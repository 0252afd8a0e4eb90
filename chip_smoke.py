#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

0. builds the seven kernel sources (csrc/*.cu), one nvcc each, in parallel;
1. the ring step (one entry of the ring-allgather kernel,
   csrc/ring_allgather.cu, on the buffer in place) against its plain torch
   version, bitwise, over ranks, lengths, dtypes, directions and round
   masks; the
   order check of the ring-allgather kernel (csrc/ring_allgather.cu): for
   every prefix length k (0 included) of the ring (both directions) and
   bidi schedules at P = 2, 3, 4, 5, 8, 16, 32 and 33, of the broadcasts'
   (M = 1, 2, 4) and a mixed schedule at P = 8, and of the broadcasts' with
   one chain (240 entries: a launch per 128) and two chains at P = 16, the
   call on the first k
   entries equals the shards installed on the diagonal and then k plain
   ring steps, on the same buffer of random values, bitwise (bf16 and f32;
   n = 1, 7, 24, 41,472 and 41,473; one and two groups); the same order
   check of the transpose kernel (csrc/ring_allgather_transpose.cu) over
   the same schedules and prefixes against its plain version (a copy of the
   cotangent, the plain transposed steps in reverse order, the diagonal),
   bitwise, f16 too at n = 24, the two-group cotangent a non-contiguous
   view, max(1, ceil(k / 128)) launches a call; the
   matmul kernel (csrc/matmul.cu) against its plain version at every shape
   the training and serving paths give it, deepseek-moe-16b's (phases 3d
   and 4d) and yi-9b's, granite-3-8b's and granite-34b's (phases 3e and
   4e) included (forward and both backward products, bf16 and f32, the
   head as every rank's (D, V) copy with V of unit stride): f32
   within 1e-5 x max|plain|, bf16 within 1e-2 x max|plain|, every bf16
   product on the wgmma + TMA path but the head products of granite-3-8b's
   odd vocab (49,155), whose rows TMA cannot describe, on the wmma path
   (``expected_path``); then that path's edge cases (the four
   operand layouts at one 128 x 192 tile, ragged M, N and K, operands
   expanded over the ranks, out= views) and the wmma path's (K = 33, N = 7,
   a base off 16 bytes), on integer inputs, bitwise; the receive
   datapath's kernels against their plain versions, all exactly
   (torch.equal): the pool scan with its RNR mask (csrc/pool.cu, f64, rows
   1 to 511, rows up to 16389 long, 1 to 16 workers, +inf-padded ragged rows
   and tied arrivals), bitmap pack, OR across rows and popcount
   (csrc/bitmap.cu, up to 512 rows and 2^20 flags; the OR also on every
   pair of 0, 1, 2, 31, 32, 33, 511, 512 and 4,096 rows by 1, 3, 4, 5, 512,
   513 and 32,768 words, all zero, all ones, one bit in the last row and
   word, sparse random words, and those as a view whose base is off 16
   bytes; popcount rows on both sides of its one-strip limit, and empty,
   with no bit, one bit and random bits set), chunk reassembly (csrc/chunk_reassembly.cu: int32 and
   int64 PSNs, duplicate PSNs, n_valid below n_staged and 0, four dtypes,
   4096-byte chunks and an odd width); then the reassembly and popcount
   wrappers under ``torch.cuda.set_sync_debug_mode("error")``: none may
   synchronise with the host;
2. the stacked allgathers (ring, bidi, bcast) against the plain gather;
3. serving smollm-135m at full width and 8 of its 30 layers (bf16, seeded
   random weights) on a (data=8, model=1) stacked mesh: prefill of a
   128-token prompt for batch 8, then greedy generation of 32 tokens, in
   every fsdp_mode. All modes must give identical logits and tokens; each
   gather of the mcast modes is one ring-allgather launch (56 per prefill)
   that runs its mode's schedule (bidi, ring, broadcasts: 392 / 392 /
   1,568 entries), no ring step is launched, and no product may reach the
   wmma or f32 kernel. A
   reduced f32 model is also held against a single-rank run;
4. training smollm-135m at full width (30 layers, bf16, batch 16 x 512,
   remat="full") on the same mesh in every fsdp_mode: one warm-up step and
   3 timed steps each; the first step's loss must be bitwise equal in all
   modes; a step launches 420 ring-allgather kernels running 2,940 / 2,940
   / 11,760 schedule entries of its mode's kind in mcast / mcast_ring /
   mcast_bcast, and 210 transpose kernels (one per gather backward) running
   1,470 / 1,470 / 5,880, no ring step, no transposed step, and the
   matmuls as before.
   A reduced f32 train step sharded
   over 8 ranks is held against a single-rank run over 3 steps (loss within
   1e-5, grad_norm within 1e-4, relative);
4b. the training path's options at the same width, batch and mesh:
   ``CollectiveConfig(prefetch=True)`` with remat="full", remat="dots", both
   together (mcast), and prefetch in mcast_bcast, beside phase 4's mcast
   step; each a warm-up, then 3 rounds of one timed step of every variant
   (the order reversed each round), then a profiled step. A step launches
   a gather per leaf and layer in the forward and again in each
   checkpointed body (29 bodies under prefetch: layer 0's gather and the
   last block lie outside them), 210 transposes, and the matmuls less the
   forward products that no "full" body runs again (dots keeps them all):
   420 / 413 / 420 / 413 / 413 gathers and 844 / 837 / 634 / 634 / 837
   matmuls; the first-step loss bitwise phase 4's, the grad norms within
   1e-4 relative of phase 4's; under prefetch the profiler must show the
   gathers on a stream that no matmul runs on. Prints the step ms, the
   device idle share, the device ms of the matmuls, gathers and
   transposes, the device ms of gathers and transposes that ran while
   another stream worked, and the peak memory;
4c. checkpoints, the restart supervisor and a replicated batch, at the same
   width on the same mesh, the checkpoints under one ``tempfile.mkdtemp()``
   removed before the phase ends: (a) ``TrainSupervisor`` runs 6 mcast steps
   at batch 16 x 512, remat="full", an async checkpoint every 2 and
   ``FailureInjector(fail_at_steps=(5,))``: steps 0 to 4, a restore of step
   4's checkpoint, steps 4 and 5; each loss, and every parameter, moment
   and the step after the last, bitwise those of an uninterrupted run from a
   fresh ``init_state``; (b) the checkpoint's bytes (1,345,220,356), the
   host-copy and write ms of an async save, the restore ms, the step ms
   with an async save behind it beside one without, and a step's host issue
   ms (what the supervisor's ``dt`` reads); (c) step 4's checkpoint restored
   into ``(data=4, model=1)`` and ``(pod=2, data=4, model=1)``, every array
   bitwise the saved one, then one step on ``(data=4)`` (loss within 1e-5
   relative of step 4's on 8 ranks); (d) ``repro_torch.launch.train.main``
   in this process, 4 steps at batch 4 x 512 with ``--ckpt-every 2``: its
   latest checkpoint is step 4; (e) global batch 4 replicated on the 8
   ranks: training at 4 x 512 in every mode (each step launching 420 / 210
   / 844 gathers / transposes / matmuls in the mcast modes, the first-step
   loss bitwise equal in every mode; step ms and peak memory), serving 4
   prompts of 128 tokens and 32 new tokens in every mode (logits and tokens
   equal, 210 gathers a prefill); and, with phase 4's reduced reference
   (before the counts are zeroed: its products are f32), the reduced f32
   replicated step against a single-rank run (loss 1e-5, grad_norm 1e-4,
   relative);
3d. serving deepseek-moe-16b at full width and 8 of its 28 layers (for
   the script's time; d_model 2048, 64
   routed experts top-6 and 2 shared, bf16, weights drawn on the card by
   ``bridge.device_params``) on (data=8,
   model=1): prefill of a 128-token prompt for batch 8 (capacity 120),
   then greedy generation of 8 tokens, in every mode, logits and tokens
   bitwise ``xla``'s; a prefill launches 88 gathers in each mcast mode
   (11 sharded leaves x 8 layers: 616 bidi / 616 ring / 2,464 bcast
   entries), no transpose, 81 bf16 matmuls (10 a layer: the attention
   projections, the three expert products batched over the experts, the
   three shared-expert products; and the head) and 8 f32 ones (the
   router); a decode step the same matmuls and no gather kernel. Prefill
   ms per mode, decode tok/s once (every mode decodes through the plain
   gather), busy ms, idle share and peak memory, medians of 3.
   Before it, reduced deepseek-moe-16b in f32 (capacity factor 1.25,
   tokens dropped) on (data=8) against a single-rank run of the same
   weights: logits within 1e-4, tokens and drop fraction equal (the
   routing is global);
4d. training deepseek-moe-16b at full width and 2 layers (1.6 B
   parameters, batch 16 x 512, capacity 960, remat="full", AdamW) on the
   same mesh in every mode: a warm-up, 2 timed steps and a profiled step
   each; the first-step loss bitwise equal in every mode, the moe_*
   metrics finite; a step launches 44 gathers, 22 transposes, 84 bf16
   and 8 f32 matmuls. Then #1 and #1b at one expert leaf (2.95 GB of
   gathered copies, past 2^31 bytes) in each mcast schedule, bitwise
   their plain versions, and #3 at the MoE step's shapes, timed;
3e. serving yi-9b (48 layers, d_model 4,096, 32 / 4 heads, SwiGLU d_ff
   11,008, untied vocab 64,000: 8.83 B parameters), granite-3-8b (40
   layers, 32 / 8 heads, d_ff 12,800, tied odd vocab 49,155: 8.17 B) and
   granite-34b at full width and 40 of its 88 layers (d_model 6,144, 48
   query heads on one kv head, GELU d_ff 24,576, untied vocab 49,152: 15.77
   B), bf16, weights drawn on the card by ``bridge.device_params`` (their
   count the analytic one), on (data=8, model=1): a prefill of a 128-token
   prompt for batch 8, then greedy generation of 8 tokens, in every mode,
   logits and tokens bitwise ``xla``'s, the cache (L, 8, KV, 128, 128); a
   prefill launches a gather per sharded leaf and layer in each mcast mode
   (336 / 280 / 240; the embedding and the head by the plain gather), no
   transpose and no ring step, a matmul per projection and layer and the
   head's, which at granite-3-8b's odd vocab is the wmma kernel's (one a
   prefill and one a decode step); prefills timed 3 times (the median), the
   mcast one profiled, decode timed once, peak memory;
4e. training each of the three at full width and 2 layers (batch 16 x
   512, remat="full", AdamW) on the same mesh in every mode: a warm-up, 2
   timed steps and a profiled step each, every step launching exactly
   what phase 4's count gives at their leaves (granite-34b's GELU MLP has
   6 a layer) and, at granite-3-8b's odd vocab, 4 wmma launches (the head's
   forward, recompute, dx and dW); the first-step loss bitwise equal in
   every mode. Then #3 timed at yi-9b's train shapes;
3g. the sub-quadratic families: first reduced rwkv6-7b and
   recurrentgemma-9b (5 layers, window 32) in f32 on (data=8) on the card
   against the same runs on the CPU, logits within 1e-4 and the same greedy
   tokens past the window in every mode; then rwkv6-7b (32 layers, d_model
   4,096, 64 WKV heads of 64, d_ff 14,336, untied vocab 65,536: 7.58 B) and
   recurrentgemma-9b (38 layers as 12 x (rec, rec, attn) + 2 rec, 16 heads
   on one kv head of 256, window 2,048, d_ff 12,288, tied vocab 256,000:
   9.40 B) at full size, bf16, weights drawn on the card by
   ``bridge.device_params``, on (data=8, model=1): a prefill of a
   128-token prompt for batch 8 in every mode, logits bitwise ``xla``'s, a
   prefill launching one #1 per sharded leaf and layer (384 / 292; the
   hybrid gathers a group of three layers at once) and one #3 per product
   (385 bf16 / 241 bf16 and 52 f32, the RG-LRU's gates); greedy generation
   of 8 tokens once (mcast; decode gathers with the plain gather in every
   mode); prefills timed twice (the median), the mcast one profiled, decode
   timed, peak memory; the chunked WKV's, the scan's, the conv's and the
   ring attention's device ms apart (plain torch, as in the reference);
4g. training rwkv6-7b at 2 layers on (data=8) and recurrentgemma-9b at 5
   (a group and the 2 trailing rec layers) on (data=2: on 4 its tied head's
   copies, their gradients and the logits' would not fit), full width,
   batch 16 x 512,
   remat="full", AdamW, in every mode: a warm-up, a timed and a profiled
   step each, every step launching what ``subq_launches`` derives (48 / 78
   #1, 24 / 39 #1b, 100 / 128 bf16 and 32 f32 #3); the first-step loss
   bitwise equal in every mode;
3h. the last three architectures: first reduced phi-3-vision-4.2b and
   whisper-base in f32 on (data=8) on the card against the same runs on
   the CPU, logits within 1e-4 and the same 8 greedy tokens in every mode;
   then phi-3-vision-4.2b (32 layers, d_model 3,072, 1,024 patches of
   1,024 projected by ``patch_proj`` ahead of the tokens, vocab 32,064:
   3.82 B) and whisper-base (6 + 6 layers, d_model 512, vocab 51,865: 97 M)
   as registered and moonshot-v1-16b-a3b at full width and 4 of its 48
   layers, bf16, ``bridge.device_params``, on (data=8, model=1): batch 8
   of 1,024 patches + 128 tokens, 512 frames + 512 tokens and 128 tokens,
   a prefill in every mode, logits bitwise ``xla``'s, launching
   ``fam_launches`` (224 / 96 / 44 #1; 226 / 96 + 1 wmma, the odd head /
   41 + 4 f32 #3); greedy generation of 8 tokens once (mcast); prefills
   timed twice, the mcast one profiled, decode timed, peak memory; then
   phi-3-vision's mcast prefill on (data=2, model=4), the weights moved
   there, the 1,152-position stream split over ``model`` (291 #1, 65 #1b,
   226 #3);
4h. training phi-3-vision-4.2b at 2 layers (batch 8 x (1,024 patches +
   512 tokens)), whisper-base whole and moonshot-v1-16b-a3b at 2 layers
   (16 x 512), full width, remat="full", AdamW, on (data=8) in every mode:
   a warm-up, a timed and a profiled step each, every step launching what
   ``fam_launches`` derives (28 / 192 / 44 #1, 14 / 96 / 22 #1b, 70 / 384
   + 4 wmma / 84 + 8 f32 #3); the first-step loss bitwise equal in every
   mode;
3i. the ``model`` axis for the MoE, rwkv, hybrid and encdec families: first
   reduced deepseek-moe-16b, rwkv6-7b, recurrentgemma-9b (5 layers) and
   whisper-base in f32 on (data=2, model=4) on the card against the same
   runs on the CPU, logits within 1e-4 in every mode and the same 8 greedy
   tokens; then deepseek-moe-16b (4 of 28 layers: EP, 16 experts a tp
   rank), rwkv6-7b (4 of 32: 16 WKV heads a tp rank), recurrentgemma-9b (its
   5-layer cut: the LRU width split, 4 heads a tp rank over one kv head)
   and whisper-base (6 + 6: 2 heads a tp rank; 512 frames + 512 tokens) at
   full width, drawn on (data=8) and served there first (the yardstick),
   then moved to (data=2, model=4): a prefill of batch 8 in every mode,
   logits bitwise xla's, every launch count (#1, #1b, #3 by path, schedule
   entries) what ``tpf_launches`` derives; greedy generation of 8 tokens
   (mcast) with its decode steps' counts; prefill ms, decode tok/s, idle,
   peak memory; the logits and tokens against the yardstick (no limit);
   the bytes #1 writes at an expert leaf on both meshes (a quarter on
   (2, 4)), its device ms and bound;
4i. training the same four (deepseek-moe-16b and rwkv6-7b at 2 layers,
   recurrentgemma-9b at 5, whisper-base whole) at 16 x 512 on (data=2,
   model=4), remat="full", AdamW, in every mode: a warm-up, a timed and a
   profiled step each, every step launching what ``tpf_launches`` derives;
   the first-step loss bitwise equal in every mode. 3i's and 4i's #1 and
   #1b call shapes join ``check_call_shapes``, their #3 shapes phase 1's
   (``tpf_path_cases``);
7. the runtime's last modules on phase 4e's yi-9b cell (2 layers, 16 x
   512, (data=8), mcast, remat="full", no prefetch): (a) ``make_compressor``
   (optim/compression.py, blockwise int8 with error feedback) over the
   cell's gradient tree on the card, bitwise equal to the same gradients
   compressed on the CPU, with its device ms; (b) one train step under the
   collective counters (launch/collective_stats.py): its bytes and counts
   by kind equal to the meta dry-run of the same cell
   (``launch/dryrun.measure_step``) and to the bytes that its #1 and #1b
   calls imply (their recorded shapes; as many as ``_train_launches``
   says); (c) the dry-run's predicted peak of the whole process beside
   ``torch.cuda.max_memory_allocated`` of that step (after
   ``reset_peak_memory_stats``, less what was allocated before the state),
   within 10 %; the card's total memory, which the dry-run's ``fits``
   holds a rank's peak against;
5. the packet-level reliable Broadcast (core/packet.py) with the leaves'
   receive datapath on the card: A, 512 hosts x 64 MiB, 8 workers, 1e-3
   Bernoulli loss per leaf, seed 0; B, 64 hosts x 64 MiB, 1 worker (the
   staging ring overflows), Gilbert-Elliott loss at 1 % in bursts of 8,
   seed 4; both with 1 us jitter and aggregated NACKs. Each must equal the
   same call's CPU run field for field (delivery orders and round traces
   included). Then every one of A's 511 leaves replays its delivery order
   (``protocol.reassemble``, on chunk reassembly) into a zeroed buffer,
   which must equal the root's, its bitmap packed and counted to 16384
   chunks;
5b. the packet-level M-chain Allgather (core/sched_ir._packet_allgather)
   with the leaves' merged multi-chain receive path on the card: AG-A, 128
   hosts x 16 MiB x 4 chains, lossless, no jitter, 8 workers (the
   reference's ag_dense point); AG-B, 188 hosts (the paper's testbed) x 4
   MiB x 4 chains, 1e-3 Bernoulli loss per leaf, 1 us jitter, 8 workers,
   aggregated NACKs; seed 0. Each must equal the same call's CPU run field
   for field, and the pool scan, pack, OR and popcount launches (counts
   zeroed before) must equal what the runs' generations and round traces
   imply: a pool pass per generation and per recovery round, one pack, OR
   and popcount per round. Wall ms on the card and the CPU, device busy
   ms, idle share and device ms per kernel; the kernels at the largest
   shapes of their calls;
5c. the paper's figures from the fluid and analytic fidelities
   (core/sched_ir.py's fluid lowerings, core/engine.py's max-min solve as
   tensor ops on the engine's device, core/topology.py, core/cost_model.py)
   at the reference's sizes (benchmarks/paper_figs.py), each run on the card
   equal field for field to the same call on the CPU: Fig. 11, fluid
   Allgathers at P = 188 of 16 KiB, 128 KiB and 1 MiB (56 Gbit/s links, 2
   workers of 9 GiB/s; at 128 KiB within 0.5x to 1.5x of the ring's per-rank
   throughput); Fig. 10, ``sweep_phase_breakdown`` up to 188 nodes
   (mcast_frac > 0.99 at 16 nodes and more and 4 MiB); Fig. 12 from routed
   engine runs on a k = 32 fat-tree at 128, 512 and 1,024 hosts, 64 KiB a
   rank, a tree flow a rank against ``cost_model.routed_ring_allgather``
   (bytes the shard times the summed tree edges and route lengths,
   multicast <= 0.55x the ring at 512 and more, time between 0.95x the
   receive bound and the ring's), the vectorized solve on the card; a lossy
   routed Broadcast (188 hosts of a k = 16 fat-tree, 64 MiB, 1e-3 drops, 2
   workers) with its 187 leaves' pools in one pool launch; the static
   traffic counts of Figs. 2 and 12 (ring over multicast in [1.5, 2.5] and
   [1.5, 2.2]). Before them, the pool's row pass on the card bitwise the 1-D
   pool on ragged rows whose staging ring overflows. Prints each figure's
   host ms on the card and the CPU, busy ms and idle share, solves, flows
   solved, vectorized solves (on the card) and their filling iterations,
   and pool launches, which must equal what the figures' generations imply
   (the card's run is the profiled one);
5d. the routed packet mode and the FSDP step (core/packet.py's routed
   Broadcast, core/sched_ir.py's routed packet Allgather and
   ``fsdp_submitters``, core/engine.py's FSDP timeline), each cell run on
   the CPU and on the card, field for field equal, printed as 5c's: (a)
   ``protocol_loss_sweep``'s part A, 1 MiB Broadcasts at 0.1 % per-link
   loss on k = 16 and k = 32 fat-trees at P = 16, 64, 256 and 512, 16
   workers, no jitter, seeds 0 to 2, and the no-aggregation ablation at
   512: every run complete with its bytes conserved, one root NACK a round
   when aggregated, the recovery time's growth from 16 to 512 at most 1.5 x
   log2(512) / log2(16) = 3.375, the ablation no faster; (b) AG-R, AG-B's
   Allgather (188 hosts x 4 MiB x 4 chains, 8 workers, 1 us jitter, seed
   0) on FatTree(k = 16, n_hosts = 188) at 1e-3 per-link loss; (c)
   ``fsdp_contention_sweep``'s grid (P 16 and 64, layers of 64 and 256 MB,
   8 layers, every policy, abstract fluid: split's bubble fraction under
   naive's in every cell), the routed step at P = 64 on FatTree(k = 8,
   n_hosts = 64) at oversubscription 1 and 4 (4 layers of 256 MB, every
   policy fluid, mcast and split with the packet overlay at 1e-3; split
   under naive; a max-min solve on the card), and ``multi_job_contention``
   (two jobs on the even and odd hosts of a k = 8, 32-host fat-tree,
   oversubscription 1, 2 and 4, 3 layers of 128 MB: the worst slowdown
   under 1.01 at 1, over 1.3 at 4, and not falling). The launches of the
   pool, pack, OR and popcount must equal what the runs' rounds imply: a
   pool pass per fast path (per generation) and per recovery round, one
   pack, OR and popcount per round; the FSDP cells launch none;
5e. the SmartNIC offload (core/dpa.py, core/dpa_engine.py, the event-level
   DPA of core/packet.py and core/sched_ir.py, ``progress_engine="host"``),
   at benchmarks/paper_figs.py's sizes: (a) the DPA model's closed forms on
   the host (Table I, Figs. 5, 13, 14, 15 and 16, the economics, part A's
   NACK budget of 16 UD threads above 511 a round, more than 16
   communicators in the LLC), each beside its assertion; then, each cell on
   the CPU and on the card, field for field equal, printed as 5c's: (b)
   ``dpa_scaling_sweep``: the event engine's Figs. 13 and 14 (UD and UC at
   1 to 16 threads; saturation at <= 4 threads for UC, 8 to 16 for UD), the
   full-core capacity within 10 % of ``pool_tput``, Fig. 16 (128 UD threads
   hold 1.6 Tbit/s, 8 do not), Fig. 5's DPA core over 1.2x a host core, the
   FSDP step (4 layers x 64 MB, P = 16, split) slower with more bubbles on
   2 host cores than on the DPA, and a lossy Broadcast (P = 16, 1 MiB, 1e-3,
   16 workers, seed 0) no faster on the event DPA than on the scalar pool;
   (c) ``protocol_loss_sweep``'s parts B and C at P = 64, 1 MiB, 16 workers,
   no jitter: 27 Broadcasts at 9 loss rates (1e-4 to 0.3) x seeds 0 to 2
   against ``analytic_ring_pipeline_bcast_time`` (the crossover above
   1e-3), and Gilbert-Elliott at 1e-2 in bursts of 16 against i.i.d. at
   1e-2; (d) AG-E, 64 hosts x 1 MiB x 4 chains, 1e-3 loss, 1 us jitter,
   seed 0, on the event DPA (``dpa=DpaConfig("UD", 16)``) and its scalar
   twin (``workers_from_dpa`` of the same config). In event mode the leaves'
   pools run on the host (no pool launch) and each recovery round launches
   one pack, OR and popcount; in scalar mode as 5b; the launches must equal
   what the runs imply. Prints the event pools' share of each run's host
   time and the phase's wall time;
5f. the composite schedules, the chain autotune, the searcher and the
   phase profiler (core/sched_ir.py's allreduce and hier_allgather kinds,
   ``autotune_chains``, core/sched_search.py, core/profiling.py), at
   benchmarks/paper_figs.py's sizes, each of (a) to (c) on the CPU and on
   the card, field for field equal (a search's wall clock aside), printed
   as 5c's: (a) ``schedule_ir_sweep``: 4 MiB Allreduces at P = 16 and 64,
   the ring AG against M = P, abstract and on FatTree(k = 8) (the
   multicast's fabric bytes under the ring's), ``autotune_chains`` on the
   flat fabric (P = 64: best M = 64) and on the 4x oversubscribed k = 8
   tree (P = 16); (b) ``search_sweep``: the Allreduce at P = 16 of 16 MiB
   on FatTree(k = 8, oversubscription 4) and Torus2D(4, 4), validated at
   packet fidelity under 1e-3 loss (certificate ratio >= 1, never worse
   than the best builder, one strict win), both searches under 30 s, a
   warm re-search wholly from the cache and 3x faster than the cold sweep,
   the cache on a temporary file that a second ``EvalCache`` serves
   wholly from disk with the same winners; (c) ``hier_fabric_sweep``: 1 MiB
   Allgathers on IslandFatTree(8, 64) and (16, 256), islands of 8: the
   winner a validated ``hier_allgather`` (certificate >= 1) strictly faster
   than the flat multicast and the ring, its switched-tier bytes under the
   flat multicast's. The pool, pack, OR and popcount launches must equal
   what the cells imply: a pool pass a fluid Allgather generation of every
   candidate simulated (a pruned or cached one none), and the packet
   validations' as 5b counts them (their round traces from the same
   validation on the CPU). (d) the FatTree search with ``n_jobs=2`` (two
   spawned children on the card) equal to the serial one on the card and
   the CPU's; (e) one more call each of AG-B, AG-R and Fig. 12 (routed)
   with ``profiling.enable()``, bitwise the unprofiled call: the profiler's
   report, each phase's share of the call's host ms, ``engine_solve``'s
   calls equal to the solves and ``pool_solve``'s to the pool launches
   plus the 1-D host scans of the call. ``REPRO_EVAL_CACHE`` and
   ``REPRO_SEARCH_WORKERS`` are cleared for the phase;
5g. the training-run co-simulation (core/train_sim.py): the runs of
   benchmarks/paper_figs.py's ``training_run_sweep`` (smollm-135m, yi-9b and
   granite-34b at 16, 64 and 256 hosts, split, abstract fabric; naive and
   split on a 4x oversubscribed k = 8 fat-tree; fluid, analytic, packet at
   0.1 and 1 % loss; granite-34b at 64 hosts, pp = 4, grad_accum = 8),
   then the three at 64 hosts priced at the H100's own figures
   (``train_sim.H100``), each on the CPU and on the card, field for field
   equal, with the sweep's assertions (step time falling with the hosts,
   MFU in (0, 1], split over naive, analytic <= fluid <= packet, the 1F1B
   bubble);
6. the collective layer's remaining entry points, each driven once with the
   launch counts zeroed before and read after: (a) the double-buffered
   drain (csrc/double_buffer_drain.cu) equal to its plain version on every
   case (torch.equal: the received shards of (b), the reference test's
   shapes, odd shapes in uint8 and int32, views off a 16-byte boundary);
   (b) ``make_allgather_matmul`` at smollm-135m's widths, bf16, on the
   (data=8, model=1) mesh, 128 and 1,024 rows per rank times each of the
   block's projections 576 -> 576, 576 -> 192, 576 -> 1536 and 1536 -> 576,
   each call one launch of the wgmma kernel that reads every rank's shard
   in place (no ring step): bitwise equal to the plain gather followed by
   the same kernel, within the matmul's limits of the plain product; the
   same calls with ``use_pallas=False``, the reference's ``jnp.dot``
   branch: the ring schedule, seven ring steps and plain products a call,
   within the same limits; its backward at 128 rows a rank and the four
   projections (forward and backward: an allgather-matmul launch, three
   matmul launches and one transpose launch a call, within the matmul's
   limits of the plain backward); its
   times beside the ring schedule's on one stream (the ring steps and
   2P - 1 products), the plain and library times and the bound, and the
   device's busy time and idle share; (c)
   ``make_broadcast`` of ``flatten_bucket`` over layer 0 (about 3.5 M f32)
   from roots 0 and 7 in 8 and 64 chunks, every rank bitwise equal to
   root's row; (d) ``concurrent_ag_rs_local`` on that bucket's shards, both
   halves bitwise equal to the separate calls, on two streams and on one:
   one ring-allgather launch of the whole ring schedule on the side stream
   and one launch of its transpose on the current one, no ring step (counts
   zeroed before, read after), and the same pair for its backward, both
   gradients bitwise the separate calls' backwards; the ring steps of (b)'s ``use_pallas=False``
   calls are the kernels line's launches of the ring step: the serving and
   training paths launch none.

Prints the card's name and power limit, per-mode and per-broadcast timings
(medians of host-clock samples after a warm-up call; device busy time and
idle share from the profiler; the CPU run's wall times, taken the same
way, beside each broadcast),
each kernel's times beside its bound, a JSON line of kernels, and as the
last line ``{"ok": true, "device": {...}}``. Exits non-zero if any check
fails or there is no CUDA device. The launches of the pool, pack, OR and
popcount in the kernels line include phases 5b to 5f's.
"""
from __future__ import annotations

import bisect
import dataclasses
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch import bridge  # noqa: E402
from repro_torch.checkpoint import latest_step, restore, save  # noqa: E402
from repro_torch.checkpoint.ckpt import host_arrays  # noqa: E402
from repro_torch.configs import (CollectiveConfig, MeshConfig, RunConfig,  # noqa: E402
                                 ShapeConfig, TrainConfig, get_model_config, reduced,
                                 replace, training_sweep_archs)
from repro_torch.core import collectives as C  # noqa: E402
from repro_torch.core import cost_model as CM  # noqa: E402
from repro_torch.core import dpa as DPA  # noqa: E402
from repro_torch.core import dpa_engine as DE  # noqa: E402
from repro_torch.core import engine as E  # noqa: E402
from repro_torch.core import packet as PK  # noqa: E402
from repro_torch.core import profiling  # noqa: E402
from repro_torch.core import protocol  # noqa: E402
from repro_torch.core import sched_ir as IR  # noqa: E402
from repro_torch.core import sched_search as SS  # noqa: E402
from repro_torch.core import simulator as SIM  # noqa: E402
from repro_torch.core import topology as TOPO  # noqa: E402
from repro_torch.core import train_sim as TS  # noqa: E402
from repro_torch.data.pipeline import SyntheticPipeline  # noqa: E402
from repro_torch.kernels import bitmap as BM  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import chunk_reassembly as CR  # noqa: E402
from repro_torch.kernels import collective_matmul as M  # noqa: E402
from repro_torch.kernels import pool as PL  # noqa: E402
from repro_torch.kernels import ring_allgather as K  # noqa: E402
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.launch.mesh import StackedMesh  # noqa: E402
from repro_torch.runtime.fault import FailureInjector, TrainSupervisor  # noqa: E402
from repro_torch.runtime.serve_loop import (ServeState, greedy_generate,  # noqa: E402
                                            make_decode_step, make_prefill_step,
                                            serving_params)
from repro_torch.runtime.train_loop import init_state, make_train_step  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.model_builder import XENT_CHUNK  # noqa: E402
from repro_torch.sharding.ctx import use_ctx  # noqa: E402
from repro_torch.sharding.fsdp import flatten_bucket  # noqa: E402
from repro_torch.sharding.specs import is_sharded, tree_leaves, tree_map  # noqa: E402

HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}   # dense bf16 tensor / f32 FMA
MODES = ("xla", "mcast", "mcast_ring", "mcast_bcast")
N_CHAINS = 2
BATCH, PROMPT, NEW = 8, 128, 32
TRAIN_SHAPE = ShapeConfig("train", "train", 512, 16)
TRAIN_TIMED = 3
REPEATS = 5   # host-clock samples per timed phase; the median is reported


def check_kernel() -> tuple[int, float]:
    """Phase 1: the ring step (a one-entry launch of the gather's kernel) vs
    its plain step, bitwise. Returns (cases, max abs err)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases, max_err = 0, 0.0
    for p in (2, 4, 8):
        # 13824, 41472 and 110592: the rank-slot lengths of smollm-135m's
        # sharded leaves at P=8 (wk/wv, wq/wo, MLP)
        for n in (1, 7, 13824, 41472, 110592, 110592 + 3):
            variants = [dict(), dict(direction=-1), dict(split=n // 2),
                        dict(direction=-1, split=n // 2)]
            if p > 2:
                variants += [dict(rounds=p // 2, active_round=r) for r in range(p // 2)]
            for dtype in (torch.bfloat16, torch.float32):
                for groups in (1, 2):
                    for kw in variants:
                        for s in range(p - 1):
                            buf = torch.randn((groups, p, p, n), generator=gen,
                                              device="cuda").to(dtype)
                            want = K.ring_step_plain(buf.clone(), s, **kw)
                            got = K.ring_step(buf, s, **kw)
                            torch.cuda.synchronize()
                            err = (got.float() - want.float()).abs().max().item()
                            max_err = max(max_err, err)
                            if not torch.equal(got, want):
                                raise AssertionError(
                                    f"ring_step != plain: P={p} n={n} {dtype} G={groups} "
                                    f"{kw} step {s}: max err {err}")
                            cases += 1
    return cases, max_err


def _mixed_schedule(n: int) -> tuple:
    """Entries of every kind in no schedule's order, at P = 8: whole slots,
    splits at 0, inside and at n, both directions, round masks."""
    return ((0, 1, None, 1, 0), (1, 1, n // 3, 1, 0), (2, -1, 0, 1, 0), (0, -1, n, 2, 1),
            (3, 1, n // 2, 4, 3), (6, -1, min(1, n), 1, 0), (5, 1, n, 8, 5))


def _order_schedules(p: int, n: int) -> dict[str, tuple]:
    out = {"ring": C._ring_schedule(p), "ring-": C._ring_schedule(p, -1),
           "bidi": C._bidi_schedule(p, n)}
    if p == 8:
        out.update({f"bcast{m}": C._bcast_schedule(p, m) for m in (1, 2, 4)})
        out["mixed"] = _mixed_schedule(n)
    if p == 16:   # the production mesh's data axis; one chain: more entries than a launch carries
        out.update({f"bcast{m}": C._bcast_schedule(p, m) for m in (1, N_CHAINS)})
    return out


# 4: the elastic mesh's ranks; 16: the production mesh's data axis; 32: the
# widest P on the narrow kernel; 33: more ranks than a warp's lanes, the wide one
P_ORDER = (2, 3, 4, 5, 8, 16, 32, 33)


def check_allgather() -> tuple[int, float]:
    """Phase 1: the order check of the ring-allgather kernel. For every
    prefix length k of every schedule, k = 0 included, the call on its
    first k entries (one launch per 128) equals the shards installed on the
    diagonal and then k plain steps, on the same buffer of random values,
    bitwise: every slot, reached or not. Returns (launches, max abs err)."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    launches, max_err = 0, 0.0
    for p in P_ORDER:
        for dtype in (torch.bfloat16, torch.float32):
            for n in (1, 7, 24, 41472, 41473):
                for name, sched in _order_schedules(p, n).items():
                    for groups in (1, 2):
                        x = torch.randn((groups, p, n), generator=gen, device="cuda").to(dtype)
                        buf = torch.randn((groups, p, p, n), generator=gen,
                                          device="cuda").to(dtype)
                        want = buf.clone()
                        want.diagonal(dim1=-3, dim2=-2).copy_(x.transpose(-1, -2))
                        for k in range(len(sched) + 1):
                            if k:
                                step, direction, split, rounds, active = sched[k - 1]
                                K.ring_step_plain(want, step, direction=direction, split=split,
                                                  rounds=rounds, active_round=active)
                            before = K.allgather_launches
                            got = K.ring_allgather(x, sched[:k], out=buf.clone())
                            torch.cuda.synchronize()
                            max_err = max(max_err, _exact("ring_allgather", (got,), (want,),
                                                          (p, dtype, n, name, groups, k)))
                            if K.allgather_launches - before != max(1, -(-k // 128)):
                                raise AssertionError(f"ring_allgather: {k} entries took "
                                                     f"{K.allgather_launches - before} launches")
                            launches += K.allgather_launches - before
    return launches, max_err


def check_allgather_transpose() -> tuple[int, float]:
    """Phase 1: the order check of the transpose kernel. For every prefix
    length k of every schedule, k = 0 included, the call on its first k
    entries (one launch per 128) equals the plain version on the same
    cotangent, bitwise: bf16 and f32 at every n of ``check_allgather``, f16
    at n = 24; one group contiguous, two as a transposed view (copied by
    the wrapper); the cotangent unchanged. Returns (launches, max abs
    err)."""
    gen = torch.Generator(device="cuda").manual_seed(10)
    launches, max_err = 0, 0.0
    sizes = [(dtype, n) for dtype in (torch.bfloat16, torch.float32)
             for n in (1, 7, 24, 41472, 41473)] + [(torch.float16, 24)]
    for p in P_ORDER:
        for dtype, n in sizes:
            for name, sched in _order_schedules(p, n).items():
                for groups in (1, 2):
                    g = torch.randn((groups, p, n, p), generator=gen,
                                    device="cuda").to(dtype).transpose(-1, -2)
                    g = g if groups == 2 else g.contiguous()
                    kept = g.clone()
                    for k in range(len(sched) + 1):
                        want = K.ring_allgather_transpose_plain(g, sched[:k])
                        before = K.allgather_transpose_launches
                        got = K.ring_allgather_transpose(g, sched[:k])
                        torch.cuda.synchronize()
                        max_err = max(max_err, _exact("ring_allgather_transpose", (got,), (want,),
                                                      (p, dtype, n, name, groups, k)))
                        if K.allgather_transpose_launches - before != max(1, -(-k // 128)):
                            raise AssertionError(
                                f"ring_allgather_transpose: {k} entries took "
                                f"{K.allgather_transpose_launches - before} launches")
                        launches += K.allgather_transpose_launches - before
                    if not torch.equal(g, kept):
                        raise AssertionError(f"ring_allgather_transpose wrote its cotangent at "
                                             f"{(p, dtype, n, name, groups)}")
    return launches, max_err


def check_collectives() -> int:
    """Phase 2: the paper's stacked allgathers equal the plain gather."""
    mesh = StackedMesh(data=8, model=1)
    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = 0
    for n in (1, 7, 13824, 110592 + 3):
        x = torch.randn((8, n), generator=gen, device="cuda").to(torch.bfloat16)
        want = C.make_allgather(mesh, "data", "xla")(x)
        for mode, chains in (("ring", None), ("bidi", None), ("bcast", N_CHAINS)):
            got = C.make_allgather(mesh, "data", mode, n_chains=chains)(x)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"{mode} allgather != plain gather at n={n}")
            cases += 1
    return cases


def check_small_reference() -> float:
    """Reduced smollm-135m in f32: the sharded mcast prefill and generation
    against a single-rank run of the same weights (no gather at all)."""
    cfg = reduced(get_model_config("smollm-135m"))
    tree = bridge.random_params(cfg, seed=1)
    tokens = torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab_size, (8, 32))).cuda()
    outs = {}
    for mesh in (None, StackedMesh(data=8, model=1)):
        params = bridge.to_torch(tree, mesh, MeshConfig(), dtype=torch.float32)
        run = RunConfig(model=cfg, shape=ShapeConfig("s", "prefill", 32, 8),
                        collective=CollectiveConfig(fsdp_mode="mcast"))
        _, _, prefill = make_prefill_step(run, mesh)
        _, _, decode = make_decode_step(run, mesh)
        logits, _ = prefill(params, {"tokens": tokens})
        toks = greedy_generate(prefill, decode, params, tokens, 8, 40)
        outs[mesh is None] = (logits, toks)
    err = (outs[True][0] - outs[False][0]).abs().max().item()
    if not err <= 1e-4:   # f32 sums batched differently: rounding only
        raise AssertionError(f"sharded vs single-rank prefill differ by {err}")
    if not torch.equal(outs[True][1], outs[False][1]):
        raise AssertionError("sharded vs single-rank greedy tokens differ")
    return err


# phase 3 serves smollm-135m at full width and SERVE_LAYERS of its 30 layers:
# its decode is host-bound (a launch per layer and step), and at 30 layers
# the phase took about 160 s on the card
SERVE_LAYERS = 8


def serve() -> None:
    """Phase 3: the serving path in every mode."""
    cfg = replace(get_model_config("smollm-135m"), num_layers=SERVE_LAYERS)
    mesh = StackedMesh(data=8, model=1)
    t0 = time.perf_counter()
    params = bridge.to_torch(bridge.random_params(cfg, seed=0), mesh,
                             MeshConfig(), dtype=torch.bfloat16)
    print(f"[serve] {cfg.name}: {cfg.num_layers} layers d_model {cfg.d_model}, weights "
          f"built in {time.perf_counter() - t0:.3f} s", flush=True)
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (BATCH, PROMPT))).cuda()
    n_sharded = sum(1 for leaf in tree_leaves(params["blocks"])
                    if is_sharded(leaf.spec, ("data",)))
    ref = None
    for mode in MODES:
        run = RunConfig(model=cfg, shape=ShapeConfig("serve", "prefill", PROMPT, BATCH),
                        collective=CollectiveConfig(fsdp_mode=mode, n_chains=N_CHAINS))
        _, _, prefill = make_prefill_step(run, mesh)
        _, _, decode = make_decode_step(run, mesh)

        def do_prefill():
            return prefill(params, {"tokens": tokens})

        def do_generate():
            return greedy_generate(prefill, decode, params, tokens, NEW, PROMPT + NEW)

        do_prefill()   # warm-up
        (logits, pre), _, counts = _run(do_prefill)
        out, _, gen_counts = _run(do_generate)
        launches, gen_launches = counts["ring_allgather"], gen_counts["ring_allgather"]
        if counts["matmul"] == 0 or any(counts[k] or gen_counts[k] for k in OFF_PATH + (
                "ring_step", "ring_allgather_transpose")):
            raise AssertionError(f"{mode}: prefill launched {counts}, generation {gen_counts}")
        prefill_s = _wall(do_prefill)
        dev_prefill, prefill_prof_ms = _device_times(do_prefill)
        busy_ms = sum(dev_prefill.values())
        ring_ms = sum(t for k, t in dev_prefill.items() if "ring_allgather_kernel" in k)
        matmul_ms = sum(t for k, t in dev_prefill.items() if "matmul_" in k)

        # decode on its own: the NEW - 1 steps of greedy_generate, from the
        # prefilled cache (rewritten in place with the same values each call)
        cache = {k: F.pad(v, (0, 0, 0, NEW)) for k, v in pre.items()}
        pos0, tok0 = torch.full((BATCH,), PROMPT, device="cuda"), logits.argmax(-1)

        def do_decode():
            state, tok = ServeState(cache, pos0), tok0
            for _ in range(NEW - 1):
                step_logits, state = decode(params, state, tok)
                tok = step_logits.argmax(-1)
            return tok

        if not torch.equal(do_decode(), out[:, -1]):
            raise AssertionError(f"{mode}: decode loop disagrees with greedy_generate")
        decode_s = _wall(do_decode)
        dev_decode, decode_prof_ms = _device_times(do_decode)
        decode_busy_ms = sum(dev_decode.values())

        if logits.shape != (BATCH, cfg.vocab_size) or not torch.isfinite(logits).all():
            raise AssertionError(f"{mode}: bad logits {tuple(logits.shape)}")
        if out.shape != (BATCH, PROMPT + NEW) or not torch.equal(out[:, :PROMPT], tokens):
            raise AssertionError(f"{mode}: bad generated tokens {tuple(out.shape)}")
        gathers = cfg.num_layers * n_sharded   # one per sharded leaf
        want = 0 if mode == "xla" else gathers
        entries = _want_entries(mode, gathers * (mesh.n_ranks - 1), mesh.n_ranks)
        if (launches != want or gen_launches != want or _entries(counts) != entries
                or _entries(gen_counts) != entries):
            raise AssertionError(f"{mode}: {launches} ring-allgather launches per prefill and "
                                 f"{gen_launches} in generation, expected {want}; schedule "
                                 f"entries {_entries(counts)} and {_entries(gen_counts)}, "
                                 f"expected {entries}")
        if ref is None:
            ref = (logits, out)
        diff = (logits.float() - ref[0].float()).abs().max().item()
        if diff != 0 or not torch.equal(out, ref[1]):
            raise AssertionError(f"{mode} differs from xla: logits max diff {diff}")
        # idle shares: busy time and wall time of the same profiled call
        row = {"mode": mode,
               "prefill_ms_median": statistics.median(prefill_s) * 1e3,
               "prefill_ms_samples": [t * 1e3 for t in prefill_s],
               "ring_allgather_launches_per_prefill": launches,
               "schedule_entries_per_prefill": _entries(counts),
               "matmul_launches_per_prefill": counts["matmul"],
               "prefill_device_busy_ms": busy_ms,
               "prefill_profiled_wall_ms": prefill_prof_ms,
               "prefill_device_idle_share": 1 - busy_ms / prefill_prof_ms,
               "prefill_ring_allgather_device_ms": ring_ms,
               "prefill_matmul_device_ms": matmul_ms,
               "decode_steps": NEW - 1,
               "decode_ms_median": statistics.median(decode_s) * 1e3,
               "decode_ms_samples": [t * 1e3 for t in decode_s],
               "decode_tok_s": BATCH * (NEW - 1) / statistics.median(decode_s),
               "decode_device_busy_ms": decode_busy_ms,
               "decode_profiled_wall_ms": decode_prof_ms,
               "decode_device_idle_share": 1 - decode_busy_ms / decode_prof_ms,
               "max_abs_logit_diff_vs_xla": diff,
               "sample_tokens": out[0, PROMPT:PROMPT + 8].tolist()}
        print("[serve] " + json.dumps(row), flush=True)
        top = sorted(dev_prefill.items(), key=lambda kv: -kv[1])[:6]
        print(f"[serve] {mode} prefill, top device time (ms): "
              + json.dumps({k[:60]: t for k, t in top}), flush=True)


MODEL_KERNELS = ("ring_allgather", "ring_allgather_transpose", "matmul")
# the kind of schedule entry each mode's gathers run (mcast: the bidirectional ring)
ENTRY_KIND = {"mcast": "bidi", "mcast_ring": "ring", "mcast_bcast": "bcast"}
OFF_PATH = ("matmul_wmma", "matmul_f32")   # matmul paths no main-path product takes
PACKET_KERNELS = ("pool", "bitmap_pack", "bitmap_or_rows", "bitmap_popcount",
                  "chunk_reassembly")
LAYER_KERNELS = ("allgather_matmul", "double_buffer_drain")
# the pool check's worker counts: one lane, A's 8, 16, odd counts, and the
# kernel's largest (S = 1, two lanes a thread)
POOL_WORKERS = (1, 7, 8, 16, 1000, 1024)
# csrc/bitmap.cu's kStripWords: a popcount row of up to this many words is
# one block, which stores its count; a longer one several, which add theirs
POPCOUNT_STRIP_WORDS = 4096
# the OR check's grid: rows within, at and past a block's lanes and its
# pass (128 and 512 rows); word counts off the vector path (1, 3, 5, 513),
# on it (4, A's 512) and of many tiles (32,768)
OR_ROWS = (0, 1, 2, 31, 32, 33, 511, 512, 4096)
OR_WORDS = (1, 3, 4, 5, 512, 513, 32768)


def _entries(counts: dict[str, int]) -> dict[str, int]:
    return {k: v for k, v in counts.items() if k.startswith("entries_")}


def _want_entries(mode: str, steps: int, p: int, key: str = "entries") -> dict[str, int]:
    """Schedule entries that gathers (or their transposes) of ``steps`` ring
    steps in all run in ``mode`` over P = p ranks: one per step, on each of
    P / M rounds for the broadcasts; keyed ``{key}_{kind}``. At P = M the
    broadcasts' one round is the plain ring (``bcast_allgather_local``)."""
    out = {f"{key}_{kind}": 0 for kind in K.entries}
    if mode != "xla":
        rounds = p // N_CHAINS if mode == "mcast_bcast" else 1
        kind = "ring" if mode == "mcast_bcast" and rounds == 1 else ENTRY_KIND[mode]
        out[f"{key}_{kind}"] = steps * rounds
    return out


def _counts() -> dict[str, int]:
    return {"ring_allgather": K.allgather_launches,
            **{f"entries_{kind}": n for kind, n in K.entries.items()},
            "ring_allgather_transpose": K.allgather_transpose_launches,
            **{f"transpose_entries_{kind}": n for kind, n in K.transpose_entries.items()},
            "ring_step": K.launches,
            "matmul": M.launches, "matmul_wmma": M.launches_wmma,
            "matmul_f32": M.launches_f32, "pool": PL.launches, "bitmap_pack": BM.pack_launches,
            "bitmap_or_rows": BM.or_launches, "bitmap_popcount": BM.popcount_launches,
            "chunk_reassembly": CR.launches, "allgather_matmul": M.allgather_launches,
            "double_buffer_drain": K.drain_launches}


def _zero_counts() -> None:
    K.allgather_launches = K.allgather_transpose_launches = 0
    K.entries.update(dict.fromkeys(K.entries, 0))
    K.transpose_entries.update(dict.fromkeys(K.transpose_entries, 0))
    K.launches = M.launches = PL.launches = CR.launches = 0
    M.launches_wmma = M.launches_f32 = 0
    BM.pack_launches = BM.or_launches = BM.popcount_launches = 0
    M.allgather_launches = K.drain_launches = 0


def _run(fn):
    """(result, wall seconds, kernel launches by name) of one synchronised call."""
    torch.cuda.synchronize()
    before, t0 = _counts(), time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return out, dt, {k: v - before[k] for k, v in _counts().items()}


def _wall(fn, repeats: int = REPEATS) -> list[float]:
    """Host seconds of each of ``repeats`` synchronised calls of ``fn``."""
    return [_run(fn)[1] for _ in range(repeats)]


def _profiled(fn, iters: int = 1) -> tuple[dict[str, float], float, list[tuple]]:
    """Device ms per call of each kernel (and memcpy / memset) that ``fn``
    runs, by name, from the profiler's CUDA records; the wall ms per call
    of those same profiled calls; and every device record as (name, stream,
    start ms, end ms)."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / iters * 1e3
    records = [(e.name(), e.device_resource_id(), e.start_ns() / 1e6,
                (e.start_ns() + e.duration_ns()) / 1e6)
               for e in prof.profiler.kineto_results.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA and e.duration_ns() > 0]
    return ({e.key: e.self_device_time_total / iters / 1e3 for e in prof.key_averages()
             if e.self_device_time_total}, wall_ms, records)


def _device_times(fn, iters: int = 1) -> tuple[dict[str, float], float]:
    """``_profiled`` without the records."""
    dev, wall_ms, _ = _profiled(fn, iters)
    return dev, wall_ms


def _union(spans: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for lo, hi in sorted(spans):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return [tuple(span) for span in out]


def _overlap(records: list[tuple], names: tuple[str, ...]) -> dict:
    """Of the device records whose name holds one of ``names``: their
    streams, their device ms, and the ms of them that run while a record of
    another stream runs (the overlap of the prefetched gathers with the
    blocks). Also the busy ms of the device: the union of every record."""
    picked = [r for r in records if any(n in r[0] for n in names)]
    streams = {r[1] for r in picked}
    overlap = 0.0
    for stream in streams:
        others = _union([(lo, hi) for _, st, lo, hi in records if st != stream])
        starts = [lo for lo, _ in others]
        for _, st, lo, hi in picked:
            if st != stream:
                continue
            i = max(bisect.bisect_right(starts, lo) - 1, 0)
            while i < len(others) and others[i][0] < hi:
                overlap += max(0.0, min(hi, others[i][1]) - max(lo, others[i][0]))
                i += 1
    return {"streams": sorted(streams),
            "all_streams": sorted({r[1] for r in records}),
            "device_ms": sum(hi - lo for _, _, lo, hi in picked),
            "overlap_ms": overlap,
            "busy_ms": sum(hi - lo for lo, hi in _union([(lo, hi) for *_, lo, hi in records]))}


def _time(fn, target_s: float = 0.05) -> float:
    """ms per call: CUDA events around back-to-back calls, as many as fill
    about ``target_s`` (at least 3, at most 200), after a warm-up."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    iters = int(min(200, max(3, target_s * 1e3 / max(start.elapsed_time(end), 1e-3))))
    for _ in range(min(iters, 10)):
        fn()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _layer_leaves(cfg) -> dict[str, tuple[int, int]]:
    """(fan-in, fan-out) of each projection of one dense layer: the SwiGLU
    MLP's three, or the plain MLP's two (``act="gelu"``, granite-34b)."""
    d, f = cfg.d_model, cfg.d_ff
    q, kv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    mlp = ({"w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)} if cfg.act == "swiglu"
           else {"w_in": (d, f), "w_out": (f, d)})
    return {"wq": (d, q), "wk": (d, kv), "wv": (d, kv), "wo": (q, d), **mlp}


def _steps(x: torch.Tensor, sched: tuple) -> torch.Tensor:
    """The gather as the main path ran it before the one-launch kernel: the
    zeroed ring buffer with the shards copied in, then one ring-step launch
    per schedule entry (each now a one-entry launch of the gather's own
    kernel, csrc/ring_allgather.cu, which serves ``ring_step``)."""
    buf = C._ring_buffer(x)
    for step, direction, split, rounds, active in sched:
        K.ring_step(buf, step, direction=direction, split=split, rounds=rounds,
                    active_round=active)
    return buf


def time_ring_steps(cfg) -> dict:
    """At the shapes of one smollm-135m layer at P=8 (the flat rank shard of
    each sharded leaf, bf16): the whole gather of each mode's schedule
    (``mcast``: bidi, ``mcast_ring``: ring, ``mcast_bcast``: M = 2) as the
    main path calls it, ``ring_allgather(x, schedule)``: the output's
    allocation and one launch that installs the shards and runs the
    schedule; ms per call from Python and device ms, beside what it
    replaces (the zeroed buffer, the shards' copy and 7 or 28 ring-step
    launches, ``_steps``), its plain version (the install and the plain steps) and the
    plain gather (``plain_allgather_local``, one tensor op: the library
    call), and the bound: (P * P + P) * n * 2 bytes, the shards read once
    and the gathered buffer written once. The same for each schedule's
    whole backward as the main path calls it, ``_transposed(g, schedule)``
    on a cotangent (P, P * n): the result's allocation and one launch of
    the transpose kernel; beside its plain version (a copy of the
    cotangent, the plain transposed steps in reverse order, the diagonal),
    which it must equal bitwise, the one PyTorch call of the same function,
    ``g.view(P, P, n).sum(-3)`` (not bitwise: it sums in another order),
    and the bound: (P * P + P) * n * 2 bytes, the cotangent read once and
    the result written once. Then one step per call of the ring step (a
    one-entry launch of the gather's kernel): kernel, plain version, and
    one library call of the same step (an advanced-index copy). Device ms
    from ``_device_ms``. Returns the means over the leaves (and, for the
    gather and its transpose, over the three schedules)."""
    p = 8
    rank = torch.arange(p, device="cuda")
    src, rcv = rank % p, (rank + 1) % p   # step 0: rank d sends its own slot
    leaves = _layer_leaves(cfg)
    tot: dict = {}
    for name, (fan_in, fan_out) in leaves.items():
        n = fan_in * fan_out // p
        x = torch.randn((p, n), device="cuda").to(torch.bfloat16)
        buf = C._ring_buffer(x)   # the ring step's buffer
        row = {"bound_ms": 2 * p * n * buf.element_size() / HBM_BYTES_PER_S * 1e3,
               "gather_bound_ms": (p * p + p) * n * buf.element_size() / HBM_BYTES_PER_S * 1e3,
               "gather_library_ms": _time(lambda: C.plain_allgather_local(x)),
               "gather_library_device_ms": _device_ms(lambda: C.plain_allgather_local(x))}
        g = torch.randn((p, p * n), device="cuda").to(torch.bfloat16)   # a layer's cotangent
        g3 = g.view(p, p, n)
        row.update({"transpose_bound_ms": row["gather_bound_ms"],
                    "transpose_library_ms": _time(lambda: g3.sum(-3)),
                    "transpose_library_device_ms": _device_ms(lambda: g3.sum(-3))})
        gather = {}
        for mode, sched in (("mcast", C._bidi_schedule(p, n)), ("mcast_ring", C._ring_schedule(p)),
                            ("mcast_bcast", C._bcast_schedule(p, N_CHAINS))):
            one = {"ms": lambda: K.ring_allgather(x, sched),
                   "replaced_ms": lambda: _steps(x, sched),
                   "plain_ms": lambda: K.ring_allgather_plain(x, sched)}
            gather[mode] = {"entries": len(sched),
                            **{k: _time(fn) for k, fn in one.items()},
                            "device_ms": _device_ms(one["ms"]),
                            "replaced_device_ms": _device_ms(one["replaced_ms"]),
                            "host_ms": _host_ms(one["ms"])}
        row["gather"] = gather
        transpose = {}
        for mode, sched in (("mcast", C._bidi_schedule(p, n)), ("mcast_ring", C._ring_schedule(p)),
                            ("mcast_bcast", C._bcast_schedule(p, N_CHAINS))):
            one = {"ms": lambda: C._transposed(g, sched),
                   "plain_ms": lambda: K.ring_allgather_transpose_plain(g3, sched)}
            if not torch.equal(one["ms"](), one["plain_ms"]()):
                raise AssertionError(f"{name} {mode}: the one-launch backward differs from its "
                                     "plain version")
            transpose[mode] = {"entries": len(sched),
                               **{k: _time(fn) for k, fn in one.items()},
                               "device_ms": _device_ms(one["ms"]),
                               "host_ms": _host_ms(one["ms"])}
        row["transpose"] = transpose
        for k in ("ms", "plain_ms", "device_ms"):
            row[f"gather_{k}"] = statistics.mean(v[k] for v in gather.values())
            row[f"transpose_{k}"] = statistics.mean(v[k] for v in transpose.values())
        fns = {"": lambda: K.ring_step(buf, 0),
               "bidi_": lambda: K.ring_step(buf, 0, split=n // 2),
               "plain_": lambda: K.ring_step_plain(buf, 0),
               "library_": lambda: buf.index_put_((rcv, src), buf[rank, src])}
        row.update({f"{k}ms": _time(fn) for k, fn in fns.items()})
        row.update({f"{k}device_ms": _device_ms(fn) for k, fn in fns.items()
                    if k in ("", "library_")})
        print(f"[ring] {name}: P={p} n={n} bf16 " + json.dumps(row), flush=True)
        for k, v in row.items():
            if k in ("gather", "transpose"):
                for mode, per in v.items():
                    for pk, pv in per.items():
                        key = f"{k}_{mode}_{pk}"
                        tot[key] = tot.get(key, 0.0) + pv / len(leaves)
            else:
                tot[k] = tot.get(k, 0.0) + v / len(leaves)
    return tot


# ------------------------------------------------------------------ matmul


def _operand(r: int, rows: int, cols: int, transposed: bool, dtype, gen) -> torch.Tensor:
    """(r, rows, cols), or the transposed view of a contiguous (r, cols, rows)."""
    if transposed:
        return torch.randn((r, cols, rows), device="cuda", generator=gen).to(dtype).transpose(1, 2)
    return torch.randn((r, rows, cols), device="cuda", generator=gen).to(dtype)


def matmul_cases(cfg, r: int, m: int, dtype, *, train: bool,
                 head_m: int | None = None) -> dict:
    """Every matmul the path launches per step: {(r, m, k, n, a_t, b_t,
    dtype): launches}, a_t / b_t marking an operand given as a transposed
    view. ``m`` is the tokens per rank, ``head_m`` the head's rows per rank
    (default ``m``; a prefill's last position). With ``train`` (remat="full"), each
    layer's forward products run twice (the checkpointed recompute), then
    dY W^T and X^T dY; the head's forward runs twice (the checkpointed
    cross-entropy chunk), then its two backward products. Every rank's copy
    of the head is (D, V) with V of unit stride, tied (the embedding's
    gather lays it out so) or not."""
    cases: dict = {}

    def add(key, count):
        cases[key] = cases.get(key, 0) + count

    for k, n in _layer_leaves(cfg).values():
        add((r, m, k, n, False, False, dtype), cfg.num_layers * (2 if train else 1))
        if train:
            add((r, m, n, k, False, True, dtype), cfg.num_layers)    # dY W^T
            add((r, k, m, n, True, False, dtype), cfg.num_layers)    # X^T dY
    d, v = cfg.d_model, cfg.vocab_size
    m = m if head_m is None else head_m
    add((r, m, d, v, False, False, dtype), 2 if train else 1)        # x head
    if train:
        add((r, m, v, d, False, True, dtype), 1)                     # dY head^T
        add((r, d, m, v, True, False, dtype), 1)                     # x^T dY
    return cases


def _tma_ok(r: int, rows: int, cols: int, transposed: bool) -> bool:
    """Whether TMA can describe a fresh bf16 operand (r, rows, cols) made as
    ``_operand`` makes it (``collective_matmul.tma_layout``): its rows, of
    the unit-stride extent, 16 bytes apart, or one row; so the rank stride."""
    inner, outer = (rows, cols) if transposed else (cols, rows)
    return (outer == 1 or inner % 8 == 0) and (r == 1 or rows * cols % 8 == 0)


def expected_path(r: int, m: int, k: int, n: int, a_t: bool, b_t: bool, dtype) -> str:
    """The matmul kernel a case of ``matmul_cases`` takes: f32 the FMA
    kernel; bf16 wgmma where TMA can describe both operands, else wmma (a
    unit-stride extent of granite-3-8b's odd vocab, 49,155)."""
    if dtype == torch.float32:
        return "f32"
    return "wgmma" if _tma_ok(r, m, k, a_t) and _tma_ok(r, k, n, b_t) else "wmma"


def check_matmul(cases) -> float:
    """Phase 1: the kernel vs its plain version at every case, each product
    on the path ``expected_path`` names (one launch each): every bf16 one on
    wgmma but the head products of an odd vocab, on wmma. Returns the max
    abs error."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    max_err = 0.0
    counter = {"wgmma": "launches", "wmma": "launches_wmma", "f32": "launches_f32"}
    for case in cases:
        r, m, k, n, a_t, b_t, dtype = case
        a = _operand(r, m, k, a_t, dtype, gen)
        b = _operand(r, k, n, b_t, dtype, gen)
        want = M.matmul_plain(a, b)
        kind, expect = M.path(a, b), expected_path(*case)
        before = getattr(M, counter[expect])
        got = M.matmul(a, b)
        torch.cuda.synchronize()
        if kind != expect or getattr(M, counter[expect]) != before + 1:
            raise AssertionError(f"matmul {(r, m, k, n, a_t, b_t, dtype)} took the {kind} path, "
                                 f"expected {expect}")
        err = (got.float() - want.float()).abs().max().item()
        tol = (1e-2 if dtype == torch.bfloat16 else 1e-5) * want.float().abs().max().item()
        if not err <= tol or got.dtype != dtype:
            raise AssertionError(f"matmul != plain at {(r, m, k, n, a_t, b_t, dtype)}: "
                                 f"max err {err} > {tol}")
        max_err = max(max_err, err)
    return max_err


def _ints(*shape, gen) -> torch.Tensor:
    """Integers in [-2, 2] as bf16: every f32 sum of their products is exact."""
    return torch.randint(-2, 3, shape, generator=gen, device="cuda").to(torch.bfloat16)


def check_matmul_edges() -> int:
    """Phase 1: the edge cases of the two bf16 paths, on integer inputs so
    that each result must equal the plain product bitwise: the four operand
    layouts at one 128 x 192 tile and at ragged M, N, K; odd extents where
    not contiguous; operands expanded over the ranks; out= views; and what
    TMA cannot describe (K = 33, N = 7 MN-major, a base off 16 bytes) on the
    wmma kernel. Returns the number of cases."""
    gen = torch.Generator(device="cuda").manual_seed(4)

    def operand(r, rows, cols, transposed):
        return (_ints(r, cols, rows, gen=gen).transpose(1, 2) if transposed
                else _ints(r, rows, cols, gen=gen))

    cases = []   # (a, b, out, path)
    for a_t in (False, True):
        for b_t in (False, True):
            for r, m, k, n in ((1, 128, 64, 192), (2, 136, 72, 200), (1, 1000, 520, 584)):
                cases.append((operand(r, m, k, a_t), operand(r, k, n, b_t), None, "wgmma"))
    cases += [(operand(2, 65, 72, False), operand(2, 72, 7, True), None, "wgmma"),
              (_ints(1024, 576, gen=gen).expand(8, 1024, 576),
               _ints(576, 192, gen=gen).expand(8, 576, 192), None, "wgmma")]
    a, b = _ints(2, 130, 64, gen=gen), _ints(2, 64, 200, gen=gen)
    for out in (torch.zeros(2, 200, 130, dtype=torch.bfloat16, device="cuda").transpose(1, 2),
                torch.zeros(2 * 130 * 200 + 1, dtype=torch.bfloat16, device="cuda")[1:]
                .view(2, 130, 200),
                torch.zeros(2, 130, 202, dtype=torch.bfloat16, device="cuda")[:, :, :200],
                torch.zeros(2, 130, 456, dtype=torch.bfloat16, device="cuda")[:, :, 256:]):
        cases.append((a, b, out, "wgmma"))
    off = torch.zeros(2 * 40 * 64 + 1, dtype=torch.bfloat16, device="cuda")[1:].view(2, 40, 64)
    off.copy_(_ints(2, 40, 64, gen=gen))
    cases += [(_ints(2, 40, 33, gen=gen), _ints(2, 33, 64, gen=gen), None, "wmma"),
              (_ints(2, 40, 64, gen=gen), _ints(2, 64, 7, gen=gen), None, "wmma"),
              (off, _ints(2, 64, 64, gen=gen), None, "wmma")]
    for a, b, out, kind in cases:
        case = (tuple(a.shape), a.stride(), tuple(b.shape), b.stride())
        before = (M.launches, M.launches_wmma)
        got = M.matmul(a, b, out=out)
        torch.cuda.synchronize()
        took = "wgmma" if M.launches > before[0] else "wmma" if M.launches_wmma > before[1] \
            else None
        if M.path(a, b) != kind or took != kind:
            raise AssertionError(f"matmul {case} took {took}, expected {kind}")
        if not torch.equal(got, M.matmul_plain(a, b)):
            raise AssertionError(f"matmul {case} ({kind}) != plain on integer inputs")
    return len(cases)


def time_matmul(cases: dict) -> dict:
    """Per case: kernel, plain and torch.bmm (the library call) ms, and the
    bound; then their sums over one step's launches, and means per launch."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0, "device_ms": 0.0,
           "library_device_ms": 0.0, "launches": 0}
    for key, count in cases.items():
        r, m, k, n, a_t, b_t, dtype = key
        a = _operand(r, m, k, a_t, dtype, gen)
        b = _operand(r, k, n, b_t, dtype, gen)
        item = a.element_size()
        row = {"path": M.path(a, b), "ms": _time(lambda: M.matmul(a, b)),
               "plain_ms": _time(lambda: M.matmul_plain(a, b)),
               "library_ms": _time(lambda: torch.bmm(a, b)),
               "bound_ms": max(2 * r * m * n * k / FLOPS[dtype],
                               r * (m * k + k * n + m * n) * item / HBM_BYTES_PER_S) * 1e3}
        row.update({"host_ms": _host_ms(lambda: M.matmul(a, b)),
                    "device_ms": _device_ms(lambda: M.matmul(a, b)),
                    "library_device_ms": _device_ms(lambda: torch.bmm(a, b))})
        row["device_tflops"] = 2 * r * m * n * k / row["device_ms"] / 1e9
        row["library_device_tflops"] = 2 * r * m * n * k / row["library_device_ms"] / 1e9
        print(f"[matmul] R={r} M={m} K={k} N={n} a^T={a_t} b^T={b_t} {str(dtype)[6:]} "
              f"x{count} per step " + json.dumps(row), flush=True)
        for name in ("ms", "plain_ms", "library_ms", "bound_ms", "device_ms",
                     "library_device_ms"):
            tot[name] += row[name] * count
        tot["launches"] += count
    per = {f"{name}_per_launch": tot[name] / tot["launches"]
           for name in ("ms", "plain_ms", "library_ms", "bound_ms")}
    return {**tot, **per}


# ---------------------------------------------------------------- training


def _train_run(cfg, shape, mode: str, *, prefetch: bool = False,
               remat: str = "full") -> RunConfig:
    return RunConfig(model=cfg, shape=shape, train=TrainConfig(remat=remat),
                     collective=CollectiveConfig(fsdp_mode=mode, n_chains=N_CHAINS,
                                                 prefetch=prefetch))


def _train_launches(cfg, mesh: StackedMesh, mode: str, *, prefetch: bool = False,
                    remat: str = "full") -> dict[str, int]:
    """Kernel launches and schedule entries a train step makes at full
    width: a gather per sharded leaf and layer in the forward, again in each
    checkpointed body's recompute (L bodies; with prefetch L - 1, each
    gathering the next layer: layer 0's gather and the last block are
    outside them); a transpose per forward gather; the matmuls of
    ``matmul_cases`` (remat="full": every projection's forward twice), less
    the forwards of the layers that no "full" body recomputes ("dots" keeps
    every product, "none" and the last block under prefetch recompute
    none)."""
    leaves, layers = len(_layer_leaves(cfg)), cfg.num_layers
    bodies = 0 if remat == "none" else layers - 1 if prefetch else layers
    gathers = 0 if mode == "xla" else leaves * (layers + bodies)
    transposes = 0 if mode == "xla" else leaves * layers
    matmul = sum(matmul_cases(cfg, mesh.n_ranks, TRAIN_SHAPE.global_batch // mesh.n_ranks
                              * TRAIN_SHAPE.seq_len, torch.bfloat16, train=True).values())
    matmul -= leaves * (layers - (bodies if remat == "full" else 0))
    wmma = head_wmma(cfg, train=True)
    p = mesh.n_ranks
    return {**{k: 0 for k in PACKET_KERNELS + LAYER_KERNELS + OFF_PATH},
            "ring_allgather": gathers,
            **_want_entries(mode, gathers * (p - 1), p),
            "ring_step": 0, "ring_allgather_transpose": transposes,
            **_want_entries(mode, transposes * (p - 1), p, "transpose_entries"),
            "matmul": matmul - wmma, "matmul_wmma": wmma}


def tp_launches(cfg, mesh: StackedMesh, mode: str, kind: str, *,
                replicated: bool = False) -> dict[str, int]:
    """#1 (``ring_allgather``), #1b (``ring_allgather_transpose``) and #3
    (``matmul``) launches of one prefill or decode step of a dense config on
    a mesh with a physical ``model`` axis (tp > 1), the prompt and the
    cache splitting over it, as the model code places them
    (``sharding/tp.py``):

    - a layer's dp gathers: one #1 a dp-split leaf in the mcast modes, in
      prefill only (decode gathers with the plain gather; with
      ``serve_params_replicated`` nothing is gathered over dp);
    - its ``model`` collectives: in prefill the two sequence gathers (#1)
      and a reduce-scatter (#1b) after each row-parallel product (``wo``
      where heads split, the down projection where d_ff splits); in decode
      q's and, where kv heads split, k's and v's head gathers (#1) and an
      all-reduce (#1b then #1) after each row-parallel product; an
      attention weight that the rules split over ``model`` off whole heads
      gathered over it (#1) at every step, unless the serving layout holds
      it whole;
    - its products: one #3 a projection;
    - outside the layers: the embedding's sum over the vocabulary shards
      (a reduce-scatter in prefill, an all-reduce in decode) where the
      vocabulary splits, the head product (#3), and in prefill the final
      sequence gather (#1), and the logits' vocabulary gather (#1) where
      it splits."""
    t, layers_ = mesh.tp, cfg.num_layers
    leaves = _layer_leaves(cfg)
    heads = cfg.num_heads % t == 0
    kv_heads = heads and cfg.num_kv_heads % t == 0
    vocab = cfg.vocab_size % t == 0
    mlp = cfg.d_ff % t == 0
    off_heads = 0 if replicated else sum(
        1 for name, (fan_in, fan_out) in leaves.items()
        if name in ("wq", "wk", "wv", "wo")
        and not (kv_heads if name in ("wk", "wv") else heads)
        and (fan_in if name == "wo" else fan_out) % t == 0)
    rows = int(heads) + int(mlp)   # row-parallel products a layer
    if kind == "prefill":
        dp = 0 if mode == "xla" or replicated else len(leaves)
        ag = layers_ * (dp + 2 + off_heads) + 1 + int(vocab)
        rs = layers_ * rows + int(vocab)
    else:
        ag = layers_ * (int(heads) + 2 * int(kv_heads) + off_heads + rows) + 2 * int(vocab)
        rs = layers_ * rows + int(vocab)
    return {"ring_allgather": ag, "ring_allgather_transpose": rs,
            "matmul": layers_ * len(leaves) + 1}


def head_wmma(cfg, *, train: bool, seq: int = TRAIN_SHAPE.seq_len) -> int:
    """The head's launches of the wmma kernel at an odd vocab (granite-3-8b's
    49,155: every rank's copy of the head, (D, V) with V of unit stride,
    and the logits' cotangent have rows 2V bytes apart, which TMA cannot
    take): one a prefill or a decode step; in a train step four a
    cross-entropy chunk (the forward, its checkpointed recompute, dx and
    dW). None at an even vocab."""
    if cfg.vocab_size % 8 == 0:
        return 0
    return 4 * -(-seq // XENT_CHUNK) if train else 1


def check_train_reference(batch: int = 8) -> float:
    """Reduced smollm-135m in f32: the train step over 8 ranks (mcast, then
    mcast_bcast) against a single-rank run of the same step, 3 steps; at
    global batch 8 sharded, at 4 replicated on every rank. Returns the
    largest relative loss difference."""
    cfg = reduced(get_model_config("smollm-135m"))
    shape = ShapeConfig("t", "train", 64, batch)
    tree = bridge.random_params(cfg, seed=1)
    batches = [SyntheticPipeline(cfg, shape).next_batch(i) for i in range(3)]
    out = {}
    for mode, mesh in (("mcast", None), ("mcast", StackedMesh(data=8, model=1)),
                       ("mcast_bcast", StackedMesh(data=8, model=1))):
        run = _train_run(cfg, shape, mode)
        _, _, step = make_train_step(run, mesh)
        state = init_state(run, mesh, tree)
        rows = []
        for b in batches:
            state, m = step(state, b)
            rows.append((float(m["loss"]), float(m["grad_norm"])))
        out[mode, mesh is None] = rows
    worst = 0.0
    for key in (("mcast", False), ("mcast_bcast", False)):
        for (loss, gn), (l1, g1) in zip(out[key], out["mcast", True]):
            worst = max(worst, abs(loss - l1) / abs(l1))
            if not (abs(loss - l1) <= 1e-5 * abs(l1) and abs(gn - g1) <= 1e-4 * abs(g1)):
                raise AssertionError(f"{key[0]} sharded vs single-rank train step: loss "
                                     f"{loss} vs {l1}, grad_norm {gn} vs {g1}")
    print(f"[reference] reduced f32 train step at batch {batch}, 8 ranks vs 1: "
          f"{json.dumps(out[('mcast', False)])} vs {json.dumps(out[('mcast', True)])}", flush=True)
    return worst


def train() -> tuple[dict[str, int], dict[str, tuple[list, list]]]:
    """Phase 4: the training path at full width in every mode. Returns the
    launches per step of each kernel in the mcast mode, and each mode's
    losses and grad norms (the warm-up step's, then the timed steps')."""
    cfg = get_model_config("smollm-135m")
    mesh = StackedMesh(data=8, model=1)
    tree = bridge.random_params(cfg, seed=0)
    pipe = SyntheticPipeline(cfg, TRAIN_SHAPE)
    batches = [pipe.next_batch(i) for i in range(TRAIN_TIMED + 2)]
    first_loss, per_step, metrics = {}, {}, {}
    for mode in MODES:
        want = _train_launches(cfg, mesh, mode)
        row, counts = _train_steps(cfg, mesh, tree, batches, mode, TRAIN_TIMED, want)
        print("[train] " + json.dumps(row), flush=True)
        first_loss[mode] = row["losses"][0]
        per_step[mode] = counts
        metrics[mode] = (row["losses"], row["grad_norms"])
    if len({first_loss[mode] for mode in MODES}) != 1:
        raise AssertionError(f"first-step losses differ between modes: {first_loss}")
    print(f"[train] first-step loss bitwise equal in every mode: {first_loss['xla']!r}",
          flush=True)
    return per_step["mcast"], metrics


def _train_steps(cfg, mesh: StackedMesh, tree, batches: list, mode: str, timed: int,
                 want: dict[str, int], shape: ShapeConfig = TRAIN_SHAPE
                 ) -> tuple[dict, dict[str, int]]:
    """A warm-up step on ``batches[0]``, ``timed`` steps on the next batches,
    each launching exactly ``want``, and a profiled step on
    ``batches[timed + 1]``, of ``mode`` at ``shape``. Returns the row of
    figures and the last step's launches."""
    run = _train_run(cfg, shape, mode)
    _, _, step = make_train_step(run, mesh)
    state = init_state(run, mesh, tree)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, m = step(state, batches[0])   # warm-up
    losses, norms = [float(m["loss"])], [float(m["grad_norm"])]
    warm_s = time.perf_counter() - t0
    samples = []
    for b in batches[1:timed + 1]:
        (state, m), dt, counts = _run(lambda b=b: step(state, b))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        samples.append(dt)
        if counts != want:
            raise AssertionError(f"{mode}: launches per train step {counts}, expected {want}")
    row = {"mode": mode, "losses": losses, "grad_norms": norms, "warmup_step_ms": warm_s * 1e3,
           **_step_times(samples, shape), "launches_per_step": counts,
           **_profiled_step(step, state, batches[timed + 1], f"{mode} step")}
    moe = {k: float(v) for k, v in m.items() if k.startswith("moe_")}
    if moe:   # the MoE family's router metrics, of the last timed step
        row["moe_metrics"] = moe
        if not all(np.isfinite(list(moe.values()))):
            raise AssertionError(f"{mode}: non-finite MoE metrics {moe}")
    _check_losses(cfg, mode, losses, norms)
    del state, m
    torch.cuda.empty_cache()
    return row, counts


def _step_times(samples: list[float], shape: ShapeConfig = TRAIN_SHAPE) -> dict:
    """Step ms; tokens/s counts the global batch's tokens (a replicated
    batch's ranks each compute all of them)."""
    return {"step_ms_median": statistics.median(samples) * 1e3,
            "step_ms_samples": [t * 1e3 for t in samples],
            "tokens_per_s": shape.global_batch * shape.seq_len / statistics.median(samples)}


def _check_losses(cfg, what: str, losses: list[float], norms: list[float]) -> None:
    """Finite losses and grad norms; the first loss within 1 of ln V, the
    loss of a random-init model whose logits are small. Not for the hybrid
    family: its embedding, scaled by sqrt(d_model), is also its head, so at
    init the residual stream carries the input token's own row and the head
    scores that token far above the others (recurrentgemma-9b's first loss
    42.6 against ln V = 12.45 on an H100); its forward is held
    against the CPU by the reduced f32 check of phase 3g."""
    if not all(np.isfinite(losses)) or not all(np.isfinite(norms)):
        raise AssertionError(f"{what}: non-finite loss or grad norm {losses} {norms}")
    if cfg.family != "hybrid" and abs(losses[0] - np.log(cfg.vocab_size)) > 1.0:
        raise AssertionError(f"{what}: first loss {losses[0]} far from ln V at random init")


def _profiled_step(step, state, batch, what: str) -> dict:
    """One train step under the profiler: the device's busy ms (the sum of
    its records, and their union, which counts two streams' overlapping
    work once), its idle share, the device ms of the matmuls, gathers and
    transposes, the streams the gathers, transposes and matmuls ran on, and
    the device ms of gathers and of transposes that ran while a record of
    another stream ran."""
    holder = {"state": state}

    def profiled():
        holder["state"], _ = step(holder["state"], batch)

    dev, prof_ms, records = _profiled(profiled)
    busy = sum(dev.values())
    gathers = _overlap(records, ("ring_allgather_kernel",))
    transposes = _overlap(records, ("ring_allgather_transpose_kernel",))
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:8]
    print(f"[train] {what}, top device time (ms): "
          + json.dumps({k[:60]: t for k, t in top}), flush=True)
    return {"device_busy_ms": busy, "profiled_wall_ms": prof_ms,
            "device_idle_share": 1 - busy / prof_ms,
            "device_busy_union_ms": gathers["busy_ms"],
            "device_idle_share_union": 1 - gathers["busy_ms"] / prof_ms,
            "matmul_device_ms": sum(t for k, t in dev.items() if "matmul_" in k),
            "ring_allgather_device_ms": sum(t for k, t in dev.items()
                                            if "ring_allgather_kernel" in k),
            "ring_allgather_transpose_device_ms": sum(
                t for k, t in dev.items() if "ring_allgather_transpose_kernel" in k),
            "streams": gathers["all_streams"], "gather_streams": gathers["streams"],
            "transpose_streams": transposes["streams"],
            "matmul_streams": _overlap(records, ("matmul_",))["streams"],
            "gather_overlap_ms": gathers["overlap_ms"],
            "transpose_overlap_ms": transposes["overlap_ms"]}


# phase 4b: the training path's options, (mode, prefetch, remat); the first
# is phase 4's mcast step, the yardstick whose steps alternate with theirs
TRAIN_OPTIONS = (("mcast", False, "full"), ("mcast", True, "full"), ("mcast", False, "dots"),
                 ("mcast", True, "dots"), ("mcast_bcast", True, "full"))
OPTIONS_ROUNDS = 3


def train_options(base: dict[str, tuple[list, list]]) -> None:
    """Phase 4b: training at full width with ``CollectiveConfig.prefetch``
    and ``remat="dots"``, alone and together (``TRAIN_OPTIONS``), beside
    phase 4's mcast step. Each variant: a warm-up step, its peak memory
    above what was resident before its state was made; then
    ``OPTIONS_ROUNDS`` rounds of one timed step of every variant, the order
    reversed each round, each step launching what ``_train_launches``
    counts; then a profiled step (``_profiled_step``). The first-step loss
    must be phase 4's bitwise (``base``: its losses and grad norms by
    mode), the grad norms within 1e-4 relative of phase 4's over the same
    steps; under prefetch the profiler must show the gathers on a stream
    that no matmul runs on."""
    cfg = get_model_config("smollm-135m")
    mesh = StackedMesh(data=8, model=1)
    tree = bridge.random_params(cfg, seed=0)
    pipe = SyntheticPipeline(cfg, TRAIN_SHAPE)
    batches = [pipe.next_batch(i) for i in range(OPTIONS_ROUNDS + 2)]
    runs = {}
    for mode, prefetch, remat in TRAIN_OPTIONS:
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        run = _train_run(cfg, TRAIN_SHAPE, mode, prefetch=prefetch, remat=remat)
        _, _, step = make_train_step(run, mesh)
        state = init_state(run, mesh, tree)
        t0 = time.perf_counter()
        state, m = step(state, batches[0])   # warm-up
        losses, norms = [float(m["loss"])], [float(m["grad_norm"])]
        torch.cuda.synchronize()
        runs[mode, prefetch, remat] = {
            "step": step, "state": state, "losses": losses, "norms": norms, "samples": [],
            "want": _train_launches(cfg, mesh, mode, prefetch=prefetch, remat=remat),
            "row": {"mode": mode, "prefetch": prefetch, "remat": remat,
                    "warmup_step_ms": (time.perf_counter() - t0) * 1e3,
                    "peak_memory_gib": (torch.cuda.max_memory_allocated() - resident) / 2**30}}
    for r in range(OPTIONS_ROUNDS):
        for key in (TRAIN_OPTIONS if r % 2 == 0 else TRAIN_OPTIONS[::-1]):
            v = runs[key]
            (v["state"], m), dt, counts = _run(lambda: v["step"](v["state"], batches[r + 1]))
            v["losses"].append(float(m["loss"]))
            v["norms"].append(float(m["grad_norm"]))
            v["samples"].append(dt)
            if counts != v["want"]:
                raise AssertionError(f"{key}: launches per train step {counts}, expected "
                                     f"{v['want']}")
    for key, v in runs.items():
        mode, prefetch, remat = key
        row = {**v["row"], "losses": v["losses"], "grad_norms": v["norms"],
               **_step_times(v["samples"]), "launches_per_step": v["want"],
               **_profiled_step(v["step"], v["state"], batches[OPTIONS_ROUNDS + 1],
                                f"{mode} prefetch={prefetch} remat={remat} step")}
        _check_losses(cfg, str(key), v["losses"], v["norms"])
        losses, norms = base[mode]
        if v["losses"][0] != losses[0]:
            raise AssertionError(f"{key}: first-step loss {v['losses'][0]!r} is not phase 4's "
                                 f"{losses[0]!r}")
        for got, ref in zip(v["norms"], norms):
            if abs(got - ref) > 1e-4 * abs(ref):
                raise AssertionError(f"{key}: grad norms {v['norms']} vs phase 4's {norms}")
        if prefetch and (not row["gather_streams"]
                         or set(row["gather_streams"]) & set(row["matmul_streams"])):
            raise AssertionError(f"{key}: the profiler shows the gathers on streams "
                                 f"{row['gather_streams']}, the matmuls on "
                                 f"{row['matmul_streams']}")
        print("[train-options] " + json.dumps(row), flush=True)


# ------------------------------------ phase 4c: checkpoints, restart, a replicated batch

# the train state of smollm-135m in bytes: 134,515,008 parameters (35,136 of
# them f32 norm scales, the rest bf16), two f32 moments, a 4-byte step
CKPT_BYTES = 1_345_220_352 + 4
REPL_SHAPE = ShapeConfig("train", "train", 512, 4)   # 4 rows on 8 ranks: replicated
REPL_TIMED = 2
CKPT_TIMED = 3


def _stored(state) -> dict[str, np.ndarray]:
    """Every leaf's global array as a checkpoint stores it, by key."""
    return {k: a for k, (a, _) in host_arrays(state).items()}


def _same_arrays(got: dict, want: dict, what: str) -> None:
    """Two dicts of arrays equal key for key, bit for bit."""
    if sorted(got) != sorted(want):
        raise AssertionError(f"{what}: keys differ")
    for key, b in want.items():
        a = got[key]
        if (a.dtype != b.dtype or a.shape != b.shape
                or not np.array_equal(a.view(f"u{a.itemsize}"), b.view(f"u{b.itemsize}"))):
            raise AssertionError(f"{what}: {key} differs")


def restart(cfg, mesh: StackedMesh, tree, tmp: str) -> dict:
    """Phase 4c (a): a supervisor run of 6 mcast steps at ``TRAIN_SHAPE``, an
    async checkpoint every 2, an injected failure at step 5: steps 0 to 4,
    the restore of step 4's checkpoint, steps 4 and 5. Against 6 steps from
    a fresh ``init_state`` with no checkpoint: every loss of a step both
    ran, and every parameter, moment and the step after the last, bitwise."""
    run = _train_run(cfg, TRAIN_SHAPE, "mcast")
    _, _, step = make_train_step(run, mesh)
    pipe = SyntheticPipeline(cfg, TRAIN_SHAPE)
    ckpt_dir = os.path.join(tmp, "restart")
    sup = TrainSupervisor(step_fn=step, pipeline=pipe, ckpt_dir=ckpt_dir, ckpt_every=2,
                          injector=FailureInjector(fail_at_steps=(5,)), async_ckpt=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, hist = sup.run(init_state(run, mesh, tree), 6)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    executed = [h["step"] for h in hist]
    if executed != [0, 1, 2, 3, 4, 4, 5] or latest_step(ckpt_dir) != 6:
        raise AssertionError(f"restart: executed {executed}, latest checkpoint "
                             f"{latest_step(ckpt_dir)}")
    fresh = init_state(run, mesh, tree)
    losses = []
    for i in range(6):
        fresh, m = step(fresh, pipe.next_batch(i))
        losses.append(float(m["loss"]))
    for h in hist:
        if h["loss"] != losses[h["step"]]:
            raise AssertionError(f"restart: step {h['step']} loss {h['loss']!r}, uninterrupted "
                                 f"{losses[h['step']]!r}")
    if state.opt.step != fresh.opt.step or state.opt.step != 6:
        raise AssertionError(f"restart: opt step {state.opt.step} vs {fresh.opt.step}")
    _same_arrays(_stored(state), _stored(fresh), "restarted vs uninterrupted state")
    del fresh
    row = {"executed": executed, "losses": [h["loss"] for h in hist],
           "uninterrupted_losses": losses, "supervisor_dt_ms": [h["dt"] * 1e3 for h in hist],
           "wall_s": wall_s}
    print("[ckpt] (a) restart equals the uninterrupted run bitwise: " + json.dumps(row),
          flush=True)
    return {"state": state, "step": step, "pipe": pipe, "dir": ckpt_dir, "row": row}


def checkpoint_times(a: dict, tmp: str) -> dict:
    """Phase 4c (b): the checkpoint's bytes; ``CKPT_TIMED`` async saves of
    the state (host copy: until ``save`` returns; write: until its future
    ends) and restores (until the state is on the card); then steps in
    turns, one with nothing behind it and one right after an async save's
    host copy while its files are written, each synchronised; and a step's
    host issue time (until ``step_fn`` returns, unsynchronised), which is
    what the supervisor's ``dt`` reads."""
    state, step, pipe = a["state"], a["step"], a["pipe"]
    d = os.path.join(tmp, "timed")
    nbytes = sum(arr.nbytes for arr, _ in host_arrays(state).values())
    if nbytes != CKPT_BYTES:
        raise AssertionError(f"checkpoint holds {nbytes} bytes, expected {CKPT_BYTES}")
    copy_ms, write_ms, restore_ms = [], [], []
    for i in range(CKPT_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fut = save(state, d, 100 + i, blocking=False)
        t1 = time.perf_counter()
        fut.result()
        t2 = time.perf_counter()
        back, _ = restore(d, 100 + i, state)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        if not back.params["embed"].local.is_cuda:
            raise AssertionError("restore left the state off the card")
        copy_ms.append((t1 - t0) * 1e3)
        write_ms.append((t2 - t1) * 1e3)
        restore_ms.append((t3 - t2) * 1e3)
        del back
        shutil.rmtree(os.path.join(d, f"step_{100 + i:08d}"))
    plain, behind, issue = [], [], []
    batch = pipe.next_batch(6)
    for i in range(CKPT_TIMED):
        (state, _), dt, _ = _run(lambda s=state: step(s, batch))
        plain.append(dt * 1e3)
        fut = save(state, d, 200 + i, blocking=False)
        (state, _), dt, _ = _run(lambda s=state: step(s, batch))
        behind.append(dt * 1e3)
        fut.result()
        shutil.rmtree(os.path.join(d, f"step_{200 + i:08d}"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        issue.append((time.perf_counter() - t0) * 1e3)
        float(m["loss"])
    a["state"] = state
    row = {"bytes": nbytes, "host_copy_ms": statistics.median(copy_ms),
           "host_copy_ms_samples": copy_ms, "write_ms": statistics.median(write_ms),
           "write_ms_samples": write_ms, "restore_ms": statistics.median(restore_ms),
           "restore_ms_samples": restore_ms,
           "step_ms": statistics.median(plain), "step_ms_samples": plain,
           "step_ms_async_save_behind": statistics.median(behind),
           "step_ms_async_save_behind_samples": behind,
           "step_issue_ms": statistics.median(issue), "step_issue_ms_samples": issue}
    print("[ckpt] (b) " + json.dumps(row), flush=True)
    return row


def elastic(cfg, a: dict) -> dict:
    """Phase 4c (c): step 4's checkpoint restored into ``(data=4, model=1)``
    and ``(pod=2, data=4, model=1)``: every array bitwise the saved one;
    then one mcast step on ``(data=4, model=1)`` from it, whose loss is
    within 1e-5 relative of step 4's on 8 ranks (the same forward per row;
    the loss summed in another order)."""
    with np.load(os.path.join(a["dir"], "step_00000004", "arrays.npz")) as npz:
        saved = {k.replace("%", "/"): npz[k] for k in npz.files}
    row = {}
    for axes, mesh_cfg in (({"data": 4, "model": 1}, MeshConfig()),
                           ({"pod": 2, "data": 4, "model": 1}, MeshConfig(multi_pod=True))):
        mesh = StackedMesh(**axes)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        back, manifest = restore(a["dir"], 4, a["state"], mesh=mesh, mesh_cfg=mesh_cfg)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        wq = back.params["blocks"]["attn"]["wq"].local
        if wq.shape[0] != mesh.n_ranks or not wq.is_cuda or back.opt.step != 4:
            raise AssertionError(f"elastic restore into {mesh}: wq {tuple(wq.shape)} on "
                                 f"{wq.device}, step {back.opt.step}")
        _same_arrays(_stored(back), saved, f"elastic restore into {mesh}")
        row[repr(mesh)] = {"restore_ms": ms, "ranks": mesh.n_ranks}
        if "pod" in axes:
            continue
        run = _train_run(cfg, TRAIN_SHAPE, "mcast")
        _, _, step = make_train_step(run, mesh)
        _, m = step(back, a["pipe"].next_batch(4))
        loss, want = float(m["loss"]), a["row"]["uninterrupted_losses"][4]
        if not abs(loss - want) <= 1e-5 * abs(want) or not np.isfinite(float(m["grad_norm"])):
            raise AssertionError(f"step on {mesh} after the elastic restore: loss {loss} vs "
                                 f"{want} on 8 ranks")
        row[repr(mesh)].update(loss=loss, loss_8_ranks=want, grad_norm=float(m["grad_norm"]))
        del back, m
    print("[ckpt] (c) elastic restore bitwise: " + json.dumps(row), flush=True)
    return row


def launcher(tmp: str) -> None:
    """Phase 4c (d): the train launcher in this process, 4 replicated mcast
    steps at batch 4 x 512 with a checkpoint every 2."""
    d = os.path.join(tmp, "launcher")
    train_launcher.main(["--arch", "smollm-135m", "--steps", "4", "--ckpt-every", "2",
                         "--batch", "4", "--seq", "512", "--fsdp-mode", "mcast",
                         "--ckpt-dir", d, "--log-every", "1"])
    if latest_step(d) != 4:
        raise AssertionError(f"the launcher's latest checkpoint is {latest_step(d)}, not 4")


def replicated_train(cfg, mesh: StackedMesh, tree) -> dict:
    """Phase 4c (e): training at global batch 4 x 512 on the 8 ranks, every
    rank the whole batch, in every mode: each step launching what phase 4's
    does; the first-step loss bitwise equal in every mode."""
    pipe = SyntheticPipeline(cfg, REPL_SHAPE)
    batches = [pipe.next_batch(i) for i in range(REPL_TIMED + 2)]
    first = {}
    for mode in MODES:
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        row, _ = _train_steps(cfg, mesh, tree, batches, mode, REPL_TIMED,
                              _train_launches(cfg, mesh, mode), shape=REPL_SHAPE)
        row["peak_memory_gib"] = (torch.cuda.max_memory_allocated() - resident) / 2**30
        print("[replicated] " + json.dumps(row), flush=True)
        first[mode] = row["losses"][0]
    if len(set(first.values())) != 1:
        raise AssertionError(f"replicated first-step losses differ between modes: {first}")
    return first


def replicated_serving(cfg, mesh: StackedMesh) -> dict:
    """Phase 4c (e): serving 4 prompts of ``PROMPT`` tokens and ``NEW`` new
    tokens on the 8 ranks in every mode: (4, V) logits, a (L, 4, ...) cache,
    (4, PROMPT + NEW) tokens, all equal to xla's; 210 gathers a prefill in
    the mcast modes, no transpose."""
    params = bridge.to_torch(bridge.random_params(cfg, seed=0), mesh, MeshConfig(),
                             dtype=torch.bfloat16)
    b = REPL_SHAPE.global_batch
    tokens = torch.from_numpy(
        np.random.default_rng(5).integers(0, cfg.vocab_size, (b, PROMPT))).cuda()
    n_sharded = sum(1 for leaf in tree_leaves(params["blocks"])
                    if is_sharded(leaf.spec, ("data",)))
    ref, rows = None, {}
    for mode in MODES:
        run = RunConfig(model=cfg, shape=ShapeConfig("serve", "prefill", PROMPT, b),
                        collective=CollectiveConfig(fsdp_mode=mode, n_chains=N_CHAINS))
        _, ctx, prefill = make_prefill_step(run, mesh)
        _, _, decode = make_decode_step(run, mesh)
        (logits, pre), prefill_s, counts = _run(lambda: prefill(params, {"tokens": tokens}))
        out, gen_s, _ = _run(lambda: greedy_generate(prefill, decode, params, tokens, NEW,
                                                     PROMPT + NEW))
        want = 0 if mode == "xla" else cfg.num_layers * n_sharded
        if (ctx.shard_batch or logits.shape != (b, cfg.vocab_size)
                or pre["k"].shape[:2] != (cfg.num_layers, b)
                or out.shape != (b, PROMPT + NEW) or not torch.isfinite(logits).all()):
            raise AssertionError(f"replicated serving {mode}: logits {tuple(logits.shape)}, "
                                 f"cache {tuple(pre['k'].shape)}, tokens {tuple(out.shape)}")
        if counts["ring_allgather"] != want or any(
                counts[k] for k in OFF_PATH + ("ring_step", "ring_allgather_transpose")):
            raise AssertionError(f"replicated serving {mode}: prefill launched {counts}")
        if ref is None:
            ref = (logits, out)
        if not torch.equal(logits, ref[0]) or not torch.equal(out, ref[1]):
            raise AssertionError(f"replicated serving {mode} differs from xla")
        rows[mode] = {"prefill_ms": prefill_s * 1e3, "generate_ms": gen_s * 1e3,
                      "gathers_per_prefill": counts["ring_allgather"],
                      "sample_tokens": out[0, PROMPT:PROMPT + 8].tolist()}
    print("[replicated] serving, logits and tokens equal in every mode: " + json.dumps(rows),
          flush=True)
    return rows


def checkpoint_phase(cfg) -> None:
    """Phase 4c: (a) to (e), the checkpoints under one ``mkdtemp`` removed
    before the phase ends."""
    mesh = StackedMesh(data=8, model=1)
    tree = bridge.random_params(cfg, seed=0)
    tmp = tempfile.mkdtemp()
    try:
        a = restart(cfg, mesh, tree, tmp)
        checkpoint_times(a, tmp)
        elastic(cfg, a)
        del a
        torch.cuda.empty_cache()
        launcher(tmp)
    finally:
        shutil.rmtree(tmp)
    replicated_train(cfg, mesh, tree)
    replicated_serving(cfg, mesh)


# ------------------------------------------------------- packet broadcast

# name: (hosts, bytes, WorkerParams, loss per leaf, seed); FabricParams() for
# both (MTU 4096, 1 us jitter), aggregated NACKs
BCASTS = {"A": (512, 64 << 20, dict(n_recv_workers=8), 1e-3, 0),
          "B": (64, 64 << 20, dict(), ("ge", 0.01, 8.0), 4)}


def _bcast(name: str, device: str) -> PK.PacketBcastResult:
    p, n_bytes, wk, loss, seed = BCASTS[name]
    if isinstance(loss, tuple):
        loss = PK.GilbertElliottLoss.from_rate(loss[1], mean_burst=loss[2])
    return PK.simulate_packet_broadcast(p, n_bytes, E.FabricParams(), E.WorkerParams(**wk),
                                        np.random.default_rng(seed), loss=loss,
                                        collect_delivery=True, device=device)


def _same_fields(a, b, what: str, skip: tuple = ()) -> None:
    """Every field of two results (dataclasses, dicts, lists, numbers),
    exactly: arrays element for element, dicts key for key and in order;
    the dataclass fields named in ``skip`` (a search's wall clock) aside."""
    if dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            if f.name not in skip:
                _same_fields(getattr(a, f.name), getattr(b, f.name), f"{what}.{f.name}", skip)
    elif isinstance(a, np.ndarray):
        if a.dtype != b.dtype or not np.array_equal(a, b):
            raise AssertionError(f"{what}: arrays differ")
    elif isinstance(a, dict):
        if list(a) != list(b):
            raise AssertionError(f"{what}: keys differ")
        for k in a:
            _same_fields(a[k], b[k], f"{what}[{k!r}]", skip)
    elif isinstance(a, (list, tuple)):
        if len(a) != len(b):
            raise AssertionError(f"{what}: lengths differ")
        for i, (x, y) in enumerate(zip(a, b)):
            _same_fields(x, y, f"{what}[{i}]", skip)
    elif a != b:
        raise AssertionError(f"{what}: {a!r} != {b!r}")


def _exact(name: str, got, want, case) -> float:
    """Raise unless every tensor of ``got`` equals ``want``; the max abs
    difference (0.0 when equal) for the kernels line."""
    err = 0.0
    for g, w in zip(got, want):
        if g.dtype == torch.uint32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        same = g == w
        if not bool(same.all()):
            diff = (g.double() - w.double()).abs()
            err = max(err, float(diff[~same].max()))
            raise AssertionError(f"{name} != plain at {case}: max abs err {err}")
    return err


def _flag_forms(flags: torch.Tensor, gen: torch.Generator) -> list[torch.Tensor]:
    """One flag pattern in every form the pack takes: bool; uint8 of 2 to
    255 where set; int32 of -1 or 1 << 31 where set; uint8 and int32 views
    whose base lies 1, 4 and 8 bytes (uint8) or 4 bytes (int32) off 16,
    which the C entry sends to its warp-per-word kernel."""
    big = torch.randint(2, 256, flags.shape, generator=gen, device="cuda", dtype=torch.uint8)
    sign = torch.randint(0, 2, flags.shape, generator=gen, device="cuda", dtype=torch.int32)
    forms = [flags, torch.where(flags, big, 0),
             torch.where(flags, torch.where(sign == 1, -1, -(1 << 31)), 0).to(torch.int32)]
    for f, offsets in ((forms[1], (1, 4, 8)), (forms[2], (1,))):
        for off in offsets:
            base = torch.empty(f.numel() + off, dtype=f.dtype, device="cuda")
            view = base[off:].view(f.shape)
            view.copy_(f)
            forms.append(view)
    return forms


def _or_rows_inputs(rows: int, n_words: int, gen: torch.Generator):
    """(pattern, int32 words (rows, n_words)) for the OR check: all zero,
    all ones, bit 31 of the last row's last word alone, sparse random words
    (a row's word kept with chance 2 / rows), and those random words as a
    view whose base lies 4 bytes off 16 (the C entry's single-word path)."""
    zero = torch.zeros((rows, n_words), dtype=torch.int32, device="cuda")
    last = zero.clone()
    if rows:
        last[-1, -1] = -(1 << 31)
    rand = torch.randint(-(1 << 31), 1 << 31, (rows, n_words), generator=gen, device="cuda",
                         dtype=torch.int64).to(torch.int32)
    rand *= torch.rand((rows, n_words), generator=gen, device="cuda") < 2 / max(rows, 1)
    base = torch.empty(rows * n_words + 1, dtype=torch.int32, device="cuda")
    off = base[1:].view(rows, n_words)
    off.copy_(rand)
    return (("zero", zero), ("ones", torch.full_like(zero, -1)), ("last bit", last),
            ("random", rand), ("off 16 bytes", off))


def check_rx_kernels() -> dict[str, tuple[int, float]]:
    """Phase 1: the receive datapath's kernels vs their plain versions,
    exactly. Returns {kernel: (cases, max abs err)}."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    out: dict[str, list] = {k: [0, 0.0] for k in PACKET_KERNELS}

    def record(name, got, want, case):
        torch.cuda.synchronize()
        out[name][1] = max(out[name][1], _exact(name, got, want, case))
        out[name][0] += 1

    for w in POOL_WORKERS:
        edge = PL.tile_plan(w)[2]   # a tile of the kernel's plan
        for rows in (1, 7, 63, 511):
            for n in sorted({1, 31, w - 1, w + 1, 4096, 16384, 16389, edge - 1, edge + 1} - {0}):
                a = torch.rand((rows, n), generator=gen, device="cuda", dtype=torch.float64)
                a = torch.sort(torch.round(a * 40) / 4, dim=1).values   # tied arrivals
                if rows > 1:
                    a[rows // 2, n // 3:] = float("inf")                # a ragged row
                for staging in (0, 3, 8192, n + 5):
                    record("pool", PL.pool_completion_rows(a, w, 0.3, staging),
                           PL.pool_completion_rows_plain(a, w, 0.3, staging),
                           (rows, n, w, staging))
                record("pool", (PL.pool_scan_rows(a, w, 0.3),),
                       (PL.pool_scan_rows_plain(a, w, 0.3),), (rows, n, w, None))
    for shape in ((32,), (16384,), (1, 16416), (7, 4096), (1, 1 << 20), (16, 1 << 20),
                  (511, 16384), (512, 16416)):
        for density in (0.3, 1e-3):
            flags = torch.rand(shape, generator=gen, device="cuda") < density
            for f in _flag_forms(flags, gen):
                record("bitmap_pack", (BM.bitmap_pack(f),), (BM.bitmap_pack_plain(f),),
                       (shape, density, f.dtype, f.storage_offset()))
            if len(shape) == 1:
                continue
            words = BM.bitmap_pack(flags)
            record("bitmap_or_rows", (BM.bitmap_or_rows(words),),
                   (BM.bitmap_or_rows_plain(words),), shape)
            record("bitmap_popcount", (BM.bitmap_popcount_rows(words), BM.bitmap_popcount(words)),
                   (BM.bitmap_popcount_rows_plain(words), BM.bitmap_popcount_plain(words)),
                   shape)
    for rows in OR_ROWS:
        for n_words in OR_WORDS:
            for case, w in _or_rows_inputs(rows, n_words, gen):
                words = w.view(torch.uint32)
                record("bitmap_or_rows", (BM.bitmap_or_rows(words),),
                       (BM.bitmap_or_rows_plain(words),), (rows, n_words, case))
    # popcount rows on both sides of the one-strip limit (and empty rows),
    # with no bit, one bit and random bits set
    one = POPCOUNT_STRIP_WORDS
    for rows, n_words in ((1, one), (1, one + 1), (3, one), (2, one + 1), (1, 1), (2, 0)):
        zero = torch.zeros((rows, n_words), dtype=torch.int32, device="cuda")
        single = zero.clone()
        if n_words:
            single[:, n_words // 2] = -(1 << 31)   # bit 31 alone
        rand = torch.randint(-(1 << 31), 1 << 31, (rows, n_words), generator=gen, device="cuda",
                             dtype=torch.int64).to(torch.int32)
        for case, w in (("none", zero), ("one", single), ("random", rand)):
            words = w.view(torch.uint32)
            record("bitmap_popcount", (BM.bitmap_popcount_rows(words), BM.bitmap_popcount(words)),
                   (BM.bitmap_popcount_rows_plain(words), BM.bitmap_popcount_plain(words)),
                   (rows, n_words, case))
    for dtype in (torch.uint8, torch.bfloat16, torch.float32, torch.int32):
        for chunk in (4096 // torch.empty((), dtype=dtype).element_size(), 1023):
            for n_staged, n_chunks, n_valid, dups in ((20, 32, 15, True), (300, 100, 250, True),
                                                      (10, 16, 0, True), (64, 64, 64, False)):
                staging = (torch.rand((n_staged, chunk), generator=gen, device="cuda")
                           * 100).to(dtype)
                psn = (torch.randint(0, n_chunks, (n_staged,), generator=gen, device="cuda")
                       if dups else torch.randperm(n_chunks, generator=gen, device="cuda"))
                user = (torch.rand((n_chunks, chunk), generator=gen, device="cuda")
                        * 100).to(dtype)
                for p in (psn, psn.to(torch.int32)):   # both PSN types, read in place
                    record("chunk_reassembly",
                           CR.chunk_reassembly(staging, p, user.clone(), n_valid),
                           CR.chunk_reassembly_plain(staging, p, user.clone(), n_valid),
                           (dtype, chunk, n_staged, n_chunks, n_valid, p.dtype))
    return {k: (c, e) for k, (c, e) in out.items()}


def check_no_sync() -> int:
    """The reassembly and popcount wrappers under
    ``torch.cuda.set_sync_debug_mode("error")``: any call that synchronises
    with the host raises. Both PSN types; popcount rows of one strip and of
    several. Returns the calls made; each result equals its plain version."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    staging = torch.randint(0, 256, (300, 4096), generator=gen, device="cuda", dtype=torch.uint8)
    psn = torch.randint(0, 100, (300,), generator=gen, device="cuda")
    user = torch.zeros((100, 4096), device="cuda", dtype=torch.uint8)
    words = [torch.randint(-(1 << 31), 1 << 31, (2, n), generator=gen, device="cuda",
                           dtype=torch.int64).to(torch.int32).view(torch.uint32)
             for n in (512, POPCOUNT_STRIP_WORDS + 1)]
    calls = [lambda p=p: CR.chunk_reassembly(staging, p, user.clone(), 250)
             for p in (psn, psn.to(torch.int32))]
    calls += [f for w in words for f in (lambda w=w: (BM.bitmap_popcount(w),),
                                         lambda w=w: (BM.bitmap_popcount_rows(w),))]
    for call in calls:   # warm-up: libraries loaded, allocator's blocks cached
        call()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = [call() for call in calls]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = [CR.chunk_reassembly_plain(staging, p, user.clone(), 250)
            for p in (psn, psn.to(torch.int32))]
    want += [f for w in words for f in ((BM.bitmap_popcount_plain(w),),
                                        (BM.bitmap_popcount_rows_plain(w),))]
    for k, (g, w) in enumerate(zip(got, want)):
        _exact("no-sync call", g, w, k)
    return len(calls)


def replay(res: PK.PacketBcastResult, n_bytes: int) -> int:
    """Every leaf's receive datapath replayed in its delivery order into a
    zeroed buffer: it must rebuild the root's buffer, its bitmap full."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    src = protocol.segment(torch.randint(0, 256, (n_bytes,), generator=gen, device="cuda",
                                         dtype=torch.uint8))
    for leaf in res.delivery_order:
        user, flags = protocol.reassemble(res, src, leaf)
        got = int(BM.bitmap_popcount(BM.bitmap_pack(flags)))
        if got != src.shape[0] or not torch.equal(user, src):
            raise AssertionError(f"leaf {leaf}: replay rebuilt {got} of {src.shape[0]} chunks, "
                                 f"buffer equal: {torch.equal(user, src)}")
    return len(res.delivery_order)


def packet_path() -> tuple[dict[str, int], dict[str, PK.PacketBcastResult]]:
    """Phase 5: broadcasts A and B on the card against their CPU runs, and
    the delivery replay. Returns the path's launches and the card results."""
    cpu, cpu_wall = {}, {}
    for name in BCASTS:
        cpu[name] = _bcast(name, "cpu")   # also the warm-up of its timing
        cpu_wall[name] = _wall(lambda name=name: _bcast(name, "cpu"))
    _zero_counts()   # counts from here to the read are the packet path's
    card = {name: _bcast(name, "cuda") for name in BCASTS}
    leaves = replay(card["A"], BCASTS["A"][1])
    torch.cuda.synchronize()
    counts = _counts()
    for name in PACKET_KERNELS:
        if counts[name] == 0:
            raise AssertionError(f"{name} was not launched on the packet path: {counts}")
    calls = rx_shapes(card)
    for name in calls:   # the shapes timed later are every call's
        if counts[name] != len(calls[name]):
            raise AssertionError(f"{name}: {counts[name]} launches on the packet path, "
                                 f"{len(calls[name])} calls in its round traces")
    for name in BCASTS:
        _same_fields(card[name], cpu[name], f"broadcast {name}, card vs CPU")
    print(f"[packet] A and B on the card equal their CPU runs field for field; all {leaves} "
          f"leaves of A rebuilt the root's buffer by reassembly", flush=True)
    dev, prof_ms = _device_times(lambda: replay(card["A"], BCASTS["A"][1]))
    print("[packet] replay of A, device ms of the whole replay: "
          + json.dumps({"reassembly_winner_kernel": sum(t for k, t in dev.items()
                                                        if "winner_kernel" in k),
                        "reassembly_scatter_kernel": sum(t for k, t in dev.items()
                                                         if "scatter_" in k),
                        "memset": sum(t for k, t in dev.items() if "emset" in k),
                        "popcount": sum(t for k, t in dev.items() if "popcount" in k),
                        "busy_ms": sum(dev.values()), "profiled_wall_ms": prof_ms,
                        "leaves": leaves}), flush=True)
    for name in BCASTS:
        def call(name=name):
            return _bcast(name, "cuda")

        _, _, per_call = _run(call)
        wall = _wall(call)
        dev, prof_ms = _device_times(call)
        busy = sum(dev.values())
        res = card[name]
        p, n_bytes, wk, loss, seed = BCASTS[name]
        row = {"broadcast": name, "hosts": p, "bytes": n_bytes, "workers": wk, "loss": loss,
               "seed": seed, "rounds": [dataclasses.astuple(r) for r in res.rounds],
               "time_s": res.time, "rnr_drops": res.rnr_drops, "recovered": res.recovered,
               "duplicates": res.duplicates, "completed": res.completed,
               "wall_ms_median": statistics.median(wall) * 1e3,
               "wall_ms_samples": [t * 1e3 for t in wall],
               "device_busy_ms": busy, "profiled_wall_ms": prof_ms,
               "device_idle_share": 1 - busy / prof_ms,
               "launches_per_call": {k: per_call[k] for k in PACKET_KERNELS},
               "kernel_device_ms": {k: sum(t for key, t in dev.items() if k in key)
                                    for k in ("pool_rows_kernel", "pack_kernel",
                                              "or_rows_kernel", "popcount_row")},
               "cpu_wall_ms_median": statistics.median(cpu_wall[name]) * 1e3,
               "cpu_wall_ms_samples": [t * 1e3 for t in cpu_wall[name]]}
        print("[packet] " + json.dumps(row), flush=True)
        top = sorted(dev.items(), key=lambda kv: -kv[1])[:8]
        print(f"[packet] {name}, top device time (ms): "
              + json.dumps({k[:60]: t for k, t in top}), flush=True)
    return counts, card


def rx_shapes(card: dict[str, PK.PacketBcastResult]) -> dict[str, list]:
    """Every call the packet path makes of the pool scan, the pack and the
    OR, from the broadcasts' round traces: the fast path's pool call over
    all leaves and, each round, a pool call over its NACKing leaves'
    retransmitted chunks, a pack of their flags and the OR of the packed
    rows; then one single-row pack per leaf in A's replay. {"pool": [((rows,
    n), W, staging), ...], "bitmap_pack": [shape, ...], "bitmap_or_rows":
    [(rows, words), ...]}, a call an entry, in the run's order."""
    fab = E.FabricParams()
    out: dict[str, list] = {"pool": [], "bitmap_pack": [], "bitmap_or_rows": []}
    for name, res in card.items():
        p, n_bytes, wk, _, _ = BCASTS[name]
        workers, n = E.WorkerParams(**wk), n_bytes // fab.mtu
        ring = (workers.n_recv_workers, workers.staging_chunks)
        out["pool"].append(((p - 1, n), *ring))
        for r in res.rounds:
            out["pool"].append(((r.nack_leaves, r.union_chunks), *ring))
            out["bitmap_pack"].append((r.nack_leaves, n))
            out["bitmap_or_rows"].append((r.nack_leaves, -(-n // 32)))
    out["bitmap_pack"] += [(BCASTS["A"][1] // fab.mtu,)] * len(card["A"].delivery_order)
    return out


def time_rx_shapes(calls: dict[str, list], service: float) -> dict[str, list[dict]]:
    """The pool scan, the pack and the OR at each distinct shape of
    ``calls`` (``rx_shapes``; a kernel missing from ``calls`` is skipped),
    in order of first call: ms a call from Python (``_time``), host issue
    (``_host_ms``), device ms (``_device_ms``), the plain version's ms, the
    bound (bytes over 3.35 TB/s: 8 B in and 17 B in all an element for the
    pool; each flag byte in and 4 B a word out for the pack; 4 B a word in
    and 4 B an output word out for the OR), the calls at that shape, and a
    yardstick the port never calls: for the pool the device ms of
    ``torch.cummax`` over the +inf-padded (R, ceil(n / W), W) view, the
    scan alone and not the function; for the pack and the OR the device ms
    of one ``copy_`` of their input bytes. Arrivals are sorted uniform rows,
    flags set at 1e-3 (the OR's words are such flags packed), all from a
    seed."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    out: dict[str, list[dict]] = {name: [] for name in calls}
    for (rows, n), w, staging in dict.fromkeys(calls.get("pool", ())):
        a = torch.sort(torch.rand((rows, n), generator=gen, device="cuda", dtype=torch.float64)
                       * (n * service), dim=1).values
        pad = (-n) % w
        view = F.pad(a, (0, pad), value=float("inf")).view(rows, (n + pad) // w, w)
        row = {"shape": [rows, n], "workers": w, "staging": staging,
               "calls": calls["pool"].count(((rows, n), w, staging)),
               **_kernel_times(lambda: PL.pool_completion_rows(a, w, service, staging),
                               lambda: PL.pool_completion_rows_plain(a, w, service, staging),
                               rows * n * 17),
               "cummax_scan_alone_device_ms": _device_ms(lambda: torch.cummax(view, 1))}
        print("[pool] " + json.dumps(row), flush=True)
        out["pool"].append(row)
    for shape in dict.fromkeys(calls.get("bitmap_pack", ())):
        flags = torch.rand(shape, generator=gen, device="cuda") < 1e-3
        copy = torch.empty_like(flags)
        row = {"shape": list(shape), "dtype": "bool", "calls": calls["bitmap_pack"].count(shape),
               **_kernel_times(lambda: BM.bitmap_pack(flags), lambda: BM.bitmap_pack_plain(flags),
                               flags.numel() + flags.numel() // 32 * 4),
               "copy_device_ms": _device_ms(lambda: copy.copy_(flags))}
        print("[bitmap_pack] " + json.dumps(row), flush=True)
        out["bitmap_pack"].append(row)
    for rows, n_words in dict.fromkeys(calls.get("bitmap_or_rows", ())):
        words = BM.bitmap_pack(torch.rand((rows, 32 * n_words), generator=gen,
                                          device="cuda") < 1e-3)
        copy = torch.empty_like(words)
        row = {"shape": [rows, n_words], "calls": calls["bitmap_or_rows"].count((rows, n_words)),
               **_kernel_times(lambda: BM.bitmap_or_rows(words),
                               lambda: BM.bitmap_or_rows_plain(words), (rows + 1) * n_words * 4),
               "copy_device_ms": _device_ms(lambda: copy.copy_(words))}
        print("[bitmap_or_rows] " + json.dumps(row), flush=True)
        out["bitmap_or_rows"].append(row)
    return out


def _kernel_times(kernel, plain, nbytes: int) -> dict[str, float]:
    return {"ms": _time(kernel), "host_ms": _host_ms(kernel), "device_ms": _device_ms(kernel),
            "plain_ms": _time(plain), "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}


def time_rx_kernels(card: dict[str, PK.PacketBcastResult]) -> dict[str, dict]:
    """Each receive-datapath kernel at the shape broadcast A gives it: ms
    per call from Python (CUDA events around back-to-back calls, ``_time``)
    of the kernel, its plain version and (for reassembly) one library call,
    ``index_copy_``; the kernel's host issue per call (``_host_ms``) and
    device ms per call (``_device_ms``; a reassembly call is a zero fill and
    two launches); beside the bound: bytes (each input read once, each
    output written once) over 3.35 TB/s, and for reassembly the device ms of
    a plain copy of the same rows (``copy_``, one cudaMemcpyAsync). The pool
    scan, the pack and the OR are timed at every shape the run gives them
    (``time_rx_shapes``); their rows here are A's first call of each."""
    res_a = card["A"]
    p, n_bytes, wk, _, _ = BCASTS["A"]
    fab, workers = E.FabricParams(), E.WorkerParams(**wk)
    n, chunk = n_bytes // fab.mtu, fab.mtu
    service = chunk / workers.thread_tput
    nackers = res_a.rounds[0].nack_leaves
    shaped = time_rx_shapes(rx_shapes(card), service)
    gen = torch.Generator(device="cuda").manual_seed(7)
    flags = torch.rand((nackers, n), generator=gen, device="cuda") < 1e-3
    agg = BM.bitmap_or_rows(BM.bitmap_pack(flags))
    src = torch.randint(0, 256, (n, chunk), generator=gen, device="cuda", dtype=torch.uint8)
    psn = torch.randperm(n, generator=gen, device="cuda")
    staging, user = src[psn], torch.zeros_like(src)
    w = n // 32
    cases = {
        "bitmap_popcount": ((w,), w * 4 + 8,
                            lambda: BM.bitmap_popcount(agg),
                            lambda: BM.bitmap_popcount_plain(agg), None),
        "chunk_reassembly": ((n, chunk), 2 * n * chunk + n * (psn.element_size() + 4),
                             lambda: CR.chunk_reassembly(staging, psn, user),
                             lambda: CR.chunk_reassembly_plain(staging, psn, user),
                             lambda: user.index_copy_(0, psn, staging)),
    }
    out = {name: {**rows[0], "library_ms": None} for name, rows in shaped.items()}
    for name, (shape, nbytes, kernel, plain, library) in cases.items():
        row = {"shape": shape, **_kernel_times(kernel, plain, nbytes),
               "library_ms": _time(library) if library else None}
        if name == "chunk_reassembly":   # the same bytes as one cudaMemcpyAsync
            row["memcpy_device_ms"] = _device_ms(lambda: user.copy_(staging))
        print(f"[{name}] " + json.dumps(row), flush=True)
        out[name] = row
    return out


# ------------------------------------------------------- packet allgather

# name: (hosts, bytes, WorkerParams, loss per leaf, jitter, seed); 4 chains,
# aggregated NACKs. AG-A is the reference's ag_dense point
# (benchmarks/paper_figs.py:381); AG-B the paper's 188-host testbed
AGS = {"AG-A": (128, 16 << 20, dict(n_recv_workers=8), None, 0.0, 0),
       "AG-B": (188, 4 << 20, dict(n_recv_workers=8), 1e-3, 1e-6, 0)}
AG_CHAINS = 4
AG_SAMPLES = 3
AG_KERNELS = ("pool", "bitmap_pack", "bitmap_or_rows", "bitmap_popcount")


def _ag(name: str, device: str) -> PK.PacketAllgatherResult:
    p, n_bytes, wk, loss, jitter, seed = AGS[name]
    return PK.simulate_packet_allgather(p, n_bytes, E.FabricParams(jitter=jitter),
                                        E.WorkerParams(**wk), np.random.default_rng(seed),
                                        AG_CHAINS, loss=loss, device=device)


def _ag_rounds(res: PK.PacketAllgatherResult) -> int:
    """The recovery rounds of a run: a round adds one RoundTrace for each of
    its live chains, all with the round's shared end time, and a later
    round (or generation) ends later, so a round is a run of traces with
    one ``t_end``."""
    ends = [r.t_end for r in res.rounds]
    return sum(1 for i, t in enumerate(ends) if i == 0 or t != ends[i - 1])


def ag_launches_implied(name: str, res: PK.PacketAllgatherResult) -> dict[str, int]:
    """The launches a run makes by its generations and round traces: one
    pool pass for each generation's fast path, and for each recovery round
    a pool pass and one pack, OR and popcount of every live chain's NACK
    union (one block of pool rows each at these sizes, which is checked)."""
    p, n_bytes = AGS[name][:2]
    n = n_bytes // E.FabricParams().mtu
    if p * AG_CHAINS * n > PK._BLOCK_ELEMS:
        raise AssertionError(f"{name}: the fast path's pool rows take more than one block")
    gens, rounds = -(-p // AG_CHAINS), _ag_rounds(res)
    return {"pool": gens + rounds, "bitmap_pack": rounds, "bitmap_or_rows": rounds,
            "bitmap_popcount": rounds}


def allgather_path() -> tuple[dict[str, int], dict]:
    """Phase 5b: the packet Allgather, AG-A and AG-B, on the card against
    the same call's CPU run, field for field; the launches of the card
    runs (counts zeroed before, read after) equal to what their
    generations and round traces imply, and nothing else launched. Then
    both on the card and on the CPU: wall ms (AG_SAMPLES synchronised
    calls after the first), the card's device busy ms, idle share and
    device ms per kernel from one profiled call, and the launches per
    call. Returns the path's launches and the shapes the pool, pack and
    OR were called at (``time_rx_shapes``' format)."""
    cpu, cpu_wall = {}, {}
    for name in AGS:
        cpu[name] = _ag(name, "cpu")
        cpu_wall[name] = _wall(lambda name=name: _ag(name, "cpu"), AG_SAMPLES)
    shapes: dict[str, list] = {"pool": [], "bitmap_pack": [], "bitmap_or_rows": []}
    pool_rows, pack, or_rows = PL.pool_completion_rows, BM.bitmap_pack, BM.bitmap_or_rows

    def record_pool(a, w, service, staging):
        shapes["pool"].append((tuple(a.shape), w, staging))
        return pool_rows(a, w, service, staging)

    def record_pack(flags):
        shapes["bitmap_pack"].append(tuple(flags.shape))
        return pack(flags)

    def record_or(words):
        shapes["bitmap_or_rows"].append(tuple(words.shape))
        return or_rows(words)

    PL.pool_completion_rows, BM.bitmap_pack, BM.bitmap_or_rows = (record_pool, record_pack,
                                                                  record_or)
    try:
        torch.cuda.synchronize()
        _zero_counts()   # counts from here to the read are the Allgather's path
        card = {name: _ag(name, "cuda") for name in AGS}
        torch.cuda.synchronize()
        counts = _counts()
    finally:
        PL.pool_completion_rows, BM.bitmap_pack, BM.bitmap_or_rows = pool_rows, pack, or_rows
    want = dict.fromkeys(counts, 0)
    for name, res in card.items():
        for k, v in ag_launches_implied(name, res).items():
            want[k] += v
    if counts != want:
        raise AssertionError(f"the Allgather launched {counts}; its generations and round "
                             f"traces imply {want}")
    if card["AG-B"].rounds == [] or card["AG-A"].rounds:
        raise AssertionError("AG-B must recover chunks and the lossless AG-A none")
    for name in AGS:
        _same_fields(card[name], cpu[name], f"allgather {name}, card vs CPU")
    print(f"[allgather] AG-A and AG-B on the card equal their CPU runs field for field; "
          f"launches {json.dumps({k: counts[k] for k in AG_KERNELS})} as their traces imply",
          flush=True)
    for name in AGS:
        def call(name=name):
            return _ag(name, "cuda")

        _, _, per_call = _run(call)
        wall = _wall(call, AG_SAMPLES)
        dev, prof_ms = _device_times(call)
        busy = sum(dev.values())
        res = card[name]
        p, n_bytes, wk, loss, jitter, seed = AGS[name]
        row = {"allgather": name, "hosts": p, "bytes": n_bytes, "chains": AG_CHAINS,
               "workers": wk, "loss": loss, "jitter": jitter, "seed": seed,
               "generations": -(-p // AG_CHAINS), "recovery_rounds": _ag_rounds(res),
               "round_traces": len(res.rounds), "time_s": res.time,
               "phases": dataclasses.asdict(res.phases), "recovered": res.recovered,
               "rnr_drops": res.rnr_drops, "completed": res.completed,
               "per_rank_recv_tput": res.per_rank_recv_tput,
               "wall_ms_median": statistics.median(wall) * 1e3,
               "wall_ms_samples": [t * 1e3 for t in wall],
               "device_busy_ms": busy, "profiled_wall_ms": prof_ms,
               "device_idle_share": 1 - busy / prof_ms,
               "launches_per_call": {k: per_call[k] for k in AG_KERNELS},
               "kernel_device_ms": {k: sum(t for key, t in dev.items() if k in key)
                                    for k in ("pool_rows_kernel", "pack_kernel",
                                              "or_rows_kernel", "popcount_row")},
               "cpu_wall_ms_median": statistics.median(cpu_wall[name]) * 1e3,
               "cpu_wall_ms_samples": [t * 1e3 for t in cpu_wall[name]]}
        print("[allgather] " + json.dumps(row), flush=True)
        top = sorted(dev.items(), key=lambda kv: -kv[1])[:8]
        print(f"[allgather] {name}, top device time (ms): "
              + json.dumps({k[:60]: t for k, t in top}), flush=True)
    return {k: counts[k] for k in AG_KERNELS}, shapes


def _largest(calls: dict[str, list], keep: dict[str, int]) -> dict[str, list]:
    """The calls of each kernel at its ``keep[name]`` distinct shapes of the
    most elements, every such call kept (``time_rx_shapes`` counts them)."""
    out = {}
    for name, k in keep.items():
        def size(c):
            shape = c[0] if name == "pool" else c
            return int(np.prod(shape))
        top = sorted(set(calls[name]), key=size, reverse=True)[:k]
        out[name] = [c for c in calls[name] if c in top]
    return out


# ------------------------------------------- phase 5c: the paper's figures

# Fig. 10 / 11: the UCC testbed's 56 Gbit/s links (benchmarks/paper_figs.py:53,70)
FIG_LINK = 56e9 / 8
FIG11_SIZES = (1 << 14, 1 << 17, 1 << 20)
FIG10_SIZES, FIG10_NODES = [4096, 1 << 17, 4 << 20], [2, 16, 188]
# Fig. 12 from routed engine runs: 64 KiB a rank on a k = 32 fat-tree
# (benchmarks/paper_figs.py:188, fabric_sweep)
FIG12_HOSTS = (128, 512, 1024)
FIG12_SHARD = 64 << 10
# the lossy routed Broadcast: the 188-host testbed (k = 16), 64 MiB, 2 workers
LOSSY_BCAST = (188, 64 << 20)


def fig11(device: str) -> list:
    """Fig. 11: fluid Allgathers at P = 188 of 16 KiB, 128 KiB and 1 MiB,
    one generator carried across the three."""
    fab = E.FabricParams(b_link=FIG_LINK)
    wk = E.WorkerParams(n_recv_workers=2, thread_tput=9.0 * (1 << 30))
    rng = np.random.default_rng(0)
    return [SIM.simulate_allgather(188, size, fab, wk, rng, device=device)
            for size in FIG11_SIZES]


def fig10(device: str) -> list[dict]:
    """Fig. 10: the phase breakdown up to 188 nodes."""
    return SIM.sweep_phase_breakdown(FIG10_SIZES, FIG10_NODES, seed=0, device=device)


def fig12_routed(device: str) -> list:
    """Fig. 12 from routed engine runs: at each P, the multicast Allgather
    (a tree flow a rank, one generation) and the P2P ring on the same
    k = 32 fat-tree; (P, Allgather result, ring time, ring link bytes)."""
    fab = E.FabricParams(p_drop=0.0, jitter=0.0)
    wk = E.WorkerParams(n_recv_workers=16)
    out = []
    for p in FIG12_HOSTS:
        topo = TOPO.FatTree(k=32, n_hosts=p, b_host=fab.b_link)
        ag = SIM.simulate_allgather(p, FIG12_SHARD, fab, wk, np.random.default_rng(0),
                                    n_chains=p, topology=topo, device=device)
        t_ring, ring_lb = CM.routed_ring_allgather(topo, p, p * FIG12_SHARD, fab,
                                                   device=device)
        out.append((p, ag, t_ring, ring_lb))
    return out


def lossy_bcast(device: str):
    """The lossy routed Broadcast: P = 188 on the testbed's k = 16 fat-tree,
    64 MiB, 1e-3 drops, 1 us jitter, 2 workers."""
    p, n_bytes = LOSSY_BCAST
    fab = E.FabricParams(p_drop=1e-3)
    topo = TOPO.FatTree(k=16, n_hosts=p, b_host=fab.b_link)
    return SIM.simulate_broadcast(p, n_bytes, fab, E.WorkerParams(n_recv_workers=2),
                                  np.random.default_rng(0), topology=topo, device=device)


def static_traffic() -> dict:
    """Figs. 2 and 12 as static counts (no engine): ring over multicast
    Allgather bytes on k = 32 / 1,024 hosts (1 MiB) and on the k = 16 /
    188-host testbed (64 KiB a rank), and the testbed's pipelined-ring
    Broadcast over multicast."""
    tree = TOPO.FatTree(k=32, n_hosts=1024)
    fig2 = (CM.p2p_ring_allgather_traffic(tree, 1024, 1 << 20)
            / CM.mcast_allgather_traffic(tree, 1024, 1 << 20))
    tree = TOPO.FatTree(k=16, n_hosts=188)
    n = 1 << 16
    fig12 = (CM.p2p_ring_allgather_traffic(tree, 188, n * 188)
             / CM.mcast_allgather_traffic(tree, 188, n * 188))
    fig12_bcast = (CM.p2p_ring_pipeline_bcast_traffic(tree, 188, n)
                   / CM.mcast_bcast_traffic(tree, 188, n))
    return {"fig2_allgather_ring_over_mcast": fig2, "fig12_allgather_ring_over_mcast": fig12,
            "fig12_bcast_ring_over_mcast": fig12_bcast}


def check_pool_rows() -> int:
    """The fluid Broadcast's row pass on the card (ragged rows padded with
    +inf, one launch) bitwise ``worker_pool_completion`` of each row's real
    prefix, where the staging ring overflows. Returns the rows checked."""
    rng = np.random.default_rng(7)
    lens = (0, 1, 255, 256, 257, 4096, 16384)
    rows = np.full((len(lens), max(lens)), np.inf)
    for k, n in enumerate(lens):
        rows[k, :n] = np.sort(rng.uniform(0.0, 2e-3, n))
    drops = 0
    for w, staging in ((1, 256), (2, 512), (7, 64)):
        done, mask = E.worker_pool_completion_rows(torch.from_numpy(rows).cuda(), w, 3e-7,
                                                   staging)
        done, mask = done.cpu().numpy(), mask.cpu().numpy()
        for k, n in enumerate(lens):
            want, rnr = E.worker_pool_completion(rows[k, :n], w, 3e-7, staging)
            if not np.array_equal(done[k, :n], want) or int(mask[k].sum()) != rnr \
                    or mask[k, n:].any():
                raise AssertionError(f"pool rows != the 1-D pool: row of {n}, W = {w}")
            drops += rnr
    if not drops:
        raise AssertionError("the pool row check's staging ring never overflowed")
    return 3 * len(lens)


def _figure(name: str, fn, implied, tag: str = "figures", skip: tuple = ()) -> tuple:
    """One figure (or cell) on the CPU, then on the card under the profiler
    (counts zeroed before, read after), field for field equal (the fields
    named in ``skip`` aside). Prints host
    ms on both (the card's with the profiler on), the card's busy ms and
    idle share, the solves and the launches of the receive kernels;
    ``implied(card result)``: the launches the run's generations and
    rounds imply, by kernel (the others none), which the card run must
    equal. Returns (card result, launches by kernel, the card run's engine
    counts)."""
    t0 = time.perf_counter()
    cpu = fn("cpu")
    cpu_ms = (time.perf_counter() - t0) * 1e3
    E.counts.update(dict.fromkeys(E.counts, 0))
    _zero_counts()
    out = []
    dev, card_ms = _device_times(lambda: out.append(fn("cuda")))
    card = out[0]
    counts, launches = dict(E.counts), {k: _counts()[k] for k in AG_KERNELS}
    _same_fields(card, cpu, f"{name}, card vs CPU", skip)
    want = {k: implied(card).get(k, 0) for k in AG_KERNELS}
    if launches != want:
        raise AssertionError(f"{name}: launches {launches}, its generations and rounds "
                             f"imply {want}")
    busy = sum(dev.values()) if dev else None   # no device record: not measured
    print(f"[{tag}] " + json.dumps({
        "figure": name, "card_host_ms": card_ms, "cpu_host_ms": cpu_ms,
        "device_busy_ms": busy, "device_idle_share": None if busy is None else 1 - busy / card_ms,
        **counts, "launches": launches,
        "top_device_ms": {k[:50]: t for k, t in sorted(dev.items(), key=lambda kv: -kv[1])[:4]}}),
        flush=True)
    return card, launches, counts


def figures_path() -> int:
    """Phase 5c: the paper's Figs. 2, 10, 11 and 12 at the reference's full
    sizes, each run on the card equal to the same call on the CPU field for
    field, each figure's bounds (benchmarks/paper_figs.py's asserts); the
    vectorized max-min solve on the card; the lossy Broadcast's leaves in one
    pool launch. Returns the phase's pool launches."""
    print(f"[figures] pool row pass == the 1-D pool on {check_pool_rows()} ragged rows, the "
          "staging ring overflowing", flush=True)
    total = 0
    res, n, _ = _figure("fig11", fig11, lambda _: {"pool": len(FIG11_SIZES) * 188})
    total += n["pool"]
    for size, ag in zip(FIG11_SIZES, res):
        ring_tput = (188 - 1) * size / CM.allgather_time_ring(size, FIG_LINK, 188)
        ratio = ag.per_rank_recv_tput / ring_tput
        print(f"[figures] fig11 {size} B: multicast {ag.per_rank_recv_tput / 1e9} GB/s a rank, "
              f"ring {ring_tput / 1e9}, ratio {ratio}", flush=True)
        if size == 1 << 17 and not 0.5 < ratio < 1.5:
            raise AssertionError(f"fig11: multicast / ring at 128 KiB {ratio}, not in (0.5, 1.5)")
    rows, n, _ = _figure("fig10", fig10,
                         lambda _: {"pool": len(FIG10_SIZES) * sum(FIG10_NODES)})
    total += n["pool"]
    for r in rows:
        print(f"[figures] fig10 P={r['nodes']} {r['bytes']} B: mcast_frac {r['mcast_frac']} "
              f"rnr {r['rnr_frac']} rel {r['reliability_frac']}", flush=True)
        if r["nodes"] >= 16 and r["bytes"] == 4 << 20 and not r["mcast_frac"] > 0.99:
            raise AssertionError(f"fig10: mcast_frac {r['mcast_frac']} at {r['nodes']} nodes")
    runs, n, counts = _figure("fig12_routed", fig12_routed,
                              lambda _: {"pool": len(FIG12_HOSTS)})
    total += n["pool"]
    if not counts["device_solves"]:
        raise AssertionError("fig12: no max-min solve ran its vectorized filling on the card")
    for p, ag, t_ring, ring_lb in runs:
        topo, hosts = TOPO.FatTree(k=32, n_hosts=p), list(range(p))
        edges = sum(len(topo.multicast_tree(h, hosts)) for h in hosts)
        hops = sum(len(topo.route(hosts[i], hosts[(i + 1) % p])) for i in range(p))
        mc_bytes, ring_bytes = sum(ag.link_bytes.values()), sum(ring_lb.values())
        mc_want, ring_want = FIG12_SHARD * edges, (p - 1) * FIG12_SHARD * hops
        t_bound = (p - 1) * FIG12_SHARD / E.FabricParams().b_link
        print(f"[figures] fig12 P={p}: multicast {mc_bytes} port bytes ({edges} tree edges), "
              f"ring {ring_bytes} ({hops} hops), ratio {mc_bytes / ring_bytes}; time "
              f"{ag.time} s, ring {t_ring}, bound {t_bound}", flush=True)
        if abs(mc_bytes - mc_want) > 1e-6 * mc_want or abs(ring_bytes - ring_want) > \
                1e-6 * ring_want:
            raise AssertionError(f"fig12 P={p}: bytes {mc_bytes} / {ring_bytes}, the trees and "
                                 f"routes give {mc_want} / {ring_want}")
        if not (mc_bytes <= 0.55 * ring_bytes if p >= 512 else mc_bytes < ring_bytes):
            raise AssertionError(f"fig12 P={p}: multicast / ring bytes {mc_bytes / ring_bytes}")
        if not 0.95 * t_bound <= ag.time <= t_ring:
            raise AssertionError(f"fig12 P={p}: time {ag.time} outside [{0.95 * t_bound}, "
                                 f"{t_ring}]")
    res, n, _ = _figure("lossy_broadcast", lossy_bcast, lambda _: {"pool": 1})
    total += n["pool"]
    print(f"[figures] lossy broadcast: time {res.time} s, recovered {res.recovered}, rnr "
          f"{res.rnr_drops}, phases {json.dumps(dataclasses.asdict(res.phases))}", flush=True)
    if not res.recovered:
        raise AssertionError("the lossy broadcast recovered no chunk")
    t0 = time.perf_counter()
    ratios = static_traffic()
    print(f"[figures] static counts {json.dumps(ratios)} "
          f"({(time.perf_counter() - t0) * 1e3} host ms)", flush=True)
    if not (1.5 <= ratios["fig2_allgather_ring_over_mcast"] <= 2.5
            and 1.5 <= ratios["fig12_allgather_ring_over_mcast"] <= 2.2
            and 1.3 <= ratios["fig12_bcast_ring_over_mcast"] <= 2.5):
        raise AssertionError(f"static traffic ratios out of the paper's bands: {ratios}")
    return total


# ------------------------------- phase 5d: routed packet and the FSDP step

# (a) protocol_loss_sweep's part A (benchmarks/paper_figs.py:255): 1 MiB
# Broadcasts at 0.1 % per-link loss on k = 16 (P <= 128) and k = 32
# fat-trees, 16 workers, no jitter, seeds 0 to 2; the no-aggregation
# ablation at the largest P
LOSS_SWEEP_P = (16, 64, 256, 512)
LOSS_SWEEP_SEEDS = (0, 1, 2)
LOSS_SWEEP_BYTES = 1 << 20
LINK_LOSS = 1e-3
# (b) AG-R: AG-B's Allgather (188 hosts x 4 MiB x 4 chains, 8 workers, 1 us
# jitter, seed 0) on the testbed's routed k = 16 fat-tree, per-link loss 1e-3
AGR = (188, 4 << 20, 4)
# (c) fsdp_contention_sweep's grid (benchmarks/paper_figs.py:777), abstract
# fluid; the routed step at P = 64 on FatTree(k = 8, n_hosts = 64); and
# multi_job_contention's two jobs (benchmarks/paper_figs.py:243)
FSDP_PS, FSDP_LAYER_BYTES, FSDP_LAYERS = (16, 64), (64e6, 256e6), 8
FSDP_ROUTED_P, FSDP_ROUTED_LAYERS, FSDP_ROUTED_BYTES = 64, 4, 256e6
OVERSUB = (1.0, 4.0)
MULTI_JOB_OVERSUB = (1.0, 2.0, 4.0)


def _sweep_topology(p: int, fab) -> TOPO.FatTree:
    return TOPO.FatTree(k=32 if p > 128 else 16, n_hosts=p, b_host=fab.b_link)


def loss_sweep(device: str) -> dict:
    """(a): every (P, seed) Broadcast aggregated, and the ablation's."""
    fab = E.FabricParams(jitter=0.0)
    wk = E.WorkerParams(n_recv_workers=16)
    runs = {}
    for p in LOSS_SWEEP_P:
        for s in LOSS_SWEEP_SEEDS:
            runs[f"P{p}.seed{s}"] = SIM.simulate_broadcast(
                p, LOSS_SWEEP_BYTES, fab, wk, np.random.default_rng(s),
                topology=_sweep_topology(p, fab), fidelity="packet", loss=LINK_LOSS,
                device=device)
    p1 = max(LOSS_SWEEP_P)
    runs["noagg"] = SIM.simulate_broadcast(
        p1, LOSS_SWEEP_BYTES, fab, wk, np.random.default_rng(LOSS_SWEEP_SEEDS[0]),
        topology=_sweep_topology(p1, fab), fidelity="packet", loss=LINK_LOSS,
        aggregate_nacks=False, device=device)
    return runs


def bcast_launches(runs: dict) -> dict[str, int]:
    """A routed Broadcast's launches: one pool pass for its fast path and
    one a round, one pack, OR and popcount a round (one block of rows each
    at these sizes)."""
    rounds = sum(len(r.rounds) for r in runs.values())
    return {"pool": len(runs) + rounds, "bitmap_pack": rounds, "bitmap_or_rows": rounds,
            "bitmap_popcount": rounds}


def ag_routed(device: str) -> PK.PacketAllgatherResult:
    """(b) AG-R."""
    p, n_bytes, m = AGR
    return SIM.simulate_allgather(p, n_bytes, E.FabricParams(), E.WorkerParams(n_recv_workers=8),
                                  np.random.default_rng(0), m,
                                  topology=TOPO.FatTree(k=16, n_hosts=p), fidelity="packet",
                                  loss=LINK_LOSS, device=device)


def fsdp_grid(device: str) -> list[dict]:
    """(c) the contention sweep's grid, abstract fluid."""
    return E.sweep_fsdp_contention(ps=FSDP_PS, layer_bytes=FSDP_LAYER_BYTES,
                                   n_layers=FSDP_LAYERS, device=device)


def fsdp_routed(device: str) -> dict:
    """(c) the routed step: every policy fluid, mcast and split with the
    packet overlay at loss 1e-3, at each oversubscription."""
    out = {}
    for o in OVERSUB:
        for policy in E.FSDP_POLICIES:
            for fidelity in ("fluid", "packet"):
                if fidelity == "packet" and policy == "naive":
                    continue
                topo = TOPO.FatTree(k=8, n_hosts=FSDP_ROUTED_P, oversubscription=o)
                out[f"o{o:g}.{policy}.{fidelity}"] = E.simulate_fsdp_step(
                    n_layers=FSDP_ROUTED_LAYERS, layer_bytes=FSDP_ROUTED_BYTES,
                    p=FSDP_ROUTED_P, policy=policy, topology=topo, fidelity=fidelity,
                    loss=LINK_LOSS if fidelity == "packet" else None,
                    rng=np.random.default_rng(0), device=device)
    return out


def multi_job(device: str) -> dict:
    """(c) two FSDP jobs on the even and odd hosts of a k = 8 fat-tree."""
    jobs = {"A": list(range(0, 32, 2)), "B": list(range(1, 32, 2))}
    return {o: E.simulate_multi_job(TOPO.FatTree(k=8, n_hosts=32, oversubscription=o), jobs,
                                    layer_bytes=128e6, n_layers=3, policy="mcast",
                                    device=device)
            for o in MULTI_JOB_OVERSUB}


def routed_path() -> dict[str, int]:
    """Phase 5d: the routed packet mode and the FSDP step, each cell run on
    the CPU and then on the card (counts zeroed before, read after), field
    for field equal, the receive kernels' launches equal to what the runs'
    rounds imply; the benchmarks' assertions. Returns the phase's launches
    of #6, #6b, #7 and #8/#9."""
    total = dict.fromkeys(AG_KERNELS, 0)

    def add(launches):
        for k in AG_KERNELS:
            total[k] += launches[k]

    runs, n, _ = _figure("loss_sweep", loss_sweep, bcast_launches, tag="routed")
    add(n)
    rec = {}
    for p in LOSS_SWEEP_P:
        per = [runs[f"P{p}.seed{s}"] for s in LOSS_SWEEP_SEEDS]
        for r in per:
            if not r.completed or r.bytes_fast + r.bytes_recovery != r.bytes_total:
                raise AssertionError(f"loss sweep P={p}: incomplete or bytes not conserved")
            if any(tr.root_nack_msgs != 1 for tr in r.rounds):
                raise AssertionError(f"loss sweep P={p}: the root served more than one NACK a "
                                     "round with aggregation")
        rec[p] = sum(r.phases.reliability for r in per) / len(per)
        print(f"[routed] loss sweep P={p}: recovery {rec[p] * 1e6} us (mean of "
              f"{len(per)} seeds), rounds {[len(r.rounds) for r in per]}", flush=True)
    p0, p1 = min(LOSS_SWEEP_P), max(LOSS_SWEEP_P)
    growth, bound = rec[p1] / rec[p0], 1.5 * math.log2(p1) / math.log2(p0)
    agg, noagg = runs[f"P{p1}.seed{LOSS_SWEEP_SEEDS[0]}"], runs["noagg"]
    print(f"[routed] recovery growth P{p0} -> P{p1}: {growth} (bound {bound}); ablation at "
          f"P{p1}: {noagg.phases.reliability * 1e6} us without aggregation, "
          f"{agg.phases.reliability * 1e6} with; root NACKs a round "
          f"{[tr.root_nack_msgs for tr in noagg.rounds]}", flush=True)
    if not growth <= bound:
        raise AssertionError(f"recovery grew {growth}x from P{p0} to P{p1}, over {bound}")
    if not noagg.phases.reliability >= agg.phases.reliability - 1e-12:
        raise AssertionError("the no-aggregation ablation recovered faster")

    res, n, counts = _figure("ag_routed", ag_routed, lambda r: {
        "pool": -(-AGR[0] // AGR[2]) + _ag_rounds(r), "bitmap_pack": _ag_rounds(r),
        "bitmap_or_rows": _ag_rounds(r), "bitmap_popcount": _ag_rounds(r)}, tag="routed")
    add(n)
    print(f"[routed] AG-R: time {res.time} s, recovered {res.recovered}, recovery rounds "
          f"{_ag_rounds(res)} ({len(res.rounds)} traces), {len(res.link_bytes)} links, "
          f"phases {json.dumps(dataclasses.asdict(res.phases))}", flush=True)
    if not (res.completed and res.recovered and res.link_bytes):
        raise AssertionError("AG-R must complete and recover chunks")
    if AGR[0] * AGR[2] * (AGR[1] // E.FabricParams().mtu) > PK._BLOCK_ELEMS:
        raise AssertionError("AG-R's fast path takes more than one block of pool rows")

    rows, n, _ = _figure("fsdp_grid", fsdp_grid, lambda _: {}, tag="routed")
    add(n)
    bubbles: dict[tuple, dict] = {}
    for r in rows:
        bubbles.setdefault((r["p"], r["layer_bytes"]), {})[r["policy"]] = r["bubble_fraction"]
    for key, b in bubbles.items():
        print(f"[routed] fsdp P={key[0]} {key[1] / 1e6:g} MB: bubble fraction {json.dumps(b)}",
              flush=True)
        if not b["split"] < b["naive"]:
            raise AssertionError(f"fsdp {key}: split bubbles {b['split']} not under naive's")
    steps, n, counts = _figure("fsdp_routed", fsdp_routed, lambda _: {}, tag="routed")
    add(n)
    for key, r in steps.items():
        print(f"[routed] fsdp routed P={FSDP_ROUTED_P} {key}: step {r.step_time * 1e3} ms, "
              f"bubble fraction {r.bubble_fraction}", flush=True)
    for o in OVERSUB:
        if not steps[f"o{o:g}.split.fluid"].bubble_fraction < \
                steps[f"o{o:g}.naive.fluid"].bubble_fraction:
            raise AssertionError(f"routed fsdp at oversubscription {o}: split not under naive")
    if not counts["device_solves"]:
        raise AssertionError("the routed FSDP step ran no max-min solve on the card")
    jobs, n, _ = _figure("multi_job", multi_job, lambda _: {}, tag="routed")
    add(n)
    slow = {o: max(r.slowdown.values()) for o, r in jobs.items()}
    print(f"[routed] multi-job slowdowns by oversubscription {json.dumps(slow)}; core bytes "
          f"{json.dumps({o: r.core_bytes for o, r in jobs.items()})}", flush=True)
    if not (slow[1.0] < 1.01 and slow[4.0] > 1.3 and slow[1.0] <= slow[2.0] <= slow[4.0]):
        raise AssertionError(f"multi-job slowdowns {slow}")
    return total


# ------------------------------- phase 5e: the SmartNIC offload (the DPA)

# (a) the DPA model's figures (benchmarks/paper_figs.py: table1_datapath,
# fig5_cpu_datapath, fig13_14_thread_scaling, fig15_chunk_sizes, fig16_tbit),
# part A's NACK budget and the LLC's communicators: closed forms on the host
DPA_THREADS = (1, 2, 4, 8, 16)
FIG15_CHUNKS = (4096, 8192, 16384, 32768)
FIG16_THREADS = (16, 64, 128)
# (c) protocol_loss_sweep's parts B and C (benchmarks/paper_figs.py:331):
# 1 MiB Broadcasts at P = 64 on the abstract fabric, 16 workers, no jitter
PART_B_P = 64
PART_B_LOSS = (1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 1e-1, 2e-1, 3e-1)
PART_C_RATE, PART_C_BURST = 1e-2, 16.0
# (d) AG-E: 64 hosts x 1 MiB x 4 chains, 1e-3 loss per leaf, 1 us jitter,
# seed 0, on 16 UD threads of the DPA: event fidelity and its scalar twin
AGE = (64, 1 << 20, 4)
AGE_DPA = ("UD", 16)
_POOL_CLOCK: dict[tuple[str, str], tuple[float, float]] = {}


def _pool_clocked(name: str, fn):
    """``fn(device)`` with the event pools' host seconds summed
    (``DpaEventPool.service_batch``, every batch) beside the call's own
    seconds, kept by (name, device) in ``_POOL_CLOCK``."""
    def run(device: str):
        spent = [0.0]
        orig = DE.DpaEventPool.service_batch

        def timed(self, *args, **kw):
            t0 = time.perf_counter()
            try:
                return orig(self, *args, **kw)
            finally:
                spent[0] += time.perf_counter() - t0

        DE.DpaEventPool.service_batch = timed
        t0 = time.perf_counter()
        try:
            out = fn(device)
        finally:
            DE.DpaEventPool.service_batch = orig
        _POOL_CLOCK[(name, device)] = (spent[0], time.perf_counter() - t0)
        return out
    return run


def _check(ok: bool, what: str) -> str:
    if not ok:
        raise AssertionError(what)
    return "holds"


def dpa_model_figures() -> dict:
    """(a) Table I, Figs. 5 and 13 to 16, the economics, part A's NACK
    budget (16 UD threads serve more NACKs a round than P = 512 sends) and
    the communicators in the LLC (more than 16, §III-D), each with its
    assertion from benchmarks/paper_figs.py."""
    gib, link = DPA.GIB, DPA.LINK_200G_BYTES
    out = {"table1": DPA.TABLE1, "fig5_cpu_core_gibs": DPA.CPU_CORE_TPUT_GIB}
    checks = {"table1: UC over UD above 2": _check(
        DPA.TABLE1["UC"]["tput_gib"] / DPA.TABLE1["UD"]["tput_gib"] > 2, "table1")}
    checks["fig5: no CPU core holds the 200G link"] = _check(
        all(g * gib < link for g in DPA.CPU_CORE_TPUT_GIB.values()), "fig5 cpu")
    out["fig5_dpa_core16t_UD_gibs"] = DPA.sustained_tput(DPA.DpaConfig("UD", 16)) / gib
    checks["fig5: 16 DPA threads hold 99 % of it"] = _check(
        out["fig5_dpa_core16t_UD_gibs"] * gib >= 0.99 * link, "fig5 dpa")
    out["fig13_gibs"] = {t: {n: DPA.sustained_tput(DPA.DpaConfig(t, n)) / gib
                             for n in DPA_THREADS} for t in ("UD", "UC")}
    out["fig14_threads_to_linerate"] = {t: DPA.threads_to_saturate(t) for t in ("UD", "UC")}
    checks["fig14: UC <= 4, UD 8 to 16"] = _check(
        out["fig14_threads_to_linerate"]["UC"] <= 4
        and 8 <= out["fig14_threads_to_linerate"]["UD"] <= 16, "fig14")
    out["fig15_UC_threads_to_linerate"] = {
        c: next(t for t in range(1, 257)
                if DPA.sustained_tput(DPA.DpaConfig("UC", t, c)) >= 0.99 * link)
        for c in FIG15_CHUNKS}
    need = DPA.link_chunk_arrival_rate(DPA.LINK_1600G_BYTES)
    out["fig16_required_Mchunks_s"] = need / 1e6
    out["fig16_UD_Mchunks_s"] = {n: DPA.sustained_chunk_rate(
        DPA.DpaConfig("UD", n, 64, DPA.LINK_1600G_BYTES)) / 1e6 for n in FIG16_THREADS}
    checks["fig16: 128 UD threads hold 1.6 Tbit/s"] = _check(DPA.tbit_feasible("UD", 128),
                                                             "fig16")
    out["economics"] = DPA.economics_summary()
    out["dpa_nack_rate_msgs_per_s"] = DPA.nack_rate(DPA.DpaConfig("UD", 16))
    checks["part A: the NACK budget exceeds 511 a round"] = _check(
        out["dpa_nack_rate_msgs_per_s"] > max(LOSS_SWEEP_P) - 1, "nack budget")
    out["communicators_in_llc"] = protocol.communicators_in_llc()
    checks["§III-D: more than 16 communicators in the LLC"] = _check(
        out["communicators_in_llc"] > 16, "llc")
    out["checks"] = checks
    return out


def _age_workers() -> E.WorkerParams:
    return E.workers_from_dpa(DPA.DpaConfig(*AGE_DPA))


def dpa_sweep(device: str) -> dict:
    """(b) ``dpa_scaling_sweep`` (benchmarks/paper_figs.py:490): the event
    engine's Figs. 13 and 14, the full-core anchors, Fig. 16, Fig. 5's DPA
    core against a host core, the FSDP step on the host progress engine
    against the DPA, and the event-against-scalar lossy Broadcast."""
    out = {"fig13": {t: {n: DE.sustained_tput_event(DE.EventDpaParams.from_table1(t, n))
                         for n in DPA_THREADS} for t in ("UD", "UC")},
           "sat_event": {t: DE.threads_to_saturate_event(t) for t in ("UD", "UC")},
           "core16": {t: (DE.pool_tput_event(DE.EventDpaParams.from_table1(t, 16)),
                          DPA.pool_tput(DPA.DpaConfig(t, 16))) for t in ("UD", "UC")}}
    need = DPA.link_chunk_arrival_rate(DPA.LINK_1600G_BYTES)
    out["fig16"] = (DE.sustained_chunk_rate_event(DE.EventDpaParams.from_table1("UD", 128),
                                                  need, chunk_bytes=64), need,
                    DPA.sustained_chunk_rate(DPA.DpaConfig("UD", 128, 64,
                                                           DPA.LINK_1600G_BYTES)))
    out["tbit"] = (DE.tbit_feasible_event("UD", 128), DE.tbit_feasible_event("UD", 8))
    out["fig5"] = (DE.sustained_tput_event(DE.EventDpaParams.from_table1("UD", 16)),
                   DE.pool_tput_event(DE.EventDpaParams.host_cpu(1)))
    kw = dict(n_layers=4, layer_bytes=64e6, p=16, policy="split", device=device)
    out["fsdp"] = (E.simulate_fsdp_step(**kw),
                   E.simulate_fsdp_step(**kw, progress_engine="host", host_cores=2))
    fab, wk = E.FabricParams(jitter=0.0), E.WorkerParams(n_recv_workers=16)
    out["bcast"] = tuple(
        SIM.simulate_broadcast(16, 1 << 20, fab, wk, np.random.default_rng(0),
                               fidelity="packet", loss=1e-3, device=device, dpa_fidelity=fid)
        for fid in ("scalar", "event"))
    return out


def loss_parts(device: str) -> dict:
    """(c) parts B and C: every (loss rate, seed) Broadcast at P = 64, then
    Gilbert-Elliott at 1e-2 in bursts of 16 and i.i.d. at 1e-2, seed 0."""
    fab, wk = E.FabricParams(jitter=0.0), E.WorkerParams(n_recv_workers=16)
    runs = {f"q{q:g}.seed{s}": SIM.simulate_broadcast(
        PART_B_P, LOSS_SWEEP_BYTES, fab, wk, np.random.default_rng(s), fidelity="packet",
        loss=q, device=device) for q in PART_B_LOSS for s in LOSS_SWEEP_SEEDS}
    for name, loss in (("ge", PK.GilbertElliottLoss.from_rate(PART_C_RATE,
                                                              mean_burst=PART_C_BURST)),
                       ("iid", PART_C_RATE)):
        runs[name] = SIM.simulate_broadcast(PART_B_P, LOSS_SWEEP_BYTES, fab, wk,
                                            np.random.default_rng(0), fidelity="packet",
                                            loss=loss, device=device)
    return runs


def _age(fidelity: str):
    def run(device: str) -> PK.PacketAllgatherResult:
        p, n_bytes, m = AGE
        kw = dict(dpa_fidelity="event", dpa=DPA.DpaConfig(*AGE_DPA)) \
            if fidelity == "event" else {}
        return PK.simulate_packet_allgather(p, n_bytes, E.FabricParams(), _age_workers(),
                                            np.random.default_rng(0), m, loss=LINK_LOSS,
                                            device=device, **kw)
    return run


def _rounds_launches(rounds: int, pools: int) -> dict[str, int]:
    return {"pool": pools, "bitmap_pack": rounds, "bitmap_or_rows": rounds,
            "bitmap_popcount": rounds}


def dpa_path() -> dict[str, int]:
    """Phase 5e: the SmartNIC offload. (a) the DPA model's figures on the
    host; (b), (c) and (d) each run on the CPU and then on the card (counts
    zeroed before, read after), field for field equal, the receive kernels'
    launches equal to what the runs imply: in event mode no pool pass for
    the leaves and one pack, OR and popcount a recovery round; in scalar
    mode as phase 5b. The event pools' host share of each run is printed.
    Returns the phase's launches of #6, #6b, #7 and #8/#9."""
    total = dict.fromkeys(AG_KERNELS, 0)

    def add(launches):
        for k in AG_KERNELS:
            total[k] += launches[k]

    def pools(name: str) -> None:
        for device in ("cpu", "cuda"):
            spent, wall = _POOL_CLOCK[(name, device)]
            print(f"[dpa] {name} on the {'card' if device == 'cuda' else 'CPU'}: event pools "
                  f"{spent * 1e3} host ms of {wall * 1e3} ({spent / wall} of the run)",
                  flush=True)

    t0 = time.perf_counter()
    figs = dpa_model_figures()
    print(f"[dpa] (a) the DPA model's figures {json.dumps(figs, default=str)} "
          f"({(time.perf_counter() - t0) * 1e3} host ms)", flush=True)

    def sweep_implied(r):
        scl, evt = r["bcast"]
        return _rounds_launches(len(scl.rounds) + len(evt.rounds), 1 + len(scl.rounds))

    sw, n, _ = _figure("dpa_sweep", _pool_clocked("dpa_sweep", dpa_sweep), sweep_implied,
                       tag="dpa")
    add(n)
    pools("dpa_sweep")
    sat_an = {t: DPA.threads_to_saturate(t) for t in ("UD", "UC")}
    core = {t: ev / an for t, (ev, an) in sw["core16"].items()}
    rate, need, an_rate = sw["fig16"]
    dpa_core, host_core = sw["fig5"]
    d, h = sw["fsdp"]
    scl, evt = sw["bcast"]
    fig13 = {t: {k: v / DPA.GIB for k, v in r.items()} for t, r in sw["fig13"].items()}
    print(f"[dpa] (b) event engine: fig13 GiB/s {json.dumps(fig13)}; saturation threads "
          f"{json.dumps(sw['sat_event'])} (analytic {json.dumps(sat_an)})"
          f"; core16 over pool_tput {json.dumps(core)}; fig16 {rate / 1e6} of {need / 1e6} "
          f"Mchunks/s ({rate / need}, analytic {an_rate / 1e6}); fig5 DPA core over host core "
          f"{dpa_core / host_core} (host {host_core / DPA.GIB} GiB/s); FSDP host over DPA step "
          f"{h.step_time / d.step_time}, bubbles {h.bubble_fraction} vs {d.bubble_fraction}, "
          f"host datapath {h.datapath_tput / DPA.GIB} GiB/s; event over scalar Broadcast "
          f"{evt.time / scl.time} ({evt.time * 1e6} vs {scl.time * 1e6} us)", flush=True)
    if not (sw["sat_event"]["UC"] <= 4 and 8 <= sw["sat_event"]["UD"] <= 16):
        raise AssertionError(f"event saturation threads {sw['sat_event']}")
    if not all(abs(r - 1.0) < 0.10 for r in core.values()):
        raise AssertionError(f"event core16 capacity off the oracle: {core}")
    if not (sw["tbit"] == (True, False) and abs(rate / an_rate - 1.0) < 0.10):
        raise AssertionError(f"fig16 by events: feasible {sw['tbit']}, {rate} vs {an_rate}")
    if not (dpa_core / host_core > 1.2 and host_core < DPA.LINK_200G_BYTES):
        raise AssertionError(f"fig5 by events: {dpa_core} vs host {host_core}")
    if not (h.step_time > d.step_time and h.bubble_fraction > d.bubble_fraction):
        raise AssertionError("the host progress engine's FSDP step is not slower")
    if not (evt.completed and evt.time >= scl.time - 1e-12):
        raise AssertionError(f"event Broadcast {evt.time} faster than scalar {scl.time}")

    runs, n, _ = _figure("loss_parts_bc", loss_parts, bcast_launches, tag="dpa")
    add(n)
    t_mc, t_ring, crossover = [], [], None
    for i, q in enumerate(PART_B_LOSS):
        per = [runs[f"q{q:g}.seed{s}"] for s in LOSS_SWEEP_SEEDS]
        if not all(r.completed and r.bytes_fast + r.bytes_recovery == r.bytes_total
                   for r in per):
            raise AssertionError(f"part B at loss {q}: incomplete or bytes not conserved")
        t_mc.append(sum(r.time for r in per) / len(per))
        t_ring.append(protocol.analytic_ring_pipeline_bcast_time(
            PART_B_P, LOSS_SWEEP_BYTES, E.FabricParams().b_link, E.FabricParams().latency,
            loss_rate=q))
        if crossover is None and t_mc[i] > t_ring[i]:
            crossover = math.sqrt(PART_B_LOSS[i - 1] * q) if i else q
    print(f"[dpa] (c) part B at P={PART_B_P}: multicast over ring "
          f"{json.dumps({f'{q:g}': m / r for q, m, r in zip(PART_B_LOSS, t_mc, t_ring)})}; "
          f"crossover {crossover}", flush=True)
    if not (crossover is None or crossover > 1e-3):
        raise AssertionError(f"the multicast-unicast crossover {crossover} is not above 1e-3")
    ge, iid = runs["ge"], runs["iid"]
    if not (ge.completed and iid.completed):
        raise AssertionError("part C: a Broadcast did not complete")
    print(f"[dpa] (c) part C: Gilbert-Elliott over i.i.d. recovery "
          f"{ge.phases.reliability / max(iid.phases.reliability, 1e-12)} "
          f"({ge.phases.reliability * 1e6} vs {iid.phases.reliability * 1e6} us)", flush=True)

    gens = -(-AGE[0] // AGE[2])
    n_chunks = AGE[1] // E.FabricParams().mtu
    if AGE[0] * AGE[2] * n_chunks > PK._BLOCK_ELEMS:
        raise AssertionError("AG-E's fast path takes more than one block of pool rows")
    res = {}
    for fidelity in ("event", "scalar"):
        name = f"AG-E.{fidelity}"
        res[fidelity], n, _ = _figure(
            name, _pool_clocked(name, _age(fidelity)),
            lambda r, f=fidelity: _rounds_launches(_ag_rounds(r), 0 if f == "event"
                                                   else gens + _ag_rounds(r)), tag="dpa")
        add(n)
        pools(name)
        r = res[fidelity]
        print(f"[dpa] (d) {name}: time {r.time} s, recovered {r.recovered}, recovery rounds "
              f"{_ag_rounds(r)}, rnr {r.rnr_drops}, launches {json.dumps(n)}", flush=True)
        if not (r.completed and r.recovered):
            raise AssertionError(f"{name} must complete and recover chunks")
    print(f"[dpa] (d) AG-E event over scalar {res['event'].time / res['scalar'].time}",
          flush=True)
    return total


# --------------------- phase 5f: the composite schedules, the searcher, the host split

# (a) schedule_ir_sweep (benchmarks/paper_figs.py:581): 4 MiB Allreduces at
# P = 16 and 64, the ring AG against M = P, on the abstract fabric and on
# FatTree(k = 8); autotune_chains on the flat fabric (P = 64, 256 KiB, every
# divisor) and on the 4x oversubscribed k = 8 tree (P = 16)
SCHEDIR_P, SCHEDIR_BYTES, AUTOTUNE_BYTES = (16, 64), 1 << 22, 1 << 18
# (b) search_sweep (:631): the Allreduce at P = 16 of 16 MiB on
# FatTree(k = 8, oversubscription 4) and Torus2D(4, 4), validated at packet
# fidelity under 1e-3 loss
SEARCH = (16, 16 << 20, 1e-3)
# (c) hier_fabric_sweep (:711): 1 MiB Allgathers on IslandFatTree(k, P),
# islands of 8
HIER, HIER_BYTES, HIER_ISLAND = ((8, 64), (16, 256)), 1 << 20, 8
# the searcher's defaults (sched_search.search): the fabric and workers of
# every search evaluation and packet validation
SEARCH_FAB, SEARCH_WK = dict(jitter=0.0), dict(n_recv_workers=8)
# (e) the host split of one more call each of AG-B, AG-R and Fig. 12
_CELL_WALL: dict[tuple[str, str], dict[str, float]] = {}


def _search_fabrics() -> dict:
    p = SEARCH[0]
    return {"fattree_os4": TOPO.FatTree(k=8, n_hosts=p, oversubscription=4.0),
            "torus4x4": TOPO.Torus2D(4, 4)}


def schedir_cell(device: str) -> dict:
    """(a): the composed Allreduces and both chain sweeps."""
    fab, wk = E.FabricParams(**SEARCH_FAB), E.WorkerParams(**SEARCH_WK)
    out = {}
    for p in SCHEDIR_P:
        for m in (p, None):
            sched = IR.build_allreduce(p, SCHEDIR_BYTES, m=m)
            tag = "mcast" if m else "ring"
            out[f"P{p}.{tag}"] = IR.execute(sched, fab, wk, np.random.default_rng(0),
                                            device=device)
            out[f"P{p}.{tag}.fattree"] = IR.execute(
                sched, fab, wk, np.random.default_rng(0), device=device,
                topology=TOPO.FatTree(k=8, n_hosts=p, b_host=fab.b_link))
    out["autotune_flat"] = IR.autotune_chains(IR.build_allgather, p=64, n_bytes=AUTOTUNE_BYTES,
                                              fabric=fab, workers=wk, device=device)
    thin = TOPO.FatTree(k=8, n_hosts=16, b_host=fab.b_link, oversubscription=4.0)
    out["autotune_oversub4"] = IR.autotune_chains(IR.build_allgather, thin, p=16,
                                                  n_bytes=AUTOTUNE_BYTES, fabric=fab,
                                                  workers=wk, device=device)
    return out


def search_cell(device: str) -> dict:
    """(b): both searches on one cache on a fresh temporary file, timed
    together; the cold fluid sweep (fresh caches, no validation) against
    the warm one (the populated cache); then a second cache on the file,
    which must serve every evaluation from disk. The walls go to
    ``_CELL_WALL``; the file is removed."""
    p, n, loss = SEARCH
    fabrics = _search_fabrics()
    tmp = tempfile.mkdtemp()
    try:
        path = os.path.join(tmp, "evals.json")
        cache = SS.EvalCache(path)
        t0 = time.perf_counter()
        found = {label: SS.search("allreduce", p, n, topology=topo, loss=loss, cache=cache,
                                  device=device) for label, topo in fabrics.items()}
        wall = time.perf_counter() - t0
        t0 = time.perf_counter()
        cold = {label: SS.search("allreduce", p, n, topology=topo, validate_packet=False,
                                 cache=SS.EvalCache(), device=device)
                for label, topo in fabrics.items()}
        wall_cold = time.perf_counter() - t0
        hits0 = cache.hits
        t0 = time.perf_counter()
        warm = {label: SS.search("allreduce", p, n, topology=topo, validate_packet=False,
                                 cache=cache, device=device) for label, topo in fabrics.items()}
        wall_warm = time.perf_counter() - t0
        warm_hits = cache.hits - hits0
        cache.save()
        again = SS.EvalCache(path)
        disk = {label: SS.search("allreduce", p, n, topology=topo, validate_packet=False,
                                 cache=again, device=device) for label, topo in fabrics.items()}
    finally:
        shutil.rmtree(tmp)
    _CELL_WALL[("search_sweep", device)] = {"wall_s": wall, "cold_s": wall_cold,
                                            "warm_s": wall_warm}
    return {"search": found, "cold": cold, "warm": warm, "warm_hits": warm_hits, "disk": disk,
            "disk_hits": again.hits, "disk_misses": again.misses}


def hier_cell(device: str) -> dict:
    """(c): at each (k, P) the searched Allgather (validated at packet
    fidelity), then the winner and the flat multicast executed on the fabric
    for their tiers' bytes; one cache for both fabrics."""
    fab, wk = E.FabricParams(**SEARCH_FAB), E.WorkerParams(**SEARCH_WK)
    cache = SS.EvalCache()
    out = {}
    t0 = time.perf_counter()
    for k, p in HIER:
        topo = TOPO.IslandFatTree(k, p, island_size=HIER_ISLAND)
        hosts = list(range(p))
        r = SS.search("allgather", p, HIER_BYTES, topology=topo, hosts=hosts, cache=cache,
                      device=device)
        topo.reset()
        win = IR.execute(r.winner.sched, fab, wk, np.random.default_rng(0), topology=topo,
                         hosts=hosts, device=device)
        win_split = topo.tier_split(win.link_bytes)
        topo.reset()
        flat = IR.execute(IR.build_allgather(p, HIER_BYTES, p), fab, wk,
                          np.random.default_rng(0), topology=topo, hosts=hosts, device=device)
        out[p] = {"search": r, "winner": win, "winner_split": win_split, "flat": flat,
                  "flat_split": topo.tier_split(flat.link_bytes)}
    _CELL_WALL[("hier_fabric_sweep", device)] = {"wall_s": time.perf_counter() - t0}
    return out


def _fluid_pools(sched) -> int:
    """Pool launches of one fluid evaluation of ``sched``: one a fluid
    Allgather generation (its one-row pass), one a fluid Broadcast, none for
    a ring; an Allreduce's AG legs; a hierarchical Allgather's stripe leg
    (one engine for every stripe)."""
    if sched.kind == "allgather":
        return sched.n_rounds
    if sched.kind == "broadcast":
        return 1
    if sched.kind in ("ring_allgather", "reduce_scatter"):
        return 0
    if sched.kind == "allreduce":
        legs = sched.meta.get("segments") or ((sched.meta["rs"], sched.meta["ag"]),)
        return sum(_fluid_pools(ag) for _, ag in legs)
    if sched.kind == "hier_allgather":
        return _fluid_pools(sched.meta["stripe_ag"])
    raise AssertionError(f"no fluid launch count for {sched.kind}")


def _packet_launches(sched, res, routed: bool) -> dict[str, int]:
    """Launches of one packet run of ``sched`` with result ``res``: each
    packet Allgather leg as phase 5b counts it (a pool pass a generation and
    a recovery round, one pack, OR and popcount a round; one block of pool
    rows each, which is checked); a ring leg none; on a fabric, a
    hierarchical multicast stripe's contention factor runs the stripe twice
    at fluid fidelity."""
    if sched.kind == "allgather":
        width = max(len(g) for g in sched.rounds())
        if sched.p * width * max(sched.n_bytes // E.FabricParams().mtu, 1) > PK._BLOCK_ELEMS:
            raise AssertionError("a validation's pool rows take more than one block")
        rounds = _ag_rounds(res)
        return _rounds_launches(rounds, sched.n_rounds + rounds)
    if sched.kind in ("ring_allgather", "reduce_scatter"):
        return _rounds_launches(0, 0)
    total = _rounds_launches(0, 0)
    if sched.kind == "allreduce":
        legs = (zip(sched.meta["segments"], res.segments) if "segments" in sched.meta
                else [((sched.meta["rs"], sched.meta["ag"]), (res.rs, res.ag))])
        for (_, ag), (_, ag_res) in legs:
            for k, v in _packet_launches(ag, ag_res, routed).items():
                total[k] += v
        return total
    if sched.kind == "hier_allgather":
        stripe = sched.meta["stripe_ag"]
        total = _packet_launches(stripe, res.stripe, routed)
        if routed:
            total["pool"] += 2 * _fluid_pools(stripe)
        return total
    raise AssertionError(f"no packet launch count for {sched.kind}")


def _search_implied(r, topo, hosts, loss, seen: set, validated: bool) -> dict[str, int]:
    """Launches of one ``search`` on a fabric like ``topo``: every candidate
    it simulated (a table row with a time whose schedule the cache had not
    seen: ``seen`` holds the cache's keys and grows; a pruned or cached one
    launches nothing) at fluid fidelity, and the winner's packet validation,
    whose round traces come from the same validation run again on the
    CPU."""
    by_name = {c.name: c.sched for c in SS.candidates(r.collective, r.p, r.n_bytes, topo)}
    total = _rounds_launches(0, 0)
    for row in r.table:
        key = IR.canonical_key(by_name[row.name])
        if row.time is not None and key not in seen:
            seen.add(key)
            total["pool"] += _fluid_pools(by_name[row.name])
    if validated:
        topo.reset()
        res = IR.execute(r.winner.sched, E.FabricParams(**SEARCH_FAB),
                         E.WorkerParams(**SEARCH_WK), np.random.default_rng(0),
                         fidelity="packet", topology=topo, hosts=hosts, loss=loss, device="cpu")
        for k, v in _packet_launches(r.winner.sched, res, True).items():
            total[k] += v
    return total


def _add(total: dict, more: dict) -> None:
    for k, v in more.items():
        total[k] = total.get(k, 0) + v


def schedir_implied(out: dict) -> dict[str, int]:
    pools = sum(2 * _fluid_pools(IR.build_allreduce(p, SCHEDIR_BYTES, m=m))
                for p in SCHEDIR_P for m in (p, None))
    pools += sum(_fluid_pools(IR.build_allgather(64, AUTOTUNE_BYTES, m))
                 for m in out["autotune_flat"][1])
    pools += sum(_fluid_pools(IR.build_allgather(16, AUTOTUNE_BYTES, m))
                 for m in out["autotune_oversub4"][1])
    return {"pool": pools}


def search_implied(out: dict) -> dict[str, int]:
    """(b): the first searches on one cache, each cold sweep on its own; the
    warm and disk searches are served wholly from the cache (checked)."""
    total, seen = {}, {label: set() for label in _search_fabrics()}
    for label, topo in _search_fabrics().items():
        _add(total, _search_implied(out["search"][label], topo, None, SEARCH[2], seen[label],
                                    True))
    for label, topo in _search_fabrics().items():
        _add(total, _search_implied(out["cold"][label], topo, None, None, set(), False))
    for label, topo in _search_fabrics().items():
        _add(total, _search_implied(out["warm"][label], topo, None, None, seen[label], False))
    return total


def hier_implied(out: dict) -> dict[str, int]:
    total = {}
    for k, p in HIER:
        topo = TOPO.IslandFatTree(k, p, island_size=HIER_ISLAND)
        r = out[p]["search"]
        _add(total, _search_implied(r, topo, list(range(p)), None, set(), True))
        total["pool"] += _fluid_pools(r.winner.sched) + 1
    return total


def _walls(name: str) -> str:
    return json.dumps({("card" if d == "cuda" else "cpu"): w for (n, d), w in _CELL_WALL.items()
                       if n == name})


def parallel_search() -> dict[str, int]:
    """(d): the FatTree search of (b), fluid only, serial and with
    ``n_jobs=2`` (two spawned children on the card) on the card, and serial
    on the CPU: all equal field for field. Returns the parent's launches of
    serial and parallel card searches (the children launch in their own
    processes)."""
    p, n, _ = SEARCH
    got = {}
    prefetched = []
    real = SS._prefetch_parallel

    def spy(*args, **kw):
        out = real(*args, **kw)
        prefetched.append(len(out))
        return out

    pools = 0
    for name, device, jobs in (("cpu", "cpu", 1), ("card", "cuda", 1), ("card_jobs2", "cuda", 2)):
        if jobs > 1:
            SS._prefetch_parallel = spy
        torch.cuda.synchronize()
        before = _counts()
        t0 = time.perf_counter()
        try:
            got[name] = SS.search("allreduce", p, n, validate_packet=False, n_jobs=jobs,
                                  topology=_search_fabrics()["fattree_os4"], device=device)
        finally:
            SS._prefetch_parallel = real
        torch.cuda.synchronize()
        launched = _counts()["pool"] - before["pool"]
        pools += launched
        print(f"[search] (d) {name}: {got[name].evaluations} evaluations, "
              f"{(time.perf_counter() - t0) * 1e3} host ms, {launched} pool launches in this "
              "process", flush=True)
    _same_fields(got["card"], got["cpu"], "(d) card serial vs CPU", skip=("wall_s",))
    _same_fields(got["card_jobs2"], got["card"], "(d) n_jobs=2 vs serial", skip=("wall_s",))
    if prefetched != [prefetched[0]] or not prefetched[0]:
        raise AssertionError(f"(d): the children prefetched {prefetched} evaluations")
    print(f"[search] (d) n_jobs=2 on the card equals the serial search field for field; the "
          f"children evaluated {prefetched[0]} candidates", flush=True)
    return {"pool": pools}


def host_split() -> None:
    """(e): one more call each of AG-B (5b), AG-R (5d (b)) and Fig. 12 (5c)
    on the card, unprofiled and then with ``profiling.enable()``: the same
    result bitwise; ``engine_solve``'s calls equal to the engine's solves in
    the call, ``pool_solve``'s to its pool launches plus its 1-D host scans
    (``engine.worker_pool_completion``, counted apart); each phase's host
    seconds and share of the call's host time."""
    calls = {"AG-B": lambda: _ag("AG-B", "cuda"), "AG-R": lambda: ag_routed("cuda"),
             "fig12_routed": lambda: fig12_routed("cuda")}
    scans = [0]
    one_d = E._pool_1d

    def counted(*args, **kw):
        scans[0] += 1
        return one_d(*args, **kw)

    for name, call in calls.items():
        plain = call()
        torch.cuda.synchronize()
        solves0, pools0, scans[0] = E.counts["solves"], PL.launches, 0
        profiling.reset()
        profiling.enable()
        E._pool_1d = counted
        t0 = time.perf_counter()
        try:
            res = call()
            torch.cuda.synchronize()
        finally:
            host_s = time.perf_counter() - t0
            profiling.disable()
            E._pool_1d = one_d
        _same_fields(res, plain, f"(e) {name}, profiled vs not")
        rep = profiling.report()
        solves, launches = E.counts["solves"] - solves0, PL.launches - pools0
        if rep.get("engine_solve", {}).get("calls", 0) != solves:
            raise AssertionError(f"(e) {name}: engine_solve {rep.get('engine_solve')}, "
                                 f"{solves} solves")
        if rep.get("pool_solve", {}).get("calls", 0) != launches + scans[0]:
            raise AssertionError(f"(e) {name}: pool_solve {rep.get('pool_solve')}, {launches} "
                                 f"pool launches + {scans[0]} host scans")
        spent = {k: profiling._acc[k] for k in sorted(profiling._acc)}
        print("[split] " + json.dumps({
            "call": name, "host_ms": host_s * 1e3, "report": rep,
            "phase_host_ms": {k: v * 1e3 for k, v in spent.items()},
            "phase_share": {k: v / host_s for k, v in spent.items()},
            "unattributed_share": 1 - sum(spent.values()) / host_s,
            "solves": solves, "pool_launches": launches, "host_pool_scans": scans[0]}),
            flush=True)
    profiling.reset()


def search_path() -> dict[str, int]:
    """Phase 5f: the composite schedules, the chain autotune, the searcher
    and the phase profiler. (a) to (c) each run on the CPU and then on the
    card (counts zeroed before, read after), field for field equal (the
    search's wall clock aside), with benchmarks/paper_figs.py's asserts and
    the receive kernels' launches equal to what the cells imply; (d) the
    parallel tier on the card; (e) the host split. ``REPRO_EVAL_CACHE`` and
    ``REPRO_SEARCH_WORKERS`` are cleared for the phase. Returns the phase's
    launches of #6, #6b, #7 and #8/#9 ((a) to (d))."""
    saved = {k: os.environ.pop(k) for k in ("REPRO_EVAL_CACHE", "REPRO_SEARCH_WORKERS")
             if k in os.environ}
    total = dict.fromkeys(AG_KERNELS, 0)
    try:
        out, n, _ = _figure("schedule_ir_sweep", schedir_cell, schedir_implied, tag="search")
        _add(total, n)
        for p in SCHEDIR_P:
            mc, ring = out[f"P{p}.mcast"], out[f"P{p}.ring"]
            mc_b = sum(out[f"P{p}.mcast.fattree"].link_bytes.values())
            ring_b = sum(out[f"P{p}.ring.fattree"].link_bytes.values())
            print(f"[search] (a) P={p}: ring over multicast time {ring.time / mc.time} "
                  f"({ring.time * 1e6} vs {mc.time * 1e6} us); multicast over ring fabric "
                  f"bytes {mc_b / ring_b} ({mc_b} vs {ring_b})", flush=True)
            if not mc_b < ring_b:
                raise AssertionError(f"(a) P={p}: multicast fabric bytes {mc_b} not under the "
                                     f"ring's {ring_b}")
        best, times = out["autotune_flat"]
        best_thin, thin = out["autotune_oversub4"]
        print(f"[search] (a) autotune: flat best M {best} of {json.dumps(times)}; 4x "
              f"oversubscribed best M {best_thin} of {json.dumps(thin)}", flush=True)
        if best != 64:
            raise AssertionError(f"(a) the flat fabric's best M is {best}, not 64")

        out, n, _ = _figure("search_sweep", search_cell, search_implied, tag="search",
                            skip=("wall_s",))
        _add(total, n)
        for device in ("cpu", "cuda"):
            w = _CELL_WALL[("search_sweep", device)]
            warm_x = w["cold_s"] / max(w["warm_s"], 1e-9)
            print(f"[search] (b) on the {'card' if device == 'cuda' else 'CPU'}: both "
                  f"searches {w['wall_s']} s, cold sweep {w['cold_s']} s, warm {w['warm_s']} "
                  f"s ({warm_x}x)", flush=True)
            if not w["wall_s"] < 30.0:
                raise AssertionError(f"(b) the search sweep took {w['wall_s']} s, not < 30")
            if not warm_x >= 3.0:
                raise AssertionError(f"(b) the warm cache is {warm_x}x the cold sweep, not 3x")
        ratios = []
        for label, r in out["search"].items():
            ratios.append(r.searched_vs_best_builder)
            print(f"[search] (b) {label}: {r.winner.name} over {r.best_builder.name} "
                  f"{r.searched_vs_best_builder}, certificate {r.certificate.ratio} "
                  f"({r.certificate.binding}), fabric bytes "
                  f"{r.winner_fabric_bytes / r.best_builder_fabric_bytes}; {r.evaluations} "
                  f"evaluations, {r.pruned} pruned, packet validated {r.packet_validated}",
                  flush=True)
            if not (r.packet_validated and r.certificate.ratio >= 1.0 - 1e-9):
                raise AssertionError(f"(b) {label}: validation {r.packet_validated}, "
                                     f"certificate {r.certificate.ratio}")
            if out["warm"][label].cache_hits != out["warm"][label].evaluations:
                raise AssertionError(f"(b) {label}: the warm search was not served wholly "
                                     "from the cache")
            if out["disk"][label].winner.name != r.winner.name:
                raise AssertionError(f"(b) {label}: the disk cache's winner differs")
        if not (all(x <= 1.0 + 1e-9 for x in ratios) and min(ratios) < 1.0):
            raise AssertionError(f"(b) searched over best builder {ratios}")
        if out["disk_misses"] or out["disk_hits"] != sum(r.evaluations
                                                         for r in out["disk"].values()):
            raise AssertionError(f"(b) the second cache on the file missed "
                                 f"{out['disk_misses']} evaluations")

        out, n, _ = _figure("hier_fabric_sweep", hier_cell, hier_implied, tag="search",
                            skip=("wall_s",))
        _add(total, n)
        print(f"[search] (c) walls {_walls('hier_fabric_sweep')}", flush=True)
        for _, p in HIER:
            r, ws, fs = out[p]["search"], out[p]["winner_split"], out[p]["flat_split"]
            flat_t = min(row.time for row in r.table
                         if row.name.startswith("builder:mcast") and row.time is not None)
            ring_t = next(row.time for row in r.table if row.name == "builder:ring")
            print(f"[search] (c) P={p}: {r.winner.name} over the flat multicast "
                  f"{r.winner_time / flat_t}, over the island ring {r.winner_time / ring_t}, "
                  f"certificate {r.certificate.ratio} ({r.certificate.binding}); switched bytes "
                  f"over the flat multicast's {ws['switched'] / fs['switched']} (island "
                  f"{ws.get('island', 0.0)}); {r.evaluations} evaluations, {r.pruned} pruned",
                  flush=True)
            if not (r.winner.sched.kind == "hier_allgather" and r.packet_validated
                    and r.certificate.ratio >= 1.0 - 1e-9):
                raise AssertionError(f"(c) P={p}: winner {r.winner.name}, validated "
                                     f"{r.packet_validated}, certificate {r.certificate.ratio}")
            if not (r.winner_time < flat_t and r.winner_time < ring_t):
                raise AssertionError(f"(c) P={p}: {r.winner_time} not under {flat_t}, {ring_t}")
            if not (ws["switched"] < fs["switched"] and fs.get("island", 0.0) == 0.0):
                raise AssertionError(f"(c) P={p}: switched bytes {ws} vs {fs}")

        _add(total, parallel_search())
        host_split()
    finally:
        os.environ.update(saved)
    return total


# ----------------------------- phase 5g: the training-run co-simulation

# benchmarks/paper_figs.py:800 (training_run_sweep): every sweep model at
# these host counts, the split policy, the abstract fabric without jitter
TRAIN_SIM_HOSTS = (16, 64, 256)
TRAIN_SIM_H100_HOSTS = 64


def training_sweep(device: str) -> dict:
    """``training_run_sweep``'s runs on ``device``: the sweep models at
    TRAIN_SIM_HOSTS; smollm-135m on P = 16 naive and split on a 4x
    oversubscribed k = 8 fat-tree; split fluid, analytic and packet at 0.1 %
    and 1 % loss; granite-34b at 64 hosts, pp = 4, grad_accum = 8."""
    fab = E.FabricParams(jitter=0.0)
    out = {f"{arch}.h{n}": TS.simulate_training_run(arch, n_hosts=n, policy="split",
                                                     fabric=fab, device=device)
           for arch in training_sweep_archs() for n in TRAIN_SIM_HOSTS}
    for pol in ("naive", "split"):
        out[f"oversub4.{pol}"] = TS.simulate_training_run(
            "smollm-135m", n_hosts=16, policy=pol, fabric=fab, device=device,
            topology=TOPO.FatTree(k=8, n_hosts=16, oversubscription=4.0))
    out["fluid"] = TS.simulate_training_run("smollm-135m", n_hosts=16, policy="split",
                                            fabric=fab, device=device)
    out["analytic"] = TS.simulate_training_run("smollm-135m", n_hosts=16, policy="split",
                                               fabric=fab, fidelity="analytic", device=device)
    for q in (0.001, 0.01):
        out[f"packet.{q}"] = TS.simulate_training_run(
            "smollm-135m", n_hosts=16, policy="split", fabric=fab, fidelity="packet", loss=q,
            rng=np.random.default_rng(0), device=device)
    out["pp4ga8"] = TS.simulate_training_run("granite-34b", n_hosts=64, pp=4, grad_accum=8,
                                             policy="split", fabric=fab, device=device)
    return out


def h100_runs(device: str) -> dict:
    """The sweep models at TRAIN_SIM_H100_HOSTS hosts, split, priced at the
    card's own figures (``train_sim.H100``)."""
    return {arch: TS.simulate_training_run(arch, n_hosts=TRAIN_SIM_H100_HOSTS, policy="split",
                                           fabric=E.FabricParams(jitter=0.0), chip=TS.H100,
                                           device=device)
            for arch in training_sweep_archs()}


def _train_row(r) -> dict:
    return {"step_s": r.step_time, "micro_s": r.micro_time, "compute_s": r.compute_time,
            "bubble_fraction": r.bubble_fraction, "mfu": r.mfu, "dp": r.dp, "pp": r.pp,
            "n_devices": r.n_devices}


def train_sim_path() -> None:
    """Phase 5g: ``training_run_sweep``'s runs and the sweep models at 64
    hosts priced at the H100, each on the CPU and on the card, field for
    field equal (``_figure``; no receive kernel runs), with
    ``training_run_sweep``'s assertions."""
    runs, _, counts = _figure("training_run_sweep", training_sweep, lambda _: {},
                              tag="train-sim")
    for arch in training_sweep_archs():
        steps = {n: runs[f"{arch}.h{n}"].step_time for n in TRAIN_SIM_HOSTS}
        if not all(0.0 < runs[f"{arch}.h{n}"].mfu <= 1.0 for n in TRAIN_SIM_HOSTS):
            raise AssertionError(f"{arch}: an MFU outside (0, 1]")
        if not steps[16] > steps[64] > steps[256]:
            raise AssertionError(f"{arch}: step times {steps} do not fall with the hosts")
        print(f"[train-sim] {arch}: step s by hosts {json.dumps(steps)}; 16 over 256 hosts "
              f"{steps[16] / steps[256]}", flush=True)
    naive, split = runs["oversub4.naive"], runs["oversub4.split"]
    if not (split.mfu > naive.mfu and split.step_time < naive.step_time
            and split.bubble_fraction < naive.bubble_fraction):
        raise AssertionError("split does not beat naive on the oversubscribed fat-tree")
    fl, an, p1, p2 = runs["fluid"], runs["analytic"], runs["packet.0.001"], runs["packet.0.01"]
    if not (an.step_time <= fl.step_time + 1e-12
            and fl.step_time <= p1.step_time <= p2.step_time + 1e-9
            and p2.mfu <= p1.mfu <= fl.mfu):
        raise AssertionError("the fidelities are out of order: analytic <= fluid <= packet")
    pp = runs["pp4ga8"]
    if pp.pipeline_bubble_fraction != (4 - 1) / (8 + 4 - 1):
        raise AssertionError(f"pipeline bubble {pp.pipeline_bubble_fraction}")
    print("[train-sim] " + json.dumps({
        "split_vs_naive_mfu_x": split.mfu / naive.mfu,
        "bubble_naive": naive.bubble_fraction, "bubble_split": split.bubble_fraction,
        "loss1pct_step_x": p2.step_time / fl.step_time,
        "analytic_vs_fluid_x": an.step_time / fl.step_time,
        "granite34b_pp4ga8": _train_row(pp)}), flush=True)
    h100, _, _ = _figure("h100_64_hosts", h100_runs, lambda _: {}, tag="train-sim")
    for arch, r in h100.items():
        v5e = runs[f"{arch}.h{TRAIN_SIM_H100_HOSTS}"]
        if not (0.0 < r.mfu <= 1.0 and r.compute_time < v5e.compute_time):
            raise AssertionError(f"{arch} at the H100's figures: mfu {r.mfu}, compute "
                                 f"{r.compute_time} s against {v5e.compute_time} at the "
                                 "reference's chip")
        print(f"[train-sim] {arch} at {TRAIN_SIM_H100_HOSTS} hosts, chip {TS.H100.name}: "
              + json.dumps(_train_row(r)), flush=True)


# ------------------------------------------------------- the collective layer

AGMM_ROWS = (BATCH * PROMPT // 8, TRAIN_SHAPE.global_batch * TRAIN_SHAPE.seq_len // 8)
AGMM_WIDTHS = ((576, 576), (576, 192), (576, 1536), (1536, 576))   # the block's projections
# matmul_pallas refuses K or N = 576 or 192 at its default 128 tiles (its
# precondition, which the port keeps); 64 divides every width
AGMM_TILES = dict(bk=64, bn=64)


def _host_ms(fn, repeats: int = REPEATS) -> float:
    """Median host ms to issue one call of ``fn`` (after a synchronise; no
    synchronise after it): the launch overhead alone."""
    out = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(out)


def _device_ms(fn, n: int = 20) -> float:
    """Device ms per call of ``fn``: n calls queued behind a spin kernel, so
    that the CUDA events around them time device work alone, not the host's
    issue (the calls end with the current stream waiting for any side
    stream, so both streams are inside the events). The spin is lengthened
    until it outlasts the host's issue of the n calls."""
    fn()
    spin_ms = 2 * n * _host_ms(fn) + 1.0
    while True:
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        torch.cuda.synchronize()
        marks[0].record()
        torch.cuda._sleep(int(spin_ms * 1.5e6))     # cycles at >= 1.5 GHz
        marks[1].record()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        issue_ms = (time.perf_counter() - t0) * 1e3
        marks[2].record()
        torch.cuda.synchronize()
        if marks[0].elapsed_time(marks[1]) > issue_ms:
            return marks[1].elapsed_time(marks[2]) / n
        spin_ms *= 2


def check_drain() -> tuple[int, float]:
    """Phase 6a: the drain kernel vs its plain version, exactly."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    cases = [torch.randn((8, rows, 576), generator=gen, device="cuda").bfloat16()
             for rows in AGMM_ROWS]
    cases += [torch.randn(shape, generator=gen, device="cuda") for shape in ((6, 8, 128),
                                                                             (3, 16, 64))]
    cases += [torch.randint(0, 256, (5, 7, 33), generator=gen, device="cuda").to(torch.uint8),
              torch.randint(-99, 99, (3, 17, 5), generator=gen, device="cuda").int(),
              torch.randint(0, 256, (1 + 4 * 300 * 77,), generator=gen, device="cuda")
              .to(torch.uint8)[1:].view(4, 300, 77),
              torch.randn((1 + 2 * 64 * 513,), generator=gen, device="cuda")
              .bfloat16()[1:].view(2, 64, 513)]
    for staged in cases:
        got = K.local_double_buffer_drain(staged)
        torch.cuda.synchronize()
        _exact("double_buffer_drain", (got,), (K.local_double_buffer_drain_plain(staged),),
               (tuple(staged.shape), staged.dtype, staged.data_ptr() % 16))
    return len(cases), 0.0


def _agmm_inputs() -> dict:
    """{(rows, K, N): (x (8, rows, K), w (K, N))}, bf16, w at its init scale."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    return {(rows, k, n): (torch.randn((8, rows, k), generator=gen, device="cuda").bfloat16(),
                           (torch.randn((k, n), generator=gen, device="cuda")
                            / k ** 0.5).bfloat16())
            for rows in AGMM_ROWS for k, n in AGMM_WIDTHS}


def _gathered(x: torch.Tensor) -> torch.Tensor:
    p, m, k = x.shape
    return C.plain_allgather_local(x.reshape(p, m * k)).reshape(p, p * m, k)


def layer_path() -> tuple[dict[str, int], dict]:
    """Phase 6b: the allgather-matmul and the drain through their entry
    points, launch counts zeroed before and read after; then each result
    against gather-then-matmul (bitwise) and the plain product. Returns the
    path's launches and the inputs with their max abs error vs plain."""
    mesh = StackedMesh(data=8, model=1)
    agmm = M.make_allgather_matmul(mesh, "data", **AGMM_TILES)
    agmm_steps = M.make_allgather_matmul(mesh, "data", use_pallas=False, **AGMM_TILES)
    inputs = _agmm_inputs()
    x_rows = {rows: x for (rows, _, _), (x, _) in inputs.items()}
    torch.cuda.synchronize()
    _zero_counts()   # counts from here to the read are the collective layer's path
    got = {key: agmm(x, w) for key, (x, w) in inputs.items()}
    got_steps = {key: agmm_steps(x, w) for key, (x, w) in inputs.items()}
    drained = {rows: K.local_double_buffer_drain(x) for rows, x in x_rows.items()}
    torch.cuda.synchronize()
    counts = _counts()
    for name in ("allgather_matmul", "matmul", "double_buffer_drain", "ring_step"):
        if counts[name] == 0:
            raise AssertionError(f"{name} was not launched on the collective layer's path: "
                                 f"{counts}")
    # one group per call: one wgmma launch that reads the shards in place;
    # use_pallas=False: the ring schedule's P - 1 steps and plain products
    want = {**{name: 0 for name in counts}, "allgather_matmul": len(inputs),
            "matmul": len(inputs), "double_buffer_drain": len(x_rows),
            "ring_step": 7 * len(inputs)}
    if counts != want:
        raise AssertionError(f"launches {counts} for {len(inputs)} allgather-matmul calls, "
                             f"expected {want}")
    errs = {}
    for key, (x, w) in inputs.items():
        rows = _gathered(x)
        wr = w.expand(8, *w.shape)
        if not torch.equal(got[key], M.matmul(rows, wr)):
            raise AssertionError(f"allgather_matmul {key} != gather then matmul")
        plain = M.matmul_plain(rows, wr)
        err = (got[key].float() - plain.float()).abs().max().item()
        if not err <= 1e-2 * plain.float().abs().max().item():
            raise AssertionError(f"allgather_matmul {key} vs plain: max err {err}")
        errs[key] = err
        err = (got_steps[key].float() - plain.float()).abs().max().item()
        if not err <= 1e-2 * plain.float().abs().max().item():
            raise AssertionError(f"allgather_matmul {key}, use_pallas=False, vs plain: max "
                                 f"err {err}")
    for rows, x in x_rows.items():
        if not torch.equal(drained[rows], x):
            raise AssertionError(f"the drain of the {rows}-row shards differs")
    print(f"[layer] {len(inputs)} allgather-matmul calls equal gather-then-matmul bitwise, "
          f"and as many with use_pallas=False within limits of plain; launches "
          f"{json.dumps(counts)}", flush=True)
    return counts, {"inputs": inputs, "errs": errs}


def time_layer(path: dict) -> dict[str, dict]:
    """Phase 6b's times: per case the call (one launch) and the reference's
    ring schedule on one stream (P - 1 ring steps and 2P - 1 products
    on the matmul kernel): ms per call back to back from CUDA events; the
    median of REPEATS synchronised calls; the host's issue time; the device
    time, and the idle share it leaves of the synchronised call; then the
    plain version (plain gather, then the plain product) and the library
    route (plain gather, then one torch.bmm), beside the bound. Then the
    drain at the shards' shapes (L2-resident, as freshly received shards
    are), timed in turns with ``clone()`` (medians of REPEATS each).
    Returns the kernels-line means. Device times come from
    ``_device_ms``: the profiler drops records on the card's machine."""
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0, "flops_ms": 0.0,
           "bytes_ms": 0.0}
    for (m, k, n), (x, w) in path["inputs"].items():
        p = x.shape[0]
        wr = w.expand(p, k, n)
        fns = {"ms": lambda: M.allgather_matmul_local(x, w, **AGMM_TILES),
               "ring_schedule_ms": lambda: M._allgather_matmul(x, w, M.matmul),
               "plain_ms": lambda: M.matmul_plain(_gathered(x), wr),
               "library_ms": lambda: torch.bmm(_gathered(x), wr)}
        row = {name: _time(fn) for name, fn in fns.items()}
        wall, wall1 = _wall(fns["ms"]), _wall(fns["ring_schedule_ms"])
        dev, dev1 = _device_ms(fns["ms"]), _device_ms(fns["ring_schedule_ms"])
        flops = p * (p * m) * k * n * 2
        flops_ms = flops / FLOPS[torch.bfloat16] * 1e3
        bytes_ms = (x.numel() + w.numel() + p * p * m * n) * 2 / HBM_BYTES_PER_S * 1e3
        row.update({"rows_per_rank": m, "K": k, "N": n,
                    "wall_ms_median": statistics.median(wall) * 1e3,
                    "wall_ms_samples": [t * 1e3 for t in wall],
                    "ring_schedule_wall_ms_median": statistics.median(wall1) * 1e3,
                    "host_issue_ms": _host_ms(fns["ms"]),
                    "ring_schedule_host_issue_ms": _host_ms(fns["ring_schedule_ms"]),
                    "device_ms": dev, "ring_schedule_device_ms": dev1,
                    "device_tflops": flops / dev / 1e9,
                    "library_device_ms": _device_ms(fns["library_ms"]),
                    "device_idle_share": 1 - dev / (statistics.median(wall) * 1e3),
                    "ring_schedule_device_idle_share":
                        1 - dev1 / (statistics.median(wall1) * 1e3),
                    "bound_ms": max(flops_ms, bytes_ms),
                    "bound_by": "operations" if flops_ms >= bytes_ms else "bytes",
                    "max_abs_err_vs_plain": path["errs"][m, k, n]})
        print("[allgather_matmul] " + json.dumps(row), flush=True)
        for name in ("ms", "plain_ms", "library_ms", "bound_ms"):
            tot[name] += row[name] / len(path["inputs"])
        tot["flops_ms"] += flops_ms
        tot["bytes_ms"] += bytes_ms
    tot["bound_by"] = "operations" if tot["flops_ms"] >= tot["bytes_ms"] else "bytes"
    tot["max_abs_err"] = max(path["errs"].values())
    drain = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    for m in AGMM_ROWS:
        x = next(x for (rows, _, _), (x, _) in path["inputs"].items() if rows == m)
        turns = {"ms": [], "library_ms": []}   # the drain and clone() in turns
        for _ in range(REPEATS):
            turns["ms"].append(_time(lambda: K.local_double_buffer_drain(x)))
            turns["library_ms"].append(_time(lambda: x.clone()))
        row = {"shape": tuple(x.shape), "ms": statistics.median(turns["ms"]),
               "ms_samples": turns["ms"],
               "plain_ms": _time(lambda: K.local_double_buffer_drain_plain(x)),
               "library_ms": statistics.median(turns["library_ms"]),
               "library_ms_samples": turns["library_ms"],
               "bound_ms": 2 * x.numel() * x.element_size() / HBM_BYTES_PER_S * 1e3,
               "device_ms": _device_ms(lambda: K.local_double_buffer_drain(x)),
               "library_device_ms": _device_ms(lambda: x.clone())}
        print("[double_buffer_drain] " + json.dumps(row), flush=True)
        for name in drain:
            drain[name] += row[name] / len(AGMM_ROWS)
    return {"allgather_matmul": tot, "double_buffer_drain": drain}


def agmm_backward() -> tuple[dict[str, int], float]:
    """Phase 6b': the backward of ``make_allgather_matmul`` at smollm-135m's
    four projections, bf16, 128 rows a rank, on the (data=8, model=1) mesh,
    launch counts zeroed before the forward and backward and read after:
    each call one allgather-matmul launch forward, and backward one matmul
    for dx's products g_d w^T, one launch of the gather's transpose of
    them, and one matmul for dw's products X^T g_d, every product on the
    wgmma path. dx and dw within the matmul's limits (1e-2 x max|plain|)
    of the plain backward (the same formula on ``matmul_plain`` and the
    transpose's plain version). Returns the launches and the max abs
    error."""
    mesh = StackedMesh(data=8, model=1)
    agmm = M.make_allgather_matmul(mesh, "data", **AGMM_TILES)
    gen = torch.Generator(device="cuda").manual_seed(9)
    m, p = AGMM_ROWS[0], 8
    cases = {(k, n): (torch.randn((p, m, k), generator=gen, device="cuda").bfloat16(),
                      (torch.randn((k, n), generator=gen, device="cuda") / k ** 0.5).bfloat16(),
                      torch.randn((p, p * m, n), generator=gen, device="cuda").bfloat16())
             for k, n in AGMM_WIDTHS}

    def grads(x, w, g):
        xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
        return torch.autograd.grad(agmm(xr, wr), (xr, wr), g)

    torch.cuda.synchronize()
    _zero_counts()   # counts from here to the read are the backward's path
    got = {key: grads(*case) for key, case in cases.items()}
    torch.cuda.synchronize()
    counts = _counts()
    want = {**dict.fromkeys(counts, 0), "allgather_matmul": len(cases),
            "matmul": 3 * len(cases), "ring_allgather_transpose": len(cases),
            "transpose_entries_ring": (p - 1) * len(cases)}
    if counts != want:
        raise AssertionError(f"the allgather-matmul backward launched {counts}, expected {want}")
    worst, row = 0.0, {}
    for (k, n), (x, w, g) in cases.items():
        contrib = M.matmul_plain(g, w.t().expand(p, n, k))
        dx = K.ring_allgather_transpose_plain(contrib.view(p, p, m * k),
                                              C._ring_schedule(p)).view(p, m, k)
        rows = x.reshape(1, p * m, k).transpose(1, 2).expand(p, k, p * m)
        dw = M.matmul_plain(rows, g).sum(0)
        for name, a, b in (("dx", got[k, n][0], dx), ("dw", got[k, n][1], dw)):
            err = (a.float() - b.float()).abs().max().item()
            if not err <= 1e-2 * b.float().abs().max().item():
                raise AssertionError(f"allgather_matmul backward {name} at {(k, n)}: max err "
                                     f"{err}")
            worst = max(worst, err)
        row[f"{k}x{n}_fwd_bwd_ms"] = _time(lambda: grads(x, w, g))
        row[f"{k}x{n}_fwd_bwd_device_ms"] = _device_ms(lambda: grads(x, w, g))
    print(f"[layer] allgather-matmul backward at {len(cases)} projections within limits of "
          f"plain (max abs err {worst}); launches {json.dumps(counts)}; " + json.dumps(row),
          flush=True)
    return counts, worst


def bucket_collectives(cfg) -> dict[str, int]:
    """Phases 6c and 6d: the pipelined broadcast and concurrent AG/RS on
    the flat f32 bucket of layer 0 of the seeded smollm-135m weights.
    Returns the launches of one concurrent AG/RS call and of its backward
    (counts zeroed before each, read after): one ring-allgather launch of
    the ring schedule and one launch of its transpose, each running seven
    entries, each time."""
    def layer0(tree):
        if isinstance(tree, dict):
            return {k: layer0(v) for k, v in tree.items()}
        return torch.from_numpy(tree[0]).cuda()

    layer = layer0(bridge.random_params(cfg, seed=0)["blocks"])
    flat, unflatten = flatten_bucket(layer, pad_to=8 * 64)
    if not torch.equal(unflatten(flat)["mlp"]["w_up"], layer["mlp"]["w_up"]):
        raise AssertionError("flatten_bucket did not round-trip")
    mesh = StackedMesh(data=8, model=1)
    x = torch.stack([flat + r for r in range(8)])   # rank r's row; only root's is sent
    row = {"bucket_elements": flat.numel()}
    for root in (0, 7):
        for chunks in (8, 64):
            bcast = C.make_broadcast(mesh, "data", root=root, n_chunks=chunks)
            if not torch.equal(bcast(x), x[root].expand(8, -1)):
                raise AssertionError(f"broadcast from {root} in {chunks} chunks differs")
            row[f"broadcast_root{root}_chunks{chunks}_wall_ms_median"] = statistics.median(
                _wall(lambda: bcast(x))) * 1e3
    ag = flat.reshape(8, -1)
    rs = torch.stack([flat * (r + 1) for r in range(8)])
    torch.cuda.synchronize()
    _zero_counts()   # counts from here to the read are concurrent AG/RS's
    got = C.concurrent_ag_rs_local(ag, rs)
    torch.cuda.synchronize()
    counts = _counts()
    want = {**dict.fromkeys(counts, 0), "ring_allgather": 1, "entries_ring": 7,
            "ring_allgather_transpose": 1, "transpose_entries_ring": 7}
    if counts != want:
        raise AssertionError(f"concurrent AG/RS launched {counts}, expected {want}")
    if not (torch.equal(got[0], C.ring_allgather_local(ag))
            and torch.equal(got[1], C.ring_reduce_scatter_local(rs, direction=-1))):
        raise AssertionError("concurrent AG/RS differs from the separate calls")
    bwd = concurrent_backward(ag, rs)
    counts = {k: counts[k] + bwd[k] for k in counts}
    row["concurrent_ag_rs_two_streams_wall_ms_median"] = statistics.median(
        _wall(lambda: C.concurrent_ag_rs_local(ag, rs))) * 1e3
    row["concurrent_ag_rs_one_stream_wall_ms_median"] = statistics.median(
        _wall(lambda: C._concurrent_ag_rs(ag, rs, overlap=False))) * 1e3
    row["concurrent_ag_rs_two_streams_device_ms"] = _device_ms(
        lambda: C.concurrent_ag_rs_local(ag, rs))
    row["concurrent_ag_rs_one_stream_device_ms"] = _device_ms(
        lambda: C._concurrent_ag_rs(ag, rs, overlap=False))
    print("[bucket] broadcast and concurrent AG/RS bitwise as required: " + json.dumps(row),
          flush=True)
    return counts


def concurrent_backward(ag: torch.Tensor, rs: torch.Tensor) -> dict[str, int]:
    """Phase 6d': the backward of ``concurrent_ag_rs_local`` on the bucket's
    shards (counts zeroed before it, read after): one ring-allgather launch
    (the reduce-scatter's cotangent) on the side stream and one transpose
    launch (the gather's) on the current one, seven entries each; both
    gradients bitwise the backwards of the separate ``ring_allgather_local``
    and ``ring_reduce_scatter_local(direction=-1)``. The profiler's records
    of the backward's body name the two kernels' streams, which must
    differ. Returns the backward's launches."""
    agr, rsr = ag.clone().requires_grad_(), rs.clone().requires_grad_()
    outs = C.concurrent_ag_rs_local(agr, rsr)
    gen = torch.Generator(device="cuda").manual_seed(10)
    cot = tuple(torch.randn(o.shape, generator=gen, device="cuda") for o in outs)

    def backward():
        return torch.autograd.grad(outs, (agr, rsr), cot, retain_graph=True)

    torch.cuda.synchronize()
    _zero_counts()   # counts from here to the read are the backward's
    got = backward()
    torch.cuda.synchronize()
    counts = _counts()
    want = {**dict.fromkeys(counts, 0), "ring_allgather": 1, "entries_ring": 7,
            "ring_allgather_transpose": 1, "transpose_entries_ring": 7}
    if counts != want:
        raise AssertionError(f"the concurrent AG/RS backward launched {counts}, expected {want}")
    a1, r1 = ag.clone().requires_grad_(), rs.clone().requires_grad_()
    d_ag = torch.autograd.grad(C.ring_allgather_local(a1), a1, cot[0])[0]
    d_rs = torch.autograd.grad(C.ring_reduce_scatter_local(r1, direction=-1), r1, cot[1])[0]
    if not (torch.equal(got[0], d_ag) and torch.equal(got[1], d_rs)):
        raise AssertionError("the concurrent AG/RS backward differs from the separate ones")
    # the Function's backward body (the forward's pair on the swapped
    # cotangents), called on this thread: the autograd engine runs a CUDA
    # backward on a thread of its own, which the profiler did not record
    _, _, records = _profiled(lambda: C._concurrent_ag_rs(cot[1], cot[0], overlap=True))
    streams = {name: sorted({st for key, st, _, _ in records if name in key})
               for name in ("ring_allgather_kernel", "ring_allgather_transpose_kernel")}
    if all(streams.values()):
        if set(streams["ring_allgather_kernel"]) & set(streams["ring_allgather_transpose_kernel"]):
            raise AssertionError(f"the concurrent AG/RS backward ran on one stream: {streams}")
        where = f"on streams {json.dumps(streams)}"
    else:
        where = "streams not measured (the profiler returned no records of the two kernels)"
    row = {"two_streams_device_ms": _device_ms(backward),
           "one_stream_device_ms": _device_ms(
               lambda: C._concurrent_ag_rs(cot[1], cot[0], overlap=False)),
           "two_streams_wall_ms_median": statistics.median(_wall(backward)) * 1e3}
    print(f"[bucket] concurrent AG/RS backward bitwise the separate backwards, {where}; "
          + json.dumps(row), flush=True)
    return counts


# ---------------------------------------------- phases 3d and 4d: the MoE family

MOE_ARCH = "deepseek-moe-16b"
MOE_PROMPT, MOE_NEW = 128, 8    # batch BATCH: T = 1,024 tokens a prefill, capacity 120
MOE_REPEATS = 3                 # host-clock samples per timed MoE call; the median is reported
MOE_TRAIN_LAYERS = 2
MOE_TRAIN_TIMED = 2
# served at 8 of its 28 layers: with every phase at full depth the script
# took 1,008 s on an H100 (3d 79 s), against its 1,200 s limit; at 14 layers
# and with phase 7 it took 1,025.5 s (3d 40.0 s)
MOE_SERVE_LAYERS = 8
# the reduced reference's prompt: batch 8 x 8 = 64 tokens at top-2 of 8
# experts, capacity 20 of the 16 an expert gets on average (tokens drop)
MOE_SMALL_SEQ = 8


def _moe_cfg():
    return get_model_config(MOE_ARCH)


def _moe_sharded_leaves(cfg) -> int:
    """The dp-sharded leaves of one MoE layer: wq, wk, wv, wo, the router,
    the three expert stacks and the three shared-expert matrices."""
    return 4 + 1 + 3 + (3 if cfg.moe.n_shared_experts else 0)


def _moe_matmuls(cfg, *, train: bool) -> tuple[int, int]:
    """(bf16 launches, f32 launches) of the matmul kernel a prefill, a decode
    step or (``train``, remat="full") a train step makes: per layer and
    forward pass the four attention projections, the three shared-expert
    products and the three expert products (each one launch batched over
    the E experts) in bf16 and the router in f32; the head once. A train
    step runs every forward product twice (the checkpointed recompute) and
    each product's two backward products; the head's forward twice (the
    checkpointed cross-entropy chunk) and its two backward products."""
    per_layer = 4 + 3 + (3 if cfg.moe.n_shared_experts else 0)
    passes = 4 if train else 1   # forward, recompute, dX, dW
    return passes * per_layer * cfg.num_layers + passes, passes * cfg.num_layers


def moe_capacity(cfg, tokens: int) -> int:
    m = cfg.moe
    return int(np.ceil(tokens * m.top_k / m.n_routed_experts * m.capacity_factor))


def moe_matmul_cases(cfg, r: int, m: int, cap: int, dtype, *, train: bool,
                     head_m: int | None = None) -> dict:
    """Every matmul an MoE step launches, as ``matmul_cases``: per rank
    (R = r, M = m tokens) the attention and shared-expert projections and
    the router (f32), per expert (R = E, M = cap) the three expert
    products, then the head."""
    cases: dict = {}

    def add(key, count):
        cases[key] = cases.get(key, 0) + count

    d, e, fe = cfg.d_model, cfg.moe.n_routed_experts, cfg.moe.d_ff_expert
    q, kv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    fs = fe * cfg.moe.n_shared_experts
    per_rank = [(d, q, dtype), (d, kv, dtype), (d, kv, dtype), (q, d, dtype),
                (d, e, torch.float32)]
    if fs:
        per_rank += [(d, fs, dtype), (d, fs, dtype), (fs, d, dtype)]
    products = [(r, m, k, n, dt) for k, n, dt in per_rank]
    products += [(e, cap, k, n, dtype) for k, n in ((d, fe), (d, fe), (fe, d))]
    for rr, mm, k, n, dt in products:
        add((rr, mm, k, n, False, False, dt), cfg.num_layers * (2 if train else 1))
        if train:
            add((rr, mm, n, k, False, True, dt), cfg.num_layers)    # dY W^T
            add((rr, k, mm, n, True, False, dt), cfg.num_layers)    # X^T dY
    v = cfg.vocab_size
    hm = m if head_m is None else head_m
    add((r, hm, d, v, False, False, dtype), 2 if train else 1)   # the head (D, V), as dense
    if train:
        add((r, hm, v, d, False, True, dtype), 1)
        add((r, d, hm, v, True, False, dtype), 1)
    return cases


def _path_want(mesh: StackedMesh, mode: str, *, gathers: int, transposes: int, matmul: int,
               wmma: int = 0, f32: int = 0) -> dict[str, int]:
    """Every count of ``_counts`` that a model call (MoE, or a dense config
    of phases 3e and 4e) must show: in the mcast modes ``gathers`` and
    ``transposes`` with their schedule entries, none in xla; ``matmul``,
    ``wmma`` and ``f32`` launches of the matmul's three kernels."""
    p = mesh.n_ranks
    g = 0 if mode == "xla" else gathers
    t = 0 if mode == "xla" else transposes
    return {**{k: 0 for k in PACKET_KERNELS + LAYER_KERNELS + ("ring_step",)},
            "ring_allgather": g, **_want_entries(mode, g * (p - 1), p),
            "ring_allgather_transpose": t,
            **_want_entries(mode, t * (p - 1), p, "transpose_entries"),
            "matmul": matmul, "matmul_wmma": wmma, "matmul_f32": f32}


def check_moe_small_reference() -> tuple[float, float]:
    """Phase 3d: reduced deepseek-moe-16b in f32 (capacity factor 1.25): the
    prefill and greedy tokens on (data=8) against a single-rank run of the
    same weights, and the routing's drop fraction equal (the routing is
    global: a per-rank router would drop other tokens). Returns the max abs
    logit difference and the drop fraction."""
    cfg = reduced(_moe_cfg())
    tree = bridge.random_params(cfg, seed=1)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (8, MOE_SMALL_SEQ))).cuda()
    outs = {}
    for mesh in (None, StackedMesh(data=8, model=1)):
        params = bridge.to_torch(tree, mesh, MeshConfig(), dtype=torch.float32)
        run = RunConfig(model=cfg, shape=ShapeConfig("s", "prefill", MOE_SMALL_SEQ, 8),
                        collective=CollectiveConfig(fsdp_mode="mcast"))
        _, ctx, prefill = make_prefill_step(run, mesh)
        _, _, decode = make_decode_step(run, mesh)
        logits, _ = prefill(params, {"tokens": tokens})
        toks = greedy_generate(prefill, decode, params, tokens, 8, MOE_SMALL_SEQ + 8)
        with use_ctx(ctx):
            _, aux, _ = transformer.dense_forward(params, cfg, {"tokens": tokens})
        outs[mesh is None] = (logits, toks, aux["moe_drop_frac"].item())
    err = (outs[True][0] - outs[False][0]).abs().max().item()
    if not err <= 1e-4:
        raise AssertionError(f"MoE sharded vs single-rank prefill differ by {err}")
    if not torch.equal(outs[True][1], outs[False][1]):
        raise AssertionError("MoE sharded vs single-rank greedy tokens differ")
    drop = outs[True][2]
    if outs[False][2] != drop or not drop > 0:
        raise AssertionError(f"MoE drop fractions {outs[False][2]} (8 ranks) and {drop} "
                             "(one rank): not equal, or nothing dropped")
    return err, drop


def _moe_decode_times(params, decode, pre, logits, out) -> dict:
    """The MOE_NEW - 1 decode steps of greedy generation on their own, from
    the prefilled cache (rewritten in place with the same values each
    call): their last token must be generation's; wall ms (medians of
    MOE_REPEATS), tok/s, busy ms and idle share of one profiled call."""
    cache = {k: F.pad(v, (0, 0, 0, MOE_NEW)) for k, v in pre.items()}
    pos0, tok0 = torch.full((BATCH,), MOE_PROMPT, device="cuda"), logits.argmax(-1)

    def do_decode():
        state, tok = ServeState(cache, pos0), tok0
        for _ in range(MOE_NEW - 1):
            step_logits, state = decode(params, state, tok)
            tok = step_logits.argmax(-1)
        return tok

    if not torch.equal(do_decode(), out[:, -1]):
        raise AssertionError("MoE decode loop disagrees with greedy_generate")
    decode_s = _wall(do_decode, MOE_REPEATS)
    dev_decode, prof_ms = _device_times(do_decode)
    busy = sum(dev_decode.values())
    top = sorted(dev_decode.items(), key=lambda kv: -kv[1])[:4]
    print("[moe-serve] decode, top device time (ms): "
          + json.dumps({k[:60]: t for k, t in top}), flush=True)
    return {"decode_steps": MOE_NEW - 1,
            "decode_ms_median": statistics.median(decode_s) * 1e3,
            "decode_ms_samples": [t * 1e3 for t in decode_s],
            "decode_tok_s": BATCH * (MOE_NEW - 1) / statistics.median(decode_s),
            "decode_device_busy_ms": busy, "decode_profiled_wall_ms": prof_ms,
            "decode_device_idle_share": 1 - busy / prof_ms}


def moe_serve() -> None:
    """Phase 3d: deepseek-moe-16b at full width and MOE_SERVE_LAYERS of its
    28 layers (bf16, weights drawn on the card by ``bridge.device_params``)
    on (data=8, model=1):
    a prefill of BATCH x MOE_PROMPT tokens, then greedy generation of
    MOE_NEW tokens, in every mode; logits and tokens bitwise xla's; each
    prefill launching a gather per sharded leaf and layer in the mcast
    modes and the matmuls of ``_moe_matmuls``, no transpose, no ring step,
    no wmma product. Decode is timed once, in the first mode: it gathers
    by the plain gather in every mode."""
    cfg = replace(_moe_cfg(), num_layers=MOE_SERVE_LAYERS)
    mesh = StackedMesh(data=8, model=1)
    t0 = time.perf_counter()
    params = bridge.device_params(cfg, mesh, MeshConfig(), seed=0, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(leaf.local.numel() if is_sharded(leaf.spec, ("data",))
                   else leaf.local[0].numel() for leaf in tree_leaves(params))
    print(f"[moe-serve] {cfg.name}: {cfg.num_layers} layers d_model {cfg.d_model}, "
          f"{cfg.moe.n_routed_experts} experts top-{cfg.moe.top_k}, {n_params:,} parameters "
          f"drawn on the card in {time.perf_counter() - t0:.3f} s; resident "
          f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB", flush=True)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (BATCH, MOE_PROMPT))).cuda()
    n_sharded = sum(1 for leaf in tree_leaves(params["blocks"])
                    if is_sharded(leaf.spec, ("data",)))
    if n_sharded != _moe_sharded_leaves(cfg):
        raise AssertionError(f"{n_sharded} sharded leaves a layer, expected "
                             f"{_moe_sharded_leaves(cfg)}")
    gathers = cfg.num_layers * n_sharded
    mm = _moe_matmuls(cfg, train=False)
    print(f"[moe-serve] launches a prefill: {gathers} ring_allgather (mcast modes: "
          f"{n_sharded} sharded leaves x {cfg.num_layers} layers), 0 transposes, "
          f"{mm[0]} bf16 matmul (10 x {cfg.num_layers} layers + the head) and {mm[1]} f32 "
          f"(the router, 1 x {cfg.num_layers}); a decode step the same matmuls and the "
          "plain gather", flush=True)
    ref = decode_row = None
    for mode in MODES:
        torch.cuda.reset_peak_memory_stats()
        run = RunConfig(model=cfg, shape=ShapeConfig("serve", "prefill", MOE_PROMPT, BATCH),
                        collective=CollectiveConfig(fsdp_mode=mode, n_chains=N_CHAINS))
        _, _, prefill = make_prefill_step(run, mesh)
        _, _, decode = make_decode_step(run, mesh)

        def do_prefill():
            return prefill(params, {"tokens": tokens})

        def do_generate():
            return greedy_generate(prefill, decode, params, tokens, MOE_NEW,
                                   MOE_PROMPT + MOE_NEW)

        do_prefill()   # warm-up
        (logits, pre), _, counts = _run(do_prefill)
        out, _, gen_counts = _run(do_generate)
        want = _path_want(mesh, mode, gathers=gathers, transposes=0, matmul=mm[0], f32=mm[1])
        want_gen = dict(want, matmul=mm[0] * MOE_NEW, matmul_f32=mm[1] * MOE_NEW)
        if counts != want or gen_counts != want_gen:
            raise AssertionError(f"{mode}: MoE prefill launched {counts}, expected {want}; "
                                 f"generation {gen_counts}, expected {want_gen}")
        prefill_s = _wall(do_prefill, MOE_REPEATS)
        dev_prefill, prefill_prof_ms = _device_times(do_prefill)
        busy_ms = sum(dev_prefill.values())
        if decode_row is None:   # decode gathers by the plain gather in every mode: once
            decode_row = _moe_decode_times(params, decode, pre, logits, out)
        if logits.shape != (BATCH, cfg.vocab_size) or not torch.isfinite(logits).all():
            raise AssertionError(f"{mode}: bad MoE logits {tuple(logits.shape)}")
        if (out.shape != (BATCH, MOE_PROMPT + MOE_NEW)
                or not torch.equal(out[:, :MOE_PROMPT], tokens)):
            raise AssertionError(f"{mode}: bad MoE tokens {tuple(out.shape)}")
        if ref is None:
            ref = (logits, out)
        diff = (logits.float() - ref[0].float()).abs().max().item()
        if diff != 0 or not torch.equal(out, ref[1]):
            raise AssertionError(f"MoE {mode} differs from xla: logits max diff {diff}")
        row = {"mode": mode,
               "prefill_ms_median": statistics.median(prefill_s) * 1e3,
               "prefill_ms_samples": [t * 1e3 for t in prefill_s],
               "launches_per_prefill": {k: v for k, v in counts.items() if v},
               "prefill_device_busy_ms": busy_ms,
               "prefill_profiled_wall_ms": prefill_prof_ms,
               "prefill_device_idle_share": 1 - busy_ms / prefill_prof_ms,
               "prefill_ring_allgather_device_ms": sum(
                   t for k, t in dev_prefill.items() if "ring_allgather_kernel" in k),
               "prefill_matmul_device_ms": sum(t for k, t in dev_prefill.items()
                                               if "matmul_" in k),
               **(decode_row if mode == MODES[0] else {}),
               "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
               "max_abs_logit_diff_vs_xla": diff,
               "sample_tokens": out[0, MOE_PROMPT:].tolist()}
        print("[moe-serve] " + json.dumps(row), flush=True)
        top = sorted(dev_prefill.items(), key=lambda kv: -kv[1])[:6]
        print(f"[moe-serve] {mode} prefill, top device time (ms): "
              + json.dumps({k[:60]: t for k, t in top}), flush=True)
    del params
    torch.cuda.empty_cache()


def moe_train() -> None:
    """Phase 4d: deepseek-moe-16b at full width, MOE_TRAIN_LAYERS layers,
    batch TRAIN_SHAPE (16 x 512), remat="full", AdamW, on (data=8,
    model=1), weights from ``bridge.device_params``, in every mode: a
    warm-up, MOE_TRAIN_TIMED timed steps and a profiled step each; the
    first-step loss bitwise equal in every mode, the moe_* metrics finite,
    a step launching a gather per sharded leaf and layer twice (the forward
    and the recompute), a transpose per forward gather and the matmuls of
    ``_moe_matmuls``."""
    cfg = replace(_moe_cfg(), num_layers=MOE_TRAIN_LAYERS)
    mesh = StackedMesh(data=8, model=1)
    tree = bridge.device_params(cfg, mesh, MeshConfig(), seed=0, dtype=torch.bfloat16)
    pipe = SyntheticPipeline(cfg, TRAIN_SHAPE)
    batches = [pipe.next_batch(i) for i in range(MOE_TRAIN_TIMED + 2)]
    n_sharded = _moe_sharded_leaves(cfg)
    gathers, transposes = 2 * n_sharded * cfg.num_layers, n_sharded * cfg.num_layers
    mm = _moe_matmuls(cfg, train=True)
    print(f"[moe-train] {cfg.name} at {cfg.num_layers} layers, batch "
          f"{TRAIN_SHAPE.global_batch} x {TRAIN_SHAPE.seq_len} (capacity "
          f"{moe_capacity(cfg, TRAIN_SHAPE.global_batch * TRAIN_SHAPE.seq_len)}): a step "
          f"launches {gathers} ring_allgather, {transposes} transposes, {mm[0]} bf16 matmul "
          f"(4 x (10 x {cfg.num_layers} + 1)) and {mm[1]} f32 (4 x {cfg.num_layers})",
          flush=True)
    first = {}
    for mode in MODES:
        torch.cuda.reset_peak_memory_stats()
        want = _path_want(mesh, mode, gathers=gathers, transposes=transposes, matmul=mm[0],
                          f32=mm[1])
        row, _ = _train_steps(cfg, mesh, tree, batches, mode, MOE_TRAIN_TIMED, want)
        row["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
        print("[moe-train] " + json.dumps(row), flush=True)
        first[mode] = row["losses"][0]
    if len(set(first.values())) != 1:
        raise AssertionError(f"MoE first-step losses differ between modes: {first}")
    print(f"[moe-train] first-step loss bitwise equal in every mode: {first['xla']!r}",
          flush=True)
    del tree
    torch.cuda.empty_cache()


def time_moe_kernels() -> dict:
    """#1 and #1b at one expert leaf of deepseek-moe-16b on 8 ranks (w_gate:
    a rank's shard 64 x 256 x 1408 bf16, the gathered copies 2.95 GB, past
    2^31 bytes): the gather and its transpose in each mcast schedule, each
    bitwise its plain version, timed beside it, the library call (the plain
    gather; the cotangent's sum over ranks) and the bound, as
    ``time_ring_steps``. Returns the means over the schedules."""
    cfg = _moe_cfg()
    p = 8
    n = cfg.moe.n_routed_experts * cfg.d_model * cfg.moe.d_ff_expert // p
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn((p, n), device="cuda", generator=gen).to(torch.bfloat16)
    g = torch.randn((p, p * n), device="cuda", generator=gen).to(torch.bfloat16)
    g3 = g.view(p, p, n)
    bound = (p * p + p) * n * 2 / HBM_BYTES_PER_S * 1e3
    rows = {}
    for mode, sched in (("mcast", C._bidi_schedule(p, n)), ("mcast_ring", C._ring_schedule(p)),
                        ("mcast_bcast", C._bcast_schedule(p, N_CHAINS))):
        if not torch.equal(K.ring_allgather(x, sched), K.ring_allgather_plain(x, sched)):
            raise AssertionError(f"{mode}: the gather of an expert leaf != plain")
        if not torch.equal(C._transposed(g, sched), K.ring_allgather_transpose_plain(g3, sched)):
            raise AssertionError(f"{mode}: the transpose of an expert leaf != plain")
        rows[mode] = {"gather_ms": _time(lambda: K.ring_allgather(x, sched)),
                      "gather_plain_ms": _time(lambda: K.ring_allgather_plain(x, sched)),
                      "gather_device_ms": _device_ms(lambda: K.ring_allgather(x, sched), 5),
                      "transpose_ms": _time(lambda: C._transposed(g, sched)),
                      "transpose_plain_ms": _time(
                          lambda: K.ring_allgather_transpose_plain(g3, sched)),
                      "transpose_device_ms": _device_ms(lambda: C._transposed(g, sched), 5)}
    out = {k: statistics.mean(r[k] for r in rows.values()) for k in rows["mcast"]}
    out.update({"gather_library_ms": _time(lambda: C.plain_allgather_local(x)),
                "transpose_library_ms": _time(lambda: g3.sum(-3)),
                "bound_ms": bound, "p": p, "n": n, "gathered_bytes": p * p * n * 2})
    print(f"[moe-kernels] one expert leaf, P={p} n={n} bf16: " + json.dumps(rows), flush=True)
    print("[moe-kernels] means over the schedules: " + json.dumps(out), flush=True)
    return out


# ------------------------- phases 3e and 4e: the registry's other dense configs

DENSE_ARCHS = ("yi-9b", "granite-3-8b", "granite-34b")
# granite-34b in full is 66.7 GB of bf16 weights on the card, and a prefill
# adds 8 gathered copies of a layer (6.1 GB) and of the head (4.8 GB): no
# margin on 80 GB. It is served at its full width and 40 of its 88 layers
DENSE_SERVE_LAYERS = {"granite-34b": 40}
DENSE_PROMPT, DENSE_NEW = 128, 8   # batch BATCH
DENSE_REPEATS = 3                  # host-clock samples per timed prefill; the median is reported
DENSE_TRAIN_LAYERS = 2
DENSE_TRAIN_TIMED = 2


def _dense_cfg(arch: str, *, train: bool = False):
    cfg = get_model_config(arch)
    layers = DENSE_TRAIN_LAYERS if train else DENSE_SERVE_LAYERS.get(arch, cfg.num_layers)
    return replace(cfg, num_layers=layers)


def _held_params(cfg, params) -> int:
    """The parameters a stacked tree holds: a sharded leaf's shards, a
    replicated leaf once."""
    n = sum(leaf.local.numel() if is_sharded(leaf.spec, ("data",)) else leaf.local[0].numel()
            for leaf in tree_leaves(params))
    norms = cfg.num_layers * 2 * cfg.d_model + cfg.d_model
    if n != cfg.n_params() + norms:
        raise AssertionError(f"{cfg.name}: {n} parameters on the card, the analytic count "
                             f"{cfg.n_params()} and {norms} norm scales")
    return n


def dense_serve() -> None:
    """Phase 3e: yi-9b (48 layers) and granite-3-8b (40) at full size and
    granite-34b at full width and DENSE_SERVE_LAYERS' depth, bf16, weights
    drawn on the card by ``bridge.device_params`` (their count the analytic
    one), on (data=8, model=1): a prefill of BATCH x DENSE_PROMPT tokens,
    then greedy generation of DENSE_NEW tokens, in every mode; logits and
    tokens bitwise xla's. A prefill launches a gather per sharded leaf and
    layer in the mcast modes (the embedding and the head go by the plain
    gather, as every weight used outside the layer loop), no transpose, no
    ring step, a matmul per projection and layer and the head's, which at
    granite-3-8b's odd vocab is the wmma kernel's; a decode step the same
    matmuls and no gather kernel. A mode's first prefill is the counted one
    (and its warm-up); then its generation, and DENSE_REPEATS timed
    prefills (the median reported); the mcast prefill profiled. Decode is
    timed once, in the first mode (every mode decodes through the plain
    gather): the generation's wall less the prefills' median."""
    mesh = StackedMesh(data=8, model=1)
    for arch in DENSE_ARCHS:
        cfg = _dense_cfg(arch)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = bridge.device_params(cfg, mesh, MeshConfig(), seed=0, dtype=torch.bfloat16)
        torch.cuda.synchronize()
        n_params = _held_params(cfg, params)
        print(f"[dense-serve] {cfg.name}: {cfg.num_layers} layers d_model {cfg.d_model}, "
              f"{cfg.num_heads} / {cfg.num_kv_heads} heads, d_ff {cfg.d_ff} ({cfg.act}), vocab "
              f"{cfg.vocab_size} ({'tied' if cfg.tie_embeddings else 'untied'} head), "
              f"{n_params:,} parameters drawn on the card in {time.perf_counter() - t0:.3f} s; "
              f"resident {torch.cuda.memory_allocated() / 2**30:.3f} GiB", flush=True)
        tokens = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (BATCH, DENSE_PROMPT))).cuda()
        leaves = _layer_leaves(cfg)
        n_sharded = sum(1 for leaf in tree_leaves(params["blocks"])
                        if is_sharded(leaf.spec, ("data",)))
        if n_sharded != len(leaves):
            raise AssertionError(f"{n_sharded} sharded leaves a layer, expected {len(leaves)}")
        gathers = cfg.num_layers * n_sharded
        wmma = head_wmma(cfg, train=False)
        mm = cfg.num_layers * len(leaves) + 1 - wmma
        print(f"[dense-serve] {cfg.name} launches a prefill: {gathers} ring_allgather (mcast "
              f"modes: {n_sharded} sharded leaves x {cfg.num_layers} layers; the embedding and "
              f"the {'tied head (the embedding again)' if cfg.tie_embeddings else 'lm_head'} "
              f"by the plain gather), 0 transposes, {mm} wgmma matmul and {wmma} wmma (the "
              "head at an odd vocab); a decode step the same matmuls and the plain gather",
              flush=True)
        ref = decode_row = None
        for mode in MODES:
            run = RunConfig(model=cfg, shape=ShapeConfig("serve", "prefill", DENSE_PROMPT, BATCH),
                            collective=CollectiveConfig(fsdp_mode=mode, n_chains=N_CHAINS))
            _, _, prefill = make_prefill_step(run, mesh)
            _, _, decode = make_decode_step(run, mesh)

            def do_prefill():
                return prefill(params, {"tokens": tokens})

            def do_generate():
                return greedy_generate(prefill, decode, params, tokens, DENSE_NEW,
                                       DENSE_PROMPT + DENSE_NEW)

            (logits, pre), _, counts = _run(do_prefill)
            out, gen_s, gen_counts = _run(do_generate)
            want = _path_want(mesh, mode, gathers=gathers, transposes=0, matmul=mm, wmma=wmma)
            want_gen = dict(want, matmul=mm * DENSE_NEW, matmul_wmma=wmma * DENSE_NEW)
            if counts != want or gen_counts != want_gen:
                raise AssertionError(f"{cfg.name} {mode}: prefill launched {counts}, expected "
                                     f"{want}; generation {gen_counts}, expected {want_gen}")
            prefill_s = _wall(do_prefill, DENSE_REPEATS)
            if decode_row is None:
                decode_s = gen_s - statistics.median(prefill_s)
                decode_row = {"decode_steps": DENSE_NEW - 1, "decode_ms": decode_s * 1e3,
                              "decode_tok_s": BATCH * (DENSE_NEW - 1) / decode_s,
                              "generation_ms": gen_s * 1e3}
            prof = {}
            if mode == "mcast":
                dev_prefill, prefill_prof_ms = _device_times(do_prefill)
                busy_ms = sum(dev_prefill.values())
                prof = {"prefill_device_busy_ms": busy_ms,
                        "prefill_profiled_wall_ms": prefill_prof_ms,
                        "prefill_device_idle_share": 1 - busy_ms / prefill_prof_ms,
                        "prefill_ring_allgather_device_ms": sum(
                            t for k, t in dev_prefill.items() if "ring_allgather_kernel" in k),
                        "prefill_matmul_device_ms": sum(t for k, t in dev_prefill.items()
                                                        if "matmul_" in k)}
                top = sorted(dev_prefill.items(), key=lambda kv: -kv[1])[:5]
                print(f"[dense-serve] {cfg.name} {mode} prefill, top device time (ms): "
                      + json.dumps({k[:60]: t for k, t in top}), flush=True)
            if logits.shape != (BATCH, cfg.vocab_size) or not torch.isfinite(logits).all():
                raise AssertionError(f"{cfg.name} {mode}: bad logits {tuple(logits.shape)}")
            if (out.shape != (BATCH, DENSE_PROMPT + DENSE_NEW)
                    or not torch.equal(out[:, :DENSE_PROMPT], tokens)):
                raise AssertionError(f"{cfg.name} {mode}: bad tokens {tuple(out.shape)}")
            want_cache = (cfg.num_layers, BATCH, cfg.num_kv_heads, DENSE_PROMPT, cfg.head_dim)
            if tuple(pre["k"].shape) != want_cache:
                raise AssertionError(f"{cfg.name}: cache {tuple(pre['k'].shape)}, expected "
                                     f"{want_cache}")
            if ref is None:
                ref = (logits, out)
            diff = (logits.float() - ref[0].float()).abs().max().item()
            if diff != 0 or not torch.equal(out, ref[1]):
                raise AssertionError(f"{cfg.name} {mode} differs from xla: logits max diff "
                                     f"{diff}")
            row = {"arch": cfg.name, "mode": mode,
                   "prefill_ms_median": statistics.median(prefill_s) * 1e3,
                   "prefill_ms_samples": [t * 1e3 for t in prefill_s],
                   "launches_per_prefill": {k: v for k, v in counts.items() if v},
                   **prof, **(decode_row if mode == MODES[0] else {}),
                   "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
                   "max_abs_logit_diff_vs_xla": diff,
                   "sample_tokens": out[0, DENSE_PROMPT:].tolist()}
            print("[dense-serve] " + json.dumps(row), flush=True)
        print(f"[dense-serve] {cfg.name}: peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB", flush=True)
        del params, pre, logits, out, ref
        torch.cuda.empty_cache()


def dense_train() -> None:
    """Phase 4e: each of DENSE_ARCHS at full width and DENSE_TRAIN_LAYERS
    layers, batch TRAIN_SHAPE (16 x 512), remat="full", AdamW, on (data=8,
    model=1), weights from ``bridge.device_params``, in every mode: a
    warm-up, DENSE_TRAIN_TIMED timed steps and a profiled step each, every
    step launching exactly ``_train_launches`` (granite-3-8b's odd head:
    ``head_wmma`` wmma launches a step); the first-step loss bitwise equal in
    every mode."""
    mesh = StackedMesh(data=8, model=1)
    for arch in DENSE_ARCHS:
        cfg = _dense_cfg(arch, train=True)
        torch.cuda.reset_peak_memory_stats()
        tree = bridge.device_params(cfg, mesh, MeshConfig(), seed=0, dtype=torch.bfloat16)
        n_params = _held_params(cfg, tree)
        pipe = SyntheticPipeline(cfg, TRAIN_SHAPE)
        batches = [pipe.next_batch(i) for i in range(DENSE_TRAIN_TIMED + 2)]
        want = _train_launches(cfg, mesh, "mcast")
        print(f"[dense-train] {cfg.name} at {cfg.num_layers} layers ({n_params:,} parameters), "
              f"batch {TRAIN_SHAPE.global_batch} x {TRAIN_SHAPE.seq_len}: a step launches "
              f"{want['ring_allgather']} ring_allgather, {want['ring_allgather_transpose']} "
              f"transposes, {want['matmul']} wgmma matmul and {want['matmul_wmma']} wmma (the "
              "head's forward, recompute, dx and dW at an odd vocab)", flush=True)
        first = {}
        for mode in MODES:
            torch.cuda.reset_peak_memory_stats()
            row, _ = _train_steps(cfg, mesh, tree, batches, mode, DENSE_TRAIN_TIMED,
                                  _train_launches(cfg, mesh, mode))
            row["arch"] = cfg.name
            row["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
            print("[dense-train] " + json.dumps(row), flush=True)
            first[mode] = row["losses"][0]
        if len(set(first.values())) != 1:
            raise AssertionError(f"{cfg.name}: first-step losses differ between modes: {first}")
        print(f"[dense-train] {cfg.name}: first-step loss bitwise equal in every mode: "
              f"{first['xla']!r}; wmma launches a step {want['matmul_wmma']}", flush=True)
        del tree
        torch.cuda.empty_cache()


# ------------------------------------- phases 3f and 4f: a physical model axis

TP_MESH = StackedMesh(data=2, model=4)
TP_BASE = StackedMesh(data=8, model=1)   # the same run with model layout only
TP_ARCH = "yi-9b"
TP_PROMPT, TP_NEW = 128, 8               # batch BATCH
TP_REPEATS = 2                           # timed prefills a variant; the median is reported
TP_TRAIN_LAYERS = 2
TP_TRAIN_TIMED = 1
# (mode, kv_cache_dtype, serve_params_replicated): every mode with the bf16
# cache, then mcast with the int8 cache and mcast with the weights replicated
TP_SERVE_VARIANTS = tuple((mode, "bf16", False) for mode in MODES) + (
    ("mcast", "int8", False), ("mcast", "bf16", True))
PROD_MESH = StackedMesh(data=16, model=16)
PROD_ARCH = "smollm-135m"
PROD_TRAIN_SHAPE = ShapeConfig("train", "train", 512, 16)
PROD_PROMPT = 128                        # batch 16


class _CallShapes:
    """The call shapes of the ring kernels on a path: while installed, every
    ``ring_allgather`` and ``ring_allgather_transpose`` call that
    ``core/collectives.py`` makes is recorded by (shape, strides, dtype,
    schedule) before it runs, for ``check_call_shapes``."""

    def __init__(self):
        self.shapes: dict[str, dict] = {"ring_allgather": {}, "ring_allgather_transpose": {}}

    def __enter__(self):
        self.saved = (C.ring_allgather, C.ring_allgather_transpose)

        def gather(x, schedule, out=None):
            self.shapes["ring_allgather"][(tuple(x.shape), tuple(x.stride()), x.dtype,
                                           tuple(schedule))] = None
            return self.saved[0](x, schedule, out)

        def transpose(g, schedule):
            self.shapes["ring_allgather_transpose"][(tuple(g.shape), tuple(g.stride()), g.dtype,
                                                     tuple(schedule))] = None
            return self.saved[1](g, schedule)

        C.ring_allgather, C.ring_allgather_transpose = gather, transpose
        return self

    def __exit__(self, *exc):
        C.ring_allgather, C.ring_allgather_transpose = self.saved


def check_call_shapes(shapes: _CallShapes) -> tuple[int, float]:
    """#1 and #1b at every call shape that phases 3h, 3f, 4f, 3i and 4i gave
    them (the FSDP gathers of the last three architectures on (data=8); the
    dp rings of tp groups strided by tp, the sequence, vocabulary, head and
    width gathers, the reduce-scatters and their backwards, phi-3-vision's
    whole token embedding and the expert leaves' E / tp copies among them):
    random values laid out with the call's own
    strides, the kernel against its plain version, bitwise; the gather's
    output laid out where the stacked ranks lie. Returns (calls, max abs
    err)."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    cases, max_err = 0, 0.0
    for name, seen in shapes.shapes.items():
        for shape, stride, dtype, schedule in seen:
            size = 1 + sum((n - 1) * st for n, st in zip(shape, stride))
            base = torch.randn(size, generator=gen, device="cuda").to(dtype)
            x = torch.as_strided(base, shape, stride)
            if name == "ring_allgather":
                got, want = K.ring_allgather(x, schedule), K.ring_allgather_plain(x, schedule)
            else:
                got = K.ring_allgather_transpose(x, schedule)
                want = K.ring_allgather_transpose_plain(x, schedule)
            torch.cuda.synchronize()
            max_err = max(max_err, _exact(name, (got,), (want,), (shape, stride, dtype)))
            cases += 1
    return cases, max_err


def check_strided_layouts() -> tuple[int, float]:
    """Phase 1: #1 and #1b on a tp group's layout, before any model runs:
    shards (A, B, P, n) viewed from a stacked (A, P, B, n) (the ranks of the
    ring axis B rows apart, as ``over_axis`` views a middle mesh axis), and
    a cotangent (A, B, P, P, n) viewed from (A, P, B, P, n): every schedule
    kind, P on the narrow and the wide kernel, vector and element paths,
    against the plain version, bitwise; the outputs laid out as (A, P, B,
    ...), where the stacked ranks lie. Returns (calls, max abs err)."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    cases, max_err = 0, 0.0
    for p in (2, 4, 16, 33):
        for dtype in (torch.bfloat16, torch.float32):
            for n in (7, 24, 4096):
                scheds = {"ring": C._ring_schedule(p), "bidi": C._bidi_schedule(p, n)}
                if p in (4, 16):
                    scheds["bcast"] = C._bcast_schedule(p, 2)
                for sched in scheds.values():
                    x = torch.randn((2, p, 3, n), generator=gen, device="cuda").to(dtype)
                    x = x.transpose(1, 2)
                    got = K.ring_allgather(x, sched)
                    want = K.ring_allgather_plain(x, sched)
                    g = torch.randn((2, p, 3, p, n), generator=gen, device="cuda").to(dtype)
                    g = g.transpose(1, 2)
                    got_t = K.ring_allgather_transpose(g, sched)
                    want_t = K.ring_allgather_transpose_plain(g, sched)
                    torch.cuda.synchronize()
                    if not (got.transpose(1, 2).is_contiguous()
                            and got_t.transpose(1, 2).is_contiguous()):
                        raise AssertionError(f"strided layout at P={p}: outputs not laid out "
                                             "where the ranks lie")
                    max_err = max(max_err, _exact("ring_allgather", (got,), (want,), (p, n)),
                                  _exact("ring_allgather_transpose", (got_t,), (want_t,),
                                         (p, n)))
                    cases += 2
    return cases, max_err


def _remesh(params, mesh: StackedMesh):
    """A tree of ``Stacked`` leaves moved to ``mesh``: each leaf's global
    tensor split as ``param_pspecs`` splits it there, leaf by leaf (the
    source tree emptied as it goes), so that both meshes run the same
    weights."""
    from repro_torch.sharding.fsdp import expand_ranks, global_tensor, split_global, unique_shards
    from repro_torch.sharding.specs import _leaf_spec

    def move(tree, path=()):
        out = {}
        for key in list(tree):
            leaf = tree.pop(key)
            if isinstance(leaf, dict):
                out[key] = move(leaf, path + (key,))
                continue
            full = global_tensor(leaf._replace(local=unique_shards(leaf)))
            spec = _leaf_spec(path + (key,), full, mesh, ("data",))
            out[key] = type(leaf)(expand_ranks(split_global(full, spec, mesh), spec, mesh,
                                               mesh.n_ranks), spec, mesh)
            del full
        return out

    return move(params)


def _unique_params(params) -> int:
    from repro_torch.sharding.fsdp import unique_shards
    return sum(unique_shards(leaf).numel() for leaf in tree_leaves(params))


def _want_tp(cfg, mesh: StackedMesh, mode: str, *, replicated: bool = False,
             steps: int = 0) -> dict[str, int]:
    """Every count of ``_counts`` for a prefill and ``steps`` decode steps on
    a mesh with a physical model axis (``tp_launches``), with the schedule
    entries: (dp - 1) of the mode's kind a dp gather (the composition of
    broadcasts at dp = N_CHAINS is the ring), (tp - 1) ring entries a
    ``model`` gather and a ``model`` reduce-scatter."""
    pre = tp_launches(cfg, mesh, mode, "prefill", replicated=replicated)
    dec = tp_launches(cfg, mesh, mode, "decode", replicated=replicated)
    n = {k: pre[k] + steps * dec[k] for k in pre}
    dp, tp = mesh.shape["data"], mesh.tp
    dp_gathers = 0 if mode == "xla" or replicated else cfg.num_layers * len(_layer_leaves(cfg))
    entries = {f"entries_{kind}": 0 for kind in K.entries}
    if dp_gathers:
        rounds = dp // min(N_CHAINS, dp) if mode == "mcast_bcast" else 1
        kind = ("bcast" if rounds > 1 else "ring") if mode == "mcast_bcast" else ENTRY_KIND[mode]
        entries[f"entries_{kind}"] += dp_gathers * rounds * (dp - 1)
    entries["entries_ring"] += (n["ring_allgather"] - dp_gathers) * (tp - 1)
    transposes = {f"transpose_entries_{kind}": 0 for kind in K.transpose_entries}
    transposes["transpose_entries_ring"] = n["ring_allgather_transpose"] * (tp - 1)
    return {**{k: 0 for k in PACKET_KERNELS + LAYER_KERNELS + OFF_PATH + ("ring_step",)},
            **n, **entries, **transposes}


def tp_serve() -> dict:
    """Phase 3f: yi-9b as registered (48 layers, d_model 4096, 32 / 4 heads)
    on (data=2, model=4): 8 stacked ranks, tensor- and sequence-parallel
    over ``model``. The weights are drawn by ``bridge.device_params`` on
    (data=8, model=1), where the same batch (BATCH x TP_PROMPT, TP_NEW new
    tokens, mcast) runs first, then moved to (2, 4) (``_remesh``). Every mode
    with the bf16 cache, then mcast with the int8 cache, and mcast with
    ``serve_params_replicated`` (its layout made once, ``serving_params``,
    the sharded tree dropped): a counted prefill (``tp_launches``) and
    generation, TP_REPEATS timed prefills, the decode steps' time from the
    generation's wall less the prefills' median; the mcast prefill and a
    decode step profiled. Logits and tokens bitwise equal across the modes
    (bf16); against (8, 1) the largest logit difference and the share of
    equal greedy tokens, with no limit (bf16 partial sums added in another
    order). Returns the rows."""
    cfg = get_model_config(TP_ARCH)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (BATCH, TP_PROMPT))).cuda()
    torch.cuda.reset_peak_memory_stats()
    params = bridge.device_params(cfg, TP_BASE, MeshConfig(), seed=0, dtype=torch.bfloat16)
    run = RunConfig(model=cfg, shape=ShapeConfig("serve", "prefill", TP_PROMPT, BATCH),
                    collective=CollectiveConfig(fsdp_mode="mcast", n_chains=N_CHAINS))
    _, _, prefill = make_prefill_step(run, TP_BASE)
    _, _, decode = make_decode_step(run, TP_BASE)
    base_logits, _ = prefill(params, {"tokens": tokens})
    base_out = greedy_generate(prefill, decode, params, tokens, TP_NEW, TP_PROMPT + TP_NEW)
    t0 = time.perf_counter()
    params = _remesh(params, TP_MESH)
    torch.cuda.synchronize()
    n_params = _unique_params(params)
    norms = cfg.num_layers * 2 * cfg.d_model + cfg.d_model
    if n_params != cfg.n_params() + norms:
        raise AssertionError(f"{n_params} parameters on {TP_MESH}, expected "
                             f"{cfg.n_params() + norms}")
    print(f"[tp-serve] {cfg.name} on {TP_MESH}: {n_params:,} parameters moved from {TP_BASE} in "
          f"{time.perf_counter() - t0:.3f} s; resident "
          f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB; predicted launches a prefill / "
          f"decode step (mcast): {json.dumps(tp_launches(cfg, TP_MESH, 'mcast', 'prefill'))} / "
          f"{json.dumps(tp_launches(cfg, TP_MESH, 'mcast', 'decode'))}", flush=True)
    rows, ref = [], None
    for mode, kv, repl in TP_SERVE_VARIANTS:
        if repl:   # the replicated layout, made once for both steps (the last variant)
            t0 = time.perf_counter()
            params = serving_params(params, RunConfig(model=cfg, shape=ShapeConfig(
                "serve", "prefill", TP_PROMPT, BATCH)), TP_MESH)
            torch.cuda.synchronize()
            print(f"[tp-serve] the dp-replicated layout made in "
                  f"{time.perf_counter() - t0:.3f} s", flush=True)
        torch.cuda.reset_peak_memory_stats()
        vcfg = replace(cfg, kv_cache_dtype=kv)
        run = RunConfig(model=vcfg, shape=ShapeConfig("serve", "prefill", TP_PROMPT, BATCH),
                        collective=CollectiveConfig(fsdp_mode=mode, n_chains=N_CHAINS,
                                                    serve_params_replicated=repl))
        _, _, prefill = make_prefill_step(run, TP_MESH)
        _, _, decode = make_decode_step(run, TP_MESH)

        def do_prefill():
            return prefill(params, {"tokens": tokens})

        def do_generate():
            return greedy_generate(prefill, decode, params, tokens, TP_NEW, TP_PROMPT + TP_NEW)

        (logits, pre), _, counts = _run(do_prefill)
        out, gen_s, gen_counts = _run(do_generate)
        want = _want_tp(vcfg, TP_MESH, mode, replicated=repl)
        want_gen = _want_tp(vcfg, TP_MESH, mode, replicated=repl, steps=TP_NEW - 1)
        if counts != want or gen_counts != want_gen:
            raise AssertionError(f"{TP_ARCH} {mode} {kv} repl={repl}: prefill launched "
                                 f"{counts}, expected {want}; generation {gen_counts}, "
                                 f"expected {want_gen}")
        prefill_s = _wall(do_prefill, TP_REPEATS)
        decode_s = gen_s - statistics.median(prefill_s)
        cache = {n: F.pad(c, (0, 0, 0, TP_NEW)) for n, c in pre.items()}
        state = ServeState(cache, torch.full((BATCH,), TP_PROMPT, dtype=torch.long,
                                             device="cuda"))
        prof = {}
        if mode == "mcast" and kv == "bf16":
            for what, fn in (("prefill", do_prefill),
                             ("decode", lambda: decode(params, state, out[:, TP_PROMPT]))):
                dev, wall_ms = _device_times(fn)
                busy = sum(dev.values())
                prof.update({f"{what}_device_busy_ms": busy, f"{what}_profiled_wall_ms": wall_ms,
                             f"{what}_device_idle_share": 1 - busy / wall_ms,
                             f"{what}_ring_allgather_device_ms": sum(
                                 t for k, t in dev.items() if "ring_allgather_kernel" in k),
                             f"{what}_transpose_device_ms": sum(
                                 t for k, t in dev.items() if "transpose_kernel" in k),
                             f"{what}_matmul_device_ms": sum(t for k, t in dev.items()
                                                             if "matmul_" in k)})
                top = sorted(dev.items(), key=lambda kv_: -kv_[1])[:5]
                print(f"[tp-serve] {mode}{' repl' if repl else ''} {what}, top device time "
                      "(ms): " + json.dumps({k[:60]: t for k, t in top}), flush=True)
        if logits.shape != (BATCH, cfg.vocab_size) or not torch.isfinite(logits).all():
            raise AssertionError(f"{TP_ARCH} {mode}: bad logits {tuple(logits.shape)}")
        if (out.shape != (BATCH, TP_PROMPT + TP_NEW)
                or not torch.equal(out[:, :TP_PROMPT], tokens)):
            raise AssertionError(f"{TP_ARCH} {mode}: bad tokens {tuple(out.shape)}")
        if kv == "int8" and pre["k"].dtype != torch.int8:
            raise AssertionError(f"the int8 cache is {pre['k'].dtype}")
        if ref is None:
            ref = (logits, out)
        diff = (logits.float() - ref[0].float()).abs().max().item()
        if kv == "bf16" and not repl and (diff != 0 or not torch.equal(out, ref[1])):
            raise AssertionError(f"{TP_ARCH} {mode} on {TP_MESH} differs from xla: logits "
                                 f"max diff {diff}")
        new = out[:, TP_PROMPT:]
        row = {"arch": cfg.name, "mesh": repr(TP_MESH), "mode": mode, "kv_cache": kv,
               "serve_params_replicated": repl,
               "prefill_ms_median": statistics.median(prefill_s) * 1e3,
               "prefill_ms_samples": [t * 1e3 for t in prefill_s],
               "decode_steps": TP_NEW - 1, "decode_ms": decode_s * 1e3,
               "decode_tok_s": BATCH * (TP_NEW - 1) / decode_s,
               "launches_per_prefill": {k: v for k, v in counts.items() if v},
               "launches_per_decode_step": {k: (gen_counts[k] - counts[k]) // (TP_NEW - 1)
                                            for k in MODEL_KERNELS},
               **prof, "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
               "max_abs_logit_diff_vs_xla_bf16": diff,
               "max_abs_logit_diff_vs_8x1": (logits.float() - base_logits.float()).abs()
               .max().item(),
               "greedy_tokens_equal_share_vs_8x1":
                   (new == base_out[:, TP_PROMPT:]).float().mean().item(),
               "greedy_tokens_equal_share_vs_xla_bf16":
                   (new == ref[1][:, TP_PROMPT:]).float().mean().item(),
               "sample_tokens": new[0].tolist()}
        rows.append(row)
        print("[tp-serve] " + json.dumps(row), flush=True)
        del pre, logits, out, cache, state
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    return rows


def tp_train() -> None:
    """Phase 4f: yi-9b at full width and TP_TRAIN_LAYERS layers on (data=2,
    model=4), batch TRAIN_SHAPE (16 x 512), remat="full", in every mode (a
    warm-up, TP_TRAIN_TIMED timed steps, a profiled step); then smollm-135m
    at full depth on the production mesh (data=16, model=16), 256 ranks: one
    training step (16 x 512) and one prefill (16 x PROD_PROMPT) in every
    mode. The first-step losses and the prefill logits bitwise equal across
    the modes at each mesh."""
    for cfg, mesh, shape, timed in (
            (replace(get_model_config(TP_ARCH), num_layers=TP_TRAIN_LAYERS), TP_MESH,
             TRAIN_SHAPE, TP_TRAIN_TIMED),
            (get_model_config(PROD_ARCH), PROD_MESH, PROD_TRAIN_SHAPE, 0)):
        tree = bridge.device_params(cfg, mesh, MeshConfig(), seed=0, dtype=torch.bfloat16)
        n_params = _unique_params(tree)
        pipe = SyntheticPipeline(cfg, shape)
        batches = [pipe.next_batch(i) for i in range(timed + 2)]
        first, logits0 = {}, None
        tokens = torch.from_numpy(np.random.default_rng(1).integers(
            0, cfg.vocab_size, (shape.global_batch, PROD_PROMPT))).cuda()
        for mode in MODES:
            torch.cuda.reset_peak_memory_stats()
            run = _train_run(cfg, shape, mode)
            _, _, step = make_train_step(run, mesh)
            state = init_state(run, mesh, tree)
            (state, m), warm_s, counts = _run(lambda: step(state, batches[0]))
            losses, norms, samples = [float(m["loss"])], [float(m["grad_norm"])], []
            for b in batches[1:timed + 1]:
                (state, m), dt, _ = _run(lambda b=b: step(state, b))
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
                samples.append(dt)
            _check_losses(cfg, mode, losses, norms)
            row = {"arch": cfg.name, "layers": cfg.num_layers, "mesh": repr(mesh),
                   "mode": mode, "parameters": n_params, "losses": losses, "grad_norms": norms,
                   "first_step_ms": warm_s * 1e3,
                   "launches_first_step": {k: v for k, v in counts.items() if v}}
            if samples:
                row.update(_step_times(samples, shape))
                row.update(_profiled_step(step, state, batches[timed + 1], f"{mode} step"))
            del state, m
            torch.cuda.empty_cache()
            if mesh is PROD_MESH:
                prun = RunConfig(model=cfg,
                                 shape=ShapeConfig("serve", "prefill", PROD_PROMPT,
                                                   shape.global_batch),
                                 collective=CollectiveConfig(fsdp_mode=mode, n_chains=N_CHAINS))
                _, _, prefill = make_prefill_step(prun, mesh)
                (logits, _), pre_s, pre_counts = _run(lambda: prefill(tree, {"tokens": tokens}))
                if not torch.isfinite(logits).all():
                    raise AssertionError(f"{cfg.name} on {mesh}: non-finite logits")
                logits0 = logits if logits0 is None else logits0
                if not torch.equal(logits, logits0):
                    raise AssertionError(f"{cfg.name} on {mesh} {mode}: prefill logits differ "
                                         "from xla's")
                row.update(prefill_ms=pre_s * 1e3,
                           launches_prefill={k: v for k, v in pre_counts.items() if v})
                del logits
            row["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
            print("[tp-train] " + json.dumps(row), flush=True)
            first[mode] = losses[0]
        if len(set(first.values())) != 1:
            raise AssertionError(f"{cfg.name} on {mesh}: first-step losses differ between "
                                 f"modes: {first}")
        print(f"[tp-train] {cfg.name} on {mesh}: first-step loss bitwise equal in every mode: "
              f"{first['xla']!r}", flush=True)
        del tree
        torch.cuda.empty_cache()


# ------------------------- phases 3g and 4g: the sub-quadratic families

SUBQ_ARCHS = ("rwkv6-7b", "recurrentgemma-9b")
SUBQ_PROMPT, SUBQ_NEW = 128, 8     # batch BATCH
SUBQ_REPEATS = 2                   # timed prefills a mode; the median is reported
# training depth: rwkv6-7b's 2 layers; recurrentgemma-9b's one (rec, rec,
# attn) group and its 2 trailing rec layers, so that every layer kind runs
SUBQ_TRAIN_LAYERS = {"rwkv6-7b": 2, "recurrentgemma-9b": 5}
SUBQ_TRAIN_TIMED = 1
# recurrentgemma-9b's tied 256,000 x 4,096 head: every rank's copy (2.1 GB)
# kept for the cross-entropy's backward, its gradient and the embedding
# lookup's (2.1 GB each a rank), beside the 512-position chunk's f32 logits
# (8.4 GB whatever the ranks) and the several f32 tensors of that size in
# its backward, and the AdamW moments (17.4 GB): on 4 ranks a step asked
# for 71.7 GB and more on an 80 GB H100, so it trains on 2
SUBQ_TRAIN_MESH = {"rwkv6-7b": StackedMesh(data=8, model=1),
                   "recurrentgemma-9b": StackedMesh(data=2, model=1)}
SUBQ_SMALL_NEW = 8


def _subq_cfg(arch: str, *, train: bool = False):
    cfg = get_model_config(arch)
    return replace(cfg, num_layers=SUBQ_TRAIN_LAYERS[arch]) if train else cfg


def subq_layers(cfg) -> list[tuple[int, int, list[tuple[int, int, int, bool]]]]:
    """Each layer kind of an rwkv or hybrid config as (layers of that kind,
    dp-sharded leaves a layer, its products (k, n, copies a rank, f32)): the
    gathers and the matmul launches of the model code. An RWKV6 layer: the
    token-shift LoRA's two products (the second one launch for its five
    mixes), r, k, v, g, the decay LoRA's two, the output, the channel mix's
    three; 12 sharded leaves. A hybrid rec layer: the gate and recurrence
    inputs, the RG-LRU's two gates in f32, the output and the SwiGLU's three;
    8 sharded leaves (the conv and the vectors are not). An attention layer:
    q, k, v, o and the SwiGLU; 7 sharded leaves."""
    d, f = cfg.d_model, cfg.d_ff
    if cfg.family == "rwkv":
        ts, dl = cfg.rwkv.tokenshift_lora, cfg.rwkv.decay_lora
        return [(cfg.num_layers, 12,
                 [(d, 5 * ts, 1, False), (ts, d, 5, False)] + [(d, d, 1, False)] * 4
                 + [(d, dl, 1, False), (dl, d, 1, False), (d, d, 1, False),
                    (d, f, 1, False), (f, d, 1, False), (d, d, 1, False)])]
    ng, nt = transformer.hybrid_layout(cfg)
    w = cfg.rglru.lru_width
    q, kv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    mlp = [(d, f, 1, False), (d, f, 1, False), (f, d, 1, False)]
    rec = [(d, w, 1, False), (d, w, 1, False), (w, w, 1, True), (w, w, 1, True),
           (w, d, 1, False)] + mlp
    attn = [(d, q, 1, False), (d, kv, 1, False), (d, kv, 1, False), (q, d, 1, False)] + mlp
    return [(2 * ng + nt, 8, rec), (ng, 7, attn)]


def subq_launches(cfg, *, train: bool) -> dict[str, int]:
    """#1 gathers (mcast modes), #1b transposes, and the matmul kernel's
    bf16 and f32 launches of one prefill (``train`` False; a decode step the
    same products and no gather kernel) or one train step (remat="full":
    every gather twice, the checkpointed body's recompute, and one
    transpose; every product four times: forward, recompute, dx, dW; the
    head's 512-position chunk the same four)."""
    gathers = sum(n * leaves for n, leaves, _ in subq_layers(cfg))
    bf16 = sum(n * sum(1 for *_, f32 in prods if not f32) for n, _, prods in subq_layers(cfg))
    f32 = sum(n * sum(1 for *_, f32 in prods if f32) for n, _, prods in subq_layers(cfg))
    if not train:
        return {"ring_allgather": gathers, "ring_allgather_transpose": 0,
                "matmul": bf16 + 1, "matmul_f32": f32}
    chunks = -(-TRAIN_SHAPE.seq_len // XENT_CHUNK)
    return {"ring_allgather": 2 * gathers, "ring_allgather_transpose": gathers,
            "matmul": 4 * bf16 + 4 * chunks, "matmul_f32": 4 * f32}


def subq_matmul_cases(cfg, r: int, m: int, *, train: bool, head_m: int | None = None) -> dict:
    """Every matmul shape the path gives the kernel, {(batch, m, k, n, a_t,
    b_t, dtype): launches}, as ``matmul_cases`` (the LoRA's five mixes one
    product of batch 5 r; the gates f32)."""
    cases: dict = {}

    def add(key, count):
        cases[key] = cases.get(key, 0) + count

    for layers, _, prods in subq_layers(cfg):
        for k, n, copies, f32 in prods:
            dt = torch.float32 if f32 else torch.bfloat16
            add((r * copies, m, k, n, False, False, dt), layers * (2 if train else 1))
            if train:
                add((r * copies, m, n, k, False, True, dt), layers)
                add((r * copies, k, m, n, True, False, dt), layers)
    d, v = cfg.d_model, cfg.vocab_size
    hm = m if head_m is None else head_m
    add((r, hm, d, v, False, False, torch.bfloat16), 2 if train else 1)
    if train:
        add((r, hm, v, d, False, True, torch.bfloat16), 1)
        add((r, d, hm, v, True, False, torch.bfloat16), 1)
    return cases


def _uncounted(cfg) -> int:
    """Weights the tree holds that the reference's analytic count leaves out:
    the final norm; the norm scales of the layers (two a layer; the encdec's
    two an encoder layer, three a decoder layer and ``enc_ln``; none for
    rwkv, whose count has them); the hybrid's norms outside the rec block
    (a rec layer's ln2, an attention layer's ln1 and ln2) and its unused
    one-layer ``tail_rec`` where the depth has no trailing layer, less the
    one vector of lru_width a rec layer that the count has and the block
    has not."""
    d = cfg.d_model
    if cfg.family == "rwkv":
        return d
    if cfg.family == "encdec":
        return (2 * cfg.encdec.enc_layers + 3 * cfg.encdec.dec_layers + 2) * d
    if cfg.family != "hybrid":
        return (2 * cfg.num_layers + 1) * d
    ng, nt = transformer.hybrid_layout(cfg)
    from repro_torch.models import rglru
    rec = rglru.rec_block_param_count(cfg) + 3 * d * cfg.d_ff
    unused = (rec + d - cfg.rglru.lru_width) if nt == 0 else 0
    return d + (2 * ng + nt) * d + 2 * ng * d + unused - (2 * ng + nt) * cfg.rglru.lru_width


def _tree_gathers(cfg, params) -> int:
    """The dp-sharded leaves of the tree's layers, counted once a layer: the
    gathers a pass makes (the hybrid's unused one-layer ``tail_rec`` aside)."""
    ng, nt = transformer.hybrid_layout(cfg) if cfg.family == "hybrid" else (0, 1)
    return sum(leaf.local.shape[1] for name, sub in params.items() if isinstance(sub, dict)
               and (name != "tail_rec" or nt) for leaf in tree_leaves(sub)
               if is_sharded(leaf.spec, ("data",)))


def _held(cfg, params) -> int:
    n = _unique_params(params)
    if n != cfg.n_params() + _uncounted(cfg):
        raise AssertionError(f"{cfg.name}: {n} weights on the card, the analytic count "
                             f"{cfg.n_params()} and {_uncounted(cfg)} it leaves out")
    return n


def check_subq_small_reference() -> float:
    """Phase 3g: reduced rwkv6-7b and recurrentgemma-9b (5 layers, window 32)
    in f32 on (data=8) on the card against the same run on the host's CPU
    (the path the CPU tests hold against the JAX package): prefill logits
    within 1e-4 in every mode, and greedy generation past the window (a
    40-token prompt, 8 new tokens: the hybrid's ring handoff) with the same
    tokens. Returns the largest logit difference."""
    mesh = StackedMesh(data=8, model=1)
    worst = 0.0
    for arch in SUBQ_ARCHS:
        cfg = reduced(get_model_config(arch), layers=5 if arch == "recurrentgemma-9b" else None)
        tree = bridge.random_params(cfg, seed=2)
        tokens = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (8, 40)))
        out = {}
        for dev in ("cpu", "cuda"):
            params = bridge.to_torch(tree, mesh, MeshConfig(), dtype=torch.float32, device=dev)
            for mode in MODES:
                run = RunConfig(model=cfg, shape=ShapeConfig("p", "prefill", 40, 8),
                                collective=CollectiveConfig(fsdp_mode=mode, n_chains=N_CHAINS))
                _, _, prefill = make_prefill_step(run, mesh, device=dev)
                _, _, decode = make_decode_step(run, mesh, device=dev)
                logits, _ = prefill(params, {"tokens": tokens.to(dev)})
                toks = greedy_generate(prefill, decode, params, tokens.to(dev), SUBQ_SMALL_NEW,
                                       40 + SUBQ_SMALL_NEW)
                out[dev, mode] = (logits.cpu(), toks.cpu())
        for mode in MODES:
            (lc, tc), (lg, tg) = out["cpu", mode], out["cuda", mode]
            diff = (lc - lg).abs().max().item()
            worst = max(worst, diff)
            if not (diff <= 1e-4 and torch.equal(tc, tg)):
                raise AssertionError(f"reduced {arch} {mode}: card vs CPU logits max diff "
                                     f"{diff}, tokens equal {torch.equal(tc, tg)}")
    return worst


def _busy_ms(fn) -> float | None:
    """Device ms of one call of ``fn`` after a warm-up: the sum of its
    kernels' device time in the profiler's records; None where the profiler
    dropped them (it has on the card's machine)."""
    fn()
    return sum(_device_times(fn)[0].values()) or None


def _subq_pieces(cfg, b: int, s: int) -> dict[str, float]:
    """Device ms of the plain-torch pieces of one layer at (global batch b,
    sequence s), from the profiler (``_busy_ms``): the chunked WKV and one
    recurrent step (rwkv); the RG-LRU's doubling scan, the causal conv and,
    at one position, ``ring_decode_attention`` (hybrid)."""
    from repro_torch.models import rglru, rwkv
    gen = torch.Generator(device="cuda").manual_seed(11)
    if cfg.family == "rwkv":
        h, hd = cfg.num_heads, cfg.head_dim
        r, k, v = (torch.randn((b, s, h, hd), generator=gen, device="cuda") for _ in range(3))
        lw = -torch.rand((b, s, h, hd), generator=gen, device="cuda")
        u = torch.randn((b, h, hd), generator=gen, device="cuda") * 0.5
        return {"wkv_chunked_ms": _busy_ms(lambda: rwkv.wkv_chunked(
                    r, k, v, lw, u, cfg.rwkv.chunk_size)),
                "wkv_recurrent_step_ms": _busy_ms(lambda: rwkv.wkv_recurrent(
                    r[:, :1], k[:, :1], v[:, :1], lw[:, :1], u))}
    w = cfg.rglru.lru_width
    a = torch.rand((b, s, w), generator=gen, device="cuda")
    x = torch.randn((b, s, w), generator=gen, device="cuda")
    cw = torch.randn((1, cfg.rglru.conv_width, w), generator=gen, device="cuda").bfloat16()
    xb = x.bfloat16()[None]
    win = min(cfg.rglru.window, s)
    q = torch.randn((b, cfg.num_heads, cfg.head_dim), generator=gen, device="cuda").bfloat16()
    kc = torch.randn((b, cfg.num_kv_heads, win, cfg.head_dim), generator=gen,
                     device="cuda").bfloat16()
    pos = torch.full((b,), s - 1, dtype=torch.long, device="cuda")
    abs_pos = pos[:, None] - ((pos[:, None] - torch.arange(win, device="cuda")) % win)
    from repro_torch.models import attention
    return {"rglru_scan_ms": _busy_ms(lambda: rglru.rglru_scan(a, x)),
            "causal_conv1d_ms": _busy_ms(lambda: rglru.causal_conv1d(
                xb, cw, torch.zeros((1, w), device="cuda"))),
            "ring_decode_attention_ms": _busy_ms(lambda: attention.ring_decode_attention(
                q, kc, kc, abs_pos, pos, cfg.rglru.window))}


def _cache_shapes(cfg, batch: dict) -> dict[str, tuple]:
    """The prefill cache's entries a rank, as (B, KV, S, hd) after the layer
    axis: the attention families' ``k`` over the stream (the encdec's over
    its tokens, and its cross ``xk`` over the frames); none checked for
    rwkv's states and the hybrid's rings."""
    kv, hd = cfg.num_kv_heads, cfg.head_dim
    if cfg.family in ("rwkv", "hybrid"):
        return {}
    if cfg.family != "encdec":
        return {"k": (BATCH, kv, transformer.stream_len(cfg, batch), hd)}
    return {"k": (BATCH, kv, batch["tokens"].shape[1], hd),
            "xk": (BATCH, kv, batch["frames"].shape[1], hd)}


def _serve_model(tag: str, cfg, batch: dict, launches, new: int, repeats: int,
                 extras=None) -> dict:
    """One architecture of phases 3g and 3h at full size, bf16, weights
    drawn on the card by ``bridge.device_params`` (their count ``_held``'s),
    on (data=8, model=1): a prefill of ``batch`` (BATCH prompts and the
    frontend's inputs) in every mode, its logits bitwise xla's, its caches
    ``_cache_shapes``, launching ``launches(cfg, "prefill")``; the mcast
    mode's greedy generation of ``new`` tokens, a decode step launching
    ``launches(cfg, "decode")`` (decode gathers with the plain gather in
    every mode, so once); ``repeats`` timed prefills a mode (the median
    reported), the mcast prefill profiled; then the entries that
    ``extras(cfg, params, batch, xla's logits)`` adds to the row. Returns
    the row."""
    mesh = StackedMesh(data=8, model=1)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = bridge.device_params(cfg, mesh, MeshConfig(), seed=0, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = _held(cfg, params)
    print(f"[{tag}] {cfg.name} ({cfg.family}): {cfg.num_layers} layers d_model {cfg.d_model}, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size} "
          f"({'tied' if cfg.tie_embeddings else 'untied'} head), {n_params:,} weights drawn on "
          f"the card ({cfg.n_params():,} in the analytic count) in "
          f"{time.perf_counter() - t0:.3f} s; resident "
          f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB", flush=True)
    tokens = batch["tokens"]
    inputs = {k: v for k, v in batch.items() if k != "tokens"}
    s0, p = transformer.stream_len(cfg, batch), tokens.shape[1]
    per, dec = launches(cfg, "prefill"), launches(cfg, "decode")
    if _tree_gathers(cfg, params) != per["ring_allgather"]:
        raise AssertionError(f"{_tree_gathers(cfg, params)} sharded layer leaves, expected "
                             f"{per['ring_allgather']}")
    print(f"[{tag}] {cfg.name} launches derived from the code: a prefill {json.dumps(per)} "
          f"(#1 in the mcast modes), a decode step {json.dumps(dec)}", flush=True)
    ref, row = None, {"arch": cfg.name, "n_weights": n_params, "stream": s0, "modes": {}}
    for mode in MODES:
        run = RunConfig(model=cfg, shape=ShapeConfig("serve", "prefill", s0, BATCH),
                        collective=CollectiveConfig(fsdp_mode=mode, n_chains=N_CHAINS))
        _, _, prefill = make_prefill_step(run, mesh)

        def do_prefill():
            return prefill(params, batch)

        (logits, pre), _, counts = _run(do_prefill)
        want = _path_want(mesh, mode, gathers=per["ring_allgather"], transposes=0,
                          matmul=per["matmul"], wmma=per.get("matmul_wmma", 0),
                          f32=per["matmul_f32"])
        if counts != want:
            raise AssertionError(f"{cfg.name} {mode}: prefill launched {counts}, "
                                 f"expected {want}")
        if logits.shape != (BATCH, cfg.vocab_size) or not torch.isfinite(logits).all():
            raise AssertionError(f"{cfg.name} {mode}: bad logits {tuple(logits.shape)}")
        for name, shp in _cache_shapes(cfg, batch).items():
            if tuple(pre[name].shape[1:]) != shp:
                raise AssertionError(f"{cfg.name}: cache {name} {tuple(pre[name].shape)}")
        if ref is None:
            ref = logits
        diff = (logits.float() - ref.float()).abs().max().item()
        if diff != 0:
            raise AssertionError(f"{cfg.name} {mode} prefill differs from xla: {diff}")
        prefill_s = _wall(do_prefill, repeats)
        mrow = {"prefill_ms_median": statistics.median(prefill_s) * 1e3,
                "prefill_ms_samples": [t * 1e3 for t in prefill_s],
                "launches_per_prefill": {k: v for k, v in counts.items() if v}}
        if mode == "mcast":
            _, _, decode = make_decode_step(run, mesh)
            out, gen_s, gen_counts = _run(lambda: greedy_generate(
                prefill, decode, params, tokens, new, s0 + new, inputs))
            want_gen = dict(want, **{k: want[k] + (new - 1) * dec.get(k, 0)
                                     for k in ("matmul", "matmul_wmma", "matmul_f32")})
            if gen_counts != want_gen:
                raise AssertionError(f"{cfg.name}: generation launched {gen_counts}, "
                                     f"expected {want_gen}")
            if (out.shape != (BATCH, p + new) or not torch.equal(out[:, :p], tokens)
                    or not torch.equal(out[:, p], logits.argmax(-1))):
                raise AssertionError(f"{cfg.name}: bad tokens {tuple(out.shape)}")
            decode_s = gen_s - statistics.median(prefill_s)
            dev, prof_ms = _device_times(do_prefill)
            busy = sum(dev.values())
            mrow.update({"decode_steps": new - 1, "decode_ms": decode_s * 1e3,
                         "decode_tok_s": BATCH * (new - 1) / decode_s,
                         "generation_ms": gen_s * 1e3,
                         "prefill_device_busy_ms": busy,
                         "prefill_profiled_wall_ms": prof_ms,
                         "prefill_device_idle_share": 1 - busy / prof_ms,
                         "prefill_ring_allgather_device_ms": sum(
                             t for k, t in dev.items() if "ring_allgather_kernel" in k),
                         "prefill_matmul_device_ms": sum(
                             t for k, t in dev.items() if "matmul_" in k),
                         "sample_tokens": out[0, p:].tolist()})
            top = sorted(dev.items(), key=lambda kv: -kv[1])[:6]
            print(f"[{tag}] {cfg.name} mcast prefill, top device time (ms): "
                  + json.dumps({k[:60]: t for k, t in top}), flush=True)
            del out
        row["modes"][mode] = mrow
        print(f"[{tag}] {cfg.name} {mode}: " + json.dumps(mrow), flush=True)
        del logits, pre
    row["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
    more = extras(cfg, params, batch, ref) if extras else {}
    row.update(more)
    print(f"[{tag}] {cfg.name}: prefill logits bitwise equal in every mode; peak device "
          f"memory {row['peak_memory_gib']:.3f} GiB; " + json.dumps(more), flush=True)
    return row


def _train_model(tag: str, cfg, mesh: StackedMesh, shape: ShapeConfig, per: dict,
                 timed: int, pieces=None, want=None) -> dict:
    """One architecture of phases 4g, 4h and 4i at full width, remat="full",
    AdamW, weights from ``bridge.device_params`` (their count ``_held``'s),
    batches of ``shape`` from the ``SyntheticPipeline``, on ``mesh``, in
    every mode: a warm-up, ``timed`` timed steps and a profiled step, each
    launching exactly ``per`` in the mcast modes (``_path_want``), or
    ``want(mode)`` where given; the first-step loss bitwise equal in every
    mode; then ``pieces(cfg)``, the row's device ms of plain-torch pieces.
    Returns the row."""
    torch.cuda.reset_peak_memory_stats()
    tree = bridge.device_params(cfg, mesh, MeshConfig(), seed=0, dtype=torch.bfloat16)
    n_params = _held(cfg, tree)
    pipe = SyntheticPipeline(cfg, shape)
    batches = [pipe.next_batch(i) for i in range(timed + 2)]
    print(f"[{tag}] {cfg.name} at {cfg.num_layers} layers ({n_params:,} weights) on "
          f"{mesh.n_ranks} ranks, batch {shape.global_batch} x {shape.seq_len}: a step "
          f"launches, derived from the code, {json.dumps(per)} (mcast modes)", flush=True)
    first, row = {}, {"arch": cfg.name, "ranks": mesh.n_ranks, "modes": {}}
    for mode in MODES:
        torch.cuda.reset_peak_memory_stats()
        mode_want = want(mode) if want else _path_want(
            mesh, mode, gathers=per["ring_allgather"],
            transposes=per["ring_allgather_transpose"], matmul=per["matmul"],
            wmma=per.get("matmul_wmma", 0), f32=per["matmul_f32"])
        mrow, _ = _train_steps(cfg, mesh, tree, batches, mode, timed, mode_want, shape)
        mrow["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
        print(f"[{tag}] {cfg.name} " + json.dumps(mrow), flush=True)
        first[mode] = mrow["losses"][0]
        row["modes"][mode] = mrow
    if len(set(first.values())) != 1:
        raise AssertionError(f"{cfg.name}: first-step losses differ between modes: {first}")
    more = ""
    if pieces:
        row["pieces"] = pieces(cfg)
        more = (f"; one layer's plain-torch pieces at {shape.global_batch} x {shape.seq_len} "
                f"(device ms, forward): {json.dumps(row['pieces'])}")
    print(f"[{tag}] {cfg.name}: first-step loss bitwise equal in every mode: "
          f"{first['xla']!r}{more}", flush=True)
    return row


def _subq_kind(cfg, kind: str) -> dict[str, int]:
    """``subq_launches`` of a prefill or a decode step (its products, no
    gather kernel)."""
    per = subq_launches(cfg, train=False)
    return dict(per, ring_allgather=0) if kind == "decode" else per


def subq_serve() -> dict[str, dict]:
    """Phase 3g: rwkv6-7b (32 layers) and recurrentgemma-9b (38) at full
    size through ``_serve_model``: BATCH x SUBQ_PROMPT tokens, launching
    ``subq_launches``, SUBQ_NEW new tokens, SUBQ_REPEATS timed prefills; the
    plain-torch pieces' device ms at the prefill's shapes. Returns each
    arch's row."""
    rows = {}
    for arch in SUBQ_ARCHS:
        cfg = _subq_cfg(arch)
        tokens = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (BATCH, SUBQ_PROMPT))).cuda()
        rows[arch] = _serve_model("subq-serve", cfg, {"tokens": tokens}, _subq_kind, SUBQ_NEW,
                                  SUBQ_REPEATS, lambda cfg, *_: {
                                      "pieces": _subq_pieces(cfg, BATCH, SUBQ_PROMPT)})
        torch.cuda.empty_cache()
    return rows


def subq_train() -> dict[str, dict]:
    """Phase 4g: rwkv6-7b at 2 layers on (data=8) and recurrentgemma-9b at 5
    (one group and 2 trailing rec layers) on (data=2, SUBQ_TRAIN_MESH),
    batch TRAIN_SHAPE (16 x 512), through ``_train_model``, each step
    launching ``subq_launches``; the plain-torch pieces' device ms at the
    batch's shapes."""
    rows = {}
    for arch in SUBQ_ARCHS:
        cfg = _subq_cfg(arch, train=True)
        rows[arch] = _train_model(
            "subq-train", cfg, SUBQ_TRAIN_MESH[arch], TRAIN_SHAPE,
            subq_launches(cfg, train=True), SUBQ_TRAIN_TIMED,
            lambda cfg: _subq_pieces(cfg, TRAIN_SHAPE.global_batch, TRAIN_SHAPE.seq_len))
        torch.cuda.empty_cache()
    return rows


# ------------------------- phases 3h and 4h: the last three architectures

FAM_ARCHS = ("phi-3-vision-4.2b", "whisper-base", "moonshot-v1-16b-a3b")
# tokens a prompt, batch BATCH: phi-3-vision's after its 1,024 patches,
# whisper's beside its FAM_FRAMES frames
FAM_PROMPT = {"phi-3-vision-4.2b": 128, "whisper-base": 512, "moonshot-v1-16b-a3b": 128}
FAM_FRAMES = 512
FAM_NEW = 8
FAM_REPEATS = 2                # timed prefills a mode; the median is reported
# moonshot-v1-16b-a3b is served at full width and 4 of its 48 layers, for
# the script's time (phase 3d serves the family's deepseek-moe-16b at 8)
FAM_SERVE_LAYERS = {"moonshot-v1-16b-a3b": 4}
# training depth: phi-3-vision and moonshot 2 layers, whisper-base whole
FAM_TRAIN_LAYERS = {"phi-3-vision-4.2b": 2, "moonshot-v1-16b-a3b": 2}
FAM_TRAIN_SHAPE = {"phi-3-vision-4.2b": ShapeConfig("train", "train", 1024 + 512, 8),
                   "whisper-base": TRAIN_SHAPE, "moonshot-v1-16b-a3b": TRAIN_SHAPE}
FAM_TRAIN_MESH = {arch: StackedMesh(data=8, model=1) for arch in FAM_ARCHS}
FAM_TRAIN_TIMED = 1
FAM_TP_MESH = StackedMesh(data=2, model=4)   # phi-3-vision's mcast prefill runs there too
FAM_SMALL_SEQ = 16                           # the reduced check's prompt tokens


def _fam_cfg(arch: str, *, train: bool = False):
    cfg = get_model_config(arch)
    layers = (FAM_TRAIN_LAYERS if train else FAM_SERVE_LAYERS).get(arch)
    return replace(cfg, num_layers=layers) if layers else cfg


def _fam_batch(cfg, tokens: int, frames: int, gen: torch.Generator, device: str) -> dict:
    """BATCH prompts of ``tokens`` tokens and the stub frontend's inputs
    beside them, N(0, 1) x 0.02 in the compute dtype: the ``vlm``'s
    ``n_patches`` patches, the ``encdec``'s ``frames`` frames."""
    dt = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
    out = {"tokens": torch.randint(0, cfg.vocab_size, (BATCH, tokens), generator=gen,
                                   device=gen.device).to(device)}
    shp = None
    if cfg.family == "vlm":
        shp = (BATCH, cfg.vision.n_patches, cfg.vision.patch_dim)
    elif cfg.family == "encdec":
        shp = (BATCH, frames, cfg.encdec.frame_dim)
    if shp:
        name = "patches" if cfg.family == "vlm" else "frames"
        out[name] = (torch.randn(shp, generator=gen, device=gen.device) * 0.02).to(device, dt)
    return out


def _encdec_products(cfg, *, decode: bool) -> list[tuple[int, int]]:
    """(fan-in, fan-out) of every product of the encdec's layers, the
    encoder's first: an encoder layer's q, k, v, o and gelu MLP (6 sharded
    leaves); a decoder layer's self-attention, cross-attention and MLP (10);
    in a decode step the decoder's only, without the cross-attention's k
    and v (frozen in the cache)."""
    d, f = cfg.d_model, cfg.d_ff
    q, kv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    attn, mlp, e = [(d, q), (d, kv), (d, kv), (q, d)], [(d, f), (f, d)], cfg.encdec
    if decode:
        return e.dec_layers * (attn + [(d, q), (q, d)] + mlp)
    return e.enc_layers * (attn + mlp) + e.dec_layers * (attn + attn + mlp)


def fam_launches(cfg, kind: str, seq: int = TRAIN_SHAPE.seq_len) -> dict[str, int]:
    """#1 gathers (mcast modes), #1b transposes and the matmul kernel's
    wgmma, wmma and f32 launches of one prefill, decode step or train step
    (``kind``; remat="full": every gather twice, the checkpointed body's
    recompute, and one transpose; every product four times: forward,
    recompute, dx, dW; the head four times a cross-entropy chunk of the
    ``seq`` positions) on (data=8, model=1). phi-3-vision: the dense
    layer's 7 sharded leaves and products, the head, and ``patch_proj``
    (replicated: no gather; in training its forward and dW, the patches
    needing no gradient). whisper-base: a gather and a product a leaf of
    ``_encdec_products``, a decode step the decoder's 8 a layer; the head at
    the odd vocab 51,865 on the wmma kernel (``head_wmma``). moonshot: the
    MoE counts of phase 3d (``_moe_sharded_leaves``, ``_moe_matmuls``)."""
    train, chunks = kind == "train", -(-seq // XENT_CHUNK)
    head = 4 * chunks if train else 1
    f32 = wmma = 0
    if cfg.family == "moe":
        leaves = _moe_sharded_leaves(cfg) * cfg.num_layers
        bf16, f32 = _moe_matmuls(cfg, train=train)
    elif cfg.family == "vlm":
        leaves = len(_layer_leaves(cfg)) * cfg.num_layers
        bf16 = (4 if train else 1) * leaves + head + {"prefill": 1, "decode": 0, "train": 2}[kind]
    else:
        leaves = len(_encdec_products(cfg, decode=False))
        body = len(_encdec_products(cfg, decode=kind == "decode"))
        wmma = head_wmma(cfg, train=train, seq=seq)
        bf16 = (4 if train else 1) * body + (0 if wmma else head)
    gathers = {"prefill": leaves, "decode": 0, "train": 2 * leaves}[kind]
    return {"ring_allgather": gathers, "ring_allgather_transpose": leaves if train else 0,
            "matmul": bf16, "matmul_wmma": wmma, "matmul_f32": f32}


def fam_tp_launches(cfg, mode: str) -> dict[str, int]:
    """A phi-3-vision prefill on FAM_TP_MESH: the dense stack's
    (``tp_launches``), but the token embedding made whole (where the
    vocabulary splits over ``model``, its shards' sums all-reduced: one #1b
    and one #1, in place of the reduce-scatter to the sequence chunks)
    before the patches join it, and ``patch_proj``'s product."""
    n = tp_launches(cfg, FAM_TP_MESH, mode, "prefill")
    vocab = cfg.vocab_size % FAM_TP_MESH.tp == 0
    return dict(n, ring_allgather=n["ring_allgather"] + int(vocab), matmul=n["matmul"] + 1)


def fam_matmul_cases(cfg, r: int, m: int, kind: str, *, head_m: int, chunks: int = 1,
                     patch_m: int = 0, dtype=torch.bfloat16) -> dict:
    """Every matmul shape of phases 3h and 4h and their launches, {(batch,
    m, k, n, a_t, b_t, dtype): launches}, as ``matmul_cases``: ``m`` rows a
    rank through each layer product (whisper's frames and tokens of one
    length), ``head_m`` through the head in each of ``chunks`` chunks,
    ``patch_m`` patches through ``patch_proj``; moonshot's the MoE cases at
    the capacity of its ``r * m`` tokens (a decode step's: as many as the
    tokens). Their launches add up to ``fam_launches``'."""
    train = kind == "train"
    if cfg.family == "moe":
        cap = r * m if kind == "decode" else moe_capacity(cfg, r * m)
        return moe_matmul_cases(cfg, r, m, cap, dtype, train=train, head_m=head_m)
    cases: dict = {}

    def add(key, count):
        cases[key] = cases.get(key, 0) + count

    if cfg.family == "vlm":
        prods = [(cfg.num_layers, k, n) for k, n in _layer_leaves(cfg).values()]
    else:
        prods = [(1, k, n) for k, n in _encdec_products(cfg, decode=kind == "decode")]
    for layers, k, n in prods:
        add((r, m, k, n, False, False, dtype), layers * (2 if train else 1))
        if train:
            add((r, m, n, k, False, True, dtype), layers)     # dY W^T
            add((r, k, m, n, True, False, dtype), layers)     # X^T dY
    d, v = cfg.d_model, cfg.vocab_size
    add((r, head_m, d, v, False, False, dtype), chunks * (2 if train else 1))
    if train:
        add((r, head_m, v, d, False, True, dtype), chunks)
        add((r, d, head_m, v, True, False, dtype), chunks)
    if patch_m:
        pd = cfg.vision.patch_dim
        add((r, patch_m, pd, d, False, False, dtype), 1)
        if train:
            add((r, pd, patch_m, d, True, False, dtype), 1)
    return cases


def fam_path_cases() -> dict:
    """Phase 1's matmul shapes of phases 3h and 4h: each config's prefill
    (one prompt a rank), decode step and train step at full width, and the
    reduced f32 check's prefill and decode steps on 8 ranks."""
    cases: dict = {}

    def add(more: dict) -> None:
        for case, n in more.items():
            cases[case] = cases.get(case, 0) + n

    b = BATCH // 8
    for arch in FAM_ARCHS:
        cfg, tcfg = _fam_cfg(arch), _fam_cfg(arch, train=True)
        shape, r = FAM_TRAIN_SHAPE[arch], FAM_TRAIN_MESH[arch].n_ranks
        np_ = cfg.vision.n_patches if cfg.family == "vlm" else 0
        tb = shape.global_batch // r
        add(fam_matmul_cases(cfg, 8, b * (np_ + FAM_PROMPT[arch]), "prefill", head_m=b,
                             patch_m=b * np_))
        add(fam_matmul_cases(cfg, 8, b, "decode", head_m=b))
        add(fam_matmul_cases(tcfg, r, tb * shape.seq_len, "train",
                             head_m=tb * min(XENT_CHUNK, shape.seq_len),
                             chunks=-(-shape.seq_len // XENT_CHUNK), patch_m=tb * np_))
        if cfg.family != "moe":
            small = reduced(get_model_config(arch))
            snp = small.vision.n_patches if small.family == "vlm" else 0
            add(fam_matmul_cases(small, 8, b * (snp + FAM_SMALL_SEQ), "prefill", head_m=b,
                                 patch_m=b * snp, dtype=torch.float32))
            add(fam_matmul_cases(small, 8, b, "decode", head_m=b, dtype=torch.float32))
    return cases


def check_fam_small_reference() -> float:
    """Phase 3h: reduced phi-3-vision-4.2b (8 patches of 32) and whisper-base
    (2 + 2 layers) in f32 on (data=8), and the reduced phi-3-vision on
    FAM_TP_MESH (tensor- and sequence-parallel, the token embedding made
    whole before the patches join it), on the card against the same runs on
    the host's CPU (the path the CPU tests hold against the JAX package):
    prefill logits within 1e-4 in every mode and greedy generation of
    FAM_NEW tokens with the same tokens. The reduced moonshot is the reduced
    deepseek-moe-16b but for its name (phase 3d's check). Returns the
    largest logit difference."""
    worst = 0.0
    cases = [(arch, StackedMesh(data=8, model=1)) for arch in FAM_ARCHS[:2]]
    for arch, mesh in cases + [(FAM_ARCHS[0], FAM_TP_MESH)]:
        cfg = reduced(get_model_config(arch))
        tree = bridge.random_params(cfg, seed=2)
        host = _fam_batch(cfg, FAM_SMALL_SEQ, FAM_SMALL_SEQ, torch.Generator().manual_seed(3),
                          "cpu")
        s0 = transformer.stream_len(cfg, host)
        out = {}
        for dev in ("cpu", "cuda"):
            params = bridge.to_torch(tree, mesh, MeshConfig(), dtype=torch.float32, device=dev)
            batch = {k: v.to(dev) for k, v in host.items()}
            inputs = {k: v for k, v in batch.items() if k != "tokens"}
            for mode in MODES:
                run = RunConfig(model=cfg, shape=ShapeConfig("p", "prefill", s0, BATCH),
                                collective=CollectiveConfig(fsdp_mode=mode, n_chains=N_CHAINS))
                _, _, prefill = make_prefill_step(run, mesh, device=dev)
                _, _, decode = make_decode_step(run, mesh, device=dev)
                logits, _ = prefill(params, batch)
                toks = greedy_generate(prefill, decode, params, batch["tokens"], FAM_NEW,
                                       s0 + FAM_NEW, inputs)
                out[dev, mode] = (logits.cpu(), toks.cpu())
        for mode in MODES:
            (lc, tc), (lg, tg) = out["cpu", mode], out["cuda", mode]
            diff = (lc - lg).abs().max().item()
            worst = max(worst, diff)
            if not (diff <= 1e-4 and torch.equal(tc, tg)):
                raise AssertionError(f"reduced {arch} on {mesh} {mode}: card vs CPU logits max "
                                     f"diff {diff}, tokens equal {torch.equal(tc, tg)}")
    return worst


def _fam_tp_prefill(cfg, params, batch, ref_logits) -> dict:
    """phi-3-vision's mcast prefill on FAM_TP_MESH, the weights moved there
    (``_remesh``; the (8, 1) tree emptied): its launches ``fam_tp_launches``
    with their ring entries, the sequence (1,152 positions) split over
    ``model``; its logits against (8, 1)'s (no limit: bf16 sums in another
    order)."""
    tp_params = _remesh(params, FAM_TP_MESH)
    s0 = transformer.stream_len(cfg, batch)
    run = RunConfig(model=cfg, shape=ShapeConfig("serve", "prefill", s0, BATCH),
                    collective=CollectiveConfig(fsdp_mode="mcast", n_chains=N_CHAINS))
    _, _, prefill = make_prefill_step(run, FAM_TP_MESH)

    def do_prefill():
        return prefill(tp_params, batch)

    (logits, _), _, counts = _run(do_prefill)
    want = _want_tp(cfg, FAM_TP_MESH, "mcast")
    extra = fam_tp_launches(cfg, "mcast")["ring_allgather"] - want["ring_allgather"]
    want.update(ring_allgather=want["ring_allgather"] + extra, matmul=want["matmul"] + 1,
                entries_ring=want["entries_ring"] + extra * (FAM_TP_MESH.tp - 1))
    if counts != want:
        raise AssertionError(f"{cfg.name} on {FAM_TP_MESH}: prefill launched {counts}, "
                             f"expected {want}")
    if logits.shape != (BATCH, cfg.vocab_size) or not torch.isfinite(logits).all():
        raise AssertionError(f"{cfg.name} on {FAM_TP_MESH}: bad logits")
    prefill_s = _wall(do_prefill, FAM_REPEATS)
    dev, prof_ms = _device_times(do_prefill)
    busy = sum(dev.values())
    row = {"mesh": "(data=2, model=4)", "prefill_ms_median": statistics.median(prefill_s) * 1e3,
           "prefill_ms_samples": [t * 1e3 for t in prefill_s],
           "launches_per_prefill": {k: v for k, v in counts.items() if v},
           "prefill_device_busy_ms": busy, "prefill_device_idle_share": 1 - busy / prof_ms,
           "max_abs_logit_diff_vs_8x1": (logits.float() - ref_logits.float()).abs().max().item(),
           "argmax_equal_share": (logits.argmax(-1) == ref_logits.argmax(-1)).float().mean().item()}
    del tp_params
    return row


def _fam_attention_ms(cfg, s: int) -> float | None:
    """Device ms of one layer's causal ``blockwise_attention`` at (BATCH, s)
    in bf16, from the profiler (``_busy_ms``): the plain-torch piece of a
    prefill (its scores in f32, as the reference's)."""
    from repro_torch.models import attention
    gen = torch.Generator(device="cuda").manual_seed(12)
    q = torch.randn((BATCH, s, cfg.num_heads, cfg.head_dim), generator=gen,
                    device="cuda").bfloat16()
    k = torch.randn((BATCH, s, cfg.num_kv_heads, cfg.head_dim), generator=gen,
                    device="cuda").bfloat16()
    return _busy_ms(lambda: attention.blockwise_attention(
        q, k, k, causal=True, q_block=cfg.attn_q_block, kv_block=cfg.attn_kv_block))


def _fam_extras(cfg, params, batch, ref_logits) -> dict:
    """Phase 3h's entries of a row beside ``_serve_model``'s: one layer's
    causal attention at the prefill's length timed apart; for phi-3-vision,
    its mcast prefill on FAM_TP_MESH (``_fam_tp_prefill``, which empties the
    (8, 1) tree)."""
    out = {"attention_layer_ms": _fam_attention_ms(cfg, transformer.stream_len(cfg, batch))}
    if cfg.family == "vlm":
        out["tp"] = _fam_tp_prefill(cfg, params, batch, ref_logits)
    return out


def fam_serve() -> dict[str, dict]:
    """Phase 3h: phi-3-vision-4.2b (32 layers, d_model 3,072, 1,024 patches
    of 1,024, vocab 32,064) and whisper-base (6 + 6 layers, d_model 512,
    vocab 51,865) as registered and moonshot-v1-16b-a3b at full width and
    FAM_SERVE_LAYERS' depth, through ``_serve_model``: BATCH prompts
    (phi-3-vision 1,024 patches + 128 tokens, whisper FAM_FRAMES frames +
    512 tokens, moonshot 128 tokens), launching ``fam_launches``, FAM_NEW
    new tokens, FAM_REPEATS timed prefills; then ``_fam_extras``. Returns
    each arch's row."""
    rows = {}
    for arch in FAM_ARCHS:
        cfg = _fam_cfg(arch)
        batch = _fam_batch(cfg, FAM_PROMPT[arch], FAM_FRAMES,
                           torch.Generator(device="cuda").manual_seed(0), "cuda")
        rows[arch] = _serve_model("fam-serve", cfg, batch, fam_launches, FAM_NEW, FAM_REPEATS,
                                  _fam_extras)
        torch.cuda.empty_cache()
    return rows


def fam_train() -> dict[str, dict]:
    """Phase 4h: phi-3-vision-4.2b at 2 layers (batch 8 x (1,024 patches +
    512 tokens)), whisper-base whole and moonshot-v1-16b-a3b at 2 layers
    (16 x 512), full width, on FAM_TRAIN_MESH, through ``_train_model``,
    every step launching ``fam_launches``."""
    rows = {}
    for arch in FAM_ARCHS:
        cfg, shape = _fam_cfg(arch, train=True), FAM_TRAIN_SHAPE[arch]
        rows[arch] = _train_model("fam-train", cfg, FAM_TRAIN_MESH[arch], shape,
                                  fam_launches(cfg, "train", shape.seq_len), FAM_TRAIN_TIMED)
        torch.cuda.empty_cache()
    return rows


# ------- phases 3i and 4i: the model axis for the MoE, rwkv, hybrid, encdec

TPF_ARCHS = ("deepseek-moe-16b", "rwkv6-7b", "recurrentgemma-9b", "whisper-base")
TPF_MESH = StackedMesh(data=2, model=4)
TPF_BASE = StackedMesh(data=8, model=1)   # the yardstick: the same weights and batch
# served depth, for the script's time: deepseek-moe-16b 4 of 28 layers,
# rwkv6-7b 4 of 32, recurrentgemma-9b its 5-layer cut (a group and 2
# trailing rec layers: every layer kind, as 4g); whisper-base whole
TPF_SERVE_LAYERS = {"deepseek-moe-16b": 4, "rwkv6-7b": 4, "recurrentgemma-9b": 5}
TPF_TRAIN_LAYERS = {"deepseek-moe-16b": 2, "rwkv6-7b": 2, "recurrentgemma-9b": 5}
# training batch: TRAIN_SHAPE (16 x 512) but recurrentgemma-9b's 8 x 512: on
# (2, 4) its mcast step at 16 x 512 asked for 7.81 GiB more with 72 GiB in
# use (the tied 256,000-row head's vocabulary shards, their gradients and
# the cross-entropy's f32 tensors, as on 4 ranks in 4g)
TPF_TRAIN_SHAPE = {"recurrentgemma-9b": ShapeConfig("train", "train", 512, 8)}
TPF_PROMPT = {"whisper-base": 512}   # tokens a prompt, batch BATCH; 128 for the others
TPF_FRAMES = 512                     # whisper's frames beside its prompt
TPF_NEW = 8
TPF_REPEATS = 2                      # timed prefills a mode; the median is reported
TPF_TRAIN_TIMED = 1
TPF_SMALL_SEQ = 16                   # the reduced check's prompt tokens (and frames)


def _tpf_cfg(arch: str, *, train: bool = False):
    cfg = get_model_config(arch)
    layers = (TPF_TRAIN_LAYERS if train else TPF_SERVE_LAYERS).get(arch)
    return replace(cfg, num_layers=layers) if layers else cfg


def _head_plan(cfg, t: int) -> tuple[bool, bool, int, int]:
    """(q heads split over ``model``, kv heads split, attention weights
    gathered over it off whole heads: of wq and wo, of wk and wv), as
    ``layers.head_plan`` and the rules place them at t tp ranks."""
    qs = cfg.num_heads % t == 0
    ks = qs and cfg.num_kv_heads % t == 0
    q, kv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    return qs, ks, 0 if qs else 2 * int(q % t == 0), 0 if ks else 2 * int(kv % t == 0)


def _split(n: int, t: int) -> int:
    """A dim of n over t tp ranks: n / t where it divides (the rules split
    it), else n."""
    return n // t if n % t == 0 else n


def tpf_layers(cfg, t: int) -> list[dict]:
    """Each layer kind of an MoE, rwkv, hybrid or encdec config on a
    physical ``model`` axis of t ranks, as the model code runs it: ``n``
    layers of the kind, ``dp`` dp-sharded leaves a layer (a #1 each in the
    mcast modes), the ``model`` collectives of a forward pass with the
    stream sequence-parallel (``ag`` gathers, #1; ``rs`` reduce-scatters,
    #1b) and of a decode step (``dag``, ``drs``), and the products a rank
    makes, (k, n, copies, f32), of a forward pass (``prods``; the MoE's
    three expert products ``experts``, batched over the E experts) and of
    a decode step (``dprods``). A forward pass gathers the normed stream's
    sequence before each sub-block and reduce-scatters each row-parallel
    output; decode all-reduces it (#1b then #1). Attention gathers q's (and
    split kv's) heads in decode, and its weights off whole heads always.
    rwkv: the time mix's heads split (else its five matrices gathered); the
    channel mix's value reduce-scattered on d_model and the product
    gathered back. Hybrid rec layers gather the post-conv width for the
    f32 gates. The encdec's decoder has a second attention (cross: its q
    and o alone in decode, the frames' k and v frozen in the cache)."""
    d, f = cfg.d_model, cfg.d_ff
    qs, ks, off_q, off_kv = _head_plan(cfg, t)
    off = off_q + off_kv
    q, kv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    q, kv = q // t if qs else q, kv // t if ks else kv
    mlp, fl = int(f % t == 0), _split(f, t)
    attn = [(d, q, 1, False), (d, kv, 1, False), (d, kv, 1, False), (q, d, 1, False)]
    attn_dec = (2 * qs + 2 * ks + off, qs)          # q, k, v heads; off-head weights; all-reduce
    if cfg.family == "moe":
        m = cfg.moe
        fs = m.d_ff_expert * m.n_shared_experts
        shp = int(bool(fs) and fs % t == 0)
        shared = ([(d, _split(fs, t), 1, False)] * 2 + [(_split(fs, t), d, 1, False)]
                  if fs else [])
        prods = attn + [(d, m.n_routed_experts, 1, True)] + shared
        return [{"n": cfg.num_layers, "dp": _moe_sharded_leaves(cfg), "ag": 2 + off,
                 "rs": int(qs) + shp, "dag": attn_dec[0] + shp, "drs": attn_dec[1] + shp,
                 "prods": prods, "dprods": prods,
                 "experts": [(d, m.d_ff_expert), (d, m.d_ff_expert), (m.d_ff_expert, d)]}]
    if cfg.family == "rwkv":
        ts, dl = cfg.rwkv.tokenshift_lora, cfg.rwkv.decay_lora
        hs = cfg.num_heads % t == 0
        off5 = 0 if hs else 5 * int(d % t == 0)
        dh = d // t if hs else d
        r_split = int(d % t == 0)
        cm_ag = int(mlp and not r_split) + r_split        # the value all-reduced; the product
        prods = ([(d, 5 * ts, 1, False), (ts, d, 5, False)] + [(d, dh, 1, False)] * 4
                 + [(d, dl, 1, False), (dl, d, 1, False), (dh, d, 1, False),
                    (d, fl, 1, False), (fl, d, 1, False), (d, _split(d, t), 1, False)])
        return [{"n": cfg.num_layers, "dp": 12, "ag": 2 + off5 + cm_ag, "rs": int(hs) + mlp,
                 "dag": off5 + int(hs) + cm_ag, "drs": int(hs) + mlp,
                 "prods": prods, "dprods": prods}]
    swiglu = [(d, fl, 1, False), (d, fl, 1, False), (fl, d, 1, False)]
    if cfg.family == "hybrid":
        ng, nt = transformer.hybrid_layout(cfg)
        w = cfg.rglru.lru_width
        ws, wl = int(w % t == 0), _split(w, t)
        rec = [(d, wl, 1, False), (d, wl, 1, False), (w, wl, 1, True), (w, wl, 1, True),
               (wl, d, 1, False)] + swiglu
        attn_l = attn + swiglu
        return [{"n": 2 * ng + nt, "dp": 8, "ag": 2 + ws, "rs": ws + mlp,
                 "dag": 2 * ws + mlp, "drs": ws + mlp, "prods": rec, "dprods": rec},
                {"n": ng, "dp": 7, "ag": 2 + off, "rs": int(qs) + mlp,
                 "dag": attn_dec[0] + mlp, "drs": attn_dec[1] + mlp,
                 "prods": attn_l, "dprods": attn_l}]
    gelu = [(d, fl, 1, False), (fl, d, 1, False)]
    e = cfg.encdec
    return [{"n": e.enc_layers, "dp": 6, "ag": 2 + off, "rs": int(qs) + mlp, "dag": 0,
             "drs": 0, "prods": attn + gelu, "dprods": []},
            {"n": e.dec_layers, "dp": 10, "ag": 3 + 2 * off, "rs": 2 * int(qs) + mlp,
             "dag": attn_dec[0] + off_q + 2 * qs + mlp, "drs": 2 * attn_dec[1] + mlp,
             "prods": attn + attn + gelu, "dprods": attn + [attn[0], attn[3]] + gelu}]


def _unrecomputed(cfg, t: int) -> int:
    """The reduce-scatters a train step's recompute does not run again:
    torch's checkpoint stops a body's recompute after its last op that
    keeps a tensor for the backward, so a body that ends with its MLP's
    reduce-scatter (a hybrid group or trailing rec layer, an encdec layer;
    d_ff split over ``model``) runs it once. An MoE body ends with the
    router's metrics, an rwkv one with the chunk of its sequence (an index
    kept): both run again whole."""
    mlp = int(cfg.d_ff % t == 0)
    if cfg.family == "hybrid":
        return sum(transformer.hybrid_layout(cfg)) * mlp
    if cfg.family == "encdec":
        return (cfg.encdec.enc_layers + cfg.encdec.dec_layers) * mlp
    return 0


def tpf_launches(cfg, mesh: StackedMesh, mode: str, kind: str,
                 seq: int = TRAIN_SHAPE.seq_len) -> dict[str, int]:
    """#1 (``ring_allgather``), #1b (``ring_allgather_transpose``) and #3
    (wgmma ``matmul``, ``matmul_wmma``, ``matmul_f32``) launches of one
    prefill, decode step or train step (``kind``; remat="full") of an MoE,
    rwkv, hybrid or encdec config on a mesh with a physical ``model`` axis,
    the prompt (and the encdec's frames) of a length that splits over it,
    from ``tpf_layers``: a layer's dp gathers (mcast modes, not in decode),
    its ``model`` collectives and products; a train step runs each
    checkpointed layer's gathers, collectives and products twice (the
    recompute; but ``_unrecomputed``), then each gather's transpose (#1b) and
    each reduce-scatter's transpose (#1), and every product's two backward
    products. Outside the
    layers: the embedding's sum over its vocabulary shards where the
    vocabulary splits (a reduce-scatter to the sequence chunks; the
    encdec's decoder takes it whole, an all-reduce; decode all-reduces),
    the final sequence gather (the encdec's encoder output too), the
    logits' vocabulary gather in serving, and the head: one product a
    prefill or decode step, four a cross-entropy chunk of ``seq`` positions
    in training, on the wmma kernel at an odd vocabulary (``head_wmma``)."""
    t = mesh.tp
    mc = int(mode != "xla")
    vs = int(cfg.vocab_size % t == 0)
    enc = int(cfg.family == "encdec")
    rows = tpf_layers(cfg, t)

    def products(key: str, f32: bool) -> int:   # a pass's, the experts' among the bf16
        return sum(r["n"] * (sum(1 for *_, x in r[key] if x == f32)
                             + (0 if f32 else len(r.get("experts", []))))
                   for r in rows)

    wmma = head_wmma(cfg, train=kind == "train", seq=seq)
    if kind == "decode":
        ag = sum(r["n"] * r["dag"] for r in rows) + 2 * vs
        rs = sum(r["n"] * r["drs"] for r in rows) + vs
        bf16, f32, head = products("dprods", False), products("dprods", True), 1
    elif kind == "prefill":
        ag = sum(r["n"] * (mc * r["dp"] + r["ag"]) for r in rows) + 1 + vs + enc * (1 + vs)
        rs = sum(r["n"] * r["rs"] for r in rows) + vs
        bf16, f32, head = products("prods", False), products("prods", True), 1
    else:
        fwd_ag = sum(r["n"] * (mc * r["dp"] + r["ag"]) for r in rows)
        fwd_rs = sum(r["n"] * r["rs"] for r in rows)
        outside = (1 + vs) * (1 + enc)   # the outside collectives and their transposes
        ag = 2 * fwd_ag + fwd_rs + outside
        rs = 2 * fwd_rs + fwd_ag + outside - _unrecomputed(cfg, t)
        bf16, f32 = 4 * products("prods", False), 4 * products("prods", True)
        head = 4 * -(-seq // XENT_CHUNK)
    return {"ring_allgather": ag, "ring_allgather_transpose": rs,
            "matmul": bf16 + (0 if wmma else head), "matmul_wmma": wmma, "matmul_f32": f32}


def tpf_matmul_cases(cfg, mesh: StackedMesh, m: int, kind: str, *, head_m: int,
                     chunks: int = 1, cap: int = 0, dtype=torch.bfloat16) -> dict:
    """Every matmul shape of phases 3i and 4i and its launches, {(batch, m,
    k, n, a_t, b_t, dtype): launches}, as ``matmul_cases``: ``m`` rows a rank
    through each layer product of ``tpf_layers`` (the encdec's frames and
    tokens of one length; rwkv's five token-shift mixes one product of
    batch 5 R), the MoE's experts at ``cap`` rows each (batch E), ``head_m``
    rows through the head in each of ``chunks`` chunks, its vocabulary split
    where it divides. Their launches add up to ``tpf_launches``'."""
    t, r = mesh.tp, mesh.n_ranks
    train = kind == "train"
    cases: dict = {}

    def prod(batch: int, rows: int, k: int, n: int, dt, count: int) -> None:
        for key, c in (((batch, rows, k, n, False, False, dt), count * (2 if train else 1)),
                       ((batch, rows, n, k, False, True, dt), count if train else 0),
                       ((batch, k, rows, n, True, False, dt), count if train else 0)):
            if c:
                cases[key] = cases.get(key, 0) + c

    for row in tpf_layers(cfg, t):
        for k, n, copies, f32 in row["dprods" if kind == "decode" else "prods"]:
            prod(r * copies, m, k, n, torch.float32 if f32 else dtype, row["n"])
        for k, n in row.get("experts", []):
            prod(cfg.moe.n_routed_experts, cap, k, n, dtype, row["n"])
    prod(r, head_m, cfg.d_model, _split(cfg.vocab_size, t), dtype, chunks)
    return cases


def _tpf_batch(cfg, tokens: int, gen: torch.Generator, device: str) -> dict:
    """BATCH prompts of ``tokens`` tokens; whisper's as many frames beside
    them (``_fam_batch``)."""
    return _fam_batch(cfg, tokens, tokens, gen, device)


def tpf_path_cases() -> dict:
    """Phase 1's matmul shapes of phases 3i and 4i: each config's prefill,
    decode step and train step on TPF_MESH at full width, and the reduced
    f32 check's prefill and decode steps there."""
    cases: dict = {}

    def add(more: dict) -> None:
        for case, n in more.items():
            cases[case] = cases.get(case, 0) + n

    dp = TPF_MESH.shape["data"]
    b = BATCH // dp
    for arch in TPF_ARCHS:
        cfg, tcfg = _tpf_cfg(arch), _tpf_cfg(arch, train=True)
        s = TPF_PROMPT.get(arch, PROMPT)
        shape = TPF_TRAIN_SHAPE.get(arch, TRAIN_SHAPE)
        tb, ts = shape.global_batch // dp, shape.seq_len
        moe = cfg.family == "moe"
        add(tpf_matmul_cases(cfg, TPF_MESH, b * s, "prefill", head_m=b,
                             cap=moe_capacity(cfg, BATCH * s) if moe else 0))
        add(tpf_matmul_cases(cfg, TPF_MESH, b, "decode", head_m=b, cap=BATCH))
        add(tpf_matmul_cases(tcfg, TPF_MESH, tb * ts, "train",
                             head_m=tb * min(XENT_CHUNK, ts), chunks=-(-ts // XENT_CHUNK),
                             cap=moe_capacity(tcfg, shape.global_batch * ts) if moe else 0))
        small = _tpf_small_cfg(arch)
        add(tpf_matmul_cases(small, TPF_MESH, b * TPF_SMALL_SEQ, "prefill", head_m=b,
                             cap=moe_capacity(small, BATCH * TPF_SMALL_SEQ) if moe else 0,
                             dtype=torch.float32))
        add(tpf_matmul_cases(small, TPF_MESH, b, "decode", head_m=b, cap=BATCH,
                             dtype=torch.float32))
    return cases


def _tpf_small_cfg(arch: str):
    return reduced(get_model_config(arch), layers=5 if arch == "recurrentgemma-9b" else None)


def _tpf_want(cfg, mesh: StackedMesh, mode: str, kind: str, *, steps: int = 0,
              seq: int = TRAIN_SHAPE.seq_len) -> dict[str, int]:
    """Every count of ``_counts`` for one ``kind`` call (and, after a
    prefill, ``steps`` decode steps) on a mesh with a physical model axis
    (``tpf_launches``), with the schedule entries: (dp - 1) of the mode's
    kind a dp gather and a dp transpose (rounds of broadcasts at dp >
    N_CHAINS), (tp - 1) ring entries a ``model`` gather and a ``model``
    reduce-scatter."""
    n = tpf_launches(cfg, mesh, mode, kind, seq)
    if steps:
        dec = tpf_launches(cfg, mesh, mode, "decode", seq)
        n = {k: n[k] + steps * dec[k] for k in n}
    dp, tp = mesh.shape["data"], mesh.tp
    leaves = sum(r["n"] * r["dp"] for r in tpf_layers(cfg, tp)) if mode != "xla" else 0
    dp_gathers = {"prefill": leaves, "decode": 0, "train": 2 * leaves}[kind]
    dp_transposes = leaves if kind == "train" else 0
    entries = {f"entries_{k}": 0 for k in K.entries}
    transposes = {f"transpose_entries_{k}": 0 for k in K.transpose_entries}
    if mode != "xla":
        rounds = dp // min(N_CHAINS, dp) if mode == "mcast_bcast" else 1
        kind_ = ("bcast" if rounds > 1 else "ring") if mode == "mcast_bcast" else ENTRY_KIND[mode]
        entries[f"entries_{kind_}"] += dp_gathers * rounds * (dp - 1)
        transposes[f"transpose_entries_{kind_}"] += dp_transposes * rounds * (dp - 1)
    entries["entries_ring"] += (n["ring_allgather"] - dp_gathers) * (tp - 1)
    transposes["transpose_entries_ring"] += (n["ring_allgather_transpose"]
                                             - dp_transposes) * (tp - 1)
    return {**{k: 0 for k in PACKET_KERNELS + LAYER_KERNELS + ("ring_step",)}, **n, **entries,
            **transposes}


def check_tpf_small_reference() -> float:
    """Phase 3i: reduced deepseek-moe-16b, rwkv6-7b, recurrentgemma-9b (5
    layers, window 32) and whisper-base in f32 on TPF_MESH on the card
    against the same runs on the host's CPU (the path the CPU tests hold
    against the JAX package): prefill logits within 1e-4 in every mode, and
    greedy generation of TPF_NEW tokens (mcast) with the same tokens.
    Returns the largest logit difference."""
    worst = 0.0
    for arch in TPF_ARCHS:
        cfg = _tpf_small_cfg(arch)
        tree = bridge.random_params(cfg, seed=2)
        host = _tpf_batch(cfg, TPF_SMALL_SEQ, torch.Generator().manual_seed(3), "cpu")
        out = {}
        for dev in ("cpu", "cuda"):
            params = bridge.to_torch(tree, TPF_MESH, MeshConfig(), dtype=torch.float32,
                                     device=dev)
            batch = {k: v.to(dev) for k, v in host.items()}
            inputs = {k: v for k, v in batch.items() if k != "tokens"}
            for mode in MODES:
                run = RunConfig(model=cfg, shape=ShapeConfig("p", "prefill", TPF_SMALL_SEQ,
                                                             BATCH),
                                collective=CollectiveConfig(fsdp_mode=mode, n_chains=N_CHAINS))
                _, _, prefill = make_prefill_step(run, TPF_MESH, device=dev)
                logits, _ = prefill(params, batch)
                toks = None
                if mode == "mcast":
                    _, _, decode = make_decode_step(run, TPF_MESH, device=dev)
                    toks = greedy_generate(prefill, decode, params, batch["tokens"], TPF_NEW,
                                           TPF_SMALL_SEQ + TPF_NEW, inputs).cpu()
                out[dev, mode] = (logits.cpu(), toks)
        for mode in MODES:
            (lc, tc), (lg, tg) = out["cpu", mode], out["cuda", mode]
            diff = (lc - lg).abs().max().item()
            worst = max(worst, diff)
            same = tc is None or torch.equal(tc, tg)
            if not (diff <= 1e-4 and same):
                raise AssertionError(f"reduced {arch} on {TPF_MESH} {mode}: card vs CPU logits "
                                     f"max diff {diff}, tokens equal {same}")
    return worst


def _expert_leaf(params, mesh: StackedMesh) -> dict:
    """Layer 0's ``w_gate`` gathered over dp in mcast as a prefill gathers
    it (one #1): the bytes its output holds, over the R ranks' copies
    (E / tp experts a copy on a model axis); on TPF_MESH its device ms, the
    bound (the shards read once, the copies written once, at the HBM
    rate), and the device ms of #1's plain version and of the library call
    (``plain_allgather_local``, one tensor op) on the shards and schedule
    that the gather hands the kernel."""
    from repro_torch.sharding.fsdp import gather_leaf
    leaf = params["blocks"]["moe"]["w_gate"]
    x, spec = leaf.local[:, 0], leaf.spec[1:]

    def gather():
        return gather_leaf(x, spec, mesh, ("data",), "bidi", N_CHAINS)

    out = gather()
    row = {"mesh": repr(mesh), "copy_shape": list(out.shape[1:]),
           "gathered_bytes": out.numel() * out.element_size(),
           "shard_bytes": x.numel() * x.element_size()}
    if mesh.tp > 1:
        seen, saved = [], C.ring_allgather
        C.ring_allgather = lambda y, sched, o=None: seen.append((y, sched)) or saved(y, sched, o)
        try:
            gather()
        finally:
            C.ring_allgather = saved
        (y, sched), = seen
        row.update(gather_device_ms=_device_ms(gather, 5),
                   bound_ms=(row["gathered_bytes"] + row["shard_bytes"])
                   / HBM_BYTES_PER_S * 1e3,
                   kernel_shards=list(y.shape), schedule_entries=len(sched),
                   plain_device_ms=_device_ms(lambda: K.ring_allgather_plain(y, sched), 5),
                   library_device_ms=_device_ms(lambda: C.plain_allgather_local(y), 5))
    del out
    return row


def _tpf_serve_one(arch: str) -> dict:
    """One architecture of phase 3i: drawn on TPF_BASE by
    ``bridge.device_params`` (bf16), its mcast prefill and greedy
    generation there the yardstick; then moved to TPF_MESH (``_remesh``):
    a prefill in every mode launching ``_tpf_want`` (logits bitwise xla's),
    greedy generation of TPF_NEW tokens (mcast) launching the prefill's and
    TPF_NEW - 1 decode steps', TPF_REPEATS timed prefills a mode, the mcast
    prefill profiled, decode tok/s, peak memory; the logits and tokens
    against the yardstick (no limit: bf16 sums in another order). For the
    MoE, the bytes #1 writes at an expert leaf on both meshes."""
    cfg = _tpf_cfg(arch)
    s = TPF_PROMPT.get(arch, PROMPT)
    batch = _tpf_batch(cfg, s, torch.Generator(device="cuda").manual_seed(0), "cuda")
    tokens = batch["tokens"]
    inputs = {k: v for k, v in batch.items() if k != "tokens"}
    torch.cuda.reset_peak_memory_stats()
    params = bridge.device_params(cfg, TPF_BASE, MeshConfig(), seed=0, dtype=torch.bfloat16)
    run = RunConfig(model=cfg, shape=ShapeConfig("serve", "prefill", s, BATCH),
                    collective=CollectiveConfig(fsdp_mode="mcast", n_chains=N_CHAINS))
    _, _, prefill = make_prefill_step(run, TPF_BASE)
    _, _, decode = make_decode_step(run, TPF_BASE)
    base_logits, _ = prefill(params, batch)
    base_out = greedy_generate(prefill, decode, params, tokens, TPF_NEW, s + TPF_NEW, inputs)
    row = {"arch": cfg.name, "layers": cfg.num_layers, "mesh": repr(TPF_MESH), "prompt": s,
           "modes": {}}
    if cfg.family == "moe":
        row["expert_leaf"] = [_expert_leaf(params, TPF_BASE)]
    params = _remesh(params, TPF_MESH)
    torch.cuda.synchronize()
    row["n_weights"] = _unique_params(params)
    if row["n_weights"] != cfg.n_params() + _uncounted(cfg):
        raise AssertionError(f"{cfg.name}: {row['n_weights']} weights on {TPF_MESH}, the "
                             f"analytic count {cfg.n_params()} and {_uncounted(cfg)}")
    if cfg.family == "moe":
        row["expert_leaf"].append(_expert_leaf(params, TPF_MESH))
        a, b = (r["gathered_bytes"] for r in row["expert_leaf"])
        if a != TPF_MESH.tp * b:
            raise AssertionError(f"#1 writes {b} bytes at an expert leaf on {TPF_MESH}, "
                                 f"{a} on {TPF_BASE}: not a 1/{TPF_MESH.tp}")
        print(f"[tpf-serve] {cfg.name} expert leaf w_gate: " + json.dumps(row["expert_leaf"]),
              flush=True)
    per = {k: tpf_launches(cfg, TPF_MESH, "mcast", k, s) for k in ("prefill", "decode")}
    print(f"[tpf-serve] {cfg.name} ({cfg.family}) at {cfg.num_layers} layers, "
          f"{row['n_weights']:,} weights on {TPF_MESH}, batch {BATCH} x {s}: launches derived "
          f"from the code, mcast: a prefill {json.dumps(per['prefill'])}, a decode step "
          f"{json.dumps(per['decode'])}", flush=True)
    ref = None
    for mode in MODES:
        torch.cuda.reset_peak_memory_stats()
        run = RunConfig(model=cfg, shape=ShapeConfig("serve", "prefill", s, BATCH),
                        collective=CollectiveConfig(fsdp_mode=mode, n_chains=N_CHAINS))
        _, _, prefill = make_prefill_step(run, TPF_MESH)
        _, _, decode = make_decode_step(run, TPF_MESH)

        def do_prefill():
            return prefill(params, batch)

        (logits, _), _, counts = _run(do_prefill)
        want = _tpf_want(cfg, TPF_MESH, mode, "prefill", seq=s)
        if counts != want:
            raise AssertionError(f"{cfg.name} {mode}: prefill launched {counts}, expected {want}")
        if logits.shape != (BATCH, cfg.vocab_size) or not torch.isfinite(logits).all():
            raise AssertionError(f"{cfg.name} {mode}: bad logits {tuple(logits.shape)}")
        ref = logits if ref is None else ref
        if not torch.equal(logits, ref):
            raise AssertionError(f"{cfg.name} {mode} prefill on {TPF_MESH} differs from xla")
        prefill_s = _wall(do_prefill, TPF_REPEATS)
        mrow = {"prefill_ms_median": statistics.median(prefill_s) * 1e3,
                "prefill_ms_samples": [t * 1e3 for t in prefill_s],
                "launches_per_prefill": {k: v for k, v in counts.items() if v}}
        if mode == "mcast":
            out, gen_s, gen_counts = _run(lambda: greedy_generate(
                prefill, decode, params, tokens, TPF_NEW, s + TPF_NEW, inputs))
            want_gen = _tpf_want(cfg, TPF_MESH, mode, "prefill", steps=TPF_NEW - 1, seq=s)
            if gen_counts != want_gen:
                raise AssertionError(f"{cfg.name}: generation launched {gen_counts}, "
                                     f"expected {want_gen}")
            if (out.shape != (BATCH, s + TPF_NEW) or not torch.equal(out[:, :s], tokens)
                    or not torch.equal(out[:, s], logits.argmax(-1))):
                raise AssertionError(f"{cfg.name}: bad tokens {tuple(out.shape)}")
            decode_s = gen_s - statistics.median(prefill_s)
            dev, prof_ms = _device_times(do_prefill)
            busy = sum(dev.values())
            mrow.update({"decode_steps": TPF_NEW - 1, "decode_ms": decode_s * 1e3,
                         "decode_tok_s": BATCH * (TPF_NEW - 1) / decode_s,
                         "launches_per_decode_step": {
                             k: (gen_counts[k] - counts[k]) // (TPF_NEW - 1)
                             for k in MODEL_KERNELS + ("matmul_wmma", "matmul_f32")},
                         "prefill_device_busy_ms": busy, "prefill_profiled_wall_ms": prof_ms,
                         "prefill_device_idle_share": 1 - busy / prof_ms,
                         "prefill_ring_allgather_device_ms": sum(
                             t for k, t in dev.items() if "ring_allgather_kernel" in k),
                         "prefill_transpose_device_ms": sum(
                             t for k, t in dev.items() if "transpose_kernel" in k),
                         "prefill_matmul_device_ms": sum(
                             t for k, t in dev.items() if "matmul_" in k),
                         "greedy_tokens_equal_share_vs_8x1":
                             (out[:, s:] == base_out[:, s:]).float().mean().item(),
                         "sample_tokens": out[0, s:].tolist()})
            top = sorted(dev.items(), key=lambda kv: -kv[1])[:6]
            print(f"[tpf-serve] {cfg.name} mcast prefill, top device time (ms): "
                  + json.dumps({k[:60]: t for k, t in top}), flush=True)
            del out
        mrow["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
        row["modes"][mode] = mrow
        print(f"[tpf-serve] {cfg.name} {mode}: " + json.dumps(mrow), flush=True)
        del logits
    row.update(max_abs_logit_diff_vs_8x1=(ref.float() - base_logits.float()).abs().max().item(),
               argmax_equal_share_vs_8x1=(ref.argmax(-1) == base_logits.argmax(-1))
               .float().mean().item())
    print(f"[tpf-serve] {cfg.name}: prefill logits bitwise equal in every mode on {TPF_MESH}; "
          f"against {TPF_BASE}: max abs logit diff {row['max_abs_logit_diff_vs_8x1']}, argmax "
          f"equal share {row['argmax_equal_share_vs_8x1']}", flush=True)
    del params
    torch.cuda.empty_cache()
    return row


def tpf_serve() -> dict[str, dict]:
    """Phase 3i: deepseek-moe-16b (4 of 28 layers: 64 experts split 16 a tp
    rank), rwkv6-7b (4 of 32: 16 WKV heads a tp rank), recurrentgemma-9b
    (its 5-layer cut: the LRU width 1,024 a tp rank, 4 of its 16 heads over
    one kv head) and whisper-base (6 + 6 layers: 2 of its 8 heads a tp
    rank; 512 frames + 512 tokens) at full width through
    ``_tpf_serve_one``. Returns each arch's row."""
    return {arch: _tpf_serve_one(arch) for arch in TPF_ARCHS}


def tpf_train() -> dict[str, dict]:
    """Phase 4i: deepseek-moe-16b and rwkv6-7b at 2 layers,
    recurrentgemma-9b at 5 and whisper-base whole, full width, batch
    TRAIN_SHAPE (16 x 512; recurrentgemma-9b 8 x 512, ``TPF_TRAIN_SHAPE``),
    on TPF_MESH, through ``_train_model``, every
    step launching ``_tpf_want``'s counts; the first-step loss bitwise
    equal in every mode."""
    rows = {}
    for arch in TPF_ARCHS:
        cfg, shape = _tpf_cfg(arch, train=True), TPF_TRAIN_SHAPE.get(arch, TRAIN_SHAPE)
        per = tpf_launches(cfg, TPF_MESH, "mcast", "train", shape.seq_len)
        rows[arch] = _train_model(
            "tpf-train", cfg, TPF_MESH, shape, per, TPF_TRAIN_TIMED,
            want=lambda mode, cfg=cfg, s=shape.seq_len: _tpf_want(cfg, TPF_MESH, mode, "train",
                                                                   seq=s))
        torch.cuda.empty_cache()
    return rows


# ------------------------------ phase 7: compression, counters, the dry-run

RT_ARCH = "yi-9b"
RT_LAYERS = 2
RT_MESH = StackedMesh(data=8, model=1)
RT_PEAK_TOL = 0.10   # the dry-run's predicted peak against the card's


def _cpu_tree(tree):
    return tree_map(lambda s: s._replace(local=s.local.detach().cpu()), tree)


def _tree_equal(a, b, what: str) -> int:
    n = 0
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        if not torch.equal(x.local.cpu(), y.local):
            raise AssertionError(f"{what}: the card's compression differs from the CPU's")
        n += 1
    return n


class _CallList:
    """Every ``ring_allgather`` and ``ring_allgather_transpose`` call of
    ``core/collectives.py`` while installed, and every plain gather
    (``plain_allgather_local``, the embedding's and the head's in the mcast
    modes): (kind, shards' shape (..., P, n), itemsize), a plain gather
    whose result needs a gradient adding its backward's reduce-scatter."""

    def __enter__(self):
        self.calls = []
        self.saved = (C.ring_allgather, C.ring_allgather_transpose, C.plain_allgather_local)

        def gather(x, schedule, out=None):
            self.calls.append(("all-gather", tuple(x.shape), x.element_size()))
            return self.saved[0](x, schedule, out)

        def transpose(g, schedule):
            self.calls.append(("reduce-scatter", tuple(g.shape[:-3]) + tuple(g.shape[-2:]),
                               g.element_size()))
            return self.saved[1](g, schedule)

        def plain(x):
            out = self.saved[2](x)
            self.calls.append(("all-gather", tuple(x.shape), x.element_size()))
            if out.requires_grad:
                self.calls.append(("reduce-scatter", tuple(x.shape), x.element_size()))
            return out

        C.ring_allgather, C.ring_allgather_transpose, C.plain_allgather_local = (
            gather, transpose, plain)
        return self

    def __exit__(self, *exc):
        C.ring_allgather, C.ring_allgather_transpose, C.plain_allgather_local = self.saved

    def implied(self) -> dict[str, dict[str, int]]:
        """The collective bytes (hlo_stats's ring formulas) and counts these
        calls imply: a gather of shards (..., P, n), and a reduce-scatter to
        them, move (P - 1) n elements a rank."""
        out = {"per_device_bytes": {}, "counts": {}}
        for kind, shape, itemsize in self.calls:
            p, n = shape[-2], shape[-1]
            per = (p - 1) * n * itemsize
            out["per_device_bytes"][kind] = out["per_device_bytes"].get(kind, 0) + per
            out["counts"][kind] = out["counts"].get(kind, 0) + 1
        return out



def runtime_phase() -> dict:
    """Phase 7 (see the module docstring). Returns its row."""
    from repro_torch.launch import collective_stats, dryrun
    from repro_torch.optim.compression import make_compressor

    cfg = replace(get_model_config(RT_ARCH), num_layers=RT_LAYERS)
    run = _train_run(cfg, TRAIN_SHAPE, "mcast")
    row = {"arch": cfg.name, "layers": RT_LAYERS, "mesh": repr(RT_MESH)}
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    tree = bridge.device_params(cfg, RT_MESH, MeshConfig(), seed=0, dtype=torch.bfloat16)
    _, _, step = make_train_step(run, RT_MESH)
    state = init_state(run, RT_MESH, tree)
    del tree
    batch = SyntheticPipeline(cfg, TRAIN_SHAPE).next_batch(0)

    # (a) the compressor on the card against the CPU, bitwise
    t0 = time.perf_counter()
    _, _, grads = step.value_and_grad(state, batch)
    comp, err = make_compressor(state.params)
    g_hat, new_err = comp(grads, err)
    comp_cpu, err_cpu = make_compressor(_cpu_tree(state.params))
    want_g, want_err = comp_cpu(_cpu_tree(grads), err_cpu)
    leaves = _tree_equal(g_hat, want_g, "g_hat") + _tree_equal(new_err, want_err, "error")
    row["compression"] = {"leaves_bitwise": leaves,
                          "device_ms": _device_ms(lambda: comp(grads, err), 3),
                          "cpu_s": time.perf_counter() - t0}
    del grads, err, g_hat, new_err, want_g, want_err, comp_cpu, err_cpu
    torch.cuda.synchronize()

    # (b) one step under the counters; (c) its peak
    want = _train_launches(cfg, RT_MESH, "mcast")
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    with collective_stats.counting(n_devices=RT_MESH.n_ranks) as st, _CallList() as calls:
        state, _ = step(state, batch)
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    got = st.as_dict()
    launched = _counts()
    meta = dryrun.measure_step(run, RT_MESH)
    dry = meta["collectives"].as_dict()
    implied = calls.implied()
    for name, other in (("the meta dry-run", dry), ("the calls' shapes", implied)):
        if (got["per_device_bytes"] != other["per_device_bytes"]
                or got["counts"] != other["counts"]):
            raise AssertionError(f"phase 7: counted {got} != {name}'s {other}")
    plain = sum(1 for k, _, _ in calls.calls if k == "all-gather") - launched["ring_allgather"]
    if not (launched["ring_allgather"] == want["ring_allgather"]
            and launched["ring_allgather_transpose"] == want["ring_allgather_transpose"]
            and got["counts"].get("all-gather") == want["ring_allgather"] + plain
            and got["counts"].get("reduce-scatter") == want["ring_allgather_transpose"] + plain):
        raise AssertionError(f"phase 7: counts {got['counts']} against launches {want}")
    predicted = meta["memory_analysis"]["process_peak_bytes"]
    gap = (predicted - peak) / peak
    mem = torch.cuda.get_device_properties(0).total_memory
    row.update({"collectives": got, "plain_gathers": plain,
                "total_bytes_equal_dryrun": got["total_bytes"]
                == dry["total_bytes"], "launches": {k: launched[k] for k in MODEL_KERNELS},
                "predicted_peak_bytes": predicted, "max_memory_allocated_step": peak,
                "peak_gap": gap, "dryrun_s": meta["lower_s"] + meta["compile_s"],
                "dryrun_flops": meta["flops"], "card_total_memory": mem,
                "card": torch.cuda.get_device_name(0)})
    print("[runtime] " + json.dumps(row), flush=True)
    if abs(gap) > RT_PEAK_TOL:
        raise AssertionError(f"phase 7: the dry-run predicts {predicted} bytes, the step "
                             f"peaked at {peak} ({gap:+.3f})")
    del state, batch
    torch.cuda.empty_cache()
    return row


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    build.build()
    print(f"[build] {len(build.SOURCES)} kernels built in "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)

    cfg = get_model_config("smollm-135m")
    small = reduced(cfg)
    t0 = time.perf_counter()
    cases, ring_err = check_kernel()
    print(f"[kernel] ring_step == plain on {cases} cases, max abs err {ring_err} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    ag_cases, ag_err = check_allgather()
    print(f"[kernel] ring_allgather == plain steps on every prefix: {ag_cases} launches, max "
          f"abs err {ag_err} ({time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    agt_cases, agt_err = check_allgather_transpose()
    print(f"[kernel] ring_allgather_transpose == plain on every prefix: {agt_cases} launches, "
          f"max abs err {agt_err} ({time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    st_cases, st_err = check_strided_layouts()
    agt_err = max(agt_err, st_err)
    ag_err = max(ag_err, st_err)
    print(f"[kernel] ring_allgather and its transpose == plain on a tp group's strided layout: "
          f"{st_cases} calls, max abs err {st_err} ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    train_cases = matmul_cases(cfg, 8, TRAIN_SHAPE.global_batch // 8 * TRAIN_SHAPE.seq_len,
                               torch.bfloat16, train=True)
    path_cases = {**train_cases,                                    # full-width serving:
                  **matmul_cases(cfg, 8, PROMPT, torch.bfloat16, train=False, head_m=1),
                  **matmul_cases(cfg, 8, 1, torch.bfloat16, train=False),   # decode
                  # the reduced f32 references: prefill, decode, train, 8 ranks and 1
                  **matmul_cases(small, 8, 32, torch.float32, train=False, head_m=1),
                  **matmul_cases(small, 1, 256, torch.float32, train=False, head_m=8),
                  **matmul_cases(small, 8, 1, torch.float32, train=False),
                  **matmul_cases(small, 1, 8, torch.float32, train=False),
                  **matmul_cases(small, 8, 64, torch.float32, train=True),
                  **matmul_cases(small, 1, 512, torch.float32, train=True),
                  # phase 4c: the step on (data=4) after the elastic restore; the
                  # replicated batch of 4 on 8 ranks: training (the launcher's
                  # too), prefill, decode, and the reduced f32 step, 8 ranks and 1
                  **matmul_cases(cfg, 4, TRAIN_SHAPE.global_batch // 4 * TRAIN_SHAPE.seq_len,
                                 torch.bfloat16, train=True),
                  **matmul_cases(cfg, 8, REPL_SHAPE.global_batch * REPL_SHAPE.seq_len,
                                 torch.bfloat16, train=True),
                  **matmul_cases(cfg, 8, REPL_SHAPE.global_batch * PROMPT, torch.bfloat16,
                                 train=False, head_m=REPL_SHAPE.global_batch),
                  **matmul_cases(cfg, 8, REPL_SHAPE.global_batch, torch.bfloat16, train=False),
                  **matmul_cases(small, 8, 4 * 64, torch.float32, train=True),
                  **matmul_cases(small, 1, 4 * 64, torch.float32, train=True)}
    # phases 3d and 4d: deepseek-moe-16b's training (2 layers), prefill and
    # decode steps, and the reduced f32 reference's, 8 ranks and 1
    moe, moe_small = _moe_cfg(), reduced(_moe_cfg())
    tokens = TRAIN_SHAPE.global_batch * TRAIN_SHAPE.seq_len
    moe_train_cases = moe_matmul_cases(replace(moe, num_layers=MOE_TRAIN_LAYERS), 8,
                                       tokens // 8, moe_capacity(moe, tokens), torch.bfloat16,
                                       train=True)
    small_t = 8 * MOE_SMALL_SEQ
    path_cases.update({
        **moe_train_cases,
        **moe_matmul_cases(moe, 8, MOE_PROMPT, moe_capacity(moe, BATCH * MOE_PROMPT),
                           torch.bfloat16, train=False, head_m=1),
        **moe_matmul_cases(moe, 8, 1, BATCH, torch.bfloat16, train=False),
        **moe_matmul_cases(moe_small, 8, MOE_SMALL_SEQ, moe_capacity(moe_small, small_t),
                           torch.float32, train=False, head_m=1),
        **moe_matmul_cases(moe_small, 1, small_t, moe_capacity(moe_small, small_t),
                           torch.float32, train=False, head_m=8),
        **moe_matmul_cases(moe_small, 8, 1, 8, torch.float32, train=False),
        **moe_matmul_cases(moe_small, 1, 8, 8, torch.float32, train=False)})
    # phases 3e and 4e: the dense configs' prefill (one row a rank), decode
    # and 2-layer training, forward and both backward products
    dense_train_cases = {arch: matmul_cases(_dense_cfg(arch, train=True), 8,
                                            TRAIN_SHAPE.global_batch // 8 * TRAIN_SHAPE.seq_len,
                                            torch.bfloat16, train=True)
                         for arch in DENSE_ARCHS}
    for arch in DENSE_ARCHS:
        path_cases.update({
            **dense_train_cases[arch],
            **matmul_cases(_dense_cfg(arch), 8, BATCH // 8 * DENSE_PROMPT, torch.bfloat16,
                           train=False, head_m=BATCH // 8),
            **matmul_cases(_dense_cfg(arch), 8, BATCH // 8, torch.bfloat16, train=False)})
    # phases 3g and 4g: the sub-quadratic families' prefill (one row a rank),
    # decode and training, and their reduced f32 check's, 8 ranks
    subq_train_cases = {}
    for arch in SUBQ_ARCHS:
        tcfg, r = _subq_cfg(arch, train=True), SUBQ_TRAIN_MESH[arch].n_ranks
        subq_train_cases[arch] = subq_matmul_cases(
            tcfg, r, TRAIN_SHAPE.global_batch // r * TRAIN_SHAPE.seq_len, train=True)
        small = reduced(get_model_config(arch), layers=5 if arch == "recurrentgemma-9b" else None)
        for case, n in {**subq_train_cases[arch],
                        **subq_matmul_cases(_subq_cfg(arch), 8, BATCH // 8 * SUBQ_PROMPT,
                                            train=False, head_m=BATCH // 8),
                        **subq_matmul_cases(_subq_cfg(arch), 8, BATCH // 8, train=False)}.items():
            path_cases[case] = path_cases.get(case, 0) + n
        for m, head_m in ((40, 1), (1, None)):
            for case, n in subq_matmul_cases(small, 8, m, train=False, head_m=head_m).items():
                path_cases[case[:-1] + (torch.float32,)] = n
    # phases 3h and 4h: phi-3-vision-4.2b, whisper-base and moonshot-v1-16b-a3b;
    # phases 3i and 4i: the MoE, rwkv, hybrid and encdec on (data=2, model=4)
    for case, n in fam_path_cases().items():
        path_cases[case] = path_cases.get(case, 0) + n
    for case, n in tpf_path_cases().items():
        path_cases[case] = path_cases.get(case, 0) + n
    t0 = time.perf_counter()
    mm_err = check_matmul(path_cases)
    odd = [case for case in path_cases if expected_path(*case) == "wmma"]
    print(f"[kernel] matmul within limits of plain on {len(path_cases)} path shapes, every "
          f"bf16 one on the wgmma path but the {len(odd)} head products of the odd vocabs "
          f"(granite-3-8b's 49,155, whisper-base's 51,865) on the wmma path "
          f"({json.dumps([c[:6] for c in odd])}), max abs err {mm_err} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    edge_cases = check_matmul_edges()
    print(f"[kernel] matmul == plain (integer inputs, exact) on {edge_cases} edge cases of the "
          "wgmma and wmma paths", flush=True)
    t0 = time.perf_counter()
    rx = check_rx_kernels()
    print("[kernel] receive datapath == plain (exact): "
          + json.dumps({k: {"cases": c, "max_abs_err": e} for k, (c, e) in rx.items()})
          + f" ({time.perf_counter() - t0:.1f} s)", flush=True)
    print(f"[kernel] chunk_reassembly and bitmap_popcount: {check_no_sync()} calls under "
          "set_sync_debug_mode('error'), none synchronised", flush=True)
    print(f"[collectives] {check_collectives()} cases equal the "
          "plain gather", flush=True)
    err = check_small_reference()
    print(f"[reference] reduced f32 sharded vs single-rank: max abs logit diff {err}",
          flush=True)
    worst = check_train_reference()
    print(f"[reference] reduced f32 train step within limits; largest relative loss "
          f"difference {worst}", flush=True)
    worst = check_train_reference(batch=REPL_SHAPE.global_batch)   # phase 4c (e)'s
    print(f"[reference] reduced f32 replicated train step within limits; largest relative "
          f"loss difference {worst}", flush=True)

    launches = {}
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()   # counts from here to the read are the serving path's
    serve()
    serve_counts = _counts()
    print(f"[serve] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; "
          f"launches {json.dumps(serve_counts)}", flush=True)
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()   # counts from here to the read are the training path's
    per_step, train_metrics = train()
    train_counts = _counts()
    print(f"[train] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; "
          f"launches {json.dumps(train_counts)}", flush=True)
    t0 = time.perf_counter()
    _zero_counts()   # counts from here to the read are the training options'
    train_options(train_metrics)
    option_counts = _counts()
    print(f"[train-options] launches {json.dumps(option_counts)} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()   # counts from here to the read are phase 4c's
    checkpoint_phase(cfg)
    ckpt_counts = _counts()
    print(f"[ckpt] phase 4c: peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; launches "
          f"{json.dumps(ckpt_counts)} ({time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    err, drop = check_moe_small_reference()
    print(f"[reference] reduced f32 MoE sharded vs single-rank: max abs logit diff {err}, "
          f"drop fraction {drop} on both ({time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()   # counts from here to the read are the MoE serving path's
    moe_serve()
    moe_serve_counts = _counts()
    print(f"[moe-serve] phase 3d: peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; launches "
          f"{json.dumps(moe_serve_counts)} ({time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()   # counts from here to the read are the MoE training path's
    moe_train()
    moe_train_counts = _counts()
    print(f"[moe-train] phase 4d: peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; launches "
          f"{json.dumps(moe_train_counts)} ({time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()   # counts from here to the read are the dense configs' serving paths'
    dense_serve()
    dense_serve_counts = _counts()
    print(f"[dense-serve] phase 3e: launches {json.dumps(dense_serve_counts)} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    _zero_counts()   # counts from here to the read are the dense configs' training paths'
    dense_train()
    dense_train_counts = _counts()
    print(f"[dense-train] phase 4e: launches {json.dumps(dense_train_counts)} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    err = check_subq_small_reference()
    print(f"[reference] reduced f32 rwkv and hybrid on the card vs the CPU: max abs logit diff "
          f"{err}, greedy tokens equal ({time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    _zero_counts()   # counts from here to the read are the sub-quadratic serving paths'
    subq_serve()
    subq_serve_counts = _counts()
    print(f"[subq-serve] phase 3g: launches {json.dumps(subq_serve_counts)} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    _zero_counts()   # counts from here to the read are the sub-quadratic training paths'
    subq_train()
    subq_train_counts = _counts()
    print(f"[subq-train] phase 4g: launches {json.dumps(subq_train_counts)} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    err = check_fam_small_reference()
    print(f"[reference] reduced f32 phi-3-vision and whisper on the card vs the CPU: max abs "
          f"logit diff {err}, greedy tokens equal ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    t0 = time.perf_counter()
    shapes = _CallShapes()   # #1 and #1b call shapes of phases 3h, 3f and 4f
    _zero_counts()   # counts from here to the read are the last three archs' serving paths'
    with shapes:
        fam_serve()
    fam_serve_counts = _counts()
    print(f"[fam-serve] phase 3h: launches {json.dumps(fam_serve_counts)} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    _zero_counts()   # counts from here to the read are the last three archs' training paths'
    fam_train()
    fam_train_counts = _counts()
    print(f"[fam-train] phase 4h: launches {json.dumps(fam_train_counts)} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    _zero_counts()   # counts from here to the read are the model axis's serving path's
    with shapes:
        tp_serve()
    tp_serve_counts = _counts()
    print(f"[tp-serve] phase 3f: launches {json.dumps(tp_serve_counts)} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    _zero_counts()   # counts from here to the read are the model axis's training paths'
    with shapes:
        tp_train()
    tp_train_counts = _counts()
    print(f"[tp-train] phase 4f: launches {json.dumps(tp_train_counts)} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    err = check_tpf_small_reference()
    print(f"[reference] reduced f32 MoE, rwkv, hybrid and whisper on {TPF_MESH} on the card vs "
          f"the CPU: max abs logit diff {err}, greedy tokens equal "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    _zero_counts()   # counts from here to the read are the model axis's families' serving
    with shapes:
        tpf_serve()
    tpf_serve_counts = _counts()
    print(f"[tpf-serve] phase 3i: launches {json.dumps(tpf_serve_counts)} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    _zero_counts()   # counts from here to the read are the model axis's families' training
    with shapes:
        tpf_train()
    tpf_train_counts = _counts()
    print(f"[tpf-train] phase 4i: launches {json.dumps(tpf_train_counts)} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    runtime_phase()
    print(f"[runtime] phase 7 passed ({time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    shape_cases, shape_err = check_call_shapes(shapes)
    ag_err, agt_err = max(ag_err, shape_err), max(agt_err, shape_err)
    print(f"[kernel] ring_allgather and its transpose == plain at every call shape of phases "
          f"3h, 3f, 4f, 3i and 4i: {len(shapes.shapes['ring_allgather'])} gather and "
          f"{len(shapes.shapes['ring_allgather_transpose'])} transpose shapes, {shape_cases} "
          f"calls, max abs err {shape_err} ({time.perf_counter() - t0:.1f} s)", flush=True)
    for name in MODEL_KERNELS:
        if tp_serve_counts[name] == 0 or tp_train_counts[name] == 0:
            raise AssertionError(f"{name} was not launched on the model axis's paths")
        if tpf_serve_counts[name] == 0 or tpf_train_counts[name] == 0:
            raise AssertionError(f"{name} was not launched on the model axis's MoE, rwkv, "
                                 "hybrid and encdec paths")
    for name in MODEL_KERNELS:
        launches[name] = (serve_counts[name] + train_counts[name] + option_counts[name]
                          + ckpt_counts[name] + moe_serve_counts[name] + moe_train_counts[name]
                          + dense_serve_counts[name] + dense_train_counts[name]
                          + tp_serve_counts[name] + tp_train_counts[name]
                          + subq_serve_counts[name] + subq_train_counts[name]
                          + fam_serve_counts[name] + fam_train_counts[name]
                          + tpf_serve_counts[name] + tpf_train_counts[name])
        if train_counts[name] == 0 or option_counts[name] == 0 or ckpt_counts[name] == 0:
            raise AssertionError(f"{name} was not launched on the training path")
        if moe_train_counts[name] == 0:
            raise AssertionError(f"{name} was not launched on the MoE training path")
        if dense_train_counts[name] == 0:
            raise AssertionError(f"{name} was not launched on the dense configs' training path")
        if subq_train_counts[name] == 0:
            raise AssertionError(f"{name} was not launched on the sub-quadratic training path")
        if fam_train_counts[name] == 0:
            raise AssertionError(f"{name} was not launched on the last three archs' training "
                                 "paths")
    # the MoE router's products run on the matmul kernel's f32 path, the
    # odd vocab's head products (granite-3-8b) on its wmma path
    launches["matmul"] += (moe_serve_counts["matmul_f32"] + moe_train_counts["matmul_f32"]
                           + dense_serve_counts["matmul_wmma"] + dense_train_counts["matmul_wmma"]
                           + subq_serve_counts["matmul_f32"] + subq_train_counts["matmul_f32"]
                           + sum(c[k] for c in (fam_serve_counts, fam_train_counts,
                                                 tpf_serve_counts, tpf_train_counts)
                                 for k in ("matmul_wmma", "matmul_f32")))
    if any(c[k] == 0 for c in (tpf_serve_counts, tpf_train_counts)
           for k in ("matmul_wmma", "matmul_f32")):
        raise AssertionError(f"the wmma or f32 matmul was not launched on phases 3i and 4i: "
                             f"{tpf_serve_counts}, {tpf_train_counts}")
    if any(fam_serve_counts[k] == 0 for k in ("ring_allgather", "ring_allgather_transpose",
                                              "matmul", "matmul_wmma", "matmul_f32")):
        raise AssertionError(f"a kernel was not launched on the last three archs' serving "
                             f"paths: {fam_serve_counts}")
    if any(subq_serve_counts[k] == 0 for k in ("ring_allgather", "matmul", "matmul_f32")):
        raise AssertionError(f"a kernel was not launched on the sub-quadratic serving paths: "
                             f"{subq_serve_counts}")
    if any(dense_serve_counts[k] == 0 for k in ("ring_allgather", "matmul", "matmul_wmma")):
        raise AssertionError(f"a kernel was not launched on the dense serving paths: "
                             f"{dense_serve_counts}")
    if any(moe_serve_counts[k] == 0 for k in ("ring_allgather", "matmul", "matmul_f32")):
        raise AssertionError(f"a kernel was not launched on the MoE serving path: "
                             f"{moe_serve_counts}")
    if serve_counts["ring_allgather"] == 0 or serve_counts["matmul"] == 0:
        raise AssertionError(f"a kernel was not launched on the serving path: {serve_counts}")
    if any(serve_counts[k] or train_counts[k] or option_counts[k] or ckpt_counts[k]
           for k in OFF_PATH):
        raise AssertionError(f"a serving or training product left the wgmma path: serving "
                             f"{serve_counts}, training {train_counts}, {option_counts}, "
                             f"phase 4c {ckpt_counts}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    packet_counts, card = packet_path()   # zeroes the counts before driving the path
    print(f"[packet] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; "
          f"launches {json.dumps(packet_counts)} ({time.perf_counter() - t0:.1f} s)", flush=True)
    launches.update({name: packet_counts[name] for name in PACKET_KERNELS})
    t0 = time.perf_counter()
    ag_counts, ag_shapes = allgather_path()   # zeroes the counts before driving the path
    print(f"[allgather] launches {json.dumps(ag_counts)} ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    for name in AG_KERNELS:
        launches[name] += ag_counts[name]
    t0 = time.perf_counter()
    fig_pools = figures_path()   # zeroes the counts before each figure's card run
    print(f"[figures] phase 5c passed: {fig_pools} pool launches "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    launches["pool"] += fig_pools
    t0 = time.perf_counter()
    routed = routed_path()   # zeroes the counts before each cell's card run
    print(f"[routed] phase 5d passed: launches {json.dumps(routed)} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    for name in AG_KERNELS:
        launches[name] += routed[name]
    t0 = time.perf_counter()
    offload = dpa_path()   # zeroes the counts before each cell's card run
    print(f"[dpa] phase 5e passed: launches {json.dumps(offload)} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    for name in AG_KERNELS:
        launches[name] += offload[name]
    t0 = time.perf_counter()
    searched = search_path()   # zeroes the counts before each cell's card run
    print(f"[search] phase 5f passed: launches {json.dumps(searched)} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    for name in AG_KERNELS:
        launches[name] += searched[name]
    t0 = time.perf_counter()
    train_sim_path()   # zeroes the counts before each cell's card run
    print(f"[train-sim] phase 5g passed ({time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    drain_cases, drain_err = check_drain()
    print(f"[kernel] double_buffer_drain == plain (exact) on {drain_cases} cases", flush=True)
    layer_counts, layer = layer_path()   # zeroes the counts before driving the path
    launches.update({name: layer_counts[name] for name in LAYER_KERNELS})
    bwd_counts, bwd_err = agmm_backward()   # zeroes the counts before driving the path
    for name in ("allgather_matmul", "matmul", "ring_allgather_transpose"):
        launches[name] += bwd_counts[name]
    bucket_counts = bucket_collectives(cfg)
    launches["ring_step"] = layer_counts["ring_step"]
    launches["ring_allgather"] += bucket_counts["ring_allgather"]
    launches["ring_allgather_transpose"] += bucket_counts["ring_allgather_transpose"]
    print(f"[layer] phase 6 checks passed ({time.perf_counter() - t0:.1f} s)", flush=True)

    ring = time_ring_steps(cfg)
    print(f"[ring] mean over one layer's leaves: {json.dumps(ring)}", flush=True)
    mm = time_matmul(train_cases)
    print(f"[matmul] one train step's {mm['launches']} launches (mcast counted "
          f"{per_step['matmul']}): {json.dumps(mm)}", flush=True)
    moe_mm = time_matmul(moe_train_cases)
    print(f"[moe-matmul] one MoE train step's {moe_mm['launches']} launches: "
          f"{json.dumps(moe_mm)}", flush=True)
    yi_mm = time_matmul(dense_train_cases["yi-9b"])
    print(f"[dense-matmul] one yi-9b train step's {yi_mm['launches']} launches (2 layers): "
          f"{json.dumps(yi_mm)}", flush=True)
    time_moe_kernels()
    rx_t = time_rx_kernels(card)
    t0 = time.perf_counter()
    time_rx_shapes(_largest(ag_shapes, {"pool": 3, "bitmap_pack": 1, "bitmap_or_rows": 1}),
                   E.FabricParams().mtu / E.WorkerParams().thread_tput)
    print(f"[allgather] kernels timed at the largest shapes of its calls "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    layer_t = time_layer(layer)
    print(f"[layer] timed ({time.perf_counter() - t0:.1f} s)", flush=True)
    print(f"[total] {time.perf_counter() - t_start:.1f} s", flush=True)

    replaces = {"pool": ("src/repro_torch/csrc/pool.cu",
                         "src/repro/kernels/pool.py:53, src/repro/kernels/pool.py:86"),
                "bitmap_pack": ("src/repro_torch/csrc/bitmap.cu", "src/repro/kernels/bitmap.py:40"),
                "bitmap_or_rows": ("src/repro_torch/csrc/bitmap.cu",
                                   "src/repro/core/packet.py:952"),
                "bitmap_popcount": ("src/repro_torch/csrc/bitmap.cu",
                                    "src/repro/kernels/bitmap.py:78"),
                "chunk_reassembly": ("src/repro_torch/csrc/chunk_reassembly.cu",
                                     "src/repro/kernels/chunk_reassembly.py:41")}
    rx_rows = [{"name": name, "route": "cuda", "source": replaces[name][0],
                "replaces": replaces[name][1], "launches": launches[name],
                "max_abs_err": rx[name][1], "ms": rx_t[name]["ms"],
                "plain_ms": rx_t[name]["plain_ms"], "bound_ms": rx_t[name]["bound_ms"],
                "bound_by": "bytes", "library_ms": rx_t[name]["library_ms"]}
               for name in PACKET_KERNELS]
    agmm_t, drain_t = layer_t["allgather_matmul"], layer_t["double_buffer_drain"]
    agmm_t["max_abs_err"] = max(agmm_t["max_abs_err"], bwd_err)   # forward and backward
    layer_rows = [
        {"name": "allgather_matmul", "route": "cuda",
         "source": "src/repro_torch/csrc/matmul.cu",
         "replaces": "src/repro/kernels/collective_matmul.py:68",
         "launches": launches["allgather_matmul"], "max_abs_err": agmm_t["max_abs_err"],
         "ms": agmm_t["ms"], "plain_ms": agmm_t["plain_ms"], "bound_ms": agmm_t["bound_ms"],
         "bound_by": agmm_t["bound_by"], "library_ms": agmm_t["library_ms"]},
        {"name": "double_buffer_drain", "route": "cuda",
         "source": "src/repro_torch/csrc/double_buffer_drain.cu",
         "replaces": "src/repro/kernels/ring_allgather.py:94",
         "launches": launches["double_buffer_drain"], "max_abs_err": drain_err,
         "ms": drain_t["ms"], "plain_ms": drain_t["plain_ms"], "bound_ms": drain_t["bound_ms"],
         "bound_by": "bytes", "library_ms": drain_t["library_ms"]}]
    print(smi)
    print(json.dumps({"kernels": [
        {"name": "ring_allgather", "route": "cuda",
         "source": "src/repro_torch/csrc/ring_allgather.cu",
         "replaces": "src/repro/kernels/ring_allgather.py:46",
         "launches": launches["ring_allgather"], "max_abs_err": ag_err,
         "ms": ring["gather_ms"], "plain_ms": ring["gather_plain_ms"],
         "bound_ms": ring["gather_bound_ms"], "bound_by": "bytes",
         "library_ms": ring["gather_library_ms"]},
        {"name": "ring_allgather_transpose", "route": "cuda",
         "source": "src/repro_torch/csrc/ring_allgather_transpose.cu",
         "replaces": "src/repro/kernels/ring_allgather.py:46",
         "launches": launches["ring_allgather_transpose"], "max_abs_err": agt_err,
         "ms": ring["transpose_ms"], "plain_ms": ring["transpose_plain_ms"],
         "bound_ms": ring["transpose_bound_ms"], "bound_by": "bytes",
         "library_ms": ring["transpose_library_ms"]},
        {"name": "ring_step", "route": "cuda", "source": "src/repro_torch/csrc/ring_allgather.cu",
         "replaces": "src/repro/kernels/ring_allgather.py:46",
         "launches": launches["ring_step"], "max_abs_err": ring_err, "ms": ring["ms"],
         "plain_ms": ring["plain_ms"], "bound_ms": ring["bound_ms"], "bound_by": "bytes",
         "library_ms": ring["library_ms"]},
        {"name": "matmul", "route": "cuda", "source": "src/repro_torch/csrc/matmul.cu",
         "replaces": "src/repro/kernels/collective_matmul.py:43",
         "launches": launches["matmul"], "max_abs_err": mm_err,
         "ms": mm["ms_per_launch"], "plain_ms": mm["plain_ms_per_launch"],
         "bound_ms": mm["bound_ms_per_launch"], "bound_by": "operations",
         "library_ms": mm["library_ms_per_launch"]}, *rx_rows, *layer_rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
