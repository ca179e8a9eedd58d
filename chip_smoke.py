#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--layers 4] [--seed 0]
    python3 chip_smoke.py --flash-decode SRC   # flash_decode's shapes on SRC's package
    python3 chip_smoke.py --flash-attention SRC   # the same for flash_attention
    python3 chip_smoke.py --shapes   # only the (arch x input shape) matrix

Phases, each printing one JSON line; any failure raises and exits non-zero:

  1. device  — the card's name and power limit (``nvidia-smi``).
  2. build   — compiles every CUDA kernel of ``src/repro_torch/csrc`` for
               sm_90a (one ``nvcc`` per source, in parallel); prints each
               library's ptxas registers / spills and its count of HGMMA
               (wgmma), UTMALDG / UTMASTG (TMA load / store), HMMA
               (mma.sync / wmma), named BAR.SYNC, BAR.ARV and USETMAXREG
               instructions in ``cuobjdump -sass``, and for each
               ``flash_attn_kernel`` instantiation its registers, spills,
               its own counts and every ptxas advisory naming wgmma or
               setmaxnreg. Fails on any such advisory in
               flash_attention.cu, or on an instantiation whose SASS lacks
               the named barriers or setmaxnreg.
  3. kernels — each kernel at the shapes its main path gives it (the
               Mixtral-8x7B serve path; Mamba2-2.7B's prefill for
               ``ssd_scan``), held against its plain PyTorch version on the
               card, with extra GQA / window / ragged / group / type cases,
               then timed with CUDA events (median of 20 after warm-up)
               beside the plain version, a PyTorch library call where one
               computes the same function, and the bound from bytes at
               3.35 TB/s and operations at 989 TFLOP/s bf16 (tensor cores),
               from the H100 SXM data sheet (``ssd_scan`` also reports the
               bound of its f32 recurrence at 67 TFLOP/s on the CUDA
               cores, ``bound_f32_recurrence_ms``). Every kernel is also
               timed by device time alone (``device_ms``: the median over
               20 calls of the time the card is busy with the work each
               call launches, from a ``torch.profiler`` window): the three
               attention kernels beside their library call's
               (``library_device_ms``), and ``expert_ffn`` beside a cuBLAS
               yardstick (``cublas_device_ms``: three ``torch.bmm`` and
               silu * mul on slabs gathered beforehand), kernel and
               library in turns, at the main path's shape and, but for
               ``expert_ffn``, at a long one (``long``: S=4096, W=4096;
               ``ssd_scan`` S=8192). ``flash_attention_chunk`` (chunked
               prefill over a pool row at slot 3) runs at the batch
               phase's chunk (C=512 from start 1024, W=2048), a grid of
               starts / lengths / windows / groups / -1 holes / pool views,
               C=64 (``c64``) and ``long`` (C=512 from 3584, W=4096),
               timed beside SDPA with its mask and beside the folded
               ``flash_decode`` route it replaces (``folded_device_ms``).
               ``flash_decode`` also runs at the batch phase's decode row
               (``batch``: B=8 over W=2048 at the phase's positions), and
               every ``flash_decode`` record carries its kernels' device ms
               apart (``parts``: the split pass and the combine, from the
               same profiler window). Tolerance: bf16 outputs rtol = atol =
               2e-2 (the repo's kernel-test tolerance), ``ssd_scan``'s f32
               outputs 1e-3
               (tests/test_kernels.py's for that kernel). Then one
               ``kernel_variant`` line per shape that only the families
               phase runs, held and timed the same way, and held at the
               families' forward length S + 1 too: ``flash_attention``
               at D=112 (Zamba2-7B, 32 / 32 heads, window 4096, S=4096, and
               S=5120 where the window skips key tiles) and
               D=256 (gemma3-1b, 4 / 1, B=2 x S=2048, and its window 512),
               ``flash_attention_cross`` (Llama-3.2-Vision-90B: 2 x 2048
               queries over 1601 patch keys, 64 / 8; SeamlessM4T-medium: 2 x
               2048 over 2048 frames, 16 / 16, D=64; rows bit-equal to the
               monolithic kernel where the lengths match), ``flash_decode``
               at D=112 (a full 4096-slot ring; held over the wrapped ring
               of a 5120-token prompt too), D=256 and G=48 (granite-34b,
               48 / 1) at B=2, W=2064, and the cross decode (1601 slots at
               position 0), ``ssd_scan`` at (P, N) = (64, 64) (112 heads,
               S=4096 and S=5120).
  4. check   — a small MoE model served by the same engine on the card and
               on the CPU (plain versions): the prefill logits must agree.
  5. serve   — Mixtral-8x7B at full width, depth cut to ``--layers``, random
               weights from ``--seed``: ODF traces over prompts of 512
               tokens, the ExpertMLP predictor trained on the card, then 4
               requests served under ``duo`` (512-token prompts, 32 new
               tokens, greedy). The launch counts of its kernels are reset
               just before the serve and must be > 0 just after.
  6. batch_check — the check phase's small model through the
               continuous-batching engine (``lfp``, ``max_batch=4``), 4
               prompts of 12-40 tokens and 8 greedy new tokens each, on the
               card and on the CPU, chunked (``prefill_budget=8``) and
               monolithic. The CPU engine runs its attention in the card
               kernels' arithmetic (``flash_decode_plain``, queries folded
               into its batch): first-token logits must agree within
               ``BATCH_CHECK_TOL``, and the same CPU run with the queries
               scaled by 1.01 (a softmax-scale fault, the control) must
               not. Reports the card against the CPU's reference attention
               too, tokens on both devices (and where they part, with the
               CPU's top-2 margin there), ``batch_invariant`` (the card at
               ``max_batch=4`` against each request alone at
               ``max_batch=1``: max abs logit difference, tokens equal) and
               ``chunked_vs_monolithic`` on the card.
  7. batch   — ``BatchedServingEngine`` at Mixtral-8x7B width, the serve
               phase's params and predictor: ``duo``, ``max_batch=8``,
               ``max_seq=2048``, ``prefill_budget=512`` (rr), 8 requests of
               128-1536 prompt tokens and 32 new tokens, 4 submitted before
               the first step and 4 after step 4; then a monolithic run of
               4 requests of 512 tokens at ``max_batch=4``. TTFT from
               submission, E2E, decode tokens/s, decode step wall time by
               batch size, expert copies per decode step, the perf
               counters, the KV row gather time per layer, peak device
               memory, ``hbm_bound_ok``. ``kernel_checks`` holds the
               phase's own kernel shapes against their plain versions
               (tolerance as the kernel phase) and times them: the chunk
               attention (``flash_attention_chunk``, C=512 from start 1024
               over W=2048, beside SDPA with its mask and the folded
               ``flash_decode`` route), decode attention at B=8 over
               gathered pool rows (beside SDPA) and the grouped sweep's
               ``expert_ffn`` at U=8, C=8 out of the engine's pools (beside
               the cuBLAS yardstick). The launch counts of the MoE kernels
               and of ``flash_attention_chunk`` are reset just before the
               phase and must each be > 0 after it; the checks' launches
               are not counted. ``chunk_route_ab``: the chunked run four
               times more, uncounted, its chunk attention through the
               kernel and through the folded ``flash_decode`` route in
               turns (folded, kernel, kernel, folded): wall, TTFT, decode
               step median at B=8. ``linear_ab``: the same four more runs,
               its dense products and router through ``layers.linear``
               (row-invariant: fixed 128-row cuBLAS calls) and through the
               plain product in turns (plain, linear, linear, plain), with
               whether each run's tokens equal the first run's.
  8. cluster — the serving surface (``repro_torch.serving``: ReplicaPool,
               ClusterFrontend, handles) over the batch phase's params,
               predictor and 8 prompts, every replica at ``max_seq=2048``
               and ``max_batch=8``. Run A, ``disagg``: a prefill and
               a decode replica (``prefill_budget=512``, rr), 4 requests
               submitted before the first poll and 4 after poll 4, each
               handed off once (its KV rows to host tensors and back). Run
               B, ``drain``: two ``role="both"`` replicas behind
               ``least_loaded``, monolithic prefill, spans on, all 8
               submitted at once, ``pool.drain(0)`` after poll 6; its
               Perfetto trace (one flow pair per migration) and metrics
               snapshot must validate. Per run: TTFT, E2E, each hop's
               snapshot-to-restore and handoff latency (first token after
               the snapshot), handoff bytes and MB/s, each replica's expert
               copies and ms per slab (CUDA events on its copy stream; the
               two replicas' first-touch copies share the host link),
               ``hbm_bound_ok``, peak device memory, launches. Every
               request must end ``done`` with the batch phase's first
               chunked run's tokens (where they part: the first index and
               both rows' top-2 margins, then a failure), every replica's
               host store must view the params' pinned slabs, and the MoE
               kernels' counts, reset just before, must each be > 0.
  8b. analysis — ``python -m repro_torch.analysis``'s lint of the port's
               sources (clean), then ``device_audit.run_audit`` on the batched
               engine at Mixtral-8x7B width (the batch phase's params and
               predictor, 8 prompts all decoding): the host syncs of one
               decode step by call site (``callback``: each must be a
               dispatch point the allowlist declares), the device bytes
               outside the residency ledger (``const``), in-place pool
               writes (``donation``) and the grouped FFN's launch shapes
               (``compile-keys``), all four clean; then each check against
               a planted fault, which it must catch. Then ``decode_steps``:
               the B=8 decode step's host-clock wall (median of 16), the
               device's busy share of a profiled window of 4 more steps and
               the CUDA runtime calls per step, with no ``cudaHostAlloc``.
               ``--decode-step SRC`` runs only this timing, on the package
               under SRC (another tree's ``src/``).
  8c. examples — each port example's ``main`` (``repro_torch.examples``)
               on the card at published widths, 2 layers: quickstart,
               serve_e2e (2 requests), serve_concurrent --smoke and
               serve_cluster --smoke on Mixtral-8x7B, train_moe (3 steps) and
               preprocess_pipeline on Qwen2-MoE-A2.7B; each holds its
               own assertions, and prints a line of its wall, launches and
               readings. The serving and training kernels' counts are reset
               before and must each be > 0 after.
  9. ssm_check — a small Mamba2 (2 layers, head_dim 64, state 128) through
               the model bundle on the card and on the CPU: the prefill
               logits must agree.
 10. ssm     — Mamba2-2.7B at its published widths and all 64 layers,
               random weights from ``--seed``: 4
               prompts of 2048 tokens one at a time, each ``prefill`` then
               32 greedy ``decode_step``s; TTFT, decode tokens/s, peak
               device memory. ``ssd_scan``'s count is reset just before and
               must be > 0 just after. Then a ``torch.profiler`` window over
               one prefill and 8 decode steps: device busy time by kernel,
               and ``ssd_scan``'s three kernels' share of it. Then, as a
               witness for the hybrid's limit, decode vs forward over one
               prompt (``decode_vs_forward``, not held), and again with the
               decode conv summed in the forward's order.
 11. paper_check — trace-scale Qwen3-30B-A3B (top-8 of 128, ``qk_norm``) and
               DeepSeekMoE-16B (top-6 of 64, a shared expert) at head_dim 64,
               2 layers, served on the card and on the CPU: prefill logits
               within 5e-2, greedy tokens equal.
 12. paper   — the paper's Table I models at their published widths, random
               weights from ``--seed``, one after another, each released
               before the next: DeepSeekMoE-16B at 2 of 28 layers,
               Qwen3-30B-A3B at 2 of 48, Mixtral-8x22B at 2 of 56 (host
               RAM). Per model: its kernel shapes held against their plain
               versions and timed (uncounted), ODF traces over 3 squad-like
               prompts and the ExpertMLP trained on the card, then
               ``BatchedServingEngine`` under ``duo`` (``max_batch=8``,
               budget 256, rr, 4 squad-like and 4 orca-like prompts, 4 of
               them after step 4, 16 greedy new tokens): TTFT, E2E, decode
               tokens/s, step wall by batch size, copies per decode step, ms
               per slab, the fused prefill's rows launched against rows
               routed, peak memory, ``hbm_bound_ok``; the first 4 requests
               each alone at ``max_batch=1`` and all 8 in a monolithic run
               must give the same tokens. On DeepSeekMoE-16B also ``hw_h100`` (the latencies
               ``HW.h100`` takes, measured) and the policy comparison:
               ``MoEServingEngine`` under odf / lfp / mif / duo over 4
               squad-like prompts (8 new tokens), tokens equal across
               policies, each policy's ledger replayed by
               ``simulate_request`` (events,
               peak residency, hits, misses equal), simulated TTFT and step
               under ``HW.h100`` beside the measured ones. The four MoE
               kernels' counts are reset before the phase and must each be
               > 0 after it.
 13. bundle_check — a small model (Kimi-K2-shaped, 2 layers: a dense0 and
               a MoE layer of 4 experts, f = 128, a shared expert;
               d_model 512, head_dim 128) through the model bundle
               (``build_dense``) on the card and on the CPU
               (``check_model_small``): forward logits, prefill's last
               logits and 8 greedy decode steps (both fed the CPU's
               tokens), within rtol = atol = 5e-2; a card token may differ
               only where the CPU's logits tie it within ``TIE``; the card's
               step i against the CPU's step i + 1 must exceed the limit.
               The card's router calls take the CPU's experts: a token whose
               own choice differs must sit at a CPU near-tie
               (``ROUTER_TIE``). Then decode at the last 8 positions against
               forward there, on the card (``decode_vs_forward``).
 14. bundle  — first ``bundle_kernels`` (uncounted): ``expert_ffn`` (the
               capacity buffer's entry) at Qwen2-MoE-A2.7B's forward shape,
               E=64, C=T=4096, d=2048, f=1408, beside the cuBLAS yardstick
               (16 rows launched per routed row), ``flash_attention`` with
               its lse output at B=2, S=2048, 16/16 heads (o bit-equal to
               the call without lse) beside SDPA, ``flash_decode`` at the
               bundle's cache (B=2, W=2064). Then Qwen2-MoE-A2.7B at all 24
               layers (29.7 GB of params on the card) and Qwen3-1.7B at all
               28, random weights from ``--seed``: 2 ``SyntheticLM`` prompts
               of 2048 tokens, a teacher-forced ``forward`` over 2049,
               ``prefill``, ``pad_cache`` and 16 greedy ``decode_step``s;
               forward, prefill and decode step times, peak memory, the
               kernels' launches (reset just before, each > 0 after); then
               decode at the last 8 positions (a prefill of S - 8 tokens,
               then steps fed the true tokens, each on the forward's
               experts) against forward there within ``DECODE_TOL``, and the
               control, decode at p against forward at p + 1, beyond it;
               the same at depths 1-16 of the same weights (``drive``).
 15. train_check — ``FlashAttentionFn`` and ``ExpertFFNFn`` against
               autograd through their plain versions (2e-2 of each
               gradient's largest entry) at a small and the full-width
               layer shape, ``SSDScanFn`` (a ragged S, H/G = 4, then
               Mamba2-2.7B's B=1 x 2048, 80 heads, (64, 128) and
               Zamba2-7B's 4096, 112 heads, (64, 64)) and
               ``FlashAttentionCrossFn`` (a ragged key tile, then
               Llama-3.2-Vision's 2 x 2048 over 1601, 64 / 8, D=128 and
               SeamlessM4T's 2048 over 2048, 16 / 16, D=64; the kernel's
               lse against the plain lse within 1e-3) the same way, each
               with its backward's ms; ``linear`` / ``mm_f32`` against the
               plain product; one train step of the small bundle on the
               card against the CPU (``compare_train_step``: loss within
               2e-2, grad norm 5e-2, each gradient leaf within
               ``STEP_GRAD_TOL`` of the CPU leaf's largest entry, beside a
               half-batch control); a checkpoint save / load round trip on
               the card, bit-equal.
 16. train   — Qwen2-MoE-A2.7B at published widths, 4 of 24 layers, B=2 x
               S=2048 (chunked attention), AdamW under
               ``cosine_schedule(2e-3, warmup=10)``: 10 steps, then 2 with
               ``microbatches=2``; loss, grad norm, wall and tokens/s per
               step, peak memory. Every loss finite, the last below the
               first; ``expert_ffn`` and ``flash_attention`` launched.
 16b. train_families_check — one train step of a small bundle of each of
               the ssm, hybrid, enc-dec, vlm and pattern families (the
               ``ssm_check`` and ``families_check`` configs) on the card
               against the CPU through ``compare_train_step``; every leaf
               the CPU step moves must be nonzero on the card (the ssm's
               ``A_log``, ``dt_bias``, ``conv_B`` and ``conv_C`` are named);
               the vlm's gates, one cancelling bf16 sum each, held to the
               CPU's f32 step by ``F32_RATIO``.
 16c. train_families — published widths, 4 AdamW steps each at lr 1e-5
               on one batch: Mamba2-2.7B at 32 of 64 layers,
               SeamlessM4T-medium at 12 + 12 (2 x 2048 over 2 x 2048
               frames), gemma3-1b at 26 (``build_dense_pattern``), Zamba2-7B
               at ``TRAIN_HYBRID_LAYERS`` of 81 (B=1 x 4096; 12 bytes a
               parameter do not fit whole), Llama-3.2-Vision-90B at one
               block of 5 layers (4 self + 1 cross). Every loss finite, the
               last below the first; ``ssd_scan``, ``flash_attention`` and
               ``flash_attention_cross`` counts reset just before and > 0
               after as each family needs them; step wall, tokens/s, peak
               memory, and the plain backwards' ms and share of the last
               step (CUDA events around each Function's backward).

 17. families_check — each remaining family's reduced config at the
               kernels' widths (the hybrid: 3 layers, head_dim 112, (P, N) =
               (64, 64), a 100-token prompt past its window of 64; the
               enc-dec at 1 + 1 layers, head_dim 64; the vlm at 2 layers,
               head_dim 128, gates 0.5 / -0.7; the pattern stack at 2
               layers, head_dim 256;
               a granite-shaped model with 48 query heads on one KV head)
               through ``check_model_small`` as ``bundle_check``, decode vs
               forward within the family's full-width limit; a further
               control for the vlm (its CPU run with its gates at zero); the
               pattern stack's logits equal to ``build_dense``'s on the
               card. Then ``rounding_witness``: the enc-dec, vlm and pattern
               stack at these depths and at 2 + 2, 4 and 5 layers, seeds
               0-2, forward logits card vs CPU (bf16) and each against the
               CPU in f32; the card at most ``F32_RATIO`` times as far from
               f32 as the CPU's bf16, the vlm without its cross path beyond.
 18. families — published widths, every weight on the card, random from
               ``--seed``: Zamba2-7B at all 81 layers (one prompt of 5120
               tokens, past its 4096-token window), SeamlessM4T-medium at
               all 12 + 12 (2 x 2048 tokens over 2 x 2048 stub frames of
               width 1024), Llama-3.2-Vision-90B at 20 of 100 layers (2 x
               2048 tokens over 1601 stub patch embeddings of width 1280,
               gates 0.5 / -0.7; all 100 layers are 180 GB), gemma3-1b at
               all 26 through ``build_dense_pattern`` (logits equal to
               ``build_dense``'s on the same weights) and granite-34b at 8 of
               88 (2 x 2048). Each: forward over S + 1 tokens, prefill, 16
               greedy decode steps through ``drive`` as ``bundle``; decode
               vs forward within ``DECODE_TOL`` (the hybrid:
               ``HYBRID_DECODE_TOL``, with the gap at 6, 12, 24 and 48
               layers of the same weights, with the decode conv summed in
               the forward's order, and at seeds 1-3, each held).
 19. shapes  — the reference's (arch x input shape) matrix
               (``configs.base.pairs()``: 33 pairs of ten configs and four
               shapes). First ``shape_kernel`` lines: each kernel at the
               matrix's sizes held against its plain version (the plain
               attention in blocks of query rows, the plain expert FFN in
               chunks of experts; an attention output's atol scaled by
               each row's rms, with planted faults that must fail: half
               the window or memory, every other decode range empty, a
               ``slot_pos`` one tile off) and timed, ``SHAPES_REPS`` calls a turn,
               beside SDPA held to its fused kernels or the cuBLAS
               yardstick: ``flash_attention`` at S=32768 (Qwen3-1.7B D=128,
               gemma3-1b D=256 with its window 512, Zamba2-7B D=112 under
               its window 4096), ``flash_attention_cross`` at SeamlessM4T's
               32768 over 32768, ``flash_decode`` at B=8 over W=32768 and at
               position 524287 over ``long_500k``'s wrapped rings (gemma3's
               131072 slots, global and window 512; Zamba2's 4096),
               ``ssd_scan`` at 2 x 32768 (Mamba2, Zamba2), ``expert_ffn`` at
               the capacity rows of Qwen2-MoE-A2.7B's and Kimi-K2's
               ``prefill_32k``. Then every pair through
               ``repro_torch.launch.dryrun``: its plan from bytes (depth,
               batch, microbatches, cuts; a pair that does not fit one card
               is printed with its bytes and not run), one warm-up and one
               timed step at published widths and full sequence length,
               one ``shape_pair`` line each (step ms by CUDA events, peak
               memory, planned bytes, launches); each decode pair within
               ``SHAPES_HOST_BYTES`` held against the same step on the CPU
               (``BUNDLE_TOL``, or the f32 witness past two layers) over its
               cache with each layer's V scaled to O(1) outputs, beside two
               controls that must fail: one window further on, and an
               eighth of the V rows zeroed.
               The kernels' counts are reset before the pairs and each of
               ``SHAPES_KERNELS`` must be > 0 after. ``--shapes`` runs only
               this phase (the pairs first).
 20. mesh    — the reference's (data, model) mesh: ``mesh_kernel`` lines
               first, the kernels at the per-rank shapes held against their
               plain versions and timed (``expert_ffn`` at Qwen2-MoE's 30
               local experts of the phase's capacity and at Mixtral-8x7B's
               hidden-mode slice, f = 14336 / 16; ``flash_attention`` at 8 /
               8 local heads and at 32 / 8 over 16 model ranks, 2 / 1;
               ``flash_decode`` with ``lse`` at 48 / 1 over a 2048-slot
               block and 8 / 8 over 4096 slots, B=2).
               Then Qwen2-MoE-A2.7B at published widths, ``MESH_LAYERS``
               layers, experts padded by the model axis (60), global batch
               4 x 4096: the unsharded step on the card (the MoE at the
               config's capacity factor, one microbatch a data shard: the
               function the mesh computes), its forward's logits and two
               AdamW steps, its router record kept; then 4 ranks of a 2 x 2
               (data x model) mesh in processes sharing this one card over
               gloo (``backend``, ``ranks_per_card`` printed), each through
               ``launch/train.py rank_setup`` and ``make_train_step`` on its
               shard, its router taking the unsharded run's experts (its
               own choice must differ only at a near-tie). Held: the logits
               (last ``MESH_TAIL`` positions of every row, each rank's
               vocabulary block, ``BUNDLE_TOL``), each step's loss
               (``MESH_LOSS_TOL``) and gradient norm (``MESH_GN_TOL``),
               every gradient leaf of step 1 (``MESH_GRAD_TOL``) and the
               params after two steps (``MESH_PARAM_TOL``), beside a fault
               run in the same processes that must fail each of them against
               the rank's sound run: its forward with model rank 1's
               ``e_start`` off by one shard (logits), its steps with
               ``copy_to`` left out (loss, gradient norm, gradient leaves,
               params). Per rank: peak memory, step ms, the collectives'
               counts and bytes (gloo between processes on one card: no
               figure of them is NVLink's), its kernels' launches, which
               must be > 0. Then, in the same 4 processes, the sharded
               decode (``MESH_DECODE_RUNS``: Qwen2-MoE-A2.7B, its KV heads
               over the model axis, and Granite-34B, MQA, its ring's slots
               over it, each at 1 layer and published widths): B=4
               prompts of 2044 tokens prefilled, the cache taken to 4096
               slots (``decode_cache``), 8 steps fed the unsharded
               run's tokens (the MoE replaying its experts), so Granite's
               writes cross into model rank 1's block, empty until step
               4. Held: each rank's logits against the unsharded decode's
               on the card (``BUNDLE_TOL``), its own greedy tokens (a
               difference only at a ``TIE``), Granite's blocks' valid and
               written slots before and after, a fault (the partials
               averaged without their log-sum-exp weights) that must
               fail; beside the host syncs of one unsharded decode step
               (``step_syncs``; ``--decode-syncs SRC`` counts another
               tree's) and ``mesh_kernel`` lines of ``flash_decode`` with
               ``lse`` at both rank shapes, an empty row among them, and
               without it as Qwen2-MoE's heads-sharded path calls it.
               Then, in the same 4 processes, every other family
               (``MESH_FAMILY_RUNS``: Mamba2-2.7B at 2 of 64 layers, global
               batch 4 x 4096; Zamba2-7B at 7 of 81, 4 x 5120 past its 4096
               window; Llama-3.2-Vision-90B at 5 of 100, one block of 4
               self and 1 cross layer over 1601 patches, no train step;
               SeamlessM4T-medium at 1 + 1, 4 x 2048; gemma3-1b at 7
               through ``build_dense_pattern``, 4 x 2048), each rank's
               blocks drawn leaf by leaf, against the unsharded run on the
               card: the forward's logits, two AdamW steps where the
               family takes them (loss, gradient norm, every gradient leaf
               of step 1, the params after step 2, as for Qwen2-MoE), and
               the decode of B=4 prompts (2044 / 5116 / 2048 / 2044 / 2560
               tokens: Zamba2's ring wraps, gemma3's local windows lie in
               model rank 1's block of its 4096 slots), prefill,
               ``decode_cache`` and 8 steps fed the unsharded tokens
               (``BUNDLE_TOL``, tokens apart only at a ``TIE``; a stack
               past two layers by the f32 witness past the limits, as
               ``decode_vs_cpu`` holds the matrix's deep stacks); beside
               the planted faults (``family_faults``) that must fail: the
               gated norm over a rank's own channels (logits), B / C
               without ``copy_to`` (their weights' gradient leaves), the
               conv state stepped without the gather (decode logits),
               Seamless's ``proj`` gather summing its gradient over the
               model axis (the ``proj`` leaf), gemma3's local windows left
               out on the slot-sharded decode (decode logits). Per rank and
               family: peak memory, step ms, collectives, and the launches
               of the family's kernels (``family_kernels``), each of which
               must be > 0; ``mesh_kernel`` lines of ``ssd_scan`` at the
               ranks' 40 / 56 heads and the 16-rank 5 / 7,
               ``flash_attention`` at Zamba2's 16 / 16 heads, D=112, window
               4096 over 5120 and at Seamless's non-causal encoder's 8 / 8,
               ``flash_attention_cross`` at Llama-Vision's 32 / 4 and
               Seamless's 8 / 8 heads, and ``flash_decode`` at Zamba2's 16
               / 16 over its 4096-slot ring, at Llama-Vision's cross 32 / 4
               over the patches and at gemma3's windowed 2048-slot block
               with ``lse`` (the other block none of the window).
               Then, in the same 4 processes, FSDP of the params forced on
               (``launch/train.py rank_model(fsdp=True)``: each rank's
               params its ``zero_specs`` slices, gathered a layer at a time
               inside the layer's checkpoint): Qwen2-MoE-A2.7B at 2 layers
               (replaying the unsharded run's experts) and Mamba2-2.7B at 2,
               whose ``A_log`` / ``D`` / ``dt_bias`` / ``norm`` take the
               data axes on the layer dim, each held against its unsharded
               run (``mesh_held``'s limits) and against the rank's ZeRO-1
               run (the forward's logits and step 1's loss bit for bit);
               beside two planted faults on Mamba2 that must fail: the
               data-axis gather's backward keeping the rank's slice without
               the sum (a gradient leaf past ``MESH_GRAD_TOL``), and a
               layer-dim leaf read from the rank's own slice as if the
               layer dim were whole (logits past ``BUNDLE_TOL`` against the
               sound forward, on params whose layers differ). Last, in
               the same processes, what ``launch/train.py --mesh 2x2``
               runs on each rank (``rank_model``, then 2 steps of its
               4 x 4096 batch) on Qwen2-MoE-A2.7B at 3 layers, by the rule
               (``--fsdp auto``: it must turn FSDP on at ``state_gb_dev``
               10.12) and with FSDP off: each rank's peak must fall by
               ``FSDP_PEAK_DROP`` at least.
               ``--mesh`` runs only this phase.

Every phase line carries ``t_s``, the seconds since the script started.
The last three lines are the card's ``nvidia-smi`` name and power limit,
the kernels' JSON summary (with each kernel's ``variants``), and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import subprocess
import sys
import time
import types
from pathlib import Path
from typing import Callable, NamedTuple

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
PEAK_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
PEAK_BF16_OPS_PER_S = 989e12   # H100 SXM dense bf16 tensor cores
PEAK_F32_OPS_PER_S = 67e12     # H100 SXM f32, CUDA cores
TOL = dict(rtol=2e-2, atol=2e-2)
TOL_F32 = dict(rtol=1e-3, atol=1e-3)
MAX_ERR_ELEMS = 1 << 28
# batch_check: first-token logits on the card against the CPU engine in the
# kernels' arithmetic (logits of max |x| 3.4). Sound runs read up to 0.030;
# the control, a 1% softmax-scale fault, 0.056 (NVIDIA H100 80GB HBM3 and
# its host's CPU): the limit sits between them
BATCH_CHECK_TOL = 4e-2
# the kernels one ssd_scan call launches (csrc/ssd_scan.cu)
SSD_SCAN_KERNELS = ("chunk_state_kernel", "state_pass_kernel", "chunk_scan_kernel")


T_START = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line also carries ``t_s``, the seconds since
    the script started."""
    if "phase" in obj:
        obj = dict(obj, t_s=time.perf_counter() - T_START)
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def event_ms(fn, reps: int = 20, warmup: int = 3) -> list:
    """Device time of each call, by CUDA events around it. On an idle stream
    this includes the host's time to issue the call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of ``event_ms``."""
    return float(np.median(event_ms(fn, reps, warmup)))


def busy_ms(events) -> float:
    """Length of the union of the events' device intervals: work that
    overlaps (a kernel launched as a programmatic dependent starts before
    the kernel it waits for ends) counts once, idle gaps not at all."""
    total, end = 0.0, float("-inf")
    for t0, t1 in sorted((e.time_range.start, e.time_range.end) for e in events):
        total += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
    return total / 1e3


def device_runs(fn, reps: int = 20, opening: int = 10):
    """The device events (kernels, copies, sets) of each of ``reps`` calls,
    from a ``torch.profiler`` window, each call ending in a sync. The calls
    run one after another and launch the same work, so the device events,
    in device order, end in ``reps`` equal runs of names (the host and
    device clocks are not aligned closely enough to match events to
    calls); a call's run is the shortest that repeats, so a call must not
    launch one sequence of kernels twice. ``opening`` more calls open the
    window and are not counted: the profiler drops events at its start
    (the first 8 calls of a masked SDPA, NVIDIA H100 80GB HBM3). A window
    that returns no device event at all is opened again, twice at most:
    once in a whole run the profiler returned none (NVIDIA H100 80GB HBM3,
    torch 2.11), where the same calls measured fine before and after; so
    is one that returns too few to end in ``reps`` equal runs (once, 5 of
    a window's 30 ``flash_attention`` calls, same card; three windows in a
    row, 14 of 30 ``flash_attention_chunk`` calls at W=4096). Returns the
    runs, or None and the last window's events after six such windows."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(6):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps + opening):
                fn()
                torch.cuda.synchronize()
        work = sorted((e for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA),
                      key=lambda e: e.time_range.start)
        for n in range(1, len(work) // reps + 1):
            tail = work[len(work) - reps * n:]
            runs = [tail[i * n:(i + 1) * n] for i in range(reps)]
            if all([e.name for e in r] == [e.name for e in runs[0]] for r in runs):
                return runs, work
    return None, work


def kernel_ms(fn, reps: int = 20, opening: int = 10) -> list:
    """Device time of each call: the busy time (``busy_ms``) of the device
    work each call launches (``device_runs``). Where the profiler gives no
    ``reps`` equal runs, the calls are timed by CUDA events instead
    (``event_ms``, host issue included), and a ``note`` line says so."""
    runs, work = device_runs(fn, reps, opening)
    if runs is not None:
        return [busy_ms(r) for r in runs]
    names = {}
    for e in work:
        names[e.name[:40]] = names.get(e.name[:40], 0) + 1
    emit(dict(note=f"profiler saw {len(work)} device events in {reps + opening} calls, "
                   f"no {reps} equal runs at the end: {names}; CUDA event times used"))
    return event_ms(fn, reps)


def kernel_parts_ms(fn, reps: int = 20):
    """Device ms per call of each kernel ``fn`` launches, by kernel name
    (namespace and template arguments cut): the median over ``reps`` calls
    of one ``device_runs`` window, or "not measured" where it gave none."""
    runs, _ = device_runs(fn, reps)
    if runs is None:
        return "not measured: no equal runs in the profiler window"
    parts = {}
    for run in runs:
        per = {}
        for e in run:
            name = e.name.split("<")[0].split("::")[-1].split("(")[0].replace("void ", "")
            per[name] = per.get(name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
        for name, ms in per.items():
            parts.setdefault(name, []).append(ms)
    return {name: float(np.median(v)) for name, v in parts.items()}


def fused_sdpa(library):
    """``library`` with SDPA held to its fused kernels (flash, memory
    efficient, cuDNN): its math fallback would hold B H S^2 f32 logits, 275
    GB at S=32768."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    fused = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
             SDPBackend.CUDNN_ATTENTION]

    def call():
        with sdpa_kernel(fused):
            return library()
    return call


def in_turns(kernel, library, timer) -> tuple:
    """Medians of ``timer`` over kernel, library, library, kernel."""
    k = timer(kernel)
    lib = timer(library) + timer(library)
    k += timer(kernel)
    return float(np.median(k)), float(np.median(lib))


# SASS instructions counted per library and per flash_attn_kernel
# instantiation: wgmma, TMA load / store, mma.sync, named barriers (a
# BAR.SYNC with an id other than 0, __syncthreads' own) and arrivals, and
# setmaxnreg
SASS_OPS = {"HGMMA": r"\bHGMMA\b", "UTMALDG": r"\bUTMALDG\b", "UTMASTG": r"\bUTMASTG\b",
            "HMMA": r"\bHMMA\b", "BAR.SYNC named": r"\bBAR\.SYNC(?:\.\w+)*\s+(?!0x0\b)",
            "BAR.ARV": r"\bBAR\.ARV\b", "USETMAXREG": r"\bUSETMAXREG\b"}


def attn_instance(mangled: str) -> str:
    """``flash_attn_kernel<D,CHUNK>`` for a mangled instantiation name."""
    m = re.search(r"flash_attn_kernelILi(\d+)ELb([01])E", mangled)
    return f"flash_attn_kernel<{m.group(1)},{'true' if m.group(2) == '1' else 'false'}>"


def sass_op_counts(sass: str) -> dict:
    """``SASS_OPS`` counts of a ``cuobjdump -sass`` text: the library's
    totals, and under ``"functions"`` each flash_attn_kernel
    instantiation's own."""
    count = lambda text: {op: len(re.findall(rx, text)) for op, rx in SASS_OPS.items()}
    out = count(sass)
    funcs = {}
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        name = part.split(None, 1)[0]
        if "flash_attn_kernel" in name:
            funcs[attn_instance(name)] = count(part)
    if funcs:
        out["functions"] = funcs
    return out


def sass_counts(lib: Path):
    """``sass_op_counts`` of a built library."""
    from repro_torch.kernels import _build
    tool = Path(_build.nvcc()).parent / "cuobjdump"
    if not tool.is_file():
        return f"not counted: {tool} not found"
    return sass_op_counts(subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                                         text=True, check=True, timeout=120).stdout)


def ptxas_report(log: str) -> dict:
    """A ``-Xptxas -v`` log read per entry function: registers and spill
    bytes of each flash_attn_kernel instantiation (``functions``), and
    every advisory line that names wgmma or setmaxnreg (``advisories``:
    C7515 / C7518 wgmma serialized, C7517 waits injected, C7508 setmaxnreg
    ignored)."""
    funcs, cur, advisories = {}, None, []
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)", ln)
        if m:
            cur = attn_instance(m.group(1)) if "flash_attn_kernel" in m.group(1) else None
            if cur:
                funcs.setdefault(cur, {})
        elif cur and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)):
            funcs[cur].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        elif cur and (m := re.search(r"Used (\d+) registers", ln)):
            funcs[cur]["registers"] = int(m.group(1))
        if "wgmma" in ln or "setmaxnreg" in ln:
            advisories.append(ln.strip())
    return dict(functions=funcs, advisories=advisories)


def check_attention_build(report: dict, sass) -> None:
    """The build phase's gate on flash_attention.cu's log and SASS: no
    advisory that a wgmma is serialized (or waits were injected, or
    setmaxnreg ignored) in any instantiation, and the SASS of every
    instantiation at D <= 128 (two consumer warpgroups) holds named
    barriers, arrivals and setmaxnreg (the ping-pong and the register moves
    were compiled)."""
    bad = report["advisories"]   # flash_attention.cu holds flash_attn_kernel alone
    if bad:
        raise AssertionError(f"flash_attention.cu: ptxas advisories {bad}")
    if isinstance(sass, dict):
        for name, ops in sass.get("functions", {}).items():
            if int(re.search(r"<(\d+),", name).group(1)) > 128:
                continue   # D = 256: one consumer warpgroup, no ping-pong
            missing = [op for op in ("BAR.SYNC named", "BAR.ARV", "USETMAXREG") if not ops[op]]
            if missing:
                raise AssertionError(f"{name}: no {missing} in its SASS")


def bound(n_bytes: float, n_ops: float, peak_ops: float = PEAK_BF16_OPS_PER_S):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / peak_ops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def max_err(got, want, tol=TOL, rows: bool = False) -> float:
    """The largest |got - want|, raising where an entry is not finite or
    passes ``tol``; over ``MAX_ERR_ELEMS`` entries at a time along dim 0
    (Kimi-K2's expert output in f32 copies would take 75 GB). With
    ``rows`` (attention outputs) the atol of each row (the last dim) is
    scaled by min(1, the row's rms in ``want``): an output that averages
    unit-normal values over n keys has entries of about n^-1/2, so at
    n = 131072 a fixed atol of 2e-2 would pass an output of zeros."""
    if got.numel() > MAX_ERR_ELEMS and got.shape[0] > 1:
        n = max(1, got.shape[0] * MAX_ERR_ELEMS // got.numel())
        return max(max_err(got[i:i + n], want[i:i + n], tol, rows)
                   for i in range(0, len(got), n))
    got, want = got.float(), want.float()
    err = (got - want).abs()
    if not torch.isfinite(got).all():
        raise AssertionError("kernel output is not finite")
    atol = tol["atol"]
    if rows:
        atol = atol * want.square().mean(-1, keepdim=True).sqrt().clamp(max=1.0)
    lim = atol + tol["rtol"] * want.abs()
    if (err > lim).any():
        raise AssertionError(f"kernel disagrees with its plain version: max abs "
                             f"err {float(err.max())} beyond {tol}"
                             + (" (atol scaled by each row's rms)" if rows else ""))
    return float(err.max())


def planted(faults: dict) -> list:
    """Each of ``faults`` ({name: a check of the kernel's output against
    its plain version on a deliberately wrong input}) must raise, or the
    check it plants into could not see that fault. Returns the names."""
    for name, check in faults.items():
        try:
            check()
        except AssertionError:
            continue
        raise AssertionError(f"a planted fault passed its check: {name}")
    return list(faults)


# -- phase 3: kernels --------------------------------------------------------

def kernel_expert_ffn(g):
    from repro_torch.kernels.expert_ffn import (expert_ffn_from_pool,
                                                expert_ffn_from_pool_plain)
    U, C, d, f, cap = 8, 256, 4096, 14336, 8
    dev = "cuda"
    x = torch.randn(U, C, d, generator=g, device=dev).to(torch.bfloat16)
    w1 = (torch.randn(cap, d, f, generator=g, device=dev) * d ** -0.5).to(torch.bfloat16)
    w3 = (torch.randn(cap, d, f, generator=g, device=dev) * d ** -0.5).to(torch.bfloat16)
    w2 = (torch.randn(cap, f, d, generator=g, device=dev) * f ** -0.5).to(torch.bfloat16)
    slots = torch.tensor([3, 0, 7, 1, 6, 2, 5, 4], dtype=torch.int32, device=dev)
    args = (x, w1, w3, w2, slots)
    err = max_err(expert_ffn_from_pool(*args), expert_ffn_from_pool_plain(*args))
    # a short group (C=24, one ragged row tile) out of a reversed slot order
    xs = x[:3, :24].contiguous()
    sl = slots.flip(0)[:3].contiguous()
    err = max(err, max_err(expert_ffn_from_pool(xs, w1, w3, w2, sl),
                           expert_ffn_from_pool_plain(xs, w1, w3, w2, sl)))
    ms = time_ms(lambda: expert_ffn_from_pool(*args))
    plain_ms = time_ms(lambda: expert_ffn_from_pool_plain(*args), reps=5)
    # yardstick, not one call of the same function: cuBLAS's three batched
    # products and silu * mul on slabs gathered beforehand (not timed)
    idx = slots.long()
    g1, g3, g2 = w1[idx], w3[idx], w2[idx]
    cublas = lambda: torch.bmm(torch.nn.functional.silu(torch.bmm(x, g1)) * torch.bmm(x, g3), g2)
    device_ms, cublas_device_ms = in_turns(lambda: expert_ffn_from_pool(*args), cublas,
                                           kernel_ms)
    n_bytes = 2 * (2 * U * C * d + 3 * U * d * f) + 4 * U
    bms, by = bound(n_bytes, 2 * 3 * U * C * d * f)
    del w1, w3, w2, g1, g3, g2
    return dict(name="expert_ffn_from_pool", route="cuda",
                source="src/repro_torch/csrc/expert_ffn.cu",
                replaces="src/repro/kernels/expert_ffn.py:64",
                shape=dict(U=U, C=C, d=d, f=f), max_abs_err=err, ms=ms,
                device_ms=device_ms, cublas_device_ms=cublas_device_ms,
                plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                bound_share=bms / device_ms, library_ms=None)


def device_vs_library(kernel, library, reps: int = 20):
    """Event-timed and profiler-timed medians of a kernel and its library
    call, each timed in turns (kernel, library, library, kernel), ``reps``
    calls a turn."""
    ms, library_ms = in_turns(kernel, library, lambda fn: event_ms(fn, reps))
    device_ms, library_device_ms = in_turns(kernel, library, lambda fn: kernel_ms(fn, reps))
    return dict(ms=ms, library_ms=library_ms, device_ms=device_ms,
                library_device_ms=library_device_ms,
                device_ratio=device_ms / library_device_ms)


def attention_bound(B, S, H, Hkv, D, window: int = -1):
    """Causal prefill: q, k, v read once and o written once (bf16); 4 D
    operations for each live (query, key) pair of each head: S (S + 1) / 2,
    or under a window w the min(q + 1, w) keys of each query q."""
    w = window if 0 < window < S else S
    pairs = w * (w + 1) // 2 + (S - w) * w
    return bound(2 * (2 * B * S * H * D + 2 * B * S * Hkv * D), 4 * B * H * D * pairs)


def kernel_flash_attention(g):
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    (q, k, v), main = flash_attention_shapes()["serve"].make(g)
    err = main["max_abs_err"]
    for s, causal, window in ((512, True, 128), (500, True, -1), (200, False, -1)):
        qs, ks, vs = q[:, :s], k[:, :s], v[:, :s]   # strided views, ragged S
        err = max(err, max_err(
            flash_attention(qs, ks, vs, causal=causal, window=window),
            flash_attention_plain(qs, ks, vs, causal=causal, window=window)))
    del q, k, v
    _, long = flash_attention_shapes()["long"].make(g)
    torch.cuda.empty_cache()
    return dict(name="flash_attention", route="cuda",
                source="src/repro_torch/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:96",
                long=long, **(main | dict(max_abs_err=err)))


class AttentionShape(NamedTuple):
    kernel: str      # the entry's record name: flash_attention, _cross or _chunk
    label: str
    make: Callable   # make(g) -> (inputs, record)


def flash_attention_shapes() -> dict[str, AttentionShape]:
    """Every ``flash_attention`` / ``_cross`` / ``_chunk`` shape a main path
    runs, by key: Mixtral-8x7B's serve prefill (S=512) and S=4096, Zamba2-7B's
    shared block (D=112) over a full window and at the families' 5120
    tokens, gemma3-1b (D=256), the two cross shapes, and the batch phase's
    chunk (C=512 from 1024 over W=2048) beside C=64 and C=512 from 3584
    over W=4096. The kernel and kernel_variant phases and
    ``--flash-attention`` share it."""
    from repro_torch.configs.base import get_config
    zamba, gemma = get_config("zamba2_7b"), get_config("gemma3_1b")
    vision, seamless = get_config("llama_3_2_vision_90b"), get_config("seamless_m4t_medium")
    zw, zh = zamba.sliding_window, (zamba.n_heads, zamba.n_kv_heads, zamba.hd)
    heads = lambda c: (c.n_heads, c.n_kv_heads, c.hd)
    fa, cross, chunk = "flash_attention", "flash_attention_cross", "flash_attention_chunk"
    shapes = {
        "serve": (fa, "causal, D=128, B=1, S=512, 32/8 (Mixtral-8x7B serve prefill)",
                  lambda g: prefill_attention(32, 8, 128, 512, g)),
        "long": (fa, "causal, D=128, B=1, S=4096, 32/8",
                 lambda g: prefill_attention(32, 8, 128, 4096, g)),
        "zamba": (fa, "D=112 (Zamba2-7B, S=4096)",
                  lambda g: prefill_attention(*zh, zw, g, window=zw)),
        "zamba_window": (fa, f"D=112 (Zamba2-7B, S={FAMILY_HYBRID_S}, window {zw})",
                         lambda g: prefill_attention(*zh, FAMILY_HYBRID_S, g, window=zw)),
        "gemma": (fa, "D=256 (gemma3-1b)",
                  lambda g: prefill_attention(*heads(gemma), BUNDLE_S, g, B=2)),
        "vision": (cross, "cross, Llama-3.2-Vision-90B",
                   lambda g: cross_attention(2, BUNDLE_S, vision.n_frontend_tokens,
                                             *heads(vision), g)),
        "seamless": (cross, "cross, SeamlessM4T-medium",
                     lambda g: cross_attention(2, BUNDLE_S, BUNDLE_S, *heads(seamless), g)),
        "chunk": (chunk, "C=512 from 1024 over W=2048, 32/8 (batch phase)",
                  lambda g: (None, chunk_attention(32, 8, 128, 2048, start=1024, C=512))),
        "c64": (chunk, "C=64 from 1024 over W=2048, 32/8",
                lambda g: (None, chunk_attention(32, 8, 128, 2048, start=1024, C=64, seed=1))),
        "chunk_long": (chunk, "C=512 from 3584 over W=4096, 32/8",
                       lambda g: (None, chunk_attention(32, 8, 128, 4096, start=3584, C=512,
                                                        seed=2))),
    }
    return {key: AttentionShape(*shape) for key, shape in shapes.items()}


def prefill_attention(H, Hkv, D, S, g, B: int = 1, lse: bool = False, window: int = -1,
                      reps: int = 20, plain_reps: int = 5):
    """Monolithic causal prefill attention of B S-token prompts (under
    ``window`` where > 0): held against the plain version (``rows``), a
    planted fault (the plain version under half the window, or of S where
    there is none) failing the same check, timed beside the plain version
    and beside SDPA held to its fused kernels (``fused_sdpa``; with the
    window's mask where it cuts). With ``lse`` the call returns the
    log-sum-exp too: ``o`` must be bit-equal to the call without it and the
    lse is held against the plain lse (TOL_F32). ``reps`` / ``plain_reps``:
    timed calls a turn / of the plain version. Returns the inputs and the
    record."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain
    mk = lambda h: torch.randn(B, S, h, D, generator=g, device="cuda").to(torch.bfloat16)
    q, k, v = mk(H), mk(Hkv), mk(Hkv)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    o = flash_attention(q, k, v, window=window)
    extra = {}
    if lse:
        o2, l2 = flash_attention(q, k, v, return_lse=True, window=window)
        if not torch.equal(o, o2):
            raise AssertionError("flash_attention: o moved with the lse output")
        po, plse = flash_attention_plain(q, k, v, return_lse=True, window=window)
        extra = dict(lse=True, o_bit_equal=True, lse_max_abs_err=max_err(l2, plse, TOL_F32))
    else:
        po = flash_attention_plain(q, k, v, window=window)
    err = max_err(o, po, rows=True)
    del po
    half = (window if 0 < window < S else S) // 2
    extra["planted"] = planted({f"window {half}": lambda: max_err(
        o, flash_attention_plain(q, k, v, window=half), rows=True)})
    del o
    if 0 < window < S:
        i = torch.arange(S, device="cuda")
        band = (i[None] <= i[:, None]) & (i[None] > i[:, None] - window)
        library = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=band,
                                                         enable_gqa=H != Hkv)
    else:
        library = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                         enable_gqa=True)
    timed = device_vs_library(
        lambda: flash_attention(q, k, v, return_lse=lse, window=window), fused_sdpa(library),
        reps)
    plain_ms = time_ms(lambda: flash_attention_plain(q, k, v, return_lse=lse, window=window),
                       reps=plain_reps, warmup=min(3, plain_reps))
    bms, by = attention_bound(B, S, H, Hkv, D, window)
    return (q, k, v), dict(shape=dict(B=B, S=S, H=H, Hkv=Hkv, D=D, window=window),
                           max_abs_err=err,
                           plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                           bound_share=bms / timed["device_ms"], **extra, **timed)


def kernel_flash_decode(g):
    import torch.nn.functional as F
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_decode import (flash_decode, flash_decode_plain,
                                                  n_splits)
    H, Hkv, D = 32, 8, 128
    dev = "cuda"
    r = lambda *s: torch.randn(s, generator=g, device=dev).to(torch.bfloat16)

    def shape(W):
        q, k, v = r(1, H, D), r(1, W, Hkv, D), r(1, W, Hkv, D)
        pos = torch.full((1,), W - 1, dtype=torch.int32, device=dev)
        sp = torch.arange(W, dtype=torch.int32, device=dev)[None]
        err = max_err(flash_decode(q, k, v, pos, sp), flash_decode_plain(q, k, v, pos, sp))
        mask = ((sp >= 0) & (sp <= pos[:, None]))[:, None, None, :]
        timed = device_vs_library(lambda: flash_decode(q, k, v, pos, sp),
                                  lambda: F.scaled_dot_product_attention(
                                      q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
                                      attn_mask=mask, enable_gqa=True))
        # q and o once, the valid slots' K and V rows once, pos and slot_pos
        n_valid = int(mask.sum())
        bms, by = bound(2 * (2 * H * D + 2 * n_valid * Hkv * D) + 4 * (W + 1),
                        4 * H * D * n_valid)
        return (q, k, v, pos, sp), dict(
            shape=dict(B=1, W=W, H=H, Hkv=Hkv, D=D, n_split=n_splits(Hkv, W)),
            max_abs_err=err, bound_ms=bms, bound_by=by,
            bound_share=bms / timed["device_ms"],
            parts=kernel_parts_ms(lambda: flash_decode(q, k, v, pos, sp)), **timed)

    (q, k, v, pos, sp), main = shape(545)
    W, err = 545, main["max_abs_err"]
    # two rows at different positions, empty slots, slots past pos, a window
    q2, k2, v2 = r(2, H, D), r(2, W, Hkv, D), r(2, W, Hkv, D)
    sp2 = torch.arange(W, dtype=torch.int32, device=dev).repeat(2, 1)
    sp2[0, 300:] = -1
    sp2[1, :40] = -1
    pos2 = torch.tensor([290, 520], dtype=torch.int32, device=dev)
    for window in (-1, 64):
        err = max(err, max_err(flash_decode(q2, k2, v2, pos2, sp2, window=window),
                               flash_decode_plain(q2, k2, v2, pos2, sp2, window=window)))
    plain_ms = time_ms(lambda: flash_decode_plain(q, k, v, pos, sp))
    _, long = shape(4096)
    # the batch phase's decode row (its kernel_checks hold it again there)
    batch = decode_attention(get_config("mixtral_8x7b"), 2048,
                             [n + BATCH_NEW - 1 for n in BATCH_LENS])
    return dict(name="flash_decode", route="cuda",
                source="src/repro_torch/csrc/flash_decode.cu",
                replaces="src/repro/kernels/flash_decode.py:80",
                plain_ms=plain_ms, long=long, batch=batch,
                **(main | dict(max_abs_err=max(err, batch["max_abs_err"]))))


def kernel_flash_attention_chunk(g):
    from repro_torch.kernels.flash_attention import (flash_attention_chunk,
                                                     flash_attention_chunk_plain)
    H, Hkv, D = 32, 8, 128
    # the batch phase's chunk: 512 queries after a 1024-token prefix
    shapes = flash_attention_shapes()
    _, main = shapes["chunk"].make(g)
    err = main["max_abs_err"]
    for start, C, W, h, hkv, d, window, holes, slot, B in CHUNK_CASES:
        q, k, v, sp = chunk_inputs(g, B, start, C, W, h, hkv, d, holes, slot)
        err = max(err, max_err(flash_attention_chunk(q, k, v, sp, start, window=window),
                               flash_attention_chunk_plain(q, k, v, sp, start, window=window)))
    _, short = shapes["c64"].make(g)
    _, long = shapes["chunk_long"].make(g)
    err = max(err, short["max_abs_err"], long["max_abs_err"])
    torch.cuda.empty_cache()
    return dict(name="flash_attention_chunk", route="cuda",
                source="src/repro_torch/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:96",
                shape=dict(B=1, C=512, start=1024, W=2048, H=H, Hkv=Hkv, D=D),
                c64=short, long=long, **(main | dict(max_abs_err=err)))


def ssd_inputs(g, B, S, H, G, P, N, dtype):
    """x ~ N(0,1), b, c ~ N(0,1)/2, dt = softplus(N(0,1))/2,
    da = -dt exp(N(0,1)/5): tests/test_kernels.py's distribution."""
    r = lambda *s, sc=1.0: (torch.randn(s, generator=g, device="cuda") * sc).to(dtype)
    x, b, c = r(B, S, H, P), r(B, S, G, N, sc=0.5), r(B, S, G, N, sc=0.5)
    dt = torch.nn.functional.softplus(torch.randn(B, S, H, generator=g, device="cuda")) * 0.5
    da = -dt * torch.exp(torch.randn(B, S, H, generator=g, device="cuda") * 0.2)
    return x, b, c, da, dt


def ssd_scan_work(B, S, H, G, P, N, in_bytes, chunk=256):
    """(bytes, chunked-form operations, recurrence operations) of a call.
    Bytes: inputs read once, y (f32) and the final state (f32) written
    once. Chunked form, the tensor cores' work at ``chunk``: per head and
    chunk of r rows the lower triangle of C B^T and its product with x
    (r (r + 1) / 2 (N + P) MACs), the chunk state B^T x (r N P) and the
    incoming-state term C h_in (r N P, none in the first chunk). The
    recurrence, one row per chunk, is the least f32 work that yields y and
    the state (per token and head C_t.B_t, its product with x_t, the state
    update and the incoming-state term), the bound while the kernel ran on
    the CUDA cores."""
    chunked = 0
    for s0 in range(0, S, chunk):
        r = min(chunk, S - s0)
        chunked += r * (r + 1) // 2 * (N + P) + r * N * P * (2 if s0 else 1)
    recurrence = S * (N + P) + S * N * P + (S - 1) * N * P
    n_bytes = (in_bytes * B * S * (H * P + 2 * G * N) + 4 * 2 * B * S * H
               + 4 * B * S * H * P + 4 * B * H * N * P)
    return n_bytes, 2 * B * H * chunked, 2 * B * H * recurrence


def ssd_scan_shape(g, S, H, G, P, N, B: int = 1, reps: int = 20):
    """``ssd_scan`` on B S-token bf16 prompts of H heads (f32 da / dt):
    held against the plain version (TOL_F32), timed by device time, by
    events and beside the plain version. Returns the inputs and the
    record."""
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain
    args = ssd_inputs(g, B, S, H, G, P, N, torch.bfloat16)
    (y, h), (y0, h0) = ssd_scan(*args), ssd_scan_plain(*args)
    err = max(max_err(y, y0, TOL_F32), max_err(h, h0, TOL_F32))
    del y, h, y0, h0
    n_bytes, chunked, recurrence = ssd_scan_work(B, S, H, G, P, N, 2)
    bms, by = bound(n_bytes, chunked)
    device_ms = float(np.median(kernel_ms(lambda: ssd_scan(*args), reps)))
    return args, dict(shape=dict(B=B, S=S, H=H, G=G, P=P, N=N, chunk=256),
                      max_abs_err=err, device_ms=device_ms, bound_ms=bms,
                      ms=time_ms(lambda: ssd_scan(*args), reps),
                      plain_ms=time_ms(lambda: ssd_scan_plain(*args), reps),
                      bound_by=by, bound_share=bms / device_ms,
                      bound_f32_recurrence_ms=bound(n_bytes, recurrence,
                                                    PEAK_F32_OPS_PER_S)[0])


def kernel_ssd_scan(g):
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain
    # Mamba2-2.7B's prefill of a 2048-token prompt: bf16 x/b/c, f32 da/dt
    H, G, P, N = 80, 1, 64, 128
    shape = lambda S: ssd_scan_shape(g, S, H, G, P, N)
    _, main = shape(2048)
    err = main["max_abs_err"]
    # a ragged S, two rows, two groups, f32 inputs
    for case in ((1, 1000, H, G, P, N, torch.bfloat16),
                 (2, 700, 8, 2, P, N, torch.bfloat16),
                 (2, 300, 8, 1, P, N, torch.float32)):
        a = ssd_inputs(g, *case)
        (y, h), (y0, h0) = ssd_scan(*a), ssd_scan_plain(*a)
        err = max(err, max_err(y, y0, TOL_F32), max_err(h, h0, TOL_F32))
    _, long = shape(8192)
    return dict(name="ssd_scan", route="cuda",
                source="src/repro_torch/csrc/ssd_scan.cu",
                replaces="src/repro/kernels/ssd_scan.py:81", tol=TOL_F32,
                library_ms=None, long=long, **(main | dict(max_abs_err=err)))


# -- phase 4: engine on the card vs the same engine on the CPU ---------------

def small_moe(seed: int):
    """Reduced Mixtral with the kernels' widths (head_dim 64, GQA G = 4) on
    the card, and the same weights on the CPU."""
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.models.params import init_params
    cfg = dataclasses.replace(reduced(get_config("mixtral_8x7b")),
                              head_dim=64, n_kv_heads=1)
    gpu = init_params(cfg, seed, device="cuda")
    return cfg, gpu, to_cpu(gpu)


def to_cpu(tree):
    """A param tree's tensors on the CPU (host slabs stay the same tensors)."""
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    return tree.cpu()


def check_small(seed: int):
    from repro_torch.serving.engine import MoEServingEngine
    cfg, gpu, cpu = small_moe(seed)
    prompt = np.random.default_rng(seed).integers(0, cfg.vocab, 40).astype(np.int32)
    out = {}
    for name, p in (("cuda", gpu), ("cpu", cpu)):
        eng = MoEServingEngine(cfg, p, policy="lfp", temperature=0.0)
        logits = eng.prefill_layers(prompt[None])[0]
        out[name] = (logits.cpu(), eng.serve(prompt, max_new=8).tokens)
    (lg_g, tok_g), (lg_c, tok_c) = out["cuda"], out["cpu"]
    real = slice(0, cfg.vocab)
    err = float((lg_g[0, real] - lg_c[0, real]).abs().max())
    # bf16 activations through two layers: a few bf16 ulps of O(1) logits
    if not (torch.isfinite(lg_g).all() and err < 5e-2):
        raise AssertionError(f"card vs CPU prefill logits differ by {err}")
    res = dict(phase="check", prefill_logit_max_abs_err=err, tol=5e-2,
               tokens_cuda=tok_g.tolist(), tokens_cpu=tok_c.tolist(),
               tokens_equal=bool(np.array_equal(tok_g, tok_c)))
    if not res["tokens_equal"]:
        # greedy ties: the CPU's top-2 margin where the two first part
        i = int(np.argmax(tok_g != tok_c))
        seq = np.concatenate([prompt, tok_c[:i].astype(np.int32)])[None]
        lg = MoEServingEngine(cfg, cpu, policy="lfp").prefill_layers(seq)[0]
        top = torch.topk(lg[0, real], 2).values
        res.update(first_divergence=i, cpu_top2_margin=float(top[0] - top[1]))
    return res


# -- phase 5: serve Mixtral-8x7B -----------------------------------------------

def mixtral_setup(layers: int, seed: int):
    """Mixtral-8x7B at full width, ``layers`` deep, random weights from
    ``seed``; ODF traces over 3 prompts of 512 tokens (32 new each) and the
    ExpertMLP trained on them. Returns ((cfg, params, stats, predictor),
    the 7 prompts, a record of the set-up's times and the predictor's
    validation accuracy)."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.predictor import train_predictor
    from repro_torch.core.state import StateConstructor
    from repro_torch.models.params import init_params
    from repro_torch.serving.engine import collect_traces

    cfg = dataclasses.replace(get_config("mixtral_8x7b"), n_layers=layers)
    t0 = time.perf_counter()
    params = init_params(cfg, seed, device="cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab, 512).astype(np.int32) for _ in range(7)]

    t0 = time.perf_counter()
    tracer, _ = collect_traces(cfg, params, prompts[:3], max_new=32)
    stats = tracer.stats()
    X, Y = StateConstructor(stats).build_dataset(tracer.as_array())
    pred, hist = train_predictor(seed, X, Y, cfg.top_k, epochs=20, batch=64,
                                 device="cuda")
    setup = dict(init_s=t_init, traces_and_training_s=time.perf_counter() - t0,
                 predictor_val_topk=hist["val_topk"][-1],
                 predictor_val_half=hist["val_half"][-1])
    return (cfg, params, stats, pred), prompts, setup


def serve(layers: int, seed: int, kernels):
    from repro_torch.serving.api import SamplingParams
    from repro_torch.serving.engine import MoEServingEngine

    (cfg, params, stats, pred), prompts, setup = mixtral_setup(layers, seed)
    engine = MoEServingEngine(cfg, params, policy="duo", stats=stats,
                              predictor=pred, temperature=0.0)
    sp = SamplingParams(temperature=0.0, max_new_tokens=32)
    gc.collect()   # the trace engine's reference cycles hold its expert pool
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels:
        fn.launches = 0
    reqs, copies = [], []
    for p in prompts[3:]:
        n0 = len(engine.cache.transfer_log)
        reqs.append(engine.serve(p, params=sp))
        copies.append(len(engine.cache.transfer_log) - n0)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in kernels}
    peak = torch.cuda.max_memory_allocated()

    # the host->device rate of one expert slab (3 x 112 MiB, pinned) on the
    # residency's copy stream: what every fetch and prefetch pays
    slabs = engine.store.get((0, 0))
    dst = [torch.empty_like(w, device="cuda") for w in slabs]
    copy_ms = time_ms(lambda: [d.copy_(w, non_blocking=True)
                               for d, w in zip(dst, slabs)], reps=5)
    del dst

    for r in reqs:
        if r.tokens.shape != (33,) or not ((r.tokens >= 0) & (r.tokens < cfg.vocab)).all():
            raise AssertionError(f"bad tokens {r.tokens}")
        if r.decode_trace.shape != (32, layers, cfg.top_k):
            raise AssertionError(f"bad decode trace shape {r.decode_trace.shape}")
    logits = engine.prefill_layers(prompts[3][None])[0]
    if logits.shape != (1, cfg.vocab) or not torch.isfinite(logits).all():
        raise AssertionError("prefill logits not finite / wrong shape")
    if not engine.cache.hbm_bound_ok:
        raise AssertionError("expert pool grew past its capacity")
    missing = [n for n, c in launches.items() if c == 0]
    if missing:
        raise AssertionError(f"kernels never launched while serving: {missing}")
    return (dict(
        phase="serve", model="mixtral-8x7b", layers=layers,
        widths=dict(d_model=cfg.d_model, n_heads=cfg.n_heads,
                    n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
                    n_experts=cfg.n_experts, top_k=cfg.top_k,
                    d_expert=cfg.d_expert, vocab=cfg.vocab),
        **setup,
        cache_capacity=engine.cache.capacity,
        expert_pool_bytes=engine.cache.device_bytes,
        ttft_s=[r.ttft_wall for r in reqs], e2e_s=[r.e2e_wall for r in reqs],
        decode_tok_per_s=[32 / (r.e2e_wall - r.ttft_wall) for r in reqs],
        hits=[r.hits for r in reqs], misses=[r.misses for r in reqs],
        expert_copies=copies,
        max_memory_allocated=peak, hbm_bound_ok=engine.cache.hbm_bound_ok,
        expert_copy_ms=copy_ms,
        expert_copy_gb_per_s=engine.store.bytes_per_expert / copy_ms / 1e6,
        host_ram_bytes=os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES"),
        launches=launches), (cfg, params, stats, pred))


# -- phase 8b: the static and device analysis of the port -------------------------

def plant_out_of_place(cache, key):
    """A prefetch that writes a copy of each pool (the fault ``donation``
    must catch)."""
    slot = cache.slot_of[key]
    for name, src in zip(("w1", "w3", "w2"), cache.store.get(key)):
        cache._pools[name] = cache._pools[name].clone()
        cache._pools[name][slot].copy_(src)
    cache._loaded.add(key)
    return False


def plant_unbucketed(ids, union, bucket_cap, u_bucket_cap=None):
    """A grouped dispatch that pads nothing: one launch shape per (U, C)
    the selections give (the fault ``compile-keys`` must catch)."""
    from repro_torch.serving.engine import group_by_expert
    d = group_by_expert(ids, union, bucket_cap=1 << 30)
    C = max(d.counts)
    return dataclasses.replace(d, row_idx=d.row_idx[:len(union), :C])


def audit_engine(mixtral, seed: int):
    """The analysis phase's engine: ``BatchedServingEngine`` over the batch
    phase's params and predictor (``duo``, ``max_batch=8``,
    ``max_seq=2048``, budget 512), and its 8 prompts of 64-512 tokens.
    Returns (build, prompts)."""
    from repro_torch.serving.batching import BatchedServingEngine
    cfg, params, stats, pred = mixtral
    rng = np.random.default_rng(seed + 8)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in (64, 96, 128, 192, 256, 320, 384, 512)]

    def build():
        return BatchedServingEngine(cfg, params, policy="duo", stats=stats, predictor=pred,
                                    max_batch=8, max_seq=2048, prefill_budget=512,
                                    temperature=0.0)

    return build, prompts


# decode steps of the audit's engine timed, after the warm ones, then profiled
DECODE_WARM, DECODE_TIMED, DECODE_PROFILED = 4, 16, 4


def decode_steps(eng) -> dict:
    """Batched decode steps of ``eng`` at its full batch, every request
    decoding: DECODE_WARM steps, then the host-clock wall of DECODE_TIMED
    (the engine's own ``decode_step_wall``, from a step's start to its
    logits on the host), then a ``torch.profiler`` window over
    DECODE_PROFILED more: the device's busy share of the window (``busy_ms``
    of its device events over the window's host-clock length, the
    profiler's own cost in it) and the CUDA runtime calls made in it, per
    step. A steady step must call no ``cudaHostAlloc``: the upload helper's
    pinned blocks come back from the caching host allocator."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(DECODE_WARM):
        eng.step()
    n0 = len(eng.decode_step_wall)
    for _ in range(DECODE_TIMED):
        eng.step()
    walls = np.array(eng.decode_step_wall[n0:]) * 1e3
    batches = set(eng.decode_batch_hist[n0:])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(DECODE_PROFILED):
            eng.step()
        torch.cuda.synchronize()
        window = (time.perf_counter() - t0) * 1e3
    if batches != {eng.max_batch} or set(eng.decode_batch_hist[-DECODE_PROFILED:]) != batches:
        raise AssertionError(f"decode steps: batch sizes {sorted(batches)}, "
                             f"not {eng.max_batch} throughout")
    busy = busy_ms([e for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA])
    runtime = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CPU and e.name.startswith("cuda"):
            runtime[e.name] = runtime.get(e.name, 0) + 1
    per_step = {k: v / DECODE_PROFILED for k, v in sorted(runtime.items())}
    return dict(batch=eng.max_batch, step_ms_median=float(np.median(walls)),
                step_ms=walls.tolist(), profiled_steps=DECODE_PROFILED,
                window_ms=window, device_busy_ms=busy, busy_share=busy / window,
                host_allocs=sum(v for k, v in runtime.items()
                                if "HostAlloc" in k or "HostRegister" in k),
                runtime_calls_per_step=per_step)


def analyse(mixtral, seed: int):
    """Phase 8b: ``python -m repro_torch.analysis``'s lint of the port's
    sources (no finding, no stale allowlist entry), then the device audit
    (``device_audit.run_audit``) of the batched engine at Mixtral-8x7B width
    on the batch phase's params and predictor (``audit_engine``): every
    request of 8 prompts of 64-512 tokens decoding, then one batched decode
    step under the sync debug mode (``callback``: each sync's call site,
    which must be a dispatch point the allowlist declares: one gate
    readback a layer, the predictor's readback, the logits readback, a
    correction fetch's wait), the bytes held outside the residency ledger
    (``const``), in-place pool writes over 6 prefetches (``donation``) and
    the grouped FFN's launch shapes (``compile-keys``). All four must find
    nothing, and the step must show at least its gate and logits
    readbacks. Then the same audit with a planted fault per check (a
    ``.item()`` inside the step, twice ``CONST_BYTES_LIMIT`` kept beside
    the ledger, an out-of-place pool write, an unbucketed dispatch): each
    check must catch its own. Then ``decode_steps`` on a fresh engine: the
    B=8 step's wall, the device's busy share, the runtime calls a step
    makes."""
    from repro_torch.analysis import ALL_RULES, load_allowlist, run_lint
    from repro_torch.analysis.device_audit import (CONST_BYTES_LIMIT, decoding_engine,
                                                   run_audit)
    cfg = mixtral[0]
    root = ROOT / "src" / "repro_torch"
    lint = run_lint(root, ALL_RULES, load_allowlist(root / "analysis" / "allowlist.toml"))
    if lint.findings or lint.unused_allows:
        raise AssertionError("lint: " + "; ".join(f.format() for f in lint.findings))
    build, prompts = audit_engine(mixtral, seed)
    params = mixtral[1]

    t0 = time.perf_counter()
    clean = run_audit(build=build, given=params, prompts=prompts)
    release()
    probe = torch.ones(1, device="cuda")
    planted = run_audit(build=build, given=params, prompts=prompts, extra={
        "callback": [lambda: probe.item()],
        "const": [lambda eng: setattr(eng, "_stray", torch.zeros(
            2 * CONST_BYTES_LIMIT, dtype=torch.uint8, device="cuda"))],
        "donation": plant_out_of_place, "compile-keys": plant_unbucketed})
    release()
    count = lambda rep, rule: sum(f.rule == rule for f in rep.findings)
    caught = {c: count(planted, c) > count(clean, c) for c in clean.checks}
    # the planted sync's own site: this file
    caught["callback"] = any(f.rule == "callback" and "chip_smoke.py" in f.where
                             for f in planted.findings)
    eng = decoding_engine(build(), prompts)
    steps = decode_steps(eng)
    del eng
    release()
    syncs = clean.readings["callback"]["syncs"]
    res = dict(phase="analysis", model=cfg.name, layers=cfg.n_layers,
               lint=dict(files=len(lint.scanned), findings=0,
                         allowlisted=len(lint.suppressed)),
               checks=clean.checks, readings=clean.readings,
               findings=[f.format() for f in clean.findings],
               planted_caught=caught, decode_steps=steps,
               seconds=time.perf_counter() - t0)
    if sorted(clean.checks) != sorted(("callback", "const", "donation", "compile-keys")):
        raise AssertionError(f"analysis: the audit ran {clean.checks}")
    if clean.findings or not all(res["planted_caught"].values()) or syncs < cfg.n_layers + 1:
        emit(res)
        raise AssertionError("analysis: a device audit check failed, missed its planted "
                             f"fault, or saw {syncs} syncs (fewer than the gate and "
                             "logits readbacks)")
    if steps["host_allocs"]:
        emit(res)
        raise AssertionError(f"analysis: {steps['host_allocs']} cudaHostAlloc calls in "
                             f"{DECODE_PROFILED} steady decode steps")
    return res


# -- phase 8c: the examples --------------------------------------------------

# published widths, depth cut: Mixtral-8x7B as the serve phase (each layer
# holds 2.6 GiB of pinned host expert weights), Qwen2-MoE-A2.7B as train;
# serve_cluster keeps 12 engines alive, each with its own expert pool (duo+
# holds 20 slabs of 336 MiB at 4 layers: 79 GB in all, past the card), so
# it runs at 2 layers (14 slabs an engine), as the others do since the mesh
# phase took in every family (4 before: the script's limit did not grow)
EXAMPLE_LAYERS = dict(quickstart=2, serve_e2e=2, serve_concurrent=2, serve_cluster=2,
                      train_moe=2, preprocess_pipeline=2)
# the examples' own request and step counts, cut for time (each cut printed)
EXAMPLE_CUTS = {"serve_e2e": ("--requests", "2"), "train_moe": ("--steps", "3")}


def example_readings(name: str, rec: dict) -> dict:
    """What each example's record says, in a line: tokens, hits and misses,
    simulator results, walls, sheds, handoffs, losses, artifacts."""
    if name == "quickstart":
        return dict(tokens=rec["tokens"], hits=rec["hits"], misses=rec["misses"],
                    ttft_wall_s=rec["ttft_wall"], e2e_wall_s=rec["e2e_wall"],
                    sim_edge_gpu={p: dict(ttft=v["ttft"], e2e=v["e2e"], hit_rate=v["hit_rate"])
                                  for p, v in rec["sims"].items()})
    if name == "serve_e2e":
        return {p: dict(tokens_first=v["tokens"][0], hits=sum(v["hits"]),
                        misses=sum(v["misses"]), wall_ttft_s=v["wall_ttft_s"],
                        wall_e2e_s=v["wall_e2e_s"], sim_p50_e2e=v["summary"]["p50_e2e"])
                for p, v in rec.items()}
    if name == "serve_concurrent":
        return dict(match_sequential=[s["match_sequential"] for s in rec["streams"]],
                    sequential_wall_s=rec["sequential_wall_s"],
                    streamed_wall_s=rec["streamed_wall_s"],
                    mean_decode_batch=rec["mean_decode_batch"], cancel=rec["cancel"],
                    shed=rec["shed"])
    if name == "serve_cluster":
        return dict(balance=rec["cluster"]["balance"], wall_s=rec["cluster"]["wall_s"],
                    one_replica_parity=rec["one_replica_parity"],
                    handoffs=rec["disagg"]["n_handoffs"],
                    handoff_bytes=rec["disagg"]["handoff_bytes"],
                    trace_events=rec["disagg"].get("trace_events"),
                    migrated=rec["drain"]["n_migrated"],
                    prefix_hit_tokens=rec["prefix"]["hit_tokens"])
    if name == "train_moe":
        return dict(n_params=rec["n_params"], loss=rec["loss"], grad_norm=rec["grad_norm"],
                    step_wall_s=rec["wall_s"])
    return dict(paths=int(rec["paths"].shape[0]), entropy=np.asarray(rec["entropy"]).tolist(),
                val_topk=rec["history"]["val_topk"][-1],
                val_half=rec["history"]["val_half"][-1],
                file_bytes={k: os.path.getsize(v) for k, v in rec["files"].items()})


def run_examples(kernels):
    """Phase 8c: each port example's ``main`` in this process, on the card
    at published widths cut to its EXAMPLE_LAYERS: Mixtral-8x7B for
    quickstart, serve_e2e, serve_concurrent --smoke and serve_cluster
    --smoke (with a Perfetto trace), Qwen2-MoE-A2.7B for train_moe and
    preprocess_pipeline (into a temporary directory, whose artifacts are
    loaded back), with the counts of EXAMPLE_CUTS. Each example holds its
    own assertions (it raises); here every loss must be finite and every
    kernel of the set launched. One line per example: its wall, launches,
    readings and the last lines it printed."""
    import io
    import tempfile
    from repro_torch.core.tracer import TraceStats
    from repro_torch.examples import (preprocess_pipeline, quickstart, serve_cluster,
                                      serve_concurrent, serve_e2e, train_moe)
    from repro_torch.training import checkpoint
    for fn in kernels:
        fn.launches = 0
    runs = []
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="examples-", dir=ROOT / "build") as tmp:
        examples = [
            ("quickstart", quickstart, []),
            ("serve_e2e", serve_e2e, []),
            ("serve_concurrent", serve_concurrent, ["--smoke"]),
            ("serve_cluster", serve_cluster, ["--smoke", "--trace-out", f"{tmp}/trace.json"]),
            ("train_moe", train_moe, ["--ckpt", f"{tmp}/train.npz"]),
            ("preprocess_pipeline", preprocess_pipeline, ["--out", f"{tmp}/preprocess"]),
        ]
        for name, mod, argv in examples:
            argv = ["--device", "cuda", "--layers", str(EXAMPLE_LAYERS[name]), *argv,
                    *EXAMPLE_CUTS.get(name, ())]
            before = {fn.__name__: fn.launches for fn in kernels}
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rec = mod.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if name == "train_moe" and not np.isfinite(rec["loss"]).all():
                raise AssertionError(f"train_moe: losses {rec['loss']}")
            if name == "preprocess_pipeline":
                TraceStats.load(rec["files"]["trace_stats"])
                checkpoint.load(rec["files"]["predictor"])
            line = dict(phase="example", example=name, argv=argv,
                        cut=list(EXAMPLE_CUTS.get(name, ())), wall_s=wall,
                        launches={n: fn.launches - before[n] for n, fn in
                                  ((fn.__name__, fn) for fn in kernels)},
                        readings=example_readings(name, rec),
                        last_lines=out.getvalue().splitlines()[-3:])
            emit(line)
            runs.append(line)
            del rec
            release()
    launches = {fn.__name__: fn.launches for fn in kernels}
    missing = [n for n, c in launches.items() if c == 0]
    if missing:
        raise AssertionError(f"kernels never launched by the examples: {missing}")
    return dict(phase="examples", layers=EXAMPLE_LAYERS,
                walls_s={r["example"]: r["wall_s"] for r in runs},
                seconds=sum(r["wall_s"] for r in runs), launches=launches)


# -- phase 6: the batched engine on the card vs on the CPU ---------------------

def run_batched(cfg, params, prompts, new_tokens: int, **kw):
    """Serve ``prompts`` through one BatchedServingEngine, all submitted
    before the first step; returns ({rid: tokens}, {rid: [logits rows]}),
    every row the engine sampled from (the real vocabulary's columns)."""
    from repro_torch.serving.batching import BatchedServingEngine
    eng = BatchedServingEngine(cfg, params, temperature=0.0, **kw)
    rows = {}
    sample = eng._sample_req

    def record(req, row):
        rows.setdefault(req.rid, []).append(row[: cfg.vocab])
        return sample(req, row)

    eng._sample_req = record
    for p in prompts:
        eng.submit(p, max_new=new_tokens)
    eng.run_until_drained()
    if not eng.cache.hbm_bound_ok:
        raise AssertionError("expert pool grew past its capacity")
    return {r.rid: list(r.tokens) for r in eng.finished}, rows


def first_divergence(a, b):
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)


def rows_diff(rows_a, rows_b, toks_a, toks_b) -> float:
    """Max abs logit difference over the rows two runs share a prefix for
    (every row up to and including the first position where they part)."""
    err = 0.0
    for rid, ra in rows_a.items():
        i = first_divergence(toks_a[rid], toks_b[rid])
        n = len(ra) if i is None else i + 1
        err = max(err, max(float(np.abs(x - y).max())
                           for x, y in zip(ra[:n], rows_b[rid][:n])))
    return err


@contextlib.contextmanager
def cpu_attention(q_scale: float = 1.0):
    """The CPU engine's attention in the card kernels' arithmetic: every
    call of the reference ``layers.attention`` runs as ``flash_decode_plain``
    with the queries folded into its batch (unnormalised p rounded to bf16,
    divided by the f32 sum: the arithmetic of ``flash_attention_plain`` and
    ``flash_attention_chunk_plain`` too, so one emulation serves monolithic
    prefill, chunked prefill and decode, which pass per-row positions).
    ``q_scale`` != 1 scales the queries: a softmax-scale fault, the control
    that shows the comparison can fail."""
    from repro_torch.kernels.flash_decode import flash_decode_plain
    from repro_torch.models import layers

    def attention(q, k, v, *, q_pos, k_pos, window=None, causal=True, scale=None):
        if not causal or scale is not None:
            raise NotImplementedError("the engines call causal attention only")
        B, Sq, H, D = q.shape
        q_pos, k_pos = q_pos.expand(B, Sq), k_pos.expand(B, k.shape[1])
        fold = lambda t: t[:, None].expand(B, Sq, *t.shape[1:]).reshape(B * Sq, *t.shape[1:])
        o = flash_decode_plain((q * q_scale).reshape(B * Sq, H, D), fold(k), fold(v),
                               q_pos.reshape(-1), fold(k_pos),
                               window=-1 if window is None else int(window))
        return o.reshape(B, Sq, H, D)

    reference = layers.attention
    layers.attention = attention
    try:
        yield
    finally:
        layers.attention = reference


def first_rows_diff(rows_a, rows_b) -> float:
    return max(float(np.abs(rows_a[r][0] - rows_b[r][0]).max()) for r in rows_a)


def check_batch_small(seed: int):
    cfg, gpu, cpu = small_moe(seed)
    rng = np.random.default_rng(seed + 1)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in (12, 40, 23, 31)]
    kw = dict(policy="lfp", max_batch=4, max_seq=64)
    res = dict(phase="batch_check", layers=cfg.n_layers, head_dim=cfg.hd,
               prompt_lens=[len(p) for p in prompts], new_tokens=8, tol=BATCH_CHECK_TOL)
    card = {}
    for mode, budget in (("chunked", 8), ("monolithic", None)):
        run = lambda params: run_batched(cfg, params, prompts, 8, prefill_budget=budget, **kw)
        tok_g, rows_g = card[mode] = run(gpu)
        tok_r, rows_r = run(cpu)                    # the reference attention
        with cpu_attention():
            tok_c, rows_c = run(cpu)                # the kernels' arithmetic
        with cpu_attention(q_scale=1.01):
            tok_f, rows_f = run(cpu)                # a 1% softmax-scale fault
        err, control = first_rows_diff(rows_g, rows_c), first_rows_diff(rows_f, rows_c)
        finite = all(np.isfinite(x).all() for rs in rows_g.values() for x in rs)
        if not (finite and err < BATCH_CHECK_TOL < control):
            raise AssertionError(f"{mode}: card vs CPU first-token logits differ by {err}, "
                                 f"the control by {control}, limit {BATCH_CHECK_TOL}")
        parts = {}
        for rid in tok_g:
            i = first_divergence(tok_g[rid], tok_c[rid])
            if i is not None:
                top = np.sort(rows_c[rid][i])[-2:]
                parts[rid] = dict(first_divergence=i, cpu_top2_margin=float(top[1] - top[0]))
        res[mode] = dict(
            first_token_logit_max_abs_err=err,
            control_q_scale_1pct=control,
            vs_cpu_reference_attention=first_rows_diff(rows_g, rows_r),
            cpu_reference_vs_kernel_arithmetic=first_rows_diff(rows_r, rows_c),
            first_token_logit_max_abs=max(float(np.abs(r[0]).max()) for r in rows_c.values()),
            tokens_cuda=[tok_g[r] for r in sorted(tok_g)],
            tokens_cpu=[tok_c[r] for r in sorted(tok_c)],
            tokens_equal=tok_g == tok_c, tokens_equal_cpu_reference=tok_g == tok_r,
            divergences=parts)
    # the same 4 requests one by one through an engine with one slot
    tok_b, rows_b = card["monolithic"]
    tok_1, rows_1 = run_batched(cfg, gpu, prompts, 8, prefill_budget=None,
                                **(kw | dict(max_batch=1)))
    res["batch_invariant"] = dict(max_abs_logit_diff=rows_diff(rows_b, rows_1, tok_b, tok_1),
                                  tokens_equal=tok_b == tok_1)
    tok_ch, rows_ch = card["chunked"]
    res["chunked_vs_monolithic"] = dict(
        first_token_max_abs_logit_diff=first_rows_diff(rows_ch, rows_b),
        tokens_equal=tok_ch == tok_b)
    return res


# -- phase 7: the batched engine at Mixtral-8x7B width ---------------------------

# the batch phase's prompt lengths and new tokens per request
BATCH_LENS, BATCH_NEW = (128, 256, 384, 512, 512, 768, 1024, 1536), 32

def serve_batch(mixtral, seed: int, kernels):
    from repro_torch.kernels.flash_attention import flash_attention_chunk as chunk_kernel
    from repro_torch.serving.batching import BatchedServingEngine
    cfg, params, stats, pred = mixtral
    rng = np.random.default_rng(seed + 2)
    lens, new_tokens = BATCH_LENS, BATCH_NEW
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in lens]
    # the phase's kernel shapes held against their plain versions, before
    # its engines run (these launches are not the path's)
    with uncounted(kernels):
        checks = dict(chunk_attention=chunk_attention(cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                                                      2048, start=1024, C=512),
                      decode_attention=decode_attention(
                          cfg, 2048, [n + new_tokens - 1 for n in lens]),
                      decode_expert_ffn=decode_expert_ffn(cfg))
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels:
        fn.launches = 0

    def engine(profile_at=None, **kw):
        """The engine, with hooks that check every sampled logits row and
        keep it by request id, count each decode step's expert copies and
        gather reads, and profile three decode steps of batch
        ``profile_at``."""
        from torch.profiler import ProfilerActivity, profile
        eng = BatchedServingEngine(cfg, params, policy="duo", stats=stats,
                                   predictor=pred, max_seq=2048, temperature=0.0, **kw)
        finite, rows = [], {}
        sample, decode = eng._sample_req, eng._decode_step
        steps = []    # (batch size, expert copies, rows read through a gather)
        prof = dict(n=0)

        def record(req, row):
            finite.append(bool(np.isfinite(row).all()))
            rows.setdefault(req.rid, []).append(row)
            return sample(req, row)

        def counted(batch):
            n0 = len(eng.cache.transfer_log)
            idx = np.array([r.slot for r in batch])
            window = len(batch) == profile_at and prof["n"] < 3
            if window and prof["n"] == 0:
                torch.cuda.synchronize()
                prof["p"] = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                prof["p"].start()
                prof["t0"] = time.perf_counter()
            decode(batch)
            if window:
                prof["n"] += 1
                if prof["n"] == 3:
                    torch.cuda.synchronize()
                    prof["wall"] = time.perf_counter() - prof["t0"]
                    prof["p"].stop()
            steps.append((len(batch), len(eng.cache.transfer_log) - n0,
                          not np.array_equal(idx, np.arange(idx[0], idx[0] + idx.size))))

        eng._sample_req, eng._decode_step = record, counted
        return eng, finite, steps, rows, prof

    def drive(eng):
        """The chunked workload: requests 1-4 before the first step, 5-8
        after step 4; returns (wall seconds, results)."""
        t0 = time.perf_counter()
        reqs = [eng.submit(p, max_new=new_tokens) for p in prompts[:4]]
        for _ in range(4):
            eng.step()
        reqs += [eng.submit(p, max_new=new_tokens) for p in prompts[4:]]
        eng.run_until_drained()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, [r.result() for r in reqs]

    eng, finite, steps, rows, prof = engine(profile_at=8, max_batch=8, prefill_budget=512,
                                            prefill_fairness="rr")
    wall, results = drive(eng)
    # what the cluster phase holds its runs against: each prompt's tokens
    # and logits rows from this run (rids follow the prompts' order)
    reference = dict(prompts=prompts, new_tokens=new_tokens,
                     tokens=[list(r.tokens) for r in results],
                     rows=[rows[rid] for rid in range(len(prompts))])
    rows0 = rows[0]
    walls = np.array(eng.decode_step_wall)
    hist = np.array(eng.decode_batch_hist)
    copies = np.array([c for _, c, _ in steps])
    n_decoded = sum(len(r.tokens) - 1 for r in results)
    chunked = dict(
        prompt_lens=list(lens), new_tokens=new_tokens, wall_s=wall,
        ttft_s=[r.ttft_wall for r in results], e2e_s=[r.e2e_wall for r in results],
        decode_tok_per_s=n_decoded / float(walls.sum()),
        tok_per_s_wall=sum(len(r.tokens) for r in results) / wall,
        decode_steps=len(walls), decode_batch_hist=hist.tolist(),
        decode_step_ms_median_by_batch={int(b): float(np.median(walls[hist == b]) * 1e3)
                                        for b in np.unique(hist)},
        expert_copies_per_decode_step=dict(median=float(np.median(copies)),
                                           max=int(copies.max()), total=int(copies.sum())),
        expert_copies_total=len(eng.cache.transfer_log),
        hits=eng.cache.hits, misses=eng.cache.misses,
        cache_capacity=eng.cache.capacity,
        perf={f: getattr(eng.perf, f) for f in (
            "decode_rows_dense", "decode_rows_grouped", "decode_rows_launched",
            "decode_ffn_launches", "decode_layers", "prefill_ffn_launches",
            "prefill_moe_layers")},
        decode_steps_with_kv_gather=sum(g for _, _, g in steps),
        hbm_bound_ok=eng.cache.hbm_bound_ok,
        profile_3_steps_at_batch_8=device_profile(prof))
    ok = all(finite) and eng.cache.hbm_bound_ok
    tokens_ok = all(len(r.tokens) == new_tokens + 1
                    and all(0 <= t < cfg.vocab for t in r.tokens) for r in results)
    # one layer's KV rows of 8 requests gathered out of order: what a
    # decode step pays per layer when the batch's slots are not consecutive
    jidx = torch.arange(7, -1, -1, device="cuda")
    K, V = eng._K[0], eng._V[0]
    gather_ms = time_ms(lambda: (K[jidx], V[jidx]))
    gather_bytes = 2 * K[jidx].nbytes
    del eng, K, V
    gc.collect()
    torch.cuda.empty_cache()

    # the chunk kernel end to end: the chunked run again (uncounted), its
    # chunk attention through the kernel and through the folded route it
    # replaced, in turns in one process (host clock: the spread of two
    # calls is wider than the difference)
    from repro_torch.models import layers
    route_ab = {}
    with uncounted(kernels):
        for route in ("folded", "kernel", "kernel", "folded"):
            e = engine(max_batch=8, prefill_budget=512, prefill_fairness="rr")[0]
            layers.flash_attention_chunk = folded_chunk if route == "folded" else chunk_kernel
            try:
                w, res = drive(e)
            finally:
                layers.flash_attention_chunk = chunk_kernel
            ws, hs = np.array(e.decode_step_wall), np.array(e.decode_batch_hist)
            route_ab.setdefault(route, []).append(dict(
                wall_s=w, ttft_s=[r.ttft_wall for r in res],
                decode_step_ms_median_at_8=float(np.median(ws[hs == 8]) * 1e3)))
            del e
            gc.collect()
            torch.cuda.empty_cache()

    # the row-invariant products end to end: the chunked run again
    # (uncounted), its dense products and router through layers.linear and
    # through the plain product, in turns
    row_linear = layers.linear
    linear_ab = {}
    with uncounted(kernels):
        for how in ("plain", "linear", "linear", "plain"):
            e = engine(max_batch=8, prefill_budget=512, prefill_fairness="rr")[0]
            layers.linear = (lambda x, w: x @ w) if how == "plain" else row_linear
            try:
                w, res = drive(e)
            finally:
                layers.linear = row_linear
            ws, hs = np.array(e.decode_step_wall), np.array(e.decode_batch_hist)
            linear_ab.setdefault(how, []).append(dict(
                wall_s=w, ttft_s=[r.ttft_wall for r in res],
                decode_step_ms_median_at_8=float(np.median(ws[hs == 8]) * 1e3),
                tokens_equal=[list(r.tokens) for r in res] == reference["tokens"]))
            del e
            gc.collect()
            torch.cuda.empty_cache()

    # request 0 again, alone in an engine with one slot and room for every
    # expert: the same prefill chunks, decode at B=1 instead of B<=8
    alone, finite_1, _, rows1, _ = engine(max_batch=1, prefill_budget=512,
                                          cache_capacity=cfg.n_layers * cfg.n_experts)
    rows1 = rows1.setdefault(0, [])
    req1 = alone.submit(prompts[0], max_new=new_tokens)
    alone.run_until_drained()
    tok0, tok1 = list(results[0].tokens), list(req1.tokens)
    i = first_divergence(tok0, tok1)
    n = len(rows0) if i is None else i + 1
    invariant = dict(request=0, tokens_equal=tok0 == tok1, first_divergence=i,
                     max_abs_logit_diff=max(float(np.abs(a - b).max())
                                            for a, b in zip(rows0[:n], rows1[:n])),
                     first_token_max_abs_logit_diff=float(np.abs(rows0[0] - rows1[0]).max()))
    ok = ok and all(finite_1) and alone.cache.hbm_bound_ok
    del alone
    gc.collect()
    torch.cuda.empty_cache()

    # monolithic: flash_attention prefill under the batched engine
    mono, finite_m, steps_m, _, _ = engine(max_batch=4, prefill_budget=None)
    t0 = time.perf_counter()
    mreqs = [mono.submit(p, max_new=new_tokens)
             for p in rng.integers(0, cfg.vocab, (4, 512)).astype(np.int32)]
    mono.run_until_drained()
    torch.cuda.synchronize()
    mwall = time.perf_counter() - t0
    mres = [r.result() for r in mreqs]
    mwalls, mhist = np.array(mono.decode_step_wall), np.array(mono.decode_batch_hist)
    mcopies = np.array([c for _, c, _ in steps_m])
    monolithic = dict(
        prompt_lens=[512] * 4, wall_s=mwall,
        ttft_s=[r.ttft_wall for r in mres], e2e_s=[r.e2e_wall for r in mres],
        decode_tok_per_s=sum(len(r.tokens) - 1 for r in mres) / float(mwalls.sum()),
        decode_step_ms_median_by_batch={int(b): float(np.median(mwalls[mhist == b]) * 1e3)
                                        for b in np.unique(mhist)},
        expert_copies_per_decode_step=dict(median=float(np.median(mcopies)),
                                           max=int(mcopies.max()), total=int(mcopies.sum())),
        expert_copies_total=len(mono.cache.transfer_log),
        cache_capacity=mono.cache.capacity,
        hits=mono.cache.hits, misses=mono.cache.misses,
        hbm_bound_ok=mono.cache.hbm_bound_ok)
    ok = ok and all(finite_m) and mono.cache.hbm_bound_ok
    tokens_ok = tokens_ok and all(len(r.tokens) == new_tokens + 1
                                  and all(0 <= t < cfg.vocab for t in r.tokens)
                                  for r in mres)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in kernels}
    peak = torch.cuda.max_memory_allocated()
    del mono
    if not ok:
        raise AssertionError("batch: non-finite logits or the expert pool grew")
    if not tokens_ok:
        raise AssertionError("batch: a request's tokens are out of range or short")
    missing = [n for n, c in launches.items() if c == 0]
    if missing:
        raise AssertionError(f"kernels never launched by the batched engine: {missing}")
    return dict(phase="batch", model="mixtral-8x7b", layers=cfg.n_layers,
                chunked=chunked, chunk_route_ab=route_ab, linear_ab=linear_ab,
                monolithic=monolithic,
                batch_invariant=invariant,
                kv_gather_ms_per_layer=gather_ms, kv_gather_bytes_per_layer=gather_bytes,
                kernel_checks=checks, max_memory_allocated=peak,
                launches=launches), reference


# -- phase 8: replicas behind the cluster frontend at Mixtral-8x7B width ---------

def timed_copies(res):
    """Time every expert copy the residency ``res`` issues: CUDA events on
    its copy stream around each ``prefetch`` that copies (the copy is the
    last work queued there, so end - start is its duration, with any wait
    for the slot's last use). Returns the list the event pairs land in."""
    pairs = []
    prefetch = res.prefetch

    def timed(key):
        if key not in res.slot_of or key in res._loaded:
            return prefetch(key)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record(res._copy_stream)
        out = prefetch(key)
        end.record(res._copy_stream)
        pairs.append((start, end))
        return out

    res.prefetch = timed
    return pairs


def row_drift(params) -> dict:
    """How far a row's product moves with the rows beside it: the max abs
    difference of rows [0, m) computed alone against among 1536 rows, m in
    1, 8, 64, 100, 512, for the plain product and for ``layers.linear``
    (which must not move), on layer 0's ``wk`` (bf16) and router (f32)."""
    from repro_torch.models.layers import linear
    g = torch.Generator(device="cuda").manual_seed(1)
    out = {}
    for name, w in (("wk", params["layers"]["attn"]["wk"][0]),
                    ("router", params["layers"]["moe"]["router"][0])):
        x = torch.randn(1536, w.shape[0], generator=g, device="cuda").to(w.dtype)
        for how, fn in (("plain", torch.mm), ("linear", linear)):
            full = fn(x, w)
            out[f"{name}_{how}"] = max(float((fn(x[:m], w) - full[:m]).abs().max())
                                       for m in (1, 8, 64, 100, 512))
    return out


def top2_margin(row) -> float:
    top = np.sort(np.asarray(row, np.float64))[-2:]
    return float(top[1] - top[0])


def serve_cluster(mixtral, reference, kernels):
    """Run A: one prefill and one decode replica behind ``disagg``; run B:
    two replicas behind ``least_loaded``, replica 0 drained mid-decode. Both
    on the batch phase's prompts, held against its first chunked run."""
    import tempfile
    from repro_torch.obs import validate_metrics_snapshot, validate_trace, write_trace
    from repro_torch.serving import ClusterFrontend, ReplicaPool, SamplingParams, TokenEvent
    from repro_torch.serving.batching import kv_row_bytes
    cfg, params, stats, pred = mixtral
    prompts, new_tokens = reference["prompts"], reference["new_tokens"]
    sp = SamplingParams(temperature=0.0, max_new_tokens=new_tokens)
    moe = params["layers"]["moe"]
    t_phase = time.perf_counter()
    drift = row_drift(params)
    if drift["wk_linear"] or drift["router_linear"]:
        raise AssertionError(f"layers.linear rows depend on the row count: {drift}")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels:
        fn.launches = 0

    def build(**kw):
        """The pool, with every sampled logits row kept by prompt and every
        replica's expert copies timed."""
        pool = ReplicaPool.build(cfg, params, policy="duo", stats=stats, predictor=pred,
                                 max_batch=8, max_seq=2048, temperature=0.0, **kw)
        rows = {}
        for eng in pool.engines:
            def record(req, row, sample=eng._sample_req):
                rows.setdefault(req.prompt.tobytes(), []).append(row)
                return sample(req, row)
            eng._sample_req = record
        return pool, rows, [timed_copies(eng.cache) for eng in pool.engines]

    def shares_slabs(pool) -> bool:
        names = ("w1", "w3", "w2")
        return all(moe[n].is_pinned() for n in names) and all(
            eng.store.get((l, e))[i].data_ptr() == moe[n][l, e].data_ptr()
            for eng in pool.engines for l in range(cfg.n_layers)
            for e in range(cfg.n_experts) for i, n in enumerate(names))

    def check_tokens(run, handles, rows):
        for i, h in enumerate(handles):
            got, want = list(h.tokens), reference["tokens"][i]
            if got == want:
                continue
            j = first_divergence(got, want)
            j = min(len(got), len(want)) if j is None else j
            mine = rows[prompts[i].tobytes()]
            print(json.dumps(dict(
                phase="cluster", run=run, request=i, first_divergence=j,
                batch_top2_margin=top2_margin(reference["rows"][i][j]),
                cluster_top2_margin=top2_margin(mine[j]),
                max_abs_logit_diff=float(np.abs(mine[j] - reference["rows"][i][j]).max()))),
                flush=True)
            raise AssertionError(f"cluster run {run}: request {i}'s tokens part from "
                                 f"the batch phase's at index {j}")

    def run_report(pool, handles, copies, wall):
        torch.cuda.synchronize()
        results = [h.result() for h in handles]
        if any(h.status != "done" for h in handles):
            raise AssertionError(f"a request ended {[h.status for h in handles]}")
        hops = []
        for h in handles:
            for hop in h.handoffs:
                t_tok = next(ev.t for ev in h.events
                             if isinstance(ev, TokenEvent) and ev.t > hop["t_snapshot"])
                hops.append(dict(src=hop["src"], dst=hop["dst"],
                                 restore_ms=(hop["t_restore"] - hop["t_snapshot"]) * 1e3,
                                 handoff_ms=(t_tok - hop["t_snapshot"]) * 1e3))
        ms = [[s.elapsed_time(e) for s, e in pairs] for pairs in copies]
        return dict(
            wall_s=wall, ttft_s=[r.ttft_wall for r in results],
            e2e_s=[r.e2e_wall for r in results], replica=[h.replica for h in handles],
            hops=hops, handoff_bytes=pool.handoff_bytes,
            kv_row_bytes=kv_row_bytes(pool.engines[0]),
            handoff_mb_per_s=(pool.handoff_bytes / 1e6
                              / max(sum(x["restore_ms"] for x in hops) / 1e3, 1e-9)
                              if hops else None),
            replicas=[dict(role=eng.role, expert_copies=len(eng.cache.transfer_log),
                           copy_ms_per_slab_median=float(np.median(m)) if m else None,
                           copy_ms_per_slab_max=max(m) if m else None,
                           finished=len(eng.finished),
                           decode_steps=len(eng.decode_batch_hist),
                           expert_pool_bytes=eng.cache.device_bytes,
                           kv_pool_bytes=2 * sum(k.nbytes for k in eng._K),
                           hbm_bound_ok=eng.cache.hbm_bound_ok)
                      for eng, m in zip(pool.engines, ms)],
            max_memory_allocated=torch.cuda.max_memory_allocated(),
            launches={fn.__name__: fn.launches for fn in kernels})

    # run A: prefill -> decode handoff of every request
    pool, rows, copies = build(prefill_budget=512, prefill_fairness="rr",
                               overrides=[{"role": "prefill"}, {"role": "decode"}])
    fe = ClusterFrontend(pool, router="disagg")
    t0 = time.perf_counter()
    handles = [fe.submit(p, params=sp) for p in prompts[:4]]
    for _ in range(4):
        fe.poll()
    handles += [fe.submit(p, params=sp) for p in prompts[4:]]
    fe.drain()
    torch.cuda.synchronize()
    disagg = run_report(pool, handles, copies, time.perf_counter() - t0)
    disagg.update(n_handoffs=pool.n_handoffs, shares_host_slabs=shares_slabs(pool))
    check_tokens("disagg", handles, rows)
    ok = disagg["shares_host_slabs"] and pool.n_handoffs == len(prompts) and all(
        r["hbm_bound_ok"] for r in disagg["replicas"])
    if not ok:
        raise AssertionError(f"cluster run disagg: {disagg}")
    del pool, fe, handles, rows, copies
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # run B: replica 0 drained mid-decode, monolithic prefill, spans on
    pool, rows, copies = build(n_replicas=2, prefill_budget=None, spans=True)
    fe = ClusterFrontend(pool, router="least_loaded")
    t0 = time.perf_counter()
    handles = [fe.submit(p, params=sp) for p in prompts]
    for _ in range(6):
        fe.poll()
    moved_at_drain = pool.drain(0)
    fe.drain()
    torch.cuda.synchronize()
    drain = run_report(pool, handles, copies, time.perf_counter() - t0)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "cluster_trace.json")
        write_trace(path, pool.recorders())
        with open(path) as f:
            trace = json.load(f)
    flows = [e["ph"] for e in trace["traceEvents"] if e["ph"] in ("s", "f")]
    drain.update(n_migrated=pool.n_migrated, moved_at_drain=moved_at_drain,
                 n_tail_handoffs=pool.n_tail_handoffs,
                 shares_host_slabs=shares_slabs(pool),
                 trace_events=len(trace["traceEvents"]),
                 trace_errors=validate_trace(trace),
                 flow_pairs=min(flows.count("s"), flows.count("f")),
                 metrics_errors=validate_metrics_snapshot(pool.metrics_snapshot()))
    check_tokens("drain", handles, rows)
    ok = (drain["shares_host_slabs"] and pool.n_migrated > 0
          and not drain["trace_errors"] and not drain["metrics_errors"]
          and flows.count("s") == flows.count("f") == pool.n_migrated
          and all(r["hbm_bound_ok"] for r in drain["replicas"]))
    if not ok:
        raise AssertionError(f"cluster run drain: {drain}")
    del pool, fe, handles, rows, copies
    gc.collect()
    torch.cuda.empty_cache()
    launches = {fn.__name__: fn.launches for fn in kernels}
    missing = [n for n, c in launches.items() if c == 0]
    if missing:
        raise AssertionError(f"kernels never launched by the cluster: {missing}")
    return dict(phase="cluster", model="mixtral-8x7b", layers=cfg.n_layers,
                max_seq=2048, prompt_lens=[len(p) for p in prompts], new_tokens=new_tokens,
                tokens_equal_batch_phase=True, row_drift=drift, disagg=disagg, drain=drain,
                seconds=time.perf_counter() - t_phase, launches=launches)


@contextlib.contextmanager
def uncounted(kernels):
    """Launches inside the block do not count as the main path's."""
    saved = [fn.launches for fn in kernels]
    try:
        yield
    finally:
        for fn, n in zip(kernels, saved):
            fn.launches = n


def decode_bound(H, Hkv, D, n_valid, n_rows, W):
    """q and o once, the valid slots' K and V rows once, pos and slot_pos."""
    return bound(2 * (2 * n_rows * H * D + 2 * n_valid * Hkv * D) + 4 * n_rows * (W + 1),
                 4 * H * D * n_valid)


def chunk_inputs(g, B, start, C, W, H, Hkv, D, holes=False, pool_slot=0):
    """q [B,C,H,D] at positions start.., and k, v [B,W,Hkv,D] and slot_pos
    [B,W] as views of a pool of pool_slot + B rows at row ``pool_slot``
    (as the batched engine passes a request's row): slot j holds j up to
    the chunk's last position, -1 past it, and with ``holes`` -1 at every
    seventh slot of the prefix."""
    r = lambda *s: torch.randn(s, generator=g, device="cuda").to(torch.bfloat16)
    n = pool_slot + B
    pool_k, pool_v = r(n, W, Hkv, D), r(n, W, Hkv, D)
    j = torch.arange(W, device="cuda")
    sp = torch.where(j < start + C, j, -1)
    if holes:
        sp = torch.where((j < start) & (j % 7 == 3), -1, sp)
    rows = slice(pool_slot, n)
    return r(B, C, H, D), pool_k[rows], pool_v[rows], sp.to(torch.int32).repeat(n, 1)[rows]


# start, C, W, H, Hkv, D, window, holes, pool slot, B: starts 37 / 300, C
# 1-200, a window, D = 64, G = 1 / 4 / 8, -1 holes, pool views (W = 642:
# slot_pos rows not 16-byte aligned), B = 2 (tests/test_torch_cuda.py's grid)
CHUNK_CASES = (
    (37, 1, 640, 32, 8, 128, -1, False, 0, 1),
    (37, 17, 640, 32, 8, 128, -1, True, 0, 1),
    (300, 64, 640, 32, 8, 128, -1, False, 0, 1),
    (300, 200, 640, 32, 8, 128, 256, False, 0, 1),
    (37, 200, 640, 16, 4, 64, -1, True, 0, 1),
    (300, 17, 640, 8, 8, 128, 256, True, 0, 1),
    (300, 64, 640, 32, 4, 128, -1, False, 0, 1),
    (300, 200, 640, 32, 8, 128, -1, True, 3, 1),
    (300, 17, 642, 32, 8, 64, 256, True, 3, 1),
    (37, 100, 640, 8, 2, 128, 64, True, 0, 2),
)


def folded_chunk(q, k, v, slot_pos, q_start: int, *, window: int = -1):
    """The chunked-prefill route ``flash_attention_chunk`` replaced: one
    request's C queries folded into ``flash_decode``'s batch, its cache
    row and slot positions read through a batch stride of 0 (B = 1)."""
    from repro_torch.kernels.flash_decode import flash_decode
    C, W = q.shape[1], k.shape[1]
    pos = q_start + torch.arange(C, dtype=torch.int32, device=q.device)
    return flash_decode(q[0], k.expand(C, -1, -1, -1), v.expand(C, -1, -1, -1), pos,
                        slot_pos.expand(C, W), window=window)[None]


def chunk_attention(H, Hkv, D, W: int, start: int, C: int, seed: int = 0):
    """Chunked-prefill attention as the batched engine runs it on the card
    (``flash_attention_chunk`` over one request's pool row, a view of a
    pool at slot 3) for C queries from ``start``: held against the plain
    version on the same views, timed beside it, beside SDPA with the same
    mask (``library_device_ms``) and beside the route it replaces, the C
    queries folded into ``flash_decode``'s batch over the row through a
    batch stride of 0 (``folded_device_ms``)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention_chunk,
                                                     flash_attention_chunk_plain)
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, sp = chunk_inputs(g, 1, start, C, W, H, Hkv, D, pool_slot=3)
    args = (q, k, v, sp, start)
    err = max_err(flash_attention_chunk(*args), flash_attention_chunk_plain(*args))
    pos = start + torch.arange(C, dtype=torch.int32, device="cuda")
    ok = (sp >= 0) & (sp <= pos[:, None])           # [C, W]
    timed = device_vs_library(lambda: flash_attention_chunk(*args),
                              lambda: F.scaled_dot_product_attention(
                                  q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                  attn_mask=ok[None, None], enable_gqa=True))
    chunk_ms, folded_device_ms = in_turns(lambda: flash_attention_chunk(*args),
                                          lambda: folded_chunk(*args), kernel_ms)
    plain_ms = time_ms(lambda: flash_attention_chunk_plain(*args), reps=5)
    # q and o once, the valid slots' K and V rows once, slot_pos; 4 D
    # operations for each valid (query, key) pair of each head
    n_keys, n_pairs = int((sp >= 0).sum()), int(ok.sum())
    bms, by = bound(2 * (2 * C * H * D + 2 * n_keys * Hkv * D) + 4 * W, 4 * H * D * n_pairs)
    return dict(C=C, start=start, W=W, H=H, Hkv=Hkv, D=D, max_abs_err=err,
                plain_ms=plain_ms, folded_device_ms=folded_device_ms,
                folded_ratio=folded_device_ms / chunk_ms, bound_ms=bms, bound_by=by,
                bound_share=bms / timed["device_ms"], **timed)


def decode_faults(out, q, k, v, pos, sp, window: int = -1) -> list:
    """``planted`` faults of a ``flash_decode`` output: the plain version
    with the slots of every other one of the call's ranges marked empty (a
    combine that drops half its ranges) and, under a window, with every
    ``slot_pos`` one tile older."""
    from repro_torch.kernels.flash_decode import TILE_SLOTS, flash_decode_plain, n_splits
    W = sp.shape[-1]
    T, n = -(-W // TILE_SLOTS), n_splits(k.shape[2], W)
    tile = torch.arange(W, device=sp.device) // TILE_SLOTS
    starts = torch.arange(n, device=sp.device) * T // n
    odd = ((torch.searchsorted(starts, tile, right=True) - 1) if n > 1 else tile) % 2 == 1
    check = lambda s: lambda: max_err(
        out, flash_decode_plain(q, k, v, pos, s, window=window), rows=True)
    name = f"every other of {n} ranges empty" if n > 1 else f"every other of {T} tiles empty"
    faults = {name: check(torch.where(odd, -1, sp))}
    if window > 0:
        faults[f"slot_pos one tile ({TILE_SLOTS} slots) older"] = check(
            torch.where(sp >= 0, sp - TILE_SLOTS, sp))
    return planted(faults)


def decode_attention(cfg, W: int, pos, reps: int = 20):
    """Batched decode attention at B=8 over pool rows gathered out of slot
    order (as the engine gathers them), row b at position ``pos[b]``: held
    against the plain version (``rows``), ``decode_faults`` failing the
    same check, timed beside it and beside SDPA."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_decode import flash_decode, flash_decode_plain
    B = len(pos)
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    g = torch.Generator(device="cuda").manual_seed(1)
    r = lambda *s: torch.randn(s, generator=g, device="cuda").to(torch.bfloat16)
    q, pool_k, pool_v = r(B, H, D), r(B, W, Hkv, D), r(B, W, Hkv, D)
    jidx = torch.arange(B - 1, -1, -1, device="cuda")
    k, v = pool_k[jidx], pool_v[jidx]
    pos = torch.tensor(pos, dtype=torch.int32, device="cuda")
    slots = torch.arange(W, dtype=torch.int32, device="cuda")[None]
    sp = torch.where(slots <= pos[:, None], slots, -1).to(torch.int32)
    args = (q, k, v, pos, sp)
    out = flash_decode(*args)
    err = max_err(out, flash_decode_plain(*args), rows=True)
    faults = decode_faults(out, *args)
    del out
    mask = ((sp >= 0) & (sp <= pos[:, None]))[:, None, None, :]
    timed = device_vs_library(lambda: flash_decode(*args),
                              lambda: F.scaled_dot_product_attention(
                                  q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
                                  attn_mask=mask, enable_gqa=True), reps)
    plain_ms = time_ms(lambda: flash_decode_plain(*args), reps=5)
    bms, by = decode_bound(H, Hkv, D, int(mask.sum()), B, W)
    return dict(B=B, W=W, H=H, Hkv=Hkv, D=D, pos=pos.tolist(), max_abs_err=err,
                planted=faults, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                bound_share=bms / timed["device_ms"],
                parts=kernel_parts_ms(lambda: flash_decode(*args)), **timed)


def decode_expert_ffn(cfg):
    """The grouped decode sweep's launch at B=8: U=8 experts of C=8 bucketed
    rows out of pools of 8 slabs."""
    return expert_ffn_check(8, 8, cfg.d_model, cfg.d_expert, [3, 0, 7, 1, 6, 2, 5, 4])


def expert_ffn_check(U, C, d, f, slots=None, pool: bool = True, reps: int = 20,
                     plain_reps: int = 5):
    """One ``expert_ffn_from_pool`` launch of U groups of C rows, read by
    slot (``slots``, or a random order) out of pools of U slabs, or with
    ``pool`` False one ``expert_ffn`` launch (the capacity buffer's entry:
    group e on slab e): held against the plain version and timed beside it
    and the cuBLAS yardstick of the kernel phase. The slabs are drawn in
    bf16 (Kimi-K2's 384 would take 68 GB as f32 draws)."""
    from repro_torch.kernels import expert_ffn as K
    g = torch.Generator(device="cuda").manual_seed(2)
    r = lambda *s: torch.empty(s, dtype=torch.bfloat16, device="cuda").normal_(generator=g)
    x = r(U, C, d)
    w1 = r(U, d, f).mul_(d ** -0.5)
    w3 = r(U, d, f).mul_(d ** -0.5)
    w2 = r(U, f, d).mul_(f ** -0.5)
    if pool:
        slots = (torch.randperm(U, generator=g, device="cuda") if slots is None
                 else torch.tensor(slots, device="cuda")).to(torch.int32)
        args, fn, plain = (x, w1, w3, w2, slots), K.expert_ffn_from_pool, \
            K.expert_ffn_from_pool_plain
        idx = slots.long()
        g1, g3, g2 = w1[idx], w3[idx], w2[idx]
    else:
        args, fn, plain = (x, w1, w3, w2), K.expert_ffn, K.expert_ffn_plain
        g1, g3, g2 = w1, w3, w2
    err = max_err(fn(*args), plain(*args))
    ms = time_ms(lambda: fn(*args), reps)
    plain_ms = time_ms(lambda: plain(*args), reps=plain_reps, warmup=min(3, plain_reps))
    cublas = lambda: torch.bmm(torch.nn.functional.silu(torch.bmm(x, g1)) * torch.bmm(x, g3), g2)
    device_ms, cublas_device_ms = in_turns(lambda: fn(*args), cublas,
                                           lambda fn_: kernel_ms(fn_, reps))
    bms, by = bound(2 * (2 * U * C * d + 3 * U * d * f) + 4 * U * pool, 2 * 3 * U * C * d * f)
    return dict(U=U, C=C, d=d, f=f, slots=slots.tolist() if pool else None,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, device_ms=device_ms,
                cublas_device_ms=cublas_device_ms, bound_ms=bms, bound_by=by,
                bound_share=bms / device_ms)


def device_profile(prof):
    """Device busy time and the top kernels of a profiled window, beside
    its host-clock length (the profiler's own cost is in that wall)."""
    if "p" not in prof:
        return None
    ev = [e for e in prof["p"].events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {}
    for e in ev:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy = busy_ms(ev)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return dict(wall_ms=prof["wall"] * 1e3, device_busy_ms=busy,
                busy_share=busy / (prof["wall"] * 1e3),
                top_kernels_ms=[[n[:80], t] for n, t in top])


# -- phase 9: the ssm bundle on the card vs on the CPU -------------------------

def small_ssm_cfg():
    """Reduced Mamba2 at the kernel's widths: 8 heads of 64, state 128."""
    from repro_torch.configs.base import get_config, reduced
    return dataclasses.replace(reduced(get_config("mamba2_2_7b")),
                               ssm_head_dim=64, ssm_state=128)


def check_small_ssm(seed: int):
    from repro_torch.models.model import build
    cfg = small_ssm_cfg()
    bundle = build(cfg)
    gpu = bundle.init(seed, device="cuda")
    cpu = {"embed": gpu["embed"].cpu(), "ln_f": gpu["ln_f"].cpu(),
           "layers": {"ln": gpu["layers"]["ln"].cpu(),
                      "ssm": {k: v.cpu() for k, v in gpu["layers"]["ssm"].items()}}}
    # 300 tokens: two chunks, the second ragged
    toks = torch.from_numpy(np.random.default_rng(seed).integers(0, cfg.vocab, (1, 300)))
    lg_g, _ = bundle.prefill(gpu, {"tokens": toks.cuda()})
    lg_c, _ = bundle.prefill(cpu, {"tokens": toks})
    real = slice(0, cfg.vocab)
    err = float((lg_g.cpu()[0, real].float() - lg_c[0, real].float()).abs().max())
    # bf16 activations through two layers: a few bf16 ulps of O(1) logits
    if not (torch.isfinite(lg_g).all() and err < 5e-2):
        raise AssertionError(f"ssm card vs CPU prefill logits differ by {err}")
    return dict(phase="ssm_check", layers=cfg.n_layers, d_model=cfg.d_model,
                head_dim=cfg.ssm_head_dim, state=cfg.ssm_state, vocab=cfg.vocab,
                prompt=300, prefill_logit_max_abs_err=err, tol=5e-2)


# -- phase 10: Mamba2-2.7B through the model bundle ------------------------------

def serve_ssm(seed: int, ssd_scan):
    from repro_torch.configs.base import get_config
    from repro_torch.models.model import build, greedy_token

    cfg = get_config("mamba2_2_7b")
    bundle = build(cfg)
    held_before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = bundle.init(seed, device="cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    leaves = [params["embed"], params["ln_f"], params["layers"]["ln"],
              *params["layers"]["ssm"].values()]
    n_params = sum(t.numel() for t in leaves)
    param_bytes = sum(t.numel() * t.element_size() for t in leaves)
    prompts = np.random.default_rng(seed).integers(0, cfg.vocab, (4, 2048))
    new_tokens = 32

    def request(prompt):
        toks = torch.from_numpy(prompt[None]).cuda()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last, cache = bundle.prefill(params, {"tokens": toks})
        tok = greedy_token(last, cfg.vocab)
        out, finite = [tok], torch.isfinite(last).all()
        torch.cuda.synchronize()
        ttft = time.perf_counter() - t0
        for _ in range(new_tokens):
            lg, cache = bundle.decode_step(params, {"token": tok}, cache)
            tok = greedy_token(lg, cfg.vocab)
            out.append(tok)
            finite &= torch.isfinite(lg).all()
        torch.cuda.synchronize()
        return ttft, time.perf_counter() - t0, torch.cat(out, 1)[0].cpu(), bool(finite)

    request(prompts[0][:300])   # warm-up: allocator, cuBLAS handles
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ssd_scan.launches = 0
    runs = [request(p) for p in prompts]
    launches = ssd_scan.launches
    peak = torch.cuda.max_memory_allocated()
    for _, _, toks, finite in runs:
        if toks.shape != (new_tokens + 1,) or not ((toks >= 0) & (toks < cfg.vocab)).all():
            raise AssertionError(f"bad tokens {toks}")
        if not finite:
            raise AssertionError("ssm logits not finite")
    if launches == 0:
        raise AssertionError("ssd_scan never launched while serving Mamba2")
    # a witness for the hybrid's decode-vs-forward limit: the gap of a pure
    # Mamba stack over one prompt, and with its decode conv summed in the
    # forward's order
    batch = model_batch(cfg, 1, prompts.shape[1], seed, "cuda")
    with torch.no_grad():
        at = bundle.forward(params, batch)[0][:, -DECODE_STEPS - 1:].float().cpu()
        err, low, pairs, _ = decode_vs_forward(bundle, params, batch, at)
        with conv_in_forward_order():
            conv = decode_vs_forward(bundle, params, batch, at)[0]
    gap = dict(max_abs_err=err, control=low, pairs=pairs, conv_in_forward_order=conv)
    return dict(
        phase="ssm", model="mamba2-2.7b", layers=cfg.n_layers,
        widths=dict(d_model=cfg.d_model, d_inner=cfg.ssm_expand * cfg.d_model,
                    heads=cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim,
                    head_dim=cfg.ssm_head_dim, state=cfg.ssm_state,
                    groups=cfg.ssm_groups, conv=cfg.ssm_conv, vocab=cfg.vocab),
        n_params=n_params, param_bytes=param_bytes, init_s=t_init,
        prompt_tokens=prompts.shape[1], new_tokens=new_tokens,
        ttft_s=[r[0] for r in runs], e2e_s=[r[1] for r in runs],
        decode_tok_per_s=[new_tokens / (r[1] - r[0]) for r in runs],
        tokens_head=[r[2][:8].tolist() for r in runs],
        memory_allocated_before_init=held_before, max_memory_allocated=peak,
        launches={"ssd_scan": launches},
        decode_vs_forward=gap,
        profile=profile_ssm(bundle, params, prompts[0], cfg.vocab))


def profile_ssm(bundle, params, prompt, vocab: int):
    """Device time by kernel name over one prefill and over 8 decode steps
    (``torch.profiler``, CUDA activity), against the host-clock window."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models.model import greedy_token
    toks = torch.from_numpy(prompt[None]).cuda()
    out = {}
    for name in ("prefill", "decode"):
        last, cache = bundle.prefill(params, {"tokens": toks})
        tok = greedy_token(last, vocab)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            if name == "prefill":
                bundle.prefill(params, {"tokens": toks})
            else:
                for _ in range(8):
                    lg, cache = bundle.decode_step(params, {"token": tok}, cache)
                    tok = greedy_token(lg, vocab)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        by_name = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
        busy = sum(by_name.values())
        scan = sum(t for n, t in by_name.items() if any(k in n for k in SSD_SCAN_KERNELS))
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        out[name] = dict(wall_ms=wall * 1e3, device_busy_ms=busy if by_name else None,
                         busy_share=busy / (wall * 1e3) if by_name else None,
                         ssd_scan_ms=scan, ssd_scan_share=scan / busy if by_name else None,
                         top_kernels_ms=[[n[:80], t] for n, t in top])
    return out


# -- phase 11: the paper's models, small, on the card vs on the CPU ------------

def check_paper_small(seed: int):
    """Trace-scale Qwen3-30B-A3B (top-8 of 128 experts, ``qk_norm``) and
    DeepSeekMoE-16B (top-6 of 64, a shared expert), 2 layers, head_dim 64
    (``trace_scale``'s 32 is outside the kernels), GQA G = 2: served by the
    same engine on the card and on the CPU (plain versions). Prefill logits
    must agree within 5e-2 (the check phase's limit), greedy tokens must be
    equal."""
    from repro_torch.configs.paper_models import DEEPSEEKMOE_16B, QWEN3_30B_A3B, trace_scale
    from repro_torch.models.params import init_params
    from repro_torch.serving.engine import MoEServingEngine
    res = dict(phase="paper_check", tol=5e-2)
    for base in (QWEN3_30B_A3B, DEEPSEEKMOE_16B):
        cfg = dataclasses.replace(trace_scale(base), head_dim=64, n_layers=2)
        gpu = init_params(cfg, seed, device="cuda")
        cpu = to_cpu(gpu)
        prompt = np.random.default_rng(seed).integers(0, cfg.vocab, 40).astype(np.int32)
        out = {}
        for name, p in (("cuda", gpu), ("cpu", cpu)):
            eng = MoEServingEngine(cfg, p, policy="lfp", temperature=0.0)
            logits = eng.prefill_layers(prompt[None])[0]
            out[name] = (logits.cpu(), eng.serve(prompt, max_new=8).tokens)
        (lg_g, tok_g), (lg_c, tok_c) = out["cuda"], out["cpu"]
        err = float((lg_g[0, :cfg.vocab] - lg_c[0, :cfg.vocab]).abs().max())
        r = dict(layers=cfg.n_layers, head_dim=cfg.hd, n_heads=cfg.n_heads,
                 n_kv_heads=cfg.n_kv_heads, n_experts=cfg.n_experts, top_k=cfg.top_k,
                 n_shared_experts=cfg.n_shared_experts, qk_norm=cfg.qk_norm,
                 prefill_logit_max_abs_err=err, tokens_cuda=tok_g.tolist(),
                 tokens_cpu=tok_c.tolist())
        res[base.name] = r
        if not (torch.isfinite(lg_g).all() and err < 5e-2 and np.array_equal(tok_g, tok_c)):
            i = first_divergence(tok_g.tolist(), tok_c.tolist())
            if i is not None:
                seq = np.concatenate([prompt, tok_c[:i].astype(np.int32)])[None]
                lg = MoEServingEngine(cfg, cpu, policy="lfp").prefill_layers(seq)[0]
                r.update(first_divergence=i, cpu_top2_margin=top2_margin(lg[0, :cfg.vocab]))
            emit(res)
            raise AssertionError(f"paper_check {base.name}: card vs CPU logits differ by "
                                 f"{err} or tokens part")
        del gpu, cpu, out
    gc.collect()
    torch.cuda.empty_cache()
    return res


# -- phase 12: the paper's Table I models at their published widths -------------

# (model, layers, max_seq): DeepSeekMoE-16B at 2 of 28 layers, Qwen3-30B-A3B
# at 2 of 48, Mixtral-8x22B at 2 of 56 (9.7 GB of pinned host expert slabs;
# host RAM). The first two ran at 28 (31.0 GB) and 24 (29.0 GB) until the
# shapes phase needed their time: the paper phase was about half of the
# script's 650 s, and the script's limit did not grow (28 / 24 layers cut to
# 14 / 12 then, to 8 / 6 when the mesh phase took in every family, and to
# 2 / 2, Mixtral-8x22B 4 to 2, when it took in FSDP and its launcher runs).
# max_seq: each model's own choice (batch invariance holds at any max_seq:
# flash_decode's ranges come from Hkv and W)
PAPER_RUNS = (("deepseekmoe-16b", 2, 2048), ("qwen3-30b-a3b", 2, 4096),
              ("mixtral-8x22b", 2, 2048))
PAPER_NEW_TOKENS = 16
# the policy comparison's new tokens: LFP stages every expert of the next
# layer at each decode step (0.59 s a step at 28 layers, NVIDIA H100 80GB
# HBM3, 700.00 W), so 16 tokens cost it 40 s of the phase
PAPER_POLICY_NEW_TOKENS = 8
PAPER_POLICIES = ("odf", "lfp", "mif", "duo")


def host_memory() -> dict:
    """The caching host allocator's pinned bytes and the machine's memory."""
    with open("/proc/meminfo") as f:
        mem = {k: int(v.split()[0]) * 1024 for k, v in (ln.split(":", 1) for ln in f)}
    stats = torch.cuda.host_memory_stats()
    return dict(pinned={k: v for k, v in stats.items()
                        if "bytes" in k and k.endswith(".current")},
                mem_available=mem["MemAvailable"], mem_total=mem["MemTotal"])


def release() -> None:
    """Return what the dropped engines and params held: device memory to the
    driver, pinned host blocks to the OS (the caching host allocator keeps
    freed blocks otherwise; the engines' reference cycles hold their pools
    until collected)."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch._C._host_emptyCache()


def paper_kernel_checks(cfg, max_seq: int, prompts):
    """The model's kernel shapes held against their plain versions and
    timed: the fused prefill's ``expert_ffn`` (U up to the groups a 256-token
    chunk routes to, C the bucketed group), prefill attention over the
    longest prompt, chunked prefill attention (a 256-token chunk after a
    256-token prefix) and decode attention at B=8 over the phase's
    positions."""
    ffn = {"deepseekmoe-16b": (64, 64), "qwen3-30b-a3b": (128, 32),
           "mixtral-8x22b": (8, 128)}[cfg.name]
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    out = dict(expert_ffn=expert_ffn_check(*ffn, cfg.d_model, cfg.d_expert),
               flash_attention=prefill_attention(
                   H, Hkv, D, max(len(p) for p in prompts),
                   torch.Generator(device="cuda").manual_seed(0))[1],
               flash_attention_chunk=chunk_attention(H, Hkv, D, max_seq, start=256, C=256),
               flash_decode=decode_attention(
                   cfg, max_seq, [len(p) + PAPER_NEW_TOKENS - 1 for p in prompts]))
    release()
    return out


def hw_latencies(pred, stats, top_k: int) -> dict:
    """What ``HW.h100`` takes besides the data sheet, measured here: the
    fixed cost of one host->device copy (4 KiB pinned, on a side stream,
    CUDA events), the host's cost of one small kernel launch (2000
    launches back to back, then a sync) and one ExpertMLP top-k prediction
    (host wall: features to the card, the top-k back)."""
    from repro_torch.core.state import StateConstructor
    src = torch.empty(4096, dtype=torch.uint8, pin_memory=True)
    dst = torch.empty(4096, dtype=torch.uint8, device="cuda")
    stream = torch.cuda.Stream()
    copies = []
    for _ in range(55):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        with torch.cuda.stream(stream):
            a.record()
            dst.copy_(src, non_blocking=True)
            b.record()
        b.synchronize()
        copies.append(a.elapsed_time(b) / 1e3)
    x = torch.zeros(1, device="cuda")
    for _ in range(100):
        x.add_(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2000):
        x.add_(1)
    torch.cuda.synchronize()
    kernel_lat = (time.perf_counter() - t0) / 2000
    feat = StateConstructor(stats).features([np.arange(top_k)], 1)[None]
    preds = []
    for _ in range(55):
        t0 = time.perf_counter()
        pred.predict_topk(feat, k=top_k)
        preds.append(time.perf_counter() - t0)
    return dict(host_lat=float(np.median(copies[5:])), kernel_lat=kernel_lat,
                pred_lat=float(np.median(preds[5:])))


def policy_comparison(cfg, params, stats, pred, prompts, host_bw: float, lat: dict):
    """The paper's Figs. 5-6 measured: ``MoEServingEngine`` under each policy
    serves the same prompts greedily (tokens must be equal across
    policies); then each policy's requests are replayed in order through
    ``simulate_request`` with a fresh scheduler at the engine's capacity
    and the same stats and predictor, which must give the engine's
    hit / miss / evict sequence, peak residency, hits and misses; the
    simulated TTFT and decode step under ``HW.h100`` (this run's slab rate
    and latencies) are reported beside the measured ones."""
    from repro_torch.core.scheduler import make_scheduler
    from repro_torch.core.simulator import HW, ModelCosts, simulate_request
    from repro_torch.core.state import StateConstructor
    from repro_torch.serving.engine import MoEServingEngine
    hw = HW.h100(host_bw=host_bw, **lat)
    costs = ModelCosts(cfg, quant_bytes=2.0)    # served in bf16
    out, tokens = {}, {}
    for policy in PAPER_POLICIES:
        torch.cuda.reset_peak_memory_stats()
        eng = MoEServingEngine(cfg, params, policy=policy, stats=stats, predictor=pred,
                               temperature=0.0)
        per_req = []
        res = []
        for p in prompts:
            n0 = len(eng.cache.transfer_log)
            res.append(eng.serve(p, max_new=PAPER_POLICY_NEW_TOKENS))
            per_req.append(len(eng.cache.transfer_log) - n0)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        tokens[policy] = [r.tokens.tolist() for r in res]
        sched = make_scheduler(policy, cfg.n_layers, cfg.n_experts, cfg.top_k,
                               eng.store.bytes_per_expert, stats=stats, predictor=pred,
                               state_constructor=StateConstructor(stats),
                               capacity=eng.cache.capacity)
        sims = [simulate_request(sched, costs, hw, r.prefill_active, r.decode_trace,
                                 seq_len=len(p)) for r, p in zip(res, prompts)]
        ledger_equal = dict(
            events=[(e.kind, e.key) for e in sched.cache.events]
            == [(e.kind, e.key) for e in eng.cache.events],
            peak_resident=sched.cache.peak_resident == eng.cache.peak_resident,
            hits_misses=(sched.cache.hits, sched.cache.misses)
            == (eng.cache.hits, eng.cache.misses),
            decode_hits_misses=(sched.decode_hits, sched.decode_misses)
            == (eng.sched.decode_hits, eng.sched.decode_misses))
        steps = [(r.e2e_wall - r.ttft_wall) / max(len(r.decode_trace), 1) for r in res]
        out[policy] = dict(
            cache_capacity=eng.cache.capacity, expert_pool_bytes=eng.cache.device_bytes,
            ttft_s=[r.ttft_wall for r in res], e2e_s=[r.e2e_wall for r in res],
            decode_step_s=steps, expert_copies=per_req,
            decode_hit_rate=eng.sched.decode_hit_rate,
            hits=eng.cache.hits, misses=eng.cache.misses,
            peak_resident=eng.cache.peak_resident, max_memory_allocated=peak,
            hbm_bound_ok=eng.cache.hbm_bound_ok, ledger_equal=ledger_equal,
            sim_ttft_s=[x.ttft for x in sims],
            sim_decode_step_s=[float(x.step_latencies.mean()) for x in sims],
            sim_over_measured_ttft=[x.ttft / r.ttft_wall for x, r in zip(sims, res)],
            sim_over_measured_step=[float(x.step_latencies.mean()) / st
                                    for x, st in zip(sims, steps)],
            sim_hit_rate=[x.hit_rate for x in sims])
        del eng, res, sched
        release()
        if not (all(ledger_equal.values()) and out[policy]["hbm_bound_ok"]):
            raise AssertionError(f"policy {policy}: engine vs simulator ledger "
                                 f"{ledger_equal}, hbm_bound_ok "
                                 f"{out[policy]['hbm_bound_ok']}")
    parted = [p for p in PAPER_POLICIES if tokens[p] != tokens["odf"]]
    if parted:
        raise AssertionError(f"policies {parted} change the tokens: {tokens}")
    return dict(prompt_lens=[len(p) for p in prompts], new_tokens=PAPER_POLICY_NEW_TOKENS,
                hw=dataclasses.asdict(hw), tokens_equal=True, policies=out)


def paper_model(name: str, layers: int, max_seq: int, seed: int, kernels, policies: bool):
    """One Table I model at its published widths, depth cut to ``layers``,
    random weights from ``seed``: kernel checks at its shapes (uncounted),
    ODF traces and the ExpertMLP trained on the card, the batched engine
    under ``duo`` over squad-like and orca-like prompts with mid-flight
    admission, each request alone at ``max_batch=1`` and a monolithic run
    (tokens must equal), and with ``policies`` the policy comparison."""
    from repro_torch.configs.paper_models import PAPER_MODELS
    from repro_torch.core.predictor import train_predictor
    from repro_torch.core.state import StateConstructor
    from repro_torch.data.pipeline import PromptWorkload, orca_like, squad_like
    from repro_torch.models.params import init_params
    from repro_torch.serving import engine as engine_mod
    from repro_torch.serving.batching import BatchedServingEngine
    from repro_torch.serving.engine import collect_traces
    t_model = time.perf_counter()
    cfg = dataclasses.replace(PAPER_MODELS[name], n_layers=layers)
    squad = PromptWorkload(squad_like(cfg.vocab), seed=seed)
    orca = PromptWorkload(orca_like(cfg.vocab), seed=seed + 1)
    trace_prompts = [p for p, _ in squad.prompts(3)]
    pairs = zip((p for p, _ in squad.prompts(4)), (p for p, _ in orca.prompts(4)))
    prompts = [p for pair in pairs for p in pair]    # squad, orca, squad, ...
    policy_prompts = [p for p, _ in squad.prompts(4)]
    with uncounted(kernels):
        checks = paper_kernel_checks(cfg, max_seq, prompts)

    t0 = time.perf_counter()
    params = init_params(cfg, seed, device="cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    host_after_init = host_memory()
    t0 = time.perf_counter()
    tracer, _ = collect_traces(cfg, params, trace_prompts, max_new=PAPER_NEW_TOKENS)
    stats = tracer.stats()
    X, Y = StateConstructor(stats).build_dataset(tracer.as_array())
    pred, hist = train_predictor(seed, X, Y, cfg.top_k, epochs=20, batch=64, device="cuda")
    t_pre = time.perf_counter() - t0
    release()

    def run(max_batch: int, budget, staged: bool, n: int = 8):
        """The first ``n`` requests through one engine (``staged``: 4 before
        the first step, 4 after step 4); the expert copies of each decode
        step, every copy timed on the copy stream, every sampled row
        checked finite."""
        eng = BatchedServingEngine(cfg, params, policy="duo", stats=stats, predictor=pred,
                                   max_batch=max_batch, max_seq=max_seq,
                                   prefill_budget=budget, prefill_fairness="rr",
                                   temperature=0.0)
        finite, steps = [], []
        sample, decode = eng._sample_req, eng._decode_step

        def record(req, row):
            finite.append(bool(np.isfinite(row).all()))
            return sample(req, row)

        def counted(batch):
            n0 = len(eng.cache.transfer_log)
            decode(batch)
            steps.append(len(eng.cache.transfer_log) - n0)

        eng._sample_req, eng._decode_step = record, counted
        copies = timed_copies(eng.cache)
        t0 = time.perf_counter()
        reqs = [eng.submit(p, max_new=PAPER_NEW_TOKENS) for p in prompts[:4 if staged else n]]
        if staged:
            for _ in range(4):
                eng.step()
            reqs += [eng.submit(p, max_new=PAPER_NEW_TOKENS) for p in prompts[4:]]
        eng.run_until_drained()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        results = [r.result() for r in reqs]
        if not (all(finite) and eng.cache.hbm_bound_ok):
            raise AssertionError(f"{name}: non-finite logits or the expert pool grew")
        if any(len(r.tokens) != PAPER_NEW_TOKENS + 1
               or not all(0 <= t < cfg.vocab for t in r.tokens) for r in results):
            raise AssertionError(f"{name}: a request's tokens are out of range or short")
        slab_ms = [a.elapsed_time(b) for a, b in copies]
        walls, hist_b = np.array(eng.decode_step_wall), np.array(eng.decode_batch_hist)
        report = dict(
            max_batch=max_batch, prefill_budget=budget, wall_s=wall,
            ttft_s=[r.ttft_wall for r in results], e2e_s=[r.e2e_wall for r in results],
            decode_tok_per_s=sum(len(r.tokens) - 1 for r in results) / float(walls.sum()),
            decode_step_ms_median_by_batch={int(b): float(np.median(walls[hist_b == b]) * 1e3)
                                            for b in np.unique(hist_b)},
            expert_copies_per_decode_step=dict(median=float(np.median(steps)),
                                               max=int(max(steps)), total=int(sum(steps))),
            expert_copies_total=len(eng.cache.transfer_log),
            copy_ms_per_slab_median=float(np.median(slab_ms)),
            copy_ms_per_slab_max=float(max(slab_ms)),
            cache_capacity=eng.cache.capacity, expert_pool_bytes=eng.cache.device_bytes,
            hits=eng.cache.hits, misses=eng.cache.misses, hbm_bound_ok=eng.cache.hbm_bound_ok)
        tokens = [list(r.tokens) for r in results]
        bytes_per_slab = eng.store.bytes_per_expert
        del eng, reqs, copies
        release()
        return report, tokens, bytes_per_slab

    # the fused prefill's dispatch: rows launched (every group padded to the
    # largest group's power of two, the group count to its power of two)
    # against the rows the gate routed
    dispatch = []
    group = engine_mod.group_by_expert

    def recorded(*a, **kw):
        d = group(*a, **kw)
        dispatch.append((d.n_rows, d.n_launched, d.row_idx.shape[0], d.row_idx.shape[1]))
        return d

    torch.cuda.reset_peak_memory_stats()
    engine_mod.group_by_expert = recorded
    try:
        chunked, tokens, slab_bytes = run(8, 256, staged=True)
    finally:
        engine_mod.group_by_expert = group
    chunked["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    routed, launched = sum(d[0] for d in dispatch), sum(d[1] for d in dispatch)
    chunked["prefill_dispatch"] = dict(
        launches=len(dispatch), rows_routed=routed, rows_launched=launched,
        launched_over_routed=launched / routed,
        max_launched_over_routed=max(d[1] / d[0] for d in dispatch),
        max_groups=max(d[2] for d in dispatch), max_group_rows=max(d[3] for d in dispatch))
    host_bw = slab_bytes / (chunked["copy_ms_per_slab_median"] / 1e3)
    # batch invariance on the 4 requests submitted first (2 squad-like, 2
    # orca-like): served one after another they take 5 s each at 28 layers
    # (NVIDIA H100 80GB HBM3, 700.00 W)
    alone, tok_alone, _ = run(1, 256, staged=False, n=4)
    mono, tok_mono, _ = run(8, None, staged=False)
    res = dict(phase="paper", model=name, layers=layers, published_layers=PAPER_MODELS[name].n_layers,
               widths=dict(d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                           head_dim=cfg.hd, n_experts=cfg.n_experts, top_k=cfg.top_k,
                           d_expert=cfg.d_expert, n_shared_experts=cfg.n_shared_experts,
                           qk_norm=cfg.qk_norm, vocab=cfg.vocab),
               max_seq=max_seq, prompt_lens=[len(p) for p in prompts],
               new_tokens=PAPER_NEW_TOKENS, init_s=t_init, traces_and_training_s=t_pre,
               predictor_val_topk=hist["val_topk"][-1], predictor_val_half=hist["val_half"][-1],
               host_expert_bytes=slab_bytes * cfg.n_layers * cfg.n_experts,
               host_after_init=host_after_init, slab_bytes=slab_bytes,
               host_gb_per_s=host_bw / 1e9, chunked=chunked, alone=alone, monolithic=mono,
               batch_invariant=tok_alone == tokens[:4], chunked_vs_monolithic=tok_mono == tokens,
               kernel_checks=checks)
    if policies:
        lat = hw_latencies(pred, stats, cfg.top_k)
        res["hw_h100"] = dict(host_bw=host_bw, **lat)
        res["policy_comparison"] = policy_comparison(cfg, params, stats, pred,
                                                     policy_prompts, host_bw, lat)
    del params, pred, tracer
    release()
    res["host_after_release"] = host_memory()
    res["seconds"] = time.perf_counter() - t_model
    for what, ok in (("batch invariance", res["batch_invariant"]),
                     ("chunked vs monolithic", res["chunked_vs_monolithic"])):
        if not ok:
            emit(res)
            raise AssertionError(f"{name}: {what}: tokens part")
    return res


def serve_paper(seed: int, kernels):
    """The three Table I models one after another, each released before the
    next; the kernels' launch counts are reset before and must each be > 0
    after."""
    for fn in kernels:
        fn.launches = 0
    for name, layers, max_seq in PAPER_RUNS:
        emit(paper_model(name, layers, max_seq, seed, kernels,
                         policies=name == "deepseekmoe-16b"))
    launches = {fn.__name__: fn.launches for fn in kernels}
    missing = [n for n, c in launches.items() if c == 0]
    if missing:
        raise AssertionError(f"kernels never launched by the paper phase: {missing}")
    return dict(phase="paper", launches=launches)


# -- phases 13-16: the dense / MoE model bundles and training on them ----------

# the bundle phases' comparison limits. Logits: rtol = atol = 5e-2
# (tests/test_models_smoke.py's decode-vs-forward tolerance) through the
# small model's 2 layers. At published widths and 24-28 layers decode at p
# against forward at p within DECODE_TOL absolute: the two run different
# kernels (flash_decode against flash_attention, capacity T·k against T)
# whose bf16 roundings grow with depth (NVIDIA H100 80GB HBM3: largest 0.079
# and 0.091 over logits of RMS 1.0, mean 0.011-0.014; the phase records the
# gap at depths 1..L and a planted control, decode at p against forward at
# p + 1, that must exceed the limit wherever the two tokens differ). A greedy token may
# differ from the CPU's only where the CPU's logits tie it to within TIE
# (two bf16 ulps of logits of magnitude 4-8: the bundles return bf16
# logits, as the reference's do). A token's own choice of experts may
# differ from the reference run's only where the reference's k-th and
# (k+1)-th router probabilities sit within ROUTER_TIE (an ulp of difference
# in the router's input picks the other); the compared run then takes the
# reference's experts (``routes(replay=)``), so every row and position is
# compared.
BUNDLE_TOL = 5e-2
DECODE_TOL = 0.15
# The hybrid (Zamba2-7B: 81 Mamba layers, 13 attention applications) parts
# decode from forward further, as a pure Mamba stack does: the Mamba layer
# decodes by a different computation than its forward (an f32 recurrence
# against the chunked scan, its causal conv one reduction of the conv state
# against a running bf16 sum of shifted products, projections of 1 row
# against S rows), and the bf16 differences grow with depth (in f32 the
# port's hybrid decode equals its forward to 2e-4:
# tests/test_torch_families.py). Measured, NVIDIA H100 80GB HBM3, logits of
# RMS 1.0: Zamba2-7B at 81 layers 0.388, 0.345, 0.383 and 0.371 at seeds
# 0-3 (0.094 at 6 layers, 0.141, 0.203, 0.266 at 48), 0.292 with the
# decode conv summed in the forward's order (so the conv is a quarter of
# it); Mamba2-2.7B's 64 layers 0.319 (0.279). The limit was set after
# readings of this kind: 1.29 times the largest of four seeds, whose spread
# is 12%, and under a tenth of the smallest control, 5.45
HYBRID_DECODE_TOL = 0.5
TIE = 1 / 16
ROUTER_TIE = 2e-2
# train_check: gradients of the kernels' autograd.Functions against autograd
# through their plain versions, relative to each gradient's largest entry
# (bf16 backward products against f32 ones; tests/test_torch_moe_ffn.py's);
# the small train step's gradients, card against CPU, leaf by leaf relative
# to the leaf's largest entry (tests/test_torch_training.py's STEP_GRAD_TOL)
GRAD_TOL = 2e-2
STEP_GRAD_TOL = 5e-2


def logit_err(got, want) -> tuple:
    """(max abs difference, whether every entry is within BUNDLE_TOL
    absolute plus BUNDLE_TOL relative) of two [..., V] logit tensors."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    return float(err.max()), bool((err <= BUNDLE_TOL * (1 + want.abs())).all())


@contextlib.contextmanager
def routes(replay=None):
    """Record (expert ids, router probabilities) of every MoE router call.
    With ``replay`` (another run's record, call for call) each call takes
    that run's experts, weighted by this call's own probabilities, and the
    record keeps this call's own choice (for ``flips``)."""
    from repro_torch.models import moe_layer as M
    rec, orig = [], M.route

    def route(*a):
        w, ids, probs = orig(*a)
        rec.append((ids.cpu(), probs.detach().float().cpu()))
        if replay is not None:
            ids = replay[len(rec) - 1][0].to(ids.device)
            w = probs.gather(1, ids)
            w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
        return w, ids, probs

    M.route = route
    try:
        yield rec
    finally:
        M.route = orig


def flips(rec, ref) -> int:
    """Tokens whose expert set differs between two runs' router calls; each
    must sit at a near-tie of ``ref``'s probabilities."""
    if len(rec) != len(ref):
        raise AssertionError(f"{len(rec)} router calls against {len(ref)}")
    n = 0
    for (ids, _), (rids, probs) in zip(rec, ref):
        k = ids.shape[1]
        diff = (ids.sort(1).values != rids.sort(1).values).any(1).numpy()
        p = probs.sort(1, descending=True).values
        gap = (p[:, k - 1] - p[:, k]).numpy()
        if (gap[diff] >= ROUTER_TIE).any():
            raise AssertionError(f"a token routed differently off a tie: gaps {gap[diff]}")
        n += int(diff.sum())
    return n


def model_batch(cfg, B: int, S: int, seed: int, dev):
    """B x (S + 1) tokens from ``SyntheticLM`` and the stub frontend's
    inputs (numpy normals): the vlm's ``patch_embeds`` [B, n_frontend_tokens,
    frontend_dim], the enc-dec's ``frames`` [B, S, frontend_dim]."""
    from repro_torch.data.pipeline import SyntheticLM
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(
        next(SyntheticLM(cfg.vocab, seed=seed).batches(B, S + 1)))}
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.n_frontend_tokens, cfg.frontend_dim), dtype=np.float32))
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (B, S, cfg.frontend_dim), dtype=np.float32))
    return {k: v.to(dev) for k, v in batch.items()}


def ring(cfg, n: int) -> int:
    """Slots a cache needs to hold n positions: the hybrid's window ring
    holds at most its window (prefill past it keeps a full, rolled ring)."""
    return min(n, cfg.sliding_window) if cfg.family == "hybrid" and cfg.sliding_window else n


def teacher_forced(bundle, params, batch, first: int, n: int, rf=()):
    """Prefill of the first ``first`` tokens, then n decode steps each fed
    the next true token. Each step takes the experts that a forward over
    the batch's T tokens used at its position (``rf``: that forward's
    router calls over B rows of T tokens; the step's own choice may differ
    only at a near-tie). Returns the steps' logits [B, n, V] (f32, on the
    CPU) and the count of tokens routed differently."""
    from repro_torch.models.model import pad_cache
    toks = batch["tokens"]
    T = toks.shape[1]
    _, cache = bundle.prefill(params, dict(batch, tokens=toks[:, :first]))
    cache = pad_cache(cache, ring(bundle.cfg, first + n), bundle.ring_axes)
    out, n_flips = [], 0
    for p in range(first, first + n):
        used = [(i[p::T], q[p::T]) for i, q in rf]
        with routes(replay=used or None) as rd:
            lg, cache = bundle.decode_step(params, {"token": toks[:, p:p + 1]}, cache)
        n_flips += flips(rd, used)
        out.append(lg.float().cpu())
    return torch.stack(out, 1), n_flips


def decode_vs_forward(bundle, params, batch, at, rf=(), tol=None):
    """Decode at the last n positions S - n .. S - 1 of the batch's S + 1
    tokens (``teacher_forced``, ``rf`` as there) against a forward's logits
    there (``at`` = forward[:, S - n:], n + 1 columns, on the CPU). Every
    (row, position) pair is held to ``tol`` absolute; a planted control,
    decode at p against forward at p + 1 (a position off by one), must
    exceed ``tol`` in every pair whose tokens at p and p + 1 differ. With
    no ``tol`` nothing is held (a diagnosis). Returns (max abs difference,
    smallest control difference, pairs, flips)."""
    toks = batch["tokens"]
    S, n, vocab = toks.shape[1] - 1, at.shape[1] - 1, bundle.cfg.vocab
    dec, n_flips = teacher_forced(bundle, params, batch, S - n, n, rf)
    dec, at = dec[..., :vocab], at[..., :vocab]
    errs = (dec - at[:, :n]).abs().amax(-1)                      # [B, n]
    moved = (toks[:, S - n:S] != toks[:, S - n + 1:]).cpu()
    err, low = float(errs.max()), float((dec - at[:, 1:]).abs().amax(-1)[moved].min())
    if tol is not None and not (bool(torch.isfinite(errs).all()) and err <= tol < low):
        raise AssertionError(f"decode vs forward: {err} (limit {tol}, control {low})")
    return err, low, errs.numel(), n_flips


# the vlm's gate_attn and gate_mlp: zero at init (a fresh cross layer is the
# identity), so the runs set them nonzero
FAMILY_GATES = (0.5, -0.7)


def set_gates(params, values=FAMILY_GATES):
    for key, val in zip(("gate_attn", "gate_mlp"), values):
        params["blocks"]["cross"][key].fill_(val)
    return params


def timed_init(bundle, seed: int):
    """The bundle's params on the card from ``seed`` (a vlm's gates set to
    FAMILY_GATES), and the seconds that took."""
    t0 = time.perf_counter()
    params = bundle.init(seed, device="cuda")
    if bundle.cfg.family == "vlm":
        set_gates(params)
    torch.cuda.synchronize()
    return params, time.perf_counter() - t0


def widths(cfg) -> dict:
    """The config's nonzero widths."""
    w = dict(d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
             head_dim=cfg.hd if cfg.n_heads else 0, d_ff=cfg.d_ff, n_experts=cfg.n_experts, top_k=cfg.top_k,
             n_shared_experts=cfg.n_shared_experts, d_expert=cfg.d_expert, vocab=cfg.vocab,
             ssm_state=cfg.ssm_state, ssm_head_dim=cfg.ssm_head_dim, enc_layers=cfg.enc_layers,
             window=cfg.sliding_window, frontend_tokens=cfg.n_frontend_tokens,
             frontend_dim=cfg.frontend_dim)
    if not cfg.ssm_state:
        del w["ssm_head_dim"]
    return {k: v for k, v in w.items() if v}


SMALL_STEPS = 8    # greedy decode steps of a small check
DECODE_STEPS = 8   # positions at which decode is held against forward


def run_small(bundle, params, batch, ref=None):
    """Forward over the batch's S + 1 tokens, prefill of S, then
    SMALL_STEPS greedy decode steps, on the params' device. Alone, each
    step is fed the run's own greedy token; with ``ref`` (another run's
    record) the ref's, and every router call takes the ref's experts
    (``routes(replay=)``). Returns the record: logits over the real
    vocabulary (f32, on the CPU), aux, each call's router record and the
    tokens routed differently from the ref's."""
    from repro_torch.models.model import pad_cache
    cfg, toks = bundle.cfg, batch["tokens"]
    S, real = toks.shape[1] - 1, slice(0, cfg.vocab)
    rec = dict(routes={}, flips=0)

    def call(key, fn, *args):
        want = ref["routes"][key] if ref else None
        with routes(replay=want) as r:
            out = fn(params, *args)
        if ref:
            rec["flips"] += flips(r, want)
        rec["routes"][key] = r
        return out

    full, aux = call("forward", bundle.forward, batch)
    last, cache = call("prefill", bundle.prefill, dict(batch, tokens=toks[:, :S]))
    cache = pad_cache(cache, ring(cfg, S + SMALL_STEPS), bundle.ring_axes)
    logits = [last.float().cpu()[:, real]]
    for i in range(SMALL_STEPS):
        tok = (ref or {"logits": logits})["logits"][i].argmax(-1)[:, None]
        lg, cache = call(i, bundle.decode_step, {"token": tok.to(toks)}, cache)
        logits.append(lg.float().cpu()[:, real])
    rec.update(full=full.float().cpu()[..., real], aux=float(aux), logits=logits)
    return rec


def check_model_small(bundle, gpu, batch, tol: float, controls=None):
    """One small model through the same port code on the CPU (plain
    versions), then on the card with every router call taking the CPU's
    experts (``run_small``): forward logits, prefill's last logits and
    SMALL_STEPS greedy decode steps fed the CPU's tokens, every row and
    position within BUNDLE_TOL (``logit_err``); a card token may differ
    from the CPU's only at a CPU co-maximum within TIE. Controls that must
    exceed the limit: the card's step i against the CPU's step i + 1 (a
    position off by one), and the pairs of logits that ``controls(card
    run, CPU run)`` returns. On the card, decode at the last DECODE_STEPS
    positions against forward there within ``tol`` (``decode_vs_forward``)."""
    cfg = bundle.cfg
    c = run_small(bundle, to_cpu(gpu), batch)
    on = {k: v.cuda() for k, v in batch.items()}
    g = run_small(bundle, gpu, on, ref=c)
    fwd_err, within = logit_err(g["full"], c["full"])
    errs, ties, ctl = [], [], []
    for i, (lg, lc) in enumerate(zip(g["logits"], c["logits"])):
        err, w = logit_err(lg, lc)
        errs.append(err)
        within &= w
        want, got = lc.argmax(-1), lg.argmax(-1)
        for b in np.flatnonzero((got != want).numpy()):
            gap = float(lc[b, want[b]] - lc[b, got[b]])
            ties.append(dict(step=i, row=int(b), cuda=int(got[b]), cpu=int(want[b]),
                             cpu_logit_gap=gap))
            if gap > TIE:
                raise AssertionError(f"{cfg.name}: card tokens {got.tolist()} against the "
                                     f"CPU's {want.tolist()}")
        if i + 1 < len(c["logits"]):
            ctl.append(logit_err(lg, c["logits"][i + 1]))
    ctl += [logit_err(a, b) for a, b in (controls(g, c) if controls else ())]
    S = batch["tokens"].shape[1] - 1
    dec = decode_vs_forward(bundle, gpu, on, g["full"][:, S - DECODE_STEPS:],
                            c["routes"]["forward"], tol)
    res = dict(config=cfg.name, layers=cfg.n_layers, widths=widths(cfg), prompt=S,
               tol=BUNDLE_TOL, forward_logit_max_abs_err=fwd_err,
               decode_logit_max_abs_err=errs, aux_cuda=g["aux"], aux_cpu=c["aux"],
               own_route_flips_at_ties=g["flips"], control_max_abs_err=[e for e, _ in ctl],
               token_ties=ties, tokens_equal=not ties, decode_vs_forward_max_abs_err=dec[0],
               decode_vs_forward_control=dec[1], decode_vs_forward_pairs=dec[2],
               decode_vs_forward_flips=dec[3], decode_vs_forward_tol=tol)
    if not within:
        emit(res)
        raise AssertionError(f"{cfg.name}: card vs CPU logits differ beyond the limit")
    if any(w for _, w in ctl):
        emit(res)
        raise AssertionError(f"{cfg.name}: a control stayed within the limit")
    return res


def small_bundle_cfg():
    """A 2-layer Kimi-K2-shaped model at the kernels' widths: one dense0
    layer, one MoE layer (4 experts, top-2, a shared expert, f = 128),
    d_model 512, 4 heads of 128."""
    from repro_torch.configs.base import get_config, reduced
    return dataclasses.replace(reduced(get_config("kimi_k2_1t_a32b")), d_model=512,
                               head_dim=128, d_expert=128, dense_d_ff=256)


def check_bundle_small(seed: int):
    """Phase 13: ``check_model_small`` on ``small_bundle_cfg``, 2 x 40
    tokens, decode vs forward within BUNDLE_TOL."""
    from repro_torch.models.model import build
    cfg = small_bundle_cfg()
    bundle = build(cfg)
    with torch.no_grad():
        res = check_model_small(bundle, bundle.init(seed, device="cuda"),
                                model_batch(cfg, 2, 40, seed, "cpu"), BUNDLE_TOL)
    return dict(phase="bundle_check", **res)


# (config id, layers): Qwen2-MoE-A2.7B at all 24 layers (29.7 GB of bf16
# params on the card), Qwen3-1.7B (dense) at all 28
BUNDLE_RUNS = (("qwen2_moe_a2_7b", 24), ("qwen3_1_7b", 28))
BUNDLE_B, BUNDLE_S, BUNDLE_NEW = 2, 2048, 16
BUNDLE_DEPTHS = (1, 2, 4, 8, 16)


def drive(bundle, params, batch, kernels, need, tol: float, cuts=()):
    """One model's main path at published widths, the kernels' counts
    reset just before and read just after: a teacher-forced ``forward``
    over the batch's S + 1 tokens, ``prefill`` of S, ``pad_cache`` and
    BUNDLE_NEW greedy ``decode_step``s, with walls and peak memory; every
    kernel named in ``need`` must have launched. Then, uncounted, decode
    at the last DECODE_STEPS positions against the forward there within
    ``tol`` (``decode_vs_forward``, each step on the forward's experts),
    and the same for each of ``cuts`` ((depth, bundle, params) over the
    first layers of the same weights): the gap's growth with depth, the
    witness that it is rounding. Returns the record."""
    from repro_torch.models.model import greedy_token, pad_cache
    from repro_torch.training.optimizer import tree_leaves
    cfg, toks, n = bundle.cfg, batch["tokens"], DECODE_STEPS
    B, S = toks.shape[0], toks.shape[1] - 1
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels:
        fn.launches = 0
    with torch.no_grad():
        with routes() as rf:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            full, aux = bundle.forward(params, batch)
            at = full[:, S - n:].float().cpu()
            t_fwd = time.perf_counter() - t0
        finite = bool(torch.isfinite(full).all())
        del full
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last, cache = bundle.prefill(params, dict(batch, tokens=toks[:, :S]))
        tok = greedy_token(last, cfg.vocab)
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t0
        cache = pad_cache(cache, ring(cfg, S + BUNDLE_NEW), bundle.ring_axes)
        out, steps = [tok], []
        for _ in range(BUNDLE_NEW):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, cache = bundle.decode_step(params, {"token": tok}, cache)
            tok = greedy_token(lg, cfg.vocab)
            torch.cuda.synchronize()
            steps.append((time.perf_counter() - t0) * 1e3)
            out.append(tok)
            finite &= bool(torch.isfinite(lg).all())
    launches = {fn.__name__: fn.launches for fn in kernels}
    peak = torch.cuda.max_memory_allocated()
    tokens = torch.cat(out, 1).cpu()
    del cache
    if not finite:
        raise AssertionError(f"{cfg.name}: logits not finite")
    missing = [k for k in need if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched by {cfg.name}: {missing}")
    with torch.no_grad(), uncounted(kernels):
        err, low, pairs, n_flips = decode_vs_forward(bundle, params, batch, at, rf, tol)
        rms = float(at.pow(2).mean().sqrt())
        del at, rf
        depth = {}
        for d, cut, pc in cuts:
            with routes() as r:
                full, _ = cut.forward(pc, batch)
            at = full[:, S - n:].float().cpu()
            del full
            depth[d] = decode_vs_forward(cut, pc, batch, at, r, tol)[0]
            del at, r
        depth[cfg.n_layers] = err
    leaves = tree_leaves(params)
    return dict(layers=cfg.n_layers, widths=widths(cfg), n_params=sum(t.numel() for t in leaves),
                param_bytes=sum(t.numel() * t.element_size() for t in leaves), batch=B,
                prompt_tokens=S, new_tokens=BUNDLE_NEW, forward_s=t_fwd, prefill_s=t_prefill,
                decode_step_ms=steps, decode_step_ms_median=float(np.median(steps)),
                aux=float(aux), logit_rms=rms, decode_vs_forward_max_abs_err=err,
                decode_vs_forward_control=low, decode_vs_forward_pairs=pairs,
                decode_vs_forward_flips=n_flips, decode_vs_forward_by_depth=depth, tol=tol,
                tokens_head=tokens[:, :8].tolist(), max_memory_allocated=peak,
                launches=launches)


def bundle_model(arch: str, seed: int, kernels):
    """One model of BUNDLE_RUNS at published widths through ``drive``:
    BUNDLE_B x BUNDLE_S prompts from ``SyntheticLM``, decode vs forward
    within DECODE_TOL, the witness over BUNDLE_DEPTHS."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.model import build
    from repro_torch.training.optimizer import tree_map
    cfg = get_config(arch)
    bundle = build(cfg)
    params, t_init = timed_init(bundle, seed)
    cuts = ((d, build(dataclasses.replace(cfg, n_layers=d)),
             dict(params, layers=tree_map(lambda t: t[:d], params["layers"])))
            for d in BUNDLE_DEPTHS if d < cfg.n_layers)
    need = [fn.__name__ for fn in kernels if cfg.is_moe or fn.__name__ != "expert_ffn"]
    res = drive(bundle, params, model_batch(cfg, BUNDLE_B, BUNDLE_S, seed, "cuda"), kernels,
                need, DECODE_TOL, cuts)
    return dict(phase="bundle", model=cfg.name, init_s=t_init, **res)


def serve_bundles(seed: int, kernels):
    """Phase 14: the kernel checks at the bundles' shapes (uncounted), then
    each of ``BUNDLE_RUNS``, released in between. ``expert_ffn`` at
    Qwen2-MoE-A2.7B's capacity buffers: forward (C = T) and decode (C =
    T·k, below one row tile); ``flash_attention`` with the lse output and
    ``flash_decode`` at the bundle's cache shape, for Qwen2-MoE-A2.7B (16
    heads of 16) and Qwen3-1.7B (16 of 8)."""
    from repro_torch.configs.base import get_config
    moe, dense = get_config("qwen2_moe_a2_7b"), get_config("qwen3_1_7b")
    B, S, W = BUNDLE_B, BUNDLE_S, BUNDLE_S + BUNDLE_NEW
    E, d, f, k = 64, moe.d_model, moe.d_expert, moe.top_k
    rec = dict(phase="bundle_kernels")
    with uncounted(kernels):
        for name, C, T in (("forward", B * S, B * S), ("decode", B * k, B)):
            r = expert_ffn_check(E, C, d, f, pool=False)
            rec[f"expert_ffn_{name}"] = r | dict(rows_per_routed_row=E * C / (T * k))
            release()
        for cfg in (moe, dense):
            _, r = prefill_attention(cfg.n_heads, cfg.n_kv_heads, cfg.hd, S,
                                     torch.Generator(device="cuda").manual_seed(4), B=B,
                                     lse=True)
            rec[f"flash_attention_{cfg.name}"] = r
            release()
            rec[f"flash_decode_{cfg.name}"] = decode_attention(cfg, W, [W - 1] * B)
            release()
    emit(rec)
    ffn = dict(name="expert_ffn", route="cuda", source="src/repro_torch/csrc/expert_ffn.cu",
               replaces="src/repro/kernels/expert_ffn.py:64", library_ms=None,
               **rec["expert_ffn_forward"])
    launches = {}
    for arch, layers in BUNDLE_RUNS:
        r = bundle_model(arch, seed, kernels)
        if r["layers"] != layers:
            raise AssertionError(f"{arch}: {r['layers']} layers, not {layers}")
        emit(r)
        for n, c in r["launches"].items():
            launches[n] = launches.get(n, 0) + c
        release()
    return ffn, dict(phase="bundle", launches=launches)


TRAIN_LAYERS, TRAIN_STEPS, TRAIN_MICRO_STEPS = 4, 10, 2


def grad_check(fn, plain, args, upstream):
    """Largest gradient difference of ``fn`` against autograd through
    ``plain``, relative to each gradient's largest entry (raises beyond
    GRAD_TOL), and the time of ``fn``'s backward alone (CUDA events,
    median of 5). Returns (relative differences, backward ms)."""
    a = [t.detach().clone().requires_grad_(True) for t in args]
    b = [t.detach().clone().requires_grad_(True) for t in args]
    out = fn(*a)
    up = upstream.to(out.dtype)
    bwd_ms = time_ms(lambda: torch.autograd.grad(out, a, up, retain_graph=True),
                     reps=5, warmup=1)
    out.backward(up)
    plain(*b).backward(upstream)
    rel = []
    for ta, tb in zip(a, b):
        scale = float(tb.grad.float().abs().max())
        rel.append(float((ta.grad.float() - tb.grad.float()).abs().max()) / max(scale, 1e-30))
        if not torch.isfinite(ta.grad.float()).all() or rel[-1] > GRAD_TOL:
            raise AssertionError(f"gradient off its plain version's by {rel[-1]} of its max")
    del a, b, out
    release()
    return rel, bwd_ms


def leaf_names(tree, prefix: str = "") -> list:
    """Slash-joined key paths of a param tree, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in leaf_names(tree[k], f"{prefix}{k}/")]
    return [prefix[:-1]]


def rel_errs(got, want) -> list:
    """Each pair's largest difference relative to ``want``'s largest entry."""
    return [float((x - y).abs().max()) / max(float(y.abs().max()), 1e-30)
            for x, y in zip(got, want)]


def train_step_record(bundle, p, batch, replay=None):
    """One train step (``make_train_step``, AdamW at lr 1e-3) on ``p``,
    updated in place: (params, loss, grad norm, the raw gradient leaves on
    the CPU, read from the first moment m = (1 - b1) * clip scale * g, and
    the step's own router record; with ``replay`` each router call takes
    that record's experts)."""
    from repro_torch.training.optimizer import AdamW, tree_leaves
    from repro_torch.training.train_loop import make_train_step
    opt = AdamW(lr=1e-3)
    with routes(replay=replay) as rec:
        p, st, m = make_train_step(bundle, opt)(p, opt.init(p), batch)
    gn = float(m["grad_norm"])
    scale = (1 - opt.b1) * min(1.0, opt.grad_clip / max(gn, 1e-9))
    return p, float(m["loss"]), gn, [t.cpu() / scale for t in tree_leaves(st.m)], rec


def compare_train_step(bundle, gpu, batch, exact=None):
    """One train step of a small bundle on the card (``gpu``, updated in
    place) against the CPU's from the same weights, ``batch`` on the CPU:
    loss within 2e-2 and grad norm within 5e-2 relative, each raw gradient
    leaf within STEP_GRAD_TOL of the CPU leaf's largest entry, and every
    leaf the CPU step moves moved on the card (a nonzero gradient). The
    control, the CPU's step on the first half of the batch (one microbatch
    of two), must exceed STEP_GRAD_TOL. The card's router calls take the
    CPU's experts (its own choice may differ only at a near-tie).
    ``exact`` (leaf name -> the CPU's f32 step's gradient) names leaves held
    instead as ``rounding_witness`` holds the deep stacks: at most
    F32_RATIO times as far from the f32 gradient as the CPU's bf16 one.
    Returns (the record, the card's updated params)."""
    names = leaf_names(gpu)
    half = {k: v[:v.shape[0] // 2] for k, v in batch.items()}
    grad_h = train_step_record(bundle, to_cpu(gpu), half)[3]
    _, lc, gc_, grad_c, rec_c = train_step_record(bundle, to_cpu(gpu), batch)
    pg, lg, gg, grad_g, own = train_step_record(
        bundle, gpu, {k: v.cuda() for k, v in batch.items()}, replay=rec_c)
    n_flips = flips(own, rec_c)
    exact = exact or {}
    rel_g, rel_h = rel_errs(grad_g, grad_c), rel_errs(grad_h, grad_c)
    leaves = {n: dict(rel_err=r, max_abs_cuda=float(g.abs().max()),
                      max_abs_cpu=float(c.abs().max()))
              for n, r, g, c in zip(names, rel_g, grad_g, grad_c)}
    witness = {}
    for n, g, c in zip(names, grad_g, grad_c):
        if n in exact:
            d_cpu = rel_errs([c], [exact[n]])[0]
            witness[n] = dict(card_vs_f32=rel_errs([g], [exact[n]])[0], cpu_vs_f32=d_cpu)
    held = [r for n, r in zip(names, rel_g) if n not in exact]
    dead = [n for n, g, c in zip(names, grad_g, grad_c)
            if float(c.abs().max()) > 0 and float(g.abs().max()) == 0]
    res = dict(loss_cuda=lg, loss_cpu=lc, grad_norm_cuda=gg, grad_norm_cpu=gc_,
               grad_rel_err_max=max(held), grad_tol=STEP_GRAD_TOL,
               control_half_batch_rel_err_min=min(rel_h), own_route_flips_at_ties=n_flips,
               zero_on_card=dead, leaves=leaves, f32_witness=witness)
    if not (np.isfinite([lg, gg]).all() and abs(lg - lc) <= 2e-2 * abs(lc)
            and abs(gg - gc_) <= 5e-2 * abs(gc_) and max(held) <= STEP_GRAD_TOL
            < min(rel_h) and not dead
            and all(w["card_vs_f32"] <= F32_RATIO * w["cpu_vs_f32"] for w in witness.values())):
        emit(res)
        raise AssertionError(f"{bundle.cfg.name}: the card's train step parts from the CPU's")
    return res, pg


def ssd_grad_inputs(r, B, S, H, G, P, N):
    """bf16 x, b, c (as the Mamba layer hands them over, after its SiLU) and
    f32 da, dt of a Mamba2 layer's scan, and an f32 upstream for y."""
    dt = torch.nn.functional.softplus(r(B, S, H).float() - 2.0)
    da = -dt * torch.rand(H, device="cuda")
    return (r(B, S, H, P), r(B, S, G, N, sc=0.3), r(B, S, G, N, sc=0.3), da, dt), \
        r(B, S, H, P).float()


def check_train(seed: int):
    """Phase 15: the autograd.Functions against autograd through their plain
    versions at a small and the published layer shapes (``SSDScanFn`` at
    Mamba2-2.7B's and Zamba2-7B's scans, ``FlashAttentionCrossFn`` at
    Llama-3.2-Vision's and SeamlessM4T's cross attention, with the kernel's
    lse over the ragged key tile held against the plain one), ``linear`` /
    ``mm_f32`` against the plain product, one train step of the small
    bundle on the card against the CPU (``compare_train_step``), and a
    checkpoint round trip on the card."""
    import tempfile
    from repro_torch.kernels.expert_ffn import ExpertFFNFn, expert_ffn_plain
    from repro_torch.kernels.flash_attention import (FlashAttentionCrossFn, FlashAttentionFn,
                                                     flash_attention_cross,
                                                     flash_attention_plain)
    from repro_torch.kernels.ssd_scan import SSDScanFn, ssd_scan_plain
    from repro_torch.models.layers import linear, mm_f32
    from repro_torch.models.model import build
    from repro_torch.training import checkpoint
    from repro_torch.training.optimizer import tree_leaves
    g = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *s, sc=1.0: (torch.randn(s, generator=g, device="cuda") * sc).to(torch.bfloat16)
    res = dict(phase="train_check", grad_tol=GRAD_TOL)
    for name, (B, S, H, Hkv, D) in (("small", (2, 256, 8, 2, 128)),
                                    ("full", (2, 2048, 16, 16, 128))):
        rel, ms = grad_check(
            lambda q, k, v: FlashAttentionFn.apply(q, k, v, True, -1), flash_attention_plain,
            (r(B, S, H, D), r(B, S, Hkv, D), r(B, S, Hkv, D)), r(B, S, H, D))
        res[f"flash_attention_{name}"] = dict(shape=[B, S, H, Hkv, D], rel_err=rel,
                                              backward_ms=ms)
    for name, (E, C, d, f) in (("small", (4, 200, 256, 128)), ("full", (64, 4096, 2048, 1408))):
        rel, ms = grad_check(
            ExpertFFNFn.apply, expert_ffn_plain,
            (r(E, C, d), r(E, d, f, sc=d ** -0.5), r(E, d, f, sc=d ** -0.5),
             r(E, f, d, sc=f ** -0.5)), r(E, C, d))
        res[f"expert_ffn_{name}"] = dict(shape=[E, C, d, f], rel_err=rel, backward_ms=ms)
    # the plain backwards of one train-phase step: one of each a layer
    res["plain_backward_ms_per_train_step"] = TRAIN_LAYERS * (
        res["flash_attention_full"]["backward_ms"] + res["expert_ffn_full"]["backward_ms"])
    # (B, S, H, G, P, N): a ragged S over two chunks and H/G = 4, then
    # Mamba2-2.7B's and Zamba2-7B's scans
    for name, (B, S, H, G, P, N) in (("small", (2, 300, 8, 2, 64, 128)),
                                     ("mamba2_2_7b", (1, 2048, 80, 1, 64, 128)),
                                     ("zamba2_7b", (1, 4096, 112, 1, 64, 64))):
        args, dy = ssd_grad_inputs(r, B, S, H, G, P, N)
        rel, ms = grad_check(lambda *a: SSDScanFn.apply(*a, 256)[0],
                             lambda *a: ssd_scan_plain(*a)[0], args, dy)
        res[f"ssd_scan_fn_{name}"] = dict(shape=[B, S, H, G, P, N], rel_err=rel,
                                          backward_ms=ms)
    # (B, Sq, Sk, H, Hkv, D): a ragged key tile, then the vlm's and enc-dec's
    for name, (B, Sq, Sk, H, Hkv, D) in (("small", (2, 256, 201, 8, 2, 128)),
                                         ("llama_3_2_vision_90b", (2, 2048, 1601, 64, 8, 128)),
                                         ("seamless_m4t_medium", (2, 2048, 2048, 16, 16, 64))):
        q, k, v = r(B, Sq, H, D), r(B, Sk, Hkv, D), r(B, Sk, Hkv, D)
        with torch.no_grad():
            lse = flash_attention_cross(q, k, v, return_lse=True)[1]
            lse_err = float((lse - flash_attention_plain(q, k, v, causal=False,
                                                         return_lse=True)[1]).abs().max())
        if not lse_err <= TOL_F32["atol"]:
            raise AssertionError(f"flash_attention_cross lse off the plain one by {lse_err}")
        rel, ms = grad_check(FlashAttentionCrossFn.apply,
                             lambda *a: flash_attention_plain(*a, causal=False),
                             (q, k, v), r(B, Sq, H, D))
        res[f"cross_fn_{name}"] = dict(shape=[B, Sq, Sk, H, Hkv, D], rel_err=rel,
                                       backward_ms=ms, lse_max_abs_err=lse_err)
        release()
    x, w, dy = r(4096, 2048), r(2048, 2048, sc=2048 ** -0.5), r(4096, 2048)
    res["linear"] = grad_check(linear, torch.matmul, (x, w), dy)[0]
    res["mm_f32"] = grad_check(mm_f32, torch.matmul, (x, w), dy)[0]

    cfg = small_bundle_cfg()
    bundle = build(cfg)
    toks = torch.from_numpy(np.random.default_rng(seed).integers(0, cfg.vocab, (4, 64)))
    res["train_step"], pg = compare_train_step(bundle, bundle.init(seed, device="cuda"),
                                               {"tokens": toks})
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        path = os.path.join(tmp, "small.npz")
        checkpoint.save(path, pg, extra={"step": 1})
        loaded, extra = checkpoint.load(path, like=pg)
        same = all(torch.equal(a, b) and a.device == b.device
                   for a, b in zip(tree_leaves(pg), tree_leaves(loaded)))
    res["checkpoint_round_trip_bit_equal"] = same and extra == {"step": 1}
    if not res["checkpoint_round_trip_bit_equal"]:
        raise AssertionError("checkpoint round trip on the card is not bit-equal")
    del pg, loaded
    release()
    return res


def train_model(seed: int, kernels):
    """Phase 16: Qwen2-MoE-A2.7B at published widths, TRAIN_LAYERS of 24,
    B=2 x S=2048 from ``SyntheticLM``, AdamW under examples/train_moe.py's
    ``cosine_schedule(2e-3, warmup=10)``: TRAIN_STEPS steps, then
    TRAIN_MICRO_STEPS with ``microbatches=2``. Every loss finite, the last
    below the first; the kernels' counts reset just before, > 0 after."""
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models.model import build
    from repro_torch.training.optimizer import AdamW, cosine_schedule, tree_leaves
    from repro_torch.training.train_loop import make_train_step
    cfg = dataclasses.replace(get_config("qwen2_moe_a2_7b"), n_layers=TRAIN_LAYERS)
    bundle = build(cfg)
    params = bundle.init(seed, device="cuda")
    n_params = sum(t.numel() for t in tree_leaves(params))
    total = TRAIN_STEPS + TRAIN_MICRO_STEPS
    opt = AdamW(lr=cosine_schedule(2e-3, warmup=10, total=total))
    state = opt.init(params)
    it = SyntheticLM(cfg.vocab, seed=seed).batches(BUNDLE_B, BUNDLE_S)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels:
        fn.launches = 0
    rows = []
    for i in range(total):
        mb = 1 if i < TRAIN_STEPS else 2
        step = make_train_step(bundle, opt, microbatches=mb)
        batch = {"tokens": torch.from_numpy(next(it)).cuda()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch)
        loss, gn = float(m["loss"]), float(m["grad_norm"])
        wall = time.perf_counter() - t0
        rows.append(dict(step=i, microbatches=mb, loss=loss, grad_norm=gn, wall_s=wall,
                         tokens_per_s=BUNDLE_B * BUNDLE_S / wall))
    launches = {fn.__name__: fn.launches for fn in kernels}
    losses = [r["loss"] for r in rows]
    res = dict(phase="train", model=cfg.name, layers=cfg.n_layers, n_params=n_params,
               batch=BUNDLE_B, seq=BUNDLE_S, steps=rows,
               step_wall_s_median=float(np.median([r["wall_s"] for r in rows[1:TRAIN_STEPS]])),
               max_memory_allocated=torch.cuda.max_memory_allocated(), launches=launches)
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        emit(res)
        raise AssertionError(f"train: losses {losses}")
    missing = [n for n, c in launches.items() if c == 0]
    if missing:
        raise AssertionError(f"kernels never launched by the train phase: {missing}")
    del params, state
    release()
    return res

# -- phases 16b-16c: training every family ---------------------------------

TRAIN_FAMILIES = ("ssm", "hybrid", "encdec", "vlm", "pattern")
# the ssm leaves that a scan without a gradient left at zero
SCAN_LEAVES = ("A_log", "dt_bias", "conv_B", "conv_C")


def check_train_families(seed: int):
    """Phase 16b: one train step of each family's small bundle (the ssm of
    ``ssm_check``; the others of SMALL_FAMILIES at their gated depths) on
    the card against the CPU (``compare_train_step``), 4 x 41 tokens (the
    hybrid 4 x 101, past its window of 64). The vlm's gates are one sum of
    bf16 products over every position, which cancel, so they are held
    against the CPU's f32 step (``activations_f32``) by F32_RATIO instead.
    The ssm's record names SCAN_LEAVES."""
    from repro_torch.models.model import build
    from repro_torch.training.optimizer import tree_map
    rows = []
    for name in TRAIN_FAMILIES:
        bundle = build(small_ssm_cfg()) if name == "ssm" else small_family(name)
        cfg = bundle.cfg
        gpu, _ = timed_init(bundle, seed)
        batch = model_batch(cfg, 4, 100 if cfg.family == "hybrid" else 40, seed, "cpu")
        exact = None
        if cfg.family == "vlm":
            with activations_f32():
                g32 = train_step_record(bundle, tree_map(lambda t: t.float().cpu(), gpu),
                                        batch)[3]
            exact = {n: t for n, t in zip(leaf_names(gpu), g32) if "/gate_" in n}
        res, _ = compare_train_step(bundle, gpu, batch, exact)
        row = dict(family=name, config=cfg.name, layers=cfg.n_layers, widths=widths(cfg),
                   tokens=list(batch["tokens"].shape), **res)
        if name == "ssm":
            row["scan_leaves"] = {k: res["leaves"][f"layers/ssm/{k}"] for k in SCAN_LEAVES}
        rows.append(row)
        del gpu
        release()
    return dict(phase="train_families_check", grad_tol=STEP_GRAD_TOL, models=rows)


# (family, config id, layers, batch, tokens) at published widths, every
# weight, gradient and AdamW moment on the card: 12 bytes a parameter (bf16
# weights and gradients, f32 m and v). Mamba2-2.7B at 32 of 64 layers (all 64
# are 2.7 B parameters, 32 GB, peak 39 GB: they ran until the mesh phase took
# in FSDP and its launcher runs), SeamlessM4T-medium at 12 + 12, gemma3-1b at
# all 26 through build_dense_pattern; Zamba2-7B at TRAIN_HYBRID_LAYERS of 81,
# 6 whole blocks of 6 Mamba layers and one application of the shared block
# (the deepest whole-block cut that fits is 72, 5.93 B parameters, 71 GB, peak
# 79.2 GB of the card's 85 on NVIDIA H100 80GB HBM3; it ran at 72 until the
# same cut); Llama-3.2-Vision-90B at one block of 5 (4 self + 1 cross layers,
# 4.28 B, plus the tied 1.05 B embedding: 5.34 B, 64 GB)
TRAIN_HYBRID_LAYERS = 36
TRAIN_FAMILY_RUNS = (("ssm", "mamba2_2_7b", 32, 2, 2048),
                     ("encdec", "seamless_m4t_medium", 12, 2, 2048),
                     ("pattern", "gemma3_1b", 26, 2, 2048),
                     ("hybrid", "zamba2_7b", TRAIN_HYBRID_LAYERS, 1, 4096),
                     ("vlm", "llama_3_2_vision_90b", 5, 2, 2048))
TRAIN_FAMILY_STEPS = 4
# a constant learning rate on one batch. AdamW's first steps move every
# weight by about the rate whatever its gradient's size, and at full width
# that overshoots: at 1e-4 (and under the train phase's warm-up from 2e-4)
# SeamlessM4T read 12.9, 11.6, 12.7 and Llama-3.2-Vision 12.2, 20.6, 16.8;
# at 1e-5 four of the five fall at every step and the vlm reads 12.2, 14.1,
# 9.5, 9.5 (NVIDIA H100 80GB HBM3)
TRAIN_FAMILY_LR = 1e-5


@contextlib.contextmanager
def timed_backwards():
    """CUDA events around every plain backward of the kernels' autograd
    Functions inside the block; yields a dict that, after the block, holds
    each Function's summed ms and count."""
    from repro_torch.kernels.expert_ffn import ExpertFFNFn
    from repro_torch.kernels.flash_attention import FlashAttentionCrossFn, FlashAttentionFn
    from repro_torch.kernels.ssd_scan import SSDScanFn
    fns = (SSDScanFn, FlashAttentionFn, FlashAttentionCrossFn, ExpertFFNFn)
    events = {fn.__name__: [] for fn in fns}
    saved = {fn: fn.backward for fn in fns}

    def wrap(fn, orig):
        def backward(ctx, *grads):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            out = orig(ctx, *grads)
            b.record()
            events[fn.__name__].append((a, b))
            return out
        return staticmethod(backward)

    for fn in fns:
        fn.backward = wrap(fn, saved[fn])
    out = {}
    try:
        yield out
    finally:
        for fn in fns:
            fn.backward = staticmethod(saved[fn])
        torch.cuda.synchronize()
        out.update({n: dict(ms=sum(a.elapsed_time(b) for a, b in ev), calls=len(ev))
                    for n, ev in events.items() if ev})


def train_family(family: str, arch: str, layers: int, B: int, S: int, seed: int, kernels):
    """One model of TRAIN_FAMILY_RUNS at published widths: TRAIN_FAMILY_STEPS
    AdamW steps at a constant ``TRAIN_FAMILY_LR`` on one batch of
    ``SyntheticLM`` tokens (and numpy-normal stub frontend inputs), so that
    each step's loss is the same function's. Every loss finite, the last
    below the first; the kernels' counts reset just before and read just
    after; step wall, tokens/s, peak memory, and the plain backwards' ms and
    share of the last step (``timed_backwards``)."""
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models.model import build, build_dense_pattern
    from repro_torch.training.optimizer import AdamW, tree_leaves
    from repro_torch.training.train_loop import make_train_step
    full_cfg = get_config(arch)
    cfg = dataclasses.replace(full_cfg, n_layers=layers)
    bundle = (build_dense_pattern if family == "pattern" else build)(cfg)
    torch.cuda.reset_peak_memory_stats()
    params, t_init = timed_init(bundle, seed)
    n_params = sum(t.numel() for t in tree_leaves(params))
    opt = AdamW(lr=TRAIN_FAMILY_LR)
    state = opt.init(params)
    step = make_train_step(bundle, opt)
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(next(SyntheticLM(cfg.vocab, seed=seed).batches(B, S)))}
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.n_frontend_tokens, cfg.frontend_dim), dtype=np.float32))
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (B, S, cfg.frontend_dim), dtype=np.float32))
    batch = {k: v.cuda() for k, v in batch.items()}
    for fn in kernels:
        fn.launches = 0
    rows = []
    for i in range(TRAIN_FAMILY_STEPS):
        last = i == TRAIN_FAMILY_STEPS - 1
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with (timed_backwards() if last else contextlib.nullcontext({})) as bwd:
            params, state, m = step(params, state, batch)
            loss, gn = float(m["loss"]), float(m["grad_norm"])
        wall = time.perf_counter() - t0
        rows.append(dict(step=i, loss=loss, grad_norm=gn, wall_s=wall,
                         tokens_per_s=B * S / wall))
    launches = {fn.__name__: fn.launches for fn in kernels}
    plain_ms = sum(v["ms"] for v in bwd.values())
    losses = [r["loss"] for r in rows]
    res = dict(phase="train_families", family=family, model=cfg.name, layers=layers,
               published_layers=full_cfg.n_layers, widths=widths(cfg), n_params=n_params,
               state_bytes=12 * n_params, batch=B, seq=S, init_s=t_init, steps=rows,
               step_wall_s=rows[-1]["wall_s"], tokens_per_s=rows[-1]["tokens_per_s"],
               plain_backward=bwd, plain_backward_ms=plain_ms,
               plain_backward_share=plain_ms / 1e3 / rows[-1]["wall_s"],
               max_memory_allocated=torch.cuda.max_memory_allocated(), launches=launches)
    if layers < full_cfg.n_layers:
        res["cut"] = f"depth: {layers} of {full_cfg.n_layers} layers"
    if cfg.family == "vlm":
        res["gates"] = FAMILY_GATES
    need = {"ssm": ("ssd_scan",), "hybrid": ("ssd_scan", "flash_attention"),
            "encdec": ("flash_attention", "flash_attention_cross"),
            "vlm": ("flash_attention", "flash_attention_cross")}.get(family, ("flash_attention",))
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        emit(res)
        raise AssertionError(f"train_families: {cfg.name} losses {losses}")
    missing = [n for n in need if launches[n] == 0]
    if missing:
        raise AssertionError(f"kernels never launched by {cfg.name}'s training: {missing}")
    del params, state
    return res


def train_families(seed: int, kernels):
    """Phase 16c: each of TRAIN_FAMILY_RUNS, released in between; the
    launches summed over them."""
    launches = {}
    for run in TRAIN_FAMILY_RUNS:
        r = train_family(*run, seed, kernels)
        emit(r)
        for n, c in r["launches"].items():
            launches[n] = launches.get(n, 0) + c
        release()
    return dict(phase="train_families", launches=launches)


# -- phase 3, continued: the kernel variants of the remaining families --------

def cross_attention(B, Sq, Sk, H, Hkv, D, g, reps: int = 20, plain_reps: int = 5):
    """``flash_attention_cross``, Sq queries over Sk memory keys (no mask):
    held against the plain version (``rows``), a planted fault (the plain
    version over the first half of the memory) failing the same check, the
    rows of a call with Sk = Sq bit-equal to the monolithic kernel's
    without a mask, timed beside the plain version and beside SDPA held to
    its fused kernels. Bound: q, k, v read and o written once;
    4 D operations per (query, key) pair of each head. Returns the inputs
    and the record."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention, flash_attention_cross,
                                                     flash_attention_plain)
    r = lambda *s: torch.randn(s, generator=g, device="cuda").to(torch.bfloat16)
    q, k, v = r(B, Sq, H, D), r(B, Sk, Hkv, D), r(B, Sk, Hkv, D)
    o = flash_attention_cross(q, k, v)
    err = max_err(o, flash_attention_plain(q, k, v, causal=False), rows=True)
    h = Sk // 2
    faults = planted({f"the first {h} memory keys": lambda: max_err(
        o, flash_attention_plain(q, k[:, :h], v[:, :h], causal=False), rows=True)})
    del o
    n = min(Sq, Sk)
    if not torch.equal(flash_attention_cross(q[:, :n], k[:, :n], v[:, :n]),
                       flash_attention(q[:, :n], k[:, :n], v[:, :n], causal=False)):
        raise AssertionError("flash_attention_cross: rows differ from the monolithic kernel's")
    library = lambda: F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), enable_gqa=True)
    timed = device_vs_library(lambda: flash_attention_cross(q, k, v), fused_sdpa(library),
                              reps)
    plain_ms = time_ms(lambda: flash_attention_plain(q, k, v, causal=False), reps=plain_reps,
                       warmup=min(3, plain_reps))
    bms, by = bound(2 * (2 * B * Sq * H * D + 2 * B * Sk * Hkv * D), 4 * B * H * D * Sq * Sk)
    return (q, k, v), dict(shape=dict(B=B, Sq=Sq, Sk=Sk, H=H, Hkv=Hkv, D=D), max_abs_err=err,
                           planted=faults, bit_equal_to_monolithic=True, plain_ms=plain_ms,
                           bound_ms=bms, bound_by=by, bound_share=bms / timed["device_ms"],
                           **timed)


def cross_decode(B, M, H, Hkv, D, g):
    """The cross-attention decode as the port runs it: ``flash_decode`` with
    pos 0 and every memory slot at position 0 (all valid), against the
    plain version (``rows``), ``decode_faults`` failing the same check,
    timed beside SDPA without a mask."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_decode import flash_decode, flash_decode_plain
    r = lambda *s: torch.randn(s, generator=g, device="cuda").to(torch.bfloat16)
    q, k, v = r(B, H, D), r(B, M, Hkv, D), r(B, M, Hkv, D)
    args = (q, k, v, torch.zeros(B, dtype=torch.int32, device="cuda"),
            torch.zeros(M, dtype=torch.int32, device="cuda")[None].expand(B, M))
    out = flash_decode(*args)
    err = max_err(out, flash_decode_plain(*args), rows=True)
    faults = decode_faults(out, *args)
    del out
    timed = device_vs_library(lambda: flash_decode(*args),
                              lambda: F.scaled_dot_product_attention(
                                  q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
                                  enable_gqa=True))
    plain_ms = time_ms(lambda: flash_decode_plain(*args), reps=5)
    bms, by = decode_bound(H, Hkv, D, B * M, B, M)
    return dict(B=B, W=M, H=H, Hkv=Hkv, D=D, cross=True, max_abs_err=err,
                planted=faults, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                bound_share=bms / timed["device_ms"],
                parts=kernel_parts_ms(lambda: flash_decode(*args)), **timed)


def attention_err(B, Sq, Sk, H, Hkv, D, g, cross: bool = False, window: int = -1):
    """The largest error of one attention call against its plain version on
    fresh inputs: ``flash_attention`` (causal, under ``window``) where Sq =
    Sk, else ``flash_attention_cross``."""
    from repro_torch.kernels.flash_attention import (flash_attention, flash_attention_cross,
                                                     flash_attention_plain)
    r = lambda *s: torch.randn(s, generator=g, device="cuda").to(torch.bfloat16)
    q, k, v = r(B, Sq, H, D), r(B, Sk, Hkv, D), r(B, Sk, Hkv, D)
    if cross:
        return max_err(flash_attention_cross(q, k, v),
                       flash_attention_plain(q, k, v, causal=False), rows=True)
    return max_err(flash_attention(q, k, v, window=window),
                   flash_attention_plain(q, k, v, window=window), rows=True)


def ring_decode(cfg, W: int, pos: int, window: int, g, reps: int = 20, timed: bool = True,
                B: int = 1):
    """``flash_decode`` at B rows' step of position ``pos`` over a ring of
    W slots that has wrapped (``launch.input_specs.ring_slot_pos``: slot s
    holds the newest position up to ``pos`` that is s mod W), under
    ``window``: held against the plain version (``rows``),
    ``decode_faults`` failing the same check, and with ``timed`` timed
    beside it and beside SDPA with the same mask. Bound: the live slots' K
    and V rows once."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_decode import flash_decode, flash_decode_plain, n_splits
    from repro_torch.launch.input_specs import ring_slot_pos
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    r = lambda *s: torch.randn(s, generator=g, device="cuda").to(torch.bfloat16)
    q, k, v = r(B, H, D), r(B, W, Hkv, D), r(B, W, Hkv, D)
    sp = ring_slot_pos(W, pos + 1, "cuda")[None].expand(B, -1).contiguous()
    p = torch.full((B,), pos, dtype=torch.int32, device="cuda")
    args = (q, k, v, p, sp)
    out = flash_decode(*args, window=window)
    err = max_err(out, flash_decode_plain(*args, window=window), rows=True)
    ok = (sp >= 0) & (sp <= pos) & ((sp > pos - window) if window > 0 else True)
    rec = dict(B=B, W=W, H=H, Hkv=Hkv, D=D, pos=pos, window=window, live=int(ok.sum()),
               n_split=n_splits(Hkv, W), max_abs_err=err,
               planted=decode_faults(out, *args, window=window))
    if not timed:
        return rec
    mask = ok[:, None, None, :]
    timed = device_vs_library(lambda: flash_decode(*args, window=window),
                              lambda: F.scaled_dot_product_attention(
                                  q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
                                  attn_mask=mask, enable_gqa=True), reps)
    plain_ms = time_ms(lambda: flash_decode_plain(*args, window=window), reps=5)
    bms, by = decode_bound(H, Hkv, D, rec["live"], B, W)
    return dict(rec, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                bound_share=bms / timed["device_ms"], **timed)


def family_kernel_variants(g):
    """The kernel shapes no earlier path runs, held against their plain
    versions and timed beside them, beside SDPA where SDPA computes the
    same function, and beside the bound. Each record is timed at one
    shape; ``forward_max_abs_err`` is the error at the families phase's
    own forward length (S + 1 tokens, a ragged last tile or chunk) where
    the record's shape is the prefill's (S). Zamba2's attention and scan
    are timed at a full window (S = 4096) and at the families phase's
    5120-token prefill, where the window masks keys and whole key tiles
    are skipped; its decode is checked over the wrapped ring that prompt
    leaves. Returns {kernel name: [variant records]}."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain
    zamba, gemma, granite = (get_config(a) for a in ("zamba2_7b", "gemma3_1b", "granite_34b"))
    vision, seamless = get_config("llama_3_2_vision_90b"), get_config("seamless_m4t_medium")
    out = {"flash_attention": [], "flash_attention_cross": [], "flash_decode": [],
           "ssd_scan": []}

    def add(kernel, variant, rec):
        rec = dict(variant=variant, **rec)
        emit(dict(phase="kernel_variant", name=kernel, tol=TOL_F32 if kernel == "ssd_scan"
                  else TOL, **rec))
        out[kernel].append(rec)
        release()

    shapes = flash_attention_shapes()
    # Zamba2's shared block (D = 112, 32 / 32) under its 4096-token window
    zw, S = zamba.sliding_window, FAMILY_HYBRID_S
    _, rec = shapes["zamba"].make(g)
    add("flash_attention", shapes["zamba"].label, rec)
    _, rec = shapes["zamba_window"].make(g)
    rec["forward_max_abs_err"] = attention_err(1, S + 1, S + 1, zamba.n_heads,
                                               zamba.n_kv_heads, zamba.hd, g, window=zw)
    add("flash_attention", shapes["zamba_window"].label, rec)
    # gemma3-1b: D = 256, 4 / 1, a global layer; a local layer's window checked too
    (q, k, v), rec = shapes["gemma"].make(g)
    w = gemma.sliding_window
    rec["window_max_abs_err"] = max_err(flash_attention(q, k, v, window=w),
                                        flash_attention_plain(q, k, v, window=w), rows=True)
    del q, k, v
    rec["forward_max_abs_err"] = attention_err(2, BUNDLE_S + 1, BUNDLE_S + 1, gemma.n_heads,
                                               gemma.n_kv_heads, gemma.hd, g)
    add("flash_attention", shapes["gemma"].label, rec)
    for key, cfg, Sk in (("vision", vision, vision.n_frontend_tokens),
                         ("seamless", seamless, BUNDLE_S)):
        _, rec = shapes[key].make(g)
        rec["forward_max_abs_err"] = attention_err(2, BUNDLE_S + 1, Sk, cfg.n_heads,
                                                   cfg.n_kv_heads, cfg.hd, g, cross=True)
        add("flash_attention_cross", shapes[key].label, rec)
    W = BUNDLE_S + BUNDLE_NEW
    rec = decode_attention(zamba, zw, [zw - 1])
    rec["wrapped_ring_max_abs_err"] = max(
        ring_decode(zamba, zw, p, zw, g, timed=False)["max_abs_err"]
        for p in (S, S + BUNDLE_NEW - 1))
    add("flash_decode", "D=112 (Zamba2-7B, a full 4096-slot ring)", rec)
    add("flash_decode", "D=256 (gemma3-1b)", decode_attention(gemma, W, [W - 1] * 2))
    add("flash_decode", "G=48 (granite-34b)", decode_attention(granite, W, [W - 1] * 2))
    add("flash_decode", "cross decode (Llama-3.2-Vision-90B)",
        cross_decode(2, vision.n_frontend_tokens, vision.n_heads, vision.n_kv_heads,
                     vision.hd, g))
    scan = (zamba.ssm_expand * zamba.d_model // zamba.ssm_head_dim, zamba.ssm_groups,
            zamba.ssm_head_dim, zamba.ssm_state)
    _, rec = ssd_scan_shape(g, zw, *scan)
    add("ssd_scan", "(P, N) = (64, 64) (Zamba2-7B, S=4096)", rec)
    _, rec = ssd_scan_shape(g, S, *scan)
    a = ssd_inputs(g, 1, S + 1, scan[0], *scan[1:], torch.bfloat16)
    (y, h), (y0, h0) = ssd_scan(*a), ssd_scan_plain(*a)
    rec["forward_max_abs_err"] = max(max_err(y, y0, TOL_F32), max_err(h, h0, TOL_F32))
    del a, y, h, y0, h0
    add("ssd_scan", f"(P, N) = (64, 64) (Zamba2-7B, S={S})", rec)
    return out


# -- phases 17-18: the remaining model families -------------------------------

# each family's reduced config at the kernels' widths, as (config id,
# overrides): the hybrid at 3 layers (a block of two Mamba layers and the
# shared block, a tail of one; head_dim 112, (P, N) = (64, 64), window 64),
# the enc-dec at 1 + 1 (head_dim 64), the vlm at 2 (a self and a cross
# layer; head_dim 128, G = 4), the pattern stack at 2 (a local and a global
# layer, window 8; head_dim 256, G = 4) and a granite-shaped dense model
# with 48 query heads on one KV head
SMALL_FAMILIES = {
    "hybrid": ("zamba2_7b", dict(n_layers=3, head_dim=112, ssm_head_dim=64, ssm_state=64)),
    "encdec": ("seamless_m4t_medium", dict(n_layers=1, enc_layers=1, head_dim=64)),
    "vlm": ("llama_3_2_vision_90b", dict(n_layers=2, head_dim=128, n_kv_heads=1)),
    "pattern": ("gemma3_1b", dict(n_layers=2, local_global_pattern=1, sliding_window=8,
                                  head_dim=256)),
    "dense_g48": ("granite_34b", dict(n_heads=48, head_dim=64)),
}
# the depths at which the gated check first ran these three. There card
# and CPU part by up to 1.44 times BUNDLE_TOL x (1 + |logit|) (6 of 9
# draws past it, NVIDIA H100 80GB HBM3), while the card's logits are 0.52
# to 1.17 times as far from the f32 logits as the CPU's bf16 ones: both
# part from exact by bf16 rounding alike. ``rounding_witness`` holds them
# so, and the gated check runs the shallower stacks above
SMALL_DEEP = {"encdec": dict(n_layers=2, enc_layers=2), "vlm": dict(n_layers=4),
              "pattern": dict(n_layers=5)}
WITNESS_SEEDS = (0, 1, 2)
# the card's forward logits may be at most this many times as far from the
# CPU's f32 logits as the CPU's bf16 logits are
F32_RATIO = 2.0


def small_family(name: str, deep: bool = False):
    """The bundle of one of SMALL_FAMILIES (at its SMALL_DEEP depth with
    ``deep``); the pattern stack through ``build_dense_pattern``."""
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.models.model import build, build_dense_pattern
    arch, kw = SMALL_FAMILIES[name]
    cfg = dataclasses.replace(reduced(get_config(arch)),
                              **(kw | (SMALL_DEEP[name] if deep else {})))
    return (build_dense_pattern if name == "pattern" else build)(cfg)


def decode_tol(cfg) -> float:
    return HYBRID_DECODE_TOL if cfg.family == "hybrid" else DECODE_TOL


def check_families_small(seed: int):
    """Phase 17: each of SMALL_FAMILIES through ``check_model_small`` on
    2 x 40 tokens (the hybrid 2 x 100, past its window of 64), decode vs
    forward within the family's full-width limit. The vlm adds a control
    that drops its cross path (the CPU with its gates at zero); the pattern
    stack's logits must equal ``build_dense``'s on the card. Then
    ``rounding_witness``."""
    from repro_torch.models.model import build_dense
    from repro_torch.models.params import init_params
    rows = []
    with torch.no_grad():
        for name in SMALL_FAMILIES:
            bundle = small_family(name)
            cfg = bundle.cfg
            gpu, _ = timed_init(bundle, seed)
            batch = model_batch(cfg, 2, 100 if cfg.family == "hybrid" else 40, seed, "cpu")
            controls = None
            if cfg.family == "vlm":
                dropped = set_gates(to_cpu(gpu), (0.0, 0.0))
                controls = lambda g, c: [(g["full"], bundle.forward(dropped, batch)[0]
                                          .float()[..., :cfg.vocab])]
            res = dict(family=name, **check_model_small(bundle, gpu, batch, decode_tol(cfg),
                                                         controls))
            if cfg.family == "vlm":
                res["gates"] = FAMILY_GATES
            if name == "pattern":
                t = {"tokens": batch["tokens"].cuda()}
                fd, _ = build_dense(cfg).forward(init_params(cfg, seed, "cuda"), t)
                if not torch.equal(bundle.forward(gpu, t)[0], fd):
                    raise AssertionError("families_check: build_dense_pattern's logits differ "
                                         "from build_dense's on the card")
                res["pattern_equals_build_dense"] = True
            rows.append(res)
        witness = rounding_witness()
    release()
    return dict(phase="families_check", tol=BUNDLE_TOL, tie=TIE, models=rows,
                rounding=witness)


@contextlib.contextmanager
def activations_f32():
    """The port's activation type set to f32 (tests/test_torch_families.py
    sets it so for its f32 cases)."""
    from repro_torch.models import layers as L
    saved, L.PDT = L.PDT, torch.float32
    try:
        yield
    finally:
        L.PDT = saved


def rounding_witness():
    """Where the card and the CPU part, and why. Each family of SMALL_DEEP
    at its gated depth and its deeper one, at WITNESS_SEEDS: forward logits
    over 2 x 41 tokens on the card (bf16, kernels) and on the CPU (bf16,
    plain versions), the card-vs-CPU gap as the share of BUNDLE_TOL x (1 +
    |logit|) it takes, and each run's distance from the CPU in f32 (the
    same weights, activations in f32). The card may be at most F32_RATIO
    times as far from the f32 logits as the CPU's bf16 run is: then both
    part from exact by bf16 rounding alike, and so from each other. A
    control: the vlm on the card with its cross path dropped (gates zero)
    must be further than that."""
    from repro_torch.training.optimizer import tree_map
    rows = []
    for name in SMALL_DEEP:
        for deep in (False, True):
            bundle = small_family(name, deep)
            cfg, real = bundle.cfg, slice(0, bundle.cfg.vocab)
            fwd = lambda p, b: bundle.forward(p, b)[0].float().cpu()[..., real]
            for seed in WITNESS_SEEDS:
                gpu, _ = timed_init(bundle, seed)
                batch = model_batch(cfg, 2, 40, seed, "cpu")
                on = {k: v.cuda() for k, v in batch.items()}
                card, cpu = fwd(gpu, on), fwd(to_cpu(gpu), batch)
                with activations_f32():
                    exact = fwd(tree_map(lambda t: t.float().cpu(), gpu), batch)
                dist = lambda a: float((a - exact).abs().max())
                err = (card - cpu).abs()
                row = dict(family=name, layers=cfg.n_layers, enc_layers=cfg.enc_layers,
                           seed=seed, card_vs_cpu=float(err.max()),
                           limit_share=float((err / (BUNDLE_TOL * (1 + cpu.abs()))).max()),
                           card_vs_f32=dist(card), cpu_vs_f32=dist(cpu))
                row["ratio"] = row["card_vs_f32"] / row["cpu_vs_f32"]
                if cfg.family == "vlm":
                    row["control_ratio"] = dist(fwd(set_gates(gpu, (0.0, 0.0)), on)) / row[
                        "cpu_vs_f32"]
                rows.append(row)
    res = dict(seeds=WITNESS_SEEDS, f32_ratio=F32_RATIO, rows=rows)
    if any(r["ratio"] > F32_RATIO or r.get("control_ratio", np.inf) <= F32_RATIO
           for r in rows):
        emit(res)
        raise AssertionError("families_check: the card parts from the f32 logits further "
                             "than bf16 rounding, or the control does not")
    return res


# (family, config id, layers, batch, prompt tokens): Zamba2-7B at all 81
# layers, one prompt past its 4096-token window; SeamlessM4T-medium at all 12
# + 12 (2 x 2048 text tokens over 2 x 2048 frames); Llama-3.2-Vision-90B at 20
# of 100 layers (4 of 20 blocks, 36 GB of bf16 params; all 100 would be 180
# GB); gemma3-1b at all 26, through build_dense and build_dense_pattern;
# granite-34b at 8 of 88 (9 GB), for its 48 query heads per KV head
FAMILY_HYBRID_S = 5120
FAMILY_RUNS = (("hybrid", "zamba2_7b", 81, 1, FAMILY_HYBRID_S),
               ("encdec", "seamless_m4t_medium", 12, 2, BUNDLE_S),
               ("vlm", "llama_3_2_vision_90b", 20, 2, BUNDLE_S),
               ("pattern", "gemma3_1b", 26, 2, BUNDLE_S),
               ("dense", "granite_34b", 8, 2, BUNDLE_S))
HYBRID_DEPTHS = (6, 12, 24, 48)
HYBRID_SEEDS = (1, 2, 3)


@contextlib.contextmanager
def conv_in_forward_order():
    """The Mamba layer's decode conv summed as its forward sums it, a
    running bf16 sum of the K shifted products in order, in place of one
    reduction over the conv state: a diagnosis of the decode-vs-forward
    gap, never the port's path."""
    from repro_torch.models import ssm
    orig = ssm._conv_step

    def step(state, new, w):
        state = torch.cat([state[:, :, 1:], new[:, :, None]], dim=2)
        return sum(state[:, :, i] * w[None, :, i] for i in range(w.shape[1])), state

    ssm._conv_step = step
    try:
        yield
    finally:
        ssm._conv_step = orig


def hybrid_cut(cfg, params, d: int):
    """(bundle, params) of a hybrid's first d layers (whole blocks), no tail."""
    from repro_torch.models.model import build
    from repro_torch.training.optimizer import tree_map
    n = d // cfg.hybrid_attn_every
    return build(dataclasses.replace(cfg, n_layers=d)), dict(
        {k: params[k] for k in ("embed", "ln_f", "shared")},
        mamba=tree_map(lambda t: t[:n], params["mamba"]))


def family_model(family: str, arch: str, layers: int, B: int, S: int, seed: int, kernels):
    """One model of FAMILY_RUNS at published widths through ``drive``,
    every weight on the card (random, from ``seed``), decode vs forward
    within the family's limit. The hybrid also records the gap at
    HYBRID_DEPTHS, with its decode conv summed in the forward's order
    (``conv_in_forward_order``), and at HYBRID_SEEDS (weights and tokens
    drawn anew, each held to the limit); the pattern stack's logits must
    equal ``build_dense``'s on the same seed's weights."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.model import build, build_dense, build_dense_pattern
    from repro_torch.models.params import init_params
    full_cfg = get_config(arch)
    cfg = dataclasses.replace(full_cfg, n_layers=layers)
    bundle = (build_dense_pattern if family == "pattern" else build)(cfg)
    params, t_init = timed_init(bundle, seed)
    batch = model_batch(cfg, B, S, seed, "cuda")
    tol = decode_tol(cfg)
    need = {"hybrid": ("flash_attention", "flash_decode", "ssd_scan"),
            "encdec": ("flash_attention", "flash_attention_cross", "flash_decode"),
            "vlm": ("flash_attention", "flash_attention_cross", "flash_decode")
            }.get(cfg.family, ("flash_attention", "flash_decode"))
    cuts = ((d, *hybrid_cut(cfg, params, d)) for d in HYBRID_DEPTHS) if family == "hybrid" else ()
    res = dict(phase="families", family=family, model=cfg.name,
               published_layers=full_cfg.n_layers, init_s=t_init,
               **drive(bundle, params, batch, kernels, need, tol, cuts))
    if cfg.family == "vlm":
        res["gates"] = FAMILY_GATES
    if layers < full_cfg.n_layers:
        res["cut"] = f"depth: {layers} of {full_cfg.n_layers} layers"
    with torch.no_grad(), uncounted(kernels):
        if family == "hybrid":
            at = bundle.forward(params, batch)[0][:, S - DECODE_STEPS:].float().cpu()
            with conv_in_forward_order():
                res["decode_vs_forward_conv_in_forward_order"] = decode_vs_forward(
                    bundle, params, batch, at)[0]
            del params, at
            release()
            gaps = {seed: [res["decode_vs_forward_max_abs_err"],
                           res["decode_vs_forward_control"]]}
            for s in HYBRID_SEEDS:
                params, _ = timed_init(bundle, s)
                b = model_batch(cfg, B, S, s, "cuda")
                at = bundle.forward(params, b)[0][:, S - DECODE_STEPS:].float().cpu()
                gaps[s] = list(decode_vs_forward(bundle, params, b, at, tol=tol)[:2])
                del params, at
                release()
            res["decode_vs_forward_by_seed"] = gaps
        if family == "pattern":
            fd, _ = build_dense(cfg).forward(init_params(cfg, seed, "cuda"), batch)
            if not torch.equal(bundle.forward(params, batch)[0], fd):
                raise AssertionError("families: build_dense_pattern's logits differ from "
                                     "build_dense's")
            res["pattern_equals_build_dense"] = True
    return res


def serve_families(seed: int, kernels):
    """Phase 18: each of ``FAMILY_RUNS``, released in between; the
    launches summed over them."""
    launches = {}
    for family, arch, layers, B, S in FAMILY_RUNS:
        r = family_model(family, arch, layers, B, S, seed, kernels)
        emit(r)
        for n, c in r["launches"].items():
            launches[n] = launches.get(n, 0) + c
        release()
    return dict(phase="families", launches=launches)


# -- phase 19: the reference's (arch x input shape) matrix ---------------------

SHAPES_S = 32_768      # prefill_32k / decode_32k
SHAPES_REPS = 5        # timed calls a turn at these sizes (10-100 ms a call)
# decode pairs whose params and cache fit this many host bytes (the CPU's
# copy and its step's copy of the cache) are held against the same step on
# the CPU; the rest (Kimi-K2's 37.6 GB of params, Llama-3.2-Vision's 10.7
# GB beside 8.7 GB of cache) would take minutes of the CPU's bf16 products
SHAPES_HOST_BYTES = 12e9
# stacks of this many layers and more are held against the CPU by the f32
# witness: through gemma3-1b's six layers the card's decode_32k logits
# parted from the CPU's by 0.109, past BUNDLE_TOL (NVIDIA H100 80GB HBM3),
# as families_check found bf16 rounding grow with depth in its stacks
SHAPES_WITNESS_LAYERS = 3
# the kernels every run of the matrix must launch
SHAPES_KERNELS = ("expert_ffn", "flash_attention", "flash_attention_cross", "flash_decode",
                  "ssd_scan")


def shape_kernel_checks(g) -> dict:
    """Each kernel at the sizes the matrix gives it and no earlier phase
    reaches, held against its plain version on the card (TOL; ``ssd_scan``
    TOL_F32; the plain attention goes in blocks of query rows there) and
    timed as the kernel phase times it (device ms, events, the bound, SDPA
    held to its fused kernels or the cuBLAS yardstick, the plain version),
    ``SHAPES_REPS`` calls a turn: ``flash_attention`` at S=32768 (Qwen3-1.7B
    B=2 16 / 8 D=128; gemma3-1b B=2 4 / 1 D=256, global and its window 512;
    Zamba2-7B B=2 32 / 32 D=112 under its window 4096);
    ``flash_attention_cross`` at SeamlessM4T's 2 x 32768 over 32768, D=64;
    ``flash_decode`` at B=8 over W=32768 (32 / 8, D=128) and at the step of
    position 524287 over ``long_500k``'s wrapped rings (gemma3-1b's 131072
    slots, global and window 512; Zamba2-7B's 4096 under its window);
    ``ssd_scan`` at 2 x 32768 (Mamba2-2.7B (64, 128), Zamba2-7B (64, 64));
    ``expert_ffn`` at the capacity rows of Qwen2-MoE-A2.7B's and Kimi-K2's
    ``prefill_32k`` step (2 x 32768 tokens). Returns {kernel: [records]}."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain
    from repro_torch.launch.input_specs import LONG_CACHE_CAP
    from repro_torch.models.moe_layer import capacity_for, n_experts_padded
    c = {a: get_config(a) for a in ("qwen3_1_7b", "gemma3_1b", "zamba2_7b",
                                     "seamless_m4t_medium", "mamba2_2_7b", "mixtral_8x7b",
                                     "qwen2_moe_a2_7b", "kimi_k2_1t_a32b")}
    heads = lambda a: (c[a].n_heads, c[a].n_kv_heads, c[a].hd)
    S, R, long_pos = SHAPES_S, SHAPES_REPS, 524_287
    out = {n: [] for n in SHAPES_KERNELS}

    def add(kernel, variant, rec):
        rec = dict(variant=variant, **rec)
        emit(dict(phase="shape_kernel", name=kernel, tol=TOL_F32 if kernel == "ssd_scan"
                  else TOL, **rec))
        out[kernel].append(rec)
        release()

    _, rec = prefill_attention(*heads("qwen3_1_7b"), S, g, B=2, reps=R, plain_reps=1)
    add("flash_attention", "causal, D=128, B=2, S=32768, 16/8 (Qwen3-1.7B prefill_32k)", rec)
    (q, k, v), rec = prefill_attention(*heads("gemma3_1b"), S, g, B=2, reps=R, plain_reps=1)
    w = c["gemma3_1b"].sliding_window
    rec["window_max_abs_err"] = max_err(flash_attention(q, k, v, window=w),
                                        flash_attention_plain(q, k, v, window=w), rows=True)
    del q, k, v
    add("flash_attention", "D=256, B=2, S=32768, 4/1 (gemma3-1b prefill_32k, global; "
        "window 512 held too)", rec)
    zw = c["zamba2_7b"].sliding_window
    _, rec = prefill_attention(*heads("zamba2_7b"), S, g, B=2, window=zw, reps=R,
                               plain_reps=1)
    add("flash_attention", "D=112, B=2, S=32768, 32/32, window 4096 (Zamba2-7B prefill_32k)",
        rec)
    _, rec = cross_attention(2, S, S, *heads("seamless_m4t_medium"), g, reps=R,
                             plain_reps=1)
    add("flash_attention_cross", "B=2, 32768 over 32768, 16/16, D=64 (SeamlessM4T-medium "
        "prefill_32k)", rec)
    add("flash_decode", "B=8, W=32768, 32/8, D=128, pos 32767 (decode_32k)",
        decode_attention(c["mixtral_8x7b"], S, [S - 1] * 8, reps=R))
    gemma = c["gemma3_1b"]
    for window in (-1, gemma.sliding_window):
        add("flash_decode", f"gemma3-1b long_500k: {LONG_CACHE_CAP}-slot ring at pos "
            f"{long_pos}, 4/1, D=256, window {window}",
            ring_decode(gemma, LONG_CACHE_CAP, long_pos, window, g, reps=R))
    add("flash_decode", f"Zamba2-7B long_500k: {zw}-slot ring at pos {long_pos}, 32/32, "
        "D=112", ring_decode(c["zamba2_7b"], zw, long_pos, zw, g, reps=R))
    for a in ("mamba2_2_7b", "zamba2_7b"):
        cfg = c[a]
        scan = (cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim, cfg.ssm_groups,
                cfg.ssm_head_dim, cfg.ssm_state)
        _, rec = ssd_scan_shape(g, S, *scan, B=2, reps=R)
        add("ssd_scan", f"({scan[2]}, {scan[3]}), B=2, S=32768, H={scan[0]} ({cfg.name} "
            "prefill_32k)", rec)
    for a in ("qwen2_moe_a2_7b", "kimi_k2_1t_a32b"):
        cfg = c[a]
        E = n_experts_padded(cfg)
        C = capacity_for(2 * S, cfg, E, cfg.capacity_factor)
        add("expert_ffn", f"E={E}, C={C}, d={cfg.d_model}, f={cfg.d_expert} ({cfg.name} "
            "prefill_32k capacity rows)",
            expert_ffn_check(E, C, cfg.d_model, cfg.d_expert, pool=False, reps=R,
                             plain_reps=1))
    return out


# every family's V leaves ([..., slots, Hkv, hd]; "mv" the cross memory)
V_LEAVES = ("v", "v0", "vt", "av", "mv")


def read_cache(cfg, cache) -> dict:
    """``cache`` with each layer's V rows scaled by the square root of the
    slots the layer reads (its window's, or the whole ring's or memory's).
    Unit-normal values averaged over n slots give attention outputs of
    about n^-1/2, too small for the logits to show a step that misreads the
    cache body; scaled, every layer's output is O(1), as over a short
    prompt, and a local layer's does not drown a global one's."""
    out = dict(cache)
    for k in V_LEAVES:
        if k not in cache:
            continue
        t = cache[k]
        W, lead = t.shape[-3], t.shape[:-4]
        first = {"v": cfg.n_dense_layers, "v0": 0,
                 "vt": cfg.n_layers - math.prod(lead)}.get(k)
        if first is None:   # the hybrid's shared block, the cross memory
            windows = [cfg.sliding_window if k == "av" and cfg.sliding_window else -1]
        else:
            windows = [cfg.window_for_layer(first + i) for i in range(math.prod(lead))]
        n = torch.tensor([min(w, W) if w > 0 else W for w in windows], dtype=torch.float32)
        scale = n.sqrt().reshape(lead if first is not None else ()).to(t.device)
        out[k] = (t * scale.reshape(scale.shape + (1,) * 4)).to(t.dtype)
    return out


def misread(cache) -> dict:
    """``cache`` with the V rows of slots [W/2, 5W/8) of every V leaf
    zeroed: a step that reads an eighth of the cache body wrongly."""
    out = dict(cache)
    for k in V_LEAVES:
        if k in cache:
            W = cache[k].shape[-3]
            out[k] = cache[k].clone()
            out[k][..., W // 2:W // 2 + W // 8, :, :] = 0
    return out


def decode_vs_cpu(plan, bundle, params, inputs, logits) -> dict:
    """The card's ``decode_step`` logits of a pair against the same step on
    the CPU (the plain versions, the same weights), both over the pair's
    synthesized cache with its V leaves scaled (``read_cache``) so that
    what the step reads of the cache shows in the logits; the CPU's router
    calls take the card's experts (a token whose own choice differs must
    sit at a near-tie). First the card's step over the pair's own cache
    must repeat the dry-run's logits bit for bit. A stack of at most two
    layers is held within ``BUNDLE_TOL``; a deeper one
    (``SHAPES_WITNESS_LAYERS``: gemma3-1b's six, Zamba2-7B's block) by the
    f32 witness, as ``families_check`` holds its deeper stacks: the card at
    most ``F32_RATIO`` times as far from the CPU's step in f32 (weights,
    cache and activations) as the CPU's bf16 step is. Each control must
    fail the same gate: the CPU step one window further on (``pos`` + the
    window, or the ring where the config has none; for the attention-free
    ssm the conv states one step behind) and, where the cache has V
    leaves, the CPU step over ``misread``'s cache."""
    from repro_torch.training.optimizer import tree_map
    cfg = plan.cfg
    with torch.no_grad():
        again, _ = bundle.decode_step(params, inputs["step"], inputs["cache"])
    if not torch.equal(again, logits):
        raise AssertionError(f"{cfg.name}: the card's decode step is not repeatable")
    del again
    scaled = read_cache(cfg, inputs["cache"])
    with routes() as card_routes, torch.no_grad():
        card = bundle.decode_step(params, inputs["step"], scaled)[0].float().cpu()
    host = to_cpu(params)
    step, cache = to_cpu(inputs["step"]), to_cpu(scaled)
    del scaled
    run = lambda p, c: bundle.decode_step(p, step, c)[0].float()
    t0 = time.perf_counter()
    with routes(replay=card_routes) as cpu_routes, torch.no_grad():
        cpu = run(host, cache)
    cpu_s = time.perf_counter() - t0
    n_flips = flips(cpu_routes, card_routes)
    controls = {}
    if "slot_pos" in cache:
        window = cfg.sliding_window or cache["slot_pos"].shape[0]
        controls["pos + window"] = dict(cache, pos=cache["pos"] + window)
    else:
        controls["conv states one step behind"] = dict(
            cache, **{k: torch.roll(cache[k], 1, dims=-1) for k in cache if k.startswith("conv_")})
    if any(k in cache for k in V_LEAVES):
        controls["V of slots [W/2, 5W/8) zeroed"] = misread(cache)
    for what, moved in controls.items():
        with routes(replay=card_routes), torch.no_grad():
            controls[what] = run(host, moved)
    err, ok = logit_err(card, cpu)
    share = lambda a: float(((a - cpu).abs() / (BUNDLE_TOL * (1 + cpu.abs()))).max())
    rec = dict(max_abs_err=err, tol=BUNDLE_TOL, limit_share=share(card),
               controls={what: logit_err(card, c)[0] for what, c in controls.items()},
               own_route_flips_at_ties=n_flips, cpu_step_s=cpu_s)
    passed = {what: logit_err(card, c)[1] for what, c in controls.items()}
    if cfg.n_layers + cfg.enc_layers >= SHAPES_WITNESS_LAYERS:
        f32 = lambda t: t.float() if t.is_floating_point() else t
        with activations_f32(), routes(replay=card_routes), torch.no_grad():
            exact = run(tree_map(f32, host), tree_map(f32, cache))
        dist = lambda a: float((a - exact).abs().max())
        rec.update(gate="f32 witness", f32_ratio=F32_RATIO, card_vs_f32=dist(card),
                   cpu_vs_f32=dist(cpu), ratio=dist(card) / dist(cpu),
                   control_ratios={what: dist(c) / dist(cpu) for what, c in controls.items()})
        ok = rec["ratio"] <= F32_RATIO
        passed = {what: r <= F32_RATIO for what, r in rec["control_ratios"].items()}
    else:
        rec["gate"] = "BUNDLE_TOL"
    if not ok:
        raise AssertionError(f"{cfg.name}: card decode logits part from the CPU's: {rec}")
    if any(passed.values()):
        raise AssertionError(f"{cfg.name}: a control passed the gate: {rec}")
    return rec


def host_bytes(plan) -> int:
    """Host bytes of a decode pair's CPU check: params, the cache and the
    step's copy of it."""
    return plan.bytes["params"] + plan.bytes["cache"]


def shape_pairs(seed: int, kernels) -> dict:
    """Every pair of ``pairs()`` through ``launch/dryrun.py``: its plan from
    bytes, then, where it fits, one warm-up and one timed step of its kind
    at published widths and full sequence length (``dryrun.run_pair``), one
    line each; params drawn once per config (the train step updates them
    in place, the later pairs run on those). Decode pairs within
    ``SHAPES_HOST_BYTES`` are held against the CPU (``decode_vs_cpu``).
    The kernels' counts are reset just before and read just after; each of
    ``SHAPES_KERNELS`` must have launched."""
    from repro_torch.launch import dryrun as D
    t0 = time.perf_counter()
    plans = D.plan_all()
    for fn in kernels:
        fn.launches = 0
    rows, no_fit, params, arch = [], [], None, None
    for plan in plans:
        if plan.arch != arch:
            params, arch = None, plan.arch
            release()
        if not plan.fits:
            rec = dict(plan.record(), ok=False)
            no_fit.append(dict(arch=plan.arch, shape=plan.shape.name, reason=plan.reason,
                               planned_bytes=plan.bytes))
        else:
            bundle = D.build_for(plan.cfg)
            if params is None:
                params, init_s = timed_init(bundle, seed)
            rec, outputs, inputs = D.run_pair(plan, "cuda", seed, params=params)
            if plan.kind == "decode" and host_bytes(plan) <= SHAPES_HOST_BYTES:
                rec["cpu_check"] = decode_vs_cpu(plan, bundle, params, inputs,
                                                 outputs["logits"])
            del outputs, inputs
        emit(dict(phase="shape_pair", **rec))
        rows.append({k: rec.get(k) for k in ("arch", "shape", "fits", "batch", "depth",
                                             "reduced", "step_ms", "max_memory_allocated")})
        release()
    params = None
    release()
    launches = {fn.__name__: fn.launches for fn in kernels}
    missing = [n for n in SHAPES_KERNELS if not launches.get(n)]
    if missing:
        raise AssertionError(f"kernels never launched by the matrix: {missing}")
    return dict(phase="shapes", pairs=len(plans), ran=sum(r["fits"] for r in rows),
                no_fit=no_fit, seconds=time.perf_counter() - t0, launches=launches)


def flash_decode_shapes():
    """Every ``flash_decode`` shape a main path runs, as (label, record
    maker): Mixtral-8x7B's serve rows (B=1 at W=545 and 4096) and the batch
    phase's B=8 row, the bundles' (B=2, W=2064), and the families'
    variants (D=112, D=256, G=48, the cross decode)."""
    from repro_torch.configs.base import get_config
    c = {a: get_config(a) for a in ("mixtral_8x7b", "qwen2_moe_a2_7b", "qwen3_1_7b",
                                     "zamba2_7b", "gemma3_1b", "granite_34b",
                                     "llama_3_2_vision_90b")}
    W = BUNDLE_S + BUNDLE_NEW
    zw, vision = c["zamba2_7b"].sliding_window, c["llama_3_2_vision_90b"]
    rows = (("B=1, W=545 (Mixtral-8x7B serve)", "mixtral_8x7b", 545, [544]),
            ("B=1, W=4096 (Mixtral-8x7B)", "mixtral_8x7b", 4096, [4095]),
            ("B=8, W=2048 (Mixtral-8x7B batch phase)", "mixtral_8x7b", 2048,
             [n + BATCH_NEW - 1 for n in BATCH_LENS]),
            ("B=2, W=2064 (Qwen2-MoE-A2.7B)", "qwen2_moe_a2_7b", W, [W - 1] * 2),
            ("B=2, W=2064 (Qwen3-1.7B)", "qwen3_1_7b", W, [W - 1] * 2),
            ("D=112 (Zamba2-7B, W=4096)", "zamba2_7b", zw, [zw - 1]),
            ("D=256 (gemma3-1b)", "gemma3_1b", W, [W - 1] * 2),
            ("G=48 (granite-34b)", "granite_34b", W, [W - 1] * 2))
    return tuple((label, lambda a=arch, w=w, p=p: decode_attention(c[a], w, p))
                 for label, arch, w, p in rows) + (
        ("cross decode (Llama-3.2-Vision-90B)",
         lambda: cross_decode(2, vision.n_frontend_tokens, vision.n_heads, vision.n_kv_heads,
                              vision.hd, torch.Generator(device="cuda").manual_seed(2))),)


def flash_decode_only(src: Path) -> int:
    """``--flash-decode SRC``: every ``flash_decode_shapes`` record, on the
    port's package from ``src``, so two trees' kernels are timed by the same
    code in one call. Prints the card and one ``decode_kernel`` line a
    shape."""
    sys.path.insert(0, str(src))
    from repro_torch.kernels import _build
    emit(dict(phase="device", nvidia_smi=nvidia_smi(), name=torch.cuda.get_device_name(0),
              torch=torch.__version__, cuda=torch.version.cuda))
    _build.build("flash_decode")
    for label, record in flash_decode_shapes():
        emit(dict(phase="decode_kernel", src=str(src), shape=label, **record()))
        release()
    return 0


def flash_attention_only(src: Path) -> int:
    """``--flash-attention SRC``: every ``flash_attention_shapes`` record
    (held against the plain version, timed beside SDPA and the bound), on
    the port's package from ``src``, so two trees' kernels are timed by the
    same code in one call. Prints the card and one ``attention_kernel``
    line a shape."""
    sys.path.insert(0, str(src))
    from repro_torch.kernels import _build
    emit(dict(phase="device", nvidia_smi=nvidia_smi(), name=torch.cuda.get_device_name(0),
              torch=torch.__version__, cuda=torch.version.cuda))
    _build.build("flash_attention")
    g = torch.Generator(device="cuda").manual_seed(0)
    for shape in flash_attention_shapes().values():
        _, record = shape.make(g)
        emit(dict(phase="attention_kernel", src=str(src), kernel=shape.kernel,
                  label=shape.label, **record))
        release()
    return 0


def decode_step_only(src: Path, layers: int, seed: int) -> int:
    """``--decode-step SRC``: the analysis phase's engine and decode steps
    (``mixtral_setup``, ``audit_engine``, ``decode_steps``) on the port's
    package from ``src``, so two trees are timed by the same code in one
    call. Prints the card and one ``decode_step`` line."""
    sys.path.insert(0, str(src))
    from repro_torch.analysis.device_audit import decoding_engine
    from repro_torch.kernels import _build
    emit(dict(phase="device", nvidia_smi=nvidia_smi(), name=torch.cuda.get_device_name(0),
              torch=torch.__version__, cuda=torch.version.cuda))
    _build.build_all()
    mixtral, _, setup = mixtral_setup(layers, seed)
    build, prompts = audit_engine(mixtral, seed)
    eng = decoding_engine(build(), prompts)
    emit(dict(phase="decode_step", src=str(src), model=mixtral[0].name, layers=layers,
              setup=setup, **decode_steps(eng)))
    return 0


def decode_syncs_only(src: Path, seed: int) -> int:
    """``--decode-syncs SRC``: the host syncs of one unsharded ``build_dense``
    decode step (``step_syncs``) of each of ``MESH_DECODE_RUNS``, B=2 after
    a 128-token prefill into 256 slots and one step, with the port's
    package from ``src``, so two trees are counted by the same code in one
    call. Prints the card and one ``decode_syncs`` line a model."""
    sys.path.insert(0, str(src))
    from repro_torch.kernels import _build
    from repro_torch.models.model import build, greedy_token, pad_cache
    emit(dict(phase="device", nvidia_smi=nvidia_smi(), name=torch.cuda.get_device_name(0),
              torch=torch.__version__, cuda=torch.version.cuda))
    _build.build_all()
    for arch, _ in MESH_DECODE_RUNS:
        cfg = mesh_decode_cfg(arch)
        bundle = build(cfg)
        params = bundle.init(seed, device="cuda")
        tokens = mesh_decode_prompts(cfg, seed)[:2, :128].cuda()
        with torch.no_grad():
            logits, cache = bundle.prefill(params, {"tokens": tokens})
            cache = pad_cache(cache, 256, bundle.ring_axes)
            tok = greedy_token(logits, cfg.vocab)
            logits, cache = bundle.decode_step(params, {"token": tok}, cache)
            tok = greedy_token(logits, cfg.vocab)
            syncs = step_syncs(lambda: bundle.decode_step(params, {"token": tok}, cache))
        emit(dict(phase="decode_syncs", src=str(src), model=cfg.name, layers=cfg.n_layers,
                  **syncs))
        del params, cache
        release()
    return 0


# -- phase 20: the (data, model) mesh ------------------------------------------

MESH_ARCH = "qwen2_moe_a2_7b"
MESH_LAYERS = 2
MESH_GRID = (2, 2)          # (data, model)
MESH_B, MESH_S = 4, 4096    # global batch
MESH_STEPS = 2
MESH_LR = 1e-3
MESH_TAIL = 128             # logit positions held, the last of every row
# Limits of the 2 x 2 step against the unsharded one, each near the
# geometric mean of the sound run's reading and the copy_to control's
# (PERF.md, PR 26: sound / control): the loss of each step (2.5e-4 / 0.19)
# and the gradient norm (2.4e-4 / 0.44), relative; each gradient leaf of
# step 1, read from the f32 first moment (m = (1 - b1) * clip scale * g) on
# the rank's ZeRO slice, as its largest difference over the leaf's largest
# entry (6.3e-3 / 1.1); the params after the steps, as the norm of (mesh -
# unsharded) over the norm of the unsharded update, over the whole tree
# (0.027 / 0.92).
MESH_LOSS_TOL = 5e-3
MESH_GN_TOL = 1e-2
MESH_GRAD_TOL = 5e-2
MESH_PARAM_TOL = 0.15


def mesh_kernel_checks(g) -> dict:
    """The kernels at the shapes a rank of a mesh gives them, each held
    against its plain version and timed (``mesh_kernel`` lines): the
    expert FFN at Qwen2-MoE-A2.7B's 30 local experts (60 over 2 model
    ranks) of the mesh phase's capacity rows (``capacity_for`` 2 x 4096
    tokens) and at Mixtral-8x7B's hidden-mode slice (8 experts, f = 14336 /
    16, 4096 rows); the attention at 8 / 8 local heads (Qwen2-MoE's 16 / 16
    over 2) and 2 / 1 (32 / 8 heads over 16 model ranks), B=2 x 4096; the
    decode attention at the mesh phase's rank shapes: with ``lse`` at
    Granite-34B's slot block and Qwen2-MoE's 8 / 8 heads (``lse_decode``,
    an empty row among them), and Qwen2-MoE's call as its heads-sharded
    path makes it (``decode_attention``, no ``lse``)."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.moe_layer import capacity_for
    cfg = get_config(MESH_ARCH)
    cap = capacity_for(MESH_B // MESH_GRID[0] * MESH_S, cfg, cfg.n_experts)
    out = {"expert_ffn": [], "flash_attention": []}
    for variant, (U, C, d, f) in (
            ("qwen2_moe_expert_mode", (cfg.n_experts // MESH_GRID[1], cap, cfg.d_model,
                                       cfg.d_expert)),
            ("mixtral_hidden_mode", (8, 4096, 4096, 14336 // 16))):
        rec = dict(variant=variant, shape=dict(U=U, C=C, d=d, f=f),
                   **expert_ffn_check(U, C, d, f, pool=False))
        rec["library_device_ms"] = rec["cublas_device_ms"]
        emit(dict(phase="mesh_kernel", kernel="expert_ffn", **rec))
        out["expert_ffn"].append(rec)
        release()
    for variant, (H, Hkv) in (("local_8_8", (8, 8)), ("local_2_1", (2, 1))):
        _, rec = prefill_attention(H, Hkv, 128, MESH_S, g, B=2)
        rec["variant"] = variant
        emit(dict(phase="mesh_kernel", kernel="flash_attention", **rec))
        out["flash_attention"].append(rec)
        release()
    out["flash_decode"] = []
    for variant, make in (
            ("granite_slots_48_1",
             lambda: lse_decode(48, 1, 128, MESH_DECODE_W // MESH_GRID[1], g)),
            ("qwen2_moe_heads_8_8_lse", lambda: lse_decode(8, 8, 128, MESH_DECODE_W, g)),
            # the call the heads-sharded path makes: no lse, both rows at
            # position 2047 (prompt 2044 + the steps) of the 4096-slot ring
            ("qwen2_moe_heads_8_8",
             lambda: decode_attention(dataclasses.replace(
                 cfg, n_heads=cfg.n_heads // MESH_GRID[1],
                 n_kv_heads=cfg.n_kv_heads // MESH_GRID[1], head_dim=cfg.hd),
                 MESH_DECODE_W, [2047] * 2))):
        rec = dict(variant=variant, **make())
        emit(dict(phase="mesh_kernel", kernel="flash_decode", **rec))
        out["flash_decode"].append(rec)
        release()
    for part in (mesh_family_kernel_checks(g), mesh_cross_kernel_checks(g)):
        for kernel, recs in part.items():
            out.setdefault(kernel, []).extend(recs)
    return out


def mesh_family_kernel_checks(g) -> dict:
    """``mesh_kernel`` lines of the ssm and hybrid families' rank shapes:
    ``ssd_scan`` at a 2 x 2 rank's heads (Mamba2-2.7B 80 / 2 at (P, N) =
    (64, 128) over its 2 x 4096 shard, Zamba2-7B 112 / 2 at (64, 64) over
    2 x 5120) and at a 16-way model axis's (5 and 7 heads), no library call
    computing it; ``flash_attention`` at Zamba2's 16 / 16 heads of D=112
    under its 4096 window over 2 x 5120; ``flash_decode`` at 16 / 16 over
    its wrapped 4096-slot ring (position 5123, B=2)."""
    from repro_torch.configs.base import get_config
    zcfg = get_config("zamba2_7b")
    out = {"ssd_scan": [], "flash_attention": [], "flash_decode": []}
    m_s, z_s = MESH_FAMILY_RUNS["mamba2_2_7b"][1], MESH_FAMILY_RUNS["zamba2_7b"][1]
    rows = MESH_B // MESH_GRID[0]
    for variant, (S, H, P, N) in (("mamba2_rank_40", (m_s, 80 // MESH_GRID[1], 64, 128)),
                                  ("zamba2_rank_56", (z_s, 112 // MESH_GRID[1], 64, 64)),
                                  ("mamba2_16_ranks_5", (m_s, 80 // 16, 64, 128)),
                                  ("zamba2_16_ranks_7", (z_s, 112 // 16, 64, 64))):
        _, rec = ssd_scan_shape(g, S, H, 1, P, N, B=rows)
        rec.update(variant=variant, library_ms=None)
        emit(dict(phase="mesh_kernel", kernel="ssd_scan", **rec))
        out["ssd_scan"].append(rec)
        release()
    H = zcfg.n_heads // MESH_GRID[1]
    _, rec = prefill_attention(H, H, zcfg.hd, z_s, g, B=rows, window=zcfg.sliding_window)
    rec["variant"] = "zamba2_16_16_d112_w4096"
    emit(dict(phase="mesh_kernel", kernel="flash_attention", **rec))
    out["flash_attention"].append(rec)
    release()
    rank = dataclasses.replace(zcfg, n_heads=H, n_kv_heads=H)
    rec = dict(variant="zamba2_16_16_ring_4096",
               **ring_decode(rank, zcfg.sliding_window, MESH_FAMILY_RUNS["zamba2_7b"][2] + 7,
                             zcfg.sliding_window, g, B=rows))
    emit(dict(phase="mesh_kernel", kernel="flash_decode", **rec))
    out["flash_decode"].append(rec)
    release()
    return out


def lse_decode(H, Hkv, D, W, g, valid: int = 2048, reps: int = 20) -> dict:
    """``flash_decode(return_lse=True)`` at a mesh rank's decode shape, B=2:
    row 0 holds positions 0 .. valid - 1 (a full block of a slot-sharded
    ring, or half of a whole one), row 1 no valid slot (model rank 1's
    block before the ring reaches it). Held against the plain version: o
    (``rows``) and the log-sum-exp of row 0 (``TOL_F32``), row 1's -inf
    exactly and its output 0. Timed beside SDPA over the same mask
    (which has no log-sum-exp output) and the plain version; bound: q, o
    and lse once, the valid slots' K and V rows once."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_decode import flash_decode, flash_decode_plain, n_splits
    B = 2
    r = lambda *s: torch.randn(s, generator=g, device="cuda").to(torch.bfloat16)
    q, k, v = r(B, H, D), r(B, W, Hkv, D), r(B, W, Hkv, D)
    slots = torch.arange(W, dtype=torch.int32, device="cuda")
    sp = torch.stack([torch.where(slots < valid, slots, -1), torch.full_like(slots, -1)])
    pos = torch.full((B,), valid - 1, dtype=torch.int32, device="cuda")
    args = (q, k, v, pos, sp)
    o, lse = flash_decode(*args, return_lse=True)
    o_p, lse_p = flash_decode_plain(*args, return_lse=True)
    err = max_err(o[:1], o_p[:1], rows=True)
    lse_err = max_err(lse[:1], lse_p[:1], TOL_F32)
    if not (torch.isneginf(lse[1]).all() and torch.isneginf(lse_p[1]).all()
            and torch.equal(o[1], torch.zeros_like(o[1]))):
        raise AssertionError("flash_decode: a row with no valid slot must give lse -inf "
                             "and an output of 0")
    mask = ((sp >= 0) & (sp <= pos[:, None]))[:, None, None, :]
    timed = device_vs_library(lambda: flash_decode(*args, return_lse=True),
                              lambda: F.scaled_dot_product_attention(
                                  q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
                                  attn_mask=mask, enable_gqa=True), reps)
    plain_ms = time_ms(lambda: flash_decode_plain(*args, return_lse=True), reps=5)
    n_valid = int(mask.sum())
    bms, by = bound(2 * (2 * B * H * D + 2 * n_valid * Hkv * D) + 4 * B * (W + 1 + H),
                    4 * H * D * n_valid)
    return dict(shape=dict(B=B, H=H, Hkv=Hkv, D=D, W=W, valid=[valid, 0],
                           n_split=n_splits(Hkv, W)),
                max_abs_err=err, lse_max_abs_err=lse_err, empty_row_lse="-inf",
                plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                bound_share=bms / timed["device_ms"], **timed)


def mesh_cfg():
    from repro_torch.configs.base import get_config
    return dataclasses.replace(get_config(MESH_ARCH), n_layers=MESH_LAYERS)


def mesh_batches(cfg, seed: int) -> list:
    """The global batch of each step (``SyntheticLM``, as the launcher
    draws them)."""
    from repro_torch.data.pipeline import SyntheticLM
    it = SyntheticLM(cfg.vocab, seed=seed).batches(MESH_B, MESH_S)
    return [torch.from_numpy(next(it)) for _ in range(MESH_STEPS)]


def mesh_unsharded(seed: int, tmp: Path) -> dict:
    """The function the mesh computes, on one card: params from ``seed``
    with the experts padded by the model axis, the MoE at the config's
    capacity factor and one microbatch a data shard (its capacity is the
    shard's). The forward's logits of each data shard's rows of step 0's
    batch (last ``MESH_TAIL`` positions), then ``MESH_STEPS`` AdamW steps.
    Each data shard's router calls go to ``tmp/routes<d>.pt`` in the order a
    rank makes them; params before and after and the first moments after
    step 1 stay on the host."""
    from repro_torch.models.model import build
    from repro_torch.models.params import init_params
    from repro_torch.training.optimizer import AdamW, tree_leaves
    from repro_torch.training.train_loop import make_train_step
    cfg = mesh_cfg()
    n_dp = MESH_GRID[0]
    bundle = build(cfg, capacity_factor=cfg.capacity_factor)
    params = init_params(cfg, seed, "cuda", expert_slabs="device", n_model=MESH_GRID[1])
    p0 = to_cpu(params)
    batches = mesh_batches(cfg, seed)
    rows = MESH_B // n_dp
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps = []
    with routes() as rec:
        with torch.no_grad():
            logits = [bundle.forward(params, {"tokens": batches[0][d * rows:(d + 1) * rows]
                                              .cuda()})[0][:, -MESH_TAIL:].cpu()
                      for d in range(n_dp)]
        opt = AdamW(lr=MESH_LR)
        state = opt.init(params)
        step = make_train_step(bundle, opt, microbatches=n_dp)
        for s, b in enumerate(batches):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, m = step(params, state, {"tokens": b.cuda()})
            steps.append(dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                              ms=(time.perf_counter() - t0) * 1e3))
            if s == 0:
                m0 = [t.cpu() for t in tree_leaves(state.m)]
    n = cfg.n_layers          # router calls a forward; a train microbatch recomputes them
    want = n * n_dp + MESH_STEPS * n_dp * 2 * n
    if len(rec) != want:
        raise AssertionError(f"mesh: {len(rec)} router calls, {want} expected")
    per = {d: list(rec[d * n:(d + 1) * n]) for d in range(n_dp)}
    for s in range(MESH_STEPS):
        base = n * n_dp + s * n_dp * 2 * n
        for d in range(n_dp):
            per[d] += rec[base + d * 2 * n:base + (d + 1) * 2 * n]
    for d, calls in per.items():
        torch.save(calls, tmp / f"routes{d}.pt")
    out = dict(logits=logits, steps=steps, p0=p0, p2=to_cpu(params), m0=m0,
               b1=opt.b1, grad_clip=opt.grad_clip,
               max_memory_allocated=torch.cuda.max_memory_allocated())
    del params, state, opt
    release()
    return out


def mesh_zero1(run, batches: list, ref: list, fault: bool) -> dict:
    """A rank's ZeRO-1 run of the mesh's model (``run``: a ``RankRun``):
    the forward's logits of its shard of step 0's batch (``batches[0]``),
    then ``MESH_STEPS`` steps of ``make_train_step``, its router replaying
    its data shard's unsharded record ``ref``; the kernels' counts, the
    collectives and the peak reset just before the steps and read just
    after. The fault run's forward has model rank 1's ``e_start`` off by one
    shard, and its steps leave ``copy_to`` out (identity both ways)."""
    from repro_torch import collectives
    from repro_torch.kernels.expert_ffn import expert_ffn
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import moe_layer as M
    from repro_torch.training.optimizer import tree_leaves
    from repro_torch.training.train_loop import make_train_step
    out = {}
    start, copy_to = M.expert_start, collectives.copy_to
    if fault and run.mesh.coords["model"] == 1:
        M.expert_start = lambda mode, i, e_loc: (i - 1) * e_loc
    with routes(replay=ref) as own:
        with torch.no_grad():
            logits = run.bundle.forward(run.params, batches[0])[0]
        out["logits"] = logits[:, -MESH_TAIL:].cpu()
        del logits
        M.expert_start = start
        if fault:
            collectives.copy_to = lambda x, ax: x
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        collectives.reset()
        for fn in (expert_ffn, flash_attention):
            fn.launches = 0
        step = make_train_step(run.bundle, run.opt)
        params, state, rows = run.params, run.state, []
        for s, b in enumerate(batches):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, mt = step(params, state, b)
            rows.append(dict(loss=float(mt["loss"]), grad_norm=float(mt["grad_norm"]),
                             ms=(time.perf_counter() - t0) * 1e3))
            if s == 0:
                out["m0"] = [t.cpu() for t in tree_leaves(state.m)]
        collectives.copy_to = copy_to
        out.update(steps=rows, max_memory_allocated=torch.cuda.max_memory_allocated(),
                   collectives=collectives.record(),
                   launches={fn.__name__: fn.launches for fn in (expert_ffn, flash_attention)},
                   params=[t.cpu() for t in tree_leaves(params)])
    if not fault:
        out["route_flips_at_ties"] = flips(own, ref)
    return out


def mesh_fault_control(run, sound: dict, batches: list, ref: list, seed: int) -> dict:
    """The planted faults of the ZeRO-1 run on this rank, against its sound
    run (``sound``: ``mesh_zero1``'s record): the fault run (``mesh_zero1``
    with ``fault``) on params drawn again (``rank_model``); the error of its
    logits (``logit_err``), each step's relative error of the loss and the
    gradient norm, its worst gradient leaf of step 1 (``MESH_GRAD_TOL``'s
    measure) and the squared distance of its params from the sound run's
    beside the sound run's squared update (the parent sums both over the
    ranks for ``MESH_PARAM_TOL``'s measure). Only these numbers leave the
    rank, so the fault run writes no record to the disk."""
    from repro_torch.launch.train import rank_model
    from repro_torch.training.optimizer import tree_leaves
    faulty = rank_model(run.cfg, run.mesh, run.device, run.ranks_per_card, seed, MESH_LR,
                        fsdp=False)
    adam = faulty.opt.opt
    p0 = [t.clone() for t in tree_leaves(faulty.params)]
    got = mesh_zero1(faulty, batches, ref, fault=True)
    del faulty
    scale = lambda gn: (1 - adam.b1) * min(1.0, adam.grad_clip / gn)
    worst = num = den = 0.0
    for a, b in zip(got["m0"], sound["m0"]):
        g = a.cuda() / scale(got["steps"][0]["grad_norm"])
        w = b.cuda() / scale(sound["steps"][0]["grad_norm"])
        worst = max(worst, float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30))
    for a, b, c in zip(got["params"], sound["params"], p0):
        a, b, c = a.cuda().float(), b.cuda().float(), c.float()
        num += float((a - b).square().sum())
        den += float((b - c).square().sum())
    err, ok = logit_err(got["logits"], sound["logits"])
    rel = lambda k: max(abs(x[k] - w[k]) / abs(w[k]) for x, w in zip(got["steps"], sound["steps"]))
    out = dict(logits_max_abs_err=err, logits_ok=ok, loss_rel_err=rel("loss"),
               grad_norm_rel_err=rel("grad_norm"), grad_leaf_rel_err=worst, param_num=num,
               param_den=den)
    del p0, got
    release()
    return out


def mesh_rank(local_rank: int, port: int, tmp: str, seed: int) -> None:
    """One rank of the mesh (a process of its own on the shared card):
    ``launch/train.py rank_setup`` and its ZeRO-1 run (``mesh_zero1``), the
    planted faults' readings against it (``mesh_fault_control``), then the
    decode, families, fsdp and rule parts. Writes ``tmp/rank<r>.pt``, and
    each part's ``HEAVY`` leaves to a file of their own as the part ends
    (``spill``)."""
    os.environ.update(RANK=str(local_rank), LOCAL_RANK=str(local_rank),
                      WORLD_SIZE=str(math.prod(MESH_GRID)),
                      LOCAL_WORLD_SIZE=str(math.prod(MESH_GRID)),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    sys.path.insert(0, str(ROOT / "src"))
    import torch.distributed as dist
    from repro_torch.launch.train import rank_setup
    tmp = Path(tmp)
    cfg = mesh_cfg()
    run = rank_setup(cfg, MESH_GRID, ("data", "model"), "gloo", "cuda", seed, MESH_LR)
    ref = torch.load(tmp / f"routes{run.mesh.coords['data']}.pt")
    batches = [run.shard_batch({"tokens": t}) for t in mesh_batches(cfg, seed)]
    r = run.mesh.rank
    out = dict(rank=r, coords=dict(run.mesh.coords), device=str(run.device),
               ranks_per_card=run.ranks_per_card, **mesh_zero1(run, batches, ref, fault=False))
    run.params = run.state = run.opt = None
    release()
    out["control"] = mesh_fault_control(run, out, batches, ref, seed)
    spill(out, tmp / f"rank{r}_zero1.pt")
    rank_note(r, "zero1")
    out["decode"] = mesh_decode_rank(run, tmp, seed)
    rank_note(r, "decode")
    out["families"] = mesh_family_rank(run, tmp, seed)
    out["fsdp"] = mesh_fsdp_rank(run, tmp, seed, out)
    out["fsdp_rule"] = mesh_fsdp_rule_rank(run, seed)
    rank_note(r, "fsdp rule")
    torch.save(out, tmp / f"rank{r}.pt")
    dist.barrier()
    dist.destroy_process_group()


def mesh_ranks(tmp: Path, seed: int) -> list:
    """Start the mesh's ranks on this card and return their records."""
    import socket

    import torch.multiprocessing as mp
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    world = math.prod(MESH_GRID)
    mp.start_processes(mesh_rank, args=(port, str(tmp), seed), nprocs=world,
                       start_method="spawn")
    ranks = []
    for r in range(world):
        rec = torch.load(tmp / f"rank{r}.pt")
        rec.update(torch.load(tmp / f"rank{r}_zero1.pt"))
        for part in ("family", "fsdp"):
            for arch, x in rec["families" if part == "family" else "fsdp"].items():
                x.update(torch.load(tmp / f"rank{r}_{part}_{arch}.pt"))
        ranks.append(rec)
    return ranks


# a rank record's leaves that only the parent's held checks read, written to
# a file of their own as each part ends and dropped from the rank's memory:
# four ranks holding every part's beside the parent's unsharded records ran
# a one-card machine out of its 96 GiB of host memory
HEAVY = ("m0", "params")


def spill(rec: dict, path: Path) -> None:
    """Write ``rec``'s ``HEAVY`` leaves to ``path`` and drop them from it
    (``mesh_ranks`` puts them back)."""
    torch.save({k: rec.pop(k) for k in HEAVY if k in rec}, path)
    gc.collect()


def rank_note(rank: int, part: str) -> None:
    """One line on stderr as a rank ends a part: the machine's available
    host memory, its cgroup's use where it has one, and the rank's own
    resident bytes."""
    with open("/proc/meminfo") as f:
        avail = next(int(ln.split()[1]) for ln in f if ln.startswith("MemAvailable"))
    with open("/proc/self/status") as f:
        rss = next(int(ln.split()[1]) for ln in f if ln.startswith("VmRSS"))
    cgroup = Path("/sys/fs/cgroup/memory.current")
    used = int(cgroup.read_text()) / 2 ** 30 if cgroup.is_file() else None
    print(json.dumps(dict(mesh_rank=rank, part=part, unix_s=time.time(),
                          mem_available_gb=avail / 2 ** 20, cgroup_gb=used,
                          rss_gb=rss / 2 ** 20)), file=sys.stderr, flush=True)


def mesh_held(ranks: list, ref: dict, cfg, witness=None, fsdp: bool = False) -> dict:
    """The ranks' step against the unsharded one: the worst relative error
    of the loss and of the gradient norm over steps and ranks, of a
    gradient leaf (``MESH_GRAD_TOL``'s measure; its leaf named) and the
    params' update over the whole tree (``MESH_PARAM_TOL``'s; ``fsdp``: the
    ranks hold their params' ``zero_specs`` slices). With
    ``witness`` (the unsharded step in f32, ``mesh_family_run``'s record),
    each loss, gradient norm and leaf past its limit is listed in
    ``over_limit`` with its ``f32_ratio``: how many times as far from the
    witness's the rank's reading is as the unsharded bf16 step's."""
    from repro_torch.launch.mesh import logical_mesh
    from repro_torch.launch.partition import param_specs, shard_leaf, zero_specs
    from repro_torch.training.optimizer import tree_leaves
    pspecs = param_specs(cfg, ref["p0"], n_model=MESH_GRID[1])
    zspecs = tree_leaves(zero_specs(ref["p0"], pspecs, dp="data", n_dp=MESH_GRID[0]))
    pspecs, names = zspecs if fsdp else tree_leaves(pspecs), leaf_names(ref["p0"])
    scale = lambda gn: (1 - ref["b1"]) * min(1.0, ref["grad_clip"] / gn)
    js = scale(ref["steps"][0]["grad_norm"])
    meshes = [dataclasses.replace(logical_mesh(MESH_GRID, ("data", "model")),
                                  coords=dict(r["coords"])) for r in ranks]
    p0, p2 = tree_leaves(ref["p0"]), tree_leaves(ref["p2"])
    grad, worst, num, den, over = 0.0, None, 0.0, 0.0, []

    def past(what, reading, limit, got, want, exact):
        """A reading past its limit, with its witness ratio."""
        ratio = float((got - exact).abs().max()) / max(float((want - exact).abs().max()), 1e-30)
        over.append(dict(what=what, reading=reading, limit=limit, f32_ratio=ratio))

    for j, (name, zs, spec) in enumerate(zip(names, zspecs, pspecs)):
        want, a, b = (t.cuda() for t in (ref["m0"][j], p0[j], p2[j]))
        exact = None if witness is None else witness["m0"][j].cuda() / scale(
            witness["steps"][0]["grad_norm"])
        for r, mesh in zip(ranks, meshes):
            w = shard_leaf(want, zs, mesh) / js
            g = r["m0"][j].cuda() / scale(r["steps"][0]["grad_norm"])
            e = float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
            if e > grad:
                grad, worst = e, name
            if e > MESH_GRAD_TOL and exact is not None:
                past(f"grad {name} rank {r['coords']}", e, MESH_GRAD_TOL, g, w,
                     shard_leaf(exact, zs, mesh))
            got, a_r, b_r = (t.float() for t in (r["params"][j].cuda(), shard_leaf(a, spec, mesh),
                                                 shard_leaf(b, spec, mesh)))
            num += float((got - b_r).square().sum())
            den += float((b_r - a_r).square().sum())
        del want, a, b, exact   # freed by del: release() would collect the whole heap a leaf
    for k, limit in (("loss", MESH_LOSS_TOL), ("grad_norm", MESH_GN_TOL)):
        for r in ranks:
            for i, (s_, w_) in enumerate(zip(r["steps"], ref["steps"])):
                e = abs(s_[k] - w_[k]) / abs(w_[k])
                if e > limit and witness is not None:
                    past(f"{k} step {i} rank {r['coords']}", e, limit, torch.tensor(s_[k]),
                         torch.tensor(w_[k]), torch.tensor(witness["steps"][i][k]))
    rel = lambda k: max(abs(s[k] - w[k]) / abs(w[k])
                        for r in ranks for s, w in zip(r["steps"], ref["steps"]))
    return dict(loss_rel_err=rel("loss"), grad_norm_rel_err=rel("grad_norm"),
                grad_leaf_rel_err=grad, grad_worst_leaf=worst,
                param_update_rel_err=math.sqrt(num / den), over_limit=over)


# -- phase 20, decode: the sharded decode on the mesh --------------------------

# (arch, layers): Qwen2-MoE-A2.7B's 16 KV heads shard over the model axis;
# Granite-34B's one (MQA) does not, so its ring's slots do
MESH_DECODE_RUNS = (("qwen2_moe_a2_7b", 1), ("granite_34b", 1))
MESH_DECODE_B = 4          # global batch, one shard of 2 a data rank
MESH_DECODE_PROMPT = 2044  # prompt tokens: slots 0..2043 of
MESH_DECODE_W = 4096       # the ring, so step 4 (position 2048) writes model rank 1's first slot
MESH_DECODE_STEPS = 8


def mesh_decode_cfg(arch: str):
    from repro_torch.configs.base import get_config
    return dataclasses.replace(get_config(arch), n_layers=dict(MESH_DECODE_RUNS)[arch])


def mesh_decode_prompts(cfg, seed: int) -> torch.Tensor:
    from repro_torch.data.pipeline import SyntheticLM
    it = SyntheticLM(cfg.vocab, seed=seed).batches(MESH_DECODE_B, MESH_DECODE_PROMPT)
    return torch.from_numpy(next(it))


def step_syncs(step) -> dict:
    """The host syncs ``step()`` makes, by call site: the device audit's
    ``audit_callbacks`` (the sync debug mode, each sync's own warning
    counted, not the mode's one-time notice) with ``step`` as the audited
    engine's step."""
    from repro_torch.analysis.device_audit import audit_callbacks
    eng = types.SimpleNamespace(device=torch.device("cuda"), step=step, running=())
    _, r = audit_callbacks(eng, set())
    return dict(syncs=r["syncs"], sites={s["site"]: s["syncs"] for s in r["sites"]})


def mesh_decode_unsharded(arch: str, seed: int, tmp: Path) -> dict:
    """The function the mesh's decode computes, on one card: params from
    ``seed`` (experts padded by the model axis), each data shard's rows
    prefilled at the config's capacity factor (a shard's dispatch), the
    cache taken to ``MESH_DECODE_W`` slots (``decode_cache``), then
    ``MESH_DECODE_STEPS`` greedy steps. Each shard's tokens (step t's input
    at t, the prefill's greedy token first) and router calls go to
    ``tmp/decode_<arch>_<d>.pt``; the logits [rows, 1 + steps, V] stay on
    the host. Then the host syncs of one more step (``step_syncs``)."""
    from repro_torch.models.model import build, decode_cache, greedy_token
    from repro_torch.models.params import init_params
    cfg = mesh_decode_cfg(arch)
    n_dp = MESH_GRID[0]
    bundle = build(cfg, capacity_factor=cfg.capacity_factor)
    params = init_params(cfg, seed, "cuda", expert_slabs="device", n_model=MESH_GRID[1])
    prompts = mesh_decode_prompts(cfg, seed)
    rows = MESH_DECODE_B // n_dp
    out = dict(logits=[], tokens=[], step_ms=[])
    for d in range(n_dp):
        with routes() as rec, torch.no_grad():
            logits, cache = bundle.prefill(params, {"tokens": prompts[d * rows:(d + 1) * rows]
                                                    .cuda()})
            cache = decode_cache(bundle, cache, MESH_DECODE_W)
            lg, toks = [logits.float().cpu()], [greedy_token(logits, cfg.vocab)]
            for _ in range(MESH_DECODE_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits, cache = bundle.decode_step(params, {"token": toks[-1]}, cache)
                torch.cuda.synchronize()
                out["step_ms"].append((time.perf_counter() - t0) * 1e3)
                lg.append(logits.float().cpu())
                toks.append(greedy_token(logits, cfg.vocab))
        toks = [t.cpu() for t in toks]
        torch.save(dict(tokens=toks, routes=rec), tmp / f"decode_{arch}_{d}.pt")
        out["logits"].append(torch.stack(lg, 1))
        out["tokens"].append(torch.cat(toks, 1))
    tok = toks[-1].cuda()
    with torch.no_grad():
        out["decode_step_syncs"] = step_syncs(
            lambda: bundle.decode_step(params, {"token": tok}, cache))
    del params, cache
    release()
    return out


def mesh_decode_rank(run, tmp: Path, seed: int) -> dict:
    """A rank's decode part, after its train steps: each of
    ``MESH_DECODE_RUNS`` built on the rank's mesh, its whole tree drawn from
    ``seed`` and cut to the rank's blocks; its data shard prefilled, the
    cache taken to the decode layout at ``MESH_DECODE_W`` slots
    (``decode_cache``), then ``MESH_DECODE_STEPS`` steps fed the unsharded
    run's tokens, the MoE replaying the unsharded run's experts. Kept: the
    logits (gathered whole), the rank's own greedy tokens, walls, the
    kernels' launches and the collectives of the run (counts reset just
    before it), and the valid slots of the rank's block of the ring before
    and after (by ``slot_pos`` and by the K rows written). Where the slots
    are sharded, a fault run after it: the partials averaged without their
    log-sum-exp weights (``collectives.lse_combine`` replaced)."""
    from repro_torch import collectives
    from repro_torch.kernels.expert_ffn import expert_ffn
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.launch.partition import param_specs
    from repro_torch.models.model import build, decode_cache, greedy_token
    from repro_torch.models.params import shard_params
    d, m = run.mesh.coords["data"], run.mesh.coords["model"]
    kernels = (expert_ffn, flash_attention, flash_decode)
    out = {}

    def block_slots(cache):
        """(valid slots of this rank's block by slot_pos, its slots whose
        K rows of layer 0, row 0 are written)."""
        W_loc = cache["k"].shape[2]
        lo = m * W_loc if W_loc < MESH_DECODE_W else 0
        valid = int((cache["slot_pos"][lo:lo + W_loc] >= 0).sum())
        return valid, int((cache["k"][0, 0] != 0).flatten(1).any(1).sum())

    for arch, _ in MESH_DECODE_RUNS:
        cfg = mesh_decode_cfg(arch)
        bundle = build(cfg, mesh_info=run.mesh_info)
        whole = bundle.init(seed, device=run.device)
        params = shard_params(whole, param_specs(cfg, whole, n_model=MESH_GRID[1]), run.mesh)
        del whole
        release()
        ref = torch.load(tmp / f"decode_{arch}_{d}.pt")
        batch = run.shard_batch({"tokens": mesh_decode_prompts(cfg, seed)})
        for fn in kernels:
            fn.launches = 0
        collectives.reset()
        torch.cuda.reset_peak_memory_stats()
        rec = {}
        with routes(replay=ref["routes"] or None) as own, torch.no_grad():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = bundle.prefill(params, batch)
            cache = decode_cache(bundle, cache, MESH_DECODE_W)
            torch.cuda.synchronize()
            rec["prefill_s"] = time.perf_counter() - t0
            rec["block_slots_before"] = block_slots(cache)
            start = cache
            lg, mine, step_ms = [logits.float().cpu()], [greedy_token(logits, cfg.vocab).cpu()], []
            for t in range(MESH_DECODE_STEPS):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                logits, cache = bundle.decode_step(params, {"token": ref["tokens"][t].cuda()},
                                                   cache)
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t1) * 1e3)
                lg.append(logits.float().cpu())
                mine.append(greedy_token(logits, cfg.vocab).cpu())
        rec.update(logits=torch.stack(lg, 1), tokens=torch.cat(mine, 1), step_ms=step_ms,
                   launches={fn.__name__: fn.launches for fn in kernels},
                   collectives=collectives.record(),
                   max_memory_allocated=torch.cuda.max_memory_allocated(),
                   cache_k=list(cache["k"].shape), block_slots_after=block_slots(cache),
                   route_flips_at_ties=flips(own, ref["routes"]) if ref["routes"] else 0)
        if cache["k"].shape[2] < MESH_DECODE_W:
            def averaged(o, lse, ax):
                return collectives.all_gather(o.float()[None], ax, 0).mean(0).to(o.dtype)
            combine, collectives.lse_combine = collectives.lse_combine, averaged
            try:
                with torch.no_grad():
                    c, fl = start, []
                    for t in range(MESH_DECODE_STEPS):
                        lgf, c = bundle.decode_step(params, {"token": ref["tokens"][t].cuda()}, c)
                        fl.append(lgf.float().cpu())
            finally:
                collectives.lse_combine = combine
            rec["fault_logits"] = torch.stack(fl, 1)
        out[arch] = rec
        del params, cache, start
        release()
    return out


def mesh_decode_held(arch: str, ref: dict, ranks: list) -> dict:
    """A model's decode on the ranks against the unsharded run: per rank
    the logits of the prefill and every step (``logit_err``, its data
    shard's rows), its own greedy tokens against the unsharded ones (a
    difference only where the unsharded logits tie the two within
    ``TIE``), the valid slots of its block, and the fault run's logits,
    which must part beyond the limit."""
    cfg = mesh_decode_cfg(arch)
    per_rank, ok, caught = [], True, None
    for r in ranks:
        d = r["coords"]["data"]
        x = r["decode"][arch]
        want = ref["logits"][d]
        err, within = logit_err(x["logits"], want)
        ties = []
        for b, t in zip(*np.nonzero((x["tokens"] != ref["tokens"][d]).numpy())):
            gap = float(want[b, t, ref["tokens"][d][b, t]] - want[b, t, x["tokens"][b, t]])
            ties.append(dict(row=int(b), step=int(t), logit_gap=gap))
            within &= gap <= TIE
        ok &= within
        row = dict(rank=r["rank"], coords=r["coords"], logits_max_abs_err=err, ok=within,
                   token_ties=ties, prefill_s=x["prefill_s"], step_ms=x["step_ms"],
                   max_memory_allocated=x["max_memory_allocated"], cache_k=x["cache_k"],
                   block_slots_before=x["block_slots_before"],
                   block_slots_after=x["block_slots_after"], launches=x["launches"],
                   collectives=x["collectives"], route_flips_at_ties=x["route_flips_at_ties"])
        if "fault_logits" in x:
            f_err, f_ok = logit_err(x["fault_logits"], want[:, 1:])
            row["averaged_partials_logits_max_abs_err"] = f_err
            caught = (caught if caught is not None else True) and not f_ok
        per_rank.append(row)
    slots = cfg.n_kv_heads % MESH_GRID[1] != 0
    return dict(model=cfg.name, layers=cfg.n_layers, layout="slots" if slots else "heads",
                ok=ok, averaged_partials_failed=caught, ranks=per_rank)


# -- phase 20, families: every other family on the mesh -------------------------

# phase 20's families, arch -> (config changes, train seq (0: no train step),
# decode prompt tokens, decode slots). Mamba2-2.7B at 2 of 64 layers;
# Zamba2-7B at 7 of 81, the least depth with every kind of layer (a block of
# 6 Mamba layers, the shared block, a Mamba tail layer), its sequence and
# prompt past its 4096-token window, so prefill's ring is rolled and the
# steps write around it;
# Llama-3.2-Vision-90B at one block of 4 self and 1 cross layer (its train
# step does not fit four ranks on one card); SeamlessM4T-medium at 1 + 1;
# gemma3-1b at 7 (one pattern block of 6 and a tail layer) through
# build_dense_pattern, its 2560-token prompt into a 4096-slot ring, so every
# local layer's 512-token window lies in model rank 1's block
MESH_FAMILY_RUNS = {"mamba2_2_7b": ({"n_layers": 2}, 4096, 2044, 2044 + MESH_DECODE_STEPS),
                    "zamba2_7b": ({"n_layers": 7}, 5120, 5116, 4096),
                    "llama_3_2_vision_90b": ({"n_layers": 5}, 0, 2048, 2048 + MESH_DECODE_STEPS),
                    "seamless_m4t_medium": ({"n_layers": 1, "enc_layers": 1}, 2048, 2044,
                                            2044 + MESH_DECODE_STEPS),
                    "gemma3_1b": ({"n_layers": 7}, 2048, 2560, 4096)}
MESH_FORWARD_SEQ = 2048    # the forward's tokens of a family that takes no train step
BC_LEAVES = ("wB", "wC", "conv_B", "conv_C")
MESH_FAMILY_LIMITS = dict(loss_rel_err=MESH_LOSS_TOL, grad_norm_rel_err=MESH_GN_TOL,
                          grad_leaf_rel_err=MESH_GRAD_TOL, param_update_rel_err=MESH_PARAM_TOL)


def mesh_family_cfg(arch: str):
    from repro_torch.configs.base import get_config
    return dataclasses.replace(get_config(arch), **MESH_FAMILY_RUNS[arch][0])


def family_kernels(cfg) -> tuple:
    """The names of the kernels a family's mesh run must launch."""
    if cfg.family == "ssm":
        return ("ssd_scan",)
    if cfg.family == "hybrid":
        return ("ssd_scan", "flash_attention", "flash_decode")
    cross = ("flash_attention_cross",) if cfg.family in ("vlm", "encdec") else ()
    return ("flash_attention", "flash_decode") + cross


@contextlib.contextmanager
def static_window(cfg):
    """``REPRO_OPT_STATIC_WINDOW`` on for a local:global stack (``build``
    then takes ``build_dense_pattern``), as it was otherwise."""
    old = os.environ.get("REPRO_OPT_STATIC_WINDOW")
    if cfg.local_global_pattern:
        os.environ["REPRO_OPT_STATIC_WINDOW"] = "1"
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("REPRO_OPT_STATIC_WINDOW", None)
        else:
            os.environ["REPRO_OPT_STATIC_WINDOW"] = old


@contextlib.contextmanager
def patched(obj, attr: str, value):
    """``obj.attr`` set to ``value`` for the block (a planted fault)."""
    old = getattr(obj, attr)
    setattr(obj, attr, value)
    try:
        yield
    finally:
        setattr(obj, attr, old)


def mesh_family_inputs(cfg, arch: str, seed: int):
    """(the forward's global batch, each train step's, the decode prompts):
    ``SyntheticLM`` tokens, the forward's those of step 0, and the
    frontend's input (``launch/input_specs.py frontend_inputs``, seeded) of
    the vlm (its 1601 patches) or the enc-dec (as many frames as tokens)."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.input_specs import frontend_inputs, generator
    _, seq, prompt, _ = MESH_FAMILY_RUNS[arch]
    g = generator(seed + 2, "cpu")

    def batch(tokens):
        return {"tokens": tokens, **frontend_inputs(cfg, tokens.shape[0], tokens.shape[1], g,
                                                    "cpu")}

    it = SyntheticLM(cfg.vocab, seed=seed).batches(MESH_B, seq or MESH_FORWARD_SEQ)
    steps = [batch(torch.from_numpy(next(it))) for _ in range(MESH_STEPS if seq else 1)]
    prompts = batch(torch.from_numpy(next(SyntheticLM(cfg.vocab, seed=seed + 1).batches(
        MESH_DECODE_B, prompt))))
    return steps[0], steps if seq else [], prompts


@contextlib.contextmanager
def plain_attention_f32():
    """The f32 witness's arithmetic on the card: activations in f32
    (``activations_f32``) and the attention through its plain versions,
    which take f32 where the kernels take bf16 (``flash_attention_xla``,
    with its flash backward, for ``flash_attention`` and
    ``FlashAttentionFn``; ``flash_decode_plain`` for ``flash_decode``; the
    reference's ``attention(causal=False)`` for ``flash_attention_cross``
    and ``FlashAttentionCrossFn``)."""
    from repro_torch.kernels.flash_decode import flash_decode_plain
    from repro_torch.models import layers as L
    plain = lambda q, k, v, causal=True, window=-1: L.flash_attention_xla(q, k, v, window, causal)
    cross = lambda q, k, v: L.attention(
        q, k, v, q_pos=torch.arange(q.shape[1], device=q.device)[None],
        k_pos=torch.arange(k.shape[1], device=q.device)[None], causal=False)
    saved = (L.FlashAttentionFn, L.flash_attention, L.flash_decode, L.FlashAttentionCrossFn,
             L.flash_attention_cross)
    L.FlashAttentionFn = types.SimpleNamespace(apply=plain)
    L.FlashAttentionCrossFn = types.SimpleNamespace(apply=cross)
    L.flash_attention, L.flash_decode, L.flash_attention_cross = plain, flash_decode_plain, cross
    try:
        with activations_f32():
            yield
    finally:
        (L.FlashAttentionFn, L.flash_attention, L.flash_decode, L.FlashAttentionCrossFn,
         L.flash_attention_cross) = saved


def shard_rows(batch: dict, d: int, n: int) -> dict:
    """Data shard d's n rows of every leaf of a batch, on the card."""
    return {k: v[d * n:(d + 1) * n].cuda() for k, v in batch.items()}


def mesh_family_run(bundle, params, batches, prompts, fed=None, forward=None,
                    capacity=None) -> dict:
    """A family's unsharded run on the card: the forward's logits of each
    data shard's rows of ``forward`` (step 0's batch by default; last
    ``MESH_TAIL`` positions, f32 on the host); each data shard's decode
    (prefill of ``prompts``, ``decode_cache`` at ``capacity`` slots, by
    default its ring's, ``MESH_DECODE_STEPS`` steps, greedy or fed
    ``fed``'s tokens [rows, 1 + steps] a shard); then an AdamW step a batch
    of ``batches``, one microbatch a data shard, updating ``params`` in
    place: each step's loss, gradient norm and wall, the first moments
    after step 1. Batches are dicts (``tokens`` and a frontend's input)."""
    from repro_torch.models.model import decode_cache, greedy_token
    from repro_torch.training.optimizer import AdamW, tree_leaves
    from repro_torch.training.train_loop import make_train_step
    cfg = bundle.cfg
    n_dp = MESH_GRID[0]
    rows, drows = MESH_B // n_dp, MESH_DECODE_B // n_dp
    forward = batches[0] if forward is None else forward
    capacity = capacity or ring(cfg, prompts["tokens"].shape[1] + MESH_DECODE_STEPS)
    out = dict(logits=[], decode_logits=[], tokens=[], decode_step_ms=[], steps=[])
    with torch.no_grad():
        for d in range(n_dp):
            lg = bundle.forward(params, shard_rows(forward, d, rows))[0]
            out["logits"].append(lg[:, -MESH_TAIL:].float().cpu())
            del lg
        for d in range(n_dp):
            logits, cache = bundle.prefill(params, shard_rows(prompts, d, drows))
            cache = decode_cache(bundle, cache, capacity)
            lg, toks = [logits.float().cpu()], [greedy_token(logits, cfg.vocab)]
            for t in range(MESH_DECODE_STEPS):
                tok = toks[-1] if fed is None else fed[d][:, t:t + 1].cuda()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits, cache = bundle.decode_step(params, {"token": tok}, cache)
                torch.cuda.synchronize()
                out["decode_step_ms"].append((time.perf_counter() - t0) * 1e3)
                lg.append(logits.float().cpu())
                toks.append(greedy_token(logits, cfg.vocab))
            out["decode_logits"].append(torch.stack(lg, 1))
            out["tokens"].append(torch.cat([t.cpu() for t in toks], 1))
            del cache
    if not batches:
        return out
    opt = AdamW(lr=MESH_LR)
    state = opt.init(params)
    step = make_train_step(bundle, opt, microbatches=n_dp)
    for i, b in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step(params, state, {k: v.cuda() for k, v in b.items()})
        out["steps"].append(dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                                 ms=(time.perf_counter() - t0) * 1e3))
        if i == 0:
            out["m0"] = [t.cpu() for t in tree_leaves(state.m)]
    out.update(b1=opt.b1, grad_clip=opt.grad_clip)
    return out




def mesh_family_unsharded(arch: str, seed: int, tmp: Path) -> dict:
    """The function a family's mesh run computes, on one card
    (``mesh_family_run`` on params from ``seed``, the vlm's gates at
    ``FAMILY_GATES``), each data shard's decode tokens to
    ``tmp/family_<arch>_<d>.pt``, the params before and after the steps on
    the host. For a stack of ``SHAPES_WITNESS_LAYERS`` or more, the f32
    witness too: the same run with the params cast to f32 under
    ``plain_attention_f32``, its decode fed the bf16 run's tokens
    (``f32``)."""
    from repro_torch.models.model import build
    from repro_torch.training.optimizer import tree_map
    cfg = mesh_family_cfg(arch)
    with static_window(cfg):
        bundle = build(cfg)
    params = bundle.init(seed, "cuda")
    if cfg.family == "vlm":
        set_gates(params)
    forward, batches, prompts = mesh_family_inputs(cfg, arch, seed)
    capacity = MESH_FAMILY_RUNS[arch][3]
    # the params drawn: on the host where the steps update them in place,
    # else the tree itself (Llama-Vision's 10.8 GB stay on the card)
    p0 = to_cpu(params) if batches else params
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = mesh_family_run(bundle, params, batches, prompts, forward=forward, capacity=capacity)
    for d, toks in enumerate(out["tokens"]):
        torch.save(dict(tokens=toks), tmp / f"family_{arch}_{d}.pt")
    out.update(max_memory_allocated=torch.cuda.max_memory_allocated())
    if batches:
        out.update(p0=p0, p2=to_cpu(params))
    del params
    release()
    if cfg.n_layers + cfg.enc_layers >= SHAPES_WITNESS_LAYERS:
        exact = tree_map(lambda t: t.float().cuda(), p0)
        del p0
        release()
        with plain_attention_f32():
            out["f32"] = mesh_family_run(bundle, exact, batches, prompts, fed=out["tokens"],
                                         forward=forward, capacity=capacity)
        del exact
        release()
    return out


def family_faults(cfg) -> list:
    """A family's planted faults: (name, what it breaks, the attribute
    replaced, the gradient leaves a ``steps`` fault is read from). The ssm
    and hybrid families (``models/ssm.py``): the gated norm over a rank's
    own channels (the forward's logits), the decode's conv state stepped
    without the gather (the decode's logits), B / C entering the heads'
    region without ``copy_to`` (the first moments of ``BC_LEAVES``). The
    enc-dec: its ``proj`` gather with a backward that sums the gradient
    over the model axis (the first moment of ``proj``). The pattern stack:
    the local layers' window left out on its slot-sharded decode (the
    decode's logits)."""
    from repro_torch import collectives
    from repro_torch.models import layers as L
    from repro_torch.models import ssm as S
    if cfg.family in ("ssm", "hybrid"):
        return [("norm_local", "forward",
                 (S, "_norm", lambda y, w, eps, tp, width: L.rms_norm(y, w, eps)), ()),
                ("no_gather", "decode", (S, "_gather_bc", lambda b, c, tp: (
                    b.repeat(1, tp.size), c.repeat(1, tp.size))), ()),
                ("bc_partial", "steps", (S, "_enter_bc", lambda t, tp: t), BC_LEAVES)]
    if cfg.family == "encdec":
        class GatherSum(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x, ax, dim):
                ctx.ax, ctx.dim, ctx.size = ax, dim, x.shape[dim]
                return collectives.all_gather(x, ax, dim)

            @staticmethod
            def backward(ctx, grad):
                whole = collectives.psum(grad, ctx.ax)
                return whole.narrow(ctx.dim, ctx.ax.index * ctx.size, ctx.size), None, None

        return [("gather_sum", "steps", (collectives, "gather_from", lambda x, ax, dim:
                                         GatherSum.apply(x, ax, dim % x.ndim)), ("proj",))]
    if cfg.local_global_pattern:
        decode = L.flash_decode
        return [("no_window", "decode", (L, "flash_decode", lambda *a, window=-1, return_lse=False:
                                         decode(*a, return_lse=True) if return_lse
                                         else decode(*a, window=window)), ())]
    return []


def mesh_family_rank(run, tmp: Path, seed: int) -> dict:
    """A rank's families part, after its decode part: each of
    ``MESH_FAMILY_RUNS`` built on the rank's mesh, its blocks of the tree
    drawn from ``seed`` leaf by leaf (``init(blocks=True)``: the ranks
    sharing the card never hold a whole tree; the vlm's gates at
    ``FAMILY_GATES``); the forward's logits of its shard of the forward batch, the
    decode of its shard of the prompts fed the unsharded run's tokens, and
    ``MESH_STEPS`` ZeRO-1 AdamW steps where the family takes them, the
    kernels' counts and the collectives reset just before and read just
    after those. Then, on the params drawn, ``family_faults``: a
    ``forward`` fault's logits, a ``decode`` fault's decode logits, a
    ``steps`` fault's first moments of its leaves after one step."""
    from repro_torch import collectives
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_cross
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.launch.partition import param_specs, zero_specs
    from repro_torch.models.model import build, decode_cache, greedy_token
    from repro_torch.training.optimizer import AdamW, ZeRO1, tree_leaves
    from repro_torch.training.train_loop import make_train_step
    d = run.mesh.coords["data"]
    kernels = (ssd_scan, flash_attention, flash_attention_cross, flash_decode)
    out = {}
    for arch, (_, seq, _, capacity) in MESH_FAMILY_RUNS.items():
        cfg = mesh_family_cfg(arch)
        with static_window(cfg):
            bundle = build(cfg, mesh_info=run.mesh_info)
        whole = bundle.init(seed, device="meta")
        pspecs = param_specs(cfg, whole, n_model=MESH_GRID[1])
        zspecs = zero_specs(whole, pspecs, dp="data", n_dp=MESH_GRID[0])
        names = leaf_names(whole)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = bundle.init(seed, run.device, blocks=True)
        if cfg.family == "vlm":
            set_gates(params)
        torch.cuda.synchronize()
        rec = dict(draw_s=time.perf_counter() - t0,
                   draw_max_memory_allocated=torch.cuda.max_memory_allocated())
        forward, batches, prompts = mesh_family_inputs(cfg, arch, seed)
        forward = run.shard_batch(forward)
        batches = [run.shard_batch(b) for b in batches]
        prompt = run.shard_batch(prompts)
        ref_toks = torch.load(tmp / f"family_{arch}_{d}.pt")["tokens"]     # [rows, 1 + steps]

        def decode(start):
            lg, mine, ms = [], [], []
            c = start
            for t in range(MESH_DECODE_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits, c = bundle.decode_step(params, {"token": ref_toks[:, t:t + 1].cuda()}, c)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                lg.append(logits.float().cpu())
                mine.append(greedy_token(logits, cfg.vocab).cpu())
            return lg, mine, ms

        def steps(p, n, keep=lambda name: True):
            opt = ZeRO1(AdamW(lr=MESH_LR), pspecs, zspecs, run.mesh_info)
            state = opt.init(p)
            step = make_train_step(bundle, opt)
            rows, m0 = [], None
            for i in range(n):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                p, state, mt = step(p, state, batches[i])
                rows.append(dict(loss=float(mt["loss"]), grad_norm=float(mt["grad_norm"]),
                                 ms=(time.perf_counter() - t0) * 1e3))
                if i == 0:
                    m0 = {n_: t.cpu() for n_, t in zip(names, tree_leaves(state.m))
                          if keep(n_)}
            return p, rows, m0

        fresh = [t.clone() for t in tree_leaves(params)] if seq else None
        for fn in kernels:
            fn.launches = 0
        collectives.reset()
        t0 = time.perf_counter()
        with torch.no_grad():
            rec["logits"] = bundle.forward(params, forward)[0][:, -MESH_TAIL:].float().cpu()
            logits, cache = bundle.prefill(params, prompt)
            cache = decode_cache(bundle, cache, capacity)
            torch.cuda.synchronize()
            rec["prefill_s"] = time.perf_counter() - t0
            lg, mine, ms = decode(cache)
        rec.update(decode_logits=torch.stack([logits.float().cpu()] + lg, 1),
                   tokens=torch.cat([greedy_token(logits, cfg.vocab).cpu()] + mine, 1),
                   decode_step_ms=ms, cache={k: list(v.shape) for k, v in cache.items()},
                   steps=[])
        if seq:
            params, rec["steps"], m0 = steps(params, MESH_STEPS)
            rec["m0"] = list(m0.values())
            rec["params"] = [t.cpu() for t in tree_leaves(params)]
        rec.update(launches={fn.__name__: fn.launches for fn in kernels},
                   collectives=collectives.record(),
                   max_memory_allocated=torch.cuda.max_memory_allocated())
        if seq:       # the faults run on the params drawn
            for leaf, t in zip(tree_leaves(params), fresh):
                leaf.copy_(t)
        faults = rec["faults"] = {}
        for name, kind, target, leaves in family_faults(cfg):
            with patched(*target), torch.set_grad_enabled(kind == "steps"):
                if kind == "forward":
                    faults[name] = bundle.forward(params, forward)[0][:, -MESH_TAIL:].float().cpu()
                elif kind == "decode":
                    faults[name] = torch.stack(decode(cache)[0], 1)
                else:
                    _, (row,), m0 = steps(params, 1, lambda n: n.split("/")[-1] in leaves)
                    faults[name] = dict(grad_norm=row["grad_norm"], m0=m0)
        spill(rec, tmp / f"rank{run.mesh.rank}_family_{arch}.pt")
        out[arch] = rec
        del params, cache, fresh, logits
        release()
        rank_note(run.mesh.rank, f"family {arch}")
    return out


def mesh_family_held(arch: str, ref: dict, ranks: list) -> dict:
    """A family's mesh run against the unsharded one: per rank the
    forward's logits (its vocabulary block), the decode's logits and
    greedy tokens (``mesh_decode_held``'s rules), peak memory, step ms,
    collectives and launches; the train steps by ``mesh_held``; and the
    planted faults, each of which must fail its check on every rank. A
    stack of at most two layers is held within the limits (``BUNDLE_TOL``,
    ``MESH_*_TOL``); a deeper one (``SHAPES_WITNESS_LAYERS``, as
    ``decode_vs_cpu`` holds the matrix's: Zamba2's seven) by the f32
    witness past them: a reading over its limit passes only if the rank is
    at most ``F32_RATIO`` times as far from the unsharded f32 run as the
    unsharded bf16 run is (the params' update has no witness: it is held
    within ``MESH_PARAM_TOL``)."""
    from repro_torch.launch.mesh import logical_mesh
    from repro_torch.launch.partition import param_specs, shard_leaf, zero_specs
    from repro_torch.training.optimizer import tree_leaves
    cfg = mesh_family_cfg(arch)
    _, seq, prompt, capacity = MESH_FAMILY_RUNS[arch]
    wit = ref.get("f32")
    views = [dict(coords=r["coords"], **r["families"][arch]) for r in ranks]
    V = views[0]["logits"].shape[-1]
    if seq:
        zspecs = zero_specs(ref["p0"], param_specs(cfg, ref["p0"], n_model=MESH_GRID[1]),
                            dp="data", n_dp=MESH_GRID[0])
        names = leaf_names(ref["p0"])
        zs = dict(zip(names, tree_leaves(zspecs)))
        index = {n: j for j, n in enumerate(names)}
    scale = lambda gn: (1 - ref["b1"]) * min(1.0, ref["grad_clip"] / gn)

    def gate(within: bool, got, want, exact) -> tuple:
        """(passes, witness ratio or None): within the limit, or, with a
        witness, no more than F32_RATIO times as far from it as want."""
        if exact is None:
            return within, None
        ratio = float((got - exact).abs().max()) / max(float((want - exact).abs().max()), 1e-30)
        return within or ratio <= F32_RATIO, ratio

    per_rank, sound = [], True
    caught = {name: True for name, *_ in family_faults(cfg)}
    for x in views:
        d, m = x["coords"]["data"], x["coords"]["model"]
        cols = slice(m * V, (m + 1) * V)
        want, want_dec = ref["logits"][d][..., cols], ref["decode_logits"][d]
        exact = None if wit is None else wit["logits"][d][..., cols]
        exact_dec = None if wit is None else wit["decode_logits"][d]
        err, within = logit_err(x["logits"], want)
        ok, ratio = gate(within, x["logits"], want, exact)
        dec_err, within = logit_err(x["decode_logits"], want_dec)
        dec_ok, dec_ratio = gate(within, x["decode_logits"], want_dec, exact_dec)
        ties = []
        for b, t in zip(*np.nonzero((x["tokens"] != ref["tokens"][d]).numpy())):
            gap = float(want_dec[b, t, ref["tokens"][d][b, t]] - want_dec[b, t, x["tokens"][b, t]])
            ties.append(dict(row=int(b), step=int(t), logit_gap=gap))
            dec_ok &= gap <= TIE
        sound &= ok and dec_ok
        mesh = dataclasses.replace(logical_mesh(MESH_GRID, ("data", "model")),
                                   coords=dict(x["coords"]))
        faults = {}
        for name, kind, _, _ in family_faults(cfg):
            got = x["faults"][name]
            if kind == "steps":     # the worst of its leaves, relative to the leaf's largest entry
                js, rs = scale(ref["steps"][0]["grad_norm"]), scale(got["grad_norm"])
                err_, fault_ok = 0.0, True
                for n, t in got["m0"].items():
                    w = shard_leaf(ref["m0"][index[n]].cuda(), zs[n], mesh) / js
                    g = t.cuda() / rs
                    e = float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
                    ex = None if wit is None else shard_leaf(
                        wit["m0"][index[n]].cuda(), zs[n], mesh) / scale(
                        wit["steps"][0]["grad_norm"])
                    fault_ok &= gate(e <= MESH_GRAD_TOL, g, w, ex)[0]
                    err_ = max(err_, e)
                faults[f"{name}_grad_leaf_rel_err"] = err_
            else:
                w, ex = (want, exact) if kind == "forward" else (
                    want_dec[:, 1:], None if exact_dec is None else exact_dec[:, 1:])
                err_, within = logit_err(got, w)
                fault_ok, r_ = gate(within, got, w, ex)
                faults.update({f"{name}_{kind}_logits_max_abs_err": err_, f"{name}_f32_ratio": r_})
            caught[name] &= not fault_ok
        per_rank.append(dict(rank=x["coords"], logits_max_abs_err=err, logits_f32_ratio=ratio,
                             logits_ok=ok, decode_logits_max_abs_err=dec_err,
                             decode_f32_ratio=dec_ratio, decode_ok=dec_ok, token_ties=ties,
                             faults=faults, draw_s=x["draw_s"],
                             draw_max_memory_allocated=x["draw_max_memory_allocated"],
                             max_memory_allocated=x["max_memory_allocated"],
                             step_ms=[s_["ms"] for s_ in x["steps"]],
                             loss=[s_["loss"] for s_ in x["steps"]],
                             grad_norm=[s_["grad_norm"] for s_ in x["steps"]],
                             prefill_s=x["prefill_s"], decode_step_ms=x["decode_step_ms"],
                             cache=x["cache"], collectives=x["collectives"],
                             launches=x["launches"]))
    res = dict(model=cfg.name, layers=cfg.n_layers, enc_layers=cfg.enc_layers, batch=MESH_B,
               seq=seq or MESH_FORWARD_SEQ, train_steps=MESH_STEPS if seq else 0,
               gate="f32 witness past the limits" if wit is not None else "limits",
               f32_ratio=F32_RATIO,
               decode=dict(batch=MESH_DECODE_B, prompt=prompt, slots=capacity,
                           steps=MESH_DECODE_STEPS),
               unsharded=dict(steps=ref["steps"], decode_step_ms=ref["decode_step_ms"],
                              max_memory_allocated=ref["max_memory_allocated"],
                              f32_steps=None if wit is None else wit["steps"]),
               faults_failed=caught, ranks=per_rank)
    train_ok = True
    if seq:
        held = mesh_held(views, ref, cfg, witness=wit)
        witnessed = ("loss_rel_err", "grad_norm_rel_err", "grad_leaf_rel_err")
        train_ok = all(held[k] <= v or (k in witnessed and wit is not None)
                       for k, v in MESH_FAMILY_LIMITS.items()) and all(
            o["f32_ratio"] <= F32_RATIO for o in held["over_limit"])
        res.update(held)
    res["sound"] = sound and train_ok
    return res


# -- phase 20, fsdp: the params FSDP (ZeRO-3) on the mesh ---------------------

MESH_FSDP_RUNS = (MESH_ARCH, "mamba2_2_7b")
# Qwen2-MoE-A2.7B's least depth at which the reference's rule turns FSDP on
# for a 2 x 2 mesh (state_gb_dev 10.12 GB; 7.26 at 2 layers)
FSDP_RULE_LAYERS = 3
FSDP_RULE_STATE_GB = 10.12
# each rank's peak under the rule must be this far below ZeRO-1's (fsdp off)
FSDP_PEAK_DROP = 0.5e9
# the layer-slice fault's params: layer l of every layer-dim leaf moved by
# this times l + 1, since the leaves are one fill in every layer as drawn
FSDP_LAYER_BUMP = 0.1


def fsdp_layer_slice(self, l):
    """The planted fault for ``models/model.py _Sliced.__getitem__``: a leaf
    whose data-axis dim is the stack's layer dim read as if it were whole,
    layer l from the rank's own slice."""
    from repro_torch.models.model import _Sliced
    if self.dim == 0:
        return self.t[l % self.t.shape[0]]
    return _Sliced(self.t[l], self.dim - 1, self.ax)


class GatherKeepsSlice(torch.autograd.Function):
    """The planted fault for ``collectives.gather_params``: the data-axis
    gather whose backward keeps the rank's slice of its own gradient (no
    sum over the data axes)."""

    @staticmethod
    def forward(ctx, w, ax, dim):
        from repro_torch import collectives
        ctx.ax, ctx.dim, ctx.size = ax, dim, w.shape[dim]
        return collectives.all_gather(w, ax, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.ax.index * ctx.size, ctx.size).contiguous(), None, None


def mesh_fsdp_rank(run, tmp: Path, seed: int, zero: dict) -> dict:
    """A rank's fsdp part, after its families part (``zero``: its record so
    far): each of ``MESH_FSDP_RUNS`` with FSDP forced on
    (``launch/train.py rank_model``), its slices drawn from ``seed``; the
    forward's logits of its shard (Qwen2-MoE replaying its data shard's
    unsharded experts), each equal bit for bit to its ZeRO-1 run's, then
    ``MESH_STEPS`` AdamW steps, the kernels' counts, the collectives and the
    peak reset just before and read just after them; step 1's loss against
    ZeRO-1's, and the worst gradient leaf against ZeRO-1's (the f32 sum
    there, rounded to bf16 here). On Mamba2, then, the planted faults: one
    step on the params drawn with the gather's backward keeping the slice
    (its first moments), and on params whose layer-dim leaves differ by
    layer the sound forward and the forward reading a layer-dim leaf from
    the rank's own slice (their logits)."""
    from repro_torch import collectives
    from repro_torch.kernels.expert_ffn import expert_ffn
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.launch.partition import data_dims
    from repro_torch.launch.train import rank_model
    from repro_torch.models.model import _Sliced
    from repro_torch.training.optimizer import tree_leaves
    from repro_torch.training.train_loop import make_train_step
    d = run.mesh.coords["data"]
    kernels = (expert_ffn, flash_attention, ssd_scan)
    out = {}
    for arch in MESH_FSDP_RUNS:
        moe = arch == MESH_ARCH
        cfg = mesh_cfg() if moe else mesh_family_cfg(arch)
        mine = zero if moe else zero["families"][arch]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = t_part = time.perf_counter()
        frun = rank_model(cfg, run.mesh, run.device, run.ranks_per_card, seed, MESH_LR,
                          fsdp=True)
        torch.cuda.synchronize()
        rec = dict(draw_s=time.perf_counter() - t0,
                   draw_max_memory_allocated=torch.cuda.max_memory_allocated(),
                   state_gb_dev=frun.state_gb_dev, planned_bytes=frun.planned_bytes())
        if moe:
            batches = [run.shard_batch({"tokens": t}) for t in mesh_batches(cfg, seed)]
            forward, replay = batches[0], torch.load(tmp / f"routes{d}.pt")
        else:
            fwd, bs, _ = mesh_family_inputs(cfg, arch, seed)
            forward, batches, replay = run.shard_batch(fwd), [run.shard_batch(b) for b in bs], None
        fresh = None if moe else [t.clone() for t in tree_leaves(frun.params)]
        with routes(replay=replay) if moe else contextlib.nullcontext():
            with torch.no_grad():
                logits = frun.bundle.forward(frun.params, forward)[0]
            rec["logits"] = logits[:, -MESH_TAIL:].float().cpu()
            del logits
            rec["logits_equal_zero1"] = bool(torch.equal(rec["logits"], mine["logits"].float()))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            collectives.reset()
            for fn in kernels:
                fn.launches = 0
            step = make_train_step(frun.bundle, frun.opt)
            params, state, rows = frun.params, frun.state, []
            for s, b in enumerate(batches):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                params, state, mt = step(params, state, b)
                rows.append(dict(loss=float(mt["loss"]), grad_norm=float(mt["grad_norm"]),
                                 ms=(time.perf_counter() - t0) * 1e3))
                if s == 0:
                    rec["m0"] = [t.cpu() for t in tree_leaves(state.m)]
        rec.update(steps=rows, max_memory_allocated=torch.cuda.max_memory_allocated(),
                   collectives=collectives.record(),
                   launches={fn.__name__: fn.launches for fn in kernels},
                   params=[t.cpu() for t in tree_leaves(params)],
                   loss_equal_zero1=rows[0]["loss"] == mine["steps"][0]["loss"])
        adam = frun.opt.opt
        scale = lambda gn: (1 - adam.b1) * min(1.0, adam.grad_clip / gn)
        worst = 0.0
        zero_m0 = torch.load(tmp / (f"rank{run.mesh.rank}_zero1.pt" if moe else
                                    f"rank{run.mesh.rank}_family_{arch}.pt"))["m0"]
        for a, b in zip(rec["m0"], zero_m0):
            a = a.cuda() / scale(rows[0]["grad_norm"])
            b = b.cuda() / scale(mine["steps"][0]["grad_norm"])
            worst = max(worst, float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30))
        rec["grad_leaf_rel_err_zero1"] = worst
        del zero_m0
        del params, state, step
        if not moe:
            faults = rec["faults"] = {}
            for leaf, t in zip(tree_leaves(frun.params), fresh):
                leaf.copy_(t)
            with patched(collectives, "gather_params",
                         lambda w, ax, dim: GatherKeepsSlice.apply(w, ax, dim % w.ndim)):
                opt = type(frun.opt)(type(adam)(lr=MESH_LR), frun.pspecs, frun.zspecs,
                                     frun.mesh_info)
                _, st, mt = make_train_step(frun.bundle, opt)(frun.params, opt.init(frun.params),
                                                              batches[0])
                faults["no_sum"] = dict(grad_norm=float(mt["grad_norm"]),
                                        m0=[t.cpu() for t in tree_leaves(st.m)])
            del opt, st
            release()
            # layer l of each layer-dim leaf (the rank's slice holds whole
            # layers) moved apart from the others
            dims = tree_leaves(data_dims(frun.pspecs, frun.zspecs)["layers"])
            per = None
            with torch.no_grad():
                for leaf, dim in zip(tree_leaves(frun.params["layers"]), dims):
                    if dim == 0:
                        per = leaf.shape[0]
                        for i in range(per):
                            leaf[i] += FSDP_LAYER_BUMP * (d * per + i + 1)
                sound = frun.bundle.forward(frun.params, forward)[0][:, -MESH_TAIL:].float().cpu()
                with patched(_Sliced, "__getitem__", fsdp_layer_slice):
                    bad = frun.bundle.forward(frun.params, forward)[0][:, -MESH_TAIL:].float().cpu()
            faults["layer_slice"] = dict(layers_a_rank=per, sound=sound, fault=bad)
        spill(rec, tmp / f"rank{run.mesh.rank}_fsdp_{arch}.pt")
        out[arch] = rec
        del frun, fresh
        release()
        rec["part_s"] = time.perf_counter() - t_part
        rank_note(run.mesh.rank, f"fsdp {arch}")
    return out


def fsdp_no_sum_fault(ranks: list, ref: dict, cfg, arch: str) -> list:
    """Each rank's worst gradient leaf of the no-sum fault's step against the
    unsharded step's (``MESH_GRAD_TOL``'s measure), on its slice."""
    from repro_torch.launch.mesh import logical_mesh
    from repro_torch.launch.partition import param_specs, shard_leaf, zero_specs
    from repro_torch.training.optimizer import tree_leaves
    zspecs = tree_leaves(zero_specs(ref["p0"], param_specs(cfg, ref["p0"], n_model=MESH_GRID[1]),
                                    dp="data", n_dp=MESH_GRID[0]))
    scale = lambda gn: (1 - ref["b1"]) * min(1.0, ref["grad_clip"] / gn)
    out = []
    for r in ranks:
        mesh = dataclasses.replace(logical_mesh(MESH_GRID, ("data", "model")),
                                   coords=dict(r["coords"]))
        fault = r["fsdp"][arch]["faults"]["no_sum"]
        worst = 0.0
        for want, got, zs in zip(ref["m0"], fault["m0"], zspecs):
            w = shard_leaf(want.cuda(), zs, mesh) / scale(ref["steps"][0]["grad_norm"])
            g = got.cuda() / scale(fault["grad_norm"])
            worst = max(worst, float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30))
        out.append(worst)
    return out


def mesh_fsdp_rule_rank(run, seed: int) -> dict:
    """A rank's rule part, after its fsdp part: what ``launch/train.py
    --mesh 2x2 --fsdp {auto,off}`` runs on each rank, in this process
    (saving two launches' start-up): ``rank_model`` of Qwen2-MoE-A2.7B at
    ``FSDP_RULE_LAYERS`` with ``fsdp`` None (the rule, ``--fsdp auto``) and
    False (``--fsdp off``), each then ``MESH_STEPS`` steps of the
    launcher's batch (``SyntheticLM``, ``MESH_B`` x ``MESH_S``); the peak
    reset just before the draw and read after the steps, the kernels'
    counts and the collectives over the steps."""
    from repro_torch import collectives
    from repro_torch.kernels.expert_ffn import expert_ffn
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.train import rank_model
    from repro_torch.training.train_loop import make_train_step
    kernels = (expert_ffn, flash_attention)
    cfg = dataclasses.replace(mesh_cfg(), n_layers=FSDP_RULE_LAYERS)
    out = {}
    for mode, fsdp in (("auto", None), ("off", False)):
        release()
        torch.cuda.reset_peak_memory_stats()
        t_part = time.perf_counter()
        rr = rank_model(cfg, run.mesh, run.device, run.ranks_per_card, seed, MESH_LR, fsdp=fsdp)
        batches = [rr.shard_batch({"tokens": t}) for t in mesh_batches(cfg, seed)]
        collectives.reset()
        for fn in kernels:
            fn.launches = 0
        step = make_train_step(rr.bundle, rr.opt)
        params, state, rows = rr.params, rr.state, []
        for b in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, mt = step(params, state, b)
            rows.append(dict(loss=float(mt["loss"]), grad_norm=float(mt["grad_norm"]),
                             ms=(time.perf_counter() - t0) * 1e3))
        out[mode] = dict(fsdp=rr.fsdp, state_gb_dev=rr.state_gb_dev,
                         planned_bytes=rr.planned_bytes(),
                         max_memory_allocated=torch.cuda.max_memory_allocated(),
                         step_ms=[r["ms"] for r in rows], loss=[r["loss"] for r in rows],
                         grad_norm=[r["grad_norm"] for r in rows],
                         collectives=collectives.record(),
                         launches={fn.__name__: fn.launches for fn in kernels},
                         part_s=time.perf_counter() - t_part)
        del rr, params, state, step, batches
    release()
    return out


def fsdp_held(ranks: list, ref: dict, fam_ref: dict) -> dict:
    """The fsdp part against the unsharded runs (``mesh_held``, the params
    held as ``zero_specs`` slices) and the ZeRO-1 ranks, and its planted
    faults."""
    models = {}
    for arch in MESH_FSDP_RUNS:
        moe = arch == MESH_ARCH
        cfg = mesh_cfg() if moe else mesh_family_cfg(arch)
        base = ref if moe else fam_ref[arch]
        views = [dict(coords=r["coords"], **r["fsdp"][arch]) for r in ranks]
        held = mesh_held(views, base, cfg, fsdp=True)
        V = views[0]["logits"].shape[-1]
        per_rank = []
        for x in views:
            dd, m = x["coords"]["data"], x["coords"]["model"]
            err, ok = logit_err(x["logits"], base["logits"][dd][..., m * V:(m + 1) * V])
            per_rank.append(dict(rank=x["coords"], logits_max_abs_err=err, logits_ok=ok,
                                 logits_equal_zero1=x["logits_equal_zero1"],
                                 loss_equal_zero1=x["loss_equal_zero1"],
                                 grad_leaf_rel_err_zero1=x["grad_leaf_rel_err_zero1"],
                                 draw_s=x["draw_s"],
                                 draw_max_memory_allocated=x["draw_max_memory_allocated"],
                                 max_memory_allocated=x["max_memory_allocated"],
                                 planned_bytes=x["planned_bytes"],
                                 step_ms=[s_["ms"] for s_ in x["steps"]],
                                 loss=[s_["loss"] for s_ in x["steps"]], part_s=x["part_s"],
                                 collectives=x["collectives"], launches=x["launches"]))
        res = dict(model=cfg.name, layers=cfg.n_layers, state_gb_dev=views[0]["state_gb_dev"],
                   ranks=per_rank, **held)
        res["sound"] = (all(r["logits_ok"] and r["logits_equal_zero1"] and r["loss_equal_zero1"]
                            for r in per_rank)
                        and all(held[k] <= v for k, v in MESH_FAMILY_LIMITS.items()))
        if not moe:
            no_sum = fsdp_no_sum_fault(ranks, base, cfg, arch)
            slices = [logit_err(x["faults"]["layer_slice"]["fault"],
                               x["faults"]["layer_slice"]["sound"]) for x in views]
            res["faults"] = dict(
                no_sum_grad_leaf_rel_err=no_sum,
                layer_slice_logits_max_abs_err=[e for e, _ in slices],
                layers_a_rank=views[0]["faults"]["layer_slice"]["layers_a_rank"])
            res["faults_failed"] = dict(no_sum=all(e > MESH_GRAD_TOL for e in no_sum),
                                        layer_slice=not any(ok for _, ok in slices))
        models[arch] = res
    return dict(models=models,
                planted=("no_sum: the data-axis gather's backward keeping the rank's slice "
                         "without the sum over the data axes (Mamba2's gradient leaves); "
                         "layer_slice: a layer-dim leaf read from the rank's own slice as if "
                         "the layer dim were whole (Mamba2's logits, its layer-dim leaves "
                         f"moved {FSDP_LAYER_BUMP} x (layer + 1) apart)"))


def fsdp_rule_held(ranks: list) -> dict:
    """The rule parts (``mesh_fsdp_rule_rank``): FSDP by the rule at
    ``FSDP_RULE_STATE_GB``, none with ``fsdp`` off, each rank's peak at
    least ``FSDP_PEAK_DROP`` below its ZeRO-1 peak."""
    auto = [r["fsdp_rule"]["auto"] for r in ranks]
    off = [r["fsdp_rule"]["off"] for r in ranks]
    drops = [o["max_memory_allocated"] - a["max_memory_allocated"] for a, o in zip(auto, off)]
    return dict(
        layers=FSDP_RULE_LAYERS, batch=MESH_B, seq=MESH_S, steps=MESH_STEPS,
        ranks={k: [dict(rank=r["rank"], coords=r["coords"], **r["fsdp_rule"][k]) for r in ranks]
               for k in ("auto", "off")},
        first_loss_equal=[a["loss"][0] == o["loss"][0] for a, o in zip(auto, off)],
        peak_drop=drops, peak_drop_limit=FSDP_PEAK_DROP,
        ok=(all(a["fsdp"] and round(a["state_gb_dev"], 2) == FSDP_RULE_STATE_GB
                for a in auto)
            and not any(o["fsdp"] for o in off) and min(drops) >= FSDP_PEAK_DROP))


def encoder_attention(B, S, H, D, g, reps: int = 20, plain_reps: int = 5):
    """The enc-dec encoder's non-causal ``flash_attention`` of B S-token
    sequences: held against the plain version (``rows``), a planted fault
    (the plain version with the causal mask) failing the same check, timed
    beside the plain version and beside SDPA held to its fused kernels.
    Bound: q, k, v read and o written once; 4 D operations per (query,
    key) pair of each head."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain
    r = lambda *s: torch.randn(s, generator=g, device="cuda").to(torch.bfloat16)
    q, k, v = r(B, S, H, D), r(B, S, H, D), r(B, S, H, D)
    o = flash_attention(q, k, v, causal=False)
    err = max_err(o, flash_attention_plain(q, k, v, causal=False), rows=True)
    faults = planted({"the causal mask": lambda: max_err(
        o, flash_attention_plain(q, k, v, causal=True), rows=True)})
    del o
    library = lambda: F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                                     v.transpose(1, 2))
    timed = device_vs_library(lambda: flash_attention(q, k, v, causal=False),
                              fused_sdpa(library), reps)
    plain_ms = time_ms(lambda: flash_attention_plain(q, k, v, causal=False), reps=plain_reps,
                       warmup=min(3, plain_reps))
    bms, by = bound(2 * 4 * B * S * H * D, 4 * B * H * D * S * S)
    return dict(shape=dict(B=B, S=S, H=H, Hkv=H, D=D, causal=False), max_abs_err=err,
                planted=faults, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                bound_share=bms / timed["device_ms"], **timed)


def window_lse_decode(H, Hkv, D, W, window: int, filled: int, g, reps: int = 20) -> dict:
    """``flash_decode(return_lse=True)`` under a window over the two blocks
    of a slot-sharded ring of 2 W slots, as a 2 x 2 mesh's decode gives
    them (B=2): row 0 model rank 1's block, whose first ``filled`` slots
    hold positions W .. W + filled - 1, the query at the last of them;
    row 1 model rank 0's block, its W slots filled with positions 0 .. W -
    1, none of them inside the window of that query. Held against the
    plain version: o (``rows``) and the log-sum-exp of row 0
    (``TOL_F32``), row 1's -inf exactly and its output 0; a planted fault
    (the plain version without the window) failing the same check. Timed
    beside SDPA over the same mask (no log-sum-exp output) and the plain
    version; bound: q, o and lse once, the valid slots' K and V rows
    once."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_decode import flash_decode, flash_decode_plain, n_splits
    B = 2
    r = lambda *s: torch.randn(s, generator=g, device="cuda").to(torch.bfloat16)
    q, k, v = r(B, H, D), r(B, W, Hkv, D), r(B, W, Hkv, D)
    slots = torch.arange(W, dtype=torch.int32, device="cuda")
    sp = torch.stack([torch.where(slots < filled, slots + W, -1), slots])
    pos = torch.full((B,), W + filled - 1, dtype=torch.int32, device="cuda")
    args = (q, k, v, pos, sp)
    o, lse = flash_decode(*args, window=window, return_lse=True)
    o_p, lse_p = flash_decode_plain(*args, window=window, return_lse=True)
    err = max_err(o[:1], o_p[:1], rows=True)
    lse_err = max_err(lse[:1], lse_p[:1], TOL_F32)
    if not (torch.isneginf(lse[1]).all() and torch.isneginf(lse_p[1]).all()
            and torch.equal(o[1], torch.zeros_like(o[1]))):
        raise AssertionError("flash_decode: a block with no slot in the window must give "
                             "lse -inf and an output of 0")
    faults = planted({"no window": lambda: max_err(
        o[:1], flash_decode_plain(*args, return_lse=True)[0][:1], rows=True)})
    ok = (sp >= 0) & (sp <= pos[:, None]) & (sp > pos[:, None] - window)
    mask = ok[:, None, None, :]
    timed = device_vs_library(lambda: flash_decode(*args, window=window, return_lse=True),
                              lambda: F.scaled_dot_product_attention(
                                  q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
                                  attn_mask=mask, enable_gqa=True), reps)
    plain_ms = time_ms(lambda: flash_decode_plain(*args, window=window, return_lse=True), reps=5)
    n_valid = int(ok.sum())
    bms, by = bound(2 * (2 * B * H * D + 2 * n_valid * Hkv * D) + 4 * B * (W + 1 + H),
                    4 * H * D * n_valid)
    return dict(shape=dict(B=B, H=H, Hkv=Hkv, D=D, W=W, window=window, filled=[filled, W],
                           valid=[int(ok[0].sum()), int(ok[1].sum())],
                           n_split=n_splits(Hkv, W)),
                max_abs_err=err, lse_max_abs_err=lse_err, empty_row_lse="-inf",
                planted=faults, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                bound_share=bms / timed["device_ms"], **timed)


def mesh_cross_kernel_checks(g) -> dict:
    """``mesh_kernel`` lines of the frontend and pattern families' rank
    shapes on the 2 x 2 mesh (B = 2 rows a data shard):
    ``flash_attention_cross`` at 32 / 4 of Llama-3.2-Vision's 64 / 8 heads
    (2048 queries over its 1601 patches) and at 8 / 8 of SeamlessM4T's 16
    / 16 (D=64, 2048 over 2048 frames); Seamless's non-causal encoder
    ``flash_attention`` at 8 / 8 over 2048 frames; the cross ``flash_decode``
    at Llama-Vision's 32 / 4 over the 1601 patches; gemma3's windowed
    ``flash_decode`` with its log-sum-exp over a 2048-slot block of its
    4096-slot ring (window 512, the 2568th position: one block holds the
    window, the other none of it)."""
    from repro_torch.configs.base import get_config
    vision, seamless, gemma = (get_config(a) for a in ("llama_3_2_vision_90b",
                                                       "seamless_m4t_medium", "gemma3_1b"))
    n_model = MESH_GRID[1]
    rows = MESH_B // MESH_GRID[0]
    out = {"flash_attention_cross": [], "flash_attention": [], "flash_decode": []}

    def add(kernel, variant, rec):
        rec = dict(variant=variant, **rec)
        emit(dict(phase="mesh_kernel", kernel=kernel, **rec))
        out[kernel].append(rec)
        release()

    Hv, Hkv_v = vision.n_heads // n_model, vision.n_kv_heads // n_model
    add("flash_attention_cross", f"llama_vision_cross_{Hv}_{Hkv_v}",
        cross_attention(rows, MESH_FORWARD_SEQ, vision.n_frontend_tokens, Hv, Hkv_v, vision.hd,
                        g)[1])
    Hs = seamless.n_heads // n_model
    seq = MESH_FAMILY_RUNS["seamless_m4t_medium"][1]
    add("flash_attention_cross", f"seamless_cross_{Hs}_{Hs}",
        cross_attention(rows, seq, seq, Hs, Hs, seamless.hd, g)[1])
    add("flash_attention", f"seamless_encoder_{Hs}_{Hs}",
        encoder_attention(rows, seq, Hs, seamless.hd, g))
    add("flash_decode", f"llama_vision_cross_decode_{Hv}_{Hkv_v}",
        cross_decode(rows, vision.n_frontend_tokens, Hv, Hkv_v, vision.hd, g))
    _, _, prompt, slots = MESH_FAMILY_RUNS["gemma3_1b"]
    W = slots // n_model
    add("flash_decode", f"gemma3_window_lse_block_{W}",
        window_lse_decode(gemma.n_heads, gemma.n_kv_heads, gemma.hd, W, gemma.sliding_window,
                          prompt + MESH_DECODE_STEPS - W, g))
    return out


def mesh_phase(seed: int) -> dict:
    """Phase 20 (module docstring)."""
    import tempfile
    t0 = time.perf_counter()
    cfg = mesh_cfg()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        tmp = Path(tmp)
        ref = mesh_unsharded(seed, tmp)
        dec_ref = {arch: mesh_decode_unsharded(arch, seed, tmp) for arch, _ in MESH_DECODE_RUNS}
        fam_ref = {arch: mesh_family_unsharded(arch, seed, tmp) for arch in MESH_FAMILY_RUNS}
        t_ref = time.perf_counter()
        ranks = mesh_ranks(tmp, seed)
        t_ranks = time.perf_counter()
        held_s = {}
        held = mesh_held(ranks, ref, cfg)
        held_s["zero1"] = time.perf_counter() - t_ranks
        decode = {arch: mesh_decode_held(arch, dec_ref[arch], ranks)
                  for arch, _ in MESH_DECODE_RUNS}
        held_s["decode"] = time.perf_counter() - t_ranks - sum(held_s.values())
        families = {arch: mesh_family_held(arch, fam_ref[arch], ranks)
                    for arch in MESH_FAMILY_RUNS}
        held_s["families"] = time.perf_counter() - t_ranks - sum(held_s.values())
        fsdp = fsdp_held(ranks, ref, fam_ref)
        held_s["fsdp"] = time.perf_counter() - t_ranks - sum(held_s.values())
        del fam_ref
        for r in ranks:
            for part in [r] + list(r["families"].values()) + list(r["fsdp"].values()):
                part.pop("m0", None)
                part.pop("params", None)
            for part in r["fsdp"].values():
                part.pop("faults", None)
        fsdp["rule"] = fsdp_rule_held(ranks)
        release()
        t_held = time.perf_counter()
    V = ranks[0]["logits"].shape[-1]

    def logits_of(rank):
        d, m = rank["coords"]["data"], rank["coords"]["model"]
        return logit_err(rank["logits"], ref["logits"][d][..., m * V:(m + 1) * V])

    per_rank = []
    for r in ranks:
        err, ok = logits_of(r)
        per_rank.append(dict(rank=r["rank"], coords=r["coords"], device=r["device"],
                             max_memory_allocated=r["max_memory_allocated"],
                             step_ms=[s["ms"] for s in r["steps"]],
                             loss=[s["loss"] for s in r["steps"]],
                             grad_norm=[s["grad_norm"] for s in r["steps"]],
                             collectives=r["collectives"], launches=r["launches"],
                             logits_max_abs_err=err, logits_ok=ok,
                             route_flips_at_ties=r["route_flips_at_ties"]))
    ctrl = [r["control"] for r in ranks]
    control = {k: max(c[k] for c in ctrl)
               for k in ("loss_rel_err", "grad_norm_rel_err", "grad_leaf_rel_err")}
    control["param_update_rel_err"] = math.sqrt(sum(c["param_num"] for c in ctrl)
                                                / sum(c["param_den"] for c in ctrl))
    e_start = [(c["logits_max_abs_err"], c["logits_ok"]) for c in ctrl]
    launches = {}
    for r in ranks:
        for part in [r["launches"]] + [x["launches"] for key in ("decode", "families", "fsdp",
                                                                 "fsdp_rule")
                                       for x in r[key].values()]:
            for k, v in part.items():
                launches[k] = launches.get(k, 0) + v
    # each FSDP model's kernels, from its steps on the ranks
    fsdp_bad = [(arch, n) for arch in MESH_FSDP_RUNS
                for n in (("expert_ffn", "flash_attention") if arch == MESH_ARCH
                          else ("ssd_scan",))
                if not sum(r["fsdp"][arch]["launches"][n] for r in ranks)]
    # each decode model's kernels, from its run on the ranks
    decode_bad = [(arch, n) for arch, _ in MESH_DECODE_RUNS
                  for n in ("flash_attention", "flash_decode")
                  + (("expert_ffn",) if mesh_decode_cfg(arch).is_moe else ())
                  if not sum(r["decode"][arch]["launches"][n] for r in ranks)]
    # each family's kernels, from its run on the ranks
    family_bad = [(arch, n) for arch in MESH_FAMILY_RUNS
                  for n in family_kernels(mesh_family_cfg(arch))
                  if not sum(r["families"][arch]["launches"][n] for r in ranks)]
    limits = dict(loss_rel_err=MESH_LOSS_TOL, grad_norm_rel_err=MESH_GN_TOL,
                  grad_leaf_rel_err=MESH_GRAD_TOL, param_update_rel_err=MESH_PARAM_TOL)
    res = dict(phase="mesh", model=cfg.name, layers=cfg.n_layers,
               grid=dict(zip(("data", "model"), MESH_GRID)), backend="gloo",
               ranks_per_card=ranks[0]["ranks_per_card"], cards=torch.cuda.device_count(),
               batch=MESH_B, seq=MESH_S, steps=MESH_STEPS, lr=MESH_LR,
               unsharded=dict(steps=ref["steps"],
                              max_memory_allocated=ref["max_memory_allocated"]),
               ranks=per_rank, **held, limits=limits,
               logits_tol=BUNDLE_TOL, logits_positions=MESH_TAIL,
               controls=dict(planted=("the forward with model rank 1's e_start off by one "
                                      "shard (logits); the steps with copy_to left out (loss, "
                                      "gradient norm, gradient leaves, params); each against "
                                      "the rank's sound run, in its process"),
                             e_start_logits_max_abs_err=[e for e, _ in e_start],
                             e_start_logits_failed=not all(ok for _, ok in e_start),
                             **control),
               launches=launches,
               decode=dict(batch=MESH_DECODE_B, prompt=MESH_DECODE_PROMPT, W=MESH_DECODE_W,
                           steps=MESH_DECODE_STEPS, logits_tol=BUNDLE_TOL, tie=TIE,
                           planted=("the ranks' partials averaged without their log-sum-exp "
                                    "weights (slot-sharded model)"),
                           unsharded={a: dict(step_ms=r["step_ms"],
                                              decode_step_syncs=r["decode_step_syncs"])
                                      for a, r in dec_ref.items()},
                           models=list(decode.values())),
               families=dict(limits=limits, logits_tol=BUNDLE_TOL, tie=TIE, gates=FAMILY_GATES,
                             planted=("norm_local: the gated norm over a rank's own channels "
                                      "(logits); bc_partial: B / C without copy_to (the "
                                      "gradient leaves of " + " / ".join(BC_LEAVES) + "); "
                                      "no_gather: the decode conv state stepped without the "
                                      "gather (decode logits); gather_sum: Seamless's proj "
                                      "gather with a backward that sums the gradient over "
                                      "the model axis (the proj gradient leaf); no_window: "
                                      "gemma3's local windows left out on the slot-sharded "
                                      "decode (decode logits)"),
                             models=list(families.values())),
               fsdp=dict(limits=MESH_FAMILY_LIMITS, logits_tol=BUNDLE_TOL, planted=fsdp["planted"],
                         models=list(fsdp["models"].values()), rule=fsdp["rule"]),
               seconds=dict(unsharded=t_ref - t0, ranks=t_ranks - t_ref, held=t_held - t_ranks,
                            held_parts=held_s, controls=time.perf_counter() - t_held))
    bad = [n for n in ("expert_ffn", "flash_attention") if not launches.get(n)] + decode_bad
    sound = all(r["logits_ok"] for r in per_rank) and all(held[k] <= v for k, v in limits.items())
    caught = res["controls"]["e_start_logits_failed"] and all(
        control[k] > v for k, v in limits.items())
    # the decode: every rank within the limit, the slot-sharded model's
    # writes crossed into model rank 1's block (empty at the start), its
    # fault caught
    granite = decode["granite_34b"]
    crossed = all(r["block_slots_before"][0] == (MESH_DECODE_PROMPT if r["coords"]["model"] == 0
                                                 else 0)
                  and r["block_slots_after"][0] == r["block_slots_after"][1] > 0
                  for r in granite["ranks"])
    dec_sound = all(x["ok"] for x in decode.values()) and crossed
    dec_caught = granite["averaged_partials_failed"] is True
    fam_sound = {f["model"]: f["sound"] for f in families.values()}
    fam_caught = {f["model"]: all(f["faults_failed"].values()) for f in families.values()}
    bad += family_bad + fsdp_bad
    fsdp_sound = {f["model"]: f["sound"] for f in fsdp["models"].values()}
    fsdp_caught = fsdp["models"]["mamba2_2_7b"]["faults_failed"]
    rule_ok = fsdp["rule"]["ok"]
    if not (sound and caught and dec_sound and dec_caught and all(fam_sound.values())
            and all(fam_caught.values()) and all(fsdp_sound.values())
            and all(fsdp_caught.values()) and rule_ok and not bad):
        emit(res)
        raise AssertionError(f"mesh: the 2 x 2 step parts from the unsharded one ({sound=}), "
                             f"or a control passed ({caught=}), or the decode parts from the "
                             f"unsharded one ({dec_sound=}, {crossed=}) or its fault passed "
                             f"({dec_caught=}), or a family parts from its unsharded run "
                             f"({fam_sound=}) or a planted fault passed ({fam_caught=}), or "
                             f"an FSDP run parts from its unsharded or ZeRO-1 run "
                             f"({fsdp_sound=}) or its fault passed ({fsdp_caught=}), or the "
                             f"FSDP by the rule or its peak drop failed ({rule_ok=}), or "
                             f"kernels never launched {bad}")
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=4,
                    help="decoder depth (each Mixtral layer holds 2.6 GiB of "
                         "pinned host expert weights)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--decode-step", metavar="SRC", default=None,
                    help="only time the analysis phase's B=8 decode steps (decode_steps) "
                         "with the port's package taken from SRC (a src/ directory, "
                         "such as an unpacked parent commit's), and print one line")
    ap.add_argument("--flash-decode", metavar="SRC", default=None,
                    help="only time flash_decode at every shape a main path runs "
                         "(flash_decode_shapes) with the port's package taken from SRC, "
                         "and print one line a shape")
    ap.add_argument("--shapes", action="store_true",
                    help="only build the kernels and run the shapes phase (the reference's "
                         "arch x input shape matrix), and print its lines")
    ap.add_argument("--mesh", action="store_true",
                    help="only build the kernels and run the mesh phase, and print its lines")
    ap.add_argument("--decode-syncs", metavar="SRC", default=None,
                    help="only count the host syncs of one unsharded build_dense decode step "
                         "(decode_syncs_only) with the port's package taken from SRC")
    ap.add_argument("--flash-attention", metavar="SRC", default=None,
                    help="only time flash_attention, _cross and _chunk at every shape a main "
                         "path runs (flash_attention_shapes) with the port's package taken "
                         "from SRC, and print one line a shape")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if args.flash_attention:
        return flash_attention_only(Path(args.flash_attention).resolve())
    if args.flash_decode:
        return flash_decode_only(Path(args.flash_decode).resolve())
    if args.decode_step:
        return decode_step_only(Path(args.decode_step).resolve(), args.layers, args.seed)
    if args.decode_syncs:
        return decode_syncs_only(Path(args.decode_syncs).resolve(), args.seed)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels.expert_ffn import expert_ffn, expert_ffn_from_pool
    from repro_torch.kernels.flash_attention import (flash_attention, flash_attention_chunk,
                                                     flash_attention_cross)
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.ssd_scan import ssd_scan

    card = nvidia_smi()
    emit(dict(phase="device", nvidia_smi=card,
              name=torch.cuda.get_device_name(0), torch=torch.__version__,
              cuda=torch.version.cuda))

    t0 = time.perf_counter()

    def built(name):
        """One source's nvcc, then its SASS counted while the others build."""
        t = time.perf_counter()
        lib = _build.build(name)
        return time.perf_counter() - t, sass_counts(lib)

    with concurrent.futures.ThreadPoolExecutor(len(_build.SOURCES)) as ex:
        done = {n: ex.submit(built, n) for n in _build.SOURCES}
        done = {n: f.result() for n, f in done.items()}
    per_source = {n: t for n, (t, _) in done.items()}
    sass = {n: c for n, (_, c) in done.items()}
    logs = {n: _build.library_path(n).with_suffix(".so.log").read_text()
            for n in _build.SOURCES}
    ptxas = {n: [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
             for n, log in logs.items()}
    attention = ptxas_report(logs["flash_attention"])
    emit(dict(phase="build", seconds=time.perf_counter() - t0,
              per_source_s=per_source, ptxas=ptxas, sass=sass,
              flash_attention=attention))
    check_attention_build(attention, sass["flash_attention"])

    g = torch.Generator(device="cuda").manual_seed(args.seed)
    shape_set = [expert_ffn, flash_attention, flash_attention_cross, flash_decode, ssd_scan]
    if args.shapes:
        emit(shape_pairs(args.seed, shape_set))
        shape_kernel_checks(g)
        return 0
    if args.mesh:
        mesh_kernel_checks(g)
        emit(mesh_phase(args.seed))
        return 0
    results = [kernel_expert_ffn(g), kernel_flash_attention(g),
               kernel_flash_attention_chunk(g), kernel_flash_decode(g), kernel_ssd_scan(g)]
    torch.cuda.empty_cache()
    for r in results:
        emit(dict(phase="kernel", **({"tol": TOL} | r)))
    variants = family_kernel_variants(g)

    emit(check_small(args.seed))
    torch.cuda.empty_cache()

    kernels = [expert_ffn_from_pool, flash_attention, flash_decode]
    srv, mixtral = serve(args.layers, args.seed, kernels)
    emit(srv)
    gc.collect()   # the engine's reference cycles hold its expert pool
    torch.cuda.empty_cache()

    emit(check_batch_small(args.seed))
    bat, reference = serve_batch(mixtral, args.seed, kernels + [flash_attention_chunk])
    emit(bat)
    gc.collect()   # the batch phase's engines hold their pools until collected
    torch.cuda.empty_cache()
    clu = serve_cluster(mixtral, reference, kernels + [flash_attention_chunk])
    emit(clu)
    with uncounted(kernels + [flash_attention_chunk]):
        emit(analyse(mixtral, args.seed))
    del mixtral, reference
    release()
    examples = run_examples(kernels + [flash_attention_chunk, expert_ffn])
    emit(examples)

    emit(check_small_ssm(args.seed))
    ssm = serve_ssm(args.seed, ssd_scan)
    emit(ssm)
    release()

    emit(check_paper_small(args.seed))
    paper = serve_paper(args.seed, kernels + [flash_attention_chunk])
    emit(paper)
    release()

    bundle_kernels = [expert_ffn, flash_attention, flash_decode]
    emit(check_bundle_small(args.seed))
    release()
    ffn_record, bundles = serve_bundles(args.seed, bundle_kernels)
    emit(bundles)
    results.append(ffn_record)
    emit(check_train(args.seed))
    train = train_model(args.seed, [expert_ffn, flash_attention])
    emit(train)
    release()
    emit(check_train_families(args.seed))
    trained = train_families(args.seed, [flash_attention, flash_attention_cross, ssd_scan])
    emit(trained)

    emit(check_families_small(args.seed))
    families = serve_families(args.seed, [flash_attention, flash_attention_cross,
                                          flash_decode, ssd_scan])
    emit(families)
    release()
    at_shapes = shape_kernel_checks(g)
    shapes = shape_pairs(args.seed, shape_set)
    emit(shapes)
    release()
    at_mesh = mesh_kernel_checks(g)
    mesh = mesh_phase(args.seed)
    emit(mesh)
    cross = variants["flash_attention_cross"][0]
    results.append(dict(name="flash_attention_cross", route="cuda",
                        source="src/repro_torch/csrc/flash_attention.cu",
                        replaces="src/repro/kernels/flash_attention.py:96",
                        **{k: v for k, v in cross.items() if k != "variant"}))

    # each kernel's launches from the paths that run it
    launches = {}
    for phase in (srv, bat, clu, examples, ssm, paper, bundles, train, trained, families,
                  shapes, mesh):
        for n, c in phase["launches"].items():
            launches[n] = launches.get(n, 0) + c
    compact = ("variant", "shape", "B", "W", "max_abs_err", "ms", "device_ms", "parts",
               "plain_ms", "bound_ms", "bound_by", "library_ms", "library_device_ms",
               "cublas_device_ms")
    summary = [{k: r[k] for k in ("name", "route", "source", "replaces")}
               | {"launches": launches[r["name"]]}
               | {k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                    "bound_by", "library_ms")}
               | {k: r[k] for k in ("device_ms", "parts", "library_device_ms",
                                    "cublas_device_ms", "folded_device_ms") if k in r}
               | {k: {c: r[k][c] for c in compact if c in r[k]}
                  for k in ("long", "batch") if k in r}
               | ({"variants": [{k: v[k] for k in compact if k in v}
                                for v in variants[r["name"]]]}
                  if variants.get(r["name"]) else {})
               | ({"shapes": [{k: v[k] for k in compact if k in v}
                              for v in at_shapes[r["name"]]]}
                  if at_shapes.get(r["name"]) else {})
               | ({"mesh": [{k: v[k] for k in compact if k in v}
                            for v in at_mesh[r["name"]]]}
                  if at_mesh.get(r["name"]) else {})
               for r in results]
    print(card, flush=True)
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
