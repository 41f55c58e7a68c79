#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one CUDA card (Hopper,
sm_90a):

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

  1. build   -- compile ``src/repro_torch/csrc/*.cu`` for sm_90a and print
                each kernel's registers, shared memory and spills, and each
                tensor-core body's count of tensor-core instructions in the
                built library (``cuobjdump -sass``): none, or a spill of any
                instantiation (head dims (64, 64), (128, 128), (192, 128);
                at (192, 128) the dk/dv body's dV and dK passes), fails (the
                bf16 forward, dq and dk/dv bodies); so does a spill of any
                paged-decode body.
  2. kernels -- each CUDA kernel against its plain PyTorch version on the
                card, TF32 off: f32 within 1e-4, bf16 within 2e-2 of the
                plain version fed the same bf16 inputs (the flash kernels
                also at MLA's KH = H = 128, D 192, Dv 128; paged decode on the
                edges of its 64-position splits, a full table, int32 and
                int64 tables, padding pointed at a NaN page, at the serving
                shape KH 4 and the speculative draft's KH 2; the flash
                kernels also at ``CROSS_SHAPES``: Whisper's encoder, S = T
                1500, and its cross-attention, S 448 over T 1500, both
                non-causal MHA 20/20 at D 64; the VLM's image layers, S 1024
                over T 1601, non-causal GQA 32/8 at D 128; Jamba's attention
                layer, causal GQA 64/8; and at a query offset, ``q_offset``,
                as a context-parallel chunk reads: ``OFFSET_HEADS`` at
                offsets 0, 77, C and T - C); two launches of each backward
                kernel and of paged decode on the same inputs give the same
                bits.
  3. f32     -- TinyLlama-1.1B at full width, 2 layers, f32: the same 8
                requests through ``make_server`` with the ``cuda`` and the
                ``torch`` kernel backends must give identical token streams;
                the ``slots`` engine and the speculative policy (draft_k 4)
                must give the paged greedy streams, and on width-consistent
                weights (a width-only de-coalescing of a level-1 init) a
                width-only draft must equal greedy with accept rate > 0.9.
  4. bf16    -- TinyLlama-1.1B as configured (22 layers, bf16 compute), 16
                requests of 40..1536 prompt tokens, two pairs sharing a
                256-token prefix: every request completes, logits are finite,
                and the kernels' launch counts match the path's structure.
  13. speculative -- phase 4's traffic through the speculative policy
                (draft_k 4; the draft is the level-1 coalescing of the
                serving weights, 11 layers at d 1024): every request
                completes, draft and verify logits are finite, first tokens
                equal phase 4's, a stream leaves phase 4's only at a
                near-tie of the full model (both tokens within 4e-2 of
                max(1, max |logit|) of the top logit of a fresh prefill of
                the shared context), the projection equals the ``torch``
                backend's leaf for leaf, and flash, paged decode and
                coalesce_pair launch as the path implies; how far each
                stream agrees with phase 4's, the gaps at each divergence,
                the rounds, accept rate, the draft/verify split, tokens/s
                and the projection's time are printed.
  6. train   -- GPT-Base at full width, 2 layers, f32, seq 1024, batch 2:
                one train step on the ``cuda`` and the ``torch`` backends
                gives the same loss, parameter gradients and updated
                parameters; a width-only coalescing of the real tree equals
                the ``torch`` backend's, and a de-coalesce then coalesce
                gives the tree back bit for bit.
  6b. train  -- the same for BERT-Large at full width, 2 layers, f32, seq
                1024, batch 2, on an MLM batch: 1024 > ``attn_block_k``, so
                the encoder reaches the flash kernels non-causally.
  7. vcycle  -- ``VCycleRunner`` (what ``run_vcycle`` wraps) on GPT-Base as
                configured (12 layers, bf16 compute, f32 master weights, seq
                1024, batch 8), 2 levels, 1 + 5 + 10 steps (Table 2's
                ratio at 10) on ``MarkovLM`` batches, then ``run_scratch``
                for 10 steps on the same
                batches: finite losses that fall, the segment schedule, the
                FLOPs account, every kernel's launch count derived from the
                specs, the plans and the schedule, and every transition
                replayed from the same trees on the ``torch`` backend
                (coalesced leaves exactly equal, interpolated within 1 ulp).
  8. bert    -- the same for BERT-Large as configured (24 layers, d_model
                1024, bf16 compute) on MLM batches (seq 512, batch 8), under
                the paper's Table 4 three-level schedule at 24 steps: 1 + 1 +
                8 + 8 + 24 steps, then 24 from scratch; no flash launch at
                seq 512.
                ``saving_vs_baseline`` and the H100 energy report printed.
  9. deit    -- the same for DeiT-B as configured (224/16: 197 tokens, 1000
                classes) on class-conditional patches (batch 64, peak rate
                6.25e-5, DeiT's recipe), under the Table 3 schedule: 2 + 20
                + 40 steps, then 40 from scratch.
  10. baselines -- the paper's five baselines on BERT-Base at full width
                (seq 512, batch 8, Table 1 schedule), 4 small and 4 final
                steps (and 3 LiGO fit steps) each: finite losses and every
                step's FLOPs charge.
  11. resume -- phase 7's GPT-Base V-cycle again, through the launcher's
                ``train_vcycle_ckpt`` with a ``CheckpointManager`` saving every
                4 global steps, killed just after the save at global step 4
                (the middle of the upward sweep); the restored state checked
                (phase up, level 1, stash of level 0), resumed in a fresh
                runner: ``History`` equal to phase 7's uninterrupted run,
                losses and final parameters bit for bit, launches as the
                schedule implies; each save's snapshot and write walls and
                bytes written and reused printed; a re-invocation on the
                finished directory takes no step.
  12. handoff -- the launcher (``--arch gpt-base --vcycle --steps 4 --batch 8
                --seq 1024 --ckpt-every 2``, GPT-Base at full width cut to 4
                layers, through ``launch_worker``, started and warmed up
                before phase 7) trains on the card in a
                subprocess while a paged server of that model here serves
                waves with a ``ManifestWatcher`` on its directory: two or more
                level-0 steps swapped in publish order by digest diff, every
                coalesced step examined skipped, no request dropped, the last
                wave equal to a fresh server's on the landed weights, which
                are the terminal checkpoint's; beside it, SIGTERM in the
                upward sweep of the same CLI (a second warm process) gives
                exit 0 and a blocking checkpoint, and the restart (the CLI's
                ``main`` in this process) resumes at that step and ends with
                the terminal checkpoint.
  14. moe-f32 -- Phi-3.5-MoE at full width (d 4096, 32/8 heads of 128, 16
                experts top-2, expert width 6400), 2 layers, f32: one train
                step at seq 1024, batch 1, on both kernel backends (loss,
                ``moe_aux``, gradients and updated parameters at phase 6's
                tolerances), then 8 requests past 512 tokens, one pair
                sharing a 256-token prefix (the padded extend step routes
                its padding), served with identical streams on both.
  15. moe-serve -- Phi-3.5-MoE at full width, 4 layers, bf16 compute,
                phase 4's traffic: every request completes, logits are
                finite, flash and paged decode launch as the path implies;
                tokens/s, host wall per tick, peak memory and the routings
                dropped for capacity per step kind printed.
  16. moe-vcycle -- phase 7's checks on Phi-3.5-MoE at full width, 2
                layers, ``coalesce_experts`` (16 -> 8 experts at level 1),
                bf16 compute over f32 master weights, seq 1024, batch 4:
                1 + 5 + 10 steps, then 10 from scratch; ``moe_aux`` per
                level and each transition's peak memory printed.
  17. qwen3-serve -- Qwen3-4B as configured (36 layers, d 2560, D 128,
                ``qk_norm``, vocab 151936), bf16, phase 4's traffic:
                phase 15's checks.
  18. ssm-f32 -- xLSTM-125m at full width, its six-block pattern once (6
                of its 12 layers: d 768, 4 heads, one sLSTM, remat
                "full"), batch 2, run at f32
                and, with the same weights, at f64: a train step's loss and
                gradients on checkpointed chunks against the plain loop's
                (seq 64 in chunks of 16: past ~100 steps the sLSTM's
                gradients overflow f32 at this width, in the reference
                too), and at seq 64 and 256 prefill of all but one token
                plus one decode step against the full forward's logits and
                the decoded state against the prefill of all tokens.  The
                f32 arithmetic is chaotic at this width, so f32 is held to
                equal losses and finite values, and f64 to 1e-6 (losses,
                logits, states; each gradient leaf of its own largest
                value).  One Mamba layer at Jamba-1.5-Large's mixer widths
                (d 8192, d_inner 16384, d_state 16, dt rank 512), B 1, S
                1024, in chunks of 128, f32: the same checks at phase 6's
                tolerances.  No kernel lies on these paths.
  19. xlstm-vcycle -- phase 7's checks on xLSTM-125m as configured (bf16
                compute over f32 master weights, Table 2's ratio, batch 8,
                sequence and steps cut to ``XLSTM_TRAIN``): heads merge
                whole (4 -> 2 at level 1, 6 layers), the transitions run
                coalesce_pair and interp_axpy as the specs imply, no flash
                launch.  In place of a falling loss (``vcycle_phase``'s
                ``learns``): every gradient norm finite, every step moves
                the parameters, and the first step of each level replayed
                with AdamW written out gives its loss and parameters at
                phase 6's tolerances.
  20. xlstm-serve -- xLSTM-125m at full width, 6 of its 12 layers (phase
                18's cut), bf16, on the slots engine
                (the paged engine refuses recurrent blocks), the first 4 of
                phase 4's prompts (``XLSTM_LENGTHS``), batch 8, 32 new
                tokens: every request
                completes, logits are finite, no kernel launches; tokens/s,
                host wall per prefill token and per decode tick, peak
                memory printed.
  21. mla-f32 -- DeepSeek-V3 at full width (d 7168, 128 heads, MLA, top-8
                routing with the shared expert), cut to one MoE layer of 16
                experts plus the MTP head, f32: one train step at seq 1024,
                batch 1, on both kernel backends (``ce``, ``mtp_ce``,
                ``moe_aux``, gradients and updated parameters at phase 6's
                tolerances; the MTP block's flash launches not doubled by
                remat); then prefill and absorbed decode against the
                forward's logits on the dense and the paged latent cache
                (``mla_decode_phase``), with no paged-decode launch.
  22. mla-vcycle -- phase 7's checks on that cut, bf16 compute over f32
                master weights, Table 2's ratio, 1 + 3 + 6 steps at batch 2
                x 1024, then 6 from scratch: coalesce_pair on the
                ``q_lora``/``kv_lora`` axes too, the MTP head's
                ``embed_cat2`` maps dense (as in the reference).
  23. mla-serve -- DeepSeek-V3 at full width, one dense and one MoE layer
                of 64 experts, bf16, phase 4's traffic: phase 15's checks,
                flash launches per cold long prefill, no paged-decode launch
                (absorbed decode runs in the latent space).
  24. jamba-f32 -- Jamba-1.5-Large at full width (d 8192, 64/8 heads of
                128, Mamba d_inner 16384, experts of width 24576 top-2), cut
                to blocks b2-b3 (Mamba + dense FFN, attention + MoE) with 2
                experts, f32: one train step at 1 x 1024 on both kernel
                backends (phase 6's checks), then prefill 1024 tokens and
                decode token 1025 from the caches (self K/V, Mamba state)
                against the forward within 1e-4 of max(1, max |logit|)
                (``cross_decode_phase``).
  25. jamba-vcycle -- phase 7's checks on that cut, bf16 compute over f32
                master weights, Table 2's ratio, 1 + 3 + 6 steps at 1 x
                1024, then 6 from scratch.
  26. jamba-serve -- the same blocks with 16 experts, bf16, phase 4's
                traffic on the slots engine (the paged engine refuses Mamba
                blocks): every request completes, flash launches as the
                prefills imply, no paged-decode launch (``slots_serve_phase``).
  27-29.      -- the same for Whisper-large-v3: the f32 step at 2 + 2 layers
                and 2 x 448 decoder tokens (the encoder's 1500 frames and
                the cross-attention on the flash kernels, the 448-token
                self-attention on the plain route), decode from the self
                and cross caches; the V-cycle at full width on 8 + 8 of its
                32 + 32 layers (the encoder halving too) at 4 x 448 on phase
                25's schedule,
                on seeded normal
                frames (``_normal_frames``: on the stub's ones the first
                step's gradients are NaN); serving as configured,
                8 requests of 16-400 tokens, each prefill encoding 1500 stub
                frames.
  30-32.      -- the same for Llama-3.2-Vision-11B: the f32 step and the
                V-cycle (2 x 1024) on ``vlm_cut`` (an image and a
                self-attention layer, twice, at full width; the gates opened
                to 0.5 in the f32 step and the decode check), serving as
                configured (40 layers, 8 image layers over 1601 stub
                image tokens) on phase 4's traffic.
  33. remat  -- GPT-Base level 0 as configured at 8 x 1024, bf16 over f32
                weights: two steps under remat "none", "full" and "dots"
                from the same weights and batch; equal first losses, the
                first step's AdamW first moments (the gradients) and the
                second step's loss held to "none"'s, peaks ordered full <=
                dots <= none, flash launches as the setting implies (the
                forward twice a layer under "full" and "dots").
  34. mesh   -- the launcher's V-cycle (``train_vcycle_ckpt``) on a 1x1 mesh,
                as ``--mesh 1x1 --grad-compression dense`` and then
                ``int8_ef`` give it: a one-rank NCCL group, the 4-ary step,
                under int8_ef one ``ef_int8_psum`` a step; GPT-Base at full
                width cut to 4 of its 12 layers, Table 2's ratio at 2 steps
                (1 + 1 + 2), 8 x 1024; launches as the
                schedule implies, a falling loss; the reduction's wall a
                step, wire bytes and EF norms printed.
  35. dp     -- two processes share the card as ``--mesh 2x1`` (gloo with
                CUDA tensors: NCCL refuses two ranks on one device), each
                on its 4 x 1024 rows of phase 34's global batch, dense then
                int8_ef: every rank exits 0 in time, the ranks' parameters
                bit-identical and losses equal, each rank's launches as the
                schedule implies, losses and final parameters within
                ``DP_TOL`` of phase 34's run of the same reduction.  The
                parent frees its own CUDA memory first.
  36. coord  -- coordinated checkpoints through the launcher
                (``COORD_TRAIN``: GPT-Base at full width, its 12 layers cut
                to 4, the V-cycle at 4 steps, 8 x 1024); pairs of processes
                share the card as in phase 35, one-process runs go through
                the launcher's ``main`` here.  36a: a SIGTERM to rank 1 alone
                of a dense ``--ckpt-dir`` run drains both ranks at one
                global step in the upward sweep (the manifest names it), and
                one process resumes the directory within ``DP_TOL["dense"]``
                of an uninterrupted one-process run; 36b: the same kill of an
                int8_ef run, every rank's EF rows restored on two processes
                with the digests the manifest recorded at the save, a resume
                on one process refused; 36c: a one-process
                ``--ckpt-local-dir`` save (drained by a SIGTERM) resumed on
                two processes, rank 1 from an empty dir gathering the objects
                over the store (bytes and rate printed), within
                ``DP_TOL["dense"]``, and 36b's command with
                ``--ckpt-local-dir`` per rank, drained at 36b's step, its
                dirs restored on one process with rank 1's as ``peer_dirs``
                bit-equal to 36b's shared dir; 36d: the serving CLI with
                ``--reload-local`` refuses 36c's terminal checkpoint (each
                rank's FSDP blocks in its own dir) naming
                ``--reload-peer-dirs``, and with rank 1's dir there swaps it
                in and decodes, the landed leaves the checkpoint's.  Every save's
                wall and bytes are printed (the manager's
                ``last_save_stats``), and every process's launches held to
                the schedule (a drained part plus its resume to the whole).
                Every pair starts before phase 33 and waits, warm: 36a, 36b
                and the local-dir run go first, 36c's resume once its
                checkpoint is written, 36b's resume once 36b has ended
                (beside the checks of a copy of 36b's drained directory).
  37. mesh   -- serving on a ``--mesh 1x2`` of two processes sharing the
                card (gloo with CUDA tensors), one pair started before phase
                24 that imports the port meanwhile (``start_group``):
                (a) the serving CLI's ``main`` (``--mesh 1x2 --num-processes
                2``) builds TinyLlama-1.1B's sharded server as configured
                (22 layers, bf16), which serves phase 4's traffic: both
                ranks' streams equal, finite logits, every request done,
                each rank's flash and paged-decode launches equal phase 4's
                and its derivation, 2 x 22 + 1 all-reduces and one
                all-gather a decode tick, the pools holding 2 of the 4 K/V
                heads, the first decode tick's logits within
                ``MESH_BF16_LOGIT_TOL`` of phase 4's; tokens/s, host wall a tick and each rank's peak
                memory printed; in (a)-(c) every prefill and extend gathers
                its logits as one [B, V] block (the last position's), and
                the prefills' host wall is printed; (b) TinyLlama at full width cut to 2
                layers, f32: the 1x2 streams equal the one-process server's
                (rank 0 runs it), before and after a ``set_params`` swap,
                the first decode tick's logits within ``MESH_LOGIT_TOL``;
                (c) Phi-3.5-MoE at full width cut to 2 layers, f32, 8 of its
                16 experts a rank: the streams equal the one-process
                server's, and rank 0's dropped-routing tally equals the
                one-process tally while rank 1 keeps none.
  38. train-mesh -- training on a ``--mesh 1x2`` of two processes sharing
                the card, a pair started before phase 24 that warms up
                meanwhile (``start_group``): (a) the launcher's
                ``main`` trains GPT-Base as configured (12 layers, bf16)
                through the V-cycle (``TRAIN_MESH_ARGS``: 1 + 1 + 2 steps on
                2 x 1024): the first step's loss and grad_norm within
                ``TRAIN_MESH_TOL`` of one process's (here), every step's
                collectives and flash launches, no gather of the logits
                (they stay split over "model" through the loss; the first-
                step peak a rank printed beside the gathered form's), each
                transition's
                coalesce_pair and interp_axpy launches and the run's total
                as derived, replicated leaves bit-identical on both ranks and
                split ones half-size, each rank's first-step peak below one
                process's, and the last checkpoint restored here on one
                device with its eval loss within ``TRAIN_MESH_TOL`` of rank
                0's; (b) two steps of Phi-3.5-MoE (one layer, 8 of 16
                experts a rank, f32) within ``TRAIN_MESH_MOE_TOL`` of one
                process's, loss, ``moe_aux``, grad_norm and the gathered
                router equal on both ranks.  Each step's wall, collectives
                and their host time, each transition's gather and each
                rank's peak are printed.
  39. fsdp   -- FSDP and the families on a "model" axis, two processes
                sharing the card, a pair started before phase 24
                (``start_group``): (a) the launcher's ``main`` trains
                GPT-Base as configured on ``--mesh 2x1`` (``FSDP_ARGS``,
                phase 38's schedule; the default ``--grad-compression
                none``, weights gathered per layer): the first step's loss
                and grad_norm within ``FSDP_TOL`` of one process's (here),
                every step's FSDP collectives and flash launches, each
                transition's launches and the run's total as derived, each
                rank's resident parameters and moments its blocks of the
                layout (half of one process's but for the biases without an
                ``embed`` dim), its first-step peak below one process's,
                and the last checkpoint restored here on one device with
                its eval loss within ``FSDP_TOL`` of the ranks' mean; (b)
                two steps with ``pregather_params``: one gather and one
                reduce-scatter a step, within ``FSDP_TOL`` of one
                process's; (c) on a 1x2 group, two steps each of
                xLSTM-125m cut to one mLSTM and one sLSTM block (f64),
                Jamba's Mamba block and Whisper-large-v3 cut to 1 + 1
                layers (f32), within ``FAMILY_MESH_TOL`` of one process's
                and equal on both ranks.
  40. mesh+  -- (a) phase 37's ranks go on, beside phases 38-39, with the
                speculative policy on 1x2 (TinyLlama-1.1B bf16 through the
                CLI on phase 13's traffic: streams equal 37(a)'s greedy but
                at near-ties, paged launches as the draft and verify steps
                imply, the draft projection's coalesce_pair launches as
                phase 13's; the 2-layer f32 cut's streams and accepted
                tokens equal one process's before and after a hot swap),
                then the f32 cut greedy on 2x1 (no collective); (b) four
                processes serve Phi-3.5-MoE (2 layers, f32) on 2x2, experts
                over ("model", "data"): one process's streams before and
                after a swap, expert block m*2 + d a rank, block 0's
                dropped-routing tally; (c) three processes train with
                context-parallel attention on 1x3: Qwen3-14B at full width
                cut to one layer (bf16 state, 1 x 3072) two level-0 steps
                through ``VCycleRunner(mesh=)``, and Whisper-large-v3 at 1 +
                1 layers through the launcher's V-cycle (f32, 432 tokens on
                1500 frames): the first loss and grad norm within ``CP_TOL``
                of one process's, flash launches as one process's, every
                flash forward reading its rank's chunk at its offset, the
                derived collectives a step.
  41. dryrun -- (a) two processes started after phase 2, one thread each,
                off the card, run ``launch/dryrun.py``'s ``lower_cell`` at
                full width and depth on the fake 256- and 512-rank meshes
                (``DRYRUN_CELLS``: Qwen3-14B train_4k, TinyLlama-1.1B
                prefill_32k and DeepSeek-V3 decode_32k on 16x16, Jamba-
                1.5-Large long_500k on 2x16x16); each cell's record is
                printed and must be ok with finite roofline terms.  (b)
                ``launch/op_cost.py``'s counter on the card and on meta for
                the same steps, the GPT-Base train step (12 layers, 8 x
                1024; the flash forward, dq and dk/dv kernels against their
                meta forms) and a TinyLlama-1.1B ``make_serve_step`` on
                dense caches (8 x 2048): FLOPs, op counts by kind and the
                kernels' recorded costs equal, bytes within 2%, the meta
                peak within 10% of ``max_memory_allocated`` from a reset
                (less what was allocated beyond the step's arguments); the
                roofline's step time beside the measured one, and the
                card's bf16 8192^3 matmul rate and 1 GiB copy bandwidth
                beside the spec constants, with the card's name and power
                limit.
  42. examples -- one process started after phase 2 (``start_examples``),
                beside phases 3-23, calls each of the reference's four
                examples as ``repro_torch.examples.<name>.main(argv)`` on
                the card (``EXAMPLES``): ``quickstart`` as shipped (its
                FLOPs saving printed), ``vcycle_pretrain --full-100m``
                (GPT-Base's widths) and ``--config moe`` at
                ``EXAMPLE_STEPS`` steps (the plan it prints equal to
                ``Model.projection_plan(ml).describe()``), ``serve_decode``
                on the paged engine greedy and speculative (10 requests of
                12 tokens), and ``elastic_restart``'s three acts (act 3:
                two launcher processes on ``--mesh 2x1`` sharing the card
                drain at one global step after a SIGTERM to one, and one
                process resumes to the terminal checkpoint).  Each
                example's kernel launches, counted from 0 just before its
                ``main``, include those of ``EXAMPLE_KERNELS``; every
                printed line is logged.
  5. timing  -- each kernel timed with CUDA events at its main path's
                shapes (device time: L2 flushed, host ahead of the device),
                beside its bound, its plain version and a library
                yardstick (run last: it reads the counts of phases 4 and
                7-12);
                paged decode also at two long shapes (B = 1 at 2047
                positions, B = 8 at 2048 each), at the speculative
                draft's middle tick (KH 2) and on its narrow body at phase
                42's serving shape (KH 2, G 2, D 16); and at Phi-3.5-MoE's shapes (D
                128, GQA 32/8): the flash forward, dq and dk/dv of a
                training layer (B 4, S 1024) and paged decode at phase 15's
                middle tick; and the flash kernels at MLA's training layer
                (B 1, S 1024, 128 heads, D 192, Dv 128), Whisper's
                cross-attention (S 448, T 1500) and the VLM's image layer
                (S 1024, T 1601), both non-causal; and at a context-
                parallel chunk (Qwen3-14B's last rank of 1x3: S 1024 at
                offset 2048 of T 3072, GQA 40/8, D 128), where the library
                yardsticks take the lower-right causal mask.  Each backward's library
                time is the fastest of PyTorch's one-call backward ops that
                take the shape (flash, cuDNN, memory-efficient), each timed
                and printed with SDPA's autograd backward beside them.

Phases run in the order 1-4, 13, 6, 6b, 7, 11, 12, 8-10, 14-42, 5; phase
41(a)'s and phase 42's processes start after phase 2.  The
card's name and power limit are printed on the line before the JSON object
with one entry per kernel (its launches per main path, ``serve_speculative``,
``serve_moe``, ``vcycle_moe``, ``scratch_moe``, ``serve_qwen3``,
``vcycle_xlstm``, ``scratch_xlstm``, ``serve_xlstm``, ``vcycle_mla``,
``scratch_mla``, ``serve_mla`` and the ``vcycle_``, ``scratch_`` and
``serve_`` paths of ``jamba``, ``whisper`` and ``vlm``, ``remat_none``,
``remat_full``, ``remat_dots``, ``mesh_int8_ef``, rank 0's ``dp_dense``
and ``dp_int8_ef``, and phase 36's ``coord_1proc``, ``coord_2to1_dense``,
``coord_int8_ef``, ``coord_1to2_local`` and ``coord_reload_local``, and
phase 37's rank 0 ``serve_mesh``, phase 38's rank 0 ``train_mesh`` and
``train_mesh_moe``, and phase 39's rank 0 ``fsdp``, ``fsdp_pregather``,
``mesh_xlstm``, ``mesh_jamba`` and ``mesh_whisper``, and phase 42's
``example_<tag>`` of each example included), and the
last line is the device record
``{"ok": true, "device": {...}}``.  Without a CUDA card, or away from the
repository's ``src/repro_torch``, the script exits non-zero before printing
any result.
"""
from __future__ import annotations

import atexit
import contextlib
import dataclasses
import io
import json
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_F32_FLOPS = 67e12    # H100 SXM f32 outside the tensor cores
PEAK_BYTES = 3.35e12      # H100 SXM HBM3
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
SEED = 0
SPIN_CYCLES = 4_000_000  # ~2 ms of device spin in time_ms, far above a wrapper's host time
# the CUDA kernel bodies of src/repro_torch/csrc, as ptxas names them
KERNEL_BODIES = ("flash_fwd_kernel", "flash_fwd_mma_kernel", "flash_bwd_dq_kernel",
                 "flash_bwd_dq_mma_kernel", "flash_bwd_dkv_kernel",
                 "flash_bwd_dkv_mma_kernel", "paged_decode_split_kernel",
                 "paged_decode_narrow_kernel", "paged_decode_merge_kernel",
                 "coalesce_pair_kernel", "interp_axpy_kernel")
# the bodies that must run on the tensor cores (bf16 mma.sync tiles)
MMA_BODIES = ("flash_fwd_mma_kernel", "flash_bwd_dq_mma_kernel", "flash_bwd_dkv_mma_kernel")
# the (query/key, value) head dims the flash kernels take: GPT/BERT/TinyLlama
# heads, Phi-3.5-MoE's and Qwen3's, and DeepSeek-V3's MLA (nope 128 + rope 64, v 128)
HEAD_DIMS = ((64, 64), (128, 128), (192, 128))
# each tensor-core body's instantiations as ptxas names them; the dk/dv body's
# last parameter is the part a launch accumulates (1 dV, 2 dK, 3 both: at
# (192, 128) it runs as a dV pass and a dK pass), the dq body's the half of
# dQ's columns (at (192, 128) one launch a half)
MMA_INSTANCES = {
    "flash_fwd_mma_kernel": [f"flash_fwd_mma_kernel<bf16,{a},{b}>" for a, b in HEAD_DIMS],
    "flash_bwd_dq_mma_kernel": [f"flash_bwd_dq_mma_kernel<bf16,{n}>" for n in
                                ("64,64,0", "128,128,0", "192,128,0", "192,128,1")],
    "flash_bwd_dkv_mma_kernel": [f"flash_bwd_dkv_mma_kernel<bf16,{n}>" for n in
                                 ("64,64,3", "128,128,3", "192,128,1", "192,128,2")],
}
# the flash kernels' shapes on the cross-attention families' and Jamba's paths,
# (B, S, T, causal, H, KH, D, Dv): Whisper-large-v3's encoder (1500 frames) and
# its decoder's cross-attention (448 tokens over them), non-causal MHA 20/20 at
# D 64; Llama-3.2-Vision's image layers (1601 image tokens, a prime), non-causal
# GQA 32/8 at D 128; Jamba-1.5-Large's attention layer, causal GQA 64/8
CROSS_SHAPES = ((1, 1500, 1500, False, 20, 20, 64, 64), (1, 448, 1500, False, 20, 20, 64, 64),
                (1, 1024, 1601, False, 32, 8, 128, 128), (1, 1024, 1024, True, 64, 8, 128, 128))
# the paged-decode bodies: no instantiation may spill
PAGED_BODIES = ("paged_decode_split_kernel", "paged_decode_narrow_kernel",
                "paged_decode_merge_kernel")
# 16-byte chunks of one interp_axpy block: one per thread (csrc/interp_axpy.cu)
AXPY_BLOCK_CHUNKS = 256


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# phase 1: build


def _body_name(mangled: str) -> str:
    """``name<type,N,...>`` of a kernel template's mangled name, its integer
    parameters in order (the flash bodies': query/key head dim, value head
    dim and, for dk/dv, the part a launch accumulates), or ``name<type>``
    where it has none (the tensor-core bodies take bf16 only and have no
    type parameter)."""
    k = re.search(r"([a-z_]+_kernel)I(f|13__nv_bfloat16)?((?:Li\d+E)*)E", mangled)
    if not k:
        return mangled
    params = ["f32" if k.group(2) == "f" else "bf16"] + re.findall(r"Li(\d+)E", k.group(3))
    return f"{k.group(1)}<{','.join(params)}>"


def find_cuobjdump() -> str:
    """``cuobjdump`` beside ``nvcc``, else the copy in Triton's package."""
    import importlib.util

    from repro_torch.kernels import build

    path = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    if os.path.exists(path):
        return path
    spec = importlib.util.find_spec("triton")
    if spec and spec.origin:
        path = os.path.join(os.path.dirname(spec.origin), "backends", "nvidia", "bin",
                            "cuobjdump")
        if os.path.exists(path):
            return path
    raise RuntimeError("cuobjdump not found beside nvcc or in triton's package")


def sass_mma_counts(lib_path) -> dict:
    """Kernel body -> its count of tensor-core instructions (HMMA, HGMMA) in
    the built library's SASS."""
    text = subprocess.run([find_cuobjdump(), "-sass", str(lib_path)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = _body_name(m.group(1))
            counts[name] = 0
        elif name and re.search(r"\bHG?MMA\.", line):
            counts[name] += 1
    return counts


def build_phase() -> None:
    from repro_torch.kernels import build

    t0 = time.time()
    path, text = build.build()
    per_kernel = {}
    name = None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = _body_name(m.group(1))
            per_kernel[name] = {}
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            per_kernel[name]["spill"] = f"{m.group(1)}/{m.group(2)}"
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            per_kernel[name]["regs"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            per_kernel[name]["static_smem"] = int(s.group(1)) if s else 0
    for body in KERNEL_BODIES:
        check(any(n.startswith(body + "<") for n in per_kernel),
              f"ptxas reported no {body}:\n{text}")
    log(f"[build] {path.name} in {time.time() - t0:.1f}s; " + "; ".join(
        f"{n} regs={v.get('regs')} static_smem={v.get('static_smem')} "
        f"spill(st/ld)={v.get('spill')}" for n, v in per_kernel.items()))
    sass = sass_mma_counts(path)
    log("[build] tensor-core instructions (HMMA/HGMMA) in the SASS: " + "; ".join(
        f"{n}={c}" for n, c in sass.items()))
    for body in MMA_BODIES:
        for n, c in sass.items():
            if n.startswith(body + "<"):
                check(c > 0, f"{n} has no tensor-core instruction in its SASS")
        check(any(n.startswith(body + "<") for n in sass), f"no SASS for {body}")
        for n in MMA_INSTANCES[body]:  # no tensor-core body may spill
            check(n in per_kernel, f"ptxas reported no {n}")
            spill = per_kernel[n].get("spill")
            check(spill == "0/0", f"{n} spills: {spill}")
    for n, v in per_kernel.items():
        if n.startswith(PAGED_BODIES):
            check(v.get("spill") == "0/0", f"{n} spills: {v.get('spill')}")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions


def _randn(shape, dtype, dev, gen):
    return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(dtype)


def paged_inputs(dev, dtype, lengths, gen, *, KH=4, G=8, D=64, P=16, M=128):
    """q, pools with one spare NaN page, the clean tables (padding -> page 0)
    and the kernel's tables (padding -> the NaN page), lengths."""
    B = len(lengths)
    N = B * M + 1
    q = _randn((B, KH, G, D), dtype, dev, gen)
    k_pages = _randn((N + 1, P, KH, D), dtype, dev, gen)
    v_pages = _randn((N + 1, P, KH, D), dtype, dev, gen)
    k_pages[N] = float("nan")  # never referenced by a valid position
    v_pages[N] = float("nan")
    perm = torch.randperm(N - 1, generator=torch.Generator().manual_seed(SEED)) + 1
    tables = torch.zeros((B, M), dtype=torch.int64)
    for b, n in enumerate(lengths):
        used = -(-n // P)
        tables[b, :used] = perm[b * M:b * M + used]
    poisoned = tables.clone()
    for b, n in enumerate(lengths):
        poisoned[b, -(-n // P):] = N
    ln = torch.tensor(lengths, dtype=torch.int64)
    return q, k_pages, v_pages, tables.to(dev), poisoned.to(dev), ln.to(dev)


def kernel_phase(dev) -> None:
    gen = torch.Generator(device=dev).manual_seed(SEED)
    dts = (torch.float32, torch.bfloat16)
    # serving (TinyLlama GQA 32/4, B = 1) and the V-cycle's two levels
    # (GPT-Base MHA 12/12 and 6/6, B = 8, S = T = 1024)
    cases = [(1, S, S, True, dt, 32, 4) for S in (640, 1031, 2048) for dt in dts]
    cases += [(1, 1031, 1031, True, dt, 16, 2) for dt in dts]  # the speculative draft
    cases += [(1, 640, 1031, False, dt, 32, 4) for dt in dts]
    cases += [(8, 1024, 1024, True, dt, H, H) for H in (12, 6) for dt in dts]
    cases = [c + (64,) for c in cases]
    # D = 128, ragged: causal GQA and non-causal MHA with T != S
    cases += [(1, 1031, 1031, True, dt, 32, 4, 128) for dt in dts]
    cases += [(2, 777, 1031, False, dt, 12, 12, 128) for dt in dts]
    # Phi-3.5-MoE and Qwen3 (GQA 32/8, D 128): a training row, a long prompt
    cases += [(1, S, S, True, dt, 32, 8, 128) for S in (1024, 1536) for dt in dts]
    cases = [c + (c[-1],) for c in cases]  # Dv = D
    # DeepSeek-V3's MLA (KH = H = 128, D 192, Dv 128): a training row, and
    # a ragged T causal and not
    cases += [(1, 1024, 1024, True, dt, 128, 128, 192, 128) for dt in dts]
    cases += [(1, 777, 1031, c, dt, 128, 128, 192, 128) for c in (True, False) for dt in dts]
    cases += [c[:4] + (dt,) + c[4:] for c in CROSS_SHAPES for dt in dts]
    for B, S, T, causal, dt, H, KH, D, Dv in cases:
        err, lerr = _flash_fwd_err(dev, gen, B, S, T, H, KH, causal, dt, D=D, Dv=Dv)
        log(f"[kernels] flash B={B} S={S} T={T} H={H} KH={KH} D={D} Dv={Dv} causal={causal} "
            f"{str(dt)[6:]}: max|out err|={err:.3e} max|lse err|={lerr:.3e}")
    paged_checks(dev, gen)
    flash_bwd_checks(dev, gen)
    offset_checks(dev, gen)
    elementwise_checks(dev, gen)


def paged_checks(dev, gen) -> None:
    """Paged decode against its plain version: the serving shape (KH 4, G 8,
    D 64, P 16, M 128, so M * P = 2048) with lengths on either side of the
    64-position split edges and at M * P, the speculative draft's (KH 2, B
    8), one sequence at the full table,
    MHA (G = 1), D = 128 at page size 4, a page size (24) whose pages
    straddle splits, and the narrow body's D 16 (the reduced TinyLlama's
    serving and draft shapes, 96 positions a row as phase 42 serves) and D
    32; int64 and int32 tables.  Table entries past a row's
    pages point at a NaN page, which no valid position may reach; length-0
    rows must be exact zeros, and a second launch must give the same bits."""
    from repro_torch.kernels import paged_attention as pa

    span = pa.SPLIT_SPAN
    cases = [([0, 1, 15, 16, 17, 777, 2048, 100], {}),
             ([0, span - 1, span, span + 1, 2 * span - 1, 2 * span + 1, 2048, 1], {}),
             ([2048], {}),
             ([3, span, span + 1, 700, 1100, 1537, 2048, 0], dict(KH=2)),
             ([0, 1, span + 1, 1000], dict(KH=12, G=1)),
             ([0, 5, span, 1023], dict(D=128, P=4, M=256)),
             ([span - 1, 24 * 3, 24 * 8 + 5, 950], dict(P=24, M=40)),
             # the narrow body: the reduced TinyLlama's serving (KH 2, G 2, D
             # 16) and its draft's (KH 1), and D 32
             ([0, 1, span - 1, span + 1, 30, 95], dict(KH=2, G=2, D=16, M=6)),
             ([3, span, 95, 96], dict(KH=1, G=2, D=16, M=6)),
             ([0, 33, span + 3, 500, 2048], dict(KH=2, G=4, D=32))]
    for dt in (torch.float32, torch.bfloat16):
        for lengths, shape in cases:
            q, kp, vp, bt, bt_poisoned, ln = paged_inputs(dev, dt, lengths, gen, **shape)
            want = pa.paged_attention_decode_torch(q, kp, vp, bt, ln)
            for idx in (torch.int64, torch.int32):
                bt_i, ln_i = bt_poisoned.to(idx), ln.to(idx)
                out = pa.paged_attention_decode_cuda(q, kp, vp, bt_i, ln_i)
                again = pa.paged_attention_decode_cuda(q, kp, vp, bt_i, ln_i)
                torch.cuda.synchronize(dev)
                err = (out.float() - want.float()).abs().max().item()
                log(f"[kernels] paged {shape or 'KH=4 G=8 D=64 P=16 M=128'} lengths={lengths} "
                    f"{str(dt)[6:]} {str(idx)[6:]} tables: max|err|={err:.3e} (padding "
                    f"entries point at a NaN page)")
                check(torch.isfinite(out).all().item() and err <= TOL[dt],
                      f"paged kernel disagrees with its plain version: {err}")
                check(torch.equal(out, again), f"two paged launches differ ({lengths}, {dt})")
                for b, n in enumerate(lengths):
                    if n == 0:
                        check(out[b].abs().max().item() == 0.0,
                              "a length-0 row is not exact zeros")


def _flash_fwd_err(dev, gen, B, S, T, H, KH, causal, dt, qkv=None, D=64, Dv=None,
                   q_offset=0):
    """(max |out err|, max |lse err|) of the flash forward kernel against
    its plain version on random (or the given) q, k, v (value head dim Dv,
    D unless given); fails beyond TOL[dt] and 1e-4 (lse is f32 in both)."""
    from repro_torch.kernels import flash_attention as fa

    q, k, v = qkv or (_randn((B, S, H, D), dt, dev, gen), _randn((B, T, KH, D), dt, dev, gen),
                      _randn((B, T, KH, Dv or D), dt, dev, gen))
    out, lse = fa.flash_attention_cuda(q, k, v, causal=causal, q_offset=q_offset)
    want, want_lse = fa.flash_attention_torch(q, k, v, causal=causal, q_offset=q_offset)
    torch.cuda.synchronize(dev)
    err = (out.float() - want.float()).abs().max().item()
    lerr = (lse - want_lse).abs().max().item()
    check(err <= TOL[dt] and lerr <= 1e-4,
          f"flash kernel B={B} S={S} T={T} H={H} KH={KH} causal={causal} {dt} disagrees "
          f"with its plain version: {err} / {lerr}")
    return err, lerr


def _scaled_err(got, want) -> float:
    """Max |got - want| over max(1, max |want|): gradients reach magnitudes
    of several units, where one bf16 rounding alone is above 2e-2."""
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1.0)).item()


def flash_bwd_checks(dev, gen) -> None:
    """dq, dk, dv of the two backward kernels against the plain backward,
    and the dq kernel's delta against rowsum(do * out): causal and not, MHA
    at both V-cycle levels' head counts (12, 6) and GQA 32/4, D 64 and 128,
    Phi-3.5-MoE's GQA 32/8 at D 128, and MLA's 128 heads at (D 192, Dv 128),
    ragged S and T; then at ``CROSS_SHAPES`` (Whisper's encoder and
    cross-attention, the VLM's image layers, Jamba's attention layer).
    bf16 tolerance: P
    and dS are rounded to bf16 before the
    tensor-core products, which the f32 plain version does not do; the
    error is taken relative to the largest gradient.  A second dq launch
    and a second dk/dv launch on the same inputs must give the same bits
    (no atomics)."""
    from repro_torch.kernels import flash_attention as fa

    # the GPT-Base levels, TinyLlama, and Phi-3.5-MoE's training heads (D 128)
    cases = []
    for H, KH, dims in ((12, 12, (64, 128)), (6, 6, (64, 128)), (32, 4, (64, 128)),
                        (32, 8, (128,)), (128, 128, ((192, 128),))):
        for D in dims:
            D, Dv = D if isinstance(D, tuple) else (D, D)
            cases += [(1, S, T, causal, H, KH, D, Dv)
                      for causal, S, T in ((True, 1000, 1000), (False, 1000, 777))]
    for dt in (torch.float32, torch.bfloat16):
        for B, S, T, causal, H, KH, D, Dv in cases + list(CROSS_SHAPES):
            q = _randn((B, S, H, D), dt, dev, gen)
            k = _randn((B, T, KH, D), dt, dev, gen)
            v = _randn((B, T, KH, Dv), dt, dev, gen)
            do = _randn((B, S, H, Dv), dt, dev, gen)
            out, lse = fa.flash_attention_torch(q, k, v, causal=causal)
            got = fa.flash_attention_bwd_cuda(q, k, v, out, lse, do, causal=causal)
            want = fa.flash_attention_bwd_torch(q, k, v, out, lse, do, causal=causal)
            torch.cuda.synchronize(dev)
            errs = [_scaled_err(g, w) for g, w in zip(got, want)]
            dqs = [fa.flash_attention_bwd_dq_cuda(q, k, v, out, lse, do,
                                                  causal=causal) for _ in range(2)]
            delta = dqs[0][1]
            d_err = _scaled_err(delta, (do.float() * out.float()).sum(-1).transpose(1, 2))
            log(f"[kernels] flash bwd H={H} KH={KH} D={D} Dv={Dv} S={S} T={T} "
                f"causal={causal} {str(dt)[6:]}: scaled max err (dq, dk, dv)="
                f"({errs[0]:.3e}, {errs[1]:.3e}, {errs[2]:.3e}), delta {d_err:.3e}")
            check(all(g.dtype == w.dtype and g.shape == w.shape
                      for g, w in zip(got, want)), "flash bwd output types")
            check(max(errs) <= TOL[dt],
                  f"flash backward kernels disagree with the plain version: {errs}")
            check(d_err <= TOL[dt], f"dq kernel's delta disagrees: {d_err}")
            check(all(torch.equal(a, b) for a, b in zip(*dqs)),
                  f"two dq launches on the same inputs differ (H={H} KH={KH} "
                  f"D={D} causal={causal} {dt})")
            again = [fa.flash_attention_bwd_dkv_cuda(q, k, v, do, lse, delta,
                                                     causal=causal)
                     for _ in range(2)]
            check(all(torch.equal(a, b) for a, b in zip(*again)),
                  f"two dk/dv launches on the same inputs differ (H={H} KH={KH} "
                  f"D={D} causal={causal} {dt})")


# context-parallel chunks (q_offset): (H, KH, D, Dv) per head layout, the
# chunk's rows C of a causal sequence of T = 3 C (ragged against the 64-row
# tiles), and the offsets each is held at: 0, one inside a tile, C, T - C
OFFSET_HEADS = ((32, 4, 64, 64), (40, 8, 128, 128), (128, 128, 192, 128))
OFFSET_C = 200


def offset_checks(dev, gen) -> None:
    """The three flash kernels at a query offset (``q_offset``: row r reads
    keys 0..q_offset + r) against their plain versions, f32 and bf16, at
    ``OFFSET_HEADS`` with a chunk of ``OFFSET_C`` rows of T = 3 C at offsets
    0, 77, C and T - C; an offset past T - S raises before any launch."""
    from repro_torch.kernels import flash_attention as fa

    C, T = OFFSET_C, 3 * OFFSET_C
    for dt in (torch.float32, torch.bfloat16):
        for H, KH, D, Dv in OFFSET_HEADS:
            k, v = _randn((1, T, KH, D), dt, dev, gen), _randn((1, T, KH, Dv), dt, dev, gen)
            for off in (0, 77, C, T - C):
                q, do = _randn((1, C, H, D), dt, dev, gen), _randn((1, C, H, Dv), dt, dev, gen)
                out, lse = fa.flash_attention_cuda(q, k, v, causal=True, q_offset=off)
                want, want_lse = fa.flash_attention_torch(q, k, v, causal=True, q_offset=off)
                got = fa.flash_attention_bwd_cuda(q, k, v, want, want_lse, do, causal=True,
                                                  q_offset=off)
                wb = fa.flash_attention_bwd_torch(q, k, v, want, want_lse, do, causal=True,
                                                  q_offset=off)
                torch.cuda.synchronize(dev)
                err = (out.float() - want.float()).abs().max().item()
                lerr = (lse - want_lse).abs().max().item()
                errs = [_scaled_err(g, w) for g, w in zip(got, wb)]
                log(f"[kernels] flash q_offset={off} C={C} T={T} H={H} KH={KH} D={D} "
                    f"Dv={Dv} {str(dt)[6:]}: max|out err|={err:.3e} max|lse err|={lerr:.3e}"
                    f"; scaled (dq, dk, dv)=({errs[0]:.3e}, {errs[1]:.3e}, {errs[2]:.3e})")
                check(err <= TOL[dt] and lerr <= 1e-4 and max(errs) <= TOL[dt],
                      f"flash kernels at q_offset {off} (H={H} D={D} {dt}) disagree with "
                      f"their plain versions: {err} / {lerr} / {errs}")
    try:
        fa.flash_attention_cuda(q, k, v, causal=True, q_offset=T - C + 1)
        check(False, "flash_attention_cuda took q_offset + S > T")
    except ValueError:
        pass


def _ulps(got, want, chunk=1 << 26) -> int:
    """Largest distance in units in the last place (same-sign values), in
    chunks of ``chunk`` elements: an expert leaf of Phi-3.5-MoE holds 0.84 G."""
    it = torch.int32 if got.dtype == torch.float32 else torch.int16
    g, w = got.reshape(-1).view(it), want.reshape(-1).view(it)
    return max(int((g[i:i + chunk].long() - w[i:i + chunk].long()).abs().max().item())
               for i in range(0, g.numel(), chunk))


def elementwise_checks(dev, gen) -> None:
    """coalesce_pair exactly equal to its plain version (the same add and
    power-of-two scale); interp_axpy within 1 ulp (the kernel rounds the two
    products and the sum separately, as the plain version does, so 0 is
    expected), at sizes on either side of whole blocks (AXPY_BLOCK_CHUNKS x
    16 bytes x k blocks, +-1 element) and on views that do not start on a
    16-byte boundary (the scalar path)."""
    from repro_torch.kernels import coalesce_pair as cp
    from repro_torch.kernels import interp_axpy as ia

    shapes = [(768, 36864), (12, 589824), (768, 50304), (10, 7), (2, 1)]
    for dt in (torch.float32, torch.bfloat16):
        for shape in shapes:
            for axis in (0, 1):
                w = _randn(shape if axis == 0 else shape[::-1], dt, dev, gen)
                for w0 in (0.5, 1.0):
                    got = cp.coalesce_pair_cuda(w, axis=axis, w0=w0)
                    check(torch.equal(got, cp.coalesce_pair_torch(w, axis=axis, w0=w0)),
                          f"coalesce_pair {tuple(w.shape)} axis={axis} w0={w0} {dt} "
                          f"differs from its plain version")
            log(f"[kernels] coalesce_pair {shape} and its transpose, axis 0/1, "
                f"w0 0.5/1.0, {str(dt)[6:]}: exactly equal")
        step = AXPY_BLOCK_CHUNKS * (16 // dt.itemsize)  # elements of one block
        sizes = [1, 1023, 1025, 50304 * 768]
        sizes += [step * k + d for k in (1, 3, 4224) for d in (-1, 0, 1)]
        ulps = []
        for n in sizes:
            a, b = _randn((n,), dt, dev, gen), _randn((n,), dt, dev, gen)
            ulps.append(_ulps(ia.interp_axpy_cuda(a, b, 0.25), ia.interp_axpy_torch(a, b, 0.25)))
            check(ulps[-1] <= 1, f"interp_axpy n={n} {dt}: {ulps[-1]} ulp from its plain version")
        buf = _randn((2, step * 3 + 2), dt, dev, gen)
        a, b = buf[0, 1:-1], buf[1, 1:-1]  # neither starts on a 16-byte boundary
        u_mis = _ulps(ia.interp_axpy_cuda(a, b, 0.25), ia.interp_axpy_torch(a, b, 0.25))
        check(u_mis <= 1, f"interp_axpy misaligned {dt}: {u_mis} ulp from its plain version")
        log(f"[kernels] interp_axpy n={sizes} {str(dt)[6:]}: max {max(ulps)} ulp; "
            f"misaligned n={a.numel()}: max {u_mis} ulp")


# ---------------------------------------------------------------------------
# phases 3-4: the serving path


def _requests(lengths, max_new, vocab, shared=()):
    """Requests with random prompts; ``shared`` lists (first, second) index
    pairs whose prompts share a 256-token prefix."""
    from repro_torch.launch.serve import Request

    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, vocab, size=n) for n in lengths]
    for a, b in shared:
        prompts[b][:256] = prompts[a][:256]
    return [Request(rid=i, prompt=p, max_new=max_new) for i, p in enumerate(prompts)]


def _wrappers():
    """Kernel name -> its CUDA wrapper (each counts its own launches)."""
    from repro_torch.kernels import coalesce_pair as cp
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import interp_axpy as ia
    from repro_torch.kernels import paged_attention as pa

    return {"flash_attention_fwd": fa.flash_attention_cuda,
            "flash_attention_bwd_dq": fa.flash_attention_bwd_dq_cuda,
            "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv_cuda,
            "coalesce_pair": cp.coalesce_pair_cuda,
            "interp_axpy": ia.interp_axpy_cuda,
            "paged_attention_decode": pa.paged_attention_decode_cuda}


def _reset_counters():
    for w in _wrappers().values():
        w.launches = 0


def _launches():
    return {k: w.launches for k, w in _wrappers().items()}


@contextlib.contextmanager
def _uncounted():
    """Launches inside (comparisons with a plain version) are not counted."""
    saved = _launches()
    try:
        yield
    finally:
        for k, w in _wrappers().items():
            w.launches = saved[k]


def _counters():
    """(flash forward, paged decode) launches: the serving phases' pair."""
    c = _launches()
    return c["flash_attention_fwd"], c["paged_attention_decode"]


def f32_phase(dev, cfg, lengths, backends=("cuda", "torch"), shared=(), tag="f32") -> None:
    """The same requests through ``make_server`` on two kernel backends;
    returns the first backend's streams, which must equal the second's.
    ``shared`` pairs share a 256-token prefix (the second runs the padded
    extend step)."""
    from repro_torch.launch.serve import make_server

    streams = {}
    for backend in backends:
        srv = make_server(cfg.replace(kernel_backend=backend), batch=4, max_seq=1024,
                          device=dev)
        _reset_counters()
        done = srv.run(_requests(lengths, 8, cfg.vocab_size, shared))
        counts = _counters()
        streams[backend] = {r.rid: r.out for r in done}
        log(f"[{tag}] backend={backend}: {len(done)} requests, launches "
            f"(flash, paged)={counts}, stats={srv.stats()}")
        check(len(done) == len(lengths) and not srv.rejected, "f32 run lost requests")
        check(srv.prefill_tokens_saved == 256 * len(shared),
              f"prefix reuse saved {srv.prefill_tokens_saved} tokens")
        if backend == "cuda":
            check(min(counts) > 0, f"f32 run did not reach both kernels: {counts}")
        del srv
    check(streams[backends[0]] == streams[backends[1]],
          f"token streams differ between backends: {streams}")
    log(f"[{tag}] streams identical across {backends}: {streams[backends[0]]}")
    return streams[backends[0]]


def engines_f32_phase(dev, cfg, lengths, greedy) -> None:
    """Phase 3's other engine and policy on the same requests (f32, the
    kernels): the slots engine and the speculative policy (draft_k 4,
    the level-1 draft) give ``greedy``, the paged greedy streams; then on
    width-consistent weights (a width-only de-coalescing of a level-1 init,
    as ``tests/test_serve.py`` builds them) a width-only draft gives the
    greedy streams of those weights with an accept rate above 0.9."""
    from repro_torch.config import MultiLevelConfig
    from repro_torch.core import operators as ops
    from repro_torch.launch.serve import SpeculativePolicy, make_server
    from repro_torch.models.api import build_model

    kw = dict(batch=4, max_seq=1024, device=dev)

    def serve(srv, params=None):
        if params is not None:
            srv.set_params(params)
        done = srv.run(_requests(lengths, 8, cfg.vocab_size))
        check(len(done) == len(lengths) and not srv.rejected, "f32 run lost requests")
        return {r.rid: r.out for r in done}, srv.stats()

    slots, _ = serve(make_server(cfg, engine="slots", **kw))
    check(slots == greedy, f"slots streams {slots} differ from paged greedy {greedy}")
    spec, st = serve(make_server(cfg, policy="speculative", draft_k=4, **kw))
    log(f"[f32] slots engine equals paged greedy; speculative (draft_k 4, level-1 draft) "
        f"stats {st}")
    check(spec == greedy, f"speculative streams {spec} differ from greedy {greedy}")
    ml = MultiLevelConfig()
    small = build_model(ops.coalesce_config(cfg, ml, width=True, depth=False))
    consistent = ops.make_decoalesce_fn(build_model(cfg).specs(), cfg, ml, width=True,
                                        depth=False)(
        small.init(torch.Generator(device=dev).manual_seed(SEED + 3)))
    want, _ = serve(make_server(cfg, **kw), consistent)
    pol = SpeculativePolicy(k=4, ml=ml, draft_width=True, draft_depth=False)
    got, st = serve(make_server(cfg, policy=pol, **kw), consistent)
    log(f"[f32] width-consistent weights, width-only draft: stats {st}")
    check(got == want, f"speculative streams {got} differ from greedy {want} on "
                       f"width-consistent weights")
    check(st["accept_rate"] > 0.9, f"accept rate {st['accept_rate']} <= 0.9 on "
                                   f"width-consistent weights")


def bf16_phase(dev, cfg, lengths, shared, max_new=32, max_seq=2048, tag="bf16",
               first_tick=None):
    """Serve the traffic; returns the recorded decode inputs, the counts and
    the token streams.  Prints tokens/s, the host wall per decode tick (the
    step and its argmax read), peak memory and, for MoE models, the
    routings dropped for capacity per step kind (cold prefill, the padded
    extend step, decode).  The first decode tick's logits, tokens and
    positions go into ``first_tick`` when a dict is given."""
    from repro_torch.launch.serve import make_server
    from repro_torch.layers.ffn import count_dropped

    srv = make_server(cfg, batch=8, max_seq=max_seq, page_size=16, device=dev)
    reqs = _requests(lengths, max_new, cfg.vocab_size, shared)
    finite = torch.ones((), dtype=torch.bool, device=dev)
    decode_inputs, tick_s = [], []
    prefill, paged_step, decode_once = srv.prefill, srv.paged_step, srv.decode_once
    tally = None

    def prefill_checked(params, tokens):
        nonlocal finite
        tally.kind = "prefill"
        logits, caches = prefill(params, tokens)
        finite = finite & torch.isfinite(logits).all()
        return logits, caches

    def paged_checked(params, pages, tokens, positions, tables):
        nonlocal finite
        tally.kind = "decode" if tokens.shape[1] == 1 else "extend"
        logits, pages = paged_step(params, pages, tokens, positions, tables)
        finite = finite & torch.isfinite(logits).all()
        if tokens.shape[1] == 1:
            decode_inputs.append((tables.cpu(), (positions[:, 0] + 1).cpu()))
            if first_tick is not None and not first_tick:
                first_tick.update(_tick_record(logits, tokens, positions))
        return logits, pages

    def decode_timed():
        t = time.time()
        out = decode_once()
        tick_s.append(time.time() - t)
        return out

    srv.prefill, srv.paged_step, srv.decode_once = prefill_checked, paged_checked, decode_timed
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize(dev)
    _reset_counters()
    with count_dropped() as tally:
        t0 = time.time()
        done = srv.run(reqs)
        torch.cuda.synchronize(dev)
        wall = time.time() - t0
    counts = _counters()
    tokens = sum(len(r.out) for r in done)
    warm = {b for _, b in shared}
    cold_long = sum(1 for i, n in enumerate(lengths)
                    if i not in warm and n > max(128, cfg.attn_block_k))
    n_layers = cfg.n_layers
    dropped = ({k: f"{d} of {r} ({d / max(r, 1):.2%})" for k, (d, r) in tally.counts().items()}
               if cfg.n_experts else "no MoE layer")
    log(f"[{tag}] {cfg.name} {n_layers}L: {len(done)} requests, {tokens} tokens in "
        f"{wall:.3f}s wall ({tokens / wall:.1f} tok/s), decode ticks={len(decode_inputs)}, "
        f"host wall per tick mean {np.mean(tick_s) * 1e3:.2f} ms (p50 "
        f"{np.median(tick_s) * 1e3:.2f}, max {np.max(tick_s) * 1e3:.2f}), "
        f"launches (flash, paged)={counts}, max_memory_allocated="
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB, routings dropped for "
        f"capacity by step kind {dropped}, stats={srv.stats()}")
    check(len(done) == len(lengths) and not srv.rejected, "bf16 run lost requests")
    check(all(len(r.out) == max_new for r in done), "a request stopped early")
    check(bool(finite.item()), "non-finite logits in the bf16 run")
    check(srv.prefill_tokens_saved == 256 * len(shared),
          f"prefix reuse saved {srv.prefill_tokens_saved} tokens, "
          f"expected {256 * len(shared)}")
    check(counts[0] == n_layers * cold_long,
          f"flash launches {counts[0]} != {n_layers} x {cold_long} cold long prompts")
    # MLA decodes absorbed, in the latent space: no paged-decode kernel on its path
    paged_layers = 0 if cfg.attn_type == "mla" else n_layers
    check(counts[1] == paged_layers * len(decode_inputs),
          f"paged launches {counts[1]} != {paged_layers} x {len(decode_inputs)} ticks")
    return decode_inputs, counts, {r.rid: r.out for r in done}


def _tick_record(logits, tokens, positions) -> dict:
    return {"logits": logits.float().cpu(), "tokens": tokens.cpu(), "positions": positions.cpu()}


def _tick_gap(got, want) -> tuple:
    """Two decode ticks' logits, over the rows whose token and position
    agree: (max abs difference over max(1, max |logit|), rows compared)."""
    rows = ((got["tokens"] == want["tokens"]) & (got["positions"] == want["positions"])).all(-1)
    if not rows.any():
        return float("inf"), 0
    g, w = got["logits"][rows], want["logits"][rows]
    return ((g - w).abs().max() / max(1.0, w.abs().max().item())).item(), int(rows.sum())


def speculative_phase(dev, cfg, lengths, shared, greedy, max_new=32, max_seq=2048, k=4):
    """Phase 4's traffic through the speculative policy.  The counters are
    zeroed before the server is built, so its first draft projection
    counts.  Returns the draft's recorded decode inputs and the launches."""
    from repro_torch.config import MultiLevelConfig
    from repro_torch.core import operators as ops
    from repro_torch.core.plans import build_plan
    from repro_torch.launch.serve import make_server
    from repro_torch.param import flatten

    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    _reset_counters()
    srv = make_server(cfg, batch=8, max_seq=max_seq, page_size=16, policy="speculative",
                      draft_k=k, device=dev)
    pol = srv.policy
    finite = {"draft": torch.ones((), dtype=torch.bool, device=dev),
              "verify": torch.ones((), dtype=torch.bool, device=dev)}
    seen = {"draft_steps": 0, "verify_s1": 0, "verify": 0, "main_s1": 0}
    draft_inputs = []
    draft_step, verify, paged_step = pol.draft_step, pol.verify, srv.paged_step

    def draft_checked(params, pages, tokens, positions, tables):
        logits, pages = draft_step(params, pages, tokens, positions, tables)
        finite["draft"] &= torch.isfinite(logits).all()
        seen["draft_steps"] += 1
        draft_inputs.append((tables.cpu(), (positions[:, 0] + 1).cpu()))
        return logits, pages

    def verify_checked(params, pages, tokens, positions, tables):
        logits, pages = verify(params, pages, tokens, positions, tables)
        finite["verify"] &= torch.isfinite(logits).all()
        seen["verify"] += 1
        seen["verify_s1"] += tokens.shape[1] == 1
        return logits, pages

    def paged_counted(params, pages, tokens, positions, tables):
        seen["main_s1"] += tokens.shape[1] == 1
        return paged_step(params, pages, tokens, positions, tables)

    pol.draft_step, pol.verify, srv.paged_step = draft_checked, verify_checked, paged_counted
    t0 = time.time()
    done = srv.run(_requests(lengths, max_new, cfg.vocab_size, shared))
    torch.cuda.synchronize(dev)
    wall = time.time() - t0
    counts = _launches()
    peak = torch.cuda.max_memory_allocated(dev)
    st = srv.stats()
    # the projection held to the torch backend's, leaf for leaf, and timed once
    with _uncounted():
        _, plain = ops.make_draft_projection(srv.model.specs(),
                                             cfg.replace(kernel_backend="torch"))
        want = flatten(plain(srv.params))
        torch.cuda.synchronize(dev)
        t1 = time.time()
        got = flatten(pol._project(srv.params))
        torch.cuda.synchronize(dev)
        project_s = time.time() - t1
    check(got.keys() == want.keys() and all(torch.equal(got[n], v) for n, v in want.items()),
          "the draft projection differs from the torch backend's")
    streams = {r.rid: r.out for r in done}
    agree = sorted(r for r in streams if streams[r] == greedy[r])
    diverge = {r: next(i for i, (a, b) in enumerate(zip(streams[r], greedy[r])) if a != b)
               for r in streams if r not in agree}
    # Each divergence must be a near-tie of the full model: a fresh prefill of
    # the shared context puts both tokens within twice the bf16 path bound
    # (2e-2 of max(1, max |logit|)) of its top logit.  A verify step or an
    # acceptance that committed a wrong token fails here.
    prompts = {q.rid: q.prompt for q in _requests(lengths, max_new, cfg.vocab_size, shared)}
    ties = {}
    with _uncounted():
        for r, i in diverge.items():
            context = np.concatenate([prompts[r], np.asarray(greedy[r][:i], prompts[r].dtype)])
            lg = srv.prefill(srv.params, srv._tensor(context)[None])[0][0].float()
            top, tol = lg.max(), 2 * TOL[torch.bfloat16] * max(1.0, lg.abs().max().item())
            ties[r] = {"greedy_gap": (top - lg[greedy[r][i]]).item(),
                       "spec_gap": (top - lg[streams[r][i]]).item(), "tol": tol,
                       "median_gap": (top - lg.median()).item()}
    tokens = sum(len(o) for o in streams.values())
    dcfg = pol.draft_cfg
    long = lambda n, c: n > max(128, c.attn_block_k)
    warm = {b for _, b in shared}
    cold_long = sum(1 for i, n in enumerate(lengths) if i not in warm and long(n, cfg))
    all_long = sum(1 for n in lengths if long(n, dcfg))
    pairs = width_pairs(srv.model.specs(), build_plan(cfg, MultiLevelConfig()))
    want_counts = {k_: 0 for k_ in _wrappers()}
    want_counts.update(
        flash_attention_fwd=cfg.n_layers * cold_long + dcfg.n_layers * all_long,
        paged_attention_decode=(dcfg.n_layers * seen["draft_steps"]
                                + cfg.n_layers * (seen["verify_s1"] + seen["main_s1"])),
        coalesce_pair=pairs)
    log(f"[spec] draft {dcfg.n_layers}L d_model {dcfg.d_model} H {dcfg.n_heads} KH "
        f"{dcfg.n_kv_heads} D {dcfg.resolved_head_dim}; {len(done)} requests, {tokens} "
        f"tokens in {wall:.3f}s wall ({tokens / wall:.1f} tok/s); rounds {st['spec_rounds']}, "
        f"accept rate {st['accept_rate']:.4f} ({st['accepted_tokens']} of "
        f"{st['drafted_tokens']} drafted), draft {st['draft_time_s']} s over "
        f"{seen['draft_steps']} draft steps, verify {st['verify_time_s']} s over "
        f"{seen['verify']} verify steps ({seen['verify_s1']} at S_b 1); projection "
        f"{project_s:.3f}s; max_memory_allocated {peak / 2**30:.2f} GiB; stats {st}")
    log(f"[spec] streams equal to phase 4's in full: {len(agree)} of {len(streams)} "
        f"({agree}); first divergence (rid: token index) {diverge}; top-logit gaps there "
        f"{ties}; launches {counts}, expected {want_counts}")
    check(len(done) == len(lengths) and not srv.rejected
          and all(len(r.out) == max_new for r in done), "the speculative run lost requests")
    check(bool(finite["draft"].item()) and bool(finite["verify"].item()),
          f"non-finite logits: draft {finite['draft'].item()}, verify "
          f"{finite['verify'].item()}")
    check(all(streams[r][0] == greedy[r][0] for r in streams),
          "a first token differs from phase 4's")
    check(all(t["greedy_gap"] <= t["tol"] and t["spec_gap"] <= t["tol"] for t in ties.values()),
          f"a stream leaves phase 4's at no near-tie of the full model: {ties}")
    check(counts == want_counts, f"speculative launches {counts} != structure {want_counts}")
    return draft_inputs, counts


# ---------------------------------------------------------------------------
# phases 6-10: the training paths


def _paper(name, n_layers=None, **kw):
    """One of the paper's configs, as published or cut to ``n_layers``."""
    from repro_torch.config import uniform_stages
    from repro_torch.configs import get_config

    cfg = get_config(name)
    if n_layers is not None:
        cfg = cfg.replace(stages=uniform_stages(n_layers, cfg.stages[0].pattern[0]))
    return cfg.replace(**kw)


def train_setup(name):
    """(config, MultiLevelConfig, TrainConfig) with which phases 7-10 train
    ``name``; ``scripts/profile_torch_train.py`` profiles the same setups.
    The paper's schedules: Tables 2-3 (GPT-Base at 10 steps, 1 + 5 + 10;
    DeiT-B), Table 4's three
    levels (BERT-Large, at 24 steps: 1 + 1 + 8 + 8 + 24), Table 1
    (BERT-Base, the baselines).  Phase 7's
    rate, except DeiT-B's: its recipe scales 5e-4 by batch / 512, 6.25e-5
    at 64 (at 6e-4 DeiT-B's loss rises over its first 40 steps).  Phi-3.5-MoE
    (phase 16): 2 layers at full width with ``coalesce_experts``, Table 2's
    ratio, 1 + 5 + 10 steps at batch 4 (its weights, gradients and AdamW
    state take 46 GB).  xLSTM-125m (phase 19): as configured, Table 2's
    ratio, batch 8, its sequence and steps cut to ``XLSTM_TRAIN`` (a train
    step issues 117-153 small kernels per time step and layer, and past ~64
    tokens the gradient norm overflows f32 at init).  DeepSeek-V3 (phase
    22): the training cut of ``deepseek_cut`` (3.47 G parameters, 55.6 GB
    of f32 weights, gradients and AdamW moments), Table 2's ratio, 1 + 3 +
    6 steps at batch 2, then 6 from scratch.  The same schedule for
    Jamba-1.5-Large's training cut (``jamba_cut(2)``, phase 25) at 1 x 1024
    and a peak rate of 1e-4 (GPT-3's rates fall with width, 1.2e-4 at d
    4096 and 0.6e-4 at d 12288; at 6e-4, on an H100, the cut's
    from-scratch loss rose from 11.62 to 11.74 over its 10 steps),
    Whisper-large-v3 at full width, 8 encoder and 8 decoder layers of its 32
    and 32 (phase 28), at 4 x 448 (its text context).
    Llama-3.2-Vision-11B's cut (``vlm_cut``, phase 31) at 2 x 1024 takes
    Table 2's ratio at 10 steps (1 + 5 + 10, then 10 from scratch)."""
    from repro_torch.config import MultiLevelConfig, TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.models.vit import n_patches

    # Phi-3.5-MoE at full width, 2 of its 32 layers, its experts merged in pairs
    if name == PHI:
        cfg = _paper(name, 2, coalesce_experts=True)
    elif name == XLSTM:  # as configured: 12 layers, bf16 over f32, remat "full"
        cfg = get_config(XLSTM)
    elif name == DEEPSEEK:  # full width: one MoE layer of 16 experts and the MTP head
        cfg = deepseek_cut(0, 1, 16)
    elif name == JAMBA:  # full width: blocks b2-b3 with 2 experts
        cfg = jamba_cut(2)
    elif name == WHISPER:  # full width, 8 of its 32 encoder and 32 decoder layers
        cfg = whisper_cut(8)
    elif name == VLM:  # full width: image and self-attention layers, twice
        cfg = vlm_cut()
    else:
        cfg = _paper(name)
    table2 = MultiLevelConfig(n_levels=2, alpha=0.25, e_a_frac=0.05, e_small_frac=0.5)
    # Table 2's ratio at 10 steps: 1 + 5 + 10 (at 6: 1 + 3 + 6)
    table2_10 = dataclasses.replace(table2, e_a_frac=0.1)
    ml, kw = {
        "gpt-base": (table2_10, {"steps": 10}),
        "bert-large": (MultiLevelConfig(n_levels=3, alpha=0.5, e_a_frac=0.05,
                                        e_small_frac=0.35), {"steps": 24, "seq_len": 512}),
        "deit-b": (table2, {"batch_size": 64, "seq_len": n_patches(cfg) + 1,
                            "peak_lr": 6.25e-5}),
        "bert-base": (MultiLevelConfig(n_levels=2, alpha=0.5, e_a_frac=0.05,
                                       e_small_frac=0.5), {"steps": 8, "seq_len": 512}),
        PHI: (table2_10, {"steps": 10, "batch_size": 4}),
        XLSTM: (table2, XLSTM_TRAIN),
        DEEPSEEK: (table2_10, {"steps": 6, "batch_size": 2}),
        JAMBA: (table2_10, {"steps": 6, "batch_size": 1, "peak_lr": 1e-4}),
        WHISPER: (table2_10, {"steps": 6, "batch_size": 4, "seq_len": 448}),
        VLM: (table2_10, {"steps": 10, "batch_size": 2}),
    }[name]
    tc = TrainConfig(steps=40, warmup_steps=2, peak_lr=6e-4, batch_size=8, seq_len=1024,
                     log_every=1)
    return cfg, ml, dataclasses.replace(tc, **kw)


def train_f32_phase(dev, cfg, tc, tag="train-f32") -> dict:
    """One train step (GPT-Base, BERT-Large, Phi-3.5-MoE, DeepSeek-V3,
    Jamba-1.5-Large, Whisper-large-v3 or Llama-3.2-Vision-11B at full width
    and cut depth, f32, in ``main``) on both backends from the same weights
    (the image layers' gates opened to 0.5) and the family's batch
    (``make_batch_fn``'s, with seeded normal image embeddings or encoder
    frames in place of the stub's ones): first the loss (and ``moe_aux``) and
    every gradient of both backends from the same leaves, then one train
    step a backend, each from the seeded init drawn anew, the ``cuda``
    step's updated tree held on the host meanwhile (Phi-3.5-MoE's f32 train
    state fills most of the card).  Tolerances: loss and ``moe_aux`` within
    1e-4; each gradient leaf within 1e-5 + 1e-3 of its largest value (f32,
    other summation orders in attention); updated parameters within 1e-5,
    with Adam's eps at 1e-4 (at 1e-8 the first step moves a weight whose
    gradient is zero up to rounding by up to lr either way).  Then a
    width-only de-coalesce and coalesce of the real tree, through the
    kernels, must give it back bit for bit, and the coalescing must equal the
    ``torch`` backend's.  Returns the ``cuda`` backend's launches."""
    from repro_torch.config import MultiLevelConfig
    from repro_torch.core import operators as ops
    from repro_torch.launch.train import make_batch_fn
    from repro_torch.models.api import build_model, make_train_step
    from repro_torch.optim import adamw_init
    from repro_torch.param import flatten, unflatten

    check(tc.seed == SEED, "the batch is drawn from tc.seed")
    batch = make_batch_fn(cfg, tc, device=dev)(0)
    # the stub frontends' ones make every cross-attention row uniform, so an
    # image layer's dq is rounding noise, which the first AdamW step (eps
    # 1e-4) magnifies by up to lr / eps: seeded normal values stand in
    batch.update(_normal_stub_inputs(cfg, tc.batch_size, dev, SEED + 10))
    peaks = {}

    def fresh():  # the seeded init, image layers' gates opened (``_open_gates``)
        tree = build_model(cfg).init(torch.Generator(device=dev).manual_seed(SEED))
        _open_gates(tree)
        return tree


    def peak(part):  # the peak since the last part, then a fresh count
        torch.cuda.synchronize(dev)
        peaks[part] = f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f}"
        torch.cuda.reset_peak_memory_stats(dev)

    peak("before")
    init = flatten(fresh())
    leaves = [v.requires_grad_() for v in init.values()]

    def loss_and_grads(backend):
        # the graph's leaf nodes hold the weights: it must not outlive this call
        loss, metrics = build_model(cfg.replace(kernel_backend=backend)).loss(
            unflatten(dict(zip(init, leaves))), batch)
        return ({k: v.item() for k, v in metrics.items()},
                torch.autograd.grad(loss, leaves, materialize_grads=True))

    res, n = {}, {}
    for backend in ("cuda", "torch"):
        _reset_counters()
        res[backend] = loss_and_grads(backend)
        n[backend] = _launches()
        peak(f"{backend} gradients")
    (m_c, g_c), (m_t, g_t) = res["cuda"], res["torch"]
    g_err = max(((a - b).abs().max() / (1e-5 + 1e-3 * b.abs().max())).item()
                for a, b in zip(g_c, g_t))
    router_g = [g.abs().max().item() for k, g in zip(init, g_t) if k.endswith("ffn/router")]
    n_leaves = len(g_t)
    del res, g_c, g_t, leaves, init
    for backend in ("cuda", "torch"):
        tree = fresh()
        _reset_counters()
        tree, _, _ = make_train_step(build_model(cfg.replace(kernel_backend=backend)), tc)(
            tree, adamw_init(tree, tc), batch)
        torch.cuda.synchronize(dev)
        n[backend] = {k: v + _launches()[k] for k, v in n[backend].items()}
        if backend == "cuda":
            kept = {k: v.cpu() for k, v in flatten(tree).items()}
            del tree
        peak(f"{backend} step")
    p_err = max((kept[k].to(dev) - v).abs().max().item() for k, v in flatten(tree).items())
    del kept
    passes = 2  # loss + gradients, then the train step
    want = _step_launches(cfg, tc, passes)
    check(all(want.values()), f"{cfg.name} at seq {tc.seq_len} takes no flash route")
    causal = cfg.stages[0].pattern[0].mixer != "enc_attn"
    moe = (f"; router gradient max {max(router_g):.3e}" if cfg.n_experts else "")
    log(f"[{tag}] {cfg.name} {cfg.n_layers}L{' + MTP' if cfg.mtp_depth else ''} "
        f"causal={causal} seq {tc.seq_len} batch {tc.batch_size}: metrics cuda {m_c} torch "
        f"{m_t}{moe}; gradient error / its tolerance {g_err:.3f} over {n_leaves} leaves; "
        f"max |param diff| after the step {p_err:.3e}; launches cuda {n['cuda']}, torch "
        f"{n['torch']}; peak max_memory_allocated GiB by part {peaks}")
    # the loss and each of its parts: ce, and mtp_ce and moe_aux where the model has them
    check(m_c.keys() == m_t.keys() and all(abs(m_c[k] - m_t[k]) <= 1e-4 for k in m_c),
          f"losses differ: {m_c} vs {m_t}")
    check(g_err <= 1.0, f"gradients differ between backends ({g_err} x tolerance)")
    check(not cfg.n_experts or min(router_g) > 0, "no gradient reached a router")
    check(p_err <= 1e-5, f"updated parameters differ: {p_err}")
    check(all(n["cuda"][k] == v for k, v in want.items()),
          f"cuda backend launches {n['cuda']}, expected {want}")
    check(not any(n["torch"].values()), f"torch backend launched kernels: {n['torch']}")
    # C(D(w)) == w for a width-only transition, on the real tree
    ml = MultiLevelConfig()
    specs = build_model(cfg).specs()
    small = ops.make_coalesce_fn(specs, cfg, ml, width=True, depth=False)(tree)
    back = ops.make_coalesce_fn(specs, cfg, ml, width=True, depth=False)(
        ops.make_decoalesce_fn(specs, cfg, ml, width=True, depth=False)(small))
    plain = ops.make_coalesce_fn(specs, cfg.replace(kernel_backend="torch"), ml,
                                 width=True, depth=False)(tree)
    fs, fb, fp = flatten(small), flatten(back), flatten(plain)
    check(all(torch.equal(fp[k], v) for k, v in fs.items()),
          "width coalesce differs from the torch backend's")
    check(all(torch.equal(fb[k], v) for k, v in fs.items()),
          "width de-coalesce then coalesce did not give the tree back bit for bit")
    log(f"[{tag}] width-only C(w) equal to the torch backend's and C(D(w)) == w, bit for "
        f"bit over {len(fs)} leaves")
    return n["cuda"]


def width_pairs(specs, plan) -> int:
    """(leaf, width axis) pairs a "stack" coalescing runs through
    coalesce_pair: every dim whose logical axis the plan halves, with role
    "in" or "out" after the plan's role overrides.  The MTP head's
    ``embed_cat2`` axis (two copies of embed side by side) has block-diagonal
    maps, which contract as dense matrices outside any kernel, as in the
    reference."""
    from repro_torch.param import flatten

    maps = plan.build_maps()
    n = 0
    for spec in flatten(specs).values():
        for ax, role in zip(spec.axes, spec.roles):
            role = plan.role_overrides.get(ax, role) if ax in maps.width else role
            if ax in maps.width and role in ("in", "out"):
                if ax == "embed_cat2":
                    check(maps.width[ax].variant is None, "embed_cat2 is not block-diagonal")
                    continue
                check(maps.width[ax].variant == "stack", f"axis {ax} is not a pair merge")
                n += 1
    return n


def _takes_flash(cfg, S, T) -> bool:
    """``run_attention``'s thresholds: S queries over T keys reach the flash
    kernels (decode never does)."""
    from repro_torch.layers.attention import FLASH_IMPLS

    return S > 128 and T > cfg.attn_block_k and cfg.attn_impl in FLASH_IMPLS


def _flash_layers(cfg, S, train=True) -> int:
    """Attention calls of one forward of ``cfg`` over S tokens that reach the
    flash kernels: each layer's self-attention (``attn``, ``enc_attn``,
    ``dec_attn``: T = S), each cross-attention (``dec_attn``, ``cross_attn``:
    T = the image tokens or the encoder's frames), each encoder layer (S =
    T = ``encoder_seq``), and in training the MTP head's block.  A recurrent
    layer never reaches them."""
    n_src = cfg.n_image_tokens or cfg.encoder_seq
    n = 0
    for st in cfg.stages:
        for b in st.pattern:
            n += st.repeats * ((b.mixer in ("attn", "enc_attn", "dec_attn")
                                and _takes_flash(cfg, S, S))
                               + (b.mixer in ("cross_attn", "dec_attn")
                                  and _takes_flash(cfg, S, n_src)))
    if cfg.n_encoder_layers and _takes_flash(cfg, cfg.encoder_seq, cfg.encoder_seq):
        n += cfg.n_encoder_layers
    return n + (_mtp_blocks(cfg, S) if train else 0)


def _mtp_blocks(cfg, S) -> int:
    """The MTP head's attention block on the flash route: one, in training."""
    return int(bool(cfg.mtp_depth) and _takes_flash(cfg, S, S))


def _step_launches(cfg, tc, steps: int) -> dict:
    """Flash launches of ``steps`` train steps (remat "full" and "dots" run a
    stacked layer's forward twice, the encoder's too: "dots" saves matrix
    products, not the flash kernel's output; the MTP block is not under
    remat, as in the reference)."""
    n = steps * _flash_layers(cfg, tc.seq_len)
    mtp = steps * _mtp_blocks(cfg, tc.seq_len)
    twice = cfg.remat in ("full", "dots")
    return {"flash_attention_fwd": (n - mtp) * (2 if twice else 1) + mtp,
            "flash_attention_bwd_dq": n, "flash_attention_bwd_dkv": n}


def _adamw_replay(cfg, tc, before, moments, count, batch, metrics, after) -> tuple:
    """One train step replayed from its starting weights (``before``) and
    AdamW moments (``moments``, ``count``): the loss and gradients of the
    same model on the ``torch`` backend, then AdamW written out here in f64
    (global-norm clipping, the moments, their bias corrections, decoupled
    decay of the leaves of 2 or more dims) at the step's own learning rate.
    Returns (the loss's error, the largest error of the updated parameters)
    against the step's ``metrics`` and updated parameters ``after``."""
    from repro_torch.models.api import build_model
    from repro_torch.param import unflatten

    names = list(before)
    leaves = [before[k].clone().requires_grad_() for k in names]
    loss, _ = build_model(cfg.replace(kernel_backend="torch")).loss(
        unflatten(dict(zip(names, leaves))), batch, z_loss=tc.z_loss)
    gs = torch.autograd.grad(loss, leaves, materialize_grads=True)
    l_err = abs(loss.item() - metrics["loss"].item())
    t, lr, p_err = count + 1, metrics["lr"], 0.0
    with torch.no_grad():
        gn = torch.sqrt(sum(g.double().square().sum() for g in gs))
        scale = torch.clamp(tc.grad_clip / gn.clamp_min(1e-9), max=1.0)
        for k, p, g in zip(names, leaves, gs):
            g = g.double() * scale
            m = tc.b1 * moments["m"][k].double() + (1 - tc.b1) * g
            v = tc.b2 * moments["v"][k].double() + (1 - tc.b2) * g.square()
            upd = (m / (1 - tc.b1 ** t)) / ((v / (1 - tc.b2 ** t)).sqrt() + tc.eps)
            if p.ndim >= 2:
                upd = upd + tc.weight_decay * p.double()
            p_err = max(p_err, (p.double() - lr * upd - after[k].double()).abs().max().item())
    return l_err, p_err


def _schedule_launches(runner, tc) -> dict:
    """Every kernel's launches in a V-cycle run of ``runner``'s schedule: the
    flash kernels of each segment's steps, coalesce_pair per "stack" width
    pair at each coalescing, interp_axpy per leaf at each interpolation."""
    from repro_torch.param import flatten

    want = {k: 0 for k in _wrappers()}
    for s in runner.plan:
        for k, n in _step_launches(runner.cfgs[s.level], tc, s.steps).items():
            want[k] += n
        if s.phase == "down":
            want["coalesce_pair"] += width_pairs(runner.specs[s.level],
                                                 runner.proj_plans[s.level])
        elif s.phase == "up":
            want["interp_axpy"] += len(flatten(runner.specs[s.level - 1]))
    return want


def vcycle_phase(dev, tag, cfg, ml, tc, keep_output=True, learns=True, batch_fn=None):
    """The paper's V-cycle through ``VCycleRunner``, then training from
    scratch on the same batches (``make_batch_fn``: the family's own).
    Every transition is replayed from the same trees on the ``torch``
    backend: each coalesced leaf must equal it exactly and each interpolated
    leaf within 1 ulp (``elementwise_checks``' tolerances), so the kernels
    are held to their plain versions at every leaf shape the path gives
    them.  Each transition's wall and peak memory are printed (the replay
    is outside both), and for MoE models ``moe_aux`` per level.  The batches
    are ``make_batch_fn``'s unless ``batch_fn`` is given.  Returns the
    launches of each of the two runs and the V-cycle's output (phase 11's
    uninterrupted run), or None with ``keep_output=False``: its parameters
    are then freed before training from scratch.

    With ``learns=False`` (xLSTM-125m, phase 19) the last loss of each run
    is printed beside its first but not required below it: at the batch
    and sequence the phase can afford, 8 x 32 tokens a step, neither that
    model nor GPT-Base lowers its loss on ``MarkovLM`` over 20-40 steps
    (PERF.md §6).  What an update must do is held instead: every step's
    gradient norm is finite and every step moves the parameters (the norm
    of the change is finite and above 0), and the first step of each level
    is replayed from its starting weights and moments (``_adamw_replay``):
    the loss within 1e-4 and every updated parameter within 1e-5, phase 6's
    tolerances."""
    from repro_torch.core import flops as flops_lib
    from repro_torch.core import operators as ops
    from repro_torch.core import vcycle as vc
    from repro_torch.launch.train import make_batch_fn
    from repro_torch.param import flatten

    held = {"coalesce_pair": 0, "interp_axpy": 0, "ulps": 0, "s": 0.0, "peak": 0,
            "transitions": [], "replay_peak": 0}
    aux = {}  # level -> the moe_aux of each step (MoE models)
    gnorms = []  # every step's gradient norm (device scalars)
    moves = []  # learns=False: every step's parameter change norm (device scalars)
    replays = {}  # learns=False: level -> (loss error, parameter error) of its first step

    def new_peak():
        """The peak since the last call, then a fresh count."""
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        return peak

    class HeldRunner(vc.VCycleRunner):
        def step_fn(self, level):
            fn = super().step_fn(level)

            def step(params, opt_state, batch):
                if learns:
                    params, opt_state, metrics = fn(params, opt_state, batch)
                else:
                    before = {k: v.detach().clone() for k, v in flatten(params).items()}
                    replay = level not in replays
                    if replay:
                        start = ({k: {n: v.clone() for n, v in flatten(opt_state[k]).items()}
                                  for k in ("m", "v")}, opt_state["count"])
                    params, opt_state, metrics = fn(params, opt_state, batch)
                    after = flatten(params)
                    with torch.no_grad():
                        moves.append(torch.sqrt(sum((after[k] - v).float().square().sum()
                                                    for k, v in before.items())))
                    if replay:
                        with _uncounted():
                            replays[level] = _adamw_replay(self.cfgs[level], tc, before,
                                                           *start, batch, metrics, after)
                    del before
                gnorms.append(metrics["grad_norm"])
                if "moe_aux" in metrics:
                    aux.setdefault(level, []).append(metrics["moe_aux"])
                return params, opt_state, metrics

            return step

        def _transition(self, state, seg, params):
            if seg.phase == "final":
                return super()._transition(state, seg, params)
            l = seg.level
            before = state.params_before.get(l - 1)  # popped by an "up"
            held["peak"] = max(held["peak"], new_peak())
            t = time.time()
            out = super()._transition(state, seg, params)
            torch.cuda.synchronize(dev)
            held["transitions"].append((seg.phase, l, time.time() - t, new_peak()))
            t = time.time()
            with _uncounted():
                if seg.phase == "down":
                    want = ops.make_coalesce_fn(
                        self.specs[l], self.cfgs[l].replace(kernel_backend="torch"),
                        self.ml, plan=self.proj_plans[l])(params)
                    got, want = flatten(out), flatten(want)
                    check(all(torch.equal(got[k], v) for k, v in want.items()),
                          f"level {l} coalescing differs from the torch backend's")
                    held["coalesce_pair"] += len(want)
                elif seg.phase == "up":
                    plain = self.cfgs[l - 1].replace(kernel_backend="torch")
                    de = flatten(ops.make_decoalesce_fn(self.specs[l - 1], plain, self.ml,
                                                        plan=self.proj_plans[l - 1])(params))
                    got, before = flatten(out), flatten(before)
                    # leaf by leaf: a whole second interpolated tree would not
                    # fit beside Phi-3.5-MoE's three
                    ulps = max(_ulps(got[k], ops.interpolate(before[k], v, self.ml.alpha,
                                                             backend="torch"))
                               for k, v in de.items())
                    check(ulps <= 1, f"level {l} interpolation {ulps} ulp from the torch "
                                     f"backend's")
                    held["interp_axpy"] += len(de)
                    held["ulps"] = max(held["ulps"], ulps)
                    del de, before
            held["replay_peak"] = max(held["replay_peak"], new_peak())
            held["s"] += time.time() - t
            return out

    check(tc.seed == SEED, "the batches are drawn from tc.seed")
    batch_fn = batch_fn or make_batch_fn(cfg, tc, device=dev)
    runner = HeldRunner(cfg, ml, tc, batch_fn, seed=SEED, device=dev)
    plan, cfgs, specs = runner.plan, runner.cfgs, runner.specs
    check(len(cfgs) == ml.n_levels, f"{len(cfgs)} levels")
    for big, small in zip(cfgs, cfgs[1:]):
        check([st.repeats for st in small.stages] == [(st.repeats + 1) // 2 for st in big.stages]
              and small.n_encoder_layers == (big.n_encoder_layers + 1) // 2
              and 2 * small.d_model == big.d_model
              and 2 * small.n_heads == big.n_heads and 2 * small.d_ff == big.d_ff
              and small.resolved_head_dim == big.resolved_head_dim
              and small.n_experts == (big.n_experts // 2 if big.coalesce_experts
                                      else big.n_experts),
              f"coalesced config {small} of {big}")
    step_dt = {lv: [] for lv in range(ml.n_levels)}

    def on_step(state, params, opt_state, stopping, dt):
        step_dt[state.level].append(dt)

    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    _reset_counters()
    t0 = time.time()
    out = runner.run(on_step=on_step)
    torch.cuda.synchronize(dev)
    wall = time.time() - t0
    counts = _launches()
    peak = max(held["peak"], torch.cuda.max_memory_allocated(dev),
               *[t[3] for t in held["transitions"]])

    # what the path's structure implies
    steps = sum(s.steps for s in plan)
    want = _schedule_launches(runner, tc)
    hist = out.history
    fps = [flops_lib.train_step_flops(c, sp, tc.batch_size, tc.seq_len)
           for c, sp in zip(cfgs, specs)]
    cum, flops_want = 0.0, []
    for s in plan:
        for _ in range(s.steps):
            cum += fps[s.level]
            flops_want.append(cum)
    vit = cfg.family == "vit"
    per_step, unit = (tc.batch_size, "images/s") if vit else (tc.batch_size * tc.seq_len,
                                                               "tokens/s")
    for lv in range(ml.n_levels):
        dts = step_dt[lv][1:]  # a level's first step pays its first launches
        log(f"[{tag}] level {lv} ({cfgs[lv].n_layers}L d_model {cfgs[lv].d_model}): "
            f"{len(step_dt[lv])} steps, mean step {np.mean(dts) * 1e3:.1f} ms after the "
            f"first ({step_dt[lv][0] * 1e3:.1f} ms), {per_step / np.mean(dts):.0f} {unit}")
    log(f"[{tag}] FLOPs account: train_step_flops by level {fps}, V-cycle total "
        f"{flops_want[-1]:.4e}, from scratch {tc.steps * fps[0]:.4e}")
    log(f"[{tag}] segments {[(s.phase, s.level, s.steps) for s in plan]}; {steps} steps "
        f"in {wall:.2f}s wall ({held['s']:.2f}s of it replaying transitions on the torch "
        f"backend); losses first {hist.loss[0]:.4f} last {hist.loss[-1]:.4f}; "
        f"peak max_memory_allocated {peak / 2**30:.2f} GiB; launches {counts}; "
        f"expected {want}")
    log(f"[{tag}] transitions against the torch backend: {held['coalesce_pair']} coalesced "
        f"leaves exactly equal, {held['interp_axpy']} interpolated leaves within "
        f"{held['ulps']} ulp")
    log(f"[{tag}] transitions (phase, level, wall s, peak max_memory_allocated GiB): "
        + ", ".join(f"({p}, {l}, {w:.3f}, {m / 2**30:.2f})"
                    for p, l, w, m in held["transitions"])
        + f"; the torch-backend replay's peak {held['replay_peak'] / 2**30:.2f} GiB")
    if aux:
        log(f"[{tag}] moe_aux per level (first, mean, last): " + ", ".join(
            f"level {lv}: {a[0].item():.5f}, {torch.stack(a).mean().item():.5f}, "
            f"{a[-1].item():.5f}" for lv, a in sorted(aux.items())))
        check(all(torch.isfinite(torch.stack(a)).all().item() for a in aux.values()),
              "a non-finite moe_aux")
    check(all(np.isfinite(hist.loss)), "a non-finite loss in the V-cycle")
    gn = torch.stack(gnorms).float().cpu().numpy()
    log(f"[{tag}] gradient norm per step: min {gn.min():.4e} max {gn.max():.4e}")
    if learns:
        check(hist.loss[-1] < hist.loss[0], "the final segment's last loss is not below "
                                             "the first logged loss")
    else:
        mv = torch.stack(moves).cpu().numpy()
        log(f"[{tag}] parameter change norm per step: min {mv.min():.4e} max {mv.max():.4e}; "
            f"first step of each level replayed with AdamW written out (level: loss error, "
            f"largest parameter error): {replays}")
        check(bool(np.isfinite(gn).all()), f"a non-finite gradient norm: {gn}")
        check(len(mv) == len(gn) and bool(np.isfinite(mv).all() and (mv > 0).all()),
              f"a step that did not move the parameters: {mv}")
        check(sorted(replays) == list(range(ml.n_levels)), f"replayed levels {sorted(replays)}")
        check(all(l_err <= 1e-4 and p_err <= 1e-5 for l_err, p_err in replays.values()),
              f"a step differs from its replay: {replays}")
    check(hist.level == [s.level for s in plan for _ in range(s.steps)],
          "History.level does not follow segments()")
    check(hist.flops == flops_want and out.total_flops == flops_want[-1],
          "cumulative FLOPs differ from the sum of train_step_flops per level")
    check(runner.n_compiles == ml.n_levels, f"{runner.n_compiles} step functions built")
    check(counts == want, f"V-cycle launches {counts} != structure {want}")
    n_down = sum(s.phase == "down" for s in plan)
    check(held["coalesce_pair"] == sum(len(flatten(specs[l + 1])) for l in range(n_down))
          and held["interp_axpy"] == sum(len(flatten(specs[l])) for l in range(n_down)),
          f"transitions held against the torch backend: {held}")

    if not keep_output:
        out = None  # its parameters: the scratch run needs the room
    # training from scratch on the same batches
    torch.cuda.reset_peak_memory_stats(dev)
    _reset_counters()
    t0 = time.time()
    _, base = vc.run_scratch(cfg, tc, batch_fn, seed=SEED, steps=tc.steps, device=dev)
    torch.cuda.synchronize(dev)
    scratch_wall = time.time() - t0
    scratch = _launches()
    want_s = dict({k: 0 for k in _wrappers()}, **_step_launches(cfg, tc, tc.steps))
    saving = vc.saving_vs_baseline(base, hist)
    log(f"[{tag}] run_scratch {tc.steps} steps in {scratch_wall:.2f}s wall "
        f"({tc.steps * per_step / scratch_wall:.0f} {unit} with first launches); losses "
        f"{np.round(base.loss, 4).tolist()}; V-cycle losses {np.round(hist.loss, 4).tolist()}; "
        f"peak max_memory_allocated "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; launches {scratch}")
    log(f"[{tag}] saving_vs_baseline (printed, not checked: {tc.steps} steps are too few "
        f"to show the paper's saving): {saving}")
    log(f"[{tag}] energy_report(V-cycle total {hist.flops[-1]:.4e} FLOPs, h100) (printed, "
        f"not checked): {flops_lib.energy_report(hist.flops[-1], 'h100')}; from scratch "
        f"{base.flops[-1]:.4e} FLOPs: {flops_lib.energy_report(base.flops[-1], 'h100')}")
    check(all(np.isfinite(base.loss)) and (base.loss[-1] < base.loss[0] or not learns),
          "run_scratch losses are not finite and falling")
    check(scratch == want_s, f"scratch launches {scratch} != structure {want_s}")
    return counts, scratch, out


def baselines_phase(dev, cfg, ml, tc, small_steps=4, final_steps=4, fit_steps=3):
    """Each of the paper's five baselines through ``BASELINES[name]``:
    finite losses, and every step charged what ``tests/test_baselines.py``
    pins for the reference (the small phase at the small model's step, LiGO's
    fit steps at the full model's, KI's student step plus its extra forward
    plus the teacher's forward).  Returns the launches of all five runs."""
    from repro_torch.core import flops as flops_lib
    from repro_torch.core.baselines import BASELINES
    from repro_torch.core.plans import build_plan
    from repro_torch.launch.train import make_batch_fn
    from repro_torch.models.api import build_model

    check(tc.seed == SEED, "the batches are drawn from tc.seed")
    batch_fn = make_batch_fn(cfg, tc, device=dev)
    B, S = tc.batch_size, tc.seq_len

    def fwd(c):
        return flops_lib.forward_flops(c, build_model(c).specs(), B, S)

    def step(c):
        return flops_lib.train_step_flops(c, build_model(c).specs(), B, S)

    small = {"stackbert": build_plan(cfg, dataclasses.replace(ml, depth_variant="stack"),
                                     width=False, depth=True).small_cfg,
             "bert2bert": build_plan(cfg, ml, width=True, depth=False).small_cfg}
    small = {name: small.get(name, build_plan(cfg, ml).small_cfg) for name in BASELINES}
    big = step(cfg)
    _reset_counters()
    for name, fn in BASELINES.items():
        kw = {"fit_steps": fit_steps} if name == "ligo" else {}
        torch.cuda.synchronize(dev)
        t0 = time.time()
        hist = fn(cfg, ml, tc, batch_fn, small_steps=small_steps, final_steps=final_steps,
                  seed=SEED, device=dev, **kw)
        wall = time.time() - t0
        final = {"ligo": [big] * (fit_steps + final_steps),
                 "ki": [big + fwd(cfg) + fwd(small[name])] * final_steps}.get(
                     name, [big] * final_steps)
        cum, want = 0.0, []
        for f in [step(small[name])] * small_steps + final:
            cum += f
            want.append(cum)
        log(f"[baselines] {name}: {len(hist.loss)} steps in {wall:.2f}s wall (small model "
            f"{small[name].n_layers}L d_model {small[name].d_model}); losses "
            f"{[round(x, 4) for x in hist.loss]}; levels {hist.level}; total "
            f"{hist.flops[-1]:.4e} FLOPs")
        check(all(np.isfinite(hist.loss)), f"{name}: a non-finite loss")
        check(hist.flops == want, f"{name}: FLOPs charges {hist.flops} != {want}")
        check(hist.level == [1] * small_steps + [0] * len(final), f"{name}: levels")
    counts = _launches()
    # seq 512 takes plain attention at every level, growth is duplication,
    # and no baseline coalesces or interpolates
    check(_flash_layers(cfg, tc.seq_len) == 0, "phase 10 expects no flash route")
    want = {k: 0 for k in _wrappers()}
    log(f"[baselines] launches {counts}, expected {want}")
    check(counts == want, f"baseline launches {counts} != structure {want}")
    return counts


# ---------------------------------------------------------------------------
# phases 11-12: checkpoints, resume and the train-to-serve hand-off


def _timed_manager(directory, kill_at=None):
    """A ``CheckpointManager`` that records, per save, the host wall of the
    snapshot (``save`` returning, after any earlier write is joined), the
    wall from then to the publish (the write, on the background thread of
    an async save) and the bytes written and reused; with ``kill_at`` it
    raises just after the save at that step, as a crash would."""
    from repro_torch.checkpoint import CheckpointManager

    class Killed(RuntimeError):
        pass

    class Timed(CheckpointManager):
        def save(self, step, state, meta=None, blocking=True):
            self.wait()
            rec = {"step": step, "phase": (meta or {}).get("phase"), "blocking": blocking,
                   "t0": time.time()}
            self.records.append(rec)
            super().save(step, state, meta, blocking)
            rec["returned_s"] = time.time() - rec["t0"]
            if step == kill_at:
                raise Killed(f"killed after the save at global step {step}")

        def _publish(self, name, tmp, step, meta):
            super()._publish(name, tmp, step, meta)
            rec = self.records[-1]
            rec["published_s"] = time.time() - rec["t0"]
            rec.update(self.last_save_stats)

    mgr = Timed(directory)
    mgr.records, mgr.Killed = [], Killed
    return mgr


def _log_saves(tag, records):
    for r in records:
        if r["blocking"]:
            walls = f"snapshot and write {r['published_s'] * 1e3:.1f} ms (blocking)"
        else:
            walls = (f"snapshot {r['returned_s'] * 1e3:.1f} ms host wall, write "
                     f"{(r['published_s'] - r['returned_s']) * 1e3:.1f} ms wall")
        log(f"[{tag}] save at global step {r['step']} (phase {r['phase']}): {walls}, "
            f"{r['bytes_written'] / 1e6:.3f} MB written ({r['objects_written']} objects), "
            f"{r['bytes_reused'] / 1e6:.3f} MB reused ({r['objects_reused']} objects)")


def resume_phase(dev, cfg, ml, tc, want, every=5, kill_at=10):
    """Phase 7's GPT-Base V-cycle through the launcher's
    ``train_vcycle_ckpt`` with a ``CheckpointManager`` saving every ``every``
    global steps, killed just after the save at ``kill_at`` (the middle of
    the upward sweep); the restored state checked, then resumed in a fresh
    runner to the end.  ``History`` must equal ``want`` (phase 7's
    uninterrupted run of the same setup) exactly, losses and final
    parameters bit for bit; the resumed path's launches follow from the
    schedule (the resumed steps plus the replayed transition); a further
    invocation on the finished directory returns the saved parameters and
    takes no step.  Returns the resumed path's launches."""
    from repro_torch.core import vcycle as vc
    from repro_torch.launch import train as T
    from repro_torch.models.api import build_model
    from repro_torch.param import flatten

    root = tempfile.mkdtemp(prefix="chip_smoke_resume_")
    try:
        free = shutil.disk_usage(root).free
        mgr = _timed_manager(root, kill_at=kill_at)
        t0 = time.time()
        try:
            T.train_vcycle_ckpt(cfg, ml, tc, ckpt=mgr, ckpt_every=every, verbose=False,
                                device=dev)
            check(False, f"the run was not killed at global step {kill_at}")
        except mgr.Killed:
            mgr.wait()
        killed_wall = time.time() - t0

        runner = vc.VCycleRunner(cfg, ml, tc, T.make_driver_batch_fn(cfg, tc, device=dev),
                                 seed=tc.seed, device=dev)
        plan = runner.plan
        t0 = time.time()
        state, params, opt = T.restore_vcycle_state(mgr, runner, tc)
        torch.cuda.synchronize(dev)
        restore_s = time.time() - t0
        seg = plan[state.seg_index]
        log(f"[resume] killed after the save at global step {kill_at} ({killed_wall:.2f}s "
            f"wall, {free / 2**30:.1f} GiB free at {root}); restored phase={state.phase} "
            f"level={state.level} seg_step={state.seg_step}/{seg.steps} params_before="
            f"{sorted(state.params_before)} opt count={opt['count']} in {restore_s:.2f}s")
        check((state.phase, state.level, state.global_step) == ("up", 1, kill_at)
              and sorted(state.params_before) == [0] and opt["count"] == state.seg_step
              and 0 < state.seg_step < seg.steps,
              f"restored state {state.phase, state.level, state.global_step, state.seg_step}"
              f" is not the middle of the upward sweep at global step {kill_at}")
        left = seg.steps - state.seg_step
        del runner, state, params, opt

        n_killed = len(mgr.records)
        torch.cuda.synchronize(dev)
        _reset_counters()
        t0 = time.time()
        out = T.train_vcycle_ckpt(cfg, ml, tc, ckpt=mgr, ckpt_every=every, verbose=False,
                                  device=dev)
        torch.cuda.synchronize(dev)
        wall = time.time() - t0
        counts = _launches()
        _log_saves("resume", mgr.records)
        cfgs = out.configs
        want_n = {k: 0 for k in _wrappers()}
        for c, n in ((cfgs[1], left), (cfgs[0], plan[-1].steps)):
            for k, v in _step_launches(c, tc, n).items():
                want_n[k] += v
        want_n["interp_axpy"] = len(flatten(build_model(cfgs[0]).specs()))
        got, ref = flatten(out.params), flatten(want.params)
        diff = {k: (got[k].float() - ref[k].float()).abs().max().item() for k in ref}
        worst = max(diff, key=diff.get)
        h, w = out.history, want.history
        loss_diff = max(abs(a - b) for a, b in zip(h.loss, w.loss))
        log(f"[resume] resumed {left} level-1 steps, the up transition and {plan[-1].steps} "
            f"level-0 steps in {wall:.2f}s wall with {len(mgr.records) - n_killed} saves; "
            f"launches {counts}, expected {want_n}; against the uninterrupted run: largest "
            f"|param diff| {diff[worst]:.3e} ({worst}), largest |loss diff| {loss_diff:.3e}, "
            f"{sum(torch.equal(got[k], ref[k]) for k in ref)}/{len(ref)} leaves bit-equal")
        check(h.step == w.step and h.level == w.level and h.flops == w.flops
              and out.total_flops == want.total_flops,
              "the resumed History's steps, levels or FLOPs differ from the uninterrupted run")
        check(h.loss == w.loss, f"resumed losses differ from the uninterrupted run's (largest "
                                f"difference {loss_diff:.3e})")
        check(got.keys() == ref.keys() and all(torch.equal(got[k], ref[k]) for k in ref),
              f"resumed parameters differ from the uninterrupted run's: largest difference "
              f"{diff[worst]:.3e} in {worst}")
        check(counts == want_n, f"resume launches {counts} != schedule {want_n}")

        n_saves = len(mgr.records)
        _reset_counters()
        again = T.train_vcycle_ckpt(cfg, ml, tc, ckpt=mgr, ckpt_every=every, verbose=False,
                                    device=dev)
        again_counts = _launches()
        same = flatten(again.params)
        check(not any(again_counts.values()) and len(mgr.records) == n_saves,
              f"the finished directory took a step: launches {again_counts}, "
              f"{len(mgr.records) - n_saves} saves")
        check(all(torch.equal(same[k], ref[k]) for k in ref)
              and again.history.to_dict() == w.to_dict(),
              "re-invoking the finished run did not return the saved parameters")
        log(f"[resume] re-invoked on the finished directory: no step, no launch, the saved "
            f"parameters and History returned")
        return counts
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _trainer(args, log_path, after=None):
    """The launcher's ``main(ARGS)`` in a process of its own on this card
    (``launch_worker``: GPT-Base cut to ``COORD_LAYERS``), its output
    (unbuffered) into ``log_path`` and its record beside it; with ``after``
    it warms up and waits for that file."""
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    cmd = [sys.executable, os.path.abspath(__file__), "--launch", log_path + ".json"]
    cmd += ["--launch-after", after] if after else []
    with open(log_path, "w") as lf:
        return subprocess.Popen(cmd + ["--", *args], cwd=ROOT, env=env, stdout=lf,
                                stderr=subprocess.STDOUT)


def _read(path) -> str:
    with open(path) as f:
        return f.read()


def _stop(p) -> None:
    if p.poll() is None:
        p.kill()
    p.wait(timeout=60)


def start_handoff(train_args) -> dict:
    """Phase 12's two launcher processes, started now (before phase 7): each
    imports the port, makes its CUDA context, loads the kernels and waits
    for :func:`handoff_phase` to let it go.  One trains ``train_args`` into
    the directory the server follows; the SIGTERM drill's trains the same
    schedule into a second directory with no periodic checkpoint."""
    root = tempfile.mkdtemp(prefix="chip_smoke_handoff_")
    ck, ck2 = os.path.join(root, "ckpt"), os.path.join(root, "ckpt_sigterm")
    drill = list(train_args) + ["--ckpt-dir", ck2]
    drill[drill.index("--ckpt-every") + 1] = "1000"
    go = os.path.join(root, "go")
    logs = {"train": os.path.join(root, "train.log"), "drill": os.path.join(root, "sigterm.log")}
    procs = {"train": _trainer(list(train_args) + ["--ckpt-dir", ck], logs["train"], go),
             "drill": _trainer(drill, logs["drill"], go)}
    return {"root": root, "ck": ck, "ck2": ck2, "go": go, "logs": logs, "procs": procs,
            "train_args": list(train_args), "drill_args": drill}


def stop_handoff(early) -> None:
    for p in early["procs"].values():
        _stop(p)
    shutil.rmtree(early["root"], ignore_errors=True)


def handoff_phase(dev, cfg, early, lengths, max_new=16, batch=8, timeout=600):
    """The train-to-serve hand-off, on :func:`start_handoff`'s processes.
    The launcher trains (the GPT-Base V-cycle, a checkpoint every
    ``--ckpt-every`` global steps) in one of them on this card while a paged
    server on the same model serves waves of requests here with a
    ``ManifestWatcher`` on the trainer's directory attached.  The server
    must swap at least two published level-0 steps, in publish order, by
    digest diff; skip every coalesced level-1 step it examines; drop no
    request; serve a wave admitted after a swap as a fresh server on the
    landed weights does; and end on the trainer's final weights.  Beside it
    the SIGTERM drill on the same CLI in a second directory: SIGTERM in the
    upward sweep (sent when its log shows the first coalescing) gives exit 0
    and a blocking ``[preempt]`` checkpoint, and the restart (here) resumes
    at that global step and ends with the terminal checkpoint.  Returns the
    server's launches."""
    import threading

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint.manager import _read_leaves
    from repro_torch.config import MultiLevelConfig, TrainConfig
    from repro_torch.core.vcycle import segments
    from repro_torch.launch.serve import ManifestWatcher, Request, make_server
    from repro_torch.param import flatten

    root, ck, ck2 = early["root"], early["ck"], early["ck2"]
    train_args, args = early["train_args"], early["drill_args"]
    log2 = early["logs"]["drill"]
    try:
        srv = make_server(cfg, engine="paged", batch=batch, max_seq=max(lengths) + max_new + 1,
                          page_size=16, device=dev)
        reload_s = []

        class TimedWatcher(ManifestWatcher):
            def poll(self):
                t0 = time.time()
                got = super().poll()
                if got is not None:
                    torch.cuda.synchronize(dev)
                    reload_s.append(time.time() - t0)
                return got

        watcher = TimedWatcher(CheckpointManager(ck), like=srv.params)
        srv.attach_watcher(watcher)
        prefill, paged_step = srv.prefill, srv.paged_step
        seen = {"long_prefills": 0, "ticks": 0}

        def prefill_counted(params, tokens):
            seen["long_prefills"] += tokens.shape[1] > max(128, cfg.attn_block_k)
            return prefill(params, tokens)

        def paged_counted(params, pages, tokens, positions, tables):
            seen["ticks"] += tokens.shape[1] == 1
            return paged_step(params, pages, tokens, positions, tables)

        srv.prefill, srv.paged_step = prefill_counted, paged_counted
        rng = np.random.default_rng(SEED + 12)
        waves = []

        def wave():
            rid = sum(len(w["reqs"]) for w in waves)
            reqs = [Request(rid=rid + i, prompt=rng.integers(0, cfg.vocab_size, size=int(n)),
                            max_new=max_new)
                    for i, n in enumerate(rng.choice(lengths, size=batch))]
            before = srv.reloads
            srv.run(reqs)
            waves.append({"reqs": reqs, "reloads": (before, srv.reloads)})

        _reset_counters()
        trainer, p = early["procs"]["train"], early["procs"]["drill"]
        drill = {"signalled": None}

        def sigterm_in_the_upward_sweep():
            while (p.poll() is None and "coalescing" not in _read(log2)
                   and time.time() - t0 < timeout):
                time.sleep(0.02)
            drill["signalled"] = p.poll() is None
            if drill["signalled"]:
                p.send_signal(signal.SIGTERM)

        with open(early["go"], "w"):
            pass
        t0 = time.time()
        watch = threading.Thread(target=sigterm_in_the_upward_sweep, daemon=True)
        watch.start()
        while trainer.poll() is None and time.time() - t0 < timeout:
            wave()
        train_wall = time.time() - t0
        check(trainer.poll() == 0, f"the trainer exited {trainer.poll()} after "
                                   f"{train_wall:.1f}s:\n{_read(os.path.join(root, 'train.log'))[-3000:]}")
        swaps_before = srv.reloads
        wave()  # lands the trainer's terminal checkpoint, then serves on it
        torch.cuda.synchronize(dev)
        counts = _launches()
        done = [r for w in waves for r in w["reqs"]]
        final = CheckpointManager(ck).latest()
        log(f"[handoff] trainer {' '.join(train_args)}: exit 0 after {train_wall:.1f}s; "
            f"server: {len(waves)} waves, {len(done)} requests, {srv.reloads} swaps of steps "
            f"{watcher.steps_seen}, skipped {watcher.steps_skipped}, poll errors "
            f"{watcher.poll_errors}, reload walls {[round(x, 3) for x in reload_s]} s; "
            f"launches {counts}, long prefills {seen['long_prefills']}, decode ticks "
            f"{seen['ticks']}")
        for r in watcher.reload_history:
            log(f"[handoff] reload {r}")
        steps = int(train_args[train_args.index("--steps") + 1])
        plan = segments(None, MultiLevelConfig(), TrainConfig(steps=steps))
        level1 = set(range(plan[0].steps + 1, plan[0].steps + plan[1].steps + 1))
        check(srv.rejected == [] and len(srv.done) == len(done)
              and all(len(r.out) == max_new for r in done), "the server dropped a request")
        check(srv.reloads == len(watcher.steps_seen) >= 2
              and watcher.steps_seen == sorted(set(watcher.steps_seen)),
              f"swaps {srv.reloads} of steps {watcher.steps_seen}: need two or more, in order")
        check(set(watcher.steps_skipped) <= level1 and not level1 & set(watcher.steps_seen)
              and watcher.steps_seen[-1] == final["step"] and final["meta"]["phase"] == "done",
              f"skipped {watcher.steps_skipped}, landed {watcher.steps_seen}, last publish "
              f"{final['step']} ({final['meta'].get('phase')})")
        # digest diff: each reload read only its changed leaves' objects, never
        # the optimizer's or a stash's that share its manifest
        check(all(r["changed"] + r["reused"] == r["leaves"]
                  and r["gather_needed"] <= r["changed"] for r in watcher.reload_history)
              and any(r["gather_skipped"] > 0 for r in watcher.reload_history),
              "a reload did not land by digest diff")
        check(waves[-1]["reloads"][1] > swaps_before or swaps_before == srv.reloads,
              "the last wave did not run on the terminal checkpoint")
        published = _read_leaves(os.path.join(ck, final["dir"], "params"))
        landed = flatten(srv.params)
        check(all(np.array_equal(landed[k].cpu().numpy(), v) for k, v in published.items()),
              "the served weights are not the trainer's final weights")
        with _uncounted():
            fresh = make_server(cfg, engine="paged", batch=batch, max_seq=srv.max_seq,
                                page_size=16, device=dev)
            fresh.set_params(srv.params)
            want = fresh.run([Request(r.rid, r.prompt, max_new) for r in waves[-1]["reqs"]])
            del fresh
        check({r.rid: r.out for r in want} == {r.rid: r.out for r in waves[-1]["reqs"]},
              "the wave admitted after the last swap differs from a fresh server's on the "
              "landed weights")
        want_n = dict({k: 0 for k in _wrappers()},
                      flash_attention_fwd=cfg.n_layers * seen["long_prefills"],
                      paged_attention_decode=cfg.n_layers * seen["ticks"])
        check(counts == want_n, f"hand-off server launches {counts} != {want_n}")
        log(f"[handoff] the last wave ({len(waves[-1]['reqs'])} requests) equals a fresh "
            f"server's on the landed weights; served weights == the terminal checkpoint's")
        del srv, watcher

        # the SIGTERM drill, which ran beside the trainer
        watch.join(timeout)
        check(drill["signalled"], f"the drill's trainer ended before its upward sweep:\n"
                                  f"{_read(log2)[-3000:]}")
        rc = p.wait(timeout=timeout)
        out = _read(log2)
        m = re.search(r"\[preempt\] SIGTERM: blocking V-cycle checkpoint at global_step (\d+)",
                      out)
        meta = CheckpointManager(ck2).latest()["meta"]
        log(f"[handoff] SIGTERM drill: exit {rc} after {time.time() - t0:.1f}s; "
            f"{m.group(0) if m else 'no [preempt] line'}; manifest phase={meta['phase']} "
            f"level={meta['level']} seg_step={meta.get('seg_step')} "
            f"global_step={meta['global_step']}")
        check(rc == 0 and m is not None and meta["phase"] == "up"
              and int(m.group(1)) == meta["global_step"],
              f"SIGTERM drill: exit {rc}, log tail:\n{out[-3000:]}")
        # the restart: the same CLI's main, here (a process of its own adds
        # only its start-up)
        import io

        t0 = time.time()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            _main_here(args, {})
        out = buf.getvalue()
        line = (f"[vcycle] resumed at phase=up level=1 seg_step={meta['seg_step']} "
                f"global_step={meta['global_step']}")
        end = CheckpointManager(ck2).latest()["meta"]
        log(f"[handoff] restart (the launcher's main here): done after "
            f"{time.time() - t0:.1f}s; {'found' if line in out else 'missing'} '{line}'; final "
            f"manifest phase {end['phase']} at global step {end['global_step']}")
        check(line in out and end["phase"] == "done",
              f"SIGTERM restart: output tail:\n{out[-3000:]}")
        return counts
    finally:
        stop_handoff(early)


# ---------------------------------------------------------------------------
# phases 18-20: the recurrent mixers (xLSTM-125m; Mamba at Jamba's widths)


def _grad_err(got, want, rtol, atol=0.0, groups=None) -> float:
    """Largest gradient error over a leaf list, in units of each leaf's own
    tolerance: atol + rtol * the largest |value| of that leaf of ``want``.
    With ``groups`` (one name per leaf) that largest value is taken no
    smaller than 1e-6 of the largest in the leaf's group: a leaf whose true
    gradient is 0 holds only rounding noise, and the noise is the size of
    its group's gradients times the rounding unit.  The mLSTM's input-gate
    bias is one: its output does not move when every input gate of a head
    shifts together (the stabilizer absorbs it, wherever |n.q| >= 1), so its
    gradient is what is left of terms the size of the gate weights'."""
    floor = {}
    for g, b in zip(groups or [None] * len(want), want):
        floor[g] = max(floor.get(g, 0.0), 1e-6 * b.abs().max().item() if groups else 0.0)
    worst = 0.0
    for a, b, g in zip(got, want, groups or [None] * len(want)):
        err = (a - b).abs().max().item()
        tol = atol + rtol * max(b.abs().max().item(), floor[g])
        worst = max(worst, err / tol if tol else (0.0 if err == 0 else float("inf")))
    return worst


def _decode_err(dev, model, params, tokens) -> tuple:
    """Prefill tokens[:, :T], decode position T from the prefill's caches:
    (prefill's and decode's largest logit error against the full forward
    at T - 1 and T, the largest |logit|, the largest error of the decode
    step's advanced state against the state the prefill of all T + 1
    tokens returns, per leaf over max(1, that leaf's largest |value|))."""
    from repro_torch.models.api import make_prefill_step, make_serve_step
    from repro_torch.param import flatten

    B, S = tokens.shape
    T = S - 1
    with torch.inference_mode():
        full = model.forward_logits(params, {"tokens": tokens})
        lg_pre, caches = make_prefill_step(model)(params, tokens[:, :T])
        lg_dec, stepped = make_serve_step(model)(params, caches, tokens[:, T:],
                                                 torch.full((B,), T, dtype=torch.long, device=dev))
        del caches
        want = flatten(make_prefill_step(model)(params, tokens)[1])
        e_state = max(((a - want[k]).abs().max() / want[k].abs().max().clamp_min(1.0)).item()
                      for k, a in flatten(stepped).items())
    return ((lg_pre - full[:, T - 1]).abs().max().item(),
            (lg_dec - full[:, T]).abs().max().item(), full.abs().max().item(), e_state)


def jamba_mixer_cfg():
    """A config carrying Jamba-1.5-Large's Mamba mixer widths (d 8192,
    d_inner 16384, d_state 16, d_conv 4, dt rank 512; the numbers of
    ``src/repro/configs/jamba_1_5_large_398b.py``, after arXiv:2403.19887)
    at f32; its stages are empty (one mixer alone is run)."""
    from repro_torch.config import ModelConfig

    mcfg = ModelConfig(name="jamba-1.5-large-398b mamba mixer", family="hybrid",
                       d_model=8192, n_heads=64, n_kv_heads=8, d_ff=24576, vocab_size=65536,
                       stages=(), mamba_d_state=16, mamba_d_conv=4, mamba_expand=2,
                       compute_dtype=torch.float32)
    check((mcfg.mamba_d_inner, mcfg.resolved_dt_rank) == (16384, 512), "Jamba's mixer widths")
    return mcfg


def ssm_f32_phase(dev, cfg, mcfg, seq=512, grad_seq=64, grad_chunk=16, batch=2,
                  mamba_seq=1024) -> None:
    """xLSTM-125m at full width, 6 of its 12 layers (remat "full", in
    ``main``) and
    one Mamba layer at Jamba-1.5-Large's mixer widths (``mcfg``): the
    checkpointed chunks against the plain loop (``ssm_chunk`` 1), then
    prefill plus one decode step against the full forward.

    xLSTM, with the same weights at f32 and at f64: a remat-full loss and
    its gradients at ``grad_seq`` x ``batch`` with ``ssm_chunk``
    ``grad_chunk`` (4 checkpointed chunks) against the plain loop; then, at
    ``grad_seq`` and at ``seq`` tokens (the forward in chunks of the
    config's 128), the full forward, the prefill of all but the last token,
    the decode of the last, and the prefill of all tokens.  At f32 the
    losses agree within 1e-4 and the gradients and logits are finite; the
    other errors are printed, not held: the model's f32 arithmetic is
    chaotic at this width (in the reference too: moving every weight matrix
    one ulp moves its logits by their own size at S 64), and the sLSTM's
    gradients grow ~1.4x a step backwards (the reference's fan-in fallback
    draws its recurrent matrices at std 0.707), which is why ``grad_seq`` is
    short: they overflow f32 past ~100 steps in both packages.  The
    equalities are held at f64, where rounding is ~5e8 times finer: the
    loss within 1e-6 of max(1, |loss|), each gradient leaf within 1e-6 of its
    own largest value (``_grad_err``), the prefill's and the decode's logits
    within 1e-6 of max(1, max |logit|), and the decode step's advanced state
    within 1e-6 of the prefill's of all tokens (``_decode_err``).

    Mamba, f32, B 1 at ``mamba_seq``: ``mean(y * r)``'s output chunked (the
    config's 128) against plain within 1e-5 of max(1, max |y|), each
    gradient within phase 6's tolerance of its own leaf (1e-5 + 1e-3 of its
    largest value), and prefill plus decode against the forward's last
    position within 1e-5 of max(1, max |y|).  No kernel lies on either path:
    the counts must stay 0."""
    from repro_torch.config import TrainConfig
    from repro_torch.launch.train import make_batch_fn
    from repro_torch.layers import ssm
    from repro_torch.models.api import build_model
    from repro_torch.param import flatten, init_tree, unflatten

    f32, f64 = torch.float32, torch.float64
    check(cfg.compute_dtype == f32 == mcfg.compute_dtype, "phase 18 runs at f32")
    _reset_counters()
    tokens = make_batch_fn(cfg, TrainConfig(batch_size=batch, seq_len=seq), device=dev)(0)
    batch_ = {k: v[:, :grad_seq] for k, v in tokens.items()}
    init32 = flatten(build_model(cfg).init(torch.Generator(device=dev).manual_seed(SEED)))
    for dt in (f32, f64):
        c = cfg.replace(compute_dtype=dt)
        init = {k: v.detach().to(dt) for k, v in init32.items()}
        leaves = [v.requires_grad_() for v in init.values()]
        res, walls, peaks = {}, {}, {}
        for chunk in (grad_chunk, 1):
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            t = time.time()
            loss, _ = build_model(c.replace(ssm_chunk=chunk)).loss(
                unflatten(dict(zip(init, leaves))), batch_)
            res[chunk] = (loss.item(), torch.autograd.grad(loss, leaves))
            torch.cuda.synchronize(dev)
            walls[chunk] = time.time() - t
            peaks[chunk] = torch.cuda.max_memory_allocated(dev) / 2**30
        (l_c, g_c), (l_p, g_p) = res[grad_chunk], res[1]
        finite = all(torch.isfinite(g).all().item() for g in g_c + g_p)
        g_max = max(g.abs().max().item() for g in g_p)
        g_err = _grad_err(g_c, g_p, rtol=1e-6, groups=[k.rsplit("/", 1)[0] for k in init])
        del res, g_c, g_p, leaves
        log(f"[ssm-f32] {cfg.name} {cfg.n_layers}L remat {cfg.remat} at {dt}, seq {grad_seq} "
            f"batch {batch}: loss chunked ({grad_chunk}) {l_c!r} plain {l_p!r}; gradients "
            f"finite {finite}, largest {g_max:.3e}, error / the f64 tolerance {g_err:.4g} over {len(init)} leaves; loss + gradients wall chunked "
            f"{walls[grad_chunk]:.2f}s plain {walls[1]:.2f}s, peak max_memory_allocated GiB "
            f"chunked {peaks[grad_chunk]:.2f} plain {peaks[1]:.2f}")
        check(finite, f"non-finite xLSTM gradients at {dt}")
        if dt == f32:
            check(abs(l_c - l_p) <= 1e-4, f"xLSTM losses differ: {l_c} vs {l_p}")
        else:
            check(abs(l_c - l_p) <= 1e-6 * max(1.0, abs(l_p)),
                  f"xLSTM f64 losses differ: {l_c} vs {l_p}")
            check(g_err <= 1.0, f"xLSTM f64 gradients differ between chunked and plain "
                                f"({g_err} x tolerance)")
        model = build_model(c)
        params = unflatten({k: v.detach() for k, v in init.items()})
        for n in (grad_seq, seq):  # short, and across the forward's chunks of 128
            t = time.time()
            e_pre, e_dec, top, e_st = _decode_err(dev, model, params, tokens["tokens"][:, :n])
            torch.cuda.synchronize(dev)
            log(f"[ssm-f32] {cfg.name} at {dt}, seq {n}: prefill {n - 1} + decode 1 against "
                f"the forward: logit error {e_pre:.3e} (prefill), {e_dec:.3e} (decode), max "
                f"|logit| {top:.4f}; decoded state against the prefill of {n}: {e_st:.3e} of "
                f"max(1, |leaf|) ({time.time() - t:.2f}s for the forward and the three steps)")
            check(math.isfinite(top) and math.isfinite(e_dec),
                  f"non-finite xLSTM logits at {dt}")
            if dt == f64:
                tol = 1e-6 * max(1.0, top)
                check(max(e_pre, e_dec) <= tol, f"xLSTM f64 prefill/decode logits differ from "
                                                f"the forward: {e_pre}, {e_dec} > {tol}")
                check(e_st <= 1e-6, f"xLSTM f64 decoded state differs from the prefill's: {e_st}")
        del init, params, model
        _free()
    del init32, tokens, batch_
    _free()

    # one Mamba layer
    gen = torch.Generator(device=dev).manual_seed(SEED)
    p = init_tree(gen, ssm.mamba_specs(mcfg))
    x = _randn((1, mamba_seq, mcfg.d_model), f32, dev, gen)
    r = _randn((1, mamba_seq, mcfg.d_model), f32, dev, gen)
    leaves = [x.requires_grad_()] + [v.requires_grad_() for v in p.values()]
    res = {}
    for chunk in (mcfg.ssm_chunk, 1):
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t = time.time()
        y, _ = ssm.mamba_apply(dict(zip(p, leaves[1:])), x, mcfg.replace(ssm_chunk=chunk))
        grads = torch.autograd.grad((y * r).mean(), leaves)
        torch.cuda.synchronize(dev)
        res[chunk] = (y.detach(), grads, time.time() - t,
                      torch.cuda.max_memory_allocated(dev) / 2**30)
        del y, grads
    (y_c, g_c, w_c, m_c), (y_p, g_p, w_p, m_p) = res[mcfg.ssm_chunk], res[1]
    y_err = (y_c - y_p).abs().max().item()
    g_err = _grad_err(g_c, g_p, rtol=1e-3, atol=1e-5)
    del res, g_c, g_p
    pd = {k: v.detach() for k, v in p.items()}
    with torch.inference_mode():
        T = mamba_seq - 1
        y_pre, state = ssm.mamba_apply(pd, x.detach()[:, :T], mcfg, return_state=True)
        y_dec, _ = ssm.mamba_apply(pd, x.detach()[:, T:], mcfg, cache=state)
    e_pre = (y_pre - y_p[:, :T]).abs().max().item()
    e_dec = (y_dec[:, 0] - y_p[:, T]).abs().max().item()
    top = y_p.abs().max().item()
    log(f"[ssm-f32] Mamba mixer of {mcfg.name} (d {mcfg.d_model}, d_inner {mcfg.mamba_d_inner}, "
        f"d_state {mcfg.mamba_d_state}, dt rank {mcfg.resolved_dt_rank}), B 1 S {mamba_seq}: "
        f"output error chunked vs plain {y_err:.3e} (max |y| {top:.3e}), gradient error / its "
        f"tolerance {g_err:.4f}; wall chunked {w_c:.2f}s plain {w_p:.2f}s, peak GiB chunked "
        f"{m_c:.2f} plain {m_p:.2f}; prefill {T} + decode 1 against the forward: {e_pre:.3e}, "
        f"{e_dec:.3e}")
    check(y_err <= 1e-5 * max(1.0, top), f"Mamba chunked output differs: {y_err}")
    check(g_err <= 1.0, f"Mamba gradients differ between chunked and plain ({g_err} x "
                        f"tolerance)")
    check(max(e_pre, e_dec) <= 1e-5 * max(1.0, top),
          f"Mamba prefill/decode differ from the forward: {e_pre}, {e_dec}")
    check(not any(_launches().values()), f"a kernel launched on the recurrent path: "
                                         f"{_launches()}")


def slots_serve_phase(dev, cfg, lengths, max_new=32, max_seq=2048, tag="xlstm-serve") -> dict:
    """The slots engine (the paged one refuses recurrent and cross-attention
    blocks) serving ``lengths`` at batch 8: every request completes with
    ``max_new`` tokens and finite logits; the flash forward launches as the
    prefills imply (``_flash_layers`` of each prompt: none without an
    attention layer; the encoder-decoder's encoder on every prefill) and
    paged decode never.  Prints tokens/s, the host wall per prefill token
    and per decode tick, and peak memory.  Returns the launches."""
    from repro_torch.launch.serve import make_server

    try:
        make_server(cfg, engine="paged", device=dev)
        check(False, f"the paged engine took {cfg.name}")
    except NotImplementedError as e:
        check("use --engine slots" in str(e), f"the paged engine's refusal: {e}")
    srv = make_server(cfg, engine="slots", batch=8, max_seq=max_seq, device=dev)
    reqs = _requests(lengths, max_new, cfg.vocab_size)
    finite = torch.ones((), dtype=torch.bool, device=dev)
    prefill, decode, decode_once = srv.prefill, srv.decode, srv.decode_once
    walls = {"prefill": [], "decode": []}

    def prefill_timed(params, tokens, **extras):
        nonlocal finite
        torch.cuda.synchronize(dev)
        t = time.time()
        logits, caches = prefill(params, tokens, **extras)
        finite = finite & torch.isfinite(logits).all()
        torch.cuda.synchronize(dev)
        walls["prefill"].append((time.time() - t, tokens.shape[1]))
        return logits, caches

    def decode_checked(params, caches, tokens, pos):
        nonlocal finite
        logits, caches = decode(params, caches, tokens, pos)
        finite = finite & torch.isfinite(logits).all()
        return logits, caches

    def decode_timed():  # the step and its argmax read
        t = time.time()
        out = decode_once()
        walls["decode"].append(time.time() - t)
        return out

    srv.prefill, srv.decode, srv.decode_once = prefill_timed, decode_checked, decode_timed
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize(dev)
    _reset_counters()
    t0 = time.time()
    done = srv.run(reqs)
    torch.cuda.synchronize(dev)
    wall = time.time() - t0
    counts = _launches()
    tokens = sum(len(r.out) for r in done)
    pre_s = sum(w for w, _ in walls["prefill"])
    pre_tok = sum(n for _, n in walls["prefill"])
    want = dict({k: 0 for k in _wrappers()},
                flash_attention_fwd=sum(_flash_layers(cfg, n, train=False) for n in lengths))
    log(f"[{tag}] {cfg.name} {cfg.n_layers}L"
        f"{f' + {cfg.n_encoder_layers}L encoder' if cfg.n_encoder_layers else ''} slots engine, "
        f"batch 8: {len(done)} requests, {tokens} tokens in {wall:.3f}s wall "
        f"({tokens / wall:.1f} tok/s); prefill {pre_tok} prompt tokens in {pre_s:.3f}s "
        f"({pre_s / pre_tok * 1e3:.3f} ms of host wall a token), {len(walls['decode'])} decode "
        f"ticks, host wall a tick mean {np.mean(walls['decode']) * 1e3:.2f} ms (p50 "
        f"{np.median(walls['decode']) * 1e3:.2f}, max {np.max(walls['decode']) * 1e3:.2f}); "
        f"max_memory_allocated={torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; "
        f"launches {counts}, expected {want}")
    check(len(done) == len(lengths) and not srv.rejected, f"{tag}: requests lost")
    check(all(len(r.out) == max_new for r in done), "a request stopped early")
    check(bool(finite.item()), f"non-finite logits in {tag}")
    check(pre_tok == sum(lengths), f"prefilled {pre_tok} tokens, not {sum(lengths)}")
    check(counts == want, f"{tag} launches {counts} != {want}")
    return counts


# ---------------------------------------------------------------------------
# phases 21-23: MLA and DeepSeek-V3


def deepseek_cut(n_dense: int, n_moe: int, n_experts: int, **kw):
    """DeepSeek-V3 at its full widths (d 7168, 128 heads, MLA q_lora 1536,
    kv_lora 512, nope 128 + rope 64, v 128, top-8 routing with the shared
    expert, the MTP head), cut to ``n_dense`` dense-FFN and ``n_moe`` MoE
    layers of ``n_experts`` routed experts each."""
    from repro_torch.config import BlockSpec, Stage
    from repro_torch.configs import get_config

    stages = tuple(Stage((BlockSpec("attn", ffn),), n)
                   for ffn, n in (("dense", n_dense), ("moe", n_moe)) if n)
    return get_config(DEEPSEEK).replace(stages=stages, n_experts=n_experts, **kw)


def mla_decode_phase(dev, cfg, S=1024, n_decode=8, n_extend=4, batch=2) -> None:
    """Prefill of all but the last ``n_decode + n_extend`` tokens, then
    absorbed decode against the latent cache one token at a time, on the
    dense and the paged layout, and on the paged one a last multi-token
    step of ``n_extend`` (the extend and verify path): every step's logits
    within 1e-4 of max(1, max |logit|) of one forward of all ``S`` tokens
    (f32, both through the kernels).  The capacity factor is raised to
    ``n_experts / top_k`` so that no expert drops a routing at any length:
    the forward and the decode steps route the same tokens alike, and the
    comparison holds the attention paths alone.  Flash runs on the forward
    and the prefill (both past ``attn_block_k``); paged decode never."""
    from repro_torch.launch.serve import make_write_prompt
    from repro_torch.models import lm as lm_lib
    from repro_torch.models.api import build_model
    from repro_torch.param import tree_map, zeros_tree

    cfg = cfg.replace(capacity_factor=cfg.n_experts / cfg.moe_top_k)
    params = build_model(cfg).init(torch.Generator(device=dev).manual_seed(SEED + 4))
    toks = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, size=(batch, S))).to(dev)
    P0, page, M = S - n_decode - n_extend, 16, -(-S // 16)
    errs = {}
    _reset_counters()
    with torch.inference_mode():
        want = lm_lib.lm_forward(params, toks, cfg, mode="prefill")["logits"]
        tol = TOL[torch.float32] * max(1.0, want.abs().max().item())
        pre = lm_lib.lm_forward(params, toks[:, :P0], cfg, mode="prefill")
        errs["prefill"] = (pre["logits"] - want[:, :P0]).abs().max().item()
        for layout in ("dense", "paged"):
            if layout == "dense":
                caches = zeros_tree(lm_lib.cache_specs(cfg, batch, S), torch.float32, dev)
                tree_map(lambda c, p: c[:, :, :P0].copy_(p), caches, pre["caches"])
                tables, last = None, S
            else:
                caches = zeros_tree(lm_lib.paged_cache_specs(cfg, 1 + batch * M, page),
                                    torch.float32, dev)
                tables = torch.arange(1, 1 + batch * M, device=dev).view(batch, M).flip(1)
                write = make_write_prompt(page)
                for b in range(batch):
                    write(caches, tree_map(lambda c: c[:, b:b + 1], pre["caches"]),
                          tables[b, :-(-P0 // page)])
                last = S - n_extend
            err = 0.0
            for i in range(P0, last):
                out = lm_lib.lm_forward(params, toks[:, i:i + 1], cfg,
                                        positions=torch.full((batch, 1), i, device=dev),
                                        mode="decode", caches=caches, block_tables=tables)
                err = max(err, (out["logits"][:, 0] - want[:, i]).abs().max().item())
            if layout == "paged":
                pos = torch.arange(last, S, device=dev)[None].expand(batch, -1)
                out = lm_lib.lm_forward(params, toks[:, last:], cfg, positions=pos,
                                        mode="decode", caches=caches, block_tables=tables)
                errs["paged extend"] = (out["logits"] - want[:, last:]).abs().max().item()
            errs[layout] = err
            del caches
    torch.cuda.synchronize(dev)
    counts = _launches()
    n_attn = cfg.n_layers
    log(f"[mla-f32] prefill {P0} tokens x {batch}, then {n_decode + n_extend} absorbed "
        f"decode steps a row (dense), {n_decode} + one {n_extend}-token step (paged): "
        f"max |logit err| against the forward {errs} (tolerance {tol:.3e}); launches "
        f"{counts}")
    check(all(e <= tol for e in errs.values()), f"absorbed decode disagrees: {errs}")
    check(counts["flash_attention_fwd"] == 2 * n_attn and not counts["paged_attention_decode"],
          f"launches {counts}: want flash {2 * n_attn} (forward, prefill), paged 0")


# ---------------------------------------------------------------------------
# phases 24-32: Jamba-1.5-Large, Whisper-large-v3, Llama-3.2-Vision-11B


def jamba_cut(n_experts: int, **kw):
    """Jamba-1.5-Large at its full widths (d 8192, 64/8 heads of D 128, Mamba
    d_state 16 and expand 2, experts of width 24576 routed top-2), cut to its
    blocks b2-b3 once (a Mamba layer with a dense FFN, an attention layer
    with an MoE FFN) with ``n_experts`` experts."""
    from repro_torch.config import Stage
    from repro_torch.configs import get_config

    full = get_config(JAMBA)
    return full.replace(stages=(Stage(full.stages[0].pattern[2:4], 1),), n_experts=n_experts,
                        **kw)


def xlstm_cut(repeats: int = 1, **kw):
    """xLSTM-125m at its full widths with its six-block pattern ``repeats``
    times (as configured: twice, 12 layers)."""
    from repro_torch.config import Stage
    from repro_torch.configs import get_config

    cfg = get_config(XLSTM)
    return cfg.replace(stages=(Stage(cfg.stages[0].pattern, repeats),), **kw)


def whisper_cut(n_layers: int, **kw):
    """Whisper-large-v3 at its full widths with ``n_layers`` encoder and as
    many decoder layers."""
    from repro_torch.config import uniform_stages
    from repro_torch.configs import get_config

    cfg = get_config(WHISPER)
    return cfg.replace(stages=uniform_stages(n_layers, cfg.stages[0].pattern[0]),
                       n_encoder_layers=n_layers, **kw)


def vlm_cut(**kw):
    """Llama-3.2-Vision-11B at its full widths in its smoke config's depth
    shape: a gated image layer and a self-attention layer, twice."""
    from repro_torch.config import Stage
    from repro_torch.configs import get_config

    cfg = get_config(VLM)
    return cfg.replace(stages=(Stage(cfg.stages[0].pattern[:2], 2),), **kw)


def _normal_frames(cfg, tc, dev):
    """``make_batch_fn``'s batches with the audio stub's ones replaced by
    seeded normal frames, the same at every step.  On ones every encoder
    layer's input is a constant row, each LayerNorm divides by sqrt(eps),
    and from 8 encoder layers on the first step's gradients are NaN, in the
    reference as in the port (ROADMAP Queue 3)."""
    from repro_torch.launch.train import make_batch_fn

    fn = make_batch_fn(cfg, tc, device=dev)
    stub = _normal_stub_inputs(cfg, tc.batch_size, dev, SEED + 9)
    return lambda step: dict(fn(step), **stub)


def _normal_stub_inputs(cfg, batch, dev, seed) -> dict:
    """Seeded normal values of the shapes and dtype of the stub frontends'
    inputs (``img_embeds``, ``enc_frames``; none for other families)."""
    from repro_torch.data import stub_frontend_inputs

    gen = torch.Generator(device=dev).manual_seed(seed)
    return {k: torch.randn(v.shape, generator=gen, device=dev, dtype=v.dtype)
            for k, v in stub_frontend_inputs(cfg, batch, dev).items()}


def _open_gates(params, value=0.5) -> None:
    """Set every image layer's ``gate`` (zeros at init: the layer then adds
    exactly 0 and its projections get no gradient) to ``value``, in place."""
    from repro_torch.param import flatten

    with torch.no_grad():
        for k, v in flatten(params).items():
            if k.endswith("/gate"):
                v.fill_(value)


def cross_decode_phase(dev, cfg, T, tag, batch=1) -> None:
    """Prefill ``T`` tokens, then decode token T + 1 from the dense caches
    (self K/V, the cross K/V the prefill projected, the Mamba state) against
    one forward over all T + 1 tokens, f32: the prefill's last logits and
    the decode step's within 1e-4 of max(1, max |logit|), phase 21's
    tolerance (on an H100, Llama-3.2-Vision's cut at d 4096 parts from its
    forward by 4.5e-5 of its largest logit in f32 rounding).  The image
    embeddings and encoder frames are seeded random values (ones would make
    every cross-attention row uniform), every gate is 0.5, and an MoE
    config's capacity factor is raised to n_experts / top_k so that no
    routing drops at any length (the forward and the decode step then route
    alike).  Flash runs on the forward and the prefill as ``_flash_layers``
    derives; paged decode never."""
    from repro_torch.models import lm as lm_lib
    from repro_torch.models.api import build_model, make_prefill_step, make_serve_step
    from repro_torch.param import tree_map, zeros_tree

    if cfg.n_experts:
        cfg = cfg.replace(capacity_factor=cfg.n_experts / cfg.moe_top_k)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(SEED + 6))
    _open_gates(params)
    extras = _normal_stub_inputs(cfg, batch, dev, SEED + 7)
    toks = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, size=(batch, T + 1))).to(dev)
    torch.cuda.synchronize(dev)
    _reset_counters()
    t0 = time.time()
    with torch.inference_mode():
        want = model.forward_logits(params, dict(tokens=toks, **extras))
        last, caches = make_prefill_step(model)(params, toks[:, :T], **extras)
        dense = zeros_tree(lm_lib.cache_specs(cfg, batch, T + 1), cfg.compute_dtype, dev)
        tree_map(lambda c, p: (c if c.shape == p.shape else c[:, :, :T]).copy_(p), dense,
                 caches)
        kinds = sorted({k for st in dense.values() for b in st.values() for k in b})
        del caches
        got, _ = make_serve_step(model)(params, dense, toks[:, T:],
                                        torch.full((batch,), T, dtype=torch.long, device=dev))
    torch.cuda.synchronize(dev)
    counts = _launches()
    scale = TOL[torch.float32] * max(1.0, want.abs().max().item())
    errs = {"prefill": (last - want[:, T - 1]).abs().max().item(),
            "decode": (got - want[:, T]).abs().max().item()}
    flash = _flash_layers(cfg, T + 1, train=False) + _flash_layers(cfg, T, train=False)
    log(f"[{tag}] prefill {T} tokens x {batch}, then decode token {T + 1} from the caches "
        f"({', '.join(kinds)}): max |logit err| against the forward {errs}, tolerance "
        f"{scale:.3e}; {time.time() - t0:.2f}s; launches {counts}")
    check(all(e <= scale for e in errs.values()),
          f"{tag}: decode from the caches disagrees with the forward: {errs}")
    check(counts["flash_attention_fwd"] == flash and flash > 0
          and not counts["paged_attention_decode"],
          f"{tag} launches {counts}: want flash {flash} (forward, prefill), paged 0")


# ---------------------------------------------------------------------------
# phase 5: kernel times


def time_ms(fn, dev, iters=20, warmup=3) -> float:
    """Mean device time of ``fn`` over ``iters`` launches, with a 128 MB
    write between launches so each one finds its inputs out of L2 (50 MB),
    as it does on the serving path where other layers run in between.  A
    spin of ~2 ms on the device after that write keeps it busy while the
    host runs ``fn``: the first event then waits for no host work, so the
    reading is device time alone, without a wrapper's Python overhead."""
    flush = torch.empty(32 * 2**20, dtype=torch.float32, device=dev)
    for _ in range(warmup):
        fn()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / iters


def timing_phase(dev, decode_inputs, draft_inputs, S=1536):
    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    B, H, KH, D, dt = 1, 32, 4, 64, torch.bfloat16
    q = _randn((B, S, H, D), dt, dev, gen)
    k = _randn((B, S, KH, D), dt, dev, gen)
    v = _randn((B, S, KH, D), dt, dev, gen)
    out, _ = fa.flash_attention_cuda(q, k, v, causal=True)
    want, _ = fa.flash_attention_torch(q, k, v, causal=True)
    flash_err = (out.float() - want.float()).abs().max().item()
    qh, kh, vh = (q.transpose(1, 2).contiguous(),
                  k.transpose(1, 2).repeat_interleave(H // KH, 1).contiguous(),
                  v.transpose(1, 2).repeat_interleave(H // KH, 1).contiguous())
    flash = {
        "ms": time_ms(lambda: fa.flash_attention_cuda(q, k, v, causal=True), dev),
        "plain_ms": time_ms(lambda: fa.flash_attention_torch(q, k, v, causal=True), dev),
        "library_ms": time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qh, kh, vh, is_causal=True), dev),
    }
    flops, nbytes = fa.flash_fwd_cost(B, S, S, H, KH, D, D, causal=True)
    flash_bound, flash_by = _bound(flops, nbytes, PEAK_BF16_FLOPS)

    # the decode tick halfway through phase 4, with fresh random K/V, then
    # the long shapes: one sequence at 2047 positions, eight at 2048
    tables, lengths = decode_inputs[len(decode_inputs) // 2]
    G, P, N = H // KH, 16, 8 * 128 + 1
    qd = _randn((tables.shape[0], KH, G, D), dt, dev, gen)
    kp = _randn((N, P, KH, D), dt, dev, gen)
    vp = _randn((N, P, KH, D), dt, dev, gen)
    paged = paged_timing(dev, qd, kp, vp, tables.to(dev), tables.to(dev), lengths.to(dev))
    paged["long_shapes"] = [paged_timing(dev, *paged_inputs(dev, dt, n, gen))
                            for n in ([2047], [2048] * 8)]
    # the speculative draft's middle decode tick (KH 2; its own pool)
    tables, lengths = draft_inputs[len(draft_inputs) // 2]
    qd = _randn((tables.shape[0], 2, G, D), dt, dev, gen)
    kp, vp = (_randn((N, P, 2, D), dt, dev, gen) for _ in range(2))
    paged["draft_shape"] = paged_timing(dev, qd, kp, vp, tables.to(dev), tables.to(dev),
                                        lengths.to(dev))
    # the narrow body at phase 42's serving shape: the reduced TinyLlama (KH 2,
    # G 2, D 16), four sequences of ~20 positions in pages of 16
    paged["narrow_shape"] = paged_timing(dev, *paged_inputs(dev, dt, [24, 19, 30, 17], gen,
                                                            KH=2, G=2, D=16, M=6))
    log(f"[timing] flash B=1 S=T={S} H=32 KH=4 D=64 bf16 causal: {flash}, "
        f"bound {flash_bound:.4f} ms ({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB)")
    check(flash_err <= TOL[dt], f"flash kernel disagrees at the timing shape: {flash_err}")
    src = "src/repro_torch/csrc/"
    return [
        {"name": "flash_attention_fwd", "route": "cuda",
         "source": src + "flash_attention_fwd.cu",
         "replaces": "src/repro/kernels/flash_attention.py:88",
         "tpu_source": "src/repro/kernels/flash_attention.py:88 _fwd_call (_flash_kernel :35)",
         "max_abs_err": flash_err, "max_err": flash_err,
         "ms": flash["ms"], "plain_ms": flash["plain_ms"], "bound_ms": flash_bound,
         "bound_by": flash_by, "library_ms": flash["library_ms"]},
        dict({"name": "paged_attention_decode", "route": "cuda",
              "source": src + "paged_attention_decode.cu",
              "replaces": "src/repro/kernels/paged_attention.py:113",
              "tpu_source": "src/repro/kernels/paged_attention.py:113 paged_attention_decode "
                            "(_paged_decode_kernel :38)",
              "max_err": paged["max_abs_err"]}, **paged),
    ]


def paged_timing(dev, q, k_pages, v_pages, tables, kernel_tables, lengths) -> dict:
    """Paged decode's device time at one shape, held to its plain version
    (the kernel reads ``kernel_tables``, the plain version ``tables``: they
    differ only past each row's pages), beside its plain version's time and
    its bound: K/V rows up to each length, q and out, the table entries of
    the pages in use and the lengths, each read or written once, at the
    tables' index width; 4 G D flops per position and kv head."""
    from repro_torch.kernels import paged_attention as pa

    got = pa.paged_attention_decode_cuda(q, k_pages, v_pages, kernel_tables, lengths)
    want = pa.paged_attention_decode_torch(q, k_pages, v_pages, tables, lengths)
    err = (got.float() - want.float()).abs().max().item()
    B, KH, G, D = q.shape
    P, M = k_pages.shape[1], tables.shape[1]
    ln = lengths.clamp(0, M * P).cpu()
    flops, nbytes = pa.paged_attention_decode_cost(
        B, KH, G, D, P, M, ln.tolist(), itemsize=q.element_size(),
        table_itemsize=tables.element_size(), length_itemsize=lengths.element_size())
    bound = _bound(flops, nbytes, PEAK_BF16_FLOPS)
    res = {
        "shape": f"B={B} KH={KH} G={G} D={D} P={P} M={M} lengths={ln.tolist()} "
                 f"{str(q.dtype)[6:]} {str(tables.dtype)[6:]} tables",
        "max_abs_err": err,
        "ms": time_ms(lambda: pa.paged_attention_decode_cuda(q, k_pages, v_pages,
                                                             kernel_tables, lengths), dev),
        "plain_ms": time_ms(lambda: pa.paged_attention_decode_torch(q, k_pages, v_pages,
                                                                    tables, lengths), dev),
        "bound_ms": bound[0], "bound_by": bound[1], "library_ms": None,
    }
    log(f"[timing] paged {res['shape']}: {res}, {nbytes / 1e6:.2f} MB, "
        f"{bound[0] / res['ms']:.1%} of the bound")
    check(torch.isfinite(got).all().item() and err <= TOL[q.dtype],
          f"paged kernel disagrees at the timing shape {res['shape']}: {err}")
    return res


def _bound(flops: float, nbytes: float, peak_flops: float):
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def _library_bwd_ms(dev, qh, kh, vh, doh, causal=True, bias=None) -> tuple:
    """(ms, op, by_op) of PyTorch's backward ops that compute dq, dk, dv
    from a saved forward in one call: the flash-attention op, cuDNN's and
    the memory-efficient attention's, each timed where it takes the shapes
    (the flash op refuses a value head dim other than the query/key one,
    and an additive ``bias``, which a causal mask at an offset needs).
    ``ms`` and ``op`` are the fastest; ``by_op`` maps every op to its time,
    or to its refusal."""
    aten, by_op = torch.ops.aten, {}
    if bias is not None:
        causal = False

    def flash():
        if bias is not None:
            raise RuntimeError("the flash op takes no additive bias")
        o, lse, cq, ck, mq, mk, seed, offset, _ = aten._scaled_dot_product_flash_attention(
            qh, kh, vh, 0.0, causal)
        return lambda: aten._scaled_dot_product_flash_attention_backward(
            doh, qh, kh, vh, o, lse, cq, ck, mq, mk, 0.0, causal, seed, offset)

    def cudnn():
        o, lse, cq, ck, mq, mk, seed, offset, _ = aten._scaled_dot_product_cudnn_attention(
            qh, kh, vh, bias, True, 0.0, causal)
        return lambda: aten._scaled_dot_product_cudnn_attention_backward(
            doh, qh, kh, vh, o, lse, seed, offset, bias, cq, ck, mq, mk, 0.0, causal)

    def efficient():
        o, lse, seed, offset = aten._scaled_dot_product_efficient_attention(
            qh, kh, vh, bias, True, 0.0, causal)
        return lambda: aten._scaled_dot_product_efficient_attention_backward(
            doh, qh, kh, vh, bias, o, lse, seed, offset, 0.0, [True, True, True, False],
            causal)

    for name, make in (("_scaled_dot_product_flash_attention_backward", flash),
                       ("_scaled_dot_product_cudnn_attention_backward", cudnn),
                       ("_scaled_dot_product_efficient_attention_backward", efficient)):
        try:
            by_op[name] = time_ms(make(), dev)
        except (RuntimeError, TypeError, ValueError) as e:
            by_op[name] = f"refused: {str(e).splitlines()[0]}"
    timed = {k: v for k, v in by_op.items() if isinstance(v, float)}
    if not timed:
        return None, "; ".join(by_op.values()), by_op
    best = min(timed, key=timed.get)
    return timed[best], best, by_op


def flash_train_timing(dev, gen, B, S, H, KH, D, Dv=None, T=None, causal=True,
                       q_offset=0) -> dict:
    """One bf16 training layer's flash kernels (q [B, S, H, D], k [B, T,
    KH, D], v [B, T, KH, Dv]; Dv = D and T = S unless given; causal unless
    told not, at ``q_offset``): the forward, dq and dk/dv held to their
    plain versions and timed beside their bounds, the plain versions and
    library yardsticks (SDPA; one PyTorch backward op computing dq, dk, dv
    from the same saved forward, ``_library_bwd_ms``; both with K/V
    expanded to H heads).  A context-parallel chunk (``q_offset = T - S``)
    is the library's lower-right causal mask: SDPA takes
    ``causal_lower_right``, the backward ops an additive bias of it.
    Returns kernel name -> its entry at this shape."""
    from repro_torch.kernels import flash_attention as fa

    F = torch.nn.functional
    dt = torch.bfloat16
    Dv, T = Dv or D, T or S
    qo = dict(q_offset=q_offset)
    shape = (f"B={B} S={S} T={T} H={H} KH={KH} D={D} Dv={Dv} bf16 "
             f"{'causal' if causal else 'non-causal'}"
             + (f" q_offset={q_offset}" if q_offset else ""))
    q = _randn((B, S, H, D), dt, dev, gen)
    do = _randn((B, S, H, Dv), dt, dev, gen)
    k, v = _randn((B, T, KH, D), dt, dev, gen), _randn((B, T, KH, Dv), dt, dev, gen)
    fwd_err, lse_err = _flash_fwd_err(dev, gen, B, S, T, H, KH, causal, dt, qkv=(q, k, v),
                                      D=D, **qo)
    out, lse = fa.flash_attention_cuda(q, k, v, causal=causal, **qo)
    dq, delta = fa.flash_attention_bwd_dq_cuda(q, k, v, out, lse, do, causal=causal, **qo)
    dk, dv = fa.flash_attention_bwd_dkv_cuda(q, k, v, do, lse, delta, causal=causal, **qo)
    wq, wk, wv = fa.flash_attention_bwd_torch(q, k, v, out, lse, do, causal=causal, **qo)
    dq_err = (dq.float() - wq.float()).abs().max().item()
    dkv_err = max((dk.float() - wk.float()).abs().max().item(),
                  (dv.float() - wv.float()).abs().max().item())
    log(f"[timing] flash {shape}: forward max|out err|={fwd_err:.3e} max|lse err|="
        f"{lse_err:.3e}; backward max|dq err|={dq_err:.3e} max|dk, dv err|={dkv_err:.3e}")
    check(max(_scaled_err(dq, wq), _scaled_err(dk, wk), _scaled_err(dv, wv)) <= TOL[dt],
          f"flash backward disagrees at {shape}: {dq_err}, {dkv_err}")
    qh, doh = q.transpose(1, 2).contiguous(), do.transpose(1, 2).contiguous()
    kh, vh = (t.transpose(1, 2).repeat_interleave(H // KH, 1).contiguous() for t in (k, v))
    sdpa = dict(is_causal=causal)
    bias = None
    if causal and q_offset:
        from torch.nn.attention.bias import causal_lower_right

        check(q_offset == T - S, "the library's lower-right mask is the offset T - S only")
        sdpa = dict(attn_mask=causal_lower_right(S, T))
        bias = torch.zeros((S, T), dtype=dt, device=dev).masked_fill(
            torch.ones((S, T), dtype=torch.bool, device=dev).triu(q_offset + 1),
            float("-inf")).expand(B, H, S, T)
    lib_bwd, lib_op, lib_ops = _library_bwd_ms(dev, qh, kh, vh, doh, causal, bias=bias)
    qg, kg, vg = (t.requires_grad_() for t in (qh.clone(), kh.clone(), vh.clone()))

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(qg, kg, vg, **sdpa)
        torch.autograd.grad(o, (qg, kg, vg), doh)

    sdpa_bwd = (time_ms(sdpa_fwd_bwd, dev)
                - time_ms(lambda: F.scaled_dot_product_attention(qg, kg, vg, **sdpa), dev))
    plain_bwd = time_ms(lambda: fa.flash_attention_bwd_torch(q, k, v, out, lse, do,
                                                            causal=causal, **qo), dev)
    # the kernels' own counts (kernels/flash_attention.py's *_cost): the
    # (query, key) pairs on and below a causal diagonal at q_offset
    dims, kw = (B, S, T, H, KH, D, Dv), dict(causal=causal, q_offset=q_offset)
    pairs = fa.attention_pairs(B, S, T, H, causal, q_offset)
    fwd_b = _bound(*fa.flash_fwd_cost(*dims, **kw), PEAK_BF16_FLOPS)
    dq_b = _bound(*fa.flash_bwd_dq_cost(*dims, **kw), PEAK_BF16_FLOPS)
    dkv_b = _bound(*fa.flash_bwd_dkv_cost(*dims, **kw), PEAK_BF16_FLOPS)
    res = {
        "flash_attention_fwd": {
            "shape": shape, "max_abs_err": fwd_err, "lse_err": lse_err,
            "ms": time_ms(lambda: fa.flash_attention_cuda(q, k, v, causal=causal, **qo), dev),
            "plain_ms": time_ms(lambda: fa.flash_attention_torch(q, k, v, causal=causal,
                                                                 **qo), dev),
            "bound_ms": fwd_b[0], "bound_by": fwd_b[1],
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                qh, kh, vh, **sdpa), dev)},
        "flash_attention_bwd_dq": {
            "shape": shape, "max_abs_err": dq_err,
            "ms": time_ms(lambda: fa.flash_attention_bwd_dq_cuda(q, k, v, out, lse, do,
                                                                 causal=causal, **qo), dev),
            "plain_ms": plain_bwd, "bound_ms": dq_b[0], "bound_by": dq_b[1],
            "library_ms": lib_bwd, "library_op": lib_op, "library_ops": lib_ops,
            "sdpa_autograd_bwd_ms": sdpa_bwd},
        "flash_attention_bwd_dkv": {
            "shape": shape, "max_abs_err": dkv_err,
            "ms": time_ms(lambda: fa.flash_attention_bwd_dkv_cuda(q, k, v, do, lse, delta,
                                                                  causal=causal, **qo), dev),
            "plain_ms": plain_bwd, "bound_ms": dkv_b[0], "bound_by": dkv_b[1],
            "library_ms": lib_bwd, "library_op": lib_op, "library_ops": lib_ops,
            "sdpa_autograd_bwd_ms": sdpa_bwd},
    }
    res["flash_attention_bwd_dkv"]["dq_plus_dkv_ms"] = (
        res["flash_attention_bwd_dq"]["ms"] + res["flash_attention_bwd_dkv"]["ms"])
    log(f"[timing] flash {shape}: {res}; the backward ops one call each: {lib_ops} (the "
        f"fastest, {lib_op}, is library_ms); SDPA fwd+bwd minus fwd through autograd "
        f"{sdpa_bwd:.4f} ms ({2 * (2 * D + Dv) * pairs / 1e9:.1f} + "
        f"{4 * (D + Dv) * pairs / 1e9:.1f} GFLOP done by dq and dk/dv, "
        f"{2 * (3 * D + 2 * Dv) * pairs / 1e9:.1f} needed by one fused backward)")
    return res


def train_timing_phase(dev):
    """The training kernels at phase 7's shapes: the flash forward and
    backward of one layer (B = 8, S = T = 1024, D = 64, causal, bf16) held to
    their plain versions at level 1 (H = KH = 6) and timed at level 0 (H = KH
    = 12); coalesce_pair / interp_axpy on the embedding, the largest leaf
    (f32).  Returns the kernel entries and the forward's numbers at this
    shape (its second shape)."""
    from repro_torch.kernels import coalesce_pair as cp
    from repro_torch.kernels import interp_axpy as ia

    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    B, S, D, dt = 8, 1024, 64, torch.bfloat16
    flash_train_timing(dev, gen, B, S, 6, 6, D)  # level 1: held (and timed, unreported)
    flash = flash_train_timing(dev, gen, B, S, 12, 12, D)  # level 0
    fwd_train = flash["flash_attention_fwd"]
    dq, dkv = flash["flash_attention_bwd_dq"], flash["flash_attention_bwd_dkv"]
    w = _randn((768, 50304), torch.float32, dev, gen)  # embed/tok folded on its embed axis
    half = w.shape[0] // 2
    cp_err = (cp.coalesce_pair_cuda(w, axis=0) - cp.coalesce_pair_torch(w, axis=0)
              ).abs().max().item()
    pair = {"ms": time_ms(lambda: cp.coalesce_pair_cuda(w, axis=0, w0=0.5), dev),
            "plain_ms": time_ms(lambda: cp.coalesce_pair_torch(w, axis=0, w0=0.5), dev),
            "library_ms": time_ms(lambda: torch.mean(w.view(2, half, -1), 0), dev)}
    pair_bound = _bound(*cp.coalesce_pair_cost(w.shape, 0, w.element_size()), PEAK_F32_FLOPS)
    a, b = (_randn((50304, 768), torch.float32, dev, gen) for _ in range(2))
    ia_err = (ia.interp_axpy_cuda(a, b, 0.25) - ia.interp_axpy_torch(a, b, 0.25)
              ).abs().max().item()
    axpy = {"ms": time_ms(lambda: ia.interp_axpy_cuda(a, b, 0.25), dev),
            "plain_ms": time_ms(lambda: ia.interp_axpy_torch(a, b, 0.25), dev),
            "library_ms": time_ms(lambda: torch.lerp(a, b, 0.25), dev)}
    axpy_bound = _bound(*ia.interp_axpy_cost(a.numel(), a.element_size()), PEAK_F32_FLOPS)
    log(f"[timing] coalesce_pair [768, 50304] f32 axis 0 w0 0.5: {pair}, bound {pair_bound}")
    log(f"[timing] interp_axpy [50304, 768] f32 alpha 0.25: {axpy}, bound {axpy_bound}")
    check(cp_err == 0.0 and ia_err == 0.0,
          f"elementwise kernels differ at the timing shapes: {cp_err}, {ia_err}")
    src = "src/repro_torch/csrc/"
    return [
        dict({"name": "flash_attention_bwd_dq", "route": "cuda",
              "source": src + "flash_attention_bwd.cu",
              "replaces": "src/repro/kernels/flash_attention.py:249",
              "tpu_source": "src/repro/kernels/flash_attention.py:249 _bwd_call "
                            "(_bwd_dq_kernel :149)"}, **dq),
        dict({"name": "flash_attention_bwd_dkv", "route": "cuda",
              "source": src + "flash_attention_bwd.cu",
              "replaces": "src/repro/kernels/flash_attention.py:266",
              "tpu_source": "src/repro/kernels/flash_attention.py:266 _bwd_call "
                            "(_bwd_dkv_kernel :188)"}, **dkv),
        {"name": "coalesce_pair", "route": "cuda", "source": src + "coalesce_pair.cu",
         "replaces": "src/repro/kernels/coalesce_pair.py:71",
         "tpu_source": "src/repro/kernels/coalesce_pair.py:71 coalesce_pair (_pair_kernel :24)",
         "max_abs_err": cp_err, "ms": pair["ms"], "plain_ms": pair["plain_ms"],
         "bound_ms": pair_bound[0], "bound_by": pair_bound[1],
         "library_ms": pair["library_ms"]},
        {"name": "interp_axpy", "route": "cuda", "source": src + "interp_axpy.cu",
         "replaces": "src/repro/kernels/interp_axpy.py:36",
         "tpu_source": "src/repro/kernels/interp_axpy.py:36 interp_axpy (_axpy_kernel :17)",
         "max_abs_err": ia_err, "ms": axpy["ms"], "plain_ms": axpy["plain_ms"],
         "bound_ms": axpy_bound[0], "bound_by": axpy_bound[1],
         "library_ms": axpy["library_ms"]},
    ], fwd_train


def moe_timing_phase(dev, moe_decode_inputs) -> dict:
    """The kernels at Phi-3.5-MoE's shapes (GQA 32/8, D 128, bf16): the
    flash forward, dq and dk/dv of one training layer (B 4, S = T 1024,
    causal) through ``flash_train_timing``, and paged decode at phase 15's
    middle tick.  Returns kernel name -> its entry at these shapes."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    H, KH, D = 32, 8, 128
    res = flash_train_timing(dev, gen, 4, 1024, H, KH, D)
    tables, lengths = moe_decode_inputs[len(moe_decode_inputs) // 2]
    G, P, N = H // KH, 16, 8 * 128 + 1
    qd = _randn((tables.shape[0], KH, G, D), torch.bfloat16, dev, gen)
    kp, vp = (_randn((N, P, KH, D), torch.bfloat16, dev, gen) for _ in range(2))
    res["paged_attention_decode"] = paged_timing(dev, qd, kp, vp, tables.to(dev),
                                                 tables.to(dev), lengths.to(dev))
    return res


def cross_timing_phase(dev) -> tuple:
    """The flash kernels at the cross-attention families' training layers
    (non-causal, S != T, bf16): Whisper's decoder over its 1500 frames (S
    448, MHA 20/20, D 64) and the VLM's image layer over 1601 image tokens
    (S 1024, GQA 32/8, D 128), through ``flash_train_timing``."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    return (flash_train_timing(dev, gen, 1, 448, 20, 20, 64, T=1500, causal=False),
            flash_train_timing(dev, gen, 1, 1024, 32, 8, 128, T=1601, causal=False))


# the phase-4 traffic: prompt lengths, and the (first, second) pairs whose
# prompts share a 256-token prefix (the second is served by the extend step)
BF16_LENGTHS = [40, 1536, 777, 900, 513, 1031, 130, 600,
                400, 1300, 1100, 257, 64, 1234, 90, 700]
BF16_SHARED = ((2, 3), (8, 9))
F32_LENGTHS = [530, 600, 777, 1000, 100, 300, 513, 64]
# phase 12: the trainer's command (GPT-Base's V-cycle at the launcher's defaults) and the
# server's prompt lengths, all past attn_block_k = 512 (the flash prefill)
# phase 33: the largest gap of "full" and "dots" to "none" allowed in the first
# step's AdamW first moments (each leaf's, over its largest |value|) and in the
# second step's loss.  None: on the H100 both were bit-equal to "none"'s (every
# kernel of the step is deterministic, and the recompute replays the forward's
# launches on the same inputs)
REMAT_TOL = {"moments": 0.0, "loss": 0.0}


def remat_phase(dev, cfg, tc) -> dict:
    """Phase 33: two level-0 train steps of ``cfg`` (GPT-Base, bf16 over
    f32 weights, 8 x 1024) under each remat setting, each from the same
    fresh weights and batch.  The first step's losses must be equal (the
    forward is the same); the backward is held to "none"'s through the
    first step's AdamW first moments ((1 - beta1) x the gradients) and the
    second step's loss (after the first update), within ``REMAT_TOL``; the
    peaks ordered full <= dots <= none, and the flash launches as
    ``_step_launches`` implies (the forward twice per layer under "full" and
    "dots").  Prints each first step's loss and peak, the wall of the second
    step (the first pays one-time costs: 5.7 s under "full" when it ran
    first) and the gaps.  Returns the launches of both steps per setting
    (paths ``remat_<setting>``)."""
    from repro_torch.launch.train import make_batch_fn
    from repro_torch.models.api import build_model, make_train_step
    from repro_torch.optim import adamw_init
    from repro_torch.param import flatten

    batch = make_batch_fn(cfg, tc, device=dev)(0)
    got, paths, moments = {}, {}, {}
    for mode in ("none", "full", "dots"):
        c = cfg.replace(remat=mode)
        model = build_model(c)
        params = model.init(torch.Generator(device=dev).manual_seed(SEED))
        opt = adamw_init(params, tc)
        step = make_train_step(model, tc)
        _free()
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        _reset_counters()
        params, opt, m = step(params, opt, batch)
        loss = m["loss"].item()
        peak = torch.cuda.max_memory_allocated(dev)
        moments[mode] = {k: v.detach().cpu() for k, v in flatten(opt["m"]).items()}
        t = time.time()  # a second step, timed: the first pays one-time imports
        params, opt, m = step(params, opt, batch)
        got[mode] = (loss, time.time() - t, peak, m["loss"].item())
        paths[f"remat_{mode}"] = _launches()
        want = dict({k: 0 for k in _wrappers()}, **_step_launches(c, tc, 2))
        check(paths[f"remat_{mode}"] == want,
              f"remat {mode}: launches {paths[f'remat_{mode}']} != structure {want}")
        del model, params, opt, step, m
    log(f"[remat] {cfg.name} level 0, {tc.batch_size} x {tc.seq_len} (mode: first step's "
        f"loss, second step's ms, first step's peak max_memory_allocated GiB): " + ", ".join(
            f"{k}: {l:.6f}, {d * 1e3:.1f}, {pk / 2**30:.2f}" for k, (l, d, pk, _) in got.items()))
    check(got["none"][0] == got["full"][0] == got["dots"][0],
          f"the losses differ across remat settings: {got}")
    for mode in ("full", "dots"):
        m_gap = max(((moments[mode][k] - v).abs().max()
                     / v.abs().max().clamp_min(1e-30)).item()
                    for k, v in moments["none"].items())
        l_gap = abs(got[mode][3] - got["none"][3])
        log(f"[remat] {mode} vs none: first moments {m_gap:.3e} of each leaf's largest "
            f"(tolerance {REMAT_TOL['moments']}), second step's loss {got[mode][3]:.6f} vs "
            f"{got['none'][3]:.6f}, gap {l_gap:.3e} (tolerance {REMAT_TOL['loss']})")
        check(m_gap <= REMAT_TOL["moments"] and l_gap <= REMAT_TOL["loss"],
              f"remat {mode}: the backward differs from none's ({m_gap}, {l_gap})")
    del moments
    check(got["full"][2] <= got["dots"][2] <= got["none"][2],
          f"peaks not ordered full <= dots <= none: {got}")
    _free()
    return paths


@contextlib.contextmanager
def _timed_reduce(dev, record):
    """Times every gradient reduction (device-synchronized, ms) into
    ``record["reduce_ms"]``, notes each level's analytic wire bytes and,
    for int8_ef, each call's EF norm."""
    from repro_torch.distributed import reduce as R

    saved = {cls: cls.reduce for cls in (R.DenseReduce, R.HierarchicalInt8EF)}
    record.setdefault("reduce_ms", [])
    record.setdefault("wire_bytes", [])
    record.setdefault("ef_norm", [])

    def wrap(cls, orig):
        def reduce(self, grads, ef):
            torch.cuda.synchronize(dev)
            t = time.time()
            out, new_ef = orig(self, grads, ef)
            torch.cuda.synchronize(dev)
            record["reduce_ms"].append((time.time() - t) * 1e3)
            wb = self.wire_bytes(grads)
            if wb not in record["wire_bytes"]:
                record["wire_bytes"].append(wb)
            if new_ef is not None:
                from repro_torch.param import flatten

                record["ef_norm"].append(math.sqrt(sum(
                    float(e.double().square().sum()) for e in flatten(new_ef).values())))
            return out, new_ef

        return reduce

    for cls, orig in saved.items():
        cls.reduce = wrap(cls, orig)
    try:
        yield record
    finally:
        for cls, orig in saved.items():
            cls.reduce = orig


def _dp_setup():
    """(config, MultiLevelConfig, TrainConfig) of phases 34-35: GPT-Base at
    full width cut to 4 of its 12 layers, Table 2's ratio at 2 steps (1 + 1
    + 2; it took 4 steps, 1 + 2 + 4, before they were cut for the script's
    time), global batch 8 x 1024 (4 x 1024 on each of two processes)."""
    _, _, tc = train_setup("gpt-base")
    cfg = _paper("gpt-base", 4)
    from repro_torch.config import MultiLevelConfig

    ml = MultiLevelConfig(n_levels=2, alpha=0.25, e_a_frac=0.1, e_small_frac=0.5)
    return cfg, ml, dataclasses.replace(tc, steps=2)


def _dp_run(dev, mesh, cfg, ml, tc, keep=None) -> dict:
    """One launcher V-cycle (``train_vcycle_ckpt``) on ``mesh``: its launches,
    losses, wall, reduction record and a digest of the final parameters
    (gathered whole from the ranks' FSDP blocks); ``keep[0]`` receives them
    on the host (flat) when given."""
    import hashlib

    from repro_torch.distributed import compression as C
    from repro_torch.distributed import gather_global_tree
    from repro_torch.launch import train as T
    from repro_torch.models.api import build_model, train_state_shardings
    from repro_torch.param import flatten

    record = {}
    C.reset_ef_psum_probe()
    torch.cuda.synchronize(dev)
    _reset_counters()
    t = time.time()
    with _timed_reduce(dev, record):
        out = T.train_vcycle_ckpt(cfg, ml, tc, ckpt=None, ckpt_every=0, verbose=False,
                                  device=dev, mesh=mesh)
    torch.cuda.synchronize(dev)
    record.update(wall=time.time() - t, launches=_launches(), loss=out.history.loss,
                  ef_calls=C.ef_psum_calls())
    whole = gather_global_tree(out.params, train_state_shardings(build_model(cfg), tc,
                                                                 mesh)[0], mesh)
    h = hashlib.blake2b(digest_size=16)
    for k, v in flatten(whole).items():
        h.update(k.encode())
        h.update(v.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes())
    record["digest"] = h.hexdigest()
    record["finite"] = all(bool(torch.isfinite(v).all()) for v in flatten(whole).values())
    if keep is not None:
        keep.append({k: v.detach().cpu() for k, v in flatten(whole).items()})
    del out, whole
    _free()
    return record


def _dp_checks(tag, rec, want, steps, tc) -> None:
    rms = rec["reduce_ms"]
    log(f"[{tag}] {steps} steps in {rec['wall']:.2f}s wall; losses first {rec['loss'][0]:.4f} "
        f"last {rec['loss'][-1]:.4f}; reduce per step mean {np.mean(rms):.2f} ms (level 0 "
        f"{np.mean(rms[:1] + rms[-tc.steps:]):.2f} ms), wire bytes per step by level "
        f"{rec['wire_bytes']}; EF norm per call first {rec['ef_norm'][:1]} last "
        f"{rec['ef_norm'][-1:]}; ef_int8_psum calls {rec['ef_calls']}; launches "
        f"{rec['launches']}, expected {want}")
    check(rec["launches"] == want, f"{tag}: launches {rec['launches']} != structure {want}")
    check(len(rms) == steps, f"{tag}: {len(rms)} reductions for {steps} steps")
    check(rec["finite"] and all(np.isfinite(rec["loss"])), f"{tag}: non-finite values")
    check(rec["loss"][-1] < rec["loss"][0], f"{tag}: the last loss is not below the first")


DP_COMPS = ("dense", "int8_ef")
# phase 35: the largest gap allowed between a 2-process run and phase 34's
# 1-process run of the same reduction, in the losses and in the final
# parameters, 2.4-3.4x the gaps read on the H100 at 4 steps, 1 + 2 + 4 (they
# repeat bit for bit between runs): dense 8.77e-5 and 1.99e-3 (bf16 products over 4096 rows, not
# 8192, and the f32 sum of two halves; AdamW turns a flipped gradient sign into
# a parameter step of the order of the learning rate), int8_ef 4.24e-3 and
# 2.01e-3 (each half quantized on its own)
DP_TOL = {"dense": {"loss": 3e-4, "params": 5e-3}, "int8_ef": {"loss": 1e-2, "params": 5e-3}}


def mesh_vcycle_phase(dev, cfg, ml, tc) -> dict:
    """Phase 34: the launcher's V-cycle as ``--mesh 1x1 --grad-compression
    C`` gives it (``make_cli_mesh`` on a one-rank NCCL group, the 4-ary
    step), C dense and then int8_ef (``ef_int8_psum`` in every step):
    launches as the schedule implies, one ``ef_int8_psum`` call a step under
    int8_ef, a falling loss; the reduction's wall per step, wire bytes and
    EF norms printed.  Returns the records by C, each with its final
    parameters on the host (``params``), which phase 35 holds its runs
    against."""
    import torch.distributed as dist

    from repro_torch.core.vcycle import VCycleRunner
    from repro_torch.launch.mesh import make_cli_mesh

    runner = VCycleRunner(cfg, ml, tc, None, device=dev)
    steps = sum(sg.steps for sg in runner.plan)
    recs = {}
    mesh = make_cli_mesh("1x1", num_processes=1, device=dev)
    try:
        check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
              f"backend {dist.get_backend()} at world {dist.get_world_size()}")
        for comp in DP_COMPS:
            keep = []
            recs[comp] = _dp_run(dev, mesh, cfg, ml,
                                 dataclasses.replace(tc, grad_compression=comp), keep)
            recs[comp]["params"] = keep[0]
    finally:
        dist.destroy_process_group()
    for comp, rec in recs.items():
        _dp_checks(f"mesh-1x1-{comp}", rec, _schedule_launches(runner, tc), steps, tc)
        want = steps if comp == "int8_ef" else 0
        check(rec["ef_calls"] == want, f"{comp}: {rec['ef_calls']} ef_int8_psum calls")
    return recs


def dp_worker(rank: int, world: int, coordinator: str, out_dir: str, after: str) -> int:
    """One rank of phase 35 (``chip_smoke.py --dp-rank R ...``), started
    early (:func:`start_dp`): it loads the kernels, warms up, waits for
    ``after``, then joins the group as the launcher does
    (``init_distributed``, ``make_cli_mesh`` of ``{world}x1``), runs the
    dense and the int8_ef V-cycles and writes its records to
    ``out_dir/rank{R}.json``."""
    from repro_torch.kernels.build import load_library
    from repro_torch.launch.mesh import init_distributed, make_cli_mesh, rank_device

    import torch.distributed as dist

    dev = rank_device("cuda", rank)
    torch.cuda.set_device(dev)
    parent = os.getppid()
    load_library()
    _warm_train(dev)
    while not os.path.exists(after):
        check(os.getppid() == parent, "phase 35: the script that started this rank is gone")
        time.sleep(0.01)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    backend = init_distributed(coordinator, world, rank, device=dev, timeout_s=300)
    mesh = make_cli_mesh(f"{world}x1", num_processes=world, device=dev)
    cfg, ml, tc = _dp_setup()
    out = {"backend": backend, "device": str(dev)}
    try:
        for comp in DP_COMPS:
            keep = [] if rank == 0 else None
            out[comp] = _dp_run(dev, mesh, cfg, ml,
                                dataclasses.replace(tc, grad_compression=comp), keep)
            if keep:  # the ranks' digests are compared, so rank 0's values stand for both
                torch.save(keep[0], os.path.join(out_dir, f"params_{comp}.pt"))
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    return 0


def start_dp() -> dict:
    """Phase 35's two ranks, started now (before phase 33): each loads the
    kernels and warms up (``_warm_train``), then waits for :func:`dp_phase`
    to let it go, so neither pays its start-up inside the phase."""
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    after = os.path.join(out_dir, "go")
    env = dict(os.environ, PYTHONUNBUFFERED="1", OMP_NUM_THREADS="2")
    logs = [os.path.join(out_dir, f"rank{r}.log") for r in range(2)]
    procs = []
    for r in range(2):
        cmd = [sys.executable, os.path.abspath(__file__), "--dp-rank", str(r), "--dp-world",
               "2", "--dp-coordinator", f"file://{os.path.join(out_dir, 'coord')}", "--dp-out", out_dir,
               "--dp-after", after]
        with open(logs[r], "w") as lf:
            procs.append(subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=lf,
                                          stderr=subprocess.STDOUT))
    return {"root": out_dir, "after": after, "procs": procs, "logs": logs}


def dp_phase(dev, one_process, early, timeout=600) -> dict:
    """Phase 35: two processes share the card (``--mesh 2x1``: gloo with
    CUDA tensors, since NCCL refuses two ranks on one device), each running
    the launcher's V-cycle on its 4 x 1024 rows of phase 34's global batch,
    dense and int8_ef, on the FSDP layout (each rank its blocks, gathered
    whole for the digests); ``early`` is :func:`start_dp`'s pair.  Every
    rank exits 0 within ``timeout``; the ranks' final parameters are
    bit-identical (digests) and their losses equal; each rank's launches
    follow the schedule; losses fall; each run's losses and final
    parameters lie within ``DP_TOL`` of phase 34's one-process run of the
    same reduction (``one_process``).  Returns rank 0's launches per run
    (paths ``dp_dense``, ``dp_int8_ef``)."""
    from repro_torch.core.vcycle import VCycleRunner

    _free()
    out_dir, procs, logs = early["root"], early["procs"], early["logs"]
    with open(early["after"], "w"):
        pass
    t = time.time()
    try:
        deadline = time.time() + timeout
        for p in procs:
            try:
                p.wait(timeout=max(1.0, deadline - time.time()))
            except subprocess.TimeoutExpired:
                pass
        wall = time.time() - t
        for r, p in enumerate(procs):
            if p.poll() is None or p.returncode != 0:
                log(f"[dp] rank {r} output:\n{_read(logs[r])[-4000:]}")
            check(p.poll() is not None, f"rank {r} did not finish within {timeout}s")
            check(p.returncode == 0, f"rank {r} exited {p.returncode}")
        recs = []
        for r in range(2):
            with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                recs.append(json.load(f))
        gaps = {}
        for comp in DP_COMPS:
            got = torch.load(os.path.join(out_dir, f"params_{comp}.pt"))
            want = one_process[comp]["params"]
            check(got.keys() == want.keys(), f"{comp}: the parameter trees differ")
            gaps[comp] = {
                "loss": float(np.max(np.abs(np.asarray(recs[0][comp]["loss"])
                                            - np.asarray(one_process[comp]["loss"])))),
                "params": max((got[k] - v).abs().max().item() for k, v in want.items())}
            del got
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=60)
        shutil.rmtree(out_dir, ignore_errors=True)
    cfg, ml, tc = _dp_setup()
    runner = VCycleRunner(cfg, ml, tc, None, device=dev)
    steps = sum(sg.steps for sg in runner.plan)
    want = _schedule_launches(runner, tc)
    log(f"[dp] two processes on one card: backend {recs[0]['backend']}, devices "
        f"{[r['device'] for r in recs]}, {wall:.1f}s wall with start-up")
    check(all(r["backend"] == "gloo" for r in recs), "the shared card's backend is not gloo")
    paths = {}
    for comp in DP_COMPS:
        for r in range(2):
            _dp_checks(f"dp-2x1-{comp}-rank{r}", recs[r][comp], want, steps, tc)
        check(recs[0][comp]["digest"] == recs[1][comp]["digest"],
              f"{comp}: the ranks' parameters differ")
        check(recs[0][comp]["loss"] == recs[1][comp]["loss"],
              f"{comp}: the ranks' losses differ")
        g, tol = gaps[comp], DP_TOL[comp]
        log(f"[dp] {comp}: ranks bit-identical (digest {recs[0][comp]['digest']}); largest "
            f"gaps to phase 34's one-process {comp} run: losses {g['loss']:.4e} "
            f"(tolerance {tol['loss']}), final parameters {g['params']:.4e} (tolerance "
            f"{tol['params']})")
        check(g["loss"] <= tol["loss"] and g["params"] <= tol["params"],
              f"{comp}: the 2-process run left phase 34's 1-process run: {g}")
        check(recs[0][comp]["ef_calls"] == (steps if comp == "int8_ef" else 0),
              f"{comp}: {recs[0][comp]['ef_calls']} ef_int8_psum calls")
        paths[f"dp_{comp}"] = recs[0][comp]["launches"]
    return paths


# ---------------------------------------------------------------------------
# phase 36: coordinated checkpoints across processes

# GPT-Base at full width (d 768, 12 heads, vocab 50304), its 12 layers cut to
# COORD_LAYERS; the launcher's V-cycle at 4 steps (1 + 2 + 4) on 8 x 1024
COORD_LAYERS = 4
COORD_TRAIN = ["--arch", "gpt-base", "--vcycle", "--steps", "4", "--batch", "8", "--seq",
               "1024", "--lr", "6e-4", "--ckpt-every", "1000"]


@contextlib.contextmanager
def _gpt_base_cut(layers):
    """The launcher's and the serving CLI's ``get_config("gpt-base")`` cut to
    ``layers`` layers at full width, in this process."""
    from repro_torch.launch import serve as S
    from repro_torch.launch import train as T

    saved = T.get_config, S.get_config

    def cut(name, smoke=False):
        return _paper(name, layers) if name == "gpt-base" else saved[0](name, smoke=smoke)

    T.get_config = S.get_config = cut
    try:
        yield
    finally:
        T.get_config, S.get_config = saved


def _ef_digests(tree) -> dict:
    """Leaf -> digest of this process's EF rows (a ProcessShard's block)."""
    from repro_torch.checkpoint.store import leaf_digest
    from repro_torch.param import flatten

    if tree is None:
        return {}
    return {k: leaf_digest(getattr(v, "local", v)) for k, v in flatten(tree).items()}


def _saved_ef_rows(directory, rows=2) -> list:
    """Per slow-axis rank, leaf -> the digest its writer recorded for that
    rank's EF row in the newest checkpoint's manifest (what it saved)."""
    from repro_torch.checkpoint import CheckpointManager

    mgr = CheckpointManager(directory)
    ef = mgr.step_manifest(mgr.latest())["ef"]
    return [{leaf: next(ch["digest"] for ch in rec["chunks"] if ch["start"][0] == r)
             for leaf, rec in ef.items()} for r in range(rows)]


def _params_digest(params) -> str:
    import hashlib

    from repro_torch.param import flatten

    h = hashlib.blake2b(digest_size=16)
    for k, v in flatten(params).items():
        h.update(k.encode())
        h.update(v.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


@contextlib.contextmanager
def _ckpt_recorder(rec):
    """Inside, the launcher builds its checkpoint manager as a subclass that
    records, after each call of the manager's own ``save`` and ``restore``,
    what the manager measured: every save (wall to its publish, step, phase,
    ``last_save_stats``), every gather over the store (``last_gather_stats``:
    digests, bytes, seconds) and the EF rows every restore landed (their
    digests)."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch import train as T

    class Recorded(CheckpointManager):
        def save(self, step, state, meta=None, blocking=True):
            t = time.time()
            super().save(step, state, meta, blocking)
            self.wait()
            rec.setdefault("saves", []).append(
                {"dir": self.dir, "local": self.local, "step": step,
                 "phase": (meta or {}).get("phase"), "wall_s": time.time() - t,
                 **self.last_save_stats})

        def restore(self, like_state, device=None, **kw):
            self.last_gather_stats = {}
            state, meta = super().restore(like_state, device, **kw)
            if self.last_gather_stats.get("seconds") is not None:
                rec.setdefault("gathers", []).append(
                    {"dir": self.dir, **self.last_gather_stats})
            if state is not None:
                rec.setdefault("restores", []).append(
                    {"phase": meta.get("phase"), "global_step": meta.get("global_step"),
                     "ef": _ef_digests(state.get("ef"))})
            return state, meta

    T.CheckpointManager = Recorded
    try:
        yield rec
    finally:
        T.CheckpointManager = CheckpointManager


def launch_worker(rec_path: str, after: str, argv: list) -> int:
    """One process of phases 12 and 36 (``chip_smoke.py --launch REC
    [--launch-after FILE] -- ARGS``): the launcher's ``main(ARGS)``,
    GPT-Base cut to ``COORD_LAYERS`` layers, with its kernel launches and
    what its checkpoint manager measured recorded into ``REC``
    (``_ckpt_recorder``).  With ``--launch-after`` the process starts, loads
    the kernels and pays its one-time costs (``_warm_train``), then waits
    for FILE before it calls ``main``: a run started before its phase.
    Exits with the launcher's code."""
    entry = time.time()
    from repro_torch.kernels.build import load_library
    from repro_torch.launch import train as T

    if after:
        if torch.cuda.is_available():
            load_library()
            _warm_train(torch.device("cuda", 0))
        parent = os.getppid()
        while not os.path.exists(after):
            check(os.getppid() == parent, "the script that started this process is gone")
            time.sleep(0.01)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rec, out, code = {"t_entry": entry, "t_main": time.time(), "waited": bool(after)}, None, 0
    with _gpt_base_cut(COORD_LAYERS), _ckpt_recorder(rec):
        _reset_counters()
        try:
            out = T.main(argv)
        except SystemExit as e:
            code = e.code or 0
        rec["launches"] = _launches()
    rec["code"], rec["t_end"] = code, time.time()
    if out is not None:
        rec["loss"], rec["digest"] = out.history.loss, _params_digest(out.params)
    with open(rec_path, "w") as f:
        json.dump(rec, f)
    return code


class _SignalOn(io.TextIOBase):
    """A stdout that passes every write on and sends this process SIGTERM
    the first time a line holds ``word`` (the launcher's log, read as the
    pairs' watcher reads it)."""

    def __init__(self, out, word):
        self.out, self.word, self.sent = out, word, False

    def write(self, text):
        self.out.write(text)
        if not self.sent and self.word in text:
            self.sent = True
            os.kill(os.getpid(), signal.SIGTERM)
        return len(text)

    def flush(self):
        self.out.flush()


def _main_here(argv, rec, sigterm=False, layers=COORD_LAYERS):
    """The launcher's ``main(argv)`` in this process (GPT-Base cut to
    ``layers`` unless None; its SIGTERM handler restored after), recorded
    into ``rec`` as ``launch_worker`` records; returns what ``main``
    returns, or its exit code.  With ``sigterm`` the process sends itself
    SIGTERM when the launcher logs its first coalescing, as the pairs'
    rank 1 gets it."""
    from repro_torch.launch import train as T

    handler = signal.getsignal(signal.SIGTERM)
    _reset_counters()
    out = _SignalOn(sys.stdout, "coalescing") if sigterm else sys.stdout
    try:
        with (_gpt_base_cut(layers) if layers else contextlib.nullcontext()), \
                _ckpt_recorder(rec), contextlib.redirect_stdout(out):
            return T.main(argv)
    except SystemExit as e:
        return e.code or 0
    finally:
        torch.cuda.synchronize()
        rec["launches"] = _launches()
        signal.signal(signal.SIGTERM, handler)


def _start_pairs(root, specs, release=False):
    """Start pairs of launcher processes (``launch_worker``), each pair a
    ``--mesh 2x1`` over a coordinator of its own (a file in ``root`` where its
    rank 0 writes the port it binds).  Each spec is
    ``(tag, rank_args, sigterm)``: ``rank_args(r)`` is rank r's argv; with
    ``sigterm`` rank 1 alone gets SIGTERM once rank 0 logs the first
    coalescing (the upward sweep starts).  With ``release`` each pair's processes warm up and wait until
    :func:`_release` lets them go (``launch_worker``'s ``--launch-after``).
    Returns the pairs for :func:`_finish_pairs`."""
    env = dict(os.environ, PYTHONUNBUFFERED="1", OMP_NUM_THREADS="1")
    pairs = []
    for tag, rank_args, sigterm in specs:
        coord = f"file://{os.path.join(root, f'{tag}.coord')}"
        logs = [os.path.join(root, f"{tag}-rank{r}.log") for r in range(2)]
        recs = [os.path.join(root, f"{tag}-rank{r}.json") for r in range(2)]
        after = os.path.join(root, f"{tag}-go") if release else None
        procs = []
        for r in range(2):
            cmd = [sys.executable, os.path.abspath(__file__), "--launch", recs[r]]
            cmd += ["--launch-after", after] if after else []
            cmd += ["--", *rank_args(r), "--mesh", "2x1", "--num-processes", "2",
                    "--process-id", str(r), "--coordinator", coord]
            with open(logs[r], "w") as lf:
                procs.append(subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=lf,
                                              stderr=subprocess.STDOUT))
        pairs.append({"tag": tag, "procs": procs, "logs": logs, "recs": recs, "after": after,
                      "sigterm": sigterm, "t": time.time(), "signalled": None})
    return pairs


def _release(pair) -> None:
    """Let a pair started with ``release`` go; its wall counts from here."""
    with open(pair["after"], "w"):
        pass
    pair["t"] = time.time()


def _stop_pairs(pairs) -> None:
    for p in pairs:
        for proc in p["procs"]:
            _stop(proc)


def _finish_pairs(pairs, timeout=300, meanwhile=None):
    """Run ``meanwhile()`` here (when given) while ``pairs`` run -- a thread
    sends each SIGTERM as :func:`_start_pairs` says -- then wait for every
    process: each must exit 0 within ``timeout``.  Returns ([(records, logs,
    wall)] per pair, meanwhile's result)."""
    import threading

    deadline = time.time() + timeout

    def watch():
        waiting = [p for p in pairs if p["sigterm"]]
        while waiting and time.time() < deadline:
            for p in list(waiting):
                r0, r1 = p["procs"]
                if "coalescing" in _read(p["logs"][0]) or r0.poll() is not None:
                    p["signalled"] = r1.poll() is None
                    if p["signalled"]:
                        r1.send_signal(signal.SIGTERM)
                    waiting.remove(p)
            time.sleep(0.01)

    watcher = threading.Thread(target=watch, daemon=True)
    watcher.start()
    try:
        got = meanwhile() if meanwhile is not None else None
        watcher.join(max(1.0, deadline - time.time()))
        out = []
        for p in pairs:
            for proc in p["procs"]:
                try:
                    proc.wait(timeout=max(1.0, deadline - time.time()))
                except subprocess.TimeoutExpired:
                    pass
            wall = time.time() - p["t"]
            if p["sigterm"]:
                check(p["signalled"], f"{p['tag']}: rank 1 ended before the upward sweep:\n"
                                      f"{_read(p['logs'][1])[-3000:]}")
            for r, proc in enumerate(p["procs"]):
                if proc.poll() != 0:
                    log(f"[coord] {p['tag']} rank {r} output:\n{_read(p['logs'][r])[-4000:]}")
                check(proc.poll() == 0, f"{p['tag']}: rank {r} exited {proc.poll()} (None: "
                                        f"still running after {timeout}s)")
            recs = []
            for path in p["recs"]:
                with open(path) as f:
                    recs.append(json.load(f))
            for r, rc in enumerate(recs):
                start = (f"{rc['t_main'] - p['t']:.1f}s from the go to its main (warmed up "
                         f"before)" if rc["waited"] else
                         f"{rc['t_entry'] - p['t']:.1f}s to start (interpreter, imports), "
                         f"{rc['t_main'] - rc['t_entry']:.1f}s to import the launcher")
                log(f"[coord] {p['tag']} rank {r}: {start}, {rc['t_end'] - rc['t_main']:.1f}s "
                    f"in its main, {p['t'] + wall - rc['t_end']:.1f}s to exit")
            out.append((recs, [_read(lg) for lg in p["logs"]], wall))
        return out, got
    finally:
        _stop_pairs(pairs)


def _drained_at(text) -> int:
    m = re.findall(r"\[preempt\] SIGTERM: blocking V-cycle checkpoint at global_step (\d+)",
                   text)
    check(len(m) == 1, f"{len(m)} [preempt] lines in a drained process's log")
    return int(m[0])


def _log_coord_saves(tag, rec):
    for r in rec.get("saves", []):
        log(f"[coord] {tag} save at global step {r['step']} (phase {r['phase']}, "
            f"{'local' if r['local'] else 'shared'} {os.path.basename(r['dir'])}): "
            f"{r['wall_s']:.3f} s to its publish, {r['bytes_written'] / 1e6:.3f} MB "
            f"written ({r['objects_written']} objects), {r['bytes_reused'] / 1e6:.3f} MB "
            f"reused")
    for g in rec.get("gathers", []):
        rate = g["bytes"] / g["seconds"] / 1e6 if g["seconds"] else 0.0
        log(f"[coord] {tag} gather through the TCPStore: {g['bytes'] / 1e6:.3f} MB fetched in "
            f"{g['seconds']:.3f} s ({rate:.1f} MB/s); stats "
            f"{ {k: v for k, v in g.items() if k not in ('dir', 'seconds', 'bytes')} }")


def _sum_counts(*counts) -> dict:
    return {k: sum(c[k] for c in counts) for k in counts[0]}


def _coord_gaps(params, loss, want_params, want_loss) -> dict:
    check(params.keys() == want_params.keys(), "the parameter trees differ")
    return {"loss": float(np.max(np.abs(np.asarray(loss) - np.asarray(want_loss)))),
            "params": max((params[k].float() - v.float()).abs().max().item()
                          for k, v in want_params.items())}


def start_coordinated() -> dict:
    """Phase 36's five pairs of launcher processes, started now (before
    phase 33): each warms up (its CUDA context, the kernels) and waits for
    :func:`coordinated_phase` to let it go, so none pays its start-up inside
    the phase."""
    root = tempfile.mkdtemp(prefix="chip_smoke_coord_")
    int8 = COORD_TRAIN + ["--grad-compression", "int8_ef"]
    d_a, d_b = os.path.join(root, "shared-dense"), os.path.join(root, "shared-int8")
    l_b = os.path.join(root, "local-int8-")
    l_1, fresh = os.path.join(root, "local-one"), os.path.join(root, "local-fresh1")
    pairs = _start_pairs(root, [
        ("36a", lambda r: COORD_TRAIN + ["--grad-compression", "dense", "--ckpt-dir", d_a],
         True),
        ("36b", lambda r: int8 + ["--ckpt-dir", d_b], True),
        ("36c-local", lambda r: int8 + ["--ckpt-local-dir", l_b + str(r)], True),
        ("36c", lambda r: COORD_TRAIN + ["--grad-compression", "dense", "--ckpt-local-dir",
                                         l_1 if r == 0 else fresh], False),
        ("36b-resume", lambda r: int8 + ["--ckpt-dir", d_b], False)], release=True)
    return {"root": root, "pairs": dict(zip(("36a", "36b", "36c-local", "36c", "36b-resume"),
                                            pairs)),
            "dirs": {"d_a": d_a, "d_b": d_b, "l_b": l_b, "l_1": l_1, "fresh": fresh}}


def stop_coordinated(early) -> None:
    _stop_pairs(list(early["pairs"].values()))
    shutil.rmtree(early["root"], ignore_errors=True)


def coordinated_phase(dev, early, timeout=300) -> dict:
    """Phase 36: coordinated checkpoints through the launcher, GPT-Base cut
    to ``COORD_LAYERS`` layers at full width, ``COORD_TRAIN``'s V-cycle; two
    processes share the card (``--mesh 2x1``, gloo), each through
    ``launch_worker``; one-process runs go through the launcher's ``main``
    in this process.  Every process's launches are held to the schedule
    (a drained part plus its resume to the whole).

    36a: uninterrupted, one process (the yardstick); two processes,
    ``--grad-compression dense --ckpt-dir D``, SIGTERM to rank 1 alone in
    the upward sweep: both exit 0 after the same global step, which the
    manifest names (phase up); one process resumes D to the end, its losses
    and final parameters within ``DP_TOL["dense"]`` of the uninterrupted
    run.  36b: the same with ``int8_ef``: every rank's EF rows restore on
    two processes with the digests the manifest recorded at the save, the
    resumed ranks end with equal losses, each on its FSDP blocks, and one
    process (``--mesh 1x1 --grad-compression int8_ef``) is refused.  36c:
    one process saves into ``--ckpt-local-dir L`` (SIGTERM in the upward
    sweep), two processes resume it, rank 1 from an empty dir gathering
    every object over the store (its gather printed, each object's digest
    checked), their terminal checkpoint (each rank's blocks in its own dir,
    restored with rank 1's as ``peer_dirs``) within ``DP_TOL["dense"]`` of
    the uninterrupted run; and 36b's command with
    ``--ckpt-local-dir`` per rank (beside 36a and 36b) drains at 36b's
    step, its dirs restore on one process with rank 1's as ``peer_dirs``
    (and not without them) bit-equal to 36b's shared dir (as drained: a
    copy, since 36b's resume runs beside these checks).  Every pair was
    started and warmed up before phase 33 (:func:`start_coordinated`).  36d: a paged
    GPT-Base server from the serving CLI with ``--reload-from L
    --reload-local`` refuses 36c's terminal checkpoint (each rank's FSDP
    blocks in its own dir) naming ``--reload-peer-dirs``, and with
    ``--reload-peer-dirs`` rank 1's dir swaps it in at a tick boundary and
    decodes; the landed leaves are the checkpoint's and paged decode
    launches once a layer and decode tick.  Returns the launches of each
    path."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.config import MultiLevelConfig, TrainConfig
    from repro_torch.core.vcycle import VCycleRunner
    from repro_torch.launch import serve as S
    from repro_torch.models.api import zero_train_state
    from repro_torch.param import flatten, tree_map

    _free()
    cfg = _paper("gpt-base", COORD_LAYERS)
    arg = lambda flag: COORD_TRAIN[COORD_TRAIN.index(flag) + 1]
    tc = TrainConfig(steps=int(arg("--steps")), batch_size=int(arg("--batch")),
                     seq_len=int(arg("--seq")))
    runner = VCycleRunner(cfg, MultiLevelConfig(n_levels=2, alpha=0.25), tc, None, device=dev)
    want = _schedule_launches(runner, tc)
    total = sum(sg.steps for sg in runner.plan)
    root, pr, dirs = early["root"], early["pairs"], early["dirs"]
    d_a, d_b, l_b, l_1, fresh = (dirs[k] for k in ("d_a", "d_b", "l_b", "l_1", "fresh"))
    paths = {}
    int8 = COORD_TRAIN + ["--grad-compression", "int8_ef"]
    try:
        # 36a, 36b and 36c's local-dir run of 36b's command go now, while this
        # process writes 36c's one-process save (then 36c's pair goes) and
        # runs the uninterrupted one
        rec_u, rec_k = {}, {}

        def here():
            """The one-process local save 36c resumes, drained by a SIGTERM
            in the upward sweep (36c's pair goes then), and the
            uninterrupted run."""
            code = _main_here(COORD_TRAIN + ["--ckpt-local-dir", l_1], rec_k, sigterm=True)
            check(code == 0, f"36c: the one-process run was not drained (it returned {code})")
            mk = CheckpointManager(l_1).latest()["meta"]
            check(mk["phase"] == "up", f"36c: the drained save {mk}")
            _release(pr["36c"])
            t0 = time.time()
            out = _main_here(COORD_TRAIN, rec_u)
            return out, time.time() - t0, mk["global_step"]

        for tag in ("36a", "36b", "36c-local"):
            _release(pr[tag])
        (pairs, (out, wall_u, kill)) = _finish_pairs(
            [pr["36a"], pr["36b"], pr["36c-local"]], timeout=timeout, meanwhile=here)
        # the drained 36b dir as it is now, for this process's checks, while
        # 36b's resume moves the shared dir on
        d_b_drained = d_b + "-drained"
        shutil.copytree(d_b, d_b_drained)
        _release(pr["36b-resume"])
        (recs, logs, wall), (recs_b, logs_b, wall_b), (recs_l, logs_l, wall_l) = pairs
        check(rec_u["launches"] == want, f"uninterrupted: launches {rec_u['launches']} != {want}")
        u_params = {k: v.detach().cpu() for k, v in flatten(out.params).items()}
        u_loss, u_steps = list(out.history.loss), list(out.history.step)
        paths["coord_1proc"] = rec_u["launches"]
        log(f"[coord] uninterrupted, one process: {total} steps "
            f"({[(sg.phase, sg.steps) for sg in runner.plan]}), {wall_u:.1f}s wall beside the "
            f"pairs; losses first {u_loss[0]:.4f} last {u_loss[-1]:.4f}; launches "
            f"{rec_u['launches']}")
        del out
        _free()

        # 36a: shared dir, dense; SIGTERM on rank 1 alone, resume on one process
        steps = [_drained_at(lg) for lg in logs]
        meta = CheckpointManager(d_a).latest()["meta"]
        log(f"[coord] 36a two processes, SIGTERM to rank 1: both exit 0 after {wall:.1f}s, "
            f"drained at global steps {steps}; manifest step {meta['global_step']} phase "
            f"{meta['phase']}")
        check("caught signal" in logs[1] and "caught signal" not in logs[0],
              "the signal did not land on rank 1 alone")
        check(steps[0] == steps[1] == meta["global_step"] and meta["phase"] == "up",
              f"drained at {steps}, manifest {meta['global_step']} ({meta['phase']})")
        for r in range(2):
            _log_coord_saves(f"36a rank {r}", recs[r])
        rec_r = {}
        t0 = time.time()
        out = _main_here(COORD_TRAIN + ["--ckpt-dir", d_a], rec_r)
        _log_coord_saves("36a resume", rec_r)
        g = _coord_gaps({k: v.detach().cpu() for k, v in flatten(out.params).items()},
                        out.history.loss, u_params, u_loss)
        log(f"[coord] 36a one process resumed phase {rec_r['restores'][0]['phase']} at global "
            f"step {rec_r['restores'][0]['global_step']} to the end in {time.time() - t0:.1f}s; "
            f"gaps to the uninterrupted run: losses {g['loss']:.4e}, final parameters "
            f"{g['params']:.4e} (tolerance {DP_TOL['dense']}); launches {rec_r['launches']}")
        check(list(out.history.step) == u_steps, "36a: the resumed History's steps differ")
        check(g["loss"] <= DP_TOL["dense"]["loss"] and g["params"] <= DP_TOL["dense"]["params"],
              f"36a: the 2 -> 1 resume left the uninterrupted run: {g}")
        for r in range(2):
            both = _sum_counts(recs[r]["launches"], rec_r["launches"])
            check(both == want, f"36a rank {r} + resume launches {both} != {want}")
        paths["coord_2to1_dense"] = _sum_counts(recs[0]["launches"], rec_r["launches"])
        del out
        _free()

        # 36b: int8_ef, shared dir
        steps = [_drained_at(lg) for lg in logs_b]
        m = CheckpointManager(d_b_drained).latest()
        check(steps[0] == steps[1] == m["meta"]["global_step"] and m["meta"]["phase"] == "up"
              and m["meta"]["ef_rows"] == 2, f"36b: drained at {steps}, manifest {m['meta']}")
        for r in range(2):
            _log_coord_saves(f"36b rank {r}", recs_b[r])
        saved = _saved_ef_rows(d_b_drained)
        check(all(saved) and saved[0] != saved[1], "36b: the manifest's EF rows")
        log(f"[coord] 36b two processes, int8_ef, SIGTERM to rank 1: both exit 0 after "
            f"{wall_b:.1f}s, drained at global step {steps[0]}")
        try:
            _main_here(int8 + ["--mesh", "1x1", "--ckpt-dir", d_b_drained], {})
            check(False, "36b: one process resumed a two-process int8_ef checkpoint")
        except ValueError as e:
            check("same mesh shape" in str(e), f"36b: refused for another reason: {e}")
            log(f"[coord] 36b one process refused: {e}")
        check(not torch.distributed.is_initialized(), "36b: the refused run left its group up")
        # the drained state on one process, from the shared dir as drained
        level = m["meta"]["level"]
        like_p, like_o = zero_train_state(runner.models[level], tc, device="cpu")
        like = {"params": like_p, "opt": like_o,
                "params_before_0": zero_train_state(runner.models[0], tc, device="cpu")[0],
                "ef": tree_map(lambda v: torch.zeros((2,) + tuple(v.shape)), like_p)}
        t0 = time.time()
        shared, _ = CheckpointManager(d_b_drained).restore(like, device="cpu")
        t_shared = time.time() - t0
        for r in range(2):
            rows = _ef_digests({k: v[r:r + 1] for k, v in flatten(shared["ef"]).items()})
            check(rows == saved[r], f"36b: rank {r}'s EF rows restore on one process other "
                                    f"than saved")
        # 36b's resume went after the first runs, 36c's beside them
        ((recs_c, logs_c, wall_c), (recs_d, logs_d, wall)), _ = \
            _finish_pairs([pr["36b-resume"], pr["36c"]], timeout=timeout)
        for r in range(2):
            _log_coord_saves(f"36b resume rank {r}", recs_c[r])
            got = recs_c[r]["restores"][0]
            check(got["global_step"] == steps[0] and got["ef"] == saved[r],
                  f"36b: rank {r} restored EF rows other than it saved")
            both = _sum_counts(recs_b[r]["launches"], recs_c[r]["launches"])
            check(both == want, f"36b rank {r} + resume launches {both} != {want}")
        end = CheckpointManager(d_b).latest()["meta"]
        check(recs_c[0]["loss"] == recs_c[1]["loss"] and end["phase"] == "done"
              and end["global_step"] == total and all(np.isfinite(recs_c[0]["loss"]))
              and recs_c[0]["digest"] != recs_c[1]["digest"], "36b: the resumed ranks disagree")
        log(f"[coord] 36b two processes resumed in {wall_c:.1f}s: each rank's EF rows "
            f"bit-equal to its save (the manifest's digests), the ranks' losses equal, each "
            f"rank ending on its own FSDP blocks (digests {recs_c[0]['digest'][:8]}, "
            f"{recs_c[1]['digest'][:8]}), losses first {recs_c[0]['loss'][0]:.4f} last "
            f"{recs_c[0]['loss'][-1]:.4f}")
        paths["coord_int8_ef"] = _sum_counts(recs_b[0]["launches"], recs_c[0]["launches"])

        # 36c (two local dirs): 36b's command with --ckpt-local-dir, on one
        # process with rank 1's dir as peer_dirs
        steps_l = [_drained_at(lg) for lg in logs_l]
        for r in range(2):
            _log_coord_saves(f"36c local rank {r}", recs_l[r])
        check(steps_l == steps, f"36c: the local-dir run drained at {steps_l}, 36b at {steps}")
        try:
            CheckpointManager(l_b + "0", local=True).restore(like, device="cpu")
            check(False, "36c: rank 0's local dir alone restored rank 1's EF rows")
        except FileNotFoundError:
            pass
        t0 = time.time()
        local, _ = CheckpointManager(l_b + "0", local=True,
                                     peer_dirs=[l_b + "1"]).restore(like, device="cpu")
        t_local = time.time() - t0
        a, b = flatten(shared), flatten(local)
        same = lambda x, y: torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
        check(a.keys() == b.keys() and all(same(a[k], b[k]) for k in a),
              "36c: the local dirs with peer_dirs restore other trees than 36b's shared dir")
        log(f"[coord] 36c 36b's command with a local dir per rank, drained at global step "
            f"{steps_l[0]} after {wall_l:.1f}s; its two dirs on one process (rank 1's as "
            f"peer_dirs; rank 0's alone refused): {len(a)} leaves bit-equal to 36b's shared "
            f"dir ({t_local:.2f}s against {t_shared:.2f}s)")
        del shared, local, a, b
        for r in range(2):
            _log_coord_saves(f"36c rank {r}", recs_d[r])
        g0, g1 = recs_d[0]["gathers"][-1], recs_d[1]["gathers"][-1]
        check(g1["held"] == 0 and g1["fetched"] == g1["manifest"] == g0["served"] > 0
              and g1["bytes"] > 0 and g0["fetched"] == 0,
              f"36c: rank 1 did not gather the checkpoint from rank 0: {g0} {g1}")
        final = CheckpointManager(l_1).latest()
        check(final["meta"]["phase"] == "done" and final["step"] == total,
              f"36c: the resumed run's last save {final['meta'].get('phase')} {final['step']}")
        # FSDP: each rank's local dir holds its blocks; rank 1's supplies the rest
        done, _ = CheckpointManager(l_1, local=True, peer_dirs=[fresh]).restore(
            {"params": zero_train_state(runner.models[0], tc, device="cpu")[0]}, device="cpu")
        g = _coord_gaps(flatten(done["params"]), final["meta"]["history"]["loss"], u_params,
                        u_loss)
        log(f"[coord] 36c one-process local save at global step {kill}, resumed on two "
            f"processes in {wall:.1f}s (rank 1 from an empty dir): gaps to the uninterrupted "
            f"run: losses {g['loss']:.4e}, final parameters {g['params']:.4e} (tolerance "
            f"{DP_TOL['dense']}); both ranks' dirs end at step {final['step']}")
        check(g["loss"] <= DP_TOL["dense"]["loss"] and g["params"] <= DP_TOL["dense"]["params"],
              f"36c: the 1 -> 2 resume left the uninterrupted run: {g}")
        check(CheckpointManager(fresh).latest()["step"] == total,
              "36c: rank 1's local dir did not publish the terminal step")
        for r in range(2):
            both = _sum_counts(rec_k["launches"], recs_d[r]["launches"])
            check(both == want, f"36c drained + rank {r} launches {both} != {want}")
        paths["coord_1to2_local"] = _sum_counts(rec_k["launches"], recs_d[0]["launches"])
        del done
        _free()

        # 36d: the serving CLI reloads from the local dir
        make_server = S.make_server
        ticks = {"decode": 0, "long_prefills": 0}

        def counted_server(*a, **kw):
            srv = make_server(*a, **kw)
            prefill, paged = srv.prefill, srv.paged_step

            def prefill_counted(params, tokens):
                ticks["long_prefills"] += tokens.shape[1] > max(128, cfg.attn_block_k)
                return prefill(params, tokens)

            def paged_counted(params, pages, tokens, positions, tables):
                ticks["decode"] += tokens.shape[1] == 1
                return paged(params, pages, tokens, positions, tables)

            srv.prefill, srv.paged_step = prefill_counted, paged_counted
            return srv

        serve = ["--arch", "gpt-base", "--no-smoke", "--device", str(dev), "--batch", "4",
                 "--requests", "8", "--max-new", "8", "--reload-from", l_1, "--reload-local"]
        try:
            with _gpt_base_cut(COORD_LAYERS), _uncounted():
                S.main(serve)
            check(False, "36d: the server read a spread local checkpoint without its peer dir")
        except FileNotFoundError as e:
            check("--reload-peer-dirs" in str(e), f"36d: the refusal does not say what to do: {e}")
        _reset_counters()
        S.make_server = counted_server
        t0 = time.time()
        try:
            with _gpt_base_cut(COORD_LAYERS):
                srv, watcher, served = S.main(serve + ["--reload-peer-dirs", fresh])
        finally:
            S.make_server = make_server
        torch.cuda.synchronize(dev)
        counts = _launches()
        wall = time.time() - t0
        with _uncounted():
            landed = flatten(srv.params)
            ckpt, _ = CheckpointManager(l_1, local=True, peer_dirs=[fresh]).restore(
                {"params": zero_train_state(runner.models[0], tc, device="cpu")[0]},
                device="cpu")
        want_serve = dict({k: 0 for k in _wrappers()},
                          flash_attention_fwd=cfg.n_layers * ticks["long_prefills"],
                          paged_attention_decode=cfg.n_layers * ticks["decode"])
        log(f"[coord] 36d paged server --reload-local (refused without rank 1's dir): "
            f"{srv.reloads} swap(s) of steps "
            f"{watcher.steps_seen} in {wall:.1f}s, last reload {watcher.last_reload_stats}; "
            f"{len(served)} requests, {ticks['decode']} decode ticks; launches {counts}")
        check(srv.reloads >= 1 and watcher.steps_seen[-1] == total and ticks["decode"] > 0
              and all(len(r.out) == 8 for r in served) and len(served) == 8,
              "36d: the server did not swap in the terminal checkpoint and decode")
        check(landed.keys() == flatten(ckpt["params"]).keys()
              and all(torch.equal(landed[k].cpu(), v)
                      for k, v in flatten(ckpt["params"]).items()),
              "36d: the landed leaves are not the checkpoint's")
        check(counts == want_serve, f"36d: launches {counts} != {want_serve}")
        paths["coord_reload_local"] = counts
        del srv, watcher, landed, ckpt
        return paths
    finally:
        stop_coordinated(early)
        _free()


# ---------------------------------------------------------------------------
# phase 37: mesh serving -- tensor and expert parallelism on a 1x2 mesh of two
# processes sharing the card (gloo with CUDA tensors)

# (b): TinyLlama-1.1B at full width cut to 2 layers, f32: a cold flash prefill,
# the extend step of a shared 256-token prefix, two plain prefills
MESH_F32_LENGTHS = [600, 530, 100, 64]
MESH_F32_SHARED = ((0, 1),)
# (c): Phi-3.5-MoE at full width cut to 2 layers, f32, prompts past attn_block_k
MESH_MOE_LENGTHS = [530, 777, 600, 700]
MESH_MOE_SHARED = ((0, 2),)
# the first decode tick's logits, 1x2 against 1x1 at f32 (max abs over max(1,
# max |logit|)): the sharded sums add the same f32 products in another order
MESH_LOGIT_TOL = 1e-4
# (a): the same at bf16 against phase 4's one process, over the rows whose
# token and position agree.  The split products round twice: 9.9e-3, where
# the K/V heads of one layer swapped give 0.28-0.34, of every layer 1.47, and
# an unmasked vocabulary-parallel lookup no agreeing row
# (``scripts/mesh_logit_gaps.py``, NVIDIA H100 80GB HBM3, 700 W)
MESH_BF16_LOGIT_TOL = 5e-2


def _mesh_run(srv, reqs, dev, tally=None) -> dict:
    """Serve ``reqs`` on ``srv`` with the kernels' and the collectives'
    counts zeroed first; the record holds the streams, the launches, each
    decode tick's collectives and host wall, each prefill's and extend's
    host wall and the shapes ``all_gather_cat`` returned inside it, the
    first decode tick's logits, whether every logit was finite, tokens/s and
    the peak memory."""
    from repro_torch.distributed import tensor_parallel as tp

    finite = torch.ones((), dtype=torch.bool, device=dev)
    ticks, walls, first = [], [], []
    prefills, active = [], []  # (kind, rows, gathered shapes, host s) a prefill or extend
    prefill, paged_step, decode_once = srv.prefill, srv.paged_step, srv.decode_once
    gather = tp.all_gather_cat

    def gather_recorded(x, dim=-1, axes=tp.MODEL):
        y = gather(x, dim, axes)
        if active:
            active[-1][2].append(tuple(y.shape))
        return y

    def prefill_timed(kind, step, tokens, *args):
        active.append((kind, tokens.shape[0], []))
        t = time.time()
        out = step(*args)
        torch.cuda.synchronize(dev)
        prefills.append(active.pop() + (time.time() - t,))
        return out

    def prefill_checked(params, tokens):
        nonlocal finite
        if tally is not None:
            tally.kind = "prefill"
        logits, caches = prefill_timed("prefill", prefill, tokens, params, tokens)
        finite = finite & torch.isfinite(logits).all()
        return logits, caches

    def paged_checked(params, pages, tokens, positions, tables):
        nonlocal finite
        if tally is not None:
            tally.kind = "decode" if tokens.shape[1] == 1 else "extend"
        args = (params, pages, tokens, positions, tables)
        if tokens.shape[1] == 1:
            logits, pages = paged_step(*args)
        else:
            logits, pages = prefill_timed("extend", paged_step, tokens, *args)
        finite = finite & torch.isfinite(logits).all()
        if tokens.shape[1] == 1 and not first:
            first.append(_tick_record(logits, tokens, positions))
        return logits, pages

    def decode_timed():
        before, t = tp.counts(), time.time()
        out = decode_once()
        walls.append(time.time() - t)
        ticks.append({k: v - before[k] for k, v in tp.counts().items()})
        return out

    srv.prefill, srv.paged_step, srv.decode_once = prefill_checked, paged_checked, decode_timed
    tp.all_gather_cat = gather_recorded
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    tp.reset_counts()
    _reset_counters()
    rids = {r.rid for r in reqs}
    t0 = time.time()
    try:
        done = [r for r in srv.run(reqs) if r.rid in rids]  # run() returns every run's
        torch.cuda.synchronize(dev)
    finally:
        tp.all_gather_cat = gather
    wall = time.time() - t0
    srv.prefill, srv.paged_step, srv.decode_once = prefill, paged_step, decode_once
    return {"streams": {r.rid: r.out for r in done}, "n_done": len(done),
            "rejected": len(srv.rejected), "lens": [len(r.out) for r in done],
            "launches": _launches(), "ticks": ticks, "tick_s": walls, "wall": wall,
            "tokens": sum(len(r.out) for r in done), "finite": bool(finite.item()),
            "collectives": tp.counts(), "saved": srv.prefill_tokens_saved,
            "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
            "first_tick": first[0] if first else None, "prefills": prefills}


def _prefill_gathers(run, vocab) -> tuple:
    """(whether every prefill and extend of ``run`` gathered its logits as
    one ``[B, V]`` block, the last position's only, as the reference keeps
    them split; the count of each kind; the shapes gathered with ``vocab``
    columns; the steps' host wall in s)."""
    ok, kinds, shapes = True, {"prefill": 0, "extend": 0}, set()
    for kind, rows, gathered, _ in run["prefills"]:
        logits = [g for g in gathered if g[-1] == vocab]
        ok = ok and logits == [(rows, vocab)]
        kinds[kind] += 1
        shapes.update(logits)
    return ok, kinds, sorted(shapes), sum(p[3] for p in run["prefills"])


def mesh_serve_worker(rank: int, coordinator: str, out_dir: str, after: str) -> int:
    """One rank of phase 37 (``chip_smoke.py --mesh-serve-rank R ...``).
    It imports the port, waits for ``after`` (started early, so its
    start-up overlaps earlier phases), then: (a) the serving CLI's ``main``
    with ``--mesh 1x2`` builds the group, the mesh and TinyLlama-1.1B's
    sharded server at full width (bf16), which serves phase 4's traffic;
    (b) on that mesh TinyLlama cut to 2 layers at f32 against the same
    server on one process (rank 0 runs it), then both after a
    ``set_params`` swap; (c) Phi-3.5-MoE cut to 2 layers at f32, experts
    split over "model", against one process, with the dropped-routing
    tally.  Writes ``out_dir/rank{R}.pt``."""
    import torch.distributed as dist

    from repro_torch.config import BlockSpec, uniform_stages
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as S
    from repro_torch.layers.ffn import count_dropped
    from repro_torch.models.api import build_model
    from repro_torch.param import flatten

    from repro_torch.kernels.build import load_library

    entry, parent = time.time(), os.getppid()
    torch.ones(8, 8, device="cuda") @ torch.ones(8, 8, device="cuda")
    load_library()
    torch.cuda.synchronize()
    while not os.path.exists(after):
        check(os.getppid() == parent, "phase 37: the script that started this rank is gone")
        time.sleep(0.01)
    go = time.time()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rec = {"start_s": go - entry}
    srv, _, _ = S.main(["--arch", "tinyllama-1.1b", "--no-smoke", "--mesh", "1x2",
                        "--num-processes", "2", "--process-id", str(rank), "--coordinator",
                        coordinator, "--batch", "8", "--max-seq", "2048", "--page-size", "16",
                        "--requests", "0"])
    dev, mesh = srv.device, srv.mesh
    rec.update(backend=dist.get_backend(), device=str(dev), up_s=time.time() - go)
    full = srv.cfg
    rec["a"] = _mesh_run(srv, _requests(BF16_LENGTHS, 32, full.vocab_size, BF16_SHARED), dev)
    rec["a"]["pool_kv_heads"] = flatten(srv.pages)["stage_0/b0/self/k"].shape[3]
    rec["a"]["stats"] = srv.stats()
    del srv
    _free()

    # (b) f32, 2 layers: 1x2 against 1x1, then a hot swap
    f32 = full.replace(stages=uniform_stages(2, BlockSpec("attn", "dense")),
                       compute_dtype=torch.float32)
    kw = dict(batch=4, max_seq=1024, page_size=16, device=dev)
    reqs = lambda base: [dataclasses.replace(r, rid=base + r.rid, out=[]) for r in
                         _requests(MESH_F32_LENGTHS, 8, f32.vocab_size, MESH_F32_SHARED)]
    new = build_model(f32).init(torch.Generator(device=dev).manual_seed(SEED + 7))
    servers = {"mesh": S.make_server(f32, mesh=mesh, **kw)}
    if rank == 0:
        servers["one"] = S.make_server(f32, **kw)
    rec["b"] = {}
    for name, s in servers.items():
        rec["b"][name] = _mesh_run(s, reqs(0), dev)
        s.set_params(new)
        rec["b"][name + "_swap"] = _mesh_run(s, reqs(100), dev)
    rec["b"]["pool_kv_heads"] = flatten(servers["mesh"].pages)["stage_0/b0/self/k"].shape[3]
    del servers, new
    _free()

    # (c) Phi-3.5-MoE, 2 layers at full width, f32: the experts split over "model"
    phi2 = _paper(PHI, 2, compute_dtype=torch.float32)
    rec["c"] = {}
    for name in ("mesh", "one") if rank == 0 else ("mesh",):
        s = S.make_server(phi2, mesh=mesh if name == "mesh" else None, **kw)
        if name == "mesh":
            rec["c"]["experts_local"] = flatten(s.params)["stages/stage_0/b0/ffn/w_gate"].shape[1]
        with count_dropped() as tally:
            rec["c"][name] = _mesh_run(s, _requests(MESH_MOE_LENGTHS, 8, phi2.vocab_size,
                                                    MESH_MOE_SHARED), dev, tally)
        rec["c"][name]["dropped"] = tally.counts()
        if name == "one":  # phase 40(b)'s yardsticks: the expert blocks, the hot swap
            w = flatten(s.params)["stages/stage_0/b0/ffn/w_gate"]
            n = w.shape[1] // 4
            rec["c"]["blocks"] = [_params_digest({"w": w[:, b * n:(b + 1) * n]})
                                  for b in range(4)]
            del w
            s.set_params(_swapped(s.params))
            rec["c"]["one_swap"] = _mesh_run(s, _dxm_requests(phi2, 100), dev)
        del s
        _free()
    rec["total_s"] = time.time() - go
    _save_atomic(rec, os.path.join(out_dir, f"rank{rank}.pt"))
    # phase 40(a), beside phases 38-39: the speculative policy on this mesh
    # (TinyLlama-1.1B bf16 through the CLI, then the 2-layer f32 cut against
    # one process), then the same cut served on a "data" axis (2x1)
    go40, r40 = time.time(), {}
    _reset_counters()
    srv, _, _ = S.main(["--arch", "tinyllama-1.1b", "--no-smoke", "--mesh", "1x2",
                        "--num-processes", "2", "--process-id", str(rank), "--coordinator",
                        coordinator, "--batch", "8", "--max-seq", "2048", "--page-size", "16",
                        "--requests", "0", "--policy", "speculative", "--draft-k", "4"])
    r40["projection"] = _launches()["coalesce_pair"]
    r40["draft_heads"] = (flatten(srv.policy.draft_params)["stages/stage_0/b0/mixer/wq"].shape[2],
                          flatten(srv.policy.draft_pages)["stage_0/b0/self/k"].shape[3])
    r40["a"] = _spec_mesh_run(srv, _requests(BF16_LENGTHS, 32, full.vocab_size, BF16_SHARED),
                              dev, greedy=rec["a"]["streams"])
    r40["a"]["draft_layers"] = srv.policy.draft_cfg.n_layers
    del srv
    _free()
    spec = lambda: S.SpeculativePolicy(k=4)
    servers = {"mesh": S.make_server(f32, mesh=mesh, policy=spec(), **kw)}
    if rank == 0:
        servers["one"] = S.make_server(f32, policy=spec(), **kw)
    new = build_model(f32).init(torch.Generator(device=dev).manual_seed(SEED + 7))
    r40["a_f32"] = {}
    for name, s in servers.items():
        r40["a_f32"][name] = _spec_mesh_run(s, reqs(0), dev)
        s.set_params(new)
        r40["a_f32"][name + "_swap"] = _spec_mesh_run(s, reqs(100), dev)
    del servers
    _free()
    from repro_torch.launch.mesh import make_cli_mesh

    mesh21 = make_cli_mesh("2x1", num_processes=2, device=dev)
    s = S.make_server(f32, mesh=mesh21, **kw)
    r40["b_2x1"] = _mesh_run(s, reqs(0), dev)
    s.set_params(new)
    r40["b_2x1_swap"] = _mesh_run(s, reqs(100), dev)
    r40["total_s"] = time.time() - go40
    del s, new
    _free()
    _save_atomic(r40, os.path.join(out_dir, f"rank{rank}_40.pt"))
    dist.destroy_process_group()
    return 0


def _save_atomic(obj, path) -> None:
    """``torch.save`` through a temporary name, so a reader that polls for
    ``path`` finds it whole."""
    torch.save(obj, path + ".part")
    os.replace(path + ".part", path)


def _swapped(params):
    """Phase 40(b)'s hot-swapped weights: an elementwise function of the
    served ones, so a process's block of the result is the result's block."""
    from repro_torch.param import tree_map

    return tree_map(lambda t: t * 1.01 + 1e-3, params)


def _dxm_requests(cfg, base=0):
    return [dataclasses.replace(r, rid=base + r.rid, out=[]) for r in
            _requests(MESH_MOE_LENGTHS, 8, cfg.vocab_size, MESH_MOE_SHARED)]


def _spec_mesh_run(srv, reqs, dev, greedy=None) -> dict:
    """:func:`_mesh_run` of a speculative server, also counting its draft
    steps, verify steps (S_b 1 among them, and each one's collectives) and
    the main model's S = 1 steps; with ``greedy`` (rid -> stream) the top-
    logit gaps of a fresh mesh prefill where a stream first leaves greedy's
    (every process runs them: the streams are the same everywhere)."""
    from repro_torch.distributed import tensor_parallel as tp

    pol = srv.policy
    seen = {"draft_steps": 0, "verify": 0, "verify_s1": 0, "main_s1": 0, "verify_coll": []}
    draft_step, verify, paged_step = pol.draft_step, pol.verify, srv.paged_step

    def draft_counted(*a):
        seen["draft_steps"] += 1
        return draft_step(*a)

    def verify_counted(params, pages, tokens, positions, tables):
        before = tp.counts()
        out = verify(params, pages, tokens, positions, tables)
        seen["verify"] += 1
        seen["verify_s1"] += tokens.shape[1] == 1
        seen["verify_coll"].append({k: v - before[k] for k, v in tp.counts().items()})
        return out

    def paged_counted(params, pages, tokens, positions, tables):
        seen["main_s1"] += tokens.shape[1] == 1
        return paged_step(params, pages, tokens, positions, tables)

    pol.draft_step, pol.verify, srv.paged_step = draft_counted, verify_counted, paged_counted
    try:
        rec = _mesh_run(srv, reqs, dev)
    finally:
        pol.draft_step, pol.verify, srv.paged_step = draft_step, verify, paged_step
    rec.update(seen=seen, stats=srv.stats())
    if greedy is not None:
        prompts = {q.rid: q.prompt for q in reqs}
        ties = {}
        with _uncounted():
            for r, s in sorted(rec["streams"].items()):
                i = next((j for j, (a, b) in enumerate(zip(s, greedy[r])) if a != b), None)
                if i is None:
                    continue
                ctx = np.concatenate([prompts[r], np.asarray(greedy[r][:i], prompts[r].dtype)])
                lg = srv.prefill(srv.params, srv._tensor(ctx)[None])[0][0].float()
                top, tol = lg.max(), 2 * TOL[torch.bfloat16] * max(1.0, lg.abs().max().item())
                ties[r] = {"at": i, "greedy_gap": (top - lg[greedy[r][i]]).item(),
                           "spec_gap": (top - lg[s[i]]).item(), "tol": tol}
        rec["ties"] = ties
    return rec


def _wait_records(procs, logs, paths, deadline, what) -> list:
    """The records at ``paths`` (one a process, written whole by
    :func:`_save_atomic`), waited for while every process is alive or has
    exited 0; a process that fails, or a deadline passed, fails the phase
    with its output logged."""
    while not all(os.path.exists(p) for p in paths):
        bad = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)
               or (p.poll() == 0 and not os.path.exists(paths[r]))]
        if bad or time.time() > deadline:
            for r in bad or range(len(procs)):
                log(f"[{what}] rank {r} output:\n{_read(logs[r])[-4000:]}")
            check(False, f"{what}: ranks {bad} exited {[procs[r].poll() for r in bad]} "
                         f"without their records (or the deadline passed)")
        time.sleep(0.05)
    return [torch.load(p, weights_only=False) for p in paths]


def stop_mesh_serve_pair(pair) -> None:
    for p in pair["procs"]:
        _stop(p)
    shutil.rmtree(pair["root"], ignore_errors=True)


def mesh_serve_phase(dev, pair, phase4, timeout=300) -> dict:
    """Phase 37: let the pair of :func:`start_group` go and hold
    its records.  Both ranks exit 0 in time.  (a) Every request of phase 4's
    traffic completes with finite logits on both ranks, the ranks' streams
    are equal, each rank's flash and paged launches equal phase 4's
    (``phase4``: its (flash, paged) counts and decode ticks) and the
    derivation (layers x cold long prompts, layers x ticks), and every
    decode tick makes 2 x 22 + 1 all-reduces and 1 all-gather, and the
    first decode tick's logits lie within ``MESH_BF16_LOGIT_TOL`` of phase
    4's (``phase4["first_tick"]``) on at least half of its rows; tokens/s,
    the host wall a tick and each rank's peak memory are printed.  In (a),
    (b) and (c) every prefill and prefix-reuse extend gathers its logits as
    one ``[B, V]`` block on each rank (the last position's: the vocabulary
    stays split up to it, as in the reference).  (b) The
    1x2 streams equal the 1x1 streams before and after the swap, on both
    ranks, the first decode tick's logits lie within ``MESH_LOGIT_TOL``,
    and the pools hold 2 of TinyLlama's 4 K/V heads a rank.  (c) Phi-3.5-
    MoE's 1x2 streams equal the 1x1 streams, each rank holds 8 of the 16
    experts, and rank 0's dropped-routing tally equals the one-process
    tally while rank 1's is empty.  Returns rank 0's (a) launches (path
    ``serve_mesh``).  The ranks go on with phase 40(a) beside phases 38-39
    (:func:`phase40`)."""
    from repro_torch.configs import get_config

    _free()
    with open(pair["after"], "w"):
        pass
    t = time.time()
    procs, logs = pair["procs"], pair["logs"]
    try:
        recs = _wait_records(procs, logs, [os.path.join(pair["root"], f"rank{r}.pt")
                                           for r in range(2)], t + timeout, "phase 37")
        wall = time.time() - t
        log(_read(logs[0]).strip())
    except BaseException:
        stop_mesh_serve_pair(pair)
        raise
    full = get_config("tinyllama-1.1b")
    L = full.n_layers
    log(f"[mesh] two processes on one card: backend {recs[0]['backend']}, devices "
        f"{[r['device'] for r in recs]}; {wall:.1f}s from the go (each rank "
        f"{[round(r['total_s'], 1) for r in recs]}s; imports {[round(r['start_s'], 1) for r in recs]}s "
        f"before it, overlapping earlier phases)")
    check(all(r["backend"] == "gloo" for r in recs), "the shared card's backend is not gloo")

    # (a) TinyLlama-1.1B at full width, bf16, phase 4's traffic
    warm = {b for _, b in BF16_SHARED}
    cold_long = sum(1 for i, n in enumerate(BF16_LENGTHS)
                    if i not in warm and n > max(128, full.attn_block_k))
    want_coll = {"all_reduce": 2 * L + 1, "all_gather": 1}
    for r, rec in enumerate(recs):
        a = rec["a"]
        fl, pg = a["launches"]["flash_attention_fwd"], a["launches"]["paged_attention_decode"]
        tw = np.asarray(a["tick_s"])
        log(f"[mesh] (a) rank {r}: tinyllama-1.1b {L}L bf16 on 1x2: {a['n_done']} requests, "
            f"{a['tokens']} tokens in {a['wall']:.3f}s ({a['tokens'] / a['wall']:.1f} tok/s), "
            f"{len(a['ticks'])} decode ticks, host wall a tick mean {tw.mean() * 1e3:.2f} ms "
            f"(p50 {np.median(tw) * 1e3:.2f}, max {tw.max() * 1e3:.2f}); collectives a tick "
            f"{a['ticks'][0]} (derived {want_coll}), in all {a['collectives']}; launches "
            f"(flash, paged)=({fl}, {pg}) (phase 4: {phase4['counts']}); pools hold "
            f"{a['pool_kv_heads']} of {full.n_kv_heads} K/V heads; max_memory_allocated "
            f"{a['peak_gib']:.2f} GiB; stats {a['stats']}")
        check(a["n_done"] == len(BF16_LENGTHS) and not a["rejected"]
              and all(n == 32 for n in a["lens"]), f"(a) rank {r} lost requests")
        check(a["finite"], f"(a) rank {r}: non-finite logits")
        check(a["saved"] == 256 * len(BF16_SHARED), f"(a) rank {r}: prefix reuse saved "
                                                    f"{a['saved']} tokens")
        check(len(a["ticks"]) == phase4["ticks"],
              f"(a) rank {r}: {len(a['ticks'])} decode ticks, phase 4 made {phase4['ticks']}")
        check((fl, pg) == (L * cold_long, L * len(a["ticks"])) == tuple(phase4["counts"]),
              f"(a) rank {r}: launches {(fl, pg)} != derivation "
              f"{(L * cold_long, L * len(a['ticks']))} / phase 4 {phase4['counts']}")
        check(all(t == want_coll for t in a["ticks"]),
              f"(a) rank {r}: collectives a tick {a['ticks'][:3]} != {want_coll}")
        check(a["pool_kv_heads"] == full.n_kv_heads // 2, f"(a) rank {r}: pools not sharded")
    # the prefill's and the extend's logits stay split up to the last position
    V = full.padded_vocab
    for r, rec in enumerate(recs):
        ok, kinds, shapes, pre_s = _prefill_gathers(rec["a"], V)
        log(f"[mesh] (a) rank {r}: logits gathered as {shapes} in {kinds['prefill']} "
            f"prefills and {kinds['extend']} extends (the last position's [B, V] only), "
            f"their host wall {pre_s:.3f}s")
        check(ok and min(kinds.values()) > 0,
              f"(a) rank {r}: a prefill or extend gathered {rec['a']['prefills']}, not [B, V]")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    tw0 = np.asarray(recs[0]["a"]["tick_s"]) * 1e3
    log(f"[mesh] phase 37 on {smi}: {wall:.1f}s from the go, (a)'s prefills and extends "
        f"{_prefill_gathers(recs[0]['a'], V)[3]:.3f}s of host wall, the gloo tick mean "
        f"{tw0.mean():.1f} ms (rank 0); with every position's logits gathered it read "
        f"27.5-70.2 s, tick 120.8-422.4 ms (NVIDIA H100 80GB HBM3, 700.00 W)")
    check(recs[0]["a"]["streams"] == recs[1]["a"]["streams"], "(a): the ranks' streams differ")
    agree = sum(recs[0]["a"]["streams"][i] == s for i, s in phase4["streams"].items())
    log(f"[mesh] (a) the ranks' streams are equal; {agree} of {len(phase4['streams'])} equal "
        f"phase 4's one-process bf16 streams (the split products round twice, and a stream "
        f"may part at a near-tie)")
    want_rows = phase4["first_tick"]["tokens"].shape[0]
    for r, rec in enumerate(recs):
        gap, rows = _tick_gap(rec["a"]["first_tick"], phase4["first_tick"])
        log(f"[mesh] (a) rank {r}: the first decode tick's logits against phase 4's one "
            f"process: gap {gap:.4e} over {rows} of {want_rows} rows (tolerance "
            f"{MESH_BF16_LOGIT_TOL})")
        check(gap <= MESH_BF16_LOGIT_TOL and 2 * rows >= want_rows,
              f"(a) rank {r}: first-tick logits gap {gap} over {rows} of {want_rows} rows")

    # (b) f32: 1x2 against 1x1, and after a swap
    b0 = recs[0]["b"]
    for key in ("mesh", "mesh_swap"):
        want = b0["one" if key == "mesh" else "one_swap"]
        for r in range(2):
            got = recs[r]["b"][key]
            check(got["n_done"] == len(MESH_F32_LENGTHS) and got["finite"],
                  f"(b) rank {r} {key}: lost requests or non-finite logits")
            check(got["streams"] == want["streams"],
                  f"(b) rank {r} {key}: the streams differ: {got['streams']} against "
                  f"{want['streams']}")
        gap, rows = _tick_gap(b0[key]["first_tick"], want["first_tick"])
        log(f"[mesh] (b) {key}: f32 1x2 streams equal 1x1 on both ranks "
            f"({len(want['streams'])} requests); first decode tick's logits gap {gap:.3e} "
            f"over {rows} rows (tolerance {MESH_LOGIT_TOL}); launches 1x2 {b0[key]['launches']}")
        check(gap <= MESH_LOGIT_TOL and rows == len(MESH_F32_LENGTHS),
              f"(b) {key}: first-tick logits gap {gap} over {rows} rows")
        check(min(b0[key]["launches"]["flash_attention_fwd"],
                  b0[key]["launches"]["paged_attention_decode"]) > 0,
              f"(b) {key}: the mesh run did not reach both kernels")
        for r in range(2):
            ok, kinds, shapes, _ = _prefill_gathers(recs[r]["b"][key], V)
            check(ok and min(kinds.values()) > 0,
                  f"(b) rank {r} {key}: prefills and extends gathered {shapes}, {kinds}")
    check(all(r["b"]["pool_kv_heads"] == 2 for r in recs), "(b): pools not 2 K/V heads a rank")

    # (c) Phi-3.5-MoE: experts split
    c0 = recs[0]["c"]
    for r in range(2):
        c = recs[r]["c"]
        check(c["experts_local"] == 8, f"(c) rank {r} holds {c['experts_local']} experts")
        check(c["mesh"]["n_done"] == len(MESH_MOE_LENGTHS) and c["mesh"]["finite"],
              f"(c) rank {r}: lost requests or non-finite logits")
        check(c["mesh"]["streams"] == c0["one"]["streams"],
              f"(c) rank {r}: the streams differ: {c['mesh']['streams']} against "
              f"{c0['one']['streams']}")
        ok, kinds, shapes, _ = _prefill_gathers(c["mesh"], get_config(PHI).padded_vocab)
        check(ok and min(kinds.values()) > 0,
              f"(c) rank {r}: prefills and extends gathered {shapes}, {kinds}")
    check(c0["mesh"]["dropped"] == c0["one"]["dropped"] and recs[1]["c"]["mesh"]["dropped"] == {},
          f"(c) dropped routings: rank 0 {c0['mesh']['dropped']}, rank 1 "
          f"{recs[1]['c']['mesh']['dropped']}, one process {c0['one']['dropped']}")
    log(f"[mesh] (c) phi3.5-moe 2L f32 on 1x2, 8 of 16 experts a rank: streams equal the "
        f"one-process server's on both ranks; routings dropped for capacity by step kind "
        f"(dropped, made) rank 0 {c0['mesh']['dropped']} = one process, rank 1 none; "
        f"collectives {c0['mesh']['collectives']}, a decode tick {c0['mesh']['ticks'][0]}")
    check(all(t == {"all_reduce": 2 + 2 + 1, "all_gather": 2 + 1}
              for t in c0["mesh"]["ticks"]), f"(c) collectives a tick {c0['mesh']['ticks'][:3]}")
    return recs[0]["a"]["launches"], recs


# ---------------------------------------------------------------------------
# phase 38: the "model" axis in training -- two processes sharing the card on a
# 1x2 mesh (gloo with CUDA tensors)

# (a) GPT-Base at full width, all 12 layers, through the launcher's main: the
# V-cycle at 2 steps (1 + 1 + 2: one coalescing, one de-coalescing) at 2 x 1024
# (it took 4 steps, 1 + 2 + 4, before they were cut for the script's time)
TRAIN_MESH_ARGS = ["--arch", "gpt-base", "--vcycle", "--steps", "2", "--batch", "2",
                   "--seq", "1024", "--lr", "6e-4", "--ckpt-every", "1000"]
# (b) Phi-3.5-MoE at full width, 1 layer of 16 experts (8 a rank), f32, 1 x 1024
TRAIN_MESH_MOE_STEPS = 2
# (a)'s first step (loss, grad_norm) and the restored eval loss against one
# process at bf16, relative.  scripts/train_mesh_gaps.py (NVIDIA H100 80GB
# HBM3, 700 W): the first loss is bit-equal; the first grad_norm lies 7.9e-4
# from one process's clean, 1.24e-2 with layer 0's FFN entry sum dropped,
# 0.28 with the norm not summed over "model", 0.42 with every entry sum
# dropped: 5.1x the clean gap, 3.1x below the least planted fault
TRAIN_MESH_TOL = 4e-3
# (b) at f32, relative: the expert-parallel sums in other orders
TRAIN_MESH_MOE_TOL = 1e-4
# (a)'s first-step peak a rank with the logits gathered whole before the
# loss, GiB (NVIDIA H100 80GB HBM3, 700 W): the split loss's is printed beside it
TRAIN_MESH_PEAK_GATHERED = 2.77


def train_mesh_tc(args):
    """The ``TrainConfig`` the launcher's ``main`` builds from ``args``."""
    from repro_torch.config import TrainConfig

    arg = lambda flag: args[args.index(flag) + 1]
    steps = int(arg("--steps"))
    return TrainConfig(steps=steps, warmup_steps=max(steps // 20, 1), peak_lr=float(arg("--lr")),
                       batch_size=int(arg("--batch")), seq_len=int(arg("--seq")), seed=0)


def _on_model(spec) -> bool:
    """Whether a ``logical_spec`` tuple splits a dimension over "model"."""
    return any("model" in ((e,) if isinstance(e, str) else e or ()) for e in spec)


def _mesh_collectives(cfg, m=2) -> dict:
    """Collectives a train step makes on a "model" axis of ``m`` (every
    width divisible): the embedding's sum, a sum after each attention and
    FFN layer, the loss's max and sum over the vocabulary blocks (the
    logits stay split: no gather), in the backward each layer's entry sums
    (attention: its input, and ``q_norm``/``k_norm``; the FFN's input) and
    the logits' entry, and the clipping norm's one sum.  Under remat "full"
    the backward recomputes each block only as far as the tensors it saved:
    the attention's sum again, not the FFN's, which ends the block."""
    L = cfg.n_layers
    fwd = 2 * L + (L if cfg.remat == "full" else 0) + 2
    bwd = L * (1 + 2 * cfg.qk_norm) + L + 1
    return {"all_reduce": 1 + fwd + bwd + 1, "all_gather": 0}


def _warm_train(dev) -> None:
    """A fresh process's one-time costs, paid before it is let go: one
    GPT-Base layer's train step at full width on 1 x 1024 (bf16, remat
    "full", the flash kernels), uncounted."""
    from repro_torch.models.api import build_model, init_train_state, make_train_step

    cfg = _paper("gpt-base", 1)
    tc = train_mesh_tc(TRAIN_MESH_ARGS)
    tc = dataclasses.replace(tc, batch_size=1)
    model = build_model(cfg)
    params, opt = init_train_state(model, tc, torch.Generator(device=dev).manual_seed(1))
    tokens = torch.randint(0, cfg.vocab_size, (1, tc.seq_len), device=dev)
    with _uncounted():
        make_train_step(model, tc)(params, opt, {"tokens": tokens, "labels": tokens})
    torch.cuda.synchronize(dev)
    del params, opt
    torch.cuda.empty_cache()


def train_mesh_worker(rank: int, coordinators: str, out_dir: str, after: str) -> int:
    """One rank of phase 38 (``chip_smoke.py --train-mesh-rank R ...``),
    started early: it imports the port, warms up, waits for ``after``, then
    (a) runs the launcher's ``main`` with ``TRAIN_MESH_ARGS --mesh 1x2`` into
    ``out_dir/ckpt``, each step timed with its launches, collectives and
    their host time, each transition with its launches and the gather's
    time, the first step's peak memory, and at the end the eval loss of one
    batch on the sharded weights; (b) on a new group, Phi-3.5-MoE's
    expert-parallel steps.  Writes ``out_dir/rank{R}.pt``."""
    import torch.distributed as dist

    from repro_torch.core import operators as O
    from repro_torch.core import vcycle as V
    from repro_torch.distributed import multiprocess as MP
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.distributed.sharding import mesh_ctx
    from repro_torch.kernels.build import load_library
    from repro_torch.launch import train as T
    from repro_torch.models.api import build_model, make_eval_loss
    from repro_torch.param import flatten

    entry, parent = time.time(), os.getppid()
    load_library()
    _warm_train(torch.device("cuda", 0))
    while not os.path.exists(after):
        check(os.getppid() == parent, "phase 38: the script that started this rank is gone")
        time.sleep(0.01)
    go = time.time()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    coord_a, coord_b = coordinators.split(",")
    rec = {"start_s": go - entry, "steps": [], "transitions": []}
    comm = {"s": 0.0}
    real = {"all_reduce": dist.all_reduce, "all_gather": dist.all_gather}

    def timed(name):
        def call(*a, **k):
            t = time.time()
            out = real[name](*a, **k)
            comm["s"] += time.time() - t
            return out
        return call

    dist.all_reduce, dist.all_gather = timed("all_reduce"), timed("all_gather")
    # gathers whose result spans the padded vocabulary: the logits whole
    logit_gathers, vocab, gather_cat = {"n": 0}, _paper("gpt-base").padded_vocab, \
        tp.all_gather_cat

    def counting_gather(x, dim=-1, axes=tp.MODEL):
        out = gather_cat(x, dim, axes)
        logit_gathers["n"] += out.shape[dim] == vocab
        return out

    tp.all_gather_cat = counting_gather

    def snap():
        torch.cuda.synchronize()
        return _launches(), tp.counts(), comm["s"], time.time()

    def diff(a, b):
        return ({k: b[0][k] - a[0][k] for k in a[0]}, {k: b[1][k] - a[1][k] for k in a[1]},
                b[2] - a[2], b[3] - a[3])

    step_fn, transition, run = V.VCycleRunner.step_fn, V.VCycleRunner._transition, \
        V.VCycleRunner.run

    def timed_step_fn(self, level):
        fn = step_fn(self, level)
        if getattr(fn, "timed", False):
            return fn

        def one(p, o, b):
            first = not rec["steps"]
            if first:
                torch.cuda.reset_peak_memory_stats()
            a, g0 = snap(), logit_gathers["n"]
            p, o, m = fn(p, o, b)
            k, c, cs, wall = diff(a, snap())
            rec["steps"].append({"level": level, "launches": k, "collectives": c,
                                 "comm_s": cs, "wall_s": wall, "loss": float(m["loss"]),
                                 "grad_norm": float(m["grad_norm"]),
                                 "logit_gathers": logit_gathers["n"] - g0})
            if first:
                rec["peak_first_step_gib"] = torch.cuda.max_memory_allocated() / 2**30
            return p, o, m

        one.timed = True
        self._step_fns[level] = one
        return one

    gathered = {"s": 0.0}
    gather_tree = MP.gather_global_tree

    def timed_gather(*a, **k):
        torch.cuda.synchronize()
        t = time.time()
        out = gather_tree(*a, **k)
        torch.cuda.synchronize()
        gathered["s"] += time.time() - t
        return out

    def timed_transition(self, state, plan, params):
        a, g0 = snap(), gathered["s"]
        out = transition(self, state, plan, params)
        k, c, cs, wall = diff(a, snap())
        if plan.phase != "final":
            rec["transitions"].append({"phase": plan.phase, "level": plan.level,
                                       "launches": k, "collectives": c, "wall_s": wall,
                                       "gather_s": gathered["s"] - g0})
        return out

    def run_and_eval(self, **kw):
        out = run(self, **kw)
        # the sharded weights' eval loss on one batch, while the group is up
        model, batch = self.models[0], self.batch_fn(1000)
        with mesh_ctx(self.mesh), _uncounted():
            rec["eval_loss"] = float(make_eval_loss(model)(out.params, batch)["loss"])
        psh = self.level_shardings(0)[0]
        rec["local"] = {k: (tuple(v.shape), _params_digest({"x": v}))
                        for k, v in flatten(out.params).items()}
        rec["split"] = [k for k, sp in flatten(psh).items() if _on_model(sp)]
        rec["n_compiles"] = self.n_compiles
        return out

    V.VCycleRunner.step_fn, V.VCycleRunner._transition = timed_step_fn, timed_transition
    V.VCycleRunner.run = run_and_eval
    O.gather_global_tree = MP.gather_global_tree = timed_gather
    _reset_counters()
    tp.reset_counts()
    t = time.time()
    out = T.main(TRAIN_MESH_ARGS + ["--ckpt-dir", os.path.join(out_dir, "ckpt"), "--mesh", "1x2",
                                    "--num-processes", "2", "--process-id", str(rank),
                                    "--coordinator", coord_a])
    rec["a_s"] = time.time() - t
    rec["loss"] = out.history.loss
    rec["launches"] = _launches()
    rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del out
    _free()

    # (b) Phi-3.5-MoE: two expert-parallel steps on a new group
    from repro_torch.distributed import gather_global_tree, put_global_tree
    from repro_torch.launch.mesh import init_distributed, make_cli_mesh
    from repro_torch.models.api import make_train_step, train_state_shardings
    from repro_torch.optim import adamw_init

    init_distributed(coord_b, 2, rank, device="cuda")
    mesh = make_cli_mesh("1x2", num_processes=2, device="cuda")
    cfg, tc, batches = _moe_mesh_setup()
    model = build_model(cfg)
    psh, _ = train_state_shardings(model, tc, mesh)
    params = put_global_tree(model.init(torch.Generator(device="cuda").manual_seed(SEED + 38)),
                             psh, mesh)
    _free()
    step = make_train_step(model, tc, mesh=mesh)
    opt, rec["b"] = adamw_init(params, tc), {"steps": []}
    _reset_counters()
    for i in range(TRAIN_MESH_MOE_STEPS):
        a = snap()
        params, opt, m = step(params, opt, batches(i))
        k, c, cs, wall = diff(a, snap())
        rec["b"]["steps"].append({"launches": k, "collectives": c, "comm_s": cs,
                                  "wall_s": wall, **{n: float(v) for n, v in m.items()}})
    router = "stages/stage_0/b0/ffn/router"
    whole = flatten(gather_global_tree(params, psh, mesh))[router]
    rec["b"]["router"] = _params_digest({"r": whole})
    rec["b"]["experts_local"] = flatten(params)["stages/stage_0/b0/ffn/w_gate"].shape[1]
    rec["b"]["launches"] = _launches()
    rec["total_s"] = time.time() - go
    dist.destroy_process_group()
    torch.save(rec, os.path.join(out_dir, f"rank{rank}.pt"))
    return 0


def _moe_mesh_setup():
    """(config, TrainConfig, step -> batch) of phase 38(b)."""
    from repro_torch.config import TrainConfig
    from repro_torch.launch.train import make_batch_fn

    cfg = _paper(PHI, 1, compute_dtype=torch.float32)
    tc = TrainConfig(steps=TRAIN_MESH_MOE_STEPS, warmup_steps=1, eps=1e-4, batch_size=1,
                     seq_len=1024)
    return cfg, tc, make_batch_fn(cfg, tc, device="cuda")


def train_mesh_phase(dev, pair, timeout=300) -> dict:
    """Phase 38: let :func:`start_group`'s ranks go; meanwhile
    take one process's first GPT-Base step on the same weights and batch,
    and one process's Phi-3.5-MoE steps.  Both ranks exit 0 in time.
    (a) The first step's loss and grad_norm lie within ``TRAIN_MESH_TOL`` of
    one process's; the ranks' losses are equal, their replicated leaves
    bit-identical at the end and each split leaf half-size; each rank's
    first-step peak is below one process's; every step makes the derived
    collectives at its level; each step's flash launches, each
    transition's coalesce_pair and interp_axpy launches, and the run's
    total equal the schedule's; each level's step is built once; the run's
    terminal checkpoint restores here on one device and its eval loss on
    one batch equals rank 0's within ``TRAIN_MESH_TOL``.  (b) Phi-3.5-MoE's
    losses lie within ``TRAIN_MESH_MOE_TOL`` of one process's; loss,
    ``moe_aux`` and grad_norm are bit-equal across ranks, and so is the
    gathered router; each rank holds 8 of 16 experts.  Returns the paths'
    launches (rank 0's)."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.config import MultiLevelConfig
    from repro_torch.core.vcycle import VCycleRunner
    from repro_torch.launch.train import make_batch_fn
    from repro_torch.models.api import (build_model, init_train_state, make_eval_loss,
                                        make_train_step, zero_train_state)
    from repro_torch.optim import adamw_init
    from repro_torch.param import flatten

    _free()
    with open(pair["after"], "w"):
        pass
    t = time.time()
    procs, logs = pair["procs"], pair["logs"]
    cfg, tc = _paper("gpt-base"), train_mesh_tc(TRAIN_MESH_ARGS)
    model = build_model(cfg)
    batch_fn = make_batch_fn(cfg, tc, device=dev)
    try:
        # (a) one process's first steps, here, beside the ranks
        params, opt = init_train_state(model, tc, torch.Generator(device=dev).manual_seed(tc.seed))
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        one, step = {"step_s": []}, make_train_step(model, tc)
        with _uncounted():
            for i in range(2):
                t1 = time.time()
                _, _, m1 = step(params, opt, batch_fn(i))
                torch.cuda.synchronize(dev)
                one["step_s"].append(time.time() - t1)
                if i == 0:
                    one.update(loss=float(m1["loss"]), grad_norm=float(m1["grad_norm"]),
                               peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30)
        one["bytes"] = sum(v.numel() * v.element_size() for v in flatten(params).values())
        del params, opt
        _free()
        # (b) one process's Phi-3.5-MoE steps
        mcfg, mtc, mbatches = _moe_mesh_setup()
        mmodel = build_model(mcfg)
        mp = mmodel.init(torch.Generator(device=dev).manual_seed(SEED + 38))
        mstep, mo, moe_one = make_train_step(mmodel, mtc), adamw_init(mp, mtc), []
        with _uncounted():
            for i in range(TRAIN_MESH_MOE_STEPS):
                mp, mo, mm = mstep(mp, mo, mbatches(i))
                moe_one.append({k: float(v) for k, v in mm.items()})
        router_one = _params_digest({"r": flatten(mp)["stages/stage_0/b0/ffn/router"]})
        del mp, mo, mstep
        _free()
        deadline = t + timeout
        for p in procs:
            try:
                p.wait(timeout=max(1.0, deadline - time.time()))
            except subprocess.TimeoutExpired:
                pass
        wall = time.time() - t
        for r, p in enumerate(procs):
            if p.poll() != 0:
                log(f"[train-mesh] rank {r} output:\n{_read(logs[r])[-4000:]}")
            check(p.poll() == 0, f"phase 38: rank {r} exited {p.poll()} (None: still "
                                 f"running after {timeout}s)")
        recs = [torch.load(os.path.join(pair["root"], f"rank{r}.pt"), weights_only=False)
                for r in range(2)]
        # the terminal checkpoint on one device, here
        like, _ = zero_train_state(model, tc, device="meta")
        restored, meta = CheckpointManager(os.path.join(pair["root"], "ckpt")).restore(
            {"params": like}, device=dev)
        check(meta["phase"] == "done", f"(a) the last checkpoint is {meta.get('phase')}")
        with _uncounted():
            eval_one = float(make_eval_loss(model)(restored["params"], batch_fn(1000))["loss"])
        del restored
    finally:
        for p in procs:
            _stop(p)
        shutil.rmtree(pair["root"], ignore_errors=True)
        _free()
    log(f"[train-mesh] two processes on one card, 1x2: {wall:.1f}s from the go (each rank "
        f"{[round(r['total_s'], 1) for r in recs]}s, (a) {[round(r['a_s'], 1) for r in recs]}s; "
        f"imports {[round(r['start_s'], 1) for r in recs]}s before it, overlapping earlier "
        f"phases)")

    # (a) GPT-Base through the launcher
    runner = VCycleRunner(cfg, MultiLevelConfig(n_levels=2, alpha=0.25), tc, None, device=dev)
    want = _schedule_launches(runner, tc)
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30)
    for r, rec in enumerate(recs):
        s0 = rec["steps"][0]
        gaps = {"loss": rel(s0["loss"], one["loss"]),
                "grad_norm": rel(s0["grad_norm"], one["grad_norm"]),
                "eval": rel(rec["eval_loss"], eval_one)}
        for i, st in enumerate(rec["steps"]):
            c = runner.cfgs[st["level"]]
            log(f"[train-mesh] (a) rank {r} step {i} (level {st['level']}): "
                f"{st['wall_s'] * 1e3:.1f} ms, collectives {st['collectives']} in "
                f"{st['comm_s'] * 1e3:.1f} ms of host, logits all-gathers "
                f"{st['logit_gathers']}, launches "
                f"{ {k: v for k, v in st['launches'].items() if v} }, loss {st['loss']:.5f}")
            check(st["logit_gathers"] == 0,
                  f"(a) rank {r} step {i}: {st['logit_gathers']} gathers of the logits")
            check(st["collectives"] == _mesh_collectives(c),
                  f"(a) rank {r} step {i}: collectives {st['collectives']} != "
                  f"{_mesh_collectives(c)}")
            nonzero = lambda d: {k: v for k, v in d.items() if v}
            check(nonzero(st["launches"]) == nonzero(_step_launches(c, tc, 1)),
                  f"(a) rank {r} step {i}: launches {st['launches']} != "
                  f"{_step_launches(c, tc, 1)}")
        for tr in rec["transitions"]:
            log(f"[train-mesh] (a) rank {r} {tr['phase']} transition at level {tr['level']}: "
                f"{tr['wall_s']:.3f}s, of it the gather {tr['gather_s']:.3f}s; launches "
                f"{ {k: v for k, v in tr['launches'].items() if v} }")
            l = tr["level"]
            n_want = ({"coalesce_pair": width_pairs(runner.specs[l], runner.proj_plans[l])}
                      if tr["phase"] == "down" else
                      {"interp_axpy": len(flatten(runner.specs[l - 1]))})
            check({k: v for k, v in tr["launches"].items() if v} == n_want,
                  f"(a) rank {r} transition {tr}: launches != {n_want}")
        log(f"[train-mesh] (a) rank {r}: first step loss {s0['loss']:.6f} grad_norm "
            f"{s0['grad_norm']:.6f} against one process {one['loss']:.6f} "
            f"{one['grad_norm']:.6f}; eval loss of the last checkpoint {rec['eval_loss']:.6f} "
            f"against the restore here {eval_one:.6f}; relative gaps "
            f"{ {k: f'{v:.3e}' for k, v in gaps.items()} } (tolerance {TRAIN_MESH_TOL}); "
            f"first-step peak {rec['peak_first_step_gib']:.2f} GiB (one process "
            f"{one['peak_gib']:.2f}; {TRAIN_MESH_PEAK_GATHERED} with the logits gathered "
            f"whole), run peak {rec['peak_gib']:.2f} GiB; one process's "
            f"level-0 steps here (beside the ranks) {[round(x * 1e3, 1) for x in one['step_s']]} "
            f"ms; launches {rec['launches']} (schedule {want})")
        check(all(g <= TRAIN_MESH_TOL for g in gaps.values()), f"(a) rank {r}: gaps {gaps}")
        check(rec["peak_first_step_gib"] < one["peak_gib"],
              f"(a) rank {r}: peak {rec['peak_first_step_gib']} not below one process's")
        check(rec["launches"] == want, f"(a) rank {r}: launches {rec['launches']} != {want}")
        check(rec["n_compiles"] == 2 and all(np.isfinite(rec["loss"])),
              f"(a) rank {r}: steps built {rec['n_compiles']}, losses {rec['loss']}")
    a0, a1 = recs
    check(a0["loss"] == a1["loss"], "(a) the ranks' losses differ")
    whole = {k: tuple(s.shape) for k, s in flatten(model.specs()).items()}
    local_bytes = 0
    for k, (shape, digest) in a0["local"].items():
        if k in a0["split"]:
            check(2 * int(np.prod(shape)) == int(np.prod(whole[k])),
                  f"(a) split leaf {k}: {shape} of {whole[k]}")
        else:
            check(shape == whole[k] and digest == a1["local"][k][1],
                  f"(a) replicated leaf {k} differs across the ranks")
        local_bytes += int(np.prod(shape)) * 4
    log(f"[train-mesh] (a) replicated leaves bit-identical on both ranks; {len(a0['split'])} "
        f"split leaves half-size: a rank's parameters {local_bytes / 1e6:.1f} MB against one "
        f"process's {one['bytes'] / 1e6:.1f} MB")

    # (b) Phi-3.5-MoE, experts split
    b0, b1 = recs[0]["b"], recs[1]["b"]
    for i in range(TRAIN_MESH_MOE_STEPS):
        g = {k: rel(b0["steps"][i][k], moe_one[i][k]) for k in ("loss", "moe_aux", "grad_norm")}
        log(f"[train-mesh] (b) phi3.5-moe 1L f32 step {i}: ranks loss {b0['steps'][i]['loss']:.6f}"
            f" moe_aux {b0['steps'][i]['moe_aux']:.6f}, one process "
            f"{moe_one[i]['loss']:.6f} {moe_one[i]['moe_aux']:.6f}; relative gaps "
            f"{ {k: f'{v:.3e}' for k, v in g.items()} }; {b0['steps'][i]['wall_s'] * 1e3:.1f} "
            f"ms, collectives {b0['steps'][i]['collectives']} in "
            f"{b0['steps'][i]['comm_s'] * 1e3:.1f} ms of host")
        check(all(v <= TRAIN_MESH_MOE_TOL for v in g.values()), f"(b) step {i}: gaps {g}")
        check(all(b0["steps"][i][k] == b1["steps"][i][k] for k in ("loss", "moe_aux",
                                                                   "grad_norm")),
              f"(b) step {i}: the ranks' metrics differ")
    check(b0["router"] == b1["router"], "(b) the ranks' gathered routers differ")
    check(b0["experts_local"] == b1["experts_local"] == 8,
          f"(b) experts a rank {b0['experts_local']}")
    log(f"[train-mesh] (b) 8 of 16 experts a rank; loss, moe_aux and grad_norm bit-equal on "
        f"both ranks, the gathered routers equal (one process's router digest "
        f"{router_one[:8]}, the ranks' {b0['router'][:8]})")
    return {"train_mesh": recs[0]["launches"], "train_mesh_moe": b0["launches"]}


# ---------------------------------------------------------------------------
# phase 39: FSDP in training (the train state split over "data") and the
# recurrent and cross-attention families on a "model" axis -- two processes
# sharing the card (gloo with CUDA tensors)

# (a) GPT-Base at full width, all 12 layers, bf16, remat "full", through the
# launcher's V-cycle on --mesh 2x1 (the default --grad-compression none):
# phase 38's schedule (1 + 1 + 2 steps: one coalescing, one de-coalescing) at
# 2 x 1024, a row a rank.  (b) two steps with TrainConfig.pregather_params
FSDP_ARGS = TRAIN_MESH_ARGS
FSDP_PREGATHER_STEPS = 2
# (a)'s first step and (b)'s two steps (loss, grad_norm) and the terminal
# checkpoint's eval loss against one process at bf16, relative.
# scripts/fsdp_gaps.py (NVIDIA H100 80GB HBM3, 700 W): the first loss is
# bit-equal; the grad norms lie 8.2e-5 (first) and 1.4e-4 (second) from one
# process's per layer, 8.9e-5 and 3.7e-4 with pregather_params; with the last
# layer's reduce-scatter skipped 2.0e-3 and 1.8e-3, the embedding's blocks
# swapped 5.3e-2 and 8.3e-2 (its first loss 9.0e-4), the division dropped
# 0.99: 2.2x the largest clean gap, 2.3x below the least planted fault
FSDP_TOL = 8e-4
# (c) the families on 1x2, two steps each against one process: the split
# sums in other orders; per step (loss, grad_norm), relative; None: printed,
# not held (every value must be finite).  Jamba and Whisper at f32 read 0 to
# 8.8e-8 (NVIDIA H100 80GB HBM3, 700 W).  xLSTM-125m runs at f64, because at
# full width its recurrence amplifies rounding; scripts/xlstm_mesh_gaps.py
# (same card) shows it on ONE process: computing the heads as the 1x2
# split's two halves moves the first grad norm by 0.676 at f32 (the 1x2 run
# reads 0.676) and by 2.8e-6 at f64 (1x2: 2.7e-6; the first loss 5.3e-11
# both); w_down scaled by 1 + 2^-52 moves it by 7.0e-6 and the second
# step's loss and grad norm by 9.1e-5 and 0.24 (by 1 + 2^-23: 2.6e-4 and
# 2.3; the clipping norm summed in reverse order: 5.0e-5 and 0.92).  The
# faults planted on 1x2 at f64 read (first loss, first grad norm): the
# sLSTM's enter_split dropped 5.3e-11, 5.2e-2; the mLSTM's 5.3e-11, 8.8e-2;
# each rank's two sLSTM heads swapped in w_down 2.8e-7, 0.53.  So the first
# step is held between them (4e-9: 75x the rounding reading, 70x below the
# swap; 6e-4: 86x the largest rounding reading, 87x below the least fault);
# the second loss only above every rounding reading (the faults' 1.4e-5 to
# 5.9e-4 lie inside rounding's spread), its grad norm printed.
FAMILY_MESH_TOL = {"xlstm": ((4e-9, 6e-4), (1e-3, None)),
                   "jamba": ((1e-5, 1e-5),) * 2, "whisper": ((1e-5, 1e-5),) * 2}
FAMILY_MESH_STEPS = 2


def _fsdp_collectives(cfg, remat=True) -> dict:
    """``distributed/fsdp.py``'s collectives a per-layer FSDP step makes: a
    gather a layer and one for the leaves outside the stacks, a layer's
    again in a remat backward, a reduce-scatter for each of them; one label
    count (GPT-Base has no MTP head and no MoE layer)."""
    L = sum(st.repeats * len(st.pattern) for st in cfg.stages) + cfg.n_encoder_layers
    return {"all_gather": L + 1 + (L if remat else 0), "reduce_scatter": L + 1,
            "batch_mean": 1}


def _family_cuts():
    """Phase 39(c)'s configs at full width: xLSTM-125m cut to one mLSTM and
    one sLSTM block (2 x 32, f64 weights, compute and moments), and at f32
    Jamba-1.5-Large's Mamba block with its
    dense FFN (no MoE layer left: ``n_experts`` 0; 1 x 64), Whisper-large-v3
    cut to one encoder and one decoder
    layer (1 x 128 tokens on its 1500 frames); each with its TrainConfig."""
    from repro_torch.config import Stage, TrainConfig
    from repro_torch.configs import get_config

    f32, f64 = dict(compute_dtype=torch.float32), torch.float64
    xl = get_config(XLSTM)
    jb = get_config(JAMBA)
    tc = lambda b, s, **kw: TrainConfig(steps=4, warmup_steps=1, eps=1e-4, batch_size=b,
                                        seq_len=s, **kw)
    return {"xlstm": (xl.replace(stages=(Stage(xl.stages[0].pattern[2:4], 1),),
                                 compute_dtype=f64, param_dtype=f64),
                      tc(2, 32, opt_dtype=f64)),
            "jamba": (jb.replace(stages=(Stage(jb.stages[0].pattern[:1], 1),), n_experts=0,
                                 **f32), tc(1, 64)),
            "whisper": (whisper_cut(1, **f32), tc(1, 128))}


def _family_batch_fn(cfg, tc, dev):
    return _normal_frames(cfg, tc, dev) if cfg.n_encoder_layers else None


def _family_steps(dev, cfg, tc, mesh=None) -> list:
    """Two steps of a phase 39(c) config from the seeded init, on one
    process or as this process's blocks on ``mesh``: each step's metrics
    (the batches from ``make_batch_fn``, Whisper's frames seeded normal
    values)."""
    from repro_torch.distributed import put_global_tree
    from repro_torch.launch.train import make_batch_fn
    from repro_torch.models.api import build_model, make_train_step, train_state_shardings
    from repro_torch.optim import adamw_init

    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(SEED + 39))
    if mesh is not None:
        params = put_global_tree(params, train_state_shardings(model, tc, mesh)[0], mesh)
    step = make_train_step(model, tc, mesh=mesh)
    batch_fn = _family_batch_fn(cfg, tc, dev) or make_batch_fn(cfg, tc, device=dev)
    opt, out = adamw_init(params, tc), []
    for i in range(FAMILY_MESH_STEPS):
        params, opt, m = step(params, opt, batch_fn(i))
        out.append({k: float(v) for k, v in m.items()})
    del params, opt
    _free()
    return out


def fsdp_worker(rank: int, coordinators: str, out_dir: str, after: str) -> int:
    """One rank of phase 39 (``chip_smoke.py --fsdp-rank R ...``), started
    early: it imports the port, warms up, waits for ``after``, then (a) runs
    the launcher's ``main`` with ``FSDP_ARGS --mesh 2x1`` into
    ``out_dir/ckpt``: each step timed with its launches, FSDP collectives
    and their host time, the first step's resident parameter and moment
    bytes and peak memory, and at the end the eval loss of one batch on the
    FSDP blocks; (b) on a new group, ``pregather_params`` steps; (c) on a
    1x2 group, the families' steps.  Writes ``out_dir/rank{R}.pt``."""
    import torch.distributed as dist

    from repro_torch.core import vcycle as V
    from repro_torch.distributed import fsdp
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.distributed.sharding import mesh_ctx
    from repro_torch.kernels.build import load_library
    from repro_torch.launch import train as T
    from repro_torch.launch.mesh import init_distributed, make_cli_mesh
    from repro_torch.models.api import build_model, make_eval_loss, make_train_step
    from repro_torch.param import flatten

    entry, parent = time.time(), os.getppid()
    dev = torch.device("cuda", 0)
    load_library()
    _warm_train(dev)
    while not os.path.exists(after):
        check(os.getppid() == parent, "phase 39: the script that started this rank is gone")
        time.sleep(0.01)
    go = time.time()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    coord_a, coord_b, coord_c = coordinators.split(",")
    rec = {"start_s": go - entry, "steps": []}
    comm = {"s": 0.0}

    def timed(fn):
        def call(*a, **k):
            t = time.time()
            out = fn(*a, **k)
            comm["s"] += time.time() - t
            return out
        return call

    fsdp._all_gather, fsdp._reduce_scatter = timed(fsdp._all_gather), timed(fsdp._reduce_scatter)
    dist.all_reduce = timed(dist.all_reduce)

    def snap():
        torch.cuda.synchronize()
        return _launches(), fsdp.counts(), comm["s"], time.time()

    def diff(a, b):
        return ({k: b[0][k] - a[0][k] for k in a[0]}, {k: b[1][k] - a[1][k] for k in a[1]},
                b[2] - a[2], b[3] - a[3])

    nbytes = lambda tree: sum(v.numel() * v.element_size() for v in flatten(tree).values()
                              if torch.is_tensor(v))
    step_fn, run = V.VCycleRunner.step_fn, V.VCycleRunner.run

    def timed_step_fn(self, level):
        fn = step_fn(self, level)
        if getattr(fn, "timed", False):
            return fn

        def one(p, o, b):
            first = not rec["steps"]
            if first:
                rec["param_bytes"], rec["moment_bytes"] = nbytes(p), nbytes({"m": o["m"],
                                                                            "v": o["v"]})
                torch.cuda.reset_peak_memory_stats()
            a = snap()
            p, o, m = fn(p, o, b)
            k, c, cs, wall = diff(a, snap())
            rec["steps"].append({"level": level, "launches": k, "collectives": c,
                                 "comm_s": cs, "wall_s": wall, "loss": float(m["loss"]),
                                 "grad_norm": float(m["grad_norm"])})
            if first:
                rec["peak_first_step_gib"] = torch.cuda.max_memory_allocated() / 2**30
            return p, o, m

        one.timed = True
        self._step_fns[level] = one
        return one

    def run_and_eval(self, **kw):
        out = run(self, **kw)
        # this rank's rows' eval loss on the FSDP blocks, gathered per layer
        with mesh_ctx(self.mesh), fsdp.fsdp_ctx(self.mesh), _uncounted():
            rec["eval_loss"] = float(make_eval_loss(self.models[0])(out.params,
                                                                    self.batch_fn(1000))["loss"])
        rec["n_compiles"] = self.n_compiles
        return out

    V.VCycleRunner.step_fn, V.VCycleRunner.run = timed_step_fn, run_and_eval
    _reset_counters()
    fsdp.reset_counts()
    t = time.time()
    out = T.main(FSDP_ARGS + ["--ckpt-dir", os.path.join(out_dir, "ckpt"), "--mesh", "2x1",
                              "--num-processes", "2", "--process-id", str(rank),
                              "--coordinator", coord_a])
    rec["a_s"] = time.time() - t
    rec["loss"] = out.history.loss
    rec["launches"] = _launches()
    rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    V.VCycleRunner.step_fn, V.VCycleRunner.run = step_fn, run
    del out
    _free()

    # (b) pregather_params: two steps from the launcher's init on the same rows
    from repro_torch.distributed import put_global_tree
    from repro_torch.models.api import init_train_state, train_state_shardings
    from repro_torch.optim import adamw_init

    init_distributed(coord_b, 2, rank, device="cuda")
    mesh = make_cli_mesh("2x1", num_processes=2, device="cuda")
    cfg, tc = _paper("gpt-base"), train_mesh_tc(FSDP_ARGS)
    tc = dataclasses.replace(tc, pregather_params=True)
    model = build_model(cfg)
    params, _ = init_train_state(model, tc, torch.Generator(device=dev).manual_seed(tc.seed))
    params = put_global_tree(params, train_state_shardings(model, tc, mesh)[0], mesh)
    opt, step = adamw_init(params, tc), make_train_step(model, tc, mesh=mesh)
    batch_fn = T.make_driver_batch_fn(cfg, tc, mesh, device=dev)
    rec["b"] = {"steps": []}
    _reset_counters()
    for i in range(FSDP_PREGATHER_STEPS):
        a = snap()
        params, opt, m = step(params, opt, batch_fn(i))
        k, c, cs, wall = diff(a, snap())
        rec["b"]["steps"].append({"launches": k, "collectives": c, "comm_s": cs,
                                  "wall_s": wall, "loss": float(m["loss"]),
                                  "grad_norm": float(m["grad_norm"])})
    rec["b"]["launches"] = _launches()
    dist.destroy_process_group()
    del params, opt, step
    _free()

    # (c) the families on a "model" axis
    init_distributed(coord_c, 2, rank, device="cuda")
    mesh = make_cli_mesh("1x2", num_processes=2, device="cuda")
    rec["c"] = {}
    for name, (cfg, tc) in _family_cuts().items():
        _reset_counters()
        tp.reset_counts()
        t = time.time()
        steps = _family_steps(dev, cfg, tc, mesh)
        torch.cuda.synchronize()
        rec["c"][name] = {"steps": steps, "wall_s": time.time() - t, "launches": _launches(),
                          "collectives": tp.counts()}
    dist.destroy_process_group()
    rec["total_s"] = time.time() - go
    torch.save(rec, os.path.join(out_dir, f"rank{rank}.pt"))
    return 0


def fsdp_phase(dev, pair, timeout=400) -> dict:
    """Phase 39: let :func:`start_group`'s ranks go; meanwhile take one
    process's first two GPT-Base steps on the same weights and batches, and
    the families' steps on one process.  Both ranks exit 0 in time.
    (a) The first step's loss and grad_norm lie within ``FSDP_TOL`` of one
    process's; the ranks' losses are equal; each rank's resident parameters
    and AdamW moments are its blocks of the FSDP layout, half of one
    process's but for the biases without an ``embed`` dim, and its
    first-step peak below one process's; every step makes the FSDP
    collectives its level's depth implies; each step's flash launches, each
    transition's coalesce_pair and interp_axpy launches and the run's total
    equal the schedule's; the terminal checkpoint restores here on one
    device and its eval loss on one batch equals the ranks' mean within
    ``FSDP_TOL``.  (b) ``pregather_params``: one gather and one
    reduce-scatter a step, the losses and grad norms within ``FSDP_TOL`` of
    one process's two steps.  (c) xLSTM, Jamba's Mamba block and Whisper on
    1x2 (xLSTM at f64): each step's loss and grad_norm within
    ``FAMILY_MESH_TOL`` of one process's, equal on both ranks.  Returns the
    paths' launches (rank 0's)."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.config import MultiLevelConfig
    from repro_torch.core.vcycle import VCycleRunner
    from repro_torch.distributed.sharding import param_shardings, split_factors
    from repro_torch.launch.train import make_batch_fn
    from repro_torch.models.api import (build_model, init_train_state, make_eval_loss,
                                        make_train_step, zero_train_state)
    from repro_torch.param import flatten

    _free()
    with open(pair["after"], "w"):
        pass
    t = time.time()
    procs, logs = pair["procs"], pair["logs"]
    cfg, tc = _paper("gpt-base"), train_mesh_tc(FSDP_ARGS)
    model = build_model(cfg)
    batch_fn = make_batch_fn(cfg, tc, device=dev)
    try:
        params, opt = init_train_state(model, tc, torch.Generator(device=dev).manual_seed(tc.seed))
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        one, step = {"steps": []}, make_train_step(model, tc)
        with _uncounted():
            for i in range(FSDP_PREGATHER_STEPS):
                params, opt, m1 = step(params, opt, batch_fn(i))
                one["steps"].append({"loss": float(m1["loss"]),
                                     "grad_norm": float(m1["grad_norm"])})
                if i == 0:
                    one["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
        one["param_bytes"] = sum(v.numel() * v.element_size() for v in flatten(params).values())
        del params, opt, step
        _free()
        fam_one = {}
        with _uncounted():
            for name, (fcfg, ftc) in _family_cuts().items():
                fam_one[name] = _family_steps(dev, fcfg, ftc)
        deadline = t + timeout
        for p in procs:
            try:
                p.wait(timeout=max(1.0, deadline - time.time()))
            except subprocess.TimeoutExpired:
                pass
        wall = time.time() - t
        for r, p in enumerate(procs):
            if p.poll() != 0:
                log(f"[fsdp] rank {r} output:\n{_read(logs[r])[-4000:]}")
            check(p.poll() == 0, f"phase 39: rank {r} exited {p.poll()} (None: still "
                                 f"running after {timeout}s)")
        recs = [torch.load(os.path.join(pair["root"], f"rank{r}.pt"), weights_only=False)
                for r in range(2)]
        like, _ = zero_train_state(model, tc, device="meta")
        restored, meta = CheckpointManager(os.path.join(pair["root"], "ckpt")).restore(
            {"params": like}, device=dev)
        check(meta["phase"] == "done", f"(a) the last checkpoint is {meta.get('phase')}")
        with _uncounted():
            eval_one = float(make_eval_loss(model)(restored["params"], batch_fn(1000))["loss"])
        del restored
    finally:
        for p in procs:
            _stop(p)
        shutil.rmtree(pair["root"], ignore_errors=True)
        _free()
    log(f"[fsdp] two processes on one card: {wall:.1f}s from the go (each rank "
        f"{[round(r['total_s'], 1) for r in recs]}s, (a) {[round(r['a_s'], 1) for r in recs]}s; "
        f"imports {[round(r['start_s'], 1) for r in recs]}s before it, overlapping earlier "
        f"phases)")

    # (a) GPT-Base through the launcher, --mesh 2x1
    runner = VCycleRunner(cfg, MultiLevelConfig(n_levels=2, alpha=0.25), tc, None, device=dev)
    want = _schedule_launches(runner, tc)
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30)
    nonzero = lambda d: {k: v for k, v in d.items() if v}
    ns = type("M", (), {"axis_names": ("data", "model"), "shape": {"data": 2, "model": 1}})()
    psh = flatten(param_shardings(model.specs(), ns))
    whole = {k: tuple(s.shape) for k, s in flatten(model.specs()).items()}
    block_bytes = sum(int(np.prod([d // f for d, f in zip(whole[k], split_factors(psh[k], ns))]))
                      for k in whole) * 4
    for r, rec in enumerate(recs):
        s0 = rec["steps"][0]
        gaps = {"loss": rel(s0["loss"], one["steps"][0]["loss"]),
                "grad_norm": rel(s0["grad_norm"], one["steps"][0]["grad_norm"]),
                "eval": rel(np.mean([x["eval_loss"] for x in recs]), eval_one)}
        for i, st in enumerate(rec["steps"]):
            c = runner.cfgs[st["level"]]
            log(f"[fsdp] (a) rank {r} step {i} (level {st['level']}): "
                f"{st['wall_s'] * 1e3:.1f} ms, collectives {st['collectives']} in "
                f"{st['comm_s'] * 1e3:.1f} ms of host, launches "
                f"{ {k: v for k, v in st['launches'].items() if v} }, loss {st['loss']:.5f}")
            check(st["collectives"] == _fsdp_collectives(c),
                  f"(a) rank {r} step {i}: collectives {st['collectives']} != "
                  f"{_fsdp_collectives(c)}")
            check(nonzero(st["launches"]) == nonzero(_step_launches(c, tc, 1)),
                  f"(a) rank {r} step {i}: launches {st['launches']} != "
                  f"{_step_launches(c, tc, 1)}")
        log(f"[fsdp] (a) rank {r}: first step loss {s0['loss']:.6f} grad_norm "
            f"{s0['grad_norm']:.6f} against one process {one['steps'][0]['loss']:.6f} "
            f"{one['steps'][0]['grad_norm']:.6f}; the ranks' mean eval loss of the last "
            f"checkpoint {np.mean([x['eval_loss'] for x in recs]):.6f} against the restore "
            f"here {eval_one:.6f}; relative gaps { {k: f'{v:.3e}' for k, v in gaps.items()} } "
            f"(tolerance {FSDP_TOL}); resident parameters {rec['param_bytes'] / 1e6:.1f} MB "
            f"and moments {rec['moment_bytes'] / 1e6:.1f} MB against one process's "
            f"{one['param_bytes'] / 1e6:.1f} MB of parameters; first-step peak "
            f"{rec['peak_first_step_gib']:.2f} GiB (one process {one['peak_gib']:.2f}), run "
            f"peak {rec['peak_gib']:.2f} GiB; launches {rec['launches']} (schedule {want})")
        check(all(g <= FSDP_TOL for g in gaps.values()), f"(a) rank {r}: gaps {gaps}")
        check(rec["param_bytes"] == block_bytes and rec["moment_bytes"] == 2 * block_bytes
              and 2 * rec["param_bytes"] < 1.001 * one["param_bytes"],
              f"(a) rank {r}: resident {rec['param_bytes']} / {rec['moment_bytes']} bytes, "
              f"blocks {block_bytes}, one process {one['param_bytes']}")
        check(rec["peak_first_step_gib"] < one["peak_gib"],
              f"(a) rank {r}: peak {rec['peak_first_step_gib']} not below one process's")
        check(rec["launches"] == want, f"(a) rank {r}: launches {rec['launches']} != {want}")
        check(rec["n_compiles"] == 2 and all(np.isfinite(rec["loss"])),
              f"(a) rank {r}: steps built {rec['n_compiles']}, losses {rec['loss']}")
    check(recs[0]["loss"] == recs[1]["loss"], "(a) the ranks' losses differ")

    # (b) pregather_params
    for r, rec in enumerate(recs):
        for i, st in enumerate(rec["b"]["steps"]):
            g = {k: rel(st[k], one["steps"][i][k]) for k in ("loss", "grad_norm")}
            log(f"[fsdp] (b) pregather rank {r} step {i}: {st['wall_s'] * 1e3:.1f} ms, "
                f"collectives {st['collectives']} in {st['comm_s'] * 1e3:.1f} ms of host; "
                f"loss {st['loss']:.6f} grad_norm {st['grad_norm']:.6f}; relative gaps to one "
                f"process { {k: f'{v:.3e}' for k, v in g.items()} }")
            check(st["collectives"] == {"all_gather": 1, "reduce_scatter": 1, "batch_mean": 1},
                  f"(b) rank {r} step {i}: collectives {st['collectives']}")
            check(all(v <= FSDP_TOL for v in g.values()), f"(b) rank {r} step {i}: gaps {g}")
        check(nonzero(rec["b"]["launches"])
              == nonzero(_step_launches(cfg, tc, FSDP_PREGATHER_STEPS)),
              f"(b) rank {r}: launches {rec['b']['launches']}")

    # (c) the families on 1x2
    paths = {"fsdp": recs[0]["launches"], "fsdp_pregather": recs[0]["b"]["launches"]}
    over = []
    for name, (fcfg, ftc) in _family_cuts().items():
        c0, c1 = recs[0]["c"][name], recs[1]["c"][name]
        for i in range(FAMILY_MESH_STEPS):
            g = {k: rel(c0["steps"][i][k], fam_one[name][i][k]) for k in ("loss", "grad_norm")}
            over += [(name, i, k, v) for (k, v), tol in zip(g.items(), FAMILY_MESH_TOL[name][i])
                     if tol is not None and v > tol]
            log(f"[fsdp] (c) {name} 1x2 {str(fcfg.compute_dtype)[6:]} step {i}: loss "
                f"{c0['steps'][i]['loss']:.9f} grad_norm {c0['steps'][i]['grad_norm']:.9f}, one "
                f"process {fam_one[name][i]['loss']:.9f} {fam_one[name][i]['grad_norm']:.9f}; "
                f"relative gaps { {k: f'{v:.3e}' for k, v in g.items()} } (tolerance "
                f"{FAMILY_MESH_TOL[name][i]})")
            check(c0["steps"][i] == c1["steps"][i], f"(c) {name} step {i}: the ranks differ")
            check(all(math.isfinite(v) for v in c0["steps"][i].values()),
                  f"(c) {name} step {i}: {c0['steps'][i]}")
        log(f"[fsdp] (c) {name}: {c0['wall_s']:.1f}s, collectives {c0['collectives']}, "
            f"launches { {k: v for k, v in c0['launches'].items() if v} }")
        check(c0["collectives"]["all_reduce"] > 0, f"(c) {name}: no collective on 1x2")
        paths[f"mesh_{name}"] = c0["launches"]
    check(not over, f"(c) gaps over their tolerance: {over}")
    return paths


# ---------------------------------------------------------------------------
# phase 40: the speculative policy on 1x2 (on phase 37's ranks, beside phases
# 38-39), serving on a "data" axis (Phi-3.5-MoE on 2x2, four processes; the
# TinyLlama cut on 2x1 on phase 37's ranks) and context-parallel attention in
# training on 1x3 (three processes), all sharing the card over gloo

# (c) Qwen3-14B at full width cut to one layer, bf16 parameters and AdamW
# moments: two level-0 steps at 1 x 3072 (chunks of 1024 rows at offsets 0,
# 1024, 2048)
CP_QWEN_SEQ = 3072
CP_QWEN_STEPS = 2
# (c) Whisper-large-v3 cut to 1 + 1 layers, f32, through the launcher's
# V-cycle (1 + 1 + 1 steps) at 432 decoder tokens on its 1500 frames
CP_WHISPER_ARGS = ["--arch", "whisper-large-v3", "--vcycle", "--steps", "2", "--batch", "1",
                   "--seq", "432", "--lr", "1e-4", "--f32", "--ckpt-every", "1000"]
# (c) the first step's loss and grad norm on 1x3 against one process's,
# relative.  scripts/cp_gaps.py on Qwen3-14B's cut (NVIDIA H100 80GB HBM3,
# 700 W): clean, the loss bit-equal and the grad norm 3.0e-6; the planted
# faults (loss, grad norm): the offset dropped 1.7e-3 / 0.10, the input's
# backward sum dropped 0 / 7.3e-2, two chunks swapped in the gather
# 9.4e-4 / 9.9e-4
CP_TOL = 1e-4


def _cp_qwen_setup(dev):
    """(config, TrainConfig, step -> batch) of phase 40(c)'s Qwen3-14B cut."""
    from repro_torch.config import BlockSpec, TrainConfig, uniform_stages
    from repro_torch.configs import get_config
    from repro_torch.launch.train import make_batch_fn

    cfg = get_config("qwen3-14b").replace(stages=uniform_stages(1, BlockSpec("attn", "dense")),
                                          param_dtype=torch.bfloat16)
    tc = TrainConfig(steps=CP_QWEN_STEPS, warmup_steps=1, peak_lr=1e-4, eps=1e-4,
                     batch_size=1, seq_len=CP_QWEN_SEQ, opt_dtype=torch.bfloat16)
    return cfg, tc, make_batch_fn(cfg, tc, device=dev)


def _cp_whisper_batch_fn(make_batch_fn):
    """``make_batch_fn`` with the audio stub's ones replaced by seeded normal
    frames (:func:`_normal_frames`'s, which Whisper needs to train)."""
    def fn(cfg, tc, shard=0, *, device=None):
        base = make_batch_fn(cfg, tc, shard, device=device)
        stub = _normal_stub_inputs(cfg, tc.batch_size, device, SEED + 9)
        return lambda step: dict(base(step), **stub)

    return fn


@contextlib.contextmanager
def _flash_rows(rows):
    """Record (S, T, q_offset, causal) of every flash forward launch."""
    from repro_torch.kernels import dispatch as KD

    fwd = KD._REGISTRY["flash_attention"]["cuda"]

    def seen(q, k, v, **kw):
        rows.append((q.shape[1], k.shape[1], kw.get("q_offset", 0), kw.get("causal")))
        return fwd(q, k, v, **kw)

    KD._REGISTRY["flash_attention"]["cuda"] = seen
    try:
        yield rows
    finally:
        KD._REGISTRY["flash_attention"]["cuda"] = fwd


def _comm_timer():
    """Patch ``dist.all_reduce`` / ``all_gather`` to add their host time to
    the returned dict's "s"."""
    import torch.distributed as dist

    comm = {"s": 0.0}
    real = {"all_reduce": dist.all_reduce, "all_gather": dist.all_gather}

    def timed(name):
        def call(*a, **k):
            t = time.time()
            out = real[name](*a, **k)
            comm["s"] += time.time() - t
            return out
        return call

    dist.all_reduce, dist.all_gather = timed("all_reduce"), timed("all_gather")
    return comm


def _group_wait(after) -> tuple:
    """A phase-40 rank's start: pay a fresh process's one-time costs
    (:func:`_warm_train`: its first training step took 9-11 s without),
    wait for the phase's go file.  Returns (seconds before the go, the go's
    time)."""
    from repro_torch.kernels.build import load_library

    entry, parent = time.time(), os.getppid()
    load_library()
    _warm_train(torch.device("cuda", 0))
    while not os.path.exists(after):
        check(os.getppid() == parent, "phase 40: the script that started this rank is gone")
        time.sleep(0.01)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    go = time.time()
    return go - entry, go


def dxm_worker(rank: int, coordinators: str, out_dir: str, after: str) -> int:
    """One rank of phase 40(b) (``chip_smoke.py --dxm-rank R ...``): Phi-3.5-
    MoE cut to 2 layers at f32 served on a 2x2 mesh (experts over ("model",
    "data"), model-major) on phase 37(c)'s traffic, before and after a hot
    swap; its ``w_gate`` block's digest, the dropped-routing tally and
    the collectives a tick.  Writes ``out_dir/rank{R}.pt``."""
    import torch.distributed as dist

    from repro_torch.launch import serve as S
    from repro_torch.launch.mesh import init_distributed, make_cli_mesh
    from repro_torch.layers.ffn import count_dropped
    from repro_torch.param import flatten

    start_s, go = _group_wait(after)
    dev = torch.device("cuda", 0)
    init_distributed(coordinators, 4, rank, device=dev)
    mesh = make_cli_mesh("2x2", num_processes=4, device=dev)
    phi2 = _paper(PHI, 2, compute_dtype=torch.float32)
    s = S.make_server(phi2, mesh=mesh, batch=4, max_seq=1024, page_size=16, device=dev)
    w = flatten(s.params)["stages/stage_0/b0/ffn/w_gate"]
    rec = {"start_s": start_s, "backend": dist.get_backend(), "coord": tuple(mesh.get_coordinate()),
           "experts_local": w.shape[1], "block": _params_digest({"w": w})}
    del w
    with count_dropped() as tally:
        rec["run"] = _mesh_run(s, _dxm_requests(phi2), dev, tally)
    rec["run"]["dropped"] = tally.counts()
    s.set_params(_swapped(s.params))
    rec["swap"] = _mesh_run(s, _dxm_requests(phi2, 100), dev)
    rec["total_s"] = time.time() - go
    del s
    _save_atomic(rec, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()
    return 0


def cp_worker(rank: int, coordinators: str, out_dir: str, after: str) -> int:
    """One rank of phase 40(c) (``chip_smoke.py --cp-rank R ...``) on 1x3:
    (1) the Qwen3-14B cut's two level-0 steps through ``VCycleRunner(mesh=)``
    from ``tc.seed``'s init; (2) on a new group, Whisper cut to 1 + 1 layers
    through the launcher's V-cycle.  Every step is recorded with its
    launches, collectives and their host time, wall and first-step peak, and
    every flash forward's (S, T, q_offset, causal).  Writes
    ``out_dir/rank{R}.pt``."""
    import torch.distributed as dist

    from repro_torch.config import MultiLevelConfig
    from repro_torch.core import vcycle as V
    from repro_torch.distributed import put_global_tree
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.launch import train as T
    from repro_torch.launch.mesh import init_distributed, make_cli_mesh
    from repro_torch.optim import adamw_init

    start_s, go = _group_wait(after)
    dev = torch.device("cuda", 0)
    coord_a, coord_b = coordinators.split(",")
    comm = _comm_timer()
    rec = {"start_s": start_s}

    def snap():
        torch.cuda.synchronize()
        return _launches(), tp.counts(), comm["s"], time.time()

    def record(steps, level, fn, *args):
        first = not steps
        if first:
            torch.cuda.reset_peak_memory_stats()
        a = snap()
        out = fn(*args)
        b = snap()
        m = out[-1]
        steps.append({"level": level, "launches": {k: b[0][k] - a[0][k] for k in a[0]},
                      "collectives": {k: b[1][k] - a[1][k] for k in a[1]},
                      "comm_s": b[2] - a[2], "wall_s": b[3] - a[3], "loss": float(m["loss"]),
                      "grad_norm": float(m["grad_norm"]),
                      "peak_gib": torch.cuda.max_memory_allocated() / 2**30})
        return out

    # (1) Qwen3-14B
    init_distributed(coord_a, 3, rank, device=dev)
    mesh = make_cli_mesh("1x3", num_processes=3, device=dev)
    cfg, tc, batch_fn = _cp_qwen_setup(dev)
    runner = V.VCycleRunner(cfg, MultiLevelConfig(n_levels=2, alpha=0.25), tc, batch_fn,
                            device=dev, mesh=mesh)
    params = put_global_tree(runner.models[0].init(
        torch.Generator(device=dev).manual_seed(tc.seed)), runner.level_shardings(0)[0], mesh)
    opt, step = adamw_init(params, tc), runner.step_fn(0)
    _reset_counters()
    tp.reset_counts()
    rec["qwen"], rec["qwen_rows"] = [], []
    with _flash_rows(rec["qwen_rows"]):
        for i in range(CP_QWEN_STEPS):
            params, opt, _ = record(rec["qwen"], 0, step, params, opt, batch_fn(i))
    rec["qwen_launches"] = _launches()
    del params, opt, step, runner
    _free()
    dist.destroy_process_group()

    # (2) Whisper through the launcher's V-cycle
    rec["whisper"], rec["whisper_rows"] = [], []
    step_fn = V.VCycleRunner.step_fn

    def timed_step_fn(self, level):
        fn = step_fn(self, level)
        if getattr(fn, "timed", False):
            return fn

        def one(p, o, b):
            return record(rec["whisper"], level, fn, p, o, b)

        one.timed = True
        self._step_fns[level] = one
        return one

    get_config, make_batch_fn = T.get_config, T.make_batch_fn
    V.VCycleRunner.step_fn = timed_step_fn
    T.get_config = lambda name, smoke=False: whisper_cut(1)
    T.make_batch_fn = _cp_whisper_batch_fn(make_batch_fn)
    _reset_counters()
    tp.reset_counts()
    try:
        with _flash_rows(rec["whisper_rows"]):
            out = T.main(CP_WHISPER_ARGS + ["--mesh", "1x3", "--num-processes", "3",
                                            "--process-id", str(rank), "--coordinator",
                                            coord_b])
    finally:
        V.VCycleRunner.step_fn, T.get_config, T.make_batch_fn = step_fn, get_config, \
            make_batch_fn
    rec["whisper_loss"] = out.history.loss
    rec["whisper_launches"] = _launches()
    rec["total_s"] = time.time() - go
    _save_atomic(rec, os.path.join(out_dir, f"rank{rank}.pt"))
    if torch.distributed.is_initialized():
        dist.destroy_process_group()
    return 0


def start_group(flag: str, n: int, n_coordinators: int) -> dict:
    """Start ``n`` processes of ``chip_smoke.py --{flag}-rank R ...`` now;
    they warm up and wait for their phase's go file.  Each coordinator is a
    file in the group's directory where the group's rank 0 writes the port it
    binds itself (``launch/mesh.py::_coordinator_store``): a port picked now
    and bound at the phase could be taken meanwhile."""
    root = tempfile.mkdtemp(prefix=f"chip_smoke_{flag}_")
    coords = [f"file://{os.path.join(root, f'coord{i}')}" for i in range(n_coordinators)]
    after = os.path.join(root, "go")
    # expandable segments: a rank's freed blocks do not strand card memory
    # that the other processes sharing the card need (40(c)'s three ranks
    # fill 60 of its 80 GB)
    env = dict(os.environ, PYTHONUNBUFFERED="1", OMP_NUM_THREADS="2",
               PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
    logs = [os.path.join(root, f"rank{r}.log") for r in range(n)]
    procs = []
    for r in range(n):
        cmd = [sys.executable, os.path.abspath(__file__), f"--{flag}-rank", str(r),
               f"--{flag}-coordinators", ",".join(coords), f"--{flag}-out", root,
               f"--{flag}-after", after]
        with open(logs[r], "w") as lf:
            procs.append(subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=lf,
                                          stderr=subprocess.STDOUT))
    return {"root": root, "after": after, "procs": procs, "logs": logs}


def _release_group(group, timeout, what) -> list:
    """Let ``group`` go and wait for its records."""
    with open(group["after"], "w"):
        pass
    n = len(group["procs"])
    return _wait_records(group["procs"], group["logs"],
                         [os.path.join(group["root"], f"rank{r}.pt") for r in range(n)],
                         time.time() + timeout, what)


def _one_process_steps(dev, cfg, tc, batch_fn, params, opt, steps) -> dict:
    """``steps`` steps of one process's ``make_train_step`` here: the first
    step's loss, grad norm and launches, each step's wall."""
    from repro_torch.models.api import build_model, make_train_step

    step = make_train_step(build_model(cfg), tc)
    out = {"step_s": []}
    for i in range(steps):
        _reset_counters()
        t = time.time()
        params, opt, m = step(params, opt, batch_fn(i))
        torch.cuda.synchronize(dev)
        out["step_s"].append(time.time() - t)
        if i == 0:
            out.update(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                       launches=_launches())
    return out


def phase40(dev, pair, dxm, cp, p37, spec_counts, timeout=400) -> dict:
    """Phase 40.  (a) Phase 37's ranks served, beside phases 38-39, phase 13's
    traffic through the speculative policy on 1x2 (TinyLlama-1.1B bf16
    through the CLI): every request completes with finite logits, the ranks'
    streams are equal and equal 37(a)'s greedy 1x2 streams but where a
    stream leaves them at a near-tie of the full model, the paged-decode
    launches equal the derivation from the draft and verify steps, and the
    draft projection's ``coalesce_pair`` launches equal phase 13's; the
    draft holds 8 of 16 query heads and 1 of 2 K/V heads a rank.  The
    2-layer f32 cut's speculative streams and accepted tokens on 1x2 equal
    one process's before and after a hot swap, and on 2x1 its greedy
    streams equal one process's with no collective.  (b) Phi-3.5-MoE on 2x2
    gives one process's streams (37(c)) before and after a hot swap; each
    rank holds 4 of 16 experts, the block ``m * 2 + d`` of the whole tree's;
    block 0's dropped-routing tally is one process's, the others' empty.
    (c) On 1x3 the Qwen3-14B cut and Whisper's first loss and grad norm lie
    within ``CP_TOL`` of one process's; each step's flash launches equal
    one process's step's; every flash forward of Qwen3 reads its 1024 rows
    at offset rank x 1024 of 3072, and Whisper's encoder 500 of 1500 frames;
    each step makes the derived collectives.  Returns the paths' launches
    (rank 0's)."""
    from repro_torch.launch.train import make_batch_fn
    from repro_torch.models.api import build_model, init_train_state
    from repro_torch.optim import adamw_init

    t0 = time.time()
    groups = (pair, dxm, cp)
    try:
        # (a): phase 37's ranks, done beside phases 38-39 (before (b): its
        # four 11 GB whole-tree inits do not fit beside them)
        a_recs = _wait_records(pair["procs"], pair["logs"],
                               [os.path.join(pair["root"], f"rank{r}_40.pt") for r in range(2)],
                               time.time() + timeout, "phase 40(a)")
        t_a = time.time() - t0
        stop_mesh_serve_pair(pair)  # its records are read: its memory goes back now
        _free()
        # (b): the four ranks go; one process's Whisper steps here meanwhile
        with open(dxm["after"], "w"):
            pass
        wcfg = whisper_cut(1, compute_dtype=torch.float32)
        wtc = train_mesh_tc(CP_WHISPER_ARGS)
        wbatch = _cp_whisper_batch_fn(make_batch_fn)(wcfg, wtc, device=dev)
        w_one = _one_process_steps(dev, wcfg, wtc, wbatch, *init_train_state(
            build_model(wcfg), wtc, torch.Generator(device=dev).manual_seed(wtc.seed)), 1)
        _free()
        dxm_recs = _wait_records(dxm["procs"], dxm["logs"],
                                 [os.path.join(dxm["root"], f"rank{r}.pt") for r in range(4)],
                                 time.time() + timeout, "phase 40(b)")
        stop_mesh_serve_pair(dxm)
        t_b = time.time() - t0 - t_a
        # (c): one process's Qwen3 steps here, then the three ranks
        qcfg, qtc, qbatch = _cp_qwen_setup(dev)
        qp = build_model(qcfg).init(torch.Generator(device=dev).manual_seed(qtc.seed))
        q_one = _one_process_steps(dev, qcfg, qtc, qbatch, qp, adamw_init(qp, qtc), 1)
        del qp
        _free()
        log(f"[phase40] before (c): this process holds "
            f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB; the card has "
            f"{torch.cuda.mem_get_info(dev)[0] / 2**30:.2f} GiB free")
        t_c = time.time()
        cp_recs = _release_group(cp, timeout, "phase 40(c)")
        t_c = time.time() - t_c
    finally:
        for g in groups:
            stop_mesh_serve_pair(g)
        _free()
    from repro_torch.configs import get_config

    L = get_config("tinyllama-1.1b").n_layers
    log(f"[phase40] {time.time() - t0:.1f}s from the go: (a) waited {t_a:.1f}s more (it ran "
        f"beside phases 38-39 on phase 37's ranks, {[round(r['total_s'], 1) for r in a_recs]}s); "
        f"(b) {t_b:.1f}s; (c) {t_c:.1f}s")

    # (a) the speculative policy on 1x2, TinyLlama-1.1B bf16
    r0 = a_recs[0]["a"]
    dl = r0["draft_layers"]
    for r, rec in enumerate(a_recs):
        a, sn = rec["a"], rec["a"]["seen"]
        st = a["stats"]
        pg = a["launches"]["paged_attention_decode"]
        want_pg = dl * sn["draft_steps"] + L * (sn["verify_s1"] + sn["main_s1"])
        tw = a["wall"] / max(st["spec_rounds"], 1)
        log(f"[phase40] (a) rank {r}: speculative 1x2 bf16: {a['n_done']} requests, "
            f"{a['tokens']} tokens in {a['wall']:.3f}s ({a['tokens'] / a['wall']:.1f} tok/s), "
            f"{st['spec_rounds']} rounds ({tw * 1e3:.1f} ms of host a round), accept rate "
            f"{st['accept_rate']:.4f}; {sn['draft_steps']} draft steps, {sn['verify']} verify "
            f"steps ({sn['verify_s1']} at S_b 1), collectives a verify step "
            f"{sn['verify_coll'][0] if sn['verify_coll'] else None}, in all {a['collectives']}; "
            f"launches {a['launches']} (paged derived {want_pg}); draft projection "
            f"{rec['projection']} coalesce_pair launches (phase 13: "
            f"{spec_counts['coalesce_pair']}); draft heads a rank {rec['draft_heads']}; "
            f"peak {a['peak_gib']:.2f} GiB; near-ties where a stream leaves greedy's "
            f"{a['ties']}")
        check(a["n_done"] == len(BF16_LENGTHS) and not a["rejected"]
              and all(n == 32 for n in a["lens"]) and a["finite"],
              f"(a) rank {r}: lost requests or non-finite logits")
        check(pg == want_pg, f"(a) rank {r}: paged launches {pg} != derived {want_pg}")
        check(rec["projection"] == spec_counts["coalesce_pair"],
              f"(a) rank {r}: projection {rec['projection']} != phase 13's "
              f"{spec_counts['coalesce_pair']}")
        check(rec["draft_heads"] == (8, 1), f"(a) rank {r}: draft heads {rec['draft_heads']}")
        check(all(t["greedy_gap"] <= t["tol"] and t["spec_gap"] <= t["tol"]
                  for t in a["ties"].values()), f"(a) rank {r}: a stream leaves greedy's at "
                                                 f"no near-tie: {a['ties']}")
        check(all(a["streams"][i][0] == s[0] for i, s in p37[0]["a"]["streams"].items()),
              f"(a) rank {r}: a first token differs from greedy's")
    check(a_recs[0]["a"]["streams"] == a_recs[1]["a"]["streams"], "(a) the ranks' streams differ")
    agree = sum(r0["streams"][i] == s for i, s in p37[0]["a"]["streams"].items())
    log(f"[phase40] (a) {agree} of {len(r0['streams'])} speculative streams equal 37(a)'s "
        f"greedy 1x2 streams in full; the rest leave them at near-ties")
    one = a_recs[0]["a_f32"]
    for key in ("mesh", "mesh_swap"):
        want = one["one" if key == "mesh" else "one_swap"]
        for r, rec in enumerate(a_recs):
            got = rec["a_f32"][key]
            check(got["streams"] == want["streams"] and got["finite"]
                  and got["stats"]["accepted_tokens"] == want["stats"]["accepted_tokens"],
                  f"(a) f32 rank {r} {key}: streams or accepted tokens differ from one "
                  f"process's")
        log(f"[phase40] (a) f32 2L {key}: 1x2 speculative streams and accepted tokens "
            f"({want['stats']['accepted_tokens']} of {want['stats']['drafted_tokens']}) equal "
            f"one process's on both ranks")
    for key, want in (("b_2x1", p37[0]["b"]["one"]), ("b_2x1_swap", p37[0]["b"]["one_swap"])):
        for r, rec in enumerate(a_recs):
            got = rec[key]
            check(got["streams"] == want["streams"] and got["finite"]
                  and got["collectives"] == {"all_reduce": 0, "all_gather": 0},
                  f"(b) 2x1 rank {r} {key}: streams {got['streams']} against "
                  f"{want['streams']}, collectives {got['collectives']}")
    log("[phase40] (b) tinyllama 2L f32 on 2x1: streams equal one process's before and after "
        "the swap on both ranks, no collective")

    # (b) Phi-3.5-MoE on 2x2
    c1 = p37[0]["c"]
    want_tick = {"all_reduce": 2 + 2 + 1, "all_gather": 2 + 1}
    for rec in dxm_recs:
        d, m = rec["coord"]
        blk = m * 2 + d
        run, tw = rec["run"], np.asarray(rec["run"]["tick_s"])
        log(f"[phase40] (b) rank {d * 2 + m} (d {d}, m {m}): phi3.5-moe 2L f32 on 2x2, experts "
            f"block {blk} ({rec['experts_local']} of 16): {run['n_done']} requests in "
            f"{run['wall']:.3f}s, host wall a tick mean {tw.mean() * 1e3:.2f} ms; collectives "
            f"a tick {run['ticks'][0]}, in all {run['collectives']}; dropped {run['dropped']}; "
            f"peak {run['peak_gib']:.2f} GiB")
        check(rec["backend"] == "gloo" and rec["experts_local"] == 4,
              f"(b) rank (d {d}, m {m}): backend {rec['backend']}, experts {rec['experts_local']}")
        check(rec["block"] == c1["blocks"][blk], f"(b) rank (d {d}, m {m}) does not hold "
                                                 f"expert block {blk} of the whole tree")
        check(run["streams"] == c1["one"]["streams"] and run["finite"]
              and rec["swap"]["streams"] == c1["one_swap"]["streams"],
              f"(b) rank (d {d}, m {m}): streams differ from one process's")
        check(run["dropped"] == (c1["one"]["dropped"] if blk == 0 else {}),
              f"(b) rank (d {d}, m {m}): tally {run['dropped']} (one process "
              f"{c1['one']['dropped']})")
        check(all(t == want_tick for t in run["ticks"]),
              f"(b) collectives a tick {run['ticks'][:3]} != {want_tick}")

    # (c) context parallelism on 1x3
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30)
    fl = ("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv")
    for r, rec in enumerate(cp_recs):
        for tag, one_, steps in (("qwen", q_one, rec["qwen"]), ("whisper", w_one,
                                                                 rec["whisper"])):
            gaps = (rel(steps[0]["loss"], one_["loss"]), rel(steps[0]["grad_norm"],
                                                             one_["grad_norm"]))
            for i, st in enumerate(steps):
                log(f"[phase40] (c) rank {r} {tag} step {i} (level {st['level']}): loss "
                    f"{st['loss']:.6f} grad_norm {st['grad_norm']:.6f}; wall "
                    f"{st['wall_s'] * 1e3:.1f} ms, collectives {st['collectives']} in "
                    f"{st['comm_s'] * 1e3:.1f} ms of host; flash launches "
                    f"{[st['launches'][k] for k in fl]}; peak {st['peak_gib']:.2f} GiB")
            log(f"[phase40] (c) rank {r} {tag}: first loss / grad_norm gap to one process "
                f"{gaps[0]:.3e} / {gaps[1]:.3e} (tolerance {CP_TOL}; one process "
                f"{one_['loss']:.6f} / {one_['grad_norm']:.6f}, {one_['step_s']} s)")
            check(max(gaps) <= CP_TOL, f"(c) rank {r} {tag}: gaps {gaps} > {CP_TOL}")
            for st in (s for s in steps if s["level"] == 0):
                check(all(st["launches"][k] == one_["launches"][k] for k in fl),
                      f"(c) rank {r} {tag}: flash launches {st['launches']} != one "
                      f"process's {one_['launches']}")
        want_q = {"all_reduce": 2, "all_gather": 2}  # per step: the layer's fused sum + the
        # clip norm's; the sequence gather, re-run by the remat backward
        check(all(st["collectives"] == want_q for st in rec["qwen"]),
              f"(c) rank {r} qwen collectives {[st['collectives'] for st in rec['qwen']]}")
        check(set(rec["qwen_rows"]) == {(1024, 3072, 1024 * r, True)},
              f"(c) rank {r} qwen flash rows {set(rec['qwen_rows'])}")
        want_w = {"all_reduce": 3, "all_gather": 4}  # encoder and decoder layers
        check(all(st["collectives"] == want_w for st in rec["whisper"]),
              f"(c) rank {r} whisper collectives {[st['collectives'] for st in rec['whisper']]}")
        check((500, 1500, 500 * r, False) in set(rec["whisper_rows"])
              and all(s != 1500 for s, *_ in rec["whisper_rows"]),
              f"(c) rank {r} whisper flash rows {set(rec['whisper_rows'])}")
        check([st["level"] for st in rec["whisper"]] == [0, 1, 0, 0],
              f"(c) rank {r} whisper levels {[st['level'] for st in rec['whisper']]}")
    return {"serve_speculative_mesh": dict(a_recs[0]["a"]["launches"],
                                           coalesce_pair=a_recs[0]["projection"]),
            "serve_dxm": dxm_recs[0]["run"]["launches"],
            "cp_qwen": cp_recs[0]["qwen_launches"],
            "cp_vcycle_whisper": cp_recs[0]["whisper_launches"]}


HANDOFF_TRAIN = ["--arch", "gpt-base", "--vcycle", "--steps", "4", "--batch", "8",
                 "--seq", "1024", "--ckpt-every", "2"]
HANDOFF_LENGTHS = [520, 600, 700, 800, 900, 1000]
# phase 14: Phi-3.5-MoE's f32 serving comparison, every prompt past attn_block_k = 512
PHI = "phi3.5-moe-42b-a6.6b"
# phases 18-20: xLSTM-125m; phase 19's V-cycle cut to this sequence and step count
XLSTM = "xlstm-125m"
XLSTM_TRAIN = {"steps": 4, "seq_len": 32}
# phase 20: the first 4 of phase 4's prompt lengths (its prefill takes ~4 ms of host
# a token)
XLSTM_LENGTHS = BF16_LENGTHS[:4]
# phases 21-23: DeepSeek-V3 at full width; the training cut (one MoE layer of 16
# experts and the MTP head) and the serving cut (one dense layer, one MoE layer of 64)
DEEPSEEK = "deepseek-v3-671b"
MOE_F32_LENGTHS = [530, 600, 777, 1000, 700, 513, 640, 900]
MOE_F32_SHARED = ((2, 3),)
# phases 24-32: Jamba-1.5-Large (cut to blocks b2-b3: 2 experts for training, 16
# for serving), Whisper-large-v3 (as configured; 2 + 2 layers for the f32 step)
# and Llama-3.2-Vision-11B (as configured for serving, ``vlm_cut`` for training)
JAMBA = "jamba-1.5-large-398b"
WHISPER = "whisper-large-v3"
VLM = "llama-3.2-vision-11b"
# phase 29: Whisper's prompts, 16-400 tokens of its 448-token text context
WHISPER_LENGTHS = [16, 400, 130, 250, 64, 333, 200, 90]


def family_phases(dev, f32_tc, paths, t0) -> None:
    """Phases 24-32: Jamba-1.5-Large, Whisper-large-v3 and Llama-3.2-Vision-11B,
    each through its f32 step and decode check, its V-cycle and its slots
    serving; the launches of each path go into ``paths``."""
    from repro_torch.configs import get_config

    for n, fam, f32_cfg, f32_train, serve_cfg, lengths, max_seq in (
            (24, "jamba", jamba_cut(2, compute_dtype=torch.float32),
             dataclasses.replace(f32_tc, batch_size=1), jamba_cut(16), BF16_LENGTHS, 2048),
            (27, "whisper", whisper_cut(2, compute_dtype=torch.float32),
             dataclasses.replace(f32_tc, seq_len=448), get_config(WHISPER), WHISPER_LENGTHS,
             448),
            (30, "vlm", vlm_cut(compute_dtype=torch.float32),
             dataclasses.replace(f32_tc, batch_size=1), get_config(VLM), BF16_LENGTHS, 2048)):
        _free()
        train_f32_phase(dev, f32_cfg, f32_train, tag=f"{fam}-f32")
        _free()
        cross_decode_phase(dev, f32_cfg, f32_train.seq_len, f"{fam}-f32")
        log(f"[time] phase {n} done at {time.time() - t0:.1f}s")
        _free()
        cfg, ml, tc = train_setup({"jamba": JAMBA, "whisper": WHISPER, "vlm": VLM}[fam])
        paths[f"vcycle_{fam}"], paths[f"scratch_{fam}"], _ = vcycle_phase(
            dev, f"{fam}-vcycle", cfg, ml, tc, keep_output=False,
            batch_fn=_normal_frames(cfg, tc, dev) if cfg.n_encoder_layers else None)
        log(f"[time] phase {n + 1} done at {time.time() - t0:.1f}s")
        _free()
        paths[f"serve_{fam}"] = slots_serve_phase(dev, serve_cfg, lengths, max_seq=max_seq,
                                                  tag=f"{fam}-serve")
        log(f"[time] phase {n + 2} done at {time.time() - t0:.1f}s")


# ---------------------------------------------------------------------------
# phase 41: the dry run at full size, and its counter against the card

# phase 41(a)'s cells, one of each kind, by fake mesh (a process each: the
# fake process group is process-global)
DRYRUN_CELLS = {"16x16": (("qwen3-14b", "train_4k"), ("tinyllama-1.1b", "prefill_32k"),
                          ("deepseek-v3-671b", "decode_32k")),
                "2x16x16": (("jamba-1.5-large-398b", "long_500k"),)}
DRYRUN_TIMEOUT = 600
# phase 41(b): meta against the card -- bytes within 2%, the peak within 10%
META_BYTES_TOL, META_PEAK_TOL = 0.02, 0.10


def start_dryrun():
    """Phase 41(a)'s two processes, started early with one thread each and
    off the card (``CUDA_VISIBLE_DEVICES`` empty): ``launch/dryrun.py``'s
    ``lower_cell`` at full width and depth for ``DRYRUN_CELLS``, rank 0 of
    the fake 256- and 512-rank meshes."""
    out = tempfile.mkdtemp(prefix="dryrun_")
    env = dict(os.environ, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    procs = {}
    for mesh, cells in DRYRUN_CELLS.items():
        path = os.path.join(out, f"{mesh}.json")
        log_f = open(os.path.join(out, f"{mesh}.log"), "w")
        cmd = [sys.executable, os.path.abspath(__file__), "--dryrun-cells", mesh,
               ",".join(f"{a}:{s}" for a, s in cells), path]
        procs[mesh] = (subprocess.Popen(cmd, stdout=log_f, stderr=subprocess.STDOUT, env=env,
                                        cwd=ROOT), path, log_f)
    return {"dir": out, "procs": procs}


def stop_dryrun(early) -> None:
    for p, _, log_f in early["procs"].values():
        if p.poll() is None:
            p.kill()
        p.wait()
        log_f.close()
    shutil.rmtree(early["dir"], ignore_errors=True)


def dryrun_worker(mesh_name: str, cells: str, path: str) -> int:
    """One process of phase 41(a): each cell's record into ``path``."""
    from repro_torch.config import SHAPES
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh

    torch.set_num_threads(1)
    mesh = make_production_mesh(multi_pod=mesh_name == "2x16x16")
    recs = {}
    for cell in cells.split(","):
        arch, shape = cell.split(":")
        recs[f"{arch}|{shape}|{mesh_name}"] = dryrun.lower_cell(arch, SHAPES[shape], mesh,
                                                                verbose=False)
    with open(path, "w") as f:
        json.dump(recs, f)
    return 0


def dryrun_phase(early) -> dict:
    """Phase 41(a): collect the full-size dry-run cells; each record on a
    line of its own, every cell ``ok`` with finite roofline terms."""
    recs = {}
    for mesh, (p, path, log_f) in early["procs"].items():
        rc = p.wait(timeout=DRYRUN_TIMEOUT)
        log_f.flush()
        with open(os.path.join(early["dir"], f"{mesh}.log")) as f:
            tail = f.read()[-4000:]
        check(rc == 0, f"phase 41(a): the {mesh} dry-run process exited {rc}:\n{tail}")
        with open(path) as f:
            recs.update(json.load(f))
    for key, rec in recs.items():
        log(f"[dryrun] {key} " + json.dumps(rec))
        r = rec["roofline"]
        terms = [r[k] for k in ("t_compute_s", "t_memory_s", "t_collective_s", "step_time_s",
                                "useful_flops_ratio")] + [rec["memory"]["peak_bytes_est"]]
        check(rec["status"] == "ok" and all(math.isfinite(t) for t in terms),
              f"phase 41(a): {key} is not ok and finite: {rec['status']} {terms}")
        log(f"[dryrun] {key}: peak {rec['memory']['peak_bytes_est'] / 2**30:.2f} GiB a device "
            f"(fits {rec['memory']['fits']}), {r['bottleneck']}-bound, compute "
            f"{r['t_compute_s'] * 1e3:.2f} ms, memory {r['t_memory_s'] * 1e3:.2f} ms, "
            f"collective {r['t_collective_s'] * 1e3:.2f} ms, useful {r['useful_flops_ratio']:.3f}, "
            f"trace {rec['trace_s']} s")
    check(set(recs) == {f"{a}|{s}|{m}" for m, cells in DRYRUN_CELLS.items() for a, s in cells},
          f"phase 41(a): cells {sorted(recs)}")
    return recs


def _as_meta(tree):
    """``tree`` (tensors in nested dicts and tuples) on the meta device."""
    if isinstance(tree, dict):
        return {k: _as_meta(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_as_meta(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return torch.empty(tree.shape, dtype=tree.dtype, device="meta")
    return tree


def _counted(step, args, dev):
    """(counter, the card's step peak) of one counted ``step(*args)``: on
    the card the peak is ``max_memory_allocated`` from a reset, less what
    was allocated before the step beyond its arguments; on meta None."""
    from repro_torch.launch.op_cost import OpCounter

    c = OpCounter()
    c.add_arguments(args)
    if dev is not None:
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    with c:
        out = step(*args)
    peak = None
    if dev is not None:
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev) - (base - c.argument_bytes)
    c.finish(out)
    return c, peak


def _meta_vs_card(tag: str, step, card_args, meta_args, dev, model_flops: float) -> dict:
    """One step counted on the card and on meta: FLOPs, op counts by kind
    and the kernels' recorded costs equal, bytes within ``META_BYTES_TOL``
    (each kind whose bytes differ named), the meta peak within
    ``META_PEAK_TOL`` of the card's; the roofline's step time beside the
    card's own (5 uncounted steps)."""
    from repro_torch.launch.analysis import roofline

    card, peak_card = _counted(step, card_args, dev)
    meta, _ = _counted(step, meta_args, None)
    kinds = lambda c: {k: v["count"] for k, v in c.by_op.items()}
    diff_kinds = {k: (kinds(card).get(k), kinds(meta).get(k))
                  for k in set(kinds(card)) | set(kinds(meta))
                  if kinds(card).get(k) != kinds(meta).get(k)}
    diff_bytes = {k: (card.by_op.get(k, {}).get("bytes"), meta.by_op.get(k, {}).get("bytes"))
                  for k in set(card.by_op) | set(meta.by_op)
                  if card.by_op.get(k, {}).get("bytes") != meta.by_op.get(k, {}).get("bytes")}
    bytes_gap = abs(card.bytes - meta.bytes) / card.bytes
    peak_gap = (meta.peak_bytes - peak_card) / peak_card
    torch.cuda.synchronize(dev)
    t = time.time()
    for _ in range(5):
        step(*card_args)
    torch.cuda.synchronize(dev)
    step_s = (time.time() - t) / 5
    rl = roofline(meta, 1, model_flops)
    res = {"flops_card": card.flops, "flops_meta": meta.flops, "bytes_card": card.bytes,
           "bytes_meta": meta.bytes, "bytes_gap": bytes_gap, "bytes_by_kind_differ": diff_bytes,
           "ops_by_kind_differ": diff_kinds, "kernels_card": card.kernels,
           "kernels_meta": meta.kernels, "peak_card_bytes": peak_card,
           "peak_meta_bytes": meta.peak_bytes, "peak_gap": peak_gap,
           "roofline_step_ms": rl.step_time * 1e3, "bottleneck": rl.bottleneck,
           "measured_step_ms": step_s * 1e3}
    log(f"[meta-vs-card] {tag}: " + json.dumps(res))
    log(f"[meta-vs-card] {tag}: FLOPs {card.flops:.6e} / {meta.flops:.6e}, bytes "
        f"{card.bytes:.6e} / {meta.bytes:.6e} ({bytes_gap:.2%}), peak {peak_card / 2**30:.3f} "
        f"/ {meta.peak_bytes / 2**30:.3f} GiB ({peak_gap:+.2%}), roofline step "
        f"{rl.step_time * 1e3:.3f} ms ({rl.bottleneck}) against {step_s * 1e3:.3f} ms measured")
    check(card.flops == meta.flops and not diff_kinds and card.kernels == meta.kernels,
          f"phase 41(b) {tag}: the card and meta differ: {card.flops} / {meta.flops}, "
          f"ops {diff_kinds}, kernels {card.kernels} / {meta.kernels}")
    check(bytes_gap <= META_BYTES_TOL, f"phase 41(b) {tag}: bytes {bytes_gap:.2%} apart, "
          f"by kind (card, meta): {diff_bytes}")
    check(abs(peak_gap) <= META_PEAK_TOL, f"phase 41(b) {tag}: peak {peak_gap:+.2%} from the "
          f"card's max_memory_allocated ({peak_card} / {meta.peak_bytes} bytes)")
    return res


def meta_vs_card_phase(dev) -> dict:
    """Phase 41(b): ``launch/op_cost.py``'s counter on the card and on
    meta for the same steps -- the GPT-Base train step (12 layers, 8 x
    1024, bf16 compute: the flash forward, dq and dk/dv kernels against
    their meta forms) and a TinyLlama-1.1B ``make_serve_step`` on dense
    caches (8 rows of 2048) -- and the card's bf16 matmul rate and copy
    bandwidth beside the roofline's spec constants."""
    from repro_torch.configs import get_config
    from repro_torch.core import flops as flops_lib
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models.api import build_model, make_serve_step, make_train_step
    from repro_torch.optim import adamw_init
    from repro_torch.param import zeros_tree

    gen = torch.Generator(device=dev).manual_seed(SEED + 41)
    out = {}
    cfg, _, tc = train_setup("gpt-base")
    model = build_model(cfg)
    params = model.init(gen)
    opt = adamw_init(params, tc)
    B, S = tc.batch_size, tc.seq_len
    batch = {k: torch.randint(0, cfg.vocab_size, (B, S), device=dev, generator=gen)
             for k in ("tokens", "labels")}
    step = make_train_step(model, tc)
    step(params, opt, batch)  # warm: the libraries' workspaces stay allocated
    _reset_counters()
    mf = flops_lib.model_flops_reference(cfg, model.specs(), B * S, train=True)
    out["gpt_base_train"] = _meta_vs_card("gpt-base train step", step, (params, opt, batch),
                                          _as_meta((params, opt, batch)), dev, mf)
    out["launches"] = _launches()
    del params, opt, batch
    _free()
    cfg = get_config("tinyllama-1.1b")
    model = build_model(cfg)
    params = model.init(gen)
    caches = zeros_tree(model.cache_specs(8, 2048), cfg.compute_dtype, dev)
    toks = torch.randint(0, cfg.vocab_size, (8, 1), device=dev, generator=gen)
    pos = torch.full((8,), 1000, dtype=torch.long, device=dev)
    step = make_serve_step(model)
    step(params, caches, toks, pos)
    mf = flops_lib.model_flops_reference(cfg, model.specs(), 8, train=False)
    out["tinyllama_serve"] = _meta_vs_card(
        "tinyllama-1.1b serve step", step, (params, caches, toks, pos),
        _as_meta((params, caches, toks, pos)), dev, mf)
    del params, caches
    _free()
    n = 8192
    a, b = (torch.randn((n, n), dtype=torch.bfloat16, device=dev, generator=gen)
            for _ in range(2))
    mm_ms = time_ms(lambda: torch.matmul(a, b), dev)
    src = torch.empty(2**30 // 2, dtype=torch.bfloat16, device=dev)
    dst = torch.empty_like(src)
    cp_ms = time_ms(lambda: dst.copy_(src), dev)
    out["matmul_bf16_tflops"] = 2 * n ** 3 / (mm_ms / 1e3) / 1e12
    out["copy_tb_s"] = 2 * 2**30 / (cp_ms / 1e3) / 1e12
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    log(f"[meta-vs-card] {smi}: bf16 {n}^3 matmul {mm_ms:.4f} ms = "
        f"{out['matmul_bf16_tflops']:.1f} TFLOP/s (spec {mesh_lib.PEAK_FLOPS_BF16 / 1e12:.0f}); "
        f"device copy of 1 GiB {cp_ms:.4f} ms = {out['copy_tb_s']:.3f} TB/s read + written "
        f"(spec HBM {mesh_lib.HBM_BW / 1e12:.2f})")
    del a, b, src, dst
    return out


def _free() -> None:
    """Return the last phase's freed blocks to the card before a phase whose
    trees fill most of it."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 42: the reference's four examples on the port (repro_torch.examples),
# each main(argv) called at the reference's defaults in one process of its
# own, started after phase 2 and run beside phases 3-23

# (tag, module, argv): vcycle_pretrain's --full-100m (GPT-Base's widths, 12
# layers at d 768, 8 x 128) and its MoE family cut from the reference's 200
# steps to EXAMPLE_STEPS (Table 2's ratio: 1 + 10 + 20), for the script's time
EXAMPLE_STEPS = 20
EXAMPLES = (("quickstart", "quickstart", ()),
            ("pretrain_100m", "vcycle_pretrain", ("--full-100m", "--steps", str(EXAMPLE_STEPS))),
            ("pretrain_moe", "vcycle_pretrain", ("--config", "moe", "--steps",
                                                 str(EXAMPLE_STEPS))),
            ("serve_greedy", "serve_decode", ()),
            ("serve_speculative", "serve_decode", ("--policy", "speculative")),
            ("elastic_restart", "elastic_restart", ()))
# the kernels each example's path must launch (the others may launch none)
EXAMPLE_KERNELS = {"quickstart": ("coalesce_pair", "interp_axpy"),
                   "pretrain_100m": ("coalesce_pair", "interp_axpy"),
                   "pretrain_moe": ("coalesce_pair", "interp_axpy"),
                   "serve_greedy": ("paged_attention_decode",),
                   "serve_speculative": ("paged_attention_decode", "coalesce_pair"),
                   "elastic_restart": ("coalesce_pair", "interp_axpy")}
EXAMPLES_TIMEOUT = 900


def _example_summary(tag: str, out: dict) -> dict:
    """The numbers phase 42 checks, from what an example's ``main`` returned."""
    if tag == "quickstart":
        return {"final_loss": out["final_loss"], "saving": out["saving"],
                "levels": sorted(set(out["vcycle"].history.level))}
    if tag.startswith("pretrain"):
        from repro_torch.examples import vcycle_pretrain as VP
        from repro_torch.models.api import build_model

        cfg = VP.example_config("moe" if tag.endswith("moe") else "dense",
                                full_100m=tag.endswith("100m"))
        return {"final_loss": out["final_loss"], "plan": out["plan"],
                "plan_want": build_model(cfg).projection_plan(VP.ML).describe(),
                "steps": len(out["output"].history.loss)}
    if tag.startswith("serve"):
        return {"served": out["served"], "tokens": out["tokens"],
                "tok_per_s": out["tok_per_s"],
                "drafted": out["stats"].get("drafted_tokens", 0),
                "accept_rate": out["stats"].get("accept_rate")}
    mp = dict(out["multiprocess"])
    mp["resume_output"] = mp["resume_output"][-4000:]
    return {"plain": out["plain"], "vcycle": out["vcycle"], "multiprocess": mp}


def examples_worker(out_dir: str, device=None) -> int:
    """Phase 42's process (``chip_smoke.py --examples OUT``): each example
    of ``EXAMPLES`` through its ``main(argv)``, in turn, the kernel counts
    set to 0 just before it and read just after; each one's launches, wall,
    printed lines and checked numbers into ``OUT/examples.json``.
    ``device="cpu"`` rehearses it on the CPU (each ``main`` gets
    ``--device cpu``)."""
    import importlib

    entry = time.time()
    if device is None:
        from repro_torch.kernels.build import load_library

        load_library()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    recs = {}
    for tag, module, argv in EXAMPLES:
        argv = list(argv)
        if module == "vcycle_pretrain":
            argv += ["--ckpt-dir", os.path.join(out_dir, tag)]
        if device is not None:
            argv += ["--device", device]
        main_ = importlib.import_module(f"repro_torch.examples.{module}").main
        print(f"[examples] {tag}: main({argv})", flush=True)
        _reset_counters()
        t = time.time()
        out = main_(argv)
        if device is None:
            torch.cuda.synchronize()
        recs[tag] = {"launches": _launches(), "wall_s": time.time() - t, "argv": argv,
                     "lines": out["lines"], **_example_summary(tag, out)}
        del out
        _free()
    with open(os.path.join(out_dir, "examples.json"), "w") as f:
        json.dump({"examples": recs, "entry": entry, "end": time.time()}, f)
    return 0


def start_examples() -> dict:
    """Phase 42's process, started now (after phase 2): two threads, its
    output and checkpoints in a temporary directory."""
    out = tempfile.mkdtemp(prefix="chip_smoke_examples_")
    log_f = open(os.path.join(out, "examples.log"), "w")
    env = dict(os.environ, PYTHONUNBUFFERED="1", OMP_NUM_THREADS="2")
    # a session of its own: stopping it stops elastic_restart's processes too
    p = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--examples", out],
                         cwd=ROOT, env=env, stdout=log_f, stderr=subprocess.STDOUT,
                         start_new_session=True)
    return {"dir": out, "proc": p, "log": log_f, "t": time.time()}


def stop_examples(early) -> None:
    with contextlib.suppress(ProcessLookupError):
        os.killpg(early["proc"].pid, signal.SIGKILL)
    early["proc"].wait(timeout=60)
    early["log"].close()
    shutil.rmtree(early["dir"], ignore_errors=True)


def examples_phase(early) -> dict:
    """Phase 42: collect the examples' process.  It exits 0; every example
    ran on the card and printed the reference's lines: quickstart its loss
    and FLOPs saving; ``vcycle_pretrain`` (``--full-100m`` and ``--config
    moe``) the plan ``Model.projection_plan(ml).describe()`` gives and a
    finite final loss; ``serve_decode`` every request's 12 tokens (paged,
    greedy and speculative); ``elastic_restart`` its three acts, act 3's two
    launcher processes exiting 0 after draining at one global step and one
    process resuming to the terminal checkpoint.  Each path launched the
    kernels of ``EXAMPLE_KERNELS``.  Returns the paths' launches
    (``example_<tag>``)."""
    p = early["proc"]
    try:
        rc = p.wait(timeout=max(1.0, EXAMPLES_TIMEOUT - (time.time() - early["t"])))
    except subprocess.TimeoutExpired:
        rc = None
    early["log"].flush()
    tail = _read(os.path.join(early["dir"], "examples.log"))[-6000:]
    check(rc == 0, f"phase 42: the examples' process exited {rc}:\n{tail}")
    with open(os.path.join(early["dir"], "examples.json")) as f:
        run = json.load(f)
    recs = run["examples"]
    check([t for t, _, _ in EXAMPLES] == list(recs), f"phase 42: examples {list(recs)}")
    paths = {}
    for tag, rec in recs.items():
        for line in rec["lines"]:
            log(f"[examples] {tag}: {line}")
        launched = {k: v for k, v in rec["launches"].items() if v}
        log(f"[examples] {tag} ({' '.join(rec['argv'])}): {rec['wall_s']:.1f}s, "
            f"launches {launched}")
        for k in EXAMPLE_KERNELS[tag]:
            check(rec["launches"][k] > 0, f"phase 42: {tag} launched no {k}")
        paths[f"example_{tag}"] = rec["launches"]
        if tag == "quickstart":
            check(math.isfinite(rec["final_loss"]) and rec["levels"] == [0, 1],
                  f"phase 42: quickstart {rec['final_loss']} {rec['levels']}")
            check("fewer training FLOPs" in rec["lines"][-1], "phase 42: no saving printed")
        elif tag.startswith("pretrain"):
            check(rec["plan"] == rec["plan_want"] and rec["lines"][1] == rec["plan"],
                  f"phase 42: {tag} printed the plan {rec['lines'][1]!r}")
            check(math.isfinite(rec["final_loss"]) and rec["lines"][-1].startswith("done;"),
                  f"phase 42: {tag} final loss {rec['final_loss']}")
        elif tag.startswith("serve"):
            check(rec["served"] == 10 and rec["tokens"] == 120,
                  f"phase 42: {tag} served {rec['served']} requests, {rec['tokens']} tokens")
            check(tag == "serve_greedy" or rec["drafted"] > 0, f"phase 42: {tag} drafted none")
        else:
            mp = rec["multiprocess"]
            steps = {d.rsplit("global_step ", 1)[-1].split(";")[0] for d in mp["drains"] if d}
            log(f"[examples] elastic_restart act 3: exit codes {mp['exit_codes']}, drains "
                f"{mp['drains']}, the resume's exit {mp['resume_rc']} and last checkpoint "
                f"{mp['final_phase']}")
            check(mp["exit_codes"] == [0, 0] and all(mp["drains"]) and len(steps) == 1,
                  f"phase 42: act 3's processes {mp['exit_codes']} {mp['drains']}")
            check(mp["resume_rc"] == 0 and mp["final_phase"] == "done"
                  and any("resumed at phase=" in ln for ln in mp["resumed"]),
                  f"phase 42: act 3's resume:\n{mp['resume_output']}")
            check(rec["plain"]["resumed_from"] == 6 and math.isfinite(rec["plain"]["loss"])
                  and rec["vcycle"]["killed_at"] is not None
                  and math.isfinite(rec["vcycle"]["final_loss"]),
                  f"phase 42: acts 1-2 {rec['plain']} {rec['vcycle']}")
    log(f"[examples] the process ran {run['end'] - early['t']:.1f}s from its start "
        f"({run['entry'] - early['t']:.1f}s to its imports), beside the phases after 2; "
        f"collected {time.time() - run['end']:.1f}s after it ended")
    return paths


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    try:
        from repro_torch.config import BlockSpec, TrainConfig, uniform_stages
        from repro_torch.configs import get_config
    except ImportError as e:
        print(f"chip_smoke: cannot import the port ({e}); run this script from the "
              f"root of a checkout, beside src/repro_torch", file=sys.stderr)
        return 1

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t0 = time.time()
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    build_phase()
    kernel_phase(dev)
    log(f"[time] phases 1-2 done at {time.time() - t0:.1f}s")
    dryrun_early = start_dryrun()  # phase 41(a) runs on the host beside phases 3-40
    atexit.register(stop_dryrun, dryrun_early)
    examples_early = start_examples()  # phase 42 runs beside phases 3-23
    atexit.register(stop_examples, examples_early)
    full = get_config("tinyllama-1.1b")
    f32 = full.replace(stages=uniform_stages(2, BlockSpec("attn", "dense")),
                       compute_dtype=torch.float32)
    engines_f32_phase(dev, f32, F32_LENGTHS, f32_phase(dev, f32, F32_LENGTHS))
    log(f"[time] phase 3 done at {time.time() - t0:.1f}s")
    first4 = {}
    decode_inputs, (serve_flash, serve_paged), greedy = bf16_phase(
        dev, full, BF16_LENGTHS, BF16_SHARED, first_tick=first4)
    log(f"[time] phase 4 done at {time.time() - t0:.1f}s")
    draft_inputs, spec_counts = speculative_phase(dev, full, BF16_LENGTHS, BF16_SHARED, greedy)
    log(f"[time] phase 13 done at {time.time() - t0:.1f}s")
    f32_tc = TrainConfig(steps=4, warmup_steps=1, eps=1e-4, batch_size=2, seq_len=1024)
    train_f32_phase(dev, _paper("gpt-base", 2, compute_dtype=torch.float32), f32_tc)
    log(f"[time] phase 6 done at {time.time() - t0:.1f}s")
    bert_f32 = train_f32_phase(dev, _paper("bert-large", 2, compute_dtype=torch.float32),
                               f32_tc, tag="train-f32-bert")
    log(f"[time] phase 6b done at {time.time() - t0:.1f}s")
    paths = {"serve": {k: 0 for k in _wrappers()}}
    paths["serve"].update(flash_attention_fwd=serve_flash, paged_attention_decode=serve_paged)
    paths["serve_speculative"] = spec_counts
    # phase 12's two launcher processes start here and warm up during phases 7 and 11
    early = start_handoff(HANDOFF_TRAIN)
    try:
        paths["vcycle"], paths["scratch"], gpt_out = vcycle_phase(dev, "vcycle",
                                                                  *train_setup("gpt-base"))
        log(f"[time] phase 7 done at {time.time() - t0:.1f}s")
        paths["resume"] = resume_phase(dev, *train_setup("gpt-base"), want=gpt_out, every=4,
                                       kill_at=4)
        del gpt_out
        log(f"[time] phase 11 done at {time.time() - t0:.1f}s")
        paths["handoff_serve"] = handoff_phase(dev, _paper("gpt-base", COORD_LAYERS), early,
                                               HANDOFF_LENGTHS)
        log(f"[time] phase 12 done at {time.time() - t0:.1f}s")
    finally:
        stop_handoff(early)
    paths["vcycle_bert_large"], paths["scratch_bert_large"], _ = vcycle_phase(
        dev, "bert", *train_setup("bert-large"))
    log(f"[time] phase 8 done at {time.time() - t0:.1f}s")
    paths["vcycle_deit_b"], paths["scratch_deit_b"], _ = vcycle_phase(
        dev, "deit", *train_setup("deit-b"))
    log(f"[time] phase 9 done at {time.time() - t0:.1f}s")
    paths["baselines_bert_base"] = baselines_phase(dev, *train_setup("bert-base"))
    log(f"[time] phase 10 done at {time.time() - t0:.1f}s")
    # phases 14-17: the MoE family (Phi-3.5-MoE at full width) and Qwen3-4B
    phi = get_config(PHI)
    phi2 = _paper(PHI, 2, compute_dtype=torch.float32)
    _free()
    train_f32_phase(dev, phi2, dataclasses.replace(f32_tc, batch_size=1), tag="moe-f32")
    _free()
    f32_phase(dev, phi2, MOE_F32_LENGTHS, shared=MOE_F32_SHARED, tag="moe-f32")
    log(f"[time] phase 14 done at {time.time() - t0:.1f}s")
    _free()
    moe_decode_inputs, serve_moe, _ = bf16_phase(
        dev, phi.replace(stages=uniform_stages(4, phi.stages[0].pattern[0])), BF16_LENGTHS,
        BF16_SHARED, tag="moe-serve")
    paths["serve_moe"] = {k: 0 for k in _wrappers()}
    paths["serve_moe"].update(flash_attention_fwd=serve_moe[0],
                              paged_attention_decode=serve_moe[1])
    log(f"[time] phase 15 done at {time.time() - t0:.1f}s")
    _free()
    paths["vcycle_moe"], paths["scratch_moe"], _ = vcycle_phase(
        dev, "vcycle-moe", *train_setup(PHI), keep_output=False)
    log(f"[time] phase 16 done at {time.time() - t0:.1f}s")
    _free()
    _, serve_qwen3, _ = bf16_phase(dev, get_config("qwen3-4b"), BF16_LENGTHS, BF16_SHARED,
                                   tag="qwen3-serve")
    paths["serve_qwen3"] = {k: 0 for k in _wrappers()}
    paths["serve_qwen3"].update(flash_attention_fwd=serve_qwen3[0],
                                paged_attention_decode=serve_qwen3[1])
    log(f"[time] phase 17 done at {time.time() - t0:.1f}s")
    # phases 18-20: the recurrent mixers (xLSTM-125m as configured; Mamba at Jamba's widths)
    _free()
    ssm_f32_phase(dev, xlstm_cut(1, compute_dtype=torch.float32), jamba_mixer_cfg(), seq=256)
    log(f"[time] phase 18 done at {time.time() - t0:.1f}s")
    _free()
    paths["vcycle_xlstm"], paths["scratch_xlstm"], _ = vcycle_phase(
        dev, "xlstm-vcycle", *train_setup(XLSTM), keep_output=False, learns=False)
    log(f"[time] phase 19 done at {time.time() - t0:.1f}s")
    _free()
    paths["serve_xlstm"] = slots_serve_phase(dev, xlstm_cut(1), XLSTM_LENGTHS)
    log(f"[time] phase 20 done at {time.time() - t0:.1f}s")
    # phases 21-23: MLA and DeepSeek-V3 at full width (the training and serving cuts)
    _free()
    ds_f32 = train_setup(DEEPSEEK)[0].replace(compute_dtype=torch.float32)
    train_f32_phase(dev, ds_f32, dataclasses.replace(f32_tc, batch_size=1), tag="mla-f32")
    _free()
    mla_decode_phase(dev, ds_f32)
    log(f"[time] phase 21 done at {time.time() - t0:.1f}s")
    _free()
    paths["vcycle_mla"], paths["scratch_mla"], _ = vcycle_phase(
        dev, "mla-vcycle", *train_setup(DEEPSEEK), keep_output=False)
    log(f"[time] phase 22 done at {time.time() - t0:.1f}s")
    _free()
    _, serve_mla, _ = bf16_phase(dev, deepseek_cut(1, 1, 64), BF16_LENGTHS, BF16_SHARED,
                                 tag="mla-serve")
    paths["serve_mla"] = {k: 0 for k in _wrappers()}
    paths["serve_mla"].update(flash_attention_fwd=serve_mla[0],
                              paged_attention_decode=serve_mla[1])
    log(f"[time] phase 23 done at {time.time() - t0:.1f}s")
    # phase 37's and 38's processes start here and import the port while phases
    # 24-36 run (started later, their imports slowed the start of phase 35's
    # processes); phase 36's start before phase 33
    pair, train_pair, fsdp_pair = (start_group("mesh-serve", 2, 1),
                                   start_group("train-mesh", 2, 2), start_group("fsdp", 2, 3))
    coord = dp_early = dxm_group = cp_group = None
    try:
        family_phases(dev, f32_tc, paths, t0)
        # phase 40's seven processes start here, after the phases that fill the
        # card (their contexts would not fit beside phase 24), and warm up
        # during phases 33-36 (started before phase 37, their warm-ups slowed it)
        dxm_group, cp_group = start_group("dxm", 4, 1), start_group("cp", 3, 2)
        # phases 33-35: remat "dots", and data-parallel V-cycles through the launcher
        _free()
        coord, dp_early = start_coordinated(), start_dp()
        paths.update(remat_phase(dev, _paper("gpt-base"), train_setup("gpt-base")[2]))
        log(f"[time] phase 33 done at {time.time() - t0:.1f}s")
        _free()
        one = mesh_vcycle_phase(dev, *_dp_setup())
        paths["mesh_int8_ef"] = one["int8_ef"]["launches"]
        log(f"[time] phase 34 done at {time.time() - t0:.1f}s")
        paths.update(dp_phase(dev, one, dp_early))
        del one
        log(f"[time] phase 35 done at {time.time() - t0:.1f}s")
        paths.update(coordinated_phase(dev, coord))
        log(f"[time] phase 36 done at {time.time() - t0:.1f}s")
        paths["serve_mesh"], p37 = mesh_serve_phase(dev, pair, {
            "counts": (serve_flash, serve_paged), "ticks": len(decode_inputs),
            "streams": greedy, "first_tick": first4})
        log(f"[time] phase 37 done at {time.time() - t0:.1f}s")
        paths.update(train_mesh_phase(dev, train_pair))
        log(f"[time] phase 38 done at {time.time() - t0:.1f}s")
        paths.update(fsdp_phase(dev, fsdp_pair))
        log(f"[time] phase 39 done at {time.time() - t0:.1f}s")
        paths.update(phase40(dev, pair, dxm_group, cp_group, p37, spec_counts))
        log(f"[time] phase 40 done at {time.time() - t0:.1f}s")
        _free()
        dryrun_phase(dryrun_early)
        paths["meta_vs_card"] = meta_vs_card_phase(dev)["launches"]
        log(f"[time] phase 41 done at {time.time() - t0:.1f}s")
        paths.update(examples_phase(examples_early))
        log(f"[time] phase 42 done at {time.time() - t0:.1f}s")
    finally:
        for group in (dxm_group, cp_group):
            if group is not None:
                stop_mesh_serve_pair(group)
        stop_mesh_serve_pair(pair)
        stop_mesh_serve_pair(train_pair)
        stop_mesh_serve_pair(fsdp_pair)
        if dp_early is not None:
            stop_mesh_serve_pair(dp_early)
        if coord is not None:
            stop_coordinated(coord)
    _free()
    kernels = timing_phase(dev, decode_inputs, draft_inputs)
    train_kernels, fwd_train = train_timing_phase(dev)
    # the flash forward where training spends it, as its second shape
    next(e for e in kernels if e["name"] == "flash_attention_fwd")["train_shape"] = fwd_train
    kernels += train_kernels
    moe_shapes = moe_timing_phase(dev, moe_decode_inputs)
    # MLA's training layer (DeepSeek-V3: 128 heads, D 192, Dv 128, B 1, S 1024)
    mla_shapes = flash_train_timing(dev, torch.Generator(device=dev).manual_seed(SEED + 5),
                                    1, 1024, 128, 128, 192, 128)
    whisper_shapes, vlm_shapes = cross_timing_phase(dev)
    # a context-parallel chunk: Qwen3-14B's last rank of 1x3 (S 1024 at
    # offset 2048 of T 3072, GQA 40/8, D 128, causal)
    cp_shapes = flash_train_timing(dev, torch.Generator(device=dev).manual_seed(SEED + 9),
                                   1, 1024, 40, 8, 128, T=3072, q_offset=2048)
    for entry in kernels:  # the other families' shapes beside each kernel's own
        for key, shapes in (("moe_shape", moe_shapes), ("mla_shape", mla_shapes),
                            ("whisper_cross_shape", whisper_shapes),
                            ("vlm_cross_shape", vlm_shapes), ("cp_chunk_shape", cp_shapes)):
            if entry["name"] in shapes:
                entry[key] = shapes[entry["name"]]
    for entry in kernels:  # launches on the main paths: serving, V-cycles, scratch, baselines, ...
        name = entry["name"]
        entry["launches_by_path"] = {p: c[name] for p, c in paths.items()}
        entry["launches"] = sum(entry["launches_by_path"].values())
        # phase 6b: the non-causal flash inside BERT-Large (a comparison of
        # the two backends, so not counted in "launches")
        entry["launches_bert_f32_step_cuda_backend"] = bert_f32.get(name, 0)
        check(entry["launches"] > 0, f"{name} was never launched on a main path")
    order = list(_wrappers())
    kernels.sort(key=lambda e: order.index(e["name"]))
    log(f"[time] phase 5 done at {time.time() - t0:.1f}s")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if "--launch" in sys.argv:  # one process of phase 36, started by _start_pairs
        i = sys.argv.index("--")
        head = sys.argv[1:i]
        opt = lambda flag: head[head.index(flag) + 1] if flag in head else ""
        sys.exit(launch_worker(opt("--launch"), opt("--launch-after"), sys.argv[i + 1:]))
    for flag, worker in (("mesh-serve", "mesh_serve_worker"), ("train-mesh", "train_mesh_worker"),
                         ("fsdp", "fsdp_worker"), ("dxm", "dxm_worker"), ("cp", "cp_worker")):
        if f"--{flag}-rank" in sys.argv:  # one rank of phases 37-40, started by start_group
            import argparse

            ap = argparse.ArgumentParser()
            ap.add_argument(f"--{flag}-rank", type=int, required=True)
            for name in ("coordinators", "out", "after"):
                ap.add_argument(f"--{flag}-{name}", required=True)
            a = vars(ap.parse_args())
            sys.exit(globals()[worker](*(a[f"{flag.replace('-', '_')}_{k}"] for k in
                                         ("rank", "coordinators", "out", "after"))))
    if "--examples" in sys.argv:  # phase 42's process, started by start_examples
        sys.exit(examples_worker(sys.argv[sys.argv.index("--examples") + 1]))
    if "--dryrun-cells" in sys.argv:  # one process of phase 41(a), started by start_dryrun
        i = sys.argv.index("--dryrun-cells")
        sys.exit(dryrun_worker(*sys.argv[i + 1:i + 4]))
    if "--dp-rank" in sys.argv:  # one rank of phase 35, started by start_dp
        import argparse

        ap = argparse.ArgumentParser()
        for flag in ("--dp-rank", "--dp-world"):
            ap.add_argument(flag, type=int, required=True)
        for flag in ("--dp-coordinator", "--dp-out", "--dp-after"):
            ap.add_argument(flag, required=True)
        a = ap.parse_args()
        sys.exit(dp_worker(a.dp_rank, a.dp_world, a.dp_coordinator, a.dp_out, a.dp_after))
    sys.exit(main())
