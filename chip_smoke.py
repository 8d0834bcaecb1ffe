#!/usr/bin/env python3
"""Drive the PyTorch port (robo_vln_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--profile] [--only 3,9,10,11,12,13,14,15]

``--only`` runs the build and the listed phases among 3 and 9 to 15 alone,
to try them; such a run prints no result line.

Phases, one or more lines each; any failure ends the run with a non-zero
exit code and no result line:

1. Device: CUDA must be present; prints nvidia-smi's name and power limit.
2. Build: compiles every CUDA kernel of the port from csrc/ for sm_90a, one
   nvcc per source, all in parallel, into build/kernels/; prints each
   kernel instance's registers and spills, and fails if an instance of
   either float32 tensor-core attention kernel (keys whole, or in key
   blocks past S = 128), of the bf16 key-block kernel (its fill instances
   included), of either wide-head attention kernel (the float32 one on
   wgmma), of the LSTM's wide forwards (the ring's and the direct one) or of its
   partials backward (the wide kernel included) spills, or if ptxas notes
   that it serialized a kernel's wgmma.
3. Kernels against their plain versions, float32 with TF32 off (in a scope
   around this phase only), at the shapes of the serving path: the LSTM
   kernel (also at every H range of its template and at batches beyond one
   launch; timed at the tick's
   shape, and as its grid running nothing but the step-to-step exchange of
   h, the floor under a step), the LSTM's two backward kernels at the same
   shapes (``partials``, the route, which exchanges partial sums of dh~,
   and ``dg_exchange``, which exchanges the whole dg, forced; each held to
   ops/rnn.lstm_recurrence_backward and to the autograd replay of
   lstm_recurrence, each gradient within 1e-4 of its norm, every other
   shape with the masks' gradient, its launches one a slice of rows; a
   forward, backward, forward, backward sequence on one workspace, the
   second of each bitwise equal to the first; each timed as a whole call,
   as its launch alone and as its grid running nothing but its exchange,
   the floor under a reverse step, against the plain backward, the replay
   and cuDNN's backward), and the cross-modal attention
   kernel in its three routes: float32 on the tensor cores (3xTF32, the
   route of every float32 call with d_k and d_v up to 256, zero-filled to
   the instance's D, in key blocks past S = 128 and at D = 256, on
   warpgroup MMA at D = 128 and 256 and on mma.sync below, copying one
   float at a time for unaligned pointers or d off a multiple of 4), the
   first float32 kernel, on the CUDA cores (forced; no call is routed there),
   the wide-head kernel (float32 d above 256) and bfloat16 (the serving
   dtype; in both modes of p, rounded to bf16 once, the default, and split
   into p_hi + p_lo, TPU.PALLAS_ATTENTION on, each against the plain
   version in that mode and timed), each held at the same shapes and at
   ragged ones, where the route each shape takes (whether it took the key
   blocks, the copy width, the mode) is checked too; attention at the HCM
   shapes is held at N = 200 (the window's), 8 (the tick's), and 4 and 1
   (phase 7's eval ticks);
   at the window's S = 16 and S = 64 the float32 key-block kernel is also
   forced, held and timed beside the whole-key kernel.  Prints the
   largest error against the stated tolerance, and every rep's time of the
   kernel, the plain version and one PyTorch library call computing the
   same function, each rep's calls queued on the device behind a sleep so
   that a call shorter than its host cost is timed on the device.  Attention
   is timed with its inputs rotated over several sets, so that no call
   finds them in the L2 cache; at the tick's shape the bfloat16 wrapper is
   also timed unqueued, at the host's dispatch rate.  Phase 3c: shapes
   past the kernels' former ranges (bfloat16 attention in key blocks, in
   both modes, at S=144, the depth tokens of a 384 px frame, at S=300 and
   512 with d=128 and at S=1000, and at S=144 and at S=200, d=128 at the
   window's N; float32 attention in key blocks at S=144 and at S=200,
   d=128, self-attention's, both at the window's N, and at S=500; float32
   on the tensor cores at the shapes PR 1's CUDA-core kernel used to take:
   S=500 and S=64 at d=60 and d=61, pointers one float off 16 bytes, d=256
   over 2 heads; the CUDA-core kernel at d=260; the LSTM
   and both backward kernels at H=556, a ragged grid; the shapes the
   wide routes opened: the wide kernel in float32 at d=260 and 512, (d_k, d_v) = (260,
   64), S=6965 with d=300 and from pointers one float off, bf16 zero-filled
   at d=72 and (128, 64), the fill instance at d=60, 65, 66 and 68 and from
   pointers 1, 2 and 4 elements off 16 bytes (16-, 8- and 4-byte copies and
   shifted loads, each launch's narrowest copy checked), the wide kernel in
   bf16 at d=256 (S=16 and 64, one head), 260 (8-byte copies), 300 (d_k in
   chunks) and one element off, and in float32 at (100, 300) three floats
   off; the LSTM
   and its partials backward at H=30 (padded to 32), 1030 and 2048, the
   wide kernels, 4096 at B=8, and 6400 at B=8, whose buffer of h does not
   fit beside the wide forward's rings: the direct wide forward, which reads h
   from the exchange's words) must launch their kernel once
   (by the route, key blocks, copy width and wide variant the shape asks
   for) and match the plain version; S=144 and S=200, d=128 are timed at
   the window's size in both dtypes against the plain version and SDPA
   (float32 also against the CUDA-core kernel forced, bf16 in both modes), as are
   float32 S=500, d=60, S=64, d=60 and S=200, d=256, h=2 (with the wide
   kernel forced there too) and phase 14's float32 window at d=256, h=1,
   S=16 and 64 (the key-block kernel's D = 256 instance, a cluster of two
   blocks; also held to the plain version with N=200, as are d_k != d_v
   across the cluster's halves and S=1000 at d=32), the wide kernel at d=260 in both dtypes (float32
   beside the CUDA-core kernel forced, which it must beat) and at phase 14's bf16
   shapes, bf16 at d=72 beside the aligned d=80 and from unaligned pointers
   beside the aligned d=64, and the LSTM's wide
   kernels at T=50, B=4, H=2048 against the plain versions and cuDNN, each
   also as its launch alone and as its grid running nothing but its
   exchange (per step), the backward's cluster printed; the
   forced-only dg_exchange backward, which keeps its range, must refuse
   H=1028 before any launch.
4. Serving path at full published width (BERT-base, TV-ResNet50 at 224 px,
   DDPPO GN-ResNet50 at 256 px, VisualLingAttn d_model 256 / 4 heads, LSTM(512)),
   random weights from seed 0, bfloat16 compute: three teacher-forced windows
   (B=4, T=50, 200 instruction tokens), then 10 closed-loop ticks at B=8 with
   the BERT embedding cached.  The launch counts are zeroed just before and
   read just after; every output must be finite.  Then the float32 agent's
   window is timed (it must launch the float32 tensor-core attention only)
   and compared with the same agent whose kernels are swapped for their
   plain versions, with torch's global TF32 flags at their defaults.  With
   --profile, torch.profiler traces one window and five ticks first and
   prints the device's busy share and top kernels.
5. Train path: the hierarchical train step (training/steps.py) at the same
   width in bfloat16, random weights from seed 0, on the bench's batch
   (B=4, T=50, 200 tokens; AdamW with weight decay 1e-5 on the high level,
   Adam without on the low level, lr 1e-4): five steps, each timed with
   CUDA events and the host clock, each launching each kernel exactly twice
   (the LSTM's forward and its backward twice each);
   every loss finite, the frozen parameters bitwise unchanged, every
   trainable one given a gradient and moved (but the progress monitors,
   which nothing calls: no gradient, unchanged); the peak memory.  With
   --profile, one step is
   traced, split into forward, backward (and in it the LSTM's backward
   kernel and attention's replay) and optimizer.  Then one float32 step,
   against the same step with every kernel swapped for its plain version
   (the LSTM's backward for the autograd replay), from the same weights and
   batch (lr 0, so the weights stay): losses within 1e-4 relative, each
   trainable leaf's gradient within 1e-3 of its norm; and the same for the
   kernels' step with TPU.REMAT on (4 forward and 2 backward LSTM launches).
6. Trainer path: ``python -m robo_vln_tpu_torch.run``'s ``run_exp``, twice,
   at the same width in bfloat16 (config from options, no yaml: B=4,
   tbptt 50, one bucket of 100, EPOCHS 2, one epoch a run, RESUME, synced
   trunks), over synthetic buffers the port's writer puts in a temporary
   directory under build/ (8 train episodes of 60-100 steps in the msgpack
   format, 4 eval episodes in the flat format, about 270 MB; removed at the
   end, with the checkpoints).  Run 1 trains epoch 0 (4 steps), validates
   (2 windows) and writes ``ckpt.2``; run 2 resumes from it and writes
   ``ckpt.3`` with 8 train steps.  Checked: the trunks shared, each train
   step and val window launching each forward kernel exactly twice (and
   a train step the LSTM's backward twice, a val window never), every logged
   loss finite, the frozen parameters bitwise unchanged, ``ckpt.2`` loaded
   into a fresh trainer bitwise equal to the first trainer's parameters,
   Adam state and counters, run 2 starting at step 4.  Printed: each step's
   host time (a wrapper around ``trainer.train_step``, set from outside the
   trainer) beside phase 5's bare step, the gaps between steps, the
   epochs, the validation, checkpoint save and load times and size, peak
   memory.  With --profile, run 2 is traced.
7. Eval path: ``python -m robo_vln_tpu_torch.run --run-type eval``'s
   ``run_exp`` at the same width in bfloat16, twice: a port checkpoint of
   random weights from seed 0 (synced trunks; written under build/ with 8
   synthetic robo_vln_v1 episodes, reference paths of 5-10 m, 200 token
   ids; removed at the end) evaluated closed-loop on the kinematic backend
   with MAX_EPISODE_STEPS cut from 1000 to 60, at EVAL.NUM_ENVS 1 and then
   8.  Checked: the stats JSON exists with finite ndtw, spl, success,
   actual_success, path_length and distance_to_goal over 8 episodes; every
   tick launches the LSTM forward twice and bf16 attention (p rounded
   once) twice, and nothing else; every parameter, the frozen ones among
   them, equals the checkpoint's after the eval.  Printed for each
   NUM_ENVS: env steps and episodes a second of rollout, the median tick
   split into the policy (CUDA events around ``HCMAgent.act``; the host's
   whole tick) and the env step with its render (host clock), BERT's
   embeddings; then which integrator the sim used and the peak memory.
   With --profile, torch.profiler traces the rollout at NUM_ENVS 8 (its
   busy share; the timings of that run include the profiler's cost).
   The checkpoint's low-level velocity head is biased so that the agent
   drives about 5 m/s and episodes end on success at different ticks; the eval's trainers start from another seed, so an eval that
   skipped the load fails the comparison with the checkpoint's parameters,
   and one whose agent does not drive (under 1 m an episode) fails.
   7b: four episodes in float32 at NUM_ENVS 4 from the same checkpoint,
   once with the kernels and once with their plain versions: every
   episode's success, actual_success and length must agree, every step's
   position within 1e-3 m (EVAL.DUMP_TRAJECTORIES); the kernels' ticks
   (their frames and resets) are replayed through the plain versions, and
   each tick's lin_vel, omega, stop logit and both levels' LSTM states
   must agree within 1e-4 of that one's range over the run;
   and some episode must end on success and not all at one tick.
   After phases 4-8: the key-block kernels of the attention (float32 on
   the tensor cores and bf16) and the float32 one-float copies must have
   launched on none of the five paths.  Each path's bf16 attention rounds
   p once (the config's default), and its LSTM backward is the partials
   kernel: split_p and the dg-exchange kernel launch on none.
8. Collection path: DAgger data collection through
   ``python -m robo_vln_tpu_torch.run``'s ``run_exp`` over 8 synthetic
   robo_vln_v1 episodes (phase 7's writer; a scene each) on the kinematic
   backend at full width (224 px rgb, 256 px depth), in a temporary
   directory under build/ (removed at the end).  8a: expert collection on
   the port's robovln_data_train.yaml (robo_vln_trainer, COLLECT_ONLY,
   UPDATE_SIZE 8, MAX_EPISODE_STEPS 1000 as shipped) at NUM_PROCESSES 1 and
   4 (spawned workers): the 4-process buffer must hold the serial buffer's
   8 episodes bitwise in some order (sha256 of each stored episode), the
   port's loader must read both, and no kernel may launch; printed: episodes
   and env steps a second, when the first and last episode reached the
   buffer, env steps a worker, MiB an episode on disk, ticks an episode.
   8b: the hierarchical trainer collecting and training in one run in
   bfloat16 (PRELOAD_LMDB_FEATURES false, ITERATIONS 2, P 0.5, UPDATE_SIZE
   4, one epoch an iteration, BATCH_SIZE 4, tbptt 50, MAX_EPISODE_STEPS
   cut to 150, synced trunks): iteration 0 at beta 1, iteration 1 mixed at
   beta 0.5 with the trained policy on the card.  Checked: 8 episodes and
   ckpt.1, ckpt.2 at the end; every mixed tick launches the LSTM forward
   twice and bf16 attention (p rounded once) twice and nothing else, the
   expert iteration nothing, the epochs 2 of each forward and 2 of the
   LSTM's backward a train step; some tick executed a policy command that
   is not the expert's label.  Printed: each iteration's env steps a
   second, the mixed tick's policy (CUDA events around ``HCMAgent.act``,
   and the host clock around the mixer's step) and env step (host clock),
   the share of ticks the policy's command ran, BERT's embeddings, the
   launches during the mixed collection and during the epochs.  8c: a
   float32 trainer's mixed collection (2 episodes of at most 60 ticks,
   beta 0.5): its ticks (frames, masks, prev) are replayed through the
   plain versions, and each tick's lin_vel, omega and both levels' LSTM
   states must agree within 1e-4 of that one's range.
9. Feature path (DAGGER.PRELOAD_TRUNK_FEATURES): phase 6's synthetic
   buffers in a temporary directory under build/.  9a: both featurized
   through training/featurize.ensure_featurized in bf16 by a trainer with
   synced trunks (frames a second, MiB raw and featurized, the trunk
   outputs outside float16's range, which must be 0); a second call must
   run no trunk, and after one more raw episode a third must featurize
   exactly that one; the first batch's three losses (the val step, no
   dropout) from features within rtol 2e-2, atol 2e-3 of the same batch's
   from raw frames.  9b: run_exp's train path once from the features (one
   epoch of 6 steps, its validation, bf16): no trunk runs, each train step
   2 + 2 + 2 launches and each val window 2 + 2; printed: the steps' host
   times, the median of steps 2-4 by host clock and CUDA events, the
   epoch, the val window, peak memory, beside phase 6's raw run.  9c: a
   float32 feature-mode step (lr 0) against the same step with the plain
   versions, at phase 5b's tolerances.
10. On-device path (EVAL.ON_DEVICE): run_exp's eval over phase 7's 8
   synthetic episodes and kind of checkpoint, ON_DEVICE_BATCH 8,
   MAX_EPISODE_STEPS 60, bf16: the whole rollout on the card, each batch a
   CUDA graph of eval/ondevice.GRAPH_TICKS ticks replayed until every
   episode is done.  10a: the stats JSON has the host driver's keys, every
   episode's stats finite, the agent drove; each tick in the graph launches
   the LSTM twice and bf16 attention (p rounded once) twice, nothing else;
   at most ceil(60 / K) + 1 host syncs a batch; printed: env steps and
   episodes a second (the driver, and the runs less the capture), ticks a
   batch, the warm-up and capture times, ms a tick by CUDA events around
   the replays, launches a tick, beside phase 7's NUM_ENVS 8 rate.  10b:
   the batch again as a graph (its host time and rate), a replay past its
   end must change nothing, and the same batch stepped eagerly must give
   the same positions (within 1e-5 m) and steps; n_ticks = max(steps).
   10c: four episodes in float32, each tick stepped from the same carry
   with the kernels and with the plain versions, the run advanced on the
   kernels': each tick's actions and both LSTM states within 1e-5 of their
   range.
11. Flat path (the flat family, cma_robo.yaml and seq2seq_robo.yaml as
   shipped: 224 px rgb, 256 px depth, 200 GloVe ids of a 2504 vocabulary,
   LSTM(512), B=1, tbptt 100, bf16).  11a: the LSTM kernel and its backward
   (the partials route) at T=100, B=1, H=512 against their plain versions
   at 3a's tolerances, timed beside the plain versions, cuDNN and the
   bound.  11b: for CMA and Seq2Seq each, three window forwards and three
   train steps (CUDA events, host clock, peak memory): each window
   launches the LSTM forward 2 (CMA) or 1 (Seq2Seq) times and attention
   never, each step as many forward and backward LSTM launches; the
   frozen trunks unchanged, every trainable leaf but the unused heads given
   a gradient; then the instruction RNN's path on the card (cuDNN over a
   packed sequence) against the CPU's scans within 1e-5, float32, both
   timed; then a float32 step (lr 0) against the same step with the plain
   versions at 5b's tolerances.  11c: run_exp --run-type train on
   cma_robo.yaml (EPOCHS cut to 1) over 4 train and 2 eval synthetic
   episodes of 60-100 steps under build/ (removed at the end): one
   checkpoint, 2 + 2 LSTM launches a step and 2 a val window, every
   logged loss finite.  11d: that checkpoint (its lin_vel bias -5 so that
   the agent drives) evaluated through run_exp over phase 7's kind of
   episodes with GloVe ids, at NUM_ENVS 8 on the host driver (2 LSTM
   launches a tick, no attention; env steps a second, the policy's ms a
   tick by CUDA events around FlatAgent.act) and with EVAL.ON_DEVICE (the
   graph's 2 launches a tick; its stats keys the host's; the same batch
   stepped eagerly within 1e-5 m of the graph's positions).
12. Extras path (the eval's extras and the flat family's last parts, at
   full width).  Whether OpenCV imports: if not, get_config must refuse
   VIDEO_OPTION before any work, and the videos and the map are left to the
   CPU tests.  12a: the HCM eval through run_exp at EVAL.NUM_ENVS 1, bf16,
   with PLOT_ATTENTION (and, with OpenCV, VIDEO_OPTION disk and the
   TOP_DOWN_MAP measure) on phase 7's kind of checkpoint over the first 4
   of its episodes at 60 ticks: one heatmap PNG an episode, (ticks x 200)
   scaled; an mp4 an episode, read back with a frame a tick at the size
   written (even sides); 2 LSTM and 2 attention launches a tick (the sow's
   maps are computed beside the kernel's output, for the plot only), and
   with the key off over the same episodes 2 and 2 as well;
   env steps a second, the policy's ms a tick by CUDA events, a frame's
   assembly and encode-and-write ms, a PNG's ms.  Then float32 with the key
   on and off: positions within 1e-3 m (as 7b), and the key-on run's ticks
   replayed with the key off, outputs and LSTM states within 1e-4 of their
   range.  12b: nonlearning.yaml through run_exp --run-type eval, each of
   RandomAgent, HandcraftedAgent and ExpertAgent over phase 7's 8
   episodes: the stats JSON with the host eval's keys less actual_success,
   env steps a second, no launch.  12c: cma_robo.yaml with
   MODEL.CMA.rcm_state_encoder, as 11b (1 LSTM launch a window, 1 + 1 a
   step) and as 11c-11d (1 a tick, on the host driver and in the graph).
   12d: run_exp train on cma_robo.yaml with DAGGER.PRELOAD_TRUNK_FEATURES
   over 11c's episodes: frames a second featurized, the feature-mode step
   beside 11c's raw step, no trunk run in a step, 2 + 2 LSTM launches a
   step; the first eval batch's float32 val losses from features within
   phase 9's tolerance of those from raw frames.  12e: HighLevelSeq2SeqPolicy
   (BERT-base, both trunks, LSTM(512)), B=4, T=50, 200 tokens: the bf16
   window by CUDA events, 1 LSTM launch; the float32 window against its
   plain-kernel twin within 2e-3.
13. The data plane and the mesh, at phase 6's width and options (bf16
   unless said; a temporary directory under build/, removed at the end).
   13a: phase 6's synthetic buffers written twice, through the native
   trajectory store (sim/trajstore.cc, built by g++ into build/sim/) and
   through the Python backend (ROBO_VLN_STORE_BACKEND): their store.dat and
   store.idx must be equal byte for byte, the native store must have built;
   both backends' read rates over the train buffer, twice each, in MB a
   second; then run_exp's train epoch with DAGGER.LOADER_WORKERS 4 (each
   worker batches its own shard, so its 2 episodes make one batch padded
   to 4): the epoch's episodes must be the in-process loader's as a
   multiset (sha256 of each real row), phase 6's launches a step and a
   val window (2 + 2 forward, attention rounding p once, and 2 of the
   LSTM's partials backward a step; 2 + 2 a val window), every logged loss
   finite, and
   no shared-memory segment left in /dev/shm; printed: each step's host
   time, the gaps between steps and the wait for the first batch, beside
   phase 6's, and each window's copy to the card (13b prints the same for
   the in-process loader).  13b: run_exp's
   epoch at TPU.MESH_SHAPE [-1, 1], which resolves to one rank, with DEVICE
   as a user leaves it ("cuda", no index), inside an NCCL group of one that
   the phase opens (a run of one rank has no group of its own): its trainer
   must run on the group's one rank, with phase 6's launches a step and a
   val window; printed: the all-reduce of each step (the gradients and losses in
   one buffer) and val window by CUDA events and host clock; then a float32
   step (lr 0) in the group against the same step outside any group: losses
   and gradients bitwise equal (or, where the step outside does not repeat
   bitwise, within phase 5b's tolerances).  13c: two ranks of a gloo group
   spawned on the one card (NCCL takes one rank a device), each on its rows
   of a global batch of 4 (rank 0's mostly padding: one episode of 12 real
   steps and one all padding; rank 1's full), dropout off: each rank's
   float32 step (lr 0) against one process's step on the global batch at
   phase 5b's tolerances (losses 1e-4 relative, each trainable leaf's
   gradient 1e-3 of its norm), then 3 bf16 steps a rank: every loss finite
   and both ranks' weights bitwise equal after them; each step 2 + 2
   forward and 2 LSTM backward launches; printed: each step's host ms and
   its gloo all-reduce (through the host, so no target is set).
14. The shapes past the kernels' former ranges on the path: the HCM at
   full width (phase 4's) with MODEL.STATE_ENCODER.hidden_size 2048 (both
   LSTMs: the wide forward and backward) and MODEL.VISUAL_LING_ATTN.h 1
   (d = 256: the wide attention kernel in bf16, the tensor-core D = 256 key
   blocks in float32), random weights from seed 0: in bf16 and in float32
   one window (build_hcm_agent) and one train step (training/steps, lr 0),
   each held to the same run under plain_kernels() (float32 at phases 4b's
   and 5b's tolerances; bf16 the window's outputs within 2e-2 of each
   one's largest magnitude, the low level's only where the high level's
   argmax agrees, the losses within phase 9's bf16 tolerances), each with
   its launches asserted (a window: 2 LSTM, both wide, and 2 attention, in
   bf16 wide and rounding p once; a step adds 2 wide backward).
15. ROADMAP §A item 8, after the key-block check (its S = 200 calls take
   the key-block kernels; it counts its own launches).  15a: random-valued
   pretrained files at full published size in the three layouts the loader
   reads (torchvision ResNet50 .pth, HF bert-base .npz with 12 layers of
   768 and a vocabulary of 30522, a DDPPO .pth {"state_dict"} under
   actor_critic.net.visual_encoder.) in a temporary directory; run_exp's
   hierarchical trainer (phase 6's set-up) from them for 2 steps: all
   three ``loaded``, every trunk and BERT tensor of both levels equal to
   the file's bitwise after the steps, 2 + 2 forward and 2 backward
   launches a step.  15b: one bf16 train step of that trainer under
   torch.profiler: each module range's calls, kernel time and device span
   (TVResNet50, GNResNetEncoder, BertEncoder, HighLevelPolicy, which holds
   BERT, LowLevelPolicy) beside the step's ranges.  15c: the nine blocks of
   models/transformer.py that no policy builds, at the widths of their
   config stanzas (the JAX defaults, config/jax_only.INERT) over N=200
   rows of 200 instruction and 16 image tokens, bf16 and float32, each
   held to itself under plain_kernels() (float32 within 1e-4, bf16 within
   phase 14's 2e-2 of the largest magnitude) with its attention launches
   and key blocks asserted (a masked call launches nothing); the
   self-attention at S=200, d=64, h=4 and the image-to-instruction
   cross-attention at Lq=16, S=200, d=128, h=2 held to the plain version
   and timed against it and SDPA in both dtypes.  15d: the port's LangNav
   study (robo_vln_tpu_torch/scripts/convergence_study.py) in this process
   at full width: 8 train and 4 val episodes, one epoch from the feature
   store, 150 ticks, the on-device eval, the host row, the control and the
   nonlearning rows; both kernels launched; scripts/collect_study_results.py
   reads the rows.
16. One JSON line {"kernels": [...]}: the LSTM, its two backward kernels
   (lstm_seq_backward, the route; lstm_seq_backward_dg_exchange), the
   attention (its float32 route and every bf16 field) and its bf16 modes
   (cross_modal_attn_bf16_round_p, cross_modal_attn_bf16_split_p);
   ``launches``: the serving path's, but the LSTM backward's, which the
   serving path never runs, is the train path's; ``train_launches``: the
   train path's, ``trainer_launches``: the trainer path's,
   ``eval_launches``: the eval path's (phase 7's two bf16 runs),
   ``collect_launches``: the collection path's (8b's two collections,
   their epochs left out; 8a's collections launch nothing),
   ``feature_launches``: 9b's run, ``ondevice_launches``: 10a's replays (a
   graph's launches, counted at its capture, times the replays);
   ``flat_launches``: phase 11's paths (each model's windows and train
   steps, the trainer, the host eval, the on-device eval's replays); the
   LSTM and its backward also carry 11a's ``flat_*`` fields (one call at
   T=100, B=1, H=512); ``extras_launches``: phase 12's paths;
   ``loader_launches``: 13a's epoch; ``mesh_launches``: 13b's epoch and
   13c's steps of both ranks; ``wide_launches``: phase 14's runs with the
   kernels; then the kernels past the former ranges
   (cross_modal_attn_f32_key_blocks: the float32 key-block kernel at phase
   14's float32 window, with (a) S=144, h=4, d=64, (b) S=200, h=4, d=128,
   (c) S=500, h=4, d=60 and (e) S=200, h=2, d=256 under a_*, b_*, c_* and
   e_*; cross_modal_attn_wide_f32, cross_modal_attn_wide_bf16, lstm_seq_wide,
   lstm_seq_backward_wide, the last two with kernel_only_ms, exchange_floor_ms,
   step_us, units and the backward's cluster), their ``launches`` phase 14's;
   ``item8_launches``: phase 15's paths (15a's steps, 15c's blocks, 15d's
   study), and the attention entry's ``item8_module_ms`` 15b's module
   times; then the attention kernel at 15c's two shapes
   (cross_modal_attn_s200_d64, cross_modal_attn_lq16_s200_d128: bf16 in
   the entry's fields, float32 under f32_*), their ``launches`` 15c's
   calls at that shape.  Then the
   card's name and power limit, then the last line
   {"ok": true, "device": {...}}.
"""

import collections
import contextlib
import glob
import itertools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

# phase 8a's spawned collection workers re-run this script as __mp_main__ to
# find their target; they need no torch, whose import would add seconds to
# each worker's start-up (the CLI's workers import none either)
if __name__ != "__mp_main__":
    import torch

# published peaks of one H100 SXM (NVIDIA data sheet): HBM bytes/s, float32
# FLOP/s outside the tensor cores (the LSTM, and the float32 attention's
# bound, kept so that its rows stay comparable), and dense bf16 and TF32
# FLOP/s of the tensor cores (the bfloat16 attention route; the float32
# route's three tf32 products, printed beside its bound)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_TC_FLOP_PER_S = 989e12
TF32_TC_FLOP_PER_S = 495e12
QUEUE_SLEEP_CYCLES = 10_000_000  # about 5 ms at the H100's clock
L2_ROTATION = 3  # input sets a timed attention call cycles over (>= 44 MB each; L2 50 MB)

LSTM_TOL = 1e-4  # float32; the T sequential steps sum in another order
# float32, each gradient's largest error against that gradient's norm: the
# reverse sums over T steps and over 4H run in another order
LSTM_BACKWARD_TOL = 1e-4
ATTN_TOL = 1e-4  # float32; another summation order over d_k and S
ATTN_BF16_TOL = 2e-2  # one bfloat16 rounding of outputs of magnitude < 4
WINDOW_TOL = 2e-3  # float32 agent, kernels against plain, through 50 steps
TRAIN_LOSS_RTOL = 1e-4  # float32 train step, kernels against plain, relative
TRAIN_GRAD_TOL = 1e-3  # the same, each leaf's gradient, of that leaf's norm
TRAIN_STEPS = 5
# phase 9: the val step's losses from float16 features against those from
# raw frames, bf16 (the JAX package's feature-store test's tolerance)
FEATURE_LOSS_RTOL, FEATURE_LOSS_ATOL = 2e-2, 2e-3
TRAINER_EPISODES = 8  # phase 6: 2 batches of 4, 2 windows of 50 each: 4 steps an epoch
TRAINER_EVAL_EPISODES = 4  # one batch, 2 val windows
EVAL_EPISODES = 8  # phase 7
EVAL_MAX_STEPS = 60  # phase 7: TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS cut from 1000
EVAL_NUM_ENVS = (1, 8)
EVAL_F32_EPISODES = 4  # phase 7b, one env each
EVAL_POSITION_TOL = 1e-3  # metres: 7b, float32 kernels against plain, closed-loop
# 7b, the kernels' ticks replayed through the plain versions: each tick's actions,
# stop logit and LSTM states, of each one's range over the run
EVAL_OUTPUT_RTOL = 1e-4
# the saved low level's velocity head: weight scaled, bias (lin_vel, omega)
# added, so that the agent drives about 5 m/s forward, steered by the
# network, and episodes end on success at different ticks.  A larger scale
# feeds the closed loop's float rounding back through the frames faster:
# at 10, 7b's positions part by 2.8e-3 m in 60 ticks on an H100 80GB HBM3
# (scripts/eval_divergence_probe.py)
EVAL_VELOCITY_SCALE, EVAL_VELOCITY_BIAS = 1.0, (-5.0, 0.0)
ONDEVICE_BATCH = 8  # phase 10: EVAL.ON_DEVICE_BATCH
ONDEVICE_F32_EPISODES = 4  # 10c, one batch
ONDEVICE_TRACE_TOL = 1e-5  # metres: 10b, the graph's positions against the eager ticks'
# 10c, each tick's actions and LSTM states, kernels against plain from the same
# carry, of each one's range over the run
ONDEVICE_OUTPUT_RTOL = 1e-5
# the host driver's stats (eval/evaluator._run_rollout's episodes)
ONDEVICE_STATS_KEYS = ("distance_to_goal", "success", "spl", "path_length", "navigation_error",
                       "steps_taken", "ndtw", "actual_success")
COLLECT_EPISODES = 8  # phase 8: the synthetic episodes, and 8a's UPDATE_SIZE
COLLECT_PROCESSES = (1, 4)  # 8a: NUM_PROCESSES
COLLECT_UPDATE = 4  # 8b: UPDATE_SIZE, two iterations
COLLECT_MAX_STEPS = 150  # 8b: MAX_EPISODE_STEPS cut from 1000, and the one length bucket
COLLECT_F32_EPISODES = 2  # 8c
COLLECT_F32_MAX_STEPS = 60  # 8c: MAX_EPISODE_STEPS cut from 1000
# 8c, the float32 mixed ticks replayed through the plain versions: each tick's
# actions and LSTM states, of each one's range over the run
COLLECT_OUTPUT_RTOL = 1e-4
EVAL_STATS = ("ndtw", "spl", "success", "actual_success", "path_length", "distance_to_goal")
# a bias on the keys adds the same q·b to every logit of a query row, which
# the softmax cancels: this leaf's exact gradient is 0
ZERO_GRAD_LEAF = "enc_att.attention.fc_k.bias"


def fail(msg):
    raise RuntimeError(f"chip_smoke: {msg}")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def kernel_name(mangled):
    """kernel<template args> from a mangled kernel name: the identifier
    ending in _kernel that its length prefix delimits."""
    for m in re.finditer(r"(?=(\d+))", mangled):
        start = m.start() + len(m.group(1))
        word = mangled[start:start + int(m.group(1))]
        if word.endswith("_kernel") and word.isidentifier():
            args = re.match(r"I((?:L[ib]\d+E|f|\d+__nv_bfloat16)+)E",
                            mangled[start + len(word):])
            if args is None:
                return word
            names = {"f": "float", "__nv_bfloat16": "bf16"}
            return word + "<" + ",".join(
                names.get(a.lstrip("0123456789"), a.strip("LibE"))
                for a in re.findall(r"L[ib]\d+E|f|\d+__nv_bfloat16", args.group(1))) + ">"
    return mangled


def ptxas_usage(log):
    """(kernel, registers, spill-store bytes) of each kernel instance in an
    ``nvcc -Xptxas -v`` log."""
    usage, name, spill = [], None, 0
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = kernel_name(m.group(1))
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            usage.append((name, int(m.group(1)), spill))
            name, spill = None, 0
    return usage


def time_ms(fn, reps=10, inner=10, warmup=3, queued=True):
    """Per-call ms of fn over ``reps`` CUDA-event windows of ``inner`` calls.
    ``queued``: each window waits on the device behind a sleep of a few ms
    while the host dispatches its calls, so a call shorter than its host
    cost is timed on the device, not at the host's dispatch rate."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(QUEUE_SLEEP_CYCLES)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return times


def report_times(label, times):
    print(f"  {label}: median {statistics.median(times):.4f} ms, reps "
          + " ".join(f"{t:.4f}" for t in times))
    return statistics.median(times)


def lstm_inputs(gen, T, B, H, device):
    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(device)

    # odd rows reset at t=0, even rows go on from h0 and c0, so both count at
    # every shape, T=1 included
    masks = torch.ones(T, B)
    masks[0, 1::2] = 0.0
    if T > 2:
        masks[T // 2, B - 1] = 0.0  # a reset inside the window
    # w_hh (H, 4H) as the transposed view of a (4H, H) tensor, the layout
    # the agent passes (weight_hh_l0.t()), so the wrapper copies nothing
    return (randn(T, B, 4 * H), masks.to(device), randn(B, H), randn(B, H),
            randn(4 * H, H, scale=H ** -0.5).t())


def lstm_bound_ms(T, B, H):
    bytes_moved = 4 * (T * B * 4 * H + T * B + 2 * B * H + 4 * H * H
                       + T * B * H + 2 * B * H)
    flops = 2 * T * B * H * 4 * H
    return bytes_moved / HBM_BYTES_PER_S * 1e3, flops / F32_FLOP_PER_S * 1e3


def lstm_backward_bound_ms(T, B, H):
    """The backward call's least time: it reads gates_x, masks, h0, c0, w_hh,
    outs and the three cotangents once and writes d_gates_x, d_h0, d_c0 and
    d_w_hh once; its operations are three float32 products of 2·T·B·H·4H
    (the gates recomputed, dh~ = dg·W_hh^T in the kernel, d_w_hh), on the
    CUDA cores (TF32 off).  Also the kernel's own share: the dh~ product, and
    the gates, W_hh, the cotangents and masks read and dg, d_h0, d_c0 written."""
    reads = T * B * 4 * H + T * B + 2 * B * H + 4 * H * H + 2 * T * B * H + 2 * B * H
    writes = T * B * 4 * H + 2 * B * H + 4 * H * H
    flops = 2 * T * B * H * 4 * H
    kernel_bytes = 4 * (T * B * 4 * H + T * B + B * H + 4 * H * H + T * B * H + 2 * B * H
                        + T * B * 4 * H + 2 * B * H)
    return ((4 * (reads + writes) / HBM_BYTES_PER_S * 1e3, 3 * flops / F32_FLOP_PER_S * 1e3),
            (kernel_bytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOP_PER_S * 1e3))


def attn_bound_ms(N, Lq, S, heads, d, itemsize, flop_per_s):
    bytes_moved = itemsize * (N * Lq * heads * d * 2 + N * S * heads * d * 2)
    flops = 2 * N * heads * Lq * S * (d + d)
    return bytes_moved / HBM_BYTES_PER_S * 1e3, flops / flop_per_s * 1e3


def rotated(fn, arg_sets):
    """fn over the argument sets in turn: each call's inputs were last touched
    len(arg_sets) - 1 calls ago, with the other sets' bytes through L2 since."""
    turns = itertools.cycle(arg_sets)
    return lambda: fn(*next(turns))


def lstm_cotangents(gen, T, B, H, device):
    """Cotangents of (outs, hT, cT) for the backward."""
    return tuple(torch.randn(*shape, generator=gen).to(device)
                 for shape in ((T, B, H), (B, H), (B, H)))


def replay_backward(gates_x, masks, h0, c0, w_hh, outs, g_outs, g_hT, g_cT, masks_grad=True):
    """The LSTM's gradient by autograd: lstm_recurrence replayed and
    differentiated, as the JAX custom VJP replays its scan.  The signature of
    fused_lstm.lstm_seq_backward_cuda; ``outs`` is not used."""
    from robo_vln_tpu_torch.ops.rnn import lstm_recurrence

    inputs = [t.detach().requires_grad_(i != 1 or masks_grad)
              for i, t in enumerate((gates_x, masks, h0, c0, w_hh))]
    with torch.enable_grad():
        res = lstm_recurrence(*inputs)
        want = [t for t in inputs if t.requires_grad]
        grads = iter(torch.autograd.grad(res, want, (g_outs, g_hT, g_cT)))
    return tuple(next(grads) if t.requires_grad else None for t in inputs)


def check_lstm_backward(tag, args, outs, cots, masks_grad, kernel=None):
    """One call of the backward, by its route or by ``kernel`` forced, held
    to the plain backward and to the autograd replay: (largest absolute
    error, largest error of a gradient's norm, launches of that kernel, the
    kernel's gradients).  Every launch must be that kernel's."""
    from robo_vln_tpu_torch.ops import fused_lstm
    from robo_vln_tpu_torch.ops.rnn import lstm_recurrence_backward

    kernel = kernel or fused_lstm.BACKWARD_KERNEL
    before = fused_lstm.backward_launches, fused_lstm.backward_kernel_launches[kernel]
    with backward_kernel(kernel):
        got = fused_lstm.lstm_seq_backward_cuda(*args, outs, *cots, masks_grad=masks_grad)
    launched = fused_lstm.backward_kernel_launches[kernel] - before[1]
    if fused_lstm.backward_launches - before[0] != launched:
        fail(f"lstm_seq backward at {tag} launched another kernel than {kernel}")
    tag = f"{tag} [{kernel}]"
    worst_abs = worst_rel = 0.0
    for label, ref in (("plain", lstm_recurrence_backward(*args, outs, *cots,
                                                          masks_grad=masks_grad)),
                       ("autograd replay", replay_backward(*args, outs, *cots,
                                                           masks_grad=masks_grad))):
        torch.cuda.synchronize()
        errs = []
        for name, g, r in zip(("gates_x", "masks", "h0", "c0", "w_hh"), got, ref):
            if (g is None) != (r is None) or (g is not None and g.shape != r.shape):
                fail(f"lstm_seq backward at {tag}: d_{name} is {g if g is None else g.shape}, "
                     f"the {label} version's {r if r is None else r.shape}")
            if g is None:
                continue
            err = (g - r).abs().max().item()
            rel = err / max(r.norm().item(), 1e-30)
            if not torch.isfinite(g).all():
                fail(f"lstm_seq backward at {tag}: non-finite d_{name}")
            errs.append(rel)
            worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, rel)
        print(f"  backward {tag}, masks gradient {masks_grad}, against the {label} version: "
              f"largest error {max(errs):.3e} of its gradient's norm "
              f"(tolerance {LSTM_BACKWARD_TOL}), {launched} launch(es)")
        if not max(errs) <= LSTM_BACKWARD_TOL:
            fail(f"lstm_seq backward disagrees with the {label} version at {tag}")
    return worst_abs, worst_rel, launched, got


def check_lstm(gen, device):
    from robo_vln_tpu_torch.ops import fused_lstm
    from robo_vln_tpu_torch.ops.rnn import lstm_recurrence, lstm_recurrence_backward

    print("phase 3a: lstm_seq kernel against ops/rnn.lstm_recurrence, and its backward "
          "kernels (partials, the route; dg_exchange, forced) against "
          "ops/rnn.lstm_recurrence_backward and the autograd replay, float32")
    worst = 0.0
    bwd_worst = {kernel: [0.0, 0.0] for kernel in fused_lstm.BACKWARD_KERNELS}
    timed = {}
    # the window's and the tick's shapes, batches over several warps' tasks,
    # small hidden sizes, every count of W_hh's 16-byte chunks a lane (KC =
    # 1..8: H up to 128, 256, ..., 1024), the most rows one launch takes at
    # H=512 and H=1024, and a batch run as two launches
    shapes = ((50, 4, 512), (1, 1, 512), (1, 8, 512), (2, 8, 512), (5, 20, 512),
              (7, 11, 64), (3, 2, 32), (3, 6, 256), (3, 5, 384), (2, 3, 640),
              (2, 3, 768), (2, 3, 896), (3, 28, 1024), (2, 56, 512), (3, 60, 512))
    for n, (T, B, H) in enumerate(shapes):
        args = lstm_inputs(gen, T, B, H, device)
        before = fused_lstm.launches
        got = fused_lstm.lstm_seq_cuda(*args)
        launched = fused_lstm.launches - before
        ref = lstm_recurrence(*args)
        torch.cuda.synchronize()
        err = max((g - r).abs().max().item() for g, r in zip(got, ref))
        worst = max(worst, err)
        print(f"  T={T} B={B} H={H}: max_abs_err {err:.3e} (tolerance {LSTM_TOL}), "
              f"{launched} launch(es)")
        if launched != (2 if B > 56 else 1):
            fail(f"lstm_seq took {launched} launches at T={T} B={B} H={H}")
        if not err <= LSTM_TOL:
            fail(f"lstm_seq disagrees with its plain version at T={T} B={B} H={H}")
        # the backward from the kernel's outs; every other shape asks for the
        # masks' gradient, and one cotangent is autograd's expanded zeros
        cots = lstm_cotangents(gen, T, B, H, device)
        if (T, B) == (7, 11):
            cots = (cots[0], cots[1], torch.zeros(1, H, device=device).expand(B, H))
        for kernel in fused_lstm.BACKWARD_KERNELS:
            units = fused_lstm._backward_units(device.index, H, kernel)[0]
            want = len(fused_lstm.backward_batch_slices(B, H, units, kernel))
            for masks_grad in ((True, False) if n == 0 else (n % 2 == 0,)):
                e_abs, e_rel, launched, _ = check_lstm_backward(
                    f"T={T} B={B} H={H}", args, got[0], cots, masks_grad, kernel)
                w = bwd_worst[kernel]
                bwd_worst[kernel] = [max(w[0], e_abs), max(w[1], e_rel)]
                if launched != want:
                    fail(f"lstm_seq backward ({kernel}) took {launched} launches at T={T} "
                         f"B={B} H={H}, expected {want}")
        call = lambda: fused_lstm.lstm_seq_cuda(*args)
        if (T, B) == (50, 4):
            kernel = report_times("kernel", time_ms(call))
            plain = report_times("plain", time_ms(lambda: lstm_recurrence(*args), inner=2))
            lstm = torch.nn.LSTM(896, H).to(device)
            x = torch.randn(T, B, 896, generator=gen).to(device)
            hc = (args[2][None], args[3][None])
            library = report_times("library nn.LSTM (cuDNN, input 896, masks all 1)",
                                   time_ms(lambda: lstm(x, hc)))
            # the same grid, T steps of nothing but the h exchange
            floor = report_times("exchange only, same grid (the exchange's floor)", time_ms(
                lambda: fused_lstm.exchange_floor_cuda(T, B, H, device)))
            print(f"  per step: kernel {kernel / T * 1e3:.3f} us, exchange "
                  f"{floor / (T - 1) * 1e3:.3f} us ({T - 1} exchanges a call)")
            timed = {"ms": kernel, "plain_ms": plain, "library_ms": library,
                     "exchange_ms": floor}
            timed.update(time_lstm_backward(gen, args, got[0], cots, lstm, x, hc))
        elif (T, B) == (1, 8):  # the tick's shape
            timed["tick_ms"] = report_times("T=1 B=8 kernel", time_ms(call))
            timed["tick_host_ms"] = report_times(
                "T=1 B=8 kernel, not queued (the host's dispatch rate)",
                time_ms(call, queued=False))
    check_lstm_sequence(gen, device)
    by_bytes, by_ops = lstm_bound_ms(50, 4, 512)
    print(f"  bound at T=50 B=4 H=512: bytes {by_bytes:.4f} ms, operations {by_ops:.4f} ms")
    (b_bytes, b_ops), (k_bytes, k_ops) = lstm_backward_bound_ms(50, 4, 512)
    print(f"  backward bound at T=50 B=4 H=512: bytes {b_bytes:.4f} ms, operations "
          f"{b_ops:.4f} ms; its kernel alone: bytes {k_bytes:.4f} ms, operations {k_ops:.4f} ms")
    # one window forward launches it twice at these shapes (high and low level)
    forward = {
        "name": "lstm_seq", "route": "cuda",
        "source": "robo_vln_tpu_torch/csrc/lstm_seq.cu",
        "replaces": "robo_vln_tpu/ops/pallas_lstm.py:40",
        "max_abs_err": worst,
        "ms": 2 * timed["ms"], "plain_ms": 2 * timed["plain_ms"],
        "bound_ms": 2 * max(by_bytes, by_ops),
        "bound_by": "bytes" if by_bytes > by_ops else "operations",
        "library_ms": 2 * timed["library_ms"],
        "exchange_floor_ms": 2 * timed["exchange_ms"],
        "tick_call_ms": timed["tick_ms"], "tick_call_host_ms": timed["tick_host_ms"],
        "work": "2 calls at T=50, B=4, H=512, float32 (one window forward); "
                "exchange_floor_ms: the same grids running nothing but the h exchange; "
                "tick_call_*: one call at T=1, B=8, queued and at the host's dispatch rate",
        "library": "torch.nn.LSTM (cuDNN) over x (T, B, 896), input projection included",
    }
    # one train step's backward runs it twice (high and low level)
    backward = [{
        "name": "lstm_seq_backward" if kernel == "partials" else f"lstm_seq_backward_{kernel}",
        "route": "cuda", "source": "robo_vln_tpu_torch/csrc/lstm_seq.cu",
        "replaces": "robo_vln_tpu/ops/pallas_lstm.py:164",
        "kernel": ("lstm_seq_backward_partials_kernel" if kernel == "partials"
                   else "lstm_seq_backward_kernel"),
        "max_abs_err": bwd_worst[kernel][0], "max_rel_err": bwd_worst[kernel][1],
        "ms": 2 * timed[f"{kernel}_ms"], "plain_ms": 2 * timed["bwd_plain_ms"],
        "replay_ms": 2 * timed["bwd_replay_ms"],
        "kernel_only_ms": 2 * timed[f"{kernel}_kernel_ms"],
        "exchange_floor_ms": 2 * timed[f"{kernel}_exchange_ms"],
        "step_us": timed[f"{kernel}_kernel_ms"] / 50 * 1e3,
        "exchange_step_us": timed[f"{kernel}_exchange_ms"] / 50 * 1e3,
        "units": timed[f"{kernel}_units"],
        "bound_ms": 2 * max(b_bytes, b_ops),
        "bound_by": "bytes" if b_bytes > b_ops else "operations",
        "kernel_only_bound_ms": 2 * max(k_bytes, k_ops),
        "library_ms": 2 * timed["bwd_library_ms"],
        "work": "2 backward calls at T=50, B=4, H=512, float32, no mask gradient (one train "
                "step's): ms the whole call (the gates recomputed in one product, the "
                "kernel, d_w_hh in one product), kernel_only_ms the launch alone, "
                "exchange_floor_ms the same grids running nothing but their exchange, "
                "step_us and exchange_step_us one call's per reverse step; "
                "replay_ms lstm_recurrence replayed under autograd and differentiated; "
                "max_rel_err each gradient's largest error of its norm (tolerance "
                f"{LSTM_BACKWARD_TOL}); replaces the custom VJP's _bwd around "
                "pallas_lstm.py:40; launches: the train path's (the serving path runs no "
                "backward)" + ("" if kernel == "partials" else
                               "; off the route, launched here forced, 0 on every path"),
        "library": "torch.nn.LSTM (cuDNN) forward and backward less its forward, x (T, B, "
                   "896), input projection included",
    } for kernel in fused_lstm.BACKWARD_KERNELS]
    return forward, *backward


def time_lstm_backward(gen, args, outs, cots, lstm, x, hc):
    """Times of one backward call at the window's shape, by each backward
    kernel: the whole call, its launch alone, and its grid running nothing
    but its exchange (the floor under a reverse step); the plain backward,
    the autograd replay, and cuDNN's backward (its forward and backward less
    its forward)."""
    from robo_vln_tpu_torch.ops import fused_lstm
    from robo_vln_tpu_torch.ops.rnn import lstm_recurrence_backward

    T, B, H = outs.shape
    device = outs.device
    gates_x, masks, h0, c0, w_hh = args
    h_tilde = torch.cat([h0[None], outs[:-1]]) * masks[..., None]
    gates = gates_x + h_tilde @ w_hh
    timed = {}
    for kernel in fused_lstm.BACKWARD_KERNELS:
        with backward_kernel(kernel):
            call = lambda: fused_lstm.lstm_seq_backward_cuda(*args, outs, *cots,
                                                             masks_grad=False)
            launch = lambda: fused_lstm._backward_launch(gates, masks, c0, w_hh, *cots, False)
            floor = lambda: fused_lstm.backward_exchange_floor_cuda(T, B, H, device)
            timed[f"{kernel}_ms"] = report_times(f"backward ({kernel}), whole call",
                                                 time_ms(call))
            timed[f"{kernel}_kernel_ms"] = report_times(
                f"backward ({kernel}), the kernel's launch alone", time_ms(launch))
            timed[f"{kernel}_exchange_ms"] = report_times(
                f"backward ({kernel}), the same grid running nothing but its exchange "
                "(the exchange's floor)", time_ms(floor))
        timed[f"{kernel}_units"] = fused_lstm._backward_units(device.index, H, kernel)[0]
        print(f"  backward ({kernel}, {timed[f'{kernel}_units']} units a block) per reverse "
              f"step: kernel {timed[f'{kernel}_kernel_ms'] / T * 1e3:.3f} us, exchange "
              f"{timed[f'{kernel}_exchange_ms'] / T * 1e3:.3f} us ({T} stages a call)")
    timed["bwd_plain_ms"] = report_times("backward, plain", time_ms(
        lambda: lstm_recurrence_backward(*args, outs, *cots, masks_grad=False), inner=2))
    timed["bwd_replay_ms"] = report_times("backward, autograd replay", time_ms(
        lambda: replay_backward(*args, outs, *cots, masks_grad=False), inner=2))
    xg = x.detach().requires_grad_()
    params = list(lstm.parameters())
    g_out = cots[0]

    def cudnn_forward():
        with torch.enable_grad():
            return lstm(xg, hc)

    def cudnn_both():
        out, (h, c) = cudnn_forward()
        torch.autograd.grad((out, h, c), [xg, *params], (g_out, cots[1][None], cots[2][None]))

    forward = statistics.median(time_ms(cudnn_forward))
    both = report_times("library nn.LSTM forward and backward", time_ms(cudnn_both))
    timed["bwd_library_ms"] = both - forward
    print(f"  library backward (forward and backward less forward {forward:.4f} ms): "
          f"{timed['bwd_library_ms']:.4f} ms")
    return timed


def check_lstm_sequence(gen, device):
    """Forward, backward, forward, backward on one workspace, made anew and
    grown by the first backward: each call held to its plain version, and
    the second of each bitwise equal to the first (no word of one launch
    meets a tag another waits for)."""
    from robo_vln_tpu_torch.ops import fused_lstm
    from robo_vln_tpu_torch.ops.rnn import lstm_recurrence

    T, B, H = 50, 4, 512
    args = lstm_inputs(gen, T, B, H, device)
    cots = lstm_cotangents(gen, T, B, H, device)
    fused_lstm._workspaces.clear()
    ref = lstm_recurrence(*args)
    runs = []
    for rep in range(2):
        outs = fused_lstm.lstm_seq_cuda(*args)
        torch.cuda.synchronize()
        err = max((g - r).abs().max().item() for g, r in zip(outs, ref))
        print(f"  sequence, forward {rep}: max_abs_err {err:.3e} (tolerance {LSTM_TOL})")
        if not err <= LSTM_TOL:
            fail("lstm_seq disagrees with its plain version in the forward/backward sequence")
        grads = check_lstm_backward(f"sequence, backward {rep}, T={T} B={B} H={H}",
                                    args, outs[0], cots, True)[3]
        runs.append((outs, grads))
    (o1, g1), (o2, g2) = runs
    if not all(torch.equal(a, b) for a, b in zip(o1 + g1, o2 + g2)):
        fail("the forward/backward sequence gave other results the second time")
    print(f"  sequence forward, backward, forward, backward: the second of each bitwise "
          f"equal to the first; workspace {fused_lstm._workspaces[device.index][0].numel()} "
          "words")


def check_attention(gen, device):
    from robo_vln_tpu_torch.ops import fused_attention

    print("phase 3b: cross_modal_attn kernel against ops/fused_attention.attention_plain "
          "(bf16 in both modes of p, each against the plain version in that mode)")
    N, Lq, heads, d = 200, 200, 4, 64
    sdpa = torch.nn.functional.scaled_dot_product_attention
    f32, bf16 = torch.float32, torch.bfloat16
    worst = dict.fromkeys(fused_attention.ROUTES, 0.0)
    mode_worst = dict.fromkeys(fused_attention.BF16_P_MODES, 0.0)
    sums = {"ms": 0.0, "f32_key_blocks_ms": 0.0, "f32_cuda_core_ms": 0.0, "plain_ms": 0.0,
            "library_ms": 0.0,
            "bf16_ms": 0.0, "bf16_plain_ms": 0.0, "bf16_library_ms": 0.0,
            "bf16_split_p_ms": 0.0, "bf16_split_p_plain_ms": 0.0}
    bounds = {f32: [0.0, 0.0], bf16: [0.0, 0.0]}

    def inputs(n, lq, S, h, dk, dv, dtype):
        return (torch.randn(n, lq, h * dk, generator=gen).to(device, dtype),
                torch.randn(n, S, h * dk, generator=gen).to(device, dtype),
                torch.randn(n, S, h * dv, generator=gen).to(device, dtype))

    def heads_view(q, k, v):
        return [t.view(t.shape[0], t.shape[1], heads, d).transpose(1, 2) for t in (q, k, v)]

    def check(tag, q, k, v, h, tol, expected):
        """One launch, which must take route ``expected`` (on the tensor
        cores past S = 128, and in float32 past d = 128, that route's key
        blocks; in float32 the copy width the sizes and pointers ask for;
        in bf16 the mode of p set), held to the plain version in that
        mode."""
        before = dict(fused_attention.route_launches)
        blocks_before = key_block_launches()
        copies_before = bf16_copy_launches()
        modes_before = dict(fused_attention.bf16_mode_launches)
        got = fused_attention.cross_modal_attn_cuda(q, k, v, h)
        ref = fused_attention.attention_plain(q, k, v, h)
        torch.cuda.synchronize()
        took = [r for r, count in fused_attention.route_launches.items() if count != before[r]]
        modes = [m for m, count in fused_attention.bf16_mode_launches.items()
                 if count != modes_before[m]]
        err = (got.float() - ref.float()).abs().max().item()
        blocks = [a - b for a, b in zip(key_block_launches(), blocks_before)]
        tol = bf16_tolerance(tol, q, k, v, h) if q.dtype == torch.bfloat16 else tol
        print(f"  {tag} [{','.join(took + modes)}{', key blocks' if any(blocks[:2]) else ''}"
              f"{', narrow copies' if any(blocks[2:]) else ''}]: "
              f"max_abs_err {err:.3e} (tolerance {tol:.3e})")
        if took != [expected]:
            fail(f"cross_modal_attn launched {took} at {tag}, expected {expected}")
        if modes != ([fused_attention.p_mode()] if q.dtype == torch.bfloat16 else []):
            fail(f"cross_modal_attn launched bf16 modes {modes} at {tag}")
        if blocks != expected_key_blocks(expected, q, k, v, h):
            fail(f"cross_modal_attn launched {blocks} ({', '.join(KEY_BLOCK_COUNTS)}) kernels at "
                 f"{tag}")
        copies = [a - b for a, b in zip(bf16_copy_launches(), copies_before)]
        if copies != expected_bf16_copies(expected, q, k, v, h):
            fail(f"cross_modal_attn launched {copies} (bf16 copies "
                 f"{', '.join(fused_attention.BF16_COPIES)}) at {tag}")
        if not err <= tol:
            fail(f"cross_modal_attn ({expected}) disagrees with its plain version at {tag}")
        worst[expected] = max(worst[expected], err)
        for m in modes:
            mode_worst[m] = max(mode_worst[m], err)

    for n in (N, 8, 4, 1):  # the window's, the tick's, the eval ticks' (phase 7)
        for S in (16, 64):
            for dtype, tol in ((f32, ATTN_TOL), (bf16, ATTN_BF16_TOL)):
                q, k, v = inputs(n, Lq, S, heads, d, d, dtype)
                tag = f"N={n} Lq={Lq} S={S} h={heads} d={d} {str(dtype)[6:]}"
                if dtype == f32:
                    check(tag, q, k, v, heads, tol, "f32_tensor_core")
                    with f32_key_blocks_everywhere():
                        check(f"{tag}, key-block kernel", q, k, v, heads, tol, "f32_tensor_core")
                    with cuda_core_f32_attention():
                        check(f"{tag}, CUDA-core kernel", q, k, v, heads, tol, "f32_cuda_core")
                else:
                    for float32_p in (False, True):
                        with p_setting(float32_p):
                            check(f"{tag} {fused_attention.p_mode()}", q, k, v, heads, tol,
                                  "bf16")
                if n != N:
                    if dtype == bf16 and n == 8:  # the tick's shape
                        call = lambda: fused_attention.cross_modal_attn_cuda(q, k, v, heads)
                        report_times(f"{tag} kernel", time_ms(call))
                        report_times(f"{tag} kernel, not queued (the host's dispatch rate)",
                                     time_ms(call, queued=False))
                    continue
                # one call moves 44-108 MB against a 50 MB L2: time it over
                # several input sets in turn, so no call finds its inputs in L2
                sets = [(q, k, v)] + [inputs(n, Lq, S, heads, d, d, dtype)
                                      for _ in range(L2_ROTATION - 1)]
                note = f"inputs rotated over {L2_ROTATION} sets, not in L2"

                def timed(label, fn, arg_sets=sets):
                    return report_times(f"{tag} {label} ({note})",
                                        time_ms(rotated(fn, arg_sets)))

                prefix = "" if dtype == f32 else "bf16_"
                kernel = lambda *t: fused_attention.cross_modal_attn_cuda(*t, heads)
                sums[prefix + "ms"] += timed("kernel", kernel)
                if dtype == f32:
                    with f32_key_blocks_everywhere():
                        sums["f32_key_blocks_ms"] += timed("key-block kernel", kernel)
                    with cuda_core_f32_attention():
                        sums["f32_cuda_core_ms"] += timed("CUDA-core kernel", kernel)
                sums[prefix + "plain_ms"] += timed("plain", lambda *t: (
                    fused_attention.attention_plain(*t, heads)))
                if dtype == bf16:  # the default above is round_p; then split_p
                    with p_setting(True):
                        sums["bf16_split_p_ms"] += timed("kernel, split_p", kernel)
                        sums["bf16_split_p_plain_ms"] += timed("plain, split_p", lambda *t: (
                            fused_attention.attention_plain(*t, heads)))
                sums[prefix + "library_ms"] += timed("library scaled_dot_product_attention",
                                                     sdpa, [heads_view(*t) for t in sets])
                if dtype == f32:
                    by_bytes, by_ops = attn_bound_ms(n, Lq, S, heads, d, 4, F32_FLOP_PER_S)
                    tc_ops = 3 * attn_bound_ms(n, Lq, S, heads, d, 4, TF32_TC_FLOP_PER_S)[1]
                    print(f"  {tag} three tf32 products on the tensor cores: {tc_ops:.4f} ms")
                else:
                    by_bytes, by_ops = attn_bound_ms(n, Lq, S, heads, d, 2, BF16_TC_FLOP_PER_S)
                print(f"  {tag} bound: bytes {by_bytes:.4f} ms, operations {by_ops:.4f} ms")
                bounds[dtype][0] += by_bytes
                bounds[dtype][1] += by_ops
    # ragged shapes, each with the route it must take: a partial query tile,
    # S below a warp, off a multiple of 8 or 16, and at the largest instance
    # (whose tiles need more than 48 KB of shared memory), other head sizes
    # (d_v != d_k in float32 only), both dtypes past S = 128 in key blocks
    # (one key past the whole instances, a partial last key block, a
    # partial last query tile; in float32 d_v != d_k), float32 head sizes
    # zero-filled to the instance's D (12, 20 and 60 by 16-byte copies; 1,
    # 61, (61, 33) and (125, 127), K and V unsplit at D = 128, one float a
    # copy; 200, (60, 136) and (256, 1) at D = 256, in key blocks at every
    # S), and d = 260 on the wide kernel
    ragged = [((3, 13, 5, 2, 8, 16), f32, "f32_tensor_core"),
              ((2, 40, 33, 3, 32, 32), f32, "f32_tensor_core"),
              ((4, 65, 1, 4, 64, 64), f32, "f32_tensor_core"),
              ((2, 130, 128, 1, 128, 128), f32, "f32_tensor_core"),
              ((2, 70, 17, 2, 64, 32), f32, "f32_tensor_core"),
              ((3, 100, 100, 2, 96, 40), f32, "f32_tensor_core"),
              ((2, 20, 200, 2, 16, 16), f32, "f32_tensor_core"),
              ((2, 50, 129, 2, 64, 64), f32, "f32_tensor_core"),
              ((3, 140, 300, 2, 96, 40), f32, "f32_tensor_core"),
              ((2, 40, 16, 2, 12, 12), f32, "f32_tensor_core"),
              ((2, 40, 200, 2, 20, 20), f32, "f32_tensor_core"),
              ((3, 70, 64, 2, 60, 60), f32, "f32_tensor_core"),
              ((2, 40, 16, 3, 1, 1), f32, "f32_tensor_core"),
              ((3, 70, 40, 2, 61, 61), f32, "f32_tensor_core"),
              ((2, 130, 129, 2, 61, 33), f32, "f32_tensor_core"),
              ((2, 40, 16, 2, 200, 200), f32, "f32_tensor_core"),
              ((2, 30, 129, 2, 60, 136), f32, "f32_tensor_core"),
              ((2, 130, 100, 2, 125, 127), f32, "f32_tensor_core"),
              ((1, 1, 1, 2, 256, 1), f32, "f32_tensor_core"),
              ((2, 40, 16, 1, 260, 260), f32, "wide_f32"),
              ((3, 13, 5, 2, 16, 16), bf16, "bf16"),
              ((2, 40, 33, 3, 32, 32), bf16, "bf16"),
              ((4, 65, 1, 4, 48, 48), bf16, "bf16"),
              ((2, 130, 128, 1, 128, 128), bf16, "bf16"),
              ((2, 130, 129, 1, 128, 128), bf16, "bf16"),
              ((3, 13, 200, 2, 16, 16), bf16, "bf16"),
              ((2, 70, 161, 3, 48, 48), bf16, "bf16")]
    for (n, lq, S, h, dk, dv), dtype, route in ragged:
        tag = f"N={n} Lq={lq} S={S} h={h} d_k={dk} d_v={dv} {str(dtype)[6:]}"
        qkv = inputs(n, lq, S, h, dk, dv, dtype)
        if dtype == f32:
            check(tag, *qkv, h, ATTN_TOL, route)
            continue
        for float32_p in (False, True):
            with p_setting(float32_p):
                check(f"{tag} {fused_attention.p_mode()}", *qkv, h, ATTN_BF16_TOL, route)
    # one window forward launches it twice: S=16 (rgb) and S=64 (depth)
    (f32_bytes, f32_ops), (bf16_bytes, bf16_ops) = bounds[f32], bounds[bf16]
    modes = [{
        "name": f"cross_modal_attn_bf16_{mode}", "route": "cuda",
        "source": "robo_vln_tpu_torch/csrc/cross_modal_attn.cu",
        "replaces": "robo_vln_tpu/ops/pallas_attention.py:48",
        "max_abs_err": mode_worst[mode],
        "ms": sums["bf16_ms" if mode == "round_p" else "bf16_split_p_ms"],
        "plain_ms": sums["bf16_plain_ms" if mode == "round_p" else "bf16_split_p_plain_ms"],
        "bound_ms": max(bf16_bytes, bf16_ops),
        "bound_by": "bytes" if bf16_bytes > bf16_ops else "operations",
        "library_ms": sums["bf16_library_ms"],
        "work": "2 bf16 calls, N=200 Lq=200 h=4 d=64 at S=16 and S=64 (one window forward), "
                f"inputs rotated over {L2_ROTATION} sets; "
                + ("p rounded to bf16 once before p·v (TPU.PALLAS_ATTENTION off, the "
                   "default: the JAX package's XLA attention), one product a key"
                   if mode == "round_p" else
                   "p split into p_hi + p_lo (TPU.PALLAS_ATTENTION on: the Pallas kernel's "
                   "float32 p), two products a key; launched here with the setting on")
                + "; max_abs_err against the plain version in the same mode",
        "library": "torch.nn.functional.scaled_dot_product_attention on head views",
    } for mode in fused_attention.BF16_P_MODES]
    return modes, {
        "name": "cross_modal_attn", "route": "cuda",
        "source": "robo_vln_tpu_torch/csrc/cross_modal_attn.cu",
        "replaces": "robo_vln_tpu/ops/pallas_attention.py:48",
        "max_abs_err": worst["f32_tensor_core"],
        "f32_cuda_core_max_abs_err": worst["f32_cuda_core"],
        "bf16_max_abs_err": worst["bf16"],
        **sums,
        "bound_ms": max(f32_bytes, f32_ops),
        "bound_by": "bytes" if f32_bytes > f32_ops else "operations",
        "bf16_bound_ms": max(bf16_bytes, bf16_ops),
        "bf16_bound_by": "bytes" if bf16_bytes > bf16_ops else "operations",
        "work": "2 calls, N=200 Lq=200 h=4 d=64 at S=16 and S=64 (one window forward), "
                f"inputs rotated over {L2_ROTATION} sets so that none is in L2; the "
                "unprefixed fields float32 on the tensor cores (3xTF32, the route every "
                "float32 call at these shapes takes, its keys whole), f32_key_blocks_ms "
                "its key-block kernel (the route past S = 128) forced at the same shapes, "
                "f32_cuda_core_* the float32 CUDA-core kernel at the same shapes, bf16_* "
                "bfloat16; bound_ms counts float32 operations at the CUDA cores' peak",
        "library": "torch.nn.functional.scaled_dot_product_attention on head views",
    }


def time_attention(gen, device, prefix, N, Lq, S, heads, d, dtype, what, offset=0,
                   force_wide=False):
    """One attention call at these sizes timed with its inputs rotated out
    of L2: the kernel (by the route the sizes take; on the float32 tensor
    cores and the wide kernel also the CUDA-core kernel forced, and with
    ``force_wide`` the wide kernel forced at a tensor-core shape), the plain
    version and SDPA on head views; and its bound.  ``offset``: q, k and v
    start that many elements into buffers of their own (SDPA gets aligned
    copies).  Returns the JSON fields ``{prefix}_*``."""
    from robo_vln_tpu_torch.ops import fused_attention

    sets = [[torch.randn(offset + N * L * heads * d, generator=gen).to(device, dtype)[offset:]
             .view(N, L, heads * d) for L in (Lq, S, S)] for _ in range(L2_ROTATION)]
    note = f"inputs rotated over {L2_ROTATION} sets, not in L2"
    tag = (f"N={N} Lq={Lq} S={S} h={heads} d={d} {str(dtype)[6:]}"
           f"{', pointers one element off 16 bytes' if offset else ''}")
    route = fused_attention.pick_route(dtype, S, d, d, offset == 0)
    bf16 = dtype == torch.bfloat16

    def timed(label, fn, arg_sets=sets):
        return report_times(f"{tag} {label} ({note})", time_ms(rotated(fn, arg_sets)))

    kernel = lambda *t: fused_attention.cross_modal_attn_cuda(*t, heads)
    plain = lambda *t: fused_attention.attention_plain(*t, heads)
    mode = f", {fused_attention.p_mode()}" if bf16 else ""
    fields = {f"{prefix}_ms": timed(f"kernel ({route}{mode})", kernel)}
    if route in ("f32_tensor_core", "wide_f32"):
        with cuda_core_f32_attention():
            fields[f"{prefix}_cuda_core_ms"] = timed("the CUDA-core kernel, forced", kernel)
    if force_wide:
        with forced_f32_attention("wide_f32"):
            fields[f"{prefix}_wide_ms"] = timed("the wide kernel, forced", kernel)
    fields[f"{prefix}_plain_ms"] = timed(f"plain{mode}", plain)
    if bf16:  # the default above is round_p; then split_p
        with p_setting(True):
            fields[f"{prefix}_split_p_ms"] = timed(f"kernel ({route}, split_p)", kernel)
            fields[f"{prefix}_split_p_plain_ms"] = timed("plain, split_p", plain)
    # SDPA on views one element off 16 bytes fails with a misaligned address
    # on the card, so past an offset it takes aligned copies
    fields[f"{prefix}_library_ms"] = timed(
        "library scaled_dot_product_attention"
        f"{' (on aligned copies)' if offset else ''}",
        torch.nn.functional.scaled_dot_product_attention,
        [[(t.clone() if offset else t).view(N, t.shape[1], heads, d).transpose(1, 2) for t in ts]
         for ts in sets])
    if bf16:
        by_bytes, by_ops = attn_bound_ms(N, Lq, S, heads, d, 2, BF16_TC_FLOP_PER_S)
        print(f"  {tag} bound: bytes {by_bytes:.4f} ms, operations {by_ops:.4f} ms (bf16 "
              "products on the tensor cores)")
    else:
        by_bytes, by_f32 = attn_bound_ms(N, Lq, S, heads, d, 4, F32_FLOP_PER_S)
        # the route's work is three tf32 products on the tensor cores; the
        # same operations on the CUDA cores are printed beside them
        by_ops = 3 * attn_bound_ms(N, Lq, S, heads, d, 4, TF32_TC_FLOP_PER_S)[1]
        fields[f"{prefix}_f32_operations_bound_ms"] = by_f32
        print(f"  {tag} bound: bytes {by_bytes:.4f} ms, operations {by_ops:.4f} ms (three "
              f"tf32 products); float32 operations on the CUDA cores {by_f32:.4f} ms")
    fields[f"{prefix}_bound_ms"] = max(by_bytes, by_ops)
    fields[f"{prefix}_bound_by"] = "bytes" if by_bytes > by_ops else "operations"
    fields[f"{prefix}_work"] = f"one call, {tag} ({what}), route {route}, {note}"
    return fields


def check_wider_shapes(gen, device):
    """Phase 3c: one call of each shape past a kernel's former range, which
    must launch that kernel once (by the route it names; in key blocks, one
    value a copy and in the wide variants where the sizes ask for them) and
    match the plain version; timings of those shapes against the plain
    version and SDPA or cuDNN; and the calls the forced-only dg_exchange
    backward refuses, before any launch.  Returns (the attention timing and
    error fields, the kernels-line entries of the float32 key-block kernel
    and the wide attention kernel, the wide LSTM kernels' entries)."""
    from robo_vln_tpu_torch.ops import fused_attention, fused_lstm
    from robo_vln_tpu_torch.ops.rnn import lstm_recurrence

    print("phase 3c: shapes past the kernels' former ranges, and the refusals left")
    f32, bf16 = torch.float32, torch.bfloat16

    def held(tag, module, call, plain, tol, route=None):
        routes = dict(getattr(module, "route_launches", {}))
        before = module.launches
        got, ref = call(), plain()
        torch.cuda.synchronize()
        took = [r for r, n in getattr(module, "route_launches", {}).items() if n != routes[r]]
        pairs = zip(*(x if isinstance(x, tuple) else (x,) for x in (got, ref)))
        err = max((g.float() - r.float()).abs().max().item() for g, r in pairs)
        print(f"  {tag} [{','.join(took) or 'kernel'}]: max_abs_err {err:.3e} "
              f"(tolerance {tol:.3e})")
        if module.launches - before != 1 or (route is not None and took != [route]):
            fail(f"{tag} launched {module.launches - before} kernels by {took}, "
                 f"expected one by {route or 'the kernel'}")
        if not err <= tol:
            fail(f"{tag} disagrees with the plain version")
        return err

    def refused(tag, module, call, counter="launches"):
        before = getattr(module, counter)
        try:
            call()
        except ValueError as e:
            print(f"  {tag}: refused before any launch ({e})")
        else:
            fail(f"{tag} was not refused")
        if getattr(module, counter) != before:
            fail(f"{tag} launched a kernel")

    def qkv(n, lq, S, h, dk, dv, dtype, offset=0):
        """q, k, v, each ``offset`` elements into a buffer of its own."""
        return [torch.randn(offset + n * L * h * d, generator=gen).to(device, dtype)[offset:]
                .view(n, L, h * d) for L, d in ((lq, dk), (S, dk), (S, dv))]

    # both dtypes past S = 128 in key blocks: bf16 (in both modes of p) at
    # the depth attention of a 384 px frame, at S = 300 and 512 with d = 128
    # (past the shared memory of a kernel that holds a head's keys whole),
    # at S = 1000, and at (a) and (b) below at the window's N;
    # float32 at (a) that depth attention and (b) self-attention over 200
    # tokens at d = 128, both at the window's N (their errors go into the
    # JSON line under ``key``), then a long S.  Float32 shapes that PR 1's
    # CUDA-core kernel took before the tensor-core kernels zero-filled the
    # head dimension and copied one float at a time: d = 60 (16-byte
    # copies, zero-filled to 64), d = 61 (one float a copy) with the keys
    # whole and in key blocks, q, k and v taken from buffers one float off
    # a 16-byte boundary, d = 256 over 2 heads (D = 256, in key blocks at
    # every S).  The wide kernel in float32 at d = 260 and 512, at (d_k, d_v)
    # = (260, 64), at S = 6965, d = 300 (past the CUDA-core kernel's d_k + S = 7264) and from
    # pointers one float off; bf16 zero-filled at d = 72 (keys whole and in
    # key blocks) and at (d_k, d_v) = (128, 64), the fill instance at d = 60,
    # 65, 66 and 68 and from pointers 1, 2 and 4 elements off 16 bytes
    # (shifted, 4- and 8-byte copies), and the wide kernel at d = 256 (one
    # head of d_model 256, as phase 14, S = 16 and 64), 260 (8-byte copies),
    # 300 (d_k in chunks) and one element off, and in float32 three off
    tc, wf, wb = "f32_tensor_core", "wide_f32", "wide_bf16"
    errors, wide_worst, key_block_worst = {}, {wf: 0.0, wb: 0.0}, 0.0
    for n, S, h, dtype, d, offset, tol, route, key in (
            (8, 144, 4, bf16, 64, 0, ATTN_BF16_TOL, "bf16", None),
            (8, 300, 4, bf16, 128, 0, ATTN_BF16_TOL, "bf16", None),
            (8, 512, 4, bf16, 128, 0, ATTN_BF16_TOL, "bf16", "bf16_s512_d128"),
            (8, 1000, 4, bf16, 64, 0, ATTN_BF16_TOL, "bf16", "bf16_s1000"),
            (200, 144, 4, bf16, 64, 0, ATTN_BF16_TOL, "bf16", "bf16_s144"),
            (200, 200, 4, bf16, 128, 0, ATTN_BF16_TOL, "bf16", "bf16_s200_d128"),
            (200, 144, 4, f32, 64, 0, ATTN_TOL, tc, "f32_s144"),
            (200, 200, 4, f32, 128, 0, ATTN_TOL, tc, "f32_s200_d128"),
            (8, 500, 4, f32, 64, 0, ATTN_TOL, tc, None),
            (8, 500, 4, f32, 60, 0, ATTN_TOL, tc, "f32_s500_d60"),
            (8, 64, 4, f32, 61, 0, ATTN_TOL, tc, "f32_s64_d61"),
            (8, 500, 4, f32, 61, 0, ATTN_TOL, tc, "f32_s500_d61"),
            (8, 64, 4, f32, 64, 1, ATTN_TOL, tc, "f32_unaligned_s64"),
            (8, 300, 4, f32, 64, 1, ATTN_TOL, tc, "f32_unaligned_s300"),
            (200, 200, 2, f32, 256, 0, ATTN_TOL, tc, "f32_s200_d256_h2"),
            (8, 16, 2, f32, 256, 1, ATTN_TOL, tc, None),
            (200, 16, 1, f32, 256, 0, ATTN_TOL, tc, "f32_s16_d256_h1"),
            (200, 64, 1, f32, 256, 0, ATTN_TOL, tc, "f32_s64_d256_h1"),
            (8, 70, 2, f32, (200, 100), 0, ATTN_TOL, tc, None),
            (8, 70, 2, f32, (100, 200), 1, ATTN_TOL, tc, None),
            (8, 1000, 1, f32, 32, 0, ATTN_TOL, tc, None),
            (8, 200, 2, f32, 260, 0, ATTN_TOL, wf, "wide_f32_d260"),
            (8, 200, 2, f32, 512, 0, ATTN_TOL, wf, "wide_f32_d512"),
            (8, 200, 2, f32, (260, 64), 0, ATTN_TOL, wf, "wide_f32_dk260_dv64"),
            (8, 6965, 2, f32, 300, 0, ATTN_TOL, wf, "wide_f32_s6965_d300"),
            (8, 100, 2, f32, 260, 1, ATTN_TOL, wf, "wide_f32_unaligned_d260"),
            (8, 64, 4, bf16, 72, 0, ATTN_BF16_TOL, "bf16", "bf16_d72"),
            (8, 200, 4, bf16, 72, 0, ATTN_BF16_TOL, "bf16", "bf16_s200_d72"),
            (8, 64, 4, bf16, (128, 64), 0, ATTN_BF16_TOL, "bf16", "bf16_dk128_dv64"),
            (8, 64, 4, bf16, 60, 0, ATTN_BF16_TOL, "bf16", "bf16_d60"),
            (8, 64, 4, bf16, 64, 1, ATTN_BF16_TOL, "bf16", "bf16_unaligned_d64"),
            (8, 64, 4, bf16, 64, 2, ATTN_BF16_TOL, "bf16", None),
            (8, 64, 4, bf16, 64, 4, ATTN_BF16_TOL, "bf16", None),
            (8, 70, 4, bf16, 68, 0, ATTN_BF16_TOL, "bf16", None),
            (8, 70, 4, bf16, 66, 0, ATTN_BF16_TOL, "bf16", None),
            (8, 70, 4, bf16, 65, 0, ATTN_BF16_TOL, "bf16", "bf16_d65"),
            (8, 64, 1, bf16, 256, 0, ATTN_BF16_TOL, wb, "wide_bf16_d256_h1"),
            (8, 16, 1, bf16, 256, 0, ATTN_BF16_TOL, wb, None),
            (8, 200, 2, bf16, 260, 0, ATTN_BF16_TOL, wb, "wide_bf16_d260"),
            (8, 70, 2, bf16, 256, 1, ATTN_BF16_TOL, wb, "wide_bf16_unaligned_d256"),
            (8, 40, 2, bf16, 300, 0, ATTN_BF16_TOL, wb, "wide_bf16_d300"),
            (8, 40, 2, f32, (100, 300), 3, ATTN_TOL, wf, None)):
        dk, dv = d if isinstance(d, tuple) else (d, d)
        q, k, v = qkv(n, 200, S, h, dk, dv, dtype, offset)
        for float32_p in (False, True) if dtype == bf16 else (None,):
            with p_setting(bool(float32_p)):
                mode = f" {fused_attention.p_mode()}" if dtype == bf16 else ""
                modes = dict(fused_attention.bf16_mode_launches)
                blocks = key_block_launches()
                copies = bf16_copy_launches()
                tag = (f"cross_modal_attn N={n} Lq=200 S={S} h={h} d_k={dk} d_v={dv} "
                       f"{str(dtype)[6:]}{mode}"
                       f"{f', pointers {offset} elements off 16 bytes' if offset else ''}")
                err = held(tag, fused_attention,
                           lambda: fused_attention.cross_modal_attn_cuda(q, k, v, h),
                           lambda: fused_attention.attention_plain(q, k, v, h),
                           bf16_tolerance(tol, q, k, v, h) if dtype == bf16 else tol, route)
                if key:
                    errors[f"{key}{'_split_p' if float32_p else ''}_max_abs_err"] = err
                if route in wide_worst:
                    wide_worst[route] = max(wide_worst[route], err)
                blocks = [a - b for a, b in zip(key_block_launches(), blocks)]
                if blocks != expected_key_blocks(route, q, k, v, h):
                    fail(f"{tag}: {blocks} ({', '.join(KEY_BLOCK_COUNTS)}) launches")
                if route == tc and blocks[0]:
                    key_block_worst = max(key_block_worst, err)
                copies = [a - b for a, b in zip(bf16_copy_launches(), copies)]
                if copies != expected_bf16_copies(route, q, k, v, h):
                    fail(f"{tag}: {copies} (bf16 copies {', '.join(fused_attention.BF16_COPIES)}) "
                         "launches")
                took = {m: c - modes[m] for m, c in fused_attention.bf16_mode_launches.items()}
                want = {m: int(dtype == bf16 and m == fused_attention.p_mode()) for m in took}
                if took != want:
                    fail(f"{tag}: bf16 modes {took}, expected {want}")
    # the LSTM at H = 556 (a ragged grid), 30 (padded to 32), 1030 and 2048
    # (the wide kernels) at T = 5 and 50, B = 4, at H = 4096, B = 8 (the
    # accumulators' 8 rows), and at H = 6400, B = 8, whose buffer of h does
    # not fit in shared memory beside the rings (the direct wide forward, which
    # reads h from the exchange's words)
    lstm_worst = {"fwd": 0.0, "direct": 0.0, "bwd": [0.0, 0.0]}
    for H, shapes in ((556, ((5, 4), (50, 4))), (30, ((5, 4), (50, 4))),
                      (1030, ((5, 4), (50, 4))), (2048, ((5, 4), (50, 4))), (4096, ((3, 8),)),
                      (6400, ((2, 8),))):
        for T, B in shapes:
            args = lstm_inputs(gen, T, B, H, device)
            Hp = fused_lstm.padded_hidden(H)
            units = fused_lstm._units(device.index, Hp)[0]
            wide = fused_lstm.wide_kernel(Hp, units)
            direct = wide and fused_lstm.wide_forward_direct(B, Hp)
            before = fused_lstm.wide_launches, fused_lstm.wide_direct_launches
            kind = " (the direct wide kernel)" if direct else " (wide)" if wide else ""
            err = held(f"lstm_seq T={T} B={B} H={H}{kind}", fused_lstm,
                       lambda: fused_lstm.lstm_seq_cuda(*args), lambda: lstm_recurrence(*args),
                       LSTM_TOL)
            took = (fused_lstm.wide_launches - before[0],
                    fused_lstm.wide_direct_launches - before[1])
            if took != (int(wide and not direct), int(direct)):
                fail(f"lstm_seq T={T} B={B} H={H}: (wide, direct wide) launches {took}, "
                     f"expected {(int(wide and not direct), int(direct))}")
            if direct:
                lstm_worst["direct"] = max(lstm_worst["direct"], err)
            elif H != 556:
                lstm_worst["fwd"] = max(lstm_worst["fwd"], err)
            cots = lstm_cotangents(gen, T, B, H, device)
            for kernel in fused_lstm.BACKWARD_KERNELS if H == 556 else ("partials",):
                before = fused_lstm.backward_wide_launches
                e_abs, e_rel, launched, _ = check_lstm_backward(
                    f"T={T} B={B} H={H}", args, lstm_recurrence(*args)[0], cots, T == 5, kernel)
                if launched != 1:
                    fail(f"lstm_seq backward ({kernel}) took {launched} launches at T={T} B={B} "
                         f"H={H}")
                b_units = fused_lstm._backward_units(device.index,
                                                     fused_lstm.padded_hidden(H), kernel)[0]
                b_wide = kernel == "partials" and fused_lstm.wide_kernel(
                    fused_lstm.padded_hidden(H), b_units)
                if fused_lstm.backward_wide_launches - before != b_wide:
                    fail(f"lstm_seq backward T={T} B={B} H={H}: not {int(b_wide)} wide launch")
                if H != 556:
                    w = lstm_worst["bwd"]
                    lstm_worst["bwd"] = [max(w[0], e_abs), max(w[1], e_rel)]

    # the dg_exchange backward, forced only, keeps its range
    args = lstm_inputs(gen, 2, 2, 1028, device)
    units = fused_lstm._backward_units(device.index, 1028, "dg_exchange")[0]
    refused(f"lstm_seq backward's dg_exchange predicate, H=1028 at {units} units a block",
            fused_lstm, lambda: fused_lstm.check_backward_shape(2, 1028, units, "dg_exchange"),
            "backward_launches")
    outs = torch.zeros(2, 2, 1028, device=device)
    with backward_kernel("dg_exchange"):
        refused("lstm_seq backward H=1028, dg_exchange forced", fused_lstm,
                lambda: fused_lstm.lstm_seq_backward_cuda(
                    *args, outs, *lstm_cotangents(gen, 2, 2, 1028, device)), "backward_launches")

    # at the window's N: the depth attention of a 384 px frame (S=144) and
    # self-attention over 200 tokens at d = 128, both in key blocks in both
    # dtypes; float32 at d = 60 (PR 1's kernel's own shape, S=500, and the
    # window's depth S=64 zero-filled to D = 64, there also from unaligned
    # pointers) and at d = 256 over 2 heads (with the wide kernel forced
    # there too), each against the CUDA-core kernel forced; the wide kernel at d =
    # 260 in both dtypes (against the CUDA-core kernel in float32) and at phase
    # 14's shapes (d = 256, one head, S = 16 and 64), bf16 zero-filled at d
    # = 72 beside the aligned d = 80 and from pointers one element off beside
    # the aligned d = 64
    timings = {**errors,
               **time_attention(gen, device, "f32_s144", 200, 200, 144, 4, 64, f32,
                                "the float32 depth attention of a 384 px frame, key blocks"),
               **time_attention(gen, device, "f32_s200_d128", 200, 200, 200, 4, 128, f32,
                                "float32 self-attention over 200 tokens, d_model 512, key blocks"),
               **time_attention(gen, device, "bf16_s144", 200, 200, 144, 4, 64, bf16,
                                "the depth attention of a 384 px frame, key blocks"),
               **time_attention(gen, device, "bf16_s200_d128", 200, 200, 200, 4, 128, bf16,
                                "self-attention over 200 tokens, d_model 512, key blocks"),
               **time_attention(gen, device, "f32_s500_d60", 200, 200, 500, 4, 60, f32,
                                "d = 60 zero-filled to 64, key blocks; the CUDA-core kernel took it"),
               **time_attention(gen, device, "f32_s64_d60", 200, 200, 64, 4, 60, f32,
                                "the window's depth S at d = 60 zero-filled to 64, keys whole"),
               **time_attention(gen, device, "f32_unaligned_s64_d60", 200, 200, 64, 4, 60, f32,
                                "the same, pointers one float off 16 bytes: one float a copy",
                                offset=1),
               **time_attention(gen, device, "f32_s200_d256_h2", 200, 200, 200, 2, 256, f32,
                                "self-attention over 200 tokens, d_model 512 over 2 heads, "
                                "D = 256", force_wide=True),
               **time_attention(gen, device, "bf16_d72", 200, 200, 64, 4, 72, bf16,
                                "d = 72 zero-filled to 80, the fill instance, 16-byte copies"),
               **time_attention(gen, device, "bf16_d80", 200, 200, 64, 4, 80, bf16,
                                "d = 80, aligned: the instance (f) fills to"),
               **time_attention(gen, device, "bf16_unaligned_d64", 200, 200, 64, 4, 64, bf16,
                                "the window's depth S, pointers one element off 16 bytes: the "
                                "fill instance, shifted loads", offset=1),
               **time_attention(gen, device, "bf16_aligned_d64", 200, 200, 64, 4, 64, bf16,
                                "the window's depth S, aligned, beside (g)"),
               **time_attention(gen, device, "bf16_d256_h2", 200, 200, 200, 2, 256, bf16,
                                "self-attention over 200 tokens, d_model 512 over 2 heads")}
    wide_f32 = time_attention(gen, device, "wide_f32_d260", 200, 200, 200, 2, 260, f32,
                              "d = 260 over 2 heads, the CUDA-core kernel's own shape")
    if not wide_f32["wide_f32_d260_ms"] < wide_f32["wide_f32_d260_cuda_core_ms"]:
        fail("the wide kernel at d = 260 is not faster than the CUDA-core kernel forced")
    # one window of phase 14 launches the bf16 wide kernel twice: rgb (S=16)
    # and depth (S=64) tokens, one head of d_model 256
    wide_bf16 = {}
    for S in (16, 64):
        wide_bf16.update(time_attention(gen, device, f"s{S}", 200, 200, S, 1, 256, bf16,
                                        "phase 14's window: VisualLingAttn h = 1"))
    wide_bf16_d260 = time_attention(gen, device, "d260", 200, 200, 200, 2, 260, bf16,
                                    "d = 260 over 2 heads: 8-byte copies")
    # one float32 window of phase 14 launches the key-block kernel's D = 256
    # instance twice, as the bf16 window the wide kernel
    pair = {}
    for S in (16, 64):
        pair.update(time_attention(gen, device, f"s{S}", 200, 200, S, 1, 256, f32,
                                   "phase 14's float32 window: VisualLingAttn h = 1, D = 256"))
    rows = (("a", "f32_s144"), ("b", "f32_s200_d128"), ("c", "f32_s500_d60"),
            ("e", "f32_s200_d256_h2"))
    entries = [{
        "name": "cross_modal_attn_f32_key_blocks", "route": "cuda",
        "source": "robo_vln_tpu_torch/csrc/cross_modal_attn.cu",
        "replaces": "robo_vln_tpu/ops/pallas_attention.py:48",
        "max_abs_err": key_block_worst,
        **{key: pair[f"s16_{key}"] + pair[f"s64_{key}"]
           for key in ("ms", "plain_ms", "bound_ms", "library_ms")},
        "bound_by": pair["s64_bound_by"],
        **{f"{row}_{key}": timings[f"{prefix}_{key}"] for row, prefix in rows
           for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
        "work": "2 calls, N=200 Lq=200 h=1 d=256 at S=16 and S=64 (one float32 window "
                "forward of phase 14: the D = 256 instance, a cluster of two blocks a query "
                "tile), 3xTF32 on warpgroup MMA; a_*, b_*, c_*, e_*: one call each at N=200 "
                "Lq=200, (a) S=144 h=4 d=64, (b) S=200 h=4 d=128, (c) S=500 h=4 d=60, (e) "
                "S=200 h=2 d=256; max_abs_err over phase 3c's float32 key-block calls; "
                "launches: phase 14 (2 a float32 window, 2 a float32 train step)",
        "library": "torch.nn.functional.scaled_dot_product_attention on head views",
    }, {
        "name": "cross_modal_attn_wide_f32", "route": "cuda",
        "source": "robo_vln_tpu_torch/csrc/cross_modal_attn.cu",
        "replaces": "robo_vln_tpu/ops/pallas_attention.py:48",
        "max_abs_err": wide_worst[wf],
        "ms": wide_f32["wide_f32_d260_ms"], "plain_ms": wide_f32["wide_f32_d260_plain_ms"],
        "bound_ms": wide_f32["wide_f32_d260_bound_ms"],
        "bound_by": wide_f32["wide_f32_d260_bound_by"],
        "library_ms": wide_f32["wide_f32_d260_library_ms"],
        "cuda_core_ms": wide_f32["wide_f32_d260_cuda_core_ms"],
        "forced_at_d256_h2_ms": timings["f32_s200_d256_h2_wide_ms"],
        "work": "one call, N=200 Lq=200 S=200 h=2 d=260, float32 (3xTF32); cuda_core_ms "
                "the CUDA-core kernel forced on the same inputs, forced_at_d256_h2_ms the wide kernel "
                "forced at the tensor-core route's D = 256 shape; max_abs_err over phase 3b's "
                "and 3c's wide float32 calls; launches: phase 14 (its float32 head, d = 256, "
                "takes the tensor-core route: 0)",
        "library": "torch.nn.functional.scaled_dot_product_attention on head views",
    }, {
        "name": "cross_modal_attn_wide_bf16", "route": "cuda",
        "source": "robo_vln_tpu_torch/csrc/cross_modal_attn.cu",
        "replaces": "robo_vln_tpu/ops/pallas_attention.py:48",
        "max_abs_err": wide_worst[wb],
        "ms": wide_bf16["s16_ms"] + wide_bf16["s64_ms"],
        "plain_ms": wide_bf16["s16_plain_ms"] + wide_bf16["s64_plain_ms"],
        "split_p_ms": wide_bf16["s16_split_p_ms"] + wide_bf16["s64_split_p_ms"],
        "bound_ms": wide_bf16["s16_bound_ms"] + wide_bf16["s64_bound_ms"],
        "bound_by": wide_bf16["s64_bound_by"],
        "library_ms": wide_bf16["s16_library_ms"] + wide_bf16["s64_library_ms"],
        "d260_ms": wide_bf16_d260["d260_ms"], "d260_plain_ms": wide_bf16_d260["d260_plain_ms"],
        "d260_library_ms": wide_bf16_d260["d260_library_ms"],
        "d260_bound_ms": wide_bf16_d260["d260_bound_ms"],
        "work": "2 calls, N=200 Lq=200 h=1 d=256 at S=16 and S=64 (one window forward of "
                "phase 14), round_p (split_p_ms with TPU.PALLAS_ATTENTION on); d260_*: one "
                "call at N=200 Lq=200 S=200 h=2 d=260 (8-byte copies); launches: phase 14",
        "library": "torch.nn.functional.scaled_dot_product_attention on head views",
    }]
    return timings, entries, time_wide_lstm(gen, device, lstm_worst)


def forward_launch_alone(args):
    """The forward's launch alone: its C entry (the wide kernel's at a wide
    shape) on outputs and a workspace made once, as lstm_seq_cuda calls it."""
    from robo_vln_tpu_torch.ops import fused_lstm

    gates_x, masks, h0, c0, w_hh = args
    T, B, H = gates_x.shape[0], gates_x.shape[1], gates_x.shape[2] // 4
    device = gates_x.device
    w_hh_t = w_hh.t().contiguous()
    units = fused_lstm._units(device.index, H)[0]
    wide = fused_lstm.wide_kernel(H, units)
    fn = fused_lstm._entry(wide, wide and fused_lstm.wide_forward_direct(B, H))
    outs = torch.empty(T, B, H, device=device)
    hT, cT = torch.empty(B, H, device=device), torch.empty(B, H, device=device)
    stream = torch.cuda.current_stream(device)
    ws = fused_lstm.make_workspace(device, B, H)
    ptrs = [t.data_ptr() for t in (gates_x, masks, h0, c0, w_hh_t, outs, hT, cT, ws)]

    def launch():
        err = fn(*ptrs, T, B, H, units, device.index, stream.cuda_stream)
        if err:
            fail(f"the forward's C entry returned {err}")
    return launch


def time_wide_lstm(gen, device, worst):
    """The LSTM's wide kernels at phase 14's shape, T=50, B=4, H=2048: the
    forward and the partials backward timed against the plain versions and
    cuDNN, with their bounds, each also as its launch alone and as its grid
    running nothing but its exchange; their kernels-line entries
    (``worst``: the largest errors of phase 3c's wide shapes)."""
    from robo_vln_tpu_torch.ops import fused_lstm
    from robo_vln_tpu_torch.ops.rnn import lstm_recurrence, lstm_recurrence_backward

    T, B, H = 50, 4, 2048
    args = lstm_inputs(gen, T, B, H, device)
    cots = lstm_cotangents(gen, T, B, H, device)
    outs = fused_lstm.lstm_seq_cuda(*args)[0]
    tag = f"T={T} B={B} H={H}"
    kernel = report_times(f"lstm_seq {tag} (wide)", time_ms(lambda: fused_lstm.lstm_seq_cuda(*args)))
    plain = report_times(f"lstm_seq {tag} plain", time_ms(lambda: lstm_recurrence(*args), inner=2))
    lstm = torch.nn.LSTM(896, H).to(device)
    x = torch.randn(T, B, 896, generator=gen).to(device)
    hc = (args[2][None], args[3][None])
    library = report_times(f"library nn.LSTM {tag} (cuDNN, input 896, masks all 1)",
                           time_ms(lambda: lstm(x, hc)))
    bwd = report_times(f"lstm_seq backward {tag} (partials, wide), whole call", time_ms(
        lambda: fused_lstm.lstm_seq_backward_cuda(*args, outs, *cots, masks_grad=False)))
    bwd_plain = report_times(f"lstm_seq backward {tag}, plain", time_ms(
        lambda: lstm_recurrence_backward(*args, outs, *cots, masks_grad=False), inner=2))
    xg = x.detach().requires_grad_()
    params = list(lstm.parameters())

    def cudnn_forward():
        with torch.enable_grad():
            return lstm(xg, hc)

    def cudnn_both():
        out, (h, c) = cudnn_forward()
        torch.autograd.grad((out, h, c), [xg, *params], (cots[0], cots[1][None], cots[2][None]))

    both = report_times(f"library nn.LSTM {tag} forward and backward", time_ms(cudnn_both))
    bwd_library = both - statistics.median(time_ms(cudnn_forward))
    fwd_launch = report_times(f"lstm_seq {tag} (wide), its launch alone",
                              time_ms(forward_launch_alone(args)))
    fwd_floor = report_times(f"lstm_seq {tag} (wide), the h exchange alone", time_ms(
        lambda: fused_lstm.exchange_floor_cuda(T, B, H, device)))
    gates_x, masks, h0, c0, w_hh = args
    h_tilde = torch.cat([h0[None], outs[:-1]]) * masks[..., None]
    gates = gates_x + h_tilde @ w_hh
    bwd_launch = report_times(f"lstm_seq backward {tag} (wide), its launch alone", time_ms(
        lambda: fused_lstm._backward_launch(gates, masks, c0, w_hh, *cots, False)))
    bwd_floor = report_times(f"lstm_seq backward {tag} (wide), its exchange alone", time_ms(
        lambda: fused_lstm.backward_exchange_floor_cuda(T, B, H, device)))
    cluster = fused_lstm.backward_cluster(B, H, device)
    by_bytes, by_ops = lstm_bound_ms(T, B, H)
    (b_bytes, b_ops), (k_bytes, k_ops) = lstm_backward_bound_ms(T, B, H)
    units = fused_lstm._units(device.index, H)[0]
    b_units = fused_lstm._backward_units(device.index, H)[0]
    print(f"  {tag}: forward {units} units a block, backward {b_units} in clusters of {cluster}; "
          f"per step: forward {fwd_launch / T * 1e3:.3f} us (exchange "
          f"{fwd_floor / (T - 1) * 1e3:.3f}), backward {bwd_launch / T * 1e3:.3f} us (exchange "
          f"{bwd_floor / T * 1e3:.3f}); bound: forward bytes {by_bytes:.4f} ms, operations "
          f"{by_ops:.4f} ms; backward bytes {b_bytes:.4f} ms, operations {b_ops:.4f} ms; "
          f"W_hh {4 * 4 * H * H / 2**20:.1f} MiB")
    common = {"route": "cuda", "source": "robo_vln_tpu_torch/csrc/lstm_seq.cu"}
    return [{
        "name": "lstm_seq_wide", **common, "replaces": "robo_vln_tpu/ops/pallas_lstm.py:40",
        "kernel": "lstm_seq_wide_kernel", "max_abs_err": worst["fwd"],
        "direct_max_abs_err": worst["direct"],
        "ms": 2 * kernel, "plain_ms": 2 * plain, "library_ms": 2 * library,
        "kernel_only_ms": 2 * fwd_launch, "exchange_floor_ms": 2 * fwd_floor,
        "step_us": fwd_launch / T * 1e3, "exchange_step_us": fwd_floor / (T - 1) * 1e3,
        "bound_ms": 2 * max(by_bytes, by_ops),
        "bound_by": "bytes" if by_bytes > by_ops else "operations", "units": units,
        "work": f"2 calls at {tag}, float32 (one window forward of phase 14): ms the whole "
                "call, kernel_only_ms its launch alone, exchange_floor_ms the same grid "
                "running nothing but the h exchange, step_us and exchange_step_us one call's "
                "per step (T steps, T - 1 exchanges); max_abs_err over phase 3c's H = 30, "
                "1030, 2048 and 4096, direct_max_abs_err the direct wide kernel at H = 6400, "
                "B = 8; launches: phase 14",
        "library": "torch.nn.LSTM (cuDNN) over x (T, B, 896), input projection included",
    }, {
        "name": "lstm_seq_backward_wide", **common,
        "replaces": "robo_vln_tpu/ops/pallas_lstm.py:164",
        "kernel": "lstm_seq_backward_partials_wide_kernel", "max_abs_err": worst["bwd"][0],
        "max_rel_err": worst["bwd"][1],
        "ms": 2 * bwd, "plain_ms": 2 * bwd_plain, "library_ms": 2 * bwd_library,
        "kernel_only_ms": 2 * bwd_launch, "exchange_floor_ms": 2 * bwd_floor,
        "step_us": bwd_launch / T * 1e3, "exchange_step_us": bwd_floor / T * 1e3,
        "bound_ms": 2 * max(b_bytes, b_ops), "kernel_only_bound_ms": 2 * max(k_bytes, k_ops),
        "bound_by": "bytes" if b_bytes > b_ops else "operations", "units": b_units,
        "cluster": cluster,
        "work": f"2 backward calls at {tag}, float32, no mask gradient (one train step of "
                "phase 14): ms the whole call (the gates recomputed in one product, the "
                "kernel, d_w_hh in one product), kernel_only_ms the launch alone, "
                "exchange_floor_ms the same grid running nothing but its exchange, step_us "
                "and exchange_step_us one call's per reverse step; cluster: blocks a cluster "
                "(their partials summed through distributed shared memory); launches: phase "
                "14's train steps",
        "library": "torch.nn.LSTM (cuDNN) forward and backward less its forward",
    }]


def path_launches():
    """Launches since the last reset, by the kernels line's names: the
    LSTM's forward; its backward by kernel (the route's, partials, and
    dg_exchange, which a path never launches); attention, and its bf16
    launches by mode of p (round_p the default; split_p only where
    TPU.PALLAS_ATTENTION is on, which no path sets)."""
    from robo_vln_tpu_torch.ops import fused_attention, fused_lstm

    return {"lstm_seq": fused_lstm.launches,
            "lstm_seq_backward": fused_lstm.backward_kernel_launches["partials"],
            "lstm_seq_backward_dg_exchange": fused_lstm.backward_kernel_launches["dg_exchange"],
            "cross_modal_attn": fused_attention.launches,
            **{f"cross_modal_attn_bf16_{mode}": count
               for mode, count in fused_attention.bf16_mode_launches.items()}}


def wide_launches():
    """Launches since the last reset of the kernels past the former ranges:
    the wide attention kernel by dtype, the LSTM's wide forward (the direct
    wide forward apart, at the shapes whose h does not fit beside the rings)
    and its partials backward's wide kernel (each also counted by
    path_launches' names, which those launches add to)."""
    from robo_vln_tpu_torch.ops import fused_attention, fused_lstm

    return {"cross_modal_attn_wide_f32": fused_attention.route_launches["wide_f32"],
            "cross_modal_attn_wide_bf16": fused_attention.route_launches["wide_bf16"],
            "lstm_seq_wide": fused_lstm.wide_launches,
            "lstm_seq_wide_direct": fused_lstm.wide_direct_launches,
            "lstm_seq_backward_wide": fused_lstm.backward_wide_launches}


def trainer_launches(train_steps, val_windows):
    """A bf16 HCM trainer's path_launches over ``train_steps`` steps and
    ``val_windows`` val windows: 2 + 2 forward (the LSTM, attention rounding
    p once) a step and a window, 2 of the partials backward a step."""
    forward = 2 * (train_steps + val_windows)
    return {"lstm_seq": forward, "lstm_seq_backward": 2 * train_steps,
            "lstm_seq_backward_dg_exchange": 0, "cross_modal_attn": forward,
            "cross_modal_attn_bf16_round_p": forward, "cross_modal_attn_bf16_split_p": 0}


KEY_BLOCK_COUNTS = ("f32_key_block", "bf16_key_block", "f32_narrow", "bf16_fill",
                    "wide_narrow")


def key_block_launches():
    """(float32 key-block, bf16 key-block, float32 narrow-copy, bf16
    one-value-copy, wide one-value-load) launches of the attention kernel
    so far (KEY_BLOCK_COUNTS)."""
    from robo_vln_tpu_torch.ops import fused_attention

    return [fused_attention.f32_key_block_launches, fused_attention.bf16_key_block_launches,
            fused_attention.f32_narrow_launches, fused_attention.bf16_fill_launches,
            fused_attention.wide_narrow_launches]


def expected_key_blocks(route, q, k, v, heads):
    """The key_block_launches one call by ``route`` on q, k, v makes: its
    tensor-core route's key blocks past that route's whole keys (in float32
    also past D = 128, in bf16 also where it copies one value at a time),
    and one-value copies where the pointers or head sizes ask for them."""
    from robo_vln_tpu_torch.ops import fused_attention

    aligned = all(t.data_ptr() % 16 == 0 for t in (q, k, v))
    return expected_key_block_counts(route, q.dtype, k.shape[1], q.shape[-1] // heads,
                                     v.shape[-1] // heads, aligned)


def expected_key_block_counts(route, dtype, S, dk, dv, aligned=True):
    """expected_key_blocks by sizes."""
    from robo_vln_tpu_torch.ops import fused_attention

    tc, bf = route == "f32_tensor_core", route == "bf16"
    wide = route in ("wide_f32", "wide_bf16")
    return [int(tc and fused_attention.f32_key_blocks(S, dk, dv)),
            int(bf and fused_attention.bf16_key_blocks(S, dk, dv, aligned)),
            int(tc and fused_attention.f32_narrow_copies(dk, dv, aligned)),
            int(bf and fused_attention.bf16_fill(dk, dv, aligned)),
            int(wide and fused_attention.wide_narrow_copies(dtype, dk, dv, aligned))]


def bf16_copy_launches():
    """Launches of the bf16 fill instance and the bf16 wide kernel so far,
    by the narrowest copy of q, k and v (fused_attention.BF16_COPIES)."""
    from robo_vln_tpu_torch.ops import fused_attention

    return [fused_attention.bf16_copy_launches[w] for w in fused_attention.BF16_COPIES]


def expected_bf16_copies(route, q, k, v, heads):
    """The bf16_copy_launches one call by ``route`` on q, k, v makes: one,
    by its narrowest copy, for the fill instance and the bf16 wide kernel."""
    from robo_vln_tpu_torch.ops import fused_attention

    dk, dv = q.shape[-1] // heads, v.shape[-1] // heads
    aligned = all(t.data_ptr() % 16 == 0 for t in (q, k, v))
    counts = [0] * len(fused_attention.BF16_COPIES)
    if route == "wide_bf16" or (route == "bf16" and fused_attention.bf16_fill(dk, dv, aligned)):
        counts[fused_attention.BF16_COPIES.index(
            fused_attention.bf16_narrowest_copy(q, k, v, dk, dv))] = 1
    return counts


@contextlib.contextmanager
def f32_key_blocks_everywhere():
    """Send every float32 tensor-core attention call to the key-block kernel,
    whatever S, to check and time it against the whole-key kernel at the
    window's S = 16 and S = 64."""
    from robo_vln_tpu_torch.ops import fused_attention

    saved = fused_attention.F32_WHOLE_S
    fused_attention.F32_WHOLE_S = 0
    try:
        yield
    finally:
        fused_attention.F32_WHOLE_S = saved


@contextlib.contextmanager
def forced_f32_attention(route):
    """Route float32 attention to ``route``: the CUDA-core kernel
    (f32_cuda_core, which no call is routed to since the wide kernel took its
    shapes) or the wide kernel (wide_f32), to check and time it against the
    kernel that takes the shape."""
    from robo_vln_tpu_torch.ops import fused_attention

    saved = fused_attention.pick_route
    fused_attention.pick_route = lambda dtype, *a, **kw: (
        route if dtype == torch.float32 else saved(dtype, *a, **kw))
    try:
        yield
    finally:
        fused_attention.pick_route = saved


def cuda_core_f32_attention():
    """Route float32 attention to the CUDA-core kernel."""
    return forced_f32_attention("f32_cuda_core")


@contextlib.contextmanager
def p_setting(float32_p):
    """The process-wide mode of bf16 attention's p (ops/cm_attention's
    float32_probabilities, TPU.PALLAS_ATTENTION) set for the block."""
    from robo_vln_tpu_torch.ops import cm_attention

    saved = cm_attention.float32_probabilities()
    cm_attention.set_float32_probabilities(float32_p)
    try:
        yield
    finally:
        cm_attention.set_float32_probabilities(saved)


def bf16_tolerance(tol, q, k, v, heads):
    """A bf16 call's tolerance against the plain version in the mode set:
    ``tol``, and with p rounded once where a key-block kernel takes the
    call (the bf16 key blocks, past S = 128 or in the fill instance, and the
    wide kernel), which rounds p before it is normalised (the plain version
    after), 2^-8 max|v| more."""
    from robo_vln_tpu_torch.ops import fused_attention

    S, dk, dv = k.shape[1], q.shape[-1] // heads, v.shape[-1] // heads
    aligned = all(t.data_ptr() % 16 == 0 for t in (q, k, v))
    blocks = (fused_attention.pick_route(torch.bfloat16, S, dk, dv, aligned) == "wide_bf16"
              or fused_attention.bf16_key_blocks(S, dk, dv, aligned))
    if fused_attention.p_mode() == "round_p" and blocks:
        return tol + 2.0 ** -8 * v.float().abs().max().item()
    return tol


@contextlib.contextmanager
def backward_kernel(kernel, units=None):
    """Send the LSTM's backward to one of its kernels (fused_lstm.BACKWARD_KERNELS)
    and, where ``units`` is given, that many hidden units a block, to check
    and time a kernel off the route against the route's."""
    from robo_vln_tpu_torch.ops import fused_lstm

    saved = fused_lstm.BACKWARD_KERNEL, fused_lstm._backward_units
    fused_lstm.BACKWARD_KERNEL = kernel
    if units is not None:
        fused_lstm._backward_units = lambda index, H, k=None: (units, saved[1](index, H)[1])
    try:
        yield
    finally:
        fused_lstm.BACKWARD_KERNEL, fused_lstm._backward_units = saved


@contextlib.contextmanager
def plain_kernels():
    """Swap every kernel for its plain version, for the comparison only: the
    LSTM's forward for lstm_recurrence and its backward for the autograd
    replay of it, attention for attention_plain (whose backward replays it)."""
    from robo_vln_tpu_torch.ops import fused_attention, fused_lstm
    from robo_vln_tpu_torch.ops.rnn import lstm_recurrence

    saved = (fused_lstm.lstm_seq_cuda, fused_lstm.lstm_seq_backward_cuda,
             fused_attention.cross_modal_attn_cuda)
    fused_lstm.lstm_seq_cuda = lstm_recurrence
    fused_lstm.lstm_seq_backward_cuda = replay_backward
    fused_attention.cross_modal_attn_cuda = fused_attention.attention_plain
    try:
        yield
    finally:
        (fused_lstm.lstm_seq_cuda, fused_lstm.lstm_seq_backward_cuda,
         fused_attention.cross_modal_attn_cuda) = saved


def window_inputs(gen, B, T, L, device):
    obs = {
        "rgb": torch.randint(0, 256, (B, T, 224, 224, 3), generator=gen, dtype=torch.uint8),
        "depth": torch.rand(B, T, 256, 256, 1, generator=gen).half(),
        "instruction": torch.randint(1, 30522, (B, L), generator=gen),
    }
    masks = torch.ones(B, T)
    masks[:, 0] = 0.0
    return {k: v.to(device) for k, v in obs.items()}, masks.to(device)


def check_finite(name, *tensors):
    for t in tensors:
        if not torch.isfinite(t.float()).all():
            fail(f"{name}: non-finite output")


def _device_us(event):
    return getattr(event, "self_device_time_total", None) or event.self_cuda_time_total


def profile_section(label, fn, top=12, ranges=()):
    """torch.profiler over fn: wall ms, summed kernel time, busy share and
    the kernels taking the most device time; then, for each named profiler
    range, its host time and the device time of the kernels launched in it.
    Returns the wall ms."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    averages = prof.key_averages()
    # profiler ranges are mirrored on the device's timeline as spans: not kernels
    kernels = [e for e in averages if e.device_type.name == "CUDA"
               and not getattr(e, "is_user_annotation", False)]
    device_ms = sum(_device_us(e) for e in kernels) / 1e3
    print(f"  profile {label}: wall {wall_ms:.3f} ms, kernel time {device_ms:.3f} ms, "
          f"device busy {device_ms / wall_ms:.3f}, {sum(e.count for e in kernels)} kernels")
    for e in sorted(kernels, key=_device_us, reverse=True)[:top]:
        print(f"    {_device_us(e) / 1e3:9.3f} ms {e.count:5d}x  {e.key[:100]}")
    for name in ranges:
        host = [e.cpu_time_total for e in averages
                if e.key == name and e.device_type.name == "CPU"]
        span = [_device_us(e) for e in averages
                if e.key == name and e.device_type.name == "CUDA"]
        count = sum(e.count for e in averages if e.key == name and e.device_type.name == "CPU")
        print(f"    range {name}: {count}x, host {sum(host) / 1e3:.3f} ms, device span "
              + (f"{sum(span) / 1e3:.3f} ms" if span else "none recorded"))
    return wall_ms


def profile_main_path(agent, obs, masks, tick_obs, tick_masks):
    print("phase 4c: torch.profiler over one window and five ticks")
    B = masks.shape[0]
    profile_section("window B=4 T=50", lambda: agent.forward_window(
        obs, masks, None, *agent.initial_state(B)))

    def ticks():
        state = agent.initial_state(8)
        for t in range(5):
            tick = {"rgb": tick_obs["rgb"][:, t], "depth": tick_obs["depth"][:, t],
                    "instruction": tick_obs["instruction"]}
            state = agent.act(tick, state, None, tick_masks[:, t])[2]

    profile_section("5 ticks B=8", ticks)


def main_path(device, profile=False):
    from robo_vln_tpu_torch import build_hcm_agent
    from robo_vln_tpu_torch.config import get_config
    from robo_vln_tpu_torch.ops import fused_attention, fused_lstm

    cfg = get_config()
    mc = cfg.MODEL
    print("phase 4: HCM agent at full width: BERT-base 12x768, TV-ResNet50 224 px, "
          "GN-ResNet50 256 px, VisualLingAttn 256/4h, LSTM(512); bfloat16")
    t0 = time.perf_counter()
    agent = build_hcm_agent(mc, device=device, compute_dtype=cfg.TPU.PRECISION, seed=0,
                            share_frozen_trunks=cfg.TPU.SHARE_FROZEN_TRUNKS,
                            pallas_attention=cfg.TPU.PALLAS_ATTENTION)
    torch.cuda.synchronize()
    print(f"  build: {time.perf_counter() - t0:.2f} s, shared trunks: {agent.trunk_fn is not None}")
    if agent.trunk_fn is None:
        fail("the synced trunks did not take the shared-trunk path")

    gen = torch.Generator().manual_seed(1)
    B, T, L = 4, 50, 200
    obs, masks = window_inputs(gen, B, T, L, device)
    tick_obs, tick_masks = window_inputs(gen, 8, 10, L, device)
    # the peak below counts what is held already: the agent, and what the
    # phases before left allocated (such as each thread's cuBLAS workspace)
    print(f"  device memory allocated before the windows: "
          f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB")
    torch.cuda.reset_peak_memory_stats()

    fused_lstm.reset_launches()
    fused_attention.reset_launches()
    for rep in range(3):
        t0 = time.perf_counter()
        hh, lh = agent.initial_state(B)
        actions, stop, logits, hh, lh = agent.forward_window(obs, masks, None, hh, lh)
        torch.cuda.synchronize()
        print(f"  window B={B} T={T} rep {rep}: {(time.perf_counter() - t0) * 1e3:.3f} ms")
    check_finite("forward_window", actions, stop, logits, hh, lh)
    if (actions.shape, stop.shape, logits.shape, hh.shape) != (
            (B, T, 2), (B, T, 1), (B, T, 4), (2, B, 512)):
        fail("forward_window output shapes")
    state = agent.initial_state(8)
    for t in range(10):
        tick = {"rgb": tick_obs["rgb"][:, t], "depth": tick_obs["depth"][:, t],
                "instruction": tick_obs["instruction"]}
        t0 = time.perf_counter()
        a, s, state = agent.act(tick, state, None, tick_masks[:, t])
        torch.cuda.synchronize()
        print(f"  act tick {t} B=8: {(time.perf_counter() - t0) * 1e3:.3f} ms")
        check_finite("act", a, s, *state)
    launches = path_launches()
    print(f"  peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    print(f"  launches on the main path: {launches}")
    expected = 2 * (3 + 10)  # high + low LSTM, rgb + depth attention, per forward
    # serving runs no backward, and its bf16 attention rounds p once (the default)
    forward = ("lstm_seq", "cross_modal_attn", "cross_modal_attn_bf16_round_p")
    for name, count in launches.items():
        want = expected if name in forward else 0
        if count != want:
            fail(f"{name} launched {count} times on the main path, expected {want}")

    if profile:
        profile_main_path(agent, obs, masks, tick_obs, tick_masks)

    print("phase 4b: float32 window, timed against the same window with the float32 "
          "CUDA-core attention kernel, then kernels against plain versions; global TF32 "
          f"flags: cudnn {torch.backends.cudnn.allow_tf32}, matmul "
          f"{torch.backends.cuda.matmul.allow_tf32} (the agent turns both off for its calls)")
    agent32 = build_hcm_agent(mc, device=device, compute_dtype="float32", seed=0)
    times = {"f32_tensor_core": [], "f32_cuda_core": []}
    for rep in range(3):
        for route, ms in times.items():
            before = dict(fused_attention.route_launches)
            forced = route == "f32_cuda_core"
            with cuda_core_f32_attention() if forced else contextlib.nullcontext():
                t0 = time.perf_counter()
                out = agent32.forward_window(obs, masks, None, *agent32.initial_state(B))
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            took = {r: c - before[r] for r, c in fused_attention.route_launches.items()}
            print(f"  float32 window B={B} T={T} rep {rep}, attention {route}: {ms[-1]:.3f} ms")
            if took != {r: 2 if r == route else 0 for r in took}:
                fail(f"the float32 window launched {took}, expected 2 of {route}")
            if route == "f32_tensor_core":
                got = out
    print("  float32 window medians: " + ", ".join(
        f"attention {route} {statistics.median(ms):.3f} ms" for route, ms in times.items()))
    with plain_kernels():
        ref = agent32.forward_window(obs, masks, None, *agent32.initial_state(B))
    top2 = ref[2].topk(2, dim=-1).values
    print(f"  smallest top-2 logit gap: {(top2[..., 0] - top2[..., 1]).min().item():.3e}")
    names = ("actions", "stop", "logits", "high hidden", "low hidden")
    for name, g, r in zip(names, got, ref):
        check_finite(f"float32 {name}", g)
        err = (g - r).abs().max().item()
        print(f"  {name}: max_abs_err {err:.3e} (tolerance {WINDOW_TOL})")
        if not err <= WINDOW_TOL:
            fail(f"float32 window {name} disagrees with the plain-kernel agent")
    return launches


def train_batch(gen, B, T, L, device):
    """The bench's batch (bench.py:226-240): oracle sub-goals in 1-4,
    corrected actions uniform in [0, 1), stop targets (u > 0.7), masks with
    column 0 at 0, every step valid."""
    obs, masks = window_inputs(gen, B, T, L, device)
    labels = {
        "vln_oracle_action_sensor": torch.randint(1, 5, (B, T), generator=gen).float(),
        "prev_actions": torch.zeros(B, T, 2),
        "corrected_actions": torch.rand(B, T, 2, generator=gen),
        "oracle_stop": (torch.rand(B, T, 1, generator=gen) > 0.7).float(),
        "valid_mask": torch.ones(B, T),
    }
    return {**obs, **{k: v.to(device) for k, v in labels.items()}, "not_done_masks": masks}


def make_step(cfg, high, low, remat):
    from robo_vln_tpu_torch.models import make_shared_trunk_fn
    from robo_vln_tpu_torch.training import inflection_coef_from, make_hier_train_step

    return make_hier_train_step(
        high, low, trunk_fn=make_shared_trunk_fn(high), remat=remat,
        inflection_coef=inflection_coef_from(cfg),
        valid_velocity_mse=cfg.TPU.VALID_MASK_VELOCITY_MSE)


def make_train(cfg, dtype, device):
    """(high, low, step, state): both policies at full width with random
    weights from seed 0 and synced trunks, the step as the config sets it,
    AdamW (weight decay 1e-5) and Adam (none) as bench.py:191-192 sets them."""
    from robo_vln_tpu_torch.models import build_hierarchical_policies, sync_frozen_trunks
    from robo_vln_tpu_torch.training import HierTrainState, TrainState, adam, adamw

    high, low = build_hierarchical_policies(cfg.MODEL, compute_dtype=dtype,
                                            generator=torch.Generator().manual_seed(0))
    sync_frozen_trunks(high, low)
    high, low = high.to(device), low.to(device)
    step = make_step(cfg, high, low, cfg.TPU.REMAT)
    state = HierTrainState(TrainState(adamw(high, 1e-5), 0), TrainState(adam(low, 0.0), 0))
    return high, low, step, state


def train_path(device, profile=False):
    from robo_vln_tpu_torch.config import get_config
    from robo_vln_tpu_torch.ops import fused_attention, fused_lstm
    from robo_vln_tpu_torch.training import trainable_mask

    cfg = get_config()
    B, T, L, lr = 4, 50, 200, 1e-4
    print(f"phase 5: hierarchical train step at full width, bfloat16, B={B} T={T}, "
          f"AdamW (wd 1e-5) high, Adam (wd 0) low, lr {lr}")
    t0 = time.perf_counter()
    high, low, step, state = make_train(cfg, torch.bfloat16, device)
    torch.cuda.synchronize()
    print(f"  build: {time.perf_counter() - t0:.2f} s")
    gen = torch.Generator().manual_seed(2)
    batch = train_batch(gen, B, T, L, device)
    named = [(f"{level}.{n}", p, mask[n]) for level, pol in (("high", high), ("low", low))
             for mask in (trainable_mask(pol),) for n, p in pol.named_parameters()]
    before = {n: p.detach().clone() for n, p, _ in named}
    hh, lh = high.initial_hidden(B, device), low.initial_hidden(B, device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    fused_lstm.reset_launches()
    fused_attention.reset_launches()
    step_ms = []
    def counts():
        return (fused_lstm.launches, fused_lstm.backward_launches, fused_attention.launches,
                fused_attention.route_launches["bf16"])

    for i in range(TRAIN_STEPS):
        counted = counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        state, hh, lh, metrics = step(state, hh, lh, batch, lr, lr)
        end.record()
        end.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
        step_ms.append(host_ms)
        print(f"  train step {i}: {start.elapsed_time(end):.3f} ms (CUDA events), "
              f"{host_ms:.3f} ms (host clock); " + ", ".join(
                  f"{k} {v.item():.4f}" for k, v in metrics.items()))
        check_finite("train step", *metrics.values(), hh, lh)
        launched = tuple(n - c for n, c in zip(counts(), counted))
        if launched != (2, 2, 2, 2):
            fail(f"train step {i} launched (lstm_seq, lstm_seq_backward, cross_modal_attn, "
                 f"of it bf16) {launched}, expected (2, 2, 2, 2)")
    launches = path_launches()
    print(f"  peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    print(f"  launches on the train path: {launches}")
    want = {name: 2 * TRAIN_STEPS if name in ("lstm_seq", "lstm_seq_backward", "cross_modal_attn",
                                              "cross_modal_attn_bf16_round_p") else 0
            for name in launches}
    if launches != want:
        fail(f"the train path launched {launches}, expected {want}")
    unused = []
    for name, p, trainable in named:
        same = torch.equal(p, before[name])
        if not trainable and not same:
            fail(f"frozen parameter {name} changed")
        if not trainable:
            continue
        if p.grad is None:  # only the progress monitors, which nothing calls
            if ".progress_monitor." not in name or not same:
                fail(f"trainable parameter {name} got no gradient")
            unused.append(name)
        elif same:
            fail(f"trainable parameter {name} did not move")
    print(f"  {sum(not t for _, _, t in named)} frozen parameters unchanged, "
          f"{sum(t for _, _, t in named) - len(unused)} trainable ones moved, "
          f"{len(unused)} without a gradient, unchanged (the unused progress monitors)")
    if profile:
        profile_section(f"train step B={B} T={T}",
                        lambda: step(state, hh, lh, batch, lr, lr), top=16,
                        ranges=("hier_train_step.forward", "hier_train_step.backward",
                                "lstm_seq.backward", "cross_modal_attn.backward_replay",
                                "hier_train_step.optimizer"))
    del high, low, step, state, before, named

    print("phase 5b: float32 train step against the same step with every kernel "
          "swapped for its plain version, the LSTM's backward for the autograd replay "
          "(lr 0, global TF32 flags at their defaults); then the kernels' step with "
          "TPU.REMAT on (the forward recomputed in the backward)")
    high, low, step, state = make_train(cfg, torch.float32, device)
    remat_step = make_step(cfg, high, low, True)
    hh, lh = high.initial_hidden(B, device), low.initial_hidden(B, device)
    params = [(f"{level}.{n}", p) for level, pol in (("high", high), ("low", low))
              for n, p in pol.named_parameters()]
    runs = {}
    for label, scope, fn, reps in (("kernels", contextlib.nullcontext, step, 2),
                                   ("plain", plain_kernels, step, 2),
                                   ("kernels, remat on", contextlib.nullcontext, remat_step, 1)):
        for rep in range(reps):
            routes = dict(fused_attention.route_launches)
            lstm_before = fused_lstm.launches, fused_lstm.backward_launches
            with scope():
                t0 = time.perf_counter()
                _, _, _, metrics = fn(state, hh, lh, batch, 0.0, 0.0)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
            grads = {n: p.grad.clone() for n, p in params if p.grad is not None}
            print(f"  float32 train step, {label}, rep {rep}: {ms:.3f} ms (host clock)")
            took = {r: n - routes[r] for r, n in fused_attention.route_launches.items()
                    if n != routes[r]}
            lstm_took = (fused_lstm.launches - lstm_before[0],
                         fused_lstm.backward_launches - lstm_before[1])
            remat = fn is remat_step
            if label != "plain" and took != {"f32_tensor_core": 4 if remat else 2}:
                fail(f"the float32 train step ({label}) took attention routes {took}")
            if lstm_took != ((4 if remat else 2, 2) if label != "plain" else (0, 0)):
                fail(f"the float32 train step ({label}) launched (lstm_seq, "
                     f"lstm_seq_backward) {lstm_took}")
        runs[label] = metrics, grads
    ref, ref_grads = runs["plain"]
    for label in ("kernels", "kernels, remat on"):
        hold_step_to_plain(label, *runs[label], ref, ref_grads)
    return launches, step_ms


HCM_LOSS_KEYS = ("high_level_loss", "low_level_action_loss", "low_level_stop_loss")


def hold_step_to_plain(label, got, got_grads, ref, ref_grads, loss_keys=HCM_LOSS_KEYS,
                       zero_leaf=ZERO_GRAD_LEAF, against="plain"):
    """A float32 train step's losses (TRAIN_LOSS_RTOL, relative) and each
    trainable leaf's gradient (TRAIN_GRAD_TOL of the leaf's norm) against
    the same step with every kernel swapped for its plain version.  The
    leaves named ``...zero_leaf`` have an exact gradient of 0 and are held
    against their projection's weight gradient instead."""
    print(f"  {label} against {against}:")
    for key in loss_keys:
        a, b = got[key].item(), ref[key].item()
        rel = abs(a - b) / abs(b) if b else abs(a)
        print(f"  {key}: {a:.6f} against {b:.6f}, relative {rel:.3e} "
              f"(tolerance {TRAIN_LOSS_RTOL})")
        if not rel <= TRAIN_LOSS_RTOL:
            fail(f"float32 train step ({label}) {key} disagrees with the plain-kernel step")
    if "high_level_accuracy" in got:
        print(f"  high_level_accuracy: {got['high_level_accuracy'].item():.4f} against "
              f"{ref['high_level_accuracy'].item():.4f}")
    if got_grads.keys() != ref_grads.keys():
        fail(f"the runs ({label}, plain) gave gradients to different parameters")
    worst = {"leaf": (0.0, None), "zero": (0.0, None)}
    for name, g in got_grads.items():
        r = ref_grads[name]
        check_finite(f"float32 gradient of {name}", g)
        if name.endswith(zero_leaf):
            # exactly 0: what both runs compute is rounding noise, held far
            # below the gradient of the same projection's weight
            kind = "zero"
            err = max(g.abs().max(), r.abs().max()).item() / ref_grads[
                name[:-len("bias")] + "weight"].norm().item()
        else:
            kind = "leaf"
            err = (g - r).abs().max().item() / max(r.norm().item(), 1e-30)
        if err >= worst[kind][0]:
            worst[kind] = err, name
    print(f"  gradients: largest error {worst['leaf'][0]:.3e} of its leaf's norm, at "
          f"{worst['leaf'][1]} (tolerance {TRAIN_GRAD_TOL}), over {len(got_grads)} leaves")
    if worst["zero"][1] is not None:
        print(f"  the key biases, whose exact gradient is 0: largest value "
              f"{worst['zero'][0]:.3e} of the key weight's gradient norm, at "
              f"{worst['zero'][1]} (tolerance {TRAIN_GRAD_TOL})")
    for err, name in worst.values():
        if not err <= TRAIN_GRAD_TOL:
            fail(f"float32 train step ({label}) gradient of {name} disagrees with the "
                 "plain-kernel step")


def write_trainer_buffers(root, episodes=None, vocab=30522, rgb_px=224, depth_px=256):
    """The synthetic expert buffers of phase 6, written with the port's own
    writer: 8 train episodes of 60-100 steps in the msgpack format and 4
    eval episodes in the flat format; rgb 224 px uint8, depth 256 px
    float16, 200 token ids below ``vocab`` (BERT's by default), float64
    actions.  ``episodes``: (train, eval) counts in place of (8, 4).
    Returns their bytes on disk."""
    import numpy as np

    from robo_vln_tpu_torch.data.loader import write_episode
    from robo_vln_tpu_torch.data.trajectory_store import TrajectoryStore

    rng = np.random.default_rng(3)
    n_train, n_eval = episodes or (TRAINER_EPISODES, TRAINER_EVAL_EPISODES)
    for name, count, flat in (("train", n_train, False), ("eval", n_eval, True)):
        with TrajectoryStore(os.path.join(root, name), writable=True) as store:
            for key in range(count):
                t = int(rng.integers(60, 101))
                obs = {
                    "rgb": rng.integers(0, 256, (t, rgb_px, rgb_px, 3), dtype=np.uint8),
                    "depth": rng.random((t, depth_px, depth_px, 1),
                                        dtype=np.float32).astype(np.float16),
                    "vln_oracle_action_sensor": rng.integers(1, 5, (t, 1)).astype(np.float64),
                    "instruction": np.tile(rng.integers(1, vocab, (1, 200)), (t, 1)).astype(
                        np.int32),
                }
                stop = t - int(rng.integers(1, 10))
                write_episode(store, key, obs, rng.standard_normal((t, 2)),
                              rng.random((t, 2)), [stop] * t, flat=flat)
    return dir_bytes(root)


def dir_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, files in os.walk(path)
               for f in files)


@contextlib.contextmanager
def instrumented_trainer(record):
    """Time and count what the hierarchical trainer does, from outside it:
    after ``_setup_policy`` each new trainer's ``train_step`` and ``val_step``
    are wrapped (host time to the end of the device's work, the gap since
    the last step, the launches of each kernel), and ``train_epoch``,
    ``val_epoch`` and ``save_checkpoint`` are timed."""
    from robo_vln_tpu_torch.ops import fused_attention, fused_lstm
    from robo_vln_tpu_torch.training import trainable_mask
    from robo_vln_tpu_torch.training.hierarchical_trainer import HierarchicalTrainer as HT

    def counts():
        return fused_lstm.launches, fused_lstm.backward_launches, fused_attention.launches

    def timed_call(kind, fn):
        def call(*args):
            before, t0 = counts(), time.perf_counter()
            if kind == "train" and record["last_end"] is not None:
                record["gaps_ms"].append((t0 - record["last_end"]) * 1e3)
            elif kind == "train" and record["epoch_start"] is not None:  # the loader's first batch
                record["first_wait_ms"].append((t0 - record["epoch_start"]) * 1e3)
                record["epoch_start"] = None
            if kind == "train":
                record["first_steps"].append(args[0].high.step)
            events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            events[0].record()
            out = fn(*args)
            events[1].record()
            torch.cuda.synchronize()
            end = time.perf_counter()
            record[f"{kind}_ms"].append((end - t0) * 1e3)
            record[f"{kind}_event_ms"].append(events[0].elapsed_time(events[1]))
            launched = tuple(n - c for n, c in zip(counts(), before))
            expected = (2, 2, 2) if kind == "train" else (2, 0, 2)
            if launched != expected:
                fail(f"a {kind} call of the trainer launched (lstm_seq, lstm_seq_backward, "
                     f"cross_modal_attn) {launched}, expected {expected}")
            if kind == "train":
                record["last_end"] = end
            return out
        return call

    def timed_method(name, key):
        original = getattr(HT, name)

        def method(self, *args, **kwargs):
            t0 = time.perf_counter()
            if name == "train_epoch":
                record["epoch_start"] = t0
            out = original(self, *args, **kwargs)
            torch.cuda.synchronize()
            record[key].append((time.perf_counter() - t0) * 1e3)
            if name == "train_epoch":
                record["last_end"] = None
            return out
        return original, method

    setup = HT._setup_policy

    def setup_and_wrap(self, *args, **kwargs):
        setup(self, *args, **kwargs)
        if not record["wrap"]:
            return
        record["trainers"].append(self)
        record["shared_trunks"].append(self.trunk_fn is not None)
        mesh = self.mesh
        record["meshes"].append((mesh.size, mesh.distributed,
                                 torch.distributed.get_backend() if mesh.distributed else None))
        if len(record["trainers"]) == 1:  # the first run's frozen weights, to hold
            record["frozen"] = {
                (level, n): p.detach().clone() for level, pol in (("high", self.high),
                                                                  ("low", self.low))
                for mask in (trainable_mask(pol),) for n, p in pol.named_parameters()
                if not mask[n]}
        self.train_step = timed_call("train", self.train_step)
        self.val_step = timed_call("val", self.val_step)

    saved = {name: timed_method(name, key) for name, key in (
        ("train_epoch", "epoch_ms"), ("val_epoch", "val_epoch_ms"),
        ("save_checkpoint", "save_ms"))}
    try:
        HT._setup_policy = setup_and_wrap
        for name, (_, method) in saved.items():
            setattr(HT, name, method)
        yield
    finally:
        HT._setup_policy = setup
        for name, (original, _) in saved.items():
            setattr(HT, name, original)


def new_trainer_record():
    record = {k: [] for k in ("trainers", "shared_trunks", "train_ms", "val_ms", "gaps_ms",
                              "first_steps", "epoch_ms", "val_epoch_ms", "save_ms",
                              "train_event_ms", "val_event_ms", "meshes", "first_wait_ms")}
    record["last_end"], record["epoch_start"], record["wrap"] = None, None, True
    return record


def check_round_trip(trainer, path, cfg):
    """Load ``path`` into a fresh trainer of ``cfg`` and hold it bitwise to
    ``trainer``'s state in memory: parameters and buffers, both optimizers'
    state, both step counters.  Returns the load's ms."""
    from robo_vln_tpu_torch.training import checkpoint as ckpt_lib
    from robo_vln_tpu_torch.training.hierarchical_trainer import HierarchicalTrainer

    fresh = HierarchicalTrainer(cfg)
    fresh._setup_policy()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fresh.state = ckpt_lib.load_checkpoint(path, fresh.high, fresh.low, fresh.state)
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3
    tensors = 0
    for level in ("high", "low"):
        got, want = getattr(fresh, level).state_dict(), getattr(trainer, level).state_dict()
        if got.keys() != want.keys():
            fail(f"the {level} level's reloaded state_dict has other keys")
        for k, v in want.items():
            if not torch.equal(got[k], v):
                fail(f"{path}: {level} {k} differs from the saving trainer's")
        got_opt = getattr(fresh.state, level).optimizer
        want_opt = getattr(trainer.state, level).optimizer
        for p_got, p_want in zip(
                (p for g in got_opt.param_groups for p in g["params"]),
                (p for g in want_opt.param_groups for p in g["params"])):
            for k, v in want_opt.state[p_want].items():
                if not torch.equal(got_opt.state[p_got][k], v):
                    fail(f"{path}: the {level} level's optimizer state {k} differs")
                tensors += 1
        if getattr(fresh.state, level).step != getattr(trainer.state, level).step:
            fail(f"{path}: the {level} level's step counter differs")
        tensors += len(want)
    del fresh
    return load_ms, tensors


def trainer_path(device, bare_step_ms, profile=False):
    """Phase 6: python -m robo_vln_tpu_torch.run's train path, twice through
    run_exp at full width on the card, the second run resuming the first."""
    import shutil
    import tempfile

    from robo_vln_tpu_torch.config import get_config
    from robo_vln_tpu_torch.ops import fused_attention, fused_lstm
    from robo_vln_tpu_torch.run import run_exp
    from robo_vln_tpu_torch.training import checkpoint as ckpt_lib

    print("phase 6: the hierarchical trainer at full width, bfloat16, B=4, tbptt 50: "
          "python -m robo_vln_tpu_torch.run's run_exp twice (epoch 0, then a resumed epoch 1)")
    from robo_vln_tpu_torch.ops import _build

    os.makedirs(_build.BUILD_DIR.parent, exist_ok=True)  # in the checkout, ignored by git
    root = tempfile.mkdtemp(prefix="trainer_", dir=_build.BUILD_DIR.parent)
    try:
        t0 = time.perf_counter()
        data_bytes = write_trainer_buffers(root)
        print(f"  buffers: {TRAINER_EPISODES} train episodes (msgpack), "
              f"{TRAINER_EVAL_EPISODES} eval episodes (flat), {data_bytes / 2**20:.1f} MiB, "
              f"written in {time.perf_counter() - t0:.2f} s")
        opts = ["DEVICE", str(device), "TRAINER_NAME", "hierarchical_trainer",
                "DAGGER.BATCH_SIZE", 4, "DAGGER.tbptt_steps", 50,
                "DAGGER.EPISODE_LEN_BUCKETS", [100], "DAGGER.EPOCHS", 2,
                "DAGGER.MAX_EPOCHS_PER_RUN", 1, "DAGGER.RESUME", True,
                "DAGGER.PRELOAD_LMDB_FEATURES", True,
                "DAGGER.LMDB_FEATURES_DIR", os.path.join(root, "train"),
                "DAGGER.LMDB_EVAL_DIR", os.path.join(root, "eval"),
                "CHECKPOINT_FOLDER", os.path.join(root, "ckpts"),
                "TENSORBOARD_DIR", os.path.join(root, "tb"),
                "LOG_FILE", os.path.join(root, "train.log"),
                "MODEL.INSTRUCTION_ENCODER.is_bert", True,
                "TPU.SYNC_FROZEN_TRUNKS_ON_INIT", True, "TPU.PRECISION", "bfloat16"]
        cfg = get_config(opts=opts)
        record = new_trainer_record()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fused_lstm.reset_launches()
        fused_attention.reset_launches()
        with instrumented_trainer(record):
            t0 = time.perf_counter()
            run_exp(None, "train", opts)
            run1_ms = (time.perf_counter() - t0) * 1e3
            trainer = record["trainers"][0]
            peak1 = torch.cuda.max_memory_allocated()
            changed = [k for k, v in record.pop("frozen").items()
                       if not torch.equal(getattr(trainer, k[0]).get_parameter(k[1]), v)]
            if changed:
                fail(f"frozen parameters changed in training: {changed[:5]}")
            ckpt2 = os.path.join(cfg.CHECKPOINT_FOLDER, "ckpt.2")
            if ckpt_lib.list_checkpoints(cfg.CHECKPOINT_FOLDER) != [ckpt2]:
                fail(f"run 1 wrote {ckpt_lib.list_checkpoints(cfg.CHECKPOINT_FOLDER)}")
            record["wrap"] = False  # the fresh trainer is not a run's
            load_ms, tensors = check_round_trip(trainer, ckpt2, cfg)
            record["wrap"] = True
            del trainer
            record["trainers"].clear()
            t0 = time.perf_counter()
            if profile:
                profile_section("trainer run 2 (resume, one epoch and its validation)",
                                lambda: run_exp(None, "train", opts), top=16,
                                ranges=("hier_train_step.forward", "hier_train_step.backward",
                                        "lstm_seq.backward",
                                        "hier_train_step.optimizer"))
            else:
                run_exp(None, "train", opts)
            run2_ms = (time.perf_counter() - t0) * 1e3
        launches = path_launches()
        record["trainers"].clear()
        ckpts = ckpt_lib.list_checkpoints(cfg.CHECKPOINT_FOLDER)
        meta = ckpt_lib.load_metadata(ckpts[-1])
        if [os.path.basename(c) for c in ckpts] != ["ckpt.2", "ckpt.3"] or \
                meta["train_steps"] != 8:
            fail(f"run 2 did not resume to ckpt.3 with 8 train steps: {ckpts}, {meta}")
        if record["first_steps"][4] != 4:
            fail(f"run 2's first step ran at step {record['first_steps'][4]}, not 4")
        if record["shared_trunks"] != [True, True]:
            fail(f"the trainers did not share their trunks: {record['shared_trunks']}")
        with open(os.path.join(cfg.TENSORBOARD_DIR, "metrics.jsonl")) as f:
            logged = [json.loads(line) for line in f]
        losses = [m for m in logged if "Loss" in m["tag"]]
        if len([m for m in losses if m["tag"].startswith("Train")]) != 4 * 8 or not all(
                math.isfinite(m["value"]) for m in losses):
            fail("the trainer's logged losses are not 4 finite values a step over 8 steps")
        if (len(record["train_ms"]), len(record["val_ms"])) != (8, 4):
            fail(f"{len(record['train_ms'])} train steps and {len(record['val_ms'])} val "
                 "windows, expected 8 and 4")
        want = trainer_launches(8, 4)
        if launches != want:
            fail(f"the trainer path launched {launches}, expected {want}: 24 of each forward "
                 "(bf16 attention rounding p once) and 16 of the partials backward")
        ckpt_bytes = dir_bytes(ckpt2)
        peak = torch.cuda.max_memory_allocated()
        steps = record["train_ms"]
        print(f"  run 1 (build, epoch 0, validation): {run1_ms:.1f} ms; run 2 (resume from "
              f"ckpt.2, epoch 1, validation): {run2_ms:.1f} ms; shared trunks: "
              f"{record['shared_trunks']}")
        print("  train steps, host ms to the end of the device's work: "
              + " ".join(f"{t:.3f}" for t in steps))
        print("  gaps between steps inside an epoch (loader wait, logging), ms: "
              + " ".join(f"{t:.3f}" for t in record["gaps_ms"]))
        print("  train epochs (checkpoint save included), ms: "
              + " ".join(f"{t:.1f}" for t in record["epoch_ms"]))
        print("  checkpoint saves, ms: " + " ".join(f"{t:.1f}" for t in record["save_ms"])
              + f"; ckpt.2 on disk {ckpt_bytes / 2**20:.1f} MiB")
        print(f"  checkpoint load into a fresh trainer: {load_ms:.1f} ms, {tensors} tensors "
              "bitwise equal to the saving trainer's (parameters, buffers, Adam state)")
        print("  val windows, ms: " + " ".join(f"{t:.3f}" for t in record["val_ms"])
              + "; val epochs, ms: " + " ".join(f"{t:.1f}" for t in record["val_epoch_ms"]))
        inner = [t for i, t in enumerate(steps) if i % 4]  # not the first step of a run
        print(f"  steps 2-4 of each run: median {statistics.median(inner):.3f} ms against "
              f"phase 5's bare step, steps 1-4: median {statistics.median(bare_step_ms[1:]):.3f} ms")
        print(f"  peak device memory: run 1 {peak1 / 2**30:.3f} GiB, both runs "
              f"{peak / 2**30:.3f} GiB")
        print(f"  launches on the trainer path: {launches} (each forward 2 a train step and a "
              "val window, the backward 2 a train step)")
        print(f"  run 2 started at step {record['first_steps'][4]} and wrote ckpt.3 with "
              f"train_steps {meta['train_steps']}, scheduler_step {meta['scheduler_step']}")
        events = [t for i, t in enumerate(record["train_event_ms"]) if i % 4]
        summary = {"step_ms": statistics.median(inner), "step_event_ms": statistics.median(events),
                   "epoch_ms": record["epoch_ms"][0], "val_ms": statistics.median(record["val_ms"]),
                   "peak_gib": peak1 / 2**30, "steps_ms": steps, "gaps_ms": record["gaps_ms"],
                   "first_wait_ms": record["first_wait_ms"]}
        return launches, summary
    finally:
        shutil.rmtree(root, ignore_errors=True)


def write_eval_episodes(path, n, seed=7, vocab=30522):
    """``n`` synthetic episodes in the robo_vln_v1 format (gzipped JSON),
    each in a scene of its own (so the batched eval's scene split gives
    each env its own episodes): a reference path of 5-10 m in 3-5
    segments that turn up to 0.6 rad each, the agent facing along its first
    segment, 200 token ids below ``vocab`` (BERT's by default; GloVe's
    2504 for the flat family)."""
    import gzip

    import numpy as np

    rng = np.random.default_rng(seed)
    episodes = []
    for i in range(n):
        length, segments = rng.uniform(5.0, 10.0), int(rng.integers(3, 6))
        heading = rng.uniform(-np.pi, np.pi)
        points = [np.array([rng.uniform(-5, 5), 0.0, rng.uniform(-5, 5)])]
        start_heading = heading
        for _ in range(segments):
            step = length / segments
            points.append(points[-1] + step * np.array([-np.sin(heading), 0.0,
                                                        -np.cos(heading)]))
            heading += rng.uniform(-0.6, 0.6)
        ref = [p.tolist() for p in points]
        episodes.append({
            "episode_id": str(i), "scene_id": f"scene_{i}.glb",
            "start_position": ref[0],
            # habitat's (x, y, z, w): a yaw about +y
            "start_rotation": [0.0, float(np.sin(start_heading / 2)), 0.0,
                               float(np.cos(start_heading / 2))],
            "goals": [{"position": ref[-1], "radius": 3.0}],
            "reference_path": ref,
            "instruction": {"instruction_text": f"synthetic instruction {i}",
                            "instruction_tokens": rng.integers(min(1000, vocab // 2), vocab,
                                                               200).tolist()},
            "info": {"geodesic_distance": float(length)},
        })
    with gzip.open(path, "wt") as f:
        json.dump({"episodes": episodes}, f)


@contextlib.contextmanager
def instrumented_eval(record, device):
    """Time and count what the closed-loop eval does, from outside it: each
    tick's policy call (CUDA events around ``HCMAgent.act``, the host clock
    around the whole host-side tick: copies in, act, the one copy out) and
    its launches (and, where ``record["states"]`` is a list, both levels'
    LSTM states after it), each env step from ``async_step`` to ``wait_step`` (host
    clock: the envs' integration, measures and render), each rollout's wall
    time, BERT's embeddings (the agent's count), each tick's actions and
    stop logit, the trainer evaluated and each episode's stats."""
    import numpy as np

    from robo_vln_tpu_torch.envs.async_env import AsyncEnvPool
    from robo_vln_tpu_torch.eval import agent as agent_mod
    from robo_vln_tpu_torch.eval import evaluator

    cuda = torch.device(device).type == "cuda"
    originals = {}

    def patch(owner, name, make):
        originals[(owner, name)] = getattr(owner, name)
        setattr(owner, name, make(getattr(owner, name)))

    def act(fn):
        def call(self, *args, **kwargs):
            before = path_launches()
            if cuda:
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
            out = fn(self, *args, **kwargs)
            if cuda:
                end.record()
                record["act_events"].append((start, end))
            if record["states"] is not None:  # 7b: both levels' LSTM states, (4, N, H)
                record["states"].append(torch.cat(out[2]).float().cpu().numpy())
            after = path_launches()
            record["tick_launches"].append({k: after[k] - before[k] for k in after})
            return out
        return call

    def policy_tick(fn):
        def call(self, *args, **kwargs):
            t0 = time.perf_counter()
            record["tick_starts"].append(t0)
            out = fn(self, *args, **kwargs)
            record["policy_host_ms"].append((time.perf_counter() - t0) * 1e3)
            record["outputs"].append(out[0].copy())  # actions and stop logit, (N, 3)
            if record["states"] is not None:  # 7b: what the policy was given
                record["ticks"].append((args[0], list(args[2])))
            return out
        return call

    def async_step(fn):
        def call(self, actions):
            record["env_t0"] = time.perf_counter()
            record["env_steps"] += len(actions)
            return fn(self, actions)
        return call

    def wait_step(fn):
        def call(self):
            out = fn(self)
            record["env_ms"].append((time.perf_counter() - record["env_t0"]) * 1e3)
            return out
        return call

    def rollout(fn):
        def call(*args, **kwargs):
            if record["profile"]:  # the profiler's own summary left out
                out = []
                wall_ms = profile_section(record["profile"],
                                          lambda: out.append(fn(*args, **kwargs)))
                record["rollout_s"].append(wall_ms / 1e3)
                return out[0]
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            record["rollout_s"].append(time.perf_counter() - t0)
            return out
        return call

    def embed(fn):
        def call(self, *args, **kwargs):
            out = fn(self, *args, **kwargs)
            record["embeds"] = self.embeds
            return out
        return call

    def aggregate(fn):
        def call(stats_episodes, *args, **kwargs):
            record["episodes"] = dict(stats_episodes)
            return fn(stats_episodes, *args, **kwargs)
        return call

    def evaluate(fn):
        def call(trainer, *args, **kwargs):
            record["trainers"].append(trainer)
            return fn(trainer, *args, **kwargs)
        return call

    try:
        patch(agent_mod.HCMAgent, "act", act)
        patch(agent_mod.HCMAgent, "embed_instruction", embed)
        patch(evaluator._PolicyTick, "__call__", policy_tick)
        patch(AsyncEnvPool, "async_step", async_step)
        patch(AsyncEnvPool, "wait_step", wait_step)
        patch(evaluator, "_run_rollout", rollout)
        patch(evaluator, "_aggregate_and_log", aggregate)
        patch(evaluator, "eval_hierarchical_checkpoint", evaluate)
        yield
    finally:
        for (owner, name), fn in originals.items():
            setattr(owner, name, fn)


def new_eval_record():
    record = {k: [] for k in ("act_events", "tick_launches", "tick_starts", "policy_host_ms",
                              "env_ms", "rollout_s", "trainers", "outputs", "ticks")}
    record.update(env_steps=0, embeds=0, episodes={}, env_t0=0.0, profile=None, states=None)
    return record


def check_eval_stats(label, record, stats_path, episodes):
    if not os.path.exists(stats_path):
        fail(f"{label}: no stats file {stats_path}")
    with open(stats_path) as f:
        stats = json.load(f)
    for key in EVAL_STATS:
        if not math.isfinite(stats.get(key, float("nan"))):
            fail(f"{label}: stats {key} = {stats.get(key)!r}, not finite")
    if len(record["episodes"]) != episodes:
        fail(f"{label}: {len(record['episodes'])} episodes evaluated, expected {episodes}")
    return stats


def trajectories(log_dir):
    with open(os.path.join(log_dir, "trajectories.jsonl")) as f:
        return {row["episode_id"]: row for row in map(json.loads, f)}


def eval_path(device, model_opts=(), profile=False):
    """Phase 7: python -m robo_vln_tpu_torch.run's eval path at full width:
    a port checkpoint of random weights evaluated closed-loop on the
    kinematic backend through run_exp, at EVAL.NUM_ENVS 1 and 8 in bf16
    (7), then four episodes in float32 with the kernels and with their
    plain versions (7b).  ``model_opts`` are extra config options (a CPU
    rehearsal shrinks the model through them); ``profile`` traces the last
    run's rollout.  Returns the launches of the two bf16 runs."""
    import shutil
    import tempfile

    import numpy as np

    from robo_vln_tpu_torch.config import get_config
    from robo_vln_tpu_torch.envs import velocity_control
    from robo_vln_tpu_torch.eval import agent as agent_mod
    from robo_vln_tpu_torch.eval import evaluator
    from robo_vln_tpu_torch.ops import _build, fused_attention, fused_lstm
    from robo_vln_tpu_torch.run import run_exp
    from robo_vln_tpu_torch.training import trainable_mask
    from robo_vln_tpu_torch.training.hierarchical_trainer import HierarchicalTrainer
    from robo_vln_tpu_torch.utils.logging import MetricsWriter

    cuda = torch.device(device).type == "cuda"
    print(f"phase 7 ({card_line() if cuda else 'no card'}): closed-loop eval at full width, "
          f"bfloat16: python -m "
          f"robo_vln_tpu_torch.run --run-type eval's run_exp over {EVAL_EPISODES} synthetic "
          f"episodes on the kinematic backend, MAX_EPISODE_STEPS cut from 1000 to "
          f"{EVAL_MAX_STEPS}, at EVAL.NUM_ENVS " + " and ".join(map(str, EVAL_NUM_ENVS)))
    os.makedirs(_build.BUILD_DIR.parent, exist_ok=True)  # in the checkout, ignored by git
    root = tempfile.mkdtemp(prefix="eval_", dir=_build.BUILD_DIR.parent)
    try:
        data = os.path.join(root, "episodes.json.gz")
        write_eval_episodes(data, EVAL_EPISODES)

        def opts(n_envs, tag, precision="bfloat16", episodes=EVAL_EPISODES, seed=()):
            return ["DEVICE", str(device), "TRAINER_NAME", "hierarchical_trainer", *seed,
                    "CHECKPOINT_FOLDER", os.path.join(root, "ckpts"),
                    "EVAL_CKPT_PATH_DIR", os.path.join(root, "ckpts"),
                    "TENSORBOARD_DIR", os.path.join(root, f"tb_{tag}"),
                    "LOG_FILE", os.path.join(root, "eval.log"),
                    "TASK_CONFIG.SIMULATOR.TYPE", "kinematic",
                    "TASK_CONFIG.DATASET.DATA_PATH", data,
                    "TASK_CONFIG.TASK.NDTW.GT_PATH", os.path.join(root, "no_gt.json.gz"),
                    "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", EVAL_MAX_STEPS,
                    "EVAL.EPISODE_COUNT", episodes, "EVAL.NUM_ENVS", n_envs,
                    "EVAL.VAL_LOG_DIR", os.path.join(root, f"val_{tag}"),
                    "EVAL.DUMP_TRAJECTORIES", True,
                    "MODEL.INSTRUCTION_ENCODER.is_bert", True,
                    "TPU.SYNC_FROZEN_TRUNKS_ON_INIT", True, "TPU.PRECISION", precision,
                    *model_opts]

        # the checkpoint's weights are random from seed 0 and its velocity
        # head scaled; the eval's trainers start from TASK_CONFIG.SEED's
        # default, 100, so an eval that skipped the load (or part of it)
        # holds other weights than the checkpoint's
        t0 = time.perf_counter()
        saver = HierarchicalTrainer(get_config(opts=opts(1, "save",
                                                         seed=("TASK_CONFIG.SEED", 0))))
        saver._setup_policy()
        with torch.no_grad():
            saver.low.linear.weight.mul_(EVAL_VELOCITY_SCALE)
            saver.low.linear.bias.add_(torch.tensor(EVAL_VELOCITY_BIAS, device=device))
        saver.save_checkpoint("ckpt.0")
        ckpt = os.path.join(root, "ckpts", "ckpt.0")
        print(f"  checkpoint of random weights from seed 0 (synced trunks), the low level's "
              f"velocity head scaled by {EVAL_VELOCITY_SCALE} and biased by "
              f"{EVAL_VELOCITY_BIAS} (lin_vel, omega), so that the agent drives; the eval "
              f"starts from seed 100: built and saved in "
              f"{time.perf_counter() - t0:.2f} s, {dir_bytes(ckpt) / 2**20:.1f} MiB")
        saved = {(level, n): p for level, pol in (("high", saver.high), ("low", saver.low))
                 for n, p in pol.named_parameters()}
        frozen = {(level, n) for level, pol in (("high", saver.high), ("low", saver.low))
                  for mask in (trainable_mask(pol),) for n, _ in pol.named_parameters()
                  if not mask[n]}

        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        fused_lstm.reset_launches()
        fused_attention.reset_launches()
        forward = ("lstm_seq", "cross_modal_attn", "cross_modal_attn_bf16_round_p")
        summary, rates = {}, {}
        for n_envs in EVAL_NUM_ENVS:
            record = new_eval_record()
            if profile and n_envs == EVAL_NUM_ENVS[-1]:
                record["profile"] = f"the rollout at NUM_ENVS {n_envs}"
            t0 = time.perf_counter()
            with instrumented_eval(record, device):
                run_exp(None, "eval", opts(n_envs, f"n{n_envs}"))
            run_s = time.perf_counter() - t0
            label = f"NUM_ENVS {n_envs}"
            stats = check_eval_stats(label, record, os.path.join(
                root, f"val_n{n_envs}", "stats_ckpt_0_val_seen.json"), EVAL_EPISODES)
            trainer = record["trainers"][0]
            for (level, name), p in saved.items():
                if not torch.equal(getattr(trainer, level).get_parameter(name), p):
                    fail(f"{label}: {level} {name} differs from the checkpoint's"
                         + (" (frozen)" if (level, name) in frozen else ""))
            for t, launched in enumerate(record["tick_launches"]):
                for name, count in launched.items():
                    if count != (2 if name in forward else 0):
                        fail(f"{label}: tick {t} launched {name} {count} times, expected "
                             f"{2 if name in forward else 0}")
            ticks = len(record["tick_launches"])
            rollout_s = record["rollout_s"][0]
            policy_ms = ([s.elapsed_time(e) for s, e in record["act_events"]] if cuda
                         else [float("nan")])
            print(f"  {label}: {len(record['episodes'])} episodes, {ticks} ticks, "
                  f"{record['env_steps']} env steps in {rollout_s:.3f} s of rollout "
                  f"({run_s:.2f} s run_exp, trainer set-up and checkpoint load included): "
                  f"{record['env_steps'] / rollout_s:.2f} env steps/s, "
                  f"{len(record['episodes']) / rollout_s:.3f} episodes/s")
            starts = record["tick_starts"]
            tick_ms = [(b - a) * 1e3 for a, b in zip(starts, starts[1:])]
            print(f"    median tick {statistics.median(tick_ms):.3f} ms (host clock, one policy "
                  f"tick to the next): policy {statistics.median(policy_ms):.3f} ms on the "
                  f"device's clock (CUDA "
                  f"events around act), {statistics.median(record['policy_host_ms']):.3f} ms "
                  f"host (copies in, act, the one copy out); env step and render "
                  f"{statistics.median(record['env_ms']):.3f} ms host; BERT embedded "
                  f"{record['embeds']} times")
            print(f"    stats: " + ", ".join(f"{k} {stats[k]:.6f}" for k in EVAL_STATS))
            if not stats["path_length"] > 1.0:
                fail(f"{label}: the agent drove {stats['path_length']:.3f} m an episode: "
                     "the checkpoint's velocity head did not reach the eval")
            summary[n_envs] = record["episodes"]
            rates[n_envs] = record["env_steps"] / rollout_s
            stats_keys = set(stats)
            del trainer
            record["trainers"].clear()
        launches = path_launches()
        print(f"  launches on the eval path (both runs): {launches}; kinematic integrator: "
              f"{velocity_control.integrator()}")
        if cuda:
            print(f"  peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
        if summary[EVAL_NUM_ENVS[0]].keys() != summary[EVAL_NUM_ENVS[-1]].keys():
            fail("the two runs evaluated other episodes")

        print(f"phase 7b: float32, {EVAL_F32_EPISODES} episodes at EVAL.NUM_ENVS "
              f"{EVAL_F32_EPISODES}, from the same checkpoint: the kernels against their "
              "plain versions, closed-loop")
        trainer = HierarchicalTrainer(get_config(opts=opts(
            EVAL_F32_EPISODES, "f32", "float32", EVAL_F32_EPISODES)))
        rows, counts, records = {}, {}, {}
        for mode in ("kernels", "plain"):
            record = records[mode] = new_eval_record()
            record["states"] = []
            before = path_launches()
            with MetricsWriter(os.path.join(root, f"tb_f32_{mode}")) as writer, \
                    instrumented_eval(record, device), \
                    plain_kernels() if mode == "plain" else contextlib.nullcontext():
                trainer._eval_checkpoint(ckpt, writer, checkpoint_index=len(rows))
            after = path_launches()
            counts[mode] = {k: after[k] - before[k] for k in after}
            rows[mode] = trajectories(writer.log_dir)
            print(f"  {mode}: {len(rows[mode])} episodes, {len(record['tick_launches'])} ticks "
                  f"in {record['rollout_s'][0]:.3f} s, launches {counts[mode]}")
        ticks = len(records["kernels"]["tick_launches"])
        want = {"kernels": {"lstm_seq": 2 * ticks, "cross_modal_attn": 2 * ticks},
                "plain": {}}
        for mode, launched in counts.items():
            expected = {k: want[mode].get(k, 0) for k in launched}
            if launched != expected:
                fail(f"7b {mode}: launched {launched}, expected {expected}")
        kern, plain = rows["kernels"], rows["plain"]
        if kern.keys() != plain.keys() or len(kern) != EVAL_F32_EPISODES:
            fail(f"7b: episodes {sorted(kern)} with the kernels, {sorted(plain)} plain")
        agree, divergence = 0, 0.0
        for ep in sorted(kern):
            k, p = kern[ep], plain[ep]
            same = all(k[key] == p[key] for key in ("success", "actual_success", "steps"))
            agree += same
            n = min(len(k["locations"]), len(p["locations"]))
            gap = max(math.dist(a, b) for a, b in zip(k["locations"][:n], p["locations"][:n]))
            divergence = max(divergence, gap)
            print(f"  episode {ep}: success {k['success']} / {p['success']}, actual_success "
                  f"{k['actual_success']} / {p['actual_success']}, steps {k['steps']} / "
                  f"{p['steps']} (kernels / plain); largest position gap {gap:.3e} m")
        print(f"  success agreement {agree}/{len(kern)}; largest position divergence over all "
              f"steps {divergence:.3e} m (tolerance {EVAL_POSITION_TOL} m)")
        if agree != len(kern):
            fail("7b: an episode's success, actual_success or length differs between the "
                 "kernels and their plain versions")
        if not divergence <= EVAL_POSITION_TOL:
            fail(f"7b: positions diverge by {divergence:.3e} m")
        # the kernels on the same inputs: the kernels' run's ticks (its
        # observations and resets) replayed through the plain versions, and
        # each tick's outputs and both levels' LSTM states held to the
        # kernels', each one's error as a share of its range over the run.
        # Closed-loop the two runs see other frames from the first tick at
        # which a position differs (the render rounds to whole values), so
        # their ticks are compared only through the positions above.
        # Attention feeds only the high level: its state carries an error
        # that the argmax over its logits hides from the actions
        kernel_ticks = records["kernels"]["ticks"]
        same = [all(np.array_equal(a[0][key], b[0][key]) for key in ("rgb", "depth"))
                for a, b in zip(kernel_ticks, records["plain"]["ticks"])]
        print(f"  closed-loop, the two runs' frames are equal through tick "
              f"{same.index(False) - 1 if False in same else len(same) - 1} of {len(kernel_ticks)}")
        agent = agent_mod.HCMAgent(trainer.high, trainer.low,
                                   share_frozen_trunks=trainer.config.TPU.SHARE_FROZEN_TRUNKS)
        replay = evaluator._PolicyTick(agent)
        state, p_out, p_hc = agent.initial_state(EVAL_F32_EPISODES), [], []
        with plain_kernels():
            for obs, reset_rows in kernel_ticks:
                out, state = replay(obs, state, reset_rows)
                p_out.append(out)
                p_hc.append(torch.cat(state).float().cpu().numpy())
        k_out, p_out = np.stack(records["kernels"]["outputs"]), np.stack(p_out)
        k_hc, p_hc = np.stack(records["kernels"]["states"]), np.stack(p_hc)
        half = p_hc.shape[1] // 2  # high level's (h, c), then the low level's
        pairs = [(k_out[..., i], p_out[..., i]) for i in range(3)] + [
            (k_hc[:, :half], p_hc[:, :half]), (k_hc[:, half:], p_hc[:, half:])]
        worst = 0.0
        for name, (k, p) in zip(("lin_vel", "omega", "stop logit", "high level's LSTM "
                                 "state", "low level's LSTM state"), pairs):
            err, span = np.abs(k - p).max(), np.ptp(p)
            rel = err / max(span, np.finfo(np.float32).tiny)
            worst = max(worst, rel)
            print(f"  the kernels' {len(kernel_ticks)} ticks replayed plain, each tick's {name}: "
                  f"largest difference {err:.3e} over a range of {span:.3e} ({rel:.3e} of it; "
                  f"tolerance {EVAL_OUTPUT_RTOL})")
        if not worst <= EVAL_OUTPUT_RTOL:
            fail(f"7b: on the same ticks the kernels' outputs or states differ from the plain "
                 f"versions' by {worst:.3e} of their range")
        # the rollouts put the decisions to the test: some episodes end on
        # success, and not all at one tick
        if not any(r["actual_success"] for r in plain.values()) \
                or len({r["steps"] for r in plain.values()}) < 2:
            fail("7b: no episode ended on success, or all ended at one tick: the comparison "
                 "does not reach the success decision")
        return launches, {"rates": rates, "stats_keys": stats_keys}
    finally:
        shutil.rmtree(root, ignore_errors=True)


@contextlib.contextmanager
def instrumented_collection(record, device):
    """Time and count what collection does, from outside it: each
    ``collect_dataset`` call (host clock, its beta, the launches of each
    kernel and the env steps inside it), each kinematic env step (host
    clock: integration, measures, render), each mixer tick (the host clock
    around ``PolicyMixer.step``: copies in, act, the one copy out; CUDA
    events around ``HCMAgent.act``; its launches; where ``record["ticks"]``
    is a list, the tick's inputs and outputs and both levels' LSTM states),
    what each tick executed and what the policy answered, the mixers built
    (for BERT's embeddings), when each episode reached the buffer, and each
    train epoch's launches."""
    from robo_vln_tpu_torch.data.trajectory_store import TrajectoryStore
    from robo_vln_tpu_torch.envs import collection, dagger
    from robo_vln_tpu_torch.envs.env import KinematicEnv
    from robo_vln_tpu_torch.eval import agent as agent_mod
    from robo_vln_tpu_torch.training.hierarchical_trainer import HierarchicalTrainer as HT

    cuda = torch.device(device).type == "cuda"
    originals = {}

    def patch(owner, name, make):
        originals[(owner, name)] = getattr(owner, name)
        setattr(owner, name, make(getattr(owner, name)))

    def delta(before):
        after = path_launches()
        return {k: after[k] - before[k] for k in after}

    def collect(fn):
        def call(config, features_dir, **kwargs):
            before, steps, t0 = path_launches(), record["env_steps"], time.perf_counter()
            record["puts"] = []
            out = fn(config, features_dir, **kwargs)
            record["collections"].append({
                "s": time.perf_counter() - t0, "beta": kwargs.get("beta", 1.0),
                "arrivals": [t - t0 for t in record["puts"]],
                "episodes": out, "env_steps": record["env_steps"] - steps,
                "launches": delta(before), "processes": int(config.NUM_PROCESSES)})
            return out
        return call

    def env_step(fn):
        def call(self, *args):
            t0 = time.perf_counter()
            out = fn(self, *args)
            record["env_ms"].append((time.perf_counter() - t0) * 1e3)
            record["env_steps"] += 1
            return out
        return call

    def act(fn):
        def call(self, obs, state, prev, mask, host_ids=None):
            before = path_launches()
            if cuda:
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
            out = fn(self, obs, state, prev, mask, host_ids=host_ids)
            if cuda:
                end.record()
                record["act_events"].append((start, end))
            record["tick_launches"].append(delta(before))
            if record["ticks"] is not None:  # 8c: what the policy was given, and gave
                record["ticks"].append((obs, prev, mask, host_ids, out[0].float().cpu().numpy(),
                                        torch.cat(out[2]).float().cpu().numpy()))
            return out
        return call

    def mixer_step(fn):
        def call(self, observations):
            t0 = time.perf_counter()
            out = fn(self, observations)
            record["policy_host_ms"].append((time.perf_counter() - t0) * 1e3)
            record["answers"].append(out)
            return out
        return call

    def set_prev(fn):
        def call(self, v, w):
            record["executed"].append((v, w))
            return fn(self, v, w)
        return call

    def mixer_for_trainer(fn):
        def call(trainer):
            mixer = fn(trainer)
            record["mixers"].append(mixer)
            return mixer
        return call

    def put(fn):
        def call(self, *args):
            out = fn(self, *args)
            record["puts"].append(time.perf_counter())
            return out
        return call

    def train_epoch(fn):
        def call(self, *args, **kwargs):
            before = path_launches()
            out = fn(self, *args, **kwargs)
            record["epoch_launches"].append(delta(before))
            return out
        return call

    try:
        patch(collection, "collect_dataset", collect)
        patch(KinematicEnv, "step", env_step)
        patch(agent_mod.HCMAgent, "act", act)
        patch(dagger.PolicyMixer, "step", mixer_step)
        patch(dagger.PolicyMixer, "set_prev", set_prev)
        patch(dagger, "mixer_for_trainer", mixer_for_trainer)
        patch(HT, "train_epoch", train_epoch)
        patch(TrajectoryStore, "put", put)
        yield
    finally:
        for (owner, name), fn in originals.items():
            setattr(owner, name, fn)


def new_collection_record():
    record = {k: [] for k in ("collections", "env_ms", "act_events", "tick_launches",
                              "policy_host_ms", "answers", "executed", "mixers",
                              "epoch_launches")}
    record.update(env_steps=0, ticks=None, puts=[])
    return record


def read_episodes(path):
    """(sha256 of each stored episode, each episode's length), by key; the
    port's loader (data/loader.TrajectoryDataset) must read every episode,
    finite and of the stored length."""
    import hashlib

    import numpy as np

    from robo_vln_tpu_torch.data import serialization
    from robo_vln_tpu_torch.data.loader import TrajectoryDataset
    from robo_vln_tpu_torch.data.trajectory_store import TrajectoryStore

    with TrajectoryStore(path) as store:
        raws = [store.get_buffer(i) for i in range(len(store))]
    digests = [hashlib.sha256(raw).hexdigest() for raw in raws]
    lengths = [len(serialization.unpackb_any(raw)[2]) for raw in raws]
    del raws
    loaded = []
    for obs, prev, corr, _ in TrajectoryDataset(path, batch_size=1, is_bert=True):
        if not (np.isfinite(corr).all() and np.isfinite(prev).all()) or corr.shape[1] != 2 \
                or obs["rgb"].dtype != np.uint8 or len(obs["rgb"]) != len(corr):
            fail(f"{path}: the loader read a malformed episode")
        loaded.append(len(corr))
    if sorted(loaded) != sorted(lengths):
        fail(f"{path}: the loader read episodes of {sorted(loaded)} ticks, the store holds "
             f"{sorted(lengths)}")
    return digests, lengths


def policy_decisions(executed, answers, labels):
    """Per mixer tick: (the policy's command ran, it differs from the
    expert's label).  The policy's command is its answer with omega
    clipped to [-1, 1]."""
    import numpy as np

    if not len(executed) == len(answers) == len(labels):
        fail(f"{len(executed)} executed commands, {len(answers)} policy answers, "
             f"{len(labels)} labels")
    out = []
    for (ev, ew), (pv, pw), (lv, lw) in zip(executed, answers, labels):
        ran = (ev, ew) == (pv, float(np.clip(pw, -1.0, 1.0)))
        out.append((ran, ran and (ev, ew) != (lv, lw)))
    return out


def buffer_labels(path, first):
    """The expert labels of every tick of the buffer's episodes from key
    ``first`` on, in collection order."""
    import numpy as np

    from robo_vln_tpu_torch.data import serialization
    from robo_vln_tpu_torch.data.trajectory_store import TrajectoryStore

    with TrajectoryStore(path) as store:
        return [tuple(row) for i in range(first, len(store)) for row in np.asarray(
            serialization.unpackb_any(store.get_buffer(i))[2], np.float64).tolist()]


def collect_path(device, model_opts=()):
    """Phase 8: DAgger collection through python -m robo_vln_tpu_torch.run's
    run_exp: expert collection on robovln_data_train.yaml at 1 and 4
    worker processes (8a), the hierarchical trainer collecting and training
    in one run, its second iteration mixed with the policy on ``device``
    (8b), and a float32 mixed collection's ticks replayed through the plain
    versions (8c).  ``model_opts`` are extra config options (a CPU rehearsal
    shrinks the model and the sensors through them).  Returns the launches
    of the phase's collection runs (8a and 8b)."""
    import shutil
    import tempfile

    import numpy as np

    from robo_vln_tpu_torch.config import get_config
    from robo_vln_tpu_torch.envs import collection, dagger
    from robo_vln_tpu_torch.ops import _build, fused_attention, fused_lstm
    from robo_vln_tpu_torch.run import run_exp
    from robo_vln_tpu_torch.training import checkpoint as ckpt_lib
    from robo_vln_tpu_torch.training.hierarchical_trainer import HierarchicalTrainer

    cuda = torch.device(device).type == "cuda"
    yaml = os.path.join(os.path.dirname(os.path.abspath(__file__)), "robo_vln_tpu_torch",
                        "config", "configs", "robovln_data_train.yaml")
    print(f"phase 8 ({card_line() if cuda else 'no card'}): DAgger collection through python -m "
          f"robo_vln_tpu_torch.run's run_exp, {COLLECT_EPISODES} synthetic episodes on the "
          "kinematic backend at full width (224 px rgb, 256 px depth)")
    os.makedirs(_build.BUILD_DIR.parent, exist_ok=True)  # in the checkout, ignored by git
    root = tempfile.mkdtemp(prefix="collect_", dir=_build.BUILD_DIR.parent)
    try:
        data = os.path.join(root, "episodes.json.gz")
        write_eval_episodes(data, COLLECT_EPISODES)
        common = ["DEVICE", str(device), "TASK_CONFIG.SIMULATOR.TYPE", "kinematic",
                  "TASK_CONFIG.DATASET.DATA_PATH", data,
                  "LOG_FILE", os.path.join(root, "collect.log"),
                  "MODEL.INSTRUCTION_ENCODER.is_bert", True]
        fused_lstm.reset_launches()
        fused_attention.reset_launches()

        # 8a: the expert alone, the shipped collection config
        print(f"8a: expert collection, robovln_data_train.yaml (robo_vln_trainer, COLLECT_ONLY), "
              f"UPDATE_SIZE {COLLECT_EPISODES}, MAX_EPISODE_STEPS 1000 (not cut), NUM_PROCESSES "
              + " and ".join(map(str, COLLECT_PROCESSES)))
        buffers = {}
        for n in COLLECT_PROCESSES:
            record = new_collection_record()
            buf = os.path.join(root, f"expert_n{n}")
            with instrumented_collection(record, device):
                run_exp(yaml, "train", [*common, "NUM_PROCESSES", n,
                                        "DAGGER.UPDATE_SIZE", COLLECT_EPISODES,
                                        "DAGGER.LMDB_FEATURES_DIR", buf,
                                        "TENSORBOARD_DIR", os.path.join(root, "tb_expert"),
                                        "CHECKPOINT_FOLDER", os.path.join(root, "ckpt_expert"),
                                        *model_opts])
            (run,) = record["collections"]
            digests, lengths = buffers[n] = read_episodes(buf)
            ticks = sum(lengths)
            if run["episodes"] != COLLECT_EPISODES or len(digests) != COLLECT_EPISODES:
                fail(f"8a NUM_PROCESSES {n}: {len(digests)} episodes in the buffer, "
                     f"expected {COLLECT_EPISODES}")
            if any(run["launches"].values()):
                fail(f"8a: expert collection launched {run['launches']}")
            print(f"  NUM_PROCESSES {n}: {COLLECT_EPISODES} episodes, {ticks} env steps in "
                  f"{run['s']:.3f} s (worker start-up included): "
                  f"{COLLECT_EPISODES / run['s']:.3f} episodes/s, {ticks / run['s']:.2f} env "
                  f"steps/s; {dir_bytes(buf) / 2**20 / COLLECT_EPISODES:.2f} MiB an episode "
                  f"on disk; ticks an episode {lengths}")
            first, last = run["arrivals"][0], run["arrivals"][-1]
            print(f"    the first episode reached the buffer after {first:.3f} s, the last after "
                  f"{last:.3f} s: {(COLLECT_EPISODES - 1) / (last - first):.3f} episodes/s "
                  "between them")
            if n > 1:  # each episode has a scene of its own: worker w rolls out w, w+n, ...
                serial_lengths = buffers[COLLECT_PROCESSES[0]][1]
                print(f"    env steps a worker: {[sum(serial_lengths[w::n]) for w in range(n)]}")
            if n == 1:
                print(f"    env step and render, host clock: median "
                      f"{statistics.median(record['env_ms']):.3f} ms over {record['env_steps']}")
        serial, parallel = (buffers[n] for n in COLLECT_PROCESSES)
        if sorted(serial[0]) != sorted(parallel[0]):
            fail(f"8a: the {COLLECT_PROCESSES[-1]}-process buffer does not hold the serial "
                 "buffer's episodes bitwise")
        print(f"  the {COLLECT_PROCESSES[-1]}-process buffer holds the serial buffer's "
              f"{COLLECT_EPISODES} episodes bitwise (order {[serial[0].index(d) for d in parallel[0]]}); "
              "the port's loader read both")
        for n in COLLECT_PROCESSES:
            shutil.rmtree(os.path.join(root, f"expert_n{n}"))

        # 8b: collect, train, collect mixed with the trained policy, train
        print(f"8b: the hierarchical trainer collecting and training in one run, bfloat16: "
              f"DAGGER.ITERATIONS 2, P 0.5, UPDATE_SIZE {COLLECT_UPDATE}, one epoch an "
              f"iteration, BATCH_SIZE 4, tbptt 50; MAX_EPISODE_STEPS cut from 1000 to "
              f"{COLLECT_MAX_STEPS}")
        record = new_collection_record()
        buf, ckpts = os.path.join(root, "dagger"), os.path.join(root, "ckpt_dagger")
        opts = [*common, "TRAINER_NAME", "hierarchical_trainer",
                "DAGGER.PRELOAD_LMDB_FEATURES", False, "DAGGER.ITERATIONS", 2, "DAGGER.P", 0.5,
                "DAGGER.UPDATE_SIZE", COLLECT_UPDATE, "DAGGER.EPOCHS", 1,
                "DAGGER.BATCH_SIZE", 4, "DAGGER.tbptt_steps", 50,
                "DAGGER.EPISODE_LEN_BUCKETS", [COLLECT_MAX_STEPS],
                "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", COLLECT_MAX_STEPS,
                "DAGGER.LMDB_FEATURES_DIR", buf,
                "DAGGER.LMDB_EVAL_DIR", os.path.join(root, "no_eval_buffer"),
                "CHECKPOINT_FOLDER", ckpts, "TENSORBOARD_DIR", os.path.join(root, "tb_dagger"),
                "TPU.SYNC_FROZEN_TRUNKS_ON_INIT", True, "TPU.PRECISION", "bfloat16",
                *model_opts]
        t0 = time.perf_counter()
        with instrumented_collection(record, device):
            run_exp(None, "train", opts)
        run_s = time.perf_counter() - t0
        launches = path_launches()  # 8a's and 8b's collections and 8b's epochs
        expert, mixed = record["collections"]
        if (expert["beta"], mixed["beta"]) != (1.0, 0.5):
            fail(f"8b: the iterations collected at beta {expert['beta']}, {mixed['beta']}")
        with_store = ckpt_lib.list_checkpoints(ckpts)
        if [os.path.basename(c) for c in with_store] != ["ckpt.1", "ckpt.2"]:
            fail(f"8b: checkpoints {with_store}, expected ckpt.1 and ckpt.2")
        digests, lengths = read_episodes(buf)
        if len(digests) != 2 * COLLECT_UPDATE:
            fail(f"8b: {len(digests)} episodes in the buffer, expected {2 * COLLECT_UPDATE}")
        ticks = len(record["tick_launches"])
        if ticks != mixed["env_steps"] or ticks == 0:
            fail(f"8b: {ticks} policy ticks over {mixed['env_steps']} mixed env steps")
        forward = ("lstm_seq", "cross_modal_attn", "cross_modal_attn_bf16_round_p")
        for t, launched in enumerate(record["tick_launches"]):
            for name, count in launched.items():
                if count != (2 if name in forward else 0):
                    fail(f"8b: mixed tick {t} launched {name} {count} times, expected "
                         f"{2 if name in forward else 0}")
        if any(expert["launches"].values()):
            fail(f"8b: the expert iteration launched {expert['launches']}")
        train_steps = ckpt_lib.load_metadata(with_store[-1])["train_steps"]
        epochs = {k: sum(e[k] for e in record["epoch_launches"]) for k in launches}
        want = {k: (2 * train_steps if k in (*forward, "lstm_seq_backward") else 0)
                for k in launches}
        if epochs != want:
            fail(f"8b: the epochs' {train_steps} train steps launched {epochs}, expected {want}")
        decisions = policy_decisions(record["executed"], record["answers"],
                                     buffer_labels(buf, COLLECT_UPDATE))
        ran = sum(r for r, _ in decisions)
        if not any(differs for _, differs in decisions):
            fail("8b: no tick executed a policy command other than the expert's label: the "
                 "mixer did not drive")
        (mixer,) = record["mixers"]
        if mixer.agent.trunk_fn is None:
            fail("8b: the mixer's policies do not share their frozen trunks")
        policy_ms = ([s.elapsed_time(e) for s, e in record["act_events"]] if cuda
                     else [float("nan")])
        for name, run in (("iteration 0, the expert", expert),
                          ("iteration 1, mixed at beta 0.5", mixed)):
            print(f"  {name}: {run['episodes']} episodes, {run['env_steps']} env steps in "
                  f"{run['s']:.3f} s: {run['env_steps'] / run['s']:.2f} env steps/s")
        print(f"  the mixed tick: policy {statistics.median(policy_ms):.3f} ms on the device's "
              f"clock (CUDA events around act), {statistics.median(record['policy_host_ms']):.3f} "
              f"ms host (copies in, act, the one copy out); env step and render "
              f"{statistics.median(record['env_ms']):.3f} ms host (median over both "
              f"iterations); the policy's command ran at {ran} of {ticks} ticks "
              f"({ran / ticks:.3f}); BERT embedded {mixer.agent.embeds} times over "
              f"{mixed['episodes']} episodes; the trunks shared")
        print(f"  launches during the mixed collection: {mixed['launches']} ({ticks} ticks); "
              f"during the epochs ({train_steps} train steps): {epochs}")
        print(f"  run_exp {run_s:.2f} s; ticks an episode {lengths}; checkpoints "
              f"{[os.path.basename(c) for c in with_store]}")
        collect_launches = {k: sum(c["launches"][k] for c in record["collections"])
                            for k in launches}
        del mixer
        record["mixers"].clear()

        # 8c: a float32 mixed collection's ticks replayed through the plain versions
        print(f"8c: float32, {COLLECT_F32_EPISODES} episodes mixed at beta 0.5, MAX_EPISODE_STEPS "
              f"{COLLECT_F32_MAX_STEPS}: each tick's inputs replayed through the plain versions")
        cfg = get_config(opts=[*opts, "TPU.PRECISION", "float32",
                               "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS",
                               COLLECT_F32_MAX_STEPS])
        trainer = HierarchicalTrainer(cfg)
        trainer._setup_policy()
        record = new_collection_record()
        record["ticks"] = []
        mixer = dagger.mixer_for_trainer(trainer)
        with instrumented_collection(record, device):
            collection.collect_dataset(cfg, os.path.join(root, "f32"),
                                       update_size=COLLECT_F32_EPISODES, mixer=mixer, beta=0.5)
        ticks = record["ticks"]
        (run,) = record["collections"]
        want = {k: (2 * len(ticks) if k in ("lstm_seq", "cross_modal_attn") else 0)
                for k in run["launches"]}
        if run["launches"] != want or not ticks:
            fail(f"8c: launched {run['launches']} in {len(ticks)} ticks, expected {want}")
        agent = mixer.agent
        state, p_out, p_hc = None, [], []
        with plain_kernels():
            for obs, prev, mask, host_ids, _, _ in ticks:
                if state is None or not mask.any():  # an episode's first tick
                    state = agent.initial_state(1)
                actions, _, state = agent.act(obs, state, prev, mask, host_ids=host_ids)
                p_out.append(actions.float().cpu().numpy())
                p_hc.append(torch.cat(state).float().cpu().numpy())
        mixer.close()
        k_out, p_out = np.stack([t[4] for t in ticks]), np.stack(p_out)
        k_hc, p_hc = np.stack([t[5] for t in ticks]), np.stack(p_hc)
        half = p_hc.shape[1] // 2  # the high level's (h, c), then the low level's
        worst = 0.0
        for name, (k, p) in zip(("lin_vel", "omega", "high level's LSTM state",
                                 "low level's LSTM state"),
                                ((k_out[..., 0], p_out[..., 0]), (k_out[..., 1], p_out[..., 1]),
                                 (k_hc[:, :half], p_hc[:, :half]),
                                 (k_hc[:, half:], p_hc[:, half:]))):
            err, span = np.abs(k - p).max(), np.ptp(p)
            rel = err / max(span, np.finfo(np.float32).tiny)
            worst = max(worst, rel)
            print(f"  {len(ticks)} ticks, each tick's {name}: largest difference {err:.3e} over "
                  f"a range of {span:.3e} ({rel:.3e} of it; tolerance {COLLECT_OUTPUT_RTOL})")
        if not worst <= COLLECT_OUTPUT_RTOL:
            fail(f"8c: on the same ticks the kernels' outputs or states differ from the plain "
                 f"versions' by {worst:.3e} of their range")
        ran = sum(r for r, _ in policy_decisions(
            record["executed"], record["answers"], buffer_labels(os.path.join(root, "f32"), 0)))
        print(f"  the policy's command ran at {ran} of {len(ticks)} ticks; launches {run['launches']}")
        del trainer, agent, mixer
        return collect_launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


def grow_buffer(path, key, seed=4):
    """Append one more episode of phase 6's kind at ``key`` (msgpack)."""
    import numpy as np

    from robo_vln_tpu_torch.data.loader import write_episode
    from robo_vln_tpu_torch.data.trajectory_store import TrajectoryStore

    rng = np.random.default_rng(seed)
    t = int(rng.integers(60, 101))
    obs = {"rgb": rng.integers(0, 256, (t, 224, 224, 3), dtype=np.uint8),
           "depth": rng.random((t, 256, 256, 1), dtype=np.float32).astype(np.float16),
           "vln_oracle_action_sensor": rng.integers(1, 5, (t, 1)).astype(np.float64),
           "instruction": np.tile(rng.integers(1, 30522, (1, 200)), (t, 1)).astype(np.int32)}
    with TrajectoryStore(path, writable=True) as store:
        write_episode(store, key, obs, rng.standard_normal((t, 2)), rng.random((t, 2)),
                      [t - 5] * t)


@contextlib.contextmanager
def counted_featurize(record):
    """Count, from outside, the trunk calls and what featurize_buffer wrote."""
    from robo_vln_tpu_torch.training import featurize

    make, write = featurize.make_shared_trunk_fn, featurize.featurize_buffer

    def make_counted(high):
        fn = make(high)

        def call(obs):
            record["trunk_calls"] += 1
            return fn(obs)
        return call

    def write_counted(*args, **kwargs):
        out = write(*args, **kwargs)
        record["written"].append(out)
        return out

    featurize.make_shared_trunk_fn, featurize.featurize_buffer = make_counted, write_counted
    try:
        yield
    finally:
        featurize.make_shared_trunk_fn, featurize.featurize_buffer = make, write


def feature_path(device, raw=None, model_opts=(), episodes_writer=None, grow=None,
                 profile=False):
    """Phase 9: training from cached trunk features at full width.  9a
    featurizes phase 6's synthetic buffers through ensure_featurized (a
    reuse and a one-episode append too) and holds the first batch's losses
    from features to those from the raw frames; 9b runs run_exp's train path
    once from the features, beside phase 6's raw run (``raw``, its summary);
    9c holds a float32 feature-mode step to the same step with the plain
    versions.  ``model_opts``, ``episodes_writer`` and ``grow`` shrink it for
    a CPU rehearsal; ``profile`` traces a bf16 feature-mode step.  Returns
    9b's launches."""
    import shutil
    import tempfile

    import numpy as np

    from robo_vln_tpu_torch.config import get_config
    from robo_vln_tpu_torch.data.loader import split_tbptt
    from robo_vln_tpu_torch.data.trajectory_store import TrajectoryStore
    from robo_vln_tpu_torch.ops import _build, fused_attention, fused_lstm
    from robo_vln_tpu_torch.run import run_exp
    from robo_vln_tpu_torch.training import featurize
    from robo_vln_tpu_torch.training.hierarchical_trainer import HierarchicalTrainer

    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    print(f"phase 9 ({card_line() if cuda else 'no card'}): training from cached trunk "
          "features (DAGGER.PRELOAD_TRUNK_FEATURES) at full width, bfloat16, B=4, tbptt 50")
    os.makedirs(_build.BUILD_DIR.parent, exist_ok=True)  # in the checkout, ignored by git
    root = tempfile.mkdtemp(prefix="features_", dir=_build.BUILD_DIR.parent)
    try:
        (episodes_writer or write_trainer_buffers)(root)
        train_dir, eval_dir = os.path.join(root, "train"), os.path.join(root, "eval")
        opts = ["DEVICE", str(device), "TRAINER_NAME", "hierarchical_trainer",
                "DAGGER.BATCH_SIZE", 4, "DAGGER.tbptt_steps", 50,
                "DAGGER.EPISODE_LEN_BUCKETS", [100], "DAGGER.EPOCHS", 1,
                "DAGGER.PRELOAD_LMDB_FEATURES", True, "DAGGER.PRELOAD_TRUNK_FEATURES", True,
                "DAGGER.LMDB_FEATURES_DIR", train_dir, "DAGGER.LMDB_EVAL_DIR", eval_dir,
                "CHECKPOINT_FOLDER", os.path.join(root, "ckpts"),
                "TENSORBOARD_DIR", os.path.join(root, "tb"),
                "LOG_FILE", os.path.join(root, "train.log"),
                "MODEL.INSTRUCTION_ENCODER.is_bert", True,
                "TPU.SYNC_FROZEN_TRUNKS_ON_INIT", True, "TPU.PRECISION", "bfloat16",
                *model_opts]
        cfg = get_config(opts=opts)
        trainer = HierarchicalTrainer(cfg)
        trainer._setup_policy()
        feat = {"trunk_calls": 0, "written": []}
        with counted_featurize(feat):
            sync()
            t0 = time.perf_counter()
            train_feat, eval_feat = trainer._featurized_dirs()
            sync()
            feat_s = time.perf_counter() - t0
            first = dict(feat, written=list(feat["written"]))
            frames = sum(w["frames"] for w in first["written"])
            overflow = sum(w["out_of_f16_range"] for w in first["written"])
            raw_mib = (dir_bytes(train_dir) + dir_bytes(eval_dir)) / 2**20
            feat_mib = (dir_bytes(train_feat) + dir_bytes(eval_feat)) / 2**20
            print(f"  9a: featurized {sum(w['episodes'] for w in first['written'])} episodes, "
                  f"{frames} frames ({first['trunk_calls']} trunk calls of "
                  f"{featurize.CHUNK} frames) in {feat_s:.3f} s: {frames / feat_s:.1f} frames/s, "
                  f"BERT rows included; on disk {raw_mib:.1f} MiB raw, {feat_mib:.1f} MiB "
                  f"featurized; {overflow} feature values outside float16's range")
            if overflow:
                fail(f"9a: {overflow} trunk outputs lie outside float16's range")
            trainer._featurized_dirs()
            if feat["trunk_calls"] != first["trunk_calls"] or len(feat["written"]) != 2:
                fail("9a: a second call over the same buffers ran the trunks again")
            with TrajectoryStore(train_dir) as store:
                n_train = len(store)
            (grow or grow_buffer)(train_dir, n_train)
            trainer._featurized_dirs()
            appended = feat["written"][2:]
            with open(os.path.join(train_feat, featurize.META)) as f:
                meta = json.load(f)
            print(f"  9a: a second call reused both caches (no trunk call); one more raw "
                  f"episode: the third call featurized {[w['episodes'] for w in appended]} "
                  f"episode(s), the cache now {meta['episodes']}")
            if [w["episodes"] for w in appended] != [1] or meta["episodes"] != n_train + 1:
                fail(f"9a: the grown buffer's call featurized {appended}, meta {meta}")
            # the first batch's losses from features against those from the
            # raw frames, in the val step (no dropout)
            losses, first_window = {}, {}
            for kind, path in (("raw", train_dir), ("features", train_feat)):
                batch = next(iter(trainer._batches(path, seed=0)))
                first_window[kind] = next(split_tbptt(batch, cfg.DAGGER.tbptt_steps))
                window = {k: torch.from_numpy(np.asarray(v)).to(device)
                          for k, v in first_window[kind].items()}
                if kind == "features" and "rgb" in window:
                    fail("9a: a feature batch carries raw rgb")
                hh, lh = trainer._initial_hidden()
                losses[kind] = [v.item() for k, v in trainer.val_step(hh, lh, window)[2].items()
                                if k.endswith("_loss") and k != "low_level_total_loss"]
            worst = max(abs(f - r) - FEATURE_LOSS_RTOL * abs(r)
                        for f, r in zip(losses["features"], losses["raw"]))
            print(f"  9a: first batch's (high, velocity, stop) losses from features "
                  f"{losses['features']} against raw frames {losses['raw']} (tolerance rtol "
                  f"{FEATURE_LOSS_RTOL}, atol {FEATURE_LOSS_ATOL}: float16 storage)")
            if not worst <= FEATURE_LOSS_ATOL:
                fail("9a: the losses from features disagree with the losses from raw frames")
            del trainer

            # 9b: one epoch through run_exp from the features
            record = new_trainer_record()
            if cuda:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            fused_lstm.reset_launches()
            fused_attention.reset_launches()
            calls = feat["trunk_calls"]
            with instrumented_trainer(record) if cuda else contextlib.nullcontext():
                t0 = time.perf_counter()
                run_exp(None, "train", opts)
                run_s = time.perf_counter() - t0
            launches = path_launches()
            if feat["trunk_calls"] != calls:
                fail("9b: the feature-mode run ran the trunks")
        if cuda:
            steps, events = record["train_ms"], record["train_event_ms"]
            peak = torch.cuda.max_memory_allocated() / 2**30
            print(f"  9b: run_exp from features (one epoch, its validation): {run_s:.2f} s; "
                  f"{len(steps)} train steps, host ms: " + " ".join(f"{t:.3f}" for t in steps))
            print(f"  9b: steps 2-4 median {statistics.median(steps[1:4]):.3f} ms host, "
                  f"{statistics.median(events[1:4]):.3f} ms CUDA events; epoch "
                  f"{record['epoch_ms'][0]:.1f} ms; val window median "
                  f"{statistics.median(record['val_ms']):.3f} ms; peak device memory "
                  f"{peak:.3f} GiB; launches {launches}")
            if raw:
                print(f"  9b: phase 6's raw run in this process: steps 2-4 median "
                      f"{raw['step_ms']:.3f} ms host, {raw['step_event_ms']:.3f} ms CUDA events; "
                      f"epoch {raw['epoch_ms']:.1f} ms; val window median {raw['val_ms']:.3f} ms; "
                      f"peak {raw['peak_gib']:.3f} GiB")
        with open(os.path.join(root, "tb", "metrics.jsonl")) as f:
            logged = [json.loads(line) for line in f]
        if not all(math.isfinite(m["value"]) for m in logged if "Loss" in m["tag"]):
            fail("9b: a logged loss is not finite")
        n_train = sum(m["tag"] == "Train High Level Action Loss" for m in logged)
        n_val = sum(m["tag"] == "Val High Level Loss" for m in logged)
        if cuda and (n_train, n_val) != (6, 2):
            fail(f"9b: {n_train} train steps and {n_val} val windows, expected 6 and 2 "
                 f"({TRAINER_EPISODES + 1} and {TRAINER_EVAL_EPISODES} episodes of 2 windows)")
        forward = 2 * (n_train + n_val)
        want = {"lstm_seq": forward, "lstm_seq_backward": 2 * n_train,
                "lstm_seq_backward_dg_exchange": 0, "cross_modal_attn": forward,
                "cross_modal_attn_bf16_round_p": forward, "cross_modal_attn_bf16_split_p": 0}
        if launches != want:
            fail(f"9b: the feature-mode run launched {launches}, expected {want}: 2 of each "
                 "forward a train step and a val window, 2 of the backward a train step")

        if profile:
            high, low, step, state = make_train(cfg, torch.bfloat16, device)
            window = {k: torch.from_numpy(np.asarray(v)).to(device)
                      for k, v in first_window["features"].items()}
            b = window["not_done_masks"].shape[0]
            hh, lh = high.initial_hidden(b, device), low.initial_hidden(b, device)
            for _ in range(2):
                step(state, hh, lh, window, 1e-4, 1e-4)
            profile_section(f"bf16 feature-mode train step B={b}",
                            lambda: step(state, hh, lh, window, 1e-4, 1e-4), top=16,
                            ranges=("hier_train_step.forward", "hier_train_step.backward",
                                    "lstm_seq.backward", "cross_modal_attn.backward_replay",
                                    "hier_train_step.optimizer"))
            del high, low, step, state

        # 9c: a float32 feature-mode step against the plain versions
        print("  9c: a float32 feature-mode train step (lr 0) against the same step with "
              "every kernel swapped for its plain version")
        high, low, step, state = make_train(cfg, torch.float32, device)
        window = {k: torch.from_numpy(np.asarray(v)).to(device)
                  for k, v in first_window["features"].items()}
        b = window["not_done_masks"].shape[0]
        hh, lh = high.initial_hidden(b, device), low.initial_hidden(b, device)
        params = [(f"{level}.{n}", p) for level, pol in (("high", high), ("low", low))
                  for n, p in pol.named_parameters()]
        runs = {}
        for label, scope in (("kernels", contextlib.nullcontext), ("plain", plain_kernels)):
            before = path_launches()
            with scope():
                _, _, _, metrics = step(state, hh, lh, window, 0.0, 0.0)
            after = path_launches()
            took = {k: after[k] - before[k] for k in after if after[k] != before[k]}
            want = {"lstm_seq": 2, "lstm_seq_backward": 2, "cross_modal_attn": 2} \
                if label == "kernels" else {}
            if took != want:
                fail(f"9c: the float32 feature-mode step ({label}) launched {took}, "
                     f"expected {want}")
            runs[label] = metrics, {n: p.grad.clone() for n, p in params if p.grad is not None}
        hold_step_to_plain("9c, kernels", *runs["kernels"], *runs["plain"])
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)

@contextlib.contextmanager
def instrumented_ondevice(record):
    """Keep, from outside, each on-device Rollout the eval makes, the host
    time of each batch's run, of the whole driver, and the episodes' stats;
    the rollout's graph launches are read by the kernels line's names."""
    from robo_vln_tpu_torch.eval import evaluator, ondevice

    saved = (ondevice.Rollout.__init__, ondevice.Rollout.run, ondevice.kernel_launches,
             evaluator._eval_on_device, evaluator._aggregate_and_log)

    def init(self, *args, **kwargs):
        saved[0](self, *args, **kwargs)
        record["rollouts"].append(self)

    def run(self, *args, **kwargs):
        t0 = time.perf_counter()
        out = (record["run"] or saved[1])(self, *args, **kwargs)
        record["run_ms"].append((time.perf_counter() - t0) * 1e3)
        return out

    def driver(*args, **kwargs):
        t0 = time.perf_counter()
        out = saved[3](*args, **kwargs)
        record["driver_s"].append(time.perf_counter() - t0)
        return out

    def aggregate(stats_episodes, *args, **kwargs):
        record["episodes"] = dict(stats_episodes)
        return saved[4](stats_episodes, *args, **kwargs)

    (ondevice.Rollout.__init__, ondevice.Rollout.run, ondevice.kernel_launches,
     evaluator._eval_on_device, evaluator._aggregate_and_log) = (init, run, path_launches,
                                                                  driver, aggregate)
    try:
        yield
    finally:
        (ondevice.Rollout.__init__, ondevice.Rollout.run, ondevice.kernel_launches,
         evaluator._eval_on_device, evaluator._aggregate_and_log) = saved


def stepped_against_plain(outputs):
    """A Rollout.run for 10c: each tick stepped eagerly from the same carry
    once with the kernels and once with the plain versions, the run advanced
    on the kernels' carry; each tick's actions (prev) and both levels' LSTM
    states of both are kept in ``outputs``."""
    from robo_vln_tpu_torch.ops import fused_lstm

    def run(self, graph=None):
        self.reset()
        with fused_lstm.private_workspace(self.workspace):
            while bool(self.state["running"]):
                start = self.snapshot()
                self.tick()
                kernels = self.snapshot()
                self.restore(start)
                with plain_kernels():
                    self.tick()
                plain = self.snapshot()
                self.restore(kernels)
                outputs.append([[s["prev"].cpu().numpy(), torch.cat(s["hidden"]).cpu().numpy()]
                                for s in (kernels, plain)])
        result = self.fetch()
        self.batches.append({"replays": 0, "syncs": 0, "events": [], "graph": False,
                             "ticks": result["n_ticks"]})
        return result
    return run


def ondevice_path(device, host=None, model_opts=(), episodes_writer=None, profile=False):
    """Phase 10: python -m robo_vln_tpu_torch.run --run-type eval with
    EVAL.ON_DEVICE at full width: phase 7's episodes and kind of checkpoint,
    the rollout on the card as a CUDA graph of GRAPH_TICKS ticks (10a); the
    same batch through the same tick stepped eagerly (10b); float32 ticks
    stepped with the kernels and with the plain versions from the same
    carries (10c).  ``host``: phase 7's summary, to print its rate beside.
    ``model_opts`` and ``episodes_writer`` shrink it for a CPU rehearsal;
    ``profile`` traces one more run of the batch's graph.  Returns the
    launches of 10a's replays (a graph's times its replays)."""
    import shutil
    import tempfile

    import numpy as np

    from robo_vln_tpu_torch.config import get_config
    from robo_vln_tpu_torch.eval import ondevice
    from robo_vln_tpu_torch.ops import _build, fused_attention, fused_lstm
    from robo_vln_tpu_torch.run import run_exp
    from robo_vln_tpu_torch.training.hierarchical_trainer import HierarchicalTrainer

    cuda = torch.device(device).type == "cuda"
    K = ondevice.GRAPH_TICKS
    print(f"phase 10 ({card_line() if cuda else 'no card'}): the on-device eval "
          f"(EVAL.ON_DEVICE) at full width, bfloat16: python -m robo_vln_tpu_torch.run "
          f"--run-type eval's run_exp over {EVAL_EPISODES} synthetic episodes, "
          f"ON_DEVICE_BATCH {ONDEVICE_BATCH}, MAX_EPISODE_STEPS {EVAL_MAX_STEPS}, a CUDA graph "
          f"of K = {K} ticks")
    os.makedirs(_build.BUILD_DIR.parent, exist_ok=True)  # in the checkout, ignored by git
    root = tempfile.mkdtemp(prefix="ondevice_", dir=_build.BUILD_DIR.parent)
    try:
        data = os.path.join(root, "episodes.json.gz")
        (episodes_writer or write_eval_episodes)(data, EVAL_EPISODES)

        def opts(tag, precision="bfloat16", episodes=EVAL_EPISODES, batch=ONDEVICE_BATCH,
                 seed=()):
            return ["DEVICE", str(device), "TRAINER_NAME", "hierarchical_trainer", *seed,
                    "CHECKPOINT_FOLDER", os.path.join(root, "ckpts"),
                    "EVAL_CKPT_PATH_DIR", os.path.join(root, "ckpts", "ckpt.0"),
                    "TENSORBOARD_DIR", os.path.join(root, f"tb_{tag}"),
                    "LOG_FILE", os.path.join(root, "eval.log"),
                    "TASK_CONFIG.SIMULATOR.TYPE", "kinematic",
                    "TASK_CONFIG.DATASET.DATA_PATH", data,
                    "TASK_CONFIG.TASK.NDTW.GT_PATH", os.path.join(root, "no_gt.json.gz"),
                    "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", EVAL_MAX_STEPS,
                    "EVAL.EPISODE_COUNT", episodes, "EVAL.ON_DEVICE", True,
                    "EVAL.ON_DEVICE_BATCH", batch,
                    "EVAL.VAL_LOG_DIR", os.path.join(root, f"val_{tag}"),
                    "EVAL.DUMP_TRAJECTORIES", True,
                    "MODEL.INSTRUCTION_ENCODER.is_bert", True,
                    "TPU.SYNC_FROZEN_TRUNKS_ON_INIT", True, "TPU.PRECISION", precision,
                    *model_opts]

        # phase 7's checkpoint: random weights from seed 0, the velocity head
        # biased so that the agent drives
        saver = HierarchicalTrainer(get_config(opts=opts("save", seed=("TASK_CONFIG.SEED", 0))))
        saver._setup_policy()
        with torch.no_grad():
            saver.low.linear.weight.mul_(EVAL_VELOCITY_SCALE)
            saver.low.linear.bias.add_(torch.tensor(EVAL_VELOCITY_BIAS, device=device))
        saver.save_checkpoint("ckpt.0")
        del saver

        # 10a
        record = {"rollouts": [], "run_ms": [], "driver_s": [], "episodes": {}, "run": None}
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        fused_lstm.reset_launches()
        fused_attention.reset_launches()
        t0 = time.perf_counter()
        with instrumented_ondevice(record):
            run_exp(None, "eval", opts("bf16"))
        run_s = time.perf_counter() - t0
        counted = path_launches()  # the warm-up ticks and the capture's
        stats = check_eval_stats("10a", record, os.path.join(
            root, "val_bf16", "stats_ckpt_0_val_seen.json"), EVAL_EPISODES)
        if set(stats) - {"pretrained_backbones"} != set(ONDEVICE_STATS_KEYS):
            fail(f"10a: the stats json has keys {sorted(stats)}, not the host driver's")
        for ep, st in record["episodes"].items():
            if not all(math.isfinite(v) for v in st.values()):
                fail(f"10a: episode {ep} has a non-finite stat: {st}")
        rollout = record["rollouts"][0]
        batches = rollout.batches
        steps = sum(st["steps_taken"] for st in record["episodes"].values())
        ticks = [b["ticks"] for b in batches]
        replays = sum(b["replays"] for b in batches)
        syncs = [b["syncs"] for b in batches]
        driver_s = record["driver_s"][0]
        runs_s = sum(record["run_ms"]) / 1e3
        capture_s = (rollout.capture_ms or 0.0) / 1e3
        print(f"  10a: {len(record['episodes'])} episodes in {len(batches)} batch(es), "
              f"{int(steps)} env steps; ticks per batch {ticks}; driver {driver_s:.3f} s "
              f"(BERT, the runs and the host's measures; capture included): "
              f"{steps / driver_s:.2f} env steps/s, {len(record['episodes']) / driver_s:.3f} "
              f"episodes/s; the runs less the capture {runs_s - capture_s:.3f} s: "
              f"{steps / (runs_s - capture_s):.2f} env steps/s ({run_s:.2f} s run_exp)")
        if host:
            print(f"  10a: phase 7's host driver at NUM_ENVS 8 in this process: "
                  f"{host['rates'][8]:.2f} env steps/s")
        limit = -(-EVAL_MAX_STEPS // K) + 1
        print(f"  10a: host syncs per batch {syncs} (at most ceil({EVAL_MAX_STEPS}/{K}) + 1 = "
              f"{limit}: one flag a replay, one read of the results)")
        if any(n > limit for n in syncs):
            fail(f"10a: a batch synced with the host {syncs} times, more than {limit}")
        for i, (b, result_ticks) in enumerate(zip(batches, ticks)):
            if b["replays"] != -(-result_ticks // K) and b["graph"]:
                fail(f"10a: batch {i} replayed {b['replays']} times for {result_ticks} ticks")
        ondevice_launches = {name: 0 for name in counted}
        if cuda:
            tick_ms = sum(s.elapsed_time(e) for b in batches for s, e in b["events"]) / (
                replays * K)
            per_tick = {k: v / K for k, v in rollout.graph_launches.items()}
            ondevice_launches = {k: v * replays for k, v in rollout.graph_launches.items()}
            print(f"  10a: capture {rollout.capture_ms:.1f} ms, after {ondevice.WARMUP_TICKS} "
                  f"eager warm-up tick(s) in {rollout.warmup_ms:.1f} ms; {replays} replays of {K} ticks, {tick_ms:.3f} ms a tick "
                  f"by CUDA events around the replays; launches a tick in the graph {per_tick}; "
                  f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
            want = {name: 2 if name in ("lstm_seq", "cross_modal_attn",
                                        "cross_modal_attn_bf16_round_p") else 0
                    for name in per_tick}
            if per_tick != want:
                fail(f"10a: the graph launches {per_tick} a tick, expected {want}")
            if counted != {k: v * (K + ondevice.WARMUP_TICKS) // K
                           for k, v in rollout.graph_launches.items()}:
                fail(f"10a: the wrappers counted {counted} outside the warm-up and the capture")
        elif counted["lstm_seq"] != 2 * sum(ticks) or counted["cross_modal_attn"] != \
                2 * sum(ticks):
            fail(f"10a: eager ticks launched {counted} over {sum(ticks)} ticks")
        if not stats["path_length"] > 1.0:
            fail(f"10a: the agent drove {stats['path_length']:.3f} m an episode")
        print("    stats: " + ", ".join(f"{k} {stats[k]:.6f}" for k in EVAL_STATS))

        # 10b: the last batch again, replayed and then stepped eagerly
        t0 = time.perf_counter()
        graph_result = rollout.run()
        rerun_s = time.perf_counter() - t0
        live = int(graph_result["steps"].sum())
        print(f"  10b: the last batch again, its graph captured: {rerun_s * 1e3:.1f} ms host "
              f"(load excluded): {live / rerun_s:.2f} env steps/s of the episodes' own steps, "
              f"{ONDEVICE_BATCH * graph_result['n_ticks'] / rerun_s:.2f} counting every row of "
              f"every tick")
        after = rollout.snapshot()
        if cuda:
            rollout.graph.replay()  # ticks past the end: exact no-ops
        else:
            rollout._ticks()
        extra = rollout.snapshot()
        moved = [k for k in after if not all(map(torch.equal, *(
            s[k] if k == "hidden" else (s[k],) for s in (after, extra))))]
        eager_result = rollout.run(graph=False)
        gap = float(np.abs(graph_result["positions"] - eager_result["positions"]).max())
        same_steps = np.array_equal(graph_result["steps"], eager_result["steps"])
        print(f"  10b: the batch replayed as a graph against stepped eagerly: positions "
              f"{'bitwise equal' if gap == 0 else f'differ by up to {gap:.3e} m'} "
              f"(tolerance {ONDEVICE_TRACE_TOL} m), steps {'equal' if same_steps else 'differ'};"
              f" n_ticks {graph_result['n_ticks']} = max(steps) "
              f"{int(graph_result['steps'].max())}; a replay past the end changed "
              f"{moved or 'nothing'}")
        if not (gap <= ONDEVICE_TRACE_TOL and same_steps):
            fail("10b: the graph's rollout differs from the eager one")
        if graph_result["n_ticks"] != int(graph_result["steps"].max()):
            fail("10b: n_ticks is not max(steps)")
        if moved:
            fail(f"10b: ticks past the end changed {moved}")
        if profile:
            profile_section("the on-device batch, its graph replayed", rollout.run, top=12)
        del rollout, record

        # 10c: float32 ticks, the kernels against the plain versions from the
        # same carries
        outputs = []
        record = {"rollouts": [], "run_ms": [], "driver_s": [], "episodes": {},
                  "run": stepped_against_plain(outputs)}
        before = path_launches()
        with instrumented_ondevice(record):
            run_exp(None, "eval", opts("f32", "float32", ONDEVICE_F32_EPISODES,
                                       ONDEVICE_F32_EPISODES))
        after = path_launches()
        k_prev, p_prev = (np.stack([o[i][0] for o in outputs]) for i in range(2))
        k_hc, p_hc = (np.stack([o[i][1] for o in outputs]) for i in range(2))
        half = p_hc.shape[1] // 2
        worst = 0.0
        for name, (k, p) in (("lin_vel", (k_prev[..., 0], p_prev[..., 0])),
                             ("omega", (k_prev[..., 1], p_prev[..., 1])),
                             ("high level's LSTM state", (k_hc[:, :half], p_hc[:, :half])),
                             ("low level's LSTM state", (k_hc[:, half:], p_hc[:, half:]))):
            err, span = np.abs(k - p).max(), np.ptp(p)
            rel = err / max(span, np.finfo(np.float32).tiny)
            worst = max(worst, rel)
            print(f"  10c: {len(outputs)} float32 ticks of {ONDEVICE_F32_EPISODES} episodes, "
                  f"each from the kernels' carry, {name}: largest difference {err:.3e} over a "
                  f"range of {span:.3e} ({rel:.3e} of it; tolerance {ONDEVICE_OUTPUT_RTOL})")
        launched = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        if launched.get("lstm_seq") != 2 * len(outputs) or \
                launched.get("cross_modal_attn") != 2 * len(outputs):
            fail(f"10c: the kernels' ticks launched {launched} over {len(outputs)} ticks")
        if not worst <= ONDEVICE_OUTPUT_RTOL:
            fail(f"10c: the kernels' ticks differ from the plain versions' by {worst:.3e} of "
                 "their range")
        return ondevice_launches
    finally:
        shutil.rmtree(root, ignore_errors=True)

FLAT_MODELS = (("cma_robo.yaml", 2), ("seq2seq_robo.yaml", 1))  # (yaml, LSTM calls a forward)
FLAT_VOCAB = 2504  # the GloVe vocabulary of the flat yamls
FLAT_TRAIN_STEPS = 3  # 11b, bf16 steps a model
FLAT_EPISODES = (4, 2)  # 11c: train and eval episodes, one window of tbptt 100 each
INSTRUCTION_TOL = 1e-5  # float32: the instruction RNN packed (cuDNN) against the scan
# 11b: the float32 step's losses, and the leaf whose exact gradient is 0 (a
# bias of the text keys adds the same q·b to every logit of a row, which the
# softmax cancels), held against the same projection's weight gradient
FLAT_LOSS_KEYS = ("action_loss", "stop_loss", "aux_loss", "total_loss")
FLAT_ZERO_GRAD_LEAF = "text_k.bias"


def flat_config(yaml, device, model_opts=(), extra=()):
    """The port's copy of a flat yaml, as shipped but for ``DEVICE`` and the
    options given."""
    from robo_vln_tpu_torch.config import get_config
    from robo_vln_tpu_torch.config.default import _CONFIGS

    return get_config(os.path.join(_CONFIGS, yaml),
                      ["DEVICE", str(device), *model_opts, *extra])


def flat_batch(gen, cfg, device):
    """One TBPTT window of the flat trainer at the config's shapes: B =
    DAGGER.BATCH_SIZE, T = tbptt_steps, instructions of 60-200 GloVe ids then
    pads, progress, corrected actions and stop targets drawn from ``gen``."""
    sim, d = cfg.TASK_CONFIG.SIMULATOR, cfg.DAGGER
    B, T, L = d.BATCH_SIZE, d.tbptt_steps, d.MAX_INSTRUCTION_LEN
    vocab = cfg.MODEL.INSTRUCTION_ENCODER.vocab_size
    ids = torch.randint(1, vocab, (B, L), generator=gen)
    for b in range(B):
        ids[b, int(torch.randint(min(60, L), L + 1, (1,), generator=gen)):] = 0
    masks = torch.ones(B, T)
    masks[:, 0] = 0.0
    batch = {
        "rgb": torch.randint(0, 256, (B, T, sim.RGB_SENSOR.HEIGHT, sim.RGB_SENSOR.WIDTH, 3),
                             generator=gen, dtype=torch.uint8),
        "depth": torch.rand(B, T, sim.DEPTH_SENSOR.HEIGHT, sim.DEPTH_SENSOR.WIDTH, 1,
                            generator=gen).half(),
        "instruction": ids, "progress": torch.rand(B, T, generator=gen),
        "prev_actions": torch.zeros(B, T, 2),
        "corrected_actions": torch.rand(B, T, 2, generator=gen),
        "oracle_stop": (torch.rand(B, T, 1, generator=gen) > 0.7).float(),
        "not_done_masks": masks, "valid_mask": torch.ones(B, T),
    }
    return {k: v.to(device) for k, v in batch.items()}


def check_flat_lstm(gen, device):
    """11a: the LSTM kernel and its backward (the partials route) at the flat
    window's shape, T=100, B=1, H=512 (one row, one launch each), held to
    their plain versions at 3a's tolerances and timed beside the plain
    versions, cuDNN and the bound."""
    from robo_vln_tpu_torch.ops import fused_lstm
    from robo_vln_tpu_torch.ops.rnn import lstm_recurrence
    from robo_vln_tpu_torch.utils.device import float32_exact

    T, B, H = 100, 1, 512
    print(f"phase 11a: lstm_seq and its backward at the flat window's shape T={T} B={B} "
          f"H={H}, float32, against their plain versions")
    with float32_exact(torch.float32):
        args = lstm_inputs(gen, T, B, H, device)
        before = fused_lstm.launches
        got = fused_lstm.lstm_seq_cuda(*args)
        launched = fused_lstm.launches - before
        ref = lstm_recurrence(*args)
        torch.cuda.synchronize()
        err = max((g - r).abs().max().item() for g, r in zip(got, ref))
        print(f"  forward: max_abs_err {err:.3e} (tolerance {LSTM_TOL}), {launched} launch(es)")
        if launched != 1 or not err <= LSTM_TOL:
            fail(f"lstm_seq at T={T} B={B} H={H}: {launched} launches, error {err:.3e}")
        cots = lstm_cotangents(gen, T, B, H, device)
        b_abs, b_rel, b_launched, _ = check_lstm_backward(f"T={T} B={B} H={H}", args, got[0],
                                                          cots, False)
        if b_launched != 1:
            fail(f"lstm_seq backward at T={T} B={B} H={H} took {b_launched} launches")
        call = lambda: fused_lstm.lstm_seq_cuda(*args)
        fwd = report_times("forward kernel", time_ms(call))
        plain = report_times("forward plain", time_ms(lambda: lstm_recurrence(*args), inner=2))
        lstm = torch.nn.LSTM(384, H).to(device)  # CMA's first encoder: rgb 256 + depth 128
        x = torch.randn(T, B, 384, generator=gen).to(device)
        hc = (args[2][None], args[3][None])
        library = report_times("library nn.LSTM (cuDNN, input 384, masks all 1)",
                               time_ms(lambda: lstm(x, hc)))
        bwd = time_lstm_backward(gen, args, got[0], cots, lstm, x, hc)
    by_bytes, by_ops = lstm_bound_ms(T, B, H)
    (b_bytes, b_ops), _ = lstm_backward_bound_ms(T, B, H)
    print(f"  bound: forward bytes {by_bytes:.4f} ms, operations {by_ops:.4f} ms; backward "
          f"bytes {b_bytes:.4f} ms, operations {b_ops:.4f} ms")
    work = f"one call at T={T}, B={B}, H={H}, float32 (CMA makes two a window, Seq2Seq one)"
    forward = {"flat_max_abs_err": err, "flat_ms": fwd, "flat_plain_ms": plain,
               "flat_bound_ms": max(by_bytes, by_ops),
               "flat_bound_by": "bytes" if by_bytes > by_ops else "operations",
               "flat_library_ms": library, "flat_work": work}
    backward = {"flat_max_abs_err": b_abs, "flat_max_rel_err": b_rel,
                "flat_ms": bwd["partials_ms"], "flat_kernel_only_ms": bwd["partials_kernel_ms"],
                "flat_plain_ms": bwd["bwd_plain_ms"], "flat_replay_ms": bwd["bwd_replay_ms"],
                "flat_bound_ms": max(b_bytes, b_ops),
                "flat_bound_by": "bytes" if b_bytes > b_ops else "operations",
                "flat_library_ms": bwd["bwd_library_ms"],
                "flat_work": work + ", no mask gradient"}
    return forward, backward


def _synchronize(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _events(device):
    if torch.device(device).type != "cuda":
        return None
    return [torch.cuda.Event(enable_timing=True) for _ in range(2)]


def _elapsed(events):
    if events is None:
        return float("nan")
    events[1].synchronize()
    return events[0].elapsed_time(events[1])


def flat_model_path(device, yaml, calls, model_opts=(), label="11b"):
    """11b (12c for the RCM encoder): one flat model at full width, with
    ``model_opts`` (``label`` names the phase): a window's forward and
    FLAT_TRAIN_STEPS train steps in bf16 (launches, times, peak memory), then
    a float32 step against the same step with the plain versions."""
    from robo_vln_tpu_torch.models import build_flat_policy
    from robo_vln_tpu_torch.ops import fused_attention, fused_lstm
    from robo_vln_tpu_torch.training import TrainState, adam, make_flat_train_step
    from robo_vln_tpu_torch.training import trainable_mask
    from robo_vln_tpu_torch.utils.device import resolve_dtype

    cfg = flat_config(yaml, device, model_opts)
    pm = cfg.MODEL.PROGRESS_MONITOR
    sim, lr = cfg.TASK_CONFIG.SIMULATOR, cfg.DAGGER.LR
    cuda = torch.device(device).type == "cuda"

    def build(dtype):
        policy = build_flat_policy(cfg.MODEL, compute_dtype=dtype,
                                   generator=torch.Generator().manual_seed(0),
                                   rgb_hw=(sim.RGB_SENSOR.HEIGHT, sim.RGB_SENSOR.WIDTH))
        policy = policy.to(device)
        state = TrainState(adam(policy), 0)
        step = make_flat_train_step(policy, use_progress=pm.use, progress_alpha=pm.alpha)
        return policy, state, step

    policy, state, step = build(resolve_dtype(cfg.TPU.PRECISION))
    name = type(policy).__name__
    batch = flat_batch(torch.Generator().manual_seed(5), cfg, device)
    B, T = batch["not_done_masks"].shape
    print(f"phase {label} ({yaml}): {name} at full width ({sim.RGB_SENSOR.WIDTH} px rgb, "
          f"{sim.DEPTH_SENSOR.WIDTH} px depth, {batch['instruction'].shape[1]} tokens of a "
          f"{cfg.MODEL.INSTRUCTION_ENCODER.vocab_size} vocabulary, LSTM("
          f"{cfg.MODEL.STATE_ENCODER.hidden_size}), B={B} T={T}), {cfg.TPU.PRECISION}")
    obs = {k: v for k, v in batch.items() if k in ("rgb", "depth", "instruction")}
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    window_ms = []
    with torch.no_grad():
        for rep in range(3):
            fused_lstm.reset_launches()
            fused_attention.reset_launches()
            ev = _events(device)
            if ev:
                ev[0].record()
            actions, stop, _, _ = policy(obs, policy.initial_hidden(B, device), None,
                                         batch["not_done_masks"])
            if ev:
                ev[1].record()
            window_ms.append(_elapsed(ev))
            check_finite(f"{name} window", actions, stop)
    window = path_launches()
    print(f"  window forward: " + " ".join(f"{t:.3f}" for t in window_ms) + " ms by CUDA "
          f"events; launches {window}")
    if window["lstm_seq"] != calls or window["cross_modal_attn"] != 0:
        fail(f"{name}'s window launched {window}, expected {calls} lstm_seq and no attention")

    mask = trainable_mask(policy)
    before = {n: p.detach().clone() for n, p in policy.named_parameters()}
    hidden = policy.initial_hidden(B, device)
    step_ms, host_ms = [], []
    launches = dict.fromkeys(window, 0)
    for k in range(FLAT_TRAIN_STEPS):
        fused_lstm.reset_launches()
        fused_attention.reset_launches()
        ev = _events(device)
        t0 = time.perf_counter()
        if ev:
            ev[0].record()
        state, hidden, metrics = step(state, hidden, batch, lr)
        if ev:
            ev[1].record()
        step_ms.append(_elapsed(ev))
        _synchronize(device)
        host_ms.append((time.perf_counter() - t0) * 1e3)
        got = path_launches()
        for key, n in got.items():
            launches[key] += n
        check_finite(f"{name} train step {k}", *metrics.values())
        if (got["lstm_seq"], got["lstm_seq_backward"], got["cross_modal_attn"]) != (
                calls, calls, 0):
            fail(f"{name}'s train step {k} launched {got}; expected {calls} forward and "
                 f"{calls} backward LSTM launches, no attention")
    peak = torch.cuda.max_memory_allocated() / 2**30 if cuda else float("nan")
    print(f"  train step (Adam, lr {lr}): CUDA events " + " ".join(f"{t:.3f}" for t in step_ms)
          + " ms, host " + " ".join(f"{t:.3f}" for t in host_ms) + f" ms; losses "
          f"{ {k: round(v.item(), 5) for k, v in metrics.items()} }; peak {peak:.3f} GiB")
    moved = frozen = unused = 0
    for n, p in policy.named_parameters():
        if not mask[n]:
            frozen += 1
            if not torch.equal(p, before[n]):
                fail(f"{name}'s frozen parameter {n} moved")
        elif p.grad is None:
            unused += 1
            if not n.startswith(("progress_monitor.", "sub_goal_linear.")) or \
                    not torch.equal(p, before[n]):
                fail(f"{name}'s trainable parameter {n} got no gradient")
        else:
            moved += 1
    print(f"  {frozen} frozen parameters unchanged, {moved} trainable ones given a gradient, "
          f"{unused} unused heads without one")
    del policy, state, step, before

    print(f"phase {label} ({yaml}): float32 train step (lr 0) against the same step with the "
          f"plain versions (the LSTM's backward the autograd replay)")
    policy, state, step = build(torch.float32)
    if cuda:
        check_instruction_rnn(policy, batch["instruction"])
    hidden = policy.initial_hidden(B, device)
    params = list(policy.named_parameters())
    runs = {}
    for label, scope in (("kernels", contextlib.nullcontext), ("plain", plain_kernels)):
        lstm_before = fused_lstm.launches, fused_lstm.backward_launches
        with scope():
            _, _, metrics = step(state, hidden, batch, 0.0)
        took = (fused_lstm.launches - lstm_before[0],
                fused_lstm.backward_launches - lstm_before[1])
        if took != ((calls, calls) if label == "kernels" else (0, 0)) and cuda:
            fail(f"the float32 {name} step ({label}) launched (lstm_seq, backward) {took}")
        runs[label] = metrics, {n: p.grad.clone() for n, p in params if p.grad is not None}
    hold_step_to_plain(f"float32 {name} step, kernels", *runs["kernels"], *runs["plain"],
                       loss_keys=FLAT_LOSS_KEYS, zero_leaf=FLAT_ZERO_GRAD_LEAF)
    return {"window_launches": window, "train_launches": launches,
            "window_ms": statistics.median(window_ms[1:]),
            "step_ms": statistics.median(step_ms[1:]),
            "step_host_ms": statistics.median(host_ms[1:]), "peak_gib": peak}


def check_instruction_rnn(policy, ids):
    """The instruction RNN's path on the card (run_rnn: cuDNN over a packed
    sequence) against the length-masked scans, float32 with TF32 off:
    outputs and final state within INSTRUCTION_TOL; both timed forward."""
    from robo_vln_tpu_torch.models.encoders import instruction
    from robo_vln_tpu_torch.utils.device import float32_exact

    enc = policy.instruction_encoder
    with float32_exact(torch.float32), torch.no_grad():
        x = enc.embedding_layer(ids.long())
        lengths = instruction.token_lengths(ids)
        got = instruction.run_rnn(enc.encoder_rnn, x, lengths)
        want = instruction.run_scan(enc.encoder_rnn, x, lengths)
        err = max((g - w).abs().max().item() for g, w in zip(got[:2], want[:2]))
        print(f"  the instruction RNN (bidirectional {enc.encoder_rnn.bidirectional}) on the "
              f"card, packed (cuDNN) against the scan: max_abs_err {err:.3e} (tolerance "
              f"{INSTRUCTION_TOL})")
        if not err <= INSTRUCTION_TOL:
            fail("the packed instruction RNN disagrees with the scan")
        report_times("instruction RNN forward, packed (cuDNN)", time_ms(
            lambda: instruction.run_rnn(enc.encoder_rnn, x, lengths), inner=2))
        report_times("instruction RNN forward, the scan", time_ms(
            lambda: instruction.run_scan(enc.encoder_rnn, x, lengths), reps=3, inner=1))


def flat_trainer_and_eval(device, root, model_opts=(), labels=("11c", "11d"), tag="flat",
                          calls=2):
    """11c and 11d (12c for the RCM encoder): run_exp train on cma_robo.yaml
    with ``model_opts`` over synthetic buffers under ``root``, one epoch and
    its checkpoint, then that checkpoint's eval on the host driver at
    NUM_ENVS 8 and with EVAL.ON_DEVICE, the graph held to the same batch
    stepped eagerly; ``calls`` LSTM launches a forward.  Returns (launches
    of each path, keyed ``<tag>_trainer``, ``<tag>_eval`` and
    ``<tag>_ondevice``, and timings)."""
    import numpy as np

    from robo_vln_tpu_torch.eval import agent as agent_mod
    from robo_vln_tpu_torch.eval import evaluator
    from robo_vln_tpu_torch.ops import fused_attention, fused_lstm
    from robo_vln_tpu_torch.run import run_exp
    from robo_vln_tpu_torch.training import checkpoint as ckpt_lib
    from robo_vln_tpu_torch.training.trainer import RoboVLNTrainer

    cuda = torch.device(device).type == "cuda"
    paths, timings = {}, {}
    n_train, n_eval = FLAT_EPISODES
    sim = flat_config("cma_robo.yaml", device, model_opts).TASK_CONFIG.SIMULATOR
    size = write_trainer_buffers(root, FLAT_EPISODES, vocab=FLAT_VOCAB,
                                 rgb_px=sim.RGB_SENSOR.WIDTH, depth_px=sim.DEPTH_SENSOR.WIDTH)
    common = ["TENSORBOARD_DIR", os.path.join(root, "tb"),
              "LOG_FILE", os.path.join(root, "flat.log"),
              "CHECKPOINT_FOLDER", os.path.join(root, "ckpts"), *model_opts]
    train_opts = ["DEVICE", str(device), "DAGGER.EPOCHS", 1,
                  "DAGGER.LMDB_FEATURES_DIR", os.path.join(root, "train"),
                  "DAGGER.LMDB_EVAL_DIR", os.path.join(root, "eval"), *common]
    print(f"phase {labels[0]}: python -m robo_vln_tpu_torch.run --run-type train's run_exp on "
          f"cma_robo.yaml as shipped (B=1, tbptt 100, Adam lr 1e-4), EPOCHS cut from 25 "
          f"to 1, over {n_train} train and {n_eval} eval synthetic episodes of 60-100 "
          f"steps ({size / 2**20:.1f} MiB)")
    record = {"steps": [], "vals": []}
    saved = RoboVLNTrainer._setup_policy

    def setup(self, *args, **kwargs):
        saved(self, *args, **kwargs)
        for kind in ("train_step", "val_step"):
            fn = getattr(self, kind)

            def timed(*a, _fn=fn, _kind=kind, **kw):
                fused_lstm.reset_launches()
                fused_attention.reset_launches()
                t0 = time.perf_counter()
                out = _fn(*a, **kw)
                _synchronize(device)
                record["steps" if _kind == "train_step" else "vals"].append(
                    ((time.perf_counter() - t0) * 1e3, path_launches()))
                return out

            setattr(self, kind, timed)

    RoboVLNTrainer._setup_policy = setup
    try:
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        run_exp(os.path.join(_config_dir(), "cma_robo.yaml"), "train", train_opts)
        run_s = time.perf_counter() - t0
    finally:
        RoboVLNTrainer._setup_policy = saved
    (ckpt,) = ckpt_lib.list_checkpoints(os.path.join(root, "ckpts"))
    trainer_launches = dict.fromkeys(path_launches(), 0)
    for kind, want_bwd in (("steps", calls), ("vals", 0)):
        for ms, got in record[kind]:
            for key, n in got.items():
                trainer_launches[key] += n
            if (got["lstm_seq"], got["lstm_seq_backward"], got["cross_modal_attn"]) != (
                    calls, want_bwd, 0):
                fail(f"the CMA trainer's {kind[:-1]} launched {got}")
    if (len(record["steps"]), len(record["vals"])) != (n_train, n_eval):
        fail(f"the CMA trainer took {len(record['steps'])} steps and "
             f"{len(record['vals'])} val windows, expected {n_train} and {n_eval}")
    logged = [json.loads(line) for line in open(os.path.join(root, "tb", "metrics.jsonl"))]
    if not all(math.isfinite(m["value"]) for m in logged):
        fail("the CMA trainer logged a non-finite loss")
    peak = torch.cuda.max_memory_allocated() / 2**30 if cuda else float("nan")
    steps_ms = [ms for ms, _ in record["steps"]]
    print(f"  run {run_s:.2f} s, {os.path.basename(ckpt)}; train steps (host clock to "
          f"the device's end) " + " ".join(f"{t:.2f}" for t in steps_ms) + " ms, val "
          "windows " + " ".join(f"{ms:.2f}" for ms, _ in record["vals"]) + f" ms; peak "
          f"{peak:.3f} GiB; {len(logged)} logged values, all finite")
    paths[f"{tag}_trainer"] = trainer_launches
    timings["trainer_step_ms"] = statistics.median(steps_ms[1:])

    # the checkpoint's velocity head biased so that the agent drives
    state_file = os.path.join(ckpt, ckpt_lib.TRAIN_STATE)
    saved_state = torch.load(state_file, map_location="cpu", weights_only=True)
    saved_state["state_dict"]["linear.bias"] += torch.tensor(EVAL_VELOCITY_BIAS)
    torch.save(saved_state, state_file)
    data = os.path.join(root, "episodes.json.gz")
    write_eval_episodes(data, EVAL_EPISODES, vocab=FLAT_VOCAB)

    def eval_opts(run, *extra):
        return ["DEVICE", str(device), "EVAL_CKPT_PATH_DIR", ckpt,
                "TASK_CONFIG.SIMULATOR.TYPE", "kinematic",
                "TASK_CONFIG.DATASET.DATA_PATH", data,
                "TASK_CONFIG.TASK.NDTW.GT_PATH", os.path.join(root, "no_gt.json.gz"),
                "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", EVAL_MAX_STEPS,
                "EVAL.SPLIT", "train", "EVAL.EPISODE_COUNT", EVAL_EPISODES,
                "EVAL.NUM_ENVS", 8, "EVAL.VAL_LOG_DIR", os.path.join(root, f"val_{run}"),
                *common, *extra]

    print(f"phase {labels[1]}: run_exp --run-type eval on cma_robo.yaml: {os.path.basename(ckpt)} "
          f"(its lin_vel bias {EVAL_VELOCITY_BIAS[0]} so that the agent drives) over "
          f"{EVAL_EPISODES} synthetic episodes, MAX_EPISODE_STEPS {EVAL_MAX_STEPS}, "
          f"NUM_ENVS 8 on the host driver, then EVAL.ON_DEVICE")
    ticks = []
    act = agent_mod.FlatAgent.act

    def timed_act(self, *args, **kwargs):
        fused_lstm.reset_launches()
        fused_attention.reset_launches()
        ev = _events(device)
        if ev:
            ev[0].record()
        out = act(self, *args, **kwargs)
        if ev:
            ev[1].record()
        ticks.append((ev, path_launches()))
        return out

    rollout_s = []
    run_rollout = evaluator._run_rollout

    def timed_rollout(*args, **kwargs):
        t0 = time.perf_counter()
        out = run_rollout(*args, **kwargs)
        rollout_s.append(time.perf_counter() - t0)
        return out

    agent_mod.FlatAgent.act, evaluator._run_rollout = timed_act, timed_rollout
    try:
        run_exp(os.path.join(_config_dir(), "cma_robo.yaml"), "eval", eval_opts("host"))
    finally:
        agent_mod.FlatAgent.act, evaluator._run_rollout = act, run_rollout
    host_s = rollout_s[0]
    host_stats = json.load(open(os.path.join(root, "val_host", "stats_ckpt_0_train.json")))
    eval_launches = dict.fromkeys(path_launches(), 0)
    for _, got in ticks:
        for key, n in got.items():
            eval_launches[key] += n
        if (got["lstm_seq"], got["cross_modal_attn"]) != (calls, 0):
            fail(f"a flat eval tick launched {got}")
    tick_ms = [_elapsed(ev) for ev, _ in ticks]
    for key in EVAL_STATS:
        if not math.isfinite(host_stats.get(key, float("nan"))):
            fail(f"flat eval: {key} is {host_stats.get(key)}")
    env_steps = host_stats["steps_taken"] * EVAL_EPISODES
    print(f"  host driver: {len(ticks)} ticks of 8 envs, {env_steps:.0f} env steps in "
          f"{host_s:.2f} s of rollout ({env_steps / host_s:.2f} env steps/s); policy "
          f"median {statistics.median(tick_ms):.3f} ms by CUDA events around "
          f"FlatAgent.act; stats "
          f"{ {k: round(host_stats[k], 4) for k in EVAL_STATS} }")
    if host_stats["path_length"] < 1.0:
        fail("the flat agent did not drive in the host eval")
    paths[f"{tag}_eval"] = eval_launches
    timings["eval_tick_ms"] = statistics.median(tick_ms)
    timings["eval_env_steps_per_s"] = env_steps / host_s

    od = {"rollouts": [], "run": None, "run_ms": [], "driver_s": [], "episodes": None}
    with instrumented_ondevice(od):
        run_exp(os.path.join(_config_dir(), "cma_robo.yaml"), "eval", eval_opts(
            "device", "EVAL.ON_DEVICE", True, "EVAL.ON_DEVICE_BATCH", ONDEVICE_BATCH))
    dev_stats = json.load(open(os.path.join(root, "val_device", "stats_ckpt_0_train.json")))
    (rollout,) = od["rollouts"]
    if set(dev_stats) != set(host_stats):
        fail(f"on-device stats keys {sorted(dev_stats)} against the host's {sorted(host_stats)}")
    for ep, st in od["episodes"].items():
        if not all(math.isfinite(st[k]) for k in ONDEVICE_STATS_KEYS):
            fail(f"on-device episode {ep}: non-finite stats {st}")
    # the graph's launches, counted at its capture (none on the CPU, whose
    # ticks run eagerly)
    per_tick = {k: n / rollout.graph_ticks for k, n in rollout.graph_launches.items()}
    if cuda and (per_tick["lstm_seq"], per_tick["cross_modal_attn"]) != (calls, 0):
        fail(f"the flat on-device graph launched {rollout.graph_launches} a graph of "
             f"{rollout.graph_ticks} ticks")
    batch = rollout.batches[-1]
    replays = sum(b["replays"] for b in rollout.batches)
    ondevice_launches = {k: rollout.graph_launches.get(k, 0) * replays
                         for k in path_launches()}
    graph_tick = [e[0].elapsed_time(e[1]) / rollout.graph_ticks for e in batch["events"]] \
        if cuda else [float("nan")]
    dev_steps = sum(st["steps_taken"] for st in od["episodes"].values())
    set_up_ms = (rollout.capture_ms or 0.0) + (rollout.warmup_ms or 0.0)
    run_s = (sum(od["run_ms"]) - set_up_ms) / 1e3
    print(f"  on-device: {batch['ticks']} ticks, {replays} replays of {rollout.graph_ticks} "
          f"ticks, {batch['syncs']} host syncs; the graph's tick "
          f"{statistics.median(graph_tick):.3f} ms by CUDA events; warm-up "
          f"{rollout.warmup_ms} ms, capture {rollout.capture_ms} ms; {dev_steps:.0f} env "
          f"steps in {run_s:.3f} s of the run less them ({dev_steps / run_s:.2f} env "
          f"steps/s); launches a tick in the graph {per_tick}; stats "
          f"{ {k: round(dev_stats[k], 4) for k in EVAL_STATS} }")
    # the same batch stepped eagerly must retrace the graph's run
    graph_result = rollout.fetch()
    eager = rollout.run(graph=False)
    gap = float(np.abs(eager["positions"] - graph_result["positions"]).max())
    print(f"  the batch stepped eagerly: positions within {gap:.3e} m of the graph's "
          f"(tolerance {ONDEVICE_TRACE_TOL}), steps equal: "
          f"{np.array_equal(eager['steps'], graph_result['steps'])}")
    if not (gap <= ONDEVICE_TRACE_TOL and np.array_equal(eager["steps"],
                                                          graph_result["steps"])):
        fail("the flat on-device graph and the same batch stepped eagerly disagree")
    paths[f"{tag}_ondevice"] = ondevice_launches
    timings["ondevice_tick_ms"] = statistics.median(graph_tick)
    timings["ondevice_env_steps_per_s"] = dev_steps / run_s
    return paths, timings


def flat_path(device, model_opts=()):
    """Phase 11: the flat family at full width on the card: 11a the LSTM at
    its shape; 11b the CMA and Seq2Seq windows and train steps; 11c run_exp
    train with cma_robo.yaml over synthetic buffers, one epoch and its
    checkpoint; 11d that checkpoint's eval on the host driver at NUM_ENVS 8
    and with EVAL.ON_DEVICE, the graph held to the same batch stepped
    eagerly.  Returns (launches of each flat path by the kernels line's
    names, the LSTM's 11a fields (forward, backward), timings)."""
    import shutil
    import tempfile

    from robo_vln_tpu_torch.ops import _build

    cuda = torch.device(device).type == "cuda"
    lstm_fields = (check_flat_lstm(torch.Generator().manual_seed(11), device) if cuda
                   else ({}, {}))
    paths, timings = {}, {}
    for yaml, calls in FLAT_MODELS:
        got = flat_model_path(device, yaml, calls, model_opts)
        tag = yaml.split("_")[0]
        paths[f"flat_{tag}_window"] = got.pop("window_launches")
        paths[f"flat_{tag}_train"] = got.pop("train_launches")
        timings[tag] = got

    os.makedirs(_build.BUILD_DIR.parent, exist_ok=True)  # in the checkout, ignored by git
    root = tempfile.mkdtemp(prefix="flat_", dir=_build.BUILD_DIR.parent)
    try:
        run_paths, run_timings = flat_trainer_and_eval(device, root, model_opts)
        paths.update(run_paths)
        timings.update(run_timings)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for name, counts in paths.items():
        if (counts["lstm_seq"] == 0 and (cuda or name != "flat_ondevice")) or \
                any(counts[k] for k in counts if "attn" in k):
            fail(f"the flat path {name} launched {counts}: the LSTM never, or attention")
    print(f"phase 11 launches by path: {paths}")
    print(f"phase 11 timings: {json.dumps(timings)}")
    return paths, lstm_fields, timings


EXTRAS_EPISODES = 4  # 12a: the first 4 of phase 7's episodes, one env
NONLEARNING_AGENTS = ("RandomAgent", "HandcraftedAgent", "ExpertAgent")
HL_SEQ2SEQ_SHAPE = (4, 50)  # 12e: B, T of the window


@contextlib.contextmanager
def timed_viz(record):
    """Host time of what the eval's extras draw and write, from outside:
    each frame's assembly (observations_to_image and the instruction
    overlay), each video's encoding and write, each heatmap's PNG; and the
    frames each video got."""
    from robo_vln_tpu_torch.tasks import viz

    originals = {name: getattr(viz, name) for name in (
        "observations_to_image", "append_text_to_image", "generate_video",
        "save_attention_plot")}

    def timed(name):
        fn = originals[name]

        def call(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            record[name].append((time.perf_counter() - t0) * 1e3)
            if name == "generate_video":
                frames = args[2]
                record["videos"].append((str(args[3]), len(frames), frames[0].shape))
            if name == "save_attention_plot":
                record["pngs"].append(out)
            return out
        return call

    for name in originals:
        setattr(viz, name, timed(name))
    try:
        yield
    finally:
        for name, fn in originals.items():
            setattr(viz, name, fn)


def read_video(path):
    """(frame count, frame shape) of an mp4, read back through OpenCV."""
    import cv2

    cap = cv2.VideoCapture(path)
    n, shape = 0, None
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        n, shape = n + 1, frame.shape
    cap.release()
    return n, shape


def read_png(path):
    """An 8-bit RGB PNG as tasks/viz.write_png writes it (one IDAT, filter
    0 rows), as (H, W, 3) RGB, without OpenCV."""
    import struct
    import zlib

    import numpy as np

    data = open(path, "rb").read()
    w, h = struct.unpack(">II", data[16:24])
    pos, idat = 8, b""
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        if data[pos + 4:pos + 8] == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    if rows[:, 0].any():
        fail(f"{path}: a PNG row with a filter other than 0")
    return rows[:, 1:].reshape(h, w, 3)


def extras_eval(device, root, model_opts, has_cv2):
    """12a: the HCM eval at NUM_ENVS 1 with PLOT_ATTENTION (and, with
    OpenCV, VIDEO_OPTION disk and the TOP_DOWN_MAP measure) over the first
    EXTRAS_EPISODES of phase 7's episodes, a checkpoint made as phase 7
    makes its; the same episodes with the key off; then both in float32,
    their positions held within EVAL_POSITION_TOL and the key-on run's
    ticks replayed with the key off.  Returns (launches with the key on and
    off, timings, the host eval's stats keys)."""
    import numpy as np

    from robo_vln_tpu_torch.config import get_config
    from robo_vln_tpu_torch.eval import agent as agent_mod
    from robo_vln_tpu_torch.eval import evaluator
    from robo_vln_tpu_torch.ops import cm_attention, fused_attention, fused_lstm
    from robo_vln_tpu_torch.run import run_exp
    from robo_vln_tpu_torch.training.hierarchical_trainer import HierarchicalTrainer

    cuda = torch.device(device).type == "cuda"
    data = os.path.join(root, "episodes.json.gz")
    write_eval_episodes(data, EVAL_EPISODES)
    ckpts = os.path.join(root, "ckpts")
    measures = ["DISTANCE_TO_GOAL", "SUCCESS", "SPL", "PATH_LENGTH", "NAVIGATION_ERROR",
                "STEPS_TAKEN"]

    def opts(tag, precision="bfloat16", plot=False, video=False, seed=()):
        extra = ["VIDEO_OPTION", ["disk"], "TASK_CONFIG.TASK.MEASUREMENTS",
                 measures + ["TOP_DOWN_MAP"]] if video else []
        return ["DEVICE", str(device), "TRAINER_NAME", "hierarchical_trainer", *seed,
                "CHECKPOINT_FOLDER", ckpts, "EVAL_CKPT_PATH_DIR", ckpts,
                "TENSORBOARD_DIR", os.path.join(root, f"tb_{tag}"),
                "LOG_FILE", os.path.join(root, "eval.log"),
                "TASK_CONFIG.SIMULATOR.TYPE", "kinematic", "TASK_CONFIG.DATASET.DATA_PATH", data,
                "TASK_CONFIG.TASK.NDTW.GT_PATH", os.path.join(root, "no_gt.json.gz"),
                "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", EVAL_MAX_STEPS,
                "EVAL.EPISODE_COUNT", EXTRAS_EPISODES, "EVAL.NUM_ENVS", 1,
                "EVAL.USE_CKPT_CONFIG", False,
                "EVAL.VAL_LOG_DIR", os.path.join(root, f"val_{tag}"),
                "EVAL.DUMP_TRAJECTORIES", True, "MODEL.INSTRUCTION_ENCODER.is_bert", True,
                "TPU.SYNC_FROZEN_TRUNKS_ON_INIT", True, "TPU.PRECISION", precision,
                "PLOT_ATTENTION", plot, "VIDEO_DIR", os.path.join(root, f"videos_{tag}"),
                *extra, *model_opts]

    saver = HierarchicalTrainer(get_config(opts=opts("save", seed=("TASK_CONFIG.SEED", 0))))
    saver._setup_policy()
    with torch.no_grad():
        saver.low.linear.weight.mul_(EVAL_VELOCITY_SCALE)
        saver.low.linear.bias.add_(torch.tensor(EVAL_VELOCITY_BIAS, device=device))
    saver.save_checkpoint("ckpt.0")
    del saver
    tokens = get_config(opts=opts("save")).DAGGER.MAX_INSTRUCTION_LEN
    what = "PLOT_ATTENTION" + (", VIDEO_OPTION disk and TOP_DOWN_MAP" if has_cv2 else "")
    print(f"phase 12a: run_exp --run-type eval at EVAL.NUM_ENVS 1, bfloat16, {what}: phase "
          f"7's checkpoint (random weights from seed 0, the velocity head biased "
          f"{EVAL_VELOCITY_BIAS}) over the first {EXTRAS_EPISODES} of its episodes, "
          f"MAX_EPISODE_STEPS {EVAL_MAX_STEPS}; then the key off; then both in float32")
    forward = ("lstm_seq", "cross_modal_attn", "cross_modal_attn_bf16_round_p")
    runs, launches, timings = {}, {}, {}
    for tag, plot in (("on", True), ("off", False)):
        record, drawn = new_eval_record(), {k: [] for k in (
            "observations_to_image", "append_text_to_image", "generate_video",
            "save_attention_plot", "videos", "pngs")}
        fused_lstm.reset_launches()
        fused_attention.reset_launches()
        with instrumented_eval(record, device), timed_viz(drawn):
            run_exp(None, "eval", opts(tag, plot=plot, video=plot and has_cv2))
        launches[tag] = path_launches()
        stats = check_eval_stats(f"12a key {tag}", record, os.path.join(
            root, f"val_{tag}", "stats_ckpt_0_val_seen.json"), EXTRAS_EPISODES)
        want = {"lstm_seq": 2, "cross_modal_attn": 2}
        want["cross_modal_attn_bf16_round_p"] = want["cross_modal_attn"]
        for t, got in enumerate(record["tick_launches"]):
            for name, count in got.items():
                if count != want.get(name, 0):
                    fail(f"12a key {tag}: tick {t} launched {name} {count} times, expected "
                         f"{want.get(name, 0)}")
        rollout_s = record["rollout_s"][0]
        policy_ms = ([s.elapsed_time(e) for s, e in record["act_events"]] if cuda
                     else [float("nan")])
        rate = record["env_steps"] / rollout_s
        ticks = {ep: int(st["steps_taken"]) for ep, st in record["episodes"].items()}
        print(f"  PLOT_ATTENTION {plot}: {len(record['tick_launches'])} ticks, "
              f"{record['env_steps']} env steps in {rollout_s:.3f} s of rollout: {rate:.2f} env "
              f"steps/s; policy {statistics.median(policy_ms):.3f} ms a tick by CUDA events "
              f"around act; env step {statistics.median(record['env_ms']):.3f} ms host; "
              f"launches a tick {want}; ticks by episode {ticks}")
        timings[f"eval_{tag}_env_steps_per_s"] = rate
        timings[f"eval_{tag}_policy_ms"] = statistics.median(policy_ms)
        if plot:
            pngs = sorted(drawn["pngs"])
            want_names = sorted(os.path.join(root, f"videos_{tag}", "attention",
                                             f"attention_ep{ep}_ckpt0.png") for ep in ticks)
            if pngs != want_names:
                fail(f"12a: heatmaps {pngs}, expected {want_names}")
            for path in pngs:
                ep = path.rsplit("attention_ep", 1)[1].split("_ckpt")[0]
                scale = max(1, 256 // max(ticks[ep], tokens))
                shape = read_png(path).shape
                if shape != (ticks[ep] * scale, tokens * scale, 3):
                    fail(f"12a: {path} is {shape}, not episode {ep}'s {ticks[ep]} ticks by "
                         f"{tokens} tokens")
            png_ms = drawn["save_attention_plot"]
            print(f"  {len(pngs)} heatmaps, one an episode, each (ticks x {tokens} tokens) "
                  f"scaled: PNG {statistics.median(png_ms):.3f} ms each (host)")
            timings["png_ms"] = statistics.median(png_ms)
        if plot and has_cv2:
            frames = len(drawn["observations_to_image"])
            if [v[1] for v in sorted(drawn["videos"])] != [ticks[ep] for ep in sorted(ticks)]:
                fail(f"12a: videos {drawn['videos']}, expected a frame a tick {ticks}")
            mp4s = sorted(glob.glob(os.path.join(root, f"videos_{tag}", "*.mp4")))
            if len(mp4s) != EXTRAS_EPISODES:
                fail(f"12a: {len(mp4s)} mp4 files, expected {EXTRAS_EPISODES}")
            for ep, n, (h, w, _) in drawn["videos"]:
                (path,) = [p for p in mp4s if os.path.basename(p).startswith(f"episode={ep}-")]
                back = read_video(path)
                if back != (n, (h - h % 2, w - w % 2, 3)):  # mp4v keeps even sides
                    fail(f"12a: {path} reads back as {back}, written {n} frames of {h}x{w}")
            draw_ms = [a + b for a, b in zip(drawn["observations_to_image"],
                                             drawn["append_text_to_image"])]
            write_ms = sum(drawn["generate_video"]) / frames
            print(f"  {len(mp4s)} videos, {frames} frames of {drawn['videos'][0][2]} (rgb, "
                  f"depth, the map tile; the instruction below), each read back with its "
                  f"frame count and size: assembly {statistics.median(draw_ms):.3f} ms a frame, "
                  f"encode and write {write_ms:.3f} ms a frame (host)")
            timings["frame_draw_ms"] = statistics.median(draw_ms)
            timings["frame_write_ms"] = write_ms
        runs[tag] = stats
        record["trainers"].clear()
    if cm_attention.sow_attention():
        fail("12a: the eval left the sow switch on")

    print("phase 12a: float32, the key on against the key off (the sow must leave the "
          "outputs alone), closed-loop, then the key-on run's ticks replayed with the key off")
    rows, records = {}, {}
    for tag, plot in (("f32_on", True), ("f32_off", False)):
        record = records[tag] = new_eval_record()
        record["states"] = []
        with instrumented_eval(record, device):
            run_exp(None, "eval", opts(tag, "float32", plot=plot))
        rows[tag] = trajectories(os.path.join(root, f"tb_{tag}"))
    on, off = rows["f32_on"], rows["f32_off"]
    if on.keys() != off.keys() or len(on) != EXTRAS_EPISODES:
        fail(f"12a float32: episodes {sorted(on)} with the key on, {sorted(off)} off")
    divergence = 0.0
    for ep in on:
        n = min(len(on[ep]["locations"]), len(off[ep]["locations"]))
        divergence = max(divergence, max(math.dist(a, b) for a, b in zip(
            on[ep]["locations"][:n], off[ep]["locations"][:n])))
        if any(on[ep][k] != off[ep][k] for k in ("success", "actual_success", "steps")):
            fail(f"12a float32: episode {ep} ends otherwise with the key on")
    print(f"  largest position gap over {len(on)} episodes {divergence:.3e} m (tolerance "
          f"{EVAL_POSITION_TOL} m)")
    if not divergence <= EVAL_POSITION_TOL:
        fail(f"12a float32: positions with the key on diverge by {divergence:.3e} m")
    trainer = records["f32_on"]["trainers"][0]
    agent = agent_mod.HCMAgent(trainer.high, trainer.low,
                               share_frozen_trunks=trainer.config.TPU.SHARE_FROZEN_TRUNKS)
    replay = evaluator._PolicyTick(agent)
    state, outs, states = agent.initial_state(1), [], []
    for obs, reset_rows in records["f32_on"]["ticks"]:
        out, state = replay(obs, state, reset_rows)
        outs.append(out)
        states.append(torch.cat(state).float().cpu().numpy())
    k_out, p_out = np.stack(records["f32_on"]["outputs"]), np.stack(outs)
    k_hc, p_hc = np.stack(records["f32_on"]["states"]), np.stack(states)
    worst = 0.0
    for name, (a, b) in zip(("lin_vel", "omega", "stop logit", "LSTM states"), [
            (k_out[..., i], p_out[..., i]) for i in range(3)] + [(k_hc, p_hc)]):
        rel = np.abs(a - b).max() / max(np.ptp(b), np.finfo(np.float32).tiny)
        worst = max(worst, rel)
        print(f"  the key-on ticks replayed with the key off, {name}: {rel:.3e} of its range "
              f"(tolerance {EVAL_OUTPUT_RTOL})")
    if not worst <= EVAL_OUTPUT_RTOL:
        fail(f"12a float32: the ticks with the key on differ by {worst:.3e} of their range")
    return launches, timings, set(runs["off"])


def nonlearning_runs(device, root, host_keys):
    """12b: nonlearning.yaml through run_exp --run-type eval, each agent
    over phase 7's synthetic episodes on the kinematic backend at the
    task's sensor sizes: the stats JSON and its keys (the host eval's, less
    actual_success and the backbones' provenance, as in JAX), env steps a
    second; no kernel launches."""
    from robo_vln_tpu_torch.ops import fused_attention, fused_lstm
    from robo_vln_tpu_torch.run import run_exp

    data = os.path.join(root, "episodes.json.gz")
    want = set(host_keys) - {"actual_success", "pretrained_backbones"}
    print(f"phase 12b: nonlearning.yaml through run_exp --run-type eval: "
          f"{', '.join(NONLEARNING_AGENTS)} over {EVAL_EPISODES} synthetic episodes, "
          f"MAX_EPISODE_STEPS {EVAL_MAX_STEPS}, on the host")
    rates = {}
    fused_lstm.reset_launches()
    fused_attention.reset_launches()
    for agent in NONLEARNING_AGENTS:
        out = os.path.join(root, f"nonlearning_{agent}")
        t0 = time.perf_counter()
        run_exp(os.path.join(_config_dir(), "nonlearning.yaml"), "eval", [
            "EVAL.NONLEARNING.AGENT", agent, "EVAL.EPISODE_COUNT", EVAL_EPISODES,
            "EVAL.VAL_LOG_DIR", out, "LOG_FILE", os.path.join(root, "nonlearning.log"),
            "TASK_CONFIG.SIMULATOR.TYPE", "kinematic", "TASK_CONFIG.DATASET.DATA_PATH", data,
            "TASK_CONFIG.TASK.NDTW.GT_PATH", os.path.join(root, "no_gt.json.gz"),
            "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", EVAL_MAX_STEPS])
        run_s = time.perf_counter() - t0
        path = os.path.join(out, f"stats_complete_{agent}_val_unseen.json")
        if not os.path.exists(path):
            fail(f"12b: {agent} wrote no {path}")
        stats = json.load(open(path))
        if set(stats) != want or not all(math.isfinite(v) for v in stats.values()):
            fail(f"12b: {agent}'s stats {stats}, expected the keys {sorted(want)}")
        env_steps = stats["steps_taken"] * EVAL_EPISODES
        rates[agent] = env_steps / run_s
        print(f"  {agent}: {env_steps:.0f} env steps in {run_s:.3f} s of run_exp: "
              f"{rates[agent]:.2f} env steps/s; stats "
              f"{ {k: round(stats[k], 4) for k in ('ndtw', 'success', 'spl', 'path_length')} }")
    launches = path_launches()
    if any(launches.values()):
        fail(f"12b: the nonlearning agents launched {launches}")
    return rates


def flat_feature_run(device, root, model_opts, raw_step_ms):
    """12d: run_exp train on cma_robo.yaml with DAGGER.PRELOAD_TRUNK_FEATURES
    over 11c's episodes: frames a second featurized, the feature-mode step
    beside 11c's raw one (``raw_step_ms``), no trunk run in training; then
    the first eval batch's float32 val losses from features against those
    from raw frames at phase 9's tolerance.  Returns (launches, timings)."""
    import numpy as np

    from robo_vln_tpu_torch.config import get_config
    from robo_vln_tpu_torch.data.loader import split_tbptt
    from robo_vln_tpu_torch.ops import fused_attention, fused_lstm
    from robo_vln_tpu_torch.run import run_exp
    from robo_vln_tpu_torch.training import featurize
    from robo_vln_tpu_torch.training.trainer import RoboVLNTrainer

    cuda = torch.device(device).type == "cuda"
    sim = flat_config("cma_robo.yaml", device, model_opts).TASK_CONFIG.SIMULATOR
    write_trainer_buffers(root, FLAT_EPISODES, vocab=FLAT_VOCAB,
                          rgb_px=sim.RGB_SENSOR.WIDTH, depth_px=sim.DEPTH_SENSOR.WIDTH)
    train_dir, eval_dir = os.path.join(root, "train"), os.path.join(root, "eval")
    opts = ["DEVICE", str(device), "DAGGER.EPOCHS", 1, "DAGGER.PRELOAD_TRUNK_FEATURES", True,
            "DAGGER.LMDB_FEATURES_DIR", train_dir, "DAGGER.LMDB_EVAL_DIR", eval_dir,
            "TENSORBOARD_DIR", os.path.join(root, "tb"), "LOG_FILE", os.path.join(root, "f.log"),
            "CHECKPOINT_FOLDER", os.path.join(root, "ckpts"), *model_opts]
    print(f"phase 12d: run_exp --run-type train on cma_robo.yaml with "
          f"DAGGER.PRELOAD_TRUNK_FEATURES over 11c's {sum(FLAT_EPISODES)} synthetic episodes, "
          f"bfloat16, one epoch")
    record = {"steps": [], "vals": [], "featurize_s": []}
    feat = {"trunk_calls": 0, "written": []}
    saved_setup, saved_dirs = RoboVLNTrainer._setup_policy, RoboVLNTrainer._featurized_dirs

    def setup(self, *args, **kwargs):
        saved_setup(self, *args, **kwargs)
        for kind in ("train_step", "val_step"):
            fn = getattr(self, kind)

            def timed(*a, _fn=fn, _kind=kind, **kw):
                fused_lstm.reset_launches()
                fused_attention.reset_launches()
                calls, t0 = feat["trunk_calls"], time.perf_counter()
                out = _fn(*a, **kw)
                _synchronize(device)
                if feat["trunk_calls"] != calls:
                    fail("12d: a feature-mode step ran the trunks")
                record["steps" if _kind == "train_step" else "vals"].append(
                    ((time.perf_counter() - t0) * 1e3, path_launches()))
                return out

            setattr(self, kind, timed)

    def featurized(self):
        _synchronize(device)
        t0 = time.perf_counter()
        out = saved_dirs(self)
        _synchronize(device)
        record["featurize_s"].append(time.perf_counter() - t0)
        return out

    RoboVLNTrainer._setup_policy, RoboVLNTrainer._featurized_dirs = setup, featurized
    try:
        with counted_featurize(feat):
            run_exp(os.path.join(_config_dir(), "cma_robo.yaml"), "train", opts)
    finally:
        RoboVLNTrainer._setup_policy, RoboVLNTrainer._featurized_dirs = saved_setup, saved_dirs
    frames = sum(w["frames"] for w in feat["written"])
    overflow = sum(w["out_of_f16_range"] for w in feat["written"])
    (feat_s,) = record["featurize_s"]
    launches = dict.fromkeys(path_launches(), 0)
    for kind, want_bwd in (("steps", 2), ("vals", 0)):
        for _, got in record[kind]:
            for key, n in got.items():
                launches[key] += n
            if (got["lstm_seq"], got["lstm_seq_backward"], got["cross_modal_attn"]) != (
                    2, want_bwd, 0):
                fail(f"12d: a feature-mode {kind[:-1]} launched {got}")
    if (len(record["steps"]), len(record["vals"])) != FLAT_EPISODES or overflow:
        fail(f"12d: {len(record['steps'])} steps, {len(record['vals'])} val windows, "
             f"{overflow} float16 overflows")
    steps_ms = [ms for ms, _ in record["steps"]]
    step_ms = statistics.median(steps_ms[1:])
    print(f"  featurized {frames} frames in {feat_s:.3f} s ({frames / feat_s:.1f} frames/s; "
          f"no BERT row: the flat policies' instruction encoders train), {overflow} values "
          f"outside float16's range; feature-mode train steps (host clock to the device's "
          f"end) " + " ".join(f"{t:.2f}" for t in steps_ms) + f" ms, median of the later "
          f"{step_ms:.2f} against 11c's raw {raw_step_ms:.2f} ms")

    cfg = get_config(os.path.join(_config_dir(), "cma_robo.yaml"), opts + [
        "TPU.PRECISION", "float32"])
    trainer = RoboVLNTrainer(cfg)
    trainer._setup_policy()
    f32_dir = os.path.join(root, "eval_f32.features")
    featurize.featurize_buffer(trainer.policy, eval_dir, f32_dir,
                               max_instruction_len=cfg.DAGGER.MAX_INSTRUCTION_LEN)
    losses = {}
    for kind, path in (("raw", eval_dir), ("features", f32_dir)):
        batch = next(iter(trainer._batches(path, seed=0)))
        window = {k: torch.from_numpy(np.asarray(v)).to(device)
                  for k, v in next(split_tbptt(batch, cfg.DAGGER.tbptt_steps)).items()}
        if kind == "features" and "rgb" in window:
            fail("12d: a feature batch carries raw rgb")
        _, metrics = trainer.val_step(trainer.policy.initial_hidden(trainer.batch_size,
                                                                    device), window)
        losses[kind] = [metrics[k].item() for k in ("action_loss", "stop_loss", "total_loss")]
    worst = max(abs(f - r) - FEATURE_LOSS_RTOL * abs(r)
                for f, r in zip(losses["features"], losses["raw"]))
    print(f"  float32, the first eval batch's (action, stop, total) val losses from features "
          f"{losses['features']} against raw frames {losses['raw']} (tolerance rtol "
          f"{FEATURE_LOSS_RTOL}, atol {FEATURE_LOSS_ATOL}: float16 storage)")
    if not worst <= FEATURE_LOSS_ATOL:
        fail("12d: the val losses from features disagree with those from raw frames")
    return launches, {"featurize_frames_per_s": frames / feat_s, "feature_step_ms": step_ms,
                      "raw_step_ms": raw_step_ms}


def hl_seq2seq_path(device, model_opts=()):
    """12e: HighLevelSeq2SeqPolicy at full width (BERT-base through the
    LanguageEncoder, both trunks, LSTM(512), 4 sub-goal logits), B=4, T=50,
    200 tokens: the bf16 window by CUDA events (1 LSTM launch, no
    attention), then the float32 window against its plain-kernel twin
    within WINDOW_TOL.  Returns (launches, window ms)."""
    from robo_vln_tpu_torch.config import get_config
    from robo_vln_tpu_torch.models import init_weights
    from robo_vln_tpu_torch.models.hierarchical_seq2seq import HighLevelSeq2SeqPolicy
    from robo_vln_tpu_torch.ops import fused_attention, fused_lstm
    from robo_vln_tpu_torch.utils.device import float32_exact

    cfg = get_config(opts=["DEVICE", str(device), "MODEL.INSTRUCTION_ENCODER.is_bert", True,
                           *model_opts])
    mc, sim = cfg.MODEL, cfg.TASK_CONFIG.SIMULATOR
    B, T = HL_SEQ2SEQ_SHAPE
    L = cfg.DAGGER.MAX_INSTRUCTION_LEN
    gen = torch.Generator().manual_seed(12)
    obs = {"rgb": torch.randint(0, 256, (B, T, sim.RGB_SENSOR.HEIGHT, sim.RGB_SENSOR.WIDTH, 3),
                                generator=gen, dtype=torch.uint8),
           "depth": torch.rand(B, T, sim.DEPTH_SENSOR.HEIGHT, sim.DEPTH_SENSOR.WIDTH, 1,
                               generator=gen).half(),
           "instruction": torch.randint(1, mc.BERT.vocab_size, (B, L), generator=gen)}
    obs = {k: v.to(device) for k, v in obs.items()}
    masks = torch.ones(B, T, device=device)
    masks[:, 0] = 0.0

    def build(dtype):
        policy = HighLevelSeq2SeqPolicy(mc, compute_dtype=dtype)
        init_weights(policy, torch.Generator().manual_seed(0))
        return policy.to(device).eval()

    policy = build(torch.bfloat16)
    print(f"phase 12e: HighLevelSeq2SeqPolicy at full width (BERT {mc.BERT.num_layers} layers "
          f"of {mc.BERT.hidden_size}, both ResNet50 trunks, LSTM("
          f"{mc.STATE_ENCODER.hidden_size}), 4 sub-goal logits), B={B} T={T}, {L} tokens, "
          f"bfloat16; no build function or yaml reaches it")
    times = []
    with torch.no_grad():
        for _ in range(3):
            fused_lstm.reset_launches()
            fused_attention.reset_launches()
            ev = _events(device)
            if ev:
                ev[0].record()
            logits, hidden = policy(obs, policy.initial_hidden(B, device), None, masks)
            if ev:
                ev[1].record()
            times.append(_elapsed(ev))
            check_finite("the high-level Seq2Seq window", logits, hidden)
    launches = path_launches()
    print(f"  window " + " ".join(f"{t:.3f}" for t in times) + f" ms by CUDA events; logits "
          f"{tuple(logits.shape)}; launches {launches}")
    if launches["lstm_seq"] != 1 or launches["cross_modal_attn"] != 0 or \
            tuple(logits.shape) != (B, T, 4):
        fail(f"12e: the window launched {launches}, logits {tuple(logits.shape)}")
    del policy
    policy = build(torch.float32)
    outs = {}
    with torch.no_grad(), float32_exact(torch.float32):
        for label, scope in (("kernels", contextlib.nullcontext), ("plain", plain_kernels)):
            with scope():
                outs[label] = policy(obs, policy.initial_hidden(B, device), None, masks)
    err = max((a - b).abs().max().item() for a, b in zip(outs["kernels"], outs["plain"]))
    print(f"  float32 window, kernels against plain: logits and LSTM state max_abs_err "
          f"{err:.3e} (tolerance {WINDOW_TOL})")
    if not err <= WINDOW_TOL:
        fail("12e: the float32 window disagrees with its plain-kernel twin")
    return launches, statistics.median(times[1:])


def extras_path(device, raw_step_ms=float("nan"), model_opts=()):
    """Phase 12: the eval's extras and the flat family's last parts at full
    width: 12a the HCM eval's attention heatmaps and, with OpenCV, its
    videos and top-down map; 12b the nonlearning agents; 12c CMA with the
    RCM state encoder (window, train step, float32 step, trainer and both
    evals); 12d the flat feature store; 12e HighLevelSeq2SeqPolicy.
    ``raw_step_ms``: 11c's raw CMA step, printed beside 12d's;
    ``model_opts`` shrink it for a CPU rehearsal.  Returns (launches by path, timings)."""
    import importlib.util
    import shutil
    import tempfile

    from robo_vln_tpu_torch.config import get_config
    from robo_vln_tpu_torch.ops import _build

    cuda = torch.device(device).type == "cuda"
    has_cv2 = importlib.util.find_spec("cv2") is not None
    print(f"phase 12 ({card_line() if cuda else 'no card'}): the eval's extras, the RCM "
          f"encoder, the flat feature store and the high-level Seq2Seq")
    if has_cv2:
        import cv2

        print(f"phase 12: OpenCV {cv2.__version__} imports: the videos and the top-down map "
              f"run on this machine")
    else:
        try:
            get_config(opts=["VIDEO_OPTION", ["disk"]])
        except ImportError as e:
            print(f"phase 12: no OpenCV on this machine: get_config refuses VIDEO_OPTION before "
                  f"any work ({e}); the videos are held on the CPU only")
        else:
            fail("12: without OpenCV, get_config took VIDEO_OPTION")
    os.makedirs(_build.BUILD_DIR.parent, exist_ok=True)  # in the checkout, ignored by git
    paths, timings = {}, {}
    rcm = [*model_opts, "MODEL.CMA.rcm_state_encoder", True]
    root = tempfile.mkdtemp(prefix="extras_", dir=_build.BUILD_DIR.parent)
    try:
        launches, timings["eval"], host_keys = extras_eval(device, root, model_opts, has_cv2)
        paths["extras_eval_plot"], paths["extras_eval_plain"] = launches["on"], launches["off"]
        timings["nonlearning_env_steps_per_s"] = nonlearning_runs(device, root, host_keys)
        shutil.rmtree(root, ignore_errors=True)

        got = flat_model_path(device, "cma_robo.yaml", 1, rcm, label="12c")
        paths["rcm_window"] = got.pop("window_launches")
        paths["rcm_train"] = got.pop("train_launches")
        timings["rcm"] = got
        os.makedirs(root, exist_ok=True)
        rcm_paths, timings["rcm_run"] = flat_trainer_and_eval(
            device, root, rcm, labels=("12c", "12c"), tag="rcm", calls=1)
        paths.update(rcm_paths)
        shutil.rmtree(root, ignore_errors=True)

        os.makedirs(root, exist_ok=True)
        paths["flat_features_trainer"], timings["flat_features"] = flat_feature_run(
            device, root, model_opts, raw_step_ms)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    paths["hl_seq2seq_window"], timings["hl_seq2seq_window_ms"] = hl_seq2seq_path(
        device, model_opts)
    for name in ("rcm_window", "rcm_train", "rcm_trainer", "rcm_eval", "flat_features_trainer",
                 "hl_seq2seq_window") + (("rcm_ondevice",) if cuda else ()):
        if paths[name]["lstm_seq"] == 0 or any(
                paths[name][k] for k in paths[name] if "attn" in k):
            fail(f"12: the path {name} launched {paths[name]}: the LSTM never, or attention")
    print(f"phase 12 launches by path: {paths}")
    print(f"phase 12 timings: {json.dumps(timings)}")
    return paths, timings


LOADER_WORKERS = 4  # 13a: DAGGER.LOADER_WORKERS
MESH_RANKS = 2  # 13c: gloo ranks on the one card
MESH_BATCH = 4  # 13c: the global batch, 2 a rank
MESH_T = 50
# 13c's float32 parity: every rank draws its own masks, one process others
MESH_NO_DROPOUT = ["MODEL.VISUAL_LING_ATTN.dropout", 0.0]
MESH_BF16_STEPS = 3  # 13c: bf16 steps a rank, the first warming the process up


def trainer_opts(device, root, *extra):
    """Phase 6's run_exp options over the buffers under ``root``, one
    epoch, no resume."""
    return ["DEVICE", str(device), "TRAINER_NAME", "hierarchical_trainer",
            "DAGGER.BATCH_SIZE", 4, "DAGGER.tbptt_steps", 50,
            "DAGGER.EPISODE_LEN_BUCKETS", [100], "DAGGER.EPOCHS", 1,
            "DAGGER.PRELOAD_LMDB_FEATURES", True,
            "DAGGER.LMDB_FEATURES_DIR", os.path.join(root, "train"),
            "DAGGER.LMDB_EVAL_DIR", os.path.join(root, "eval"),
            "CHECKPOINT_FOLDER", os.path.join(root, "ckpts"),
            "TENSORBOARD_DIR", os.path.join(root, "tb"),
            "LOG_FILE", os.path.join(root, "train.log"),
            "MODEL.INSTRUCTION_ENCODER.is_bert", True,
            "TPU.SYNC_FROZEN_TRUNKS_ON_INIT", True, "TPU.PRECISION", "bfloat16", *extra]


def episode_fingerprints(batch):
    """A sha256 of every real episode of a collated batch: each entry's row,
    cut to the episode's steps (the instruction whole)."""
    import hashlib

    import numpy as np

    out = []
    valid = batch["valid_mask"]
    for i in range(valid.shape[0]):
        n = int(valid[i].sum())
        if not n:
            continue
        h = hashlib.sha256()
        for k in sorted(batch):
            row = batch[k][i] if k in ("instruction", "instruction_embedding") else batch[k][i, :n]
            h.update(k.encode())
            h.update(np.ascontiguousarray(row).tobytes())
        out.append(h.hexdigest())
    return out


@contextlib.contextmanager
def recorded_batches(fingerprints, train_dir):
    """The trainers' batches of ``train_dir``, fingerprinted as they pass."""
    from robo_vln_tpu_torch.training.trainer import BaseTrainer

    original = BaseTrainer._batches

    def batches(self, features_dir, seed):
        it = original(self, features_dir, seed)
        if features_dir != train_dir:
            return it

        def tee():
            for batch in it:
                fingerprints.extend(episode_fingerprints(batch))
                yield batch
        return tee()

    BaseTrainer._batches = batches
    try:
        yield
    finally:
        BaseTrainer._batches = original


@contextlib.contextmanager
def recorded_segments(names):
    """The names of the shared-memory segments created in the block."""
    from multiprocessing import shared_memory

    original = shared_memory.SharedMemory

    class Recording(original):
        def __init__(self, name=None, create=False, size=0, **kwargs):
            super().__init__(name=name, create=create, size=size, **kwargs)
            if create:
                names.append(self.name)

    shared_memory.SharedMemory = Recording
    try:
        yield
    finally:
        shared_memory.SharedMemory = original


@contextlib.contextmanager
def timed_sends(times):
    """The host ms of each window's copy to the card on the hierarchical
    trainer's worker thread (device_transfer's send: the pinned copy and
    its queueing) into ``times``."""
    from robo_vln_tpu_torch.training import hierarchical_trainer as ht

    original = ht.device_transfer

    def device_transfer(device):
        send, receive = original(device)

        def timed(window):
            t0 = time.perf_counter()
            out = send(window)
            times.append((time.perf_counter() - t0) * 1e3)
            return out
        return timed, receive

    ht.device_transfer = device_transfer
    try:
        yield
    finally:
        ht.device_transfer = original


@contextlib.contextmanager
def timed_reduce(times):
    """Each DataMesh.reduce_step's ms (CUDA events, host clock) into ``times``."""
    from robo_vln_tpu_torch.parallel.mesh import DataMesh

    original = DataMesh.reduce_step

    def reduce_step(self, grads, scalars):
        events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        t0 = time.perf_counter()
        events[0].record()
        out = original(self, grads, scalars)
        events[1].record()
        events[1].synchronize()
        times.append((events[0].elapsed_time(events[1]), (time.perf_counter() - t0) * 1e3))
        return out

    DataMesh.reduce_step = reduce_step
    try:
        yield
    finally:
        DataMesh.reduce_step = original


def store_and_loader(device, root, raw):
    """13a: the native store against the Python backend, their read rates,
    and a run_exp epoch through the process-parallel loader."""
    import filecmp
    import gc

    from robo_vln_tpu_torch.config import get_config
    from robo_vln_tpu_torch.data import trajectory_store as store_lib
    from robo_vln_tpu_torch.data.loader import TrajectoryDataset, batch_iterator
    from robo_vln_tpu_torch.ops import fused_attention, fused_lstm
    from robo_vln_tpu_torch.run import run_exp

    saved = os.environ.get(store_lib.BACKEND_VAR)
    for backend in ("native", "python"):
        os.environ[store_lib.BACKEND_VAR] = backend
        t0 = time.perf_counter()
        size = write_trainer_buffers(os.path.join(root, backend))
        print(f"  phase 6's buffers written through the {backend} backend: {size / 2**20:.1f} "
              f"MiB in {time.perf_counter() - t0:.2f} s")
    if saved is None:
        os.environ.pop(store_lib.BACKEND_VAR)
    else:
        os.environ[store_lib.BACKEND_VAR] = saved
    with store_lib.TrajectoryStore(os.path.join(root, "native", "train")) as store:
        if store.backend != "native":
            fail("the native trajectory store did not build (g++ missing?)")
    for split in ("train", "eval"):
        for name in ("store.dat", "store.idx"):
            if not filecmp.cmp(os.path.join(root, "native", split, name),
                               os.path.join(root, "python", split, name), shallow=False):
                fail(f"the native store's {split}/{name} differs from the Python backend's")
    print("  the native store's files equal the Python backend's, byte for byte "
          "(train and eval, store.dat and store.idx)")
    for backend in ("native", "python"):
        rates = []
        for _ in range(2):
            with store_lib.TrajectoryStore(os.path.join(root, "native", "train"),
                                           backend=backend) as store:
                t0 = time.perf_counter()
                total = sum(store.get_buffer(k).nbytes for k in range(len(store)))
                rates.append(total / 1e6 / (time.perf_counter() - t0))
        print(f"  {backend} backend reads the train buffer ({total / 2**20:.1f} MiB) at "
              + ", then ".join(f"{r:.1f}" for r in rates) + " MB/s")

    train_dir = os.path.join(root, "native", "train")
    opts = trainer_opts(device, os.path.join(root, "native"),
                        "DAGGER.LOADER_WORKERS", LOADER_WORKERS)
    dag = get_config(opts=opts).DAGGER
    want = []  # the in-process loader's episodes of epoch 0
    dataset = TrajectoryDataset(train_dir, batch_size=dag.BATCH_SIZE, is_bert=True, seed=0)
    for batch in batch_iterator(dataset, dag.BATCH_SIZE, list(dag.EPISODE_LEN_BUCKETS),
                                dag.MAX_INSTRUCTION_LEN):
        want.extend(episode_fingerprints(batch))
    record, got, segments, sends = new_trainer_record(), [], [], []
    fused_lstm.reset_launches()
    fused_attention.reset_launches()
    with instrumented_trainer(record), recorded_batches(got, train_dir), \
            recorded_segments(segments), timed_sends(sends):
        t0 = time.perf_counter()
        run_exp(None, "train", opts)
        run_ms = (time.perf_counter() - t0) * 1e3
    launches = path_launches()
    record["trainers"].clear()
    if sorted(got) != sorted(want):
        fail(f"the parallel loader's episodes ({len(got)}) are not the in-process loader's "
             f"({len(want)}) as a multiset")
    gc.collect()  # the last batch's arrays, whose finalizers free their segment
    left = [n for n in segments if os.path.exists(os.path.join("/dev/shm", n.lstrip("/")))]
    if not segments or left:
        fail(f"shared-memory segments: {len(segments)} created, left behind: {left}")
    with open(os.path.join(root, "native", "tb", "metrics.jsonl")) as f:
        losses = [json.loads(line)["value"] for line in f if "Loss" in line]
    if not losses or not all(math.isfinite(v) for v in losses):
        fail("the parallel-loader epoch logged a non-finite loss")
    steps = len(record["train_ms"])
    want_launches = trainer_launches(steps, len(record["val_ms"]))
    if launches != want_launches:
        fail(f"the parallel-loader epoch launched {launches}, expected {want_launches}")
    print(f"  run_exp epoch with DAGGER.LOADER_WORKERS {LOADER_WORKERS}: {run_ms:.1f} ms, "
          f"{steps} train steps (each worker batches its own shard of 2 episodes, padded to "
          f"4) and {len(record['val_ms'])} val windows; {len(got)} episodes, the in-process "
          f"loader's as a multiset; {len(segments)} segments created, none left in /dev/shm")
    print("  train steps, host ms: " + " ".join(f"{t:.3f}" for t in record["train_ms"]))
    print("  gaps between steps, ms: " + " ".join(f"{t:.3f}" for t in record["gaps_ms"])
          + "; the epoch's start to its first step (the loader's first batch): "
          + " ".join(f"{t:.1f}" for t in record["first_wait_ms"]) + " ms")
    if raw:
        print("  phase 6 (in-process loader, runs 1 and 2): steps, host ms: "
              + " ".join(f"{t:.3f}" for t in raw["steps_ms"]) + "; gaps, ms: "
              + " ".join(f"{t:.3f}" for t in raw["gaps_ms"]) + "; the epochs' start to their "
              "first step: " + " ".join(f"{t:.1f}" for t in raw["first_wait_ms"]) + " ms")
    print("  each window's copy to the card (train windows on the worker thread, then val "
          "windows on the main one), host ms: " + " ".join(f"{t:.3f}" for t in sends))
    print(f"  launches: {launches} (2 + 2 forward and 2 LSTM backward a step, 2 + 2 a val "
          "window)")
    return launches


def mesh_step(cfg, high, low, mesh):
    from robo_vln_tpu_torch.models import make_shared_trunk_fn
    from robo_vln_tpu_torch.training import inflection_coef_from, make_hier_train_step

    return make_hier_train_step(
        high, low, trunk_fn=make_shared_trunk_fn(high), inflection_coef=inflection_coef_from(cfg),
        valid_velocity_mse=cfg.TPU.VALID_MASK_VELOCITY_MSE, mesh=mesh)


def step_outputs(step, state, high, low, batch, lr=0.0):
    """(metrics, gradients by name) of one step from the given state."""
    b = batch["valid_mask"].shape[0]
    device = batch["valid_mask"].device
    _, _, _, metrics = step(state, high.initial_hidden(b, device), low.initial_hidden(b, device),
                            batch, lr, lr)
    grads = {f"{level}.{n}": p.grad.clone() for level, pol in (("high", high), ("low", low))
             for n, p in pol.named_parameters() if p.grad is not None}
    return {k: v.clone() for k, v in metrics.items()}, grads


@contextlib.contextmanager
def one_rank_group(device):
    """A process group of one around the block: NCCL on the card (a run of
    one rank has no group; this one has the many-rank path's collectives
    run at world size 1)."""
    import torch.distributed as dist

    from robo_vln_tpu_torch.parallel.mesh import free_address, init_process_group

    init_process_group(0, 1, free_address(), device)
    try:
        yield
    finally:
        dist.destroy_process_group()


def one_card_mesh(device, root):
    """13b: run_exp's epoch in an NCCL group of one, and a float32 step in
    the group against the same step outside any."""
    import torch.distributed as dist

    from robo_vln_tpu_torch.config import get_config
    from robo_vln_tpu_torch.ops import fused_attention, fused_lstm
    from robo_vln_tpu_torch.parallel.mesh import DataMesh
    from robo_vln_tpu_torch.run import run_exp

    # DEVICE as a user leaves it: "cuda", no index
    opts = trainer_opts(device.type, os.path.join(root, "native"),
                        "CHECKPOINT_FOLDER", os.path.join(root, "ckpts_13b"),
                        "TENSORBOARD_DIR", os.path.join(root, "tb_13b"))
    record, reduce_ms, sends = new_trainer_record(), [], []
    fused_lstm.reset_launches()
    fused_attention.reset_launches()
    with one_rank_group(device), instrumented_trainer(record), timed_reduce(reduce_ms), \
            timed_sends(sends):
        run_exp(None, "train", opts)
    launches = path_launches()
    meshes = record["meshes"]
    record["trainers"].clear()
    backend = "nccl" if device.type == "cuda" else "gloo"
    if meshes != [(1, True, backend)]:
        fail(f"run_exp's trainer at TPU.MESH_SHAPE [-1, 1] ran on the mesh {meshes}, expected "
             f"one rank of a {backend} group")
    if len(reduce_ms) != len(record["train_ms"]) + len(record["val_ms"]):
        fail(f"{len(reduce_ms)} all-reduces for {len(record['train_ms'])} steps and "
             f"{len(record['val_ms'])} val windows")
    want = trainer_launches(len(record["train_ms"]), len(record["val_ms"]))
    if launches != want:
        fail(f"the epoch in the group of one launched {launches}, expected {want}")
    print(f"  run_exp epoch at TPU.MESH_SHAPE [-1, 1]: {meshes[0][0]} rank, {meshes[0][2]}; "
          f"{len(record['train_ms'])} train steps, host ms: "
          + " ".join(f"{t:.3f}" for t in record["train_ms"]))
    print("  the step's all-reduce (gradients and losses, one buffer), ms by CUDA events / host "
          "clock: " + " ".join(f"{e:.3f}/{h:.3f}" for e, h in reduce_ms[:len(record['train_ms'])])
          + "; a val window's (losses): " + " ".join(
              f"{e:.3f}/{h:.3f}" for e, h in reduce_ms[len(record["train_ms"]):]))
    print("  each window's copy to the card (the in-process loader; train windows on the "
          "worker thread, then val windows on the main one), host ms: "
          + " ".join(f"{t:.3f}" for t in sends))
    print(f"  launches: {launches}")

    cfg = get_config()
    high, low, step, state = make_train(cfg, torch.float32, device)
    batch = train_batch(torch.Generator().manual_seed(5), MESH_BATCH, MESH_T, 200, device)
    runs = [step_outputs(step, state, high, low, batch) for _ in range(2)]
    with one_rank_group(device):
        mesh = DataMesh(device)
        grouped = step_outputs(mesh_step(cfg, high, low, mesh), state, high, low, batch)
        backend = dist.get_backend()
        # the all-reduce's parts on the step's gradients: the copy into one
        # buffer, the collective alone, the whole reduce_step
        grads = list(grouped[1].values())
        flat = torch.cat([g.reshape(-1) for g in grads])
        scalars = [torch.zeros((), device=device)] * 4
        parts = {"cat": lambda: torch.cat([g.reshape(-1) for g in grads]),
                 "all_reduce": lambda: dist.all_reduce(flat),
                 "reduce_step": lambda: mesh.reduce_step(grads, scalars)}
        print(f"  the all-reduce's parts over the step's {flat.numel()} gradients "
              f"({flat.numel() * 4 / 1e6:.1f} MB), median of 10 calls by CUDA events: " + ", ".join(
                  f"{name} {statistics.median(time_ms(fn, reps=10, inner=1)):.4f} ms"
                  for name, fn in parts.items()))
    del high, low, step, state

    def bitwise(a, b):
        return a[0].keys() == b[0].keys() and a[1].keys() == b[1].keys() and all(
            torch.equal(a[i][k], b[i][k]) for i in (0, 1) for k in a[i])

    repeatable = bitwise(runs[0], runs[1])
    if bitwise(grouped, runs[0]):
        print(f"  float32 step (lr 0) in the {backend} group of one: losses and "
              f"{len(grouped[1])} gradients bitwise equal to the step outside any group")
    elif repeatable:
        fail("the float32 step in a group of one differs from the step outside any group, "
             "which repeats bitwise")
    else:
        print("  the float32 step outside any group does not repeat bitwise; the grouped step "
              "is held to it at phase 5b's tolerances")
        hold_step_to_plain("the grouped step", *grouped, *runs[0], against="the step outside")
    return launches


def mesh_batch(device):
    """13c's global batch: rank 0's rows mostly padding (12 real steps, then
    an episode all padding), rank 1's two full episodes."""
    batch = train_batch(torch.Generator().manual_seed(13), MESH_BATCH, MESH_T, 200, device)
    for row, first in ((0, 12), (1, 0)):
        batch["valid_mask"][row, first:] = 0.0
        batch["vln_oracle_action_sensor"][row, first:] = 0.0
        batch["corrected_actions"][row, first:] = 0.0
        batch["oracle_stop"][row, first:] = -1.0
    return batch


def _mesh_rank(rank, address, out_dir, device):
    """13c's rank, in a spawned process on ``device`` (the one card): the
    sharded float32 step (lr 0), then MESH_BF16_STEPS bf16 steps; its
    results into out_dir."""
    global torch
    import torch  # this module is __mp_main__ here, imported without torch
    import torch.distributed as dist

    from robo_vln_tpu_torch.config import get_config
    from robo_vln_tpu_torch.ops import fused_attention, fused_lstm
    from robo_vln_tpu_torch.parallel.mesh import DataMesh, init_process_group

    device = torch.device(device)
    init_process_group(rank, MESH_RANKS, address, device, backend="gloo")
    try:
        mesh = DataMesh(device, size=MESH_RANKS, rank=rank)
        batch = mesh.shard(mesh_batch(device))
        out = {}
        for dtype, n, lr in ((torch.float32, 1, 0.0), (torch.bfloat16, MESH_BF16_STEPS, 1e-4)):
            # each rank draws its own dropout masks: the float32 parity runs without
            cfg = get_config(opts=MESH_NO_DROPOUT if dtype == torch.float32 else None)
            high, low, step, state = make_train(cfg, dtype, device)
            mesh.broadcast(high, low)
            step = mesh_step(cfg, high, low, mesh)
            b = MESH_BATCH // MESH_RANKS
            hh, lh = high.initial_hidden(b, device), low.initial_hidden(b, device)
            reduce_ms, step_ms = [], []
            fused_lstm.reset_launches()
            fused_attention.reset_launches()
            with timed_reduce(reduce_ms):
                for _ in range(n):
                    t0 = time.perf_counter()
                    state, hh, lh, metrics = step(state, hh, lh, batch, lr, lr)
                    torch.cuda.synchronize()
                    step_ms.append((time.perf_counter() - t0) * 1e3)
            result = {"metrics": {k: v.cpu() for k, v in metrics.items()}, "steps": n,
                      "launches": path_launches(), "reduce_ms": reduce_ms, "step_ms": step_ms}
            if dtype == torch.float32:
                result["grads"] = {f"{level}.{k}": p.grad.cpu()
                                   for level, pol in (("high", high), ("low", low))
                                   for k, p in pol.named_parameters() if p.grad is not None}
            else:
                flat = torch.cat([p.detach().float().reshape(-1)
                                  for m in (high, low) for p in m.parameters()])
                ref = flat.clone()
                dist.broadcast(ref, 0)
                result["weights_equal"] = bool(torch.equal(flat, ref))
            out[str(dtype).split(".")[-1]] = result
            del high, low, state, step
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def two_ranks_on_one_card(device, root):
    """13c: two gloo ranks on the one card against the one-process step on
    the global batch."""
    import torch.multiprocessing as mp

    from robo_vln_tpu_torch.config import get_config
    from robo_vln_tpu_torch.parallel.mesh import free_address

    cfg = get_config(opts=MESH_NO_DROPOUT)
    high, low, step, state = make_train(cfg, torch.float32, device)
    ref, ref_grads = step_outputs(step, state, high, low, mesh_batch(device))
    ref_grads = {k: v.cpu() for k, v in ref_grads.items()}
    del high, low, step, state
    torch.cuda.empty_cache()
    out_dir = os.path.join(root, "ranks")
    os.makedirs(out_dir)
    t0 = time.perf_counter()
    mp.start_processes(_mesh_rank, args=(free_address(), out_dir, str(device)), nprocs=MESH_RANKS,
                       join=True, start_method="spawn")
    spawn_s = time.perf_counter() - t0
    results = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
               for r in range(MESH_RANKS)]
    print(f"  {MESH_RANKS} ranks spawned, ran and joined in {spawn_s:.1f} s")
    launches = {}
    for rank, res in enumerate(results):
        f32, bf16 = res["float32"], res["bfloat16"]
        hold_step_to_plain(f"rank {rank}'s float32 step (B={MESH_BATCH // MESH_RANKS} a rank)",
                           f32["metrics"], f32["grads"], ref, ref_grads,
                           against=f"one process at B={MESH_BATCH}")
        for label, r in (("float32", f32), ("bf16", bf16)):
            got = {k: r["launches"][k] for k in ("lstm_seq", "lstm_seq_backward",
                                                 "cross_modal_attn")}
            if got != dict.fromkeys(got, 2 * r["steps"]):
                fail(f"rank {rank}'s {r['steps']} {label} steps launched {r['launches']}")
            print(f"  rank {rank}, {r['steps']} {label} step(s), host ms: "
                  + " ".join(f"{t:.3f}" for t in r["step_ms"]) + "; their gloo all-reduce, "
                  "ms by CUDA events / host clock: "
                  + " ".join(f"{e:.3f}/{h:.3f}" for e, h in r["reduce_ms"])
                  + f"; launches {got} (2 + 2 forward and 2 LSTM backward a step)")
        if not all(math.isfinite(v.item()) for v in bf16["metrics"].values()):
            fail(f"rank {rank}'s bf16 step gave a non-finite loss")
        if not bf16["weights_equal"]:
            fail(f"rank {rank}'s weights differ from rank 0's after the bf16 step")
        for r in (f32, bf16):
            for k, v in r["launches"].items():
                launches[k] = launches.get(k, 0) + v
    print(f"  both ranks' bf16 losses finite and weights bitwise equal after the steps; "
          f"launches of both ranks: {launches}")
    return launches


def mesh_path(device, raw=None):
    """Phase 13: the data plane and the mesh at full width."""
    import shutil
    import tempfile

    from robo_vln_tpu_torch.ops import _build

    print("phase 13: the data plane and the mesh at full width, bfloat16 unless said")
    os.makedirs(_build.BUILD_DIR.parent, exist_ok=True)
    root = tempfile.mkdtemp(prefix="mesh_", dir=_build.BUILD_DIR.parent)
    try:
        print("phase 13a: the native trajectory store and the process-parallel loader")
        loader = store_and_loader(device, root, raw)
        print("phase 13b: the mesh on the one card, an NCCL group of one")
        one = one_card_mesh(device, root)
        print(f"phase 13c: {MESH_RANKS} gloo ranks on the one card, B={MESH_BATCH} global")
        two = two_ranks_on_one_card(device, root)
        return loader, {"13b": one, "13c": two}
    finally:
        shutil.rmtree(root, ignore_errors=True)


WIDE_HIDDEN = 2048  # phase 14: MODEL.STATE_ENCODER.hidden_size, both LSTMs
WIDE_HEADS = 1  # phase 14: MODEL.VISUAL_LING_ATTN.h, one head of d_model 256
# phase 14, bf16: kernels against plain, each output's largest error of its
# largest magnitude; bf16 rounds p before it is normalised in the kernel,
# after it in the plain version (2^-8 of a term), then through 50 steps
WIDE_BF16_RTOL = 2e-2


def wide_path(device):
    """Phase 14: the HCM at bench.py's full width with two settings a user
    can make that reach the shapes past the kernels' former ranges,
    MODEL.STATE_ENCODER.hidden_size 2048 (the LSTM's wide variants, both
    levels) and MODEL.VISUAL_LING_ATTN.h 1 (d = 256: the wide attention
    kernel in bf16, the tensor-core D = 256 key blocks in float32): in bf16
    and in float32, one window through build_hcm_agent and one train step
    through training/steps (lr 0), each held to itself under
    plain_kernels() (float32 at phases 4b and 5b's tolerances; bf16 the
    window's outputs within WIDE_BF16_RTOL of each output's largest
    magnitude and the losses within phase 9's bf16 tolerances), with its
    launches asserted.  Returns the launches of the kernels' runs by the
    kernels line's names."""
    from robo_vln_tpu_torch import build_hcm_agent
    from robo_vln_tpu_torch.config import get_config
    from robo_vln_tpu_torch.ops import fused_attention, fused_lstm

    cfg = get_config(None, ["MODEL.STATE_ENCODER.hidden_size", WIDE_HIDDEN,
                            "MODEL.VISUAL_LING_ATTN.h", WIDE_HEADS])
    mc = cfg.MODEL
    B, T, L = 4, 50, 200
    d = mc.VISUAL_LING_ATTN.d_model // WIDE_HEADS
    print(f"phase 14: the HCM at full width with MODEL.STATE_ENCODER.hidden_size {WIDE_HIDDEN} "
          f"and MODEL.VISUAL_LING_ATTN.h {WIDE_HEADS} (d = {d}), B={B} T={T}: a window and a "
          "train step in bf16 and in float32, each against plain_kernels()")
    gen = torch.Generator().manual_seed(14)
    obs, masks = window_inputs(gen, B, T, L, device)
    batch = train_batch(gen, B, T, L, device)
    total = collections.Counter()

    def counts():
        return {**path_launches(), **wide_launches(), **dict(zip(
            KEY_BLOCK_COUNTS, key_block_launches())),
            **{f"route_{r}": n for r, n in fused_attention.route_launches.items()}}

    def expect(label, before, want):
        after = counts()
        took = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        print(f"  {label}: launched {took}")
        if took != want:
            fail(f"phase 14 {label} launched {took}, expected {want}")
        total.update({k: n for k, n in took.items() if not k.startswith("route_")})

    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype)[6:]
        bf16 = dtype == torch.bfloat16
        # the rgb (S = 16) and depth (S = 64) attention: in bf16 the wide
        # kernel, p rounded once; in float32 at d = 256 the tensor-core key
        # blocks
        attn = collections.Counter({"cross_modal_attn": 2})
        for S in (16, 64):
            route = fused_attention.pick_route(dtype, S, d, d)
            attn[f"route_{route}"] += 1
            attn.update({f"cross_modal_attn_{route}": int(route.startswith("wide"))})
            attn.update(dict(zip(KEY_BLOCK_COUNTS,
                                 expected_key_block_counts(route, dtype, S, d, d))))
        if bf16:
            attn["cross_modal_attn_bf16_round_p"] = 2
        # both LSTMs past H = 1024: the wide variant
        forward = {k: n for k, n in {"lstm_seq": 2, "lstm_seq_wide": 2, **attn}.items() if n}
        agent = build_hcm_agent(mc, device=device, compute_dtype=name, seed=0,
                                share_frozen_trunks=cfg.TPU.SHARE_FROZEN_TRUNKS,
                                pallas_attention=cfg.TPU.PALLAS_ATTENTION)
        for scope in (contextlib.nullcontext, plain_kernels):  # a first, uncounted call each
            with scope():
                agent.forward_window(obs, masks, None, *agent.initial_state(B))
        before = counts()
        t0 = time.perf_counter()
        got = agent.forward_window(obs, masks, None, *agent.initial_state(B))
        torch.cuda.synchronize()
        print(f"  {name} window B={B} T={T}: {(time.perf_counter() - t0) * 1e3:.3f} ms "
              "(host clock, its second call)")
        expect(f"{name} window", before, forward)
        before = counts()
        with plain_kernels():
            t0 = time.perf_counter()
            ref = agent.forward_window(obs, masks, None, *agent.initial_state(B))
            torch.cuda.synchronize()
        print(f"  {name} window, plain_kernels(): {(time.perf_counter() - t0) * 1e3:.3f} ms "
              "(its second call)")
        expect(f"{name} window, plain_kernels()", before, {})
        names = ("actions", "stop", "logits", "high hidden", "low hidden")
        if got[3].shape != (2, B, WIDE_HIDDEN):
            fail(f"phase 14 high hidden state {tuple(got[3].shape)}")
        held = names
        if bf16:  # the low level follows the high level's argmax
            flips = (got[2].argmax(-1) != ref[2].argmax(-1)).sum().item()
            print(f"  {name}: the high level's argmax differs at {flips} of {B * T} steps")
            if flips:
                held = ("logits", "high hidden")
        for label, g, r in zip(names, got, ref):
            check_finite(f"phase 14 {name} {label}", g)
            if label not in held:
                continue
            err = (g.float() - r.float()).abs().max().item()
            tol = WIDE_BF16_RTOL * r.float().abs().max().item() if bf16 else WINDOW_TOL
            print(f"  {name} {label}: max_abs_err {err:.3e} (tolerance {tol:.3e})")
            if not err <= tol:
                fail(f"phase 14 {name} window {label} disagrees with the plain-kernel agent")
        del agent, got, ref

        high, low, step, state = make_train(cfg, dtype, device)
        hh, lh = high.initial_hidden(B, device), low.initial_hidden(B, device)
        params = [(f"{level}.{n}", p) for level, pol in (("high", high), ("low", low))
                  for n, p in pol.named_parameters()]
        runs = {}
        for label, scope in (("kernels", contextlib.nullcontext), ("plain", plain_kernels)):
            with scope():  # a first, uncounted step (lr 0: the weights stay)
                step(state, hh, lh, batch, 0.0, 0.0)
            before = counts()
            with scope():
                t0 = time.perf_counter()
                _, _, _, metrics = step(state, hh, lh, batch, 0.0, 0.0)
                torch.cuda.synchronize()
            print(f"  {name} train step, {label}: {(time.perf_counter() - t0) * 1e3:.3f} ms "
                  "(host clock, its second call); " + ", ".join(
                      f"{k} {v.item():.6f}" for k, v in metrics.items()))
            expect(f"{name} train step, {label}", before,
                   {**forward, "lstm_seq_backward": 2, "lstm_seq_backward_wide": 2}
                   if label == "kernels" else {})
            check_finite(f"phase 14 {name} train step", *metrics.values())
            runs[label] = metrics, {n: p.grad.clone() for n, p in params if p.grad is not None}
        if bf16:
            (got, grads), (ref, _) = runs["kernels"], runs["plain"]
            for key in HCM_LOSS_KEYS:
                a, b = got[key].item(), ref[key].item()
                print(f"  {name} {key}: {a:.6f} against {b:.6f} (rtol {FEATURE_LOSS_RTOL}, "
                      f"atol {FEATURE_LOSS_ATOL})")
                if not abs(a - b) <= FEATURE_LOSS_RTOL * abs(b) + FEATURE_LOSS_ATOL:
                    fail(f"phase 14 bf16 train step {key} disagrees with the plain-kernel step")
            check_finite("phase 14 bf16 gradients", *grads.values())
        else:
            hold_step_to_plain("phase 14 float32 train step, kernels", *runs["kernels"],
                               *runs["plain"])
        del high, low, step, state, runs, params
        torch.cuda.empty_cache()
    print(f"  phase 14 launches (the kernels' runs): {dict(total)}")
    return dict(total)


# phase 15: ROADMAP §A item 8 (pretrained backbones, module ranges, the
# transformer blocks no policy builds, the LangNav study)
ITEM8_TRAIN_EPISODES = 4  # 15a: one batch of 4 (60-100 steps, padded to 100): 2 steps
DDPPO_PREFIX = "actor_critic.net.visual_encoder."
BLOCK_N, BLOCK_TOKENS, IMAGE_TOKENS = 200, 200, 16  # 15c: rows, instruction and image tokens
BLOCK_F32_TOL = 1e-4  # 15c, float32, each block's output against plain_kernels()
# 15c's timed attention calls: (field prefix, Lq, S, heads, d, what)
BLOCK_SHAPES = (("s200_d64", 200, 200, 4, 64,
                 "TRANSFORMER_INSTRUCTION_ENCODER's self-attention"),
                ("lq16_s200_d128", 16, 200, 2, 128,
                 "IMAGE_CROSS_MODAL_ENCODER's cross-attention, image tokens onto the instruction"))
# 15d: the port's study at full width, cut to a smoke
STUDY_KNOBS = {"N_TRAIN": 8, "N_VAL": 4, "EPOCHS": 1, "EPOCHS_PER_ITER": 1, "TOTAL_EPOCHS": 1,
               "BATCH": 8, "MAX_STEPS": 150, "NUM_ENVS": 4, "HOST_EPISODES": 1,
               "ON_DEVICE": True, "FEATURE_MODE": True}


def write_pretrained_files(root, mc):
    """15a: the three backbones' files at ``mc``'s sizes (at full width the
    published ones: torchvision's ResNet50, the DDPPO GroupNorm ResNet50,
    bert-base with 12 layers of 768 and a vocabulary of 30522), values from
    seed 15, in the three layouts the loader reads: torchvision's .pth (its
    fc and num_batches_tracked included), HF BertModel's .npz (its pooler
    included) and a DDPPO .pth ({"state_dict"}, the encoder under
    actor_critic.net.visual_encoder.).  Returns ({name: path}, {name: the
    tensors each such module must hold})."""
    import numpy as np

    from robo_vln_tpu_torch.models.hierarchical import HighLevelPolicy

    high = HighLevelPolicy(mc)
    gen = torch.Generator().manual_seed(15)

    def draw(sd):
        out = {}
        for k, v in sd.items():
            if k.endswith("running_var"):
                out[k] = torch.rand(v.shape, generator=gen) + 0.5
            elif v.dim() > 1:
                out[k] = torch.randn(v.shape, generator=gen) * v[0].numel() ** -0.5
            else:
                out[k] = torch.randn(v.shape, generator=gen) * 0.1 + float(k.endswith("weight"))
        return out

    tensors = {"ddppo_depth": draw(high.depth_encoder.visual_encoder.state_dict()),
               "imagenet_rgb": draw(high.rgb_encoder.cnn.state_dict()),
               "bert": draw(high.embedding_layer.state_dict())}
    paths = {"ddppo_depth": os.path.join(root, "gibson-2plus-resnet50.pth"),
             "imagenet_rgb": os.path.join(root, "resnet50_imagenet.pth"),
             "bert": os.path.join(root, "bert_base_uncased.npz")}
    torch.save({"state_dict": {DDPPO_PREFIX + k: v for k, v in tensors["ddppo_depth"].items()},
                "config": None}, paths["ddppo_depth"])
    tv = dict(tensors["imagenet_rgb"])
    tv.update({k.replace("running_var", "num_batches_tracked"): torch.tensor(0)
               for k in tensors["imagenet_rgb"] if k.endswith("running_var")})
    tv["fc.weight"], tv["fc.bias"] = torch.randn(1000, 2048, generator=gen) * 0.02, torch.zeros(1000)
    torch.save(tv, paths["imagenet_rgb"])
    hidden = mc.BERT.hidden_size
    np.savez(paths["bert"], **{k: v.numpy() for k, v in tensors["bert"].items()},
             **{"pooler.dense.weight": np.zeros((hidden, hidden), np.float32),
                "pooler.dense.bias": np.zeros(hidden, np.float32)})
    return paths, tensors


def check_backbones(trainer, tensors):
    """Every frozen trunk and BERT of both levels equal to its file's
    tensors, bitwise."""
    held = {"ddppo_depth": ("depth_encoder.visual_encoder",),
            "imagenet_rgb": ("rgb_encoder.cnn",), "bert": ("embedding_layer",)}
    checked = 0
    for name, paths in held.items():
        for level, policy in (("high", trainer.high), ("low", trainer.low)):
            for path in paths:
                try:
                    module = policy.get_submodule(path)
                except AttributeError:
                    continue  # the low level holds no BERT
                for k, t in module.state_dict().items():
                    if not torch.equal(t.cpu(), tensors[name][k]):
                        fail(f"phase 15a: {level}.{path}.{k} differs from the {name} file")
                    checked += 1
    return checked


def pretrained_trainer(device, root, model_opts=(), buffers=None):
    """15a: run_exp's hierarchical trainer (phase 6's set-up) from the three
    pretrained files for 2 steps: all three ``loaded``, the frozen trunks
    and BERT equal to the files' tensors bitwise after the steps, and both
    kernels launched (2 + 2 forward and 2 backward a step).  Returns the
    trainer, its launches and the options that name the files."""
    from robo_vln_tpu_torch.config import get_config
    from robo_vln_tpu_torch.ops import fused_attention, fused_lstm
    from robo_vln_tpu_torch.run import run_exp

    t0 = time.perf_counter()
    paths, tensors = write_pretrained_files(root, get_config(opts=list(model_opts)).MODEL)
    sizes = {k: os.path.getsize(p) / 2**20 for k, p in paths.items()}
    print(f"phase 15a: pretrained files written in {time.perf_counter() - t0:.1f} s: "
          + ", ".join(f"{k} {os.path.basename(paths[k])} {sizes[k]:.1f} MiB" for k in paths))
    (buffers or write_trainer_buffers)(root, episodes=(ITEM8_TRAIN_EPISODES, 0))
    files = ["MODEL.DEPTH_ENCODER.ddppo_checkpoint", paths["ddppo_depth"],
             "MODEL.RGB_ENCODER.pretrained_weights", paths["imagenet_rgb"],
             "MODEL.BERT.pretrained_weights", paths["bert"]]
    opts = [*model_opts, *files, "DEVICE", str(device), "TRAINER_NAME", "hierarchical_trainer",
            "DAGGER.BATCH_SIZE", 4, "DAGGER.tbptt_steps", 50, "DAGGER.EPISODE_LEN_BUCKETS", [100],
            "DAGGER.EPOCHS", 1, "DAGGER.PRELOAD_LMDB_FEATURES", True,
            "DAGGER.LMDB_FEATURES_DIR", os.path.join(root, "train"),
            "DAGGER.LMDB_EVAL_DIR", os.path.join(root, "no_eval"),
            "CHECKPOINT_FOLDER", os.path.join(root, "ckpts"),
            "TENSORBOARD_DIR", os.path.join(root, "tb"), "LOG_FILE", os.path.join(root, "train.log"),
            "MODEL.INSTRUCTION_ENCODER.is_bert", True, "TPU.SYNC_FROZEN_TRUNKS_ON_INIT", True,
            "TPU.PRECISION", "bfloat16"]
    record = new_trainer_record()
    fused_lstm.reset_launches()
    fused_attention.reset_launches()
    t0 = time.perf_counter()
    with instrumented_trainer(record):
        run_exp(None, "train", opts)
    run_ms = (time.perf_counter() - t0) * 1e3
    launches = path_launches()
    trainer = record["trainers"][0]
    prov = trainer.pretrained_backbones
    print(f"  run_exp train, 2 steps from the files: {run_ms:.1f} ms (the build, the loads and "
          f"the steps); provenance {prov}")
    if {k: v.get("status") for k, v in prov.items()} != dict.fromkeys(paths, "loaded"):
        fail(f"phase 15a: the backbones were not all loaded: {prov}")
    if len(record["train_ms"]) != 2:
        fail(f"phase 15a took {len(record['train_ms'])} train steps, expected 2")
    checked = check_backbones(trainer, tensors)
    want = trainer_launches(2, 0)
    if launches != want:
        fail(f"phase 15a launched {launches}, expected {want}")
    print(f"  {checked} trunk and BERT tensors of both levels equal to the files' after the "
          f"steps; train steps (host ms to the end of the device's work): "
          + " ".join(f"{t:.3f}" for t in record["train_ms"]) + f"; launches {launches}; "
          f"shared trunks {record['shared_trunks']}")
    return trainer, launches, files


def range_times(prof, names):
    """{range: (calls, kernel ms, device span ms)} of a profile: the device
    time of the kernels launched inside each range (its children's
    included), and its span on the device's timeline."""
    events = prof.events()
    out = {}
    for name in names:
        cpu = [e for e in events if e.name == name and e.device_type.name == "CPU"]
        span = [e for e in events if e.name == name and e.device_type.name == "CUDA"]
        out[name] = (len(cpu), sum(e.device_time_total for e in cpu) / 1e3,
                     sum(e.time_range.elapsed_us() for e in span) / 1e3)
    return out


def module_times(device, trainer, B=4, T=50, L=200):
    """15b: one bf16 train step (lr 0) of 15a's trainer under torch.profiler:
    the device time of each module range (utils/profiling.MODULE_RANGES: the
    rgb and depth trunks, BERT, the high-level policy, which holds BERT, and
    the low-level policy) and of the step's ranges.  Returns {range: kernel
    ms}."""
    from torch.profiler import ProfilerActivity, profile

    from robo_vln_tpu_torch.utils.profiling import MODULE_RANGES

    gen = torch.Generator().manual_seed(16)
    batch = train_batch(gen, B, T, L, device)
    hh, lh = trainer.high.initial_hidden(B, device), trainer.low.initial_hidden(B, device)
    trainer.train_step(trainer.state, hh, lh, batch, 0.0, 0.0)  # warm, lr 0: weights unchanged
    _synchronize(device)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.device(
        device).type == "cuda" else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        trainer.train_step(trainer.state, hh, lh, batch, 0.0, 0.0)
        _synchronize(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    steps = ("hier_train_step.forward", "hier_train_step.backward", "hier_train_step.optimizer")
    times = range_times(prof, MODULE_RANGES + steps)
    print(f"phase 15b: one bf16 train step B={B} T={T} under torch.profiler: {wall_ms:.3f} ms "
          "host; by range, its calls, the device time of its kernels, its span on the device")
    for name, (calls, kernel_ms, span_ms) in times.items():
        if not calls:
            fail(f"phase 15b: no {name} range in the profile of a train step")
        print(f"  {name}: {calls}x, kernels {kernel_ms:.3f} ms, span {span_ms:.3f} ms")
    return {name: kernel_ms for name, (_, kernel_ms, _) in times.items()}


def stanza_widths():
    """The widths of the reference's transformer stanzas, which the port's
    tree does not hold: their JAX package defaults (config/jax_only.INERT)."""
    from robo_vln_tpu_torch.config.jax_only import INERT

    out = collections.defaultdict(dict)
    for key, (value, _) in INERT.items():
        parts = key.split(".")
        if parts[0] == "MODEL" and parts[1] in ("TRANSFORMER_INSTRUCTION_ENCODER",
                                                "IMAGE_CROSS_MODAL_ENCODER", "INTER_MODULE_ATTN"):
            out[parts[1]][parts[2]] = value
    return dict(out)


def block_cases(dtype, widths, n, tokens, image_tokens, gen, device):
    """15c: the nine blocks of models/transformer.py that no policy builds, at
    the stanzas' widths over ``n`` rows (instruction sequences of ``tokens``,
    image maps of ``image_tokens``): [(name, module, inputs, its attention
    calls as (Lq, S, heads, d))]."""
    from robo_vln_tpu_torch.models import transformer as tf

    ti, ic, im = (widths[k] for k in ("TRANSFORMER_INSTRUCTION_ENCODER",
                                      "IMAGE_CROSS_MODAL_ENCODER", "INTER_MODULE_ATTN"))
    torch.manual_seed(15)

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(device)

    t_d, i_d, m_d = (w["d_model"] // w["h"] for w in (ti, ic, im))
    lang = randn(n, tokens, ti["d_model"])
    text = randn(n, tokens, ti["d_in"])
    pad = torch.zeros(n, tokens, 1, dtype=torch.bool)
    pad[::2, tokens - tokens // 10:] = True  # every other row's last tenth is padding
    image = randn(n, image_tokens, ic["d_in"])
    image_model = randn(n, image_tokens, ic["d_model"])
    instruction = randn(n, tokens, ic["d_model"])
    side = math.isqrt(image_tokens)
    pos_mod = tf.PositionEmbedding2DLearned(ic["d_model"] // 2)
    pos = pos_mod.to(device)((side, side), n).reshape(n, image_tokens, ic["d_model"])
    self_t = [(tokens, tokens, ti["h"], t_d)]
    image_calls = [(image_tokens, image_tokens, ic["h"], i_d), (image_tokens, tokens, ic["h"], i_d)]
    cases = [
        ("EncoderLayer", tf.EncoderLayer(ti["d_model"], ti["h"], ti["d_ff"], dtype),
         (lang, lang, lang), self_t),
        ("BaseEncoder", tf.BaseEncoder(ti["d_model"], ti["h"], ti["d_ff"], ti["N"], dtype),
         (lang,), self_t * ti["N"]),
        ("TransformerLanguageEncoder", tf.TransformerLanguageEncoder(
            ti["d_model"], ti["h"], ti["d_ff"], ti["N"], ti["d_in"], dtype),
         (text, pad.to(device)), self_t * ti["N"]),
        ("DecoderLayer", tf.DecoderLayer(ic["d_model"], ic["h"], ic["d_ff"], dtype),
         (image_model, instruction), image_calls),
        ("InterModuleAttnDecoder", tf.InterModuleAttnDecoder(
            im["d_model"], im["h"], im["d_ff"], im["N"], im["in_features"], dtype),
         (randn(n, tokens, im["in_features"]), randn(n, tokens, im["in_features"])),
         [(tokens, tokens, im["h"], m_d)] * im["N"]),
        ("ImageCrossModalEncoder", tf.ImageCrossModalEncoder(
            ic["d_model"], ic["h"], ic["d_ff"], ic["N"], ic["d_in"], dtype),
         (image, instruction), image_calls * ic["N"]),
        ("PositionEmbedding2DLearned", pos_mod, ((side, side), n), []),
        ("ImageEncoderWithPosEncodings", tf.ImageEncoderWithPosEncodings(
            ic["d_model"], ic["h"], ic["d_ff"], ic["N"], ic["d_model"], dtype),
         (image_model, instruction, None, None, pos), image_calls * ic["N"]),
        ("ImagePlainEncoder", tf.ImagePlainEncoder(
            ic["d_model"], ic["h"], ic["d_ff"], ic["N"], ic["d_in"], dtype),
         (image,), [(image_tokens, image_tokens, ic["h"], i_d)] * ic["N"]),
    ]
    return [(name, module.to(device).eval(), args, calls) for name, module, args, calls in cases]


def attention_counts():
    from robo_vln_tpu_torch.ops import fused_attention

    return {"cross_modal_attn": fused_attention.launches,
            **dict(zip(KEY_BLOCK_COUNTS, key_block_launches())),
            **{f"route_{r}": c for r, c in fused_attention.route_launches.items()},
            **{f"bf16_{m}": c for m, c in fused_attention.bf16_mode_launches.items()}}


def blocks_path(device, widths=None, n=BLOCK_N, tokens=BLOCK_TOKENS, image_tokens=IMAGE_TOKENS):
    """15c: the nine blocks forward in bf16 and float32, each held to its run
    under plain_kernels() (float32 within BLOCK_F32_TOL, bf16 within
    WIDE_BF16_RTOL of the output's largest magnitude, phase 14's), with the
    attention kernel's launches a block asserted (one a call, and the key
    blocks each call's route takes); a masked call (the language encoder
    with an attention mask) takes the plain path and launches nothing.
    Returns (launches of the kernels' runs by the kernels line's names,
    the calls at each timed shape)."""
    from robo_vln_tpu_torch.ops import fused_attention
    from robo_vln_tpu_torch.utils.device import float32_exact

    widths = widths or stanza_widths()
    print(f"phase 15c: the transformer blocks no policy builds, at the stanzas' widths {widths} "
          f"over N={n} rows, {tokens} instruction and {image_tokens} image tokens; bf16 and "
          "float32, each against plain_kernels()")
    total = collections.Counter()
    shape_calls = collections.Counter()
    timed = {(Lq, S, h, d): prefix for prefix, Lq, S, h, d, _ in BLOCK_SHAPES}
    for dtype in (torch.bfloat16, torch.float32):
        name_dt = str(dtype)[6:]
        bf16 = dtype == torch.bfloat16
        gen = torch.Generator().manual_seed(15)
        with float32_exact(dtype), torch.no_grad():
            for name, module, args, calls in block_cases(dtype, widths, n, tokens,
                                                          image_tokens, gen, device):
                want = collections.Counter({"cross_modal_attn": len(calls)})
                for Lq, S, h, d in calls:
                    route = fused_attention.pick_route(dtype, S, d, d)
                    want[f"route_{route}"] += 1
                    want.update(dict(zip(KEY_BLOCK_COUNTS,
                                         expected_key_block_counts(route, dtype, S, d, d))))
                    if bf16:
                        want["bf16_round_p"] += 1
                    shape_calls[timed.get((Lq, S, h, d))] += 1
                want = {k: v for k, v in want.items() if v}
                before = attention_counts()
                _synchronize(device)
                t0 = time.perf_counter()
                got = module(*args)
                _synchronize(device)
                ms = (time.perf_counter() - t0) * 1e3
                took = {k: v - before[k] for k, v in attention_counts().items() if v != before[k]}
                if took != want:
                    fail(f"phase 15c {name} {name_dt} launched {took}, expected {want}")
                before = attention_counts()
                with plain_kernels():
                    ref = module(*args)
                if attention_counts() != before:
                    fail(f"phase 15c {name} {name_dt} under plain_kernels() launched a kernel")
                check_finite(f"phase 15c {name} {name_dt}", got)
                err = (got.float() - ref.float()).abs().max().item()
                tol = WIDE_BF16_RTOL * ref.float().abs().max().item() if bf16 else BLOCK_F32_TOL
                print(f"  {name} {name_dt} {tuple(got.shape)}: {ms:.3f} ms (host clock, first "
                      f"call), {len(calls)} attention launches {took}; max_abs_err {err:.3e} "
                      f"(tolerance {tol:.3e})")
                if not err <= tol:
                    fail(f"phase 15c {name} {name_dt} disagrees with plain_kernels()")
                total.update({k: v for k, v in took.items() if not k.startswith("route_")})
                if name == "TransformerLanguageEncoder":  # masked: the plain path, no launch
                    before = attention_counts()
                    masked = module(args[0], args[1], args[1].reshape(n, 1, 1, tokens))
                    if attention_counts() != before:
                        fail("phase 15c: a masked attention call launched the kernel")
                    check_finite("phase 15c masked TransformerLanguageEncoder", masked)
                del module, args, got, ref
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    launches = {"cross_modal_attn": total["cross_modal_attn"],
                "cross_modal_attn_bf16_round_p": total["bf16_round_p"],
                "cross_modal_attn_bf16_split_p": total["bf16_split_p"],
                **{k: total[k] for k in KEY_BLOCK_COUNTS}}
    print(f"  phase 15c launches (the kernels' runs): {launches}; calls at the timed shapes "
          f"{ {k: v for k, v in shape_calls.items() if k} }")
    return launches, shape_calls


def block_shape_entries(gen, device, shape_calls):
    """15c's timed calls: each BLOCK_SHAPES shape in bf16 (the serving
    dtype: the entry's ms, plain_ms, library_ms, bound) and float32 (f32_*),
    held to the plain version first (max_abs_err, bf16; f32_max_abs_err),
    then timed against it and SDPA (time_attention).  Returns the kernels
    line's entries."""
    from robo_vln_tpu_torch.ops import fused_attention

    entries = []
    for prefix, Lq, S, h, d, what in BLOCK_SHAPES:
        entry = {"name": f"cross_modal_attn_{prefix}", "route": "cuda",
                 "source": "robo_vln_tpu_torch/csrc/cross_modal_attn.cu",
                 "replaces": "robo_vln_tpu/ops/pallas_attention.py:48",
                 "launches": shape_calls[prefix]}
        for dtype, tag in ((torch.bfloat16, ""), (torch.float32, "f32_")):
            q, k, v = (torch.randn(BLOCK_N, L, h * d, generator=gen).to(device, dtype)
                       for L in (Lq, S, S))
            with torch.no_grad():
                got = fused_attention.cross_modal_attn_cuda(q, k, v, h)
                ref = fused_attention.attention_plain(q, k, v, h)
            err = (got.float() - ref.float()).abs().max().item()
            tol = bf16_tolerance(ATTN_BF16_TOL, q, k, v, h) if tag == "" else ATTN_TOL
            route = fused_attention.pick_route(dtype, S, d, d)
            print(f"  {prefix} {str(dtype)[6:]} ({what}): route {route}, max_abs_err {err:.3e} "
                  f"(tolerance {tol:.3e})")
            if not err <= tol:
                fail(f"phase 15c: the kernel at {prefix} {dtype} disagrees with the plain version")
            fields = time_attention(gen, device, prefix, BLOCK_N, Lq, S, h, d, dtype, what)
            entry.update({f"{tag}max_abs_err": err, f"{tag}ms": fields[f"{prefix}_ms"],
                          f"{tag}plain_ms": fields[f"{prefix}_plain_ms"],
                          f"{tag}library_ms": fields[f"{prefix}_library_ms"],
                          f"{tag}bound_ms": fields[f"{prefix}_bound_ms"],
                          f"{tag}bound_by": fields[f"{prefix}_bound_by"],
                          f"{tag}work": fields[f"{prefix}_work"],
                          **{f"{tag}{k[len(prefix) + 1:]}": fields[k] for k in fields
                             if k.endswith(("split_p_ms", "cuda_core_ms"))}})
        entries.append(entry)
    return entries


def study_path(device, root, model_opts=(), knobs=None):
    """15d: the port's convergence study (robo_vln_tpu_torch/scripts/
    convergence_study.py) in this process, cut to a smoke at full width: 8
    LangNav train episodes and 4 val, one epoch from the feature store, the
    on-device eval (and the host driver's row, the grounding control, the
    nonlearning rows), with ``model_opts`` (15a's pretrained files) on the
    study's config; scripts/collect_study_results.py must read its rows.
    Returns its launches."""
    from robo_vln_tpu_torch.ops import fused_attention, fused_lstm
    from robo_vln_tpu_torch.scripts import convergence_study as cs

    saved = {k: getattr(cs, k) for k in (*STUDY_KNOBS, "DEVICE", "build_config")}
    for k, v in {**STUDY_KNOBS, **(knobs or {}), "DEVICE": str(device)}.items():
        setattr(cs, k, v)
    if model_opts:
        build = cs.build_config

        def with_opts(data_dir):
            cfg = build(data_dir).clone().defrost()
            cfg.merge_from_list(list(model_opts))
            cfg.freeze()
            return cfg

        cs.build_config = with_opts
    fused_lstm.reset_launches()
    fused_attention.reset_launches()
    out = os.path.join(root, "study")
    try:
        t0 = time.perf_counter()
        cs.main([out])
        seconds = time.perf_counter() - t0
    finally:
        for k, v in saved.items():
            setattr(cs, k, v)
    with open(os.path.join(out, "convergence.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    launches = path_launches()
    splits = sorted({r["split"] for r in rows if r["model"] == "hcm"})
    print(f"phase 15d: the port's LangNav study, {cs.MODELS['hcm'][0]} at full width, "
          f"{STUDY_KNOBS}: {seconds:.1f} s; rows {splits} and the nonlearning rows; launches "
          f"{launches}")
    for r in rows:
        print(f"  {json.dumps(r)}")
    if splits != ["val_seen", "val_unseen", "val_unseen_host", "val_unseen_shuffled"]:
        fail(f"phase 15d: the study wrote rows for {splits}")
    if not (launches["lstm_seq"] and launches["lstm_seq_backward"]
            and launches["cross_modal_attn"]):
        fail(f"phase 15d: the study's path did not launch both kernels: {launches}")
    report = subprocess.run([sys.executable, "scripts/collect_study_results.py", out],
                            cwd=os.path.dirname(os.path.abspath(__file__)),
                            capture_output=True, text=True, timeout=300)
    if report.returncode != 0 or "Full per-epoch table" not in report.stdout:
        fail(f"phase 15d: scripts/collect_study_results.py did not read the study's rows: "
             f"{report.stdout[-2000:]} {report.stderr[-2000:]}")
    print("  scripts/collect_study_results.py read the rows: "
          + report.stdout.strip().splitlines()[0])
    return launches


def item8_path(device, model_opts=(), widths=None, blocks=(BLOCK_N, BLOCK_TOKENS, IMAGE_TOKENS),
               buffers=None, study_knobs=None):
    """Phase 15 (ROADMAP §A item 8): 15a the trainer from pretrained files,
    15b the module ranges, 15c the transformer blocks and their attention
    shapes, 15d the LangNav study.  Run after the key-block check: its
    S = 200 calls take the key-block kernels, and it counts its own
    launches.  Returns (launches by path, the kernels line's entries of
    15c's shapes, 15b's module times)."""
    import shutil
    import tempfile

    from robo_vln_tpu_torch.ops import _build, fused_attention

    cuda = torch.device(device).type == "cuda"
    print(f"phase 15 ({card_line() if cuda else 'no card'}): ROADMAP §A item 8 — pretrained "
          "backbones, module ranges, the remaining transformer blocks, the LangNav study")
    os.makedirs(_build.BUILD_DIR.parent, exist_ok=True)
    root = tempfile.mkdtemp(prefix="item8_", dir=_build.BUILD_DIR.parent)
    try:
        trainer, pretrained, files = pretrained_trainer(device, root, model_opts, buffers)
        module_ms = module_times(device, trainer)
        del trainer
        fused_attention.reset_launches()
        block_launches, shape_calls = blocks_path(device, widths, *blocks)
        entries = (block_shape_entries(torch.Generator().manual_seed(15), device, shape_calls)
                   if cuda else [])
        study = study_path(device, root, (*model_opts, *files), study_knobs)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"pretrained": pretrained, "blocks": block_launches, "study": study}, entries, module_ms


def _config_dir():
    from robo_vln_tpu_torch.config.default import _CONFIGS

    return _CONFIGS


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        from robo_vln_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the port is not importable ({e})", file=sys.stderr)
        return 1
    from robo_vln_tpu_torch.utils.device import float32_exact

    device = torch.device("cuda", 0)
    card = card_line()
    print(f"phase 1: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)")

    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"phase 2: built {sorted(logs) or 'nothing (up to date)'} in "
          f"{time.perf_counter() - t0:.1f} s into {_build.BUILD_DIR}")
    for name, log in logs.items():
        for kernel, regs, spill in ptxas_usage(log):
            print(f"  {name}: {kernel}: {regs} registers, {spill} bytes spill stores")
            if kernel.startswith(("cross_modal_attn_f32tc", "cross_modal_attn_f32wg",
                                  "cross_modal_attn_bf16_blocks",
                                  "cross_modal_attn_wide", "lstm_seq_backward_partials",
                                  "lstm_seq_wide")) and spill:
                fail(f"{kernel} spills {spill} bytes")
        # ptxas's note that it serialized a kernel's wgmma (each waiting for
        # the one before), which costs the float32 wide kernel most of its speed
        serialized = [line.strip() for line in log.splitlines() if "serialized" in line]
        if serialized:
            fail(f"{name}: wgmma serialized: {serialized[0]}")

    profile = "--profile" in sys.argv[1:]
    if "--only" in sys.argv[1:]:  # a partial run, to try phases on their own
        only = sys.argv[sys.argv.index("--only") + 1].split(",")
        if "9" in only:
            feature_path(device, profile=profile)
        if "10" in only:
            ondevice_path(device, profile=profile)
        if "11" in only:
            flat_path(device)
        if "12" in only:
            extras_path(device)
        if "13" in only:
            mesh_path(device)
        if "3" in only:
            with float32_exact(torch.float32):
                check_lstm(torch.Generator().manual_seed(0), device)
                check_attention(torch.Generator().manual_seed(0), device)
                check_wider_shapes(torch.Generator().manual_seed(0), device)
        if "14" in only:
            wide_path(device)
        if "15" in only:
            item8_path(device)
        print(f"chip_smoke: phases {only} passed; a partial run prints no result")
        return 0
    gen = torch.Generator().manual_seed(0)
    with float32_exact(torch.float32):  # the float32 plain versions without TF32
        lstm_kernels = check_lstm(gen, device)
        bf16_modes, attention = check_attention(gen, device)
        wider, wide_attention, wide_lstm = check_wider_shapes(gen, device)
        attention.update(wider)
    kernels = [*lstm_kernels, attention, *bf16_modes]
    # each path zeroes the launch counts before it runs; both tensor-core
    # routes' key blocks (S > 128) are read after each
    key_blocks = {}

    def read_key_blocks(suffix):
        for name, count in zip(KEY_BLOCK_COUNTS, key_block_launches()):
            key_blocks[f"{name}{suffix}_launches"] = count

    launches = main_path(device, profile)
    read_key_blocks("")
    train_launches, bare_step_ms = train_path(device, profile)
    read_key_blocks("_train")
    trainer_launches, raw_trainer = trainer_path(device, bare_step_ms, profile)
    read_key_blocks("_trainer")
    eval_launches, host_eval = eval_path(device, profile=profile)
    read_key_blocks("_eval")
    collect_launches = collect_path(device)
    read_key_blocks("_collect")
    feature_launches = feature_path(device, raw_trainer, profile=profile)
    read_key_blocks("_feature")
    ondevice_launches = ondevice_path(device, host_eval, profile=profile)
    read_key_blocks("_ondevice")
    flat_launches, (flat_forward, flat_backward), flat_timings = flat_path(device)
    read_key_blocks("_flat")
    extras_launches, _ = extras_path(device, flat_timings["trainer_step_ms"])
    read_key_blocks("_extras")
    loader_launches, mesh_launches = mesh_path(device, raw_trainer)
    read_key_blocks("_mesh")
    wide = wide_path(device)  # asserts its own key blocks (float32 at D = 256)
    print(f"key-block launches of the attention kernel (S > 128 or d > 128 in float32, S > "
          f"128 in bf16) and float32 one-float-copy launches on the serving, train, "
          f"trainer, eval, collection, feature, on-device, flat, extras and mesh paths (the "
          f"on-device paths' as the wrappers counted them, at the warm-up and the capture): "
          f"{key_blocks}")
    if any(key_blocks.values()):
        fail("an HCM path launched a key-block or one-float-copy attention kernel")
    attention.update(key_blocks)
    # phase 15 after the check: its S = 200 calls take the key-block kernels
    item8, block_entries, module_ms = item8_path(device)
    for k in kernels:
        k["launches"] = launches[k["name"]]
        k["train_launches"] = train_launches[k["name"]]
        k["trainer_launches"] = trainer_launches[k["name"]]
        k["eval_launches"] = eval_launches[k["name"]]
        k["collect_launches"] = collect_launches[k["name"]]
        k["feature_launches"] = feature_launches[k["name"]]
        k["ondevice_launches"] = ondevice_launches[k["name"]]
        k["flat_launches"] = {path: counts[k["name"]] for path, counts in flat_launches.items()}
        k["extras_launches"] = {path: counts[k["name"]]
                                for path, counts in extras_launches.items()}
        k["loader_launches"] = loader_launches[k["name"]]
        k["mesh_launches"] = {path: counts[k["name"]] for path, counts in mesh_launches.items()}
    kernels[0].update(flat_forward)  # the LSTM at the flat window's shape
    kernels[1].update(flat_backward)
    # the serving path runs no backward: the backward's launches are the train path's
    for backward in kernels[1:3]:
        backward["serving_launches"], backward["launches"] = (backward["launches"],
                                                              backward["train_launches"])
    for k in kernels:
        k["wide_launches"] = wide.get(k["name"], 0)
        k["item8_launches"] = {path: counts.get(k["name"], 0) for path, counts in item8.items()}
    # the kernels past the former ranges: phase 14 is their path (the float32
    # key blocks counted as wide_path counts them)
    counted_as = {"cross_modal_attn_f32_key_blocks": "f32_key_block"}
    for k in (*wide_attention, *wide_lstm):
        k["launches"] = wide.get(counted_as.get(k["name"], k["name"]), 0)
    if not wide_attention[0]["launches"]:
        fail("phase 14 launched the float32 key-block kernel no time")
    kernels += [*wide_attention, *wide_lstm]
    # the attention kernel at 15c's shapes: their launches are 15c's calls at them
    kernels += block_entries
    attention["item8_module_ms"] = module_ms  # 15b: device ms of each module range in a step
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
