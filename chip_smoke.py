#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`paddle_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py        # from the repository root, on a machine with a card

Phases (any failure exits non-zero and prints no result line):
  1. card    — nvidia-smi name + power limit; TF32 off for matmul and cuDNN.
  2. build   — nvcc builds every CUDA source of the port from this checkout.
  3. kernels — each kernel's wrapper on card tensors vs its plain PyTorch
               version on the same tensors, at a small odd shape and at the
               main path's shapes: paged attention at GPT-2-small decode
               shapes, S = 8 and 32 with ragged positions, S = 8 at the
               decode profile's contexts of 16-34 tokens and S = 1 at
               position 1023 (max_abs_err <= 1e-4, two calls
               bit-identical, achieved TB/s, the wrapper's host µs per
               call, and the split + merge pair's time inside a CUDA graph
               of 20 back-to-back calls, L2 flushed before each in the graph
               and the flushes' own graph time subtracted, as the decode
               step's graph holds them); the GRU forward (hs, h_last
               <= 1e-4) and backward (each of dproj, dW_zr, dW_c, db, dh0
               <= 1e-3 x max(1, max|plain|)) in both directions at
               T=7/B=5/H=24, at the seq2seq encoder's T=50/B=128/H=512
               with ragged lengths 30-50, at T=50/B=64/H=1024 (lengths
               30-50, wider than 4 units per SM) and at phase 21's
               T=64/B=128/H=512 (lengths 30-50 padded to 64); the LSTM forward (hs, h_last,
               c_last <= 1e-4) and backward (dproj, dW, db, dh0, dc0, as
               the GRU's) in both directions with non-zero h0 and c0 at
               T=7/B=5/H=24, the text classifier's T=100/B=128/H=512 with
               ragged lengths 60-100 and BASELINE's widest H=1280/B=64;
               attention (<= 1e-4) at (B,Tq,Tk,D,Dv) = (3,5,7,8,6) with a
               [B,1,Tk] and a [B,Tq,Tk] mask, each with a fully masked row,
               at (2,5,9,16,257), and timed at (32,512,512,64,64),
               (8,1024,1024,128,128) with a [B,1,Tk] mask and
               (2,512,512,512,300). Kernel, plain version and (where
               one exists) one PyTorch library call timed with CUDA events
               (L2 flushed and the card given a ~0.5 ms head start
               before each launch), beside the least time the
               card could take (bytes or operations over its peaks: f32
               for the recurrences, three TF32 passes on the tensor cores
               for attention's 3xTF32 products; a recurrent forward counts
               the rows it must compute, a backward the valid steps only). For each
               recurrent forward also its time per step, the time of its
               step loop's grid syncs alone at its own grid and T (the
               library's sync probe) and its time at B = 8, 32 and the
               main batch; for each
               recurrent backward also its layout plan, its parts from
               torch.profiler (walk, split-K dW GEMM with db folded in,
               the pass over the splits) and, as a note, torch.mm of the
               same dW sums in f32 with TF32 off.
  4. serve   — the serving engine at GPT-2 small's widths (12 layers,
               d_model 768, 12 heads, vocab 50257, max_len 1024; random
               weights from seed 0) answers 8 greedy requests of mixed prompt
               length, one chunked past the largest bucket; its first decode
               step runs eagerly, then the step is one captured CUDA graph,
               replayed. Checks: every request finished, no page leaked, one
               decode signature, one capture, the decode kernel launched
               n_layers times per decode step (replays count the calls they
               hold), and the first REPLAYED step's logits, read from the
               graph's static buffers, agree with the CPU plain path at the
               same weights and pool (atol 1e-3). Graph vs eager: the same
               inputs through a replay and through the eager step, logits
               within 1e-5 relative (bitwise recorded), greedy identical.
               Then 16 decode-only steps unprofiled (host ms a step, the
               graph's device time by CUDA events) and under torch.profiler
               (busy time and share, kernels and the top kernels a step). A
               small model's greedy tokens on the card must equal its
               tokens on the CPU. Then one sampled request on the session
               (temperature 0.8, top_k 40, seed 2^31 + 7): its tokens equal
               a CPU engine's for the same request (jax's threefry noise)
               and differ from the greedy ones.
 4b. wire    — the port's ServingServer on 127.0.0.1 port 0 over a
               serve_forever session of phase 4's configuration: phase 4's
               8 prompts through a framed ServingClient give phase 4's
               tokens exactly; then serving/workload.run_closed_loop_rpc,
               16 requests of 16-128 prompt tokens and 32 new, at
               concurrency 8 and 1 (tokens/s, TTFT p50/p99, inter-token
               p50/p99). Checks: no page leak, one decode signature,
               launches = decode steps x n_layers.
 4c. speculation — speculate_k=4 against 0 on 8 repetitive prompts, in
               process: identical tokens, one verify and one decode
               signature, free pages back where they started; acceptance
               rate and spec_effective_k printed.
 4d. recovery — the supervised engine under decode_raise:step=8 and then
               engine_stall:step=6 (stall 3 s past a 1 s watchdog): every
               request completes with phase 4's tokens exactly, one
               restart, the graph captured twice (the re-capture after
               recovery), no page leak.
 4e. layer_error — a width-5 batch into an Fc made for 8, on the card:
               LayerError naming the layer and its layer stack.
  5. train   — seq2seq NMT training at the reference's headline widths
               (bench.py:211-245: vocab 30000, embed = hidden = 512, batch
               128, lengths 50; random weights from seed 0): SGDTrainer +
               Adam(1e-3), f32, 14 steps on one batch; the first runs
               eagerly and captures the step as one CUDA graph, the other
               13 replay it (10 timed). Checks: one graph and 13 replays;
               2 forward + 2 backward GRU launches per step (encoder fw
               and bw; a replay counts the calls it holds); the first 4
               steps against an eager twin from the same parameters (costs
               within 1e-6 relative, parameters within 1e-6 relative L2,
               bitwise printed); finite costs, the last below the first.
               Then the graph's device time a step (CUDA events over 5
               back-to-back steps), torch.profiler over 2 steps (busy
               share, launches per step, top kernels, the GRU kernels'
               share) and the eager twin's step time.
 5b. checkpoint — at that width (53.7 M parameters + Adam's slots): sync
               save time; async save's training-thread stall (twice: the
               second into the kept pinned buffers), the steps run while
               it writes, the wait; the async pass bitwise the sync pass;
               load into a fresh trainer (time; state bitwise the pass);
               3 passes of 2 ragged batches killed in pass 1 (the `kill`
               fault) and auto-resumed from pass 0, bitwise equal to a
               never-stopped run (or, if two never-stopped runs differ,
               within twice their spread).
 5c. generation — the copy task (vocab 12) trained on the card through
               `train(reader.batch(...), feeder=DataFeeder(...))`
               reproduces >= 3 of 4 sequences by beam search; at full
               width on phase 5's trainer, 16 sources of 50 tokens
               (RandomState(0)), beam 4, max_len 50: each row's best score
               within 1e-3 of the CPU path's, the share of identical best
               ids printed; ms per call, kernels per generated step, 2 GRU
               forward launches per call.
  6. card vs CPU — the same model, batch 8 with ragged lengths: step-1 cost
               (1e-5 relative) and all 22 gradients (rtol 1e-3, atol 1e-4)
               on the card (kernels) vs the CPU (plain versions), same
               parameters and batch.
  7. LSTM    — text classification training, the reference's RNN benchmark
               (benchmarks/rnn_bench.py: vocab 10000, embed 128, 2 LSTM
               layers, 2 classes, SGD(0.01)) at BASELINE.md's middle LSTM
               row (hidden 512, batch 128, length 100; ids and labels from
               RandomState(0) as rnn_bench draws them), peephole-free
               layers, f32, 2 warm-up + 10 timed steps (the first eager and
               captured, the rest replays). Checks: one graph, 11 replays,
               2 forward + 2 backward LSTM launches per step, finite costs,
               the last below the first; the graph's device time,
               torch.profiler over 2 steps, eager steps timed. Then the same
               model at batch 8 with ragged lengths: step-1 cost (1e-5
               relative) and all 11 gradients (rtol 1e-3, atol 1e-4), card
               vs CPU.
  8. attention — `dot_product_attention` (its only path) at B=32,
               Tq=Tk=512, D=Dv=64 with a per-row mask: forward (1e-4) and
               q/k/v gradients (1e-4 x max(1, max|g|)) through the kernel vs
               the plain body, launches counted from 0.
  9. route   — the shapes the recurrent kernels do not lay out compute
               through the plain step loops and launch no recurrent kernel:
               lstm_scan at T=1, B=207, H=1280 and gru_scan at T=3, B=249,
               H=1280 (vs the CPU, 1e-4 and 1e-3 x max(1, max|g|)); the
               first B without a layout for each RNN at H = 512, 1024,
               1280. dot_product_attention at D=512/Dv=64 and Dv=257, with
               fused=None and fused=True, launches the attention kernel (it
               tiles D and Dv) and matches the plain body on the CPU (1e-4
               and 1e-4 x max(1, max|g|)).
 10. resnet  — ResNet-50 training as bench.py:656-830 run_bench drives the
               reference: 224x224, batch 256, 1000 classes, the bf16
               policy, SGD(0.1, momentum 0.9), 8 stacked batches a
               `multi_step` call (BENCH_SCAN), images and labels from
               RandomState(0); 1 warm-up call (eager, then its 8 steps
               captured as one CUDA graph) and 2 timed calls (replays;
               checked: one graph, 2 replays). Prints
               bench.py's fields (resnet50_images_per_sec_per_chip,
               ms_per_step, mfu over the card's dense bf16 peak with
               bench.py's 3 x 8.18 GFLOP an image, platform, device_kind,
               precision, batch_size, image_size, scan_k) and peak memory.
               Checks: finite costs, every batch-norm moving statistic
               moved from its 0 / 1 start. Then torch.profiler over one
               call: device busy share, launches per step, time by kernel
               group (conv, batch-norm reductions, elementwise, pooling)
               and the top kernels; fails if layout transposes run as
               often as the convs (the NHWC activations are to reach cuDNN
               as channels_last, uncopied).
 11. resnet vs CPU — ResNet-50 at 64x64, batch 4, 10 classes from the
               same parameters. f32 with TF32 off: step-1 cost (5e-5
               relative), all 161 gradients (each within 0.1, all together
               within 0.05, relative L2 norm) and all 106 new states (5e-4
               of each one's largest value): the whole graph is
               ill-conditioned at this size (tests/test_torch_resnet.py).
               bf16: each layer fed the CPU's input to it within 5e-2
               relative L2, all but 2 within 1e-3 (a relu may flip an
               output within an ulp of 0); the step's cost finite.
 12. lenet   — LeNet at 28x28, batch 8, f32: step-1 cost (1e-5 relative),
               all gradients (rtol 1e-3, atol 1e-4 x max(1, max|g|)) and
               the parameters after two SGD steps (atol 1e-5), card vs CPU.
 13. ctr     — CTR wide&deep (BASELINE config #4) at the JAX package's
               default widths: wide 1000, slots (1000, 1000, 500, 100),
               embed 32, hidden (128, 64); batch 4096 from RandomState(0),
               a click for every even slot-0 id (tests/test_models.py's
               pattern); f32, SGD(0.5), 2 warm-up + 10 timed steps (the first
               eager and captured as the step graph, the rest replays).
               Checks: one graph, 11 replays, no ported kernel launched
               (counters from 0: the path holds none), finite costs, the
               last below the first. Prints ms/step, examples/s, the
               graph's device ms a step and busy share, peak memory, eager
               steps timed, and torch.profiler over 2 steps (busy share,
               kernels a step, time by kernel group, top kernels). Then
               card vs CPU at tests/test_models.py:89-103's config (wide
               32, slots (16, 16), embed 8, hidden (16,), batch 32): step-1
               cost (1e-5 relative), every gradient (rtol 1e-3, atol 1e-4 x
               max(1, max|g|)), the parameters after two steps (1e-5).
 14. ocr     — OCR CRNN + CTC (BASELINE config #5) at the JAX package's
               default widths: 32x128x1 images, 80 classes, hidden 96, so 32
               frames of 512 features into a peephole bi-LSTM (the plain
               step loop, as in the JAX package); batch 128, labels of 4-16
               ids in [1, 80]; f32, SGD(0.01), steps, checks and prints as
               for ctr, plus both batch-norm moving statistics moved (inside
               the graph). Then card vs CPU at tests/test_models.py:121-137's
               config (32x64, 10 classes, hidden 16, batch 2): step-1 cost
               (1e-5 relative), every gradient (rtol 1e-3, atol 1e-4 x max(1,
               max|g|)), parameters and states after two steps (1e-4).
 15. struct ops — ctc_loss at OCR's shape (logits [128, 32, 81], frames
               25-32, labels 4-12): values (1e-5 relative) and gradients
               (1e-5 x max(1, max|g|)) card vs CPU, and against
               torch.nn.functional.ctc_loss(reduction="none") on the card
               (1e-4), with the times of forward + backward (the port eager
               and inside one CUDA graph, torch's); crf_nll at B=128, T=50,
               32 tags: values (1e-5 relative) and gradients (1e-4 x max(1,
               max|g|)) card vs CPU, crf_decode's tags equal; gru_scan
               with act="relu" at T=50, B=128, H=512: the step loop, no
               GRU kernel launch, card vs CPU.
 16. vgg     — VGG-19 (BASELINE.md:21) at 224x224, batch 64, 1000 classes,
               bf16, Momentum(0.9) with the discexp schedule after a
               2-step warmup, a ModelAverage, Dropout on jax's threefry
               bits; one batch drawn as bench.py draws images; one eager
               step, its capture and 11 replays (each step's lr, Dropout
               keys and average inside the graph). Prints images/s,
               ms/step, the graph's device ms and busy share, MFU (the
               convs' and fcs' 3 x 2 x multiply-adds over the dense bf16
               peak) and peak memory. Checks: one graph, 11 replays, finite
               costs that fall, two more replays whose drop6 outputs are
               nonzero only where jax's mask for their step keeps and whose
               masks differ, test() on the averaged parameters;
               torch.profiler over 2 steps (kernel groups). Then the
               tiny VGG-19 of tests/test_torch_vgg.py card vs CPU in f32:
               costs (1e-6 relative), gradients (1e-5 relative L2), the
               parameters and averages after 3 steps (1e-5 x max(1,
               max|p|)).
 17. prefetch — phase 16's step over 12 distinct host batches through a
               DevicePrefetcher (pinned memory, a copy stream, 2 ahead)
               against the same batches placed on the card, in turns
               (placed, prefetcher twice, placed): ms a step of each pass;
               every step a replay of the one graph.
 18. remat   — phase 10's ResNet-50 step (one step a dispatch) without
               remat and under remat="conv_only": ms/step, graph device
               ms and peak memory of each; the updates equal within 1e-6
               relative L2 (or twice the spread of two runs without remat).
 19. guard   — on phase 5's seq2seq trainer (GRU launches from 0): a
               `nan_loss` batch under skip_batch leaves the state of a run
               without that batch (bitwise, or within twice the spread of
               two clean runs); rollback restores pass 0 and halves
               lr_scale; a `preempt` drain mid-pass and its auto-resume end
               where an unbroken run ends; the replayed step's ms with the
               guard and without it.
 20. optim   — the seven optimizers on phase 7's LSTM trainer (LSTM
               launches from 0): one eager step, its capture and 3 replays
               at full width, then card vs CPU at batch 8 over 4 ragged
               batches (costs 1e-5 relative, parameters and slots 1e-3
               relative L2).
 21. v1_bigru — the v1 config pipeline: a v1 bi-GRU text config
               (embedding_layer -> bidirectional_gru -> fc softmax,
               classification_cost with its classification_error evaluator,
               Adam) at the seq2seq encoder's widths (vocab 30000, 512,
               batch 128, lengths 30-50, 24 batches a pass) through
               `paddle_tpu_torch.cli` (`parse_args`, `prepare_train`, then
               the job's `run`, as `main` runs `train`) in process, 2 passes with --save_dir (GRU counters from 0):
               both GRU kernels for both directions every step (and both
               forwards at the init and each test batch), one graph, every later step a
               replay, avg_cost falls, the evaluator counted every example
               of the pass, pass-00001 written; then --job=time (ms/step,
               tokens/s over every timed batch's real tokens, GRU launches
               a step), 5 replays under torch.profiler (the device's busy
               ms a step and busy share, both over that window),
               --job=test from pass-00001,
               dump_config against the parse, and the config at vocab 64,
               size 16, batch 8 card vs CPU over its first 4 logged step
               costs (the first 1e-5 relative, all 1e-4).
 22. v1_lenet — the v1 MNIST LeNet config (two simple_img_conv_pool, fc 10
               softmax, Momentum(0.9), batch 128, 20 batches a pass, 2
               passes): one graph, the cost falls, no recurrent kernel;
               --job=time (images/s), then busy ms and busy share as
               phase 21's; card vs CPU
               over its first 4 logged step costs.
 23. v1_seq2seq — the reference's seqToseq demo network
               (demo/seqToseq/seqToseq_net.py, is_generating=False: two
               simple_gru encoders, each a gru_group of gru_step layers,
               and a recurrent_group decoder of simple_attention, a mixed
               projection, gru_step and a 30000-wide softmax mixed layer,
               StaticInputs of the encoder, a memory booted from the
               backward encoder's first step, classification_cost, Adam
               5e-4) at train.conf's widths (vocab 30000, 512, batch 128,
               every sequence 50 long, padded to 64; ids drawn as bench.py
               draws them; 4 batches a pass, 2 passes) through
               `paddle_tpu_torch.cli` in process (recurrent counters from
               0), 2 passes with --save_dir (phase 26 generates from its
               pass-00001): one graph, every later step a replay, avg_cost
               falls, no recurrent kernel launch, peak memory; --job=time over 8
               batches (ms a step, target tokens/s), 5 replays under
               torch.profiler (busy ms, busy share, kernels a replay);
               dump_config against the parse; gru_group's output against
               simple_gru2's fused kernels on one parameter dict at vocab
               30000 / 512 / batch 128 / lengths 30-50, both directions
               (relative L2 <= 1e-4); the config at vocab 64, width 16,
               batch 8 card vs CPU over its first 4 logged step costs.
 24. v2_api  — a paddle.v2 script at phase 21's widths: v2.init, data /
               embedding(512) / two networks.simple_gru(512) (forward and
               reverse) / last_seq and first_seq / fc(2, Softmax) /
               classification_cost, parameters.create, trainer.SGD with
               Adam(1e-3), train(batch(reader, 128), 2 passes of 8
               batches, event_handler, feeding) (GRU counters from 0):
               2 + 2 GRU launches a step (and the state's init forward),
               one graph, every later step a replay, EndIteration costs
               fall, EndPass each pass; test() finite; to_tar -> from_tar
               bitwise; ms a step over 10 replays, tokens/s, busy share;
               Inference.infer over 256 samples in chunks of 128 ->
               values [256, 2] and ids [256], both GRU forwards each
               chunk, its ms per 128; the script at vocab 64, width 16,
               batch 8 card vs CPU over its first 4 EndIteration costs.
 25. deploy  — phase 21's pass-00001 through `merge_model` (the CLI, in
               process), `capi.create_for_inference`: forward on a batch
               of 128 equals the trainer's test forward on the pass's
               parameters within 1e-6 relative, forward and
               get_layer_output each launch both GRU forwards once;
               merge_model_v1 writes its file; api.GradientMachine /
               Arguments (ragged start positions) on phase 24's model:
               forward and getLayerOutput agree, forwardBackward's
               gradients finite; the merge's s, the load's s and the
               forward's ms.
 26. v1_gen  — the seqToseq demo's generating half
               (demo/seqToseq/seqToseq_net.py, is_generating=True: phase
               23's network with the decoder step under beam_search, the
               target table a GeneratedInput named as the training
               config's, beam 3, max_length 250, a seqtext printer over
               sent_id and the 30000-word dictionary,
               Outputs('__beam_search_predict__')) on phase 23's
               pass-00001 through one GenerationSession: two batches of
               128 sources of 30-50 ids (recurrent counters from 0): 128
               lines a batch, lengths in [1, 250], scores best first, the
               printed words the best beam's, the second call neither
               rebuilds nor reloads, no recurrent kernel; ms a call,
               kernels a generated step (torch.profiler over one call /
               250), best-beam tokens/s, peak memory;
               api.SequenceGenerator on the same parameters gives the
               session's best beams; card vs CPU at vocab 64, width 16,
               batch 8, beam 3, max_length 12 on one parameter dict: ids
               identical, scores within 1e-5 relative.
 27. serve_config — `python -m paddle_tpu_torch serve --config=gen.conf
               --model_dir=.../pass-00001 --port=0` as a subprocess on the
               card: phase 26's first batch through the framed client's
               generate_config returns phase 26's result file byte for
               byte, twice; the request's ms; SIGTERM, exit code 0.
 28. v2_gen  — the paddle.v2 book's machine translation network at phase
               23's widths (two networks.simple_gru encoders, the fused
               GRU; simple_attention, gru_step and a 30000-wide softmax in a
               recurrent_group): trainer.SGD with Adam(5e-4) over 4 batches
               of 128 (GRU counters from 0: 2 + 2 a step and the init's
               forward, one graph), to_tar -> from_tar bitwise; the
               generating topology (layer.beam_search, GeneratedInput by
               embedding name, beam 3, max_length 50) through
               Inference.infer(field="value") over 256 sources in chunks of
               128: ids [256, 50] int32, 2 GRU forward launches a chunk, the
               first chunk equal to a Network forward of it; ms per 128.
 29. v1_proto — phase 21's config on TrainData(ProtoData(files=...,
               type="proto_sequence")) and TestData(...), the shards
               written by the port's write_shard from phase 21's samples
               in its order (8 batches of 128 a pass, 2 test batches), 2
               passes through the CLI (counters from 0): one graph, every
               later step a replay, 2 + 2 GRU launches a step, avg_cost
               falls; --job=time (ms a step, tokens/s); --job=test from its
               pass-00001 on this config and on phase 21's PyDataProvider2
               config: the same per-batch costs within 1e-6 relative.
 30. book_nmt — the paddle.v2 book's machine translation chapter,
               unchanged, through paddle.dataset.wmt14 (synthetic records:
               nothing cached, nothing fetched): train(30000) ->
               reader.shuffle(8192) -> batch(128) -> trainer.SGD with
               Adam(5e-5) over 8 batches of phase 28's network at vocab
               30000 / 512 (GRU counters from 0: 2 + 2 a step and the
               init's forward; every step after a signature's first a
               replay); the first 2 batches' costs card vs CPU from the
               same parameters; layer.beam_search (beam 3, max_length 50)
               through infer over 128 sources of wmt14.test(30000), 2 GRU
               forwards a chunk, every id a word of wmt14.get_dict(30000);
               ms a step, target tokens/s, graphs, infer ms per 128, peak
               memory.
 31. book    — the book's seven other chapters, unchanged, each through
               its reader over 8 batches (the first 2 also on the CPU from
               the same parameters): fit_a_line (uci_housing),
               recognize_digits (mnist, two conv-pools of 20 and 50),
               image_classification (cifar.train10, vgg_bn_drop),
               word2vec (imikolov, 5-grams, emb 32 shared, hidden 256),
               recommender_system (movielens, batch 256: id embeddings of
               32 and 16 through fcs, the categories as a sparse binary
               vector, the title through sequence_conv_pool, two 200-wide
               tanh fcs, cos_sim(scale=5), square_error_cost, Adam(1e-4);
               one graph), understand_sentiment (imdb, stacked_lstm_net
               128 / 512 / 3, ModelAverage) and label_semantic_roles
               (conll05.test(), db_lstm depth 8, hidden 512, batch 32, crf
               + crf_decoding, ModelAverage): finite costs, the first 2
               batches' costs card vs CPU, SRL's decoded ids inside the
               label dictionary; ms a step each, and whether the cost fell.
 32. image_models — AlexNet and GoogLeNet as benchmarks/image_bench.py
               trains them: 224x224, 1000 classes, batch 128 (labels
               randint(0, 10)), SGD(0.01, momentum 0.9), in f32 (TF32 off)
               and bf16, 8 steps each (one graph, 7 replays): ms a step
               (host clock), the graph's device ms, images/s, MFU over 3 x
               2 x the convs' and fcs' multiply-adds, peak memory,
               torch.profiler's busy share, kernels a step and kernel
               groups (fewer layout transposes than convs); costs finite
               and falling; then each model at 64x64, batch 4 in f32, cost
               and gradients card vs CPU.
 33. v1_alexnet — the reference's benchmark/paddle/image/alexnet.py as a v1
               config (227x227x3, batch 128 through --config_args)
               through `train --job=time` over 8 replays of one graph: ms
               a batch, images/s, busy share; dump_config equal to the
               parse; the first 4 logged costs card vs CPU at 67x67.
 34. vocab   — each of the 36 layers of the v1 vocabulary (ROADMAP §1
               items 6a-6b; VOCAB_CASES, with further shapes and options)
               forward and backward card vs CPU, f32: within 1e-5
               relative L2; SamplingId's ids and EosIdCheck's flags equal.
 35. v1_vocab — a v1 config over the new helpers and `1 + layer_math.exp(x)
               * z` through `train --config` for 8 steps: one graph, the
               cost falls, print_layer's line once a step, dump_config
               equal to the parse, the first 4 costs card vs CPU.
 36. fluid_digits — recognize_digits' conv net as a fluid Program
               (fluid.layers: conv 20 and 50 of 5x5 with relu, 2x2 max
               pools, fc 10 softmax, cross_entropy, accuracy; Adam 1e-3)
               over 20 `exe.run` calls at batch 64 on mnist's synthetic
               records: runs 1-2 eager, run 2 captured as one CUDA graph,
               18 replays; the loss falls; the first 2 losses card vs
               CPU from the same scope; the eager interpreter on the card
               against 3 replays; ms a run (the fetch included), the
               graph's device ms, kernels a replay, peak memory.
 37. fluid_lstm — the fluid LSTM text classifier (lookup_table, mul, the
               lstm op with SeqLengths, last_h, mul, softmax,
               cross_entropy, mean; Adam) at vocab 10000, 128, 512, batch
               128, length 100 (lengths 60-100), 12 runs of one batch: one
               graph, the loss falls; ms a run, real tokens/s, kernels a
               replay, peak memory; card vs CPU at batch 8.
 38. fluid_control — card vs CPU: a recurrent op over gru_unit (T 50, B
               128, H 512, SGD; one graph), the while counter (eager: its
               trip count is a device value), cond with a scalar and a
               per-sample condition at [128, 512], beam_search +
               beam_search_decode at B 128, K 3, V 30000 over 8 steps,
               save -> load inside a graphed run; each program's route.
 39. gan     — the GAN demo through MultiNetworkTrainer, batch 128, 400
               alternating iterations: one graph a phase, every later
               step a replay; the generator's mean within half its
               starting distance of the data mean; the shared dis_*
               bitwise equal in both phases; ms an iteration.
 40. ssd     — models/ssd.py at its defaults (96x96x3, 21 classes, widths
               32/64/128, 12 096 priors) at batch 32 of 1-8 gt boxes an
               image, Adam(1e-3), 20 steps of one batch through
               SGDTrainer: one graph, 19 replays, no ported kernel
               launched, the cost falls; ms a step (host clock), the
               graph's device ms, images/s, busy share, kernels a step,
               peak memory. Card vs CPU at batch 4 (SGD(0.01)): the first
               2 costs (1e-5, 1e-4), every gradient (1e-4 x max(1,
               max|g|)). DetectionOutput on the trained parameters at
               batch 4, card vs CPU from the same head outputs: labels
               equal, scores and boxes within 1e-5 (rows in a score tie
               matched as a set); ms and kernels of a detection call at
               batch 32; detection_map (11-point) over 4 batches.
 41. struct_costs — NCE (uniform, and by a distribution), hsigmoid,
               LambdaCost and CrossEntropyOverBeam (B 512, D 256, 10 000
               classes; 64 queries of 32 documents; 3 beam expansions)
               card vs CPU: cost 1e-5, gradients 1e-4 x max(1, max|g|);
               then the book's word2vec with hsigmoid and with NCE in its
               softmax's place and the LambdaRank demo over mq2007's
               listwise queries, 8 batches each through paddle.v2: one
               graph, 7 replays, the cost falls.
 42. rnn_extra — SimpleRnn (B 64, T 50, H 256) both ways and MDLstm (B 8,
               16 x 16, 32 units) in all four direction pairs: output
               card vs CPU within 1e-5 relative L2, gradients within 5e-4
               of a float64 CPU run (the CPU's f32 distance printed); a v1 config of a bidirectional recurrent_layer text
               classifier through `train --config` for 8 steps: one graph,
               the cost falls.
 43. layers3d — Conv3D, Conv3DTranspose and Pool3D (max, avg with
               ceil_mode) over [8, 16, 16, 16, 16] in f32 with TF32 off,
               output and gradients card vs CPU within 1e-5 relative L2;
               ms of a forward + backward.
 44. runtime — g++ builds the native library (seconds printed);
               recordio.convert shards mnist's synthetic records (each
               shard read back equal to the Python oracle's); a TaskMaster
               hands them out one shard a task and recognize_digits trains
               8 batches on them through paddle.v2's DataFeeder as one
               graph, the cost falling; a HostPool array stages a batch;
               one native update of each optimizer type against optim/.
 45. fleet   — the router drill in one process at phase 4's
               configuration: a RouterServer (lease 0.8 s, poll 0.01 s)
               in front of three ServingServer replicas, each warmed (its
               decode graph captured on its own engine thread) before the
               next is built and before it joins. 48 requests of
               PROMPT_LENS' mix, 32 new tokens, one submit every 50 ms,
               odd ones sampled (temperature 0.8, top_k 20, seed 1000+i):
               first unfaulted (tokens equal a direct single session's for
               the same open-loop requests; tokens/s against that one
               replica), then 12 of them with decode_raise firing once,
               fleet-wide (one replica restarts and re-captures its graph
               while the others replay theirs: tokens unchanged), then on
               a fresh fleet faulted — replica 0 kill()ed mid-decode,
               replica 1 wedged between steps on its generation lock for
               2 s, past its lease, then healed. Gates: every request
               finishes or fails with a named reason, finished tokens
               bitwise the unfaulted run's (greedy and sampled), no
               duplicate delivery and >= 1 late winner dropped, no page
               leaked on a survivor, launches = decode steps x n_layers
               (CAPTURED through the replays) with every graph holding 12
               kernel calls, goodput retention >= 0.7. Printed: TTFT
               p50/p99 through the router against the direct session,
               tokens/s, kill -> first token on the survivor, RPCs per
               request, each replica's decode steps and graph replays, and
               where a request's time went (forward RPC, the replica's
               queue and prefill, the pump cycle, ms a decoded token).
 46. fleet_processes — what a deployment runs: `python -m
               paddle_tpu_torch.serving.router serve` as a process, a
               RouterStandby watching it from this one, two `python -m
               paddle_tpu_torch serve --demo` replicas at phase 4's widths
               with `--router_endpoints PRIMARY,STANDBY`. A burst of 16
               through the router against the same burst on one replica
               (tokens/s); then 16 streams through a ServingClient given
               both endpoints, one replica SIGKILLed once the router
               shows work in flight on it (its work fails over); then 16
               more, the router process SIGKILLed once the survivor has
               work in flight (the standby takes over, its
               sweep adopts the survivor's work, the streams reattach by
               key and cursor). Gates: every stream delivers its tokens
               exactly once, equal to phase 45's unfaulted run; the
               survivor leaks no page and its launches = its decode steps
               x n_layers; takeover and rejoin times printed.
 47. cluster — cluster training through the task master, as processes:
               `python -m paddle_tpu_torch.runtime.master serve --faults
               master_kill:step=N` on a snapshot, a `... master standby`
               process on the same snapshot, and two trainer processes,
               each running the CLI's `train --config=<phase 21's config>
               --master_endpoints=PRIMARY,STANDBY --device=cuda` (as
               `chip_smoke.py --cluster-trainer`, which prints the
               process's kernel counts and step stamps) at phase 21's
               widths; phase 21's 24 batches pickled into recordio shards,
               one batch a task, through `cluster_reader`. The primary dies
               mid-pass, the standby takes over, both trainers fail over.
               Gates: done == ntasks and discarded == 0 on the standby, the
               primary's exit KILLED_EXIT and the standby's takeover line,
               both trainers trained (every task's batch was trained by
               some trainer) and failed over, each ran one step graph with
               gru_seq_fused fwd = 2 x (steps + test batches + the init's
               forward) and bwd = 2 x steps, the cost falls. Printed: kill
               -> the standby serving, kill -> each trainer's next logged
               step, in ms.
 48. autoscale — `python -m paddle_tpu_torch.serving.router serve
               --autoscale --autoscale_master M` in front of one `python -m
               paddle_tpu_torch serve --demo --exit_on_drain` replica at
               phase 4's widths; a master process seeded with
               `--initial_world 1` and one trainer of phase 47 pulling its
               tasks (paced by the h2d_delay site). 3 logical chips. Phase
               45's 48 requests twice at once through the router (a
               burst), idle, then the burst again. Gates: the controller's
               decisions are spawn, drain, lend (resize to 2) and reclaim
               (resize to 1) in that order; every request finishes with a
               direct session's tokens; the epochs settle (idle, none timed
               out) and the trainer's reader drained through both and
               trained after the reclaim, on one graph with its GRU
               launches = 2 x steps (+ the init's forward); every replica
               that served launched the decode kernel decode steps x 12
               times. Printed: spawn -> the replica live in the router's
               view, in s; the decision log and the signals' timeline.
 49. dp_resnet — phase 10's ResNet-50 step (224x224, batch 256, bf16,
               SGD(0.1, momentum 0.9), K = 8 a call) through
               `DataParallel(make_mesh({"data": 1}))` over a one-rank NCCL
               group, as bench.py runs it on a one-chip host, for the
               replicated, zero1 and zero3 updaters: a warm-up call (eager,
               then captured with its collectives) and two replays each.
               Gates: one graph each; collective counts = the CPU tests'
               pins a step (batch norm's 2 all-reduces x 53 layers, plus the
               updater's); parameters and moving statistics bitwise a
               mesh-less trainer's after the same calls; finite costs.
               Printed: images/s, ms a step against phase 10, MFU, peak
               memory, optimizer-state bytes, the NCCL kernels' share of
               device time and count a step (torch.profiler).
 50. dp_seq2seq — phase 5's seq2seq through DataParallel on that group:
               replicated at K = 1 (its first 4 steps vs a mesh-less
               trainer, bitwise) and zero2 + int8 at K = 4. Gates:
               gru_seq_fused 2 + 2 launches an update; one gradient
               all-to-all and one all-gather a zero2 dispatch; the int8
               residual non-zero after the first dispatch; the cost falls;
               one graph each.
 51. tp_serve — tensor-parallel serving at GPT-2-small widths with the
               padded vocab of 50 304 (50 257 does not divide by 2): two
               rank threads on cuda:0 over one gloo group
               (`make_demo_session(tp=2, group=...)`: rank 0's session
               leads, rank 1's TPWorker repeats its calls), 8 prompts of
               PROMPT_LENS x 32 new tokens greedy and one SAMPLED request,
               against a tp 0 session on the same seeded weights. Gates:
               tokens identical (where one differs: the step and the tp 0
               top-2 logit gap there are printed, and the phase fails);
               paged_attention_decode launched decode steps x 12 on each
               rank, at 6 heads; the kernel at H = 6 vs its plain version
               (1e-4); per decode step 2 x 12 + 1 all-reduces and 1
               all-gather on the model axis; pool bytes a rank half of tp
               0's and parameter bytes within 52 %; the decode step eager
               ("eager: gloo group": gloo cannot be captured). Printed: ms
               a decoded token and a decode step at tp 2 (eager, gloo)
               beside tp 0 (the decode graph), a finding and not a claim.
 52. lines   — nvidia-smi line, {"kernels": [...]}, then the last line
               {"ok": true, "device": {...}}.

Details also go to build/chip_smoke.json (ignored by git).

    python3 chip_smoke.py --tp-serve

runs only phase 51 after the build.

    python3 chip_smoke.py --train-of DIR

runs only the training phases 5, 7 and 10 of the chip_smoke.py in DIR (a
checkout of another commit, e.g. `git archive` of the parent unpacked under
build/) on DIR's own package, and prints one `train_of` summary line: the
way to compare two commits' training steps in one chip call."""

from __future__ import annotations

import itertools
import json
import os
import re
import statistics
import subprocess
import sys
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# H100/H200 data-sheet peaks (SXM parts unless named): memory bytes/s, f32
# FLOP/s outside the tensor cores, and dense TF32 and dense bf16 FLOP/s on them
_PEAKS = (
    ("H200", 4.8e12, 67e12, 495e12, 989e12),
    ("H100 NVL", 3.9e12, 60e12, 417.5e12, 835.5e12),
    ("H100 PCIe", 2.0e12, 51e12, 378e12, 756e12),
    ("H100", 3.35e12, 67e12, 495e12, 989e12),
)

GPT2_SMALL = dict(vocab=50257, n_layers=12, d_model=768, n_heads=12)
PROMPT_LENS = (16, 40, 100, 128, 200, 350, 500, 700)
NEW_TOKENS = 32
# phase 4's sampled request: a seed past 2^31 (seeds are uint32 per request)
SAMPLED = dict(temperature=0.8, top_k=40, seed=2**31 + 7)
KERNEL_TOL = 1e-4
LOGITS_TOL = 1e-3
GRAPH_RTOL = 1e-5
# the reference's headline NMT training shape (bench.py:211-245, the
# train.conf scale of demo/seqToseq): vocab 30k, embed = hidden = 512
S2S = dict(vocab=30000, embed=512, hidden=512, batch=128, src_len=50, trg_len=50)
TRAIN_WARMUP, TRAIN_STEPS = 2, 10
# the training step as a CUDA graph: the first REPLAY_CHECK_STEPS steps (one
# eager + capture, then replays) against an eager twin from the same
# parameters, costs and parameters within REPLAY_RTOL relative; the eager
# twin's step time from TRAIN_EAGER_STEPS steps (the first dropped)
REPLAY_CHECK_STEPS = 4
REPLAY_RTOL = 1e-6
TRAIN_EAGER_STEPS = 6
# generation at full width on phase 5's parameters (16 sources of 50 tokens,
# beam 4, max_len 50); best-beam scores card vs CPU within GEN_SCORE_TOL
GEN = dict(batch=16, src_len=50, beam=4, max_len=50)
GEN_SCORE_TOL = 1e-3
GRU_FWD_TOL = 1e-4
# dW and db sum T*B = 6400 terms in another order than the plain version
GRU_BWD_RTOL = 1e-3
CPU_BATCH = 8
CPU_COST_RTOL = 1e-5
CPU_GRAD_TOL = dict(rtol=1e-3, atol=1e-4)
# the reference's RNN benchmark (benchmarks/rnn_bench.py: vocab 10000, embed
# 128, 2 LSTM layers, 2 classes, SGD(0.01)) at BASELINE.md's middle LSTM
# row (hidden 512, batch 128, sequence length 100), peephole-free layers
LSTM = dict(vocab=10000, embed=128, hidden=512, layers=2, classes=2, batch=128,
            seq_len=100)
LSTM_FWD_TOL = 1e-4
# dW and db sum up to T*B = 12800 terms in another order than the plain version
LSTM_BWD_RTOL = 1e-3
# attention: B, Tq, Tk, D, Dv of the large kernel shape
ATTN_MAIN = (32, 512, 512, 64, 64)
ATTN_TOL = 1e-4
ATTN_GRAD_RTOL = 1e-4
# the reference's headline benchmark (bench.py:656-830 run_bench): ResNet-50,
# 224x224, batch 256, 1000 classes, SGD(0.1, momentum 0.9), the bf16 policy,
# 8 steps a dispatch (BENCH_SCAN); 1 warm-up and 2 timed dispatches here
RESNET = dict(image_size=224, batch=256, classes=1000, scan_k=8, warmup=1, dispatches=2)
# bench.py's count: ResNet-50 forward at 224x224 is 8.18 GFLOP, training 3x
RESNET_FLOPS_PER_IMAGE = 3 * 8.18e9
# card vs CPU at bench.py's reduced shape (64x64, batch 4, 10 classes).
# The whole graph is ill-conditioned there (tests/test_torch_resnet.py: two
# f32 evaluations' gradients part by percents), so its gradients are held
# as vectors (relative L2 norm), its states to a share of their largest
# value; in bf16 each layer is held on its own, fed the CPU's input to it
RESNET_CPU = dict(image_size=64, batch=4, classes=10)
RESNET_COST_RTOL = 5e-5
RESNET_GRAD_REL_L2 = 0.1
RESNET_ALL_GRADS_REL_L2 = 0.05
RESNET_STATE_RTOL = 5e-4
RESNET_BF16_LAYER_REL_L2 = 5e-2
RESNET_BF16_LAYER_TIGHT = 1e-3
RESNET_BF16_RELU_FLIPS = 2
# LeNet (BASELINE config #1) at MNIST's 28x28, batch 8
LENET_BATCH = 8
# CTR wide&deep (BASELINE config #4) at the JAX package's default widths
# (paddle_tpu/models/ctr.py:20-26); no bench in the repo drives config #4,
# so the batch is this script's choice; SGD(0.5), the test's rate
CTR = dict(wide_dim=1000, slot_vocab_sizes=(1000, 1000, 500, 100), embed_dim=32,
           hidden_dims=(128, 64))
CTR_BATCH = 4096
CTR_LR = 0.5
# and at tests/test_models.py:89-103's config, card vs CPU
CTR_SMALL = dict(wide_dim=32, slot_vocab_sizes=(16, 16), embed_dim=8, hidden_dims=(16,))
CTR_SMALL_BATCH = 32
# OCR CRNN + CTC (BASELINE config #5) at the JAX package's default widths
# (paddle_tpu/models/ocr_crnn.py:16-22: 32x128x1, 80 classes, hidden 96, so
# 32 frames of 512 features), batch 128 (this script's choice), labels of
# 4-16 ids in [1, 80], SGD(0.01)
OCR = dict(image_height=32, image_width=128, num_channels=1, num_classes=80, rnn_hidden=96)
OCR_BATCH = 128
OCR_LABELS = (4, 16)
OCR_LR = 0.01
# and at tests/test_models.py:121-137's config, card vs CPU
OCR_SMALL = dict(image_height=32, image_width=64, num_classes=10, rnn_hidden=16)
MODEL_WARMUP, MODEL_STEPS = 2, 10
# CTC at OCR's shape with ragged frames (25-32) and labels (4-12); CRF at a
# sequence-tagging shape of this script's choice: B=128, T=50, 32 tags;
# Gru(act="relu") at the seq2seq encoder's T=50, B=128, H=512
CTC_SHAPE = dict(b=OCR_BATCH, t=32, c=OCR["num_classes"] + 1, l=12)
CRF_SHAPE = dict(b=128, t=50, c=32)
STRUCT_RTOL = 1e-5
TORCH_CTC_RTOL = 1e-4
# VGG-19 (BASELINE.md:21, "VGG-19 train, images/sec @ bs 64/128/256") at
# 224x224, batch 64, 1000 classes, the bf16 policy, Momentum(0.9) with the
# discexp schedule (x0.5 every 8 steps) after a 2-step warmup, and a
# ModelAverage; one eager step, its capture and 11 replays
VGG = dict(image_size=224, batch=64, classes=1000, fc_dim=4096, lr=0.005, decay_a=0.5,
           decay_b=8 * 64, warmup=2 * 64, steps=12)
# and at tests/test_torch_vgg.py's config, card vs CPU in f32, held to that
# test's tolerances: costs 1e-6 relative, gradients 1e-5 relative L2; the
# parameters and averages after 3 steps within 1e-5 x max(1, max|p|), as
# LeNet's (the conv biases start at 0 and stay near 1e-4, where a relative
# L2 reads the reduction order of their gradients' sums)
VGG_SMALL = dict(image_size=32, batch=4, classes=10, fc_dim=64)
VGG_COST_RTOL, VGG_REL_L2, VGG_PARAM_ATOL = 1e-6, 1e-5, 1e-5
# remat on phase 10's ResNet-50 (224x224, batch 256, bf16, one step a
# dispatch): one eager step and its capture, 3 timed replays, 2 replays
# under CUDA events; updates within tests/test_torch_remat.py's 1e-6, or
# within twice the spread of two runs without remat where those differ
REMAT_STEPS, REMAT_RTOL = 4, 1e-6
# the seven optimizers of paddle_tpu/optim/optimizers.py on phase 7's LSTM
# trainer: one eager step, its capture and 3 replays at full width, then
# card vs CPU at batch 8 over 4 ragged batches (costs 1e-5 relative,
# parameters and slots 1e-3 relative L2: an adaptive step divides by |g|)
OPT_STEPS, OPT_COST_RTOL, OPT_REL_L2 = 4, 1e-5, 1e-3
# the prefetcher phase: 12 distinct VGG batches a pass, 2 batches ahead
PREFETCH_BATCHES, PREFETCH_DEPTH = 12, 2
# the v1 config pipeline (`python -m paddle_tpu_torch train --config=...`):
# the reference's quick_start bidirectional text classifier with
# bidirectional_gru for bidirectional_lstm, at the seq2seq encoder's widths
# (bench.py:211-245: vocab 30000, 512 wide, batch 128), lengths 30-50 drawn
# from RandomState as phase 5 draws them, 24 batches a pass, 2 passes;
# the first 4 ids of a sequence say its label. Card vs CPU at vocab 64,
# size 16, batch 8: the first V1_CPU_STEPS logged step costs, the first
# within CPU_COST_RTOL, the others (Adam's steps on top) within V1_CPU_RTOL
V1_BIGRU = dict(vocab=30000, size=512, batch=128, batches=24, test_batches=2,
                min_len=30, max_len=50, passes=2, time_batches=20)
V1_BIGRU_SMALL = dict(vocab=64, size=16, batch=8, batches=4, test_batches=1)
V1_CPU_STEPS, V1_CPU_RTOL = 4, 1e-4
# replays under torch.profiler after --job=time: the busy ms a step and the
# busy share (kernel time over wall time) come from this one window
V1_PROFILE_STEPS = 5
# the v1 MNIST LeNet (BASELINE config #1 as a v1 config: two
# simple_img_conv_pool of 20 and 50 5x5 filters, fc 10 softmax),
# Momentum(0.9), batch 128, 20 batches a pass, 2 passes; card vs CPU over
# its first V1_CPU_STEPS logged steps at 4 batches
V1_LENET = dict(batch=128, batches=20, test_batches=2, passes=2, time_batches=20)

# the v1 seqToseq demo (demo/seqToseq/seqToseq_net.py, is_generating=False)
# through recurrent_group at train.conf's widths (bench.py:191,211-245):
# vocab 30000 both sides, word vectors, encoder and decoder 512, batch 128,
# every sequence 50 long, ids drawn as bench.py draws them; Adam 5e-4 as the
# demo sets it; 4 batches a pass, 2 passes (the same 4 batches), then
# --job=time over 8 batches. Card vs CPU at vocab 64, width 16, batch 8.
# gru_group's output against simple_gru2's fused kernel on one parameter
# dict at vocab 30000 / 512 / batch 128 / lengths 30-50: relative L2
V1_S2S = dict(vocab=30000, size=512, batch=128, batches=4, length=50, passes=2,
              time_batches=8)
V1_S2S_SMALL = dict(vocab=64, size=16, batch=8, batches=4, length=6)
GRU_GROUP_RTOL = 1e-4
# the paddle.v2 script: the v1 bi-GRU's widths (vocab 30000, 512, batch 128,
# lengths 30-50), 8 batches a pass, 2 passes; infer over 256 samples in
# chunks of 128; card vs CPU at vocab 64, width 16, batch 8
V2_API = dict(vocab=30000, size=512, batch=128, batches=8, passes=2, min_len=30,
              max_len=50, infer=256, time_steps=10)
V2_API_SMALL = dict(vocab=64, size=16, batch=8, batches=4, passes=1, min_len=3,
                    max_len=6, infer=16, time_steps=0)
# the merged model serves forwards equal to the trainer's test forward
DEPLOY_RTOL = 1e-6
# the seqToseq demo's generating config on phase 23's pass: two batches of
# 128 sources of 30-50 ids (bench.py's draws), beam 3, max_length 250; card
# vs CPU at vocab 64, width 16, batch 8, beam 3, max_length 12 on one
# parameter dict (the init's times `scale`: sharper distributions, fewer
# near-ties; not so sharp that a step's best log-probability nears 0,
# where log(p) of an f32 p near 1 keeps few digits in either package):
# ids identical, scores within GEN_SMALL_RTOL
V1_GEN = dict(vocab=30000, batch=128, min_len=30, max_len=50)
V1_GEN_SMALL = dict(vocab=64, size=16, batch=8, beam=3, max_length=12, min_len=3,
                    max_len=8, scale=2.0)
GEN_SMALL_RTOL = 1e-5
# the paddle.v2 book's NMT network at phase 23's widths: Adam(5e-4), 4
# batches of 128 (every sequence 50), then beam 3, max_length 50 over 256
# sources of 30-50 ids in chunks of 128
V2_GEN = dict(vocab=30000, size=512, batch=128, batches=4, length=50, beam=3,
              max_length=50, infer=256, min_len=30, max_len=50)
# phase 21's bi-GRU config on proto_sequence shards of phase 21's samples:
# 8 batches of 128 a pass, 2 passes, 2 test batches; the test batches'
# costs equal to the PyDataProvider2 config's within PROTO_RTOL
V1_PROTO = dict(vocab=30000, size=512, batch=128, batches=8, test_batches=2, passes=2,
                min_len=30, max_len=50)
PROTO_RTOL = 1e-6
# the paddle.v2 book's machine translation chapter through wmt14: vocab
# 30000, 512, batch 128, 8 batches (the first BOOK_CPU_STEPS also on the
# CPU from the same parameters); beam 3, max_length 50 over 128 test sources
BOOK_NMT = dict(vocab=30000, size=512, batch=128, batches=8, beam=3, max_length=50,
                infer=128)
BOOK_CPU_STEPS = 2
# the book's six other chapters at its widths, 8 batches each (batch 128;
# SRL 32 over conll05.test()'s 512 records), ModelAverage where the book
# passes it
BOOK_BATCHES = 8
BOOK = dict(
    fit_a_line=dict(batch=128),
    recognize_digits=dict(batch=128, filters=(20, 50)),
    image_classification=dict(batch=128, fc=512,
                              stages=((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))),
    word2vec=dict(batch=128, emb=32, hidden=256),
    recommender_system=dict(batch=256, emb=32, small=16, combined=200, title_dict=5000),
    understand_sentiment=dict(batch=128, emb=128, hidden=512, stacked=3, average=True),
    label_semantic_roles=dict(batch=32, word_dim=32, mark_dim=5, hidden=512, depth=8,
                              average=True),
)
# the fluid stack on the card (phases 36-38). 36: recognize_digits' conv
# net in fluid.layers (two conv-pools of 20 and 50, fc 10 softmax, Adam
# 1e-3) at batch 64 over 20 runs of mnist's synthetic records; 37: the
# LSTM text classifier of tests/test_fluid_control_flow.py:487-546 at
# benchmarks/rnn_bench.py's widths (lengths drawn in 60-100), 12 runs of
# one batch, card vs CPU at batch 8; 38: a recurrent op over gru_unit at
# the seq2seq widths (T 50, B 128, H 512, SGD), the while counter, cond
# with a scalar and a per-sample condition at [128, 512], beam_search +
# beam_search_decode at B 128, K 3, V 30000 over 8 steps of a toy decoder,
# and save -> load inside a graphed run. Card vs CPU: first losses within
# CPU_COST_RTOL, the second within V1_CPU_RTOL; the eager interpreter on
# the card against the replays within FLUID_EAGER_RTOL; outputs within
# FLUID_OUT_TOL
FLUID_DIGITS = dict(batch=64, runs=20, lr=1e-3, eager_from=10, eager_runs=3)
FLUID_LSTM = dict(vocab=10000, embed=128, hidden=512, classes=2, batch=128, seq_len=100,
                  min_len=60, runs=12, lr=1e-3, cpu_batch=8, eager_from=5, eager_runs=4)
FLUID_GRU = dict(t=50, b=128, d=512, h=512, classes=2, runs=6, lr=0.1)
FLUID_COND = dict(b=128, d=512, runs=4)
FLUID_BEAM = dict(b=128, k=3, v=30000, steps=8, emb=64, runs=4, end_id=1)
FLUID_EAGER_RTOL = 1e-5
FLUID_OUT_TOL = dict(rtol=1e-4, atol=1e-5)
# 39: the GAN demo (tests/test_multi_network.py:24-60) through
# MultiNetworkTrainer at batch 128 over 400 alternating iterations
GAN = dict(batch=128, iters=400, mean=(2.0, -1.0), std=0.3, noise=4)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def peaks(name: str):
    """(bytes/s, f32 FLOP/s, dense TF32 FLOP/s) of the card."""
    for key, *rates in _PEAKS:
        if key in name:
            return tuple(rates[:3])
    fail(f"no data-sheet peaks for {name!r}")


def bf16_peak(name: str) -> float:
    """Dense bf16 FLOP/s of the card (its data sheet)."""
    for key, *rates in _PEAKS:
        if key in name:
            return rates[3]
    fail(f"no data-sheet peaks for {name!r}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


_SLEEP_CYCLES = []


def head_start_cycles(torch, ms: float = 0.5) -> int:
    """GPU clock cycles of `torch.cuda._sleep` that take about `ms`
    (measured once with CUDA events)."""
    if not _SLEEP_CYCLES:
        torch.cuda._sleep(1000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        torch.cuda._sleep(1_000_000)
        b.record()
        torch.cuda.synchronize()
        _SLEEP_CYCLES.append(int(ms * 1_000_000 / a.elapsed_time(b)))
    return _SLEEP_CYCLES[0]


def time_ms(torch, fn, flush, iters: int = 30) -> float:
    """Mean device ms per call: CUDA events around each call, with L2
    flushed (a 64 MiB write) before it, as a decode step that has read the
    other layers' pages in between finds it. The card then spins ~0.5 ms
    (`torch.cuda._sleep`) before the first event, so the host has queued
    the call by the time the card reaches it: the interval holds the
    card's time, not the wrapper's host overhead (a call whose host work
    outlasts the card's, as a plain version's loop of small ops may, still
    shows its host time). `host_us` reads the host's side."""
    cycles = head_start_cycles(torch)
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(cycles)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def host_us(torch, fn, calls: int = 100, loops: int = 10):
    """The host's side of a call, without flush or head start: µs to issue
    one call (`calls` back to back, no sync), and wall µs per call of the
    same loop run to its end (synchronised) — the larger of the host's and
    the card's time a call, as a host-bound decode step meets it. Each the
    least of `loops` loops: the host is shared, and other work only adds
    (its CPU-time clock ticks too coarsely to read one call)."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    issue, wall = [], []
    for _ in range(loops):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        issue.append((t1 - t0) / calls * 1e6)
        wall.append((t2 - t0) / calls * 1e6)
    return min(issue), min(wall)


def paged_inputs(torch, seed, s, h, hd, ps, pmax, min_pos, max_pos, dump_slot):
    """Random ragged decode inputs on the card: positions drawn in
    min_pos..max_pos, shuffled physical pages, partly filled last pages,
    unused table entries on dump page 0, and (when `dump_slot`) a last slot
    at position 0 with an all-dump row."""
    g = torch.Generator().manual_seed(seed)
    kd = h * hd
    n_pages = 1 + s * pmax
    q = torch.randn(s, kd, generator=g)
    kp = torch.randn(n_pages, ps, kd, generator=g)
    vp = torch.randn(n_pages, ps, kd, generator=g)
    free = (torch.randperm(n_pages - 1, generator=g) + 1).tolist()
    bt = torch.zeros(s, pmax, dtype=torch.int32)
    pos = torch.zeros(s, dtype=torch.int32)
    for i in range(s - 1 if dump_slot else s):
        p = int(torch.randint(min_pos, max_pos + 1, (1,), generator=g))
        n = p // ps + 1
        bt[i, :n] = torch.tensor([free.pop() for _ in range(n)], dtype=torch.int32)
        pos[i] = p
    return [t.cuda() for t in (q, kp, vp, bt, pos)]


def graph_ms(torch, fn, flush, calls: int = 20, replays: int = 10):
    """Device ms per call with `calls` calls captured back to back in one
    CUDA graph, as the decode step's graph holds them (no host launch
    between kernels): (cold, warm). Cold: the graph flushes L2 (a 64 MiB
    write) before each call, and a graph of the flushes alone is timed and
    subtracted. Warm: the calls alone, back to back. Each is the median of
    `replays` replays timed with CUDA events after a ~0.5 ms head start."""
    cycles = head_start_cycles(torch)
    fn()
    torch.cuda.synchronize()

    def capture(body):
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(calls):
                body()
        return g

    def replay_ms(g):
        g.replay()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(replays):
            torch.cuda._sleep(cycles)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            g.replay()
            b.record()
            pairs.append((a, b))
        torch.cuda.synchronize()
        return statistics.median(a.elapsed_time(b) for a, b in pairs)

    flushes = capture(flush.zero_)
    both = capture(lambda: (flush.zero_(), fn()))
    warm = capture(fn)
    cold_ms = (replay_ms(both) - replay_ms(flushes)) / calls
    warm_ms = replay_ms(warm) / calls
    del flushes, both, warm
    return cold_ms, warm_ms


def paged_parts_ms(torch, fn, flush, calls: int = 10):
    """Device ms per paged-attention call by kernel, from torch.profiler over
    `calls` calls with L2 flushed before each: the split grid and the merge
    grid (a design with one kernel shows it as the split). Profiled again,
    up to 3 windows, when the profiler records no device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
            for _ in range(calls):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        parts = {"split": 0.0, "merge": 0.0}
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA and "paged_decode" in e.key:
                part = "merge" if "merge" in e.key else "split"
                parts[part] += e.self_device_time_total / 1e3 / calls
        if parts["split"] > 0:
            return parts
    return None


PAGED_SHAPES = (
    # name, seed, S, H, hd, PS, P, positions drawn in min..max, dump slot
    ("small_odd", 0, 5, 2, 8, 4, 7, 0, 27, True),
    ("gpt2_small_s8", 1, 8, 12, 64, 16, 64, 0, 1023, False),
    ("gpt2_small_s32", 2, 32, 12, 64, 16, 64, 0, 1023, False),
    # one long request: the fewest slots to spread over the card
    ("gpt2_small_s1_long", 3, 1, 12, 64, 16, 64, 1023, 1023, False),
    # the decode profile's contexts (16-34 tokens): a slot's tiles one to a split
    ("gpt2_small_s8_short", 4, 8, 12, 64, 16, 64, 15, 33, False),
)


def kernel_phase(torch, flush, bw, f32_flops):
    """Paged attention vs its plain version at PAGED_SHAPES (1e-4, and two
    calls bit-identical), timed beside the plain version, SDPA + gather and
    the byte bound, with the achieved TB/s and the wrapper's host µs per
    call. Uses the wrapper's public calls only, so it times any checkout's
    package put first on sys.path."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import paged_attention as pa

    rows = []
    for name, seed, s, h, hd, ps, pmax, min_pos, max_pos, dump in PAGED_SHAPES:
        q, kp, vp, bt, pos = paged_inputs(torch, seed, s, h, hd, ps, pmax,
                                          min_pos, max_pos, dump)
        scale = 1.0 / hd ** 0.5
        kw = dict(scale=scale, n_heads=h)
        got = pa.paged_attention_decode(q, kp, vp, bt, pos, **kw)
        again = pa.paged_attention_decode(q, kp, vp, bt, pos, **kw)
        want = pa.paged_attention_decode_ref(q, kp, vp, bt, pos, **kw)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        t_ctx = pmax * ps
        mask = (torch.arange(t_ctx, device="cuda")[None, :]
                <= pos.long()[:, None])[:, None, None, :]

        def library():
            k = kp[bt.long()].reshape(s, t_ctx, h, hd).transpose(1, 2)
            v = vp[bt.long()].reshape(s, t_ctx, h, hd).transpose(1, 2)
            o = F.scaled_dot_product_attention(
                q.view(s, h, 1, hd), k, v, attn_mask=mask, scale=scale)
            return o.reshape(s, h * hd)

        lib_err = float((library() - want).abs().max())
        kernel_ms = time_ms(
            torch, lambda: pa.paged_attention_decode(q, kp, vp, bt, pos, **kw),
            flush)
        plain_ms = time_ms(
            torch,
            lambda: pa.paged_attention_decode_ref(q, kp, vp, bt, pos, **kw),
            flush)
        library_ms = time_ms(torch, library, flush)
        parts = paged_parts_ms(
            torch, lambda: pa.paged_attention_decode(q, kp, vp, bt, pos, **kw), flush)
        issue_us, loop_us = host_us(
            torch, lambda: pa.paged_attention_decode(q, kp, vp, bt, pos, **kw))
        g_cold, g_warm = graph_ms(
            torch, lambda: pa.paged_attention_decode(q, kp, vp, bt, pos, **kw),
            flush)
        # least work: each visible K and V row read once, q/table/positions
        # read and out written once; 4 flops per visible token per KD element
        tokens = int((pos.long() + 1).clamp(max=t_ctx).sum())
        kd = h * hd
        nbytes = 2 * 4 * tokens * kd + 2 * 4 * s * kd + 4 * s * pmax + 4 * s
        ops = 4 * tokens * kd
        t_bytes, t_ops = nbytes / bw * 1e3, ops / f32_flops * 1e3
        row = dict(
            shape=name, S=s, H=h, hd=hd, PS=ps, P=pmax,
            visible_tokens=tokens, max_abs_err=err, library_err=lib_err,
            bit_identical=bool(torch.equal(got, again)),
            kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
            graph_ms=g_cold, graph_warm_ms=g_warm,
            parts_ms=parts, host_issue_us=issue_us, loop_us=loop_us,
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            achieved_tb_s=nbytes / (kernel_ms * 1e-3) / 1e12,
            bytes=nbytes, operations=ops,
        )
        print("kernel", json.dumps(row), flush=True)
        if not err <= KERNEL_TOL:
            fail(f"paged_attention_decode vs plain at {name}: max_abs_err "
                 f"{err} > {KERNEL_TOL}")
        if not row["bit_identical"]:
            fail(f"paged_attention_decode at {name}: two calls differ")
        rows.append(row)
    return rows


def gru_inputs(torch, seed, t, b, h, lengths, h0_scale):
    """Time-major GRU inputs on the card: proj [T,B,3H], mask [T,B] from
    `lengths`, smart-normal weights, bias, h0, and cotangents dhs, dh_last."""
    g = torch.Generator().manual_seed(seed)
    proj = torch.randn(t, b, 3 * h, generator=g)
    lens = torch.as_tensor(lengths)
    mask = (torch.arange(t)[:, None] < lens[None, :]).float()
    w_hzr = torch.randn(h, 2 * h, generator=g) / h ** 0.5
    w_hc = torch.randn(h, h, generator=g) / h ** 0.5
    bias = 0.1 * torch.randn(3 * h, generator=g)
    h0 = h0_scale * torch.randn(b, h, generator=g)
    dhs = torch.randn(t, b, h, generator=g)
    dh_last = torch.randn(b, h, generator=g)
    return [x.cuda() for x in (proj, mask, w_hzr, w_hc, bias, h0, dhs, dh_last)]


def gru_kernel_phase(torch, flush, bw, f32_flops):
    """Both GRU kernels vs their plain versions on the card, both
    directions, at a small odd shape and at the encoder's shape in the
    seq2seq training step; kernel and plain times (CUDA events, L2 flushed)
    beside the bound, at each shape in the forward direction."""
    from paddle_tpu_torch.data.feeder import _bucket_len
    from paddle_tpu_torch.ops import rnn_kernels as K

    g = torch.Generator().manual_seed(5)
    main_lens = torch.randint(30, 51, (S2S["batch"],), generator=g)
    main_lens[0] = S2S["src_len"]
    wide_lens = torch.randint(30, 51, (64,), generator=g)
    wide_lens[0] = S2S["src_len"]
    # phase 21's v1 config: lengths 30-50, which the feeder pads to the
    # next power of two (data/feeder.py `_bucket_len`): T = 64
    v1_lens = torch.randint(V1_BIGRU["min_len"], V1_BIGRU["max_len"] + 1,
                            (V1_BIGRU["batch"],), generator=g)
    v1_lens[0] = V1_BIGRU["max_len"]
    v1_t = _bucket_len(V1_BIGRU["max_len"], None)
    shapes = (
        # name, seed, T, B, H, lengths, h0 scale
        ("small_odd", 11, 7, 5, 24, [7, 3, 1, 5, 6], 0.5),
        ("s2s_encoder", 12, S2S["src_len"], S2S["batch"], S2S["hidden"],
         main_lens.tolist(), 0.0),
        ("wide_h1024", 13, S2S["src_len"], 64, 1024, wide_lens.tolist(), 0.5),
        ("v1_bigru", 14, v1_t, V1_BIGRU["batch"], V1_BIGRU["size"], v1_lens.tolist(), 0.0),
    )
    rows = []
    for name, seed, t, b, h, lens, h0_scale in shapes:
        proj, mask, w_hzr, w_hc, bias, h0, dhs, dh_last = gru_inputs(
            torch, seed, t, b, h, lens, h0_scale)
        fwd_args = (proj, mask, w_hzr, w_hc, bias, h0)
        row = dict(shape=name, T=t, B=b, H=h, lengths_min=min(lens),
                   lengths_max=max(lens), plan=K.gru_seq_plan(h, b, t))
        for reverse in (False, True):
            hs, zrc = K.gru_seq_fwd(*fwd_args, reverse=reverse)
            hs_ref, zrc_ref = K.gru_seq_fused_ref(*fwd_args, reverse=reverse)
            last = 0 if reverse else -1
            bwd_tail = (h0, mask, w_hzr, w_hc, dhs, dh_last)
            got = K.gru_seq_bwd(zrc, hs, *bwd_tail, reverse=reverse)
            want = K.gru_seq_bwd_ref(zrc_ref, hs_ref, *bwd_tail, reverse=reverse)
            torch.cuda.synchronize()
            d = "rev" if reverse else "fwd"
            errs = {
                "hs": float((hs - hs_ref).abs().max()),
                "h_last": float((hs[last] - hs_ref[last]).abs().max()),
                "zrc": float((zrc - zrc_ref).abs().max()),
            }
            row[f"fwd_err_{d}"] = errs
            for k in errs:
                if not errs[k] <= GRU_FWD_TOL:
                    fail(f"gru_seq_fwd vs plain at {name} ({d}): {k} max_abs_err "
                         f"{errs[k]} > {GRU_FWD_TOL}")
            berrs = {}
            for k, a, w in zip(("dproj", "dw_zr", "dw_c", "db", "dh0"), got, want):
                scale = max(1.0, float(w.abs().max()))
                err = float((a - w).abs().max())
                berrs[k] = dict(max_abs_err=err, limit=GRU_BWD_RTOL * scale)
                if not err <= GRU_BWD_RTOL * scale:
                    fail(f"gru_seq_bwd vs plain at {name} ({d}): {k} max_abs_err "
                         f"{err} > {GRU_BWD_RTOL} x {scale}")
            row[f"bwd_err_{d}"] = berrs
        hs, zrc = K.gru_seq_fwd(*fwd_args)
        bwd_tail = (h0, mask, w_hzr, w_hc, dhs, dh_last)
        row["fwd_kernel_ms"] = time_ms(torch, lambda: K.gru_seq_fwd(*fwd_args), flush)
        fwd_steps(torch, row, lambda: K.gru_seq_fwd_sync(h, b, t), flush)
        row["fwd_plain_ms"] = time_ms(
            torch, lambda: K.gru_seq_fused_ref(*fwd_args), flush, iters=10)
        row["bwd_kernel_ms"] = time_ms(
            torch, lambda: K.gru_seq_bwd(zrc, hs, *bwd_tail), flush)
        row["bwd_plain_ms"] = time_ms(
            torch, lambda: K.gru_seq_bwd_ref(zrc, hs, *bwd_tail), flush, iters=10)
        row["bwd_parts_ms"] = bwd_parts_ms(
            torch, lambda: K.gru_seq_bwd(zrc, hs, *bwd_tail), "gru")
        row["bwd_parts_note"] = BWD_PARTS_NOTE
        dproj = K.gru_seq_bwd(zrc, hs, *bwd_tail)[0].reshape(t * b, 3 * h)
        hp = K._h_prev_seq(hs, h0, False).reshape(t * b, h)
        rh = zrc[..., h:2 * h].reshape(t * b, h) * hp
        row["note_cublas_dw_ms"] = cublas_dw_ms(
            torch, [(hp, dproj[:, :2 * h]), (rh, dproj[:, 2 * h:])], flush)
        # least work, each input read once and each output written once,
        # f32. The forward writes every row's gates, masked ones too, but a
        # masked step carries h through: h W_zr is needed at the valid steps
        # and once after a row's last one (fwd_product_rows), (r*h) W_c at
        # all T*B rows (r changes with x_t). The backward's products run
        # over the valid steps only (a masked step's dproj is 0 and its dh
        # carries through: 2*steps*H*3H for the W^T products, as much for
        # dW). Notes: the forward over all T*B rows, and over valid steps.
        mm = 2 * sum(lens) * h * 3 * h
        fwd_ops = 2 * fwd_product_rows(lens, t) * h * 2 * h + 2 * t * b * h * h
        f = 4
        fwd_bytes = f * (t * b * 3 * h + t * b + 3 * h * h + 3 * h + b * h
                         + t * b * h + t * b * 3 * h)
        bwd_bytes = f * (t * b * 3 * h + t * b * h + b * h + t * b + 3 * h * h
                         + t * b * h + b * h
                         + t * b * 3 * h + 3 * h * h + 3 * h + b * h)
        set_bounds(row, bw, f32_flops, fwd=(fwd_ops, fwd_bytes), bwd=(2 * mm, bwd_bytes),
                   fwd_all_rows=(2 * t * b * h * 3 * h, fwd_bytes),
                   fwd_valid_steps=(mm, fwd_bytes))
        if name == "s2s_encoder":
            row["note_torch_nn_gru_fwd_ms"] = torch_gru_ms(torch, t, b, h, flush)
            row["fwd_kernel_ms_by_batch"] = fwd_by_batch(
                torch, K.gru_seq_fwd, fwd_args, (0, 1), (5,), b, flush)
        print("gru_kernel", json.dumps(row), flush=True)
        rows.append(row)
    return rows


def fwd_product_rows(lens, t):
    """Rows of h_{t-1} W that a forward (time order) must compute: a row
    of length l changes h at its l valid steps, so it needs the product at
    step 0 and after each valid step before T: min(l + 1, T) steps."""
    return sum(min(n + 1, t) for n in lens)


def set_bounds(row, bw, f32_flops, **legs):
    """row[<leg>_bound_ms] and its parts for legs = {leg: (f32
    operations, bytes)}: the larger of the bytes over the card's memory
    rate and the operations over its f32 peak."""
    for leg, (ops, nbytes) in legs.items():
        t_bytes, t_ops = nbytes / bw * 1e3, ops / f32_flops * 1e3
        row[f"{leg}_bound_ms"] = max(t_bytes, t_ops)
        row[f"{leg}_bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        row[f"{leg}_bytes"] = nbytes
        row[f"{leg}_operations"] = ops


def fwd_steps(torch, row, sync_probe, flush):
    """A forward's time per step, and the part of it its grid syncs take
    alone: the library's sync probe runs the same step loop with nothing
    but the syncs, at the forward's own grid and T."""
    t = row["T"]
    row["fwd_us_per_step"] = row["fwd_kernel_ms"] * 1e3 / t
    row["fwd_sync_us_per_step"] = time_ms(torch, sync_probe, flush) * 1e3 / t
    row["fwd_sync_share"] = row["fwd_sync_us_per_step"] / row["fwd_us_per_step"]


def fwd_by_batch(torch, fwd, args, seq, state, b, flush):
    """The forward's ms at B = 8, 32 and b on the first rows of `args`
    (args[i] is [T, B, ...] for i in `seq`, a [B, H] state for i in
    `state`, else a weight): how its time per step moves with the rows."""
    out = {}
    for bb in (8, 32, b):
        sub = [x[:, :bb].contiguous() if i in seq else x[:bb].contiguous() if i in state
               else x for i, x in enumerate(args)]
        out[bb] = time_ms(torch, lambda: fwd(*sub), flush, iters=10)
    return out


def torch_gru_ms(torch, t, b, h, flush):
    """torch.nn.GRU (cuDNN) forward at the same shape: a DIFFERENT function
    (reset gate applied after the recurrent product, r*(W_hn h + b_hn), an
    input projection of its own, no step mask), timed only as a note."""
    gru = torch.nn.GRU(h, h).cuda()
    x = torch.randn(t, b, h, device="cuda")
    with torch.no_grad():
        return time_ms(torch, lambda: gru(x), flush)


def bwd_parts_ms(torch, fn, tag, calls=3):
    """Device ms per backward call by part, from torch.profiler over
    `calls` calls: the walk (`<tag>_bwd_kernel`), the split-K dW GEMM with
    db folded in (`<tag>_dw_kernel`) and its second pass over the splits
    (`<tag>_dw_sum_kernel`, which also sums db); "other" is the list of
    valid rows. Each kernel launches once per call: its mean over the
    launches the profiler recorded is its part. The profiler now and then
    records no device events at all; such a window is profiled again, up
    to 3 windows."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    names = {f"{tag}_bwd_kernel": "walk", f"{tag}_dw_kernel": "dw",
             f"{tag}_dw_sum_kernel": "dw_sum"}
    for _ in range(3):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        parts = dict.fromkeys(list(names.values()) + ["other"], 0.0)
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA:
                part = next((v for k, v in names.items() if k in e.key), "other")
                parts[part] += e.self_device_time_total / 1e3 / e.count
        if any(parts.values()):
            break
    if parts["walk"] <= 0 or parts["dw"] <= 0:
        fail(f"torch.profiler saw no {tag} backward kernels: {parts}")
    return parts


BWD_PARTS_NOTE = ("db is folded into dw (column sums of the staged dproj tiles) and "
                  "dw_sum (the second pass over the splits)")


def cublas_dw_ms(torch, pairs, flush):
    """torch.mm of each (A, D) pair as A^T D in f32 with TF32 off: the same
    sums as the dW reduction, a yardstick only (never called by the port)."""
    assert not torch.backends.cuda.matmul.allow_tf32
    return time_ms(torch, lambda: [torch.mm(a.T, d) for a, d in pairs], flush)


def lstm_inputs(torch, seed, t, b, h, lengths):
    """Time-major LSTM inputs on the card: proj [T,B,4H], mask [T,B] from
    `lengths`, a smart-normal W, bias, non-zero h0 and c0, and cotangents
    dhs, dh_last, dc_last."""
    g = torch.Generator().manual_seed(seed)
    proj = torch.randn(t, b, 4 * h, generator=g)
    lens = torch.as_tensor(lengths)
    mask = (torch.arange(t)[:, None] < lens[None, :]).float()
    w_hh = torch.randn(h, 4 * h, generator=g) / h ** 0.5
    bias = 0.1 * torch.randn(4 * h, generator=g)
    h0 = 0.5 * torch.randn(b, h, generator=g)
    c0 = 0.5 * torch.randn(b, h, generator=g)
    dhs = torch.randn(t, b, h, generator=g)
    dh_last = torch.randn(b, h, generator=g)
    dc_last = torch.randn(b, h, generator=g)
    return [x.cuda() for x in (proj, mask, w_hh, bias, h0, c0, dhs, dh_last, dc_last)]


def lstm_kernel_phase(torch, flush, bw, f32_flops):
    """Both LSTM kernels vs their plain versions on the card, both
    directions, non-zero h0 and c0, at a small odd shape, at the text
    classifier's shape with ragged lengths and at BASELINE's widest row;
    kernel and plain times (CUDA events, L2 flushed) beside the bound, at
    each shape in the forward direction."""
    from paddle_tpu_torch.ops import rnn_kernels as K

    g = torch.Generator().manual_seed(6)
    main_lens = torch.randint(60, LSTM["seq_len"] + 1, (LSTM["batch"],), generator=g)
    main_lens[0] = LSTM["seq_len"]
    wide_lens = torch.randint(60, LSTM["seq_len"] + 1, (64,), generator=g)
    wide_lens[0] = LSTM["seq_len"]
    shapes = (
        # name, seed, T, B, H, lengths
        ("small_odd", 21, 7, 5, 24, [7, 3, 1, 5, 6]),
        ("text_cls", 22, LSTM["seq_len"], LSTM["batch"], LSTM["hidden"],
         main_lens.tolist()),
        ("wide_h1280", 23, LSTM["seq_len"], 64, 1280, wide_lens.tolist()),
    )
    rows = []
    for name, seed, t, b, h, lens in shapes:
        proj, mask, w_hh, bias, h0, c0, dhs, dh_last, dc_last = lstm_inputs(
            torch, seed, t, b, h, lens)
        fwd_args = (proj, mask, w_hh, bias, h0, c0)
        bwd_tail = (h0, c0, mask, w_hh, dhs, dh_last, dc_last)
        row = dict(shape=name, T=t, B=b, H=h, lengths_min=min(lens),
                   lengths_max=max(lens), plan=K.lstm_seq_plan(h, b, t))
        for reverse in (False, True):
            hs, gates, ct, cs = K.lstm_seq_fwd(*fwd_args, reverse=reverse)
            ref = K.lstm_seq_fused_ref(*fwd_args, reverse=reverse)
            last = 0 if reverse else -1
            got = K.lstm_seq_bwd(gates, ct, hs, cs, *bwd_tail, reverse=reverse)
            want = K.lstm_seq_bwd_ref(ref[1], ref[2], ref[0], ref[3], *bwd_tail,
                                      reverse=reverse)
            torch.cuda.synchronize()
            d = "rev" if reverse else "fwd"
            errs = {
                "hs": float((hs - ref[0]).abs().max()),
                "h_last": float((hs[last] - ref[0][last]).abs().max()),
                "c_last": float((cs[last] - ref[3][last]).abs().max()),
                "gates": float((gates - ref[1]).abs().max()),
                "ct": float((ct - ref[2]).abs().max()),
                "cs": float((cs - ref[3]).abs().max()),
            }
            row[f"fwd_err_{d}"] = errs
            for k in errs:
                if not errs[k] <= LSTM_FWD_TOL:
                    fail(f"lstm_seq_fwd vs plain at {name} ({d}): {k} max_abs_err "
                         f"{errs[k]} > {LSTM_FWD_TOL}")
            berrs = {}
            for k, a, w in zip(("dproj", "dw", "db", "dh0", "dc0"), got, want):
                scale = max(1.0, float(w.abs().max()))
                err = float((a - w).abs().max())
                berrs[k] = dict(max_abs_err=err, limit=LSTM_BWD_RTOL * scale)
                if not err <= LSTM_BWD_RTOL * scale:
                    fail(f"lstm_seq_bwd vs plain at {name} ({d}): {k} max_abs_err "
                         f"{err} > {LSTM_BWD_RTOL} x {scale}")
            row[f"bwd_err_{d}"] = berrs
        hs, gates, ct, cs = K.lstm_seq_fwd(*fwd_args)
        saved = (gates, ct, hs, cs)
        row["fwd_kernel_ms"] = time_ms(torch, lambda: K.lstm_seq_fwd(*fwd_args), flush)
        fwd_steps(torch, row, lambda: K.lstm_seq_fwd_sync(h, b, t), flush)
        row["fwd_plain_ms"] = time_ms(
            torch, lambda: K.lstm_seq_fused_ref(*fwd_args), flush, iters=5)
        row["bwd_kernel_ms"] = time_ms(
            torch, lambda: K.lstm_seq_bwd(*saved, *bwd_tail), flush)
        row["bwd_plain_ms"] = time_ms(
            torch, lambda: K.lstm_seq_bwd_ref(*saved, *bwd_tail), flush, iters=5)
        row["bwd_parts_ms"] = bwd_parts_ms(
            torch, lambda: K.lstm_seq_bwd(*saved, *bwd_tail), "lstm")
        row["bwd_parts_note"] = BWD_PARTS_NOTE
        dproj = K.lstm_seq_bwd(*saved, *bwd_tail)[0].reshape(t * b, 4 * h)
        hp = K._h_prev_seq(hs, h0, False).reshape(t * b, h)
        row["note_cublas_dw_ms"] = cublas_dw_ms(torch, [(hp, dproj)], flush)
        # least work, each input read once and each output written once,
        # f32. The forward writes every row's gates, masked ones too, but a
        # masked step carries h through, so h W is needed at the valid
        # steps and once after a row's last one (fwd_product_rows). The
        # backward's products run over the valid steps only (2*steps*H*4H
        # for dh_prev, as much for dW). Notes: the forward over all T*B
        # rows, and over valid steps.
        mm = 2 * sum(lens) * h * 4 * h
        fwd_ops = 2 * fwd_product_rows(lens, t) * h * 4 * h
        f, tb = 4, t * b
        fwd_bytes = f * (tb * 4 * h + tb + 4 * h * h + 4 * h + 2 * b * h
                         + 3 * tb * h + tb * 4 * h)
        bwd_bytes = f * (tb * 4 * h + 4 * tb * h + 2 * b * h + tb + 4 * h * h
                         + 2 * b * h + tb * 4 * h + 4 * h * h + 4 * h + 2 * b * h)
        set_bounds(row, bw, f32_flops, fwd=(fwd_ops, fwd_bytes), bwd=(2 * mm, bwd_bytes),
                   fwd_all_rows=(2 * tb * h * 4 * h, fwd_bytes),
                   fwd_valid_steps=(mm, fwd_bytes))
        if name == "text_cls":
            row["note_torch_nn_lstm_fwd_ms"] = torch_lstm_ms(torch, t, b, h, flush)
            row["fwd_kernel_ms_by_batch"] = fwd_by_batch(
                torch, K.lstm_seq_fwd, fwd_args, (0, 1), (4, 5), b, flush)
        print("lstm_kernel", json.dumps(row), flush=True)
        rows.append(row)
    return rows


def torch_lstm_ms(torch, t, b, h, flush):
    """torch.nn.LSTM (cuDNN) forward at the same shape: a DIFFERENT function
    (an input projection of its own, two biases, no step mask), timed only
    as a note."""
    lstm = torch.nn.LSTM(h, h).cuda()
    x = torch.randn(t, b, h, device="cuda")
    with torch.no_grad():
        return time_ms(torch, lambda: lstm(x), flush)


def attn_inputs(torch, seed, b, tq, tk, d, dv, per_row):
    """q, k, v and a 0/1 mask ([B,Tq,Tk] when `per_row`, else [B,1,Tk],
    ~70 % kept) on the card, with one fully masked row."""
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(b, tq, d, generator=g)
    k = torch.randn(b, tk, d, generator=g)
    v = torch.randn(b, tk, dv, generator=g)
    mask = (torch.rand(b, tq if per_row else 1, tk, generator=g) > 0.3).float()
    mask[-1, -1, :] = 0.0
    return [x.cuda() for x in (q, k, v, mask)]


ATTN_SHAPES = (
    # name, seed, B, Tq, Tk, D, Dv, per-row mask, timed
    ("small_kv_mask", 31, 3, 5, 7, 8, 6, False, False),
    ("small_row_mask", 32, 3, 5, 7, 8, 6, True, False),
    ("d16_dv257", 36, 2, 5, 9, 16, 257, True, False),
    ("b32_t512", 33, *ATTN_MAIN, True, True),
    ("b8_t1024_d128", 37, 8, 1024, 1024, 128, 128, False, True),
    ("b2_d512_dv300", 38, 2, 512, 512, 512, 300, True, True),
)


def attn_kernel_phase(torch, flush, bw, f32_flops, tf32_flops, names=None):
    """The attention kernel vs its plain version on the card at the JAX
    tests' shape with both mask shapes and a fully masked row, at a wide v
    (Dv=257), and timed at B=32, Tq=Tk=512, D=Dv=64 (per-row mask), at
    B=8, Tq=Tk=1024, D=Dv=128 ([B,1,Tk] mask) and at B=2, Tq=Tk=512,
    D=512, Dv=300: kernel, plain and F.scaled_dot_product_attention
    (additive mask; never called by the port) beside the least time: the
    bytes, or the products as the kernel issues them, three TF32 passes on
    the tensor cores (the f32 SIMT figure kept as a note). `names` picks
    rows of ATTN_SHAPES (all by default); the phase uses the wrapper's
    public calls only, so it times any checkout's package put first on
    sys.path."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import rnn_kernels as K

    rows = []
    for name, seed, b, tq, tk, d, dv, per_row, timed in ATTN_SHAPES:
        if names is not None and name not in names:
            continue
        q, k, v, mask = attn_inputs(torch, seed, b, tq, tk, d, dv, per_row)
        scale = 1.0 / d ** 0.5
        got = K.attention_seq_fwd(q, k, v, mask, scale)
        want = K.attention_seq_fused_ref(q, k, v, mask, scale)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        masked_row_err = float((got[-1, -1] - want[-1, -1]).abs().max())
        row = dict(shape=name, B=b, Tq=tq, Tk=tk, D=d, Dv=dv, Mq=mask.shape[1],
                   max_abs_err=err, fully_masked_row_err=masked_row_err,
                   tensor_core="3xTF32")
        if not (err <= ATTN_TOL and bool(torch.isfinite(got).all())):
            fail(f"attention_seq_fwd vs plain at {name}: max_abs_err {err} > {ATTN_TOL}")
        if timed:
            additive = torch.where(mask > 0, 0.0, -1e9)

            def library():
                return F.scaled_dot_product_attention(q, k, v, attn_mask=additive,
                                                      scale=scale)

            row["library_err"] = float((library() - want).abs().max())
            row["kernel_ms"] = time_ms(
                torch, lambda: K.attention_seq_fwd(q, k, v, mask, scale), flush)
            row["plain_ms"] = time_ms(
                torch, lambda: K.attention_seq_fused_ref(q, k, v, mask, scale), flush)
            row["library_ms"] = time_ms(torch, library, flush)
            ops = 2 * b * tq * tk * (d + dv)
            nbytes = 4 * (b * tq * d + b * tk * d + b * tk * dv + mask.numel()
                          + b * tq * dv)
            t_bytes, t_ops = nbytes / bw * 1e3, 3 * ops / tf32_flops * 1e3
            row.update(bound_ms=max(t_bytes, t_ops),
                       bound_by="bytes" if t_bytes >= t_ops else "operations",
                       bytes=nbytes, operations=ops, tensor_core_operations=3 * ops,
                       bound_ms_f32_simt=max(t_bytes, ops / f32_flops * 1e3))
        print("attn_kernel", json.dumps(row), flush=True)
        rows.append(row)
    return rows


def attn_path_phase(torch):
    """`ops/attention.dot_product_attention`, the fused op's own path, at
    B=32, Tq=Tk=512, D=Dv=64 with a per-row mask: forward and q/k/v
    gradients with fused=None (the kernel; ATTN_LAUNCHES counted from 0)
    against fused=False (the plain body) on the card."""
    from paddle_tpu_torch.ops import attention as A
    from paddle_tpu_torch.ops import rnn_kernels as K

    q, k, v, mask = attn_inputs(torch, 34, *ATTN_MAIN, True)
    out = {}
    for fused in (None, False):
        xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
        if fused is None:
            K.ATTN_LAUNCHES = 0
        o = A.dot_product_attention(*xs, mask=mask, fused=fused)
        grads = torch.autograd.grad((o * o).sum(), xs)
        torch.cuda.synchronize()
        if fused is None:
            launches = K.ATTN_LAUNCHES
        out[fused] = (o.detach(), grads)
    errs = {"out": float((out[None][0] - out[False][0]).abs().max())}
    limits = {"out": ATTN_TOL}
    for n, a, w in zip("qkv", out[None][1], out[False][1]):
        errs[f"d{n}"] = float((a - w).abs().max())
        limits[f"d{n}"] = ATTN_GRAD_RTOL * max(1.0, float(w.abs().max()))
    res = dict(shape=list(ATTN_MAIN), launches=launches, errors_vs_plain_body=errs,
               limits=limits)
    print("attn_path", json.dumps(res), flush=True)
    if launches < 1:
        fail("dot_product_attention did not launch the attention kernel")
    bad = [k for k in errs if not errs[k] <= limits[k]]
    if bad:
        fail(f"dot_product_attention fused vs plain body differ in {bad}: {errs}")
    return res


def first_b_without_layout(fits, h: int, t: int = 1, hi: int = 4096):
    """The smallest batch in [1, hi] whose (T, B, H) the kernels' plan cannot
    lay out (None if it lays out all), by bisection: a larger batch only
    needs more of a block's shared memory."""
    if fits(h, hi, t):
        return None
    lo = 0  # fits(h, lo) holds (vacuously at 0)
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if fits(h, mid, t) else (lo, mid)
    return hi


def route_phase(torch):
    """The shapes where the recurrent kernels have no layout compute on the
    card through the plain step loops and launch no recurrent kernel:
    lstm_scan at T=1, B=207, H=1280 and gru_scan at T=3, B=249, H=1280
    (outputs and every gradient vs the plain path on the CPU: 1e-4, and
    1e-3 x max(1, max|g|)). The attention shapes that once had no fit, q, k
    [1,1,512] / v [1,1,64] and Dv=257, now launch the attention kernel with
    dot_product_attention(fused=None) and fused=True (output and gradients
    vs the plain body on the CPU: 1e-4, and 1e-4 x max(1, max|g|)). Also
    where each recurrent plan runs out on this card: the first B without a
    layout at H = 512, 1024, 1280."""
    from paddle_tpu_torch.ops import attention as A
    from paddle_tpu_torch.ops import rnn as R
    from paddle_tpu_torch.ops import rnn_kernels as K

    def counters():
        return (K.FWD_LAUNCHES, K.BWD_LAUNCHES, K.LSTM_FWD_LAUNCHES,
                K.LSTM_BWD_LAUNCHES)

    res = {"first_b_without_layout": {
        name: {h: first_b_without_layout(fits, h) for h in (512, 1024, 1280)}
        for name, fits in (("lstm", K.lstm_seq_fits), ("gru", K.gru_seq_fits))}}
    errs, limits = {}, {}
    before = counters()

    def rnn_case(name, t, b, h, gates, run):
        g = torch.Generator().manual_seed(b + h)
        x = {"proj": torch.randn(b, t, gates * h, generator=g),
             "w": torch.randn(h, gates * h, generator=g) * (0.3 * (64 / h) ** 0.5),
             "bias": torch.randn(gates * h, generator=g) * 0.1,
             "h0": torch.randn(b, h, generator=g)}
        mask = (torch.arange(t)[None, :] < 1 + torch.arange(b)[:, None] % t).float()
        out = {}
        for dev in ("cuda", "cpu"):
            xs = {k: v.to(dev).requires_grad_(True) for k, v in x.items()}
            hs, h_last = run(xs, mask.to(dev))
            grads = torch.autograd.grad((hs * hs).sum() + h_last.sum(), list(xs.values()))
            out[dev] = [hs.detach().cpu(), h_last.detach().cpu()] + [gr.cpu() for gr in grads]
        for i, (a, w) in enumerate(zip(out["cuda"], out["cpu"])):
            key = f"{name}_{('hs', 'h_last', *x)[i]}"
            errs[key] = float((a - w).abs().max())
            limits[key] = KERNEL_TOL if i < 2 else 1e-3 * max(1.0, float(w.abs().max()))

    def lstm(xs, mask):
        hs, h_last, _ = R.lstm_scan(xs["proj"], mask, R.LstmParams(xs["w"], xs["bias"]),
                                    h0=xs["h0"], c0=torch.zeros_like(xs["h0"]))
        return hs, h_last

    def gru(xs, mask):
        h = xs["h0"].shape[1]
        p = R.GruParams(xs["w"][:, :2 * h], xs["w"][:, 2 * h:], xs["bias"])
        return R.gru_scan(xs["proj"], mask, p, h0=xs["h0"], reverse=True)

    res["lstm_b207_h1280_fits"] = K.lstm_seq_fits(1280, 207, 1)
    res["gru_b249_h1280_fits"] = K.gru_seq_fits(1280, 249, 3)
    rnn_case("lstm", 1, 207, 1280, 4, lstm)
    rnn_case("gru", 3, 249, 1280, 3, gru)
    rnn_launches = [a - b for a, b in zip(counters(), before)]
    attn_launches = {}
    for name, (b, tq, tk, d, dv) in (("attn_d512", (1, 1, 1, 512, 64)),
                                     ("attn_dv257", (2, 5, 9, 16, 257))):
        q, k, v, mask = attn_inputs(torch, 35, b, tq, tk, d, dv, True)
        for fused in (None, True):
            key = f"{name}_{'none' if fused is None else 'true'}"
            outs = {}
            # the kernel on the card against the plain body on the CPU
            for dev, how in (("cuda", fused), ("cpu", False)):
                xs = [t.to(dev).requires_grad_(True) for t in (q, k, v)]
                n0 = K.ATTN_LAUNCHES
                o = A.dot_product_attention(*xs, mask=mask.to(dev), fused=how)
                outs[dev] = [t.cpu() for t in
                             [o.detach()] + list(torch.autograd.grad((o * o).sum(), xs))]
                if dev == "cuda":
                    attn_launches[key] = K.ATTN_LAUNCHES - n0
            for i, part in enumerate(("out", "dq", "dk", "dv")):
                a, w = outs["cuda"][i], outs["cpu"][i]
                errs[f"{key}_{part}"] = float((a - w).abs().max())
                limits[f"{key}_{part}"] = ATTN_TOL * (1.0 if i == 0 else
                                                      max(1.0, float(w.abs().max())))
    torch.cuda.synchronize()
    res.update(rnn_kernel_launches=rnn_launches, attn_kernel_launches=attn_launches,
               errors=errs, limits=limits)
    print("route", json.dumps(res), flush=True)
    if res["lstm_b207_h1280_fits"] or res["gru_b249_h1280_fits"]:
        fail(f"the fault shapes now have a layout: {res}")
    if any(rnn_launches):
        fail(f"the plain step loops launched recurrent kernels: {rnn_launches}")
    if not all(n >= 1 for n in attn_launches.values()):
        fail(f"dot_product_attention did not launch the attention kernel: {attn_launches}")
    bad = [k for k in errs if not errs[k] <= limits[k]]
    if bad:
        fail(f"routes on the card differ from their references in {bad}: {errs}")
    return res


SERVE = dict(GPT2_SMALL, max_len=1024, max_slots=8, page_size=16,
             prefill_buckets=(64, 128, 256, 512), max_new_limit=64,
             prefill_chunk=128, seed=0)


def gpt2_session(**kw):
    """Phase 4's configuration on the card: GPT-2 small's widths, random
    weights from seed 0 (the same weights in every phase)."""
    from paddle_tpu_torch.serving import make_demo_session

    return make_demo_session(**{**SERVE, **kw}, device="cuda")


def release(torch) -> None:
    """Return the memory of sessions the caller dropped (their pools, decode
    graphs and the graphs' memory pools) before the next one is built."""
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def serve_phase(torch):
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.serving.decode_graph import DecodeGraph
    from paddle_tpu_torch.serving.model import ServableLM

    t0 = time.perf_counter()
    sess = gpt2_session()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    model = sess.model
    rng = torch.Generator().manual_seed(1)
    prompts = [
        [model.cfg.bos_id]
        + torch.randint(3, model.cfg.vocab, (n - 1,), generator=rng).tolist()
        for n in PROMPT_LENS
    ]

    # the first REPLAYED decode step's inputs (read back from the graph's
    # static buffers), its pools before the step and its logits, for the
    # CPU reference
    first = {}
    orig_replay = DecodeGraph.replay

    def spy(graph, *host):
        if first:
            return orig_replay(graph, *host)
        # copies: the step and the later ones update the pools in place
        first["pools"] = tuple(t.to("cpu", copy=True)
                               for t in (graph.k_pages, graph.v_pages))
        logits, greedy = orig_replay(graph, *host)
        first["args"] = [t.to("cpu", copy=True) for t in graph.inputs]
        first["logits"] = logits.to("cpu", copy=True)
        return logits, greedy

    DecodeGraph.replay = spy
    step_ms = []
    orig_decode = sess._decode_once

    def timed_decode(skip=frozenset()):
        before = sess.decode_steps
        t = time.perf_counter()
        orig_decode(skip)  # ends in the step's token fetch: synchronised
        if sess.decode_steps != before:
            step_ms.append((time.perf_counter() - t) * 1e3)

    sess._decode_once = timed_decode

    torch.cuda.reset_peak_memory_stats()
    pa.LAUNCHES = 0
    t0 = time.perf_counter()
    handles = [sess.submit(p, NEW_TOKENS) for p in prompts]
    sess.run_until_idle()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = pa.LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    DecodeGraph.replay = orig_replay
    del sess._decode_once

    n_tok = sum(len(h.tokens) for h in handles)
    st = sess.stats()
    result = dict(
        config=dict(SERVE, prefill_buckets=list(SERVE["prefill_buckets"]),
                    prompt_lens=list(PROMPT_LENS), new_tokens=NEW_TOKENS),
        setup_s=setup_s, wall_s=wall_s, tokens=n_tok,
        tokens_per_s=n_tok / wall_s,
        decode_steps=sess.decode_steps,
        decode_step_ms_median=statistics.median(step_ms),
        decode_step_ms_min=min(step_ms),
        # the first decode step runs eagerly (the capture's warm-up and the
        # capture itself); the rest replay the graph
        decode_step_ms_first=step_ms[0],
        decode_step_ms_median_replayed=statistics.median(step_ms[1:]),
        decode_graph_captures=sess.decode_graph_captures,
        graph_kernel_calls=sess._decode_graph.kernel_calls,
        prefill_chunks=sess.prefill_chunks_committed,
        launches=launches, peak_memory_bytes=peak,
        finish=[h.finish_reason for h in handles],
        pages_in_use=st["pages_in_use"],
        decode_shape_signatures=sess.decode_shape_signatures(),
    )
    if not all(h.done and h.finish_reason in ("length", "eos") for h in handles):
        fail(f"not every request finished: {result['finish']}")
    if st["pages_in_use"] != 0:
        fail(f"{st['pages_in_use']} KV pages leaked")
    if sess.decode_shape_signatures() != 1:
        fail(f"{sess.decode_shape_signatures()} decode signatures, want 1")
    want = sess.decode_steps * model.cfg.n_layers
    if launches != want:
        fail(f"decode kernel launched {launches} times, want decode_steps x "
             f"n_layers = {want}")
    if sess.decode_graph_captures != 1 or "logits" not in first:
        fail(f"the decode step was captured {sess.decode_graph_captures} "
             f"times, want 1 (and replayed)")

    # the first replayed decode step again on the CPU: plain paged
    # attention, same weights, same pool and inputs
    cpu_model = ServableLM(model.cfg, device="cpu")
    cpu_model.load_state_dict(model.state_dict())
    kp, vp = first["pools"]
    ref = cpu_model.decode_logits(kp, vp, *first["args"])
    err = float((ref - first["logits"]).abs().max())
    result["first_step_logits_max_abs_err_vs_cpu"] = err
    print("serve", json.dumps(result), flush=True)
    if not err <= LOGITS_TOL:
        fail(f"first decode step logits differ from the CPU path by {err}")
    result["sampled"] = sampled_request_phase(torch, sess, prompts[0], handles[0].tokens)
    result["graph_vs_eager"] = graph_vs_eager_phase(torch, sess)
    result["decode_profile"] = profile_decode(torch, sess, prompts)
    result["tokens"] = [h.tokens for h in handles]
    result["prompts"] = prompts
    del sess, model, cpu_model, first, kp, vp, ref
    release(torch)
    return result


def sampled_request_phase(torch, sess, prompt, greedy):
    """One sampled request (SAMPLED) on phase 4's session after its greedy
    ones: its tokens on the card equal a CPU engine's for the same request
    (the same seeded weights; the noise is jax's threefry bits, the same on
    every device) and differ from the prompt's greedy tokens."""
    from paddle_tpu_torch.serving import make_demo_session

    t0 = time.perf_counter()
    h = sess.submit(prompt, NEW_TOKENS, **SAMPLED)
    sess.run_until_idle()
    card_ms = (time.perf_counter() - t0) * 1e3
    cpu = make_demo_session(**SERVE, device="cpu")
    ch = cpu.submit(prompt, NEW_TOKENS, **SAMPLED)
    cpu.run_until_idle()
    result = dict(request=SAMPLED, tokens=h.tokens, cpu_tokens=ch.tokens, card_ms=card_ms,
                  equal=h.tokens == ch.tokens, greedy_differs=h.tokens != greedy)
    print("sampled", json.dumps(result), flush=True)
    del cpu
    if not h.done or h.tokens != ch.tokens:
        fail(f"sampled request: card tokens {h.tokens} vs CPU {ch.tokens}")
    if h.tokens == greedy:
        fail("sampled request: tokens equal the greedy ones")
    return result


def graph_vs_eager_phase(torch, sess):
    """The same decode inputs through the graph replay and through the
    eager `decode_logits` (on a copy of the pools taken before the replay):
    logits within 1e-5 relative (bitwise where the same kernels run in the
    same order: recorded), greedy tokens identical."""
    g = sess._decode_graph
    s, p = g.block_table.shape
    ps = sess.cache.page_size
    rng = torch.Generator().manual_seed(2)
    pos = torch.randint(0, p * ps, (s,), generator=rng, dtype=torch.int32)
    pages = torch.randperm(sess.cache.num_pages - 1, generator=rng)[: s * p] + 1
    bt = pages.reshape(s, p).to(torch.int32)
    tokens = torch.randint(3, sess.cfg.vocab, (s,), generator=rng, dtype=torch.int32)
    active = torch.ones(s, dtype=torch.bool)
    kp, vp = sess.k_pages.clone(), sess.v_pages.clone()
    logits, greedy = g.replay(tokens.numpy(), pos.numpy(), active.numpy(), bt.numpy())
    logits, greedy = logits.clone(), greedy.clone()
    eager = sess.model.decode_logits(kp, vp, *(t.cuda() for t in (tokens, pos, active, bt)))
    torch.cuda.synchronize()
    rel = float((logits - eager).abs().max() / eager.abs().max())
    out = dict(
        bitwise=bool(torch.equal(logits, eager)),
        max_abs_err=float((logits - eager).abs().max()),
        max_rel_err=rel,
        greedy_equal=bool(torch.equal(greedy, eager.argmax(-1))),
        pools_after_max_abs_err=max(float((kp - sess.k_pages).abs().max()),
                                    float((vp - sess.v_pages).abs().max())),
    )
    print("graph_vs_eager", json.dumps(out), flush=True)
    if not rel <= GRAPH_RTOL or not out["greedy_equal"]:
        fail(f"the decode graph disagrees with the eager step: {out}")
    return out


def profile_decode(torch, sess, prompts, steps: int = 16):
    """Where a steady decode step's time goes, over `steps` decode-only
    engine steps of 8 slots (admission and prefill run before each window),
    twice: unprofiled, the host clock per step and CUDA events around each
    graph replay (the graph's device time, its four input copies included);
    then under torch.profiler, the kernels by name. Device busy share =
    the profiled kernels' time over the unprofiled step's wall time (the
    profiler's own overhead stretches its window's wall); the rest is the
    card idle while the host runs the engine step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.serving.decode_graph import DecodeGraph

    events = []
    orig_replay = DecodeGraph.replay

    def timed_replay(graph, *host):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = orig_replay(graph, *host)
        b.record()
        events.append((a, b))
        return out

    def window(profiled: bool):
        hs = [sess.submit(p[:16], steps + 2) for p in prompts]
        sess.step()  # admit + prefill + first decode, outside the window
        before = sess.decode_steps
        torch.cuda.synchronize()
        prof = None
        if profiled:
            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                           acc_events=True)
            prof.__enter__()
        else:
            DecodeGraph.replay = timed_replay
        try:
            t0 = time.perf_counter()
            for _ in range(steps):
                sess.step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        finally:
            DecodeGraph.replay = orig_replay
            if prof is not None:
                prof.__exit__(None, None, None)
        n = sess.decode_steps - before
        sess.run_until_idle()
        if not all(h.done for h in hs) or sess.cache.pages_in_use:
            fail("profiled requests did not finish cleanly")
        return n, wall_ms, prof

    n_plain, wall_plain, _ = window(False)
    graph_ms = sum(a.elapsed_time(b) for a, b in events) / max(1, len(events))
    n, wall_ms, prof = window(True)
    kernels = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            kernels[e.key] = (kernels.get(e.key, (0.0, 0))[0]
                              + e.self_device_time_total / 1e3,
                              kernels.get(e.key, (0.0, 0))[1] + e.count)
    busy_ms = sum(ms for ms, _ in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]
    out = dict(
        decode_steps=n, wall_ms_per_step=wall_plain / n_plain,
        graph_device_ms_per_step=graph_ms,
        graph_replays_per_step=len(events) / n_plain,
        device_busy_ms_per_step=busy_ms / n,
        device_busy_share=(busy_ms / n) / (wall_plain / n_plain),
        profiled_wall_ms_per_step=wall_ms / n,
        profiled_busy_share=busy_ms / wall_ms,
        kernels_per_step=sum(c for _, c in kernels.values()) / n,
        paged_attention_ms_per_step=sum(
            ms for k, (ms, _) in kernels.items() if "paged_decode" in k) / n,
        top_kernels_ms_per_step=[[k[:80], ms / n, c / n] for k, (ms, c) in top],
    )
    print("profile", json.dumps(out), flush=True)
    if busy_ms <= 0:
        fail("torch.profiler recorded no device time")
    if len(events) != n_plain:
        fail(f"{len(events)} graph replays in {n_plain} decode steps")
    return out


def wire_phase(torch, serve):
    """The port's ServingServer on 127.0.0.1, port 0, over a serve_forever
    session on the card: phase 4's 8 prompts through a framed
    ServingClient (greedy tokens identical to phase 4's, in process), then
    workload.run_closed_loop_rpc at concurrency 8 and 1."""
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.serving import ServingClient, ServingServer
    from paddle_tpu_torch.serving.workload import make_prompts, run_closed_loop_rpc

    sess = gpt2_session()
    srv = ServingServer(sess, host="127.0.0.1", port=0).start()
    out = {}
    try:
        pa.LAUNCHES = 0
        client = ServingClient(srv.address, wire="frames")
        got = [client.generate(p, NEW_TOKENS, timeout_s=300.0)["tokens"]
               for p in serve["prompts"]]
        out["framed"] = client.wire_framed
        client.close()
        out["tokens_equal_in_process"] = got == serve["tokens"]
        prompts = make_prompts(16, PROMPT_LENS[:4], GPT2_SMALL["vocab"], 1, seed=3)
        for c in (8, 1):
            r = run_closed_loop_rpc(
                lambda: ServingClient(srv.address, wire="frames"),
                prompts, NEW_TOKENS, concurrency=c)
            r.pop("results")
            out[f"closed_loop_c{c}"] = r
        st = sess.stats()
        out.update(decode_steps=st["decode_steps"], launches=pa.LAUNCHES,
                   decode_graph_captures=st["decode_graph_captures"],
                   pages_in_use=st["pages_in_use"],
                   decode_shape_signatures=st["decode_shape_signatures"])
    finally:
        srv.stop()
    print("wire", json.dumps(out), flush=True)
    if not (out["framed"] and out["tokens_equal_in_process"]):
        fail(f"wire: greedy tokens over the framed wire differ from the "
             f"in-process tokens (framed={out['framed']})")
    if out["pages_in_use"] or out["decode_shape_signatures"] != 1:
        fail(f"wire: {out['pages_in_use']} pages leaked, "
             f"{out['decode_shape_signatures']} decode signatures")
    if out["launches"] != out["decode_steps"] * GPT2_SMALL["n_layers"]:
        fail(f"wire: {out['launches']} decode kernel launches in "
             f"{out['decode_steps']} decode steps")
    del srv, sess
    release(torch)
    return out


def speculation_phase(torch):
    """speculate_k=4 on repetitive prompts, in process: tokens identical to
    speculate_k=0, one verify and one decode signature, no page leak."""
    from paddle_tpu_torch.serving.workload import make_repetitive_prompts

    prompts = make_repetitive_prompts(8, 4, 8, GPT2_SMALL["vocab"], 1, seed=4)
    out = {}
    toks = {}
    for k in (0, 4):
        sess = gpt2_session(speculate_k=k)
        free0 = sess.cache.free_pages
        t0 = time.perf_counter()
        hs = [sess.submit(p, NEW_TOKENS) for p in prompts]
        sess.run_until_idle()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = sess.stats()
        toks[k] = [h.tokens for h in hs]
        out[f"k{k}"] = dict(
            wall_s=wall, tokens_per_s=sum(map(len, toks[k])) / wall,
            decode_steps=st["decode_steps"], spec_rounds=st["spec_rounds"],
            spec_acceptance_rate=st["spec_acceptance_rate"],
            spec_effective_k=st["spec_effective_k"],
            spec_pages_trimmed=st["spec_pages_trimmed"],
            verify_shape_signatures=st["verify_shape_signatures"],
            decode_shape_signatures=st["decode_shape_signatures"],
            free_pages_start=free0, free_pages_end=sess.cache.free_pages,
        )
        del sess, hs
        release(torch)
    out["tokens_equal"] = toks[0] == toks[4]
    print("speculation", json.dumps(out), flush=True)
    k4 = out["k4"]
    if not out["tokens_equal"]:
        fail("speculation: speculate_k=4 tokens differ from speculate_k=0")
    if k4["spec_rounds"] < 1 or k4["verify_shape_signatures"] != 1:
        fail(f"speculation: {k4['spec_rounds']} rounds, "
             f"{k4['verify_shape_signatures']} verify signatures")
    for k in ("k0", "k4"):
        if out[k]["decode_shape_signatures"] != 1:
            fail(f"speculation {k}: {out[k]['decode_shape_signatures']} "
                 "decode signatures")
        if out[k]["free_pages_end"] != out[k]["free_pages_start"]:
            fail(f"speculation {k}: pages leaked")
    return out


def recovery_phase(torch, serve):
    """The supervised engine on the card under seeded faults: decode_raise
    mid-run, then an engine_stall past engine_stall_timeout_s. Every request
    completes with tokens bitwise equal to phase 4's fault-free run, one
    restart each, and the decode graph re-captured after it."""
    from paddle_tpu_torch.core import faults

    os.environ["PADDLE_TPU_SERVING_STALL_S"] = "3"
    out = {}
    for site, spec in (("decode_raise", "decode_raise:step=8"),
                       ("engine_stall", "engine_stall:step=6")):
        sess = gpt2_session(engine_restart_max=2, engine_stall_timeout_s=1.0)
        free0 = sess.cache.free_pages
        t0 = time.perf_counter()
        with faults.inject(spec) as inj:
            sess.serve_forever()
            hs = [sess.submit(p, NEW_TOKENS) for p in serve["prompts"]]
            done = all(h._event.wait(300) for h in hs)
            fired = dict(inj.fired)
        sess.stop()
        st = sess.stats()
        row = dict(
            spec=spec, fired=fired.get(site, 0), wall_s=time.perf_counter() - t0,
            engine_restarts=st["engine_restarts"],
            decode_graph_captures=st["decode_graph_captures"],
            finish=[h.finish_reason for h in hs],
            tokens_equal=done and [h.tokens for h in hs] == serve["tokens"],
            pages_leaked=free0 - sess.cache.free_pages,
        )
        out[site] = row
        print("recovery", json.dumps(row), flush=True)
        if not done or not row["tokens_equal"]:
            fail(f"recovery {site}: tokens differ from the fault-free run: {row}")
        if row["fired"] != 1 or row["engine_restarts"] != 1:
            fail(f"recovery {site}: fired {row['fired']}, "
                 f"{row['engine_restarts']} restarts")
        if row["decode_graph_captures"] != 2 or row["pages_leaked"]:
            fail(f"recovery {site}: {row['decode_graph_captures']} captures "
                 f"(want 2: the first and the re-capture), "
                 f"{row['pages_leaked']} pages leaked")
        del sess, hs
        release(torch)
    return out


def small_tokens_phase(torch):
    """A small model's greedy tokens, card vs CPU (same seeded weights)."""
    from paddle_tpu_torch.serving import make_demo_session

    prompts = [[1, 5, 9, 11], [1, 7], list(range(1, 19)), [1] + list(range(40, 47))]
    out = {}
    for dev in ("cuda", "cpu"):
        s = make_demo_session(vocab=96, n_layers=2, d_model=32, n_heads=2,
                              max_len=96, max_slots=4, page_size=8,
                              prefill_buckets=(8, 16, 32), max_new_limit=16,
                              prefill_chunk=8, device=dev)
        hs = [s.submit(p, 8) for p in prompts]
        s.run_until_idle()
        out[dev] = [h.tokens for h in hs]
    print("small_tokens", json.dumps(out), flush=True)
    if out["cuda"] != out["cpu"]:
        fail("small model: greedy tokens on the card differ from the CPU")


def s2s_batch(np, seed, b, ragged):
    """A seq2seq batch drawn as bench.py:234-242 draws it (full lengths), or
    with ragged lengths (first row full)."""
    vocab, src_len, trg_len = S2S["vocab"], S2S["src_len"], S2S["trg_len"]
    rs = np.random.RandomState(seed)
    batch = {
        "source_ids": rs.randint(2, vocab, (b, src_len)).astype(np.int32),
        "source_ids.lengths": np.full(b, src_len, np.int32),
        "target_ids": rs.randint(2, vocab, (b, trg_len)).astype(np.int32),
        "target_ids.lengths": np.full(b, trg_len, np.int32),
        "label_ids": rs.randint(2, vocab, (b, trg_len)).astype(np.int32),
        "label_ids.lengths": np.full(b, trg_len, np.int32),
    }
    if ragged:
        src_l = rs.randint(1, src_len + 1, b).astype(np.int32)
        trg_l = rs.randint(1, trg_len + 1, b).astype(np.int32)
        src_l[0], trg_l[0] = src_len, trg_len
        batch["source_ids.lengths"] = src_l
        batch["target_ids.lengths"] = batch["label_ids.lengths"] = trg_l
    return batch


def s2s_trainer(device, **kw):
    from paddle_tpu_torch.models import Seq2SeqModel
    from paddle_tpu_torch.nn.graph import reset_name_scope
    from paddle_tpu_torch.optim import Adam
    from paddle_tpu_torch.trainer import SGDTrainer

    reset_name_scope()
    model = Seq2SeqModel(S2S["vocab"], S2S["vocab"], embed_dim=S2S["embed"],
                         hidden_dim=S2S["hidden"])
    return SGDTrainer(model.cost, Adam(learning_rate=1e-3), seed=0, device=device, **kw)


def eager_steps(trainer, batch, n, k=1):
    """n dispatches of k steps through the eager body a graph captures, on
    the card, with no graph (the warm-up's path) -> their costs (device)."""
    costs = []
    for _ in range(n):
        costs.extend(trainer._eager(batch, k)[0])
    return costs


def timed_calls(torch, call, n):
    """n calls of `call`, each ending in the fetch of its costs -> (costs,
    host ms of each call)."""
    costs, ms = [], []
    for _ in range(n):
        t = time.perf_counter()
        out = call()
        costs.extend([float(out)] if out.dim() == 0 else out.tolist())  # the fetch syncs
        ms.append((time.perf_counter() - t) * 1e3)
    return costs, ms


def device_ms_per_call(torch, call, n=5):
    """Device ms per call: CUDA events around n calls issued back to back
    with no fetch between them (the host queues replays far faster than the
    card runs them, so the interval is the card's time)."""
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        call()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def rel_l2_max(torch, got, want):
    """Largest relative L2 distance over the tensors of two name->tensor
    dicts, and whether every tensor is bitwise equal."""
    worst = max(rel_l2(torch, got[k], v) for k, v in want.items())
    return worst, all(torch.equal(got[k], v) for k, v in want.items())


def train_phase(torch):
    """The seq2seq training step at the reference's headline widths on the
    card: SGDTrainer + Adam(1e-3), the port's own init from seed 0, one
    bench.py batch. The first step runs eagerly and captures the step as a
    CUDA graph; every later step replays it. 4 steps, held against an eager
    twin from the same parameters (costs within 1e-6 relative, parameters
    within 1e-6 relative L2; bitwise printed), then 10 timed steps; GRU
    launch counts are set to 0 just before these 14 steps and read just
    after. Then the graph's device time a step, torch.profiler over 2
    steps, and the eager twin's step time (the path without the graph)."""
    import numpy as np

    from paddle_tpu_torch.ops import rnn_kernels as K

    t0 = time.perf_counter()
    trainer = s2s_trainer("cuda")
    batch = s2s_batch(np, 0, S2S["batch"], ragged=False)
    trainer.init_state(batch)
    eager = s2s_trainer("cuda")
    eager.init_state(batch)
    eager.load_params(trainer.state["params"])
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in trainer.state["params"].values())

    torch.cuda.reset_peak_memory_stats()
    K.FWD_LAUNCHES = K.BWD_LAUNCHES = 0
    step = lambda: trainer.step(batch)  # noqa: E731
    costs, step_ms = timed_calls(torch, step, REPLAY_CHECK_STEPS)
    after_check = {k: v.clone() for k, v in trainer.state["params"].items()}
    more, more_ms = timed_calls(torch, step, TRAIN_STEPS)
    costs, step_ms = costs + more, step_ms + more_ms
    fwd, bwd = K.FWD_LAUNCHES, K.BWD_LAUNCHES
    steps = len(costs)
    graphs = list(trainer.graphs.values())
    replays = graphs[0].replays if graphs else 0
    peak = torch.cuda.max_memory_allocated()
    device_ms = device_ms_per_call(torch, step)
    med = statistics.median(more_ms)
    tokens = S2S["batch"] * S2S["trg_len"]

    eager_costs = [float(c) for c in eager_steps(eager, batch, REPLAY_CHECK_STEPS)]
    cost_err = max(abs(a - b) / abs(b) for a, b in zip(costs, eager_costs))
    param_err, bitwise = rel_l2_max(torch, after_check, eager.state["params"])
    _, eager_ms = timed_calls(torch, lambda: eager_steps(eager, batch, 1)[0], TRAIN_EAGER_STEPS)
    eager_med = statistics.median(eager_ms[1:])
    result = dict(
        config=dict(S2S, optimizer="Adam(1e-3)", precision="f32, TF32 off",
                    params=n_params),
        setup_s=setup_s, steps=steps, costs=costs, step_ms=step_ms,
        step_ms_median=med, step_ms_min=min(more_ms),
        tokens_per_s=tokens / (med / 1e3), peak_memory_bytes=peak,
        gru_fwd_launches=fwd, gru_bwd_launches=bwd,
        graphs=len(graphs), replays=replays,
        graph_device_ms_per_step=device_ms, busy_share_graph=device_ms / med,
        replay_vs_eager=dict(steps=REPLAY_CHECK_STEPS, graph_costs=costs[:REPLAY_CHECK_STEPS],
                             eager_costs=eager_costs, cost_rel_err=cost_err,
                             param_rel_l2_max=param_err, bitwise=bitwise),
        eager_step_ms_median=eager_med, eager_tokens_per_s=tokens / (eager_med / 1e3),
        python_threads=threading.active_count(),
    )
    print("train", json.dumps(result), flush=True)
    if fwd != 2 * steps or bwd != 2 * steps:
        fail(f"GRU kernels launched fwd {fwd} / bwd {bwd} times in {steps} "
             f"steps, want 2 + 2 per step (encoder fw and bw)")
    if len(graphs) != 1 or replays != steps - 1:
        fail(f"{len(graphs)} step graphs, {replays} replays in {steps} steps: "
             f"want one graph, every step after the first a replay")
    if not (cost_err <= REPLAY_RTOL and param_err <= REPLAY_RTOL):
        fail(f"replayed steps vs eager: costs {cost_err}, parameters {param_err} "
             f"(relative, want <= {REPLAY_RTOL})")
    if not all(np.isfinite(costs)):
        fail(f"non-finite training cost: {costs}")
    if not costs[-1] < costs[0]:
        fail(f"training cost did not fall: first {costs[0]}, last {costs[-1]}")
    result["profile"] = profile_train(torch, step)
    result["eager_profile"] = profile_train(torch, lambda: eager_steps(eager, batch, 1),
                                            label="train_eager_profile")
    del eager
    return result, trainer


def checkpoint_phase(torch, trainer):
    """Checkpoints at seq2seq's full width (53.7 M parameters and Adam's two
    slots), from phase 5's trainer: a sync save; an async save (the
    training thread's stall, then 3 steps while the writer writes, then
    the wait); a second async save into the kept pinned buffers; the
    async pass read back equal to the sync pass (bitwise); a load into a
    fresh trainer, whose state must equal the sync pass bitwise. Then a run
    of 3 passes of 2 batches killed (the `kill` fault) in pass 1 and
    auto-resumed from its pass-0 checkpoint, against two runs never
    stopped: bitwise equal to the first, or (where the card's step is not
    bitwise repeatable) within twice their spread."""
    import shutil

    import numpy as np

    from paddle_tpu_torch.core import faults
    from paddle_tpu_torch.trainer import checkpoint as ckpt

    root = os.path.join(REPO, "build", "chip_smoke_ckpt")
    shutil.rmtree(root, ignore_errors=True)
    batch = s2s_batch(np, 0, S2S["batch"], ragged=False)
    n_bytes = sum(v.numel() * v.element_size() for tree in trainer._trees().values()
                  for v in tree.values())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.save(os.path.join(root, "sync"), 0)
    sync_s = time.perf_counter() - t0
    stalls = []
    for i in range(2):
        t0 = time.perf_counter()
        trainer.save(os.path.join(root, f"async{i}"), 0, async_=True)
        stalls.append(time.perf_counter() - t0)
        if i == 0:
            t0 = time.perf_counter()
            for _ in range(3):
                float(trainer.step(batch))
            steps_during_write_ms = (time.perf_counter() - t0) * 1e3 / 3
        t0 = time.perf_counter()
        trainer.checkpoint_wait()
        if i == 0:
            wait_s = time.perf_counter() - t0
    sync_pass = ckpt.load_pass(os.path.join(root, "sync"))
    async_pass = ckpt.load_pass(os.path.join(root, "async0"))
    async_equal = all(
        sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k]) for k in a)
        for a, b in zip(sync_pass[:3], async_pass[:3]))

    fresh = s2s_trainer("cuda")
    fresh.init_state(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fresh.load(os.path.join(root, "sync"))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    want = {f"{name}/{k}": v for name, flat in zip(("params", "states", "opt"), sync_pass[:3])
            for k, v in flat.items()}
    got = {f"{name}/{k}": v for name, tree in fresh._trees().items() for k, v in tree.items()}
    load_bitwise = (sorted(got) == sorted(want) and all(
        np.array_equal(got[k].cpu().numpy(), want[k]) for k in want)
        and int(fresh.state["samples"]) == sync_pass[3]["extra"]["samples"])
    del fresh

    def reader():
        return iter([s2s_batch(np, seed, S2S["batch"], ragged=True) for seed in (11, 12)])

    def run(save_dir=None, resume=False):
        tr = s2s_trainer("cuda")
        tr.train(reader, num_passes=3, save_dir=save_dir, auto_resume=resume)
        out = {k: v.clone() for k, v in tr._trees()["params"].items()}
        out.update({f"opt/{k}": v.clone() for k, v in tr._trees()["opt"].items()})
        return out, int(tr.state["samples"])

    unbroken, samples_u = run()
    unbroken2, _ = run()
    torch.cuda.empty_cache()
    kill_dir = os.path.join(root, "killed")
    killed = False
    try:
        # dispatches 0-1 are pass 0 (checkpointed), 2-3 pass 1: die at 3
        with faults.inject("kill:step=3"):
            run(kill_dir)
    except faults.InjectedKill:
        killed = True
    resumed_from = ckpt.find_latest_valid_pass(kill_dir)
    resumed, samples_r = run(kill_dir, resume=True)
    spread, repeatable = rel_l2_max(torch, unbroken2, unbroken)
    err, resume_bitwise = rel_l2_max(torch, resumed, unbroken)
    shutil.rmtree(root, ignore_errors=True)
    out = dict(state_bytes=n_bytes, sync_save_s=sync_s, async_stall_s=stalls,
               async_write_wait_s=wait_s, steps_during_write_ms=steps_during_write_ms,
               async_equals_sync=async_equal, load_s=load_s, load_bitwise=load_bitwise,
               killed=killed, resumed_from_pass=resumed_from,
               samples=[samples_u, samples_r], resume_bitwise=resume_bitwise,
               resume_rel_l2_max=err, unbroken_repeatable=repeatable,
               unbroken_spread_rel_l2_max=spread)
    print("checkpoint", json.dumps(out), flush=True)
    if not async_equal:
        fail("the async checkpoint differs from the sync one")
    if not load_bitwise:
        fail("a fresh trainer's state after load differs from the checkpoint")
    if not (killed and resumed_from == 0 and samples_u == samples_r):
        fail(f"kill / resume did not run as set up: killed {killed}, resumed from "
             f"{resumed_from}, samples {samples_u} / {samples_r}")
    if not (resume_bitwise or (not repeatable and err <= 2 * spread)):
        fail(f"the resumed run differs from the unbroken one by {err} (relative L2); "
             f"two unbroken runs differ by {spread}")
    return out


def generation_phase(torch, trainer):
    """Beam-search generation on the card. The JAX package's copy task
    (vocab 12, embed 24, hidden 32; 160 samples, batches of 32 through
    `reader.batch` and a `DataFeeder` with seq_bucket [8], Adam(0.01), 30
    passes) trained with `train(..., feeder=)` on the card reproduces at
    least 3 of 4 sequences (beam 3, max_len 8). Then at full width on
    phase 5's parameters: 16 sources of 50 tokens from RandomState(0), beam
    4, max_len 50, on the card and on the CPU: each row's best-beam score
    within GEN_SCORE_TOL of the CPU's; the share of rows with identical
    best ids is printed, not held (random weights make near-ties). The
    card's ms per call (median of 3 after one warm-up), its GRU forward
    launches per call (2: the encoder) and its kernels per generated step
    (torch.profiler over one call)."""
    import numpy as np

    from paddle_tpu_torch.data import DataFeeder, InputSpec
    from paddle_tpu_torch.data import reader as rd
    from paddle_tpu_torch.models import Seq2SeqModel
    from paddle_tpu_torch.nn.graph import reset_name_scope
    from paddle_tpu_torch.ops import rnn_kernels as K
    from paddle_tpu_torch.optim import Adam
    from paddle_tpu_torch.trainer import SGDTrainer
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    vocab = 12
    rs = np.random.RandomState(1)
    samples = []
    for _ in range(160):
        toks = rs.randint(2, vocab, size=rs.randint(2, 5)).tolist()
        samples.append({"source_ids": toks, "target_ids": [0] + toks,
                        "label_ids": toks + [1]})
    reset_name_scope()
    copy = Seq2SeqModel(vocab, vocab, embed_dim=24, hidden_dim=32)
    tr = SGDTrainer(copy.cost, Adam(learning_rate=0.01), seed=0, device="cuda")
    feeder = DataFeeder({n: InputSpec("index_seq", vocab, seq_bucket=[8])
                         for n in ("source_ids", "target_ids", "label_ids")})
    t0 = time.perf_counter()
    tr.train(rd.batch(lambda: iter(samples), 32, drop_last=True), num_passes=30,
             feeder=feeder)
    copy_train_s = time.perf_counter() - t0
    src = np.zeros((4, 8), np.int32)
    for i, smp in enumerate(samples[:4]):
        src[i, :len(smp["source_ids"])] = smp["source_ids"]
    lens = np.array([len(smp["source_ids"]) for smp in samples[:4]], np.int32)
    seqs, _ = copy.build_generator(beam_size=3, max_len=8)(tr.state["params"], {}, src, lens)
    copied = 0
    for i, smp in enumerate(samples[:4]):
        top = seqs[i, 0].tolist()
        copied += (top[:top.index(1) + 1] if 1 in top else top) == smp["source_ids"] + [1]
    copy_graphs = len(tr.graphs)
    del tr

    reset_name_scope()
    model = Seq2SeqModel(S2S["vocab"], S2S["vocab"], embed_dim=S2S["embed"],
                         hidden_dim=S2S["hidden"])
    gen = model.build_generator(beam_size=GEN["beam"], max_len=GEN["max_len"])
    rs = np.random.RandomState(0)
    src = rs.randint(2, S2S["vocab"], (GEN["batch"], GEN["src_len"])).astype(np.int32)
    lens = np.full(GEN["batch"], GEN["src_len"], np.int32)
    params = trainer.state["params"]
    gen(params, {}, src, lens)  # warm-up
    K.FWD_LAUNCHES = 0
    ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        ids, scores = gen(params, {}, src, lens)
        ids, scores = ids.cpu().numpy(), scores.cpu().numpy()  # the fetch syncs
        ms.append((time.perf_counter() - t0) * 1e3)
    gru_fwd_per_call = K.FWD_LAUNCHES / 3
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        gen(params, {}, src, lens)
        torch.cuda.synchronize()
    kernels = sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA)
    busy_ms = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA) / 1e3
    t0 = time.perf_counter()
    cpu_ids, cpu_scores = gen({k: v.cpu() for k, v in params.items()}, {}, src, lens)
    cpu_s = time.perf_counter() - t0
    cpu_ids, cpu_scores = cpu_ids.numpy(), cpu_scores.numpy()
    best_err = float(np.abs(scores[:, 0] - cpu_scores[:, 0]).max())
    same_ids = float(np.mean([np.array_equal(ids[i, 0], cpu_ids[i, 0])
                              for i in range(GEN["batch"])]))
    out = dict(copy_task=dict(reproduced=int(copied), of=4, train_s=copy_train_s,
                              graphs=copy_graphs),
               config=GEN, ms_per_call=statistics.median(ms), ms_calls=ms,
               ms_per_generated_step=statistics.median(ms) / GEN["max_len"],
               kernels_per_call=kernels, kernels_per_generated_step=kernels / GEN["max_len"],
               device_busy_ms_per_call=busy_ms, gru_fwd_launches_per_call=gru_fwd_per_call,
               best_score_max_abs_err_vs_cpu=best_err, best_ids_same_share=same_ids,
               cpu_s=cpu_s, best_scores=scores[:, 0].tolist())
    print("generation", json.dumps(out), flush=True)
    if copied < 3:
        fail(f"the copy task trained on the card reproduced {copied} of 4 sequences")
    if not best_err <= GEN_SCORE_TOL:
        fail(f"best-beam scores differ card vs CPU by {best_err} > {GEN_SCORE_TOL}")
    if gru_fwd_per_call != 2:
        fail(f"{gru_fwd_per_call} GRU forward launches a generate call, want 2 (the encoder)")
    return out


def profile_train(torch, step, tag: str = "gru", steps: int = 2, label=None):
    """Where a training step's time goes: torch.profiler over `steps` calls
    of `step`. Device busy = summed kernel time over the window's wall
    time; the `<tag>_` kernels (the recurrence's) are summed apart."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            ms, n = kernels.get(e.key, (0.0, 0))
            kernels[e.key] = (ms + e.self_device_time_total / 1e3, n + e.count)
    busy_ms = sum(ms for ms, _ in kernels.values())
    ours = {k: v for k, v in kernels.items() if f"{tag}_" in k}
    rnn_ms = sum(ms for ms, _ in ours.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]
    groups = {}
    for key, (ms, n) in kernels.items():
        g = groups.setdefault(train_kernel_group(key), [0.0, 0.0])
        g[0] += ms / steps
        g[1] += n / steps
    out = {
        "steps": steps, "wall_ms_per_step": wall_ms / steps,
        "device_busy_ms_per_step": busy_ms / steps,
        "device_busy_share": busy_ms / wall_ms,
        "kernel_launches_per_step": sum(c for _, c in kernels.values()) / steps,
        "groups_ms_and_launches_per_step": groups,
        f"{tag}_kernels_ms_per_step": rnn_ms / steps,
        f"{tag}_kernels_share_of_busy": rnn_ms / busy_ms if busy_ms else 0.0,
        f"{tag}_kernels": {k[:60]: [ms / steps, c / steps] for k, (ms, c) in ours.items()},
        "top_kernels_ms_per_step": [[k[:80], ms / steps, c / steps] for k, (ms, c) in top],
    }
    label = label or ("train_profile" if tag == "gru" else f"{tag}_train_profile")
    print(label, json.dumps(out), flush=True)
    if busy_ms <= 0:
        fail("torch.profiler recorded no device time in the training steps")
    return out


# kernel-name fragments of each group in a training step's profile
_TRAIN_GROUPS = (
    ("gemm", ("gemm", "cutlass", "xmma", "sm90_", "sm80_", "ampere", "cublas")),
    ("conv", ("conv", "cudnn", "implicit", "dgrad", "wgrad", "fprop", "im2col", "col2im")),
    ("index", ("index", "gather", "scatter", "embedding", "take")),
    ("reduce", ("reduce", "softmax", "norm", "cumsum", "scan")),
    ("pool", ("pool",)),
    ("copy", ("copy", "cat", "memcpy", "memset", "fill")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def train_kernel_group(name: str) -> str:
    low = name.lower()
    for group, keys in _TRAIN_GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def train_vs_cpu_phase(torch):
    """Step-1 cost and all 22 gradients at the same widths, batch 8 with
    ragged lengths, on the card (kernels) and on the CPU (plain versions),
    from the same parameters."""
    import numpy as np

    batch = s2s_batch(np, 1, CPU_BATCH, ragged=True)
    cpu = s2s_trainer("cpu")
    cpu.init_state(batch)
    card = s2s_trainer("cuda")
    card.init_state(batch)
    card.load_params(cpu.state["params"])
    t0 = time.perf_counter()
    c_card, g_card = card.cost_and_grads(batch)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    c_cpu, g_cpu = cpu.cost_and_grads(batch)
    cpu_s = time.perf_counter() - t0
    c_card, c_cpu = float(c_card), float(c_cpu)
    grads = {}
    bad = []
    for k in sorted(g_cpu):
        a, w = g_card[k].cpu(), g_cpu[k]
        excess = float(((a - w).abs() - CPU_GRAD_TOL["rtol"] * w.abs()).max())
        grads[k] = dict(max_abs_err=float((a - w).abs().max()),
                        max_abs_grad=float(w.abs().max()), worst_excess=excess)
        if not torch.allclose(a, w, **CPU_GRAD_TOL):
            bad.append(k)
    rel = abs(c_card - c_cpu) / abs(c_cpu)
    out = dict(batch=CPU_BATCH, cost_card=c_card, cost_cpu=c_cpu, cost_rel_err=rel,
               n_grads=len(grads), grads=grads, card_s=card_s, cpu_s=cpu_s,
               src_lengths=batch["source_ids.lengths"].tolist(),
               trg_lengths=batch["target_ids.lengths"].tolist())
    print("train_vs_cpu", json.dumps(out), flush=True)
    if len(grads) != 22:
        fail(f"{len(grads)} gradients, want the model's 22 parameters")
    if not rel <= CPU_COST_RTOL:
        fail(f"step-1 cost card {c_card} vs CPU {c_cpu}: rel err {rel} > {CPU_COST_RTOL}")
    if bad:
        fail(f"gradients differ card vs CPU beyond {CPU_GRAD_TOL}: {bad}")
    return out


def lstm_trainer(device, optimizer=None):
    """SGDTrainer + SGD(0.01) over the text classifier's graph built from
    the port's public layers with peephole-free LSTMs (the graph
    `models.text_lstm` builds, minus the peepholes, which would take the
    plain step loop)."""
    from paddle_tpu_torch.nn import costs as C
    from paddle_tpu_torch.nn import layers as L
    from paddle_tpu_torch.nn.graph import reset_name_scope
    from paddle_tpu_torch.nn.recurrent import simple_lstm
    from paddle_tpu_torch.nn.seq_layers import SeqPool
    from paddle_tpu_torch.optim import SGD
    from paddle_tpu_torch.trainer import SGDTrainer

    reset_name_scope()
    ids = L.Data("word_ids", shape=(LSTM["vocab"],), is_seq=True)
    label = L.Data("label", shape=())
    x = L.Embedding(ids, LSTM["embed"], vocab_size=LSTM["vocab"], name="emb")
    for i in range(LSTM["layers"]):
        x = simple_lstm(x, LSTM["hidden"], name=f"lstm{i}", use_peephole=False)
    pooled = SeqPool(x, "max", name="pool")
    logits = L.Fc(pooled, LSTM["classes"], act=None, name="logits")
    cost = C.ClassificationCost(logits, label, name="cost")
    return SGDTrainer(cost, optimizer or SGD(learning_rate=0.01), seed=0, device=device)


def lstm_batch(np, seed, b, ragged):
    """A batch drawn as rnn_bench.py:31-36 draws it (full lengths), or with
    ragged lengths (first row full)."""
    rs = np.random.RandomState(seed)
    t, vocab = LSTM["seq_len"], LSTM["vocab"]
    batch = {
        "word_ids": rs.randint(0, vocab, (b, t)).astype(np.int32),
        "word_ids.lengths": np.full(b, t, np.int32),
        "label": rs.randint(0, 2, b),
    }
    if ragged:
        lens = rs.randint(1, t + 1, b).astype(np.int32)
        lens[0] = t
        batch["word_ids.lengths"] = lens
    return batch


def lstm_train_phase(torch):
    """The LSTM text classifier's training step at rnn_bench.py's widths and
    BASELINE's middle row on the card: SGD(0.01), the port's own init from
    seed 0, one rnn_bench batch, 2 warm-up + 10 timed steps; the first
    step runs eagerly and captures the step graph, the others replay it.
    LSTM launch counts are set to 0 just before these steps and read just
    after. Then the graph's device time a step, torch.profiler over 2
    steps, and eager steps of the same trainer (the path without the
    graph) timed."""
    import numpy as np

    from paddle_tpu_torch.ops import rnn_kernels as K

    t0 = time.perf_counter()
    trainer = lstm_trainer("cuda")
    batch = lstm_batch(np, 0, LSTM["batch"], ragged=False)
    trainer.init_state(batch)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in trainer.state["params"].values())

    torch.cuda.reset_peak_memory_stats()
    K.LSTM_FWD_LAUNCHES = K.LSTM_BWD_LAUNCHES = 0
    costs, step_ms = [], []
    for _ in range(TRAIN_WARMUP + TRAIN_STEPS):
        t = time.perf_counter()
        costs.append(float(trainer.step(batch)))  # the fetch synchronises
        step_ms.append((time.perf_counter() - t) * 1e3)
    fwd, bwd = K.LSTM_FWD_LAUNCHES, K.LSTM_BWD_LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    steps = TRAIN_WARMUP + TRAIN_STEPS
    graphs = list(trainer.graphs.values())
    replays = graphs[0].replays if graphs else 0
    med = statistics.median(step_ms[TRAIN_WARMUP:])
    device_ms = device_ms_per_call(torch, lambda: trainer.step(batch))
    _, eager_ms = timed_calls(torch, lambda: eager_steps(trainer, batch, 1)[0],
                              TRAIN_EAGER_STEPS)
    eager_med = statistics.median(eager_ms[1:])
    result = dict(
        config=dict(LSTM, optimizer="SGD(0.01)", precision="f32, TF32 off",
                    peepholes=False, params=n_params),
        setup_s=setup_s, steps=steps, costs=costs, step_ms=step_ms,
        step_ms_median=med, step_ms_min=min(step_ms[TRAIN_WARMUP:]),
        samples_per_s=LSTM["batch"] / (med / 1e3),
        tokens_per_s=LSTM["batch"] * LSTM["seq_len"] / (med / 1e3),
        peak_memory_bytes=peak, lstm_fwd_launches=fwd, lstm_bwd_launches=bwd,
        graphs=len(graphs), replays=replays,
        graph_device_ms_per_step=device_ms, busy_share_graph=device_ms / med,
        eager_step_ms_median=eager_med,
        eager_tokens_per_s=LSTM["batch"] * LSTM["seq_len"] / (eager_med / 1e3),
    )
    print("lstm_train", json.dumps(result), flush=True)
    want = LSTM["layers"] * steps
    if fwd != want or bwd != want:
        fail(f"LSTM kernels launched fwd {fwd} / bwd {bwd} times in {steps} steps, "
             f"want {LSTM['layers']} + {LSTM['layers']} per step")
    if len(graphs) != 1 or replays != steps - 1:
        fail(f"{len(graphs)} LSTM step graphs, {result['replays']} replays in {steps} "
             f"steps: want one graph, every step after the first a replay")
    if not all(np.isfinite(costs)):
        fail(f"non-finite LSTM training cost: {costs}")
    if not costs[-1] < costs[0]:
        fail(f"LSTM training cost did not fall: first {costs[0]}, last {costs[-1]}")
    result["profile"] = profile_train(torch, lambda: trainer.step(batch), tag="lstm")
    return result


def lstm_vs_cpu_phase(torch):
    """Step-1 cost and all gradients of the LSTM text classifier at the same
    widths, batch 8 with ragged lengths, on the card (kernels) and on the
    CPU (plain versions), from the same parameters."""
    import numpy as np

    batch = lstm_batch(np, 1, CPU_BATCH, ragged=True)
    cpu = lstm_trainer("cpu")
    cpu.init_state(batch)
    card = lstm_trainer("cuda")
    card.init_state(batch)
    card.load_params(cpu.state["params"])
    c_card, g_card = card.cost_and_grads(batch)
    c_cpu, g_cpu = cpu.cost_and_grads(batch)
    c_card, c_cpu = float(c_card), float(c_cpu)
    grads, bad = {}, []
    for k in sorted(g_cpu):
        a, w = g_card[k].cpu(), g_cpu[k]
        grads[k] = dict(max_abs_err=float((a - w).abs().max()),
                        max_abs_grad=float(w.abs().max()))
        if not torch.allclose(a, w, **CPU_GRAD_TOL):
            bad.append(k)
    rel = abs(c_card - c_cpu) / abs(c_cpu)
    n_want = 3 + 4 * LSTM["layers"]
    out = dict(batch=CPU_BATCH, cost_card=c_card, cost_cpu=c_cpu, cost_rel_err=rel,
               n_grads=len(grads), grads=grads,
               lengths=batch["word_ids.lengths"].tolist())
    print("lstm_vs_cpu", json.dumps(out), flush=True)
    if len(grads) != n_want:
        fail(f"{len(grads)} LSTM-model gradients, want its {n_want} parameters")
    if not rel <= CPU_COST_RTOL:
        fail(f"LSTM step-1 cost card {c_card} vs CPU {c_cpu}: rel err {rel} > "
             f"{CPU_COST_RTOL}")
    if bad:
        fail(f"LSTM-model gradients differ card vs CPU beyond {CPU_GRAD_TOL}: {bad}")
    return out


def resnet_batches(np, size, b, k, classes):
    """One batch and K stacked ones, drawn as bench.py:706-710 and :764-775
    draw them (one RandomState(0): randn images, randint labels)."""
    rs = np.random.RandomState(0)
    batch = {"image": rs.randn(b, size, size, 3).astype(np.float32),
             "label": rs.randint(0, classes, b)}
    stacked = {"image": rs.randn(k, b, size, size, 3).astype(np.float32),
               "label": rs.randint(0, classes, (k, b))}
    return batch, stacked


def resnet_trainer(device, precision, size, classes, lr=0.1, remat=None, **kw):
    from paddle_tpu_torch.models import resnet50
    from paddle_tpu_torch.nn.graph import reset_name_scope
    from paddle_tpu_torch.optim import SGD
    from paddle_tpu_torch.trainer import SGDTrainer

    reset_name_scope()
    cost = resnet50(num_classes=classes, image_size=size)[3]
    return SGDTrainer(cost, SGD(learning_rate=lr, momentum=0.9), seed=0, device=device,
                      precision=precision, remat=remat, **kw)


# kernel-name fragments of each group in the ResNet-50 profile
_GROUPS = (
    ("conv", ("conv", "xmma", "cudnn", "implicit", "dgrad", "wgrad", "fprop",
              "sm90_", "sm80_", "cutlass", "gemm")),
    ("layout_transpose", ("nchwtonhwc", "nhwctonchw", "transpose")),
    ("pool", ("pool",)),
    ("reduce", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def kernel_group(name: str) -> str:
    low = name.lower()
    for group, keys in _GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def resnet_phase(torch):
    """ResNet-50 training as bench.py's run_bench drives the reference:
    224x224, batch 256, 1000 classes, bf16, SGD(0.1, momentum 0.9), 8
    stacked batches a `multi_step` call; 1 warm-up call (eager, then the 8
    steps captured as one CUDA graph) and 2 timed calls (replays), each
    ending in the fetch of its 8 costs. Then the graph's device time, one
    eager call of the same 8 steps (the path without the graph) timed, and
    torch.profiler over one call."""
    import numpy as np

    cfg = RESNET
    k = cfg["scan_k"]
    t0 = time.perf_counter()
    batch, stacked = resnet_batches(np, cfg["image_size"], cfg["batch"], k, cfg["classes"])
    draw_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    trainer = resnet_trainer("cuda", "bf16", cfg["image_size"], cfg["classes"])
    trainer.init_state(batch)
    stacked = {key: torch.as_tensor(v).to("cuda") for key, v in stacked.items()}
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in trainer.state["params"].values())

    torch.cuda.reset_peak_memory_stats()
    costs, dispatch_ms = timed_calls(torch, lambda: trainer.multi_step(stacked),
                                     cfg["warmup"] + cfg["dispatches"])
    peak = torch.cuda.max_memory_allocated()
    graphs = list(trainer.graphs.values())
    replays = graphs[0].replays if graphs else 0
    timed = dispatch_ms[cfg["warmup"]:]
    device_ms = device_ms_per_call(torch, lambda: trainer.multi_step(stacked), n=2) / k
    _, eager_ms = timed_calls(torch, lambda: torch.stack(eager_steps(trainer, stacked, 1, k)),
                              1)
    ms_per_step = statistics.median(timed) / k
    images_per_s = cfg["batch"] / (ms_per_step / 1e3)
    name = torch.cuda.get_device_name(0)
    peak_flops = bf16_peak(name)
    flops_per_image = RESNET_FLOPS_PER_IMAGE * (cfg["image_size"] / 224.0) ** 2
    states = trainer.state["states"]
    unmoved = [key for key, v in states.items()
               if bool((v == (0.0 if key.endswith("moving_mean") else 1.0)).all())]
    result = dict(
        metric="resnet50_images_per_sec_per_chip",
        resnet50_images_per_sec_per_chip=images_per_s,
        ms_per_step=ms_per_step,
        mfu=images_per_s * flops_per_image / peak_flops,
        peak_tflops_bf16=peak_flops / 1e12,
        platform="gpu", device_kind=name, precision=trainer.precision,
        batch_size=cfg["batch"], image_size=cfg["image_size"], scan_k=k,
        classes=cfg["classes"], optimizer="SGD(0.1, momentum 0.9)", params=n_params,
        n_params=len(trainer.state["params"]), n_states=len(states),
        draw_s=draw_s, setup_s=setup_s, dispatch_ms=dispatch_ms,
        ms_per_step_min=min(timed) / k, costs=costs, peak_memory_bytes=peak,
        states_unmoved=unmoved, graphs=len(graphs), replays=replays,
        graph_device_ms_per_step=device_ms,
        busy_share_graph=device_ms / (statistics.median(timed) / k),
        eager_ms_per_step=eager_ms[0] / k,
        eager_images_per_sec=cfg["batch"] / (eager_ms[0] / k / 1e3),
    )
    print("resnet", json.dumps(result), flush=True)
    if len(graphs) != 1 or replays != cfg["dispatches"]:
        fail(f"{len(graphs)} ResNet-50 step graphs, {replays} replays in "
             f"{cfg['warmup'] + cfg['dispatches']} calls: want one graph, every call "
             f"after the first a replay")
    if not all(np.isfinite(costs)):
        fail(f"non-finite ResNet-50 training cost: {costs}")
    if unmoved:
        fail(f"batch-norm moving statistics never moved from their start: {unmoved[:5]}")
    result["profile"] = profile_resnet(torch, trainer, stacked)
    return result


def profile_resnet(torch, trainer, stacked):
    """Where a ResNet-50 step's time goes: torch.profiler over one
    `multi_step` call. Device busy = summed kernel time over the window's
    wall time; kernels grouped by name (`kernel_group`). Fails if layout
    transposes run once a conv or more: cuDNN is to read the NHWC
    activations as channels_last, not copy them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    k = next(iter(stacked.values())).shape[0]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        trainer.multi_step(stacked)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            ms, n = kernels.get(e.key, (0.0, 0))
            kernels[e.key] = (ms + e.self_device_time_total / 1e3, n + e.count)
    busy_ms = sum(ms for ms, _ in kernels.values())
    groups = {}
    for key, (ms, n) in kernels.items():
        g = groups.setdefault(kernel_group(key), [0.0, 0])
        g[0] += ms / k
        g[1] += n / k
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:15]
    n_convs = sum(1 for l in trainer.network.layer_order if l.type_name == "conv")
    transposes = groups.get("layout_transpose", [0.0, 0])[1]
    out = {
        "steps": k, "wall_ms_per_step": wall_ms / k,
        "device_busy_ms_per_step": busy_ms / k,
        "device_busy_share": busy_ms / wall_ms,
        "kernel_launches_per_step": sum(c for _, c in kernels.values()) / k,
        "groups_ms_and_launches_per_step": groups,
        "layout_transposes_per_step": transposes, "convs": n_convs,
        "top_kernels_ms_per_step": [[key[:90], ms / k, c / k] for key, (ms, c) in top],
    }
    print("resnet_profile", json.dumps(out), flush=True)
    if busy_ms <= 0:
        fail("torch.profiler recorded no device time in the ResNet-50 steps")
    if transposes >= n_convs:
        fail(f"{transposes} layout-transpose kernels a step for {n_convs} convs: the "
             f"convs copy their activations")
    return out


def rel_l2(torch, got, want) -> float:
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    return float((got - want).norm() / want.norm().clamp(min=1e-30))


def resnet_vs_cpu_phase(torch):
    """ResNet-50 at 64x64, batch 4, 10 classes from the same parameters on
    the card and on the CPU. f32 (TF32 off): the step-1 cost, all 161
    gradients and all 106 new states. bf16: every layer fed the CPU's
    input to it, and the whole step's cost finite (printed beside the
    CPU's, not held: the whole graph's bf16 cost is not reproducible across
    rounding orders at this size)."""
    import numpy as np

    from paddle_tpu_torch.core import dtypes
    from paddle_tpu_torch.nn import graph as G

    cfg = RESNET_CPU
    batch, _ = resnet_batches(np, cfg["image_size"], cfg["batch"], 1, cfg["classes"])
    out = {}
    for precision in ("f32", "bf16"):
        cpu = resnet_trainer("cpu", precision, cfg["image_size"], cfg["classes"])
        cpu.init_state(batch)
        card = resnet_trainer("cuda", precision, cfg["image_size"], cfg["classes"])
        card.init_state(batch)
        card.load_params(cpu.state["params"])
        c_card, g_card, s_card = card.cost_grads_and_states(batch)
        c_cpu, g_cpu, s_cpu = cpu.cost_grads_and_states(batch)
        c_card, c_cpu = float(c_card), float(c_cpu)
        row = dict(cost_card=c_card, cost_cpu=c_cpu,
                   cost_rel_err=abs(c_card - c_cpu) / abs(c_cpu),
                   n_grads=len(g_card), n_states=len(s_card))
        if precision == "f32":
            grads = {key: rel_l2(torch, g_card[key], g) for key, g in g_cpu.items()}
            names = sorted(g_cpu)
            row["grads_all_rel_l2"] = rel_l2(
                torch, torch.cat([g_card[key].flatten().cpu() for key in names]),
                torch.cat([g_cpu[key].flatten() for key in names]))
            row["grad_rel_l2_max"] = max(grads.values())
            row["grad_rel_l2_median"] = statistics.median(grads.values())
            row["state_err_max"] = max(
                float((s_card[key].cpu() - v).abs().max() / v.abs().max())
                for key, v in s_cpu.items())
        else:
            every = G.Network([l for l in cpu.network.layer_order if l.type_name != "data"])
            values, _ = every.apply(cpu.state["params"], batch, cpu.state["states"],
                                    train=True, policy=dtypes.bf16_policy())
            ctx = G.Context("apply", card.state["params"], device=torch.device("cuda"),
                            states=card.state["states"], train=True,
                            policy=dtypes.bf16_policy())
            errs = {}
            for layer in every.outputs:
                ins = [G.Argument(torch.as_tensor(batch[i.name]).to("cuda"))
                       if i.type_name == "data" else
                       G.Argument(values[i.name].value.detach().to("cuda"))
                       for i in layer.inputs]
                errs[layer.name] = rel_l2(torch, layer.forward(ctx, ins).value,
                                          values[layer.name].value)
            row["layers"] = len(errs)
            row["layer_rel_l2_max"] = max(errs.values())
            row["layer_rel_l2_median"] = statistics.median(errs.values())
            row["layers_above_tight"] = sorted(
                key for key, e in errs.items() if e > RESNET_BF16_LAYER_TIGHT)
        out[precision] = row
    print("resnet_vs_cpu", json.dumps(out), flush=True)
    f32, bf16 = out["f32"], out["bf16"]
    if f32["n_grads"] != 161 or f32["n_states"] != 106:
        fail(f"{f32['n_grads']} gradients / {f32['n_states']} states, want 161 / 106")
    if not f32["cost_rel_err"] <= RESNET_COST_RTOL:
        fail(f"ResNet-50 f32 cost card vs CPU: rel err {f32['cost_rel_err']}")
    if not (f32["grad_rel_l2_max"] <= RESNET_GRAD_REL_L2
            and f32["grads_all_rel_l2"] <= RESNET_ALL_GRADS_REL_L2):
        fail(f"ResNet-50 f32 gradients card vs CPU: {f32['grad_rel_l2_max']} / "
             f"{f32['grads_all_rel_l2']}")
    if not f32["state_err_max"] <= RESNET_STATE_RTOL:
        fail(f"ResNet-50 f32 states card vs CPU: {f32['state_err_max']}")
    if not np.isfinite(bf16["cost_card"]):
        fail(f"ResNet-50 bf16 cost on the card is {bf16['cost_card']}")
    if not (bf16["layer_rel_l2_max"] <= RESNET_BF16_LAYER_REL_L2
            and len(bf16["layers_above_tight"]) <= RESNET_BF16_RELU_FLIPS):
        fail(f"ResNet-50 bf16 layers card vs CPU: max {bf16['layer_rel_l2_max']}, "
             f"above {RESNET_BF16_LAYER_TIGHT}: {bf16['layers_above_tight']}")
    return out


def lenet_phase(torch):
    """LeNet (BASELINE config #1) at 28x28, batch 8, f32 with TF32 off, on
    the card and on the CPU from the same parameters: the step-1 cost
    (1e-5 relative), every gradient (rtol 1e-3, atol 1e-4 x max(1,
    max|g|)), and the parameters after two SGD(0.05, momentum 0.9) steps
    (atol 1e-5)."""
    import numpy as np

    from paddle_tpu_torch.models import lenet
    from paddle_tpu_torch.nn.graph import reset_name_scope
    from paddle_tpu_torch.optim import SGD
    from paddle_tpu_torch.trainer import SGDTrainer

    batches = []
    for seed in (0, 1):
        rs = np.random.RandomState(seed)
        batches.append({"pixel": rs.randn(LENET_BATCH, 28, 28, 1).astype(np.float32),
                        "label": rs.randint(0, 10, LENET_BATCH)})
    trainers = {}
    for dev in ("cpu", "cuda"):
        reset_name_scope()
        trainers[dev] = SGDTrainer(lenet()[3], SGD(learning_rate=0.05, momentum=0.9),
                                   seed=0, device=dev)
        trainers[dev].init_state(batches[0])
    cpu, card = trainers["cpu"], trainers["cuda"]
    card.load_params(cpu.state["params"])
    c_card, g_card = card.cost_and_grads(batches[0])
    c_cpu, g_cpu = cpu.cost_and_grads(batches[0])
    bad = [key for key, g in g_cpu.items() if not torch.allclose(
        g_card[key].cpu(), g, rtol=1e-3, atol=1e-4 * max(1.0, float(g.abs().max())))]
    grads = {key: dict(max_abs_err=float((g_card[key].cpu() - g).abs().max()),
                       max_abs_grad=float(g.abs().max()),
                       rel_l2=rel_l2(torch, g_card[key], g)) for key, g in g_cpu.items()}
    for b in batches:
        card.step(b)
        cpu.step(b)
    param_err = max(float((card.state["params"][key].cpu() - v).abs().max())
                    for key, v in cpu.state["params"].items())
    rel = abs(float(c_card) - float(c_cpu)) / abs(float(c_cpu))
    out = dict(batch=LENET_BATCH, cost_card=float(c_card), cost_cpu=float(c_cpu),
               cost_rel_err=rel, n_grads=len(g_cpu), grads_outside_tol=bad, grads=grads,
               params_max_abs_err_after_2_steps=param_err)
    print("lenet", json.dumps(out), flush=True)
    if not rel <= CPU_COST_RTOL:
        fail(f"LeNet cost card vs CPU: rel err {rel}")
    if bad:
        fail(f"LeNet gradients differ card vs CPU: {bad}")
    if not param_err <= 1e-5:
        fail(f"LeNet parameters after two steps differ card vs CPU by {param_err}")
    return out


def rnn_counts():
    """Every recurrent and attention kernel's launch counter."""
    from paddle_tpu_torch.ops import rnn_kernels as K

    return {name: getattr(K, name) for name in (
        "FWD_LAUNCHES", "BWD_LAUNCHES", "LSTM_FWD_LAUNCHES", "LSTM_BWD_LAUNCHES",
        "ATTN_LAUNCHES")}


def zero_rnn_counts() -> None:
    from paddle_tpu_torch.ops import rnn_kernels as K

    for name in rnn_counts():
        setattr(K, name, 0)


def ctr_batch(np, cfg, b, seed):
    """A CTR batch drawn as tests/test_models.py:96-103 draws it: a click
    for every even slot-0 id, multi-hot wide features in [0, 0.1)."""
    rs = np.random.RandomState(seed)
    vocabs = cfg["slot_vocab_sizes"]
    slot0 = rs.randint(0, vocabs[0], b)
    batch = {"wide_features": rs.rand(b, cfg["wide_dim"]).astype(np.float32) * 0.1,
             "slot0_id": slot0}
    for i, v in enumerate(vocabs[1:], start=1):
        batch[f"slot{i}_id"] = rs.randint(0, v, b)
    batch["click"] = (slot0 % 2).astype(np.float32)[:, None]
    return batch


def ctr_trainer(device, cfg, lr):
    from paddle_tpu_torch.models import ctr_wide_deep
    from paddle_tpu_torch.nn.graph import reset_name_scope
    from paddle_tpu_torch.optim import SGD
    from paddle_tpu_torch.trainer import SGDTrainer

    reset_name_scope()
    return SGDTrainer(ctr_wide_deep(**cfg)[3], SGD(learning_rate=lr), seed=0, device=device)


def ocr_batch(np, cfg, b, seed, labels=OCR_LABELS):
    """An OCR batch: randn images, label strings of labels[0]..labels[1]
    ids in [1, num_classes] (0 is the CTC blank)."""
    rs = np.random.RandomState(seed)
    lo, hi = labels
    return {"image": rs.randn(b, cfg["image_height"], cfg["image_width"],
                              cfg.get("num_channels", 1)).astype(np.float32),
            "label": rs.randint(1, cfg["num_classes"] + 1, (b, hi)).astype(np.int32),
            "label.lengths": rs.randint(lo, hi + 1, b).astype(np.int32)}


def ocr_trainer(device, cfg, lr):
    from paddle_tpu_torch.models import ocr_crnn
    from paddle_tpu_torch.nn.graph import reset_name_scope
    from paddle_tpu_torch.optim import SGD
    from paddle_tpu_torch.trainer import SGDTrainer

    reset_name_scope()
    return SGDTrainer(ocr_crnn(**cfg)[3], SGD(learning_rate=lr), seed=0, device=device)


def model_train_phase(torch, name, trainer, batch, examples, config):
    """A model's training step at full width on the card: MODEL_WARMUP +
    MODEL_STEPS steps on one batch (moved to the card once: set-up), the
    first eager and captured as the step graph, the others replays. The
    kernel counters are set to 0 just before these steps and read just
    after: this path holds no ported TPU kernel, so each must stay 0. Then
    the graph's device time a step, eager steps timed, torch.profiler over
    2 steps."""
    import numpy as np

    t0 = time.perf_counter()
    trainer.init_state(batch)
    dev_batch = {k: torch.as_tensor(v).to("cuda") for k, v in batch.items()}
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in trainer.state["params"].values())
    states0 = {k: v.clone() for k, v in trainer.state["states"].items()}

    torch.cuda.reset_peak_memory_stats()
    zero_rnn_counts()
    steps = MODEL_WARMUP + MODEL_STEPS
    costs, step_ms = timed_calls(torch, lambda: trainer.step(dev_batch), steps)
    launches = rnn_counts()
    peak = torch.cuda.max_memory_allocated()
    graphs = list(trainer.graphs.values())
    replays = graphs[0].replays if graphs else 0
    med = statistics.median(step_ms[MODEL_WARMUP:])
    device_ms = device_ms_per_call(torch, lambda: trainer.step(dev_batch))
    _, eager_ms = timed_calls(torch, lambda: eager_steps(trainer, dev_batch, 1)[0],
                              TRAIN_EAGER_STEPS)
    eager_med = statistics.median(eager_ms[1:])
    unmoved = [k for k, v in trainer.state["states"].items() if torch.equal(v, states0[k])]
    result = dict(
        config=config, params=n_params, setup_s=setup_s, steps=steps, costs=costs,
        step_ms=step_ms, step_ms_median=med, step_ms_min=min(step_ms[MODEL_WARMUP:]),
        examples_per_s=examples / (med / 1e3), peak_memory_bytes=peak,
        kernel_launches=launches, graphs=len(graphs), replays=replays,
        graph_device_ms_per_step=device_ms, busy_share_graph=device_ms / med,
        eager_step_ms_median=eager_med, eager_examples_per_s=examples / (eager_med / 1e3),
        states=sorted(states0), states_unmoved=unmoved,
    )
    print(name, json.dumps(result), flush=True)
    if len(graphs) != 1 or replays != steps - 1:
        fail(f"{len(graphs)} {name} step graphs, {replays} replays in {steps} steps: want "
             f"one graph, every step after the first a replay")
    if any(launches.values()):
        fail(f"the {name} step launched ported kernels it does not run: {launches}")
    if not all(np.isfinite(costs)):
        fail(f"non-finite {name} training cost: {costs}")
    if not costs[-1] < costs[0]:
        fail(f"{name} training cost did not fall: first {costs[0]}, last {costs[-1]}")
    if unmoved:
        fail(f"{name}: states never moved from their start: {unmoved}")
    result["profile"] = profile_train(torch, lambda: trainer.step(dev_batch), tag=name,
                                      label=f"{name}_profile")
    return result


def model_vs_cpu_phase(torch, name, make_trainer, batches, cost_rtol=CPU_COST_RTOL,
                       grad_tol=CPU_GRAD_TOL, param_atol=1e-5):
    """A model at its test config on the card and on the CPU from the same
    parameters: the step-1 cost (`cost_rtol` relative), every gradient
    (rtol, atol x max(1, max|g|)), and the parameters and states after one
    step per batch (`param_atol`; the card's first step eager and captured,
    the others replays)."""
    cpu, card = make_trainer("cpu"), make_trainer("cuda")
    cpu.init_state(batches[0])
    card.init_state(batches[0])
    card.load_params(cpu.state["params"])
    c_card, g_card = card.cost_and_grads(batches[0])
    c_cpu, g_cpu = cpu.cost_and_grads(batches[0])
    grads, bad = {}, []
    for k, g in sorted(g_cpu.items()):
        a = g_card[k].cpu()
        atol = grad_tol["atol"] * max(1.0, float(g.abs().max()))
        grads[k] = dict(max_abs_err=float((a - g).abs().max()), max_abs_grad=float(g.abs().max()))
        if not torch.allclose(a, g, rtol=grad_tol["rtol"], atol=atol):
            bad.append(k)
    for b in batches:
        card.step(b)
        cpu.step(b)
    after = {f"{kind}:{k}": float((card.state[kind][k].cpu() - v).abs().max())
             for kind in ("params", "states") for k, v in cpu.state[kind].items()}
    rel = abs(float(c_card) - float(c_cpu)) / abs(float(c_cpu))
    graphs = list(card.graphs.values())
    out = dict(batch=len(next(iter(batches[0].values()))), cost_card=float(c_card),
               cost_cpu=float(c_cpu), cost_rel_err=rel, n_grads=len(grads),
               grads_outside_tol=bad, grads=grads, steps=len(batches),
               replays=graphs[0].replays if graphs else 0,
               max_abs_err_after_steps=max(after.values()), worst_after=max(after, key=after.get))
    print(f"{name}_vs_cpu", json.dumps(out), flush=True)
    if not rel <= cost_rtol:
        fail(f"{name} step-1 cost card {float(c_card)} vs CPU {float(c_cpu)}: rel err {rel}")
    if bad:
        fail(f"{name} gradients differ card vs CPU beyond {grad_tol}: {bad}")
    if not out["max_abs_err_after_steps"] <= param_atol:
        fail(f"{name} parameters or states after {len(batches)} steps differ card vs CPU by "
             f"{out['max_abs_err_after_steps']} ({out['worst_after']})")
    return out


def ctr_phase(torch):
    """CTR wide&deep at the JAX package's default widths, batch 4096 (see
    `model_train_phase`), then card vs CPU at tests/test_models.py's
    config: step-1 cost, every gradient, the parameters after two steps."""
    import numpy as np

    cfg = CTR
    trainer = ctr_trainer("cuda", cfg, CTR_LR)
    batch = ctr_batch(np, cfg, CTR_BATCH, 0)
    res = model_train_phase(torch, "ctr", trainer, batch, CTR_BATCH,
                            dict(cfg, batch=CTR_BATCH, optimizer=f"SGD({CTR_LR})",
                                 precision="f32, TF32 off"))
    del trainer
    torch.cuda.empty_cache()
    res["vs_cpu"] = model_vs_cpu_phase(
        torch, "ctr", lambda dev: ctr_trainer(dev, CTR_SMALL, CTR_LR),
        [ctr_batch(np, CTR_SMALL, CTR_SMALL_BATCH, s) for s in (1, 2)])
    return res


def ocr_phase(torch):
    """OCR CRNN + CTC at the JAX package's default widths, batch 128 (see
    `model_train_phase`; the batch norm's moving statistics move inside
    the graph), then card vs CPU at tests/test_models.py's config: step-1
    cost, every gradient, the parameters and states after two steps."""
    import numpy as np

    cfg = OCR
    trainer = ocr_trainer("cuda", cfg, OCR_LR)
    batch = ocr_batch(np, cfg, OCR_BATCH, 0)
    frames = cfg["image_width"] // 4
    res = model_train_phase(torch, "ocr", trainer, batch, OCR_BATCH,
                            dict(cfg, batch=OCR_BATCH, frames=frames,
                                 frame_features=128 * cfg["image_height"] // 8,
                                 labels=OCR_LABELS, optimizer=f"SGD({OCR_LR})",
                                 precision="f32, TF32 off", peepholes=True))
    res["images_per_s"] = res["examples_per_s"]
    if len(res["states"]) != 2:
        fail(f"OCR states {res['states']}: want bn3's moving mean and variance")
    del trainer
    torch.cuda.empty_cache()
    res["vs_cpu"] = model_vs_cpu_phase(
        torch, "ocr", lambda dev: ocr_trainer(dev, OCR_SMALL, OCR_LR),
        [ocr_batch(np, OCR_SMALL, 2, s, labels=(4, 6)) for s in (1, 2)],
        grad_tol=dict(rtol=1e-3, atol=1e-4), param_atol=1e-4)
    return res


def events_ms(torch, fn, n=10):
    """Device ms per call by CUDA events around n calls after 2 warm-ups."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def graph_of(torch, fn):
    """`fn` captured as a CUDA graph after a side-stream warm-up -> (the
    graph, its static outputs)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    return graph, out


def struct_ops_phase(torch):
    """CTC and CRF on the card against their CPU run, and Gru(act="relu")
    on the step loop.

    ctc_loss at OCR's shape ([128, 32, 81] logits, frames 25-32, labels
    4-12): values (STRUCT_RTOL relative) and the logits' gradient (1e-5 x
    max(1, max|g|)) card vs CPU; as an independent check
    torch.nn.functional.ctc_loss(reduction="none", blank=0) on the card
    (TORCH_CTC_RTOL, values and gradients); times of forward + backward:
    the port's eager, the port's inside one CUDA graph, and torch's.
    crf_nll at B=128, T=50, 32 tags, ragged: values card vs CPU as for
    CTC, both gradients within 1e-4 x max(1, max|g|) (marginals of
    log-space sums that reach hundreds over 50 steps, where an f32 ulp is
    ~1e-5; the weight's entries sum 6400 terms each); crf_decode's tags
    equal. gru_scan with act="relu" at
    T=50, B=128, H=512: the step loop, no GRU kernel launch, outputs 1e-4
    and gradients 1e-3 x max(1, max|g|) card vs CPU (outputs 1e-4 x
    max(1, max|h|): a relu candidate is not bounded)."""
    import numpy as np

    import torch.nn.functional as F

    from paddle_tpu_torch.ops import crf as crf_ops
    from paddle_tpu_torch.ops import ctc as ctc_ops
    from paddle_tpu_torch.ops import rnn as R

    res, errs, limits = {}, {}, {}

    def hold(key, got, want, rtol=None, scale=None):
        """rtol: each value within rtol of its own size; scale: within
        scale x max(1, max|want|)."""
        got, want = got.detach().cpu().double(), want.detach().cpu().double()
        if rtol is not None:
            errs[key] = float(((got - want).abs() / want.abs()).max())
            limits[key] = rtol
        else:
            errs[key] = float((got - want).abs().max())
            limits[key] = scale * max(1.0, float(want.abs().max()))

    # CTC
    sh = CTC_SHAPE
    rs = np.random.RandomState(0)
    logits = torch.from_numpy(rs.randn(sh["b"], sh["t"], sh["c"]).astype(np.float32) * 2)
    labels = torch.from_numpy(rs.randint(1, sh["c"], (sh["b"], sh["l"])).astype(np.int32))
    fl = torch.from_numpy(rs.randint(25, sh["t"] + 1, sh["b"]).astype(np.int32))
    ll = torch.from_numpy(rs.randint(4, sh["l"] + 1, sh["b"]).astype(np.int32))

    def ctc(dev):
        x = logits.to(dev).requires_grad_(True)
        nll = ctc_ops.ctc_loss(x, fl.to(dev), labels.to(dev), ll.to(dev))
        return (nll.detach(),) + torch.autograd.grad(nll.sum(), x)

    card, cpu = ctc("cuda"), ctc("cpu")
    hold("ctc_nll", card[0], cpu[0], rtol=STRUCT_RTOL)
    hold("ctc_grad", card[1], cpu[1], scale=1e-5)
    xs = logits.cuda()
    args = (fl.cuda(), labels.cuda(), ll.cuda())

    def torch_ctc():
        x = xs.detach().requires_grad_(True)
        nll = F.ctc_loss(torch.log_softmax(x, -1).transpose(0, 1), args[1].long(),
                         args[0].long(), args[2].long(), blank=0, reduction="none")
        return (nll.detach(),) + torch.autograd.grad(nll.sum(), x)

    ref = torch_ctc()
    hold("ctc_nll_vs_torch", card[0], ref[0], rtol=TORCH_CTC_RTOL)
    hold("ctc_grad_vs_torch", card[1], ref[1], scale=TORCH_CTC_RTOL)

    def ours():
        x = xs.detach().requires_grad_(True)
        return torch.autograd.grad(ctc_ops.ctc_loss(x, *args).sum(), x)[0]

    graph, _ = graph_of(torch, ours)
    res["ctc"] = dict(shape=sh, ms_eager=events_ms(torch, ours),
                      ms_graph=events_ms(torch, graph.replay),
                      torch_ctc_loss_ms=events_ms(torch, torch_ctc))

    # CRF
    sh = CRF_SHAPE
    rs = np.random.RandomState(1)
    emissions = torch.from_numpy(rs.randn(sh["b"], sh["t"], sh["c"]).astype(np.float32) * 2)
    tags = torch.from_numpy(rs.randint(0, sh["c"], (sh["b"], sh["t"])).astype(np.int32))
    lens = torch.from_numpy(rs.randint(1, sh["t"] + 1, sh["b"]).astype(np.int32))
    w = torch.from_numpy(rs.randn(sh["c"] + 2, sh["c"]).astype(np.float32) * 0.5)

    def crf(dev):
        e, ww = emissions.to(dev).requires_grad_(True), w.to(dev).requires_grad_(True)
        nll = crf_ops.crf_nll(e, lens.to(dev), tags.to(dev), ww)
        ge, gw = torch.autograd.grad(nll.sum(), (e, ww))
        return nll.detach(), ge, gw, crf_ops.crf_decode(e.detach(), lens.to(dev), ww.detach())

    card, cpu = crf("cuda"), crf("cpu")
    hold("crf_nll", card[0], cpu[0], rtol=STRUCT_RTOL)
    # the gradients are marginals exp(alpha + beta - log Z) of log-space sums
    # that reach hundreds over 50 steps, where an f32 ulp is ~1e-5; each of
    # w's entries also sums B*T = 6400 terms, in another order on the card
    hold("crf_grad_emissions", card[1], cpu[1], scale=1e-4)
    hold("crf_grad_w", card[2], cpu[2], scale=1e-4)
    decode_equal = bool(torch.equal(card[3].cpu(), cpu[3]))
    e_dev, w_dev, lens_dev, tags_dev = (emissions.cuda(), w.cuda(), lens.cuda(), tags.cuda())

    def crf_step():
        e, ww = e_dev.detach().requires_grad_(True), w_dev.detach().requires_grad_(True)
        return torch.autograd.grad(crf_ops.crf_nll(e, lens_dev, tags_dev, ww).sum(), (e, ww))

    res["crf"] = dict(shape=sh, decode_equal=decode_equal, ms_eager=events_ms(torch, crf_step),
                      decode_ms_eager=events_ms(
                          torch, lambda: crf_ops.crf_decode(e_dev, lens_dev, w_dev)))

    # Gru(act="relu") takes the step loop
    t, b, h = 50, 128, 512
    g = torch.Generator().manual_seed(7)
    x = {"proj": torch.randn(b, t, 3 * h, generator=g) * 0.5,
         "w": torch.randn(h, 3 * h, generator=g) * (0.3 * (64 / h) ** 0.5),
         "bias": torch.randn(3 * h, generator=g) * 0.1}
    mask = (torch.arange(t)[None, :] < 30 + torch.arange(b)[:, None] % 21).float()
    out = {}
    zero_rnn_counts()
    for dev in ("cuda", "cpu"):
        xs_ = {k: v.to(dev).requires_grad_(True) for k, v in x.items()}
        p = R.GruParams(xs_["w"][:, :2 * h], xs_["w"][:, 2 * h:], xs_["bias"])
        hs, h_last = R.gru_scan(xs_["proj"], mask.to(dev), p, cand_act="relu")
        grads = torch.autograd.grad((hs * hs).sum() + h_last.sum(), list(xs_.values()))
        out[dev] = [hs.detach(), h_last.detach()] + list(grads)
    torch.cuda.synchronize()
    gru_launches = rnn_counts()
    for i, part in enumerate(("hs", "h_last", "dproj", "dw", "dbias")):
        hold(f"gru_relu_{part}", out["cuda"][i], out["cpu"][i], scale=1e-4 if i < 2 else 1e-3)
    res.update(gru_relu=dict(shape=dict(t=t, b=b, h=h), kernel_launches=gru_launches),
               errors=errs, limits=limits)
    print("struct_ops", json.dumps(res), flush=True)
    bad = [k for k in errs if not errs[k] <= limits[k]]
    if bad:
        fail(f"CTC / CRF / GRU(relu) on the card differ beyond their limits in {bad}: {errs}")
    if not decode_equal:
        fail("crf_decode's tags on the card differ from the CPU's")
    if any(gru_launches.values()):
        fail(f"gru_scan(act='relu') launched kernels: {gru_launches}")
    return res


def vgg_train_flops(size, batch, classes, fc_dim, depth=19):
    """FLOPs of one training step (forward, and the backward's two products
    a layer) from VGG's convs and fcs: 3 x 2 x the multiply-adds."""
    from paddle_tpu_torch.models.vgg import BLOCKS, CHANNELS

    macs, side, cin = 0, size, 3
    for n, ch in zip(BLOCKS[depth], CHANNELS):
        for _ in range(n):
            macs += side * side * 9 * cin * ch
            cin = ch
        side //= 2
    macs += side * side * 512 * fc_dim + fc_dim * fc_dim + fc_dim * classes
    return 3 * 2 * macs * batch


def vgg_trainer(device, precision, cfg, extras=False):
    """SGDTrainer over VGG-19 with Momentum(0.9), discexp after a warmup and
    a ModelAverage; `extras` hands drop6's output to every step's extras."""
    from paddle_tpu_torch.models import vgg
    from paddle_tpu_torch.nn.graph import Network, reset_name_scope
    from paddle_tpu_torch.optim import ModelAverage, Momentum, schedules
    from paddle_tpu_torch.trainer import SGDTrainer

    reset_name_scope()
    cost = vgg(19, num_classes=cfg["classes"], image_size=cfg["image_size"],
               fc_dim=cfg["fc_dim"])[3]
    extra = [x for x in Network(cost).layer_order if x.name == "drop6"] if extras else []
    lr = VGG["lr"]
    return SGDTrainer(
        cost, Momentum(learning_rate=lr, momentum=0.9), seed=0, device=device,
        precision=precision, extra_outputs=extra,
        schedule=schedules.build(lr, "discexp", decay_a=VGG["decay_a"],
                                 decay_b=VGG["decay_b"], warmup_samples=VGG["warmup"]),
        model_average=ModelAverage(0.5))


def vgg_phase(torch):
    """VGG-19 training at 224x224, batch 64, bf16, Momentum(0.9) + discexp +
    warmup + ModelAverage: one eager step, its capture and 11 replays (the
    last 11 timed), each the whole step including the schedule, the
    Dropout keys and the average, on one batch drawn as bench.py draws
    images. Then the graph's device time, two more replays whose drop6
    outputs must be nonzero only where jax's mask for that step keeps and
    must differ from each other, and test() on the averaged parameters."""
    import numpy as np

    from paddle_tpu_torch.core import prng
    from paddle_tpu_torch.nn.graph import _stable_hash

    cfg = VGG
    t0 = time.perf_counter()
    batch, _ = resnet_batches(np, cfg["image_size"], cfg["batch"], 1, cfg["classes"])
    trainer = vgg_trainer("cuda", "bf16", cfg, extras=True)
    trainer.init_state(batch)
    dev = {k: torch.as_tensor(v).to("cuda") for k, v in batch.items()}
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in trainer.state["params"].values())

    torch.cuda.reset_peak_memory_stats()
    costs, step_ms = timed_calls(torch, lambda: trainer.step(dev), cfg["steps"])
    peak = torch.cuda.max_memory_allocated()
    graphs = list(trainer.graphs.values())
    replays = graphs[0].replays if graphs else 0
    med = statistics.median(step_ms[1:])
    device_ms = device_ms_per_call(torch, lambda: trainer.step(dev), n=3)
    flops = vgg_train_flops(cfg["image_size"], cfg["batch"], cfg["classes"], cfg["fc_dim"])
    name = torch.cuda.get_device_name(0)
    masks = []
    for _ in range(2):
        key = prng.fold_in(trainer.state["rng"], trainer.state["samples"])
        want = prng.bernoulli(prng.fold_in(prng.fold_in(key, _stable_hash("drop6")), 1),
                              0.5, (cfg["batch"], cfg["fc_dim"]))
        _, extras = trainer._dispatch(dev, 1)
        masks.append((extras["drop6"] != 0, want))
    outside = [int((kept & ~want).sum()) for kept, want in masks]
    fresh = not torch.equal(masks[0][1], masks[1][1]) and not torch.equal(masks[0][0],
                                                                         masks[1][0])
    kept_share = [float(kept.float().mean()) for kept, _ in masks]
    test_cost = trainer.test(lambda: iter([dev]))["cost"]
    with torch.no_grad():
        raw_cost = float(trainer._cost(trainer.state["params"], dev, train=False)[0])
    result = dict(
        config=dict(cfg, precision=trainer.precision, optimizer="Momentum(0.9)",
                    schedule="discexp + warmup", model_average="ModelAverage(0.5)"),
        params=n_params, setup_s=setup_s, steps=cfg["steps"], costs=costs, step_ms=step_ms,
        step_ms_median=med, step_ms_min=min(step_ms[1:]),
        images_per_s=cfg["batch"] / (med / 1e3), peak_memory_bytes=peak,
        graphs=len(graphs), replays=replays, graph_device_ms_per_step=device_ms,
        busy_share_graph=device_ms / med, train_flops_per_step=flops,
        mfu=flops / (med / 1e3) / bf16_peak(name), peak_tflops_bf16=bf16_peak(name) / 1e12,
        drop6_kept_outside_mask=outside, drop6_masks_differ=fresh,
        drop6_kept_share=kept_share, samples=int(trainer.state["samples"]),
        lr_scale=float(trainer.state["lr_scale"]),
        average_n=float(trainer.state["avg"]["n"]), test_cost_averaged=test_cost,
        cost_raw_params=raw_cost,
    )
    print("vgg", json.dumps(result), flush=True)
    if len(graphs) != 1 or replays != cfg["steps"] - 1:
        fail(f"{len(graphs)} VGG step graphs, {replays} replays in {cfg['steps']} steps: "
             f"want one graph, every step after the first a replay")
    if not all(np.isfinite(costs)):
        fail(f"non-finite VGG-19 training cost: {costs}")
    if not statistics.median(costs[-3:]) < costs[0]:
        fail(f"VGG-19 training cost did not fall: first {costs[0]}, last three {costs[-3:]}")
    if any(outside) or not fresh:
        fail(f"drop6's replayed masks: {outside} values kept outside jax's mask, "
             f"masks differ between replays: {fresh}")
    if not (np.isfinite(test_cost) and result["average_n"] == cfg["steps"] + 5):
        fail(f"test() on the averaged parameters: cost {test_cost}, average over "
             f"{result['average_n']} steps")
    result["profile"] = profile_train(torch, lambda: trainer.step(dev), tag="vgg",
                                      label="vgg_profile")
    result["vs_cpu"] = vgg_vs_cpu_phase(torch)
    return result, trainer, dev


def vgg_vs_cpu_phase(torch):
    """The tiny VGG-19 of tests/test_torch_vgg.py (image 32, fc 64, 10
    classes, batch 4) in f32 on the card and on the CPU from the same
    parameters: the first step's cost and gradients at the same key, then 3
    steps (the card's first eager and captured, then replays), parameters
    and averages after them."""
    import numpy as np

    cfg = VGG_SMALL

    def batch(seed):
        rs = np.random.RandomState(seed)
        return {"image": rs.rand(cfg["batch"], cfg["image_size"], cfg["image_size"], 3)
                .astype(np.float32),
                "label": rs.randint(0, cfg["classes"], cfg["batch"]).astype(np.int32)}

    cpu, card = vgg_trainer("cpu", "f32", cfg), vgg_trainer("cuda", "f32", cfg)
    cpu.init_state(batch(0))
    card.init_state(batch(0))
    card.load_params(cpu.state["params"])
    c_card, g_card = card.cost_and_grads(batch(1))
    c_cpu, g_cpu = cpu.cost_and_grads(batch(1))
    cost_err = abs(float(c_card) - float(c_cpu)) / abs(float(c_cpu))
    grad_err = {k: rel_l2(torch, g_card[k].cpu(), v) for k, v in g_cpu.items()}
    costs_card = [float(card.step(batch(s))) for s in (1, 2, 3)]
    costs_cpu = [float(cpu.step(batch(s))) for s in (1, 2, 3)]
    step_cost_err = max(abs(a - b) / abs(b) for a, b in zip(costs_card, costs_cpu))
    after = {**{k: (card.state["params"][k].cpu(), v) for k, v in cpu.state["params"].items()},
             **{f"avg/{k}": (card.state["avg"]["avg"][k].cpu(), v)
                for k, v in cpu.state["avg"]["avg"].items()}}
    after_err = {k: float((a - w).abs().max()) / max(1.0, float(w.abs().max()))
                 for k, (a, w) in after.items()}
    after_rel_l2 = {k: rel_l2(torch, a, w) for k, (a, w) in after.items()}
    replays = sum(g.replays for g in card.graphs.values())
    out = dict(config=cfg, cost_rel_err=cost_err, grad_rel_l2_max=max(grad_err.values()),
               step_costs_card=costs_card, step_costs_cpu=costs_cpu,
               step_cost_rel_err=step_cost_err,
               after_steps_max_abs_err_scaled=max(after_err.values()),
               after_steps_rel_l2_max=max(after_rel_l2.values()),
               after_steps_rel_l2_worst=max(after_rel_l2, key=after_rel_l2.get),
               replays=replays, tolerances=dict(cost=VGG_COST_RTOL, grad_rel_l2=VGG_REL_L2,
                                                after_steps_atol=VGG_PARAM_ATOL))
    print("vgg_vs_cpu", json.dumps(out), flush=True)
    if replays != 2:
        fail(f"tiny VGG-19 on the card: {replays} replays in 3 steps, want 2")
    if not (cost_err <= VGG_COST_RTOL and step_cost_err <= VGG_COST_RTOL):
        fail(f"tiny VGG-19 cost card vs CPU: {cost_err}, steps {step_cost_err} "
             f"(relative, want <= {VGG_COST_RTOL})")
    bad = ([k for k, e in grad_err.items() if not e <= VGG_REL_L2]
           + [k for k, e in after_err.items() if not e <= VGG_PARAM_ATOL])
    if bad:
        fail(f"tiny VGG-19 card vs CPU: gradients beyond {VGG_REL_L2} relative L2 or "
             f"parameters / averages beyond {VGG_PARAM_ATOL} x max(1, max|p|): {bad[:6]}")
    return out


def remat_phase(torch):
    """Phase 10's ResNet-50 step (224x224, batch 256, bf16, one step a
    dispatch) without remat and under remat="conv_only" from the same
    parameters: ms a step, the graph's device ms and the peak memory of
    each (reset before the eager step, so the eager step and the capture
    both count), and the parameters after the same steps."""
    import numpy as np

    cfg = RESNET
    batch, _ = resnet_batches(np, cfg["image_size"], cfg["batch"], 1, cfg["classes"])
    dev = {k: torch.as_tensor(v).to("cuda") for k, v in batch.items()}
    out, params = {}, {}

    def run(label, policy):
        torch.cuda.empty_cache()
        trainer = resnet_trainer("cuda", "bf16", cfg["image_size"], cfg["classes"],
                                 remat=policy)
        trainer.init_state(batch)
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        costs, ms = timed_calls(torch, lambda: trainer.step(dev), REMAT_STEPS)
        peak = torch.cuda.max_memory_allocated()
        device_ms = device_ms_per_call(torch, lambda: trainer.step(dev), n=2)
        replays = sum(g.replays for g in trainer.graphs.values())
        params[label] = {k: v.clone() for k, v in trainer.state["params"].items()}
        out[label] = dict(remat=policy, costs=costs, ms_per_step=statistics.median(ms[1:]),
                          graph_device_ms_per_step=device_ms, peak_memory_bytes=peak,
                          state_bytes=resident, peak_above_state_bytes=peak - resident,
                          replays=replays)
        del trainer
        torch.cuda.empty_cache()

    run("none", None)
    run("conv_only", "conv_only")
    err, bitwise = rel_l2_max(torch, params["conv_only"], params["none"])
    spread = 0.0
    if err > REMAT_RTOL:  # is the step itself deterministic on this card?
        run("none_again", None)
        spread, _ = rel_l2_max(torch, params["none_again"], params["none"])
    out.update(update_rel_l2_max=err, bitwise=bitwise, none_spread_rel_l2_max=spread,
               peak_memory_ratio=(out["conv_only"]["peak_memory_bytes"]
                                  / out["none"]["peak_memory_bytes"]))
    print("remat", json.dumps(out), flush=True)
    for label in ("none", "conv_only"):
        if out[label]["replays"] != REMAT_STEPS + 1:
            fail(f"remat {label}: {out[label]['replays']} replays, want {REMAT_STEPS + 1}")
        if not all(np.isfinite(out[label]["costs"])):
            fail(f"remat {label}: non-finite costs {out[label]['costs']}")
    if not err <= max(REMAT_RTOL, 2 * spread):
        fail(f"remat='conv_only' changed the updates: {err} relative L2 (two runs without "
             f"remat differ by {spread})")
    return out


def guard_phase(torch):
    """The divergence guard and the preemption drain on phase 5's seq2seq
    trainer (the GRU kernels), batches of 128 with ragged lengths, on the
    card: a `nan_loss` batch under skip_batch against a run without it;
    rollback (2 passes of 2 batches, the poisoned batch the first of pass 1,
    a poll every step); a `preempt` drain mid-pass and its auto-resume
    against an unbroken run; the replayed step's ms with the guard and
    without it. GRU launch counts from 0 over the phase."""
    import contextlib
    import shutil
    import tempfile

    import numpy as np

    from paddle_tpu_torch.core import faults, preempt, stats
    from paddle_tpu_torch.trainer import Preempted

    dev = [{k: torch.as_tensor(v).to("cuda") for k, v in
            s2s_batch(np, 30 + i, S2S["batch"], ragged=True).items()} for i in range(3)]
    root = tempfile.mkdtemp(prefix="guard-", dir=os.path.join(REPO, "build"))

    def run(batches, policy=None, passes=1, spec=None, save_dir=None, resume=False,
            every=2):
        tr = s2s_trainer("cuda", divergence_policy=policy, guard_check_every=every)
        with faults.inject(spec) if spec else contextlib.nullcontext():
            tr.train(lambda: iter(batches), num_passes=passes, save_dir=save_dir,
                     auto_resume=resume)
        return tr

    def snapshot(tr):
        flat = {f"{n}/{k}": v.clone() for n, t in tr._trees().items() for k, v in t.items()}
        flat.update({k: tr.state[k].clone() for k in ("samples", "lr_scale", "rng")})
        return flat

    def release(*trainers):
        for tr in trainers:
            tr.graphs.clear()
        torch.cuda.empty_cache()

    def compare(got, want, again):
        """(rel L2 max, bitwise, spread of two runs of `want`'s set-up when
        got and want differ)."""
        err, bitwise = rel_l2_max(torch, got, want)
        spread = rel_l2_max(torch, again(), want)[0] if not bitwise else 0.0
        return err, bitwise, spread

    zero_rnn_counts()
    stats.FT_EVENTS._counts.clear()
    t0 = time.perf_counter()
    guarded = run(dev, "skip_batch", spec="nan_loss:step=1")
    g_state, diverged = snapshot(guarded), int(guarded.state["diverged"])
    release(guarded)
    clean = snapshot(run([dev[0], dev[2]], "skip_batch"))
    skip_err, skip_bitwise, skip_spread = compare(
        g_state, clean, lambda: snapshot(run([dev[0], dev[2]], "skip_batch")))
    release()
    roll_dir = os.path.join(root, "roll")
    roll = run(dev[:2], "rollback", passes=2, spec="nan_loss:step=2", save_dir=roll_dir,
               every=1)
    lr_scale, rolled = float(roll.state["lr_scale"]), stats.FT_EVENTS.get("divergence_rollback")
    roll_finite = all(bool(torch.isfinite(v).all()) for v in roll.state["params"].values())
    release(roll)
    unbroken = snapshot(run(dev, passes=2))
    release()
    pre_dir = os.path.join(root, "preempt")
    drained = None
    try:
        run(dev, passes=2, spec="preempt:step=1", save_dir=pre_dir)
    except Preempted as p:
        drained = [p.pass_id, p.batches_done, p.checkpoint_dir is not None]
    finally:
        preempt.reset()
    release()
    resumed = snapshot(run(dev, passes=2, save_dir=pre_dir, resume=True))
    pre_err, pre_bitwise, pre_spread = compare(resumed, unbroken,
                                               lambda: snapshot(run(dev, passes=2)))
    release()
    guard_s = time.perf_counter() - t0
    timing = {}
    for label, policy in (("no_guard", None), ("skip_batch", "skip_batch")):
        tr = s2s_trainer("cuda", divergence_policy=policy, guard_check_every=16)
        tr.init_state(dev[0])
        _, ms = timed_calls(torch, lambda: tr.step(dev[0]), TRAIN_WARMUP + TRAIN_STEPS)
        timing[label] = dict(step_ms_median=statistics.median(ms[TRAIN_WARMUP:]),
                             graph_device_ms_per_step=device_ms_per_call(
                                 torch, lambda: tr.step(dev[0])))
        release(tr)
        del tr
    launches = rnn_counts()
    shutil.rmtree(root, ignore_errors=True)
    out = dict(skip=dict(diverged=diverged, rel_l2_max=skip_err, bitwise=skip_bitwise,
                         clean_spread=skip_spread),
               rollback=dict(lr_scale=lr_scale, rollbacks=rolled, finite=roll_finite),
               preempt=dict(drained=drained, rel_l2_max=pre_err, bitwise=pre_bitwise,
                            unbroken_spread=pre_spread),
               phase_s=guard_s, step_timing=timing,
               guard_overhead_ms=(timing["skip_batch"]["graph_device_ms_per_step"]
                                  - timing["no_guard"]["graph_device_ms_per_step"]),
               gru_launches=launches)
    print("guard", json.dumps(out), flush=True)
    if diverged != 1 or not (skip_bitwise or skip_err <= 2 * skip_spread):
        fail(f"skip_batch: {diverged} divergences, state vs a run without the batch "
             f"{skip_err} relative L2 (bitwise {skip_bitwise}, clean spread {skip_spread})")
    if lr_scale != 0.5 or rolled != 1 or not roll_finite:
        fail(f"rollback: lr_scale {lr_scale}, {rolled} rollbacks, finite {roll_finite}")
    if drained != [0, 2, True] or not (pre_bitwise or pre_err <= 2 * pre_spread):
        fail(f"preempt: drained {drained}, resumed vs unbroken {pre_err} relative L2 "
             f"(bitwise {pre_bitwise}, spread {pre_spread})")
    if not launches["FWD_LAUNCHES"] or not launches["BWD_LAUNCHES"]:
        fail(f"the guarded seq2seq steps launched no GRU kernel: {launches}")
    return out


def optim_phase(torch):
    """The seven optimizers of paddle_tpu/optim/optimizers.py (SGD, AdaGrad,
    DecayedAdaGrad, AdaDelta, RMSProp, Adam, AdaMax) on phase 7's LSTM
    trainer: at full width one eager step, its capture and 3 replays (ms a
    replay), then at batch 8 over 4 ragged batches card vs CPU from the
    same parameters (costs, parameters and slots). LSTM launch counts from
    0 over the phase."""
    import numpy as np

    from paddle_tpu_torch import optim as O

    makers = {
        "SGD": lambda: O.SGD(0.01), "AdaGrad": lambda: O.AdaGrad(0.001),
        "DecayedAdaGrad": lambda: O.DecayedAdaGrad(0.001),
        "AdaDelta": lambda: O.AdaDelta(1.0), "RMSProp": lambda: O.RMSProp(0.001),
        "Adam": lambda: O.Adam(0.001), "AdaMax": lambda: O.AdaMax(0.002),
    }
    full = lstm_batch(np, 0, LSTM["batch"], ragged=False)
    full_dev = {k: torch.as_tensor(v).to("cuda") for k, v in full.items()}
    small = [lstm_batch(np, 40 + i, CPU_BATCH, ragged=True) for i in range(OPT_STEPS)]
    zero_rnn_counts()
    out, bad, card_steps, card_inits = {}, [], 0, 0
    for name, make in makers.items():
        tr = lstm_trainer("cuda", make())
        tr.init_state(full)
        costs, ms = timed_calls(torch, lambda: tr.step(full_dev), OPT_STEPS)
        replays = sum(g.replays for g in tr.graphs.values())
        del tr
        cpu, card = lstm_trainer("cpu", make()), lstm_trainer("cuda", make())
        cpu.init_state(small[0])
        card.init_state(small[0])
        card.load_params(cpu.state["params"])
        c_card = [float(card.step(b)) for b in small]
        c_cpu = [float(cpu.step(b)) for b in small]
        card_steps += 2 * OPT_STEPS
        card_inits += 2  # Network.init runs the forward once on the card
        got, want = card._trees()["opt"], cpu._trees()["opt"]
        cost_err = max(abs(a - b) / abs(b) for a, b in zip(c_card, c_cpu))
        param_err = max(rel_l2(torch, card.state["params"][k].cpu(), v)
                        for k, v in cpu.state["params"].items())
        slot_err = max([rel_l2(torch, got[k].cpu().float(), v.float())
                        for k, v in want.items() if k != "opt/t"] or [0.0])
        out[name] = dict(costs=costs, ms_per_replay=statistics.median(ms[1:]),
                         replays=replays, cpu_cost_rel_err=cost_err,
                         cpu_param_rel_l2_max=param_err, cpu_slot_rel_l2_max=slot_err,
                         t=int(card.state["opt"]["t"]))
        if (replays != OPT_STEPS - 1 or not all(np.isfinite(costs))
                or not cost_err <= OPT_COST_RTOL or not param_err <= OPT_REL_L2
                or not slot_err <= OPT_REL_L2 or out[name]["t"] != OPT_STEPS):
            bad.append(name)
        del cpu, card
        torch.cuda.empty_cache()
    launches = rnn_counts()
    out["lstm_launches"] = launches
    print("optim", json.dumps(out), flush=True)
    if bad:
        fail(f"optimizers failing on the card (replays, finite costs, or card vs CPU "
             f"beyond {OPT_COST_RTOL} / {OPT_REL_L2}): {bad}")
    fwd, bwd = 2 * (card_steps + card_inits), 2 * card_steps
    if launches["LSTM_FWD_LAUNCHES"] != fwd or launches["LSTM_BWD_LAUNCHES"] != bwd:
        fail(f"LSTM kernels launched {launches} times in {card_steps} steps and "
             f"{card_inits} inits, want 2 + 2 a step and 2 forward an init")
    return out


def prefetch_phase(torch, trainer, dev):
    """Phase 16's VGG-19 step fed a pass of distinct host batches through
    a DevicePrefetcher (pinned memory, its copy stream, 2 batches ahead)
    against a pass of the same batches already on the card: ms a step of
    each pass (host clock, the pass ending in its cost fetch), in turns:
    placed, prefetcher (its first pass allocates the pinned blocks),
    prefetcher again, placed again; every step a replay of the one
    graph."""
    import numpy as np

    from paddle_tpu_torch.data import DevicePrefetcher

    cfg = VGG
    host = []
    for i in range(PREFETCH_BATCHES):
        rs = np.random.RandomState(100 + i)
        host.append({"image": rs.randn(cfg["batch"], cfg["image_size"], cfg["image_size"], 3)
                     .astype(np.float32),
                     "label": rs.randint(0, cfg["classes"], cfg["batch"])})
    placed = [{k: torch.as_tensor(v).to("cuda") for k, v in b.items()} for b in host]
    first = next(iter(DevicePrefetcher(lambda: iter(host[:1]))))
    landed = all(torch.equal(first[k].cpu(), torch.as_tensor(v)) for k, v in host[0].items())
    graph = next(iter(trainer.graphs.values()))
    replays0 = graph.replays
    out = {}
    prefetcher = DevicePrefetcher(lambda: iter(host), prefetch_depth=PREFETCH_DEPTH)
    runs = (("placed", lambda: iter(placed)), ("prefetcher", prefetcher),
            ("prefetcher_again", prefetcher), ("placed_again", lambda: iter(placed)))
    for label, reader in runs:
        passes = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train(reader, num_passes=1,
                      event_handler=lambda e: passes.append(e.metrics)
                      if type(e).__name__ == "EndPass" else None)
        out[label] = dict(ms_per_step=(time.perf_counter() - t0) * 1e3 / PREFETCH_BATCHES,
                          avg_cost=passes[0]["avg_cost"])
    out.update(batches=PREFETCH_BATCHES, depth=PREFETCH_DEPTH, landed_equal=landed,
               replays=graph.replays - replays0, graphs=len(trainer.graphs),
               bytes_per_batch=int(sum(v.nbytes for v in host[0].values())))
    print("prefetch", json.dumps(out), flush=True)
    if not landed:
        fail("a DevicePrefetcher batch differs from its host batch")
    if out["replays"] != len(runs) * PREFETCH_BATCHES or out["graphs"] != 1:
        fail(f"the prefetched and placed passes ran {out['replays']} replays of "
             f"{out['graphs']} graphs, want {len(runs) * PREFETCH_BATCHES} of one")
    if not all(np.isfinite(out[label]["avg_cost"]) for label, _ in runs):
        fail(f"non-finite pass cost: {out}")
    return out


V1_BIGRU_PROVIDER = """
import numpy as np
from paddle.trainer.PyDataProvider2 import *


def hook(settings, vocab, train, test, min_len, max_len, **kwargs):
    settings.vocab, settings.lens = vocab, (min_len, max_len)
    settings.samples = {"train": train, "test": test}
    settings.input_types = {"word": integer_value_sequence(vocab),
                            "label": integer_value(2)}


@provider(init_hook=hook, should_shuffle=False)
def process(settings, filename):
    rs = np.random.RandomState(0 if filename == "train" else 1)
    lo, hi = settings.lens
    for _ in range(settings.samples[filename]):
        label = int(rs.randint(2))
        ids = rs.randint(3, settings.vocab, size=rs.randint(lo, hi + 1))
        ids[:4] = 1 + label
        yield {"word": ids.tolist(), "label": label}
"""

V1_BIGRU_CONFIG = """
from paddle.trainer_config_helpers import *

vocab = get_config_arg("vocab", int, 30000)
size = get_config_arg("size", int, 512)
batch = get_config_arg("batch", int, 128)
batches = get_config_arg("batches", int, 24)
test_batches = get_config_arg("test_batches", int, 2)
settings(batch_size=batch, learning_rate=1e-3, learning_method=AdamOptimizer())
define_py_data_sources2(
    train_list="train.list", test_list="test.list", module="v1_bigru_provider",
    obj="process", args={"vocab": vocab, "train": batches * batch,
                         "test": test_batches * batch, "min_len": 30, "max_len": 50})
word = data_layer(name="word", size=vocab)
label = data_layer(name="label", size=2)
emb = embedding_layer(input=word, size=size)
bi = bidirectional_gru(input=emb, size=size)
output = fc_layer(input=bi, size=2, act=SoftmaxActivation())
outputs(classification_cost(input=output, label=label))
"""

V1_LENET_PROVIDER = """
import numpy as np
from paddle.trainer.PyDataProvider2 import *


def hook(settings, train, test, **kwargs):
    settings.samples = {"train": train, "test": test}


@provider(input_types={"pixel": dense_vector(784), "label": integer_value(10)},
          init_hook=hook, should_shuffle=False)
def process(settings, filename):
    rs = np.random.RandomState(0 if filename == "train" else 1)
    for _ in range(settings.samples[filename]):
        label = int(rs.randint(10))
        x = rs.rand(784).astype("float32") * 0.2
        x[label * 70:label * 70 + 70] += 1.0
        yield {"pixel": x, "label": label}
"""

V1_LENET_CONFIG = """
from paddle.trainer_config_helpers import *

batch = get_config_arg("batch", int, 128)
batches = get_config_arg("batches", int, 20)
test_batches = get_config_arg("test_batches", int, 2)
settings(batch_size=batch, learning_rate=0.01, learning_method=MomentumOptimizer(0.9))
define_py_data_sources2(
    train_list="train.list", test_list="test.list", module="v1_lenet_provider",
    obj="process", args={"train": batches * batch, "test": test_batches * batch})
img = data_layer(name="pixel", size=784, height=28, width=28)
label = data_layer(name="label", size=10)
conv1 = simple_img_conv_pool(input=img, filter_size=5, num_filters=20, num_channel=1,
                             pool_size=2, pool_stride=2, act=ReluActivation())
conv2 = simple_img_conv_pool(input=conv1, filter_size=5, num_filters=50, num_channel=20,
                             pool_size=2, pool_stride=2, act=ReluActivation())
predict = fc_layer(input=conv2, size=10, act=SoftmaxActivation())
outputs(classification_cost(input=predict, label=label))
"""


def v1_config_dir(name: str, config: str, provider: str) -> str:
    """A directory holding a v1 config, its provider and file lists."""
    import tempfile

    d = tempfile.mkdtemp(prefix=f"chip_smoke_{name}_")
    files = {"conf.py": config, f"v1_{name}_provider.py": provider,
             "train.list": "train\n", "test.list": "test\n"}
    for fname, text in files.items():
        with open(os.path.join(d, fname), "w") as f:
            f.write(text)
    return d


class _Records:
    """The trainer's log records ("pass P batch B cost=C") of a CLI run."""

    def __init__(self):
        import logging

        self.costs = []
        self.handler = logging.Handler()
        self.handler.emit = lambda r: self.costs.append(
            float(r.getMessage().rsplit("cost=", 1)[1])) if "cost=" in r.getMessage() else None
        self.logger = logging.getLogger("paddle_tpu_torch.trainer")

    def __enter__(self):
        self.logger.addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)
        return False


def run_cli(conf_dir: str, argv, echo: bool = True):
    """`python -m paddle_tpu_torch <argv>` in this process, from the
    config's directory -> (exit code, its stdout lines, step costs logged,
    the `train` command's job or None); `echo` repeats its stdout here."""
    import contextlib
    import io

    from paddle_tpu_torch import cli

    out = io.StringIO()
    cwd = os.getcwd()
    os.chdir(conf_dir)
    sys.path.insert(0, conf_dir)
    job = None
    try:
        with _Records() as rec, contextlib.redirect_stdout(out):
            args = cli.parse_args(list(argv))
            if args.cmd == "train":
                job = cli.prepare_train(args)
                rc = job.run()
            else:
                rc = args.fn(args)
    finally:
        sys.path.remove(conf_dir)
        os.chdir(cwd)
    lines = out.getvalue().splitlines()
    for line in lines if echo else ():
        print(f"  | {line}", flush=True)
    return rc, lines, rec.costs, job


def pass_lines(lines):
    """{pass id: {key: value}} of the CLI's "pass N: k=v ..." lines."""
    out = {}
    for line in lines:
        if line.startswith("pass "):
            head, rest = line.split(":", 1)
            out[int(head.split()[1])] = {k: float(v) for k, v in
                                         (kv.split("=", 1) for kv in rest.split())}
    return out


def v1_args(cfg: dict) -> str:
    return ",".join(f"{k}={v}" for k, v in cfg.items()
                    if k in ("vocab", "size", "batch", "batches", "test_batches"))


def v1_vs_cpu(name: str, conf_dir: str, args: str):
    """The config at a small width through `train --device=cpu` and
    `--device=cuda` from the same seed: the first V1_CPU_STEPS logged step
    costs (one pass, --log_period=1)."""
    costs = {}
    for dev in ("cpu", "cuda"):
        rc, _, logged, _ = run_cli(conf_dir, [
            "train", "--config=conf.py", f"--config_args={args}", f"--device={dev}",
            "--num_passes=1", "--log_period=1"])
        if rc != 0:
            fail(f"{name}: train --device={dev} at the small width exited {rc}")
        costs[dev] = logged[:V1_CPU_STEPS]
    rel = [abs(a - b) / abs(b) for a, b in zip(costs["cuda"], costs["cpu"])]
    out = dict(config_args=args, steps=len(rel), cost_card=costs["cuda"],
               cost_cpu=costs["cpu"], cost_rel_err=rel)
    if len(rel) != V1_CPU_STEPS:
        fail(f"{name}: {len(rel)} logged steps card vs CPU, want {V1_CPU_STEPS}")
    if not (rel[0] <= CPU_COST_RTOL and max(rel) <= V1_CPU_RTOL):
        fail(f"{name}: step costs card {costs['cuda']} vs CPU {costs['cpu']}: rel err "
             f"{rel} (first <= {CPU_COST_RTOL}, all <= {V1_CPU_RTOL})")
    return out


def v1_timed(torch, conf_dir: str, name: str, tag: str, per_step, n: int,
             config_args: str = ""):
    """`--job=time` over n batches (the replays of one graph), then
    torch.profiler over V1_PROFILE_STEPS replays on the same trainer: the
    device's busy ms a step and its busy share, both over the profiled
    window -> (result, the job)."""
    zero_rnn_counts()
    rc, lines, _, job = run_cli(conf_dir, ["train", "--config=conf.py", "--job=time",
                                           f"--num_batches={n}",
                                           f"--config_args={config_args}"])
    launches = rnn_counts()  # the init's forward, the warm-up step, n replays
    if rc != 0:
        fail(f"{name}: --job=time exited {rc}")
    timed = json.loads(lines[-1])
    if set(timed) != {"ms_per_batch", "batches"} or timed["batches"] != n:
        fail(f"{name}: --job=time printed {timed}")
    trainer = job.trainer
    graphs = list(trainer.graphs.values())
    if len(graphs) != 1 or graphs[0].replays != n:
        fail(f"{name}: --job=time ran {len(graphs)} graphs, "
             f"{graphs[0].replays if graphs else 0} replays, want one graph, {n} replays")
    # the last timed batch, on the host as the feeder gave it (the graph's
    # signature holds numpy dtypes: device tensors would capture anew)
    batch = {k: v.cpu().numpy() for k, v in graphs[0].inputs.items()}
    profile = profile_train(torch, lambda: trainer.step(batch), tag=tag,
                            steps=V1_PROFILE_STEPS, label=f"{name.replace(' ', '_')}_profile")
    if len(trainer.graphs) != 1:
        fail(f"{name}: the profiled steps captured a graph of their own")
    ms = timed["ms_per_batch"]
    out = dict(ms_per_step=ms, batches_timed=n,
               device_busy_ms_per_step=profile["device_busy_ms_per_step"],
               busy_share=profile["device_busy_share"],
               profiled_wall_ms_per_step=profile["wall_ms_per_step"],
               kernel_launches=launches, profile=profile,
               **per_step(job, ms))
    return out, job


def v1_bigru_phase(torch):
    """Phase 21: the v1 bi-GRU text config at full width through the CLI."""
    from paddle_tpu_torch import proto
    from paddle_tpu_torch.config import parse_config

    cfg = V1_BIGRU
    d = v1_config_dir("bigru", V1_BIGRU_CONFIG, V1_BIGRU_PROVIDER)
    save = os.path.join(d, "out")
    steps = cfg["batches"] * cfg["passes"]
    tests = cfg["test_batches"] * cfg["passes"]
    t0 = time.perf_counter()
    zero_rnn_counts()
    rc, lines, _, job = run_cli(d, ["train", "--config=conf.py",
                                    f"--num_passes={cfg['passes']}", f"--save_dir={save}",
                                    "--log_period=0"])
    launches = rnn_counts()
    train_s = time.perf_counter() - t0
    if rc != 0:
        fail(f"v1 bigru: train exited {rc}")
    trainer = job.trainer
    ((ev, _),) = job.evaluators
    graphs = list(trainer.graphs.values())
    passes = pass_lines(lines)
    examples = cfg["batches"] * cfg["batch"]
    result = dict(config=cfg, train_s=train_s, steps=steps, passes=passes,
                  evaluator_samples_last_pass=ev.total, graphs=len(graphs),
                  replays=graphs[0].replays if graphs else 0, kernel_launches=launches,
                  gru_launches_per_step=dict(
                      fwd=(launches["FWD_LAUNCHES"] - 2 * (tests + 1)) / steps,
                      bwd=launches["BWD_LAUNCHES"] / steps))
    # every train step runs both directions forward and backward; the
    # parameters' init (one forward of the first batch) and each test batch
    # at a pass end run both forwards
    want = (2 * (steps + tests + 1), 2 * steps)
    if (launches["FWD_LAUNCHES"], launches["BWD_LAUNCHES"]) != want:
        fail(f"v1 bigru: GRU launches {launches} over {steps} steps, {tests} test "
             f"batches and the init, want fwd {want[0]}, bwd {want[1]}")
    if any(v for k, v in launches.items() if k not in ("FWD_LAUNCHES", "BWD_LAUNCHES")):
        fail(f"v1 bigru: launched kernels it does not run: {launches}")
    if len(graphs) != 1 or result["replays"] != steps - 1:
        fail(f"v1 bigru: {len(graphs)} step graphs, {result['replays']} replays in "
             f"{steps} steps: want one graph, every step after the first a replay")
    if sorted(passes) != list(range(cfg["passes"])) or not all(
            "ClassificationErrorEvaluator" in p for p in passes.values()):
        fail(f"v1 bigru: pass lines {passes}")
    if not passes[1]["avg_cost"] < passes[0]["avg_cost"]:
        fail(f"v1 bigru: avg_cost did not fall: {passes}")
    if ev.total != examples:
        fail(f"v1 bigru: the evaluator counted {ev.total} samples, the pass has {examples}")
    if not os.path.isdir(os.path.join(save, "pass-00001")):
        fail("v1 bigru: pass-00001 was not written")

    def per_step(timed_job, ms):
        # real tokens (not padding) of every batch --job=time timed: the
        # first n of the reader
        n = cfg["time_batches"]
        tokens = sum(int(timed_job.feeder(b)["word.lengths"].sum())
                     for b in itertools.islice(timed_job.reader(), n))
        return dict(tokens_timed=tokens, tokens_per_step=tokens / n,
                    tokens_per_s=tokens / (n * ms / 1e3))

    del trainer, job
    timed, t_job = v1_timed(torch, d, "v1 bigru", "gru", per_step, cfg["time_batches"])
    result["time"] = timed
    counts = timed["kernel_launches"]
    per_launch = dict(fwd=(counts["FWD_LAUNCHES"] - 2) / (cfg["time_batches"] + 1),
                      bwd=counts["BWD_LAUNCHES"] / (cfg["time_batches"] + 1))
    result["time"]["gru_launches_per_step"] = per_launch
    if per_launch != dict(fwd=2.0, bwd=2.0):
        fail(f"v1 bigru: --job=time launched the GRU kernels {counts}")
    del t_job
    torch.cuda.empty_cache()
    rc, lines, _, _ = run_cli(d, ["train", "--config=conf.py", "--job=test",
                                  f"--init_model_path={save}", "--start_pass=2"])
    tested = json.loads(lines[-1])
    result["test"] = tested
    if rc != 0 or tested["samples"] != cfg["test_batches"] * cfg["batch"] or not (
            tested["test_cost"] < passes[0]["avg_cost"]):
        fail(f"v1 bigru: --job=test exited {rc} with {tested}")
    rc, lines, _, _ = run_cli(d, ["dump_config", "--config=conf.py"], echo=False)
    dumped = "\n".join(lines) + "\n"
    parsed = proto.to_text(parse_config(os.path.join(d, "conf.py")).trainer_config)
    result["dump_config_lines"] = len(lines)
    if rc != 0 or dumped != parsed or 'type: "gated_recurrent"' not in dumped:
        fail(f"v1 bigru: dump_config exited {rc}, matches the parse: {dumped == parsed}")
    small = v1_config_dir("bigru", V1_BIGRU_CONFIG, V1_BIGRU_PROVIDER)
    result["vs_cpu"] = v1_vs_cpu("v1 bigru", small, v1_args(V1_BIGRU_SMALL))
    result["save_dir"] = save  # phase 25 merges its pass-00001
    print("v1_bigru", json.dumps(result), flush=True)
    return result


def v1_lenet_phase(torch):
    """Phase 22: the v1 MNIST LeNet config through the CLI."""
    cfg = V1_LENET
    d = v1_config_dir("lenet", V1_LENET_CONFIG, V1_LENET_PROVIDER)
    steps = cfg["batches"] * cfg["passes"]
    zero_rnn_counts()
    rc, lines, _, job = run_cli(d, ["train", "--config=conf.py",
                                    f"--num_passes={cfg['passes']}", "--log_period=0"])
    launches = rnn_counts()
    if rc != 0:
        fail(f"v1 lenet: train exited {rc}")
    trainer = job.trainer
    ((ev, _),) = job.evaluators
    graphs = list(trainer.graphs.values())
    passes = pass_lines(lines)
    result = dict(config=cfg, steps=steps, passes=passes, graphs=len(graphs),
                  replays=graphs[0].replays if graphs else 0, kernel_launches=launches,
                  evaluator_samples_last_pass=ev.total)
    if len(graphs) != 1 or result["replays"] != steps - 1:
        fail(f"v1 lenet: {len(graphs)} step graphs, {result['replays']} replays in "
             f"{steps} steps: want one graph, every step after the first a replay")
    if any(launches.values()):
        fail(f"v1 lenet: launched kernels it does not run: {launches}")
    if not passes[1]["avg_cost"] < passes[0]["avg_cost"]:
        fail(f"v1 lenet: avg_cost did not fall: {passes}")
    if ev.total != cfg["batches"] * cfg["batch"]:
        fail(f"v1 lenet: the evaluator counted {ev.total} samples")

    def per_step(_, ms):
        return dict(images_per_s=cfg["batch"] / (ms / 1e3))

    del trainer, job
    timed, t_job = v1_timed(torch, d, "v1 lenet", "conv", per_step, cfg["time_batches"])
    result["time"] = timed
    if any(timed["kernel_launches"].values()):
        fail(f"v1 lenet: --job=time launched kernels it does not run: "
             f"{timed['kernel_launches']}")
    del t_job
    result["vs_cpu"] = v1_vs_cpu("v1 lenet", d, "batches=4,test_batches=1")
    print("v1_lenet", json.dumps(result), flush=True)
    return result


V1_S2S_PROVIDER = """
import numpy as np
from paddle.trainer.PyDataProvider2 import *


def hook(settings, src_dict, trg_dict, samples, length, **kwargs):
    settings.dicts, settings.length = (src_dict, trg_dict), length
    settings.samples = {"train": samples, "test": samples}
    settings.input_types = {
        "source_language_word": integer_value_sequence(src_dict),
        "target_language_word": integer_value_sequence(trg_dict),
        "target_language_next_word": integer_value_sequence(trg_dict)}


@provider(init_hook=hook, should_shuffle=False)
def process(settings, filename):
    # bench.py's draws: ids uniform in [2, vocab), every sequence `length`
    # long; the next word is the target shifted, then 1 (<e>)
    rs = np.random.RandomState(0 if filename == "train" else 1)
    src_dict, trg_dict = settings.dicts
    for _ in range(settings.samples[filename]):
        src = rs.randint(2, src_dict, size=settings.length)
        trg = rs.randint(2, trg_dict, size=settings.length)
        yield {"source_language_word": src.tolist(),
               "target_language_word": trg.tolist(),
               "target_language_next_word": np.append(trg[1:], 1).tolist()}
"""

# demo/seqToseq/seqToseq_net.py of PaddlePaddle v0.11 (is_generating=False),
# its widths from config args
V1_S2S_CONFIG = """
from paddle.trainer_config_helpers import *

source_dict_dim = get_config_arg("vocab", int, 30000)
target_dict_dim = source_dict_dim
word_vector_dim = encoder_size = decoder_size = get_config_arg("size", int, 512)
batch = get_config_arg("batch", int, 128)
batches = get_config_arg("batches", int, 4)
length = get_config_arg("length", int, 50)
settings(batch_size=batch, learning_rate=5e-4, learning_method=AdamOptimizer())
define_py_data_sources2(
    train_list="train.list", test_list=None, module="v1_s2s_provider", obj="process",
    args={"src_dict": source_dict_dim, "trg_dict": target_dict_dim,
          "samples": batches * batch, "length": length})

src_word_id = data_layer(name="source_language_word", size=source_dict_dim)
src_embedding = embedding_layer(
    input=src_word_id, size=word_vector_dim,
    param_attr=ParamAttr(name="_source_language_embedding"))
src_forward = simple_gru(input=src_embedding, size=encoder_size, naive=True,
                         gru_layer_attr=ExtraLayerAttribute(error_clipping_threshold=50))
src_backward = simple_gru(input=src_embedding, size=encoder_size, reverse=True,
                          naive=True,
                          gru_layer_attr=ExtraLayerAttribute(error_clipping_threshold=50))
encoded_vector = concat_layer(input=[src_forward, src_backward])

with mixed_layer(size=decoder_size) as encoded_proj:
    encoded_proj += full_matrix_projection(input=encoded_vector)

backward_first = first_seq(input=src_backward)
with mixed_layer(size=decoder_size, act=TanhActivation()) as decoder_boot:
    decoder_boot += full_matrix_projection(input=backward_first)


def gru_decoder_with_attention(enc_vec, enc_proj, current_word):
    decoder_mem = memory(name="gru_decoder", size=decoder_size, boot_layer=decoder_boot)
    context = simple_attention(encoded_sequence=enc_vec, encoded_proj=enc_proj,
                               decoder_state=decoder_mem)
    with mixed_layer(size=decoder_size * 3) as decoder_inputs:
        decoder_inputs += full_matrix_projection(input=context)
        decoder_inputs += full_matrix_projection(input=current_word)
    gru_step = gru_step_layer(name="gru_decoder", input=decoder_inputs,
                              output_mem=decoder_mem, size=decoder_size)
    with mixed_layer(size=target_dict_dim, bias_attr=True,
                     act=SoftmaxActivation()) as out:
        out += full_matrix_projection(input=gru_step)
    return out


group_inputs = [StaticInput(input=encoded_vector, is_seq=True),
                StaticInput(input=encoded_proj, is_seq=True)]
trg_embedding = embedding_layer(
    input=data_layer(name="target_language_word", size=target_dict_dim),
    size=word_vector_dim, param_attr=ParamAttr(name="_target_language_embedding"))
group_inputs.append(trg_embedding)
decoder = recurrent_group(name="decoder_group", step=gru_decoder_with_attention,
                          input=group_inputs)
lbl = data_layer(name="target_language_next_word", size=target_dict_dim)
outputs(classification_cost(input=decoder, label=lbl))
"""


def s2s_args(cfg: dict) -> str:
    return ",".join(f"{k}={cfg[k]}" for k in ("vocab", "size", "batch", "batches", "length"))


def gru_group_vs_fused(torch, np):
    """simple_gru (gru_group: a recurrent_group of gru_step layers, no
    kernel) against simple_gru2 (the fused grumemory kernels) on one
    parameter dict, forward and reverse, at vocab 30000 / 512 / batch 128 /
    lengths 30-50 -> relative L2 over the valid steps."""
    from paddle_tpu_torch.config import v1_layers as v1
    from paddle_tpu_torch.nn import graph as G
    from paddle_tpu_torch.v2 import data_type, layer

    cfg = V1_BIGRU
    rs = np.random.RandomState(5)
    lens = rs.randint(cfg["min_len"], cfg["max_len"] + 1, cfg["batch"]).astype(np.int32)
    batch = {"word": rs.randint(3, cfg["vocab"], (cfg["batch"], cfg["max_len"])).astype(
        np.int32), "word.lengths": lens}
    mask = torch.from_numpy(np.arange(cfg["max_len"])[None, :] < lens[:, None]).cuda()
    out = {}
    for reverse in (False, True):
        vals = {}
        params = None
        for helper in ("simple_gru", "simple_gru2"):
            G.reset_name_scope()
            word = layer.data("word", data_type.integer_value_sequence(cfg["vocab"]))
            emb = layer.embedding(word, cfg["size"], name="emb")
            node = getattr(v1, helper)(input=emb, size=cfg["size"], name="g",
                                       reverse=reverse)
            net = G.Network([node])
            if params is None:
                params = net.init(batch, seed=3, device="cuda")
            with torch.no_grad():
                vals[helper] = net.apply(params, batch)[node.name].value
        got, want = (vals[k][mask] for k in ("simple_gru", "simple_gru2"))
        out["rev" if reverse else "fwd"] = rel_l2(torch, got, want)
    if max(out.values()) > GRU_GROUP_RTOL:
        fail(f"gru_group vs the fused GRU: relative L2 {out} > {GRU_GROUP_RTOL}")
    return out


def v1_seq2seq_phase(torch):
    """Phase 23: the v1 seqToseq demo through recurrent_group at full width
    through the CLI (GRU counters from 0: the groups launch no kernel)."""
    import numpy as np

    from paddle_tpu_torch import proto
    from paddle_tpu_torch.config import parse_config

    cfg = V1_S2S
    d = v1_config_dir("s2s", V1_S2S_CONFIG, V1_S2S_PROVIDER)
    steps = cfg["batches"] * cfg["passes"]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    zero_rnn_counts()
    rc, lines, costs, job = run_cli(d, ["train", "--config=conf.py",
                                        f"--num_passes={cfg['passes']}", "--log_period=1",
                                        f"--save_dir={os.path.join(d, 'out')}"])
    launches = rnn_counts()
    train_s = time.perf_counter() - t0
    if rc != 0:
        fail(f"v1 seq2seq: train exited {rc}")
    trainer = job.trainer
    graphs = list(trainer.graphs.values())
    passes = pass_lines(lines)
    result = dict(config=cfg, train_s=train_s, steps=steps, passes=passes,
                  step_costs=costs, graphs=len(graphs),
                  replays=graphs[0].replays if graphs else 0, kernel_launches=launches,
                  peak_memory_bytes=torch.cuda.max_memory_allocated())
    if any(launches.values()):
        fail(f"v1 seq2seq: launched kernels its groups do not run: {launches}")
    if len(graphs) != 1 or result["replays"] != steps - 1:
        fail(f"v1 seq2seq: {len(graphs)} step graphs, {result['replays']} replays in "
             f"{steps} steps: want one graph, every step after the first a replay")
    if sorted(passes) != list(range(cfg["passes"])) or not (
            passes[1]["avg_cost"] < passes[0]["avg_cost"]):
        fail(f"v1 seq2seq: avg_cost did not fall: {passes}")
    if not all(np.isfinite(costs)) or len(costs) != steps:
        fail(f"v1 seq2seq: logged step costs {costs}")
    if not os.path.isdir(os.path.join(d, "out", "pass-00001")):
        fail("v1 seq2seq: pass-00001 was not written")
    result["conf_dir"] = d  # phase 26 generates from its pass-00001

    def per_step(timed_job, ms):
        # real target tokens of every batch --job=time timed
        n = cfg["time_batches"]
        tokens = sum(int(timed_job.feeder(b)["target_language_word.lengths"].sum())
                     for b in itertools.islice(timed_job.reader(), n))
        return dict(tokens_timed=tokens, tokens_per_step=tokens / n,
                    tokens_per_s=tokens / (n * ms / 1e3))

    del trainer, job
    torch.cuda.empty_cache()
    # --job=time reads its batches from one pass: give it time_batches
    timed, t_job = v1_timed(torch, d, "v1 seq2seq", "gru", per_step, cfg["time_batches"],
                            config_args=f"batches={cfg['time_batches']}")
    result["time"] = timed
    if any(timed["kernel_launches"].values()):
        fail(f"v1 seq2seq: --job=time launched kernels {timed['kernel_launches']}")
    result["kernels_per_replay"] = timed["profile"]["kernel_launches_per_step"]
    del t_job
    torch.cuda.empty_cache()
    rc, lines, _, _ = run_cli(d, ["dump_config", "--config=conf.py"], echo=False)
    dumped = "\n".join(lines) + "\n"
    parsed = proto.to_text(parse_config(os.path.join(d, "conf.py")).trainer_config)
    result["dump_config_lines"] = len(lines)
    if rc != 0 or dumped != parsed or 'type: "recurrent_layer_group"' not in dumped:
        fail(f"v1 seq2seq: dump_config exited {rc}, matches the parse: {dumped == parsed}")
    result["gru_group_vs_fused_rel_l2"] = gru_group_vs_fused(torch, np)
    small = v1_config_dir("s2s", V1_S2S_CONFIG, V1_S2S_PROVIDER)
    result["vs_cpu"] = v1_vs_cpu("v1 seq2seq", small, s2s_args(V1_S2S_SMALL))
    print("v1_seq2seq", json.dumps(result), flush=True)
    return result


def v2_samples(np, cfg, n, seed):
    """(ids, label) samples as phase 21's provider draws them: the first 4
    ids of a sequence say its label."""
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        label = int(rs.randint(2))
        ids = rs.randint(3, cfg["vocab"], size=rs.randint(cfg["min_len"], cfg["max_len"] + 1))
        ids[:4] = 1 + label
        out.append((ids.tolist(), label))
    return out


def v2_script(paddle, cfg, device):
    """The paddle.v2 script of phase 24 -> (output layer, cost, parameters,
    the trainer, its events): a bi-GRU of two networks.simple_gru over one
    embedding, Adam(1e-3), `cfg["passes"]` passes of batch(reader)."""
    from paddle_tpu_torch.nn import graph as G

    G.reset_name_scope()
    paddle.init(use_gpu=device == "cuda", trainer_count=1, seed=0)
    word = paddle.layer.data(name="word",
                             type=paddle.data_type.integer_value_sequence(cfg["vocab"]))
    label = paddle.layer.data(name="label", type=paddle.data_type.integer_value(2))
    emb = paddle.layer.embedding(input=word, size=cfg["size"])
    fwd = paddle.networks.simple_gru(input=emb, size=cfg["size"], name="gru_fw")
    bwd = paddle.networks.simple_gru(input=emb, size=cfg["size"], reverse=True,
                                     name="gru_bw")
    out = paddle.layer.fc(input=[paddle.layer.last_seq(input=fwd),
                                 paddle.layer.first_seq(input=bwd)],
                          size=2, act=paddle.activation.Softmax())
    cost = paddle.layer.classification_cost(input=out, label=label)
    params = paddle.parameters.create(cost)
    trainer = paddle.trainer.SGD(cost=cost, parameters=params,
                                 update_equation=paddle.optimizer.Adam(learning_rate=1e-3))
    return out, cost, params, trainer


def v2_train(paddle, np, cfg, trainer):
    samples = v2_samples(np, cfg, cfg["batches"] * cfg["batch"], 0)
    events = []
    trainer.train(reader=paddle.batch(lambda: iter(samples), cfg["batch"]),
                  num_passes=cfg["passes"], event_handler=events.append,
                  feeding={"word": 0, "label": 1})
    costs = [e.cost for e in events if isinstance(e, paddle.event.EndIteration)]
    return samples, events, costs


def v2_api_phase(torch):
    """Phase 24: a paddle.v2 script at full width (GRU counters from 0 just
    before train)."""
    import io

    import numpy as np

    import paddle_tpu_torch.v2 as paddle

    cfg = V2_API
    steps = cfg["batches"] * cfg["passes"]
    out, cost, params, trainer = v2_script(paddle, cfg, "cuda")
    zero_rnn_counts()
    t0 = time.perf_counter()
    samples, events, costs = v2_train(paddle, np, cfg, trainer)
    train_s = time.perf_counter() - t0
    launches = rnn_counts()
    tr = trainer.trainer
    graphs = list(tr.graphs.values())
    kinds = [type(e).__name__ for e in events]
    result = dict(config=cfg, train_s=train_s, steps=steps, step_costs=costs,
                  graphs=len(graphs), replays=graphs[0].replays if graphs else 0,
                  kernel_launches=launches,
                  gru_launches_per_step=dict(fwd=(launches["FWD_LAUNCHES"] - 2) / steps,
                                             bwd=launches["BWD_LAUNCHES"] / steps))
    # the state's init runs both forwards once; every step both directions
    # forward and backward
    if (launches["FWD_LAUNCHES"], launches["BWD_LAUNCHES"]) != (2 * steps + 2, 2 * steps):
        fail(f"v2 api: GRU launches {launches} over {steps} steps, want fwd "
             f"{2 * steps + 2}, bwd {2 * steps}")
    if len(graphs) != 1 or result["replays"] != steps - 1:
        fail(f"v2 api: {len(graphs)} step graphs, {result['replays']} replays in "
             f"{steps} steps: want one graph, every step after the first a replay")
    half = len(costs) // 2
    if len(costs) != steps or not np.mean(costs[half:]) < np.mean(costs[:half]):
        fail(f"v2 api: EndIteration costs did not fall: {costs}")
    if kinds.count("EndPass") != cfg["passes"]:
        fail(f"v2 api: {kinds.count('EndPass')} EndPass events for {cfg['passes']} passes")
    test_samples = v2_samples(np, cfg, 2 * cfg["batch"], 1)
    res = trainer.test(reader=paddle.batch(lambda: iter(test_samples), cfg["batch"]),
                       feeding={"word": 0, "label": 1})
    result["test_cost"] = res.cost
    if not np.isfinite(res.cost):
        fail(f"v2 api: test() cost {res.cost}")
    buf = io.BytesIO()
    trainer.save_parameter_to_tar(buf)
    back = paddle.parameters.Parameters.from_tar(io.BytesIO(buf.getvalue()))
    trained = trainer.parameters
    if sorted(back.names()) != sorted(trained.names()) or not all(
            back.get(k).tobytes() == trained.get(k).tobytes() for k in trained.names()):
        fail("v2 api: to_tar -> from_tar is not bitwise")
    result["tar_bytes"] = len(buf.getvalue())

    # ms a step: replays of the trained step on one batch, one sync at the end
    feeder = trainer.topology.make_feeder({"word": 0, "label": 1})
    batch = feeder(samples[:cfg["batch"]])
    tr.step(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(cfg["time_steps"]):
        tr.step(batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / cfg["time_steps"]
    tokens = int(batch["word.lengths"].sum())
    profile = profile_train(torch, lambda: tr.step(batch), tag="gru",
                            steps=V1_PROFILE_STEPS, label="v2_api_profile")
    result.update(ms_per_step=ms, tokens_per_step=tokens, tokens_per_s=tokens / (ms / 1e3),
                  device_busy_ms_per_step=profile["device_busy_ms_per_step"],
                  busy_share=profile["device_busy_share"], profile=profile)

    inf = paddle.inference.Inference(out, trained)
    infer_in = [(ids,) for ids, _ in v2_samples(np, cfg, cfg["infer"], 2)]
    inf.infer(infer_in[:cfg["batch"]], feeding={"word": 0})  # its init's forward
    zero_rnn_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vals, ids = inf.infer(infer_in, feeding={"word": 0}, field=["value", "id"],
                          batch_size=cfg["batch"])
    infer_ms = (time.perf_counter() - t0) * 1e3
    infer_launches = rnn_counts()
    chunks = -(-cfg["infer"] // cfg["batch"])
    result.update(infer_ms_per_128=infer_ms / chunks, infer_launches=infer_launches)
    if vals.shape != (cfg["infer"], 2) or ids.shape != (cfg["infer"],) or not (
            np.isfinite(vals).all()) or not np.array_equal(ids, vals.argmax(-1)):
        fail(f"v2 api: infer gave values {vals.shape}, ids {ids.shape}")
    if infer_launches["FWD_LAUNCHES"] != 2 * chunks:
        fail(f"v2 api: infer over {chunks} chunks launched {infer_launches}, want "
             f"{2 * chunks} GRU forwards")
    result["vs_cpu"] = v2_vs_cpu(torch, np, paddle)
    print("v2_api", json.dumps(result), flush=True)
    return result, (out, cost, trained)


def v2_vs_cpu(torch, np, paddle):
    """The v2 script at vocab 64, width 16, batch 8 on the CPU and on the
    card from the same parameters: the first V1_CPU_STEPS EndIteration
    costs (the first within CPU_COST_RTOL, all within V1_CPU_RTOL)."""
    cfg = V2_API_SMALL
    costs, start = {}, None
    for dev in ("cpu", "cuda"):
        _, _, params, trainer = v2_script(paddle, cfg, dev)
        if start is None:
            start = params.as_dict()
        for k, v in start.items():
            params.set(k, v)
        costs[dev] = v2_train(paddle, np, cfg, trainer)[2][:V1_CPU_STEPS]
    rel = [abs(a - b) / abs(b) for a, b in zip(costs["cuda"], costs["cpu"])]
    out = dict(steps=len(rel), cost_card=costs["cuda"], cost_cpu=costs["cpu"],
               cost_rel_err=rel)
    if len(rel) != V1_CPU_STEPS or not (rel[0] <= CPU_COST_RTOL and max(rel) <= V1_CPU_RTOL):
        fail(f"v2 api: step costs card {costs['cuda']} vs CPU {costs['cpu']}: rel err "
             f"{rel} (first <= {CPU_COST_RTOL}, all <= {V1_CPU_RTOL})")
    return out


def deploy_phase(torch, bigru_save_dir, v2_model):
    """Phase 25: phase 21's pass-00001 merged through the CLI and served by
    `capi.create_for_inference` (GRU counters from 0 around each call);
    merge_model_v1; the py_paddle GradientMachine on phase 24's model."""
    import numpy as np

    from paddle_tpu_torch import api, capi
    from paddle_tpu_torch.config import parse_config
    from paddle_tpu_torch.optim import optimizers
    from paddle_tpu_torch.trainer import checkpoint as ckpt
    from paddle_tpu_torch.trainer.trainer import SGDTrainer

    conf_dir = os.path.dirname(bigru_save_dir)
    merged = os.path.join(conf_dir, "merged.npz")
    t0 = time.perf_counter()
    rc, lines, _, _ = run_cli(conf_dir, ["merge_model", "--config=conf.py",
                                         f"--model_dir={bigru_save_dir}",
                                         f"--output={merged}"])
    merge_s = time.perf_counter() - t0
    if rc != 0 or lines[-1] != merged or not os.path.exists(merged):
        fail(f"deploy: merge_model exited {rc}: {lines}")
    t0 = time.perf_counter()
    machine = capi.create_for_inference(merged)
    load_s = time.perf_counter() - t0
    (cost_name,) = machine.output_names()
    cfg = V1_BIGRU
    samples = v2_samples(np, cfg, cfg["batch"], 3)
    feeder = machine.topology.make_feeder({"word": 0, "label": 1})
    batch = feeder(samples)
    machine.forward(batch)  # warm
    zero_rnn_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = machine.forward(batch, output_layer=cost_name)
    forward_ms = (time.perf_counter() - t0) * 1e3
    fwd_launches = rnn_counts()
    probs_layer = machine.network.outputs[0].inputs[0].name
    zero_rnn_counts()
    probs = machine.get_layer_output(probs_layer, batch)
    layer_launches = rnn_counts()
    for what, n in (("forward", fwd_launches), ("get_layer_output", layer_launches)):
        if n["FWD_LAUNCHES"] != 2 or any(v for k, v in n.items() if k != "FWD_LAUNCHES"):
            fail(f"deploy: {what} launched {n}, want both GRU forwards once")
    if probs.shape != (cfg["batch"], 2) or not np.allclose(probs.sum(-1), 1, atol=1e-5):
        fail(f"deploy: get_layer_output({probs_layer}) gave {probs.shape}")
    params, _, _, _ = ckpt.load_pass(bigru_save_dir, 1)
    tr = SGDTrainer(parse_config(os.path.join(conf_dir, "conf.py")).outputs,
                    optimizers.Adam(1e-3))
    tr.init_state(batch)
    tr.load_params(params)
    with torch.no_grad():
        want = float(tr._cost(tr.state["params"], batch, train=False)[0])
    rel = abs(float(got) - want) / abs(want)
    if rel > DEPLOY_RTOL:
        fail(f"deploy: the merged model's cost {float(got)} vs the trainer's test "
             f"forward {want}: rel err {rel} > {DEPLOY_RTOL}")
    v1_path = capi.merge_model_v1(os.path.join(conf_dir, "conf.py"), bigru_save_dir,
                                  os.path.join(conf_dir, "merged_v1.bin"))
    v1_bytes = os.path.getsize(v1_path)
    want_bytes = sum(16 + 4 * np.asarray(v).size for v in params.values())
    if v1_bytes <= want_bytes:
        fail(f"deploy: merge_model_v1 wrote {v1_bytes} bytes, the parameters alone "
             f"take {want_bytes}")

    out, cost, trained = v2_model
    gm = api.GradientMachine([cost, out])
    gm.setParameters(trained.as_dict())
    args = api.Arguments()
    seqs = [ids for ids, _ in samples]
    args.setSlotIds("word", np.concatenate([np.asarray(i, np.int32) for i in seqs]))
    args.setSlotSequenceStartPositions("word", np.cumsum([0] + [len(i) for i in seqs]))
    args.setSlotIds("label", np.asarray([y for _, y in samples], np.int32))
    gm_cost, grads = gm.forwardBackward(args)
    if not np.isfinite(gm_cost) or set(grads) != set(trained.names()) or not all(
            np.isfinite(g).all() for g in grads.values()):
        fail(f"deploy: GradientMachine.forwardBackward cost {gm_cost}, grads finite "
             f"{[k for k, g in grads.items() if not np.isfinite(g).all()]}")
    gm_outs = gm.forward(args)
    gm_probs = gm.getLayerOutput(out.name, args)
    if gm_probs.shape != (len(samples), 2) or not np.allclose(
            gm_outs[out.name], gm_probs, rtol=1e-6, atol=1e-7):
        fail(f"deploy: GradientMachine.forward gave {gm_outs[out.name].shape}, "
             f"getLayerOutput {gm_probs.shape}")
    result = dict(merge_s=merge_s, load_s=load_s, forward_ms_per_128=forward_ms,
                  merged_bytes=os.path.getsize(merged), merged_v1_bytes=v1_bytes,
                  forward_launches=fwd_launches, get_layer_output_launches=layer_launches,
                  cost_merged=float(got), cost_trainer=want, cost_rel_err=rel,
                  gradient_machine_cost=gm_cost, gradient_machine_out=list(gm_probs.shape))
    print("deploy", json.dumps(result), flush=True)
    return result


# the seqToseq demo's generating half (demo/seqToseq/seqToseq_net.py,
# is_generating=True) on phase 23's network: the same step under
# beam_search, the target table a GeneratedInput named as the training
# config's, the network function's defaults beam 3, max_length 250, bos 0,
# eos 1; a seqtext printer over sent_id and the target dictionary;
# Outputs('__beam_search_predict__'). No data source: the batches are fed.
V1_S2S_GEN_CONFIG = re.sub(
    r"define_py_data_sources2\(.*?\}\)\n", "",
    V1_S2S_CONFIG[:V1_S2S_CONFIG.index("trg_embedding = embedding_layer(")],
    flags=re.S) + """trg_embedding = GeneratedInput(size=target_dict_dim,
                               embedding_name="_target_language_embedding",
                               embedding_size=word_vector_dim)
group_inputs.append(trg_embedding)
beam_gen = beam_search(name="decoder_group", step=gru_decoder_with_attention,
                       input=group_inputs, bos_id=0, eos_id=1,
                       beam_size=get_config_arg("beam_size", int, 3),
                       max_length=get_config_arg("max_length", int, 250))
seqtext_printer_evaluator(input=beam_gen, id_input=data_layer(name="sent_id", size=1),
                          dict_file="trg.dict", result_file="gen_result.txt")
Outputs("__beam_search_predict__")
"""


def gen_sources(np, cfg, n, seed):
    """n source sentences of cfg's lengths, ids uniform in [2, vocab) as
    bench.py:186-245 draws them, padded -> a batch with `sent_id`."""
    rs = np.random.RandomState(seed)
    lens = rs.randint(cfg["min_len"], cfg["max_len"] + 1, n).astype(np.int32)
    ids = rs.randint(2, cfg["vocab"], (n, cfg["max_len"])).astype(np.int32)
    ids[np.arange(cfg["max_len"])[None, :] >= lens[:, None]] = 0
    return {"source_language_word": ids, "source_language_word.lengths": lens,
            "sent_id": np.arange(n, dtype=np.int32)}


def trg_words(vocab: int):
    return ["<s>", "<e>", "<unk>"] + [f"w{i}" for i in range(3, vocab)]


def check_gen_result(name, text, beams, batch, words, max_length):
    """A plain-mode result file against the beams it printed: one line a
    sample, `sent_id \t words`, the best beam's words up to its length;
    every length in [1, max_length]; each sample's scores best first."""
    hist, scores, lens = (beams[k] for k in ("history", "scores", "lengths"))
    lines = text.splitlines()
    if len(lines) != len(batch["sent_id"]):
        fail(f"{name}: {len(lines)} result lines for {len(batch['sent_id'])} samples")
    if not ((lens >= 1) & (lens <= max_length)).all():
        fail(f"{name}: lengths outside [1, {max_length}]: {lens.min()}..{lens.max()}")
    if not (scores[:, :-1] >= scores[:, 1:]).all():
        fail(f"{name}: beam scores not sorted best first")
    for i, line in enumerate(lines):
        want = f"{batch['sent_id'][i]}\t " + " ".join(
            words[t] for t in hist[i, 0, :lens[i, 0]])
        if line != want:
            fail(f"{name}: line {i} {line[:80]!r} is not the best beam {want[:80]!r}")


def v1_gen_phase(torch, s2s_dir):
    """Phase 26: the seqToseq demo's generating config on phase 23's
    pass-00001 through one GenerationSession (recurrent counters from 0),
    SequenceGenerator on its parameters, card vs CPU at a small width."""
    import numpy as np

    from paddle_tpu_torch import api
    from paddle_tpu_torch.config import parse_config
    from paddle_tpu_torch.nn import graph as G
    from paddle_tpu_torch.trainer.generation import GenerationSession

    cfg = V1_GEN
    conf = os.path.join(s2s_dir, "gen.conf")
    with open(conf, "w") as f:
        f.write(V1_S2S_GEN_CONFIG)
    words = trg_words(V1_S2S["vocab"])
    with open(os.path.join(s2s_dir, "trg.dict"), "w") as f:
        f.write("\n".join(words) + "\n")
    args = f"vocab={V1_S2S['vocab']},size={V1_S2S['size']}"
    model_dir = os.path.join(s2s_dir, "out", "pass-00001")
    pc = parse_config(conf, args, emit_proto=False)
    (node,) = pc.outputs
    if (node.name, node.type_name, node.beam_size, node.max_length, node.bos_id,
            node.eos_id) != ("decoder_group", "beam_search", 3, 250, 0, 1):
        fail(f"v1 gen: Outputs('__beam_search_predict__') resolved to {node!r}")
    sess = GenerationSession(pc, model_dir=model_dir, base_dir=s2s_dir)
    batches = [gen_sources(np, cfg, cfg["batch"], seed) for seed in (0, 1)]
    torch.cuda.reset_peak_memory_stats()
    zero_rnn_counts()
    ms, texts, beams, params = [], [], [], None
    for i, batch in enumerate(batches):
        dest = os.path.join(s2s_dir, f"gen_result.{i}.txt")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        written = sess.generate(batch, result_file=dest)
        ms.append((time.perf_counter() - t0) * 1e3)
        if written != {"seq_text_printer_evaluator": dest}:
            fail(f"v1 gen: generate wrote {written}")
        if params is None:
            params = sess._params
        elif sess._params is not params:
            fail("v1 gen: the second generate rebuilt or reloaded the parameters")
        with open(dest) as f:
            texts.append(f.read())
        beams.append({k: v.cpu().numpy() for k, v in sess.last_beams["decoder_group"].items()
                      if isinstance(v, torch.Tensor)})
        check_gen_result("v1 gen", texts[-1], beams[-1], batch, words, 250)
    launches = rnn_counts()
    peak = torch.cuda.max_memory_allocated()
    if any(launches.values()):
        fail(f"v1 gen: launched recurrent kernels the groups do not run: {launches}")
    profile = profile_train(torch, lambda: sess.generate(
        batches[1], result_file=os.path.join(s2s_dir, "gen_profiled.txt")),
        tag="gru", steps=1, label="v1_gen_profile")
    best_tokens = int(beams[1]["lengths"][:, 0].sum())
    result = dict(config=cfg, ms_per_call=ms[1], first_call_ms_with_build_and_load=ms[0],
                  kernels_per_generated_step=profile["kernel_launches_per_step"] / 250,
                  kernels_per_call=profile["kernel_launches_per_step"],
                  device_busy_ms_per_call=profile["device_busy_ms_per_step"],
                  busy_share=profile["device_busy_share"],
                  best_beam_tokens=best_tokens,
                  best_beam_tokens_per_s=best_tokens / (ms[1] / 1e3),
                  beam_tokens_per_s=cfg["batch"] * 3 * 250 / (ms[1] / 1e3),
                  length_min_mean_max=[int(beams[1]["lengths"][:, 0].min()),
                                       float(beams[1]["lengths"][:, 0].mean()),
                                       int(beams[1]["lengths"][:, 0].max())],
                  length_mean_by_rank=beams[1]["lengths"].mean(0).tolist(),
                  peak_memory_bytes=peak, kernel_launches=launches, profile=profile)

    gm = api.GradientMachine(pc.outputs)
    gm.setParameters({k: v.cpu().numpy() for k, v in params.items()})
    t0 = time.perf_counter()
    seqs = api.SequenceGenerator(gm, node).generate(batches[0])
    result["sequence_generator_ms"] = (time.perf_counter() - t0) * 1e3
    want = [beams[0]["history"][i, 0, :beams[0]["lengths"][i, 0]].tolist()
            for i in range(cfg["batch"])]
    if seqs != want:
        bad = sum(a != b for a, b in zip(seqs, want))
        fail(f"v1 gen: SequenceGenerator's ids differ from the session's on {bad} samples")

    # card vs CPU at a small width, one parameter dict
    small = V1_GEN_SMALL
    sargs = (f"vocab={small['vocab']},size={small['size']},beam_size={small['beam']},"
             f"max_length={small['max_length']}")
    sbatch = gen_sources(np, small, small["batch"], 2)
    got = {}
    for dev in ("cpu", "cuda"):
        G.reset_name_scope()
        s = GenerationSession(parse_config(conf, sargs, emit_proto=False), base_dir=s2s_dir,
                              device=dev)
        s._ensure_built(sbatch)
        if dev == "cpu":
            s._params = {k: small["scale"] * v for k, v in s._params.items()}
            start = s._params
        else:
            s._params = {k: v.to(dev) for k, v in start.items()}
        s.generate(sbatch, result_file=os.path.join(s2s_dir, f"gen_small_{dev}.txt"))
        got[dev] = {k: v.cpu().numpy() for k, v in s.last_beams["decoder_group"].items()
                    if isinstance(v, torch.Tensor)}
    same = bool(np.array_equal(got["cuda"]["history"], got["cpu"]["history"]) and
                np.array_equal(got["cuda"]["lengths"], got["cpu"]["lengths"]))
    rel = float(np.max(np.abs(got["cuda"]["scores"] - got["cpu"]["scores"]) /
                       np.abs(got["cpu"]["scores"])))
    result["vs_cpu"] = dict(config=small, ids_identical=same, scores_max_rel_err=rel,
                            lengths=got["cpu"]["lengths"][:, 0].tolist())
    print("v1_gen", json.dumps(result), flush=True)
    if not same or rel > GEN_SMALL_RTOL:
        fail(f"v1 gen: card vs CPU ids identical {same}, scores rel err {rel}")
    return result, dict(conf=conf, args=args, model_dir=model_dir, batch=batches[0],
                        text=texts[0], ms=ms[1])


def serve_config_phase(torch, gen):
    """Phase 27: `python -m paddle_tpu_torch serve --config` on phase 26's
    generating config and pass (a subprocess on the card) answers phase
    26's first batch through `generate_config` with phase 26's text, twice;
    SIGTERM ends it with exit code 0."""
    import signal

    from paddle_tpu_torch.serving import ServingClient

    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch", "serve", f"--config={gen['conf']}",
         f"--model_dir={gen['model_dir']}", f"--config_args={gen['args']}", "--port=0"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO)
    try:
        line = json.loads(proc.stdout.readline())
        listen_s = time.perf_counter() - t0
        client = ServingClient(tuple(line["address"]), timeout=600.0)
        ms = []
        for _ in range(2):
            t1 = time.perf_counter()
            files = client.generate_config(gen["batch"])
            ms.append((time.perf_counter() - t1) * 1e3)
            if files != {"seq_text_printer_evaluator": gen["text"]}:
                fail(f"serve --config: generate_config returned text that is not phase "
                     f"26's ({sorted(files)})")
        client.close()
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            out, err = proc.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
    result = dict(listen_s=listen_s, first_request_ms_with_build_and_load=ms[0],
                  request_ms=ms[1], session_ms=gen["ms"], exit_code=proc.returncode)
    print("serve_config", json.dumps(result), flush=True)
    if proc.returncode != 0:
        fail(f"serve --config: exit code {proc.returncode} after SIGTERM: {err[-2000:]}")
    return result


def v2_nmt_net(paddle, cfg, is_generating):
    """The paddle.v2 book's machine translation network (08.machine_
    translation train.py `seqToseq_net`) at cfg's widths: two
    networks.simple_gru encoders (the fused GRU kernels), simple_attention,
    a recurrent_group decoder of fc + gru_step + softmax fc; generating, the
    same step under layer.beam_search with a GeneratedInput."""
    vocab, size = cfg["vocab"], cfg["size"]
    src = paddle.layer.data(name="source_language_word",
                            type=paddle.data_type.integer_value_sequence(vocab))
    emb = paddle.layer.embedding(input=src, size=size)
    fwd = paddle.networks.simple_gru(input=emb, size=size, name="src_forward")
    bwd = paddle.networks.simple_gru(input=emb, size=size, reverse=True, name="src_backward")
    encoded = paddle.layer.concat(input=[fwd, bwd])
    encoded_proj = paddle.layer.fc(act=paddle.activation.Linear(), size=size,
                                   bias_attr=False, input=encoded)
    boot = paddle.layer.fc(size=size, act=paddle.activation.Tanh(), bias_attr=False,
                           input=paddle.layer.first_seq(input=bwd))

    def step(enc_vec, enc_proj, current_word):
        mem = paddle.layer.memory(name="gru_decoder", size=size, boot_layer=boot)
        context = paddle.networks.simple_attention(encoded_sequence=enc_vec,
                                                   encoded_proj=enc_proj, decoder_state=mem)
        inputs = paddle.layer.fc(
            act=paddle.activation.Linear(), size=size * 3, bias_attr=False,
            input=[context, current_word],
            layer_attr=paddle.attr.ExtraLayerAttribute(error_clipping_threshold=100.0))
        gru = paddle.layer.gru_step(name="gru_decoder", input=inputs, output_mem=mem,
                                    size=size)
        return paddle.layer.fc(size=vocab, bias_attr=True, act=paddle.activation.Softmax(),
                               input=gru)

    group = [paddle.layer.StaticInput(input=encoded),
             paddle.layer.StaticInput(input=encoded_proj)]
    if not is_generating:
        trg = paddle.layer.embedding(
            input=paddle.layer.data(name="target_language_word",
                                    type=paddle.data_type.integer_value_sequence(vocab)),
            size=size, param_attr=paddle.attr.ParamAttr(name="_target_language_embedding"))
        decoder = paddle.layer.recurrent_group(name="decoder_group", step=step,
                                               input=group + [trg])
        label = paddle.layer.data(name="target_language_next_word",
                                  type=paddle.data_type.integer_value_sequence(vocab))
        return paddle.layer.classification_cost(input=decoder, label=label)
    trg = paddle.layer.GeneratedInput(size=vocab, embedding_name="_target_language_embedding",
                                      embedding_size=size)
    return paddle.layer.beam_search(name="decoder_group", step=step, input=group + [trg],
                                    bos_id=0, eos_id=1, beam_size=cfg["beam"],
                                    max_length=cfg["max_length"])


def v2_gen_phase(torch):
    """Phase 28: the v2 book's NMT script at phase 23's widths trains 4
    batches (GRU counters from 0), round-trips its parameters through a
    tar, then generates with layer.beam_search + infer(field="value")."""
    import io

    import numpy as np

    import paddle_tpu_torch.v2 as paddle
    from paddle_tpu_torch.nn import graph as G

    cfg = V2_GEN
    G.reset_name_scope()
    paddle.init(use_gpu=True, trainer_count=1, seed=0)
    cost = v2_nmt_net(paddle, cfg, False)
    params = paddle.parameters.create(cost)
    trainer = paddle.trainer.SGD(cost=cost, parameters=params,
                                 update_equation=paddle.optimizer.Adam(learning_rate=5e-4))
    rs = np.random.RandomState(0)
    samples = []
    for _ in range(cfg["batches"] * cfg["batch"]):
        src = rs.randint(2, cfg["vocab"], size=cfg["length"])
        trg = rs.randint(2, cfg["vocab"], size=cfg["length"])
        samples.append((src.tolist(), trg.tolist(), np.append(trg[1:], 1).tolist()))
    feeding = {"source_language_word": 0, "target_language_word": 1,
               "target_language_next_word": 2}
    costs = []
    zero_rnn_counts()
    t0 = time.perf_counter()
    trainer.train(reader=paddle.batch(lambda: iter(samples), cfg["batch"]), num_passes=1,
                  event_handler=lambda e: costs.append(e.cost)
                  if isinstance(e, paddle.event.EndIteration) else None, feeding=feeding)
    train_s = time.perf_counter() - t0
    train_launches = rnn_counts()
    graphs = list(trainer.trainer.graphs.values())
    steps = cfg["batches"]
    if (train_launches["FWD_LAUNCHES"], train_launches["BWD_LAUNCHES"]) != (
            2 * steps + 2, 2 * steps):
        fail(f"v2 gen: GRU launches {train_launches} over {steps} steps, want fwd "
             f"{2 * steps + 2} (the init's forward too), bwd {2 * steps}")
    if len(graphs) != 1 or graphs[0].replays != steps - 1 or not np.isfinite(costs).all():
        fail(f"v2 gen: {len(graphs)} graphs, costs {costs}")
    buf = io.BytesIO()
    trainer.save_parameter_to_tar(buf)
    back = paddle.parameters.Parameters.from_tar(io.BytesIO(buf.getvalue()))
    trained = trainer.parameters
    if sorted(back.names()) != sorted(trained.names()) or not all(
            back.get(k).tobytes() == trained.get(k).tobytes() for k in trained.names()):
        fail("v2 gen: to_tar -> from_tar is not bitwise")
    del trainer, graphs
    torch.cuda.empty_cache()

    G.reset_name_scope()
    gen = v2_nmt_net(paddle, cfg, True)
    inf = paddle.inference.Inference(gen, back)
    src = gen_sources(np, cfg, cfg["infer"], 3)
    sources = [(src["source_language_word"][i, :n].tolist(),)
               for i, n in enumerate(src["source_language_word.lengths"])]
    feed = {"source_language_word": 0}
    inf.infer(sources[:cfg["batch"]], feeding=feed, field="value")  # its init's forward
    zero_rnn_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids = inf.infer(sources, feeding=feed, field="value", batch_size=cfg["batch"])
    infer_ms = (time.perf_counter() - t0) * 1e3
    launches = rnn_counts()
    chunks = cfg["infer"] // cfg["batch"]
    with torch.no_grad():
        ref = inf.network.apply(inf._params, inf.topology.make_feeder(feed)(
            sources[:cfg["batch"]]))[gen.name].value.cpu().numpy()
    result = dict(config=cfg, train_s=train_s, step_costs=costs,
                  train_launches=train_launches, tar_bytes=len(buf.getvalue()),
                  infer_ms_per_128=infer_ms / chunks, infer_launches=launches,
                  ids_shape=list(ids.shape),
                  length_mean=float(np.where((ids == 1).any(1), (ids == 1).argmax(1) + 1,
                                             cfg["max_length"]).mean()))
    print("v2_gen", json.dumps(result), flush=True)
    if launches["FWD_LAUNCHES"] != 2 * chunks or any(
            v for k, v in launches.items() if k != "FWD_LAUNCHES"):
        fail(f"v2 gen: infer over {chunks} chunks launched {launches}, want "
             f"{2 * chunks} GRU forwards and nothing else")
    if ids.shape != (cfg["infer"], cfg["max_length"]) or ids.dtype != np.int32:
        fail(f"v2 gen: infer gave ids {ids.shape} {ids.dtype}")
    if not np.array_equal(ids[:cfg["batch"]], ref):
        fail("v2 gen: infer's first chunk differs from a Network forward of it")
    return result


# -- the paddle.v2 book's chapters (phases 30-31) ------------------------------
# Each builds its network with the `paddle` module it is given (the port's
# paddle_tpu_torch.v2, or the JAX package's in the CPU tests) and returns
# what its train.py hands trainer.SGD: the cost, the extra layers, the
# feeding, the update equation and the reader creator. Where the JAX
# package names a v2 call differently from the book, the chapter uses the
# JAX package's name (layer.pool, attr.ExtraAttr, optimizer.ModelAverageCfg,
# data_type.dense_array for the image chapters' flat records, which the
# feeder reshapes to NHWC).


def book_fit_a_line(paddle, cfg):
    """01.fit_a_line: uci_housing, fc 13 -> 1, square_error_cost."""
    x = paddle.layer.data(name="x", type=paddle.data_type.dense_vector(13))
    y_predict = paddle.layer.fc(input=x, size=1, act=paddle.activation.Linear())
    y = paddle.layer.data(name="y", type=paddle.data_type.dense_vector(1))
    cost = paddle.layer.square_error_cost(input=y_predict, label=y)
    # the training split (404 records) three times over: 8 full batches
    train = paddle.dataset.uci_housing.train()
    return dict(cost=cost, extra=[], feeding={"x": 0, "y": 1},
                optimizer=paddle.optimizer.Momentum(momentum=0),
                reader=paddle.reader.chain(train, train, train), buf_size=500)


def book_recognize_digits(paddle, cfg):
    """02.recognize_digits `convolutional_neural_network`: mnist, two
    simple_img_conv_pool (5x5, pool 2) of cfg["filters"], fc 10 softmax."""
    images = paddle.layer.data(name="pixel", type=paddle.data_type.dense_array((28, 28, 1)))
    label = paddle.layer.data(name="label", type=paddle.data_type.integer_value(10))
    f1, f2 = cfg["filters"]
    conv_pool_1 = paddle.networks.simple_img_conv_pool(
        input=images, filter_size=5, num_filters=f1, num_channel=1, pool_size=2,
        pool_stride=2, act=paddle.activation.Relu())
    conv_pool_2 = paddle.networks.simple_img_conv_pool(
        input=conv_pool_1, filter_size=5, num_filters=f2, num_channel=f1, pool_size=2,
        pool_stride=2, act=paddle.activation.Relu())
    predict = paddle.layer.fc(input=conv_pool_2, size=10, act=paddle.activation.Softmax())
    cost = paddle.layer.classification_cost(input=predict, label=label)
    opt = paddle.optimizer.Momentum(
        learning_rate=0.1 / 128.0, momentum=0.9,
        regularization=paddle.optimizer.L2Regularization(rate=0.0005 * 128))
    return dict(cost=cost, extra=[], feeding={"pixel": 0, "label": 1}, optimizer=opt,
                reader=paddle.dataset.mnist.train(), buf_size=8192)


def book_image_classification(paddle, cfg):
    """03.image_classification `vgg_bn_drop`: cifar.train10, img_conv_group
    stages of cfg["stages"] (filters, convs) with batch norm and dropout,
    dropout 0.5, fc, batch_norm with drop_rate 0.5, fc, fc 10 softmax."""
    image = paddle.layer.data(name="image", type=paddle.data_type.dense_array((32, 32, 3)))
    label = paddle.layer.data(name="label", type=paddle.data_type.integer_value(10))

    def conv_block(ipt, num_filter, groups, dropouts, num_channels=None):
        return paddle.networks.img_conv_group(
            input=ipt, num_channels=num_channels, pool_size=2, pool_stride=2,
            conv_num_filter=[num_filter] * groups, conv_filter_size=3,
            conv_act=paddle.activation.Relu(), conv_with_batchnorm=True,
            conv_batchnorm_drop_rate=dropouts, pool_type=paddle.pooling.Max())

    x, channels = image, 3
    for i, (nf, groups) in enumerate(cfg["stages"]):
        drops = ([0.3] if i == 0 else [0.4]) * (groups - 1) + [0]
        x = conv_block(x, nf, groups, drops, channels)
        channels = nf
    drop = paddle.layer.dropout(input=x, dropout_rate=0.5)
    fc1 = paddle.layer.fc(input=drop, size=cfg["fc"], act=paddle.activation.Linear())
    bn = paddle.layer.batch_norm(input=fc1, act=paddle.activation.Relu(),
                                 layer_attr=paddle.attr.ExtraAttr(drop_rate=0.5))
    fc2 = paddle.layer.fc(input=bn, size=cfg["fc"], act=paddle.activation.Linear())
    out = paddle.layer.fc(input=fc2, size=10, act=paddle.activation.Softmax())
    cost = paddle.layer.classification_cost(input=out, label=label)
    opt = paddle.optimizer.Momentum(
        momentum=0.9, regularization=paddle.optimizer.L2Regularization(rate=0.0002 * 128),
        learning_rate=0.1 / 128.0, learning_rate_decay_a=0.1,
        learning_rate_decay_b=50000 * 100, learning_rate_schedule="discexp")
    return dict(cost=cost, extra=[], feeding={"image": 0, "label": 1}, optimizer=opt,
                reader=paddle.dataset.cifar.train10(), buf_size=50000)


def book_word2vec(paddle, cfg):
    """04.word2vec: imikolov 5-grams, four embeddings of cfg["emb"] sharing
    the table `shared_w`, concat, fc cfg["hidden"] sigmoid (drop_rate 0.5),
    softmax over the dictionary; cfg["output"] "hsigmoid" or "nce" puts
    that cost over the dictionary in the softmax's place (AdaGrad at the
    book's 3e-3)."""
    word_dict = paddle.dataset.imikolov.build_dict()
    if cfg.get("vocab"):  # the CPU twins' reduced dictionary
        word_dict = {w: i for w, i in word_dict.items() if i < cfg["vocab"] - 1}
        word_dict["<unk>"] = len(word_dict)
    dict_size = len(word_dict)
    emb_attr = paddle.attr.Param(name="shared_w", initial_std=0.001, learning_rate=1,
                                 l2_rate=0)

    def word(name):
        return paddle.layer.data(name=name, type=paddle.data_type.integer_value(dict_size))

    names = ("firstw", "secondw", "thirdw", "fourthw")
    embs = [paddle.layer.embedding(input=word(n), size=cfg["emb"], param_attr=emb_attr)
            for n in names]
    nextword = word("fifthw")
    contextemb = paddle.layer.concat(input=embs)
    hidden1 = paddle.layer.fc(
        input=contextemb, size=cfg["hidden"], act=paddle.activation.Sigmoid(),
        layer_attr=paddle.attr.ExtraAttr(drop_rate=0.5),
        bias_attr=paddle.attr.Param(learning_rate=2),
        param_attr=paddle.attr.Param(initial_std=1.0 / (cfg["emb"] * 8) ** 0.5,
                                     learning_rate=1))
    output = cfg.get("output", "softmax")
    if output == "hsigmoid":  # phase 41: the softmax output as a hierarchical sigmoid
        cost = paddle.layer.hsigmoid(input=hidden1, label=nextword, num_classes=dict_size)
    elif output == "nce":  # and as noise-contrastive estimation
        cost = paddle.layer.nce(input=hidden1, label=nextword, num_classes=dict_size,
                                num_neg_samples=cfg["neg"])
    else:
        predictword = paddle.layer.fc(input=hidden1, size=dict_size,
                                      bias_attr=paddle.attr.Param(learning_rate=2),
                                      act=paddle.activation.Softmax())
        cost = paddle.layer.classification_cost(input=predictword, label=nextword)
    opt = paddle.optimizer.AdaGrad(
        learning_rate=3e-3,
        regularization=paddle.optimizer.L2Regularization(8e-4))
    return dict(cost=cost, extra=[], feeding={n: i for i, n in enumerate(names + ("fifthw",))},
                optimizer=opt, reader=paddle.dataset.imikolov.train(word_dict, 5),
                buf_size=8192, dict_size=dict_size)


def book_understand_sentiment(paddle, cfg):
    """05.understand_sentiment `stacked_lstm_net`: imdb, embedding
    cfg["emb"], fc + lstmemory stacked cfg["stacked"] deep (every other one
    reversed; lstmemory keeps its peepholes, the plain step loop), max pools
    of the last pair, fc 2 softmax; with `average`, ModelAverage(0.5)."""
    word_dict = paddle.dataset.imdb.word_dict()
    input_dim, hid_dim = len(word_dict), cfg["hidden"]
    layer_attr = paddle.attr.ExtraAttr(drop_rate=0.5)
    fc_para_attr = paddle.attr.Param(learning_rate=1e-3)
    lstm_para_attr = paddle.attr.Param(initial_std=0.0, learning_rate=1.0)
    para_attr = [fc_para_attr, lstm_para_attr]
    bias_attr = paddle.attr.Param(initial_std=0.0, l2_rate=0.0)
    relu, linear = paddle.activation.Relu(), paddle.activation.Linear()
    data = paddle.layer.data("word", paddle.data_type.integer_value_sequence(input_dim))
    emb = paddle.layer.embedding(input=data, size=cfg["emb"])
    fc1 = paddle.layer.fc(input=emb, size=hid_dim, act=linear, bias_attr=bias_attr)
    lstm1 = paddle.layer.lstmemory(input=fc1, act=relu, bias_attr=bias_attr,
                                   layer_attr=layer_attr)
    inputs = [fc1, lstm1]
    for i in range(2, cfg["stacked"] + 1):
        fc = paddle.layer.fc(input=inputs, size=hid_dim, act=linear, param_attr=para_attr,
                             bias_attr=bias_attr)
        lstm = paddle.layer.lstmemory(input=fc, reverse=(i % 2) == 0, act=relu,
                                      bias_attr=bias_attr, layer_attr=layer_attr)
        inputs = [fc, lstm]
    fc_last = paddle.layer.pool(input=inputs[0], pooling_type=paddle.pooling.Max())
    lstm_last = paddle.layer.pool(input=inputs[1], pooling_type=paddle.pooling.Max())
    output = paddle.layer.fc(input=[fc_last, lstm_last], size=2,
                             act=paddle.activation.Softmax(), bias_attr=bias_attr,
                             param_attr=para_attr)
    lbl = paddle.layer.data("label", paddle.data_type.integer_value(2))
    cost = paddle.layer.classification_cost(input=output, label=lbl)
    opt = paddle.optimizer.Adam(
        learning_rate=2e-3, regularization=paddle.optimizer.L2Regularization(rate=8e-4),
        model_average=paddle.optimizer.ModelAverageCfg(average_window=0.5)
        if cfg["average"] else None)
    return dict(cost=cost, extra=[], feeding={"word": 0, "label": 1}, optimizer=opt,
                reader=paddle.dataset.imdb.train(word_dict), buf_size=1000)


def book_label_semantic_roles(paddle, cfg):
    """06.label_semantic_roles `db_lstm`: conll05.test(), eight embeddings
    (word cfg["word_dim"] shared as `emb`, mark cfg["mark_dim"]), mixed
    full_matrix_projections, cfg["depth"] lstmemory layers of
    cfg["hidden"] / 4 alternating direction, crf and crf_decoding over the
    label dictionary. No pretrained embedding: conll05.get_embedding
    raises offline, so `emb` keeps its initial values (is_static)."""
    word_dict, verb_dict, label_dict = paddle.dataset.conll05.get_dict()
    word_dict_len, pred_len, label_dict_len = len(word_dict), len(verb_dict), len(label_dict)
    mark_dict_len, word_dim, mark_dim = 2, cfg["word_dim"], cfg["mark_dim"]
    hidden_dim, depth, default_std = cfg["hidden"], cfg["depth"], 1 / (cfg["hidden"] ** 0.5) / 3.0

    def seq(name, size):
        return paddle.layer.data(name=name, type=paddle.data_type.integer_value_sequence(size))

    word = seq("word_data", word_dict_len)
    predicate = seq("verb_data", pred_len)
    ctx = [seq(f"ctx_{n}_data", word_dict_len) for n in ("n2", "n1", "0", "p1", "p2")]
    mark = seq("mark_data", mark_dict_len)
    emb_para = paddle.attr.Param(name="emb", initial_std=0.0, is_static=True)
    std_0 = paddle.attr.Param(initial_std=0.0)
    std_default = paddle.attr.Param(initial_std=default_std)
    predicate_embedding = paddle.layer.embedding(
        size=word_dim, input=predicate,
        param_attr=paddle.attr.Param(name="vemb", initial_std=default_std))
    mark_embedding = paddle.layer.embedding(size=mark_dim, input=mark, param_attr=std_0)
    emb_layers = [paddle.layer.embedding(size=word_dim, input=x, param_attr=emb_para)
                  for x in [word] + ctx]
    emb_layers += [predicate_embedding, mark_embedding]
    hidden_0 = paddle.layer.mixed(
        size=hidden_dim, bias_attr=std_default,
        input=[paddle.layer.full_matrix_projection(input=emb, param_attr=std_default)
               for emb in emb_layers])
    mix_hidden_lr = 1e-3
    lstm_para_attr = paddle.attr.Param(initial_std=0.0, learning_rate=1.0)
    hidden_para_attr = paddle.attr.Param(initial_std=default_std, learning_rate=mix_hidden_lr)
    lstm_0 = paddle.layer.lstmemory(
        input=hidden_0, act=paddle.activation.Relu(), gate_act=paddle.activation.Sigmoid(),
        state_act=paddle.activation.Sigmoid(), bias_attr=std_0, param_attr=lstm_para_attr)
    input_tmp = [hidden_0, lstm_0]
    for i in range(1, depth):
        mix_hidden = paddle.layer.mixed(
            size=hidden_dim, bias_attr=std_default,
            input=[paddle.layer.full_matrix_projection(input=input_tmp[0],
                                                       param_attr=hidden_para_attr),
                   paddle.layer.full_matrix_projection(input=input_tmp[1],
                                                       param_attr=lstm_para_attr)])
        lstm = paddle.layer.lstmemory(
            input=mix_hidden, act=paddle.activation.Relu(),
            gate_act=paddle.activation.Sigmoid(), state_act=paddle.activation.Sigmoid(),
            reverse=((i % 2) == 1), bias_attr=std_0, param_attr=lstm_para_attr)
        input_tmp = [mix_hidden, lstm]
    feature_out = paddle.layer.mixed(
        size=label_dict_len, bias_attr=std_default,
        input=[paddle.layer.full_matrix_projection(input=input_tmp[0],
                                                   param_attr=hidden_para_attr),
               paddle.layer.full_matrix_projection(input=input_tmp[1],
                                                   param_attr=lstm_para_attr)])
    target = seq("target", label_dict_len)
    crf_cost = paddle.layer.crf(
        size=label_dict_len, input=feature_out, label=target,
        param_attr=paddle.attr.Param(name="crfw", initial_std=default_std,
                                     learning_rate=mix_hidden_lr))
    crf_dec = paddle.layer.crf_decoding(size=label_dict_len, input=feature_out,
                                        param_attr=paddle.attr.Param(name="crfw"))
    opt = paddle.optimizer.Momentum(
        momentum=0, learning_rate=1e-2,
        regularization=paddle.optimizer.L2Regularization(rate=8e-4),
        model_average=paddle.optimizer.ModelAverageCfg(average_window=0.5,
                                                       max_average_window=10000)
        if cfg["average"] else None)
    names = ("word_data", "ctx_n2_data", "ctx_n1_data", "ctx_0_data", "ctx_p1_data",
             "ctx_p2_data", "verb_data", "mark_data", "target")
    return dict(cost=crf_cost, extra=[crf_dec], decode=crf_dec,
                feeding={n: i for i, n in enumerate(names)}, optimizer=opt,
                reader=paddle.dataset.conll05.test(), buf_size=8192,
                label_dict_len=label_dict_len)


def book_machine_translation(paddle, cfg):
    """08.machine_translation: wmt14.train(cfg["vocab"]) through
    v2_nmt_net (two simple_gru encoders: the fused GRU kernels)."""
    cost = v2_nmt_net(paddle, cfg, False)
    opt = paddle.optimizer.Adam(learning_rate=5e-5,
                                regularization=paddle.optimizer.L2Regularization(rate=8e-4))
    return dict(cost=cost, extra=[], optimizer=opt,
                feeding={"source_language_word": 0, "target_language_word": 1,
                         "target_language_next_word": 2},
                reader=paddle.dataset.wmt14.train(cfg["vocab"]), buf_size=8192)


def book_recommender_system(paddle, cfg):
    """05.recommender_system: movielens; the user's id, gender, age and job
    and the movie's id, categories and title, each through an embedding
    (or, for the categories, a sparse_binary_vector) and an fc, combined
    into two 200-wide tanh fcs; `cos_sim(scale=5)` of the two against the
    score by square_error_cost, Adam(1e-4). cfg["title_dict"] is the title
    vocabulary (the synthetic records' 5000 ids; the book reads
    get_movie_title_dict(), which neither package's reader has)."""
    ml = paddle.dataset.movielens
    layer, dt, act = paddle.layer, paddle.data_type, paddle.activation
    emb, small = cfg["emb"], cfg["small"]

    def id_fc(name, n, width):
        slot = layer.data(name=name, type=dt.integer_value(n))
        return layer.fc(input=layer.embedding(input=slot, size=width), size=width)

    usr = layer.fc(input=[id_fc("user_id", ml.max_user_id() + 1, emb),
                          id_fc("gender_id", 2, small),
                          id_fc("age_id", len(ml.age_table()), small),
                          id_fc("job_id", ml.max_job_id() + 1, small)],
                   size=cfg["combined"], act=act.Tanh())
    categories = layer.data(name="category_id",
                            type=dt.sparse_binary_vector(len(ml.movie_categories())))
    title = layer.data(name="movie_title",
                       type=dt.integer_value_sequence(cfg["title_dict"]))
    title_conv = paddle.networks.sequence_conv_pool(
        input=layer.embedding(input=title, size=emb), hidden_size=emb, context_len=3)
    mov = layer.fc(input=[id_fc("movie_id", ml.max_movie_id() + 1, emb),
                          layer.fc(input=categories, size=emb), title_conv],
                   size=cfg["combined"], act=act.Tanh())
    inference = layer.cos_sim(a=usr, b=mov, size=1, scale=5)
    score = layer.data(name="score", type=dt.dense_vector(1))
    cost = layer.square_error_cost(input=inference, label=score)
    feeding = {"user_id": 0, "gender_id": 1, "age_id": 2, "job_id": 3, "movie_id": 4,
               "category_id": 5, "movie_title": 6, "score": 7}
    return dict(cost=cost, extra=[], feeding=feeding,
                optimizer=paddle.optimizer.Adam(learning_rate=1e-4),
                reader=(lambda: ((*r[:7], [r[7]]) for r in ml.train()())),
                buf_size=8192)


def book_lambda_rank(paddle, cfg):
    """The learning-to-rank demo's LambdaRank network (v2 lambda_cost):
    mq2007's listwise queries of 46-wide documents, fc cfg["hidden"] tanh,
    fc 1 linear, lambda_cost NDCG@6, Adam at cfg["lr"]."""
    dim = paddle.dataset.mq2007.FEATURE_DIM
    data = paddle.layer.data("data", paddle.data_type.dense_vector_sequence(dim))
    label = paddle.layer.data("label", paddle.data_type.dense_vector_sequence(1))
    hidden = paddle.layer.fc(input=data, size=cfg["hidden"], act=paddle.activation.Tanh())
    score = paddle.layer.fc(input=hidden, size=1, act=paddle.activation.Linear())
    cost = paddle.layer.lambda_cost(input=score, score=label, NDCG_num=6)
    return dict(cost=cost, extra=[], feeding={"data": 0, "label": 1},
                optimizer=paddle.optimizer.Adam(learning_rate=cfg["lr"]),
                reader=paddle.dataset.mq2007.train(format="listwise"), buf_size=512)


BOOK_CHAPTERS = dict(
    fit_a_line=book_fit_a_line, recognize_digits=book_recognize_digits,
    image_classification=book_image_classification, word2vec=book_word2vec,
    recommender_system=book_recommender_system,
    understand_sentiment=book_understand_sentiment,
    label_semantic_roles=book_label_semantic_roles,
    machine_translation=book_machine_translation, lambda_rank=book_lambda_rank)


def book_run(paddle, name, cfg, batches, device=None, start_tar=None, keep_init=False,
             event_handler=None, before_train=None):
    """One chapter's train.py: its network, `parameters.create` (or
    `Parameters.from_tar(start_tar)`), trainer.SGD and train() over
    `batch(shuffle(reader, buf_size), cfg["batch"])`, the first `batches`
    batches, one pass; `before_train()` runs just before train(). ->
    {chapter, trainer, costs (EndIteration's), the training pass's batches,
    and with keep_init the initial parameters' tar}."""
    import io

    ch = BOOK_CHAPTERS[name](paddle, cfg)
    if start_tar is None:
        params = paddle.parameters.create(ch["cost"])
    else:
        params = paddle.parameters.Parameters.from_tar(io.BytesIO(start_tar))
    init_tar = None
    if keep_init:
        buf = io.BytesIO()
        params.to_tar(buf)
        init_tar = buf.getvalue()
    kw = {} if device is None else {"device": device}
    trainer = paddle.trainer.SGD(cost=ch["cost"], parameters=params,
                                 update_equation=ch["optimizer"], extra_layers=ch["extra"],
                                 **kw)
    batched = paddle.batch(paddle.reader.shuffle(ch["reader"], buf_size=ch["buf_size"]),
                           cfg["batch"])
    costs, passes = [], []

    def handler(e):
        if type(e).__name__ == "EndIteration":
            costs.append(float(e.cost))
        if event_handler is not None:
            event_handler(e)

    def reader():
        # SGD reads a first batch of its own to build its state: the
        # training pass is the last call
        passes.append([])
        for b in itertools.islice(batched(), batches):
            passes[-1].append(b)
            yield b

    if before_train is not None:
        before_train()
    trainer.train(reader=reader, num_passes=1, event_handler=handler, feeding=ch["feeding"])
    return dict(chapter=ch, trainer=trainer, costs=costs, batches=passes[-1],
                init_tar=init_tar)

def book_data_home() -> str:
    """A fresh, empty DATA_HOME under build/ for the book's readers: with
    nothing cached there, every reader yields its synthetic records."""
    import tempfile

    from paddle_tpu_torch.data.datasets import common

    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    common.DATA_HOME = tempfile.mkdtemp(prefix="book-data-", dir=os.path.join(REPO, "build"))
    common.SYNTHETIC = False
    return common.DATA_HOME


def book_files(home: str):
    return sorted(os.path.relpath(os.path.join(d, f), home)
                  for d, _, fs in os.walk(home) for f in fs)


def book_step_times(run_fn):
    """Run run_fn(event_handler) -> result, recording each EndIteration's
    wall time -> (result, [ms of each step after the first])."""
    stamps = []

    def handler(e):
        if type(e).__name__ == "EndIteration":
            stamps.append(time.perf_counter())

    t0 = time.perf_counter()
    out = run_fn(handler)
    return out, [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])], (stamps[0] - t0) * 1e3


def book_nmt_phase(torch):
    """Phase 30: the v2 book's machine translation chapter, unchanged, through
    `paddle.dataset.wmt14`: train(30000) -> reader.shuffle(8192) ->
    batch(128) -> trainer.SGD over 8 batches (GRU counters from 0), the
    first 2 batches' costs against the CPU from the same parameters; then
    layer.beam_search + infer over 128 sources of wmt14.test(30000), the
    ids turned into words through wmt14.get_dict(30000)."""
    import random

    import numpy as np

    import paddle_tpu_torch.v2 as paddle
    from paddle_tpu_torch.nn import graph as G

    cfg, steps = BOOK_NMT, BOOK_NMT["batches"]
    home = book_data_home()
    G.reset_name_scope()
    paddle.init(use_gpu=True, trainer_count=1, seed=0)
    random.seed(0)
    torch.cuda.reset_peak_memory_stats()
    run, step_ms, first_ms = book_step_times(lambda h: book_run(
        paddle, "machine_translation", cfg, steps, keep_init=True, event_handler=h,
        before_train=zero_rnn_counts))
    launches = rnn_counts()
    peak = torch.cuda.max_memory_allocated()
    tr = run["trainer"].trainer
    costs = run["costs"]
    batches = run["batches"]
    trg_tokens = [sum(len(s[1]) for s in b) for b in batches]
    src_lens = sorted({len(s[0]) for b in batches for s in b})
    replayed_s = sum(step_ms) / 1e3
    result = dict(config=cfg, step_costs=costs, kernel_launches=launches,
                  graphs=len(tr.graphs), signatures=[str(k)[:200] for k in tr.graphs],
                  replays=sum(g.replays for g in tr.graphs.values()),
                  first_step_ms=first_ms, step_ms=step_ms,
                  ms_per_step_median=statistics.median(step_ms),
                  target_tokens_per_s=sum(trg_tokens[1:]) / replayed_s,
                  target_tokens_per_step=trg_tokens, source_lengths=[src_lens[0], src_lens[-1]],
                  peak_memory_bytes=peak, synthetic=paddle.dataset.common.SYNTHETIC)
    if (launches["FWD_LAUNCHES"], launches["BWD_LAUNCHES"]) != (2 * steps + 2, 2 * steps):
        fail(f"book nmt: GRU launches {launches} over {steps} steps, want fwd "
             f"{2 * steps + 2} (the init's forward too), bwd {2 * steps}")
    if len(costs) != steps or not np.isfinite(costs).all():
        fail(f"book nmt: costs {costs}")
    if result["replays"] + len(tr.graphs) != steps:
        fail(f"book nmt: {len(tr.graphs)} graphs and {result['replays']} replays over "
             f"{steps} steps: every step after a signature's first must replay")
    files = book_files(home)
    if not paddle.dataset.common.SYNTHETIC or files:
        fail(f"book nmt: SYNTHETIC {paddle.dataset.common.SYNTHETIC}, files under "
             f"DATA_HOME {files[:5]}")

    # the first 2 batches on the CPU from the same parameters and batches
    G.reset_name_scope()
    random.seed(0)
    cpu = book_run(paddle, "machine_translation", cfg, BOOK_CPU_STEPS, device="cpu",
                   start_tar=run["init_tar"])["costs"]
    rel = [abs(a - b) / abs(b) for a, b in zip(costs, cpu)]
    result["vs_cpu"] = dict(steps=len(cpu), cost_card=costs[:len(cpu)], cost_cpu=cpu,
                            cost_rel_err=rel)
    if len(rel) != BOOK_CPU_STEPS or not (rel[0] <= CPU_COST_RTOL and max(rel) <= V1_CPU_RTOL):
        fail(f"book nmt: step costs card {costs[:len(cpu)]} vs CPU {cpu}: rel err {rel} "
             f"(first <= {CPU_COST_RTOL}, all <= {V1_CPU_RTOL})")

    # generation: layer.beam_search over 128 test sources, as the chapter does
    G.reset_name_scope()
    gen = v2_nmt_net(paddle, cfg, True)
    inf = paddle.inference.Inference(gen, run["trainer"].parameters)
    sources = [(s,) for s, _, _ in itertools.islice(
        paddle.dataset.wmt14.test(cfg["vocab"])(), cfg["infer"])]
    feed = {"source_language_word": 0}
    inf.infer(sources, feeding=feed, field="value")  # its init's forward
    zero_rnn_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids = inf.infer(sources, feeding=feed, field="value", batch_size=cfg["batch"])
    infer_ms = (time.perf_counter() - t0) * 1e3
    infer_launches = rnn_counts()
    _, trg_dict = paddle.dataset.wmt14.get_dict(cfg["vocab"])
    words = [[trg_dict[int(i)] for i in row[:(list(row) + [1]).index(1)]] for row in ids]
    result.update(infer_ms_per_128=infer_ms * cfg["batch"] / len(sources),
                  infer_launches=infer_launches, ids_shape=list(ids.shape),
                  first_translation=" ".join(words[0]),
                  length_mean=float(np.mean([len(w) + 1 for w in words])))
    print("book_nmt", json.dumps(result), flush=True)
    if ids.shape != (cfg["infer"], cfg["max_length"]) or ids.dtype != np.int32:
        fail(f"book nmt: infer gave ids {ids.shape} {ids.dtype}")
    if not all(int(i) in trg_dict for i in ids.ravel()):
        fail("book nmt: a generated id is not a word of wmt14.get_dict")
    chunks = -(-len(sources) // cfg["batch"])
    if infer_launches["FWD_LAUNCHES"] != 2 * chunks or any(
            v for k, v in infer_launches.items() if k != "FWD_LAUNCHES"):
        fail(f"book nmt: infer over {chunks} chunks launched {infer_launches}, want "
             f"{2 * chunks} GRU forwards and nothing else")
    return result


def book_chapters_phase(torch):
    """Phase 31: the book's six other chapters, unchanged, at their widths,
    each through its reader over 8 batches (counters from 0 in each):
    finite costs; the first 2 batches' costs against the CPU from the
    same parameters and batches; SRL's crf_decoding ids inside the label
    dictionary. Whether a chapter's cost fell over its 8 batches is
    reported, not held: under the book's rates on the synthetic records
    image_classification's and word2vec's do not (PERF.md §6)."""
    import random

    import numpy as np

    import paddle_tpu_torch.v2 as paddle
    from paddle_tpu_torch.nn import graph as G

    home = book_data_home()
    out = {}
    for name, cfg in BOOK.items():
        G.reset_name_scope()
        paddle.init(use_gpu=True, trainer_count=1, seed=0)
        random.seed(0)
        torch.cuda.reset_peak_memory_stats()
        run, step_ms, first_ms = book_step_times(lambda h: book_run(
            paddle, name, cfg, BOOK_BATCHES, keep_init=True, event_handler=h,
            before_train=zero_rnn_counts))
        tr, costs = run["trainer"].trainer, run["costs"]
        r = dict(config=cfg, step_costs=costs, cost_fell=costs[-1] <= costs[0],
                 first_step_ms=first_ms,
                 ms_per_step_median=statistics.median(step_ms), step_ms=step_ms,
                 graphs=len(tr.graphs), replays=sum(g.replays for g in tr.graphs.values()),
                 kernel_launches=rnn_counts(),
                 peak_memory_bytes=torch.cuda.max_memory_allocated())
        G.reset_name_scope()
        random.seed(0)
        cpu = book_run(paddle, name, cfg, BOOK_CPU_STEPS, device="cpu",
                       start_tar=run["init_tar"])["costs"]
        rel = [abs(a - b) / abs(b) for a, b in zip(costs, cpu)]
        r["vs_cpu"] = dict(cost_cpu=cpu, cost_rel_err=rel)
        if name == "label_semantic_roles":
            ch = run["chapter"]
            feeding = {k: v for k, v in ch["feeding"].items() if k != "target"}
            samples = [s[:-1] for s in itertools.islice(paddle.dataset.conll05.test()(),
                                                         cfg["batch"])]
            dec = np.asarray(paddle.infer(output_layer=ch["decode"],
                                          parameters=run["trainer"].parameters, input=samples,
                                          feeding=feeding, field="value"))
            r["decode_shape"], r["decode_ids"] = list(dec.shape), sorted(set(dec.ravel().tolist()))
            if dec.min() < 0 or dec.max() >= ch["label_dict_len"]:
                fail(f"book {name}: crf_decoding ids {r['decode_ids']} outside the "
                     f"{ch['label_dict_len']} labels")
        out[name] = r
        print("book_chapter", name, json.dumps(r), flush=True)
        if len(costs) != BOOK_BATCHES or not np.isfinite(costs).all():
            fail(f"book {name}: costs over {BOOK_BATCHES} batches {costs}")
        if len(rel) != BOOK_CPU_STEPS or not (rel[0] <= CPU_COST_RTOL and
                                              max(rel) <= V1_CPU_RTOL):
            fail(f"book {name}: step costs card {costs[:len(cpu)]} vs CPU {cpu}: rel err "
                 f"{rel} (first <= {CPU_COST_RTOL}, all <= {V1_CPU_RTOL})")
        if r["replays"] + r["graphs"] != BOOK_BATCHES:
            fail(f"book {name}: {r['graphs']} graphs and {r['replays']} replays over "
                 f"{BOOK_BATCHES} steps")
        if name == "recommender_system" and r["graphs"] != 1:
            fail(f"book {name}: {r['graphs']} graphs over {BOOK_BATCHES} steps, want one "
                 f"(every batch's titles pad to the same length)")
        del run, tr
        torch.cuda.empty_cache()
    files = book_files(home)
    if not paddle.dataset.common.SYNTHETIC or files:
        fail(f"book: SYNTHETIC {paddle.dataset.common.SYNTHETIC}, files {files[:5]}")
    return out


def layer_error_phase(torch):
    """A forward error on the card raises LayerError naming the layer (the
    JAX package's layer-name context): a width-5 batch into an Fc made for 8."""
    import numpy as np

    from paddle_tpu_torch.core.stack_trace import LayerError
    from paddle_tpu_torch.nn import graph as G
    from paddle_tpu_torch.nn import layers as L

    G.reset_name_scope()
    net = G.Network([L.Fc(L.Data("x", shape=(8,)), 3, act=None)])
    params = net.init({"x": np.zeros((2, 8), np.float32)}, device="cuda")
    try:
        net.apply(params, {"x": np.zeros((2, 5), np.float32)})
    except LayerError as e:
        result = dict(layer_name=e.layer_name, layer_stack=e.layer_stack, text=str(e)[:200])
    else:
        fail("layer error: a width-5 batch into an 8-wide Fc raised nothing on the card")
    print("layer_error", json.dumps(result), flush=True)
    if result["layer_name"] != "__fc_0__" or not result["text"].startswith(
            "error in layer '__fc_0__' (layer stack: __fc_0__): "):
        fail(f"layer error: {result}")
    return result


V1_PROTO_CONFIG = V1_BIGRU_CONFIG.replace(
    V1_BIGRU_CONFIG[V1_BIGRU_CONFIG.index("define_py_data_sources2("):
                    V1_BIGRU_CONFIG.index("word = data_layer")],
    'TrainData(ProtoData(files="train.list", type="proto_sequence"))\n'
    'TestData(ProtoData(files="test.list", type="proto_sequence"))\n')


def v1_proto_phase(torch, bigru_dir):
    """Phase 29: phase 21's bi-GRU config on TrainData(ProtoData(...,
    type="proto_sequence")): shards the port's write_shard writes of phase
    21's samples, 2 passes through the CLI (GRU counters from 0),
    --job=time; then --job=test of the proto config and of phase 21's
    PyDataProvider2 config from the same pass, batch by batch."""
    import numpy as np

    from paddle_tpu_torch.data import proto_data as pd

    cfg = V1_PROTO
    d = v1_config_dir("proto", V1_PROTO_CONFIG, V1_BIGRU_PROVIDER)
    for split, n, seed in (("train", cfg["batches"] * cfg["batch"], 0),
                           ("test", cfg["test_batches"] * cfg["batch"], 1)):
        # phase 21's provider's draws, in its order
        pd.write_shard(os.path.join(d, f"{split}.bin"),
                       [pd.SlotDef(pd.VECTOR_SPARSE_NON_VALUE, cfg["vocab"]),
                        pd.SlotDef(pd.INDEX, 2)],
                       [pd.DataSample(vector_slots=[pd.VectorSlot(ids=ids)], id_slots=[y])
                        for ids, y in v2_samples(np, cfg, n, seed)])
        with open(os.path.join(d, f"{split}.list"), "w") as f:
            f.write(f"{split}.bin\n")
    save = os.path.join(d, "out")
    steps = cfg["batches"] * cfg["passes"]
    zero_rnn_counts()
    t0 = time.perf_counter()
    rc, lines, costs, job = run_cli(d, ["train", "--config=conf.py",
                                        f"--num_passes={cfg['passes']}", f"--save_dir={save}",
                                        "--log_period=1"])
    train_s = time.perf_counter() - t0
    launches = rnn_counts()
    if rc != 0:
        fail(f"v1 proto: train exited {rc}")
    graphs = list(job.trainer.graphs.values())
    passes = pass_lines(lines)
    tests = cfg["test_batches"] * cfg["passes"]
    result = dict(config=cfg, train_s=train_s, steps=steps, passes=passes,
                  graphs=len(graphs), replays=graphs[0].replays if graphs else 0,
                  kernel_launches=launches)
    if (launches["FWD_LAUNCHES"], launches["BWD_LAUNCHES"]) != (
            2 * (steps + tests + 1), 2 * steps):
        fail(f"v1 proto: GRU launches {launches}, want 2 + 2 a step (and both forwards "
             f"at the init and each of {tests} test batches)")
    if len(graphs) != 1 or result["replays"] != steps - 1:
        fail(f"v1 proto: {len(graphs)} step graphs, {result['replays']} replays in {steps} "
             "steps: want one graph, every step after the first a replay")
    if not passes[1]["avg_cost"] < passes[0]["avg_cost"]:
        fail(f"v1 proto: avg_cost did not fall: {passes}")
    del job
    rc, lines, _, t_job = run_cli(d, ["train", "--config=conf.py", "--job=time",
                                      f"--num_batches={cfg['batches']}"])
    timed = json.loads(lines[-1])
    if rc != 0 or timed.get("batches") != cfg["batches"]:
        fail(f"v1 proto: --job=time exited {rc}: {timed}")
    tokens = sum(int(t_job.feeder(b)["word.lengths"].sum()) for b in t_job.reader())
    result.update(ms_per_step=timed["ms_per_batch"], tokens_per_step=tokens / cfg["batches"],
                  tokens_per_s=tokens / (cfg["batches"] * timed["ms_per_batch"] / 1e3))
    del t_job

    def test_costs(conf_dir):
        rc, lines, _, job = run_cli(conf_dir, [
            "train", "--config=conf.py", "--job=test", f"--init_model_path={save}",
            f"--start_pass={cfg['passes']}", f"--config_args=test_batches={cfg['test_batches']}"],
            echo=False)
        if rc != 0:
            fail(f"v1 proto: --job=test in {conf_dir} exited {rc}")
        tr = job.trainer
        with torch.no_grad():
            return [float(tr._cost(tr.state["params"], job.feeder(b), train=False)[0])
                    for b in job.test_reader()]

    proto_costs, pydp_costs = test_costs(d), test_costs(bigru_dir)
    rel = [abs(a - b) / abs(b) for a, b in zip(proto_costs, pydp_costs)]
    result.update(test_batch_costs_proto=proto_costs, test_batch_costs_pydp2=pydp_costs,
                  test_cost_rel_err=rel)
    print("v1_proto", json.dumps(result), flush=True)
    if len(proto_costs) != cfg["test_batches"] or len(rel) != len(pydp_costs) or (
            max(rel) > PROTO_RTOL):
        fail(f"v1 proto: --job=test batch costs {proto_costs} vs the PyDataProvider2 "
             f"config's {pydp_costs}: rel err {rel} > {PROTO_RTOL}")
    return result


# -- AlexNet and GoogLeNet (phase 32) --------------------------------------------

# benchmarks/image_bench.py's run: 224x224, 1000 classes, batch 128,
# SGD(0.01, momentum 0.9), one batch drawn once (randn images, labels
# randint(0, 10)); 8 steps a (model, precision), the first eager and
# captured, the other 7 replays
IMAGE_MODELS = ("alexnet", "googlenet")
IMAGE = dict(image_size=224, batch=128, classes=1000, lr=0.01, steps=8)
# card against CPU: 64x64, batch 4, 10 classes, f32 (TF32 off); the cost
# within 1e-5, each gradient within IMAGE_GRAD_REL_L2 (GoogLeNet's relus
# sit on ties the summation order decides: tests/test_torch_image_models.py)
IMAGE_CPU = dict(image_size=64, batch=4, classes=10)
IMAGE_GRAD_REL_L2 = {"alexnet": 1e-4, "googlenet": 5e-2}


def image_batch(np, size, b, label_range=10):
    """image_bench.py:39-44's batch: one RandomState(0), randn images,
    randint(0, 10) labels."""
    rs = np.random.RandomState(0)
    return {"image": rs.randn(b, size, size, 3).astype(np.float32),
            "label": rs.randint(0, label_range, b)}


def image_trainer(model, device, precision, size, classes, lr=0.01):
    from paddle_tpu_torch import models
    from paddle_tpu_torch.nn.graph import reset_name_scope
    from paddle_tpu_torch.optim import SGD
    from paddle_tpu_torch.trainer import SGDTrainer

    reset_name_scope()
    cost = getattr(models, model)(num_classes=classes, image_size=size)[3]
    return SGDTrainer(cost, SGD(learning_rate=lr, momentum=0.9), seed=0, device=device,
                      precision=precision)


def conv_fc_macs(torch, trainer, image_size) -> int:
    """Multiply-adds an image of the model's convs and fcs: each conv's
    output pixels x kh x kw x Cin/groups x Cout (the output shapes from a
    forward of one image), each fc's weight size."""
    import numpy as np

    from paddle_tpu_torch.nn.graph import Context

    net, params = trainer.network, trainer.state["params"]
    dev = next(iter(params.values())).device
    one = image_batch(np, image_size, 1)
    ctx = Context("apply", params, device=dev, states=trainer.state["states"], train=False)
    with torch.no_grad():
        values = net._run(ctx, one, dev, keep_all=True)
    macs = 0
    for layer in net.layer_order:
        if layer.type_name == "conv":
            kh, kw, cin_g, cout = params[f"{layer.name}.w"].shape
            oh, ow = values[layer.name].value.shape[1:3]
            macs += oh * ow * kh * kw * cin_g * cout
        elif layer.type_name == "fc":
            macs += sum(p.numel() for k, p in params.items()
                        if k.startswith(f"{layer.name}.w"))
    return int(macs)


def profile_image_step(torch, trainer, batch, label):
    """torch.profiler over 2 replayed steps: busy share, kernels a step, the
    kernel groups of phase 10 (`kernel_group`); fails if layout transposes
    run once a conv or more (the convs must read NHWC as channels_last)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    steps = 2
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            trainer.step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            ms, n = kernels.get(e.key, (0.0, 0))
            kernels[e.key] = (ms + e.self_device_time_total / 1e3, n + e.count)
    busy_ms = sum(ms for ms, _ in kernels.values())
    groups = {}
    for key, (ms, n) in kernels.items():
        g = groups.setdefault(kernel_group(key), [0.0, 0])
        g[0] += ms / steps
        g[1] += n / steps
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
    n_convs = sum(1 for l in trainer.network.layer_order if l.type_name == "conv")
    transposes = groups.get("layout_transpose", [0.0, 0])[1]
    out = {"steps": steps, "wall_ms_per_step": wall_ms / steps,
           "device_busy_ms_per_step": busy_ms / steps, "device_busy_share": busy_ms / wall_ms,
           "kernel_launches_per_step": sum(c for _, c in kernels.values()) / steps,
           "groups_ms_and_launches_per_step": groups,
           "layout_transposes_per_step": transposes, "convs": n_convs,
           "top_kernels_ms_per_step": [[k[:90], ms / steps, c / steps]
                                       for k, (ms, c) in top]}
    print(label, json.dumps(out), flush=True)
    if busy_ms <= 0:
        fail(f"{label}: torch.profiler recorded no device time")
    if transposes >= n_convs:
        fail(f"{label}: {transposes} layout-transpose kernels a step for {n_convs} convs")
    return out


def image_models_phase(torch):
    """Phase 32: AlexNet and GoogLeNet training as image_bench.py drives the
    JAX package (IMAGE), in f32 (TF32 off) and bf16: per (model,
    precision) one eager step and its capture, then replays; ms a step
    (host clock, the median of the replays), the graph's device ms (CUDA
    events), images/s, MFU (3 x 2 x the convs' and fcs' multiply-adds
    over the f32 non-tensor or the dense bf16 peak), peak memory, and
    torch.profiler's busy share and kernels a step. Gates: one graph and
    steps - 1 replays, finite costs that fall on the fixed batch, no
    recurrent kernel launched, fewer layout transposes than convs. Then
    each model's f32 cost and gradients card against CPU (IMAGE_CPU)."""
    import numpy as np

    cfg = IMAGE
    name = torch.cuda.get_device_name(0)
    _, f32_flops, _ = peaks(name)
    batch = image_batch(np, cfg["image_size"], cfg["batch"])
    out = {}
    for model in IMAGE_MODELS:
        for precision in ("f32", "bf16"):
            t0 = time.perf_counter()
            trainer = image_trainer(model, "cuda", precision, cfg["image_size"],
                                    cfg["classes"], cfg["lr"])
            trainer.init_state(batch)
            dev = {k: torch.as_tensor(v).to("cuda") for k, v in batch.items()}
            torch.cuda.synchronize()
            setup_s = time.perf_counter() - t0
            macs = conv_fc_macs(torch, trainer, cfg["image_size"])
            zero_rnn_counts()
            torch.cuda.reset_peak_memory_stats()
            costs, step_ms = timed_calls(torch, lambda: trainer.step(dev), cfg["steps"])
            peak = torch.cuda.max_memory_allocated()
            launches = rnn_counts()
            graphs = list(trainer.graphs.values())
            replays = graphs[0].replays if graphs else 0
            med = statistics.median(step_ms[1:])
            device_ms = device_ms_per_call(torch, lambda: trainer.step(dev), n=3)
            flops = 3 * 2 * macs * cfg["batch"]
            peak_flops = f32_flops if precision == "f32" else bf16_peak(name)
            tag = f"{model}_{precision}"
            r = dict(model=model, precision=trainer.precision, config=cfg,
                     params=sum(p.numel() for p in trainer.state["params"].values()),
                     macs_per_image=macs, train_flops_per_step=flops, setup_s=setup_s,
                     costs=costs, step_ms=step_ms, step_ms_median=med,
                     step_ms_min=min(step_ms[1:]), images_per_s=cfg["batch"] / (med / 1e3),
                     graph_device_ms_per_step=device_ms, busy_share_graph=device_ms / med,
                     mfu=flops / (med / 1e3) / peak_flops, peak_tflops=peak_flops / 1e12,
                     bound_ms_at_peak=flops / peak_flops * 1e3, peak_memory_bytes=peak,
                     graphs=len(graphs), replays=replays, kernel_launches=launches)
            if len(graphs) != 1 or replays != cfg["steps"] - 1:
                fail(f"{tag}: {len(graphs)} step graphs, {replays} replays in "
                     f"{cfg['steps']} steps: want one graph, every later step a replay")
            if not np.isfinite(costs).all() or not costs[-1] < costs[0]:
                fail(f"{tag}: costs {costs}: want finite and falling on the fixed batch")
            if any(launches.values()):
                fail(f"{tag}: launched kernels it does not run: {launches}")
            r["profile"] = profile_image_step(torch, trainer, dev, f"{tag}_profile")
            print("image_model", tag, json.dumps({k: v for k, v in r.items()
                                                  if k != "profile"}), flush=True)
            out[tag] = r
            del trainer, dev, graphs
            torch.cuda.empty_cache()
        out[f"{model}_vs_cpu"] = image_vs_cpu(torch, model)
    return out


def image_vs_cpu(torch, model):
    """The model at IMAGE_CPU in f32 on the card and on the CPU from the
    same parameters: the first step's cost and gradients (same key)."""
    import numpy as np

    cfg = IMAGE_CPU
    batch = image_batch(np, cfg["image_size"], cfg["batch"])
    cpu = image_trainer(model, "cpu", "f32", cfg["image_size"], cfg["classes"])
    card = image_trainer(model, "cuda", "f32", cfg["image_size"], cfg["classes"])
    cpu.init_state(batch)
    card.init_state(batch)
    card.load_params(cpu.state["params"])
    c_cpu, g_cpu = cpu.cost_and_grads(batch)
    c_card, g_card = card.cost_and_grads(batch)
    cost_err = abs(float(c_card) - float(c_cpu)) / abs(float(c_cpu))
    grad_err = {k: rel_l2(torch, g_card[k].cpu(), v) for k, v in g_cpu.items()}
    out = dict(config=cfg, cost_card=float(c_card), cost_cpu=float(c_cpu),
               cost_rel_err=cost_err, grad_rel_l2_max=max(grad_err.values()),
               grad_rel_l2_worst=max(grad_err, key=grad_err.get),
               tolerances=dict(cost=CPU_COST_RTOL, grad=IMAGE_GRAD_REL_L2[model]))
    print("image_vs_cpu", model, json.dumps(out), flush=True)
    if not cost_err <= CPU_COST_RTOL:
        fail(f"{model} card vs CPU: cost {c_card} vs {c_cpu} (rel {cost_err})")
    bad = {k: e for k, e in grad_err.items() if not e <= IMAGE_GRAD_REL_L2[model]}
    if bad:
        fail(f"{model} card vs CPU: gradients beyond {IMAGE_GRAD_REL_L2[model]} relative "
             f"L2: {dict(list(bad.items())[:5])}")
    return out


def dump_equals_parse(conf_dir: str, args: str, name: str) -> dict:
    """`python -m paddle_tpu_torch dump_config` of the config against
    `proto.to_text` of its parse, in the config's directory."""
    from paddle_tpu_torch import proto
    from paddle_tpu_torch.config import parse_config

    rc, lines, _, _ = run_cli(conf_dir, ["dump_config", "--config=conf.py",
                                         f"--config_args={args}"], echo=False)
    cwd = os.getcwd()
    os.chdir(conf_dir)
    sys.path.insert(0, conf_dir)
    try:
        want = proto.to_text(parse_config("conf.py", args).trainer_config)
    finally:
        sys.path.remove(conf_dir)
        os.chdir(cwd)
    got = "\n".join(lines)
    out = dict(rc=rc, dump_lines=len(lines), equal=got == want.rstrip("\n"),
               layers=sum(1 for line in lines if line.strip() == "layers {"))
    if rc != 0 or not out["equal"]:
        fail(f"{name}: dump_config exited {rc}, equal to the parse: {out['equal']}")
    return out


def v1_alexnet_phase(torch):
    """Phase 33: the reference's benchmark AlexNet as a v1 config
    (V1_ALEXNET_CONFIG) at 227x227, batch 128 through `python -m
    paddle_tpu_torch train --config=... --job=time`, in process: ms a
    batch over 8 replays of one graph, images/s, busy share and kernels a
    step; `dump_config` equal to the parse; the first 4 logged costs card
    against CPU at V1_ALEXNET_SMALL."""
    d = v1_config_dir("alexnet", V1_ALEXNET_CONFIG, V1_ALEXNET_PROVIDER)
    args = config_args(V1_ALEXNET)
    result = dict(config=V1_ALEXNET, dump=dump_equals_parse(d, args, "v1 alexnet"))

    def per_step(job, ms):
        return dict(images_per_s=V1_ALEXNET["batch_size"] / (ms / 1e3),
                    graphs=len(job.trainer.graphs))

    timed, job = v1_timed(torch, d, "v1 alexnet", "conv", per_step, V1_ALEXNET["batches"],
                          config_args=args)
    result["time"] = timed
    if any(timed["kernel_launches"].values()):
        fail(f"v1 alexnet: launched kernels it does not run: {timed['kernel_launches']}")
    del job
    torch.cuda.empty_cache()
    result["vs_cpu"] = v1_vs_cpu("v1 alexnet", d, config_args(V1_ALEXNET_SMALL))
    print("v1_alexnet", json.dumps(result), flush=True)
    return result


def v1_vocab_phase(torch):
    """Phase 35: V1_VOCAB_CONFIG (the transposed conv, img_cmrnorm, maxout,
    bilinear_interp, spp, pad, crop, cos_sim, trans, row_conv, prelu,
    scaling, print_layer, selective_fc and `1 + layer_math.exp(x) * z`)
    through `train --config` for 8 steps: one graph of 7 replays, the cost
    falls, print_layer's line once a step (the eager step's and each
    replay's), `dump_config` equal to the parse; ms a step over 5 more
    replays of the last batch; then the first 4 logged costs card against
    CPU at V1_VOCAB_SMALL."""
    import numpy as np

    cfg = V1_VOCAB
    d = v1_config_dir("vocab", V1_VOCAB_CONFIG, V1_VOCAB_PROVIDER)
    args = config_args(cfg)
    result = dict(config=cfg, dump=dump_equals_parse(d, args, "v1 vocab"))
    zero_rnn_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rc, lines, costs, job = run_cli(d, ["train", "--config=conf.py", f"--config_args={args}",
                                        "--num_passes=1", "--log_period=1"], echo=False)
    wall_s = time.perf_counter() - t0
    launches = rnn_counts()
    graphs = list(job.trainer.graphs.values()) if job is not None else []
    prints = [line for line in lines if line.startswith("gate [[")]
    result.update(rc=rc, step_costs=costs, graphs=len(graphs),
                  replays=graphs[0].replays if graphs else 0, print_lines=len(prints),
                  first_print=prints[0][:60] if prints else None, wall_s=wall_s,
                  peak_memory_bytes=torch.cuda.max_memory_allocated(),
                  kernel_launches=launches)
    if rc != 0:
        fail(f"v1 vocab: train exited {rc}")
    if len(graphs) != 1 or result["replays"] != cfg["batches"] - 1:
        fail(f"v1 vocab: {len(graphs)} graphs, {result['replays']} replays over "
             f"{cfg['batches']} steps: want one graph, every later step a replay")
    if len(costs) != cfg["batches"] or not np.isfinite(costs).all() or not costs[-1] < costs[0]:
        fail(f"v1 vocab: step costs {costs}: want {cfg['batches']}, finite, falling")
    if len(prints) != cfg["batches"]:
        fail(f"v1 vocab: print_layer printed {len(prints)} times over {cfg['batches']} "
             f"steps, want once a step")
    if any(launches.values()):
        fail(f"v1 vocab: launched kernels it does not run: {launches}")
    # the last batch again through the graph: ms a step (each replay prints)
    batch = {k: v.cpu().numpy() for k, v in graphs[0].inputs.items()}
    _, step_ms = timed_calls(torch, lambda: job.trainer.step(batch), 5)
    result.update(ms_per_step_median=statistics.median(step_ms), step_ms=step_ms)
    del job, graphs
    result["vs_cpu"] = v1_vs_cpu("v1 vocab", d, config_args(V1_VOCAB_SMALL))
    print("v1_vocab", json.dumps(result), flush=True)
    return result


# -- AlexNet as a v1 config (phase 33) and a v1 config of the new helpers
# (phase 35) ------------------------------------------------------------------

V1_ALEXNET_PROVIDER = """
import numpy as np
from paddle.trainer.PyDataProvider2 import *


def hook(settings, height, width, num_class, samples, **kwargs):
    settings.shape, settings.num_class = (3, height, width), num_class
    settings.samples = samples
    settings.input_types = {"data": dense_vector(3 * height * width),
                            "label": integer_value(num_class)}


@provider(init_hook=hook, should_shuffle=False)
def process(settings, filename):
    # images and labels drawn as benchmarks/image_bench.py draws them
    rs = np.random.RandomState(0)
    size = int(np.prod(settings.shape))
    for _ in range(settings.samples):
        yield {"data": rs.randn(size).astype("float32"),
               "label": int(rs.randint(settings.num_class))}
"""

# benchmark/paddle/image/alexnet.py's layout (the JAX package's
# models/alexnet.py docstring names it): 227x227x3, conv 96/256/384/384/256,
# cross-map norms after conv1 and conv2, 3x3/2 max pools, two 4096 fcs with
# drop_rate 0.5, momentum with the per-sample rate and L2
V1_ALEXNET_CONFIG = """
from paddle.trainer_config_helpers import *

height = get_config_arg("height", int, 227)
width = get_config_arg("width", int, 227)
num_class = get_config_arg("num_class", int, 1000)
batch_size = get_config_arg("batch_size", int, 128)
batches = get_config_arg("batches", int, 8)
fc_dim = get_config_arg("fc_dim", int, 4096)
gp = get_config_arg("layer_num", int, 1)
define_py_data_sources2(
    "train.list", None, module="v1_alexnet_provider", obj="process",
    args={"height": height, "width": width, "num_class": num_class,
          "samples": batches * batch_size})
settings(batch_size=batch_size, learning_rate=0.01 / batch_size,
         learning_method=MomentumOptimizer(0.9),
         regularization=L2Regularization(0.0005 * batch_size))

# conv1
net = data_layer("data", size=height * width * 3, height=height, width=width)
net = img_conv_layer(input=net, filter_size=11, num_channels=3, num_filters=96,
                     stride=4, padding=1)
net = img_cmrnorm_layer(input=net, size=5, scale=0.0001, power=0.75)
net = img_pool_layer(input=net, pool_size=3, stride=2)
# conv2
net = img_conv_layer(input=net, filter_size=5, num_filters=256, stride=1, padding=2,
                     groups=gp)
net = img_cmrnorm_layer(input=net, size=5, scale=0.0001, power=0.75)
net = img_pool_layer(input=net, pool_size=3, stride=2)
# conv3, conv4, conv5
net = img_conv_layer(input=net, filter_size=3, num_filters=384, stride=1, padding=1)
net = img_conv_layer(input=net, filter_size=3, num_filters=384, stride=1, padding=1,
                     groups=gp)
net = img_conv_layer(input=net, filter_size=3, num_filters=256, stride=1, padding=1,
                     groups=gp)
net = img_pool_layer(input=net, pool_size=3, stride=2)
net = fc_layer(input=net, size=fc_dim, act=ReluActivation(),
               layer_attr=ExtraAttr(drop_rate=0.5))
net = fc_layer(input=net, size=fc_dim, act=ReluActivation(),
               layer_attr=ExtraAttr(drop_rate=0.5))
net = fc_layer(input=net, size=num_class, act=SoftmaxActivation())
lab = data_layer("label", num_class)
outputs(cross_entropy(input=net, label=lab))
"""

V1_VOCAB_PROVIDER = """
import numpy as np
from paddle.trainer.PyDataProvider2 import *


def hook(settings, side, vocab, samples, **kwargs):
    settings.side, settings.vocab, settings.samples = side, vocab, samples
    settings.input_types = {"image": dense_vector(3 * side * side), "x": dense_vector(16),
                            "w": dense_vector(1), "word": integer_value_sequence(vocab),
                            "label": integer_value(4)}


@provider(init_hook=hook, should_shuffle=False)
def process(settings, filename):
    rs = np.random.RandomState(0)
    for _ in range(settings.samples):
        x = rs.randn(16).astype("float32")
        label = int(np.argmax(x[:4]))  # learnable from x alone
        yield {"image": rs.rand(3 * settings.side ** 2).astype("float32"), "x": x,
               "w": rs.uniform(0.5, 1.5, 1).astype("float32"),
               "word": rs.randint(0, settings.vocab, rs.randint(3, 9)).tolist(),
               "label": label}
"""

# the v1 DSL over the new layers: the transposed conv, img_cmrnorm, maxout,
# bilinear_interp, spp, pad, crop, cos_sim, trans, row_conv, prelu,
# scaling, print_layer and selective_fc, and layer_math's arithmetic
# (`1 + layer_math.exp(x) * z` builds scaling and slope_intercept)
V1_VOCAB_CONFIG = """
from paddle.trainer_config_helpers import *

side = get_config_arg("side", int, 16)
vocab = get_config_arg("vocab", int, 50)
batch = get_config_arg("batch", int, 64)
batches = get_config_arg("batches", int, 8)
settings(batch_size=batch, learning_rate=1e-2, learning_method=AdamOptimizer())
define_py_data_sources2(
    train_list="train.list", test_list=None, module="v1_vocab_provider", obj="process",
    args={"side": side, "vocab": vocab, "samples": batches * batch})
img = data_layer(name="image", size=3 * side * side, height=side, width=side)
x = data_layer(name="x", size=16)
w = data_layer(name="w", size=1)
word = data_layer(name="word", size=vocab)
label = data_layer(name="label", size=4)

conv = img_conv_layer(input=img, filter_size=3, num_filters=8, num_channels=3, padding=1)
norm = img_cmrnorm_layer(input=conv, size=5)
mo = maxout_layer(input=norm, groups=2)
up = img_conv_layer(input=mo, filter_size=2, num_filters=4, stride=2, trans=True)
down = bilinear_interp_layer(input=up, out_size_x=side, out_size_y=side)
pyramid = spp_layer(input=down, pyramid_height=2)
padded = pad_layer(input=mo, pad_h=[1, 1], pad_w=[1, 1])
cropped = crop_layer(input=padded, offset=[1, 1], shape=[side, side])
f_img = fc_layer(input=[pyramid, cropped], size=16, act=TanhActivation())
h = fc_layer(input=x, size=16, act=TanhActivation())
cos = cos_sim(a=f_img, b=h, scale=5)
gate = print_layer(input=1 + layer_math.exp(cos) * w, format="gate")
flipped = trans_layer(input=h, height=4)
seq = row_conv_layer(input=embedding_layer(input=word, size=8), context_len=3,
                     act=TanhActivation())
pooled = pooling_layer(input=seq, pooling_type=AvgPooling())
feat = concat_layer(input=[flipped, pooled, f_img, h])
act = prelu_layer(input=fc_layer(input=feat, size=16, act=LinearActivation()))
scaled = scaling_layer(input=act, weight=gate)
out = selective_fc_layer(input=scaled, size=4, act=SoftmaxActivation())
outputs(classification_cost(input=out, label=label))
"""
def config_args(cfg: dict) -> str:
    """A config's --config_args from a dict of its get_config_arg values."""
    return ",".join(f"{k}={v}" for k, v in cfg.items())


V1_VOCAB = dict(side=16, vocab=50, batch=64, batches=8)
V1_VOCAB_SMALL = dict(side=8, vocab=20, batch=8, batches=4)
V1_ALEXNET = dict(batch_size=128, batches=8)
# phase 33's card-vs-CPU check: AlexNet's v1 layout at 67x67 (conv5 3x3),
# fc 64, 10 classes, batch 4
V1_ALEXNET_SMALL = dict(height=67, width=67, num_class=10, batch_size=4, batches=4,
                        fc_dim=64)


# -- the v1 layer vocabulary (phase 34; tests/test_torch_layers_vocab.py) ------

# The 36 layers ROADMAP §1 items 6a-6b port, at small shapes, each
# name -> (inputs, build). An input is (kind, shape[, high]): "x" randn,
# "pos" U(0.5, 1.5), "prob" rows of a softmax, "sel" 0/1 with a 1 in every
# row, "ids" integers in [0, high), "seq" a randn [B, T, D] sequence with
# ragged lengths. build(L, P, ins, name) makes the layer from a package's
# `nn.layers` and `nn.projections` modules over Data layers `ins`.
VOCAB_CASES = {
    "conv_transpose": ([("x", (3, 5, 6, 4))], lambda L, P, i, n: L.Conv2DTranspose(
        i[0], 3, 3, stride=2, padding=1, name=n)),
    "conv_transpose_s1p0": ([("x", (3, 4, 5, 4))], lambda L, P, i, n: L.Conv2DTranspose(
        i[0], 3, (3, 2), stride=1, padding=0, act="tanh", name=n)),
    "conv_transpose_s2p0": ([("x", (3, 4, 5, 4))], lambda L, P, i, n: L.Conv2DTranspose(
        i[0], 3, 3, stride=2, padding=0, name=n)),
    "conv_transpose_s1p1": ([("x", (3, 4, 5, 4))], lambda L, P, i, n: L.Conv2DTranspose(
        i[0], 3, 3, stride=1, padding=1, name=n)),
    "lrn": ([("x", (3, 4, 5, 7))], lambda L, P, i, n: L.CrossMapNorm(
        i[0], size=5, scale=0.5, power=0.75, name=n)),
    "maxout": ([("x", (3, 4, 4, 6))], lambda L, P, i, n: L.Maxout(i[0], 3, name=n)),
    "spp": ([("x", (3, 5, 6, 4))], lambda L, P, i, n: L.SpatialPyramidPool(
        i[0], 3, "max", name=n)),
    "spp_avg": ([("x", (3, 5, 6, 4))], lambda L, P, i, n: L.SpatialPyramidPool(
        i[0], 2, "avg", name=n)),
    "bilinear_interp": ([("x", (3, 4, 5, 2))], lambda L, P, i, n: L.BilinearInterp(
        i[0], (7, 9), name=n)),
    "bilinear_interp_down": ([("x", (3, 8, 7, 2))], lambda L, P, i, n: L.BilinearInterp(
        i[0], (3, 4), name=n)),
    "pad": ([("x", (3, 4, 5, 2))], lambda L, P, i, n: L.Pad(
        i[0], pad_h=(1, 2), pad_w=(0, 1), pad_c=(1, 0), name=n)),
    "crop": ([("x", (3, 5, 6, 2))], lambda L, P, i, n: L.Crop(i[0], 1, 2, 3, 3, name=n)),
    "rotate": ([("x", (3, 4, 5, 2))], lambda L, P, i, n: L.Rotate(i[0], name=n)),
    "feature_map_expand": ([("x", (3, 4))], lambda L, P, i, n: L.FeatureMapExpand(
        i[0], 3, act="tanh", name=n)),
    "feature_map_expand_elems": ([("x", (3, 4))], lambda L, P, i, n: L.FeatureMapExpand(
        i[0], 3, as_row_vector=False, name=n)),
    "cross_channel_norm": ([("x", (3, 4, 5, 6))], lambda L, P, i, n: L.CrossChannelNorm(
        i[0], name=n)),
    "prelu": ([("x", (3, 8))], lambda L, P, i, n: L.ParameterRelu(
        i[0], partial_sum=2, name=n)),
    "scaling": ([("x", (3, 1)), ("x", (3, 5))], lambda L, P, i, n: L.Scaling(
        i[0], i[1], name=n)),
    "slope_intercept": ([("x", (3, 5))], lambda L, P, i, n: L.SlopeIntercept(
        i[0], slope=2.0, intercept=0.5, name=n)),
    "interpolation": ([("x", (3, 1)), ("x", (3, 5)), ("x", (3, 5))],
                      lambda L, P, i, n: L.Interpolation(i[0], i[1], i[2], name=n)),
    "power": ([("x", (3, 1)), ("pos", (3, 5))], lambda L, P, i, n: L.Power(
        i[0], i[1], name=n)),
    "dot_prod": ([("x", (3, 6)), ("x", (3, 6))], lambda L, P, i, n: L.DotProd(
        i[0], i[1], name=n)),
    "cos_sim": ([("x", (3, 6)), ("x", (3, 6))], lambda L, P, i, n: L.CosSim(
        i[0], i[1], scale=5.0, name=n)),
    "convex_comb": ([("x", (3, 4)), ("x", (3, 12))], lambda L, P, i, n: L.LinearComb(
        i[0], i[1], size=3, name=n)),
    "cos_vm": ([("x", (3, 4)), ("x", (3, 12))], lambda L, P, i, n: L.CosSimVecMat(
        i[0], i[1], size=3, scale=2.0, name=n)),
    "concat2": ([("x", (3, 5)), ("x", (3, 3))], lambda L, P, i, n: L.Concat2(
        [P.FullMatrix(i[0], size=4), P.Identity(i[1])], act="tanh", bias=True, name=n)),
    "trans": ([("x", (3, 6))], lambda L, P, i, n: L.Trans(i[0], 2, name=n)),
    "trans_batch": ([("x", (3, 6))], lambda L, P, i, n: L.Trans(i[0], name=n)),
    "row_l2_norm": ([("x", (3, 6))], lambda L, P, i, n: L.RowL2Norm(i[0], name=n)),
    "data_norm": ([("x", (3, 6))], lambda L, P, i, n: L.DataNorm(i[0], name=n)),
    "data_norm_min_max": ([("x", (3, 6))], lambda L, P, i, n: L.DataNorm(
        i[0], "min-max", name=n)),
    "data_norm_decimal": ([("x", (3, 6))], lambda L, P, i, n: L.DataNorm(
        i[0], "decimal-scaling", name=n)),
    "resize": ([("x", (3, 8))], lambda L, P, i, n: L.Resize(i[0], 4, name=n)),
    "clip": ([("x", (3, 8))], lambda L, P, i, n: L.Clip(i[0], -0.5, 0.5, name=n)),
    "scale_shift": ([("x", (3, 5))], lambda L, P, i, n: L.ScaleShift(i[0], name=n)),
    "multiplex": ([("ids", (3,), 3), ("x", (3, 5)), ("x", (3, 5)), ("x", (3, 5))],
                  lambda L, P, i, n: L.Multiplex(i[0], i[1:], name=n)),
    "outer_prod": ([("x", (3, 4)), ("x", (3, 3))], lambda L, P, i, n: L.OuterProd(
        i[0], i[1], name=n)),
    "conv_shift": ([("x", (3, 7)), ("x", (3, 3))], lambda L, P, i, n: L.ConvShift(
        i[0], i[1], name=n)),
    "sum_to_one_norm": ([("pos", (3, 5))], lambda L, P, i, n: L.SumToOneNorm(
        i[0], name=n)),
    "tensor": ([("x", (3, 4)), ("x", (3, 5))], lambda L, P, i, n: L.TensorLayer(
        i[0], i[1], 3, act="tanh", name=n)),
    "selective_fc": ([("x", (3, 6)), ("sel", (3, 5))], lambda L, P, i, n: L.SelectiveFc(
        [i[0], i[1]], 5, act="softmax", name=n)),
    "selective_fc_all": ([("x", (3, 6))], lambda L, P, i, n: L.SelectiveFc(
        i[0], 5, act="tanh", name=n)),
    "row_conv": ([("seq", (3, 6, 4))], lambda L, P, i, n: L.RowConv(
        i[0], 3, act="tanh", name=n)),
    "sampling_id": ([("prob", (3, 7))], lambda L, P, i, n: L.SamplingId(i[0], name=n)),
    "eos_id": ([("ids", (3, 5), 4)], lambda L, P, i, n: L.EosIdCheck(i[0], 2, name=n)),
    "print": ([("x", (3, 4))], lambda L, P, i, n: L.PrintLayer(
        i[0], message="vocab print", name=n)),
}
# the 36 layers of ROADMAP §1 items 6a-6b, one case a layer (the others are
# further shapes and options of the same layers)
VOCAB_LAYERS = (
    "conv_transpose", "lrn", "maxout", "spp", "bilinear_interp", "pad", "crop", "rotate",
    "feature_map_expand", "cross_channel_norm", "prelu", "scaling", "slope_intercept",
    "interpolation", "power", "dot_prod", "cos_sim", "convex_comb", "cos_vm", "concat2",
    "trans", "row_l2_norm", "data_norm", "resize", "clip", "scale_shift", "multiplex",
    "outer_prod", "conv_shift", "sum_to_one_norm", "tensor", "selective_fc", "row_conv",
    "sampling_id", "eos_id", "print")
VOCAB_RNG_SEED = 5
VOCAB_CARD_RTOL = 1e-5


def vocab_inputs(np, name, seed=0):
    """A case's inputs drawn from RandomState(seed): [(value, lengths or
    None)], float32 values (ids int32)."""
    rs = np.random.RandomState(seed)
    out = []
    for spec in VOCAB_CASES[name][0]:
        kind, shape = spec[0], spec[1]
        lengths = None
        if kind == "x":
            v = rs.randn(*shape)
        elif kind == "pos":
            v = rs.uniform(0.5, 1.5, shape)
        elif kind == "prob":
            e = np.exp(rs.randn(*shape))
            v = e / e.sum(-1, keepdims=True)
        elif kind == "sel":
            v = (rs.rand(*shape) < 0.5).astype(np.float32)
            v[np.arange(shape[0]), rs.randint(0, shape[1], shape[0])] = 1.0
        elif kind == "ids":
            v = rs.randint(0, spec[2], shape).astype(np.int32)
        else:  # "seq"
            v = rs.randn(*shape)
            lengths = np.array([shape[1]] + list(rs.randint(1, shape[1] + 1, shape[0] - 1)),
                               np.int32)
        out.append((v.astype(np.float32) if v.dtype != np.int32 else v, lengths))
    return out


def vocab_states(np, states, seed=1):
    """Random statistics for DataNorm's states (its `min` below its `max`)."""
    rs = np.random.RandomState(seed)
    return {k: (rs.uniform(-1.0, 0.0, np.shape(v)) if k.endswith(".min")
                else rs.uniform(0.5, 1.5, np.shape(v))).astype(np.float32)
            for k, v in states.items()}


def vocab_build(name, L, P, Data):
    """The case's layer named `name` over Data layers `in0`, `in1`, ..."""
    specs, build = VOCAB_CASES[name]
    ins = [Data(f"in{j}", shape=s[1][1:], is_seq=s[0] == "seq") for j, s in enumerate(specs)]
    return build(L, P, ins, name)


def vocab_port_run(torch, name, device, inputs, ct=None, params=None, states=None,
                   policy="f32"):
    """The port's layer `name` on `device`: init mode (without `params`) makes
    its parameters and states on the CPU; then the forward in train mode
    over `inputs` and, given a cotangent `ct`, the gradients of the float
    inputs and the parameters -> dict(out, dx, dp, params, states)."""
    from paddle_tpu_torch.core import dtypes, prng
    from paddle_tpu_torch.nn import graph as G
    from paddle_tpu_torch.nn import layers as L
    from paddle_tpu_torch.nn import projections as P

    dev = torch.device(device)
    pol = dtypes.get(policy)
    layer = vocab_build(name, L, P, L.Data)
    xs = []
    for v, lengths in inputs:
        t = torch.as_tensor(v).to(dev)
        if t.is_floating_point():
            t = t.to(pol.compute_dtype).requires_grad_(ct is not None)
        xs.append((t, None if lengths is None else torch.as_tensor(lengths).to(dev)))
    args = [G.Argument(t, lengths) for t, lengths in xs]
    if params is None:
        ctx = G.Context("init", {}, device=torch.device("cpu"), train=True,
                        rng=prng.PRNGKey(VOCAB_RNG_SEED))
        with torch.no_grad():
            layer.forward(ctx, [G.Argument(t.detach().cpu(), None if n is None else n.cpu())
                                for t, n in xs])
        params, states = ctx.params, ctx.states
    params = {k: v.to(dev).clone().requires_grad_(ct is not None) for k, v in params.items()}
    states = {k: torch.as_tensor(v).to(dev) for k, v in (states or {}).items()}
    ctx = G.Context("apply", params, device=dev, states=states, train=True, policy=pol,
                    rng=prng.PRNGKey(VOCAB_RNG_SEED, dev))
    with dtypes.policy_scope(pol):
        out = layer.forward(ctx, args).value
    res = dict(out=out.detach(), dx=[], dp={}, params=params, states=states)
    if ct is not None and out.is_floating_point():
        floats = [t for t, _ in xs if t.is_floating_point()]
        wrt = floats + list(params.values())
        if wrt:
            grads = torch.autograd.grad(out, wrt, torch.as_tensor(ct).to(dev, out.dtype),
                                        allow_unused=True)
            res["dx"] = [g for g in grads[:len(floats)]]
            res["dp"] = dict(zip(params, grads[len(floats):]))
    return res


def vocab_phase(torch):
    """Phase 34: each of the 36 layers of the v1 vocabulary (VOCAB_CASES,
    with the further shapes and options) forward and backward on the card
    against the port's CPU result from the same parameters, states and
    inputs, f32 with TF32 off: output, input and parameter gradients
    within VOCAB_CARD_RTOL relative L2; SamplingId's ids and EosIdCheck's
    flags equal."""
    import numpy as np

    worst, rows = 0.0, {}
    for name in VOCAB_CASES:
        inputs = vocab_inputs(np, name)
        cpu0 = vocab_port_run(torch, name, "cpu", inputs)
        states = {k: torch.as_tensor(v) for k, v in vocab_states(np, cpu0["states"]).items()}
        params = {k: v.detach() for k, v in cpu0["params"].items()}
        out_shape = tuple(cpu0["out"].shape)
        ct = np.random.RandomState(2).randn(*out_shape).astype(np.float32)
        cpu = vocab_port_run(torch, name, "cpu", inputs, ct, params, states)
        card = vocab_port_run(torch, name, "cuda", inputs, ct, params, states)
        errs = {"out": rel_l2(torch, card["out"].float(), cpu["out"].float())}
        for j, (g, w) in enumerate(zip(card["dx"], cpu["dx"])):
            if w is not None:
                errs[f"dx{j}"] = rel_l2(torch, g, w)
        for k, w in cpu["dp"].items():
            if w is not None:
                errs[k] = rel_l2(torch, card["dp"][k], w)
        exact = not cpu["out"].is_floating_point() or name == "eos_id"
        if exact and not torch.equal(card["out"].cpu(), cpu["out"]):
            fail(f"vocab {name}: card {card['out'].tolist()} != CPU {cpu['out'].tolist()}")
        rows[name] = dict(shape=list(out_shape), max_rel_l2=max(errs.values()),
                          worst=max(errs, key=errs.get), checked=len(errs))
        worst = max(worst, rows[name]["max_rel_l2"])
        if not rows[name]["max_rel_l2"] <= VOCAB_CARD_RTOL:
            fail(f"vocab {name}: card vs CPU {errs} (relative L2, want <= "
                 f"{VOCAB_CARD_RTOL})")
    out = dict(cases=len(rows), layers=len(VOCAB_LAYERS), max_rel_l2=worst,
               tolerance=VOCAB_CARD_RTOL, rows=rows)
    print("vocab", json.dumps(out), flush=True)
    return out


def fluid_digits_program(fluid, lr=None):
    """Phase 36's program, built with a fluid package's layers API (either
    package's: tests/test_torch_fluid.py builds it in both): recognize_digits'
    conv net, reshaped before its fc as tests/test_fluid.py:92 does."""
    import numpy as np

    L = fluid.layers
    fluid.reset_default_program()
    img = L.data("img", shape=[1, 28, 28])
    label = L.data("label", shape=[1], dtype=np.int64)
    p1 = L.pool2d(L.conv2d(img, 20, 5, act="relu"), 2, pool_stride=2)
    p2 = L.pool2d(L.conv2d(p1, 50, 5, act="relu"), 2, pool_stride=2)
    pred = L.fc(L.reshape(p2, [-1, 50 * 4 * 4]), 10, act="softmax")
    loss = L.mean(L.cross_entropy(pred, label))
    acc = L.accuracy(pred, label)
    fluid.optimizer.AdamOptimizer(lr or FLUID_DIGITS["lr"]).minimize(loss)
    return fluid.default_main_program(), [loss.name, acc.name]


def fluid_digits_feeds(np, runs, batch):
    """`runs` feeds of `batch` mnist.train() records (synthetic: nothing is
    cached under the fresh DATA_HOME)."""
    from paddle_tpu_torch.data.datasets import mnist

    book_data_home()
    recs = list(itertools.islice(mnist.train()(), runs * batch))
    if len(recs) < runs * batch:
        fail(f"fluid digits: mnist.train() gave {len(recs)} records")
    feeds = []
    for i in range(runs):
        part = recs[i * batch:(i + 1) * batch]
        feeds.append({"img": np.stack([r[0] for r in part]).reshape(batch, 1, 28, 28),
                      "label": np.asarray([[r[1]] for r in part], np.int64)})
    return feeds


def fluid_lstm_program(fluid, cfg):
    """Phase 37's program: the LSTM text classifier of
    tests/test_fluid_control_flow.py:487-546 at cfg's widths (uniform
    initial ranges of 1/sqrt(fan-in) past the embedding)."""
    import numpy as np

    fluid.reset_default_program()
    t, vocab, emb_d, hid = cfg["seq_len"], cfg["vocab"], cfg["embed"], cfg["hidden"]
    prog = fluid.default_main_program()
    block = prog.global_block()
    block.create_var("ids", shape=[t], dtype=np.int64, is_data=True)
    block.create_var("lengths", shape=[], dtype=np.int32, is_data=True)
    block.create_var("label", shape=[1], dtype=np.int64, is_data=True)

    def param(name, shape, bound):
        return block.create_parameter(name, shape=shape, initializer=("uniform", -bound, bound))

    emb_w = param("emb.w", [vocab, emb_d], 0.1)
    block.append_op("lookup_table", {"W": emb_w, "Ids": "ids"}, {"Out": "emb"}, {})
    proj_w = param("proj.w", [emb_d, 4 * hid], emb_d ** -0.5)
    block.append_op("mul", {"X": "emb", "Y": proj_w}, {"Out": "proj"}, {"x_num_col_dims": 2})
    lstm_w = param("lstm.w", [hid, 4 * hid], hid ** -0.5)
    lstm_b = block.create_parameter("lstm.b", shape=[4 * hid], initializer=("constant", 0.0))
    block.append_op("lstm", {"Input": "proj", "Weight": lstm_w, "Bias": lstm_b,
                             "SeqLengths": "lengths"},
                    {"Hidden": "hidden", "Cell": "cell", "LastH": "last_h"}, {})
    fc_w = param("fc.w", [hid, cfg["classes"]], hid ** -0.5)
    block.append_op("mul", {"X": "last_h", "Y": fc_w}, {"Out": "logits"}, {})
    block.append_op("softmax", {"X": "logits"}, {"Y": "probs"}, {})
    block.append_op("cross_entropy", {"X": "probs", "Label": "label"}, {"Y": "xent"}, {})
    loss = block.create_var("loss", shape=[])
    block.append_op("mean", {"X": "xent"}, {"Out": loss}, {})
    fluid.optimizer.AdamOptimizer(learning_rate=cfg["lr"]).minimize(loss)
    return prog, ["loss"]


def fluid_lstm_feed(np, cfg, b, seed=0):
    """A batch drawn as benchmarks/rnn_bench.py:31-36 draws its ids and
    labels, lengths in [min_len, seq_len] (the first row full)."""
    rs = np.random.RandomState(seed)
    t = cfg["seq_len"]
    lengths = rs.randint(cfg["min_len"], t + 1, b).astype(np.int32)
    lengths[0] = t
    return {"ids": rs.randint(0, cfg["vocab"], (b, t)).astype(np.int64), "lengths": lengths,
            "label": rs.randint(0, cfg["classes"], (b, 1)).astype(np.int64)}


def fluid_gru_program(fluid, cfg):
    """A recurrent op over gru_unit (x_t @ W_in, then the GRU cell on
    h_pre), its last state through an fc, softmax and cross_entropy,
    trained with SGD."""
    import numpy as np

    fluid.reset_default_program()
    d, h = cfg["d"], cfg["h"]
    prog = fluid.default_main_program()
    block = prog.global_block()
    block.create_var("x_seq", shape=[cfg["t"], d], is_data=True)
    block.create_var("h0", shape=[h], is_data=True)
    block.create_var("label", shape=[1], dtype=np.int64, is_data=True)
    w_in = block.create_parameter("w_in", shape=[d, 3 * h],
                                  initializer=("uniform", -d ** -0.5, d ** -0.5))
    u = block.create_parameter("gru.w", shape=[h, 3 * h],
                               initializer=("uniform", -h ** -0.5, h ** -0.5))
    bias = block.create_parameter("gru.b", shape=[1, 3 * h], initializer=("constant", 0.0))
    fc_w = block.create_parameter("fc.w", shape=[h, cfg["classes"]],
                                  initializer=("uniform", -h ** -0.5, h ** -0.5))
    sub = prog.create_block()
    sub.append_op("mul", {"X": "x_t", "Y": w_in}, {"Out": "xp"}, {})
    sub.append_op("gru_unit", {"Input": "xp", "HiddenPrev": "h_pre", "Weight": u,
                               "Bias": bias}, {"Hidden": "h_new"}, {})
    prog.rollback()
    block.desc.ops.append(fluid.framework.OpDesc(
        type="recurrent", attrs={"sub_block": sub.idx, "seq_ins": {"x_t": "x_seq"},
                                 "states": {"h_pre": ("h0", "h_new")},
                                 "seq_outs": {"h_seq": "h_new"}, "name": "gru"}))
    block.append_op("mul", {"X": "gru.h_new@LAST", "Y": fc_w}, {"Out": "logits"}, {})
    block.append_op("softmax", {"X": "logits"}, {"Y": "probs"}, {})
    block.append_op("cross_entropy", {"X": "probs", "Label": "label"}, {"Y": "xent"}, {})
    loss = block.create_var("loss", shape=[])
    block.append_op("mean", {"X": "xent"}, {"Out": loss}, {})
    fluid.optimizer.SGDOptimizer(learning_rate=cfg["lr"]).minimize(loss)
    return prog, ["loss", "h_seq"]


def fluid_gru_feed(np, cfg, seed=0):
    rs = np.random.RandomState(seed)
    b = cfg["b"]
    return {"x_seq": rs.randn(b, cfg["t"], cfg["d"]).astype(np.float32),
            "h0": np.zeros((b, cfg["h"]), np.float32),
            "label": rs.randint(0, cfg["classes"], (b, 1)).astype(np.int64)}


def fluid_while_program(fluid):
    """The counter of tests/test_fluid_control_flow.py:107: v doubles until
    c reaches n (a `while` op: its trip count is a device value)."""
    fluid.reset_default_program()
    prog = fluid.default_main_program()
    block = prog.global_block()
    for name, shape in (("v", [4]), ("c", []), ("n", [])):
        block.create_var(name, shape=shape, is_data=True)
    block.create_var("keep_going", shape=[])
    block.append_op("less_than", {"X": "c", "Y": "n"}, {"Out": "keep_going"}, {})
    sub = prog.create_block()
    sub.append_op("scale", {"X": "v"}, {"Out": "v"}, {"scale": 2.0})
    sub.append_op("increment", {"X": "c"}, {"Out": "c"}, {"step": 1.0})
    sub.append_op("less_than", {"X": "c", "Y": "n"}, {"Out": "keep_going"}, {})
    prog.rollback()
    block.desc.ops.append(fluid.framework.OpDesc(
        type="while", attrs={"sub_block": sub.idx, "cond": "keep_going", "carry": ["v", "c"]}))
    return prog, ["v", "c"]


def fluid_cond_program(fluid, per_sample: bool):
    """cond over a [B, D] input: the true block scales by 10 then applies
    dropout, the false block negates; a scalar flag picks one, a [B] flag
    picks rows."""
    fluid.reset_default_program()
    prog = fluid.default_main_program()
    block = prog.global_block()
    block.create_var("flag", shape=[FLUID_COND["b"]] if per_sample else [], is_data=True)
    block.create_var("x", shape=[FLUID_COND["d"]], is_data=True)
    true_b = prog.create_block()
    true_b.append_op("scale", {"X": "x"}, {"Out": "t"}, {"scale": 10.0})
    true_b.append_op("dropout", {"X": "t"}, {"Out": "out"}, {"dropout_prob": 0.25})
    prog.rollback()
    false_b = prog.create_block()
    false_b.append_op("scale", {"X": "x"}, {"Out": "out"}, {"scale": -1.0})
    prog.rollback()
    block.desc.ops.append(fluid.framework.OpDesc(
        type="cond", attrs={"cond": "flag", "true_block": true_b.idx,
                            "false_block": false_b.idx, "outs": ["out"]}))
    return prog, ["out"]


def fluid_beam_program(fluid, cfg):
    """beam_search over `steps` steps of a toy decoder (lookup_table of the
    previous ids, tanh(emb @ W_h + state), a V-wide softmax; the state
    follows the chosen parents through `gather`), then
    beam_search_decode."""
    fluid.reset_default_program()
    bk, v, e = cfg["b"] * cfg["k"], cfg["v"], cfg["emb"]
    prog = fluid.default_main_program()
    block = prog.global_block()
    block.create_var("pre_ids", shape=[1], is_data=True)
    block.create_var("pre_scores", shape=[1], is_data=True)
    block.create_var("state", shape=[e], is_data=True)
    emb = block.create_parameter("dec.emb", shape=[v, e], initializer=("uniform", -1.0, 1.0))
    w_h = block.create_parameter("dec.w_h", shape=[e, e],
                                 initializer=("uniform", -e ** -0.5, e ** -0.5))
    w_out = block.create_parameter("dec.w_out", shape=[e, v], initializer=("normal", 0.0, 1.0))
    ids, scores, state = "pre_ids", "pre_scores", "state"
    for t in range(cfg["steps"]):
        block.append_op("lookup_table", {"W": emb, "Ids": ids}, {"Out": f"e{t}"}, {})
        block.append_op("mul", {"X": f"e{t}", "Y": w_h}, {"Out": f"s{t}"}, {})
        block.append_op("elementwise_add", {"X": f"s{t}", "Y": state}, {"Out": f"a{t}"}, {})
        block.append_op("tanh", {"X": f"a{t}"}, {"Y": f"h{t}"}, {})
        block.append_op("mul", {"X": f"h{t}", "Y": w_out}, {"Out": f"logits{t}"}, {})
        block.append_op("softmax", {"X": f"logits{t}"}, {"Y": f"probs{t}"}, {})
        block.append_op("beam_search", {"pre_ids": ids, "pre_scores": scores,
                                        "scores": f"probs{t}"},
                        {"selected_ids": f"ids{t}", "selected_scores": f"scores{t}",
                         "parent_idx": f"parent{t}"},
                        {"beam_size": cfg["k"], "end_id": cfg["end_id"],
                         "is_accumulated": False})
        block.append_op("gather", {"X": f"h{t}", "Index": f"parent{t}"},
                        {"Out": f"state{t}"}, {})
        block.append_op("reshape", {"X": f"ids{t}"}, {"Out": f"ids_row{t}"},
                        {"shape": [1, bk]})
        block.append_op("reshape", {"X": f"parent{t}"}, {"Out": f"parent_row{t}"},
                        {"shape": [1, bk]})
        ids, scores, state = f"ids{t}", f"scores{t}", f"state{t}"
    steps = range(cfg["steps"])
    block.append_op("concat", {"X": [f"ids_row{t}" for t in steps]}, {"Out": "all_ids"},
                    {"axis": 0})
    block.append_op("concat", {"X": [f"parent_row{t}" for t in steps]},
                    {"Out": "all_parents"}, {"axis": 0})
    block.append_op("beam_search_decode", {"Ids": "all_ids", "ParentIdx": "all_parents",
                                           "Scores": scores},
                    {"SentenceIds": "sentences", "SentenceScores": "sentence_scores"},
                    {"beam_size": cfg["k"]})
    return prog, ["sentences", "sentence_scores"]


def fluid_beam_feed(np, cfg, seed=0):
    """Start ids 0 for every beam, beam 0 of each source at score 0 and
    the others at -1e9 (so the first step expands one beam), a random
    state a source."""
    rs = np.random.RandomState(seed)
    b, k, e = cfg["b"], cfg["k"], cfg["emb"]
    scores = np.full((b, k), -1e9, np.float32)
    scores[:, 0] = 0.0
    state = np.repeat(rs.randn(b, 1, e).astype(np.float32), k, axis=1)
    return {"pre_ids": np.zeros((b * k, 1), np.int64), "pre_scores": scores.reshape(-1, 1),
            "state": state.reshape(b * k, e)}


def fluid_save_load_program(fluid, path):
    """save then load of the same file inside one run: the save writes each
    run's value; the load reads the file once a signature (the JAX
    package's trace-time constant)."""
    fluid.reset_default_program()
    block = fluid.default_main_program().global_block()
    block.create_var("x", shape=[FLUID_COND["d"]], is_data=True)
    block.append_op("scale", {"X": "x"}, {"Out": "y"}, {"scale": 2.0})
    block.append_op("save", {"X": "y"}, {"Out": "saved"}, {"file_path": path})
    block.append_op("load", {}, {"Out": "loaded"}, {"file_path": path})
    return fluid.default_main_program(), ["y", "loaded"]


def fluid_runs(exe, prog, feeds, fetch, scope, use_jit=True):
    """exe.run over `feeds` -> (the fetches of each run, host ms of each
    run, fetches included)."""
    outs, ms = [], []
    for feed in feeds:
        t = time.perf_counter()
        outs.append(exe.run(prog, feed=feed, fetch_list=fetch, scope=scope, use_jit=use_jit))
        ms.append((time.perf_counter() - t) * 1e3)
    return outs, ms


def fluid_start(fluid, prog, seed=0):
    """The persistables' initial values (drawn on the CPU) as host arrays,
    so the card and the CPU start from the same scope."""
    scope = fluid.Scope()
    fluid.Executor(seed=seed, device="cpu").initialize(prog, scope)
    return scope.numpy()


def fluid_graph_stats(exe):
    graphs = list(exe.graphs.values())
    return dict(graphs=len(graphs), replays=sum(g.replays for g in graphs),
                eager_runs=exe.eager_runs, route="graph" if graphs else "eager")


def rel_err(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def fluid_vs_cpu(name, card_losses, cpu_losses):
    """The first loss within CPU_COST_RTOL of the CPU's, the second within
    V1_CPU_RTOL (an update apart)."""
    rel = [rel_err(a, b) for a, b in zip(card_losses, cpu_losses)]
    if not (rel[0] <= CPU_COST_RTOL and max(rel) <= V1_CPU_RTOL):
        fail(f"{name}: losses card {card_losses} vs CPU {cpu_losses}: rel err {rel} "
             f"(first <= {CPU_COST_RTOL}, all <= {V1_CPU_RTOL})")
    return rel


def fluid_eager_vs_replay(fluid, prog, feeds, fetch, snapshot, replayed):
    """The eager interpreter on the card (use_jit=False) from `snapshot`
    (the scope's arrays before the replays `replayed`, their losses) over
    the same feeds -> (relative errors, bitwise)."""
    exe = fluid.Executor(device="cuda")
    eager, _ = fluid_runs(exe, prog, feeds, fetch, fluid.scope_from_arrays(snapshot, "cuda"),
                          use_jit=False)
    got = [float(e[0]) for e in eager]
    rel = [rel_err(a, b) for a, b in zip(got, replayed)]
    if not max(rel) <= FLUID_EAGER_RTOL:
        fail(f"fluid: eager on the card {got} vs replays {replayed}: rel err {rel} "
             f"(<= {FLUID_EAGER_RTOL})")
    return rel, got == list(replayed)


def fluid_digits_phase(torch):
    """Phase 36: recognize_digits' conv net as a fluid Program on the card,
    20 `exe.run(prog, feed, fetch_list=[loss, acc])` calls on mnist's
    synthetic records at batch 64: one graph (captured at run 2) and 18
    replays, the loss falls; ms a run (host clock, the fetch included), the
    graph's device ms (CUDA events over 5 back-to-back replays, run after
    the checks), kernels a replay (torch.profiler over 3 runs), peak
    memory; the first 2 losses card vs CPU from the same scope; 3 runs of
    the eager interpreter on the card (use_jit=False) from the scope
    before run 11 against runs 11-13 (replays)."""
    import numpy as np

    from paddle_tpu_torch import fluid

    cfg = FLUID_DIGITS
    prog, fetch = fluid_digits_program(fluid)
    feeds = fluid_digits_feeds(np, cfg["runs"], cfg["batch"])
    start = fluid_start(fluid, prog)
    exe = fluid.Executor(device="cuda")
    scope = fluid.scope_from_arrays(start, "cuda")
    torch.cuda.reset_peak_memory_stats()
    k = cfg["eager_from"]
    outs, ms = fluid_runs(exe, prog, feeds[:k], fetch, scope)
    snapshot = scope.numpy()
    more, more_ms = fluid_runs(exe, prog, feeds[k:], fetch, scope)
    outs, ms = outs + more, ms + more_ms
    peak = torch.cuda.max_memory_allocated()
    stats = fluid_graph_stats(exe)
    losses = [float(o[0]) for o in outs]
    acc = [float(o[1]) for o in outs]
    n = cfg["eager_runs"]
    eager_rel, bitwise = fluid_eager_vs_replay(fluid, prog, feeds[k:k + n], fetch, snapshot,
                                               losses[k:k + n])
    cpu, _ = fluid_runs(fluid.Executor(device="cpu"), prog, feeds[:2], fetch,
                        fluid.scope_from_arrays(start, "cpu"))
    cpu_rel = fluid_vs_cpu("fluid digits", losses[:2], [float(c[0]) for c in cpu])
    out = dict(config=cfg, **stats, losses=losses, accuracy=acc,
               ms_per_run_median=statistics.median(ms[2:]), run_ms=ms,
               peak_memory_bytes=peak, cpu_loss_rel_err=cpu_rel,
               eager_vs_replay_rel_err=eager_rel, eager_vs_replay_bitwise=bitwise)
    if stats["graphs"] != 1 or stats["replays"] != cfg["runs"] - 2:
        fail(f"fluid digits: {stats} over {cfg['runs']} runs, want 1 graph and "
             f"{cfg['runs'] - 2} replays")
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        fail(f"fluid digits: losses {losses}")
    out["profile"] = profile_train(torch, lambda: exe.run(prog, feed=feeds[-1],
                                                          fetch_list=fetch, scope=scope),
                                   tag="fluid", steps=3, label="fluid_digits_profile")
    (graph,) = exe.graphs.values()
    out["graph_device_ms"] = device_ms_per_call(torch, graph.graph.replay, n=5)
    print("fluid_digits", json.dumps(out), flush=True)
    return out


def fluid_lstm_phase(torch):
    """Phase 37: the fluid LSTM text classifier at rnn_bench's widths
    (vocab 10000, embedding 128, hidden 512, batch 128, length 100, lengths
    60-100), 12 runs of one batch: one graph, the loss falls; ms a run,
    real tokens/s, kernels a replay, peak memory; the first 2 losses card
    vs CPU at batch 8 from the same scope; the eager interpreter on the
    card against runs 6-9 (replays) from the scope before them."""
    import numpy as np

    from paddle_tpu_torch import fluid

    cfg = FLUID_LSTM
    prog, fetch = fluid_lstm_program(fluid, cfg)
    feed = fluid_lstm_feed(np, cfg, cfg["batch"])
    start = fluid_start(fluid, prog)
    exe = fluid.Executor(device="cuda")
    scope = fluid.scope_from_arrays(start, "cuda")
    torch.cuda.reset_peak_memory_stats()
    k, n = cfg["eager_from"], cfg["eager_runs"]
    outs, ms = fluid_runs(exe, prog, [feed] * k, fetch, scope)
    snapshot = scope.numpy()
    more, more_ms = fluid_runs(exe, prog, [feed] * (cfg["runs"] - k), fetch, scope)
    outs, ms = outs + more, ms + more_ms
    peak = torch.cuda.max_memory_allocated()
    stats = fluid_graph_stats(exe)
    losses = [float(o[0]) for o in outs]
    run_ms = statistics.median(ms[2:])
    eager_rel, bitwise = fluid_eager_vs_replay(fluid, prog, [feed] * n, fetch, snapshot,
                                               losses[k:k + n])
    small = fluid_lstm_feed(np, cfg, cfg["cpu_batch"], seed=1)
    card, _ = fluid_runs(fluid.Executor(device="cuda"), prog, [small] * 2, fetch,
                         fluid.scope_from_arrays(start, "cuda"))
    cpu, _ = fluid_runs(fluid.Executor(device="cpu"), prog, [small] * 2, fetch,
                        fluid.scope_from_arrays(start, "cpu"))
    cpu_rel = fluid_vs_cpu("fluid lstm", [float(c[0]) for c in card],
                           [float(c[0]) for c in cpu])
    out = dict(config=cfg, **stats, losses=losses, ms_per_run_median=run_ms, run_ms=ms,
               real_tokens_per_s=float(feed["lengths"].sum()) / (run_ms / 1e3),
               peak_memory_bytes=peak, cpu_batch_loss_rel_err=cpu_rel,
               eager_vs_replay_rel_err=eager_rel, eager_vs_replay_bitwise=bitwise)
    if stats["graphs"] != 1 or stats["replays"] != cfg["runs"] - 2:
        fail(f"fluid lstm: {stats} over {cfg['runs']} runs")
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        fail(f"fluid lstm: losses {losses}")
    out["profile"] = profile_train(torch, lambda: exe.run(prog, feed=feed, fetch_list=fetch,
                                                          scope=scope),
                                   tag="fluid", steps=2, label="fluid_lstm_profile")
    (graph,) = exe.graphs.values()
    out["graph_device_ms"] = device_ms_per_call(torch, graph.graph.replay, n=3)
    print("fluid_lstm", json.dumps(out), flush=True)
    return out


def fluid_card_vs_cpu(name, prog, fetch, feeds, cpu_runs=None):
    """`feeds` through a card executor and, for the first `cpu_runs`, a CPU
    one, from the same initial scope -> the card's outputs and stats; every
    float fetch within FLUID_OUT_TOL of the CPU's, the others (ids, flags)
    equal."""
    import numpy as np

    from paddle_tpu_torch import fluid

    start = fluid_start(fluid, prog)
    exe = fluid.Executor(device="cuda")
    card, ms = fluid_runs(exe, prog, feeds, fetch, fluid.scope_from_arrays(start, "cuda"))
    n = len(feeds) if cpu_runs is None else cpu_runs
    cpu, _ = fluid_runs(fluid.Executor(device="cpu"), prog, feeds[:n], fetch,
                        fluid.scope_from_arrays(start, "cpu"))
    worst = 0.0
    for i, (c_run, p_run) in enumerate(zip(card, cpu)):
        for j, (c, p) in enumerate(zip(c_run, p_run)):
            if p.dtype.kind not in "fc":
                if not np.array_equal(c, p):
                    fail(f"fluid {name}: run {i} fetch {fetch[j]} card != CPU")
                continue
            err = float(np.max(np.abs(c - p) / (FLUID_OUT_TOL["atol"]
                                                 + FLUID_OUT_TOL["rtol"] * np.abs(p))))
            worst = max(worst, err)
            if not err <= 1.0:
                fail(f"fluid {name}: run {i} fetch {fetch[j]} card vs CPU beyond "
                     f"{FLUID_OUT_TOL} ({err:.3g} of the tolerance)")
    return card, dict(**fluid_graph_stats(exe), ms_per_run_median=statistics.median(ms),
                      runs=len(feeds), cpu_runs=n, worst_share_of_tolerance=worst)


def fluid_control_phase(torch):
    """Phase 38: fluid control flow and generation ops, card vs CPU from
    the same scopes and feeds: a recurrent op over gru_unit at T 50, B 128,
    H 512 trained with SGD (first 2 losses as phase 36's; kernels a replay
    by torch.profiler), the while
    counter (eager on the card: its trip count is a device value), cond
    with a scalar and a per-sample condition at [128, 512] (dropout in the
    true block: the same keys), beam_search + beam_search_decode at B 128,
    K 3, V 30000 over 8 steps (the decoded ids equal, scores within
    FLUID_OUT_TOL), and save -> load inside a graphed run (the file holds
    each run's value after its replay; the load reads it once). Which
    programs ran as a graph and which eagerly is reported."""
    import numpy as np

    from paddle_tpu_torch import fluid

    out = {}
    cfg = FLUID_GRU
    prog, fetch = fluid_gru_program(fluid, cfg)
    feed = fluid_gru_feed(np, cfg)
    start = fluid_start(fluid, prog)
    exe = fluid.Executor(device="cuda")
    scope = fluid.scope_from_arrays(start, "cuda")
    torch.cuda.reset_peak_memory_stats()
    card, ms = fluid_runs(exe, prog, [feed] * cfg["runs"], fetch, scope)
    cpu, _ = fluid_runs(fluid.Executor(device="cpu"), prog, [feed] * 2, fetch,
                        fluid.scope_from_arrays(start, "cpu"))
    losses = [float(c[0]) for c in card]
    out["recurrent_gru"] = dict(
        config=cfg, **fluid_graph_stats(exe), losses=losses,
        ms_per_run_median=statistics.median(ms[2:]),
        peak_memory_bytes=torch.cuda.max_memory_allocated(),
        cpu_loss_rel_err=fluid_vs_cpu("fluid recurrent", losses[:2],
                                      [float(c[0]) for c in cpu]))
    if out["recurrent_gru"]["graphs"] != 1 or not losses[-1] < losses[0]:
        fail(f"fluid recurrent: {out['recurrent_gru']}")
    out["recurrent_gru"]["profile"] = profile_train(
        torch, lambda: exe.run(prog, feed=feed, fetch_list=fetch, scope=scope), tag="fluid",
        steps=2, label="fluid_gru_profile")

    prog, fetch = fluid_while_program(fluid)
    feeds = [{"v": np.full(4, i + 1.0, np.float32), "c": np.zeros((), np.float32),
              "n": np.full((), 7.0 - i, np.float32)} for i in range(3)]
    card, out["while"] = fluid_card_vs_cpu("while", prog, fetch, feeds)
    if out["while"]["route"] != "eager" or not np.array_equal(card[0][0], np.full(4, 128.0)):
        fail(f"fluid while: {out['while']}, v {card[0][0]}")

    c = FLUID_COND
    rs = np.random.RandomState(0)
    for kind, per_sample in (("cond_scalar", False), ("cond_per_sample", True)):
        prog, fetch = fluid_cond_program(fluid, per_sample)
        flags = ([rs.randint(0, 2, c["b"]).astype(np.float32) for _ in range(c["runs"])]
                 if per_sample else [np.asarray(float(i % 2)) for i in range(c["runs"])])
        feeds = [{"flag": f, "x": rs.randn(c["b"], c["d"]).astype(np.float32)} for f in flags]
        _, out[kind] = fluid_card_vs_cpu(kind, prog, fetch, feeds)
        if out[kind]["route"] != "graph":
            fail(f"fluid {kind}: {out[kind]}")

    cfg = FLUID_BEAM
    prog, fetch = fluid_beam_program(fluid, cfg)
    feeds = [fluid_beam_feed(np, cfg, seed=i) for i in range(cfg["runs"])]
    card, out["beam_search"] = fluid_card_vs_cpu("beam_search", prog, fetch, feeds,
                                                 cpu_runs=2)
    ids = card[-1][0]
    out["beam_search"].update(config=cfg, sentence_ids_shape=list(ids.shape),
                              distinct_ids=int(len(np.unique(ids))))
    if out["beam_search"]["route"] != "graph" or ids.shape != (cfg["b"], cfg["k"],
                                                                  cfg["steps"]):
        fail(f"fluid beam_search: {out['beam_search']}")

    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    results = {}
    for dev in ("cuda", "cpu"):
        path = os.path.join(REPO, "build", f"fluid_saved_{dev}")
        prog, fetch = fluid_save_load_program(fluid, path)
        exe = fluid.Executor(device=dev)
        xs = [np.full(c["d"], float(i + 1), np.float32) for i in range(4)]
        runs = []
        for x in xs:
            y, loaded = exe.run(prog, feed={"x": x}, fetch_list=fetch)
            runs.append(dict(y=y, loaded=loaded, disk=np.load(path + ".npy")))
        results[dev] = dict(runs=runs, stats=fluid_graph_stats(exe))
    for dev, r in results.items():
        for i, run in enumerate(r["runs"]):
            if not (np.array_equal(run["disk"], run["y"])
                    and np.array_equal(run["loaded"], r["runs"][0]["y"])):
                fail(f"fluid save/load on {dev}: run {i} disk {run['disk'][:2]} y "
                     f"{run['y'][:2]} loaded {run['loaded'][:2]}")
    out["save_load"] = results["cuda"]["stats"]
    if out["save_load"]["route"] != "graph" or out["save_load"]["replays"] != 2:
        fail(f"fluid save/load: {out['save_load']}")
    out["routes"] = {k: v["route"] for k, v in out.items()}
    print("fluid_control", json.dumps(out), flush=True)
    return out


def gan_build(L, C, ParamAttr, Network, Adam, Trainer, **kw):
    """The GAN demo's two phases (tests/test_multi_network.py:24-60), in a
    package's layers (either package's: tests/test_torch_multi_network.py
    builds both): the discriminator Fc 16 relu -> Fc 2 softmax (`dis_*`),
    the generator Fc 16 relu -> Fc 2 (`gen_*`) scored by a static copy of
    the discriminator, Adam(1e-2) in both -> (dis trainer, gen trainer,
    the generator's Network, its output's name)."""
    def discriminator(sample, static):
        pa = lambda n: ParamAttr(name=n, is_static=static)  # noqa: E731
        h = L.Fc(sample, 16, act="relu", param_attr=pa("dis_w1"),
                 bias_attr=pa("dis_b1"), name=f"dish_{static}")
        return L.Fc(h, 2, act="softmax", param_attr=pa("dis_w2"),
                    bias_attr=pa("dis_b2"), name=f"diso_{static}")

    def generator(noise, static):
        pa = lambda n: ParamAttr(name=n, is_static=static)  # noqa: E731
        h = L.Fc(noise, 16, act="relu", param_attr=pa("gen_w1"),
                 bias_attr=pa("gen_b1"), name=f"genh_{static}")
        return L.Fc(h, 2, act=None, param_attr=pa("gen_w2"),
                    bias_attr=pa("gen_b2"), name=f"geno_{static}")

    d_cost = C.ClassificationCost(discriminator(L.Data("sample", shape=(2,)), False),
                                  L.Data("label", shape=()), name="d_cost")
    g_sample = generator(L.Data("noise", shape=(4,)), False)
    g_cost = C.ClassificationCost(discriminator(g_sample, True),
                                  L.Data("label", shape=()), name="g_cost")
    dis = Trainer(d_cost, Adam(learning_rate=1e-2), **kw)
    gen = Trainer(g_cost, Adam(learning_rate=1e-2), **kw)
    return dis, gen, Network(g_sample), g_sample.name


def gan_phase(torch):
    """Phase 39: the GAN demo through MultiNetworkTrainer on the card at
    batch 128, 400 alternating iterations on the test's data (mean
    [2, -1], sigma 0.3): each phase's step one graph, every later step a
    replay; the generator's mean lands within half of its starting
    distance of the data mean; dis_w1 / dis_w2 bitwise equal in both
    phases' states after the run, gen_w1 absent from the discriminator's.
    ms an iteration (the discriminator step, the generator step and the
    sampling forward of the fakes, host clock); then torch.profiler over 5
    more iterations (kernels an iteration, busy share)."""
    import numpy as np

    from paddle_tpu_torch.nn import costs, layers
    from paddle_tpu_torch.nn.graph import Network, ParamAttr, reset_name_scope
    from paddle_tpu_torch.optim import Adam
    from paddle_tpu_torch.trainer import MultiNetworkTrainer, SGDTrainer

    cfg = GAN
    reset_name_scope()
    dis, gen, gen_net, name = gan_build(layers, costs, ParamAttr, Network, Adam, SGDTrainer,
                                        device="cuda")
    mt = MultiNetworkTrainer({"dis": dis, "gen": gen})
    rs = np.random.RandomState(0)
    bs, mean = cfg["batch"], np.asarray(cfg["mean"], np.float32)
    real = lambda: mean + rs.randn(bs, 2).astype(np.float32) * cfg["std"]  # noqa: E731
    noise = lambda n=bs: rs.randn(n, cfg["noise"]).astype(np.float32)  # noqa: E731
    ones = np.ones(bs, np.int64)
    labels = np.concatenate([np.ones(bs), np.zeros(bs)]).astype(np.int64)
    mt.init_state({"dis": {"sample": real(), "label": ones},
                   "gen": {"noise": noise(), "label": ones}})

    def samples(n):
        outs = gen_net.apply(mt.state_of("gen")["params"], {"noise": noise(n)})
        return outs[name].value.detach().cpu().numpy()

    costs_d, costs_g = [], []

    def iteration():
        batch = np.concatenate([real(), samples(bs)], 0)
        costs_d.append(mt.step("dis", {"sample": batch, "label": labels}))
        costs_g.append(mt.step("gen", {"noise": noise(), "label": ones}))

    before = float(np.linalg.norm(samples(256).mean(0) - mean))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(cfg["iters"]):
        iteration()
    torch.cuda.synchronize()
    ms_iter = (time.perf_counter() - t0) * 1e3 / cfg["iters"]
    after = float(np.linalg.norm(samples(256).mean(0) - mean))
    graphs = {p: (len(tr.graphs), sum(g.replays for g in tr.graphs.values()))
              for p, tr in mt.trainers.items()}
    dp, gp = mt.state_of("dis")["params"], mt.state_of("gen")["params"]
    in_sync = {k: bool(torch.equal(dp[k], gp[k])) for k in ("dis_w1", "dis_b1", "dis_w2",
                                                             "dis_b2")}
    out = dict(config=cfg, ms_per_iteration=ms_iter, distance_before=before,
               distance_after=after, graphs_and_replays=graphs, shared_bitwise=in_sync,
               cost_d_first_last=[float(costs_d[0]), float(costs_d[-1])],
               cost_g_first_last=[float(costs_g[0]), float(costs_g[-1])],
               peak_memory_bytes=torch.cuda.max_memory_allocated())
    print("gan", json.dumps(out), flush=True)
    if any(g != (1, cfg["iters"] - 1) for g in graphs.values()):
        fail(f"gan: graphs and replays {graphs}, want one graph a phase and "
             f"{cfg['iters'] - 1} replays")
    if not after < 0.5 * before:
        fail(f"gan: the generator's mean moved from {before} to {after} of the data mean")
    if not all(in_sync.values()) or "gen_w1" in dp:
        fail(f"gan: shared parameters {in_sync}, dis params {sorted(dp)}")
    out["profile"] = profile_train(torch, iteration, tag="gan", steps=5, label="gan_profile")
    return out


# -- SSD, the structured costs, SimpleRnn / MDLstm, the 3-D layers and the
# native runtime (phases 40-44) -----------------------------------------------

# 40: models/ssd.py at its defaults (96x96x3, 21 classes, widths 32/64/128,
# three heads of 4 priors a cell at 48, 24 and 12: 12 096 priors, nms_top_k
# 400, keep_top_k 200), batch 32 of 1-8 gt boxes an image (padded to 8),
# Adam(1e-3), `steps` steps on one batch; card vs CPU at batch 4 (SGD(0.01):
# the first 2 costs, every gradient); detections at batch 4 card vs CPU
# from the same head outputs; mAP over `map_batches` batches of 32
SSD = dict(image_size=96, num_classes=21, widths=(32, 64, 128), batch=32, steps=20,
           lr=1e-3, max_gt=8, cpu_batch=4, cpu_lr=0.01, map_batches=4)
SSD_GRAD_TOL = 1e-4
SSD_DET_TOL = 1e-5
# 41: the structured costs at a word model's widths (B 512, D 256, a 10 000
# word dictionary, 10 noise samples; LambdaRank over 64 queries of 32
# documents; three beam expansions of 128 x 5 x 4 candidates), card vs CPU;
# then the book's word2vec with hsigmoid / NCE in the softmax's place and
# the LambdaRank demo over mq2007, 8 batches each
STRUCT = dict(b=512, d=256, classes=10000, neg=10, queries=64, docs=32, beam_b=128,
              beam_k=5, beam_n=4)
STRUCT_BOOK = (("word2vec_hsigmoid", "word2vec", dict(batch=128, emb=32, hidden=256,
                                                      output="hsigmoid")),
               ("word2vec_nce", "word2vec", dict(batch=128, emb=32, hidden=256, output="nce",
                                                 neg=10)),
               ("lambda_rank", "lambda_rank", dict(batch=32, hidden=128, lr=1e-3)))
# 42: SimpleRnn (B 64, T 50, H 256) both ways and MDLstm (B 8, a 16 x 16
# grid, 32 units) in each direction pair, on the phase's data and on
# `md_seeds` more draws of grid and parameters, card vs CPU; a v1 config
# of a bidirectional recurrent_layer text classifier trained 8 steps
RNN_EXTRA = dict(b=64, t=50, h=256, grid_b=8, grid=16, grid_hid=32, md_seeds=(1, 2, 3))
# MDLstm's gradients run back through 31 wavefront steps of two
# neighbours each, and their f32 rounding error varies with the data: over
# this phase's 16 draws, 2.7e-6 to 4.2e-5 relative L2 from a float64 run on
# the CPU, 3.4e-6 to 1.5e-4 on an H100, whose float64 gradients are the
# CPU's within 4e-13. A wrong gradient reads 1.5e-2 or more (a neighbour's
# h scaled by 0.999, a peephole on the wrong cell). So each f32 gradient is
# held to the float64 run within this limit, card f32 vs CPU f32 printed
# beside, and the card in float64 to the CPU in float64
RNN_EXTRA_GRAD_REL_L2 = 5e-4
RNN_EXTRA_F64_REL_L2 = 1e-10
V1_RNN = dict(vocab=1000, emb=64, size=128, batch=64, batches=8)
# 43: Conv3D (16 -> 32, k 3, pad 1), Conv3DTranspose (32 -> 16, k 2, stride
# 2) and Pool3D (max, avg; k 2) over [8, 16, 16, 16, 16], and Conv3D from one
# channel (1 -> 32, k 3, pad 1) over [8, 16, 16, 16, 1], f32 with TF32 off;
# cuDNN computes all of them, its own weight gradients included
L3D = dict(b=8, d=16, c=16, filters=32)
L3D_REL_L2 = 1e-5
# 44: the native runtime: mnist's synthetic records sharded into recordio
# (1 000 records a shard), an in-process TaskMaster handing them out one
# shard a task, recognize_digits fed through DataFeeder into its step graph
RUNTIME = dict(records=4096, per_shard=1000, batch=128, steps=8)


def ssd_net(cfg):
    """A fresh models/ssd.py graph at cfg's widths -> (cost, detection)."""
    from paddle_tpu_torch.models import ssd
    from paddle_tpu_torch.nn.graph import reset_name_scope

    reset_name_scope()
    _, _, _, cost, det = ssd(image_size=cfg["image_size"], num_classes=cfg["num_classes"],
                             widths=cfg["widths"])
    return cost, det


def ssd_batch(np, cfg, b, seed):
    """A detection batch: randn images; 1..max_gt gt boxes an image in
    normalised corners (corner in [0, 0.6), sides in [0.15, 0.4)), labels
    1..num_classes-1, as tests/test_torch_detection.py draws them; rows past
    an image's count are zero, `gt_*.lengths` hold the counts."""
    rs = np.random.RandomState(seed)
    s, g = cfg["image_size"], cfg["max_gt"]
    boxes = np.zeros((b, g, 4), np.float32)
    labels = np.zeros((b, g), np.int32)
    lengths = rs.randint(1, g + 1, b).astype(np.int32)
    for i in range(b):
        for j in range(lengths[i]):
            x0, y0 = rs.uniform(0, 0.6, 2)
            w, h = rs.uniform(0.15, 0.4, 2)
            boxes[i, j] = [x0, y0, min(x0 + w, 1.0), min(y0 + h, 1.0)]
            labels[i, j] = rs.randint(1, cfg["num_classes"])
    return {"image": rs.randn(b, s, s, 3).astype(np.float32), "gt_boxes": boxes,
            "gt_boxes.lengths": lengths, "gt_labels": labels, "gt_labels.lengths": lengths}


def detections_agree(np, got, want, tol):
    """Card vs CPU detections [B, K, 6], row by row: the same label, score
    and box within `tol`. Rows whose scores lie within `tol` of their
    neighbour's form a tie the two devices' last bits may break either way,
    so each such run is matched as a set -> (ok, max_abs_err, rows in
    ties)."""
    worst, tied = 0.0, 0
    for g_img, w_img in zip(got, want):
        i = 0
        while i < len(w_img):
            j = i + 1
            while j < len(w_img) and abs(w_img[j, 1] - w_img[j - 1, 1]) <= tol:
                j += 1
            tied += j - i if j - i > 1 else 0
            used = set()
            for row in w_img[i:j]:
                best = None
                for t in range(i, j):
                    if t in used or g_img[t, 0] != row[0]:
                        continue
                    err = float(np.abs(g_img[t, 1:] - row[1:]).max())
                    if err <= tol and (best is None or err < best[1]):
                        best = (t, err)
                if best is None:
                    return False, worst, tied
                used.add(best[0])
                worst = max(worst, best[1])
            i = j
    return True, worst, tied


def grads_close(torch, got, want, tol):
    """{name: max abs err} and the names outside tol x max(1, max|want|)."""
    errs, bad = {}, []
    for k, w in want.items():
        w = w.detach().cpu().double()
        g = got[k].detach().cpu().double()
        errs[k] = float((g - w).abs().max())
        if errs[k] > tol * max(1.0, float(w.abs().max())):
            bad.append(k)
    return errs, bad


def ssd_phase(torch):
    """Phase 40: SSD at full width trains as one graph, card vs CPU at batch
    4, detections card vs CPU, detection timing and mAP (see SSD)."""
    import numpy as np

    from paddle_tpu_torch.metrics.evaluators import DetectionMAPEvaluator
    from paddle_tpu_torch.nn.detection_layers import gather_heads
    from paddle_tpu_torch.nn.graph import Network
    from paddle_tpu_torch.optim import SGD, Adam
    from paddle_tpu_torch.trainer import SGDTrainer

    cfg = SSD
    cost, det = ssd_net(cfg)
    trainer = SGDTrainer(cost, Adam(learning_rate=cfg["lr"]), seed=0, device="cuda")
    batch = ssd_batch(np, cfg, cfg["batch"], 0)
    t0 = time.perf_counter()
    trainer.init_state(batch)
    dev_batch = {k: torch.as_tensor(v).to("cuda") for k, v in batch.items()}
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    zero_rnn_counts()
    costs, step_ms = timed_calls(torch, lambda: trainer.step(dev_batch), cfg["steps"])
    launches = rnn_counts()
    peak = torch.cuda.max_memory_allocated()
    graphs = list(trainer.graphs.values())
    replays = graphs[0].replays if graphs else 0
    med = statistics.median(step_ms[1:])
    device_ms = device_ms_per_call(torch, lambda: trainer.step(dev_batch))
    res = dict(config=cfg, params=sum(p.numel() for p in trainer.state["params"].values()),
               setup_s=setup_s, costs=costs, step_ms=step_ms, step_ms_median=med,
               images_per_s=cfg["batch"] / (med / 1e3), graph_device_ms_per_step=device_ms,
               busy_share_graph=device_ms / med, peak_memory_bytes=peak, graphs=len(graphs),
               replays=replays, kernel_launches=launches)
    print("ssd", json.dumps(res), flush=True)
    if len(graphs) != 1 or replays != cfg["steps"] - 1:
        fail(f"ssd: {len(graphs)} step graphs, {replays} replays in {cfg['steps']} steps")
    if any(launches.values()):
        fail(f"ssd: the step launched ported kernels it does not run: {launches}")
    if not (np.isfinite(costs).all() and costs[-1] < costs[0]):
        fail(f"ssd: training costs {costs}: want finite and falling")
    res["profile"] = profile_train(torch, lambda: trainer.step(dev_batch), tag="ssd",
                                   label="ssd_profile")

    # card vs CPU at batch 4 from the same parameters
    small = ssd_batch(np, cfg, cfg["cpu_batch"], 1)
    twins = {}
    for dev in ("cpu", "cuda"):
        twins[dev] = SGDTrainer(ssd_net(cfg)[0], SGD(learning_rate=cfg["cpu_lr"]), seed=0,
                                device=dev)
        twins[dev].init_state(small)
    twins["cuda"].load_params(twins["cpu"].state["params"])
    c_card, g_card = twins["cuda"].cost_and_grads(small)
    c_cpu, g_cpu = twins["cpu"].cost_and_grads(small)
    errs, bad = grads_close(torch, g_card, g_cpu, SSD_GRAD_TOL)
    two = {dev: [float(tr.step(small)) for _ in range(2)] for dev, tr in twins.items()}
    rel = [abs(a - b) / abs(b) for a, b in zip(two["cuda"], two["cpu"])]
    res["vs_cpu"] = dict(batch=cfg["cpu_batch"], cost_card=float(c_card),
                         cost_cpu=float(c_cpu), costs_card=two["cuda"], costs_cpu=two["cpu"],
                         cost_rel_err=rel, grad_max_abs_err=max(errs.values()),
                         grads_outside_tol=bad)
    print("ssd_vs_cpu", json.dumps(res["vs_cpu"]), flush=True)
    if not (rel[0] <= CPU_COST_RTOL and rel[1] <= V1_CPU_RTOL):
        fail(f"ssd: costs card {two['cuda']} vs CPU {two['cpu']}: rel err {rel}")
    if bad:
        fail(f"ssd: gradients card vs CPU beyond {SSD_GRAD_TOL} x max(1, max|g|): {bad}")
    del twins

    # detections on the trained parameters: card vs CPU from the same heads
    params = trainer.state["params"]
    heads_net = Network(list(det.inputs))
    image = {"image": ssd_batch(np, cfg, cfg["cpu_batch"], 2)["image"]}
    heads = heads_net.apply(params, image)
    loc, conf, pri, var = gather_heads([heads[l.name] for l in det.inputs], det.n_heads)
    on_card = det.detect(loc, conf, pri, var).cpu().numpy()
    on_cpu = det.detect(loc.cpu(), conf.cpu(), pri.cpu(), var.cpu()).numpy()
    ok, worst, tied = detections_agree(np, on_card, on_cpu, SSD_DET_TOL)
    res["detect_vs_cpu"] = dict(shape=list(on_card.shape), max_abs_err=worst, tied_rows=tied,
                                rows_scored=int((on_card[..., 1] > 0).sum()))
    if not ok:
        fail(f"ssd: detections card vs CPU differ beyond {SSD_DET_TOL} "
             f"(labels, scores, boxes; {tied} rows in score ties)")
    # the detection call at batch 32 (eager), then mAP over map_batches batches
    det_net = Network([det])
    img32 = {"image": torch.as_tensor(batch["image"]).to("cuda")}
    res["detect_ms_batch32"] = events_ms(torch, lambda: det_net.apply(params, img32), n=5)
    res["detect_profile"] = profile_train(torch, lambda: det_net.apply(params, img32),
                                          tag="sort", steps=1, label="ssd_detect_profile")
    ev = DetectionMAPEvaluator(ap_type="11point")
    ev.start()
    for i in range(cfg["map_batches"]):
        b = ssd_batch(np, cfg, cfg["batch"], 10 + i)
        dets = det_net.apply(params, {"image": b["image"]})["detection"].value
        ev.update(detections=dets, gt_boxes=b["gt_boxes"], gt_labels=b["gt_labels"],
                  gt_lengths=b["gt_boxes.lengths"])
    res["map_11point"] = ev.finish()
    print("ssd_detect", json.dumps({k: res[k] for k in (
        "detect_vs_cpu", "detect_ms_batch32", "map_11point")}), flush=True)
    if not 0.0 <= res["map_11point"] <= 1.0:
        fail(f"ssd: mAP {res['map_11point']} outside [0, 1]")
    return res


def layer_card_vs_cpu(torch, net, batch, train=True, seed=3, f64=False, init_seed=0):
    """One graph's output and its gradients on the card and on the CPU from
    the same parameters (`net.init` at `init_seed`) and, in training, the
    same key: a cost's own gradients, or those of the output times a fixed
    cotangent -> (card, CPU) pairs of (output on the host, {param: grad});
    with `f64`, two more, the CPU and the card in float64 (parameters,
    inputs and the compute policy)."""
    import numpy as np

    from paddle_tpu_torch.core import dtypes, prng

    params = {k: v.numpy() for k, v in net.init(batch, seed=init_seed, device="cpu").items()}
    name = net.outputs[0].name
    runs = [("cuda", torch.float32), ("cpu", torch.float32)]
    out = []
    for dev, dt in runs + ([("cpu", torch.float64), ("cuda", torch.float64)] if f64 else []):
        policy = dtypes.Policy(param_dtype=dt, compute_dtype=dt, accum_dtype=dt)
        tp = {k: torch.from_numpy(v).to(dev, dt).requires_grad_(True) for k, v in params.items()}
        feed = {k: torch.from_numpy(v).to(dt) if v.dtype == np.float32 else v
                for k, v in batch.items()}
        value = net.apply(tp, feed, train=train, rng=prng.PRNGKey(seed, dev),
                          policy=policy)[name].value
        loss = value
        if value.dim():
            gen = torch.Generator().manual_seed(seed)
            loss = (value * torch.randn(value.shape, generator=gen).to(dev, dt)).sum()
        grads = torch.autograd.grad(loss, list(tp.values()))
        out.append((value.detach().cpu().double(), dict(zip(tp, grads))))
    return tuple(out)


def struct_costs_phase(torch):
    """Phase 41 (see STRUCT): NCE (uniform and by distribution), hsigmoid,
    LambdaCost and CrossEntropyOverBeam, value and gradients card vs CPU;
    then the book's word2vec with hsigmoid and with NCE over its dictionary,
    and the LambdaRank demo over mq2007, 8 batches each through
    paddle.v2's trainer: one graph, every later batch a replay, the cost
    falling."""
    import random

    import numpy as np

    import paddle_tpu_torch.v2 as paddle
    from paddle_tpu_torch.nn import graph as G
    from paddle_tpu_torch.nn import layers as L
    from paddle_tpu_torch.nn import struct_costs as S

    cfg = STRUCT
    rs = np.random.RandomState(0)
    b, d, c = cfg["b"], cfg["d"], cfg["classes"]
    flat = {"x": rs.randn(b, d).astype(np.float32),
            "y": rs.randint(0, c, b).astype(np.int32)}
    q, t = cfg["queries"], cfg["docs"]
    lens = rs.randint(t // 2, t + 1, q).astype(np.int32)
    rank = {"docs": rs.randn(q, t, 46).astype(np.float32), "docs.lengths": lens,
            "rel": rs.randint(0, 3, (q, t)).astype(np.float32), "rel.lengths": lens}
    bb, k, n = cfg["beam_b"], cfg["beam_k"], cfg["beam_n"]
    beam = {"s0": rs.randn(bb, k * n).astype(np.float32),
            "sel0": np.stack([rs.permutation(k * n)[:k] for _ in range(bb)]).astype(np.int32),
            "g0": rs.randint(0, k * n, bb).astype(np.int32),
            "s1": rs.randn(bb, k * k * n).astype(np.float32),
            "sel1": np.stack([rs.permutation(k * k * n)[:k] for _ in range(bb)]).astype(np.int32),
            "g1": rs.randint(0, k * k * n, bb).astype(np.int32)}
    dist = rs.rand(c).astype(np.float32) + 0.01

    def nce(**kw):
        return S.NCECost(L.Fc(L.Data("x", shape=(d,)), d, act="tanh", name="h"),
                         L.Data("y", shape=()), num_classes=c, num_neg_samples=cfg["neg"],
                         name="cost", **kw)

    def beam_ce():
        ins = [S.BeamInput(L.Fc(L.Data(f"s{i}", shape=(w,)), w, act=None, name=f"f{i}"),
                           L.Data(f"sel{i}", shape=(k,)), L.Data(f"g{i}", shape=()))
               for i, w in enumerate((k * n, k * k * n))]
        return S.CrossEntropyOverBeam(ins, name="cost")

    cases = {
        "nce_uniform": (nce, flat),
        "nce_distribution": (lambda: nce(neg_distribution=dist), flat),
        "hsigmoid": (lambda: S.HierarchicalSigmoid(
            L.Fc(L.Data("x", shape=(d,)), d, act="tanh", name="h"), L.Data("y", shape=()),
            num_classes=c, name="cost"), flat),
        "lambda_cost": (lambda: S.LambdaCost(
            L.Fc(L.Data("docs", shape=(None, 46), is_seq=True), 1, act=None, name="h"),
            L.Data("rel", shape=(None,), is_seq=True), ndcg_num=6, name="cost"), rank),
        "cross_entropy_over_beam": (beam_ce, beam),
    }
    res = {"config": cfg, "cases": {}}
    for name, (build, batch) in cases.items():
        G.reset_name_scope()
        net = G.Network([build()])
        (vc, gc), (vp, gp) = layer_card_vs_cpu(torch, net, batch)
        errs, bad = grads_close(torch, gc, gp, SSD_GRAD_TOL)
        vc, vp = float(vc), float(vp)
        rel = abs(vc - vp) / max(abs(vp), 1e-30)
        res["cases"][name] = dict(cost_card=vc, cost_cpu=vp, cost_rel_err=rel,
                                  grad_max_abs_err=max(errs.values()), grads_outside_tol=bad)
        if not (np.isfinite(vc) and rel <= CPU_COST_RTOL) or bad:
            fail(f"struct costs {name}: card {vc} vs CPU {vp} (rel {rel}); gradients "
                 f"outside {SSD_GRAD_TOL} x max(1, max|g|): {bad}")
    print("struct_costs", json.dumps(res["cases"]), flush=True)

    book_data_home()
    res["book"] = {}
    for label, chapter, bcfg in STRUCT_BOOK:
        G.reset_name_scope()
        paddle.init(use_gpu=True, trainer_count=1, seed=0)
        random.seed(0)
        torch.cuda.reset_peak_memory_stats()
        run, step_ms, first_ms = book_step_times(lambda h: book_run(
            paddle, chapter, bcfg, BOOK_BATCHES, event_handler=h,
            before_train=zero_rnn_counts))
        tr, costs = run["trainer"].trainer, run["costs"]
        r = dict(config=bcfg, step_costs=costs, first_step_ms=first_ms,
                 ms_per_step_median=statistics.median(step_ms), graphs=len(tr.graphs),
                 replays=sum(g.replays for g in tr.graphs.values()),
                 kernel_launches=rnn_counts(), peak_memory_bytes=torch.cuda.max_memory_allocated())
        res["book"][label] = r
        print("struct_costs_book", label, json.dumps(r), flush=True)
        if len(costs) != BOOK_BATCHES or not np.isfinite(costs).all() or not costs[-1] < costs[0]:
            fail(f"{label}: costs over {BOOK_BATCHES} batches {costs}: want finite, falling")
        if r["graphs"] != 1 or r["replays"] != BOOK_BATCHES - 1:
            fail(f"{label}: {r['graphs']} graphs and {r['replays']} replays over "
                 f"{BOOK_BATCHES} batches")
    return res


V1_RNN_PROVIDER = """
import numpy as np
from paddle.trainer.PyDataProvider2 import *


def hook(settings, vocab, samples, **kwargs):
    settings.vocab, settings.samples = vocab, samples
    settings.input_types = {"word": integer_value_sequence(vocab), "label": integer_value(2)}


@provider(init_hook=hook, should_shuffle=False)
def process(settings, filename):
    rs = np.random.RandomState(0)
    half = settings.vocab // 2
    for _ in range(settings.samples):
        label = int(rs.randint(2))  # the label's words come from its half of the vocabulary
        words = rs.randint(0, half, rs.randint(17, 33)) + half * label
        yield {"word": words.tolist(), "label": label}
"""

# a bidirectional vanilla-RNN text classifier (recurrent_layer both ways)
V1_RNN_CONFIG = """
from paddle.trainer_config_helpers import *

vocab = get_config_arg("vocab", int, 1000)
emb = get_config_arg("emb", int, 64)
size = get_config_arg("size", int, 128)
batch = get_config_arg("batch", int, 64)
batches = get_config_arg("batches", int, 8)
settings(batch_size=batch, learning_rate=2e-3, learning_method=AdamOptimizer())
define_py_data_sources2(train_list="train.list", test_list=None, module="v1_rnn_provider",
                        obj="process", args={"vocab": vocab, "samples": batches * batch})
word = data_layer(name="word", size=vocab)
label = data_layer(name="label", size=2)
e = embedding_layer(input=word, size=emb)
fwd = recurrent_layer(input=fc_layer(input=e, size=size, act=LinearActivation()),
                      act=TanhActivation())
bwd = recurrent_layer(input=fc_layer(input=e, size=size, act=LinearActivation()),
                      act=TanhActivation(), reverse=True)
pooled = pooling_layer(input=concat_layer(input=[fwd, bwd]), pooling_type=MaxPooling())
outputs(classification_cost(input=fc_layer(input=pooled, size=2, act=SoftmaxActivation()),
                            label=label))
"""


def rnn_extra_phase(torch):
    """Phase 42 (see RNN_EXTRA): SimpleRnn both ways and MDLstm in every
    direction pair: the output card vs CPU within 1e-5 relative L2, each
    f32 gradient, card and CPU, within RNN_EXTRA_GRAD_REL_L2 of a float64
    run on the CPU (card vs CPU in f32 printed beside), the card's float64
    gradients within RNN_EXTRA_F64_REL_L2 of the CPU's; then V1_RNN_CONFIG
    through `train --config` for 8 steps: one graph, 7 replays, the cost
    falling, no ported kernel launched."""
    import numpy as np

    from paddle_tpu_torch.nn import graph as G
    from paddle_tpu_torch.nn import layers as L
    from paddle_tpu_torch.nn import recurrent as R

    cfg = RNN_EXTRA
    rs = np.random.RandomState(0)
    seq = {"x": rs.randn(cfg["b"], cfg["t"], cfg["h"]).astype(np.float32) * 0.5,
           "x.lengths": rs.randint(cfg["t"] // 2, cfg["t"] + 1, cfg["b"]).astype(np.int32)}
    g, hid = cfg["grid"], cfg["grid_hid"]
    grid = {"x": rs.randn(cfg["grid_b"], g, g, 5 * hid).astype(np.float32) * 0.5}
    cases = {f"simple_rnn_{'rev' if rev else 'fwd'}": (
        lambda rev=rev: R.SimpleRnn(L.Data("x", shape=(None, cfg["h"]), is_seq=True),
                                    reverse=rev, name="out"), seq, 0) for rev in (False, True)}
    for seed in (0,) + cfg["md_seeds"]:
        x = grid if seed == 0 else {"x": np.random.RandomState(seed).randn(
            cfg["grid_b"], g, g, 5 * hid).astype(np.float32) * 0.5}
        for dirs in ((True, True), (False, True), (True, False), (False, False)):
            cases[f"mdlstm_{int(dirs[0])}{int(dirs[1])}" + (f"_s{seed}" if seed else "")] = (
                lambda dirs=dirs: R.MDLstm(L.Data("x", shape=(g, g, 5 * hid)), size=hid,
                                           directions=dirs, name="out"), x, seed)
    res = {"config": cfg, "cases": {}}
    for name, (build, batch, init_seed) in cases.items():
        G.reset_name_scope()
        net = G.Network([build()])
        (vc, gc), (vp, gp), (_, g64), (_, g64c) = layer_card_vs_cpu(torch, net, batch, f64=True,
                                                                    init_seed=init_seed)
        rel = float((vc - vp).norm() / max(float(vp.norm()), 1e-30))

        def rel_to(grads, want):
            return max(float((grads[k].cpu().double() - g.cpu().double()).norm()
                             / max(float(g.cpu().double().norm()), 1e-30))
                       for k, g in want.items())

        row = dict(out_rel_l2=rel, grad_card_f64=rel_to(gc, g64), grad_cpu_f64=rel_to(gp, g64),
                   grad_card_cpu=rel_to(gc, gp), grad_card64_cpu64=rel_to(g64c, g64))
        res["cases"][name] = row
        if (not rel <= L3D_REL_L2 or row["grad_card_f64"] > RNN_EXTRA_GRAD_REL_L2
                or row["grad_cpu_f64"] > RNN_EXTRA_GRAD_REL_L2
                or row["grad_card64_cpu64"] > RNN_EXTRA_F64_REL_L2):
            fail(f"rnn_extra {name}: output card vs CPU relative L2 {rel} (<= {L3D_REL_L2}); "
                 f"gradients (largest over the parameters) {row}: f32 vs f64 <= "
                 f"{RNN_EXTRA_GRAD_REL_L2}, card f64 vs CPU f64 <= {RNN_EXTRA_F64_REL_L2}")
    print("rnn_extra", json.dumps(res["cases"]), flush=True)

    d = v1_config_dir("rnn", V1_RNN_CONFIG, V1_RNN_PROVIDER)
    zero_rnn_counts()
    rc, lines, costs, job = run_cli(d, ["train", "--config=conf.py",
                                        f"--config_args={config_args(V1_RNN)}",
                                        "--num_passes=1", "--log_period=1"], echo=False)
    launches = rnn_counts()
    graphs = list(job.trainer.graphs.values()) if job is not None else []
    v1 = dict(config=V1_RNN, rc=rc, step_costs=costs, graphs=len(graphs),
              replays=graphs[0].replays if graphs else 0, kernel_launches=launches)
    if graphs:
        b = {k: v.cpu().numpy() for k, v in graphs[0].inputs.items()}
        _, step_ms = timed_calls(torch, lambda: job.trainer.step(b), 5)
        v1["ms_per_step_median"] = statistics.median(step_ms)
    res["v1"] = v1
    print("rnn_extra_v1", json.dumps(v1), flush=True)
    if rc != 0 or len(graphs) != 1 or v1["replays"] != V1_RNN["batches"] - 1:
        fail(f"v1 recurrent_layer config: exit {rc}, {len(graphs)} graphs, {v1['replays']} "
             f"replays over {V1_RNN['batches']} steps")
    if len(costs) != V1_RNN["batches"] or not np.isfinite(costs).all() or not costs[-1] < costs[0]:
        fail(f"v1 recurrent_layer config: step costs {costs}: want finite, falling")
    if any(launches.values()):
        fail(f"v1 recurrent_layer config launched kernels it does not run: {launches}")
    return res


def layers3d_phase(torch):
    """Phase 43 (see L3D): Conv3D, Conv3DTranspose, Pool3D max / avg and a
    one-channel Conv3D, output and every gradient card vs CPU in f32 with TF32 off, each within
    L3D_REL_L2 relative L2; ms of a forward + backward on the card."""
    import numpy as np

    from paddle_tpu_torch.nn import graph as G
    from paddle_tpu_torch.nn import layers as L
    from paddle_tpu_torch.nn import layers3d as L3

    cfg = L3D
    s, c, f = cfg["d"], cfg["c"], cfg["filters"]
    rs = np.random.RandomState(0)
    xs = rs.randn(cfg["b"], s, s, s, c).astype(np.float32)
    x1 = rs.randn(cfg["b"], s, s, s, 1).astype(np.float32)
    cases = {
        "conv3d": (lambda x_: L3.Conv3D(x_, f, 3, padding=1, act="relu", name="out"), xs),
        "conv3d_transpose": (lambda x_: L3.Conv3DTranspose(
            L3.Conv3D(x_, f, 1, name="pre"), c, 2, stride=2, name="out"), xs),
        "pool3d_max": (lambda x_: L3.Pool3D(x_, 2, "max", name="out"), xs),
        "pool3d_avg": (lambda x_: L3.Pool3D(x_, 3, "avg", stride=2, padding=1, ceil_mode=True,
                                            name="out"), xs),
        "conv3d_one_channel": (lambda x_: L3.Conv3D(x_, f, 3, padding=1, name="out"), x1),
    }
    res = {"config": cfg, "cases": {}}
    for name, (build, x) in cases.items():
        G.reset_name_scope()
        net = G.Network([build(L.Data("x", shape=x.shape[1:]))])
        params = {k: v.numpy() for k, v in net.init({"x": x}, device="cpu").items()}
        outs = {}
        for dev in ("cuda", "cpu"):
            tp = {k: torch.from_numpy(v).to(dev).requires_grad_(True) for k, v in params.items()}
            xt = torch.from_numpy(x).to(dev).requires_grad_(True)

            def fwd_bwd():
                y = net.apply(tp or {"device": xt}, {"x": xt})["out"].value
                return y, torch.autograd.grad((0.5 * y * y + y).sum(),
                                              list(tp.values()) + [xt])

            y, grads = fwd_bwd()
            outs[dev] = [y.detach().cpu()] + [gr.cpu() for gr in grads]
            if dev == "cuda":
                res["cases"][name] = dict(card_ms_fwd_bwd=events_ms(torch, fwd_bwd, n=5))
        rels = [float((a - b).norm() / max(float(b.norm()), 1e-30))
                for a, b in zip(outs["cuda"], outs["cpu"])]
        res["cases"][name].update(rel_l2=rels, shape=list(outs["cpu"][0].shape))
        if max(rels) > L3D_REL_L2:
            fail(f"layers3d {name}: card vs CPU relative L2 {rels} (out, grads) > {L3D_REL_L2}")
    print("layers3d", json.dumps(res), flush=True)
    return res


def runtime_phase(torch):
    """Phase 44 (see RUNTIME): g++ builds the native library (seconds
    printed); `recordio.convert` shards mnist's synthetic records, each
    shard read back equal to the Python oracle's; a TaskMaster hands the
    shards out as tasks and the book's recognize_digits trains on what
    `read_shards` gives, through paddle.v2's trainer (DataFeeder) as one
    step graph, the cost falling; a HostPool array stages one batch; one
    native update of each optimizer type against the port's optim/."""
    import pickle
    import random
    import tempfile

    import numpy as np

    import paddle_tpu_torch.v2 as paddle
    from paddle_tpu_torch import optim
    from paddle_tpu_torch.nn import graph as G
    from paddle_tpu_torch.runtime import build, recordio
    from paddle_tpu_torch.runtime.allocator import HostPool
    from paddle_tpu_torch.runtime.master import TaskMaster
    from paddle_tpu_torch.runtime.optimizer import NativeOptimizer

    cfg = RUNTIME
    t0 = time.perf_counter()
    lib = build.build()
    res = dict(config=cfg, build_s=time.perf_counter() - t0, library=os.path.relpath(lib, REPO))
    book_data_home()
    samples = list(itertools.islice(paddle.dataset.mnist.train()(), cfg["records"]))
    shard_dir = tempfile.mkdtemp(prefix="recordio-", dir=os.path.join(REPO, "build"))
    t0 = time.perf_counter()
    shards = recordio.convert(shard_dir, lambda: iter(samples), records_per_file=cfg["per_shard"])
    res["convert_s"] = time.perf_counter() - t0
    for p in shards:
        if list(recordio.Reader(p)) != list(recordio._py_read(p)):
            fail(f"runtime: {p}: the native reader's records differ from the oracle's")
    master = TaskMaster(timeout_s=600, failure_max=2)
    master.set_dataset(shards, chunks_per_task=1)
    read, tasks = [], []

    def master_reader():
        while True:
            task = master.get_task()
            if task is None or task[0] == TaskMaster.PASS_FINISHED:
                return
            tasks.append(task[0])
            for s in recordio.read_shards(task[1]):
                read.append(s)
                yield s
            master.task_finished(task[0])

    G.reset_name_scope()
    paddle.init(use_gpu=True, trainer_count=1, seed=0)
    random.seed(0)
    ch = BOOK_CHAPTERS["recognize_digits"](paddle, BOOK["recognize_digits"])
    params = paddle.parameters.create(ch["cost"])
    trainer = paddle.trainer.SGD(cost=ch["cost"], parameters=params,
                                 update_equation=ch["optimizer"], extra_layers=ch["extra"])
    costs, calls = [], []
    batched = paddle.batch(master_reader, cfg["batch"])

    def reader():
        calls.append(1)
        if len(calls) == 1:  # the trainer's first look, to build its state
            return iter([samples[:cfg["batch"]]])
        return itertools.islice(batched(), cfg["steps"])

    trainer.train(reader=reader, num_passes=1, feeding=ch["feeding"],
                  event_handler=lambda e: costs.append(float(e.cost))
                  if type(e).__name__ == "EndIteration" else None)
    tr = trainer.trainer
    res.update(shards=len(shards), tasks=len(tasks), records_read=len(read),
               master=master.stats(), step_costs=costs, graphs=len(tr.graphs),
               replays=sum(g.replays for g in tr.graphs.values()))
    same = [pickle.dumps(a) for a in read] == [pickle.dumps(a) for a in samples[:len(read)]]
    if not same or len(read) < cfg["steps"] * cfg["batch"]:
        fail(f"runtime: {len(read)} records read through the task master, not mnist's first")
    if not (np.isfinite(costs).all() and costs[-1] < costs[0]) or res["graphs"] != 1:
        fail(f"runtime: recognize_digits over the shards: costs {costs}, {res['graphs']} "
             "graphs: want finite, falling, one graph")
    master.close()
    # one batch staged in the host pool, then moved to the card
    pool = HostPool(total_bytes=64 << 20)
    images = np.stack([np.asarray(s[0], np.float32) for s in samples[:cfg["batch"]]])
    staged = pool.ndarray(images.shape, np.float32)
    staged[:] = images
    on_card = torch.from_numpy(staged).to("cuda")
    res["host_pool"] = dict(pool.stats(), staged_equal=bool(
        torch.equal(on_card.cpu(), torch.from_numpy(images))))
    pool.release(staged)
    del staged, on_card
    if not res["host_pool"]["staged_equal"] or pool.stats()["in_use"] != 0:
        fail(f"runtime: host pool staging {res['host_pool']}")
    pool.close()
    # one native update of each type against the port's optimizers (host)
    rs = np.random.RandomState(0)
    p0, g0 = rs.randn(4096).astype(np.float32), rs.randn(4096).astype(np.float32)
    res["optimizers"] = {}
    for kind, kw, opt in (
            ("sgd", dict(learning_rate=0.1, momentum=0.9), optim.SGD(learning_rate=0.1,
                                                                      momentum=0.9)),
            ("adagrad", dict(learning_rate=0.1, epsilon=1e-6),
             optim.AdaGrad(learning_rate=0.1, epsilon=1e-6)),
            ("adadelta", dict(learning_rate=1.0, rho=0.95, epsilon=1e-6),
             optim.AdaDelta(learning_rate=1.0, rho=0.95, epsilon=1e-6)),
            ("adam", dict(learning_rate=0.01), optim.Adam(learning_rate=0.01))):
        p_nat = p0.copy()
        NativeOptimizer(kind, **kw).update(p_nat, g0)
        tp = {"w": torch.from_numpy(p0.copy())}
        opt.update({"w": torch.from_numpy(g0)}, opt.init_state(tp), tp, kw["learning_rate"])
        err = float(np.abs(p_nat - tp["w"].numpy()).max())
        res["optimizers"][kind] = err
        if err > 1e-5:
            fail(f"runtime: native {kind} update differs from optim/ by {err}")
    print("runtime", json.dumps(res), flush=True)
    return res


# -- 45-46: the serving fleet ---------------------------------------------------

FLEET = dict(replicas=3, requests=48, gap_s=0.05, lease_s=0.8, poll_s=0.01,
             stall_fence_s=0.2, wedge_s=2.0, late_grace_s=30.0, retention_min=0.7,
             recapture_requests=12, recapture_step=10)
FLEET_SAMPLED = dict(temperature=0.8, top_k=20)
FLEET_PROC = dict(lease_s=2.0, batch=16, standby_poll_s=0.1)
WARM_PROMPT = [1, 5, 9, 11]


def fleet_requests(torch, bos_id):
    """Phase 45's 48 requests: PROMPT_LENS' mix in turn, odd ones sampled
    under their own seed (1000 + i), even ones greedy."""
    rng = torch.Generator().manual_seed(45)
    reqs = []
    for i in range(FLEET["requests"]):
        n = PROMPT_LENS[i % len(PROMPT_LENS)]
        prompt = [bos_id] + torch.randint(3, GPT2_SMALL["vocab"], (n - 1,),
                                          generator=rng).tolist()
        reqs.append((prompt, dict(FLEET_SAMPLED, seed=1000 + i) if i % 2 else {}))
    return reqs


def named_reasons() -> set:
    from paddle_tpu_torch.serving import FinishReason

    return {v for k, v in vars(FinishReason).items()
            if not k.startswith("_") and isinstance(v, str)}


def warmed_session():
    """A phase-4 session on its supervised engine thread, warmed there: its
    first decode step runs eagerly and the step is captured before the
    replica joins a fleet (a capture must not outlast a lease); the load
    estimate the warm-up left is forgotten."""
    sess = gpt2_session(engine_stall_timeout_s=300.0, engine_restart_max=5)
    sess.serve_forever()
    h = sess.submit(WARM_PROMPT, 4)
    if not h._event.wait(120.0) or sess.decode_graph_captures != 1:
        fail(f"fleet: a replica did not warm up ({sess.decode_graph_captures} captures)")
    sess.scheduler.reset_load_estimate()
    return sess


def percentile(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(round(q * (len(xs) - 1))))]


def ttft_ms(handles):
    t = [(h.t_first_token - h.t_submit) * 1e3 for h in handles
         if h.t_first_token is not None]
    return dict(p50=percentile(t, 0.5), p99=percentile(t, 0.99)) if t else None


def open_loop(submit, reqs, gap_s, before=None, timeout_s=180.0):
    """Submit `reqs` one every `gap_s` (open loop; a shed is counted), then
    wait for every handle -> (handles by index, shed, wall s)."""
    from paddle_tpu_torch.serving import QuotaExceeded

    handles, shed = {}, 0
    t0 = time.perf_counter()
    for i, (prompt, sampling) in enumerate(reqs):
        if before is not None:
            before(i)
        try:
            handles[i] = submit(i, prompt, sampling)
        except QuotaExceeded:
            shed += 1
        if gap_s:
            time.sleep(gap_s)
    for h in handles.values():
        h._event.wait(max(0.1, timeout_s - (time.perf_counter() - t0)))
    return handles, shed, time.perf_counter() - t0


class Fleet:
    """Phase 45's fleet: a RouterServer and `n` warmed in-process replicas,
    with the router's replica forwards and batch polls counted."""

    def __init__(self, n):
        from paddle_tpu_torch.serving import ServingServer
        from paddle_tpu_torch.serving.router import RouterServer

        self.server = RouterServer(lease_s=FLEET["lease_s"], poll_interval_s=FLEET["poll_s"],
                                   late_grace_s=FLEET["late_grace_s"]).start()
        self.router = r = self.server.router
        self.rpcs = dict(forward=0, poll_many=0)
        self.forward_s = []
        forward, pump = r._forward, r._pump_once

        def counted_forward(*a, **kw):
            self.rpcs["forward"] += 1
            t = time.perf_counter()
            try:
                return forward(*a, **kw)
            finally:
                self.forward_s.append(time.perf_counter() - t)

        def counted_pump(*a, **kw):
            ok = pump(*a, **kw)
            if ok is not None:
                self.rpcs["poll_many"] += 1
            return ok

        r._forward, r._pump_once = counted_forward, counted_pump
        self.replicas = []
        for _ in range(n):
            sess = warmed_session()
            srv = ServingServer(sess, router_endpoints=self.server.address,
                                stall_fence_s=FLEET["stall_fence_s"]).start()
            self.replicas.append((srv, sess))
            deadline = time.monotonic() + 30
            while len(self.server.fleet.live()) < len(self.replicas):
                if time.monotonic() > deadline:
                    fail("fleet: a replica did not join the router")
                time.sleep(0.01)

    def submit(self, i, prompt, sampling):
        return self.router.submit(prompt, NEW_TOKENS, tenant=f"tenant{i % 3}",
                                  deadline_s=120.0, **sampling)

    def counts(self):
        return [(s.decode_steps, s.decode_graph_captures) for _, s in self.replicas]

    def replica_handle(self, h):
        """The replica-side RequestHandle that delivered fleet request `h`
        (same process, same monotonic clock), or None."""
        rep = self.server.fleet.get(h.delivered_by) if h.delivered_by else None
        for srv, _ in self.replicas:
            if rep is not None and tuple(srv.address) == rep.endpoint:
                with srv._handles_lock:
                    rid = srv._by_client_id.get((h.tenant, h.key))
                    return srv._handles.get(rid) if rid is not None else None
        return None

    def breakdown(self, handles):
        """Where a fleet request's time went, medians in ms: the submit
        forward's RPC, submit -> the replica's admission stamp, the
        replica's own TTFT (queue and prefill), its first token -> the
        router's mirror (the pump cycle), the replica's ms a decoded token,
        its last token -> the router's delivery."""
        rows = [(h, self.replica_handle(h)) for h in handles.values()]
        rows = [(h, sh) for h, sh in rows if sh is not None and sh.t_first_token
                and h.t_first_token and sh.t_done and h.t_done]

        def med(xs):
            return statistics.median(xs) * 1e3 if xs else None

        return dict(
            requests=len(rows), forward_rpc_ms=med(self.forward_s),
            submit_to_replica_ms=med([sh.t_submit - h.t_submit for h, sh in rows]),
            replica_ttft_ms=med([sh.t_first_token - sh.t_submit for h, sh in rows]),
            pump_first_token_ms=med([h.t_first_token - sh.t_first_token for h, sh in rows]),
            decode_ms_per_token=med([(sh.t_done - sh.t_first_token) / max(1, len(sh.tokens) - 1)
                                     for h, sh in rows]),
            pump_delivery_ms=med([h.t_done - sh.t_done for h, sh in rows]),
        )

    def close(self, killed=()):
        for k, (srv, _) in enumerate(self.replicas):
            (srv.kill if k in killed else srv.stop)()
        self.server.stop()


def fleet_run_stats(handles, shed, wall):
    done = {i: list(h.tokens) for i, h in handles.items()
            if h.done and h.status == h.DONE}
    reasons = {}
    for h in handles.values():
        reasons[h.finish_reason] = reasons.get(h.finish_reason, 0) + 1
    return dict(
        accepted=len(handles), shed=shed, completed=len(done), wall_s=wall,
        goodput_rps=len(done) / wall, tokens_per_s=sum(map(len, done.values())) / wall,
        finish_reasons=reasons, ttft_ms=ttft_ms(handles.values()),
        all_named=all(h.done for h in handles.values())
        and all(h.finish_reason in named_reasons() for h in handles.values()),
    ), done


def fleet_phase(torch, smi):
    """Phase 45 (see the module docstring)."""
    from paddle_tpu_torch.core import faults
    from paddle_tpu_torch.ops import paged_attention as pa

    n_layers = GPT2_SMALL["n_layers"]
    out = dict(config=dict(FLEET, new_tokens=NEW_TOKENS, prompt_lens=list(PROMPT_LENS)),
               nvidia_smi=smi)

    # the direct single session: the same open-loop requests
    direct = warmed_session()
    reqs = fleet_requests(torch, direct.cfg.bos_id)
    hs, _, wall = open_loop(lambda i, p, s: direct.submit(p, NEW_TOKENS, **s), reqs,
                            FLEET["gap_s"])
    ref = {i: list(h.tokens) for i, h in hs.items()}
    out["direct"] = dict(wall_s=wall, ttft_ms=ttft_ms(hs.values()),
                         tokens_per_s=sum(map(len, ref.values())) / wall)
    direct.stop()
    del direct, hs
    release(torch)

    # the unfaulted fleet: open loop, then one recapture mid-run
    fleet = Fleet(FLEET["replicas"])
    try:
        counts0 = fleet.counts()
        pa.LAUNCHES = 0
        hs, shed, wall = open_loop(fleet.submit, reqs, FLEET["gap_s"])
        launches = pa.LAUNCHES
        steps = sum(a[0] - b[0] for a, b in zip(fleet.counts(), counts0))
        clean, clean_toks = fleet_run_stats(hs, shed, wall)
        clean.update(launches=launches, decode_steps=steps,
                     breakdown=fleet.breakdown(hs),
                     rpcs=dict(fleet.rpcs), rpcs_per_request=(
                         fleet.rpcs["forward"] + fleet.rpcs["poll_many"]) / max(1, len(hs)),
                     poll_many_per_result=fleet.rpcs["poll_many"] / max(1, len(hs)))
        out["clean"] = clean
        if clean_toks != ref or shed:
            bad = [i for i in ref if clean_toks.get(i) != ref[i]]
            fail(f"fleet: unfaulted tokens differ from the direct session at {bad} "
                 f"(shed {shed})")
        if launches != steps * n_layers:
            fail(f"fleet: {launches} decode kernel launches in {steps} decode steps")
        restarts0 = [s.engine_restarts for _, s in fleet.replicas]
        with faults.inject(f"decode_raise:step={FLEET['recapture_step']}") as inj:
            hs, _, wall = open_loop(fleet.submit, reqs[:FLEET["recapture_requests"]],
                                    FLEET["gap_s"])
            fired = inj.fired.get("decode_raise", 0)
        restarted = [k for k, (_, s) in enumerate(fleet.replicas)
                     if s.engine_restarts > restarts0[k]]
        captures = [s.decode_graph_captures for _, s in fleet.replicas]
        out["recapture"] = dict(fired=fired, restarted=restarted, captures=captures,
                                wall_s=wall)
        if (fired != 1 or len(restarted) != 1
                or captures != [2 if k in restarted else 1 for k in range(len(captures))]):
            fail(f"fleet: recapture run: {out['recapture']}")
        if {i: list(h.tokens) for i, h in hs.items()} != {
                i: ref[i] for i in range(FLEET["recapture_requests"])}:
            fail("fleet: tokens changed across a replica's recapture mid-run")
        out["clean"]["replicas"] = [
            dict(decode_steps=s.decode_steps, captures=s.decode_graph_captures,
                 graph_replays=s.decode_steps - s.decode_graph_captures,
                 kernel_calls=s._decode_graph.kernel_calls)
            for _, s in fleet.replicas]
    finally:
        fleet.close()
    del fleet, hs
    release(torch)

    # the faulted fleet: replica 0 killed, replica 1 wedged past its lease
    fleet = Fleet(FLEET["replicas"])
    timer = None
    killed = {}
    try:
        counts0 = fleet.counts()
        r = fleet.router
        pa.LAUNCHES = 0

        def fault(i):
            nonlocal timer
            if i == FLEET["requests"] // 4:
                killed["t"] = time.monotonic()
                rid = next(x.replica_id for x in fleet.server.fleet.replicas() if x.index == 0)
                with r._lock:
                    killed["handles"] = [h for h in r._handles.values()
                                         if rid in h.assignments and not h.done]
                fleet.replicas[0][0].kill()
            if i == FLEET["requests"] // 2:
                lock = fleet.replicas[1][1]._gen_lock
                lock.acquire()
                timer = threading.Timer(FLEET["wedge_s"], lock.release)
                timer.start()

        hs, shed, wall = open_loop(fleet.submit, reqs, FLEET["gap_s"], before=fault)
        timer.join()
        survivors = fleet.replicas[1:]
        deadline = time.monotonic() + 60
        while (any(s.scheduler.has_work() for _, s in survivors)
               or r.late_results_dropped < 1) and time.monotonic() < deadline:
            time.sleep(0.05)
        launches = pa.LAUNCHES
        steps = sum(a[0] - b[0] for a, b in zip(fleet.counts(), counts0))
        faulted, fault_toks = fleet_run_stats(hs, shed, wall)
        # the killed replica's in-flight requests: their first token on the
        # survivor that took them (the survivor's own handle, same clock)
        firsts = []
        for h in killed["handles"]:
            for srv, _ in survivors:
                with srv._handles_lock:
                    rid = srv._by_client_id.get((h.tenant, h.key))
                    sh = srv._handles.get(rid) if rid is not None else None
                if sh is not None and sh.t_first_token is not None:
                    firsts.append(sh.t_first_token - killed["t"])
        mismatch = [i for i, t in fault_toks.items() if t != clean_toks.get(i)]
        faulted.update(
            failovers=r.failovers, replica_evictions=r.replica_evictions,
            late_results_dropped=r.late_results_dropped, launches=launches,
            decode_steps=steps, mismatched=mismatch,
            greedy_checked=sum(1 for i in fault_toks if i % 2 == 0),
            sampled_checked=sum(1 for i in fault_toks if i % 2 == 1),
            killed_in_flight=len(killed["handles"]),
            kill_to_first_token_s=min(firsts) if firsts else None,
            kill_to_last_first_token_s=max(firsts) if firsts else None,
            pages_in_use_survivors=[s.cache.pages_in_use for _, s in survivors],
            kernel_calls=[s._decode_graph.kernel_calls for _, s in fleet.replicas],
            rpcs=dict(fleet.rpcs),
        )
        faulted["goodput_retention"] = faulted["goodput_rps"] / clean["goodput_rps"]
        out["faulted"] = faulted
    finally:
        if timer is not None:
            timer.join()
        fleet.close(killed=(0,))
    print("fleet", json.dumps(out), flush=True)
    f = out["faulted"]
    if not (clean["all_named"] and f["all_named"]):
        fail(f"fleet: a request ended without a named reason: {f['finish_reasons']}")
    if f["shed"] or f["completed"] != f["accepted"]:
        # one replica lives throughout: nothing may end other than done
        fail(f"fleet: faulted run: {f['shed']} shed, {f['finish_reasons']}")
    if f["mismatched"] or not (f["greedy_checked"] and f["sampled_checked"]):
        fail(f"fleet: faulted tokens differ from the unfaulted run at {f['mismatched']}")
    if f["failovers"] < 1 or f["replica_evictions"] < 2 or f["late_results_dropped"] < 1:
        fail(f"fleet: failovers {f['failovers']}, evictions {f['replica_evictions']}, "
             f"late winners {f['late_results_dropped']}")
    if any(f["pages_in_use_survivors"]):
        fail(f"fleet: pages leaked on a survivor: {f['pages_in_use_survivors']}")
    if f["launches"] != f["decode_steps"] * n_layers or set(f["kernel_calls"]) != {n_layers}:
        fail(f"fleet: {f['launches']} launches in {f['decode_steps']} decode steps, "
             f"graphs holding {f['kernel_calls']} kernel calls")
    if not f["goodput_retention"] >= FLEET["retention_min"]:
        fail(f"fleet: goodput retention {f['goodput_retention']:.3f} < "
             f"{FLEET['retention_min']}")
    del fleet, hs
    release(torch)
    out["reqs"] = reqs
    out["tokens"] = clean_toks
    return out


def free_port() -> int:
    """A free local port, for a standby that binds it only at takeover."""
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def spawn(args, name, env):
    """Start `python -m <args>` from the repository root; its stderr goes to
    build/fleet_<name>.err."""
    with open(os.path.join(REPO, "build", f"fleet_{name}.err"), "w") as err:
        return subprocess.Popen([sys.executable, "-m", *args], cwd=REPO, env=env,
                                stdout=subprocess.PIPE, stderr=err, text=True)


def first_json(proc, name):
    """A spawned process's first stdout line, as JSON (120 s at most)."""
    import select

    ready, _, _ = select.select([proc.stdout], [], [], 120.0)
    line = proc.stdout.readline() if ready else ""
    if not line:
        proc.kill()
        with open(os.path.join(REPO, "build", f"fleet_{name}.err")) as f:
            tail = f.read()[-2000:]
        fail(f"fleet_processes: {name} did not start: {tail}")
    return json.loads(line)


def stream_batch(endpoints, reqs, idx, on_started=None):
    """One ServingClient a stream (both router endpoints) for each request
    index in `idx`, in threads; `on_started` runs once every thread is
    started -> {index: tokens}, {index: error}."""
    from paddle_tpu_torch.serving import ServingClient

    got, errs = {}, {}

    def run(i):
        prompt, sampling = reqs[i]
        c = ServingClient(endpoints, timeout=5.0)
        toks = []
        try:
            for fr in c.stream(prompt, NEW_TOKENS, reattach_retries=60,
                               client_req_id=f"fleet-proc-{i}", **sampling):
                toks.extend(fr["tokens"])
                if fr.get("done"):
                    break
            got[i] = toks
        except Exception as e:  # reported by the caller's gate
            errs[i] = repr(e)
        finally:
            c.close()

    threads = [threading.Thread(target=run, args=(i,), daemon=True) for i in idx]
    for t in threads:
        t.start()
    if on_started is not None:
        on_started()
    for t in threads:
        t.join(180.0)
    return got, errs


def wait_idle(probe, timeout_s=30.0):
    """Poll a router's `replicas` view until every live replica's last
    heartbeat reported an idle engine and the router has nothing in flight
    there: the least-loaded choice reads the heartbeats' load, so a
    snapshot taken during a burst would steer the next requests."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        reps = [r for r in probe.call("replicas")["replicas"] if r["state"] == "live"]
        if all(r["outstanding"] == 0 and not r["load"].get("queue_depth")
               and not r["load"].get("active_slots") for r in reps):
            return
        time.sleep(0.02)
    fail(f"fleet_processes: the replicas did not report idle: {reps}")


def wait_in_flight(probe, endpoint, n=1, timeout_s=60.0):
    """Poll a router's `replicas` view until the replica at `endpoint` has
    at least `n` requests in flight there."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        for r in probe.call("replicas")["replicas"]:
            if tuple(r["endpoint"]) == tuple(endpoint) and r["outstanding"] >= n:
                return r["outstanding"]
        time.sleep(0.002)
    fail(f"fleet_processes: no request in flight on {endpoint}")


def fleet_process_phase(torch, smi, fleet):
    """Phase 46 (see the module docstring)."""
    import signal

    from paddle_tpu_torch.runtime.master import MasterClient
    from paddle_tpu_torch.serving import ServingClient
    from paddle_tpu_torch.serving.router import RouterStandby

    reqs, want = fleet["reqs"], fleet["tokens"]
    env = dict(os.environ, PYTHONPATH=REPO)
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    procs = {}
    standby_box = {}
    stop_standby = threading.Event()
    out = dict(config=dict(FLEET_PROC), nvidia_smi=smi)
    try:
        # the router and both replicas start together (each process takes
        # seconds to import torch and reach the card); a replica that finds
        # no router yet retries its registration from its heartbeat loop
        primary = ("127.0.0.1", free_port())
        procs["router"] = spawn(
            ["paddle_tpu_torch.serving.router", "serve", "--port", str(primary[1]),
             "--lease_s", str(FLEET_PROC["lease_s"])], "router", env)
        sb_port = free_port()
        endpoints = [list(primary), ["127.0.0.1", sb_port]]
        flags = ["--vocab", str(SERVE["vocab"]), "--n_layers", str(SERVE["n_layers"]),
                 "--d_model", str(SERVE["d_model"]), "--n_heads", str(SERVE["n_heads"]),
                 "--max_len", str(SERVE["max_len"]), "--max_slots", str(SERVE["max_slots"]),
                 "--page_size", str(SERVE["page_size"]),
                 "--prefill_buckets", ",".join(map(str, SERVE["prefill_buckets"])),
                 "--prefill_chunk", str(SERVE["prefill_chunk"]),
                 "--max_new_limit", str(SERVE["max_new_limit"]), "--seed", str(SERVE["seed"]),
                 "--router_endpoints", ",".join(f"{h}:{p}" for h, p in endpoints),
                 "--stall_fence_s", "30", "--engine_stall_timeout_s", "300"]
        names = ("replica_a", "replica_b")
        for name in names:
            procs[name] = spawn(["paddle_tpu_torch", "serve", "--demo", "--device",
                                 "cuda", *flags], name, env)
        if tuple(first_json(procs["router"], "router")["address"]) != primary:
            fail("fleet_processes: the router is not on its port")
        # the standby watches only a listening primary: armed before the
        # router listens, it would count the refused probes as a death
        standby = RouterStandby(primary, port=sb_port, poll_s=FLEET_PROC["standby_poll_s"],
                                lease_s=FLEET_PROC["lease_s"], stop_evt=stop_standby)
        threading.Thread(target=lambda: standby_box.update(
            srv=standby.run(), t_takeover=time.monotonic()), daemon=True).start()
        addrs = {name: tuple(first_json(procs[name], name)["address"])
                 for name in names}
        via = ServingClient(primary, timeout=10.0)
        deadline = time.monotonic() + 60
        while via.stats()["live_replicas"] < 2:
            if time.monotonic() > deadline:
                fail("fleet_processes: the replicas did not join the router")
            time.sleep(0.05)
        for a in addrs.values():  # each replica's first decode step and capture
            c = ServingClient(a)
            c.generate(WARM_PROMPT, 4, timeout_s=120.0)
            c.close()

        def burst(client, idx):
            t0 = time.perf_counter()
            rids = {i: client.submit(reqs[i][0], NEW_TOKENS, client_req_id=f"burst-{t0}-{i}",
                                     **reqs[i][1]) for i in idx}
            toks = {}
            while len(toks) < len(rids):
                for i, rid in rids.items():
                    if i not in toks:
                        r = client.poll(rid)
                        if r.get("done"):
                            toks[i] = list(r["tokens"])
                time.sleep(0.005)
            wall = time.perf_counter() - t0
            return toks, sum(map(len, toks.values())) / wall

        idx = list(range(FLEET_PROC["batch"]))
        toks, out["fleet_burst_tokens_per_s"] = burst(via, idx)
        one = ServingClient(addrs["replica_a"])
        toks1, out["one_replica_burst_tokens_per_s"] = burst(one, idx)
        one.close()
        if toks != {i: want[i] for i in idx} or toks1 != toks:
            fail("fleet_processes: burst tokens differ from phase 45's unfaulted run")

        # fault 1: replica A SIGKILLed with streams in flight on it
        kill = {}
        probe = MasterClient(primary, timeout=10.0)
        wait_idle(probe)

        def kill_a():
            kill["in_flight"] = wait_in_flight(probe, addrs["replica_a"])
            kill["t"] = time.monotonic()
            procs["replica_a"].send_signal(signal.SIGKILL)

        b1 = list(range(FLEET_PROC["batch"]))
        got, errs = stream_batch(endpoints, reqs, b1, kill_a)
        out["replica_kill_to_done_s"] = time.monotonic() - kill["t"]
        out["replica_killed_in_flight"] = kill["in_flight"]
        st = via.stats()
        out["after_replica_kill"] = {k: st[k] for k in (
            "failovers", "replica_evictions", "live_replicas", "completed")}
        if errs or got != {i: want[i] for i in b1}:
            fail(f"fleet_processes: after the replica kill: errors {errs}, tokens "
                 f"equal {got == {i: want[i] for i in b1}}")
        if st["failovers"] < 1 or st["live_replicas"] != 1:
            fail(f"fleet_processes: after the replica kill: {out['after_replica_kill']}")
        via.close()

        # fault 2: the router process SIGKILLed with 16 more in flight
        def kill_router():
            kill["router_in_flight"] = wait_in_flight(probe, addrs["replica_b"])
            probe.close()
            kill["router"] = time.monotonic()
            procs["router"].send_signal(signal.SIGKILL)
            threading.Thread(target=watch_rejoin, daemon=True).start()

        def watch_rejoin():
            deadline = time.monotonic() + 120
            while time.monotonic() < deadline:
                srv = standby_box.get("srv")
                if srv is not None and srv.fleet.live():
                    kill["rejoin"] = time.monotonic()
                    return
                time.sleep(0.005)

        b2 = list(range(FLEET_PROC["batch"], 2 * FLEET_PROC["batch"]))
        got, errs = stream_batch(endpoints, reqs, b2, kill_router)
        t_done = time.monotonic()
        deadline = time.monotonic() + 30
        while "srv" not in standby_box and time.monotonic() < deadline:
            time.sleep(0.01)
        new = standby_box.get("srv")
        if new is None or standby_box["t_takeover"] < kill["router"]:
            fail("fleet_processes: the standby did not take over after the kill")
        out["takeover"] = dict(
            kill_to_done_s=t_done - kill["router"],
            adopted=new.router.adopted, completed=new.router.completed,
            live_replicas=len(new.fleet.live()), instance=new.router.instance,
            in_flight_at_kill=kill["router_in_flight"],
            takeover_s=standby_box["t_takeover"] - kill["router"],
            rejoin_s=kill.get("rejoin", t_done) - kill["router"],
        )
        if errs or got != {i: want[i] for i in b2}:
            fail(f"fleet_processes: after the router kill: errors {errs}, tokens "
                 f"equal {got == {i: want[i] for i in b2}}")
        if new.router.adopted < 1:
            fail(f"fleet_processes: the standby's sweep adopted nothing: {out['takeover']}")

        # the survivor: no page leaked; its launches = its decode steps x 12
        c = ServingClient(addrs["replica_b"])
        deadline = time.monotonic() + 30
        while c.stats()["pages_in_use"] and time.monotonic() < deadline:
            time.sleep(0.05)
        st = c.stats()
        c.close()
        procs["replica_b"].send_signal(signal.SIGTERM)
        final = json.loads(procs["replica_b"].communicate(timeout=60)[0].strip().splitlines()[-1])
        out["survivor"] = dict(
            pages_in_use=st["pages_in_use"], decode_steps=final["final_stats"]["decode_steps"],
            captures=final["final_stats"]["decode_graph_captures"],
            launches=final["paged_attention_launches"], exit=procs["replica_b"].returncode)
        out["survivor"]["graph_replays"] = (out["survivor"]["decode_steps"]
                                            - out["survivor"]["captures"])
        print("fleet_processes", json.dumps(out), flush=True)
        sv = out["survivor"]
        if sv["pages_in_use"] or sv["exit"] != 0:
            fail(f"fleet_processes: survivor {sv}")
        if sv["launches"] != sv["decode_steps"] * GPT2_SMALL["n_layers"]:
            fail(f"fleet_processes: the survivor launched the decode kernel "
                 f"{sv['launches']} times in {sv['decode_steps']} decode steps")
        return out
    finally:
        stop_standby.set()
        if standby_box.get("srv") is not None:
            standby_box["srv"].stop()
        for p in procs.values():
            if p.poll() is None:
                p.kill()
            p.wait(30)


# phase 47: the task master in front of two CLI trainers of phase 21's
# config at full width (vocab 30000, 512, batch 128, lengths 30-50), phase
# 21's 24 batches of samples pickled into recordio shards of one batch each
# (one task a shard); the primary dies to master_kill on its kill_step-th
# RPC, mid-pass; a standby process on the same snapshot takes over. 1 test
# batch at the pass end
CLUSTER = dict(tasks=24, kill_step=11, lease_s=30.0, standby_poll_s=0.05,
               test_batches=1)
# phase 48: the autoscaler in front of GPT-2-small replicas (phase 4's
# widths) and a trainer of phase 47, one card: the controller's chips are
# logical (3: a replica and the training world at the start, one free).
# The trainer is paced by the h2d_delay site (one batch a h2d_delay_ms) so
# it trains through the whole drill. The thresholds and rate limits are
# this drill's, set from its measured signals (PERF.md §6): a
# spawned replica is live in the router's view ~12 s after its spawn, so
# the burst (phase 45's 48 requests 4 times) outlasts the spawn, and the
# serving cooldown (20 s) keeps the drain after the burst and a second
# spawn from being ordered before the first one is seen; the router's
# queue-wait estimate reads 0.8-1.3 s idle after a burst and tens of s in
# one. The module's defaults stay the JAX package's
AUTOSCALE = dict(chips=3, min_replicas=1, max_replicas=2, initial_world=1,
                 tick_s=0.25, router_lease_s=1.5, master_lease_s=2.0,
                 burst_repeat=4, h2d_delay_ms=100, repeat_tasks=60,
                 config=dict(high_wait_s=10.0, low_wait_s=2.0, high_ticks=2, low_ticks=4,
                             serving_cooldown_s=20.0, train_cooldown_s=4.0,
                             flap_window_s=6.0, startup_quiet_s=6.0,
                             drain_deadline_s=30.0, resize_timeout_s=30.0,
                             train_min_world=0, train_max_world=2))


def phase21_samples(n):
    """Phase 21's training samples (V1_BIGRU_PROVIDER's, file "train")."""
    import numpy as np

    rs = np.random.RandomState(0)
    out = []
    for _ in range(n):
        label = int(rs.randint(2))
        ids = rs.randint(3, V1_BIGRU["vocab"], size=rs.randint(
            V1_BIGRU["min_len"], V1_BIGRU["max_len"] + 1))
        ids[:4] = 1 + label
        out.append({"word": ids.tolist(), "label": label})
    return out


def cluster_trainer(torch, conf_dir: str, argv) -> int:
    """`chip_smoke.py --cluster-trainer CONF_DIR ARGS`: one trainer process
    of phases 47-48. It runs the CLI's `train` command (what `python -m
    paddle_tpu_torch train ARGS` runs) in this process, from CONF_DIR, and
    prints one line: the exit code, the GRU launches, the step graphs, each
    logged step's wall-clock stamp and cost, the wall-clock stamps of its
    first failed master RPCs, and the fault-tolerance events."""
    import logging

    sys.path.insert(0, REPO)
    from paddle_tpu_torch.core import stats

    stamps, rpc_failures = [], []

    class Stamp(logging.Handler):
        def emit(self, r):
            msg = r.getMessage()
            if " cost=" in msg:
                stamps.append((time.time(), float(msg.rsplit("cost=", 1)[1])))
            elif " failed (" in msg:  # the master client's reconnect warning
                rpc_failures.append(r.created)

    for name in ("paddle_tpu_torch.trainer", "paddle_tpu_torch.master"):
        logging.getLogger(name).setLevel(logging.INFO)
        logging.getLogger(name).addHandler(Stamp())
    zero_rnn_counts()
    rc, lines, _, job = run_cli(conf_dir, ["train", "--config=conf.py", *argv], echo=False)
    graphs = list(job.trainer.graphs.values())
    print(json.dumps({
        "rc": rc, "launches": rnn_counts(), "graphs": len(graphs),
        "replays": sum(g.replays for g in graphs),
        "samples": int(job.trainer.state["samples"]) if job.trainer.state else 0,
        "stamps": stamps, "rpc_failures": rpc_failures[:8],
        "pass_lines": [l for l in lines if l.startswith("pass ")],
        "ft": stats.FT_EVENTS.as_dict()}), flush=True)
    return 0


def cluster_dir(tasks: int, repeat: int = 1):
    """Phase 21's config and provider in a fresh directory, and phase 21's
    first `tasks` batches of samples in recordio shards of one batch each
    -> (the directory, the shard list repeated `repeat` times)."""
    from paddle_tpu_torch.runtime import recordio

    d = v1_config_dir("bigru", V1_BIGRU_CONFIG, V1_BIGRU_PROVIDER)
    b = V1_BIGRU["batch"]
    samples = phase21_samples(tasks * b)
    shards = recordio.convert(os.path.join(d, "shards"), lambda: iter(samples),
                              records_per_file=b)
    if len(shards) != tasks:
        fail(f"cluster: {len(shards)} shards for {tasks} batches")
    return d, shards * repeat


def trainer_cmd(conf_dir, endpoints, *extra):
    cfg = V1_BIGRU
    args = (f"--config_args=batches={CLUSTER['tasks']},test_batches="
            f"{CLUSTER['test_batches']}")
    return [os.path.join(REPO, "chip_smoke.py"), "--cluster-trainer", conf_dir, args,
            f"--master_endpoints={endpoints}", "--device=cuda", "--num_passes=1",
            "--log_period=1", *extra]


def spawn_script(args, name, env):
    """Start `python <args>` from the repository root; its stderr goes to
    build/fleet_<name>.err."""
    with open(os.path.join(REPO, "build", f"fleet_{name}.err"), "w") as err:
        return subprocess.Popen([sys.executable, *args], cwd=REPO, env=env,
                                stdout=subprocess.PIPE, stderr=err, text=True)


def last_json(proc, name, timeout_s=120.0):
    """A process's last stdout line, as JSON, once it exits."""
    try:
        out = proc.communicate(timeout=timeout_s)[0]
    except subprocess.TimeoutExpired:
        proc.kill()
        out = proc.communicate()[0]
    lines = [l for l in out.strip().splitlines() if l.startswith("{")]
    if not lines:
        with open(os.path.join(REPO, "build", f"fleet_{name}.err")) as f:
            tail = f.read()[-3000:]
        fail(f"{name}: printed no result (exit {proc.returncode}): {tail}")
    return json.loads(lines[-1])


def trainer_gates(name, res, tests):
    """One trainer's launches, graphs and costs -> its summary."""
    steps = res["samples"] // V1_BIGRU["batch"]
    la = res["launches"]
    want = (2 * (steps + tests + 1), 2 * steps)
    out = dict(steps=steps, graphs=res["graphs"], replays=res["replays"],
               gru_fwd_launches=la["FWD_LAUNCHES"], gru_bwd_launches=la["BWD_LAUNCHES"],
               rc=res["rc"])
    if (la["FWD_LAUNCHES"], la["BWD_LAUNCHES"]) != want:
        fail(f"{name}: GRU launches {la} in {steps} steps, {tests} test batches and "
             f"the init: want fwd {want[0]}, bwd {want[1]}")
    if any(v for k, v in la.items() if k not in ("FWD_LAUNCHES", "BWD_LAUNCHES")):
        fail(f"{name}: launched kernels it does not run: {la}")
    if steps and (res["graphs"] != 1 or res["replays"] != steps - 1):
        fail(f"{name}: {res['graphs']} step graphs, {res['replays']} replays in {steps} "
             f"steps: want one graph, every step after the first a replay")
    return out


def cluster_phase(torch):
    """Phase 47 (see the module docstring)."""
    import signal
    import threading

    from paddle_tpu_torch.runtime.master import KILLED_EXIT, MasterClient

    d, shards = cluster_dir(CLUSTER["tasks"])
    env = dict(os.environ, PYTHONPATH=REPO)
    p1, p2 = free_port(), free_port()
    snap = os.path.join(d, "master.snap")
    endpoints = f"127.0.0.1:{p1},127.0.0.1:{p2}"
    procs, stamp = {}, {}
    out = dict(config=dict(CLUSTER, **{k: V1_BIGRU[k] for k in (
        "vocab", "size", "batch", "min_len", "max_len")}))
    t0 = time.perf_counter()
    try:
        procs["primary"] = spawn(
            ["paddle_tpu_torch.runtime.master", "serve", "--port", str(p1),
             "--snapshot", snap, "--lease_s", str(CLUSTER["lease_s"]),
             "--failure_max", "10", "--faults", f"master_kill:step={CLUSTER['kill_step']}"],
            "master_primary", env)
        first_json(procs["primary"], "master_primary")
        boot = MasterClient(("127.0.0.1", p1))
        boot.call("set_dataset", shards=shards, chunks_per_task=1)
        boot.close()
        procs["standby"] = spawn(
            ["paddle_tpu_torch.runtime.master", "standby", "--port", str(p2),
             "--primary", f"127.0.0.1:{p1}", "--snapshot", snap,
             "--lease_s", str(CLUSTER["lease_s"]), "--poll_s",
             str(CLUSTER["standby_poll_s"]), "--max_wait_s", "300"],
            "master_standby", env)

        def watch_standby():
            line = procs["standby"].stdout.readline()
            stamp["standby"] = time.time()
            stamp["standby_line"] = line

        threading.Thread(target=watch_standby, daemon=True).start()
        for name in ("trainer_a", "trainer_b"):
            procs[name] = spawn_script(trainer_cmd(d, endpoints), name, env)
        res = {name: last_json(procs[name], name, timeout_s=300.0)
               for name in ("trainer_a", "trainer_b")}
        out["wall_s"] = time.perf_counter() - t0
        procs["primary"].wait(30)
        # the kill: the first master RPC that failed in either trainer (the
        # primary dies inside a trainer's RPC; its process exits later)
        fails = [t for r in res.values() for t in r["rpc_failures"]]
        if fails:
            stamp["kill"] = min(fails)
        post = MasterClient(("127.0.0.1", p2))
        st = post.call("stats")
        post.close()
        out["master"] = {k: st[k] for k in ("todo", "pending", "done", "discarded",
                                            "pass", "evicted_trainers")}
        out["primary_exit"] = procs["primary"].returncode
        out["standby"] = json.loads(stamp.get("standby_line") or "{}")
        for name, r in res.items():
            out[name] = trainer_gates(name, r, CLUSTER["test_batches"])
            after = [t for t, _ in r["stamps"] if t > stamp.get("kill", 1e30)]
            out[name]["kill_to_next_batch_ms"] = (
                (after[0] - stamp["kill"]) * 1e3 if after else None)
            out[name]["failovers"] = r["ft"].get("master_failover", 0)
            out[name]["pass_lines"] = r["pass_lines"]
        out["kill_to_standby_serving_ms"] = (
            (stamp["standby"] - stamp["kill"]) * 1e3
            if "standby" in stamp and "kill" in stamp else None)
        out["steps_after_kill"] = {
            n: sum(t > stamp.get("kill", 1e30) for t, _ in r["stamps"]) for n, r in res.items()}
        stamps = sorted(s for r in res.values() for s in r["stamps"])
        costs = [c for _, c in stamps]
        out["cost_first3"], out["cost_last3"] = costs[:3], costs[-3:]
        print("cluster", json.dumps(out), flush=True)
        consumed = sum(out[n]["steps"] for n in res)
        if out["primary_exit"] != KILLED_EXIT or out["standby"].get("role") != "standby":
            fail(f"cluster: primary exit {out['primary_exit']}, standby {out['standby']}")
        if st["done"] != CLUSTER["tasks"] or st["discarded"] != 0:
            fail(f"cluster: the master's books after the failover: {out['master']}")
        if any(res[n]["rc"] != 0 for n in res) or not all(out[n]["steps"] for n in res):
            fail(f"cluster: both trainers must pull work and exit 0: "
                 f"{[(n, out[n]['steps'], res[n]['rc']) for n in res]}")
        if consumed < CLUSTER["tasks"]:
            fail(f"cluster: {consumed} batches trained, the pass has {CLUSTER['tasks']}")
        if not all(out[n]["failovers"] for n in res):
            fail("cluster: a trainer never failed over to the standby")
        if "kill" not in stamp or not sum(out["steps_after_kill"].values()):
            fail(f"cluster: the kill did not land mid-pass: {out['steps_after_kill']}")
        if not (sum(out["cost_last3"]) < sum(out["cost_first3"])):
            fail(f"cluster: the cost did not fall: {out['cost_first3']} -> "
                 f"{out['cost_last3']}")
        return out
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        for p in procs.values():
            try:
                p.wait(30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(30)


def autoscale_phase(torch, fleet):
    """Phase 48 (see the module docstring)."""
    import signal
    import threading

    from paddle_tpu_torch.runtime.master import MasterClient
    from paddle_tpu_torch.serving import ServingClient

    cfg = AUTOSCALE
    reqs, want = fleet["reqs"], fleet["tokens"]
    env = dict(os.environ, PYTHONPATH=REPO)
    logs = os.path.join(REPO, "build", "autoscale")
    os.makedirs(logs, exist_ok=True)
    for f in os.listdir(logs):
        os.unlink(os.path.join(logs, f))
    d, shards = cluster_dir(CLUSTER["tasks"], cfg["repeat_tasks"])
    pm, pr = free_port(), free_port()
    router = ("127.0.0.1", pr)
    procs = {}
    out = dict(config=dict(cfg))
    # (s since the start, live replicas, draining, the router's queue-wait
    # estimate, the training world, its epoch's state, epochs completed)
    timeline = []
    t0, t0_wall = time.monotonic(), time.time()
    try:
        procs["master"] = spawn(
            ["paddle_tpu_torch.runtime.master", "serve", "--port", str(pm),
             "--lease_s", str(cfg["master_lease_s"]),
             "--initial_world", str(cfg["initial_world"])], "as_master", env)
        first_json(procs["master"], "as_master")
        mc = MasterClient(("127.0.0.1", pm), timeout=10.0)
        mc.call("set_dataset", shards=shards, chunks_per_task=1)
        procs["trainer"] = spawn_script(trainer_cmd(
            d, f"127.0.0.1:{pm}", "--prefetch_depth=1",
            f"--faults=h2d_delay:{cfg['h2d_delay_ms']}ms"), "as_trainer", env)
        flags = ["--vocab", str(SERVE["vocab"]), "--n_layers", str(SERVE["n_layers"]),
                 "--d_model", str(SERVE["d_model"]), "--n_heads", str(SERVE["n_heads"]),
                 "--max_len", str(SERVE["max_len"]), "--max_slots", str(SERVE["max_slots"]),
                 "--page_size", str(SERVE["page_size"]),
                 "--prefill_buckets", ",".join(map(str, SERVE["prefill_buckets"])),
                 "--prefill_chunk", str(SERVE["prefill_chunk"]),
                 "--max_new_limit", str(SERVE["max_new_limit"]), "--seed", str(SERVE["seed"]),
                 "--device", "cuda"]
        procs["replica_a"] = spawn(["paddle_tpu_torch", "serve", "--demo", *flags,
                                    "--router_endpoints", "%s:%d" % router,
                                    "--exit_on_drain"], "as_replica_a", env)
        addr_a = tuple(first_json(procs["replica_a"], "as_replica_a")["address"])
        c = ServingClient(addr_a)
        c.generate(WARM_PROMPT, 4, timeout_s=120.0)  # its first step and capture
        c.close()
        out["replica_a_ready_s"] = time.monotonic() - t0
        procs["router"] = spawn(
            ["paddle_tpu_torch.serving.router", "serve", "--port", str(pr),
             "--lease_s", str(cfg["router_lease_s"]), "--autoscale",
             "--autoscale_master", f"127.0.0.1:{pm}",
             "--autoscale_tick_s", str(cfg["tick_s"]),
             "--autoscale_chips", str(cfg["chips"]),
             "--autoscale_min_replicas", str(cfg["min_replicas"]),
             "--autoscale_max_replicas", str(cfg["max_replicas"]),
             "--autoscale_config", json.dumps(cfg["config"]),
             "--autoscale_spawn_log_dir", logs,
             *[f"--autoscale_spawn_arg={a}" for a in ["--demo", *flags]]],
            "as_router", env)
        if first_json(procs["router"], "as_router").get("autoscale") is not True:
            fail("autoscale: the router did not report its controller")
        probe = MasterClient(router, timeout=10.0)
        stop_watch = threading.Event()
        marks = {}

        def watch():
            """The router's and the master's view every 0.1 s: a row of the
            timeline whenever it changes, and the spawn's two marks."""
            probe = MasterClient(router, timeout=10.0)
            mc = MasterClient(("127.0.0.1", pm), timeout=10.0)
            spawned = os.path.join(logs, "replica_0.err")
            while not stop_watch.is_set():
                rs, ms = probe.call("stats"), mc.call("stats")
                reps = rs["replicas"]
                rz = ms["resize"]
                now = time.monotonic() - t0
                row = (round(now, 3), sum(r["state"] == "live" for r in reps),
                       sum(r["state"] == "draining" for r in reps),
                       rs["estimated_queue_wait_s"], rz["world"], rz["state"],
                       rz["completed"])
                if not timeline or row[1:] != timeline[-1][1:]:
                    timeline.append(row)
                if "spawn" not in marks and os.path.exists(spawned):
                    marks["spawn"] = now
                if "spawn" in marks and "spawn_live" not in marks and row[1] == 2:
                    marks["spawn_live"] = now
                time.sleep(0.1)
            probe.close()
            mc.close()

        deadline = time.monotonic() + 30
        while probe.call("stats")["live_replicas"] < 1:
            if time.monotonic() > deadline:
                fail("autoscale: replica A did not join the router")
            time.sleep(0.05)
        wt = threading.Thread(target=watch, daemon=True)
        wt.start()

        def burst(tag):
            """Every request of phase 45 `burst_repeat` times through the
            router at once -> {(copy, index): tokens}."""
            cl = ServingClient(router, timeout=30.0)
            rids = {(k, i): cl.submit(reqs[i][0], NEW_TOKENS,
                                      client_req_id=f"as-{tag}-{k}-{i}", **reqs[i][1])
                    for k in range(cfg["burst_repeat"]) for i in range(len(reqs))}
            toks, deadline = {}, time.monotonic() + 300
            while len(toks) < len(rids) and time.monotonic() < deadline:
                for key, rid in rids.items():
                    if key not in toks:
                        r = cl.poll(rid)
                        if r.get("done"):
                            toks[key] = list(r["tokens"])
                time.sleep(0.02)
            cl.close()
            return toks, len(rids)

        def wait_for(cond, what, timeout_s):
            deadline = time.monotonic() + timeout_s
            while not cond():
                if time.monotonic() > deadline:
                    fail(f"autoscale: {what} did not happen in {timeout_s:.0f} s: "
                         f"timeline {timeline}")
                time.sleep(0.1)
            return time.monotonic() - t0

        # 1. a burst: the controller spawns a second replica
        marks["burst1"] = time.monotonic() - t0
        got1, n1 = burst("b1")
        marks["burst1_done"] = time.monotonic() - t0
        wait_for(lambda: "spawn_live" in marks, "the spawned replica going live", 120)
        # 2. idle: a drain, then the freed chip lent to training (world 2)
        marks["lent"] = wait_for(
            lambda: mc.call("stats")["resize"]["world"] == 2
            and mc.call("stats")["resize"]["state"] == "idle", "the lend", 120)
        # 3. the next burst, past the flap window: the chip comes back first
        time.sleep(max(0.0, cfg["config"]["flap_window_s"] + 1.0
                       - (time.monotonic() - t0 - marks["lent"])))
        marks["burst2"] = time.monotonic() - t0
        box = {}
        bt = threading.Thread(target=lambda: box.update(r=burst("b2")), daemon=True)
        bt.start()
        marks["reclaimed"] = wait_for(
            lambda: mc.call("stats")["resize"]["world"] == 1, "the reclaim", 120)
        bt.join(300)
        got2, n2 = box.get("r", ({}, -1))
        marks["burst2_done"] = time.monotonic() - t0
        stop_watch.set()
        wt.join(5)
        mst = mc.call("stats")
        out["resize"] = mst["resize"]
        out["master"] = {k: mst[k] for k in ("done", "discarded", "live_leases")}
        # the controller's decision log, the trainer, then every replica
        procs["router"].send_signal(signal.SIGTERM)
        ctl = last_json(procs["router"], "as_router", timeout_s=60.0)["autoscaler"]
        procs["trainer"].send_signal(signal.SIGTERM)
        tres = last_json(procs["trainer"], "as_trainer", timeout_s=120.0)
        replicas = {}
        if procs["replica_a"].poll() is None:
            procs["replica_a"].send_signal(signal.SIGTERM)
        replicas["replica_a"] = last_json(procs["replica_a"], "as_replica_a", 60.0)
        for f in sorted(os.listdir(logs)):
            if f.endswith(".out"):
                with open(os.path.join(logs, f)) as fh:
                    lines = [l for l in fh.read().splitlines() if l.startswith("{")]
                replicas[f[:-4]] = json.loads(lines[-1]) if lines else {}
        out.update(marks=marks, timeline=timeline, decisions=ctl["actions"],
                   controller=ctl, spawn_to_live_s=marks["spawn_live"] - marks["spawn"])
        out["replicas"] = {
            n: dict(decode_steps=r.get("final_stats", {}).get("decode_steps"),
                    captures=r.get("final_stats", {}).get("decode_graph_captures"),
                    launches=r.get("paged_attention_launches"))
            for n, r in replicas.items()}
        stamps = [t for t, _ in tres["stamps"]]
        out["trainer"] = dict(rc=tres["rc"], steps=tres["samples"] // V1_BIGRU["batch"],
                              graphs=tres["graphs"], replays=tres["replays"],
                              launches=tres["launches"], ft=tres["ft"])
        print("autoscale", json.dumps(out), flush=True)
        acts = [a.split(":")[0] if not a.startswith("resize") else a for a in ctl["actions"]]
        order = [a for a in acts if a in ("spawn", "drain", "resize:2", "resize:1")]
        if order[:4] != ["spawn", "drain", "resize:2", "resize:1"]:
            fail(f"autoscale: decisions {ctl['actions']}: want spawn, drain, lend "
                 f"(resize:2), reclaim (resize:1) in that order")
        bad = {k: v for k, v in {**{("b1",) + k: v for k, v in got1.items()},
                                 **{("b2",) + k: v for k, v in got2.items()}}.items()
               if v != want[k[-1]]}
        if len(got1) != n1 or len(got2) != n2 or bad:
            fail(f"autoscale: {len(got1)}/{n1} and {len(got2)}/{n2} requests finished, "
                 f"{len(bad)} with tokens other than a direct session's")
        rz = mst["resize"]
        if rz["state"] != "idle" or rz["completed"] < 2 or rz["last"].get("timed_out"):
            fail(f"autoscale: the resize epochs did not settle: {rz}")
        after = [t for t in stamps if t > t0_wall + marks["reclaimed"]]
        out["trainer"]["steps_after_reclaim"] = len(after)
        if tres["ft"].get("reader_resize_drain", 0) < 2 or not after:
            fail(f"autoscale: the trainer did not train through both epochs: "
                 f"{out['trainer']}")
        steps, la = out["trainer"]["steps"], tres["launches"]
        if (la["FWD_LAUNCHES"], la["BWD_LAUNCHES"]) != (2 * (steps + 1), 2 * steps) or (
                tres["graphs"] != 1):
            fail(f"autoscale: the trainer's GRU launches {la} and {tres['graphs']} graphs "
                 f"in {steps} steps")
        # a replica spawned by the second burst may still be loading at the
        # end: SIGTERM reaches it before it serves, and it reports nothing
        served = {n: r for n, r in out["replicas"].items() if r["launches"] is not None}
        for n, r in served.items():
            if r["launches"] != r["decode_steps"] * GPT2_SMALL["n_layers"]:
                fail(f"autoscale: {n} launched the decode kernel {r['launches']} times "
                     f"in {r['decode_steps']} decode steps")
        if "replica_a" not in served or "replica_0" not in served:
            fail(f"autoscale: replica A and the first spawned replica must report: "
                 f"{out['replicas']}")
        return out
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        for p in procs.values():
            try:
                p.wait(30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(30)


# phases 49-50: data parallelism over a one-rank NCCL group (the card has one
# GPU; NCCL refuses two ranks on one device)
DP_UPDATERS = (("replicated", False), ("zero1", "zero1"), ("zero3", "zero3"))
DP_S2S = dict(check_steps=4, timed_steps=6, zero2_k=4, zero2_dispatches=4)


def dp_pins(shard, n_bn: int, n_flat: int, comp=None) -> dict:
    """The collectives of one step (tests/test_torch_collectives.py): batch
    norm's two all-reduces a layer, plus the updater's: replicated one flat
    all-reduce; zero1/2 one gradient scatter (a reduce-scatter, or an
    all-to-all of the encoded rows under bf16/int8) and one all-gather;
    zero3 one reduce-scatter and one all-gather a flat parameter."""
    pins = {"all_reduce": 2 * n_bn, "reduce_scatter": 0, "all_gather": 0, "all_to_all": 0}
    scatter = "reduce_scatter" if comp in (None, "none") else "all_to_all"
    if not shard:
        pins["all_reduce"] += 1
    elif shard == "zero3":
        pins.update({scatter: 1, "all_gather": n_flat})
    else:
        pins.update({scatter: 1, "all_gather": 1})
    return pins


def profile_collectives(torch, call, steps: int, label: str):
    """torch.profiler over one `call` of `steps` steps: the NCCL kernels'
    (and device-to-device copies') share of device time and count a step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy = nccl_ms = copy_ms = 0.0
    nccl_n = copy_n = 0
    names = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        ms = e.self_device_time_total / 1e3
        busy += ms
        low = e.key.lower()
        if "nccl" in low:
            nccl_ms += ms
            nccl_n += e.count
            names[e.key[:70]] = e.count / steps
        elif "memcpy dtod" in low or "memcpy_dtod" in low:
            copy_ms += ms
            copy_n += e.count
    out = {"steps": steps, "wall_ms_per_step": wall_ms / steps,
           "device_busy_ms_per_step": busy / steps, "device_busy_share": busy / wall_ms,
           "nccl_kernels_per_step": nccl_n / steps, "nccl_ms_per_step": nccl_ms / steps,
           "nccl_share_of_device_time": nccl_ms / busy if busy else 0.0,
           "nccl_kernels": names, "dtod_copies_per_step": copy_n / steps,
           "dtod_copy_ms_per_step": copy_ms / steps}
    print(label, json.dumps(out), flush=True)
    if busy <= 0:
        fail(f"{label}: torch.profiler recorded no device time")
    return out


def dp_resnet_phase(torch, resnet):
    """Phase 10's ResNet-50 step as bench.py:656-830 runs it on a one-chip
    host: `DataParallel(make_mesh({"data": 1}))` over a one-rank NCCL group
    (224x224, batch 256, 1000 classes, bf16, SGD(0.1, momentum 0.9), K = 8
    stacked batches a `multi_step` call, drawn as phase 10 draws them), for
    the replicated, zero1 and zero3 updaters in turn: one warm-up call
    (eager, then the 8 steps captured with their collectives as one CUDA
    graph) and two timed replays, each from the same parameters and moving
    statistics as a mesh-less trainer that ran the same three calls first.
    Gates: one graph per updater; the collective counts = the pins of
    tests/test_torch_collectives.py a step x 24 steps (the replays count
    the calls their capture holds); parameters and moving statistics
    bitwise the mesh-less trainer's; finite costs. Printed: bench.py's
    fields, ms a step against phase 10's, peak memory, optimizer-state
    bytes, and from torch.profiler over one call the NCCL kernels' share of
    device time and their count a step."""
    import numpy as np

    from paddle_tpu_torch.parallel import DataParallel, make_mesh

    cfg = RESNET
    k = cfg["scan_k"]
    calls = cfg["warmup"] + cfg["dispatches"]
    t0 = time.perf_counter()
    batch, stacked = resnet_batches(np, cfg["image_size"], cfg["batch"], k, cfg["classes"])
    stacked = {key: torch.as_tensor(v).to("cuda") for key, v in stacked.items()}
    draw_s = time.perf_counter() - t0

    def snapshot(tr):
        return ({key: v.clone() for key, v in tr.canonical_params().items()},
                {key: v.clone() for key, v in tr.state["states"].items()})

    ref = resnet_trainer("cuda", "bf16", cfg["image_size"], cfg["classes"])
    ref.init_state(batch)
    init_params, init_states = snapshot(ref)
    ref_costs, ref_ms = timed_calls(torch, lambda: ref.multi_step(stacked), calls)
    want_params, want_states = snapshot(ref)
    n_bn = sum(1 for l in ref.network.layer_order if l.type_name == "batch_norm")
    del ref
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    mesh = make_mesh({"data": 1})
    mesh_s = time.perf_counter() - t0
    name = torch.cuda.get_device_name(0)
    peak_flops = bf16_peak(name)
    flops_per_image = RESNET_FLOPS_PER_IMAGE * (cfg["image_size"] / 224.0) ** 2
    out = {"config": dict(cfg, precision="bf16", optimizer="SGD(0.1, momentum 0.9)",
                          mesh=repr(mesh), mesh_s=mesh_s, batch_norms=n_bn),
           "draw_s": draw_s, "mesh_less": dict(costs=ref_costs, dispatch_ms=ref_ms,
                                                ms_per_step=statistics.median(
                                                    ref_ms[cfg["warmup"]:]) / k),
           "phase10_ms_per_step": resnet["ms_per_step"]}
    for label, shard in DP_UPDATERS:
        torch.cuda.empty_cache()
        tr = resnet_trainer("cuda", "bf16", cfg["image_size"], cfg["classes"],
                            parallel=DataParallel(mesh), shard_update=shard)
        tr.init_state(batch)
        tr.load_params(init_params)
        tr.load_states(init_states)
        n_flat = sum(1 for g in getattr(tr.updater, "_geom", {}).values() if g.flat)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mesh.reset_counts()
        costs, dispatch_ms = timed_calls(torch, lambda: tr.multi_step(stacked), calls)
        counts = mesh.counts()
        peak = torch.cuda.max_memory_allocated()
        graphs = list(tr.graphs.values())
        replays = graphs[0].replays if graphs else 0
        got_params, got_states = snapshot(tr)
        bitwise_params = all(torch.equal(got_params[key], v) for key, v in want_params.items())
        bitwise_states = all(torch.equal(got_states[key], v) for key, v in want_states.items())
        worst = max(rel_l2(torch, got_params[key], v) for key, v in want_params.items())
        ms_per_step = statistics.median(dispatch_ms[cfg["warmup"]:]) / k
        images_per_s = cfg["batch"] / (ms_per_step / 1e3)
        pins = dp_pins(shard, n_bn, n_flat)
        want_counts = {key: calls * k * v for key, v in pins.items()}
        opt_bytes = sum(v.numel() * v.element_size() for v in
                        tr._trees()["opt"].values())
        res = dict(
            updater=label, resnet50_images_per_sec_per_chip=images_per_s,
            ms_per_step=ms_per_step, ms_per_step_min=min(dispatch_ms[cfg["warmup"]:]) / k,
            vs_phase10_ms_per_step=ms_per_step / resnet["ms_per_step"],
            vs_mesh_less_ms_per_step=ms_per_step / out["mesh_less"]["ms_per_step"],
            mfu=images_per_s * flops_per_image / peak_flops, dispatch_ms=dispatch_ms,
            costs=costs, peak_memory_bytes=peak, opt_state_bytes=opt_bytes,
            param_bytes=sum(v.numel() * v.element_size()
                            for v in tr.state["params"].values()),
            graphs=len(graphs), replays=replays, collective_counts=counts,
            collective_pins_per_step=pins, flat_params=n_flat,
            bitwise_params=bitwise_params, bitwise_states=bitwise_states,
            param_rel_l2_max=worst,
            collective_bytes_detail=tr.updater.collective_bytes_detail(k))
        res["profile"] = profile_collectives(torch, lambda: tr.multi_step(stacked), k,
                                             f"dp_resnet_profile_{label}")
        out[label] = res
        print("dp_resnet", json.dumps(res), flush=True)
        if len(graphs) != 1 or replays != cfg["dispatches"]:
            fail(f"dp_resnet {label}: {len(graphs)} graphs, {replays} replays: want one "
                 f"graph, every call after the first a replay")
        if counts != want_counts:
            fail(f"dp_resnet {label}: collectives {counts}, want {want_counts} "
                 f"({pins} a step x {calls * k} steps)")
        if not (bitwise_params and bitwise_states):
            fail(f"dp_resnet {label}: parameters bitwise {bitwise_params}, moving "
                 f"statistics bitwise {bitwise_states} against the mesh-less trainer "
                 f"(largest parameter difference {worst} relative L2)")
        if not all(np.isfinite(costs)):
            fail(f"dp_resnet {label}: non-finite costs {costs}")
        del tr, graphs
        torch.cuda.empty_cache()
    return out, mesh


def dp_seq2seq_phase(torch, mesh):
    """Phase 5's seq2seq NMT (bench.py:211-245: vocab 30000, 512/512, batch
    128, lengths 50, Adam(1e-3), f32) through `DataParallel` over phase 49's
    one-rank NCCL group, twice: replicated at K = 1, its first 4 steps held
    to a mesh-less trainer from the same parameters (costs and parameters
    bitwise), then 6 timed steps; and zero2 with int8 compression at K = 4
    (4 stacked batches merged into one 512-row update a dispatch), 4
    dispatches. Gates: gru_seq_fused launches = 2 x updates forward and
    backward (a replay counts the calls it holds); zero2 runs one gradient
    scatter (an all-to-all of the int8 rows) and one parameter all-gather a
    dispatch; the int8 error-feedback residual is non-zero after the first
    dispatch; the cost falls; one graph per signature. Printed: ms a step
    of both runs and `collective_bytes_detail`."""
    import numpy as np

    from paddle_tpu_torch.ops import rnn_kernels as K
    from paddle_tpu_torch.parallel import DataParallel

    cfg = DP_S2S
    batch = s2s_batch(np, 0, S2S["batch"], ragged=False)
    plain = s2s_trainer("cuda")
    plain.init_state(batch)
    init = {key: v.clone() for key, v in plain.state["params"].items()}
    dp = s2s_trainer("cuda", parallel=DataParallel(mesh))
    dp.init_state(batch)
    dp.load_params(init)

    K.FWD_LAUNCHES = K.BWD_LAUNCHES = 0
    mesh.reset_counts()
    check_costs, check_ms = timed_calls(torch, lambda: dp.step(batch), cfg["check_steps"])
    after_check = {key: v.clone() for key, v in dp.canonical_params().items()}
    more, more_ms = timed_calls(torch, lambda: dp.step(batch), cfg["timed_steps"])
    steps = cfg["check_steps"] + cfg["timed_steps"]
    fwd, bwd = K.FWD_LAUNCHES, K.BWD_LAUNCHES
    counts = mesh.counts()
    graphs = len(dp.graphs)
    plain_costs, plain_ms = timed_calls(torch, lambda: plain.step(batch), cfg["check_steps"])
    cost_err = max(abs(a - b) / abs(b) for a, b in zip(check_costs, plain_costs))
    param_err, bitwise = rel_l2_max(torch, after_check, plain.state["params"])
    cost_bitwise = check_costs == plain_costs
    replicated = dict(steps=steps, costs=check_costs + more,
                      step_ms_median=statistics.median(more_ms),
                      mesh_less_step_ms_median=statistics.median(plain_ms[1:]),
                      gru_fwd_launches=fwd, gru_bwd_launches=bwd, graphs=graphs,
                      collective_counts=counts, cost_rel_err=cost_err,
                      costs_bitwise=cost_bitwise, param_rel_l2_max=param_err,
                      params_bitwise=bitwise,
                      collective_bytes_detail=dp.updater.collective_bytes_detail(1))
    print("dp_seq2seq_replicated", json.dumps(replicated), flush=True)
    if fwd != 2 * steps or bwd != 2 * steps:
        fail(f"dp_seq2seq replicated: GRU launches fwd {fwd} / bwd {bwd} in {steps} steps, "
             f"want 2 + 2 a step")
    if graphs != 1:
        fail(f"dp_seq2seq replicated: {graphs} step graphs, want one")
    if counts != {**dp_pins(False, 0, 0), "all_reduce": steps}:
        fail(f"dp_seq2seq replicated: collectives {counts}, want one all-reduce a step")
    if not ((cost_bitwise and bitwise)
            or (cost_err <= REPLAY_RTOL and param_err <= REPLAY_RTOL)):
        fail(f"dp_seq2seq replicated vs mesh-less: costs {cost_err}, parameters "
             f"{param_err} relative (bitwise {cost_bitwise}/{bitwise})")
    del dp, plain
    torch.cuda.empty_cache()

    k = cfg["zero2_k"]
    z2 = s2s_trainer("cuda", parallel=DataParallel(mesh), shard_update="zero2",
                     grad_compression="int8")
    z2.init_state(batch)
    z2.load_params(init)
    window = [s2s_batch(np, seed, S2S["batch"], ragged=False) for seed in range(k)]
    stacked = {key: torch.as_tensor(np.stack([b[key] for b in window])).to("cuda")
               for key in window[0]}
    K.FWD_LAUNCHES = K.BWD_LAUNCHES = 0
    mesh.reset_counts()
    first, first_ms = timed_calls(torch, lambda: z2.multi_step(stacked), 1)
    ef_max = max(float(e.abs().max()) for e in z2.state["opt"]["ef"].values())
    rest, rest_ms = timed_calls(torch, lambda: z2.multi_step(stacked),
                                cfg["zero2_dispatches"] - 1)
    dispatches = cfg["zero2_dispatches"]
    fwd, bwd = K.FWD_LAUNCHES, K.BWD_LAUNCHES
    counts = mesh.counts()
    costs = first + rest
    zero2 = dict(k=k, dispatches=dispatches, costs=costs, dispatch_ms=first_ms + rest_ms,
                 ms_per_step=statistics.median(rest_ms) / k,
                 ms_per_dispatch=statistics.median(rest_ms),
                 gru_fwd_launches=fwd, gru_bwd_launches=bwd, graphs=len(z2.graphs),
                 collective_counts=counts, ef_abs_max_after_first_dispatch=ef_max,
                 collective_bytes_detail=z2.updater.collective_bytes_detail(k))
    print("dp_seq2seq_zero2_int8", json.dumps(zero2), flush=True)
    if fwd != 2 * dispatches or bwd != 2 * dispatches:
        fail(f"dp_seq2seq zero2: GRU launches fwd {fwd} / bwd {bwd} in {dispatches} merged "
             f"updates, want 2 + 2 an update")
    want = {**dp_pins("zero2", 0, 0, "int8")}
    want = {key: v * dispatches for key, v in want.items()}
    if counts != want:
        fail(f"dp_seq2seq zero2: collectives {counts}, want {want} (one gradient all-to-all "
             f"and one all-gather a dispatch)")
    if not ef_max > 0:
        fail("dp_seq2seq zero2: the int8 error-feedback residual is zero after the first "
             "dispatch")
    if len(z2.graphs) != 1:
        fail(f"dp_seq2seq zero2: {len(z2.graphs)} graphs, want one")
    if not (all(np.isfinite(costs)) and costs[-1] < costs[0]):
        fail(f"dp_seq2seq zero2: the cost did not fall: {costs}")
    del z2
    torch.cuda.empty_cache()
    return {"replicated": replicated, "zero2_int8": zero2}


TP_VOCAB = 50304  # nanoGPT's padded GPT-2 vocabulary (GPTConfig.vocab_size)
TP_SERVE = dict(SERVE, vocab=TP_VOCAB)


def tp_top2_gap(torch, model, prompt, tokens, step):
    """The tp 0 model's gap between its two largest logits where token
    `step` of `tokens` was chosen (a near-tie the row-parallel sums'
    order can flip)."""
    seq = torch.tensor([list(prompt) + list(tokens[:step])], device=model.device)
    with torch.no_grad():
        top = model.forward_logits(seq)[0, -1].topk(2).values
    return float(top[0] - top[1])


def tp_serve_phase(torch, bw, f32_flops):
    """Phase 51: GPT-2-small widths (vocab 50 304) served at tp 2 by two
    rank threads on cuda:0 over one gloo group, against tp 0 on the same
    seeded weights."""
    from torch.distributed import HashStore, PrefixStore

    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.parallel import mesh as pmesh
    from paddle_tpu_torch.serving import make_demo_session
    from paddle_tpu_torch.serving import model as smodel
    from paddle_tpu_torch.serving.tp import TPWorker

    t_phase = time.perf_counter()
    rng = torch.Generator().manual_seed(1)
    prompts = [[1] + torch.randint(3, TP_VOCAB, (n - 1,), generator=rng).tolist()
               for n in PROMPT_LENS]

    def serve(sess, res):
        step_ms = []
        orig = sess._decode_once

        def timed(skip=frozenset()):
            before = sess.decode_steps
            t = time.perf_counter()
            orig(skip)  # ends in the step's token fetch: synchronised
            if sess.decode_steps != before:
                step_ms.append((time.perf_counter() - t) * 1e3)

        sess._decode_once = timed
        t0 = time.perf_counter()
        handles = [sess.submit(p, NEW_TOKENS) for p in prompts]
        sess.run_until_idle()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        sampled = sess.submit(prompts[0], NEW_TOKENS, **SAMPLED)
        sess.run_until_idle()
        del sess._decode_once
        st = sess.stats()
        n_tok = sum(len(h.tokens) for h in handles)
        res.update(tokens=[h.tokens for h in handles], sampled=sampled.tokens,
                   finish=[h.finish_reason for h in handles], wall_s=wall,
                   ms_per_token=wall * 1e3 / n_tok,
                   decode_steps=st["decode_steps"],
                   decode_step_ms_median=statistics.median(step_ms),
                   decode_step_ms_median_after_first=statistics.median(step_ms[1:]),
                   decode_graph=st["decode_graph"], tp=st["tp"],
                   param_bytes_per_chip=st["param_bytes_per_chip"],
                   pool_bytes_per_chip=st["pool_bytes_per_chip"],
                   pages_in_use=st["pages_in_use"])

    # tp 0: the single-card program (the decode graph)
    base = {}
    t0 = time.perf_counter()
    ref = make_demo_session(**TP_SERVE, device="cuda")
    base["setup_s"] = time.perf_counter() - t0
    serve(ref, base)

    # which rank launched the kernel, at how many heads
    spy = {}
    orig_kernel = smodel.paged_attention_decode

    def counted(*a, **kw):
        key = (threading.current_thread().name, kw["n_heads"])
        spy[key] = spy.get(key, 0) + 1
        return orig_kernel(*a, **kw)

    store = HashStore()
    tp, errors = {}, []

    def rank(r):
        try:
            torch.cuda.set_device(0)
            group = pmesh.new_gloo_group(PrefixStore("tp51", store), r, 2, timeout_s=300)
            t0 = time.perf_counter()
            s = make_demo_session(**TP_SERVE, device="cuda", tp=2, group=group)
            torch.cuda.synchronize()
            setup = time.perf_counter() - t0
            if isinstance(s, TPWorker):
                s.run()
                tp["worker_calls"] = s.calls
                return
            tp["setup_s"] = setup
            tp["local_heads"] = s.model.local_heads
            serve(s, tp)
            # one pure decode step's collectives, after a short admission
            m = s.model.mesh
            s.submit([1, 5, 9], 4)
            s.step()
            m.reset_counts()
            steps = s.decode_steps
            s.step()
            tp["one_step"] = dict(decode_steps=s.decode_steps - steps,
                                  model=m.counts("model"), data=m.counts("data"))
            s.run_until_idle()
            tp["decode_steps_total"] = s.decode_steps
            s.stop()
        except BaseException as e:  # the phase fails below
            import traceback

            errors.append(traceback.format_exc())

    smodel.paged_attention_decode = counted
    pa.LAUNCHES = 0
    try:
        threads = [threading.Thread(target=rank, args=(r,), name=f"tp-rank{r}")
                   for r in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
    finally:
        smodel.paged_attention_decode = orig_kernel
    if errors or any(t.is_alive() for t in threads):
        fail(f"tp serve: a rank failed or hung: {errors[:1]}")
    launches_total = pa.LAUNCHES
    # the worker decodes in lockstep with the lead: both ran the lead's
    # decode steps (the main run, the sampled request, the pin's steps)
    per_rank = {f"rank{r}": {str(h): n for (th, h), n in spy.items() if th == f"tp-rank{r}"}
                for r in range(2)}

    # the kernel at H = 6 against its plain version, at phase 3's timing
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    s_, h_, hd, ps, pmax = 8, 6, 64, 16, 64
    q, kp, vp, bt, pos = paged_inputs(torch, 51, s_, h_, hd, ps, pmax, 0, 1023, False)
    kw = dict(scale=1.0 / hd ** 0.5, n_heads=h_)
    got = pa.paged_attention_decode(q, kp, vp, bt, pos, **kw)
    want = pa.paged_attention_decode_ref(q, kp, vp, bt, pos, **kw)
    h6_err = float((got - want).abs().max())
    tokens = int((pos.long() + 1).clamp(max=pmax * ps).sum())
    kd = h_ * hd
    nbytes = 2 * 4 * tokens * kd + 2 * 4 * s_ * kd + 4 * s_ * pmax + 4 * s_
    t_bytes, t_ops = nbytes / bw * 1e3, 4 * tokens * kd / f32_flops * 1e3

    def library():
        import torch.nn.functional as F

        t_ctx = pmax * ps
        k = kp[bt.long()].reshape(s_, t_ctx, h_, hd).transpose(1, 2)
        v = vp[bt.long()].reshape(s_, t_ctx, h_, hd).transpose(1, 2)
        mask = (torch.arange(t_ctx, device="cuda")[None, :]
                <= pos.long()[:, None])[:, None, None, :]
        return F.scaled_dot_product_attention(q.view(s_, h_, 1, hd), k, v,
                                              attn_mask=mask, scale=kw["scale"])

    launches_before = pa.LAUNCHES
    kernel_h6 = dict(
        shape="gpt2_small_s8_h6", S=s_, H=h_, hd=hd, PS=ps, P=pmax, max_abs_err=h6_err,
        kernel_ms=time_ms(torch, lambda: pa.paged_attention_decode(q, kp, vp, bt, pos, **kw),
                          flush),
        plain_ms=time_ms(torch, lambda: pa.paged_attention_decode_ref(q, kp, vp, bt, pos,
                                                                      **kw), flush),
        library_ms=time_ms(torch, library, flush),
        bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations")
    pa.LAUNCHES = launches_before  # the comparison's launches do not count
    del flush, q, kp, vp, bt, pos, got, want

    res = dict(config=dict(TP_SERVE, prefill_buckets=list(TP_SERVE["prefill_buckets"]),
                           prompt_lens=list(PROMPT_LENS), new_tokens=NEW_TOKENS, tp=2,
                           group="gloo, two rank threads on cuda:0"),
               tp0={k: v for k, v in base.items() if k not in ("tokens", "sampled")},
               tp2={k: v for k, v in tp.items() if k not in ("tokens", "sampled")},
               launches_total=launches_total, launches_per_rank=per_rank,
               kernel_h6=kernel_h6, tokens_equal=tp.get("tokens") == base["tokens"],
               sampled_equal=tp.get("sampled") == base["sampled"],
               sampled_differs_from_greedy=base["sampled"] != base["tokens"][0])
    res["pool_ratio"] = tp["pool_bytes_per_chip"] / base["pool_bytes_per_chip"]
    res["param_ratio"] = tp["param_bytes_per_chip"] / base["param_bytes_per_chip"]
    # the first token that differs, with the tp 0 model's top-2 gap there
    diffs = []
    for i, (a, b) in enumerate(zip(tp["tokens"] + [tp["sampled"]],
                                   base["tokens"] + [base["sampled"]])):
        if a != b:
            j = next((k for k, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
            prompt = prompts[i] if i < len(prompts) else prompts[0]
            diffs.append(dict(request=i, step=j, tp0=b[j:j + 1], tp2=a[j:j + 1],
                              tp0_top2_gap=tp_top2_gap(torch, ref.model, prompt, b, j)))
    res["token_diffs"] = diffs
    res["phase_s"] = time.perf_counter() - t_phase
    print("tp_serve", json.dumps(res), flush=True)
    steps_run = tp["one_step"]
    want_launches = tp["decode_steps_total"] * 12
    if diffs:
        fail(f"tp serve: tokens differ from tp 0 at {diffs}")
    if not all(f in ("length", "eos") for f in tp["finish"]):
        fail(f"tp serve: not every request finished: {tp['finish']}")
    if tp["local_heads"] != 6 or set(per_rank["rank0"]) != {"6"} or \
            set(per_rank["rank1"]) != {"6"}:
        fail(f"tp serve: the kernel ran at {per_rank}, want 6 heads on each rank")
    n0, n1 = per_rank["rank0"]["6"], per_rank["rank1"]["6"]
    if n0 != want_launches or n1 != want_launches or launches_total != n0 + n1:
        fail(f"tp serve: paged_attention_decode launches {per_rank} (total "
             f"{launches_total}); want decode steps x 12 on each rank")
    if not h6_err <= KERNEL_TOL:
        fail(f"paged_attention_decode at H = 6 vs plain: max_abs_err {h6_err}")
    pins = {"all_reduce": 2 * 12 + 1, "reduce_scatter": 0, "all_gather": 1,
            "all_to_all": 0}
    if steps_run["decode_steps"] != 1 or steps_run["model"] != pins or \
            any(steps_run["data"].values()):
        fail(f"tp serve: one decode step's collectives {steps_run}, want {pins} on the "
             "model axis and none on the data axis")
    if res["pool_ratio"] != 0.5 or not 0.5 <= res["param_ratio"] <= 0.52:
        fail(f"tp serve: bytes a rank vs tp 0: pool {res['pool_ratio']}, params "
             f"{res['param_ratio']}")
    if tp["decode_graph"] != "eager: gloo group" or base["decode_graph"] != "captured":
        fail(f"tp serve: decode modes tp 2 {tp['decode_graph']!r}, tp 0 "
             f"{base['decode_graph']!r}")
    if tp["pages_in_use"] or base["pages_in_use"]:
        fail("tp serve: KV pages leaked")
    if not res["sampled_differs_from_greedy"]:
        fail("tp serve: the sampled request's tokens equal the greedy ones")
    del ref
    release(torch)
    return res


def train_of(torch, tree: str) -> int:
    """`--train-of TREE`: the training phases (5, 7 and 10) of the
    chip_smoke.py in TREE, a checkout of this repository (an earlier
    commit's, to compare in one call), run on TREE's own package; prints
    one summary line. Not part of the smoke run."""
    import importlib.util

    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    spec = importlib.util.spec_from_file_location("tree_chip_smoke",
                                                  os.path.join(tree, "chip_smoke.py"))
    other = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(other)
    from paddle_tpu_torch.ops import build

    if not os.path.abspath(build.__file__).startswith(tree + os.sep):
        fail(f"--train-of {tree} imported the package at {build.__file__}")
    print(nvidia_smi_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build()
    out = {"tree": tree}
    for name in ("train_phase", "lstm_train_phase", "resnet_phase"):
        r = getattr(other, name)(torch)
        r = r[0] if isinstance(r, tuple) else r
        prof = r.get("profile", {})
        out[name] = {k: r.get(k) for k in (
            "step_ms_median", "tokens_per_s", "ms_per_step", "images_per_s",
            "resnet50_images_per_sec_per_chip", "graph_device_ms_per_step",
            "eager_step_ms_median", "eager_ms_per_step", "gru_fwd_launches",
            "lstm_fwd_launches", "peak_memory_bytes") if k in r}
        out[name].update({k: prof.get(k) for k in (
            "device_busy_ms_per_step", "device_busy_share", "kernel_launches_per_step",
            "wall_ms_per_step")})
        torch.cuda.empty_cache()
    print("train_of", json.dumps(out), flush=True)
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--train-of"]:
        return train_of(torch, sys.argv[2])
    if sys.argv[1:2] == ["--cluster-trainer"]:
        return cluster_trainer(torch, sys.argv[2], sys.argv[3:])
    sys.path.insert(0, REPO)
    from paddle_tpu_torch.ops import build

    if sys.argv[1:2] == ["--tp-serve"]:
        # phase 51 alone, after the build: a quick check of TP serving
        print(nvidia_smi_line(), flush=True)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        build.build()
        tp_serve_phase(torch, *peaks(torch.cuda.get_device_name(0))[:2])
        return 0

    # 1. card
    smi = nvidia_smi_line()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    bw, f32_flops, tf32_flops = peaks(name)
    print(json.dumps({
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "python": sys.version.split()[0], "device": name,
        "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
        "peak_bytes_per_s": bw, "peak_f32_flops": f32_flops,
        "peak_tf32_flops": tf32_flops,
    }), flush=True)

    # 2. build
    t0 = time.perf_counter()
    libs = build.build()
    build_s = time.perf_counter() - t0
    print(json.dumps({"build_s": build_s, "libraries": {
        k: os.path.relpath(v, REPO) for k, v in libs.items()}}), flush=True)
    for k in libs:
        for line in build.build_log(k).splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas[{k}] {line.strip()}", flush=True)

    # 3. kernels vs plain versions
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    rows = kernel_phase(torch, flush, bw, f32_flops)
    gru_rows = gru_kernel_phase(torch, flush, bw, f32_flops)
    lstm_rows = lstm_kernel_phase(torch, flush, bw, f32_flops)
    attn_rows = attn_kernel_phase(torch, flush, bw, f32_flops, tf32_flops)
    del flush
    torch.cuda.empty_cache()

    # 4. the serving engine end to end (launches counted from 0 here), the
    # decode graph against the eager step, then 4b-4d: the server and its
    # wire, speculation, recovery
    serve = serve_phase(torch)
    small_tokens_phase(torch)
    wire = wire_phase(torch, serve)
    speculation = speculation_phase(torch)
    recovery = recovery_phase(torch, serve)
    layer_error = layer_error_phase(torch)

    # 5. seq2seq training at the reference's widths as a CUDA graph (GRU
    # launches from 0), 5b. its checkpoints, 5c. generation
    torch.cuda.empty_cache()
    train, s2s = train_phase(torch)
    checkpoint = checkpoint_phase(torch, s2s)
    generation = generation_phase(torch, s2s)
    del s2s
    torch.cuda.empty_cache()
    # 6. the training step's cost and gradients, card vs CPU
    train_vs_cpu = train_vs_cpu_phase(torch)

    # 7. LSTM text classification training (LSTM launches from 0), then its
    # cost and gradients card vs CPU
    torch.cuda.empty_cache()
    lstm_train = lstm_train_phase(torch)
    lstm_vs_cpu = lstm_vs_cpu_phase(torch)
    # 8. dot_product_attention, the fused op's own path (launches from 0)
    attn_path = attn_path_phase(torch)
    # 9. the plain routes where the kernels have no layout or no fit
    route = route_phase(torch)

    # 10. ResNet-50 training at bench.py's headline shape (bf16, 8 steps a
    # call), 11. its cost, gradients and states card vs CPU, 12. LeNet
    torch.cuda.empty_cache()
    resnet = resnet_phase(torch)
    torch.cuda.empty_cache()
    resnet_vs_cpu = resnet_vs_cpu_phase(torch)
    lenet = lenet_phase(torch)

    # 13. CTR wide&deep and 14. OCR CRNN training at full width (kernel
    # counters from 0 in each), each then card vs CPU; 15. CTC, CRF and a
    # relu GRU on the card against the CPU
    torch.cuda.empty_cache()
    ctr = ctr_phase(torch)
    torch.cuda.empty_cache()
    ocr = ocr_phase(torch)
    torch.cuda.empty_cache()
    struct_ops = struct_ops_phase(torch)

    # 16. VGG-19 with Dropout, the schedule and the average, then card vs
    # CPU; 17. its step fed by the prefetcher; 18. remat on ResNet-50; 19.
    # the guard and the drain on seq2seq (GRU launches from 0); 20. the
    # seven optimizers on the LSTM model (LSTM launches from 0)
    torch.cuda.empty_cache()
    vgg, vgg_tr, vgg_batch = vgg_phase(torch)
    prefetch = prefetch_phase(torch, vgg_tr, vgg_batch)
    del vgg_tr, vgg_batch
    torch.cuda.empty_cache()
    remat = remat_phase(torch)
    torch.cuda.empty_cache()
    guard = guard_phase(torch)
    torch.cuda.empty_cache()
    optim = optim_phase(torch)

    # 21. the v1 bi-GRU config and 22. the v1 MNIST LeNet config through
    # `python -m paddle_tpu_torch train`, in process (counters from 0)
    torch.cuda.empty_cache()
    v1_bigru = v1_bigru_phase(torch)
    torch.cuda.empty_cache()
    v1_lenet = v1_lenet_phase(torch)

    # 23. the v1 seqToseq demo through recurrent_group, 24. a paddle.v2
    # script, 25. the deployment path on phase 21's checkpoint and phase
    # 24's model (counters from 0 in each)
    torch.cuda.empty_cache()
    v1_seq2seq = v1_seq2seq_phase(torch)
    torch.cuda.empty_cache()
    v2_api, v2_model = v2_api_phase(torch)
    torch.cuda.empty_cache()
    deploy = deploy_phase(torch, v1_bigru["save_dir"], v2_model)
    del v2_model

    # 26. the seqToseq demo's generating config on phase 23's pass, 27.
    # served by `serve --config` in a subprocess, 28. a paddle.v2 NMT script
    # trains and generates, 29. phase 21's config on ProtoData shards
    # (counters from 0 in each)
    torch.cuda.empty_cache()
    v1_gen, gen_model = v1_gen_phase(torch, v1_seq2seq["conf_dir"])
    torch.cuda.empty_cache()
    serve_config = serve_config_phase(torch, gen_model)
    del gen_model
    torch.cuda.empty_cache()
    v2_gen = v2_gen_phase(torch)
    torch.cuda.empty_cache()
    v1_proto = v1_proto_phase(torch, os.path.dirname(v1_bigru["save_dir"]))

    # 30. the v2 book's machine translation chapter through wmt14, 31. its
    # six other chapters through their readers (counters from 0 in each)
    torch.cuda.empty_cache()
    book_nmt = book_nmt_phase(torch)
    torch.cuda.empty_cache()
    book = book_chapters_phase(torch)

    # 32. AlexNet and GoogLeNet at 224x224, batch 128, in f32 and bf16, 33.
    # the reference's AlexNet v1 config under --job=time, 34. the 36 layers
    # of the v1 vocabulary card vs CPU, 35. a v1 config of the new helpers
    # trained as one graph (counters from 0 in each)
    torch.cuda.empty_cache()
    image_models = image_models_phase(torch)
    torch.cuda.empty_cache()
    v1_alexnet = v1_alexnet_phase(torch)
    torch.cuda.empty_cache()
    vocab = vocab_phase(torch)
    v1_vocab = v1_vocab_phase(torch)

    # 36. a fluid Program (recognize_digits) trains as one CUDA graph, 37.
    # the fluid LSTM text classifier at rnn_bench's widths, 38. fluid
    # control flow and generation ops card vs CPU, 39. the GAN demo's two
    # phases through MultiNetworkTrainer
    torch.cuda.empty_cache()
    fluid_digits = fluid_digits_phase(torch)
    torch.cuda.empty_cache()
    fluid_lstm = fluid_lstm_phase(torch)
    torch.cuda.empty_cache()
    fluid_control = fluid_control_phase(torch)
    torch.cuda.empty_cache()
    gan = gan_phase(torch)

    # 40. SSD trains at full width and detects, 41. the structured costs, 42.
    # SimpleRnn / MDLstm and a v1 recurrent_layer config, 43. the 3-D layers,
    # 44. the native runtime feeding a step graph (counters from 0 in each)
    torch.cuda.empty_cache()
    ssd = ssd_phase(torch)
    torch.cuda.empty_cache()
    struct_costs = struct_costs_phase(torch)
    torch.cuda.empty_cache()
    rnn_extra = rnn_extra_phase(torch)
    torch.cuda.empty_cache()
    layers3d = layers3d_phase(torch)
    torch.cuda.empty_cache()
    runtime = runtime_phase(torch)

    # 45. the serving fleet in one process and 46. as processes with a router
    # takeover (launch counters from 0 in each run)
    release(torch)
    fleet = fleet_phase(torch, smi)
    fleet_proc = fleet_process_phase(torch, smi, fleet)

    # 47. cluster training through the task master with a failover, 48. the
    # autoscaler in front of replica processes and a trainer (counters from
    # 0 in each process)
    release(torch)
    cluster = cluster_phase(torch)
    autoscale = autoscale_phase(torch, fleet)
    del fleet["reqs"]

    # 49. ResNet-50 through DataParallel over a one-rank NCCL group for the
    # replicated, zero1 and zero3 updaters, 50. seq2seq through it, replicated
    # and zero2 + int8 (collective and GRU counters from 0 in each run)
    release(torch)
    dp_resnet, dp_mesh = dp_resnet_phase(torch, resnet)
    release(torch)
    dp_seq2seq = dp_seq2seq_phase(torch, dp_mesh)
    del dp_mesh

    # 51. tensor-parallel serving at GPT-2-small widths: two rank threads on
    # the card over gloo against tp 0 (launch and collective counters from 0)
    release(torch)
    tp_serve = tp_serve_phase(torch, bw, f32_flops)

    # 52. lines
    from paddle_tpu_torch.ops import paged_attention as pa

    main_row = next(r for r in rows if r["shape"] == "gpt2_small_s8")
    kernels = [{
        "name": "paged_attention_decode",
        "route": "cuda",
        "source": "paddle_tpu_torch/csrc/paged_attention.cu",
        "replaces": "paddle_tpu/ops/pallas/paged_attention.py:108",
        "launches": serve["launches"],
        "launches_fleet": fleet["clean"]["launches"],
        "launches_fleet_faulted": fleet["faulted"]["launches"],
        "launches_fleet_processes_survivor": fleet_proc["survivor"]["launches"],
        "launches_autoscale_replicas": {
            n: r["launches"] for n, r in autoscale["replicas"].items()},
        "launches_tp2_per_rank": tp_serve["launches_per_rank"],
        "max_abs_err": max([r["max_abs_err"] for r in rows]
                           + [tp_serve["kernel_h6"]["max_abs_err"]]),
        "ms": main_row["kernel_ms"],
        "kernel_ms": main_row["kernel_ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "graph_ms": main_row["graph_ms"],
        "achieved_tb_s": main_row["achieved_tb_s"],
        "plan": pa.split_plan(
            *(main_row[k] for k in ("S", "H", "hd", "PS", "P")),
            torch.cuda.get_device_properties(0).multi_processor_count)._asdict(),
        "shape": main_row["shape"],
        "shapes": rows + [tp_serve["kernel_h6"]],
    }]
    g_main = next(r for r in gru_rows if r["shape"] == "s2s_encoder")
    g_v1 = next(r for r in gru_rows if r["shape"] == "v1_bigru")
    no_library = ("none: no single PyTorch call computes this GRU (torch.nn.GRU "
                  "applies the reset gate after the recurrent product and takes "
                  "no step mask)")
    for leg, replaces, launches, errs in (
        ("fwd", "paddle_tpu/ops/pallas/rnn_kernels.py:378", train["gru_fwd_launches"],
         [e[k] for r in gru_rows for d in ("fwd", "rev")
          for e in [r[f"fwd_err_{d}"]] for k in e]),
        ("bwd", "paddle_tpu/ops/pallas/rnn_kernels.py:391", train["gru_bwd_launches"],
         [v["max_abs_err"] for r in gru_rows for d in ("fwd", "rev")
          for v in r[f"bwd_err_{d}"].values()]),
    ):
        v1_key = "FWD_LAUNCHES" if leg == "fwd" else "BWD_LAUNCHES"
        kernels.append({
            "name": f"gru_seq_fused_{leg}",
            "route": "cuda",
            "source": "paddle_tpu_torch/csrc/gru_seq.cu",
            "replaces": replaces,
            "launches": launches,
            "max_abs_err": max(errs),
            "ms": g_main[f"{leg}_kernel_ms"],
            "kernel_ms": g_main[f"{leg}_kernel_ms"],
            "plain_ms": g_main[f"{leg}_plain_ms"],
            "bound_ms": g_main[f"{leg}_bound_ms"],
            "bound_by": g_main[f"{leg}_bound_by"],
            "library_ms": None,
            "library_note": no_library,
            "launches_v1_config": v1_bigru["kernel_launches"][v1_key],
            "launches_v2_api": v2_api["kernel_launches"][v1_key],
            "launches_v2_gen_train": v2_gen["train_launches"][v1_key],
            "launches_v1_proto": v1_proto["kernel_launches"][v1_key],
            "launches_book_nmt_train": book_nmt["kernel_launches"][v1_key],
            "launches_cluster_trainers": [cluster[n][f"gru_{leg}_launches"]
                                          for n in ("trainer_a", "trainer_b")],
            "launches_autoscale_trainer": autoscale["trainer"]["launches"][v1_key],
            "launches_dp_seq2seq": {
                run: dp_seq2seq[run][f"gru_{leg}_launches"]
                for run in ("replicated", "zero2_int8")},
            **({"launches_deploy": deploy["forward_launches"]["FWD_LAUNCHES"]
                + deploy["get_layer_output_launches"]["FWD_LAUNCHES"],
                "launches_v2_infer": v2_api["infer_launches"]["FWD_LAUNCHES"],
                "launches_v2_gen_infer": v2_gen["infer_launches"]["FWD_LAUNCHES"],
                "launches_book_nmt_infer": book_nmt["infer_launches"]["FWD_LAUNCHES"]}
               if leg == "fwd" else {}),
            "v1_config_shape": {k: g_v1[f"{leg}_{k}"] for k in (
                "kernel_ms", "plain_ms", "bound_ms", "bound_by")},
            **({"bwd_parts_ms": g_main["bwd_parts_ms"],
                "note_cublas_dw_ms": g_main["note_cublas_dw_ms"]} if leg == "bwd" else
               {"us_per_step": g_main["fwd_us_per_step"],
                "sync_us_per_step": g_main["fwd_sync_us_per_step"],
                "bound_ms_all_rows": g_main["fwd_all_rows_bound_ms"],
                "bound_ms_valid_steps": g_main["fwd_valid_steps_bound_ms"]}),
            "plan": g_main["plan"],
            "shape": g_main["shape"],
            "shapes": gru_rows,
        })
    l_main = next(r for r in lstm_rows if r["shape"] == "text_cls")
    no_lstm_library = ("none: no single PyTorch call computes this LSTM (torch.nn.LSTM "
                       "has an input projection of its own, two biases and no step "
                       "mask)")
    for leg, replaces, launches, errs in (
        ("fwd", "paddle_tpu/ops/pallas/rnn_kernels.py:175",
         lstm_train["lstm_fwd_launches"],
         [e[k] for r in lstm_rows for d in ("fwd", "rev")
          for e in [r[f"fwd_err_{d}"]] for k in e]),
        ("bwd", "paddle_tpu/ops/pallas/rnn_kernels.py:191",
         lstm_train["lstm_bwd_launches"],
         [v["max_abs_err"] for r in lstm_rows for d in ("fwd", "rev")
          for v in r[f"bwd_err_{d}"].values()]),
    ):
        kernels.append({
            "name": f"lstm_seq_fused_{leg}",
            "route": "cuda",
            "source": "paddle_tpu_torch/csrc/lstm_seq.cu",
            "replaces": replaces,
            "launches": launches,
            "max_abs_err": max(errs),
            "ms": l_main[f"{leg}_kernel_ms"],
            "kernel_ms": l_main[f"{leg}_kernel_ms"],
            "plain_ms": l_main[f"{leg}_plain_ms"],
            "bound_ms": l_main[f"{leg}_bound_ms"],
            "bound_by": l_main[f"{leg}_bound_by"],
            "library_ms": None,
            "library_note": no_lstm_library,
            **({"bwd_parts_ms": l_main["bwd_parts_ms"],
                "note_cublas_dw_ms": l_main["note_cublas_dw_ms"]} if leg == "bwd" else
               {"us_per_step": l_main["fwd_us_per_step"],
                "sync_us_per_step": l_main["fwd_sync_us_per_step"],
                "bound_ms_all_rows": l_main["fwd_all_rows_bound_ms"],
                "bound_ms_valid_steps": l_main["fwd_valid_steps_bound_ms"]}),
            "plan": l_main["plan"],
            "shape": l_main["shape"],
            "shapes": lstm_rows,
        })
    a_main = next(r for r in attn_rows if r["shape"] == "b32_t512")
    kernels.append({
        "name": "attention_seq_fused",
        "route": "cuda",
        "source": "paddle_tpu_torch/csrc/attention_seq.cu",
        "replaces": "paddle_tpu/ops/pallas/rnn_kernels.py:534",
        "launches": attn_path["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in attn_rows),
        "ms": a_main["kernel_ms"],
        "kernel_ms": a_main["kernel_ms"],
        "plain_ms": a_main["plain_ms"],
        "bound_ms": a_main["bound_ms"],
        "bound_by": a_main["bound_by"],
        "library_ms": a_main["library_ms"],
        "library_note": "F.scaled_dot_product_attention with the additive mask",
        "tensor_core": "3xTF32",
        "bound_ms_f32_simt": a_main["bound_ms_f32_simt"],
        "shape": a_main["shape"],
        "shapes": attn_rows,
    })
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with open(os.path.join(REPO, "build", "chip_smoke.json"), "w") as f:
        json.dump({"nvidia_smi": smi, "build_s": build_s, "kernels": kernels,
                   "serve": serve, "wire": wire, "speculation": speculation,
                   "recovery": recovery, "train": train, "checkpoint": checkpoint,
                   "generation": generation, "train_vs_cpu": train_vs_cpu,
                   "lstm_train": lstm_train, "lstm_vs_cpu": lstm_vs_cpu,
                   "attn_path": attn_path, "route": route, "resnet": resnet,
                   "resnet_vs_cpu": resnet_vs_cpu, "lenet": lenet, "ctr": ctr,
                   "ocr": ocr, "struct_ops": struct_ops, "vgg": vgg, "remat": remat,
                   "guard": guard, "optim": optim, "prefetch": prefetch,
                   "v1_bigru": v1_bigru, "v1_lenet": v1_lenet,
                   "v1_seq2seq": v1_seq2seq, "v2_api": v2_api, "deploy": deploy,
                   "v1_gen": v1_gen, "serve_config": serve_config, "v2_gen": v2_gen,
                   "v1_proto": v1_proto, "layer_error": layer_error, "book_nmt": book_nmt,
                   "book": book, "image_models": image_models, "v1_alexnet": v1_alexnet,
                   "vocab": vocab, "v1_vocab": v1_vocab, "fluid_digits": fluid_digits,
                   "fluid_lstm": fluid_lstm, "fluid_control": fluid_control, "gan": gan,
                   "ssd": ssd, "struct_costs": struct_costs, "rnn_extra": rnn_extra,
                   "layers3d": layers3d, "runtime": runtime, "fleet": fleet,
                   "fleet_processes": fleet_proc, "cluster": cluster,
                   "autoscale": autoscale, "dp_resnet": dp_resnet,
                   "dp_seq2seq": dp_seq2seq, "tp_serve": tp_serve},
                  f, indent=1)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
