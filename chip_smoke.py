#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (paddle_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed N] [--profile]

(``--dp-worker`` is the mode in which phase 9 runs this script on each
data-parallel rank through the port's launcher; it is not for callers.)

The Programs' random seed is N + 1 (fluid reads 0 as unseeded), so a
run's weights, batches and dropout masks are a function of N.

Phases, each of which fails the run (non-zero exit) on error:
  1. environment: torch/CUDA versions, the card's name and power limit;
  2. build: every CUDA kernel from paddle_tpu_torch/ops/kernels/csrc,
     one nvcc per source, all started together;
  3. kernel parity on the card, each kernel against its plain PyTorch
     version on the same inputs (TF32 off):
       flash_attention at the BERT-base shape B=8 H=12 T=512 D=64 f32
       with a 0/-10000 padding bias, a ragged T=200 case, a causal
       case, D = 32 and 128, one query (T=1) and one key past a tile
       (T=65) (O and lse, atol 1e-4: f32-accurate 3xTF32 products and
       sums over up to 512 keys in another order); with attention
       dropout 0.1 at B=8 H=12 T=512 and
       at a ragged T=300 with D = 32, 64 and 128, and with fully masked
       rows (O exactly 0, lse log(1e-20)) (O and lse, atol 1e-4), and
       its keep mask read back from the kernel bitwise against the
       plain hash at the first two shapes; every case launched twice,
       the second launch bitwise the first;
       flash_attention_bwd (dQ, dK, dV, and the key-bias cotangent in
       six cases; D = 32, 64 and 128, ragged T, causal, dropout, fully
       masked rows) against autograd of the plain forward with the
       same mask, max|diff| <= 1e-4 * max(1, max|plain|), and a second
       launch from the same inputs bitwise the first;
       the bf16 route of both (bf16 products with f32 accumulation, P
       and dS rounded to bf16 as the Pallas kernels round them) against
       their plain bf16 versions at B=8 H=12 T=512 D=64 with and without
       dropout and at head offset 48, ragged T=300 at D = 32, causal at
       D = 128, one query and fully masked rows: O, dQ, dK, dV and the
       bias cotangent within 2e-2 of max(1, max|plain|), lse within
       1e-4, second launches bitwise;
       embedding_lookup on a 30522 x 768 table with 4096 ids,
       duplicates and out-of-range ids included (bitwise);
       embedding_scatter_add on the 30522 x 768, 512 x 768 and 2 x 768
       tables with 4096 ids each, all of them on row 0 of the 2-row
       table, a run of 1500 starting at sorted position 37, D = 16, 100
       and 1, one id, and 12,288 int32 ids (bitwise);
       embedding_lookup and embedding_scatter_add on the Transformer's
       10,000 x 512 table at phase 11's 4096 source ids, padding ids 0
       among them (bitwise);
       fused_adam over the 153 parameters of BERT-base pretraining
       (~132M f32 elements), over rank 1's rows of them (the sharded
       optimizer state: the rows bitwise the whole update's), an AdamW
       run and LeNet-5's 6 parameters:
       parameters and moments bitwise (the library is built with --fmad=false, so it rounds
       every operation as the plain version's separate kernels do);
       and, Adam and AdamW, views at element offsets 1, 2 and 3 (one
       tensor's four streams at different offsets among them), sizes
       1, 3, 5, 8191 and 8193, and a run of 200 tiny tensors, each
       tensor with its own learning rate and beta powers, one counted
       launch a run (bitwise);
       fused_lamb over the same 153 tensors plus a zero-gradient tensor
       without decay and a [1] tensor: moments bitwise, parameters to
       rtol 2e-6 / atol 3e-7 (the trust ratio's norms are summed in
       another order), and a second launch from the same state gives
       the same parameters bit for bit (fixed-order sums, no atomics);
       embedding_update (the sparse Adagrad rows) through the
       fused_emb_update op on the 1000001 x 16 table with 106,496
       uniform ids, on the 1000 x 16 table with the same ids (~106
       visits a row) and on a 1000001 x 1 table, padding_idx and
       out-of-range ids included, and on the 1000001 x 16 table with
       one id, 8192 equal ids and 2**20 + 7 uniform ids (bitwise);
       quant_quantize and quant_reduce (K8) at the shapes 2-rank
       BERT-base training gives them: the 30522 x 768 table gradient
       (quantize [91566, 256], reduce [2, 45783, 256]), a 768 x 3072
       gradient ([9216, 256], [2, 4608, 256]), the fused bucket of the
       101 small gradients (124,418 elements padded to 124,928) and
       block 64 on an unaligned size; the reduce also at blocks 8, 9,
       200, 256, 1024 and 4096, n = 1, 2, 3 and 8, one row and 37 rows
       with an all-zero row and a row whose absmax is its last element,
       and shards at byte 1 of their buffer (bitwise);
       dropout and dropout_grad (the dropout op's forward, with Mask
       and without it, and its gradient from the saved seed) at
       BERT-base's [8, 512, 768], the Transformer FFN's [64, 64, 2048]
       and an odd [7, 13, 33], f32 and bf16, both implementations, p
       0.1, 0 and 1, NaN, infinite and -0 inputs and gradients, a
       non-contiguous view and one at an element offset, every launch
       twice: the forward against its plain version, the gradient
       against the gradient from the saved Mask that it replaces, and
       the autograd Function's gradient against autograd through the
       plain version (bitwise);
  4. serving: BERT-base (12 layers, hidden 768, seq 512, random weights
     from --seed) built with the port's layers, saved with
     save_inference_model, loaded by create_paddle_predictor on
     CUDAPlace(0), answering 3 requests of batch 1, 3 and 8 (buckets 1,
     4, 8), each eagerly (use_program_cache=False through the
     predictor's executor) and then from its bucket's CUDA graph (the
     bucket's first run, its capture with one replay, a replay, a
     profiled replay).  Every eager call and first run must launch
     flash_attention 12 times and embedding_lookup 3 times at the
     wrappers, and every replay replay as many through its graph's
     launch manifest (counted apart as replayed launches), which the
     profiled replay must show as K1's and K6's kernels; outputs are
     finite [b, 512, 768] and every graph answer is bitwise the eager
     one; the batch-8 answer matches the same predictor run with the
     plain versions (FLAGS_torch_kernels_plain) to max-abs 1e-3, whose
     runs take a CUDA graph of their own and launch no kernel;
  5. training: BERT-base pretraining (build_pretrain(BASE, 512), MLM +
     NSP heads, hidden and attention dropout 0.1) with
     fluid.optimizer.Adam(1e-6, epsilon 1e-6).minimize on
     CUDAPlace(0): the startup program, then 3 steps of batch 8 on one
     repeated synthetic_batch, through Executor.run as it runs by
     default (as every training phase's steps: step 1, which fetches
     gradients too, and step 2 each their signature's first run,
     eager; step 3 captured in a CUDA graph and replayed; a step's
     launches are those at the wrappers plus those its graph's replay
     ran).  Each step must launch flash_attention
     (with dropout) 12 times, flash_attention_bwd 12, embedding_lookup
     3, embedding_scatter_add 3, fused_adam once, and dropout and
     dropout_grad 25 times each (each dropout op in training mode, here
     and in every training phase: 37 at seq 128, where attention takes
     the naive chain, 32 on the Transformer, 1 on SE-ResNeXt-50; the
     forward writes Mask only where it is read: step 1 fetches the last
     dropout op's X, Out and Mask, which must be bitwise dropout_plain
     of X); the loss is finite
     and falls from step 1 to step 3, and at step 3 it is below the loss
     the same 3 steps give with the parameters held (each step from the
     starting state: the same dropout masks, so the difference is what
     the updates learned).  Step 1 again from the same state
     with the plain versions gives the same loss (rel. 1e-4) and
     gradients, first moments and parameters within the limits printed;
     peak device memory is printed;
  6. LAMB pretraining: the same model with
     lr = linear_lr_warmup(polynomial_decay(4e-5, 1000, 0.0), 2, 0.0,
     4e-5) and fluid.optimizer.Lamb(lr, lamb_weight_decay
     0.01, epsilon 1e-6, grad_clip=GradientClipByGlobalNorm(1.0)), 3
     steps of batch 8: each step launches flash_attention 12 times,
     flash_attention_bwd 12, embedding_lookup 3, embedding_scatter_add
     3, fused_lamb once (one run over all 153 parameters) and fused_adam
     never; the rate of each step is printed; the loss checks of phase
     5; step 1 (rate 0) against the plain path as in phase 5;
  7. Wide&Deep CTR training: models.wide_deep.build at BASE widths with
     the hashed Criteo feature space (sparse_feature_dim 1000001:
     embedding 16, 26 sparse and 13 dense fields, hidden 400-400-400)
     and fluid.optimizer.Adagrad(1e-3, epsilon 1e-6), 3 steps of batch
     4096 (106,496 ids a step): each step launches embedding_lookup 2
     times and embedding_update 2 (the deep and the wide table's rows)
     and nothing else; the loss falls below the held run's; step 1
     again with the plain versions gives the same loss and state bit
     for bit (the same PyTorch ops around kernels that are bitwise
     their plain versions);
  8. timings: each kernel, its plain version and the PyTorch library
     call at the main path's shapes (K8 at the table gradient's; its
     768 x 3072 shape beside it) (device time of CUDA-graph replays,
     L2 flushed before each call; a plain version that syncs with the
     host is timed with CUDA events around single calls instead), the
     least time the card could take (bound; for K1 and K2 with their
     products as f32-accurate 3xTF32 products on the tensor cores, the
     f32-pipe bound beside it; their bf16 rows, flash_attention[bf16],
     flash_attention[bf16,dropout] and flash_attention_bwd[bf16], at
     the dense bf16 rate, beside SDPA in bf16; K1's, K4's and K8's
     reduce rows also
     print the time before their redesign), K4 also at LeNet-5's 6
     tensors (a row of its own, fused_adam[lenet]), K6b also on the 2-row
     sentence table (a row of its own) and split into its sort, its
     zeroing and its
     passes on both tables, K7 also on the 1000001 x 1 table (a row of
     its own), the 1000 x 16 table and a 64 x 16 table whose 8192 ids
     all but six are 0 (one run of 8187), these two beside the sparse
     step of torch.optim.Adagrad on them, and split into its sort and
     its run kernels on the three Wide&Deep tables, K6b past its
     one-block sort (16,384 and 65,536 ids on the word table, beside
     index_add_, bitwise its plain version), K6 and K6b on the
     Transformer's 10,000 x 512 table at phase 11's source ids (rows of
     their own, embedding_lookup[nmt] and embedding_scatter_add[nmt]),
     the dropout kernels (upscale_in_train) at BERT-base's [8, 512,
     768] in f32 and bf16 (rows dropout and dropout[bf16] with Mask,
     dropout[no mask] and dropout[bf16,no mask] without it, beside
     torch.native_dropout; dropout_grad and dropout_grad[bf16] beside
     native_dropout_backward), an empty kernel launched and timed the
     same way, the gradient as the PyTorch chain it replaces, and each
     kernel at the Transformer FFN's [64, 64, 2048] and at DROPOUT_BIG
     times BERT-base's tensor with its share of its bound,
     the crossover of the naive attention chain (the port's lowerings,
     autograd for its backward) and K1 (forward) and K1 + K2 (forward
     and backward) on BERT-base's attention at seq 128, 256 and 512
     with 4096 tokens each (no dropout, a padding bias; the two routes'
     outputs within 1e-4), the request latency per batch size eagerly
     and from graph replays (median of 5 requests, the self CPU, device
     time and device-op count of a profiled request, in which K1's and
     K6's kernels must appear once a launch, and peak memory), the
     median step of each training path, with the garbage collections
     and allocator retries of each timed step, and (phases 5, 6 and 7;
     10's LeNet-5 Adam, ResNet-50 and SE-ResNeXt-50, 11's BERT-base at
     seq 128 and Transformer and 13's AMP BERT-base at seq 512 and AMP
     ResNet-50 in their phases) 5 steps three ways from the same state
     and executor step: with use_program_cache=False, from the plan
     cache eagerly (Executor.run's path without its CUDA graph) and
     from the plan cache with CUDA graphs, as Executor.run runs by
     default (the graphs captured before freed; the first step eager,
     the second captured with one replay, the rest replayed): each
     side's median
     step (the graph side's over its replays), a profiled step's self
     CPU and device time and the peak memory, the graph side's first
     run, capture and graph pool; every loss and the whole startup
     state (parameters, moments, beta powers, learning-rate counter,
     loss scale and counters) bitwise equal on the three sides, the
     scope's tensors the same objects, and on the graph side one
     capture, nothing refused (LAMB, Wide&Deep and BERT-base at seq
     128 print why where their capture is refused) and the launches at
     the wrappers plus the replayed launches the eager side's, kernel by
     kernel.  The library call for
     the flash backward is
     SDPA's memory-efficient backward op on its own forward's saved
     outputs; for the row update (deep and wide tables),
     torch.optim.Adagrad's step on a sparse gradient; PyTorch has no
     LAMB and no block-scaled int8 quantize (null; phase 9 times the
     dense collective on the same payload as K8's collective-level
     yardstick);
  9. data-parallel training: this script again on 2 ranks through
     ``python -m paddle_tpu_torch.distributed.launch --nproc_per_node 2``
     (one card a rank over NCCL where the machine has two cards or
     more, else both ranks on card 0 over gloo, the wire staged through
     host memory).  Each rank builds phase 5's program, rewrites it with
     GradAllReduce over the 2 endpoints with FLAGS_comms_quantize on
     and trains 3 steps of batch 8 on data from --seed + rank.  Each
     step must launch K8's quantize and reduce once for every planned
     collective the transpiled program holds whose arm is 'quant' (53
     at BERT-base), and the other kernels as in phase 5; after every
     step the ranks' parameters are bitwise equal; the loss at step 3
     is below the held run's; step 1's all-reduced gradients of the
     quantized arm lie within the quantization bound of the dense
     arm's (per block, sum_r s_r / 2 + s_red / 2); one quantized
     all-reduce of the table gradient is bitwise its plain path's.
     Each rank's step medians with the arm on and off, its peak device
     memory and the collective times (quantized, flat dense, the
     planner's dense rs_ag) of the table gradient are printed; a rank
     that fails fails the phase;
 10. image classification on CUDAPlace(0): LeNet-5 (models.lenet, batch
     64 of synthetic MNIST from --seed) with fluid.optimizer.Adam(1e-3)
     and with SGD(0.01), 3 steps and 5 timed steps each: every Adam step
     launches fused_adam once (8 in all) and every SGD step nothing; the
     loss falls; metrics.Accuracy accumulates the fetched accuracy; step
     1 again with the plain versions agrees (loss rel 1e-4, gradients
     and Adam's moments or SGD's parameter changes rel 1e-3); peak
     memory and a profiled step's device time are printed.  ResNet-50
     (models.resnet, full depth and width, 1000 classes) at batch 128
     of 3 x 224 x 224 f32 NCHW images from --seed with Momentum(0.1,
     0.9) and L2Decay(1e-4): 3 steps and 5 timed, no kernel of the port
     launched; step ms, images/s, the device time of
     a profiled step and the peak memory are printed; every moving mean
     and variance changes; its clone(for_test=True) at batch 32 gives
     finite [32, 1000] logits, the same on a second run; step 1 at batch
     4 from the same state on CUDAPlace(0) and on CPUPlace(): the f32
     losses within rel 1e-4, and in float64 the loss and every
     parameter, velocity and moving statistic within 1e-6 of their
     largest (the f32 states' distances from float64 are printed).
     SE-ResNeXt-50 (cardinality 32) at batch 32, the same optimizer, 3
     steps: finite losses, every moving statistic updated, step ms, a
     profiled step's device time and peak memory printed.  Convolutions
     run in f32 on cuDNN whatever torch.backends.cudnn.allow_tf32 says;
 11. the attention chain below flash_min_len on CUDAPlace(0): BERT-base
     built by build_pretrain(BASE, 128, is_test=True), saved and served
     through create_paddle_predictor at batches 1, 8 and 32 (buckets 1,
     8, 32) eagerly and from CUDA graphs as in phase 4: each call
     launches embedding_lookup 3 times and no flash kernel, the graph
     answers bitwise the eager ones, the batch-8 answer within 1e-3 of
     the plain path, latency both ways as in phase 8;
     BERT-base pretraining at seq 128 with Adam as in phase 5 at batch
     32 (4096 tokens), each step launching embedding_lookup 3 times,
     embedding_scatter_add 3 and fused_adam once, the loss checks and
     step 1 against the plain path of phase 5; Transformer-base NMT
     (models.transformer BASE: d_model 512, 8 heads, ffn 2048, 6 + 6
     layers, vocabularies of 10,000, dropout 0.1, label smoothing 0.1)
     with Adam(1e-4, epsilon 1e-6) at batch 64 of 64 x 64 ragged,
     bucket-padded pairs, 3 steps, each launching embedding_lookup 2
     times, embedding_scatter_add 2 and fused_adam once, with the same
     checks, then one step of a 32 x 32 batch on the same Program (its
     launches, a finite loss, and the loss, gradients and moments
     against the plain path); every path's latency or step time and
     rate, peak memory and a profiled request or step (its device time
     and 10 largest kernels) are printed.  f32 products run without
     TF32 whatever torch.backends.cuda.matmul.allow_tf32 says;
 12. data parallel through CompiledProgram.with_data_parallel.  In this
     process (no process group: one replica) ResNet-50 at batch 128, 3
     steps with cuDNN's deterministic algorithms, and BERT-base seq 512
     (hidden dropout 0, attention dropout 0.1) under
     ReduceStrategy.Reduce, 1 step, each bitwise Executor.run of the
     same Program from the same state (losses and the whole state).
     In phase 9's job, after its steps, on its 2 ranks: ResNet-50 at
     batch 64 a rank (rows of the global batch of 128), 3 steps and 5
     timed, no kernel launched, the ranks' states bitwise equal after
     each step; step 1 against one replica of batch 128 on rank 0 (loss
     rel 1e-4, moving statistics within 1e-3 of their largest; the
     parameters' and velocities' distances printed, not held in f32)
     and again in float64 at batch 4 a rank against one replica of
     batch 8 (the loss and every variable within 1e-6); each rank's and
     the job's step ms and images/s, the gradient all-reduce alone and
     the peak memory.  Then BERT-base under Reduce at batch 4 a rank, 3
     steps, each launching K1 and K2 12 times, K6 and K6b 3 and K4 once,
     the parameters bitwise equal on the ranks after each, every moment
     holding half its rows; each rank's K1 mask of step 1, read back,
     bitwise its rows of dropout_keep_plain over the global batch; step
     1 against one replica of batch 8 with the same masks (loss rel
     1e-4, parameters and moments within 1e-3 of their largest); step
     ms, tokens/s, and each rank's peak beside one AllReduce-strategy
     step's;
 13. mixed precision (fluid.contrib.mixed_precision.decorate, bf16
     compute with dynamic loss scaling, as the JAX package's bench.py
     trains): (a) BERT-base pretraining at seq 512, batch 8, under
     decorate(Adam(1e-4)), attention dropout 0.1 in the kernels, 3
     steps, each launching K1 and K2 on their bf16 route 12 times, K6
     and K6b 3 times and K4 once, and the dropout kernels 25 times
     each, with finite f32 losses, f32 master gradients and no overflow;
     step 1 fetches the last dropout op's bf16 X, Out and Mask, bitwise
     dropout_plain of X; step 1 against the plain path (the
     plain bf16 K1 and K2: loss rel 1e-2, gradients and moments 5e-2
     of their largest, the loss scale and counters bitwise); its
     for_test clone (K1 bf16 without dropout 12 times); (b) the same at
     seq 128, batch 32 (the naive chain in bf16); (c) ResNet-50 at
     batch 128 in NHWC under decorate(Momentum(0.1, 0.9)), 3 steps and
     5 timed, bf16 activations, step 1 within rel 5e-2 of the f32 step
     from the same state; (d) word2vec CBOW (vocabulary 2000, embedding
     32, hidden 256, 4 context words) with SGD(1e-3) in f32 at batch
     32, 3 steps, 4 K6 and 4 K6b launches a step on the shared table,
     step 1 bitwise its plain path; (e) one step of (a)'s program that
     overflows at the current scale (the scale set to 2^127 with one
     bad step behind it, the MLM decoder weight times 64): the verdict
     true on the card, the scale halved, Adam's moments decayed bitwise
     and its beta powers advanced, no synchronizing call inside the
     step, which is its signature's first run; then the same step
     twice more from the same state and executor step, captured with
     one replay and then replayed under the same sync debug mode:
     bitwise the eager step, its launches all replayed.  Each path prints its step ms (median of 5), rate, a
     profiled step's device time and peak memory beside the same
     model's f32 numbers from phases 5, 10 and 11 of the run, and the
     card's name and power limit.
 14. the data and IO plane: (a) Wide&Deep at phase 7's widths trained
     from MultiSlot text files in Criteo's layout written from --seed
     (8 full batches of 4096 and one of 1000 over 4 files): the native
     feeder's parse rate (QueueDataset, 4 threads) and load_into_memory,
     then InMemoryDataset + local_shuffle through
     exe.train_from_dataset(thread=4) and QueueDataset through
     train_from_dataset(thread=1), each bitwise exe.run over the same
     batches from the same state (every loss and the whole state), 2
     embedding_lookup and 2 embedding_update launches a step; the
     prediction saved with save_inference_model and answered, bitwise
     the training program's clone(for_test=True), by
     load_inference_model in a fresh scope, infer_from_dataset and
     create_paddle_predictor; examples/s through train_from_dataset
     beside the same steps fed from staged device tensors; (b) phase
     5's BERT-base program for 5 steps fed by
     DataLoader.from_generator(capacity=4, use_double_buffer=True) on
     cuda_places(), bitwise the numpy-fed steps with phase 5's launches
     a step, a checkpoint after step 3 (save_persistables, npz and
     save_format='paddle') resumed in a fresh scope bitwise the
     uninterrupted steps 4-5, and loaded into the running scope with no
     new capture (its graph replays steps 4-5 bitwise again); the
     step time both ways and the loader's next() per step.
 15. control flow and RNN sequences: an LSTM seq2seq at the widths of
     PaddleNLP's seq2seq example for IWSLT'15 en-vi without attention
     (models.seq2seq.BASE: 2 LSTM layers, hidden and embeddings 512,
     vocabularies 17,191 and 7,709, dropout 0.2 between the encoder's
     layers) with Adam(1e-3) and GradientClipByGlobalNorm(5.0), batch
     128 of 50 + 50 tokens with lengths from --seed and Zipf-drawn ids
     (models.seq2seq.zipf_ids: eos is not the most frequent token, so
     the trained model's beams do not all end at once): the encoder's two
     masked dynamic_lstm, the decoder teacher-forced through a
     layers.While(max_trip_count=51) over two LSTMCells (bounded and
     masked: no host read).  3 steps through Executor.run as every
     training phase runs them, each launching embedding_lookup and
     embedding_scatter_add twice, fused_adam, dropout and dropout_grad
     once; the loss falls below the held run's; step 1 again with the
     plain versions bitwise (loss and whole state); the replays'
     median, a profiled step's device time, peak memory and target
     tokens/s; plan_cache_steps (uncached, cached eager and replayed
     bitwise, one capture with the While inside).  Then, from the
     trained scope, BeamSearchDecoder + dynamic_decode at beam 10 and
     50 steps (no while: captured, its replays bitwise the plain path,
     51 embedding_lookup launches a run) and the book's decode, a
     forward-only While over layers.beam_search, array_write and
     gather_tree that stops when every beam has ended or at 50 steps
     (captured with a CUDA graph WHILE node, its replays bitwise the
     plain path, 1 + trips embedding_lookup launches a run and, in a
     graph's run, 1 + trips graph_cond launches), each
     with its live steps (the While's trips; the last step at which
     dynamic_decode's ids hold a beam that has not ended), which must
     reach S2S_MIN_LIVE, its ms a batch and a profiled run's device
     time.
 16. structured prediction and recompute: (a) the Fluid book's
     label_semantic_roles (models.label_semantic_roles.BASE: db_lstm
     with embeddings 32 and 5, hidden 512, depth 8, a linear-chain CRF
     over 59 IOB labels, the CoNLL-2005 dictionaries' 44,068 words and
     3,162 predicates; SGD on exponential_decay(0.01, 100000, 0.5), batch
     10) on synthetic sentences of 4-100 words (mean ~25) from --seed,
     fed by DataLoader.from_generator(bucket_boundaries=[16, 32, 64,
     128], batch_size=10) onto CUDAPlace(0): every batch bitwise a numpy
     padding of the same samples; each step through Executor.run with
     the K6 and K6b launches the program implies (8 and 2); at least
     20 steps, 3 buckets of 2 or more; each bucket's first step again
     with the plain versions bitwise (loss and state), a replay of each
     bucket's own graph bitwise its eager step; per bucket the
     replayed and eager ms, a profiled replay's device ms, peak memory
     and tokens/s; then the eval clone (crf_decoding + chunk_eval IOB,
     29 types) on held-out batches: a pipeline whose device units replay
     around the chunk_eval host op, bitwise the plain path, chunk
     counts equal to numpy's, precision, recall
     and F1; (b) BERT-base at seq 512 batch 8 with
     RecomputeOptimizer(Adam), a checkpoint at each encoder layer's
     output, 3 steps from the same start as the same steps without
     recompute: every loss and the whole state bitwise (or, where
     autograd sums in another order, the loss within rel 1e-6 and each
     state tensor within 1e-5 of its max), step 1's peak memory below
     the unrecomputed step's, launches exact (K1, K6 and the dropout
     forward once more for each recomputed op), plan_cache_steps
     (replays bitwise eager), the step ms and device ms both ways;
     (c) every other new op type (the CRF pair, warpctc, ctc_align,
     edit_distance, hierarchical_sigmoid, sample_logits, cos_sim,
     pyramid_hash, filter_by_instag, var_conv_2d, tree_conv, row_conv,
     nce with each sampler) at a size its users run: forward and
     gradients twice bitwise, and against the same lowering on the CPU
     (integers and samples exact, floats within 1e-5 of the largest
     magnitude);
 17. the core layers, ops and optimizers, cuDNN deterministic through
     (a): (a) MobileNetV3-Large at the paper's widths
     (models/mobilenet_v3.py BASE: 5,480,206 parameters, 1000
     classes) at batch 128 of 224 x 224 images from --seed, with
     RMSProp (momentum 0.9, rho 0.9), L2 decay 1e-5, the staircase
     exponential decay and ExponentialMovingAverage(0.9999): 3 steps
     through Executor.run (the dropout forward and gradient once each
     a step, exact; step 3 replayed), the loss falling and finite, step
     1 bitwise the plain path (every state variable, EMA and RMSProp
     accumulators among them), plan_cache_steps (5 steps each
     uncached, cached eager and replayed, bitwise; host clock, self
     CPU, device time, peak), and one profiled eager step's share of
     the depthwise convolutions and of the 176 rmsprop ops; (b)
     LarsMomentum, Adamax, Adadelta, centered RMSProp, Ftrl, Dpsgd
     (sigma 0), DecayedAdagrad, DGCMomentum, ModelAverage (with its
     apply / restore) and Lookahead, 3 LeNet-5 steps each in float64
     at batch 16, each step from the port's CPU state before the same
     CPU step: the loss and the state within 1e-5 (relative, plus 1e-5
     of the largest of its kind), the CPU tests' tolerance; dpsgd's
     noise by its moments; (c) every op type of the
     slice at a size its users run, twice bitwise and against the CPU
     (integers exact, floats within 1e-5 of the largest magnitude).
 18. the observability plane, outside the kernels line's counts: (a)
     phase 5's BERT-base Adam step, 3 cached eager steps under
     fluid.profiler 'Default' (torch.profiler, CUPTI): the per-op
     device table, whose rows (unattributed included) must sum to the
     profiled device time within 1%, K1's kernels under
     fused_multihead_attention and K2's under its grad, no more than
     5% unattributed, opprof's worklist naming K1 and K2 as the cover
     of those runs; then one 'Serial' step (op by op); (b) FLAGS_trace
     off against on over replayed and cached eager steps, the tracer
     switched at every step, step_report's phases; the capturing step
     must record the replay's spans only; (c) phase 14's Wide&Deep
     through train_from_dataset beside staged device tensors, timed as
     phase 14 times them, one traced epoch each: reader_wait's share,
     the queue depth, the consumer's waits; (d) SE-ResNeXt-50's
     replayed step under the profiler: its device union over the
     streams must not pass the step's wall; (e) phase 15's two decodes
     traced and profiled: wall against device time; (f) MobileNetV3-
     Large's first run under FLAGS_memviz: memviz.peak_bytes against
     torch.cuda.max_memory_allocated (within 1%), the row's parts
     summing to it, live_census against memory_allocated; (g) the
     status server on port 0 read from a thread during replayed steps:
     /healthz ready, /metrics clean under prom_lint, /statusz naming
     the card; (h) self CPU of an AMP BERT-base and a LeNet-5 step,
     uncached and cached eager, in both orders.
 19. the rest of the compile plane (phase 1 prints the CUDA driver and
     runtime versions; conditional nodes need 12.3): (a) phase 15's
     book decode (batch 128, beam 10, a beam live for 50 steps) after 3
     training steps: 5 runs through Executor.run (eager, captured with
     a WHILE node, 3 replays), each bitwise the eager host loop
     (sequences, ids, parents, scores, trips), graph_cond and K6
     launches exact; a profiled replay with no device-to-host copy
     before its last kernel; the replayed, eager and device ms;
     (b) BERT-base pretraining with Adam (seq 512, batch 8) whose rate
     is PaddlePaddle LARK's linear_warmup_decay written with
     fluid.layers.Switch (warmup over 3 steps, then polynomial_decay to
     0 at step 5): 5 steps through Executor.run, each step's rate the
     numpy formula, steps 2-5 from the graph (its two IF nodes) and the
     whole state after each bitwise the same step run eagerly in
     lockstep; (c) the same program with layers.Print(loss): one device
     unit replayed and a host tail, through Executor.run and through
     compile(allow_host=True), one printed line a step, bitwise (b)'s
     eager steps, the replayed ms beside the cached eager ms; (d) a
     save and a load between two device units (4096 x 1024): the
     saved file is the unit's output, a load of new weights in place
     is honoured by the next replay, bitwise eager; (e) (b)'s step as
     a training CompiledStep: 4 calls (3 replayed) bitwise (b)'s eager
     steps, the caller's state bitwise untouched, the ms and the pool's
     growth; (f) (b)'s step under FLAGS_check_nan_inf: finite_check
     launched once a step, no trip over 4 healthy steps, then a
     parameter set to inf through the scope: the replayed step raises
     FloatingPointError naming the eager step's variables, with
     provenance; the step ms with the check on and off, replayed and
     eager, and the pool growth of the check's input copies.  The
     kernels line gains finite_check, timed at (f)'s checked set, and
     graph_cond, whose launches all run in graph replays ((a), (b)).
 20. the dataset loaders, the rest of the core and the nn ops, under
     cuDNN's deterministic algorithms: (a) the book's image classifier,
     the JAX package's resnet18_cifar (ResNet-18 at 3 x 32 x 32, 10
     classes) with Adam(0.001) at batch 128 (Fluid 1.6's book
     test_image_classification.py), fed from dataset.cifar.train10()
     through reader.shuffle, reader.batch and a DataLoader staging onto
     the card: 20 steps through Executor.run (step 1 eager, step 2
     captured, the rest replayed), one K4 launch each; the losses and
     the final state bitwise a second, eager-only run on the same
     batches; step 1 bitwise its plain-kernel step; the loss falling;
     the for_test clone over test10()'s batches (no kernel launched);
     the replayed, cached eager and device ms and the peak; (b) phase
     7's Wide&Deep with fluid.layers.auc(num_thresholds=4095) on its
     [1 - p, p] predictions, 10 steps (2 K6 and 2 K7 launches each,
     replayed from step 2): StatPos / StatNeg and the outputs bitwise
     an eager-only run after every step, step 10's AUC within 1e-6 of
     the auc op's CPU lowering on that step's predictions and
     statistics (which it reproduces bitwise); the replayed step beside
     Wide&Deep without auc; (c) every op type of the nn slice (item
     11b's nn_ops, size, rank, soft_relu,
     gaussian_random_batch_size_like) at a size its users run, forward
     and gradient, against the CPU lowering (floats within 1e-5 of the
     largest magnitude, integers exact) and twice bitwise, but
     grid_sampler's X gradient (F.grid_sample adds it with atomics);
     (d) a denoising step drawing gaussian_random_batch_size_like,
     gaussian_random and uniform_random (10^6 values each) in a main
     program: 6 steps, 5 replayed, each bitwise the eager step of the
     same number, each drawing anew, step 1's means and standard
     deviations within 3 sigma of their sampling error;
 21. dense vision, losses and misc (ROADMAP item 11b's groups A and B),
     under cuDNN's deterministic algorithms: (a) C3D at the paper's
     widths (Tran et al. 2015: eight 3x3x3 conv3d of 64 to 512, five
     max pool3d, pool5 padded (0, 1, 1), fc6 / fc7 of 4096 with dropout
     0.5, fc8 over 487 classes; ~80M parameters) on 3 x 16 x 112 x 112
     clips drawn on the card from the seed, batch 30, SGD at 0.003, 6
     steps (step 1 eager, step 2 captured, the rest replayed; the
     dropout kernels launched each step), the losses and the whole
     state bitwise an eager-only run; the replayed, cached eager and
     device ms, the convolution kernels' share of an eager step's
     device time and the peak over the resident bytes; (b) the CTR-DNN
     of PaddleRec's ctr/dnn (26 slots hashed into a 1,000,001 x 10
     table, each slot's pooled row with its show and click through
     continuous_value_model, 13 dense features through data_norm, fc
     400 x 3, softmax over 2, auc) at batch 4096 with sparse Adagrad,
     10 steps (one K6 and one K7 launch each, replayed from step 2):
     the outputs, the auc statistics and data_norm's parameters bitwise
     an eager-only run after every step, the last AUC within 1e-6 of
     the auc op's CPU lowering; (c) every op type of groups A and B at
     a size its users run (deformable_conv at DCNv2's ResNet-50 res5,
     conv3d and pool3d at C3D's layers), forward and gradient, against
     the CPU lowering (floats within 1e-5 of the largest magnitude,
     integers exact) and twice bitwise, none exempt (the host ops
     unique and unique_with_counts through a program); (d) a program
     with two losses on the whole-program grad (2 seeds) against the
     per-op grad path (rtol 1e-5, atol 1e-6) and
     nets.scaled_dot_product_attention in a step replayed bitwise its
     eager step;
 22. detection (ROADMAP item 11b's group C), under cuDNN's deterministic
     algorithms: (a) MobileNet-SSD (PaddleCV ssd/mobilenet_ssd.py:
     MobileNet-v1 at scale 1.0, multi_box_head over the 19^2 to 1^2
     maps, 1,917 priors, 21 classes) on 300 x 300 images of the VOC2012
     loader's synthetic stand-in, batch 64, the summed ssd_loss, RMSProp
     at 0.001 with L2Decay 5e-5, 6 steps (step 1 eager, step 2
     captured, the rest replayed; K6 each step, for ssd_loss's matched
     gt rows), the losses and the whole state bitwise an eager-only
     run; the replayed and cached eager ms, images/s, the three largest
     kernels' share of an eager step's device time, the peak; the
     for_test clone with detection_output over softmaxed confidences,
     replayed bitwise its eager run, detection_output alone timed
     replayed and eager with its launches a call, and the mAP
     (DetectionMAP) of its rows; (b) the Faster R-CNN RPN and RoI head
     at Detectron's shapes (PaddleCV rcnn's C4 defaults at 800 x 1333:
     a fed res4 map [1, 1024, 50, 84] through a trainable 1 x 1
     convolution, 15 anchors a cell, 12,000 / 2,000 proposals at NMS
     0.7, 256 RPN samples, 512 rois at 14 x 14 roi_align, fc 81 and
     324; res5 left out), 3 momentum steps twice from one start,
     bitwise; the step's ms, generate_proposals' alone, the peak, and
     roi_align, roi_pool, psroi_pool, prroi_pool and
     deformable_roi_pooling on the step's 512 rois, forward and
     backward, twice bitwise and timed; (c) every op type of group C
     at a size its users run (SSD's, YOLOv3's, RetinaNet's, the R-CNN
     head's), forward and gradient, against the CPU lowering (floats
     within 1e-5 of the largest magnitude, integers exact) and twice
     bitwise, none exempt (the host ops through a program).
The line before the last is a JSON object {"kernels": [...]}.  Each
row's "launches" are those the wrappers made on the main path (every
counted step and request: the counters set to 0 just before each and
read just after) and its "replayed_launches" those that the main
path's CUDA-graph replays ran, from the graphs' manifests: serving's
(phases 4 and 11; each bucket's also seen by the profiler in one
replay) and the training steps' (each training phase's step 3).  A row
that times one table or route of a kernel (embedding_scatter_add[2-row],
embedding_update[wide], embedding_lookup[nmt],
embedding_scatter_add[nmt], the flash kernels' [dropout], [bf16] and
[bf16,dropout] rows, dropout[bf16], dropout[no mask],
dropout[bf16,no mask], dropout_grad[bf16]) counts the main path's
launches on
that table or route, measured at each call of the wrapper, which also writes them
into the manifest of a graph being captured; its kernel's row counts
those on the kernel's other tables or routes; fused_adam counts
all of K4's launches in this process (BERT-base Adam's and LeNet-5's)
and fused_adam[lenet] LeNet-5's; fused_adam[zero], K4 at rank 1's
shard of BERT-base under Reduce (half the rows of every tensor), counts
rank 0's launches in phase 12; K1's dropout row and K2's are timed at
rank 1's head offset (48); a row with no launch fails the run.  The
last is {"ok": true, "device": {...}}.
--profile adds a torch.profiler breakdown of one request of each batch
size, of one step of each training path, of one data-parallel step of
each arm and of one ResNet-50 step.
"""

import argparse
import contextlib
import ctypes
import gc
import io
import itertools
import json
import math
import os
import random
import socket
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch import reader as rdr
from paddle_tpu_torch import runtime, weights
from paddle_tpu_torch.dataset import cifar, mnist
from paddle_tpu_torch.fluid import compile_cache, core, flags, metrics
from paddle_tpu_torch.inference import AnalysisConfig, create_paddle_predictor
from paddle_tpu_torch.models import bert
from paddle_tpu_torch.models import label_semantic_roles as srl
from paddle_tpu_torch.models import lenet
from paddle_tpu_torch.models import mobilenet_v3
from paddle_tpu_torch.models import resnet
from paddle_tpu_torch.models import se_resnext
from paddle_tpu_torch.models import seq2seq
from paddle_tpu_torch.models import transformer
from paddle_tpu_torch.models import wide_deep
from paddle_tpu_torch.models import word2vec
from paddle_tpu_torch.ops import lang_ops
from paddle_tpu_torch.ops import registry
from paddle_tpu_torch.ops.kernels import common
from paddle_tpu_torch.ops.kernels import dropout as drop_k
from paddle_tpu_torch.ops.kernels import embedding as emb_k
from paddle_tpu_torch.ops.kernels import finite_check as fin_k
from paddle_tpu_torch.ops.kernels import flash_attention as fa_k
from paddle_tpu_torch.ops.kernels import fused_optimizer as opt_k
from paddle_tpu_torch.ops.kernels import graph_cond
from paddle_tpu_torch.ops.kernels import quant_collective as qc_k

ROOT = os.path.dirname(os.path.abspath(__file__))
SEQ = 512
BATCHES = (1, 3, 8)
TRAIN_BATCH = 8
TRAIN_STEPS = 3
TIMED_STEPS = 5
# the rate BERT's linear warmup (peak 1e-4 after 10,000 steps) reaches
# after 100 steps: Adam's first steps at 1e-5 and above overshoot the
# NSP head (measured on the H100; PERF.md)
LR = 1e-6
RATE = 0.1
# H100 SXM data-sheet peaks (dense): HBM bytes/s, f32 FLOP/s outside
# the tensor cores, TF32 FLOP/s on them (an f32-accurate product costs
# three TF32 products: the 3xTF32 split)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
TF32_FLOPS_PER_S = 495e12
BF16_FLOPS_PER_S = 989e12
FA_TOL = 1e-4
# times before a redesign (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md's
# kernel table), printed beside the rows of phase 8: K1 when both
# products ran as scalar f32 FMAs, K4 with scalar loads, K8's reduce
# with a warp a row and one byte a lane, the dropout op's forward when
# it always wrote Mask
BEFORE_MS = {'flash_attention': ('the scalar-FMA K1', 0.4120),
             'flash_attention[dropout]': ('the scalar-FMA K1', 0.4141),
             'fused_adam': ('the scalar-load K4', 1.4078),
             'quant_reduce': ('the warp-a-row reduce', 0.0795),
             'embedding_update': ('K7 after torch.sort', 0.1390),
             'embedding_update[wide]': ('K7 after torch.sort', 0.0972),
             'embedding_update[1000-row]': ('K7 after torch.sort', 0.1126),
             # the first dropout kernel, which always wrote Mask
             'dropout': ('the Mask-writing kernel', 0.0209),
             'dropout[bf16]': ('the Mask-writing kernel', 0.0121),
             'dropout[no mask]': ('the Mask-writing kernel', 0.0209),
             'dropout[bf16,no mask]': ('the Mask-writing kernel', 0.0121)}
# K1's and K2's kernels-line rows are timed at rank 1's head-index
# offset of phase 12's BERT-base (local batch 4, 12 heads); their times
# without the offset (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md's kernel
# table)
DP_G_OFFSET = 4 * 12
NO_OFFSET_MS = {'flash_attention[dropout]': 0.1806,
                'flash_attention_bwd': 0.5112}
BWD_TOL = 1e-4
FA_BF16_TOL = 2e-2  # tests/test_torch_cuda_flash_attention.py's bf16 limit
SLICE_TOL = 1e-3
EPSILON = 1e-6  # BERT's Adam epsilon (Devlin et al. 2019)
# LAMB pretraining (You et al. 2019) with BERT's schedule and clip
# (Devlin et al. 2019): a linear warmup from 0 over LAMB_WARMUP steps
# into a polynomial decay, the global gradient norm clipped at 1.0.
# The warmup is cut to 2 steps so that 3 steps show the updates, and
# the peak is set for batch 8 (measured on the H100, PERF.md).
LAMB_PEAK = 4e-5
LAMB_WARMUP = 2
LAMB_DECAY_STEPS = 1000
LAMB_DECAY = 0.01
CLIP_NORM = 1.0
# Wide&Deep CTR: the hashed Criteo feature space of PaddlePaddle's
# CTR-DNN example, BASE's other widths; the JAX package's Adagrad
# epsilon
WD_ROWS = 1000001
WD_BATCH = 4096
WD_LR = 1e-3
# phase 14: the MultiSlot files (8 full batches of WD_BATCH and one of
# WD_PARTIAL lines over WD_FILES files) and the BERT-base steps fed by
# the DataLoader, checkpointed after CHECKPOINT_STEP
WD_FILES = 4
WD_FULL_BATCHES = 8
WD_PARTIAL = 1000
LOADER_STEPS = 5
CHECKPOINT_STEP = 3
# step 1 of the kernel path against the plain path (see check_plain_step)
LOSS_RTOL = 1e-4
GRAD_TOL = 1e-3
# phase 12: BERT-base's batch a rank (phase 5's batch 8 on 2 ranks), and
# a data-parallel step 1's state against one replica of the global batch
DP_BERT_BATCH = 4
DP_STATE_TOL = 1e-3
# data-parallel training (phase 9): ranks, K8's block, the time limit
DP_RANKS = 2
QUANT_BLOCK = 256
DP_TIMEOUT_S = 600
TABLE_NUMEL = 30522 * 768
# image classification (phase 10): LeNet-5 at the batch and rates of the
# reference's test_recognize_digits.py (SGD at 0.01); ResNet-50 as the
# JAX package's bench.py trains it (batch 128, Momentum 0.1 / 0.9, uniform
# [0, 1) images) with the reference ResNet recipe's L2Decay(1e-4);
# SE-ResNeXt-50 (cardinality 32) at batch 32 with the same optimizer
LENET_BATCH = 64
LENET_LR = {'adam': 1e-3, 'sgd': 0.01}
LENET_ADAM = {'beta1': 0.9, 'beta2': 0.999, 'epsilon': 1e-8}  # Adam(1e-3)'s
IMAGE_CLASSES = 1000
RESNET_BATCH = 128
RESNET_EVAL_BATCH = 32
RESNET_CPU_BATCH = 4
SE_BATCH = 32
IMAGE_LR = 0.1
IMAGE_MOMENTUM = 0.9
IMAGE_DECAY = 1e-4
# ResNet-50's float64 step 1 on the card against the CPU's, relative
# to each variable's largest magnitude (see check_card_against_cpu)
F64_TOL = 1e-6
# K6b past its one-block sort (SORT_MAX ids): a batch of 32 and of 128
# at seq 512 on the word table
SCATTER_BIG_IDS = (16384, 65536)
# phase 8 also times the dropout kernel at this many times BERT-base's
# [8, 512, 768] activation
DROPOUT_BIG = 8
# the attention chain below flash_min_len (phase 11): BERT-base served
# and trained at seq 128, the length of its main pretraining phase
# (Devlin et al. 2019), training at batch 32 (4096 tokens, as the seq-512
# path's batch 8); Transformer-base (Vaswani et al. 2017) at batch 64 of
# 64 x 64 (4096 target tokens, the reference's token batches), then one
# step of the 32 bucket, Adam at 1e-4 (a rate at which 3 steps show
# through the dropout noise)
SHORT_SEQ = 128
SHORT_BATCHES = (1, 8, 32)
SHORT_TRAIN_BATCH = 32
NMT_BATCH = 64
NMT_LEN = 64
NMT_BUCKET = 32
NMT_LR = 1e-4
NMT_ROWS = 10000
S2S_BATCH = 128  # PaddleNLP seq2seq (IWSLT'15 en-vi): batch, max length,
S2S_LEN = 50     # Adam's rate and the global-norm clip
S2S_LR = 1e-3
S2S_CLIP = 5.0
S2S_DECODE_RUNS = 3
# phase 16: label_semantic_roles at the book's batch, fed by the bucketed
# loader; the samples drawn (about 26 batches of 10 after the buckets
# drop their partial batches) and the held-out eval batches
SRL_BUCKETS = (16, 32, 64, 128)
SRL_SAMPLES = 300
SRL_MIN_STEPS = 20
SRL_EVAL_BATCHES = 3
# BERT-base under RecomputeOptimizer: the tolerance where autograd sums
# a gradient in another order than the unrecomputed step
RC_LOSS_RTOL = 1e-6
RC_STATE_TOL = 1e-5
# each decode must keep a beam live for this many of its 50 steps (a
# decode whose beams all end at once checks beam_search's selection on
# frozen beams only)
S2S_MIN_LIVE = 50
# phase 8's crossover of the naive chain and K1 + K2 on BERT-base's
# attention: 4096 tokens at each length
CROSSOVER_SEQS = (128, 256, 512)
CROSSOVER_TOKENS = 4096
# phase 13, mixed precision as the JAX package's bench.py trains:
# BERT-base under decorate(Adam(1e-4)) with dynamic loss scaling
# (bench.py:311) at seq 512 batch 8 and at its own seq 128 batch 32,
# ResNet-50 under decorate(Momentum(0.1, 0.9)) in NHWC at batch 128
# (bench.py:36,48); word2vec CBOW at the JAX model's widths with SGD(1e-3)
# in f32 at batch 32, as the upstream book test trains it
AMP_LR = 1e-4
W2V_VOCAB = 2000
W2V_BATCH = 32
W2V_LR = 1e-3
# an AMP step 1 against its plain path: both round every product and
# activation to bf16; the kernels' bf16 P differs from the plain one's
# by a rounding (FA_BF16_TOL), in 12 layers forward and backward
AMP_LOSS_RTOL = 1e-2
AMP_GRAD_TOL = 5e-2
# ResNet-50's AMP step 1 against the f32 step from the same state
AMP_F32_LOSS_RTOL = 5e-2
# phase 13's overflow step: the loss scale the state is set to
OVERFLOW_SCALE = 2.0 ** 127
SCALE_STATE = ('loss_scaling_0', 'good_steps_0', 'bad_steps_0')
# the kernels-line rows of the flash kernels' routes
FLASH_ROWS = ('flash_attention', 'flash_attention[dropout]',
              'flash_attention[bf16]', 'flash_attention[bf16,dropout]',
              'flash_attention_bwd', 'flash_attention_bwd[bf16]')
# the f32 numbers of phases 5, 10 and 11 in this run, printed beside
# phase 13's
F32_RUNS = {}


START = time.perf_counter()


def log(*args):
    """print, flushed; a phase's first line ('[N] ...') also says when
    it started, in seconds since the script began."""
    if args and str(args[0]).startswith('['):
        args = args + ('(at %.1f s)' % (time.perf_counter() - START),)
    print(*args, flush=True)


def card_line():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[torch.cuda.current_device()] if out else ''


class Timer(object):
    """Device time of one call, host launch overhead excluded: `reps`
    calls captured in a CUDA graph, replayed `iters` times between CUDA
    events.  Cold (the default): each call follows a read of a 256 MB
    buffer, which evicts the 50 MB L2 as a request's earlier layers
    would; the time of those reads alone is subtracted.  graph=False
    times single calls between CUDA events instead (for calls a graph
    cannot hold: host syncs, autograd), host gaps inside the call
    included."""

    def __init__(self, dev):
        self._buf = torch.ones(64 << 20, device=dev)
        self._sink = torch.empty((), device=dev)

    def _flush(self):
        torch.sum(self._buf, dim=0, out=self._sink)

    @staticmethod
    def _graph_ms(fn, reps, iters):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / (iters * reps)

    def _event_ms(self, fn, cold, iters):
        fn()
        torch.cuda.synchronize()
        total = 0.0
        for _ in range(iters):
            if cold:
                self._flush()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            total += start.elapsed_time(end)
        return total / iters

    def ms(self, fn, cold=True, reps=10, iters=10, graph=True):
        if not graph:
            return self._event_ms(fn, cold, iters)
        if not cold:
            return self._graph_ms(fn, reps, iters)

        def flushed():
            self._flush()
            fn()
        return (self._graph_ms(flushed, reps, iters) -
                self._graph_ms(self._flush, reps, iters))


def fwd_rate(q, k, v, causal=False, key_bias=None, dropout_rate=0.0,
             *rest, **kwargs):
    """The dropout rate of a flash_attention_kernel call."""
    return dropout_rate


# rows of the kernels line that count one kernel's launches on some of
# its calls: row -> (the kernel's wrapper, pick(its arguments)).  A
# kernel's own row counts its other launches.
SUB_ROWS = {
    'embedding_scatter_add[2-row]': (
        (emb_k, 'scatter_add_kernel'), lambda nrows, ids, g: nrows == 2),
    'embedding_update[wide]': (
        (emb_k, 'update_kernel'), lambda w, *rest: w.shape[1] == 1),
    # the Transformer's 10,000 x 512 source and target tables
    'embedding_lookup[nmt]': (
        (emb_k, 'gather_kernel'), lambda w, ids: w.shape[0] == NMT_ROWS),
    'embedding_scatter_add[nmt]': (
        (emb_k, 'scatter_add_kernel'),
        lambda nrows, ids, g: nrows == NMT_ROWS),
    # the flash kernels' routes: f32 or bf16, with or without dropout
    'flash_attention[dropout]': (
        (fa_k, 'flash_attention_kernel'),
        lambda q, *a, **kw: q.dtype == torch.float32 and fwd_rate(
            q, *a, **kw)),
    'flash_attention[bf16]': (
        (fa_k, 'flash_attention_kernel'),
        lambda q, *a, **kw: q.dtype == torch.bfloat16 and not fwd_rate(
            q, *a, **kw)),
    'flash_attention[bf16,dropout]': (
        (fa_k, 'flash_attention_kernel'),
        lambda q, *a, **kw: q.dtype == torch.bfloat16 and fwd_rate(
            q, *a, **kw)),
    'flash_attention_bwd[bf16]': (
        (fa_k, 'flash_attention_bwd_kernel'),
        lambda q, *a, **kw: q.dtype == torch.bfloat16),
    # the dropout op's forward on bf16 activations (mixed precision),
    # and without Mask (nothing reads it: every training step but one
    # that fetches it), in f32 and bf16
    'dropout[bf16]': (
        (drop_k, 'dropout_kernel'),
        lambda x, seed, rate, upscale, write_mask=True:
            x.dtype == torch.bfloat16 and write_mask),
    'dropout[no mask]': (
        (drop_k, 'dropout_kernel'),
        lambda x, seed, rate, upscale, write_mask=True:
            x.dtype == torch.float32 and not write_mask),
    'dropout[bf16,no mask]': (
        (drop_k, 'dropout_kernel'),
        lambda x, seed, rate, upscale, write_mask=True:
            x.dtype == torch.bfloat16 and not write_mask),
    # the dropout op's gradient on bf16 activations
    'dropout_grad[bf16]': (
        (drop_k, 'dropout_grad_kernel'),
        lambda g, *a: g.dtype == torch.bfloat16)}
# the launches on the sub-rows since the counters were last set to 0,
# at the wrappers and replayed, as the kernels' own counters keep them
SUB_LAUNCHES = dict.fromkeys(SUB_ROWS, 0)
SUB_REPLAYED = dict.fromkeys(SUB_ROWS, 0)
# the main path's launches by row of the kernels line: every counted()
# call adds its own (without_counting puts them back)
MAIN_LAUNCHES = {}
MAIN_REPLAYED = {}


def on_sub_rows(wrapper, kernel, rows):
    """The kernel wrapper `wrapper` (a KERNELS name), tallying each
    call's launches on the sub-rows whose pick takes its arguments: in
    SUB_LAUNCHES, or, while a CUDA graph is captured, in the graph's
    manifest under the row's name, which each replay adds to
    SUB_REPLAYED (count_replays)."""
    def call(*args, **kwargs):
        rec = common.recording()
        manifest = rec.launches if rec is not None else None

        def now():
            return common.launches(wrapper) if manifest is None else \
                manifest.get(wrapper, 0)
        before = now()
        out = kernel(*args, **kwargs)
        n = now() - before
        for row, pick in rows:
            if n and pick(*args, **kwargs):
                if manifest is None:
                    SUB_LAUNCHES[row] += n
                else:
                    manifest[row] = manifest.get(row, 0) + n
        return out
    return call


def count_replays(manifest, add=common.add_replays):
    """common.add_replays, which also adds a replay's launches on the
    sub-rows (its manifest's row names) to SUB_REPLAYED."""
    for row, n in manifest.items():
        if row in SUB_REPLAYED:
            SUB_REPLAYED[row] += n
    add({k: n for k, n in manifest.items() if k in common.KERNELS})


def tally_sub_rows():
    """Wrap the wrappers of SUB_ROWS and the replay count for the whole
    run: the sub-rows are counted as the kernels are, eagerly and in
    every CUDA graph the run captures."""
    groups = {}
    for row, ((mod, name), pick) in SUB_ROWS.items():
        groups.setdefault((mod, name), []).append((row, pick))
    wrapper = {'scatter_add_kernel': 'embedding_scatter_add',
               'update_kernel': 'embedding_update',
               'gather_kernel': 'embedding_lookup',
               'flash_attention_kernel': 'flash_attention',
               'flash_attention_bwd_kernel': 'flash_attention_bwd',
               'dropout_kernel': 'dropout',
               'dropout_grad_kernel': 'dropout_grad'}
    for (mod, name), rows in groups.items():
        setattr(mod, name, on_sub_rows(wrapper[name], getattr(mod, name),
                                       rows))
    common.add_replays = count_replays


def reset_counts():
    common.reset_launches()
    for row in SUB_ROWS:
        SUB_LAUNCHES[row] = SUB_REPLAYED[row] = 0


def by_row(per_kernel, per_sub_row):
    """{row of the kernels line: n}: a sub-row's own count, a kernel's
    row the rest of the kernel's."""
    out = dict(per_kernel)
    for row, n in per_sub_row.items():
        out[row] = n
        out[row.split('[')[0]] -= n
    return out


def without_counting(fn):
    """Run fn() and put the launch counters back as they were: parity
    and timing launches are not the main path's."""
    saved = {k: (common.launches(k), common.replayed(k))
             for k in common.KERNELS}
    subs = dict(SUB_LAUNCHES), dict(SUB_REPLAYED)
    mains = dict(MAIN_LAUNCHES), dict(MAIN_REPLAYED)
    try:
        return fn()
    finally:
        for k, (n, r) in saved.items():
            common.KERNELS[k]['launches'] = n
            common.KERNELS[k]['replayed'] = r
        for d, old in zip((SUB_LAUNCHES, SUB_REPLAYED, MAIN_LAUNCHES,
                           MAIN_REPLAYED), subs + mains):
            d.clear()
            d.update(old)


def counted(fn):
    """(fn(), what it ran per kernel: the launches at the wrappers plus
    the launches its CUDA graph replays ran): the counters are set to 0
    just before and read just after; the launches and the replayed
    launches by row of the kernels line are added to MAIN_LAUNCHES and
    MAIN_REPLAYED."""
    reset_counts()
    out = fn()
    for acc, read, subs in ((MAIN_LAUNCHES, common.launches, SUB_LAUNCHES),
                            (MAIN_REPLAYED, common.replayed, SUB_REPLAYED)):
        rows = by_row({k: read(k) for k in common.KERNELS}, subs)
        for row, n in rows.items():
            acc[row] = acc.get(row, 0) + n
    return out, {k: common.launches(k) + common.replayed(k)
                 for k in common.KERNELS}


def ran_by_row():
    """The launches at the wrappers plus the replayed ones, by row of
    the kernels line, since the counters were last set to 0."""
    return by_row({k: common.launches(k) + common.replayed(k)
                   for k in common.KERNELS},
                  {r: SUB_LAUNCHES[r] + SUB_REPLAYED[r] for r in SUB_ROWS})


def eager_run(exe, program, feed=None, fetch_list=None, return_numpy=True,
              scope=None, use_cache=True):
    """Executor.run's path without its CUDA graph: the cached plan (a
    plan built for the call with use_cache=False) run op by op
    (Executor._run_graphed with graphs=False).  Both sides of a cached
    against uncached comparison come through here, so that they do the
    same step records (none of Executor.run's)."""
    feed = feed or {}
    fetch = [getattr(f, 'name', f) for f in fetch_list or []]
    plan = exe._get_plan(program, feed, fetch, use_cache=use_cache)
    return exe._run_graphed(plan, program, feed, fetch,
                            scope or fluid.global_scope(), return_numpy,
                            graphs=False)


def max_abs(a, b):
    return (a.float() - b.float()).abs().max().item()


# ------------------------------------------------------------ phase 3
def qkv_views(gen, b, t, h, d, dev):
    """Q, K, V as split views of one [B, T, 3*H*D] projection, the
    layout the BERT path hands the kernel."""
    qkv = torch.randn(b, t, 3 * h * d, generator=gen, device=dev)
    return [x.reshape(b, t, h, d) for x in qkv.split(h * d, dim=2)]


def padding_bias(gen, b, t, dev):
    lens = torch.randint(t // 4, t + 1, (b,), generator=gen, device=dev)
    keep = torch.arange(t, device=dev)[None, :] < lens[:, None]
    return torch.where(keep, 0.0, -10000.0).float()


def flash_twice(q, k, v, causal, bias, rate=0.0, seed=None):
    """K1's (O, lse), launched twice from the same inputs: the second
    launch must give the first's bits."""
    o, lse = fa_k.flash_attention_kernel(q, k, v, causal, bias, rate, seed)
    o2, lse2 = fa_k.flash_attention_kernel(q, k, v, causal, bias, rate,
                                           seed)
    torch.cuda.synchronize()
    if not (torch.equal(o, o2) and torch.equal(lse, lse2)):
        raise AssertionError('flash_attention: a second launch from the '
                             'same inputs gave other bits')
    return o, lse


def check_flash(gen, dev):
    """K1 without dropout against its plain version: O and lse within
    FA_TOL, and a second launch bitwise the first (the bf16 route:
    check_flash_bf16)."""
    cases = [('serving B8 H12 T512 D64', 8, 512, 12, 64, False, True),
             ('ragged B2 H4 T200 D64', 2, 200, 4, 64, False, True),
             ('causal ragged B2 H4 T300 D128', 2, 300, 4, 128, True, True),
             ('no bias B1 H2 T64 D32', 1, 64, 2, 32, False, False),
             ('one query B2 H4 T1 D64', 2, 1, 4, 64, False, True),
             ('a key past a tile B2 H4 T65 D64', 2, 65, 4, 64, False, True)]
    worst = 0.0
    for name, b, t, h, d, causal, with_bias in cases:
        q, k, v = qkv_views(gen, b, t, h, d, dev)
        bias = padding_bias(gen, b, t, dev) if with_bias else None
        o, lse = flash_twice(q, k, v, causal, bias)
        po, plse = fa_k.flash_attention_plain(q, k, v, causal, bias)
        eo, el = max_abs(o, po), max_abs(lse, plse)
        log('  flash_attention %-36s max|dO| %.3e max|dlse| %.3e (limit '
            '%g); 2nd launch bitwise' % (name, eo, el, FA_TOL))
        if not (el <= FA_TOL and eo <= FA_TOL):
            raise AssertionError('flash_attention %s disagrees with its '
                                 'plain version' % name)
        worst = max(worst, el, eo)
    return worst


def check_flash_bf16(gen, dev):
    """The bf16 route of K1 and K2 (bf16 products, P and dS rounded to
    bf16 as the Pallas kernels round them) against their plain bf16
    versions, which take the same rounding points: O, dQ, dK and dV
    within FA_BF16_TOL * max(1, max|plain|) (the plain forward rounds P
    relative to each row's maximum, the kernel relative to the running
    maximum of the key tiles, and the f32 sums run in another order),
    lse within FA_TOL, the bias cotangent (f32) within FA_BF16_TOL *
    max(1, max|plain|); a second launch bitwise the first.  Returns the
    worst max|diff| of each kernels-line row."""
    bf16 = torch.bfloat16
    worst = {'flash_attention[bf16]': 0.0,
             'flash_attention[bf16,dropout]': 0.0,
             'flash_attention_bwd[bf16]': 0.0}
    for name, b, t, h, d, causal, rate, g_off, masked in (
            ('B8 H12 T512 D64', 8, 512, 12, 64, False, 0.0, 0, False),
            ('B8 H12 T512 D64', 8, 512, 12, 64, False, RATE, 0, False),
            ('B8 H12 T512 D64 head offset 48', 8, 512, 12, 64, False, RATE,
             DP_G_OFFSET, False),
            ('ragged B2 H4 T300 D32', 2, 300, 4, 32, False, RATE, 0, False),
            ('causal ragged B2 H4 T300 D128', 2, 300, 4, 128, True, 0.0, 0,
             False),
            ('one query B2 H4 T1 D64', 2, 1, 4, 64, False, 0.0, 0, False),
            ('masked B2 H4 T200 D64', 2, 200, 4, 64, False, RATE, 0, True)):
        seed = 91 + t
        q, k, v = [x.to(bf16) for x in qkv_views(gen, b, t, h, d, dev)]
        bias = padding_bias(gen, b, t, dev)
        if masked:
            bias[0] = float('-inf')
        o, lse = fa_k.flash_attention_kernel(q, k, v, causal, bias, rate,
                                             seed, g_off)
        o2, lse2 = fa_k.flash_attention_kernel(q, k, v, causal, bias, rate,
                                               seed, g_off)
        po, plse = fa_k.flash_attention_plain(q, k, v, causal, bias, rate,
                                              seed, g_off)
        do = torch.randn(b, t, h, d, generator=gen, device=dev).to(bf16)
        dlse = torch.randn(b, h, t, generator=gen, device=dev)
        got, again = [fa_k.flash_attention_bwd_kernel(
            q, k, v, bias, o, lse, do, dlse, causal, rate, seed, True, g_off)
            for _ in range(2)]
        want = fa_k.flash_attention_bwd_plain(q, k, v, bias, do, dlse, causal,
                                              rate, seed, True, g_off)
        torch.cuda.synchronize()
        if not (torch.equal(o, o2) and torch.equal(lse, lse2) and
                all(torch.equal(x, y) for x, y in zip(got, again))):
            raise AssertionError('flash_attention bf16 %s: a second launch '
                                 'from the same inputs gave other bits'
                                 % name)
        eo, el = max_abs(o, po), max_abs(lse, plse)
        ok = o.dtype == bf16 and el <= FA_TOL and \
            eo <= FA_BF16_TOL * max(1.0, po.float().abs().max().item())
        errs = []
        for label, g, w in zip(('dQ', 'dK', 'dV', 'dbias'), got, want):
            e = max_abs(g, w)
            rel = e / max(1.0, w.float().abs().max().item())
            ok = ok and rel <= FA_BF16_TOL and g.dtype == w.dtype
            errs.append('%s %.2e' % (label, rel))
            worst['flash_attention_bwd[bf16]'] = max(
                worst['flash_attention_bwd[bf16]'], e)
        if masked:
            ok = ok and o[0].abs().max().item() == 0.0 and \
                all(x[0].abs().max().item() == 0.0 for x in got[:3])
        row = 'flash_attention[bf16,dropout]' if rate else \
            'flash_attention[bf16]'
        worst[row] = max(worst[row], eo, el)
        log('  flash_attention bf16%s %-32s max|dO| %.3e max|dlse| %.3e; '
            'backward %s (limit %g of max(1, max|plain|)); 2nd launches '
            'bitwise' % (' dropout %.1f' % rate if rate else '', name, eo,
                         el, ', '.join(errs), FA_BF16_TOL))
        if not ok:
            raise AssertionError('flash_attention bf16 %s disagrees with its '
                                 'plain version' % name)
    return worst


def kernel_keep_mask(b, h, t, seed, dev, g_offset=0):
    """The forward kernel's dropout keep mask [b, h, t, t] at head-index
    offset g_offset, read back: with Q = K = 0 every unmasked key gets
    p = 1/64, and with the key bias opening one 64-key window at a time
    and V one-hot over that window, O[q, d] = keep(q, window + d) /
    (64 * (1 - rate))."""
    z = torch.zeros(b, t, h, 64, device=dev)
    keep = torch.empty(b, h, t, t, dtype=torch.bool, device=dev)
    for k0 in range(0, t, 64):
        w = min(64, t - k0)
        bias = torch.full((b, t), float('-inf'), device=dev)
        bias[:, k0:k0 + w] = 0.0
        v = torch.zeros(b, t, h, 64, device=dev)
        v[:, k0:k0 + w, :, :w] = torch.eye(w, device=dev)[None, :, None, :]
        o, _ = fa_k.flash_attention_kernel(z, z, v, False, bias, RATE, seed,
                                           g_offset)
        keep[:, :, :, k0:k0 + w] = (o[..., :w] > 0).permute(0, 2, 1, 3)
    return keep


def check_flash_dropout(gen, dev):
    """K1 with attention dropout against its plain version (the same
    hash): O and lse within FA_TOL, a second launch bitwise the first,
    and at the first two shapes the keep mask read back from the kernel
    bitwise the plain hash.  'masked': batch 0's keys all -inf, whose
    rows give O = 0 exactly and lse = log(1e-20)."""
    seed = 0x9E3779B9 ^ 12345
    worst = 0.0
    for name, b, t, h, d, readback, masked in (
            ('B8 H12 T512 D64', 8, 512, 12, 64, True, False),
            ('ragged B2 H4 T300 D64', 2, 300, 4, 64, True, False),
            ('ragged B2 H4 T300 D32', 2, 300, 4, 32, False, False),
            ('ragged B2 H4 T300 D128', 2, 300, 4, 128, False, False),
            ('masked B2 H4 T200 D64', 2, 200, 4, 64, False, True)):
        q, k, v = qkv_views(gen, b, t, h, d, dev)
        bias = padding_bias(gen, b, t, dev)
        if masked:
            bias[0] = float('-inf')
        o, lse = flash_twice(q, k, v, False, bias, RATE, seed)
        po, plse = fa_k.flash_attention_plain(q, k, v, False, bias, RATE,
                                              seed)
        eo, el = max_abs(o, po), max_abs(lse, plse)
        ok = eo <= FA_TOL and el <= FA_TOL
        note = ''
        if readback:
            keep = kernel_keep_mask(b, h, t, seed, dev)
            want = fa_k.dropout_keep_plain(seed, b, h, t, t, RATE, dev)
            torch.cuda.synchronize()
            same = torch.equal(keep, want)
            ok = ok and same
            note = ', keep mask bitwise %s (keep rate %.4f)' % (
                same, keep.float().mean().item())
        if masked:
            zero = o[0].abs().max().item() == 0.0
            lse_err = (lse[0] - math.log(1e-20)).abs().max().item()
            ok = ok and zero and lse_err <= FA_TOL
            note = ', masked rows: O exactly 0 %s, max|lse - log(1e-20)| ' \
                   '%.3e' % (zero, lse_err)
        log('  flash_attention dropout %.1f %-22s max|dO| %.3e max|dlse| '
            '%.3e (limit %g)%s, 2nd launch bitwise'
            % (RATE, name, eo, el, FA_TOL, note))
        if not ok:
            raise AssertionError('flash_attention with dropout %s disagrees '
                                 'with its plain version' % name)
        worst = max(worst, eo, el)
    return worst


def check_flash_bwd(gen, dev):
    """K2 against autograd of the plain forward, max|diff| <= 1e-4 *
    max(1, max|plain|) for dQ, dK, dV and the bias cotangent, and a second
    launch from the same inputs bitwise the first (the bf16 route:
    check_flash_bf16).  'masked': batch 0's keys all -inf (fully masked
    rows, whose gradients are 0)."""
    cases = [('B8 H12 T512 D64 dropout', 8, 512, 12, 64, False, RATE, False,
              None),
             ('ragged B2 H4 T300 D64 dropout dbias+dlse', 2, 300, 4, 64,
              False, RATE, True, None),
             ('causal B2 H4 T200 D128 dbias', 2, 200, 4, 128, True, 0.0,
              True, None),
             ('B1 H2 T64 D32', 1, 64, 2, 32, False, 0.0, False, None),
             ('B2 H4 T512 D128 dropout dbias+dlse', 2, 512, 4, 128, False,
              RATE, True, None),
             ('ragged B2 H3 T300 D32 dropout dbias+dlse', 2, 300, 3, 32,
              False, RATE, True, None),
             ('masked B2 H4 T200 D64 dbias+dlse', 2, 200, 4, 64, False, 0.0,
              True, 'masked')]
    worst = 0.0
    for name, b, t, h, d, causal, rate, with_grads, kind in cases:
        seed = 77 + t
        q, k, v = qkv_views(gen, b, t, h, d, dev)
        bias = padding_bias(gen, b, t, dev)
        if kind == 'masked':
            bias[0] = float('-inf')
        do = torch.randn(b, t, h, d, generator=gen, device=dev)
        dlse = (torch.randn(b, h, t, generator=gen, device=dev)
                if with_grads else None)
        o, lse = fa_k.flash_attention_kernel(q, k, v, causal, bias, rate,
                                             seed)
        got, again = [fa_k.flash_attention_bwd_kernel(
            q, k, v, bias, o, lse, do, dlse, causal, rate, seed,
            bias_grad=with_grads) for _ in range(2)]
        want = fa_k.flash_attention_bwd_plain(
            q, k, v, bias, do, dlse, causal, rate, seed, bias_grad=with_grads)
        torch.cuda.synchronize()
        errs = []
        for label, g, w, g2 in zip(('dQ', 'dK', 'dV', 'dbias'), got, want,
                                   again):
            if w is None:
                continue
            if not torch.equal(g, g2):
                raise AssertionError('flash_attention_bwd %s: a second launch '
                                     'gave another %s' % (name, label))
            e = max_abs(g, w) / max(1.0, w.abs().max().item())
            errs.append('%s %.2e' % (label, e))
            if not e <= BWD_TOL:
                raise AssertionError('flash_attention_bwd %s: %s differs '
                                     'from the plain backward by %g'
                                     % (name, label, e))
            if kind is None:
                worst = max(worst, max_abs(g, w))
        log('  flash_attention_bwd %-42s %s; 2nd launch bitwise'
            % (name, ', '.join(errs)))
    return worst


def check_embedding(gen, dev):
    w = torch.randn(30522, 768, generator=gen, device=dev)
    ids = torch.randint(0, 30522, (4096,), generator=gen, device=dev)
    ids[:8] = torch.tensor([7, 7, 7, 30521, -1, -500, 30522, 10 ** 9],
                           device=dev)
    got = emb_k.gather_kernel(w, ids)
    want = emb_k.gather_plain(w, ids)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError('embedding_lookup is not bitwise equal to '
                             'its plain version')
    for name, cast in (('int32 ids', torch.int32), ('bf16 table', None)):
        if cast is None:
            wb = w.to(torch.bfloat16)
            ok = torch.equal(emb_k.gather_kernel(wb, ids),
                             emb_k.gather_plain(wb, ids))
        else:
            ok = torch.equal(emb_k.gather_kernel(w, ids.to(cast)),
                             emb_k.gather_plain(w, ids.to(cast)))
        if not ok:
            raise AssertionError('embedding_lookup (%s) differs' % name)
    log('  embedding_lookup 30522x768, 4096 ids: bitwise equal '
        '(int64, int32 ids, bf16 table)')
    return 0.0


def bits(t):
    """An integer view of a float tensor: NaNs compare by their bits."""
    t = t.contiguous()
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def dropout_twice(x, seed, p, upscale, write_mask=True):
    """The forward kernel's (Out, Mask), launched twice from the same
    inputs: the second launch must give the first's bits (Mask None
    both times without `write_mask`)."""
    out, mask = drop_k.dropout_kernel(x, seed, p, upscale, write_mask)
    out2, mask2 = drop_k.dropout_kernel(x, seed, p, upscale, write_mask)
    torch.cuda.synchronize()
    if not (torch.equal(bits(out), bits(out2)) and (
            mask is None and mask2 is None if not write_mask else
            torch.equal(bits(mask), bits(mask2)))):
        raise AssertionError('dropout (write_mask=%s): a second launch from '
                             'the same inputs gave other bits' % write_mask)
    return out, mask


def dropout_grad_twice(g, seed, p, upscale):
    """The gradient kernel's dX, launched twice from the same inputs: the
    second launch must give the first's bits."""
    dx = drop_k.dropout_grad_kernel(g, seed, p, upscale)
    dx2 = drop_k.dropout_grad_kernel(g, seed, p, upscale)
    torch.cuda.synchronize()
    if not torch.equal(bits(dx), bits(dx2)):
        raise AssertionError('dropout_grad: a second launch from the same '
                             'inputs gave other bits')
    return dx


def first_differences(x, got, want, *more):
    """The first elements where got (or any of `more`) and want differ in
    their bits: index, input, got's and want's bits."""
    differ = bits(got) != bits(want)
    for other in more:
        differ |= bits(other) != bits(want)
    idx = differ.view(-1).nonzero()[:4].view(-1).tolist()
    return ['%d: x %r got %#x want %#x' % (
        i, x.view(-1)[i].item(), bits(got).view(-1)[i].item(),
        bits(want).view(-1)[i].item()) for i in idx]


def with_specials(t):
    """t with NaN, +-inf and -0 as its first four values."""
    t.view(-1)[:4] = torch.tensor(
        [float('nan'), float('inf'), -float('inf'), -0.0], device=t.device)
    return t


def check_dropout(gen, dev):
    """The dropout op's kernels against their plain versions, bitwise, at
    BERT-base's [8, 512, 768] and the Transformer FFN's [64, 64, 2048]
    activations, f32 and bf16, both implementations, p 0.1, 0 and 1,
    NaN, infinite and -0 values among the inputs and the gradients; an
    odd element count, a non-contiguous view and a view at an element
    offset (no 16-byte vectors): the forward with Mask and without it
    (Out the same bits, no Mask) against dropout_plain, the gradient
    kernel against the gradient from the saved Mask (dropout_grad, the
    chain of PyTorch ops it replaces), every launch twice; and the
    autograd Function's gradient (the kernel, from the saved seed)
    against autograd through the plain version."""
    seed = torch.tensor(0x9E3779B1 ^ 4242, device=dev)
    cases = 0
    for shape in ((8, SEQ, 768), (NMT_BATCH, NMT_LEN, 2048), (7, 13, 33)):
        base = with_specials(torch.randn(*shape, generator=gen, device=dev))
        base_g = with_specials(torch.randn(*shape, generator=gen,
                                           device=dev))
        base_g.view(-1)[4:8] = base.view(-1)[:4]
        for dtype in (torch.float32, torch.bfloat16):
            x, g = base.to(dtype), base_g.to(dtype)
            for upscale in (True, False):
                for p in (RATE, 0.0, 1.0):
                    out, mask = dropout_twice(x, seed, p, upscale)
                    out_n, none = dropout_twice(x, seed, p, upscale, False)
                    dx = dropout_grad_twice(g, seed, p, upscale)
                    want, want_mask = drop_k.dropout_plain(x, seed, p,
                                                           upscale)
                    want_dx = drop_k.dropout_grad(g, want_mask, p, upscale)
                    if not (torch.equal(bits(out), bits(want)) and
                            torch.equal(bits(mask), bits(want_mask)) and
                            torch.equal(bits(out_n), bits(want)) and
                            none is None):
                        raise AssertionError(
                            'dropout %s %s upscale=%s p=%g (with and without '
                            'Mask) is not bitwise its plain version: %s'
                            % (shape, dtype, upscale, p, first_differences(
                                x, out, want, out_n)))
                    if not torch.equal(bits(dx), bits(want_dx)):
                        raise AssertionError(
                            'dropout_grad %s %s upscale=%s p=%g is not '
                            'bitwise the gradient from the saved Mask: %s'
                            % (shape, dtype, upscale, p, first_differences(
                                g, dx, want_dx)))
                    cases += 1
    x = torch.randn(8, SEQ, 769, generator=gen, device=dev)
    g = torch.randn(8, SEQ, 769, generator=gen, device=dev)
    for name, view, gview in (
            ('non-contiguous', x[..., 1:], g[..., 1:]),
            ('offset', x.view(-1)[3:3 + 8 * SEQ * 768],
             g.view(-1)[3:3 + 8 * SEQ * 768])):
        out, mask = dropout_twice(view, seed, RATE, True)
        out_n, _ = dropout_twice(view, seed, RATE, True, False)
        dx = dropout_grad_twice(gview, seed, RATE, True)
        want, want_mask = drop_k.dropout_plain(view.contiguous(), seed, RATE,
                                               True)
        want_dx = drop_k.dropout_grad(gview.contiguous(), want_mask, RATE,
                                      True)
        if not (torch.equal(out, want) and torch.equal(mask, want_mask) and
                torch.equal(out_n, want) and torch.equal(dx, want_dx)):
            raise AssertionError('dropout on a %s view is not bitwise its '
                                 'plain version' % name)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(8, SEQ, 768, generator=gen, device=dev).to(dtype)
        g = torch.randn(8, SEQ, 768, generator=gen, device=dev).to(dtype)
        for upscale, write_mask in ((True, True), (False, True),
                                    (True, False)):
            xa = x.clone().requires_grad_()
            before = common.launches('dropout_grad')
            out, _ = drop_k.dropout(xa, seed, RATE, upscale, write_mask)
            got, = torch.autograd.grad(out, xa, g)
            if common.launches('dropout_grad') != before + 1:
                raise AssertionError('the dropout op\'s backward did not '
                                     'launch the gradient kernel once')
            xb = x.clone().requires_grad_()
            keep = drop_k.hash_keep(seed, x.shape, RATE, dev)
            want, = torch.autograd.grad(
                drop_k.apply_keep(xb, keep, RATE, upscale)[0], xb, g)
            if not torch.equal(bits(got), bits(want)):
                raise AssertionError('the dropout gradient (%s, upscale=%s) '
                                     'is not autograd\'s' % (dtype, upscale))
    log('  dropout: %d cases at [8, 512, 768], [64, 64, 2048] and [7, 13, '
        '33] (f32, bf16; both implementations; p %g, 0, 1; NaN, inf and -0 '
        'inputs and gradients), each the forward with and without Mask and '
        'the gradient kernel, a non-contiguous and an offset view, second '
        'launches and the autograd Function\'s gradient: bitwise'
        % (cases, RATE))
    return 0.0


def dropout_launches(main):
    """The dropout kernels' launches a training step of `main`: the
    forward's and the gradient's, one each for each dropout op in
    training mode (every one on these paths is on the loss's path)."""
    n = sum(op.type == 'dropout' and not op.attrs.get('is_test') and
            op.attrs.get('__op_role__') != 'backward'
            for op in main.global_block().ops)
    return {'dropout': n, 'dropout_grad': n}


def mask_probe(main):
    """The last dropout op of `main` in training mode (after the last
    layer's FFN, on bf16 activations under AMP): step 1 of phases 5 and
    13 (a) fetches its X, Out and Mask, and the fetch makes the kernel
    write Mask."""
    return [op for op in main.global_block().ops
            if op.type == 'dropout' and not op.attrs.get('is_test')][-1]


def probe_fetch(op):
    return [op.input('X')[0], op.output('Out')[0], op.output('Mask')[0]]


def check_fetched_mask(exe, main, op, fetched, dtype):
    """The fetched (X, Out, Mask) of a dropout op: X in `dtype`, and Out
    and Mask bit for bit what the kernel wrote before Mask became
    optional, dropout_plain of X under the op's seed at the executor's
    step."""
    x, out, mask = fetched
    seed = registry.LowerCtx(
        exe._step, op.attrs.get('__op_seed__', 0), device=x.device,
        random_seed=main.random_seed).dropout_op_seed()
    want, want_mask = drop_k.dropout_plain(
        x, seed, op.attrs.get('dropout_prob', 0.5),
        op.attrs.get('dropout_implementation') == 'upscale_in_train')
    if x.dtype != dtype or not (torch.equal(bits(out), bits(want)) and
                                torch.equal(bits(mask), bits(want_mask))):
        raise AssertionError('the fetched Out and Mask of %s (X %s) are not '
                             'the plain version\'s' % (op.output('Mask')[0],
                                                       x.dtype))
    log('  fetched X, Out and Mask of %s %s %s: bitwise dropout_plain '
        '(%.4f kept)' % (op.output('Mask')[0], tuple(mask.shape),
                         str(dtype).split('.')[1],
                         mask.float().mean().item()))


def check_scatter(gen, dev):
    """K6b bitwise against its plain version: BERT's three tables at the
    main path's 4096 ids (word with duplicates and out-of-range ids,
    positions, the 2-row sentence table with every id on row 0), a run
    of 1500 that starts mid-chunk (sorted position 37 onward) over many
    128-row stages, D = 16, 100 and 1 with long and short runs, one id,
    and 12,288 int32 ids (past the kernel's one-block sort: torch.sort)."""
    n, d = TRAIN_BATCH * SEQ, 768
    word = torch.randint(0, 30522, (n,), generator=gen, device=dev)
    word[:8] = torch.tensor([7, 7, 7, 30521, -1, -500, 30522, 7], device=dev)
    mid = torch.randint(0, 7, (3000,), generator=gen, device=dev)
    mid[37:1537] = 7
    mid[1537:] = torch.randint(8, 50, (1463,), generator=gen, device=dev)

    def skewed(rows, m):
        ids = torch.randint(0, rows, (m,), generator=gen, device=dev)
        ids[5:900] = 3
        return ids

    cases = [('30522 x 768', 30522, word, d),
             ('512 x 768 positions', SEQ,
              torch.arange(SEQ, device=dev).repeat(TRAIN_BATCH), d),
             ('2 x 768 sentence', 2, torch.zeros(n, dtype=torch.int64,
                                                 device=dev), d),
             ('50 x 768, run of 1500 from sorted position 37', 50, mid, d),
             ('40 x 16 skewed', 40, skewed(40, 2000), 16),
             ('40 x 100 skewed', 40, skewed(40, 2000), 100),
             ('41 x 1 skewed', 41, skewed(41, 2000), 1),
             ('10 x 768, one id', 10, torch.tensor([4], device=dev), d),
             ('1000 x 64, 12288 int32 ids', 1000, torch.randint(
                 -5, 1005, (12288,), generator=gen, device=dev).to(
                     torch.int32), 64)]
    for name, rows, ids, width in cases:
        g = torch.randn(ids.numel(), width, generator=gen, device=dev)
        got = emb_k.scatter_add_kernel(rows, ids, g)
        want = emb_k.scatter_add_plain(rows, ids, g)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError('embedding_scatter_add %s is not bitwise '
                                 'equal to its plain version (max|diff| %g)'
                                 % (name, max_abs(got, want)))
        log('  embedding_scatter_add %-46s %5d ids: bitwise equal'
            % (name, ids.numel()))
    return 0.0


def nmt_ids(seed, length=NMT_LEN):
    """The source ids of phase 11's Transformer batch ([NMT_BATCH,
    length], ragged rows padded with id 0), flattened."""
    batch = transformer.synthetic_batch(
        transformer.BASE, NMT_BATCH, length, length,
        np.random.RandomState(seed))
    return torch.from_numpy(batch['src_ids']).reshape(-1)


def check_nmt_tables(gen, dev, seed):
    """K6 and K6b bitwise against their plain versions on the
    Transformer's 10,000 x 512 table at the ids of phase 11's batch
    (4096, a run of padding ids 0 among them)."""
    ids = nmt_ids(seed).to(dev)
    w = torch.randn(NMT_ROWS, 512, generator=gen, device=dev)
    g = torch.randn(ids.numel(), 512, generator=gen, device=dev)
    for name, got, want in (
            ('embedding_lookup', emb_k.gather_kernel(w, ids),
             emb_k.gather_plain(w, ids)),
            ('embedding_scatter_add',
             emb_k.scatter_add_kernel(NMT_ROWS, ids, g),
             emb_k.scatter_add_plain(NMT_ROWS, ids, g))):
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError('%s on the 10000 x 512 table is not bitwise '
                                 'equal to its plain version' % name)
        log('  %-22s 10000 x 512, %d ids (%d padding): bitwise equal'
            % (name, ids.numel(), int((ids == 0).sum())))
    return 0.0


def adam_inputs(shapes, gen, dev):
    lr = torch.full((1,), LR, device=dev)
    b1p = torch.full((1,), 0.9 ** 3, device=dev)
    b2p = torch.full((1,), 0.999 ** 3, device=dev)
    ins = {k: [] for k in ('Param', 'Grad', 'Moment1', 'Moment2',
                           'LearningRate', 'Beta1Pow', 'Beta2Pow')}
    for s in shapes:
        ins['Param'].append(torch.randn(s, generator=gen, device=dev))
        ins['Grad'].append(torch.randn(s, generator=gen, device=dev) * 1e-2)
        ins['Moment1'].append(torch.randn(s, generator=gen, device=dev) *
                              1e-3)
        ins['Moment2'].append(torch.rand(s, generator=gen, device=dev) *
                              1e-4)
        ins['LearningRate'].append(lr)
        ins['Beta1Pow'].append(b1p)
        ins['Beta2Pow'].append(b2p)
    return ins


def check_adam(gen, dev, shapes, lenet_shapes):
    for kind, attrs, subset in (
            ('adam', {'beta1': 0.9, 'beta2': 0.999, 'epsilon': EPSILON},
             shapes),
            ('adamw', {'beta1': 0.9, 'beta2': 0.999, 'epsilon': 1e-8,
                       'coeff': 0.01}, shapes[:9]),
            ('adam', LENET_ADAM, lenet_shapes)):
        ins = adam_inputs(subset, gen, dev)
        want = opt_k.apply_plain(kind, None, ins, attrs)
        opt_k.apply_kernel(kind, ins, attrs)  # in place
        torch.cuda.synchronize()
        for slot, got_slot in (('ParamOut', 'Param'),
                               ('Moment1Out', 'Moment1'),
                               ('Moment2Out', 'Moment2')):
            for got, w in zip(ins[got_slot], want[slot]):
                if not torch.equal(got, w):
                    raise AssertionError('fused_adam (%s) %s is not bitwise '
                                         'equal to the per-tensor lowering: '
                                         'max|diff| %g'
                                         % (kind, slot, max_abs(got, w)))
        log('  fused_adam %-5s %3d tensors, %d elements: bitwise equal'
            % (kind, len(subset), sum(int(np.prod(s)) for s in subset)))
    check_adam_edges(gen, dev)
    return 0.0


def zero_shapes(shapes):
    """Rank 1's shard of each tensor under ReduceStrategy.Reduce on
    DP_RANKS ranks: 1 / DP_RANKS of the rows where dim 0 is > 1 and
    divides, else the whole tensor."""
    return [(s[0] // DP_RANKS,) + tuple(s[1:])
            if s[0] > 1 and s[0] % DP_RANKS == 0 else tuple(s)
            for s in shapes]


def check_adam_rows(gen, dev, shapes):
    """K4 over rank 1's row slices of BERT-base's tensors (and the other
    tensors whole) in one launch, as the sharded optimizer state runs
    it: the updated rows bitwise the whole tensors' plain update."""
    attrs = {'beta1': 0.9, 'beta2': 0.999, 'epsilon': EPSILON}
    ins = adam_inputs(shapes, gen, dev)
    want = opt_k.apply_plain('adam', None, ins, attrs)
    rows = []
    part = {k: list(v) for k, v in ins.items()}
    for i, s in enumerate(shapes):
        n = s[0]
        r = slice(n // DP_RANKS, 2 * n // DP_RANKS) \
            if n > 1 and n % DP_RANKS == 0 else slice(0, n)
        rows.append(r)
        for slot in ('Param', 'Grad', 'Moment1', 'Moment2'):
            part[slot][i] = ins[slot][i][r]
    opt_k.apply_kernel('adam', part, attrs)  # in place
    torch.cuda.synchronize()
    for slot, got_slot in (('ParamOut', 'Param'), ('Moment1Out', 'Moment1'),
                           ('Moment2Out', 'Moment2')):
        for got, w, r in zip(part[got_slot], want[slot], rows):
            if not torch.equal(got, w[r]):
                raise AssertionError('fused_adam over row slices: %s is not '
                                     'bitwise the whole update\'s rows'
                                     % slot)
    log('  fused_adam over rank 1\'s rows of %d tensors (%d of them '
        'sliced), %d elements, one launch: bitwise the whole tensors\' '
        'plain update' % (len(shapes), sum(r != slice(0, s[0]) for r, s in
                                           zip(rows, shapes)),
                          sum(x.numel() for x in part['Param'])))
    return 0.0


def offset_view(x, offset):
    """x copied into a contiguous view at element `offset` of a larger
    buffer."""
    buf = torch.zeros(x.numel() + 4, dtype=x.dtype, device=x.device)
    out = buf[offset:offset + x.numel()]
    out.copy_(x)
    return out


def check_adam_edges(gen, dev):
    """K4's design edges, Adam and AdamW, each run one counted launch
    bitwise the per-tensor lowering: views at element offsets 1, 2 and
    3 (all four streams, and one tensor's streams at different offsets),
    sizes 1, 3, 5, 8191 and 8193, a run of 200 tiny tensors; every
    tensor with its own learning rate and beta powers."""
    aligned = (0, 0, 0, 0)
    cases = [('views at offsets 1-3', [5000, 8193, 3, 8191, 30522, 1],
              [(1, 1, 1, 1), (2, 2, 2, 2), (3, 3, 3, 3), (1, 0, 2, 3)]),
             ('sizes 1-8193', [1, 3, 5, 8191, 8193], [aligned]),
             ('200 tiny tensors', [1 + (7 * i) % 40 for i in range(200)],
              [aligned, (1, 1, 1, 1), aligned, (3, 0, 3, 3)])]
    for kind, attrs in (('adam', {'beta1': 0.9, 'beta2': 0.999,
                                  'epsilon': EPSILON}),
                        ('adamw', {'beta1': 0.85, 'beta2': 0.99,
                                   'epsilon': 1e-8, 'coeff': 0.02})):
        for name, sizes, offsets in cases:
            ins = {k: [] for k in ('Param', 'Grad', 'Moment1', 'Moment2',
                                   'LearningRate', 'Beta1Pow', 'Beta2Pow')}
            for i, n in enumerate(sizes):
                vals = (torch.randn(n, generator=gen, device=dev),
                        torch.randn(n, generator=gen, device=dev) * 1e-2,
                        torch.randn(n, generator=gen, device=dev) * 1e-3,
                        torch.rand(n, generator=gen, device=dev) * 1e-4)
                for slot, v, o in zip(('Param', 'Grad', 'Moment1',
                                       'Moment2'), vals,
                                      offsets[i % len(offsets)]):
                    ins[slot].append(offset_view(v, o))
                ins['LearningRate'].append(torch.full(
                    (1,), LR * (1 + i % 7), device=dev))
                ins['Beta1Pow'].append(torch.full((1,), 0.9 ** (i + 1),
                                                  device=dev))
                ins['Beta2Pow'].append(torch.full((1,), 0.999 ** (i + 1),
                                                  device=dev))
            want = opt_k.apply_plain(kind, None, ins, attrs)
            before = common.launches('fused_adam')
            opt_k.apply_kernel(kind, ins, attrs)  # in place
            torch.cuda.synchronize()
            if common.launches('fused_adam') != before + 1:
                raise AssertionError('fused_adam (%s) launched %d times'
                                     % (name, common.launches('fused_adam')
                                        - before))
            for slot, out in (('Param', 'ParamOut'),
                              ('Moment1', 'Moment1Out'),
                              ('Moment2', 'Moment2Out')):
                for got, w in zip(ins[slot], want[out]):
                    if not torch.equal(got, w):
                        raise AssertionError(
                            'fused_adam (%s, %s) %s is not bitwise equal to '
                            'the per-tensor lowering: max|diff| %g'
                            % (kind, name, slot, max_abs(got, w)))
            log('  fused_adam %-5s %-22s %3d tensors: bitwise equal'
                % (kind, name, len(sizes)))


def lamb_inputs(shapes, gen, dev):
    """adam_inputs over `shapes` with per-tensor beta powers (LAMB keeps
    one pair a parameter), then a tensor with a zero gradient and zero
    moments and a [1] tensor."""
    ins = adam_inputs(list(shapes) + [(4096,), (1,)], gen, dev)
    for slot in ('Beta1Pow', 'Beta2Pow'):
        ins[slot] = [x.clone() for x in ins[slot]]
    for slot in ('Grad', 'Moment1', 'Moment2'):
        ins[slot][-2].zero_()
    return ins


def check_lamb(gen, dev, shapes):
    """K5 over BERT-base's parameter set: moments bitwise, parameters to
    rtol 2e-6 / atol 3e-7, the same parameters bit for bit from a second
    launch on the same state.  The zero-gradient tensor runs without
    decay (its own run), so its r is 0: trust 1 and a zero step."""
    attrs = {'beta1': 0.9, 'beta2': 0.999, 'epsilon': EPSILON,
             'weight_decay': LAMB_DECAY}
    ins = lamb_inputs(shapes, gen, dev)
    worst = 0.0
    for lo, hi, run_attrs in ((0, len(shapes) + 2, attrs),
                              (len(shapes), len(shapes) + 1,
                               dict(attrs, weight_decay=0.0))):
        part = {k: v[lo:hi] for k, v in ins.items()}
        want = opt_k.apply_plain('lamb', None, part, run_attrs)
        outs = []
        for _ in range(2):
            got = {k: [x.clone() for x in v] for k, v in part.items()}
            opt_k.apply_kernel('lamb', got, run_attrs)
            outs.append(got)
        torch.cuda.synchronize()
        for slot, out in (('Moment1', 'Moment1Out'),
                          ('Moment2', 'Moment2Out')):
            for a, b in zip(outs[0][slot], want[out]):
                if not torch.equal(a, b):
                    raise AssertionError('fused_lamb %s is not bitwise equal '
                                         'to the per-tensor lowering: '
                                         'max|diff| %g' % (slot,
                                                           max_abs(a, b)))
        for a, b, c in zip(outs[0]['Param'], want['ParamOut'],
                           outs[1]['Param']):
            worst = max(worst, max_abs(a, b))
            if not torch.allclose(a, b, rtol=2e-6, atol=3e-7):
                raise AssertionError('fused_lamb parameters differ from the '
                                     'per-tensor lowering: max|diff| %g'
                                     % max_abs(a, b))
            if not torch.equal(a, c):
                raise AssertionError('fused_lamb gave other parameters on a '
                                     'second launch from the same state')
    if not torch.equal(outs[0]['Param'][0], part['Param'][0]):
        raise AssertionError('fused_lamb moved a tensor whose r is 0')
    log('  fused_lamb  %3d tensors, %d elements (+ a zero-gradient and a '
        '[1] tensor): moments bitwise, parameters max|diff| %.3e (rtol '
        '2e-6, atol 3e-7), bitwise from launch to launch'
        % (len(shapes), sum(int(np.prod(s)) for s in shapes), worst))
    return worst


def check_emb_update(gen, dev):
    """K7 through the fused_emb_update op against the op's plain path
    (FLAGS_torch_kernels_plain), bitwise: padding rows zeroed, ids
    clipped, untouched rows left alone."""
    n = WD_BATCH * wide_deep.BASE.num_sparse_fields
    ids = torch.randint(0, WD_ROWS, (WD_BATCH, 26), generator=gen,
                        device=dev)
    ids[0, :6] = torch.tensor([5, 5, -3, WD_ROWS, 10 ** 9, 17], device=dev)
    for rows, d, pad in ((WD_ROWS, 16, 17), (1000, 16, 0), (WD_ROWS, 1, 5)):
        ins = {'Param': [torch.randn(rows, d, generator=gen, device=dev)],
               'Moment': [torch.rand(rows, d, generator=gen, device=dev)],
               'Ids': [ids if rows == WD_ROWS else ids % rows],
               'Grad': [torch.randn(WD_BATCH, 26, d, generator=gen,
                                    device=dev)],
               'LearningRate': [torch.full((1,), 0.05, device=dev)]}
        attrs = {'epsilon': 1e-6, 'padding_idx': pad}
        start = [ins['Param'][0].clone(), ins['Moment'][0].clone()]
        flags.set_flags({'FLAGS_torch_kernels_plain': True})
        try:
            want = emb_k.apply_update(None, ins, attrs)
        finally:
            flags.set_flags({'FLAGS_torch_kernels_plain': False})
        got = emb_k.apply_update(None, ins, attrs)  # in place
        torch.cuda.synchronize()
        for slot, a, b in zip(('ParamOut', 'MomentOut'),
                              (got['ParamOut'][0], got['MomentOut'][0]),
                              (want['ParamOut'][0], want['MomentOut'][0])):
            if not torch.equal(a, b):
                raise AssertionError('embedding_update %s on %d x %d is not '
                                     'bitwise equal to its plain version: '
                                     'max|diff| %g' % (slot, rows, d,
                                                       max_abs(a, b)))
        if not (torch.equal(got['ParamOut'][0][pad], start[0][pad]) and
                torch.equal(got['MomentOut'][0][pad], start[1][pad])):
            raise AssertionError('embedding_update moved the padding row')
        touched = int(torch.unique(ins['Ids'][0].clamp(0, rows - 1)).numel())
        log('  embedding_update %7d x %2d, %d ids (%d rows touched): '
            'bitwise equal' % (rows, d, n, touched))
    # one id, one run of 8192 (the long-run kernel) and past 2**20 ids
    for name, ids in (('one id', torch.tensor([WD_ROWS - 1], device=dev)),
                      ('8192 equal ids', torch.full((8192,), 4242,
                                                    device=dev)),
                      ('2**20 + 7 uniform ids', torch.randint(
                          0, WD_ROWS, (2 ** 20 + 7,), generator=gen,
                          device=dev))):
        w = torch.randn(WD_ROWS, 16, generator=gen, device=dev)
        m = torch.rand(WD_ROWS, 16, generator=gen, device=dev)
        g = torch.randn(ids.numel(), 16, generator=gen, device=dev)
        lr = torch.full((1,), 0.05, device=dev)
        want = emb_k.update_plain(w, m, ids, g, lr, 1e-6)
        emb_k.update_kernel(w, m, ids, g, lr, 1e-6)  # in place
        torch.cuda.synchronize()
        if not (torch.equal(w, want[0]) and torch.equal(m, want[1])):
            raise AssertionError('embedding_update on %d x 16, %s, is not '
                                 'bitwise equal to its plain version: '
                                 'max|diff| %g' % (WD_ROWS, name, max(
                                     max_abs(w, want[0]),
                                     max_abs(m, want[1]))))
        log('  embedding_update %7d x 16, %s: bitwise equal'
            % (WD_ROWS, name))
    return 0.0


def quant_rows(x, n, block):
    """x flat, zero-padded to n chunks of whole blocks: [n * cb, block],
    the layout quant_allreduce quantizes."""
    chunk = -(-x.numel() // n)
    chunk = -(-chunk // block) * block
    return F.pad(x, (0, chunk * n - x.numel())).reshape(-1, block)


def check_quant(gen, dev):
    """K8's quantize and reduce at the 2-rank data-parallel shapes, each
    against its plain version, bitwise."""
    for name, numel, block in (('table 30522x768', TABLE_NUMEL, 256),
                               ('768x3072', 768 * 3072, 256),
                               ('fused bucket', 124418, 256),
                               ('block 64 unaligned', 1000003, 64)):
        n = DP_RANKS
        shards = []
        for _ in range(n):
            x = torch.randn(numel, generator=gen, device=dev) * 1e-3
            x[:2 * block] = 0.0
            x[-block:] *= 1e4
            rows = quant_rows(x, n, block)
            q, sc = qc_k.quantize_kernel(rows)
            pq, ps = qc_k.quantize_plain(rows)
            torch.cuda.synchronize()
            if not (torch.equal(q, pq) and torch.equal(sc, ps)):
                raise AssertionError('quant_quantize (%s) is not bitwise '
                                     'equal to its plain version' % name)
            shards.append((q, sc))
        cb = rows.shape[0] // n
        qt = torch.stack([q.reshape(n, cb, block)[0] for q, _ in shards])
        st = torch.stack([sc.reshape(n, cb, 1)[0] for _, sc in shards])
        qr, sr = qc_k.reduce_kernel(qt, st)
        pqr, psr = qc_k.dequant_reduce_requant_plain(qt, st)
        torch.cuda.synchronize()
        if not (torch.equal(qr, pqr) and torch.equal(sr, psr)):
            raise AssertionError('quant_reduce (%s) is not bitwise equal to '
                                 'its plain version' % name)
        log('  quant_collective %-18s %d elements: quantize %s, reduce %s: '
            'bitwise equal' % (name, numel, list(rows.shape),
                               list(qt.shape)))
    check_reduce_edges(gen, dev)
    return 0.0


def check_reduce_edges(gen, dev):
    """K8's reduce at its design edges against its plain version,
    bitwise: blocks 8, 9, 200, 256, 1024 and 4096 (vectors where rows
    start on 16 bytes, bytes where not; a second read past 256), n = 1,
    2, 3 and 8, one row and 37 rows with an all-zero row and a row whose
    absmax is its last element, and shards at byte 1 of their buffer."""
    cases = 0
    for block in (8, 9, 200, 256, 1024, 4096):
        for n in (1, 2, 3, 8):
            for cb in (1, 37):
                x = torch.randn(n * cb, block, generator=gen, device=dev) * (
                    10.0 ** torch.randint(-3, 2, (n * cb, 1), generator=gen,
                                          device=dev))
                qt, st = qc_k.quantize_plain(x)
                qt, st = qt.reshape(n, cb, block), st.reshape(n, cb, 1)
                if cb > 2:
                    qt[:, 1] = 0
                    st[:, 1] = 1.0
                    qt[:, 2] = qt[:, 2].clamp(-100, 100)
                    qt[:, 2, -1] = 127
                shards = [qt]
                if block == 256:
                    shards.append(offset_view(qt.reshape(-1), 1).view(
                        qt.shape))
                for q in shards:
                    qr, sr = qc_k.reduce_kernel(q, st)
                    pqr, psr = qc_k.dequant_reduce_requant_plain(q, st)
                    torch.cuda.synchronize()
                    if not (torch.equal(qr, pqr) and torch.equal(sr, psr)):
                        raise AssertionError(
                            'quant_reduce [%d, %d, %d] (data at byte %d mod '
                            '16) is not bitwise equal to its plain version'
                            % (n, cb, block, q.data_ptr() % 16))
                    cases += 1
    log('  quant_reduce edges: blocks 8, 9, 200, 256, 1024, 4096 x n = 1, '
        '2, 3, 8 x cb = 1, 37 (zero row, absmax last) and shards off 16 '
        'bytes: %d cases bitwise equal' % cases)


# ------------------------------------------------------------ phase 4
def build_model(model_dir, seed, seq=SEQ, pretrain=False):
    """BERT-base's encoder at `seq` saved as an inference model: built
    with bert_encoder, or (pretrain) by build_pretrain(BASE, seq,
    is_test=True) with the encoder output fetched."""
    cfg = bert.BASE
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed + 1
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        if pretrain:
            feeds, enc, _ = bert.build_pretrain(cfg, seq, is_test=True)
            feeds = {n: feeds[n] for n in ('src_ids', 'pos_ids', 'sent_ids',
                                           'input_mask')}
        else:
            feeds = bert.encoder_feeds(seq)
            enc = bert.bert_encoder(feeds['src_ids'], feeds['pos_ids'],
                                    feeds['sent_ids'], feeds['input_mask'],
                                    cfg, is_test=True)
    n_attn = sum(op.type == 'fused_multihead_attention'
                 for op in main.global_block().ops)
    n_emb = sum(op.type == 'lookup_table_v2'
                for op in main.global_block().ops)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
        fluid.io.save_inference_model(model_dir, list(feeds), [enc], exe,
                                      main_program=main)
    n_params = sum(int(np.prod(p.shape)) for p in main.all_parameters())
    return cfg, n_attn, n_emb, n_params


def serve(model_dir, cfg, n_attn, n_emb, seed, seq=SEQ, batches=BATCHES):
    """The requests of `batches` at `seq`: each served eagerly (a plan
    built for it) and then from its bucket's CUDA graph (the bucket's
    first run, its capture with one replay, one more replay, and a
    profiled replay), every call's launches at the wrappers and
    replayed launches checked, the profiled replay's K1 and K6
    kernels counted by the profiler, and every graph answer bitwise
    the eager one; the batch-8 answer against the plain path, whose
    own graph launches no kernel.  Returns the predictor, the
    requests, and the launches and the replayed launches by kernel."""
    config = AnalysisConfig(model_dir)
    pred = create_paddle_predictor(config)
    if pred.place != fluid.CUDAPlace(0):
        raise AssertionError('predictor is on %r' % pred.place)
    rng = np.random.RandomState(seed)
    requests = [bert.encoder_batch(cfg, b, seq, rng, pad_to=seq - 37 * i)
                for i, b in enumerate(batches)]
    names = pred.get_input_names()
    none = {k: 0 for k in common.KERNELS}
    expected = dict(none, flash_attention=n_attn, embedding_lookup=n_emb)
    launches, replayed = dict(none), dict(none)

    def call(req, replay=False, profile=False):
        """One request: its answer and seconds, and with `profile` its
        profile; its launches must be `expected` at the wrappers
        (replay False) or replayed."""
        events = []

        def run():
            return pred.run([req[n] for n in names])[0].data

        def run_profiled():
            out = []
            events.extend(profile_run('', lambda: out.append(run()),
                                      quiet=True, pad=True))
            return out[0]
        t0 = time.perf_counter()
        out, _ = counted(run_profiled if profile else run)
        sec = time.perf_counter() - t0
        counts = {k: common.launches(k) for k in common.KERNELS}
        again = {k: common.replayed(k) for k in common.KERNELS}
        b = req['src_ids'].shape[0]
        want = (none, expected) if replay else (expected, none)
        if (counts, again) != want:
            raise AssertionError('request batch %d launched %s and replayed '
                                 '%s, expected %s and %s'
                                 % ((b, counts, again) + want))
        for k in common.KERNELS:
            launches[k] += counts[k]
            replayed[k] += again[k]
        return out, sec, events

    def profiled_replay(req):
        """A replay under the profiler, which must see K1 and K6 run
        as often as the graph's manifest says (profiled_request)."""
        tries = []

        def once():
            out, sec, events = call(req, replay=True, profile=True)
            tries.append((out, sec))
            return events
        events = profiled_request(once, len(names))
        kernels = kernel_counts(events)
        if kernels != {'flash_fwd<float': n_attn, 'gather_rows<': n_emb}:
            raise AssertionError(
                'request batch %d: the profiler saw K1 / K6 %s times in a '
                'replay, expected %d / %d' % (req['src_ids'].shape[0],
                                              kernels, n_attn, n_emb))
        return tries

    pred._use_program_cache = False
    eager = []
    for req in requests:
        out, sec, _ = call(req)
        b = req['src_ids'].shape[0]
        log('  request batch %d, eager: out %s %s, %.2f ms, launches %s'
            % (b, out.shape, out.dtype, sec * 1e3,
               {k: c for k, c in expected.items() if c}))
        if out.shape != (b, seq, cfg.hidden) or not np.isfinite(out).all():
            raise AssertionError('request batch %d: bad output' % b)
        eager.append(out)
    pred._use_program_cache = True
    plane = compile_cache.plane()
    for req, want in zip(requests, eager):
        before = plane.stats()
        # the first run, the capture with a replay, a replay, and a
        # replay under the profiler
        tries = [call(req, replay=i > 0)[:2] for i in range(3)]
        tries += profiled_replay(req)
        secs = [sec for _, sec in tries]
        for out, _ in tries:
            if not np.array_equal(out, want):
                raise AssertionError(
                    'request batch %d: the graph path differs from the '
                    'eager answer by %g' % (req['src_ids'].shape[0],
                                            float(np.abs(out - want).max())))
        after = plane.stats()
        if after['graph_captures'] - before['graph_captures'] != 1 or \
                after['graph_replays'] - before['graph_replays'] != \
                len(tries) - 1:
            raise AssertionError('request batch %d: %s -> %s: not one '
                                 'capture and %d replays'
                                 % (req['src_ids'].shape[0], before, after,
                                    len(tries) - 1))
        log('  request batch %d, graph path (first run, capture + replay, '
            'replay, profiled replay): %s ms, each bitwise the eager '
            'answer; launches at the wrappers on the first run, replayed '
            'after, and the profiled replay ran K1 %d and K6 %d times; the '
            'capture grew the graphs\' pool by %.1f MiB'
            % (req['src_ids'].shape[0], ['%.2f' % (x * 1e3) for x in secs],
               n_attn, n_emb,
               (after['graph_pool_bytes'] - before['graph_pool_bytes']) /
               2 ** 20))
    # the whole path again with the plain versions, on the card: a graph
    # of its own, which launches no kernel
    i8 = batches.index(8)
    entries = plane.entry_count()
    flags.set_flags({'FLAGS_torch_kernels_plain': True})
    try:
        plain = [counted(lambda: pred.run(
            [requests[i8][n] for n in names])[0].data) for _ in range(3)]
    finally:
        flags.set_flags({'FLAGS_torch_kernels_plain': False})
    if plane.entry_count() != entries + 1 or any(
            any(c.values()) for _, c in plain) or any(
            common.replayed(k) for k in common.KERNELS) or not all(
            np.array_equal(o, plain[0][0]) for o, _ in plain):
        raise AssertionError('the plain path: %d -> %d graphs, launches %s'
                             % (entries, plane.entry_count(),
                                [c for _, c in plain]))
    err = float(np.abs(plain[0][0] - eager[i8]).max())
    log('  batch 8 vs the plain path on the card (its own graph: %d -> %d '
        'entries, no kernel launched): max|diff| %.3e (limit %g)'
        % (entries, plane.entry_count(), err, SLICE_TOL))
    if not err <= SLICE_TOL:
        raise AssertionError('the kernel path disagrees with the plain '
                             'path: %g' % err)
    return pred, requests, launches, replayed


def profiled_request(once, n_feeds, attempts=3):
    """The events of once(), a request under the profiler, which
    returns its profile.  A profile without the request's feed copies
    (n_feeds host-to-device) or its answer's device-to-host copy lost
    device records (seen on the H100: the first ~35 device ops of a
    request missing), so it says nothing of what ran: the request runs
    again under a new profile, up to `attempts` times."""
    from torch.autograd import DeviceType
    for _ in range(attempts):
        events = once()
        copies = {kind: sum(e.count for e in events
                            if e.device_type == DeviceType.CUDA and
                            'Memcpy %s' % kind in e.key)
                  for kind in ('HtoD', 'DtoH')}
        if copies['HtoD'] >= n_feeds and copies['DtoH'] >= 1:
            return events
        log('    the profiler lost device records (copies %s, %d device '
            'ops): profiled again' % (copies, device_ops(events)))
    raise AssertionError('the profiler lost device records in %d profiles '
                         'of a request in a row' % attempts)


def kernel_counts(events):
    """How many times K1's f32 forward and K6's gather kernels ran in
    a profile."""
    from torch.autograd import DeviceType
    return {k: sum(e.count for e in events
                   if e.device_type == DeviceType.CUDA and k in e.key)
            for k in ('flash_fwd<float', 'gather_rows<')}


def device_ms(events):
    """Device time of a profiled call: the sum of its CUDA events' own
    times (ms)."""
    from torch.autograd import DeviceType
    return sum(e.self_device_time_total for e in events
               if e.device_type == DeviceType.CUDA) / 1e3


def host_ms(events, waits=True):
    """Self CPU time of a profiled call (ms): the sum over its ops,
    without the profiler's own 'Activity Buffer Request' (~1.4 ms on
    the H100's host) and the 'profiled call' range (Python between
    the ops); waits=False also leaves out the time spent waiting for
    the device in the cuda*Synchronize calls."""
    return sum(e.self_cpu_time_total for e in events
               if e.key not in ('Activity Buffer Request', 'profiled call')
               and (waits or 'Synchronize' not in e.key)) / 1e3


def device_ops(events):
    from torch.autograd import DeviceType
    return sum(e.count for e in events if e.device_type == DeviceType.CUDA)


PAD_KERNELS = 32


def profile_run(label, fn, quiet=False, pad=False):
    """torch.profiler over one call of fn: host and device totals, the
    device-op count and the by-kernel table.  pad: PAD_KERNELS spin
    kernels (torch.cuda._sleep) run first under the profiler, fn inside
    a record_function range ('profiled call'), and both are left out of
    the totals (their launches add ~0.1 ms to the self CPU): late in a
    run the profiler has dropped the first device ops it saw."""
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        if pad:
            for _ in range(PAD_KERNELS):
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
            with record_function('profiled call'):
                fn()
                torch.cuda.synchronize()
        else:
            fn()
            torch.cuda.synchronize()
    events = prof.key_averages()
    if pad:
        from torch.autograd import DeviceType
        events = [e for e in events if 'spin_kernel' not in e.key and not (
            e.key == 'profiled call' and e.device_type == DeviceType.CUDA)]
    if not quiet:
        log('  profile %s: host %.2f ms self CPU, device %.2f ms in %d '
            'kernels/copies' % (label, host_ms(events), device_ms(events),
                                device_ops(events)))
    return events


def profile_requests(pred, requests):
    names = pred.get_input_names()
    for req in requests:
        events = profile_run('request batch %d' % req['src_ids'].shape[0],
                             lambda: pred.run([req[n] for n in names]))
    log(events.table(sort_by='self_cuda_time_total', row_limit=15))


# ------------------------------------------------------- phases 5-7
def encoder_outputs(main):
    """The output of each BERT encoder layer: the layer_norm after its
    FFN (the first layer_norm is the embeddings', then two a layer)."""
    lns = [op for op in main.global_block().ops if op.type == 'layer_norm'
           and op.attrs.get('__op_role__') != 'backward']
    return [op.output('Y')[0] for op in lns[2::2]]


def recomputed(main, types):
    """How many ops of each of `types` a RecomputeOptimizer program
    emits again in its backward (their outputs carry the @RC suffix)."""
    return {t: sum(op.type == t and op.output_arg_names and all(
        n.endswith('@RC') for n in op.output_arg_names)
        for op in main.global_block().ops) for t in types}


def pretrain_program(seed, optimizer, seq=SEQ, batch=TRAIN_BATCH,
                     recompute=False):
    """BERT-base pretraining with Adam ('adam', phase 5; phase 11 at
    seq 128; with `recompute`, phase 16 (b): under RecomputeOptimizer
    with a checkpoint at each encoder layer's output) or with LAMB, the
    warmup over a polynomial decay and the global-norm clip ('lamb',
    phase 6): the path dict that train() runs."""
    cfg = bert.BASE
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed + 1
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        _, _, loss = bert.build_pretrain(cfg, seq_len=seq)
        if optimizer == 'adam':
            lr = None
            opt = fluid.optimizer.Adam(learning_rate=LR, epsilon=EPSILON)
            if recompute:
                opt = fluid.optimizer.RecomputeOptimizer(opt)
                opt._set_checkpoints(encoder_outputs(main))
            opt.minimize(loss)
        else:
            lr = fluid.layers.linear_lr_warmup(
                fluid.layers.polynomial_decay(LAMB_PEAK, LAMB_DECAY_STEPS,
                                              0.0),
                LAMB_WARMUP, 0.0, LAMB_PEAK)
            fluid.optimizer.Lamb(
                lr, lamb_weight_decay=LAMB_DECAY, epsilon=EPSILON,
                grad_clip=fluid.clip.GradientClipByGlobalNorm(CLIP_NORM)
            ).minimize(loss)
    n_attn = sum(op.type == 'fused_multihead_attention' and
                 op.attrs.get('__op_role__') != 'backward'
                 for op in main.global_block().ops)
    expected = {k: 0 for k in common.KERNELS}
    expected.update({'flash_attention': n_attn,
                     'flash_attention_bwd': n_attn,
                     'embedding_lookup': 3, 'embedding_scatter_add': 3,
                     'fused_' + optimizer: 1, **dropout_launches(main)})
    # each recomputed span's forward kernels run again in the backward
    again = recomputed(main, ('fused_multihead_attention', 'lookup_table',
                              'lookup_table_v2', 'dropout'))
    expected['flash_attention'] += again['fused_multihead_attention']
    expected['embedding_lookup'] += again['lookup_table'] + \
        again['lookup_table_v2']
    expected['dropout'] += again['dropout']
    # gradients fetched beside the loss on step 1, held against the
    # plain path
    probe = ['embedding_0.w_0', 'fc_0.w_0', 'fc_0.w_1', 'layer_norm_0.w_0']
    probe += [p.name for p in main.all_parameters()
              if p.shape == (cfg.hidden, cfg.vocab_size)]
    return {'name': 'BERT-base %s%s%s' % (
                optimizer.upper(), '' if seq == SEQ else ' seq %d' % seq,
                ' recompute' if recompute else ''),
            'main': main, 'startup': startup, 'loss': loss, 'lr': lr,
            'batch': bert.synthetic_batch(cfg, batch, seq,
                                          np.random.RandomState(seed)),
            'expected': expected, 'probe': probe, 'tokens': batch * seq,
            'rate': LR, 'bitwise': False,
            'mask_op': mask_probe(main) if optimizer == 'adam' and
            seq == SEQ and not recompute else None}


def wide_deep_program(seed):
    """Wide&Deep CTR at BASE widths over the hashed Criteo feature space
    with Adagrad (phase 7): the path dict that train() runs."""
    cfg = wide_deep.WideDeepConfig(sparse_feature_dim=WD_ROWS)
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed + 1
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        _, preds, loss = wide_deep.build(cfg)
        fluid.optimizer.Adagrad(WD_LR, epsilon=1e-6).minimize(loss)
    n_update = sum(op.type == 'fused_emb_update'
                   for op in main.global_block().ops)
    expected = {k: 0 for k in common.KERNELS}
    expected.update({'embedding_lookup': 2, 'embedding_update': n_update,
                     **dropout_launches(main)})
    return {'name': 'Wide&Deep Adagrad', 'main': main, 'startup': startup,
            'loss': loss, 'preds': preds, 'lr': None,
            'batch': wide_deep.synthetic_batch(cfg, WD_BATCH,
                                               np.random.RandomState(seed)),
            'expected': expected, 'probe': [],
            'tokens': WD_BATCH * cfg.num_sparse_fields, 'rate': WD_LR,
            'bitwise': True}


def snapshot(scope, names):
    return {n: scope.find_var(n).detach().clone() for n in names}


def train(path):
    """TRAIN_STEPS steps of a training path on CUDAPlace(0) through
    Executor.run as it runs by default (step 1, which fetches gradients
    too, and step 2 eager, each its signature's first run; step 3
    captured in a CUDA graph and replayed), each step's launches at the
    wrappers plus its replayed launches checked; the loss checks and the
    step-1 check against the plain path.  Returns what the timings
    need."""
    main, startup, loss = path['main'], path['startup'], path['loss']
    n_opt = sum(op.type in ('adam', 'lamb', 'adagrad', 'fused_emb_update')
                for op in main.global_block().ops)
    params = main.all_parameters()
    log('  %s program: %d ops (%d update ops), %d parameters (%d elements)'
        % (path['name'], len(main.global_block().ops), n_opt, len(params),
           sum(int(np.prod(p.shape)) for p in params)))
    state_names = weights.startup_names(startup)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    fetch = [loss.name] + ([path['lr'].name] if path['lr'] else [])
    grad_fetch = [main._grad_name_map[p] for p in path['probe']]
    mask_op = path.get('mask_op')
    mask_fetch = probe_fetch(mask_op) if mask_op else []
    launches = {k: 0 for k in common.KERNELS}
    losses, rates, secs = [], [], []
    with fluid.scope_guard(scope):
        exe.run(startup)
        start = snapshot(scope, state_names)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for step in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            out, counts = counted(lambda: exe.run(
                main, feed=path['batch'],
                fetch_list=fetch + (grad_fetch + mask_fetch if step == 0
                                    else []),
                return_numpy=False))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            losses.append(float(out[0]))
            rates.append(float(out[1]) if path['lr'] else None)
            if step == 0:
                grads = [g.clone() for g in
                         out[len(fetch):len(fetch) + len(grad_fetch)]]
                after1 = snapshot(scope, state_names)
                if mask_op:
                    check_fetched_mask(exe, main, mask_op, out[-3:],
                                       torch.float32)
            for k, c in counts.items():
                launches[k] += c
            log('  step %d: loss %.6f%s, %.1f ms, launches + replayed %s'
                % (step + 1, losses[-1],
                   ', lr %.4g' % rates[-1] if path['lr'] else '',
                   secs[-1] * 1e3, {k: c for k, c in counts.items() if c}))
            if counts != path['expected']:
                raise AssertionError('step %d launched %s, expected %s'
                                     % (step + 1, counts, path['expected']))
        peak = torch.cuda.max_memory_allocated()
    log('  peak device memory over the %d steps: %.2f GiB'
        % (TRAIN_STEPS, peak / 2 ** 30))
    held = held_losses(path, start)
    log('  losses %s; with the parameters held %s'
        % (['%.6f' % x for x in losses], ['%.6f' % x for x in held]))
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0] or \
            not losses[-1] < held[-1] or \
            not abs(held[0] - losses[0]) <= 1e-6 * abs(losses[0]):
        raise AssertionError('loss %s (held %s): not finite, not falling '
                             'from step 1 to step %d, or not below the '
                             'held run' % (losses, held, TRAIN_STEPS))
    check_plain_step(path, fetch + grad_fetch, start, after1, losses[0],
                     grads, rates[0] if path['lr'] else path['rate'])
    return {'path': path, 'exe': exe, 'scope': scope, 'launches': launches,
            'peak': peak, 'rates': rates}


def held_losses(path, start, place=None):
    """The losses of TRAIN_STEPS steps that each start from `start`: the
    same step numbers, hence the same dropout masks, and parameters that
    do not move (eager steps: each starts from new tensors)."""
    exe = fluid.Executor(place or fluid.CUDAPlace(0))
    scope = fluid.Scope()
    losses = []
    with fluid.scope_guard(scope):
        without_counting(lambda: exe.run(path['startup']))
        for _ in range(TRAIN_STEPS):
            for n, v in start.items():
                scope.set_var(n, v.clone())
            losses.append(float(without_counting(lambda: eager_run(
                exe, path['main'], path['batch'], [path['loss']]))[0]))
    return losses


def check_plain_step(path, fetch, start, after1, loss1, grads, lr1,
                     batch=None, step=1):
    """Step 1 (or the step after executor step `step`, on `batch`) again
    from the same state (a startup run and the kernel path's step
    counter, then its starting values), with every kernel's plain
    version.

    A path with `bitwise` (Wide&Deep) runs the same PyTorch ops around
    kernels that are bitwise their plain versions: the loss and the
    whole state after the step must be bit for bit the kernel path's.

    On the BERT paths the hidden dropout draws from the same generator
    (program seed, op seed, step) and the attention mask from the same
    hash, so both paths compute the same function in another summation
    order: the loss agrees to LOSS_RTOL, the probed gradients and every
    first moment ((1 - beta1) * gradient after one step) to GRAD_TOL of
    their largest magnitude.  A first Adam step at rate lr1 moves a
    parameter by lr1 * g / (|g| + epsilon), which changes by at most
    lr1 / epsilon times a change of g, so each parameter must agree
    within (lr1 / epsilon) * max|d moment1| / (1 - beta1), with 5% and
    1e-7 of slack for rounding; LAMB's first step runs at the warmup's
    rate 0, so its parameters must stay within the 1e-7.  A later step
    (lr1 None) holds the loss, the gradients and the moments alone: its
    parameters move by ratios of moments that no bound of this kind
    covers."""
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    flags.set_flags({'FLAGS_torch_kernels_plain': True})
    try:
        with fluid.scope_guard(scope):
            without_counting(lambda: exe.run(path['startup']))
            exe._step = step
            for n, v in start.items():
                scope.set_var(n, v.clone())
            out = without_counting(lambda: exe.run(
                path['main'], feed=path['batch'] if batch is None else batch,
                fetch_list=fetch, return_numpy=False))
            torch.cuda.synchronize()
            got = snapshot(scope, list(start))
    finally:
        flags.set_flags({'FLAGS_torch_kernels_plain': False})
    if path['bitwise']:
        differ = [n for n in start if not torch.equal(after1[n], got[n])]
        log('  step %s vs the plain path: loss %s, state %s' % (
            '1' if step == 1 else 'after executor step %d' % step,
            'equal' if float(out[0]) == loss1 else 'differs',
            'bitwise equal (%d variables)' % len(start) if not differ
            else 'differs in %s' % differ))
        if float(out[0]) != loss1 or differ:
            raise AssertionError('the training step is not bitwise its '
                                 'plain path')
        return
    loss_err = abs(float(out[0]) - loss1) / abs(loss1)
    n_fixed = len(fetch) - len(grads)
    grad_err = max(max_abs(a, b) / b.abs().max().item()
                   for a, b in zip(grads, out[n_fixed:]))
    moment_err, param_ratio = 0.0, 0.0
    for n in start:
        if '_moment1_' not in n:
            continue
        dm = max_abs(after1[n], got[n])
        moment_err = max(moment_err,
                         dm / max(got[n].abs().max().item(), 1e-30))
        if lr1 is not None:
            p = n.split('_moment1_')[0]
            limit = lr1 / EPSILON * dm / (1 - 0.9) * 1.05 + 1e-7
            param_ratio = max(param_ratio,
                              max_abs(after1[p], got[p]) / limit)
    log('  step %s vs the plain path: loss rel %.2e (limit %g), gradients '
        'of %s rel %.2e, first moments rel %.2e (limit %g), %s' % (
            '1' if step == 1 else 'after executor step %d' % step, loss_err,
            LOSS_RTOL, path['probe'], grad_err, moment_err, GRAD_TOL,
            'parameters not bounded' if lr1 is None else
            'parameters at %.2f of their bound' % param_ratio))
    if not (loss_err <= LOSS_RTOL and grad_err <= GRAD_TOL and
            moment_err <= GRAD_TOL and param_ratio <= 1.0):
        raise AssertionError('the training step disagrees with its plain '
                             'path')


def train_step_ms(run):
    """Median host-clock time of exe.run (the loss fetched to numpy, so
    it ends after the step's last kernel) over TIMED_STEPS steps.  Beside
    each step, outside its timing: the garbage collections Python ran
    during it and since the step before (generation, ms; from
    gc.callbacks) and how many times the caching allocator freed its
    cache to retry an allocation during it
    (torch.cuda.memory_stats()['num_alloc_retries'])."""
    path = run['path']
    secs, notes = [], []
    collections, began = [], [0.0]

    def on_gc(phase, info):
        if phase == 'start':
            began[0] = time.perf_counter()
        else:
            collections.append('gen %d %.2f ms' % (
                info['generation'], (time.perf_counter() - began[0]) * 1e3))
    seen = 0
    gc.callbacks.append(on_gc)
    try:
        with fluid.scope_guard(run['scope']):
            for _ in range(TIMED_STEPS):
                retries = torch.cuda.memory_stats().get('num_alloc_retries',
                                                        0)
                before = len(collections)
                t0 = time.perf_counter()
                run['exe'].run(path['main'], feed=path['batch'],
                               fetch_list=[path['loss']])
                secs.append(time.perf_counter() - t0)
                after = len(collections)
                notes.append('gc during %s, before %s; alloc retries +%d' % (
                    collections[before:after] or 'none',
                    collections[seen:before] or 'none',
                    torch.cuda.memory_stats().get('num_alloc_retries', 0) -
                    retries))
                seen = after
    finally:
        gc.callbacks.remove(on_gc)
    med = statistics.median(secs) * 1e3
    log('  %s step: median %.2f ms over %d steps %s, %.0f %s/s' % (
        path['name'], med, TIMED_STEPS, ['%.2f' % (x * 1e3) for x in secs],
        path['tokens'] / med * 1e3,
        path.get('unit', 'ids' if path['bitwise'] else 'tokens')))
    for i, note in enumerate(notes):
        log('    timed step %d: %s' % (i + 1, note))
    return med


# each training path's numbers from plan_cache_steps
GRAPH_NUMBERS = []


def graph_stats():
    return {k: compile_cache.counter_value('executor/' + k)
            for k in ('graph_captures', 'graph_replays', 'graph_refused',
                      'graph_stale', 'graph_pool_bytes')}


def graph_refusals(program, scope):
    """The reasons kept for the signatures of `program` whose capture
    failed on `scope`."""
    out = []
    for plan in program._exec_cache.values():
        for g in plan.graphs.get(scope, {}).values():
            units = getattr(g, 'units', None)   # a pipeline's
            out.extend(u for u in (units or [g]) if isinstance(u, str))
    return out


def drop_graphs(program, scope):
    """Free the CUDA graphs (and their pools) of `program` on `scope`."""
    for plan in program._exec_cache.values():
        plan.graphs.pop(scope, None)
    gc.collect()
    torch.cuda.empty_cache()


def plan_cache_steps(run, required=True):
    """TIMED_STEPS steps from the run's current state, three ways, each
    from the same state (written back in place) and executor step: with
    use_program_cache=False (the plan built for every step), from the
    plan cache eagerly (eager_run), and from the plan cache with CUDA
    graphs, as Executor.run runs by default (the first step eager on the
    capture stream, the second captured with one replay, the rest
    replayed; the graphs the run captured before are freed first).  Each side: its median step (host clock,
    the loss fetched to numpy; the graph side's over its replays), the
    self CPU and device time of one profiled step after its timed ones
    (a replay on the graph side) and its peak memory; the graph side's
    first run, capture and graph pool.

    Every loss and every variable of the startup program after the
    timed steps must be bitwise equal on the three sides (the
    parameters, moments, beta powers, the learning-rate counter, the
    AMP loss scale and its counters): all run with cuDNN's
    deterministic algorithms (LeNet-5's filter gradients otherwise sum
    in a varying order).  The scope's tensors must stay the same
    objects.  The graph side must capture once, replay the other steps
    and refuse nothing, and its launches at the wrappers plus its
    replayed launches must be the eager cached side's, kernel by
    kernel; a path that is not `required` (Wide&Deep) prints why its
    capture was refused instead.  Where the eager sides differ, the
    uncached steps are run once more, to tell a plan-cache fault from
    a path that does not repeat itself.  The graphs are freed after."""
    path, exe, scope = run['path'], run['exe'], run['scope']
    main = path['main']
    names = weights.startup_names(path['startup'])
    sides = (('use_program_cache=False', False, False),
             ('plan cache, eager', True, False),
             ('plan cache, CUDA graphs', True, True))
    res = {}
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True

    def one(cache, graphs):
        if not graphs:
            return eager_run(exe, main, path['batch'], [path['loss']],
                             use_cache=cache)[0]
        return exe.run(main, feed=path['batch'], fetch_list=[path['loss']],
                       use_program_cache=cache)[0]

    def steps(cache, graphs=False):
        for n, v in start.items():
            held[n].copy_(v)
        exe._step = step0
        secs, losses = [], []
        for _ in range(TIMED_STEPS):
            t0 = time.perf_counter()
            losses.append(one(cache, graphs))
            secs.append(time.perf_counter() - t0)
        return secs, losses, snapshot(scope, names)

    drop_graphs(main, scope)
    try:
        with fluid.scope_guard(scope):
            held = {n: scope.find_var(n) for n in names}
            start, step0 = snapshot(scope, names), exe._step
            for label, cache, graphs in sides:
                stats = graph_stats()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                common.reset_launches()
                secs, losses, after = steps(cache, graphs)
                launched = {k: common.launches(k)
                            for k in common.KERNELS}
                replayed = {k: common.replayed(k)
                            for k in common.KERNELS}
                events = profile_run('', lambda: one(cache, graphs),
                                     quiet=True, pad=True)
                torch.cuda.synchronize()
                res[label] = dict(
                    secs=secs, losses=losses, after=after,
                    launched=launched, replayed=replayed,
                    host=host_ms(events),
                    host_nowait=host_ms(events, waits=False),
                    dev=device_ms(events),
                    peak=torch.cuda.max_memory_allocated(),
                    stats={k: v - stats[k]
                           for k, v in graph_stats().items()})
            moved = [n for n, v in held.items() if scope.find_var(n) is not v]
            refusals = graph_refusals(main, scope)
            base = res[sides[0][0]]
            differ = {label: [n for n in names if not torch.equal(
                base['after'][n], r['after'][n])] + [
                    'loss of step %d' % (i + 1) for i, (a, b) in enumerate(
                        zip(base['losses'], r['losses']))
                    if not np.array_equal(a, b)]
                for label, r in res.items()}
            if differ[sides[1][0]]:
                again = steps(False)[2]
                log('  the uncached steps run again: %s' % (
                    'bitwise the first uncached run' if all(
                        torch.equal(again[n], base['after'][n])
                        for n in names) else 'they differ from the first '
                    'uncached run too'))
    finally:
        torch.backends.cudnn.deterministic = saved
        drop_graphs(main, scope)
    for label, _, graphs in sides:
        r = res[label]
        timed = r['secs'][2:] if graphs else r['secs']
        r['median'] = statistics.median(timed) * 1e3
        log('  %s step, %s (cuDNN deterministic): median %.2f ms over %s '
            '%s; one profiled: self CPU %.2f ms (%.2f outside the '
            'synchronizing waits), device %.2f ms; peak %.2f GiB' % (
                path['name'], label, r['median'],
                'its %d replays' % len(timed) if graphs else
                '%d steps' % len(timed),
                ['%.2f' % (x * 1e3) for x in r['secs']], r['host'],
                r['host_nowait'], r['dev'], r['peak'] / 2 ** 30))
    g, e = res[sides[2][0]], res[sides[1][0]]
    st = g['stats']
    log('  %s graph side: first run %.2f ms, capture with one replay %.2f '
        'ms, graph pool %.1f MiB, captures %d, replays %d, refused %d, '
        'stale %d%s; launches at the wrappers %s, replayed %s' % (
            path['name'], g['secs'][0] * 1e3, g['secs'][1] * 1e3,
            st['graph_pool_bytes'] / 2 ** 20, st['graph_captures'],
            st['graph_replays'], st['graph_refused'], st['graph_stale'],
            ' (%s)' % refusals if refusals else '',
            {k: c for k, c in g['launched'].items() if c},
            {k: c for k, c in g['replayed'].items() if c}))
    log('  %s: the %d variables and %d losses after the timed steps %s; '
        'scope tensors %s' % (
            path['name'], len(names), TIMED_STEPS, '; '.join(
                '%s: %s' % (label, 'bitwise equal to the uncached side'
                            if not d else 'differ in %s' % d[:8])
                for label, d in differ.items() if label != sides[0][0]),
            'kept' if not moved else 'replaced: %s' % moved[:8]))
    if any(differ.values()) or moved:
        raise AssertionError('%s: the three sides differ, or the state '
                             'left its tensors' % path['name'])
    total = {k: g['launched'][k] + g['replayed'][k] for k in common.KERNELS}
    if not required and st['graph_captures'] == 0:
        log('  %s stays eager: %s' % (path['name'], refusals))
        return
    if st['graph_captures'] != 1 or st['graph_refused'] or \
            st['graph_stale'] or st['graph_replays'] != TIMED_STEPS or \
            total != e['launched']:
        raise AssertionError(
            '%s: the graph side captured %d, replayed %d, refused %d (%s), '
            'stale %d; launches + replayed %s against eager %s' % (
                path['name'], st['graph_captures'], st['graph_replays'],
                st['graph_refused'], refusals, st['graph_stale'],
                {k: c for k, c in total.items() if c},
                {k: c for k, c in e['launched'].items() if c}))
    GRAPH_NUMBERS.append(
        '%s: use_program_cache=False %.2f ms, plan cache %.2f ms, graph '
        'replays %.2f ms; self CPU outside the waits %.2f / %.2f / %.2f '
        'ms; device %.2f / %.2f / %.2f ms; peak %.2f / %.2f / %.2f GiB; '
        'pool %.1f MiB' % (
            path['name'], *[res[lb[0]]['median'] for lb in sides],
            *[res[lb[0]]['host_nowait'] for lb in sides],
            *[res[lb[0]]['dev'] for lb in sides],
            *[res[lb[0]]['peak'] / 2 ** 30 for lb in sides],
            st['graph_pool_bytes'] / 2 ** 20))


def profile_train(run):
    path = run['path']
    with fluid.scope_guard(run['scope']):
        events = profile_run('%s step' % path['name'], lambda: run['exe'].run(
            path['main'], feed=path['batch'], fetch_list=[path['loss']]))
    log(events.table(sort_by='self_cuda_time_total', row_limit=25))
    # the port's own kernels in the step (all in anonymous namespaces)
    from torch.autograd import DeviceType
    mark = '(anonymous namespace)::'
    port = sorted((e for e in events if e.device_type == DeviceType.CUDA and
                   e.key.split(mark)[0] in ('', 'void ') and mark in e.key),
                  key=lambda e: -e.self_device_time_total)
    for e in port:
        log('    %-36s %9.3f us in %d launches' % (
            e.key.split(mark)[1].split('(')[0], e.self_device_time_total,
            e.count))
    log('    the port\'s kernels: %.3f us of the step\'s device time'
        % sum(e.self_device_time_total for e in port))
    return device_ms(events)


def step_device_ms(run):
    """The device time of one profiled step of a training run."""
    path = run['path']
    with fluid.scope_guard(run['scope']):
        return device_ms(profile_run('%s step' % path['name'], lambda: run[
            'exe'].run(path['main'], feed=path['batch'],
                       fetch_list=[path['loss']])))


# ------------------------------------------------------------ phase 8
def bound(nbytes, flops, tensor_cores=False, bf16=False):
    """The least time for `nbytes` of HBM traffic and `flops` of f32
    work: on the f32 pipe, or (tensor_cores) as f32-accurate products on
    the tensor cores, three TF32 products each, with the f32-pipe figure
    kept under bound_f32_ms; `bf16`: products of bf16 operands on the
    tensor cores at their dense bf16 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    if bf16:
        t_ops = flops / BF16_FLOPS_PER_S * 1e3
        return {'bound_ms': max(t_bytes, t_ops),
                'bound_by': 'bytes' if t_bytes >= t_ops else 'operations'}
    t_f32 = flops / F32_FLOPS_PER_S * 1e3
    t_ops = 3 * flops / TF32_FLOPS_PER_S * 1e3 if tensor_cores else t_f32
    out = {'bound_ms': max(t_bytes, t_ops),
           'bound_by': 'bytes' if t_bytes >= t_ops else 'operations'}
    if tensor_cores:
        out['bound_f32_ms'] = max(t_bytes, t_f32)
    return out


def sdpa_bwd_call(q, k, v, mask, do):
    """The library call for the flash backward: SDPA's memory-efficient
    backward op (the backend SDPA takes for f32 with a float mask) on
    the outputs its forward saved, with dropout RATE; one call a CUDA
    graph can hold."""
    b, t, h, _ = q.shape
    qh, kh, vh, doh = [x.transpose(1, 2) for x in (q, k, v, do)]
    bias = mask.expand(b, h, t, t)
    out, lse, seed, offset = \
        torch.ops.aten._scaled_dot_product_efficient_attention(
            qh, kh, vh, bias, True, RATE)
    # the backward reads the dropout RNG's seed and offset from host
    # tensors when called eagerly and from device tensors under CUDA
    # graph capture
    rng = {False: (seed.cpu(), offset.cpu()),
           True: (seed.to(q.device), offset.to(q.device))}
    bwd = torch.ops.aten._scaled_dot_product_efficient_attention_backward
    return lambda: bwd(
        doh, qh, kh, vh, bias, out, lse,
        *rng[torch.cuda.is_current_stream_capturing()], RATE,
        [True, True, True, False])


def scatter_split(timer, rows, ids, g):
    """K6b's parts on one input, each timed alone (cold L2): the sort of
    the clipped ids; the zeroing of the output, which the kernel does in
    the sort's launch on other SMs (timed as that launch); the run and
    long-run passes (with the zeroing of their 4-byte run count)."""
    runs = emb_k._runs_scratch(g.shape[0], g.device)
    out = torch.empty(rows, g.shape[1], device=g.device)
    keys, order, _ = emb_k._scatter_sort(rows, ids, runs)
    return {'sort_ms': timer.ms(lambda: emb_k._scatter_sort(rows, ids,
                                                            runs)),
            'sort_and_zero_ms': timer.ms(lambda: emb_k._scatter_sort(
                rows, ids, runs, out)),
            'kernel_ms': timer.ms(lambda: emb_k._scatter_sum(
                keys, order, g, out, runs, False, True))}


def update_split(timer, rows, ids, w, m, g, lr):
    """K7's parts on one input, each timed alone (cold L2): the sort (the
    histogram and one launch a digit pass) and the run and long-run
    kernels on the sorted workspace."""
    lib = emb_k._update_lib()
    work = emb_k._update_work(lib, ids.numel(), rows, ids.device)
    emb_k._update_sort(lib, rows, ids, work)
    return {'sort_ms': timer.ms(lambda: emb_k._update_sort(
                lib, rows, ids, work)),
            'kernel_ms': timer.ms(lambda: emb_k._update_rows(
                lib, work, g, lr, w, m, 1e-6))}


def time_kernels(timer, gen, dev, req, train_batch, wd_batch, launches,
                 max_err, adam_shapes, lenet_shapes, seed):
    b, t, h, d = 8, SEQ, 12, 64
    seed = 4242
    # the dropout seed in device memory, as the executor hands it to K1
    # and K2 (a CUDA graph of a call reads it there)
    drop_seed = torch.full((), seed, dtype=torch.int64, device=dev)
    q, k, v = qkv_views(gen, b, t, h, d, dev)
    bias = torch.from_numpy(req['input_mask']).to(dev) * 10000.0 - 10000.0
    qh, kh, vh = [x.transpose(1, 2) for x in (q, k, v)]
    mask = bias[:, None, None, :]
    o, lse = fa_k.flash_attention_kernel(q, k, v, False, bias, RATE,
                                         drop_seed, DP_G_OFFSET)
    do = torch.randn(b, t, h, d, generator=gen, device=dev)
    fa_bytes = 4 * (4 * b * t * h * d + b * t + b * h * t)
    fa_flops = 4 * b * h * t * t * d
    # the bf16 route at the same shape: bf16 Q, K, V, O and dO, the f32
    # bias and lse; SDPA in bf16 (its mask in bf16) as the yardstick
    qb, kb, vb, dob = [x.to(torch.bfloat16) for x in (q, k, v, do)]
    qhb, khb, vhb = [x.transpose(1, 2) for x in (qb, kb, vb)]
    mask_b = mask.to(torch.bfloat16)
    ob, lseb = fa_k.flash_attention_kernel(qb, kb, vb, False, bias, RATE,
                                           drop_seed)
    fa_bytes_b = 2 * 4 * b * t * h * d + 4 * (b * t + b * h * t)
    fa_bwd_bytes_b = 2 * 8 * b * t * h * d + 4 * (b * t + b * h * t)
    w = torch.randn(30522, 768, generator=gen, device=dev)
    ids = torch.from_numpy(req['src_ids']).to(dev).reshape(-1)
    n = ids.numel()
    src = torch.from_numpy(train_batch['src_ids']).to(dev).reshape(-1)
    zeros = torch.zeros_like(src)
    g = torch.randn(src.numel(), 768, generator=gen, device=dev)
    ins = adam_inputs(adam_shapes, gen, dev)
    adam_attrs = {'beta1': 0.9, 'beta2': 0.999, 'epsilon': EPSILON}
    table, blocks = opt_k.device_table(ins)
    n_adam = sum(x.numel() for x in ins['Param'])
    lib_params = [torch.nn.Parameter(x.clone()) for x in ins['Param']]
    for p, x in zip(lib_params, ins['Grad']):
        p.grad = x.clone()
    lib_adam = torch.optim.Adam(lib_params, lr=LR, eps=EPSILON, fused=True,
                                capturable=True)
    # K4 over LeNet-5's 6 tensors, beside fused torch.optim.Adam on them
    lenet_ins = adam_inputs(lenet_shapes, gen, dev)
    lenet_table, lenet_blocks = opt_k.device_table(lenet_ins)
    n_lenet = sum(x.numel() for x in lenet_ins['Param'])
    lenet_params = [torch.nn.Parameter(x.clone())
                    for x in lenet_ins['Param']]
    for p, x in zip(lenet_params, lenet_ins['Grad']):
        p.grad = x.clone()
    lib_lenet = torch.optim.Adam(lenet_params, lr=LENET_LR['adam'],
                                 fused=True, capturable=True)
    # K4 over rank 1's shard of BERT-base under ReduceStrategy.Reduce
    # (phase 12): half the rows of every tensor whose dim 0 is even, the
    # others whole, beside fused torch.optim.Adam on the same tensors
    zero_ins = adam_inputs(zero_shapes(adam_shapes), gen, dev)
    zero_table, zero_blocks = opt_k.device_table(zero_ins)
    n_zero = sum(x.numel() for x in zero_ins['Param'])
    zero_params = [torch.nn.Parameter(x.clone()) for x in zero_ins['Param']]
    for p, x in zip(zero_params, zero_ins['Grad']):
        p.grad = x.clone()
    lib_zero = torch.optim.Adam(zero_params, lr=LR, eps=EPSILON, fused=True,
                                capturable=True)
    lamb_attrs = {'beta1': 0.9, 'beta2': 0.999, 'epsilon': EPSILON,
                  'weight_decay': LAMB_DECAY}
    lamb_ins = lamb_inputs(adam_shapes, gen, dev)
    lamb_ins = {k: v[:len(adam_shapes)] for k, v in lamb_ins.items()}
    lamb_table, lamb_blocks = opt_k.device_table(lamb_ins, opt_k.LAMB_SOURCE)
    # the deep table's update: the main path's ids, its [V, 16] table
    wd_ids = torch.from_numpy(wd_batch['sparse_input']).to(dev).reshape(-1)
    n_wd = wd_ids.numel()
    rows_wd = {}
    for rows, width in ((WD_ROWS, 16), (1000, 16), (WD_ROWS, 1)):
        ids_r = wd_ids % rows
        touched = int(torch.unique(ids_r).numel())
        rows_wd[(rows, width)] = dict(
            ids=ids_r, w=torch.randn(rows, width, generator=gen, device=dev),
            m=torch.rand(rows, width, generator=gen, device=dev),
            g=torch.randn(n_wd, width, generator=gen, device=dev),
            touched=touched,
            bound=bound(n_wd * (8 + width * 4) + touched * width * 16, 0))
    # the hot case: 8192 ids on a 64 x 16 table, all but six on row 0
    hot_ids = torch.zeros(8192, dtype=torch.int64, device=dev)
    hot_ids[:6] = torch.tensor([3, 3, -7, 64, 64 + 9, 63], device=dev)
    rows_wd['hot'] = dict(
        ids=hot_ids, w=torch.randn(64, 16, generator=gen, device=dev),
        m=torch.rand(64, 16, generator=gen, device=dev),
        g=torch.randn(8192, 16, generator=gen, device=dev), touched=3,
        bound=bound(8192 * (8 + 16 * 4) + 3 * 16 * 16, 0))
    lr_wd = torch.full((1,), WD_LR, device=dev)
    deep = rows_wd[(WD_ROWS, 16)]
    wide = rows_wd[(WD_ROWS, 1)]
    lib_emb = torch.nn.Parameter(deep['w'].clone())
    lib_emb.grad = torch.sparse_coo_tensor(deep['ids'][None], deep['g'],
                                           deep['w'].shape,
                                           check_invariants=True)
    lib_adagrad = torch.optim.Adagrad([lib_emb], lr=WD_LR, eps=1e-6)
    lib_wide = torch.nn.Parameter(wide['w'].clone())
    lib_wide.grad = torch.sparse_coo_tensor(wide['ids'][None], wide['g'],
                                            wide['w'].shape,
                                            check_invariants=True)
    lib_adagrad_wide = torch.optim.Adagrad([lib_wide], lr=WD_LR, eps=1e-6)
    # K8 at the table gradient's shapes on 2 ranks: the quantize of the
    # padded payload, the reduce of one chunk's 2 shards
    quant = {}
    for numel in (TABLE_NUMEL, 768 * 3072):
        rows = quant_rows(torch.randn(numel, generator=gen, device=dev) *
                          1e-3, DP_RANKS, QUANT_BLOCK)
        codes, scales = qc_k.quantize_kernel(rows)
        cb = rows.shape[0] // DP_RANKS
        nbytes = rows.numel() * (1 + 4 / QUANT_BLOCK)
        quant[numel] = dict(
            rows=rows, qt=codes.reshape(DP_RANKS, cb, QUANT_BLOCK),
            st=scales.reshape(DP_RANKS, cb, 1),
            # f32 in, int8 and scales out; n shards in, one chunk out
            qbound=bound(rows.numel() * 4 + nbytes, 0),
            rbound=bound(nbytes + nbytes / DP_RANKS, 0))
    tab = quant[TABLE_NUMEL]
    # the Transformer's 10,000 x 512 tables at phase 11's source ids
    nmt = nmt_ids(seed).to(dev)
    w_nmt = torch.randn(NMT_ROWS, 512, generator=gen, device=dev)
    g_nmt = torch.randn(nmt.numel(), 512, generator=gen, device=dev)
    # the dropout op's activations and their gradients: BERT-base's
    # [8, 512, 768] in f32 and (under AMP) bf16; the forward reads X and
    # writes Out, and Mask where it is read; the gradient reads dOut and
    # writes dX; native_dropout_backward takes the 1-byte keep mask
    x_drop = torch.randn(8, SEQ, 768, generator=gen, device=dev)
    x_drop_b = x_drop.to(torch.bfloat16)
    g_drop = torch.randn(8, SEQ, 768, generator=gen, device=dev)
    g_drop_b = g_drop.to(torch.bfloat16)
    keep_drop = drop_k.hash_keep(drop_seed, x_drop.shape, RATE, dev)
    n_drop = x_drop.numel()
    # name, kernel, plain, library, bound, whether a CUDA graph can
    # hold the plain version and the library call (the others have no
    # host sync)
    calls = [
        ('flash_attention',
         lambda: fa_k.flash_attention_kernel(q, k, v, False, bias),
         lambda: fa_k.flash_attention_plain(q, k, v, False, bias),
         lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask),
         bound(fa_bytes, fa_flops, True), True, True),
        ('flash_attention[dropout]',
         lambda: fa_k.flash_attention_kernel(q, k, v, False, bias, RATE,
                                             drop_seed, DP_G_OFFSET),
         lambda: fa_k.flash_attention_plain(q, k, v, False, bias, RATE,
                                            drop_seed, DP_G_OFFSET),
         lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,
                                                dropout_p=RATE),
         bound(fa_bytes, fa_flops, True), True, True),
        # the bound counts the S recompute and the four products the
        # gradient needs from q, k, v, O, lse and dO
        ('flash_attention_bwd',
         lambda: fa_k.flash_attention_bwd_kernel(q, k, v, bias, o, lse, do,
                                                 None, False, RATE, drop_seed,
                                                 False, DP_G_OFFSET),
         lambda: fa_k.flash_attention_bwd_plain(q, k, v, bias, do, None,
                                                False, RATE, drop_seed, False,
                                                DP_G_OFFSET),
         sdpa_bwd_call(q, k, v, mask, do),
         bound(4 * (8 * b * t * h * d + b * t + b * h * t),
               10 * b * h * t * t * d, True), False, True),
        # the bf16 route (phase 13's BERT-base under AMP): one bf16
        # product for each of the two (forward) and five (backward)
        ('flash_attention[bf16]',
         lambda: fa_k.flash_attention_kernel(qb, kb, vb, False, bias),
         lambda: fa_k.flash_attention_plain(qb, kb, vb, False, bias),
         lambda: F.scaled_dot_product_attention(qhb, khb, vhb,
                                                attn_mask=mask_b),
         bound(fa_bytes_b, fa_flops, bf16=True), True, True),
        ('flash_attention[bf16,dropout]',
         lambda: fa_k.flash_attention_kernel(qb, kb, vb, False, bias, RATE,
                                             drop_seed),
         lambda: fa_k.flash_attention_plain(qb, kb, vb, False, bias, RATE,
                                            drop_seed),
         lambda: F.scaled_dot_product_attention(qhb, khb, vhb,
                                                attn_mask=mask_b,
                                                dropout_p=RATE),
         bound(fa_bytes_b, fa_flops, bf16=True), True, True),
        ('flash_attention_bwd[bf16]',
         lambda: fa_k.flash_attention_bwd_kernel(qb, kb, vb, bias, ob, lseb,
                                                 dob, None, False, RATE,
                                                 drop_seed),
         lambda: fa_k.flash_attention_bwd_plain(qb, kb, vb, bias, dob, None,
                                                False, RATE, drop_seed),
         sdpa_bwd_call(qb, kb, vb, mask_b, dob),
         bound(fa_bwd_bytes_b, 10 * b * h * t * t * d, bf16=True), False,
         True),
        # the ids are in range here: F.embedding does not clip
        ('embedding_lookup',
         lambda: emb_k.gather_kernel(w, ids),
         lambda: emb_k.gather_plain(w, ids),
         lambda: F.embedding(ids, w),
         bound(2 * n * 768 * 4 + n * 8, 0), True, True),
        ('embedding_scatter_add',
         lambda: emb_k.scatter_add_kernel(30522, src, g),
         lambda: emb_k.scatter_add_plain(30522, src, g),
         lambda: torch.zeros(30522, 768, device=dev).index_add_(0, src, g),
         bound(src.numel() * (768 * 4 + 8) + 30522 * 768 * 4, 0), False,
         True),
        # the step's other scatter: BERT's 2-row sentence table, every id
        # on row 0, one run of 4096 rows
        ('embedding_scatter_add[2-row]',
         lambda: emb_k.scatter_add_kernel(2, zeros, g),
         lambda: emb_k.scatter_add_plain(2, zeros, g),
         lambda: torch.zeros(2, 768, device=dev).index_add_(0, zeros, g),
         bound(src.numel() * (768 * 4 + 8) + 2 * 768 * 4, 0), False, True),
        ('embedding_lookup[nmt]',
         lambda: emb_k.gather_kernel(w_nmt, nmt),
         lambda: emb_k.gather_plain(w_nmt, nmt),
         lambda: F.embedding(nmt, w_nmt),
         bound(2 * nmt.numel() * 512 * 4 + nmt.numel() * 8, 0), True, True),
        ('embedding_scatter_add[nmt]',
         lambda: emb_k.scatter_add_kernel(NMT_ROWS, nmt, g_nmt),
         lambda: emb_k.scatter_add_plain(NMT_ROWS, nmt, g_nmt),
         lambda: torch.zeros(NMT_ROWS, 512, device=dev).index_add_(
             0, nmt, g_nmt),
         bound(nmt.numel() * (512 * 4 + 8) + NMT_ROWS * 512 * 4, 0), False,
         True),
        ('fused_adam',
         lambda: opt_k.launch('adam', table, blocks, adam_attrs),
         lambda: opt_k.apply_plain('adam', None, ins, adam_attrs),
         lib_adam.step,
         bound(28 * n_adam + 12 * len(adam_shapes), 0), True, True),
        ('fused_adam[lenet]',
         lambda: opt_k.launch('adam', lenet_table, lenet_blocks, LENET_ADAM),
         lambda: opt_k.apply_plain('adam', None, lenet_ins, LENET_ADAM),
         lib_lenet.step,
         bound(28 * n_lenet + 12 * len(lenet_shapes), 0), True, True),
        ('fused_adam[zero]',
         lambda: opt_k.launch('adam', zero_table, zero_blocks, adam_attrs),
         lambda: opt_k.apply_plain('adam', None, zero_ins, adam_attrs),
         lib_zero.step,
         bound(28 * n_zero + 12 * len(adam_shapes), 0), True, True),
        # moments pass 24 bytes an element, apply pass 16; no PyTorch
        # call computes LAMB
        ('fused_lamb',
         lambda: opt_k.launch_lamb(lamb_table, lamb_blocks, lamb_attrs),
         lambda: opt_k.apply_plain('lamb', None, lamb_ins, lamb_attrs),
         None, bound(40 * n_adam + 12 * len(adam_shapes), 0), True, True),
        # ids, gradient rows, the touched rows of w and m read and written
        ('embedding_update',
         lambda: emb_k.update_kernel(deep['w'], deep['m'], deep['ids'],
                                     deep['g'], lr_wd, 1e-6),
         lambda: emb_k.update_plain(deep['w'], deep['m'], deep['ids'],
                                    deep['g'], lr_wd, 1e-6),
         lib_adagrad.step, deep['bound'], False, False),
        # the wide part's D = 1 table over the same ids
        ('embedding_update[wide]',
         lambda: emb_k.update_kernel(wide['w'], wide['m'], wide['ids'],
                                     wide['g'], lr_wd, 1e-6),
         lambda: emb_k.update_plain(wide['w'], wide['m'], wide['ids'],
                                    wide['g'], lr_wd, 1e-6),
         lib_adagrad_wide.step, wide['bound'], False, False),
        # no PyTorch call computes the block absmax scale and the +-127
        # rounding; phase 9 times the dense collective instead
        ('quant_quantize',
         lambda: qc_k.quantize_kernel(tab['rows']),
         lambda: qc_k.quantize_plain(tab['rows']),
         None, tab['qbound'], True, True),
        ('quant_reduce',
         lambda: qc_k.reduce_kernel(tab['qt'], tab['st']),
         lambda: qc_k.dequant_reduce_requant_plain(tab['qt'], tab['st']),
         None, tab['rbound'], True, True),
        # the dropout op (upscale_in_train, as BERT's), beside
        # torch.native_dropout (its own mask from Philox)
        ('dropout',
         lambda: drop_k.dropout_kernel(x_drop, drop_seed, RATE, True),
         lambda: drop_k.dropout_plain(x_drop, drop_seed, RATE, True),
         lambda: torch.native_dropout(x_drop, RATE, True),
         bound(12 * n_drop + 8, 0), True, True),
        ('dropout[bf16]',
         lambda: drop_k.dropout_kernel(x_drop_b, drop_seed, RATE, True),
         lambda: drop_k.dropout_plain(x_drop_b, drop_seed, RATE, True),
         lambda: torch.native_dropout(x_drop_b, RATE, True),
         bound(6 * n_drop + 8, 0), True, True),
        # without Mask, as every training step but a fetching one runs it
        ('dropout[no mask]',
         lambda: drop_k.dropout_kernel(x_drop, drop_seed, RATE, True, False),
         lambda: drop_k.dropout_plain(x_drop, drop_seed, RATE, True),
         lambda: torch.native_dropout(x_drop, RATE, True),
         bound(8 * n_drop + 8, 0), True, True),
        ('dropout[bf16,no mask]',
         lambda: drop_k.dropout_kernel(x_drop_b, drop_seed, RATE, True,
                                       False),
         lambda: drop_k.dropout_plain(x_drop_b, drop_seed, RATE, True),
         lambda: torch.native_dropout(x_drop_b, RATE, True),
         bound(4 * n_drop + 8, 0), True, True),
        ('dropout_grad',
         lambda: drop_k.dropout_grad_kernel(g_drop, drop_seed, RATE, True),
         lambda: drop_k.dropout_grad_plain(g_drop, drop_seed, RATE, True),
         lambda: torch.ops.aten.native_dropout_backward(
             g_drop, keep_drop, 1.0 / (1.0 - RATE)),
         bound(8 * n_drop + 8, 0), True, True),
        ('dropout_grad[bf16]',
         lambda: drop_k.dropout_grad_kernel(g_drop_b, drop_seed, RATE, True),
         lambda: drop_k.dropout_grad_plain(g_drop_b, drop_seed, RATE, True),
         lambda: torch.ops.aten.native_dropout_backward(
             g_drop_b, keep_drop, 1.0 / (1.0 - RATE)),
         bound(4 * n_drop + 8, 0), True, True),
    ]
    rows = []
    for name, kernel, plain, library, bnd, graph, lib_graph in calls:
        base = name.split('[')[0]
        info = common.KERNELS[base]
        ms = timer.ms(kernel)
        plain_ms = timer.ms(plain, graph=graph)
        library_ms = None if library is None else \
            timer.ms(library, graph=lib_graph)
        row = {'name': name, 'route': 'cuda',
               'source': 'paddle_tpu_torch/ops/kernels/csrc/' +
                         info['source'],
               'replaces': info['replaces'].split(' ')[0],
               'launches': launches.get(name, launches.get(base)),
               'max_abs_err': max_err.get(name, max_err.get(base)),
               'ms': ms, 'plain_ms': plain_ms,
               'bound_ms': bnd['bound_ms'], 'bound_by': bnd['bound_by'],
               'library_ms': library_ms}
        if 'bound_f32_ms' in bnd:
            row['bound_f32_ms'] = bnd['bound_f32_ms']
        rows.append(row)
        log('  %-28s cold L2: kernel %.4f ms  plain %.4f ms%s  library '
            '%s  bound %.4f ms (%s)%s' % (
                name, ms, plain_ms, '' if graph else ' (events)',
                'none' if library_ms is None else '%.4f ms%s' % (
                    library_ms, '' if lib_graph else ' (events)'),
                row['bound_ms'], row['bound_by'],
                '' if 'bound_f32_ms' not in bnd else
                ', tensor cores; %.4f ms on the f32 pipe'
                % bnd['bound_f32_ms']) +
            ('' if name not in BEFORE_MS else
             '; %s took %.4f ms' % BEFORE_MS[name]) +
            ('' if name not in NO_OFFSET_MS else
             '; at head offset %d (without it: %.4f ms)'
             % (DP_G_OFFSET, NO_OFFSET_MS[name])))
    # K6b's parts: the sort, the zeroing (in the sort's launch) and the
    # run and long-run passes
    for rows_k, ids_k in ((30522, src), (2, zeros)):
        split = scatter_split(timer, rows_k, ids_k, g)
        log('  %-24s cold L2 split, %d x 768 table: sort %.4f ms, sort with '
            'the zeroing (one launch) %.4f ms, run and long-run passes '
            '%.4f ms' % ('embedding_scatter_add', rows_k, split['sort_ms'],
                         split['sort_and_zero_ms'], split['kernel_ms']))
    # K6b past SORT_MAX ids: torch.sort, a memset and the kernel's passes
    for n_ids in SCATTER_BIG_IDS:
        ids_n = torch.randint(0, 30522, (n_ids,), generator=gen, device=dev)
        g_n = torch.randn(n_ids, 768, generator=gen, device=dev)
        same = torch.equal(emb_k.scatter_add_kernel(30522, ids_n, g_n),
                           emb_k.scatter_add_plain(30522, ids_n, g_n))
        log('  %-24s cold L2, %d ids on the 30522 x 768 table: kernel %.4f '
            'ms  plain %.4f ms (events)  index_add_ %.4f ms  bound %.4f ms; '
            '%s its plain version' % (
                'embedding_scatter_add', n_ids,
                timer.ms(lambda: emb_k.scatter_add_kernel(30522, ids_n, g_n)),
                timer.ms(lambda: emb_k.scatter_add_plain(30522, ids_n, g_n),
                         graph=False),
                timer.ms(lambda: torch.zeros(30522, 768, device=dev)
                         .index_add_(0, ids_n, g_n)),
                bound(n_ids * (768 * 4 + 8) + 30522 * 768 * 4, 0)['bound_ms'],
                'bitwise' if same else 'NOT bitwise'))
        if not same:
            raise AssertionError('embedding_scatter_add at %d ids is not '
                                 'bitwise its plain version' % n_ids)
    dropout_extra(timer, gen, dev, drop_seed, x_drop, g_drop, keep_drop)
    # K8 at a 768 x 3072 gradient's shapes
    w3 = quant[768 * 3072]
    log('  %-24s cold L2: kernel %.4f ms  plain %.4f ms  bound %.4f ms '
        '(768 x 3072 gradient, [%d, %d])' % (
            'quant_quantize', timer.ms(lambda: qc_k.quantize_kernel(
                w3['rows'])), timer.ms(lambda: qc_k.quantize_plain(
                    w3['rows'])), w3['qbound']['bound_ms'],
            *w3['rows'].shape))
    log('  %-24s cold L2: kernel %.4f ms  plain %.4f ms  bound %.4f ms '
        '(768 x 3072 gradient, [%d, %d, %d])' % (
            'quant_reduce', timer.ms(lambda: qc_k.reduce_kernel(
                w3['qt'], w3['st'])),
            timer.ms(lambda: qc_k.dequant_reduce_requant_plain(
                w3['qt'], w3['st'])), w3['rbound']['bound_ms'],
            *w3['qt'].shape))
    # the row update on BASE's 1000-row table (~106 visits a row) and on
    # the hot case (one run of 8187 rows), beside the sparse Adagrad step
    # of torch.optim on the same table and ids (clipped into the table,
    # as the kernel clips them)
    for key, label in (((1000, 16), '1000 x 16 table'),
                       ('hot', '64 x 16 table, one run of 8187')):
        r = rows_wd[key]
        lib_param = torch.nn.Parameter(r['w'].clone())
        lib_param.grad = torch.sparse_coo_tensor(
            r['ids'].clamp(0, r['w'].shape[0] - 1)[None], r['g'],
            r['w'].shape, check_invariants=True)
        lib_step = torch.optim.Adagrad([lib_param], lr=WD_LR, eps=1e-6).step
        log('  %-28s cold L2: kernel %.4f ms  plain %.4f ms (events)  '
            'sparse Adagrad %.4f ms (events)  bound %.4f ms (%s, %d ids, %d '
            'rows touched)' % (
                'embedding_update', timer.ms(
                    lambda: emb_k.update_kernel(r['w'], r['m'], r['ids'],
                                                r['g'], lr_wd, 1e-6)),
                timer.ms(lambda: emb_k.update_plain(
                    r['w'], r['m'], r['ids'], r['g'], lr_wd, 1e-6),
                    graph=False),
                timer.ms(lib_step, graph=False),
                r['bound']['bound_ms'], label, r['ids'].numel(),
                r['touched']) + (
                    '; %s took %.4f ms'
                    % BEFORE_MS['embedding_update[1000-row]']
                    if key == (1000, 16) else ''))
    # K7's parts: its sort and its run kernels
    for key in ((WD_ROWS, 16), (WD_ROWS, 1), (1000, 16), 'hot'):
        r = rows_wd[key]
        rows_k = 64 if key == 'hot' else key[0]
        split = update_split(timer, rows_k, r['ids'], r['w'], r['m'],
                             r['g'], lr_wd)
        log('  %-24s cold L2 split, %d x %d table: sort %.4f ms, run and '
            'long-run kernels %.4f ms' % (
                'embedding_update', rows_k, r['w'].shape[1],
                split['sort_ms'], split['kernel_ms']))
    return rows


def dropout_extra(timer, gen, dev, seed, x, g, keep):
    """Phase 8's lines beside the dropout kernels' rows: an empty kernel
    launched and timed as the kernels are (on one block and on the
    forward's wave), the gradient as the chain of PyTorch ops it was
    (dropout_grad from the saved Mask), the Transformer FFN's
    [64, 64, 2048] and DROPOUT_BIG times BERT-base's tensor, each kernel
    beside its bound and its library call."""
    lib = common.library(drop_k.SOURCE)
    lib.dropout_empty.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.dropout_wave.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    wave = {}
    for dt in (torch.float32, torch.bfloat16):
        blocks = ctypes.c_int(0)
        common.check_launch('dropout_wave', lib, lib.dropout_wave(
            drop_k._DTYPES[dt], ctypes.byref(blocks)), count=False)
        wave[dt] = blocks.value

    def empty_launch(blocks):
        common.check_launch('dropout_empty', lib, lib.dropout_empty(
            blocks, common.stream_ptr(dev)), count=False)
    empty = {blocks: timer.ms(lambda: empty_launch(blocks))
             for blocks in {1, *wave.values()}}
    log('  %-28s cold L2: %s (the timer\'s floor: a launch that does '
        'nothing)' % ('empty kernel', ', '.join(
            '%.4f ms on %d blocks' % (ms, b) for b, ms in sorted(
                empty.items()))))
    for dt in (torch.float32, torch.bfloat16):
        gd, mask = g.to(dt), keep.to(dt)
        log('  %-28s cold L2: %.4f ms (%s at [8, %d, 768]: the compare, the '
            'division, zeros_like and where from the saved Mask%s)' % (
                'dropout_grad chain', timer.ms(lambda: drop_k.dropout_grad(
                    gd, mask, RATE, True)), str(dt).split('.')[1], SEQ,
                '' if dt == torch.float32 else ', and the casts'))
    # the Transformer trains in f32 only
    shapes = (('the Transformer FFN\'s', (NMT_BATCH, NMT_LEN, 2048),
               (torch.float32,)),
              ('%d times BERT-base\'s' % DROPOUT_BIG,
               (8 * DROPOUT_BIG, SEQ, 768), (torch.float32, torch.bfloat16)))
    for label, shape, dtypes in shapes:
        xs = torch.randn(*shape, generator=gen, device=dev)
        gs = torch.randn(*shape, generator=gen, device=dev)
        ks = drop_k.hash_keep(seed, shape, RATE, dev)
        for dt in dtypes:
            xd, gd = xs.to(dt), gs.to(dt)
            width = xd.element_size()
            n = xd.numel()
            sfx = '' if dt == torch.float32 else '[bf16]'
            for name, call, library, nbytes in (
                    ('dropout' + sfx,
                     lambda: drop_k.dropout_kernel(xd, seed, RATE, True),
                     lambda: torch.native_dropout(xd, RATE, True),
                     3 * width * n),
                    ('dropout[%sno mask]' % ('bf16,' if sfx else ''),
                     lambda: drop_k.dropout_kernel(xd, seed, RATE, True,
                                                   False),
                     lambda: torch.native_dropout(xd, RATE, True),
                     2 * width * n),
                    ('dropout_grad' + sfx,
                     lambda: drop_k.dropout_grad_kernel(gd, seed, RATE,
                                                        True),
                     lambda: torch.ops.aten.native_dropout_backward(
                         gd, ks, 1.0 / (1.0 - RATE)), 2 * width * n)):
                ms = timer.ms(call)
                bnd = bound(nbytes + 8, 0)['bound_ms']
                log('  %-28s cold L2: kernel %.4f ms  library %.4f ms  '
                    'bound %.4f ms, %.0f%% of it (%s %s)' % (
                        name, ms, timer.ms(library), bnd, 100 * bnd / ms,
                        label, list(shape)))
        del xs, gs, ks


def request_latency(pred, requests, n_attn, n_emb, runs=5):
    """Per request batch size, eager (a plan built for each request) and
    from the bucket's CUDA graph: the median host-clock time of pred.run
    (numpy in, numpy out, so it ends after the device-to-host copy),
    the self CPU, device time and device-op count of one profiled
    request, and the peak device memory over the timed requests.  The
    profiled replay must show K1's and K6's kernels n_attn and n_emb
    times: the replay runs the hand-written kernels."""
    from torch.autograd import DeviceType
    names = pred.get_input_names()
    for req in requests:
        b = req['src_ids'].shape[0]
        for cache in (False, True):
            pred._use_program_cache = cache
            pred.run([req[n] for n in names])
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            resting = torch.cuda.memory_allocated()
            secs = []
            for _ in range(runs):
                t0 = time.perf_counter()
                pred.run([req[n] for n in names])
                secs.append(time.perf_counter() - t0)
            peak = torch.cuda.max_memory_allocated() - resting
            want = {'flash_fwd<float': n_attn, 'gather_rows<': n_emb}
            events = profiled_request(lambda: profile_run(
                '', lambda: pred.run([req[n] for n in names]), quiet=True,
                pad=True), len(names))
            kernels = kernel_counts(events)
            if kernels != want:
                log('    the profile saw K1 / K6 %s times; its device ops: '
                    '%s' % (kernels, sorted(
                        (e.count, e.key[:60]) for e in events
                        if e.device_type == DeviceType.CUDA)))
            log('  request batch %d %s: median %.2f ms over %d runs %s; '
                'one profiled: self CPU %.2f ms (%.2f outside the '
                'synchronizing waits), device %.2f ms in %d kernels/copies '
                '(K1 %d, K6 %d); peak %.1f MiB above the resting '
                'allocation' % (
                    b, 'graph replay' if cache else 'eager',
                    statistics.median(secs) * 1e3, runs,
                    ['%.2f' % (x * 1e3) for x in secs], host_ms(events),
                    host_ms(events, waits=False), device_ms(events),
                    device_ops(events), kernels['flash_fwd<float'],
                    kernels['gather_rows<'], peak / 2 ** 20))
            if kernels != want and cache:
                raise AssertionError(
                    'request batch %d: the profiler saw K1 / K6 %s times '
                    'in a replay, expected %d / %d'
                    % (b, kernels, n_attn, n_emb))
    pred._use_program_cache = True


def naive_attention(q, k, v, mask):
    """The port's naive attention chain on [B, T, H, D] q, k, v and a
    [B, 1, 1, T] key bias: the lowerings BERT runs below flash_min_len
    (transpose2, matmul with the scale, elementwise_add, softmax,
    matmul, transpose2, reshape2), without dropout."""
    ctx = registry.LowerCtx(1, device=q.device)

    def op(kind, ins, **attrs):
        return registry.get(kind).run(ctx, ins, attrs)['Out'][0]
    qh, kh, vh = [op('transpose2', {'X': [x]}, axis=[0, 2, 1, 3])
                  for x in (q, k, v)]
    s = op('matmul', {'X': [qh], 'Y': [kh]}, transpose_Y=True,
           alpha=q.shape[3] ** -0.5)
    p = op('softmax', {'X': [op('elementwise_add', {'X': [s], 'Y': [mask]},
                                axis=-1)]}, axis=-1)
    o = op('transpose2', {'X': [op('matmul', {'X': [p], 'Y': [vh]})]},
           axis=[0, 2, 1, 3])
    return op('reshape2', {'X': [o]}, shape=[0, 0, -1])


def attention_crossover(timer, gen, dev):
    """The naive chain against K1 (forward) and K1 + K2 (forward and
    backward) on BERT-base's attention (12 heads, D = 64) at
    CROSSOVER_SEQS with CROSSOVER_TOKENS tokens each, no dropout, a
    padding bias; device times of CUDA-graph replays with L2 flushed.
    The chain's backward is autograd's over its lowerings; the outputs
    of both routes agree within FA_TOL."""
    h, d = 12, 64
    for t in CROSSOVER_SEQS:
        b = CROSSOVER_TOKENS // t
        qkv = torch.randn(b, t, 3 * h * d, generator=gen, device=dev)
        q, k, v = [x.reshape(b, t, h, d) for x in qkv.split(h * d, dim=2)]
        leaf = qkv.clone().requires_grad_()
        bias = padding_bias(gen, b, t, dev)
        mask = bias[:, None, None, :]
        do = torch.randn(b, t, h, d, generator=gen, device=dev)
        o, _ = fa_k.flash_attention_kernel(q, k, v, False, bias)
        with torch.no_grad():
            err = max_abs(naive_attention(q, k, v, mask),
                          o.reshape(b, t, h * d))
        if not err <= FA_TOL:
            raise AssertionError('the naive chain and K1 disagree at seq %d: '
                                 '%g' % (t, err))

        def naive_fwd():
            with torch.no_grad():
                naive_attention(q, k, v, mask)

        def naive_fwd_bwd():
            out = naive_attention(*[x.reshape(b, t, h, d)
                                    for x in leaf.split(h * d, dim=2)], mask)
            torch.autograd.grad(out, [leaf], do.reshape(b, t, h * d))

        def flash_fwd_bwd():
            o, lse = fa_k.flash_attention_kernel(q, k, v, False, bias)
            fa_k.flash_attention_bwd_kernel(q, k, v, bias, o, lse, do, None)
        times = {name: timer.ms(fn) for name, fn in (
            ('naive_fwd', naive_fwd),
            ('k1', lambda: fa_k.flash_attention_kernel(q, k, v, False,
                                                       bias)),
            ('naive_fwd_bwd', naive_fwd_bwd), ('k1_k2', flash_fwd_bwd))}
        log('  attention crossover seq %d (batch %d, %d tokens): forward '
            'naive %.4f ms, K1 %.4f ms; forward + backward naive %.4f ms, '
            'K1 + K2 %.4f ms (naive/flash %.2f); max|naive - K1| %.1e' % (
                t, b, b * t, times['naive_fwd'], times['k1'],
                times['naive_fwd_bwd'], times['k1_k2'],
                times['naive_fwd_bwd'] / times['k1_k2'], err))


# ------------------------------------------------------------ phase 9
def free_port():
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sk:
        sk.bind(('127.0.0.1', 0))
        return sk.getsockname()[1]


def data_parallel(seed, profile):
    """Phase 9: this script on DP_RANKS ranks through the port's
    launcher; the ranks' results.  A rank that fails (or the time limit)
    fails the phase: the launcher then stops every rank."""
    out_dir = tempfile.mkdtemp(dir=os.path.join(ROOT, 'build', 'chip_smoke'))
    cmd = [sys.executable, '-m', 'paddle_tpu_torch.distributed.launch',
           '--nproc_per_node', str(DP_RANKS), '--started_port',
           str(free_port()), os.path.join(ROOT, 'chip_smoke.py'),
           '--dp-worker', '--dp-out', out_dir, '--seed', str(seed)] + \
        (['--profile'] if profile else [])
    t0 = time.perf_counter()
    rc = subprocess.run(cmd, cwd=ROOT, timeout=DP_TIMEOUT_S).returncode
    if rc != 0:
        raise AssertionError('the data-parallel ranks failed (launcher exit '
                             '%d)' % rc)
    results = []
    for r in range(DP_RANKS):
        with open(os.path.join(out_dir, 'rank%d.json' % r)) as f:
            results.append(json.load(f))
    log('  %d ranks on cards %s over %s, %.1f s' % (
        DP_RANKS, [res['card'] for res in results], results[0]['backend'],
        time.perf_counter() - t0))
    for res in results:
        log('  rank %d: losses %s, held %s; step median quantized %.2f ms '
            '(its collectives alone %.2f), dense %.2f ms (%.2f); peak %.2f '
            'GiB; quant bound used %.3f; table-gradient all-reduce '
            'quantized %.2f ms, flat dense %.2f ms, rs_ag %.2f ms' % (
                res['rank'], ['%.6f' % x for x in res['losses']],
                ['%.6f' % x for x in res['held']], res['step_ms']['quant'],
                res['step_collectives_ms']['quant'], res['step_ms']['dense'],
                res['step_collectives_ms']['dense'], res['peak'] / 2 ** 30,
                res['bound_ratio'], res['collective_ms']['quant'],
                res['collective_ms']['dense'], res['collective_ms']['rs_ag']))
    rn = [res['phase12']['resnet'] for res in results]
    bt = [res['phase12']['bert'] for res in results]
    log('  phase 12, ResNet-50 on %d ranks of batch %d: step median %s ms, '
        '%s images/s by rank, %.1f images/s for the job (global batch %d '
        'over the slowest rank\'s step); gradient all-reduce alone %s ms; '
        'peak %s GiB' % (
            DP_RANKS, rn[0]['images'], ['%.2f' % r['step_ms'] for r in rn],
            ['%.1f' % (r['images'] / r['step_ms'] * 1e3) for r in rn],
            sum(r['images'] for r in rn) / max(r['step_ms'] for r in rn) *
            1e3, sum(r['images'] for r in rn),
            ['%.2f' % r['allreduce_ms'] for r in rn],
            ['%.2f' % (r['peak'] / 2 ** 30) for r in rn]))
    log('  phase 12, BERT-base Reduce on %d ranks of batch %d: step median '
        '%s ms, %s tokens/s by rank, %.0f tokens/s for the job; peak %s GiB '
        'against %s GiB under AllReduce' % (
            DP_RANKS, DP_BERT_BATCH, ['%.2f' % b['step_ms'] for b in bt],
            ['%.0f' % (b['tokens'] / b['step_ms'] * 1e3) for b in bt],
            sum(b['tokens'] for b in bt) / max(b['step_ms'] for b in bt) *
            1e3, ['%.2f' % (b['peak'] / 2 ** 30) for b in bt],
            ['%.2f' % (b['peak_allreduce'] / 2 ** 30) for b in bt]))
    return results


def params_in_sync(scope, names, group, dev):
    """Whether every rank's parameters are bitwise rank 0's."""
    from paddle_tpu_torch.distributed import wire
    flat = torch.cat([scope.find_var(n).reshape(-1) for n in names])
    same = torch.equal(flat, wire.broadcast(flat, group, 0))
    ok = wire.all_reduce(torch.tensor([float(same)], device=dev), group,
                         op=dist.ReduceOp.MIN)
    return bool(ok.item())


def collective_ms(fn, group, runs=5):
    """Median wall time of fn() on every rank, the ranks released
    together."""
    secs = []
    for _ in range(runs):
        dist.barrier(group=group)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return statistics.median(secs) * 1e3


def dp_worker(args):
    """One rank of phase 9 (see the module docstring); raises on any
    failed check, so the launcher stops the job."""
    from paddle_tpu_torch.distributed import init_distributed, local_card
    from paddle_tpu_torch.distributed import wire
    from paddle_tpu_torch.fluid import comms, comms_plan
    from paddle_tpu_torch.fluid.transpiler import GradAllReduce
    from paddle_tpu_torch.ops import collective_ops
    card = local_card()
    place = fluid.CUDAPlace(card)
    dev = place.torch_device()
    torch.cuda.set_device(dev)
    group = init_distributed(place)
    rank, n = dist.get_rank(), dist.get_world_size()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def say(fmt, *a):
        log('  [rank %d] ' % rank + fmt % a)

    flags.set_flags({'FLAGS_comms_quantize': True})
    path = pretrain_program(args.seed, 'adam')
    batch = path['batch'] = bert.synthetic_batch(
        bert.BASE, TRAIN_BATCH, SEQ, np.random.RandomState(args.seed + rank))
    main, startup, loss = path['main'], path['startup'], path['loss']
    GradAllReduce().transpile(startup, main, rank,
                              os.environ['PADDLE_TRAINER_ENDPOINTS'].split(
                                  ','),
                              os.environ['PADDLE_CURRENT_ENDPOINT'])
    block = main.global_block()
    colls = [op.input('X') for op in block.ops if op.attrs.get('plan') and
             op.type in ('c_allreduce_sum', 'c_allreduce_fused')]
    arms = [comms_plan.decide(
        4.0 * sum(int(np.prod(block.var(g).shape)) for g in names), 4,
        n)['arm'] for names in colls]
    n_quant = arms.count('quant')
    expected = dict(path['expected'], quant_quantize=n_quant,
                    quant_reduce=n_quant)
    say('%d ops, %d planned collectives (%d quantized, %d fused), backend '
        '%s, card %d', len(block.ops), len(colls), n_quant,
        sum(len(x) > 1 for x in colls), dist.get_backend(group), card)
    grads = [g for names in colls for g in names]
    params = sorted(p.name for p in main.all_parameters())
    state_names = weights.startup_names(startup)
    exe, scope = fluid.Executor(place), fluid.Scope()
    losses, secs = [], []
    launches = {k: 0 for k in common.KERNELS}
    with fluid.scope_guard(scope):
        exe.run(startup)
        start = snapshot(scope, state_names)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        comms.reset()
        for step in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            out, counts = counted(lambda: exe.run(
                main, feed=batch,
                fetch_list=[loss] + (grads if step == 0 else []),
                return_numpy=False))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            losses.append(float(out[0]))
            for k, c in counts.items():
                launches[k] += c
            if step == 0:
                quant_avg = dict(zip(grads, out[1:]))
            in_sync = without_counting(
                lambda: params_in_sync(scope, params, group, dev))
            say('step %d: loss %.6f, %.1f ms, launches %s, ranks in sync %s',
                step + 1, losses[-1], secs[-1] * 1e3,
                {k: c for k, c in counts.items() if c}, in_sync)
            if counts != expected:
                raise AssertionError('step %d launched %s, expected %s'
                                     % (step + 1, counts, expected))
            if not in_sync:
                raise AssertionError('the ranks\' parameters differ after '
                                     'step %d' % (step + 1))
        peak = torch.cuda.max_memory_allocated(dev)
        if comms.arm_counts() != {'quant': TRAIN_STEPS * n_quant,
                                  'dense': 0, 'rs_ag': 0}:
            raise AssertionError('arms run: %s' % comms.arm_counts())
    held = without_counting(lambda: held_losses(path, start, place))
    say('losses %s; with the parameters held %s',
        ['%.6f' % x for x in losses], ['%.6f' % x for x in held])
    if not (all(np.isfinite(losses)) and losses[-1] < held[-1]):
        raise AssertionError('loss %s not finite or not below the held run '
                             '%s' % (losses, held))

    def step1(prog, prog_startup, quantize):
        """The gradients `grads` of step 1 of `prog` from `start`, on a
        scope of its own."""
        flags.set_flags({'FLAGS_comms_quantize': quantize})
        try:
            ex, sc = fluid.Executor(place), fluid.Scope()
            with fluid.scope_guard(sc):
                ex.run(prog_startup)
                for name, v in start.items():
                    sc.set_var(name, v.clone())
                got = ex.run(prog, feed=batch, fetch_list=grads,
                             return_numpy=False)
            return dict(zip(grads, got))
        finally:
            flags.set_flags({'FLAGS_comms_quantize': True})

    dense_avg = without_counting(lambda: step1(main, startup, False))
    # each rank's own gradients: the program before the rewrite
    before = pretrain_program(args.seed, 'adam')
    local = without_counting(lambda: step1(before['main'],
                                           before['startup'], True))
    del before
    ratio = 0.0
    for names in colls:
        rows = [quant_rows(torch.cat([src[g].reshape(-1) for g in names]),
                           n, QUANT_BLOCK) for src in (local, quant_avg,
                                                       dense_avg)]
        s_sum = wire.all_reduce(rows[0].abs().amax(1) / 127.0, group)
        q_sum, d_sum = rows[1] * n, rows[2] * n
        bound_b = s_sum / 2 + q_sum.abs().amax(1) / 127.0 / 2 + \
            2e-6 * d_sum.abs().amax(1) + 1e-30
        err_b = (q_sum - d_sum).abs().amax(1)
        ratio = max(ratio, (err_b / bound_b).max().item())
    say('step 1 quantized vs dense all-reduced gradients: at most %.3f of '
        'the quantization bound', ratio)
    if not ratio <= 1.0:
        raise AssertionError('the quantized arm is off the dense arm by more '
                             'than its bound (%.3f)' % ratio)
    table = max(grads, key=lambda g: local[g].numel())
    x = local[table]
    got = without_counting(lambda: qc_k.quant_allreduce(x, group, n,
                                                        QUANT_BLOCK))
    flags.set_flags({'FLAGS_torch_kernels_plain': True})
    try:
        want = without_counting(lambda: qc_k.quant_allreduce(
            x, group, n, QUANT_BLOCK))
    finally:
        flags.set_flags({'FLAGS_torch_kernels_plain': False})
    if not torch.equal(got, want):
        raise AssertionError('the quantized all-reduce of %s is not bitwise '
                             'its plain path' % table)
    say('quantized all-reduce of %s %s: bitwise its plain path', table,
        list(x.shape))
    # a step's planned collectives alone, on this rank's gradients
    payloads = [torch.cat([local[g].reshape(-1) for g in names])
                for names in colls]
    del local, quant_avg, dense_avg, got, want, start
    torch.cuda.empty_cache()

    step_ms = {}
    with fluid.scope_guard(scope):
        for arm in ('quant', 'dense'):
            flags.set_flags({'FLAGS_comms_quantize': arm == 'quant'})
            ts = []
            for _ in range(TIMED_STEPS):
                t0 = time.perf_counter()
                without_counting(lambda: exe.run(main, feed=batch,
                                                 fetch_list=[loss]))
                ts.append(time.perf_counter() - t0)
            step_ms[arm] = statistics.median(ts) * 1e3
            say('%s arm: step median %.2f ms over %d steps %s', arm,
                step_ms[arm], TIMED_STEPS, ['%.1f' % (t * 1e3) for t in ts])
            if args.profile:
                events = without_counting(lambda: profile_run(
                    'rank %d %s arm step' % (rank, arm), lambda: exe.run(
                        main, feed=batch, fetch_list=[loss])))
                if rank == 0:
                    log(events.table(sort_by='self_cpu_time_total',
                                     row_limit=12))
    step_coll = {}
    for arm in ('quant', 'dense'):
        flags.set_flags({'FLAGS_comms_quantize': arm == 'quant'})
        step_coll[arm] = collective_ms(lambda: without_counting(lambda: [
            collective_ops._planned_allreduce(p, group, n, {'plan': True})
            for p in payloads]), group)
    say('the %d planned collectives of a step alone: quantized %.2f ms, '
        'dense %.2f ms', len(payloads), step_coll['quant'],
        step_coll['dense'])
    flags.set_flags({'FLAGS_comms_quantize': True})
    coll = {
        'quant': collective_ms(lambda: without_counting(
            lambda: qc_k.quant_allreduce(x, group, n, QUANT_BLOCK)), group),
        'dense': collective_ms(lambda: wire.all_reduce(x, group), group),
        'rs_ag': collective_ms(lambda: collective_ops._rs_ag_allreduce(
            x, group, n), group)}
    say('all-reduce of %s (%.1f MB f32): quantized %.2f ms, flat dense %.2f '
        'ms, rs_ag %.2f ms', table, x.numel() * 4 / 1e6, coll['quant'],
        coll['dense'], coll['rs_ag'])
    res = {'rank': rank, 'card': card, 'backend': dist.get_backend(group),
           'losses': losses, 'held': held, 'step_ms': step_ms, 'peak': peak,
           'bound_ratio': ratio, 'collective_ms': coll,
           'step_collectives_ms': step_coll,
           'n_collectives': len(colls), 'n_quant': n_quant,
           'launches': launches,
           'card_line': card_line()}
    # phase 12 in the same job, phase 9's state freed first
    del exe, scope, path, main, startup, block, batch, x, payloads
    gc.collect()
    torch.cuda.empty_cache()
    res['phase12'] = dp_ranks_phase12(args, group, rank, n, place, dev, say)
    with open(os.path.join(args.dp_out, 'rank%d.json' % rank), 'w') as f:
        json.dump(res, f)
    dist.barrier(group=group)
    dist.destroy_process_group()
    return 0


# ----------------------------------------------------------- phase 10
def lenet_path(seed, opt):
    """LeNet-5 with Adam ('adam', K4 once a step) or SGD ('sgd', no
    kernel) on one synthetic MNIST batch from `seed`."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed + 1
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        _, _, loss, acc = lenet.build()
        if opt == 'adam':
            fluid.optimizer.Adam(LENET_LR['adam']).minimize(loss)
        else:
            fluid.optimizer.SGD(LENET_LR['sgd']).minimize(loss)
    imgs, labels = mnist._synthetic(LENET_BATCH, seed)
    expected = {k: 0 for k in common.KERNELS}
    expected.update(dropout_launches(main))
    if opt == 'adam':
        expected['fused_adam'] = 1
    return {'name': 'LeNet-5 %s' % opt.upper(), 'opt': opt, 'main': main,
            'startup': startup, 'loss': loss, 'acc': acc,
            'batch': {'img': imgs.reshape(-1, 1, 28, 28),
                      'label': labels.reshape(-1, 1)},
            'expected': expected,
            'probe': sorted(p.name for p in main.all_parameters())}


def train_lenet(path):
    """TRAIN_STEPS steps, then TIMED_STEPS timed ones, of LeNet-5 on
    CUDAPlace(0); every step's launches are counted and checked, the
    fetched accuracy goes to metrics.Accuracy, the loss must fall, and
    step 1 is held against the plain path."""
    main, loss = path['main'], path['loss']
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    names = weights.startup_names(path['startup'])
    grad_fetch = [main._grad_name_map[p] for p in path['probe']]
    accuracy = metrics.Accuracy()
    launches = {k: 0 for k in common.KERNELS}
    losses, secs = [], []
    with fluid.scope_guard(scope):
        exe.run(path['startup'])
        start = snapshot(scope, names)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for step in range(TRAIN_STEPS + TIMED_STEPS):
            t0 = time.perf_counter()
            # the loss comes back as numpy: the step has ended
            out, counts = counted(lambda: exe.run(
                main, feed=path['batch'],
                fetch_list=[loss, path['acc']] +
                (grad_fetch if step == 0 else [])))
            secs.append(time.perf_counter() - t0)
            losses.append(float(out[0]))
            accuracy.update(out[1], LENET_BATCH)
            if step == 0:
                grads = [torch.from_numpy(g) for g in out[2:]]
                after1 = snapshot(scope, names)
            for k, c in counts.items():
                launches[k] += c
            if counts != path['expected']:
                raise AssertionError('%s step %d launched %s, expected %s'
                                     % (path['name'], step + 1, counts,
                                        path['expected']))
        peak = torch.cuda.max_memory_allocated()
        dev_ms = device_ms(without_counting(lambda: profile_run(
            '%s step' % path['name'], lambda: exe.run(
                main, feed=path['batch'], fetch_list=[loss]))))
    med = statistics.median(secs[TRAIN_STEPS:]) * 1e3
    log('  %s: losses %s, accuracy %.4f (metrics.Accuracy over %d '
        'batches); step median %.3f ms over %d timed steps %s, %.0f '
        'images/s, device %.3f ms a profiled step; peak device memory '
        '%.3f GiB; launches %s' % (
            path['name'], ['%.5f' % x for x in losses], accuracy.eval(),
            len(losses), med, TIMED_STEPS,
            ['%.3f' % (x * 1e3) for x in secs[TRAIN_STEPS:]],
            LENET_BATCH / med * 1e3, dev_ms, peak / 2 ** 30,
            {k: c for k, c in launches.items() if c}))
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError('%s: loss %s not finite or not falling'
                             % (path['name'], losses))
    check_plain_lenet(path, grad_fetch, start, after1, losses[0], grads)
    return {'launches': launches, 'step_ms': med, 'path': path, 'exe': exe,
            'scope': scope}


def check_plain_lenet(path, grad_fetch, start, after1, loss1, grads):
    """Step 1 again from the same state with every kernel's plain
    version (K4's per-tensor adam lowering): the loss within LOSS_RTOL,
    each gradient within GRAD_TOL of its largest magnitude, and the
    state the step writes (Adam's moments; SGD's parameter change, -lr
    times the gradient) within GRAD_TOL of its largest.  cuDNN's
    backward may sum in another order from run to run, so this is not
    bitwise."""
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    flags.set_flags({'FLAGS_torch_kernels_plain': True})
    try:
        with fluid.scope_guard(scope):
            without_counting(lambda: exe.run(path['startup']))
            for n, v in start.items():
                scope.set_var(n, v.clone())
            out = without_counting(lambda: exe.run(
                path['main'], feed=path['batch'],
                fetch_list=[path['loss']] + grad_fetch))
            got = snapshot(scope, list(start))
    finally:
        flags.set_flags({'FLAGS_torch_kernels_plain': False})
    loss_err = abs(float(out[0]) - loss1) / abs(loss1)
    grad_err = max(max_abs(a, torch.from_numpy(b)) /
                   max(float(np.abs(b).max()), 1e-30)
                   for a, b in zip(grads, out[1:]))
    state_err = 0.0
    for n in start:
        if path['opt'] == 'adam' and '_moment' in n:
            a, b = after1[n], got[n]
        elif path['opt'] == 'sgd' and n in path['probe']:
            a, b = after1[n] - start[n], got[n] - start[n]
        else:
            continue
        state_err = max(state_err, max_abs(a, b) /
                        max(b.abs().max().item(), 1e-30))
    log('  %s step 1 vs the plain path: loss rel %.2e (limit %g), '
        'gradients rel %.2e, %s rel %.2e (limit %g)' % (
            path['name'], loss_err, LOSS_RTOL, grad_err,
            'moments' if path['opt'] == 'adam' else 'parameter changes',
            state_err, GRAD_TOL))
    if not (loss_err <= LOSS_RTOL and grad_err <= GRAD_TOL and
            state_err <= GRAD_TOL):
        raise AssertionError('%s step 1 disagrees with its plain path'
                             % path['name'])


def image_path(seed, model, batch, dev, bench=None):
    """ResNet-50 ('resnet') or SE-ResNeXt-50 ('se_resnext', cardinality
    32) with Momentum and L2Decay on CUDAPlace(0): the path dict, its
    for_test clone, and a batch of uniform [0, 1) images (as the JAX
    package's bench.py makes them) and labels from `seed`, on `dev`.
    With `bench` ('amp' or 'f32'), ResNet-50 as bench_resnet50 trains
    it: NHWC, Momentum without decay, under decorate for 'amp'."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed + 1
    layout = 'NHWC' if bench else 'NCHW'
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        if model == 'resnet':
            _, out, loss, acc = resnet.build(class_dim=IMAGE_CLASSES,
                                             data_format=layout)
        else:
            _, out, loss, acc = se_resnext.build(class_dim=IMAGE_CLASSES)
        test = main.clone(for_test=True)
        if bench:
            opt = fluid.optimizer.Momentum(IMAGE_LR, IMAGE_MOMENTUM)
            if bench == 'amp':
                opt = fluid.contrib.mixed_precision.decorate(
                    opt, use_dynamic_loss_scaling=True)
            opt.minimize(loss)
            # after minimize: the clone keeps the AMP marks
            test = main.clone(for_test=True)
        else:
            fluid.optimizer.Momentum(
                IMAGE_LR, IMAGE_MOMENTUM,
                regularization=fluid.regularizer.L2Decay(IMAGE_DECAY)
            ).minimize(loss)
    rng = np.random.RandomState(seed)
    shape = (batch, 224, 224, 3) if bench else (batch, 3, 224, 224)
    x = torch.from_numpy(rng.rand(*shape).astype('float32'))
    y = torch.from_numpy(rng.randint(0, IMAGE_CLASSES, (batch, 1)))
    stats = sorted(p.name for p in main.all_parameters()
                   if not p.trainable)
    name = 'ResNet-50' if model == 'resnet' else 'SE-ResNeXt-50'
    if bench:
        name += ' NHWC %s' % ('AMP' if bench == 'amp' else 'f32')
    return {'name': name,
            'main': main, 'startup': startup, 'test': test, 'loss': loss,
            'out': out, 'acc': acc, 'stats': stats,
            'batch': {'image': x.to(dev), 'label': y.to(dev)},
            'host_batch': {'image': x, 'label': y}}


def train_image(path, steps, timed, profile):
    """`steps` counted steps (no kernel of the port may launch), then
    `timed` timed ones; every moving mean and variance must change and
    the losses stay finite.  Returns the run."""
    main, loss = path['main'], path['loss']
    ops = main.global_block().ops
    params = [p for p in main.all_parameters() if p.trainable]
    log('  %s program: %d ops (%d conv2d, %d batch_norm, %d momentum), %d '
        'trainable parameters (%d elements), %d moving statistics' % (
            path['name'], len(ops), sum(op.type == 'conv2d' for op in ops),
            sum(op.type == 'batch_norm' for op in ops),
            sum(op.type == 'momentum' for op in ops), len(params),
            sum(int(np.prod(p.shape)) for p in params), len(path['stats'])))
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    names = weights.startup_names(path['startup'])
    want = dict({k: 0 for k in common.KERNELS}, **dropout_launches(main))
    batch = path['batch']['image'].shape[0]
    losses, secs = [], []
    with fluid.scope_guard(scope):
        exe.run(path['startup'])
        start = snapshot(scope, names)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for step in range(steps + timed):
            t0 = time.perf_counter()
            out, counts = counted(lambda: exe.run(
                main, feed=path['batch'], fetch_list=[loss, path['acc']]))
            secs.append(time.perf_counter() - t0)
            losses.append(float(out[0]))
            if counts != want:
                raise AssertionError('%s step %d launched %s: only the '
                                     'dropout kernels (%d each) are on this path'
                                     % (path['name'], step + 1, counts,
                                        want['dropout']))
            if step < steps:
                log('  step %d: loss %.5f, accuracy %.4f, %.1f ms' % (
                    step + 1, losses[-1], float(out[1]), secs[-1] * 1e3))
        peak = torch.cuda.max_memory_allocated()
        moved = [n for n in path['stats']
                 if not torch.equal(scope.find_var(n), start[n])]
        events = without_counting(lambda: profile_run(
            '%s step' % path['name'], lambda: exe.run(
                main, feed=path['batch'], fetch_list=[loss])))
        dev_ms = device_ms(events)
        if profile:
            log(events.table(sort_by='self_cuda_time_total', row_limit=20))
    med = statistics.median(secs[steps:] if timed else secs) * 1e3
    log('  %s: step %s %.2f ms%s, %.1f images/s, device %.2f ms a '
        'profiled step; peak device memory %.2f GiB; %d of %d moving '
        'statistics changed' % (
            path['name'], 'median' if timed else 'median of the counted',
            med, '' if not timed else ' over %d timed steps %s' % (
                timed, ['%.2f' % (x * 1e3) for x in secs[steps:]]),
            batch / med * 1e3, dev_ms, peak / 2 ** 30, len(moved),
            len(path['stats'])))
    if not all(np.isfinite(losses)):
        raise AssertionError('%s: loss %s not finite'
                             % (path['name'], losses))
    if len(moved) != len(path['stats']):
        raise AssertionError('%s: moving statistics not updated: %s' % (
            path['name'], sorted(set(path['stats']) - set(moved))[:5]))
    return {'exe': exe, 'scope': scope, 'start': start, 'step_ms': med,
            'peak': peak, 'device_ms': dev_ms, 'losses': losses}


def check_eval(path, run):
    """The for_test clone at RESNET_EVAL_BATCH: finite logits of the
    right shape, the same on a second run."""
    feed = {k: v[:RESNET_EVAL_BATCH] for k, v in path['batch'].items()}
    with fluid.scope_guard(run['scope']):
        outs = [without_counting(lambda: run['exe'].run(
            path['test'], feed=feed, fetch_list=[path['out']],
            return_numpy=False))[0] for _ in range(2)]
    shape = (RESNET_EVAL_BATCH, IMAGE_CLASSES)
    ok = tuple(outs[0].shape) == shape and \
        bool(torch.isfinite(outs[0]).all()) and torch.equal(*outs)
    log('  %s eval clone, batch %d: logits %s, finite and the same on a '
        'second run: %s' % (path['name'], RESNET_EVAL_BATCH,
                            list(outs[0].shape), ok))
    if not ok:
        raise AssertionError('%s eval clone: logits not finite, not %s or '
                             'not deterministic' % (path['name'], shape))


def check_card_against_cpu(path, start):
    """Step 1 at RESNET_CPU_BATCH from the same state and feed on
    CUDAPlace(0) and on CPUPlace(), in f32 and in float64 (the state and
    the images cast; the port keeps f64 in f64, cuDNN's convolutions
    included).  In f32 the card's loss is within LOSS_RTOL of the CPU's.
    In float64 the card computes the CPU's step: the loss and every
    variable of the state after the step (parameters, velocities, moving
    means and variances) within F64_TOL of their largest magnitude.  The
    f32 state is only printed, as each device's distance from the
    float64 step: the f32 gradients of ResNet-50 at batch 4 are not
    pinned down (relu inputs within f32 rounding of 0 fall on either
    side), so the CPU's own f32 velocities lie percents of their largest
    from the float64 ones (tests/torch_image_cases.py)."""
    feed32 = {k: v[:RESNET_CPU_BATCH].numpy()
              for k, v in path['host_batch'].items()}
    state32 = {n: core.to_numpy(v) for n, v in start.items()}
    names = sorted(state32)
    res = {}
    for dtype in (np.float32, np.float64):
        state = {n: v.astype(dtype) if v.dtype.kind == 'f' else v
                 for n, v in state32.items()}
        feed = dict(feed32, image=feed32['image'].astype(dtype))
        for dev_name, place in (('card', fluid.CUDAPlace(0)),
                                ('cpu', fluid.CPUPlace())):
            exe = fluid.Executor(place)
            scope = fluid.Scope()
            with fluid.scope_guard(scope):
                without_counting(lambda: exe.run(path['startup']))
                weights.load_numpy_params(scope, state, place)
                t0 = time.perf_counter()
                loss = float(without_counting(lambda: exe.run(
                    path['main'], feed=feed, fetch_list=[path['loss']]))[0])
                secs = time.perf_counter() - t0
                res[dev_name, dtype] = (loss, weights.numpy_state(
                    scope, names), secs)
    card32, cpu32 = res['card', np.float32], res['cpu', np.float32]
    card64, cpu64 = res['card', np.float64], res['cpu', np.float64]
    loss32 = abs(card32[0] - cpu32[0]) / abs(cpu32[0])
    loss64 = abs(card64[0] - cpu64[0]) / abs(cpu64[0])
    worst64, worst32 = {}, {}
    for n in names:
        ref = cpu64[1][n]
        if ref.dtype.kind != 'f':
            continue
        kind = ('velocity' if '_velocity_' in n else
                'stats' if n in path['stats'] else
                'param' if n + '_velocity_0' in cpu64[1] else None)
        if kind is None:
            continue
        top = max(float(np.abs(ref).max()), 1e-30)
        e64 = float(np.abs(card64[1][n] - ref).max()) / top
        if e64 >= worst64.get(kind, (-1.0,))[0]:
            worst64[kind] = (e64, n)
        e_card = float(np.abs(card32[1][n] - ref).max()) / top
        e_cpu = float(np.abs(cpu32[1][n] - ref).max()) / top
        if e_card >= worst32.get(kind, (-1.0,))[0]:
            worst32[kind] = (e_card, e_cpu, n)
    log('  %s step 1 at batch %d from the same state: f32 loss on the card '
        '%.6f (%.1f ms), on the CPU %.6f (%.1f ms), rel %.2e (limit %g); '
        'float64 loss %.9f (%.1f ms) / %.9f (%.1f ms), rel %.2e (limit %g)'
        % (path['name'], RESNET_CPU_BATCH, card32[0], card32[2] * 1e3,
           cpu32[0], cpu32[2] * 1e3, loss32, LOSS_RTOL, card64[0],
           card64[2] * 1e3, cpu64[0], cpu64[2] * 1e3, loss64, F64_TOL))
    for kind in sorted(worst64):
        e64, n64 = worst64[kind]
        e_card, e_cpu, n32 = worst32[kind]
        log('    %-8s float64 card vs CPU: worst %s %.2e of its largest '
            '(limit %g); f32 from the float64 step: worst %s, card %.2e, '
            'CPU %.2e' % (kind, n64, e64, F64_TOL, n32, e_card, e_cpu))
    if not (loss32 <= LOSS_RTOL and loss64 <= F64_TOL and
            max(w[0] for w in worst64.values()) <= F64_TOL):
        raise AssertionError('%s: the card\'s step 1 disagrees with the '
                             'CPU\'s' % path['name'])


def image_classification(seed, dev, profile):
    """Phase 10; returns LeNet-5 + Adam's K4 launches at the wrapper and
    replayed, as counted() added them to the main path's."""
    lenet_launches = {}
    for opt in ('adam', 'sgd'):
        path = lenet_path(seed, opt)
        log('[10] %s, batch %d, %d steps and %d timed' % (
            path['name'], LENET_BATCH, TRAIN_STEPS, TIMED_STEPS))
        before = (MAIN_LAUNCHES.get('fused_adam', 0),
                  MAIN_REPLAYED.get('fused_adam', 0))
        run = train_lenet(path)
        if opt == 'adam':
            lenet_k4 = (MAIN_LAUNCHES['fused_adam'] - before[0],
                        MAIN_REPLAYED['fused_adam'] - before[1])
        lenet_launches[opt] = run['launches']
        if opt == 'adam':
            without_counting(lambda: plan_cache_steps(run))
    want = TRAIN_STEPS + TIMED_STEPS
    if lenet_launches['adam']['fused_adam'] != want or \
            any(lenet_launches['sgd'].values()):
        raise AssertionError('LeNet-5 launched %s (Adam) and %s (SGD): '
                             'expected fused_adam %d times and nothing'
                             % (lenet_launches['adam'],
                                lenet_launches['sgd'], want))

    path = image_path(seed, 'resnet', RESNET_BATCH, dev)
    log('[10] %s, batch %d, 3 x 224 x 224 NCHW f32, %d classes, '
        'Momentum(%g, %g) with L2Decay(%g)' % (
            path['name'], RESNET_BATCH, IMAGE_CLASSES, IMAGE_LR,
            IMAGE_MOMENTUM, IMAGE_DECAY))
    run = train_image(path, TRAIN_STEPS, TIMED_STEPS, profile)
    F32_RUNS['resnet50'] = dict(
        phase=10, step_ms=run['step_ms'],
        rate=RESNET_BATCH / run['step_ms'] * 1e3, unit='images',
        device_ms=run['device_ms'], peak=run['peak'])
    check_eval(path, run)
    run['path'] = path
    without_counting(lambda: plan_cache_steps(run))
    start = run['start']
    del run
    torch.cuda.empty_cache()
    check_card_against_cpu(path, start)
    del path, start
    torch.cuda.empty_cache()

    path = image_path(seed, 'se_resnext', SE_BATCH, dev)
    log('[10] %s (cardinality 32), batch %d, Momentum(%g, %g) with '
        'L2Decay(%g)' % (path['name'], SE_BATCH, IMAGE_LR, IMAGE_MOMENTUM,
                         IMAGE_DECAY))
    run = train_image(path, TRAIN_STEPS, 0, profile)
    run['path'] = path
    without_counting(lambda: plan_cache_steps(run))
    del path, run
    torch.cuda.empty_cache()
    return lenet_k4


# ----------------------------------------------------------- phase 11
def nmt_program(seed):
    """Transformer-base NMT training with Adam (phase 11): the path dict
    that train() runs."""
    cfg = transformer.BASE
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed + 1
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        _, _, loss = transformer.build(cfg, src_len=NMT_LEN, tgt_len=NMT_LEN)
        fluid.optimizer.Adam(learning_rate=NMT_LR,
                             epsilon=EPSILON).minimize(loss)
    expected = {k: 0 for k in common.KERNELS}
    expected.update({'embedding_lookup': 2, 'embedding_scatter_add': 2,
                     'fused_adam': 1, **dropout_launches(main)})
    probe = ['embedding_0.w_0', 'embedding_1.w_0', 'fc_0.w_0']
    probe += [p.name for p in main.all_parameters()
              if p.shape == (cfg.d_model, cfg.tgt_vocab)]
    return {'name': 'Transformer-base Adam', 'main': main,
            'startup': startup, 'loss': loss, 'lr': None,
            'batch': transformer.synthetic_batch(
                cfg, NMT_BATCH, NMT_LEN, NMT_LEN,
                np.random.RandomState(seed)),
            'expected': expected, 'probe': probe,
            'tokens': NMT_BATCH * NMT_LEN, 'rate': NMT_LR, 'bitwise': False}


def bucket_step(run, seed):
    """One step of the NMT_BUCKET bucket on the Program built for
    NMT_LEN, on the path's executor after its steps: its launches
    checked, the loss finite, the step against the plain path."""
    path = run['path']
    main = path['main']
    batch = transformer.synthetic_batch(
        transformer.BASE, NMT_BATCH, NMT_BUCKET, NMT_BUCKET,
        np.random.RandomState(seed + 1))
    names = weights.startup_names(path['startup'])
    fetch = [path['loss'].name] + [main._grad_name_map[p]
                                   for p in path['probe']]
    with fluid.scope_guard(run['scope']):
        start = snapshot(run['scope'], names)
        step = run['exe']._step
        t0 = time.perf_counter()
        out, counts = counted(lambda: run['exe'].run(
            main, feed=batch, fetch_list=fetch, return_numpy=False))
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        after = snapshot(run['scope'], names)
    loss = float(out[0])
    log('  bucket %d step (batch %d, %d target tokens): loss %.6f, %.1f ms, '
        'launches %s' % (NMT_BUCKET, NMT_BATCH, NMT_BATCH * NMT_BUCKET, loss,
                         sec * 1e3, {k: c for k, c in counts.items() if c}))
    if counts != path['expected'] or not math.isfinite(loss):
        raise AssertionError('the bucket step launched %s (expected %s), '
                             'loss %g' % (counts, path['expected'], loss))
    check_plain_step(path, fetch, start, after, loss,
                     [g.clone() for g in out[1:]], None, batch=batch,
                     step=step)
    return counts


def short_attention(seed):
    """Phase 11: BERT-base served and trained at seq 128 and
    Transformer-base trained, all through the naive attention chain,
    each with a profiled request or step."""
    launches = {k: 0 for k in common.KERNELS}
    log('[11] BERT-base seq %d serving through create_paddle_predictor'
        % SHORT_SEQ)
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory(
            dir=os.path.join(ROOT, 'build', 'chip_smoke')) as model_dir:
        cfg, n_attn, n_emb, _ = build_model(model_dir, seed, SHORT_SEQ,
                                            pretrain=True)
        if n_attn:
            raise AssertionError('seq %d built %d fused attention ops'
                                 % (SHORT_SEQ, n_attn))
        pred, requests, served, replayed = serve(
            model_dir, cfg, 0, n_emb, seed, SHORT_SEQ, SHORT_BATCHES)
    for k, c in served.items():
        launches[k] += c
    without_counting(lambda: request_latency(pred, requests, 0, n_emb))
    log('  peak device memory while serving: %.2f GiB'
        % (torch.cuda.max_memory_allocated() / 2 ** 30))
    without_counting(lambda: profile_requests(pred, requests))
    del pred
    torch.cuda.empty_cache()

    for path in (pretrain_program(seed, 'adam', SHORT_SEQ,
                                  SHORT_TRAIN_BATCH), nmt_program(seed)):
        log('[11] %s training steps on CUDAPlace(0)' % path['name'])
        run = train(path)
        for k, c in run['launches'].items():
            launches[k] += c
        if path['name'].startswith('Transformer'):
            for k, c in bucket_step(run, seed).items():
                launches[k] += c
        med = without_counting(lambda: train_step_ms(run))
        dev_ms = without_counting(lambda: profile_train(run))
        if not path['name'].startswith('Transformer'):
            F32_RUNS['bert128'] = step_numbers(11, run, med, dev_ms)
        without_counting(lambda: plan_cache_steps(
            run, required=path['name'].startswith('Transformer')))
        del run
        torch.cuda.empty_cache()
    log('  launches + replayed on phase 11\'s paths: %s; replayed while '
        'serving: %s' % ({k: c for k, c in launches.items() if c},
                         {k: c for k, c in replayed.items() if c}))


# ----------------------------------------------------------- phase 12
def dp_program(main, loss, reduce):
    """main made with_data_parallel, under ReduceStrategy.Reduce (the
    sharded optimizer state) with `reduce`."""
    bs = fluid.BuildStrategy()
    if reduce:
        bs.reduce_strategy = fluid.BuildStrategy.ReduceStrategy.Reduce
    return fluid.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name, build_strategy=bs)


def dp_bert(seed):
    """Phase 12's BERT-base pretraining at seq 512: phase 5's program
    with the hidden dropout at 0 and the attention dropout at RATE (the
    masks a one-replica step can share): (main, startup, loss, cfg,
    the launches a step)."""
    cfg = bert.BertConfig(dropout=0.0, attn_dropout=RATE)
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed + 1
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        _, _, loss = bert.build_pretrain(cfg, seq_len=SEQ)
        fluid.optimizer.Adam(learning_rate=LR, epsilon=EPSILON).minimize(loss)
    n_attn = sum(op.type == 'fused_multihead_attention'
                 for op in main.global_block().ops)
    expected = {k: 0 for k in common.KERNELS}
    expected.update({'flash_attention': n_attn, 'flash_attention_bwd': n_attn,
                     'embedding_lookup': 3, 'embedding_scatter_add': 3,
                     'fused_adam': 1, **dropout_launches(main)})
    return main, startup, loss, cfg, expected


def state_kind(name, stats):
    return ('velocity' if '_velocity_' in name else
            'moment' if '_moment' in name else
            'stats' if name in stats else 'param')


def worst_distance(got, want, names, stats=()):
    """{kind: (max|got - want| / max|want|, name)} over `names`."""
    worst = {}
    for n in names:
        if not want[n].is_floating_point() or want[n].numel() <= 1:
            continue
        d = max_abs(got[n].to(want[n].device), want[n]) / max(
            want[n].abs().max().item(), 1e-30)
        kind = state_kind(n, stats)
        if d >= worst.get(kind, (-1.0,))[0]:
            worst[kind] = (d, n)
    return worst


def top_host(events, n=6):
    """The n host ops of a profile with the most self CPU time, with
    their ms and calls."""
    from torch.autograd import DeviceType
    rows = sorted((e for e in events if e.device_type == DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)[:n]
    return ', '.join('%s %.1f ms (%d)' % (e.key, e.self_cpu_time_total / 1e3,
                                          e.count) for e in rows)


def dp_world_one(seed, dev):
    """Phase 12 in this process, which has no process group: ResNet-50
    and BERT-base through with_data_parallel (one replica) against
    Executor.run of the same Program from the same state, bitwise (all
    steps counted: each drives the main path's entry points)."""
    path = image_path(seed, 'resnet', RESNET_BATCH, dev)
    log('[12] with_data_parallel at world size 1 on CUDAPlace(0): '
        '%s, batch %d, %d steps, against Executor.run' % (
            path['name'], RESNET_BATCH, TRAIN_STEPS))
    names = weights.startup_names(path['startup'])
    none = {k: 0 for k in common.KERNELS}
    runs = {}
    start = None
    # cuDNN's deterministic algorithms, so that two runs of one step
    # can be held bit for bit
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for mode in ('Executor.run', 'with_data_parallel'):
            exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
            prog = path['main'] if mode == 'Executor.run' else \
                dp_program(path['main'], path['loss'], False)
            with fluid.scope_guard(scope):
                exe.run(path['startup'])
                if start is None:
                    start = snapshot(scope, names)
                for n, v in start.items():
                    scope.set_var(n, v.clone())
                losses = []
                for _ in range(TRAIN_STEPS):
                    out, counts = counted(lambda: exe.run(
                        prog, feed=path['batch'], fetch_list=[path['loss']],
                        return_numpy=False))
                    losses.append(out[0].clone())
                    if counts != none:
                        raise AssertionError('ResNet-50 launched %s'
                                             % counts)
                runs[mode] = (losses, snapshot(scope, names))
            del exe, scope
    finally:
        torch.backends.cudnn.deterministic = saved
    a, b = runs['Executor.run'], runs['with_data_parallel']
    same = all(torch.equal(x, y) for x, y in zip(a[0], b[0]))
    differ = [n for n in names if not torch.equal(a[1][n], b[1][n])]
    log('  %s: losses %s, %s; the state after %d steps (%d variables: '
        'parameters, velocities, moving statistics) %s' % (
            path['name'], ['%.6f' % float(x) for x in b[0]],
            'bitwise Executor.run\'s' if same else 'NOT Executor.run\'s',
            TRAIN_STEPS, len(names),
            'bitwise equal' if not differ else 'differs in %s' % differ[:5]))
    if not same or differ:
        raise AssertionError('with_data_parallel at world size 1 is not '
                             'bitwise Executor.run (ResNet-50)')
    del path, runs, start, a, b
    torch.cuda.empty_cache()

    main, startup, loss, cfg, expected = dp_bert(seed)
    log('[12] BERT-base seq %d, batch %d, ReduceStrategy.Reduce at world '
        'size 1: 1 step against Executor.run' % (SEQ, TRAIN_BATCH))
    batch = bert.synthetic_batch(cfg, TRAIN_BATCH, SEQ,
                                 np.random.RandomState(seed))
    names = weights.startup_names(startup)
    res = {}
    start = None
    for mode in ('Executor.run', 'with_data_parallel'):
        exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
        prog = main if mode == 'Executor.run' else dp_program(main, loss,
                                                              True)
        with fluid.scope_guard(scope):
            exe.run(startup)
            if start is None:
                start = snapshot(scope, names)
            for n, v in start.items():
                scope.set_var(n, v.clone())
            out, counts = counted(lambda: exe.run(
                prog, feed=batch, fetch_list=[loss], return_numpy=False))
            if counts != expected:
                raise AssertionError('BERT-base %s launched %s, expected %s'
                                     % (mode, counts, expected))
            res[mode] = (out[0].clone(), snapshot(scope, names))
        del exe, scope
    a, b = res['Executor.run'], res['with_data_parallel']
    differ = [n for n in names if not torch.equal(a[1][n], b[1][n])]
    same = torch.equal(a[0], b[0])
    log('  loss %.6f, %s; the state after the step (%d variables) %s; '
        'launches a step %s' % (
            float(b[0]), 'bitwise Executor.run\'s' if same else
            'NOT Executor.run\'s', len(names), 'bitwise equal' if not differ
            else 'differs in %s' % differ[:5],
            {k: c for k, c in expected.items() if c}))
    if not same or differ:
        raise AssertionError('with_data_parallel at world size 1 is not '
                             'bitwise Executor.run (BERT-base)')


def dp_resnet_f64(path, start, rank, n, place, group, say):
    """ResNet-50's data-parallel step 1 in float64 (the state and the
    images cast; the port keeps f64 in f64, cuDNN's convolutions and the
    collectives included) on RESNET_CPU_BATCH images a rank, against one
    replica of the n * RESNET_CPU_BATCH images on rank 0: the loss and
    every parameter, velocity and moving statistic within F64_TOL of
    their largest.  Returns rank 0's distances."""
    main, loss = path['main'], path['loss']
    names = sorted(start)
    feed = {'image': path['batch']['image'][:n * RESNET_CPU_BATCH].double(),
            'label': path['batch']['label'][:n * RESNET_CPU_BATCH]}
    rows = {k: v[rank * RESNET_CPU_BATCH:(rank + 1) * RESNET_CPU_BATCH]
            for k, v in feed.items()}
    state = {k: v.double() if v.is_floating_point() else v
             for k, v in start.items()}

    def step(prog, batch):
        exe, scope = fluid.Executor(place), fluid.Scope()
        with fluid.scope_guard(scope):
            exe.run(path['startup'])
            for name, v in state.items():
                scope.set_var(name, v.clone())
            got = float(exe.run(prog, feed=batch, fetch_list=[loss])[0])
            return got, snapshot(scope, names)

    l_dp, after = step(dp_program(main, loss, False), rows)
    res = None
    if rank == 0:
        l_one, one = step(main, feed)
        loss_rel = abs(l_dp - l_one) / abs(l_one)
        worst = worst_distance(after, one, names, path['stats'])
        say('ResNet-50 step 1 in float64, batch %d a rank, against one '
            'replica of batch %d: loss rel %.2e; %s (limit %g of the '
            'largest)', RESNET_CPU_BATCH, n * RESNET_CPU_BATCH, loss_rel,
            ', '.join('%s %.2e (%s)' % (k, d, nm) for k, (d, nm)
                      in sorted(worst.items())), F64_TOL)
        res = {'loss_rel': loss_rel,
               'worst': {k: d for k, (d, _) in worst.items()}}
        if not (loss_rel <= F64_TOL and
                max(d for d, _ in worst.values()) <= F64_TOL):
            raise AssertionError('ResNet-50 data-parallel step 1 in float64 '
                                 'disagrees with one replica')
    dist.barrier(group=group)
    return res


def dp_ranks_phase12(args, group, rank, n, place, dev, say):
    """Phase 12 on this rank (after phase 9, in the same job): ResNet-50
    and BERT-base under with_data_parallel, each rank fed its rows of
    the global batch; returns this rank's numbers."""
    from paddle_tpu_torch.fluid import parallel_executor as pe
    rep = registry.Replica(group, rank, n)
    out = {}
    if rank == 0:
        log('[12] with_data_parallel on %d ranks over %s (%s | %s): '
            'ResNet-50 at batch %d a rank, then BERT-base seq %d under '
            'ReduceStrategy.Reduce at batch %d a rank' % (
                n, dist.get_backend(group), torch.cuda.get_device_name(dev),
                card_line(), RESNET_BATCH // n, SEQ, DP_BERT_BATCH))

    # ResNet-50: global batch RESNET_BATCH, RESNET_BATCH / n a rank
    path = image_path(args.seed, 'resnet', RESNET_BATCH, dev)
    main, loss, startup = path['main'], path['loss'], path['startup']
    local = RESNET_BATCH // n
    feed = {k: v[rank * local:(rank + 1) * local]
            for k, v in path['batch'].items()}
    names = weights.startup_names(startup)
    prog = dp_program(main, loss, False)
    none = {k: 0 for k in common.KERNELS}
    exe, scope = fluid.Executor(place), fluid.Scope()
    losses, secs = [], []
    with fluid.scope_guard(scope):
        exe.run(startup)
        start = snapshot(scope, names)
        if not params_in_sync(scope, names, group, dev):
            raise AssertionError('the ranks start from different states')
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for step in range(TRAIN_STEPS + TIMED_STEPS):
            t0 = time.perf_counter()
            got, counts = counted(lambda: exe.run(
                prog, feed=feed, fetch_list=[loss], return_numpy=False))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            if counts != none:
                raise AssertionError('ResNet-50 launched %s' % counts)
            if step >= TRAIN_STEPS:
                continue
            losses.append(float(got[0]))
            in_sync = without_counting(
                lambda: params_in_sync(scope, names, group, dev))
            if step == 0:
                after1 = snapshot(scope, names)
            say('ResNet-50 step %d: loss %.6f (the global batch\'s), %.1f '
                'ms, the ranks\' states (%d variables) bitwise equal %s',
                step + 1, losses[-1], secs[-1] * 1e3, len(names), in_sync)
            if not in_sync:
                raise AssertionError('the ranks\' ResNet-50 states differ '
                                     'after step %d' % (step + 1))
        peak = torch.cuda.max_memory_allocated(dev)
        grads = [torch.zeros(p.shape, device=dev)
                 for p in main.all_parameters() if p.trainable]
        events = without_counting(lambda: profile_run(
            'rank %d ResNet-50 data-parallel step' % rank, lambda: exe.run(
                prog, feed=feed, fetch_list=[loss])))
        say('ResNet-50 step: device %.2f ms; host: %s', device_ms(events),
            top_host(events))
    del exe, scope
    step_ms = statistics.median(secs[TRAIN_STEPS:]) * 1e3
    ar_ms = collective_ms(lambda: pe.average(grads, rep), group)
    say('ResNet-50: step median %.2f ms over %d timed steps %s, %.1f '
        'images/s on this rank; the gradient all-reduce alone (%d tensors, '
        '%.1f MB f32, flat buckets) %.2f ms; peak %.2f GiB', step_ms,
        TIMED_STEPS, ['%.1f' % (x * 1e3) for x in secs[TRAIN_STEPS:]],
        local / step_ms * 1e3, len(grads),
        sum(g.numel() for g in grads) * 4 / 1e6, ar_ms, peak / 2 ** 30)
    out['resnet'] = {'losses': losses, 'step_ms': step_ms, 'peak': peak,
                     'allreduce_ms': ar_ms, 'images': local}
    del grads
    torch.cuda.empty_cache()
    if rank == 0:
        # one replica of the global batch from the same state
        ex1, sc1 = fluid.Executor(place), fluid.Scope()
        with fluid.scope_guard(sc1):
            ex1.run(startup)
            for name, v in start.items():
                sc1.set_var(name, v.clone())
            l1 = float(without_counting(lambda: ex1.run(
                main, feed=path['batch'], fetch_list=[loss]))[0])
            one = snapshot(sc1, names)
        del ex1, sc1
        loss_rel = abs(losses[0] - l1) / abs(l1)
        worst = worst_distance(after1, one, names, path['stats'])
        say('ResNet-50 step 1 against one replica of batch %d from the same '
            'state, f32: loss %.6f vs %.6f, rel %.2e (limit %g); moving '
            'statistics %.2e of their largest (limit %g); parameters %.2e, '
            'velocities %.2e (not held in f32: relu inputs within f32 '
            'rounding of 0 fall on either side, phase 10)', RESNET_BATCH,
            losses[0], l1, loss_rel, LOSS_RTOL, worst['stats'][0],
            DP_STATE_TOL, worst['param'][0], worst['velocity'][0])
        out['resnet']['one_replica'] = {'loss_rel': loss_rel, 'worst': {
            k: d for k, (d, _) in worst.items()}}
        if not (loss_rel <= LOSS_RTOL and
                worst['stats'][0] <= DP_STATE_TOL):
            raise AssertionError('ResNet-50 data-parallel step 1 disagrees '
                                 'with one replica of the global batch')
        del one
    del feed, after1, prog
    torch.cuda.empty_cache()
    out['resnet']['f64'] = dp_resnet_f64(path, start, rank, n, place,
                                         group, say)
    del path, start
    torch.cuda.empty_cache()
    dist.barrier(group=group)

    # BERT-base under Reduce: global batch n * DP_BERT_BATCH
    main, startup, loss, cfg, expected = dp_bert(args.seed)
    gbatch = bert.synthetic_batch(cfg, n * DP_BERT_BATCH, SEQ,
                                  np.random.RandomState(args.seed))
    feed = {k: v[rank * DP_BERT_BATCH:(rank + 1) * DP_BERT_BATCH]
            for k, v in gbatch.items()}
    names = weights.startup_names(startup)
    params = sorted(p.name for p in main.all_parameters())
    block = main.global_block()
    # one AllReduce-strategy step's peak (its second step: the first
    # makes the moments' shards under Reduce)
    exe, scope = fluid.Executor(place), fluid.Scope()
    prog = dp_program(main, loss, False)
    with fluid.scope_guard(scope):
        exe.run(startup)
        start = snapshot(scope, names)
        without_counting(lambda: exe.run(prog, feed=feed, fetch_list=[loss]))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        without_counting(lambda: exe.run(prog, feed=feed, fetch_list=[loss]))
        peak_ar = torch.cuda.max_memory_allocated(dev)
    del exe, scope, prog
    torch.cuda.empty_cache()

    exe, scope = fluid.Executor(place), fluid.Scope()
    prog = dp_program(main, loss, True)
    losses, secs = [], []
    launches = {k: 0 for k in common.KERNELS}
    with fluid.scope_guard(scope):
        exe.run(startup)
        for name, v in start.items():
            scope.set_var(name, v.clone())
        torch.cuda.synchronize()
        for step in range(TRAIN_STEPS):
            if step == 1:
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            got, counts = counted(lambda: exe.run(
                prog, feed=feed, fetch_list=[loss], return_numpy=False))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            losses.append(float(got[0]))
            for k, c in counts.items():
                launches[k] += c
            in_sync = without_counting(
                lambda: params_in_sync(scope, params, group, dev))
            if step == 0:
                # on the host, so that the peak below is the step's
                step1 = exe._step
                after1 = {name: pe.whole_value(scope.find_var(name)).to(
                    'cpu', copy=True) for name in names}
            say('BERT-base Reduce step %d: loss %.6f, %.1f ms, launches %s, '
                'parameters bitwise equal on the ranks %s', step + 1,
                losses[-1], secs[-1] * 1e3,
                {k: c for k, c in counts.items() if c}, in_sync)
            if counts != expected:
                raise AssertionError('step %d launched %s, expected %s'
                                     % (step + 1, counts, expected))
            if not in_sync:
                raise AssertionError('the ranks\' BERT-base parameters '
                                     'differ after step %d' % (step + 1))
        peak = torch.cuda.max_memory_allocated(dev)
        halved, whole = 0, 0
        for name in names:
            if '_moment' not in name:
                continue
            full = tuple(block.var(name).shape)
            held = tuple(scope.find_var(name).shape)
            shard = full[0] > 1 and full[0] % n == 0
            want = (full[0] // n,) + full[1:] if shard else full
            if held != want:
                raise AssertionError('%s holds %s on rank %d, expected %s'
                                     % (name, held, rank, want))
            halved += shard
            whole += not shard
        events = without_counting(lambda: profile_run(
            'rank %d BERT-base Reduce step' % rank, lambda: exe.run(
                prog, feed=feed, fetch_list=[loss])))
        say('BERT-base Reduce step: device %.2f ms; host: %s',
            device_ms(events), top_host(events))
    del exe, scope, prog
    torch.cuda.empty_cache()
    step_ms = statistics.median(secs[1:]) * 1e3
    say('BERT-base Reduce: %d moments hold 1/%d of their rows, %d whole; '
        'step median %.2f ms (steps 2-%d), %.0f tokens/s on this rank; peak '
        '%.2f GiB (steps 2-%d) against %.2f GiB under AllReduce: %.2f GiB '
        'less', halved, n, whole, step_ms, TRAIN_STEPS,
        DP_BERT_BATCH * SEQ / step_ms * 1e3, peak / 2 ** 30, TRAIN_STEPS,
        peak_ar / 2 ** 30, (peak_ar - peak) / 2 ** 30)
    # this rank's K1 mask of step 1's first attention op, read back
    op = [o for o in block.ops if o.type == 'fused_multihead_attention'][0]
    seed = registry.LowerCtx(step1, op.attrs['__op_seed__']).dropout_seed(
        op.attrs)
    h = cfg.heads
    keep = without_counting(lambda: kernel_keep_mask(
        DP_BERT_BATCH, h, SEQ, seed, dev, rank * DP_BERT_BATCH * h))
    want = fa_k.dropout_keep_plain(seed, n * DP_BERT_BATCH, h, SEQ, SEQ,
                                   RATE, dev)[rank * DP_BERT_BATCH:
                                              (rank + 1) * DP_BERT_BATCH]
    mask_ok = torch.equal(keep, want)
    say('K1\'s keep mask of step 1 at head offset %d: bitwise rows %d-%d '
        'of the global batch\'s dropout_keep_plain %s (keep rate %.4f)',
        rank * DP_BERT_BATCH * h, rank * DP_BERT_BATCH,
        (rank + 1) * DP_BERT_BATCH - 1, mask_ok, keep.float().mean().item())
    if not mask_ok:
        raise AssertionError('K1\'s mask on rank %d is not its rows of the '
                             'global batch\'s' % rank)
    del keep, want
    out['bert'] = {'losses': losses, 'step_ms': step_ms, 'peak': peak,
                   'peak_allreduce': peak_ar, 'launches': launches,
                   'tokens': DP_BERT_BATCH * SEQ, 'halved': halved}
    if rank == 0:
        ex1, sc1 = fluid.Executor(place), fluid.Scope()
        with fluid.scope_guard(sc1):
            ex1.run(startup)
            for name, v in start.items():
                sc1.set_var(name, v.clone())
            l1 = float(without_counting(lambda: ex1.run(
                main, feed=gbatch, fetch_list=[loss]))[0])
            one = snapshot(sc1, names)
        del ex1, sc1
        loss_rel = abs(losses[0] - l1) / abs(l1)
        worst = worst_distance(after1, one, names)
        say('BERT-base Reduce step 1 against one replica of batch %d with '
            'the same masks: loss %.6f vs %.6f, rel %.2e (limit %g); %s '
            '(limit %g of the largest)', n * DP_BERT_BATCH, losses[0], l1,
            loss_rel, LOSS_RTOL, ', '.join(
                '%s %.2e (%s)' % (k, d, nm) for k, (d, nm)
                in sorted(worst.items())), DP_STATE_TOL)
        out['bert']['one_replica'] = {'loss_rel': loss_rel, 'worst': {
            k: d for k, (d, _) in worst.items()}}
        if not (loss_rel <= LOSS_RTOL and
                max(d for d, _ in worst.values()) <= DP_STATE_TOL):
            raise AssertionError('BERT-base Reduce step 1 disagrees with '
                                 'one replica of the global batch')
    dist.barrier(group=group)
    return out


# ----------------------------------------------------------- phase 13
def step_numbers(phase, run, step_ms, dev_ms):
    """A training run's step ms, rate, device ms and peak memory, as
    side_by_side prints them."""
    path = run['path']
    return dict(phase=phase, step_ms=step_ms,
                rate=path['tokens'] / step_ms * 1e3,
                unit=path.get('unit', 'tokens'), device_ms=dev_ms,
                peak=run['peak'])


def flash_counted(fn):
    """(fn(), what it ran per kernel, the flash kernels' launches by
    route (FLASH_ROWS), at the wrappers plus replayed) as counted()
    gives them."""
    out, counts = counted(fn)
    rows = ran_by_row()
    return out, counts, {r: rows[r] for r in FLASH_ROWS}


def amp_bert_path(seed, seq, batch):
    """BERT-base pretraining under decorate(Adam(AMP_LR)) with dynamic
    loss scaling, as bench.py trains it, and the for_test clone of its
    Program (the AMP marks kept, attention dropout off)."""
    cfg = bert.BASE
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed + 1
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        _, _, loss = bert.build_pretrain(cfg, seq_len=seq)
        fluid.contrib.mixed_precision.decorate(
            fluid.optimizer.Adam(AMP_LR),
            use_dynamic_loss_scaling=True).minimize(loss)
    test = main.clone(for_test=True)
    n_attn = sum(op.type == 'fused_multihead_attention'
                 for op in main.global_block().ops)
    expected = {k: 0 for k in common.KERNELS}
    expected.update({'flash_attention': n_attn,
                     'flash_attention_bwd': n_attn, 'embedding_lookup': 3,
                     'embedding_scatter_add': 3, 'fused_adam': 1,
                     **dropout_launches(main)})
    decoder = [p.name for p in main.all_parameters()
               if p.shape == (cfg.hidden, cfg.vocab_size)][0]
    return {'name': 'BERT-base AMP Adam seq %d' % seq, 'main': main,
            'startup': startup, 'test': test, 'loss': loss, 'lr': None,
            'batch': bert.synthetic_batch(cfg, batch, seq,
                                          np.random.RandomState(seed)),
            'expected': expected, 'n_attn': n_attn, 'decoder': decoder,
            'probe': ['embedding_0.w_0', 'fc_0.w_0', 'layer_norm_0.w_0',
                      decoder],
            'tokens': batch * seq, 'rate': AMP_LR, 'bitwise': False,
            'mask_op': mask_probe(main) if seq == SEQ else None}


def amp_train(path):
    """TRAIN_STEPS steps of an AMP path on CUDAPlace(0): each step's
    launches exact (every flash launch on the bf16 route), finite losses,
    no overflow (the scale stays, the good-step counter counts the
    steps); step 1 against the plain path (amp_plain_step).  Returns the
    run, with the flash launches by route."""
    main, startup, loss = path['main'], path['startup'], path['loss']
    params = main.all_parameters()
    log('  %s program: %d ops, %d parameters (%d elements), %d marked '
        '__amp__, %d __amp_gray__, %d black' % (
            path['name'], len(main.global_block().ops), len(params),
            sum(int(np.prod(p.shape)) for p in params),
            *[sum(bool(op.attrs.get(m)) for op in main.global_block().ops)
              for m in ('__amp__', '__amp_gray__', '__amp_black__')]))
    state_names = weights.startup_names(startup)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    grad_fetch = [main._grad_name_map[p] for p in path['probe']]
    mask_op = path['mask_op']
    mask_fetch = probe_fetch(mask_op) if mask_op else []
    launches = {k: 0 for k in common.KERNELS}
    flash = dict.fromkeys(FLASH_ROWS, 0)
    losses = []
    with fluid.scope_guard(scope):
        exe.run(startup)
        start = snapshot(scope, state_names)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for step in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            out, counts, rows = flash_counted(lambda: exe.run(
                main, feed=path['batch'],
                fetch_list=[loss] + (grad_fetch + mask_fetch if step == 0
                                     else []),
                return_numpy=False))
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            losses.append(float(out[0]))
            if step == 0:
                grads = [g.clone() for g in out[1:1 + len(grad_fetch)]]
                if mask_op:
                    check_fetched_mask(exe, main, mask_op, out[-3:],
                                       torch.bfloat16)
                after1 = snapshot(scope, state_names)
                dtypes = {'loss': out[0].dtype,
                          'gradients': sorted({str(g.dtype) for g in grads})}
            for k, c in counts.items():
                launches[k] += c
            for k, c in rows.items():
                flash[k] += c
            log('  step %d: loss %.6f, %.1f ms, launches %s, flash by route '
                '%s' % (step + 1, losses[-1], ms,
                        {k: c for k, c in counts.items() if c},
                        {k: c for k, c in rows.items() if c}))
            want_rows = dict.fromkeys(FLASH_ROWS, 0)
            want_rows['flash_attention[bf16,dropout]'] = path['n_attn']
            want_rows['flash_attention_bwd[bf16]'] = path['n_attn']
            if counts != path['expected'] or rows != want_rows:
                raise AssertionError('step %d launched %s (%s), expected %s '
                                     '(%s)' % (step + 1, counts, rows,
                                               path['expected'], want_rows))
        peak = torch.cuda.max_memory_allocated()
        scale = {n: scope.find_var(n).tolist() for n in SCALE_STATE}
    log('  losses %s (f32 %s, gradients %s); peak device memory %.2f GiB; '
        'loss scaling %s' % (['%.6f' % x for x in losses], dtypes['loss'],
                             dtypes['gradients'], peak / 2 ** 30, scale))
    if not all(np.isfinite(losses)) or dtypes['loss'] != torch.float32 or \
            dtypes['gradients'] != ['torch.float32']:
        raise AssertionError('%s: losses %s not finite, or the loss or the '
                             'master gradients not f32 (%s)'
                             % (path['name'], losses, dtypes))
    if scale != {'loss_scaling_0': [2.0 ** 15],
                 'good_steps_0': [TRAIN_STEPS], 'bad_steps_0': [0]}:
        raise AssertionError('%s: loss scaling %s after %d good steps'
                             % (path['name'], scale, TRAIN_STEPS))
    amp_plain_step(path, [loss.name] + grad_fetch, start, after1, losses[0],
                   grads)
    return {'path': path, 'exe': exe, 'scope': scope, 'launches': launches,
            'flash': flash, 'peak': peak, 'start': start}


def amp_plain_step(path, fetch, start, after1, loss1, grads):
    """Step 1 again from the same state and step counter with every
    kernel's plain version (the plain bf16 K1 and K2 among them): the
    loss within AMP_LOSS_RTOL, the probed gradients and both moments of
    every parameter within AMP_GRAD_TOL of their largest, the loss scale
    and its counters bitwise."""
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    flags.set_flags({'FLAGS_torch_kernels_plain': True})
    try:
        with fluid.scope_guard(scope):
            without_counting(lambda: exe.run(path['startup']))
            exe._step = 1
            for n, v in start.items():
                scope.set_var(n, v.clone())
            out = without_counting(lambda: exe.run(
                path['main'], feed=path['batch'], fetch_list=fetch,
                return_numpy=False))
            torch.cuda.synchronize()
            got = snapshot(scope, list(start))
    finally:
        flags.set_flags({'FLAGS_torch_kernels_plain': False})
    loss_err = abs(float(out[0]) - loss1) / abs(loss1)
    grad_err = max(max_abs(a, b) / b.abs().max().item()
                   for a, b in zip(grads, out[1:]))
    moment_err = max(max_abs(after1[n], got[n]) /
                     max(got[n].abs().max().item(), 1e-30)
                     for n in start if '_moment' in n)
    scale_same = all(torch.equal(after1[n], got[n]) for n in SCALE_STATE)
    log('  step 1 vs the plain path: loss rel %.2e (limit %g), gradients '
        'of %s rel %.2e, moments rel %.2e (limit %g), loss scaling %s'
        % (loss_err, AMP_LOSS_RTOL, path['probe'], grad_err, moment_err,
           AMP_GRAD_TOL, 'bitwise' if scale_same else 'DIFFERS'))
    if not (loss_err <= AMP_LOSS_RTOL and grad_err <= AMP_GRAD_TOL and
            moment_err <= AMP_GRAD_TOL and scale_same):
        raise AssertionError('%s: step 1 disagrees with its plain path'
                             % path['name'])


def amp_numbers(run):
    """Step ms (median of TIMED_STEPS), rate, a profiled step's device
    time and the peak memory of a training run."""
    med = without_counting(lambda: train_step_ms(run))
    dev_ms = without_counting(lambda: step_device_ms(run))
    return step_numbers(13, run, med, dev_ms)


def side_by_side(name, amp, f32, card):
    """One line: the AMP path's numbers beside the same model's f32
    numbers from an earlier phase of this run, and the card."""
    def fmt(x):
        return ('step %.2f ms, %.0f %s/s, device %.2f ms a profiled step, '
                'peak %.2f GiB' % (x['step_ms'], x['rate'], x['unit'],
                                   x['device_ms'], x['peak'] / 2 ** 30))
    log('  %s: bf16 (AMP) %s | f32 (phase %d, this run) %s | %s' % (
        name, fmt(amp), f32['phase'], fmt(f32), card))


def amp_eval(run):
    """The for_test clone of an AMP program: its forward in bf16 with
    attention dropout off.  Returns the flash launches by route."""
    path = run['path']
    with fluid.scope_guard(run['scope']):
        out, counts, rows = flash_counted(lambda: run['exe'].run(
            path['test'], feed=path['batch'], fetch_list=[path['loss']],
            return_numpy=False))
    want = dict.fromkeys(FLASH_ROWS, 0)
    want['flash_attention[bf16]'] = path['n_attn']
    log('  the for_test clone: loss %.6f (%s), launches %s' % (
        float(out[0]), out[0].dtype, {k: c for k, c in counts.items() if c}))
    if rows != want or not math.isfinite(float(out[0])):
        raise AssertionError('%s eval: flash launches %s, expected %s, or '
                             'a loss that is not finite' % (path['name'],
                                                            rows, want))
    return counts, rows


def amp_overflow_step(run, dev):
    """(e) One step of the AMP BERT-base program that overflows at the
    current scale: the state's loss scale set to OVERFLOW_SCALE with one
    bad step behind it, and the MLM decoder weight times 64, so the
    gradients behind the decoder grow past 2 and their scaled values
    past f32's range while the forward stays finite.  The verdict is
    true on the card, the scale halves and the counters restart, Adam
    decays its moments (bitwise beta times the old, as zero gradients
    give), advances its beta powers and moves its parameters, as the
    JAX package's semantics say; the step runs from feeds already on the
    card under torch.cuda.set_sync_debug_mode('warn'), and no
    synchronizing call may happen inside it.  It is its signature's
    first run (eager, on the capture stream); the same step from the
    same state (written back in place) and executor step then runs
    twice more, as Executor.run runs it: captured with one replay, then
    a replay under the same sync debug mode, whose state must be
    bitwise the eager step's, with no launch at the wrappers and the
    eager step's launches replayed."""
    path = run['path']
    main, scope, exe = path['main'], run['scope'], run['exe']
    names = weights.startup_names(path['startup'])
    feed = {k: torch.as_tensor(v, device=dev)
            for k, v in path['batch'].items()}
    step0 = exe._step
    with fluid.scope_guard(scope):
        scope.set_var('loss_scaling_0',
                      torch.full((1,), OVERFLOW_SCALE, device=dev))
        scope.set_var('bad_steps_0',
                      torch.ones((1,), dtype=torch.int32, device=dev))
        scope.set_var(path['decoder'], scope.find_var(path['decoder']) * 64.0)
        prev = snapshot(scope, names)
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter('always')
            torch.cuda.set_sync_debug_mode('warn')
            try:
                out, counts, rows = flash_counted(lambda: exe.run(
                    main, feed=feed, fetch_list=['found_inf_0'],
                    return_numpy=False))
            finally:
                torch.cuda.set_sync_debug_mode('default')
        syncs = sorted({str(w.message).split('\n')[0] for w in caught
                        if 'called a synchronizing' in str(w.message)})
        torch.cuda.synchronize()
        found = bool(out[0])
        after = snapshot(scope, names)
    scale = {n: after[n].tolist() for n in SCALE_STATE}
    decayed = all(
        torch.equal(after[n], prev[n] * (0.9 if '_moment1_' in n else 0.999))
        for n in names if '_moment' in n)
    powers = all(
        torch.equal(after[n], prev[n] * (0.9 if '_beta1_' in n else 0.999))
        for n in names if '_pow_acc_' in n)
    params = [p.name for p in main.all_parameters()]
    moved = sum(not torch.equal(after[n], prev[n]) for n in params)
    finite = all(bool(torch.isfinite(after[n]).all()) for n in params)
    log('  (e) overflow step: verdict %s on %s, loss scaling %s, moments '
        'decayed bitwise %s, beta powers advanced %s, %d of %d parameters '
        'moved, all finite %s, launches %s; synchronizing calls inside the '
        'step: %s' % (found, out[0].device, scale, decayed, powers, moved,
                      len(params), finite,
                      {k: c for k, c in counts.items() if c},
                      syncs or 'none'))
    want = {'loss_scaling_0': [OVERFLOW_SCALE / 2], 'good_steps_0': [0],
            'bad_steps_0': [0]}
    if not (found and out[0].is_cuda and scale == want and decayed and
            powers and moved and finite and not syncs and
            counts == path['expected']):
        raise AssertionError('the overflow step did not follow the loss '
                             'scaling semantics (or synchronized)')
    stats = graph_stats()
    common.reset_launches()
    with fluid.scope_guard(scope):
        held = {n: scope.find_var(n) for n in names}
        for i in range(2):
            for n, v in prev.items():
                held[n].copy_(v)
            exe._step = step0
            torch.cuda.synchronize()
            if i == 1:
                launched = {k: common.launches(k) for k in common.KERNELS}
                before = {k: common.replayed(k) for k in common.KERNELS}
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter('always')
                    torch.cuda.set_sync_debug_mode('warn')
                    try:
                        out = exe.run(main, feed=feed,
                                      fetch_list=['found_inf_0'],
                                      return_numpy=False)
                    finally:
                        torch.cuda.set_sync_debug_mode('default')
                last = {k: common.replayed(k) - before[k]
                        for k in common.KERNELS}
                again = {k: common.launches(k) - launched[k]
                         for k in common.KERNELS}
            else:
                out = exe.run(main, feed=feed, fetch_list=['found_inf_0'],
                              return_numpy=False)
        torch.cuda.synchronize()
        replayed = snapshot(scope, names)
        found = bool(out[0])
        refusals = graph_refusals(main, scope)
    drop_graphs(main, scope)
    syncs = sorted({str(w.message).split('\n')[0] for w in caught
                    if 'called a synchronizing' in str(w.message)})
    st = {k: v - stats[k] for k, v in graph_stats().items()}
    differ = [n for n in names if not torch.equal(replayed[n], after[n])]
    log('  (e) the overflow step replayed: verdict %s, captures %d, replays '
        '%d, refused %d%s; the replay launched %s at the wrappers and '
        'replayed %s; the state %s; synchronizing calls inside the '
        'replayed step: %s' % (
            found, st['graph_captures'], st['graph_replays'],
            st['graph_refused'], ' (%s)' % refusals if refusals else '',
            {k: c for k, c in again.items() if c},
            {k: c for k, c in last.items() if c},
            'bitwise the eager step\'s' if not differ else
            'differs in %s' % differ[:8], syncs or 'none'))
    if not (found and st['graph_captures'] == 1 and
            st['graph_replays'] == 2 and not st['graph_refused'] and
            not differ and not any(again.values()) and
            last == path['expected'] and not syncs):
        raise AssertionError('the replayed overflow step is not the eager '
                             'one (or synchronized)')
    return counts, rows


def amp_resnet(seed, dev, profile, card):
    """(c) ResNet-50 at batch 128 under AMP as bench_resnet50 trains it;
    its step 1 against the f32 step from the same state."""
    path = image_path(seed, 'resnet', RESNET_BATCH, dev, bench='amp')
    log('[13] (c) %s, batch %d, 224 x 224, %d classes, decorate(Momentum(%g, '
        '%g))' % (path['name'], RESNET_BATCH, IMAGE_CLASSES, IMAGE_LR,
                  IMAGE_MOMENTUM))
    run = train_image(path, TRAIN_STEPS, TIMED_STEPS, profile)
    with fluid.scope_guard(run['scope']):
        scale = {n: run['scope'].find_var(n).tolist() for n in SCALE_STATE}
        conv = [op.output('Output')[0] for op in path['main'].global_block().ops
                if op.type == 'conv2d'][0]
        act = without_counting(lambda: run['exe'].run(
            path['test'], feed=path['batch'], fetch_list=[conv],
            return_numpy=False))[0]
    f32_path = image_path(seed, 'resnet', RESNET_BATCH, dev, bench='f32')
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    with fluid.scope_guard(scope):
        without_counting(lambda: exe.run(f32_path['startup']))
        for n in weights.startup_names(f32_path['startup']):
            scope.set_var(n, run['start'][n].clone())
        loss32 = float(without_counting(lambda: exe.run(
            f32_path['main'], feed=f32_path['batch'],
            fetch_list=[f32_path['loss']]))[0])
    rel = abs(run['losses'][0] - loss32) / abs(loss32)
    log('  step 1: AMP loss %.6f, f32 loss from the same state %.6f (rel '
        '%.2e, limit %g); activations %s; loss scaling %s' % (
            run['losses'][0], loss32, rel, AMP_F32_LOSS_RTOL, act.dtype,
            scale))
    steps = TRAIN_STEPS + TIMED_STEPS + 1  # and the profiled step
    if not (rel <= AMP_F32_LOSS_RTOL and act.dtype == torch.bfloat16 and
            scale == {'loss_scaling_0': [2.0 ** 15], 'good_steps_0': [steps],
                      'bad_steps_0': [0]}):
        raise AssertionError('ResNet-50 under AMP: step 1 off the f32 step, '
                             'activations not bf16 or an overflow')
    side_by_side('ResNet-50 batch %d' % RESNET_BATCH, dict(
        step_ms=run['step_ms'], rate=RESNET_BATCH / run['step_ms'] * 1e3,
        unit='images', device_ms=run['device_ms'], peak=run['peak']),
        F32_RUNS['resnet50'], card)
    log('    (f32: NCHW with L2Decay(%g), phase 10\'s form; AMP: NHWC '
        'without decay, bench_resnet50\'s)' % IMAGE_DECAY)
    run['path'] = path
    without_counting(lambda: plan_cache_steps(run))


def word2vec_path(seed):
    """(d) word2vec CBOW with SGD(W2V_LR) in f32: the path dict that
    train() runs, bitwise its plain path."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed + 1
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        _, _, loss = word2vec.build(W2V_VOCAB)
        fluid.optimizer.SGD(W2V_LR).minimize(loss)
    n_lookup = sum(op.type == 'lookup_table'
                   for op in main.global_block().ops)
    expected = {k: 0 for k in common.KERNELS}
    expected.update({'embedding_lookup': n_lookup,
                     'embedding_scatter_add': n_lookup,
                     **dropout_launches(main)})
    return {'name': 'word2vec CBOW SGD', 'main': main, 'startup': startup,
            'loss': loss, 'lr': None,
            'batch': word2vec.synthetic_batch(W2V_VOCAB, W2V_BATCH,
                                              np.random.RandomState(seed)),
            'expected': expected, 'probe': [], 'tokens': W2V_BATCH,
            'unit': 'examples', 'rate': W2V_LR, 'bitwise': True}


def mixed_precision(seed, dev, profile):
    """Phase 13."""
    card = '%s | %s' % (torch.cuda.get_device_name(0), card_line())
    launches = {k: 0 for k in common.KERNELS}
    flash = dict.fromkeys(FLASH_ROWS, 0)

    def add(counts, rows=None):
        for k, c in counts.items():
            launches[k] += c
        for k, c in (rows or {}).items():
            flash[k] += c

    for key, seq, batch in (('bert512', SEQ, TRAIN_BATCH),
                            ('bert128', SHORT_SEQ, SHORT_TRAIN_BATCH)):
        path = amp_bert_path(seed, seq, batch)
        log('[13] (%s) %s, batch %d, decorate(Adam(%g)) with dynamic loss '
            'scaling' % ('a' if seq == SEQ else 'b', path['name'], batch,
                         AMP_LR))
        run = amp_train(path)
        add(run['launches'], run['flash'])
        nums = amp_numbers(run)
        if seq == SEQ:
            without_counting(lambda: plan_cache_steps(run))
        # the bf16 products: through the autograd Function that turns
        # cuBLAS's bf16 partial sums off (PyTorch's default lets them
        # on), or, with the flag off already, plain torch.matmul
        flag = torch.backends.cuda.matmul
        prev = flag.allow_bf16_reduced_precision_reduction
        flag.allow_bf16_reduced_precision_reduction = False
        try:
            plain_mm = without_counting(lambda: train_step_ms(run))
        finally:
            flag.allow_bf16_reduced_precision_reduction = prev
        log('  step with allow_bf16_reduced_precision_reduction off '
            '(torch.matmul without the Function): median %.2f ms; as the '
            'run leaves it (%s): %.2f ms' % (plain_mm, prev,
                                              nums['step_ms']))
        add(*amp_eval(run))
        if profile:
            without_counting(lambda: profile_train(run))
        side_by_side('BERT-base seq %d batch %d' % (seq, batch), nums,
                     F32_RUNS[key], card)
        if seq == SEQ:
            add(*amp_overflow_step(run, dev))
        del run
        torch.cuda.empty_cache()
    amp_resnet(seed, dev, profile, card)
    torch.cuda.empty_cache()

    path = word2vec_path(seed)
    log('[13] (d) %s: vocabulary %d, embedding %d, hidden 256, %d context '
        'words, batch %d, f32' % (path['name'], W2V_VOCAB, word2vec.EMB_SIZE,
                                  word2vec.N_GRAM, W2V_BATCH))
    run = train(path)
    add(run['launches'])
    nums = amp_numbers(run)
    log('  word2vec: step %.2f ms, %.0f examples/s, device %.2f ms a '
        'profiled step, peak %.2f GiB | %s' % (
            nums['step_ms'], nums['rate'], nums['device_ms'],
            nums['peak'] / 2 ** 30, card))
    log('  launches + replayed on phase 13\'s paths: %s; flash by route %s'
        % ({k: c for k, c in launches.items() if c},
           {k: c for k, c in flash.items() if c}))


# ----------------------------------------------------------- phase 14
def write_criteo_files(d, seed, lines, files=WD_FILES):
    """MultiSlot text in Criteo's layout at Wide&Deep's widths, from
    `seed`: 13 dense floats, 26 hashed ids in [0, WD_ROWS), the label
    (correlated with the features, as wide_deep.synthetic_batch's), one
    sample a line, `lines` lines over `files` files."""
    rng = np.random.RandomState(seed)
    dense = rng.rand(lines, 13).astype('float32')
    ids = rng.randint(0, WD_ROWS, (lines, 26))
    score = dense.sum(1) + (ids.sum(1) % 7) * 0.1
    label = (score > np.median(score)).astype('int64')
    fmt = '13 ' + ' '.join(['%.9g'] * 13) + ' 26 ' + \
        ' '.join(['%d'] * 26) + ' 1 %d'
    paths = []
    for k, part in enumerate(np.array_split(np.arange(lines), files)):
        path = os.path.join(d, 'part-%05d' % k)
        with open(path, 'w') as f:
            for i in part:
                f.write(fmt % (tuple(dense[i]) + tuple(ids[i]) +
                               (label[i],)) + '\n')
        paths.append(path)
    return paths


def wd_dataset(kind, path, files, thread):
    ds = fluid.DatasetFactory().create_dataset(kind)
    ds.set_batch_size(WD_BATCH)
    ds.set_thread(thread)
    ds.set_filelist(files)
    block = path['main'].global_block()
    ds.set_use_var([block.var(n) for n in
                    ('dense_input', 'sparse_input', 'label')])
    ds.seed = 7
    return ds


def fetches_of(exe, into):
    """Record the first fetch of each exe.run that train_from_dataset or
    infer_from_dataset makes (at print_period=1, one every step) into
    `into`; the call runs under quiet_steps."""
    run = exe.run

    def recorded(*args, **kwargs):
        out = run(*args, **kwargs)
        if out:
            into.append(out[0])
        return out
    exe.run = recorded


def quiet_steps():
    """Swallow the '[dataset step N]' lines of print_period=1."""
    return contextlib.redirect_stdout(io.StringIO())


def wd_steps(path, start, batches, dataset=None, thread=1):
    """Wide&Deep from `start` on a new executor and scope: exe.run over
    `batches`, or train_from_dataset(dataset, thread) when `dataset` is
    given, the loss fetched every step.  (losses, the final state, the
    launches + replayed, the executor, the scope, each exe.run's
    seconds)."""
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    losses, secs = [], []
    with fluid.scope_guard(scope):
        without_counting(lambda: exe.run(path['startup']))
        for n, v in start.items():
            scope.find_var(n).copy_(v)
        if dataset is None:
            def run():
                for b in batches:
                    t0 = time.perf_counter()
                    losses.append(float(exe.run(
                        path['main'], feed=b, fetch_list=[path['loss']])[0]))
                    secs.append(time.perf_counter() - t0)
        else:
            fetches_of(exe, losses)

            def run():
                with quiet_steps():
                    exe.train_from_dataset(
                        path['main'], dataset, thread=thread,
                        fetch_list=[path['loss']], print_period=1)
        _, counts = counted(run)
        losses = [float(x) for x in losses]
        torch.cuda.synchronize()
        state = snapshot(scope, list(start))
    return losses, state, counts, exe, scope, secs


def same_state(a, b):
    return [n for n in a if not torch.equal(a[n], b[n])]


def data_plane_ctr(seed, dev, card):
    """Phase 14 (a): Wide&Deep trained from MultiSlot files through
    Dataset + train_from_dataset, held bitwise against exe.run over the
    same batches; its prediction saved and served three ways."""
    path = wide_deep_program(seed)
    lines = WD_FULL_BATCHES * WD_BATCH + WD_PARTIAL
    base = os.path.join(ROOT, 'build', 'chip_smoke')
    with tempfile.TemporaryDirectory(dir=base) as d:
        t0 = time.perf_counter()
        files = write_criteo_files(d, seed, lines)
        log('  wrote %d lines of MultiSlot text (13 dense, 26 ids, the '
            'label) in %d files in %.1f s' % (lines, len(files),
                                              time.perf_counter() - t0))
        # the native feeder alone: every file parsed by 4 threads (its
        # library built first, as set-up)
        t0 = time.perf_counter()
        feeder_lib = runtime.build()
        log('  the MultiSlot feeder library %s ready in %.1f s' % (
            os.path.basename(feeder_lib), time.perf_counter() - t0))
        queue4 = wd_dataset('QueueDataset', path, files, 4)
        t0 = time.perf_counter()
        parsed = sum(int(b['label'].shape[0]) for b in queue4.batches())
        parse_s = time.perf_counter() - t0
        mem = wd_dataset('InMemoryDataset', path, files, 4)
        t0 = time.perf_counter()
        mem.load_into_memory()
        load_s = time.perf_counter() - t0
        mem.local_shuffle()
        batches = list(mem.batches())
        pinned = all(v.is_pinned() for b in batches for v in b.values())
        log('  feeder: %d lines parsed in %.1f ms (%.0f lines/s, 4 threads, '
            'warm page cache); load_into_memory %.1f ms; %d batches (%s), '
            'in pinned memory %s' % (
                parsed, parse_s * 1e3, parsed / parse_s, load_s * 1e3,
                len(batches), [int(b['label'].shape[0]) for b in batches],
                pinned))
        if parsed != lines or mem.get_memory_data_size() != lines or \
                not pinned:
            raise AssertionError('the feeder gave %d lines (memory %d) of '
                                 '%d, pinned %s' % (
                                     parsed, mem.get_memory_data_size(),
                                     lines, pinned))
        exe0, scope0 = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
        with fluid.scope_guard(scope0):
            without_counting(lambda: exe0.run(path['startup']))
            start = snapshot(scope0, weights.startup_names(path['startup']))
        del exe0, scope0
        ref = wd_steps(path, start, batches)
        want = {k: v * len(batches) for k, v in path['expected'].items()}
        sizes = [int(b['label'].shape[0]) for b in batches]
        log('  exe.run over the batches, each its signature\'s first run, '
            'capture or replay: %s ms (the %d-row batch at step %d, its '
            'signature\'s first run, eager)' % (
                ['%.2f' % (x * 1e3) for x in ref[5]], WD_PARTIAL,
                sizes.index(WD_PARTIAL) + 1))
        queue1 = wd_dataset('QueueDataset', path, files, 1)
        queue_batches = list(queue1.batches())
        for kind, ds, thread, held in (
                ('InMemoryDataset', mem, 4, ref),
                ('QueueDataset', queue1, 1,
                 wd_steps(path, start, queue_batches))):
            got = wd_steps(path, start, None, ds, thread)
            differ = same_state(got[1], held[1])
            log('  %s, train_from_dataset(thread=%d): %d steps, losses %s, '
                'launches + replayed %s; against exe.run over the same '
                'batches: losses %s, state (%d variables) %s' % (
                    kind, thread, len(got[0]),
                    ['%.6f' % x for x in got[0]],
                    {k: c for k, c in got[2].items() if c},
                    'bitwise equal' if got[0] == held[0] else 'DIFFER',
                    len(start), 'bitwise equal' if not differ else
                    'differs in %s' % differ))
            if got[0] != held[0] or differ or got[2] != want or \
                    len(got[0]) != len(batches) or \
                    not all(np.isfinite(got[0])):
                raise AssertionError('%s through train_from_dataset is not '
                                     'bitwise exe.run over its batches, or '
                                     'launched %s (expected %s)' % (
                                         kind, got[2], want))
        exe, scope = ref[3], ref[4]
        test = path['main'].clone(for_test=True)
        feeds = ['dense_input', 'sparse_input']
        with fluid.scope_guard(scope):
            want_preds = [without_counting(lambda: exe.run(
                test, feed=b, fetch_list=[path['preds']])[0])
                for b in batches]
            inferred = []
            fetches_of(exe, inferred)
            with quiet_steps():
                steps = without_counting(lambda: exe.infer_from_dataset(
                    path['main'], mem, fetch_list=[path['preds']],
                    print_period=1))
            del exe.run
            model_dir = os.path.join(d, 'model')
            fluid.save_inference_model(model_dir, feeds, [path['preds']],
                                       exe, path['main'])
        exe2, scope2 = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
        with fluid.scope_guard(scope2):
            prog, feed_names, fetch_vars = fluid.io.load_inference_model(
                model_dir, exe2)
            loaded = [without_counting(lambda: exe2.run(
                prog, feed={n: b[n] for n in feed_names},
                fetch_list=fetch_vars)[0]) for b in batches]
        pred = create_paddle_predictor(AnalysisConfig(model_dir))
        served = without_counting(lambda: pred.run(
            [batches[0][n].numpy() for n in pred.get_input_names()])[0].data)
        ok = steps == len(batches) and all(
            np.array_equal(a, w) for a, w in zip(inferred, want_preds)) and \
            all(np.array_equal(a, w) for a, w in zip(loaded, want_preds)) \
            and np.array_equal(served, want_preds[0])
        log('  the prediction saved with save_inference_model: '
            'load_inference_model in a fresh scope (%d batches), '
            'infer_from_dataset (%d steps) and create_paddle_predictor (one '
            'batch, [%d, 2]) against the training program\'s '
            'clone(for_test=True): %s' % (
                len(loaded), steps, served.shape[0],
                'bitwise equal' if ok else 'DIFFER'))
        if not ok:
            raise AssertionError('the saved Wide&Deep prediction does not '
                                 'answer as the for_test clone')
        # examples/s: train_from_dataset (thread 4) beside the same steps
        # fed from device tensors staged before; both warm (every
        # signature captured), nothing fetched
        staged = [{n: v.to(dev) for n, v in b.items()} for b in batches]

        def from_dataset():
            exe.train_from_dataset(path['main'], mem, thread=4)

        def from_device():
            for b in staged:
                exe.run(path['main'], feed=b)
        secs = {}
        with fluid.scope_guard(scope):
            for name, fn in (('dataset', from_dataset),
                             ('staged', from_device)) * 2:
                for _ in range(3):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    without_counting(fn)
                    torch.cuda.synchronize()
                    secs.setdefault(name, []).append(
                        time.perf_counter() - t0)
        rate = {k: lines / min(v[-3:]) for k, v in secs.items()}
        log('  Wide&Deep %d examples an epoch (%s | %s): train_from_dataset '
            '(InMemoryDataset, thread 4) %.0f examples/s, the same steps '
            'from staged device tensors %.0f examples/s (best of the last 3 '
            'epochs each, every signature replayed)' % (
                lines, torch.cuda.get_device_name(0), card,
                rate['dataset'], rate['staged']))
        pred = None
    return {'parse_lines_s': parsed / parse_s, 'load_ms': load_s * 1e3,
            'rate': rate}


def data_plane_bert(seed, dev, card):
    """Phase 14 (b): BERT-base pretraining (phase 5's program) fed by
    DataLoader.from_generator, held bitwise against numpy feeds, with a
    checkpoint after step 3 in both formats resumed bitwise."""
    path = pretrain_program(seed, 'adam')
    main, loss = path['main'], path['loss']
    names = list(path['batch'])
    feed_list = [main.global_block().var(n) for n in names]
    data = [bert.synthetic_batch(bert.BASE, TRAIN_BATCH, SEQ,
                                 np.random.RandomState(seed + 100 + i))
            for i in range(LOADER_STEPS)]
    state_names = weights.startup_names(path['startup'])

    def fresh(start=None):
        exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
        with fluid.scope_guard(scope):
            without_counting(lambda: exe.run(path['startup']))
            if start is not None:
                for n, v in start.items():
                    scope.find_var(n).copy_(v)
        return exe, scope

    def step(exe, scope, feed):
        with fluid.scope_guard(scope):
            t0 = time.perf_counter()
            out = float(exe.run(main, feed=feed, fetch_list=[loss])[0])
            return out, time.perf_counter() - t0

    exe, scope = fresh()
    with fluid.scope_guard(scope):
        start = snapshot(scope, state_names)
    ref_losses, ref_secs = [], []
    for i, b in enumerate(data):
        l, sec = without_counting(lambda: step(exe, scope, b))
        ref_losses.append(l)
        ref_secs.append(sec)
        if i == CHECKPOINT_STEP - 1:
            at3 = snapshot(scope, state_names)
            step3 = exe._step
    with fluid.scope_guard(scope):
        ref_final = snapshot(scope, state_names)
    drop_graphs(main, scope)
    del exe, scope
    torch.cuda.empty_cache()

    loader = fluid.io.DataLoader.from_generator(
        feed_list=feed_list, capacity=4, use_double_buffer=True,
        iterable=True)
    loader.set_batch_generator(lambda: (tuple(b[n] for n in names)
                                        for b in data),
                               places=fluid.cuda_places())
    exe, scope = fresh(start)
    losses, secs, next_s = [], [], []
    per_step = []
    it = iter(loader)
    base = os.path.join(ROOT, 'build', 'chip_smoke')
    with tempfile.TemporaryDirectory(dir=base) as d:
        dirs = {'npz': os.path.join(d, 'npz'),
                'paddle': os.path.join(d, 'paddle')}
        for i in range(LOADER_STEPS):
            if i == 2:
                # the loader's host work a step: its next() under the
                # profiler, which pops a staged batch and stages the next
                got = []
                events = without_counting(lambda: profile_run(
                    'next()', lambda: got.append(next(it)), quiet=True))
                next_cpu = host_ms(events, waits=False)
                batch = got[0]
            else:
                t0 = time.perf_counter()
                batch = next(it)
                next_s.append(time.perf_counter() - t0)
            if not all(v.is_cuda for v in batch.values()):
                raise AssertionError('the loader handed out host tensors')
            (l, sec), counts = counted(lambda: step(exe, scope, batch))
            losses.append(l)
            secs.append(sec)
            per_step.append(counts)
            if i == CHECKPOINT_STEP - 1:
                with fluid.scope_guard(scope):
                    for fmt, dd in dirs.items():
                        fluid.io.save_persistables(
                            exe, dd, main,
                            save_format='native' if fmt == 'npz'
                            else 'paddle')
        if next(it, None) is not None:
            raise AssertionError('the loader gave more than %d batches'
                                 % LOADER_STEPS)
        with fluid.scope_guard(scope):
            final = snapshot(scope, state_names)
        differ = same_state(final, ref_final)
        log('  %d steps fed by DataLoader.from_generator (capacity 4, '
            'double buffer, cuda_places()): losses %s; against numpy feeds: '
            'losses %s, state (%d variables) %s; launches + replayed a step '
            '%s' % (LOADER_STEPS, ['%.6f' % x for x in losses],
                    'bitwise equal' if losses == ref_losses else 'DIFFER',
                    len(state_names), 'bitwise equal' if not differ else
                    'differs in %s' % differ[:4],
                    {k: c for k, c in per_step[-1].items() if c}))
        if losses != ref_losses or differ or \
                any(c != path['expected'] for c in per_step):
            raise AssertionError('BERT-base fed by the DataLoader is not '
                                 'bitwise the numpy-fed steps, or launched %s '
                                 '(expected %s)' % (per_step,
                                                    path['expected']))
        # the checkpoint after step 3: loaded into a fresh scope, steps
        # 4-5 as the uninterrupted run's.  save_persistables keeps no
        # executor step (nor does the JAX package's, outside its elastic
        # store), and the step seeds every dropout mask: the resume sets
        # it by hand, as a user must for a bitwise resume
        for fmt, dd in dirs.items():
            exe2, scope2 = fresh()
            with fluid.scope_guard(scope2):
                fluid.io.load_persistables(exe2, dd, main)
                loaded = snapshot(scope2, state_names)
            exe2._step = step3
            resumed = [without_counting(lambda: step(exe2, scope2, b))[0]
                       for b in data[CHECKPOINT_STEP:]]
            with fluid.scope_guard(scope2):
                differ = same_state(loaded, at3) + same_state(
                    snapshot(scope2, state_names), ref_final)
            log('  checkpoint after step %d (%s): loaded into a fresh scope '
                'and resumed with the executor\'s dropout step set by hand '
                '(the checkpoint holds no step), steps %d-%d losses %s, the '
                'loaded and final states %s' % (CHECKPOINT_STEP, fmt, CHECKPOINT_STEP + 1,
                               LOADER_STEPS, 'bitwise the uninterrupted '
                               'run\'s' if resumed == ref_losses[
                                   CHECKPOINT_STEP:] else 'DIFFER',
                               'bitwise equal' if not differ else
                               'differ in %s' % differ[:4]))
            if resumed != ref_losses[CHECKPOINT_STEP:] or differ:
                raise AssertionError('the %s checkpoint did not resume '
                                     'bitwise' % fmt)
            drop_graphs(main, scope2)
            del exe2, scope2
            torch.cuda.empty_cache()
        # a load into the running scope: written in place, so the
        # captured graph replays steps 4-5 again, no capture
        before = compile_cache.plane().stats()
        with fluid.scope_guard(scope):
            fluid.io.load_persistables(exe, dirs['paddle'], main)
        exe._step = step3
        again = [without_counting(lambda: step(exe, scope, b))[0]
                 for b in data[CHECKPOINT_STEP:]]
        after = compile_cache.plane().stats()
    moved = {k: after[k] - before[k] for k in
             ('graph_captures', 'graph_replays', 'graph_stale')}
    log('  load_persistables into the running scope, the dropout step set '
        'back by hand, then steps %d-%d again: losses %s, graphs %s' % (
            CHECKPOINT_STEP + 1, LOADER_STEPS,
            'bitwise the uninterrupted run\'s' if again == ref_losses[
                CHECKPOINT_STEP:] else 'DIFFER', moved))
    if again != ref_losses[CHECKPOINT_STEP:] or moved != {
            'graph_captures': 0, 'graph_stale': 0,
            'graph_replays': LOADER_STEPS - CHECKPOINT_STEP}:
        raise AssertionError('a load into the running scope recaptured or '
                             'changed the steps')
    ms = {'numpy': statistics.median(ref_secs[2:]) * 1e3,
          'loader': statistics.median(secs[2:]) * 1e3,
          'next': statistics.median(next_s[1:]) * 1e3,
          'next_self_cpu': next_cpu}
    log('  BERT-base step (%s | %s), median of steps 3-%d (replays): fed '
        'numpy arrays %.2f ms, fed by the DataLoader %.2f ms; the loader\'s '
        'next() a step: %.3f ms self CPU (profiled at step 3, outside the '
        'waits), %.3f ms on the host clock (median of steps 2, 4 and 5)' % (
            torch.cuda.get_device_name(0), card, LOADER_STEPS, ms['numpy'],
            ms['loader'], ms['next_self_cpu'], ms['next']))
    drop_graphs(main, scope)
    return ms


def data_plane(seed, dev):
    """Phase 14: the data and IO plane's paths at full width."""
    card = card_line()
    log('[14] the data and IO plane (%s | %s): (a) Wide&Deep from MultiSlot '
        'files through Dataset + train_from_dataset' % (
            torch.cuda.get_device_name(0), card))
    ctr = data_plane_ctr(seed, dev, card)
    torch.cuda.empty_cache()
    log('[14] (b) BERT-base pretraining fed by DataLoader.from_generator')
    bert_ms = data_plane_bert(seed, dev, card)
    torch.cuda.empty_cache()
    return ctr, bert_ms


# ----------------------------------------------------------- phase 15
def seq2seq_path(seed):
    """The LSTM seq2seq's training step (models.seq2seq.build_train at
    BASE widths) with Adam and the global-norm clip: the path dict that
    train() runs.  Every kernel on it is bitwise its plain version, so
    the whole step is (bitwise)."""
    cfg = seq2seq.BASE
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed + 1
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        loss = seq2seq.build_train(fluid, cfg, S2S_BATCH, S2S_LEN, S2S_LEN)
        fluid.optimizer.Adam(
            learning_rate=S2S_LR,
            grad_clip=fluid.clip.GradientClipByGlobalNorm(S2S_CLIP)
        ).minimize(loss)
    batch = seq2seq.synthetic_batch(cfg, S2S_BATCH, S2S_LEN, S2S_LEN,
                                    np.random.RandomState(seed))
    expected = {k: 0 for k in common.KERNELS}
    expected.update({'embedding_lookup': 2, 'embedding_scatter_add': 2,
                     'fused_adam': 1, **dropout_launches(main)})
    return {'name': 'LSTM seq2seq Adam', 'main': main, 'startup': startup,
            'loss': loss, 'lr': None, 'batch': batch, 'expected': expected,
            'probe': ['src_emb', 'tgt_emb', 'dec_l0_w', 'out_w'],
            'tokens': int(batch['tgt_len'].sum()), 'unit': 'target tokens',
            'rate': S2S_LR, 'bitwise': True}


def decode_program(seed, build):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed + 1
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        outs = build(fluid, seq2seq.BASE, S2S_BATCH, S2S_LEN)
    return main, [v.name for v in outs]


def live_steps(ids):
    """1 + the last step (axis 1 of dynamic_decode's ids [B * beam,
    T]) at which some beam's id is not eos, 0 when none is."""
    live = np.flatnonzero((ids != seq2seq.BASE.eos).any(0))
    return int(live[-1]) + 1 if live.size else 0


def seq2seq_decode(run, seed, label, build, while_loop):
    """A decode program on the trained scope: once with the plain
    versions (eagerly), then S2S_DECODE_RUNS times through Executor.run
    (counted; its first run eager, the second captured with one replay,
    the rest replayed), each run's fetches bitwise the plain run's and
    its launches exact.  Both decodes may be captured: the book's
    (`while_loop`) with its forward-only While as a CUDA graph WHILE
    node, whose handle graph_cond sets before the node and at the end
    of each trip.  The decode must keep a beam live for S2S_MIN_LIVE
    steps: the While's trips, dynamic_decode's ``live_steps``.  Returns
    the ms of each counted run (host clock, fetches to numpy) and a
    profiled run's device ms."""
    main, fetch = decode_program(seed, build)
    exe, scope = run['exe'], run['scope']
    feed = {k: run['path']['batch'][k] for k in ('src', 'src_len')}
    with fluid.scope_guard(scope):
        flags.set_flags({'FLAGS_torch_kernels_plain': True})
        try:
            plain = without_counting(lambda: eager_run(exe, main, feed,
                                                       fetch))
        finally:
            flags.set_flags({'FLAGS_torch_kernels_plain': False})
        plan = exe._get_plan(main, feed, fetch)
        why = plan.no_graph
        if why is not None:
            raise AssertionError('%s: capture refusal %r' % (label, why))
        steps = int(np.asarray(plain[-1]).ravel()[0]) if while_loop \
            else S2S_LEN
        live = steps if while_loop else live_steps(np.asarray(plain[0]))
        if live < S2S_MIN_LIVE:
            raise AssertionError(
                '%s: a beam stays live for %d of its %d steps, fewer than '
                '%d' % (label, live, S2S_LEN, S2S_MIN_LIVE))
        expected = {k: 0 for k in common.KERNELS}
        expected['embedding_lookup'] = 1 + steps
        secs = []
        for i in range(S2S_DECODE_RUNS):
            # the first run is eager; a graph's sets the WHILE's handle
            expected['graph_cond'] = (1 + steps) if while_loop and i else 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, counts = counted(lambda: exe.run(main, feed=feed,
                                                  fetch_list=fetch))
            secs.append(time.perf_counter() - t0)
            differ = [n for n, a, b in zip(fetch, out, plain)
                      if not np.array_equal(a, b)]
            if counts != expected or differ:
                raise AssertionError(
                    '%s run %d launched %s (expected %s); differs from '
                    'the plain path in %s' % (label, i + 1, counts,
                                              expected, differ))
        events = without_counting(lambda: profile_run(
            label, lambda: exe.run(main, feed=feed, fetch_list=fetch),
            quiet=True))
    ids = np.asarray(out[0])
    if not ((ids >= 0) & (ids < seq2seq.BASE.tgt_vocab)).all():
        raise AssertionError('%s: ids out of the vocabulary' % label)
    log('  %s (%d ops, %d steps, a beam live for %d): ids %s, scores '
        'finite %s; bitwise the plain path on %d runs, launches %s a run; '
        '%s; ms a batch of %d at %d steps %s, a profiled run\'s device '
        '%.2f ms' % (
            label, sum(len(b.ops) for b in main.blocks), steps, live,
            tuple(ids.shape), bool(np.isfinite(np.asarray(out[3 if while_loop
                                                         else 1])
                                              ).all()),
            S2S_DECODE_RUNS, {k: c for k, c in expected.items() if c},
            'captured and replayed' + (' (a WHILE node)' if while_loop
                                       else ''), S2S_BATCH, steps,
            ['%.2f' % (x * 1e3) for x in secs], device_ms(events)))
    return secs, device_ms(events)


def seq2seq_phase(seed):
    """Phase 15: the LSTM seq2seq trained through its bounded While and
    decoded both ways."""
    log('[15] LSTM seq2seq training steps on CUDAPlace(0) (%s | %s)' % (
        torch.cuda.get_device_name(0), card_line()))
    path = seq2seq_path(seed)
    log('  %d ops in the While\'s sub-block, batch %d, %d + %d tokens '
        '(%d target tokens)' % (
            len(path['main'].blocks[1].ops), S2S_BATCH, S2S_LEN, S2S_LEN,
            path['tokens']))
    run = train(path)
    med = without_counting(lambda: train_step_ms(run))
    dev_ms = without_counting(lambda: profile_train(run))
    log('  step: median %.2f ms (replays), device %.2f ms, peak %.2f GiB, '
        '%.0f target tokens/s' % (med, dev_ms, run['peak'] / 2 ** 30,
                                  path['tokens'] / med * 1e3))
    without_counting(lambda: plan_cache_steps(run))
    seq2seq_decode(run, seed, 'BeamSearchDecoder + dynamic_decode',
                   seq2seq.build_beam_decode, False)
    seq2seq_decode(run, seed, 'While + beam_search + gather_tree',
                   seq2seq.build_while_decode, True)
    del run
    torch.cuda.empty_cache()

# ----------------------------------------------------------- phase 16
def srl_expected(main):
    """The kernels' launches of a label_semantic_roles training step,
    from its program: the gather (K6) once for each lookup op, the
    scatter-add (K6b) once for each lookup whose table takes a gradient
    (the six word lookups share the frozen word table, trainable=False
    as the book's pretrained one)."""
    block = main.global_block()
    lookups = [op for op in block.ops
               if op.type in ('lookup_table', 'lookup_table_v2')]
    expected = {k: 0 for k in common.KERNELS}
    expected['embedding_lookup'] = len(lookups)
    expected['embedding_scatter_add'] = sum(
        block.var(op.input('W')[0]).trainable for op in lookups)
    return expected


def srl_batches(samples, batch):
    """(bucket, numpy feed) of each batch the bucketed loader makes of
    `samples` (drop_last), in its order: a sample joins the smallest
    bucket that holds it, and a bucket's batch goes out when full."""
    buckets = {b: [] for b in SRL_BUCKETS}
    for smp in samples:
        b = min(x for x in SRL_BUCKETS if x >= smp[-1][0])
        buckets[b].append(smp)
        if len(buckets[b]) == batch:
            yield b, srl.pad_batch(buckets[b], b)
            buckets[b] = []


def median_ms(fn, n):
    secs = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        secs.append(time.perf_counter() - t0)
    return statistics.median(secs) * 1e3


def srl_phase(seed):
    """Phase 16 (a): label_semantic_roles at the book's widths."""
    cfg = srl.BASE
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed + 1
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        feeds, loss, decode = srl.build_train(fluid, cfg)
    test, chunk = srl.build_eval(fluid, cfg, main, decode)
    expected = srl_expected(main)
    params = main.all_parameters()
    log('  program: %d ops, %d parameters (%d elements); launches a step '
        'from the program: %s' % (
            len(main.global_block().ops), len(params),
            sum(int(np.prod(p.shape)) for p in params),
            {k: c for k, c in expected.items() if c}))
    samples = srl.synthetic_samples(cfg, seed, SRL_SAMPLES)
    want = list(srl_batches(samples, cfg.batch))
    loader = fluid.io.DataLoader.from_generator(
        feed_list=feeds[:len(srl.SEQUENCE_FIELDS) + 1],
        bucket_boundaries=SRL_BUCKETS, batch_size=cfg.batch, drop_last=True)
    loader.set_sample_generator(lambda: iter(samples),
                                places=fluid.CUDAPlace(0))
    names = weights.startup_names(startup)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    steps = {}
    with fluid.scope_guard(scope):
        without_counting(lambda: exe.run(startup))
        n = 0
        for batch in loader:
            b, ref = want[n]
            n += 1
            differ = [k for k in ref if not np.array_equal(
                core.to_numpy(batch[k]).reshape(ref[k].shape), ref[k])]
            if set(batch) != set(ref) or differ or \
                    batch['word'].device.type != 'cuda':
                raise AssertionError('loader batch %d (bucket %d) is not '
                                     'the numpy padding: %s' % (n, b, differ))
            rec = {'step': exe._step, 'batch': ref,
                   'tokens': int(ref['length'].sum())}
            if b not in steps:
                rec['start'] = snapshot(scope, names)
            out, counts = counted(lambda: exe.run(
                main, feed=batch, fetch_list=[loss], return_numpy=False))
            rec['loss'] = float(out[0])
            if 'start' in rec:
                rec['after'] = snapshot(scope, names)
            if counts != expected or not math.isfinite(rec['loss']):
                raise AssertionError('step %d (bucket %d): loss %s, launched '
                                     '%s, expected %s' % (
                                         n, b, rec['loss'], counts, expected))
            steps.setdefault(b, []).append(rec)
        if n != len(want):
            raise AssertionError('the loader made %d batches, numpy %d'
                                 % (n, len(want)))
        multi = sorted(b for b, r in steps.items() if len(r) >= 2)
        log('  %d steps through the bucketed loader (every batch bitwise '
            'its numpy padding, staged on the card), steps by bucket %s; '
            'launches a step as expected; losses by bucket %s' % (
                n, {b: len(r) for b, r in sorted(steps.items())},
                {b: ['%.3f' % x['loss'] for x in r]
                 for b, r in sorted(steps.items())}))
        if n < SRL_MIN_STEPS or len(multi) < 3:
            raise AssertionError('%d steps, %d buckets of 2 or more steps'
                                 % (n, len(multi)))
        longest = max(steps.values(), key=len)
        if not longest[-1]['loss'] < longest[0]['loss']:
            raise AssertionError('the loss does not fall in the bucket of '
                                 'the most steps: %s' % [
                                     r['loss'] for r in longest])
        path = {'main': main, 'startup': startup, 'bitwise': True}
        for b in sorted(steps):
            r = steps[b][0]
            check_plain_step(path, [loss.name], r['start'], r['after'],
                             r['loss'], [], None, batch=r['batch'],
                             step=r['step'])
        # each bucket's graph against its eager step from the same state
        for b in multi:
            feed = steps[b][0]['batch']
            held = {k: scope.find_var(k) for k in names}
            before, step0 = snapshot(scope, names), exe._step
            stats = graph_stats()
            replay = without_counting(lambda: exe.run(
                main, feed=feed, fetch_list=[loss]))
            after = snapshot(scope, names)
            moved = {k: v - stats[k] for k, v in graph_stats().items()}
            for k, v in before.items():
                held[k].copy_(v)
            exe._step = step0
            eager = without_counting(lambda: eager_run(exe, main, feed,
                                                       [loss]))
            differ = [k for k in names
                      if not torch.equal(after[k], scope.find_var(k))]
            if moved['graph_replays'] != 1 or moved['graph_captures'] or \
                    not np.array_equal(replay[0], eager[0]) or differ:
                raise AssertionError(
                    'bucket %d: replays %d, captures %d; the replayed step '
                    '(loss %s) against the eager one (%s), state differs '
                    'in %s' % (b, moved['graph_replays'],
                               moved['graph_captures'], replay[0], eager[0],
                               differ[:8]))
            log('  bucket %d: the step replayed from its own graph is '
                'bitwise its eager step (loss and %d variables)' % (
                    b, len(names)))
        for b in multi:
            feed = steps[b][0]['batch']
            tokens = steps[b][0]['tokens']
            fetch = [loss]
            rep = without_counting(lambda: median_ms(
                lambda: exe.run(main, feed=feed, fetch_list=fetch), 5))
            eag = without_counting(lambda: median_ms(
                lambda: eager_run(exe, main, feed, fetch), 3))
            events = without_counting(lambda: profile_run(
                '', lambda: exe.run(main, feed=feed, fetch_list=fetch),
                quiet=True))
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            without_counting(lambda: eager_run(exe, main, feed, fetch))
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            log('  bucket %d (batch %d, %d tokens): replayed %.2f ms, eager '
                '%.2f ms, a profiled replay\'s device %.2f ms, peak %.3f GiB '
                '(%.1f MiB over the resident %.3f GiB), %.0f tokens/s '
                'replayed (%s | %s)' % (
                    b, cfg.batch, tokens, rep, eag, device_ms(events),
                    peak / 2 ** 30, (peak - base) / 2 ** 20, base / 2 ** 30,
                    tokens / rep * 1e3, torch.cuda.get_device_name(0),
                    card_line()))
        # the eval clone: crf_decoding + chunk_eval on held-out batches
        fetch = [decode] + chunk
        held_out = [f for _, f in srl_batches(srl.synthetic_samples(
            cfg, seed + 1000, SRL_SAMPLES), cfg.batch)][:SRL_EVAL_BATCHES]
        plan = exe._get_plan(test, held_out[0],
                             [getattr(v, 'name', v) for v in fetch])
        host = [u.steps[0].members[0].op.type for u in plan.units
                if u.host]
        if plan.no_graph is not None or 'chunk_eval' not in host:
            raise AssertionError('the eval program: refusal %r, host units '
                                 '%s' % (plan.no_graph, host))
        why = 'a pipeline: its device units replayed around host op %s' % (
            ', '.join(host))
        totals = np.zeros(3, np.int64)
        test_expected = {k: 0 for k in common.KERNELS}
        test_expected['embedding_lookup'] = expected['embedding_lookup']
        for feed in held_out:
            got, counts = counted(lambda: exe.run(test, feed=feed,
                                                  fetch_list=fetch))
            flags.set_flags({'FLAGS_torch_kernels_plain': True})
            try:
                plain = without_counting(lambda: eager_run(exe, test, feed,
                                                           fetch))
            finally:
                flags.set_flags({'FLAGS_torch_kernels_plain': False})
            counts_np = lang_ops.chunk_counts(
                got[0], feed['target'], feed['length'].ravel(), 'IOB',
                cfg.chunk_types)
            if counts != test_expected or any(
                    not np.array_equal(a, b) for a, b in zip(got, plain)) \
                    or tuple(int(np.asarray(v).ravel()[0])
                             for v in got[4:]) != counts_np:
                raise AssertionError(
                    'eval: launched %s (expected %s); paths or chunk '
                    'outputs differ from the plain path, or the chunk '
                    'counts %s from numpy\'s %s' % (
                        counts, test_expected, [int(np.asarray(v).ravel()[0])
                                                for v in got[4:]],
                        counts_np))
            totals += counts_np
        p = totals[2] / max(totals[0], 1)
        r = totals[2] / max(totals[1], 1)
        log('  eval clone (crf_decoding + chunk_eval IOB, %d types) on %d '
            'held-out batches (%s): paths and chunk '
            'outputs bitwise the plain path, counts equal numpy\'s; chunks '
            'inferred %d, labelled %d, correct %d: precision %.4f, recall '
            '%.4f, F1 %.4f' % (
                cfg.chunk_types, len(held_out), why, totals[0], totals[1],
                totals[2], p, r, 2 * p * r / (p + r) if totals[2] else 0.0))
    del exe, scope
    gc.collect()
    torch.cuda.empty_cache()


def recompute_phase(seed):
    """Phase 16 (b): BERT-base with RecomputeOptimizer(Adam) against the
    same steps without recompute."""
    plain = pretrain_program(seed, 'adam')
    rc = pretrain_program(seed, 'adam', recompute=True)
    names = weights.startup_names(plain['startup'])
    again = recomputed(rc['main'], ('fused_multihead_attention',
                                    'lookup_table_v2', 'lookup_table',
                                    'dropout', 'recompute_barrier'))
    log('  %d checkpoints; ops emitted again in the backward: %s; launches '
        'a step with recompute %s, without %s' % (
            len(encoder_outputs(rc['main'])),
            {k: c for k, c in again.items() if c},
            {k: c for k, c in rc['expected'].items() if c},
            {k: c for k, c in plain['expected'].items() if c}))
    start, res = None, {}
    for path in (plain, rc):
        exe = fluid.Executor(fluid.CUDAPlace(0))
        scope = fluid.Scope()
        with fluid.scope_guard(scope):
            without_counting(lambda: exe.run(path['startup']))
            if start is None:
                start = {n: scope.find_var(n).cpu() for n in names}
            else:
                for n, v in start.items():
                    scope.find_var(n).copy_(v)
            losses, states, peaks = [], [], []
            for step in range(TRAIN_STEPS):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                out, counts = counted(lambda: exe.run(
                    path['main'], feed=path['batch'],
                    fetch_list=[path['loss']], return_numpy=False))
                torch.cuda.synchronize()
                peaks.append(torch.cuda.max_memory_allocated())
                if counts != path['expected']:
                    raise AssertionError('%s step %d launched %s, expected %s'
                                         % (path['name'], step + 1, counts,
                                            path['expected']))
                losses.append(float(out[0]))
                states.append({n: scope.find_var(n).cpu() for n in names})
            run = {'path': path, 'exe': exe, 'scope': scope}
            med = without_counting(lambda: train_step_ms(run))
            dev_ms = without_counting(lambda: step_device_ms(run))
            if path is rc:
                without_counting(lambda: plan_cache_steps(run))
        res[path['name']] = dict(losses=losses, states=states, peaks=peaks,
                                 ms=med, dev=dev_ms)
        del exe, scope, run
        gc.collect()
        torch.cuda.empty_cache()
    a, b = res[plain['name']], res[rc['name']]
    loss_rel = max(abs(x - y) / abs(y) for x, y in zip(a['losses'],
                                                       b['losses']))
    differ, worst = [], 0.0
    for sa, sb in zip(a['states'], b['states']):
        for n in names:
            if not torch.equal(sa[n], sb[n]):
                differ.append(n)
                worst = max(worst, max_abs(sa[n], sb[n]) / max(
                    sa[n].abs().max().item(), 1e-30))
    log('  losses with recompute %s, without %s: %s; state after each '
        'step %s' % (
            ['%.6f' % x for x in b['losses']],
            ['%.6f' % x for x in a['losses']],
            'bitwise' if a['losses'] == b['losses'] else
            'rel %.2e' % loss_rel,
            'bitwise equal (%d variables)' % len(names) if not differ else
            'differs in %d (worst %.2e of its max): %s' % (
                len(set(differ)), worst, sorted(set(differ))[:8])))
    if (differ or a['losses'] != b['losses']) and not (
            loss_rel <= RC_LOSS_RTOL and worst <= RC_STATE_TOL):
        raise AssertionError('recompute moves the steps beyond the '
                             'tolerance')
    for label, r in ((rc['name'], b), (plain['name'], a)):
        log('  %s: step %.2f ms median (replayed), a profiled step\'s '
            'device %.2f ms, peak %s GiB over steps 1-%d (%s | %s)' % (
                label, r['ms'], r['dev'],
                ['%.3f' % (x / 2 ** 30) for x in r['peaks']], TRAIN_STEPS,
                torch.cuda.get_device_name(0), card_line()))
    if not b['peaks'][0] < a['peaks'][0]:
        raise AssertionError('recompute does not lower step 1\'s peak: %d '
                             'against %d bytes' % (b['peaks'][0],
                                                   a['peaks'][0]))
    log('  recompute saves %.3f GiB of step 1\'s peak and adds %.2f ms '
        '(%.1f%%) to the replayed step' % (
            (a['peaks'][0] - b['peaks'][0]) / 2 ** 30, b['ms'] - a['ms'],
            (b['ms'] / a['ms'] - 1) * 100))


# the new op types of phase 16 (c), each at a size its users run:
# (op, inputs from a numpy generator, attrs, whether its float inputs
# take a gradient)
def lang_op_cases(rng):
    f = lambda *s: rng.randn(*s).astype('float32')  # noqa: E731
    i = lambda hi, *s: rng.randint(0, hi, s).astype('int64')  # noqa: E731
    b, t, v = 16, 100, 40
    lab_len = rng.randint(10, 31, b)
    cases = [
        ('linear_chain_crf', {'Emission': [f(10, 64, 59)],
                              'Transition': [f(61, 59)],
                              'Label': [i(59, 10, 64)],
                              'Length': [rng.randint(4, 65, (10, 1))]}, {}),
        ('crf_decoding', {'Emission': [f(10, 64, 59)],
                          'Transition': [f(61, 59)],
                          'Length': [rng.randint(4, 65, (10, 1))]}, {}),
        ('warpctc', {'Logits': [f(b, t, v)], 'Label': [i(v - 1, b, 30) + 1],
                     'LogitsLength': [rng.randint(80, t + 1, b)],
                     'LabelLength': [lab_len]},
         {'blank': 0, 'norm_by_times': True}),
        ('ctc_align', {'Input': [i(v, b, t)],
                       'InputLength': [rng.randint(50, t + 1, b)]},
         {'blank': 0, 'padding_value': -1}),
        ('edit_distance', {'Hyps': [i(30, b, 40)], 'Refs': [i(30, b, 40)],
                           'HypsLength': [rng.randint(0, 41, b)],
                           'RefsLength': [rng.randint(1, 41, b)]},
         {'normalized': True, 'ignored_tokens': [0]}),
        ('hierarchical_sigmoid', {'X': [f(128, 64)], 'W': [f(9999, 64)],
                                  'Bias': [f(9999)],
                                  'Label': [i(10000, 128)]},
         {'num_classes': 10000}),
        ('sample_logits', {'Logits': [f(128, 10000)],
                           'Labels': [i(10000, 128, 1)]},
         {'num_samples': 64, 'seed': 5}),
        ('cos_sim', {'X': [f(128, 64)], 'Y': [f(1, 64)]}, {}),
        ('pyramid_hash', {'X': [i(1 << 30, 8, 50)], 'W': [f(100003, 16)]},
         {'pyramid_layer': 4}),
        ('filter_by_instag', {'Ins': [f(64, 32)], 'Ins_tag': [i(8, 64)],
                              'Filter_tag': [np.array([1, 3, 5])]}, {}),
        ('var_conv_2d', {'X': [f(8, 2, 32, 32)], 'W': [f(4, 18)],
                         'Mask': [(rng.rand(8, 1, 32, 32) < 0.8).astype(
                             'float32')]},
         {'output_channel': 4, 'input_channel': 2}),
        ('tree_conv', {'NodesVector': [f(4, 30, 16)],
                       'EdgeSet': [np.array([[[(c - 1) // 2, c]
                                              for c in range(1, 30)]] * 4)],
                       'Filter': [f(16, 3, 8, 4)]}, {}),
        ('row_conv', {'X': [f(8, 100, 64)], 'Filter': [f(3, 64)]}, {}),
    ]
    for sampler in ('uniform', 'log_uniform', 'custom_dist'):
        attrs = {'num_neg_samples': 10, 'sampler': sampler, 'seed': 3,
                 'num_total_classes': 10000}
        if sampler == 'custom_dist':
            attrs['custom_dist'] = list(rng.dirichlet(np.ones(10000)))
        cases.append(('nce', {'Input': [f(128, 64)], 'Weight': [f(10000, 64)],
                              'Bias': [f(10000)], 'Label': [i(10000, 128, 1)]},
                      attrs))
    return cases


def lang_op_run(op, ins, attrs, dev, seed):
    """The op's outputs and its float inputs' gradients under seeded
    cotangents, on `dev`, all brought to the CPU."""
    ctx = registry.LowerCtx(step=3, op_seed=7, device=dev,
                            random_seed=seed + 1)
    opdef = registry.get(op)
    with torch.enable_grad():
        tins = {s: [torch.as_tensor(a, device=dev) for a in v]
                for s, v in ins.items()}
        xs = [x.requires_grad_() for v in tins.values() for x in v
              if x.is_floating_point()]
        outs = opdef.run(ctx, tins, attrs)
        gen = np.random.RandomState(seed)
        ys = [y for s, v in sorted(outs.items()) for y in v
              if s not in opdef.no_grad_out_slots and y.requires_grad]
        cts = [torch.as_tensor(np.asarray(gen.randn(*y.shape)).astype(
            'float32'), device=dev) for y in ys]
        grads = torch.autograd.grad(ys, xs, cts, allow_unused=True) \
            if ys and xs else []
    return ({s: [y.detach().cpu() for y in v] for s, v in outs.items()},
            [None if g is None else g.cpu() for g in grads])


def lang_ops_phase(seed, dev):
    """Phase 16 (c): every other new op type on the card, twice bitwise
    and against the same lowering on the CPU."""
    rng = np.random.RandomState(seed + 16)
    rows = []
    for op, ins, attrs in lang_op_cases(rng):
        first = lang_op_run(op, ins, attrs, dev, seed)
        second = lang_op_run(op, ins, attrs, dev, seed)
        cpu = lang_op_run(op, ins, attrs, 'cpu', seed)
        outs = [(s, a, b, c) for s in sorted(first[0]) for a, b, c in zip(
            first[0][s], second[0][s], cpu[0][s])]
        outs += [('grad %d' % k, a, b, c) for k, (a, b, c) in enumerate(zip(
            first[1], second[1], cpu[1])) if a is not None]
        twice = [s for s, a, b, _ in outs if not torch.equal(a, b)]
        worst, bad = 0.0, []
        for s, a, _, c in outs:
            if a.is_floating_point():
                err = max_abs(a, c) / max(c.abs().max().item(), 1e-30)
                worst = max(worst, err)
                if err > 1e-5:
                    bad.append('%s %.2e' % (s, err))
            elif not torch.equal(a, c):
                bad.append(s)
        label = op + (' ' + attrs['sampler'] if op == 'nce' else '')
        if twice or bad:
            raise AssertionError('%s on the card: second launch differs in '
                                 '%s; against the CPU: %s' % (
                                     label, twice, bad))
        rows.append('%s (%d outputs, %d gradients: %.1e)' % (
            label, sum(len(v) for v in first[0].values()),
            sum(g is not None for g in first[1]), worst))
    log('  on the card twice bitwise and against the CPU (integers and the '
        'samples exact, floats within 1e-5 of the largest magnitude): %s'
        % '; '.join(rows))


def lang_phase(seed, dev):
    """Phase 16: structured prediction and recompute."""
    log('[16] (a) label_semantic_roles (the book\'s db_lstm + CRF) on '
        'CUDAPlace(0) (%s | %s)' % (torch.cuda.get_device_name(0),
                                   card_line()))
    t0 = time.perf_counter()
    srl_phase(seed)
    log('  (a): %.1f s' % (time.perf_counter() - t0))
    log('[16] (b) BERT-base with RecomputeOptimizer(Adam), a checkpoint at '
        'each encoder layer')
    t0 = time.perf_counter()
    recompute_phase(seed)
    log('  (b): %.1f s' % (time.perf_counter() - t0))
    log('[16] (c) the other new op types on the card')
    t0 = time.perf_counter()
    without_counting(lambda: lang_ops_phase(seed, dev))
    log('  (c): %.1f s' % (time.perf_counter() - t0))


# ----------------------------------------------------------- phase 17
def mobilenet_path(seed):
    """MobileNetV3-Large BASE (models.mobilenet_v3) with the paper's
    RMSProp + L2 + EMA recipe at batch 128, 224 x 224: the path dict
    that train() runs.  Its one kernel pair (the dropout forward and
    gradient) is bitwise its plain version, so the whole step is
    (bitwise) under cuDNN's deterministic algorithms."""
    cfg = mobilenet_v3.BASE
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed + 1
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        _, _, loss, _ = mobilenet_v3.build_train(fluid, cfg)
    batch = mobilenet_v3.synthetic_batch(cfg, np.random.RandomState(seed))
    expected = {k: 0 for k in common.KERNELS}
    expected.update(dropout_launches(main))
    names = sorted(p.name for p in main.all_parameters() if p.trainable)
    return {'name': 'MobileNetV3-Large RMSProp', 'main': main,
            'startup': startup, 'loss': loss, 'lr': None, 'batch': batch,
            'expected': expected, 'probe': [names[0], names[-1]],
            'tokens': cfg.batch, 'unit': 'images', 'rate': cfg.lr,
            'bitwise': True}


def mobilenet_shares(run):
    """One profiled eager step of the MobileNetV3 run: its device time,
    the share of the depthwise convolutions' kernels (forward and
    backward, by kernel name) and of the rmsprop ops (their kernels,
    under a record_function range around each op's lowering)."""
    from torch.autograd import DeviceType
    from torch.profiler import record_function
    path = run['path']
    od = registry.get('rmsprop')
    fn = od.fn

    def ranged(ctx, ins, attrs):
        with record_function('rmsprop op'):
            return fn(ctx, ins, attrs)
    od.fn = ranged
    try:
        with fluid.scope_guard(run['scope']):
            events = profile_run('', lambda: eager_run(
                run['exe'], path['main'], path['batch'], [path['loss']]),
                quiet=True, pad=True)
    finally:
        od.fn = fn
    # the device rows without the range's own (its wall span on the
    # stream, gaps included)
    kernels = [e for e in events if e.device_type == DeviceType.CUDA and
               e.key != 'rmsprop op']
    total = sum(e.self_device_time_total for e in kernels) / 1e3
    dw = [e for e in kernels if 'depthwise' in e.key.lower()]
    dw_ms = sum(e.self_device_time_total for e in dw) / 1e3
    ranges = [e for e in events if e.key == 'rmsprop op' and
              e.device_type == DeviceType.CPU]
    rms_ms = sum(e.device_time_total for e in ranges) / 1e3
    n_rms = sum(e.count for e in ranges)
    log('  one profiled eager step: device %.2f ms in %d kernels; the '
        'depthwise convolutions %.2f ms (%.1f%%, %d launches of %s); the '
        '%d rmsprop ops %.2f ms (%.1f%%) (%s | %s)' % (
            total, sum(e.count for e in kernels), dw_ms,
            100 * dw_ms / total, sum(e.count for e in dw),
            sorted({k for e in dw for k in e.key.replace('(', ' ').split()
                    if 'depthwise' in k.lower()}), n_rms, rms_ms,
            100 * rms_ms / total, torch.cuda.get_device_name(0),
            card_line()))
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    for e in top:
        log('    %-60s %9.3f ms in %d launches' % (
            e.key[:60], e.self_device_time_total / 1e3, e.count))


def mobilenet_phase(seed):
    """Phase 17 (a): MobileNetV3-Large trained by the paper's recipe."""
    saved = torch.backends.cudnn.deterministic, \
        torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        path = mobilenet_path(seed)
        names = weights.startup_names(path['startup'])
        log('  %d trainable parameters (%d elements), %d state variables '
            '(%d EMA, %d RMSProp accumulators), batch %d at %d x %d' % (
                sum(p.trainable for p in path['main'].all_parameters()),
                mobilenet_v3.count_parameters(path['main']), len(names),
                sum(n.endswith('.ema') for n in names),
                sum(any(a in n for a in ('_momentum_', '_mean_square_',
                                         '_mean_grad_')) for n in names),
                mobilenet_v3.BASE.batch, mobilenet_v3.BASE.image,
                mobilenet_v3.BASE.image))
        run = train(path)
        # the step's host clock, self CPU, device time and peak, uncached,
        # cached eager and replayed
        without_counting(lambda: plan_cache_steps(run))
        log('  (%s | %s)' % (torch.cuda.get_device_name(0), card_line()))
        without_counting(lambda: mobilenet_shares(run))
    finally:
        torch.backends.cudnn.deterministic, \
            torch.backends.cudnn.benchmark = saved
    del run
    gc.collect()
    torch.cuda.empty_cache()


# phase 17 (b): the other optimizer classes of the core slice, each as
# (label, build(optimizer module, loss)) on LeNet-5
CORE_OPTIMIZERS = (
    ('LarsMomentum', lambda o, loss: o.LarsMomentum(
        0.01, 0.9, lars_coeff=0.01).minimize(loss)),
    ('Adamax', lambda o, loss: o.Adamax(1e-3).minimize(loss)),
    ('Adadelta', lambda o, loss: o.Adadelta(1.0, rho=0.9).minimize(loss)),
    ('RMSProp centered', lambda o, loss: o.RMSProp(
        1e-3, rho=0.9, epsilon=1e-3, momentum=0.9,
        centered=True).minimize(loss)),
    ('Ftrl', lambda o, loss: o.Ftrl(0.01, l1=1e-3, l2=1e-3).minimize(loss)),
    ('Dpsgd (sigma 0)', lambda o, loss: o.Dpsgd(
        0.01, clip=1.0, sigma=0.0).minimize(loss)),
    ('DecayedAdagrad', lambda o, loss: o.DecayedAdagrad(
        0.01, decay=0.9).minimize(loss)),
    ('DGCMomentum', lambda o, loss: o.DGCMomentumOptimizer(
        0.01, 0.9, sparsity=[0.75]).minimize(loss)),
    ('ModelAverage over Momentum', lambda o, loss: (
        o.Momentum(0.01, 0.9).minimize(loss), o.ModelAverage(0.15))[1]),
    ('Lookahead over SGD (k 2)', lambda o, loss: o.LookaheadOptimizer(
        o.SGD(0.01), alpha=0.5, k=2).minimize(loss)),
)
# LeNet-5 on the card against the CPU in float64: the loss and each
# state variable within CORE_TOL (relative, plus CORE_TOL of the largest
# of its kind), the tolerance the optimizers' CPU tests state.  In f32 the
# convolutions' rounding (cuDNN's order against oneDNN's) moves the
# gradients, which first steps amplify where the update is a ratio of
# gradient sums (FTRL, Adadelta); in f64 it stays far below.  The f32
# witness holds the card's update ops alone at CORE_TOL, fed the CPU
# step's gradients, and logs how far the card's own f32 gradients and
# whole step land from the CPU's
CORE_TOL = 1e-5
CORE_LENET_BATCH = 16


def state_group(name, params):
    """The kind of a state variable: its accumulator's suffix after the
    parameter's name, or 'state' (parameters, counters): each compared
    within CORE_TOL of the largest magnitude of its kind."""
    for p in params:
        if name.startswith(p) and name != p:
            return name[len(p):].rstrip('0123456789')
    return 'state'


def state_distance(state, want, params):
    """The worst distance of `state` from `want` as a share of its limit
    (CORE_TOL relative, plus CORE_TOL of the largest magnitude of its
    kind in `want`), and the variables over it."""
    scale = {}
    for n in want:
        g = state_group(n, params)
        scale[g] = max(scale.get(g, 0.0),
                       float(np.abs(want[n]).max(initial=0.0)))
    worst, over = 0.0, []
    for n in want:
        a, b = state[n].astype(np.float64), want[n].astype(np.float64)
        err = np.abs(a - b) - CORE_TOL * np.abs(b)
        lim = CORE_TOL * scale[state_group(n, params)]
        e = float(err.max(initial=0.0))
        worst = max(worst, e / max(lim, 1e-30))
        if e > lim:
            over.append('%s (%.3g over %.3g)' % (n, e, lim))
    return worst, over


def lenet_optimizer_program(seed, build, dtype):
    """LeNet-5 under `build` with `dtype` images: (main, startup, loss,
    what build returned)."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed + 1
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        img = fluid.layers.data('img', shape=[1, 28, 28], dtype=dtype)
        _, _, loss, _ = lenet.build(img=img)
        extra = build(fluid.optimizer, loss)
    return main, startup, loss, extra


def lenet_feeds(seed, dtype):
    """3 batches of CORE_LENET_BATCH synthetic MNIST images."""
    imgs, labels = mnist._synthetic(CORE_LENET_BATCH * 3, seed + 17)
    imgs = imgs.astype(dtype)
    return [{'img': imgs[k::3].reshape(-1, 1, 28, 28),
             'label': labels[k::3].reshape(-1, 1)} for k in range(3)]


def update_program(main):
    """`main` with only its optimize-role ops, and the names those read
    that neither the scope holds nor an earlier of them writes (the
    gradients): what the step's updates see of its backward."""
    upd = main.clone()
    block = upd.global_block()
    for k in reversed(range(len(block.ops))):
        if block.ops[k].attrs.get('__op_role__') != 'optimize':
            block._remove_op(k)
    written, fed = set(), []
    for op in block.ops:
        for names in op.inputs.values():
            for n in names:
                v = block._find_var_recursive(n)
                if n not in written and n not in fed and not (
                        v is not None and v.persistable):
                    fed.append(n)
        for names in op.outputs.values():
            written.update(names)
    return upd, fed


def core_optimizer_witness(seed, label, build, place):
    """The f32 witness of the float64 lockstep: 3 LeNet-5 steps on the
    CPU; on `place`, from the CPU's state before each step, (1) the
    step's update ops alone fed the CPU step's gradients, the state held
    within CORE_TOL as in the lockstep, and (2) the whole f32 step, whose
    gradients' and state's distance from the CPU's is returned, not held.
    Returns (the update ops' worst share of the limit, the worst gradient
    distance as a share of its largest magnitude, the whole step's worst
    share of the state limit)."""
    main, startup, loss, _ = lenet_optimizer_program(seed, build, 'float32')
    upd, fed = update_program(main)
    names = weights.startup_names(startup)
    params = sorted((p.name for p in main.all_parameters()),
                    key=lambda s: -len(s))
    cpu_exe, cpu_scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    exe, scope = fluid.Executor(place), fluid.Scope()
    with fluid.scope_guard(cpu_scope):
        cpu_exe.run(startup)
    with fluid.scope_guard(scope):
        exe.run(startup)
    upd_worst = grad_worst = step_worst = 0.0
    for k, feed in enumerate(lenet_feeds(seed, np.float32)):
        with fluid.scope_guard(cpu_scope):
            before = weights.numpy_state(cpu_scope, names)
            out = cpu_exe.run(main, feed=feed, fetch_list=[loss] + fed)
            after = weights.numpy_state(cpu_scope, names)
        grads = dict(zip(fed, out[1:]))
        with fluid.scope_guard(scope):
            weights.load_numpy_params(scope, before, place, startup)
            exe._step = cpu_exe._step - 1
            eager_run(exe, upd, grads, [])
            share, over = state_distance(weights.numpy_state(scope, names),
                                         after, params)
            if over:
                raise AssertionError(
                    '%s f32 step %d: the update ops on the card, fed the '
                    'CPU\'s gradients, against the CPU: %s' % (
                        label, k + 1, over[:6]))
            upd_worst = max(upd_worst, share)
            weights.load_numpy_params(scope, before, place, startup)
            exe._step = cpu_exe._step - 1
            mine = eager_run(exe, main, feed, [loss] + fed)[1:]
            step_worst = max(step_worst, state_distance(
                weights.numpy_state(scope, names), after, params)[0])
        for n, a in zip(fed, mine):
            b = grads[n]
            grad_worst = max(grad_worst, float(np.abs(a - b).max()) /
                             max(float(np.abs(b).max()), 1e-30))
    return upd_worst, grad_worst, step_worst


def core_optimizer_lockstep(seed, label, build):
    """3 steps of LeNet-5 under `build` on the card, each from the
    port's CPU state before the same step on the CPU, in float64: the
    loss and every state variable within CORE_TOL (relative, plus
    CORE_TOL of the largest magnitude of its kind).  Returns the worst
    error as a share of its limit and a note of ModelAverage's apply /
    restore check."""
    main, startup, loss, extra = lenet_optimizer_program(seed, build,
                                                         'float64')
    feeds = lenet_feeds(seed, np.float64)
    names = weights.startup_names(startup)
    params = sorted((p.name for p in main.all_parameters()),
                    key=lambda s: -len(s))
    cpu_exe, cpu_scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    worst = 0.0
    with fluid.scope_guard(cpu_scope):
        cpu_exe.run(startup)
    with fluid.scope_guard(scope):
        exe.run(startup)
    for k, feed in enumerate(feeds):
        with fluid.scope_guard(cpu_scope):
            before = weights.numpy_state(cpu_scope, names)
            want = float(cpu_exe.run(main, feed=feed, fetch_list=[loss])[0])
            after = weights.numpy_state(cpu_scope, names)
        with fluid.scope_guard(scope):
            weights.load_numpy_params(scope, before, fluid.CUDAPlace(0),
                                      startup)
            exe._step = cpu_exe._step - 1
            got = float(eager_run(exe, main, feed, [loss])[0])
            state = weights.numpy_state(scope, names)
        bad = []
        # rtol plus the atol of a scalar's own magnitude, as close() holds
        if not abs(got - want) <= 2 * CORE_TOL * abs(want):
            bad.append('loss %r vs %r' % (got, want))
        share, over = state_distance(state, after, params)
        worst = max(worst, share)
        bad += over
        if bad:
            raise AssertionError('%s step %d on the card against the CPU: '
                                 '%s' % (label, k + 1, bad[:6]))
    note = ''
    if not hasattr(extra, 'apply'):
        return worst, note
    # ModelAverage: apply() / restore() on both, into the scope's tensors
    ps = [p.name for p in main.all_parameters() if p.trainable]
    out = {}
    for key, sc in (('cpu', cpu_scope), ('card', scope)):
        with fluid.scope_guard(sc):
            ptrs = [core.as_array(sc.find_var(n)).data_ptr() for n in ps]
            base = weights.numpy_state(sc, ps)
            with extra.apply():
                avg = weights.numpy_state(sc, ps)
                same = ptrs == [core.as_array(sc.find_var(n)).data_ptr()
                                for n in ps]
            out[key] = (base, avg, weights.numpy_state(sc, ps), same)
    for n in ps:
        b = out['cpu'][1][n]
        if not (out['card'][3] and out['cpu'][3] and np.array_equal(
                out['card'][2][n], out['card'][0][n]) and np.allclose(
                out['card'][1][n], b, rtol=0,
                atol=CORE_TOL * np.abs(b).max())):
            raise AssertionError('ModelAverage apply/restore on the card: '
                                 '%s' % n)
    return worst, '; apply() averaged and restore() put back %d ' \
        'parameters in their own tensors, as on the CPU' % len(ps)


def dpsgd_noise_check(dev):
    """The dpsgd op's noise on the card at LeNet-5's largest parameter
    (fc 800 x 10 -> 8000, tiled to 400,000 elements) with zero gradient:
    mean 0 and std sigma * clip within 5 sigma of the sampling error,
    and the same draws on the CPU (the hash is integer arithmetic; the
    inverse CDF within 1e-5)."""
    n = 400000
    ins = {'Param': [torch.zeros(n, device=dev)],
           'Grad': [torch.zeros(n, device=dev)],
           'LearningRate': [torch.ones(1, device=dev)]}
    attrs = {'clip': 0.5, 'sigma': 2.0}
    ctx = registry.LowerCtx(step=3, op_seed=5, device=dev, random_seed=1)
    noise = -registry.get('dpsgd').run(ctx, ins, attrs)['ParamOut'][0]
    cpu_ctx = registry.LowerCtx(step=3, op_seed=5, device='cpu',
                                random_seed=1)
    cpu = -registry.get('dpsgd').run(cpu_ctx, {k: [v[0].cpu()] for k, v in
                                               ins.items()},
                                     attrs)['ParamOut'][0]
    noise = noise.double().cpu()
    mean, std = noise.mean().item(), noise.std().item()
    err = max_abs(noise.float(), cpu) / cpu.abs().max().item()
    if abs(mean) > 5 / n ** 0.5 or abs(std - 1.0) > 5 / (2 * n) ** 0.5 or \
            err > 1e-5:
        raise AssertionError('dpsgd noise on the card: mean %g, std %g, '
                             'against the CPU %.2e' % (mean, std, err))
    return mean, std, err


def core_optimizers_phase(seed, dev):
    """Phase 17 (b)."""
    rows, witness = [], []
    for label, build in CORE_OPTIMIZERS:
        t0 = time.perf_counter()
        worst, note = core_optimizer_lockstep(seed, label, build)
        rows.append('%s (worst %.1e of the tolerance%s; %.1f s)' % (
            label, worst, note, time.perf_counter() - t0))
        t0 = time.perf_counter()
        upd, grad, step = core_optimizer_witness(seed, label, build,
                                                 fluid.CUDAPlace(0))
        witness.append('%s (update ops %.1e of the tolerance; the card\'s '
                       'own gradients %.1e of their largest, its whole '
                       'step %.1e of the tolerance; %.1f s)' % (
                           label, upd, grad, step,
                           time.perf_counter() - t0))
    mean, std, err = dpsgd_noise_check(dev)
    log('  3 LeNet-5 steps each (float64, batch %d) on the card, each from '
        'the CPU\'s state before the same step, the loss and the state '
        'within %g (relative, plus %g of the largest of its kind): %s' % (
            CORE_LENET_BATCH, CORE_TOL, CORE_TOL, '; '.join(rows)))
    log('  the f32 witness, each step from the CPU\'s state: the update '
        'ops alone on the card fed the CPU step\'s gradients, held within '
        '%g as above; the whole f32 step on the card, not held: %s' % (
            CORE_TOL, '; '.join(witness)))
    log('  dpsgd noise (sigma 2, clip 0.5, 400,000 elements): mean %.2e, '
        'std / (sigma * clip) %.5f, against the CPU %.1e' % (
            mean, std, err))


def core_op_cases(rng):
    """Every op type of the core slice at a size its users run: (op,
    inputs, attrs).  tests/test_torch_coverage.py holds the list of
    those op types and checks that each has a case here."""
    f = lambda *s: rng.randn(*s).astype('float32')  # noqa: E731
    pos = lambda *s: rng.uniform(0.1, 3.0, s).astype('float32')  # noqa
    unit = lambda *s: rng.uniform(-0.9, 0.9, s).astype('float32')  # noqa
    i = lambda hi, *s: rng.randint(0, hi, s).astype('int64')  # noqa: E731
    # a MobileNetV3 activation at batch 4 (the expansion of block 3)
    act = f(4, 72, 56, 56)
    cases = []
    for op in ('abs', 'ceil', 'round', 'square', 'atan', 'sinh', 'cosh',
               'erf', 'softsign', 'softplus', 'logsigmoid', 'silu',
               'tanh_shrink', 'sin', 'tan', 'mish', 'selu', 'stanh'):
        cases.append((op, {'X': [act]}, {}))
    for op in ('rsqrt', 'log2', 'log10', 'log1p'):
        cases.append((op, {'X': [pos(4, 72, 56, 56)]}, {}))
    for op in ('acos', 'asin'):
        cases.append((op, {'X': [unit(4, 72, 56, 56)]}, {}))
    cases += [
        ('leaky_relu', {'X': [act]}, {'alpha': 0.1}),
        ('elu', {'X': [act]}, {'alpha': 1.0}),
        ('relu6', {'X': [act * 4]}, {'threshold': 6.0}),
        ('brelu', {'X': [act]}, {'t_min': -1.0, 't_max': 1.0}),
        ('hard_sigmoid', {'X': [act * 4]}, {'slope': 1.0 / 6, 'offset': 0.5}),
        ('hard_swish', {'X': [act * 4]}, {}),
        ('swish', {'X': [act]}, {'beta': 1.0}),
        ('thresholded_relu', {'X': [act]}, {'threshold': 1.0}),
        ('hard_shrink', {'X': [act]}, {'threshold': 0.5}),
        ('soft_shrink', {'X': [act]}, {'lambda': 0.5}),
        ('softshrink', {'X': [act]}, {'lambda': 0.5}),
        ('prelu', {'X': [act], 'Alpha': [pos(72) / 10]}, {'mode': 'channel'}),
        ('maxout', {'X': [act]}, {'groups': 4}),
        ('reduce_mean', {'X': [act]}, {'dim': [2, 3], 'keep_dim': True}),
        ('reduce_max', {'X': [act]}, {'dim': [1]}),
        ('reduce_min', {'X': [act]}, {'reduce_all': True}),
        ('reduce_prod', {'X': [pos(64, 32) / 2 + 0.5]}, {'dim': [1]}),
        ('reduce_all', {'X': [act > -3]}, {'dim': [1, 2]}),
        ('reduce_any', {'X': [act > 3]}, {'dim': [0]}),
        ('dot', {'X': [f(1024, 768)], 'Y': [f(1024, 768)]}, {}),
        ('isfinite', {'X': [act, f(1000)]}, {}),
        ('isinf', {'X': [act]}, {}),
        ('isnan', {'X': [act]}, {}),
        ('p_norm', {'X': [f(1024, 768)]}, {'porder': 2.0, 'axis': -1}),
        ('arg_min', {'X': [f(1024, 1000)]}, {'axis': -1}),
        ('top_k_v2', {'X': [f(1024, 1000)]}, {'k': 5}),
        ('argsort', {'X': [f(256, 1000)]}, {'axis': -1, 'descending': True}),
        ('norm', {'X': [f(1024, 768)]}, {'axis': 1, 'epsilon': 1e-10}),
        ('cholesky', {'X': [(lambda a: a @ a.transpose(0, 2, 1) +
                             64 * np.eye(64, dtype='float32'))(
                                 f(32, 64, 64))]}, {}),
        ('inverse', {'Input': [f(32, 64, 64) + 16 * np.eye(
            64, dtype='float32')]}, {}),
        ('flatten2', {'X': [act]}, {'axis': 1}),
        ('flatten', {'X': [act]}, {'axis': 2}),
        ('flatten_contiguous_range', {'X': [act]},
         {'start_axis': 1, 'stop_axis': 3}),
        ('strided_slice', {'Input': [act]}, {'axes': [2, 3],
                                             'starts': [1, 55],
                                             'ends': [56, 0],
                                             'strides': [2, -3]}),
        ('expand_as', {'X': [f(128, 1, 768)],
                       'target_tensor': [f(128, 16, 768)]}, {}),
        ('tile', {'X': [f(128, 1, 768)]}, {'repeat_times': [1, 16, 1]}),
        ('unstack', {'X': [f(16, 128, 768)]}, {'axis': 0}),
        # distinct rows (and below distinct ids): a gradient summed by
        # atomics over repeated rows would not repeat bitwise
        ('gather_nd', {'X': [f(32, 128, 768)],
                       'Index': [np.stack(np.divmod(rng.permutation(4096),
                                                    128), 1)]}, {}),
        ('scatter', {'X': [f(8192, 768)],
                     'Ids': [rng.permutation(8192)[:4096].astype('int64')],
                     'Updates': [f(4096, 768)]}, {'overwrite': True}),
        ('embedding', {'W': [f(8192, 768)], 'Ids': [i(8192, 32, 128)]},
         {'padding_idx': 0}),
        ('cumsum', {'X': [f(128, 4096)]}, {'axis': 1, 'exclusive': True,
                                           'reverse': True}),
        ('pad', {'X': [act]}, {'paddings': [0, 0, 0, 0, 1, 1, 1, 1],
                               'pad_value': 0.0}),
        ('pad2d', {'X': [act]}, {'paddings': [1, 1, 2, 2],
                                 'mode': 'constant', 'pad_value': 0.5}),
        ('where', {'Condition': [act > 0], 'X': [act], 'Y': [act * 2]}, {}),
        ('where_index', {'Condition': [f(256, 1024) > 1.5]},
         {'capacity': 20000}),
        ('diag', {'Diagonal': [f(1024)]}, {}),
        ('flip', {'X': [act]}, {'axis': [2, 3]}),
        ('reverse', {'X': [act]}, {'axis': [1]}),
        ('roll', {'X': [act]}, {'shifts': [3, -5], 'axis': [2, 3]}),
        ('tril_triu', {'X': [f(4, 512, 512)]}, {'lower': True,
                                                 'diagonal': 0}),
        ('index_select', {'X': [f(8192, 768)],
                          'Index': [rng.permutation(8192)[:4096]]},
         {'dim': 0}),
        ('minus', {'X': [act], 'Y': [act * 0.5]}, {}),
        ('share_data', {'X': [act]}, {}),
        ('split_byref', {'X': [act]}, {'axis': 1, 'num': 4}),
        ('coalesce_tensor', {'Input': [f(768, 768), f(768), f(3072, 768)]},
         {}),
        ('shuffle_batch', {'X': [f(4096, 64)]}, {}),
        ('truncated_gaussian_random', {}, {'shape': [768, 3072],
                                           'mean': 0.0, 'std': 0.02}),
        ('uniform_random_batch_size_like', {'Input': [f(4096, 1)]},
         {'shape': [-1, 768], 'min': -1.0, 'max': 1.0}),
        ('eye', {}, {'num_rows': 1024, 'num_columns': 768}),
        ('tensor_array_to_tensor', {'X': [f(64, 32, 512)]},
         {'axis': 1, 'length': 50}),
    ]
    p, g = f(768, 768), f(768, 768) * 0.01
    m2 = pos(768, 768) * 1e-4
    lr = np.array([0.01], 'float32')
    cases += [
        ('lars_momentum', {'Param': [p], 'Grad': [g], 'Velocity': [g],
                           'LearningRate': [lr]}, {'mu': 0.9}),
        ('adamax', {'Param': [p], 'Grad': [g], 'Moment': [g],
                    'InfNorm': [m2], 'Beta1Pow': [np.array([0.729],
                                                           'float32')],
                    'LearningRate': [lr]}, {}),
        ('adadelta', {'Param': [p], 'Grad': [g], 'AvgSquaredGrad': [m2],
                      'AvgSquaredUpdate': [m2]}, {'rho': 0.95}),
        ('rmsprop', {'Param': [p], 'Grad': [g], 'Moment': [g],
                     'MeanSquare': [m2], 'MeanGrad': [g * 0.1],
                     'LearningRate': [lr]},
         {'decay': 0.9, 'epsilon': 1e-3, 'momentum': 0.9,
          'centered': True}),
        ('ftrl', {'Param': [p], 'Grad': [g], 'SquaredAccumulator': [m2],
                  'LinearAccumulator': [g], 'LearningRate': [lr]},
         {'l1': 1e-3, 'l2': 1e-3}),
        ('dpsgd', {'Param': [p], 'Grad': [g], 'LearningRate': [lr]},
         {'clip': 1.0, 'sigma': 1.0}),
        ('proximal_gd', {'Param': [p], 'Grad': [g], 'LearningRate': [lr]},
         {'l1': 1e-3, 'l2': 1e-3}),
        ('dgc', {'Grad': [g], 'U': [g], 'V': [g]},
         {'m': 0.9, 'sparsity_ratio': 0.999}),
        ('decayed_adagrad', {'Param': [p], 'Grad': [g], 'Moment': [m2],
                             'LearningRate': [lr]}, {'decay': 0.95}),
    ]
    return cases


def core_ops_phase(seed, dev):
    """Phase 17 (c): every op type of the core slice on the card, twice
    bitwise and against the same lowering on the CPU, as phase 16 (c)
    holds its ops."""
    rng = np.random.RandomState(seed + 17)
    cases = core_op_cases(rng)
    worst_all, n_out = 0.0, 0
    for op, ins, attrs in cases:
        first = lang_op_run(op, ins, attrs, dev, seed)
        second = lang_op_run(op, ins, attrs, dev, seed)
        cpu = lang_op_run(op, ins, attrs, 'cpu', seed)
        outs = [(s, a, b, c) for s in sorted(first[0]) for a, b, c in zip(
            first[0][s], second[0][s], cpu[0][s])]
        outs += [('grad %d' % k, a, b, c) for k, (a, b, c) in enumerate(zip(
            first[1], second[1], cpu[1])) if a is not None]
        twice = [s for s, a, b, _ in outs if not torch.equal(a, b)]
        bad = []
        for s, a, _, c in outs:
            n_out += 1
            if a.is_floating_point():
                err = max_abs(a, c) / max(c.abs().max().item(), 1e-30)
                worst_all = max(worst_all, err)
                if err > 1e-5:
                    bad.append('%s %.2e' % (s, err))
            elif not torch.equal(a, c):
                bad.append(s)
        if twice or bad:
            raise AssertionError('%s on the card: second launch differs in '
                                 '%s; against the CPU: %s' % (op, twice, bad))
    log('  %d op types (%d cases, %d outputs and gradients) on the card '
        'twice bitwise and against the CPU (integers exact, floats within '
        '1e-5 of the largest magnitude; worst %.1e)' % (
            len({op for op, _, _ in cases}), len(cases), n_out, worst_all))


def core_phase(seed, dev):
    """Phase 17: the core layers, ops and optimizers."""
    log('[17] (a) MobileNetV3-Large, RMSProp + L2 + EMA (the paper\'s '
        'recipe), on CUDAPlace(0) (%s | %s)' % (
            torch.cuda.get_device_name(0), card_line()))
    t0 = time.perf_counter()
    mobilenet_phase(seed)
    log('  (a): %.1f s' % (time.perf_counter() - t0))
    log('[17] (b) the other optimizer classes on LeNet-5')
    t0 = time.perf_counter()
    without_counting(lambda: core_optimizers_phase(seed, dev))
    log('  (b): %.1f s' % (time.perf_counter() - t0))
    log('[17] (c) the core op types on the card')
    t0 = time.perf_counter()
    without_counting(lambda: core_ops_phase(seed, dev))
    log('  (c): %.1f s' % (time.perf_counter() - t0))


# ----------------------------------------------------------- phase 18
OBS_EAGER_STEPS = 3   # (a) Default-profiled eager BERT-base steps
OBS_TRACE_STEPS = 16  # (b) steps a side with the tracer off and on
OBS_CPU_REPEATS = 9   # (h) profiled steps a side and order
OBS_UNATTRIBUTED_MAX = 0.05  # (a) the eager steps' unattributed share
OBS_MEM_SLACK = 1 << 20  # (f) census against memory_allocated, read apart


def fresh_run(path):
    """A path's startup program run on a new executor and scope (not
    counted): the run dict the phase's helpers take."""
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(path['startup'])
    return {'path': path, 'exe': exe, 'scope': scope}


def free_run(run):
    drop_graphs(run['path']['main'], run['scope'])
    run.clear()
    gc.collect()
    torch.cuda.empty_cache()


def quiet_profile(tracer_option, fn):
    """fn() under fluid.profiler.profiler(tracer_option); the table it
    prints is kept, not printed (the phase logs its own rows)."""
    with quiet_steps():
        with fluid.profiler.profiler('All', tracer_option=tracer_option):
            fn()
            torch.cuda.synchronize()
    return fluid.profiler.summary_records()


def log_rows(rows, n, unit_steps=1, unit='calls'):
    for t, r in sorted(rows.items(), key=lambda kv: -kv[1]['total'])[:n]:
        log('    %-44s %6d %s %10.3f ms' % (
            t[:44], r['calls'] // unit_steps, unit,
            r['total'] * 1e3 / unit_steps))


def obs_profile(seed, card):
    """(a) BERT-base Adam (seq 512, batch 8): OBS_EAGER_STEPS cached eager
    steps under the 'Default' profiler (torch.profiler, CUPTI), the
    per-op device table whose rows, unattributed included, sum to the
    profiled device time; K1's and K2's kernels under
    fused_multihead_attention and its grad; the op-cost worklist naming
    K1 as the cover of the attention runs; then one 'Serial' step."""
    run = fresh_run(pretrain_program(seed, 'adam'))
    path, exe, scope = run['path'], run['exe'], run['scope']
    main, feed, fetch = path['main'], path['batch'], [path['loss']]
    with fluid.scope_guard(scope):
        eager_run(exe, main, feed, fetch)
        rows = quiet_profile('Default', lambda: [
            eager_run(exe, main, feed, fetch)
            for _ in range(OBS_EAGER_STEPS)])
        last = fluid.profiler.last_profile()
        events = fluid.profiler.last_events()
        serial = quiet_profile('Serial', lambda: exe.run(
            main, feed=feed, fetch_list=fetch))
    dev = last['device']
    total = sum(r['total'] for r in rows.values()) * 1e3
    unattr = sum(r['total'] for t, r in rows.items()
                 if t.startswith('unattributed/')) * 1e3
    log('  (a) %d cached eager steps under profiler(\'All\', '
        'tracer_option=\'Default\') (%s | %s): %d device events on %d '
        'streams, summed %.3f ms a step, union over the streams %.3f ms a '
        'step; the table\'s %d rows sum to %.3f ms a step (%.4f%% off the '
        'device sum), unattributed %.3f ms a step (%.2f%%); the rows by '
        'total device time a step:' % (
            OBS_EAGER_STEPS, torch.cuda.get_device_name(0), card,
            dev['events'], dev['streams'], dev['sum_ms'] / OBS_EAGER_STEPS,
            dev['union_ms'] / OBS_EAGER_STEPS, len(rows),
            total / OBS_EAGER_STEPS,
            100 * abs(total - dev['sum_ms']) / dev['sum_ms'],
            unattr / OBS_EAGER_STEPS, 100 * unattr / total))
    log_rows(rows, 20, OBS_EAGER_STEPS, 'kernels')
    kern = last['kernels']
    fa = kern.get('fused_multihead_attention', [])
    fa_grad = kern.get('fused_multihead_attention_grad', [])
    log('    fused_multihead_attention holds %s; its grad holds %s' % (
        sorted({fluid.profiler._kernel_label(k) for k in fa}),
        sorted({fluid.profiler._kernel_label(k) for k in fa_grad})))
    if abs(total - dev['sum_ms']) > 0.01 * dev['sum_ms']:
        raise AssertionError('the profiler rows sum to %.3f ms, the device '
                             'events to %.3f ms' % (total, dev['sum_ms']))
    if not any('flash_fwd' in k for k in fa) or \
            not any('flash_bwd' in k for k in fa_grad):
        raise AssertionError('K1/K2 not under fused_multihead_attention '
                             '/ _grad: %s / %s' % (fa, fa_grad))
    if unattr > OBS_UNATTRIBUTED_MAX * total:
        raise AssertionError('%.1f%% of the eager steps\' device time is '
                             'unattributed' % (100 * unattr / total))
    fluid.opprof.reset()
    fluid.opprof.record_capture(events, program='bert512',
                                steps=OBS_EAGER_STEPS)
    worklist = fluid.opprof.kernel_worklist(limit=64)
    covers = {r['op_type']: r['covered_by'] for r in worklist
              if r['covered_by']}
    log('  (a) opprof.kernel_worklist over the capture, the first 8 of %d '
        'runs (ms a step, covering kernel):' % len(worklist))
    for r in worklist[:8]:
        log('    #%d %-34s %4d ops %9.3f ms  %s' % (
            r['rank'], r['op_type'][:34], len(r['ops']), r['ms_per_step'],
            r['covered_by']))
    log('    runs a hand-written kernel covers: %s' % covers)
    if covers.get('fused_multihead_attention') != 'flash_attention' or \
            covers.get('fused_multihead_attention_grad') != \
            'flash_attention_bwd':
        raise AssertionError('the worklist does not name K1/K2: %s' % covers)
    fluid.opprof.reset()
    log('  (a) one \'Serial\' step (op by op, the card synchronized around '
        'each op; every grad op replays its forward op), host ms by op '
        'type:')
    log_rows(serial, 12)
    if serial.get('fused_multihead_attention', {}).get('calls') != \
            serial.get('fused_multihead_attention_grad', {}).get('calls'):
        raise AssertionError('Serial table: %s' % sorted(serial))
    return run


def timed_steps(fn, n):
    secs = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        secs.append(time.perf_counter() - t0)
    return secs


def obs_trace(run, card, health_checks):
    """(b) FLAGS_trace off against on over the same replayed and cached
    eager BERT-base steps (the loss fetched to numpy, so each ends after
    its last kernel), the tracer switched at every step; the replayed
    step's capture records no span and counts once.  Then the status
    plane is read from another thread while replayed steps run (g)."""
    path, exe, scope = run['path'], run['exe'], run['scope']
    main, feed, fetch = path['main'], path['batch'], [path['loss']]
    trace, monitor = fluid.trace, fluid.monitor
    with fluid.scope_guard(scope):
        drop_graphs(main, scope)
        trace.reset()
        trace.enable(buffer_steps=64)
        calls = monitor.counter_value('executor/run_calls')
        for _ in range(2):   # the first run eager, the second captured
            exe.run(main, feed=feed, fetch_list=fetch)
        recs = trace.steps()
        capture = [s[0] for s in recs[-1]['spans']]
        trace.disable()
        if len(recs) != 2 or \
                monitor.counter_value('executor/run_calls') != calls + 2 or \
                'bind' in capture or capture.count('dispatch') != 1:
            raise AssertionError('the capturing step recorded %s (%d step '
                                 'records)' % (capture, len(recs)))

        def eager_step():
            # the cached plan run eagerly is the executor's inner entry:
            # the step span Executor.run would open is opened here
            with trace.step_span(exe._step + 1):
                return eager_run(exe, main, feed, fetch)
        sides = (('replayed', lambda: exe.run(main, feed=feed,
                                              fetch_list=fetch)),
                 ('cached eager', eager_step))
        out = {}
        for label, fn in sides:
            fn()
            trace.reset()
            secs = {'off': [], 'on': []}
            for i in range(2 * OBS_TRACE_STEPS):
                state = ('off', 'on')[i % 2]
                if state == 'on':
                    trace.enable(buffer_steps=2 * OBS_TRACE_STEPS)
                else:
                    trace.disable()
                secs[state] += timed_steps(fn, 1)
            trace.disable()
            rep = trace.step_report()
            med = {k: statistics.median(v) * 1e3 for k, v in secs.items()}
            n = rep['rollup']['count']
            phases = {k: v / n for k, v in rep['rollup']['phases_ms'].items()}
            cover = statistics.median(s['coverage'] for s in rep['steps'])
            out[label] = med
            log('  (b) BERT-base %s step (%s | %s): median %.3f ms with '
                'FLAGS_trace off, %.3f ms on (%+.3f ms) over %d steps each, '
                'the tracer switched at every step; step_report phases (ms '
                'a step): %s; spans cover %.1f%% of the step wall' % (
                    label, torch.cuda.get_device_name(0), card, med['off'],
                    med['on'], med['on'] - med['off'], len(secs['on']),
                    ', '.join('%s %.3f' % kv for kv in sorted(
                        phases.items(), key=lambda kv: -kv[1])),
                    100 * cover))
        # (g) on its own replayed steps: a reader thread would take the
        # host from the timed eager steps above
        stop = health_checks()
        for _ in range(OBS_TRACE_STEPS):
            exe.run(main, feed=feed, fetch_list=fetch)
        stop()
    trace.reset()
    return out


def obs_reader(seed, card):
    """(c) Wide&Deep from phase 14's MultiSlot files (8 full batches and
    one of WD_PARTIAL rows) through train_from_dataset (InMemoryDataset,
    thread 4, every signature captured) beside the same steps fed from
    staged device tensors: 3 epochs each way, twice, as phase 14 times
    them, then one epoch each way with the reader's spans and
    counters."""
    path = wide_deep_program(seed)
    lines = WD_FULL_BATCHES * WD_BATCH + WD_PARTIAL
    trace, monitor = fluid.trace, fluid.monitor
    run = fresh_run(path)
    exe, scope, main = run['exe'], run['scope'], path['main']
    base = os.path.join(ROOT, 'build', 'chip_smoke')
    with tempfile.TemporaryDirectory(dir=base) as d:
        files = write_criteo_files(d, seed, lines)
        mem = wd_dataset('InMemoryDataset', path, files, 4)
        mem.load_into_memory()
        batches = list(mem.batches())
    staged = [{n: v.to('cuda') for n, v in b.items()} for b in batches]
    ways = (('train_from_dataset', lambda: exe.train_from_dataset(
                main, mem, thread=4)),
            ('staged device tensors', lambda: [
                exe.run(main, feed=b) for b in staged]))
    secs = {}
    with fluid.scope_guard(scope):
        for _ in range(2):   # every signature's first run and capture
            for _, fn in ways:
                fn()
        for label, fn in ways * 2:
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                secs.setdefault(label, []).append(time.perf_counter() - t0)
        for label, fn in ways:
            waits = monitor.histogram_value('reader/consume_blocked_seconds')
            n0 = waits['count'] if waits else 0
            s0 = waits['sum'] if waits else 0.0
            trace.reset()
            trace.enable(buffer_steps=64)
            fn()
            torch.cuda.synchronize()
            rep = trace.step_report()
            trace.disable()
            waits = monitor.histogram_value('reader/consume_blocked_seconds')
            roll = rep['rollup']
            walls = sum(s['wall_ms'] for s in rep['steps'])
            share = roll['phases_ms'].get('reader_wait', 0.0) / walls \
                if walls else 0.0
            best = min(secs[label][-3:])
            log('  (c) Wide&Deep, %s (%s | %s): %.0f examples/s (%d examples '
                'an epoch, best of the last 3 epochs: %.3f ms; all %s); one '
                'traced epoch: %d steps, their wall %.3f ms, reader_wait '
                '%.1f%% of it; phases (ms an epoch): %s; queue depth %d at '
                'the last batch; the consumer waited %d times, %.3f ms in '
                'all' % (
                    label, torch.cuda.get_device_name(0), card,
                    lines / best, lines, best * 1e3,
                    ['%.2f' % (x * 1e3) for x in secs[label]],
                    roll['count'], walls, 100 * share, ', '.join(
                        '%s %.3f' % kv for kv in sorted(
                            roll['phases_ms'].items(),
                            key=lambda kv: -kv[1])),
                    monitor.gauge_value('reader/queue_depth'),
                    (waits['count'] if waits else 0) - n0,
                    ((waits['sum'] if waits else 0.0) - s0) * 1e3))
        produced = monitor.counter_value('reader/batches_produced')
        consumed = monitor.counter_value('reader/batches_consumed')
    if not produced or consumed < 9 * len(batches):
        raise AssertionError('reader counters: produced %s consumed %s'
                             % (produced, consumed))
    trace.reset()
    free_run(run)


def profiled_step(fn):
    """(host wall ms of fn() under the 'Default' profiler, its device
    time: fluid.profiler.last_profile()['device'])."""
    holder = {}

    def step():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        holder['wall'] = (time.perf_counter() - t0) * 1e3
    quiet_profile('Default', step)
    return holder['wall'], fluid.profiler.last_profile()['device']


def obs_union(seed, dev, card):
    """(d) SE-ResNeXt-50 (batch 32): one replayed step under the
    profiler, its device union over the streams at most the step's wall
    time, beside the summed device time."""
    run = fresh_run(image_path(seed, 'se_resnext', SE_BATCH, dev))
    path, exe, scope = run['path'], run['exe'], run['scope']
    step = lambda: exe.run(path['main'], feed=path['batch'],  # noqa: E731
                           fetch_list=[path['loss']])
    with fluid.scope_guard(scope):
        for _ in range(3):   # eager, captured, replayed
            step()
        replays = compile_cache.counter_value('executor/graph_replays')
        wall, devt = profiled_step(step)
        replayed = compile_cache.counter_value('executor/graph_replays') > \
            replays
    log('  (d) SE-ResNeXt-50 batch %d, one %s step under the profiler (%s | '
        '%s): wall %.3f ms; device events %d on %d streams: summed %.3f ms, '
        'union over the streams %.3f ms (%.1f%% of the wall)' % (
            SE_BATCH, 'replayed' if replayed else 'eager',
            torch.cuda.get_device_name(0), card, wall, devt['events'],
            devt['streams'], devt['sum_ms'], devt['union_ms'],
            100 * devt['union_ms'] / wall))
    if devt['union_ms'] > wall or not devt['events']:
        raise AssertionError('device union %.3f ms over the step wall %.3f '
                             'ms' % (devt['union_ms'], wall))
    free_run(run)


def obs_decodes(seed, card):
    """(e) phase 15's two decodes (the LSTM seq2seq after 3 training
    steps): dynamic_decode and the book's While (a WHILE node), both
    replayed, each
    3 traced runs with step_report's phases, and one profiled run's
    device time against its wall."""
    run = fresh_run(seq2seq_path(seed))
    path, exe, scope = run['path'], run['exe'], run['scope']
    trace = fluid.trace
    feed = {k: path['batch'][k] for k in ('src', 'src_len')}
    with fluid.scope_guard(scope):
        for _ in range(3):
            exe.run(path['main'], feed=path['batch'],
                    fetch_list=[path['loss']])
        for label, build in (
                ('dynamic_decode', seq2seq.build_beam_decode),
                ('While + beam_search', seq2seq.build_while_decode)):
            main, fetch = decode_program(seed, build)
            for _ in range(3):   # eager, captured, replayed where it may
                exe.run(main, feed=feed, fetch_list=fetch)
            trace.reset()
            trace.enable(buffer_steps=16)
            for _ in range(3):
                exe.run(main, feed=feed, fetch_list=fetch)
            rep = trace.step_report()
            trace.disable()
            wall, devt = profiled_step(
                lambda: exe.run(main, feed=feed, fetch_list=fetch))
            roll = rep['rollup']
            n = roll['count']
            why = exe._get_plan(main, feed, fetch).no_graph
            log('  (e) %s (%s, %s | %s): median wall %.3f ms over %d runs; '
                'phases (ms a run): %s; one profiled run: wall %.3f ms, '
                'device summed %.3f ms, union %.3f ms, %d events' % (
                    label, 'replayed' if why is None else 'eager',
                    torch.cuda.get_device_name(0), card, roll['wall_p50_ms'],
                    n, ', '.join('%s %.3f' % (k, v / n) for k, v in sorted(
                        roll['phases_ms'].items(), key=lambda kv: -kv[1])),
                    wall, devt['sum_ms'], devt['union_ms'], devt['events']))
    trace.reset()
    free_run(run)


def obs_memory(seed, card):
    """(f) MobileNetV3-Large (batch 128): the program's first run under
    FLAGS_memviz, memviz.peak_bytes against torch.cuda.max_memory_allocated
    of the same run and the row's decomposition; live_census against
    torch.cuda.memory_allocated."""
    memviz = fluid.memviz
    path = mobilenet_path(seed)
    run = fresh_run(path)
    exe, scope, main = run['exe'], run['scope'], path['main']
    flags.set_flags({'FLAGS_memviz': True})
    try:
        with fluid.scope_guard(scope):
            memviz.note_params(p.name for p in main.all_parameters())
            exe.run(main, feed=path['batch'], fetch_list=[path['loss']])
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            label = memviz.program_label(main)
            mv_peak = memviz.peak_bytes(label)
            row = [r for r in memviz.report() if r['program'] == label][0]
            census = memviz.live_census(scope)
            alloc = torch.cuda.memory_allocated()
    finally:
        flags.set_flags({'FLAGS_memviz': False})
    gib = 2.0 ** 30
    parts = dict(row['classes'], output=row['output_bytes'],
                 temp=row['temp_bytes'], other=row['other_bytes'])
    log('  (f) MobileNetV3-Large batch %d, its first run (%s | %s): '
        'memviz.peak_bytes %.4f GiB, torch.cuda.max_memory_allocated %.4f '
        'GiB; the row: %s (sum %.4f GiB); live_census %.4f GiB (%s) '
        'against torch.cuda.memory_allocated %.4f GiB' % (
            mobilenet_v3.BASE.batch, torch.cuda.get_device_name(0), card,
            mv_peak / gib, peak / gib, ', '.join(
                '%s %.4f' % (k, v / gib) for k, v in parts.items()),
            sum(parts.values()) / gib, census['total_bytes'] / gib,
            ', '.join('%s %.4f' % (k, v / gib)
                      for k, v in census['classes'].items() if v),
            alloc / gib))
    if row.get('estimated') or abs(mv_peak - peak) > 0.01 * peak or \
            abs(sum(parts.values()) - mv_peak) > 1.0 or \
            abs(census['total_bytes'] - alloc) > OBS_MEM_SLACK:
        raise AssertionError('memviz peak %s / torch %s; row sums %s; census '
                             '%s / allocated %s' % (
                                 mv_peak, peak, sum(parts.values()),
                                 census['total_bytes'], alloc))
    free_run(run)


def obs_cached_cpu(seed, card):
    """(h) ROADMAP Queue 3's to-do: self CPU of one AMP BERT-base step and
    one LeNet-5 step, uncached (a plan built for the call) and cached,
    both eager through eager_run, both orders in one process,
    OBS_CPU_REPEATS profiled steps a side and order (the device waits
    left out); the gap is held against the steps' spread."""
    out = {}
    for path in (amp_bert_path(seed, SEQ, TRAIN_BATCH),
                 lenet_path(seed, 'adam')):
        run = fresh_run(path)
        exe, scope, main = run['exe'], run['scope'], path['main']
        feed, fetch = path['batch'], [path['loss']]
        sides = {
            'uncached': lambda: eager_run(exe, main, feed, fetch,
                                          use_cache=False),
            'cached': lambda: eager_run(exe, main, feed, fetch)}
        res = {}
        with fluid.scope_guard(scope):
            for fn in sides.values():
                fn()
            for order in (('uncached', 'cached'), ('cached', 'uncached')):
                for side in order:
                    res[(order[0], side)] = [host_ms(profile_run(
                        '', sides[side], quiet=True, pad=True), waits=False)
                        for _ in range(OBS_CPU_REPEATS)]
        med = {k: statistics.median(v) for k, v in res.items()}
        # the cached side's median less the uncached side's, in each
        # order, against the widest interquartile range of a side: a
        # cost only where both orders show a gap of one sign wider than
        # the step-to-step spread
        gaps = [med[(first, 'cached')] - med[(first, 'uncached')]
                for first in ('uncached', 'cached')]
        spread = max(q[2] - q[0] for q in (
            statistics.quantiles(v, n=4) for v in res.values()))
        verdict = 'a cost of the cached path' if min(gaps) > spread \
            else 'a cost of the uncached path' if max(gaps) < -spread \
            else 'noise: the gap is within the step-to-step spread'
        out[path['name']] = (med, verdict)
        log('  (h) %s (%s | %s), self CPU outside the waits, median of %d '
            'profiled steps: uncached first: uncached %.3f ms, cached %.3f '
            'ms; cached first: cached %.3f ms, uncached %.3f ms (all runs: '
            '%s): cached less uncached %+.3f / %+.3f ms, widest '
            'interquartile range %.3f ms: %s' % (
                path['name'], torch.cuda.get_device_name(0), card,
                OBS_CPU_REPEATS, med[('uncached', 'uncached')],
                med[('uncached', 'cached')], med[('cached', 'cached')],
                med[('cached', 'uncached')],
                {'%s first, %s' % k: ['%.3f' % x for x in v]
                 for k, v in res.items()}, gaps[0], gaps[1], spread,
                verdict))
        free_run(run)
    return out


def health_poller(srv):
    """(g) A thread GETting /healthz, /metrics and /statusz while the
    steps run: returns stop(), which joins it and checks what it read
    (prom_lint finds nothing, /healthz ready, /statusz names the card)."""
    import threading
    import urllib.request
    got, errors = [], []
    done = threading.Event()

    def poll():
        while not done.is_set():
            for p in ('/healthz', '/metrics', '/statusz'):
                try:
                    with urllib.request.urlopen(srv.url + p,
                                                timeout=30) as r:
                        got.append((p, r.status, r.read().decode()))
                except Exception as e:  # noqa: BLE001 — reported below
                    errors.append('%s: %s' % (p, e))
            done.wait(0.05)
    t = threading.Thread(target=poll, daemon=True)
    t.start()

    def stop():
        done.set()
        t.join(60)
        kinds = {p: [x for x in got if x[0] == p]
                 for p in ('/healthz', '/metrics', '/statusz')}
        lint = [fluid.health.prom_lint(x[2]) for x in kinds['/metrics']]
        ready = [json.loads(x[2])['ready'] for x in kinds['/healthz']]
        statusz = [json.loads(x[2]) for x in kinds['/statusz']]
        bad = errors + [p for p in lint if p] + \
            [x[1] for x in got if x[1] != 200]
        log('  (g) the status plane on port %d while the steps ran: %s; '
            'prom_lint problems %d; /healthz ready %s; /statusz versions %s'
            % (srv.port, {p: len(v) for p, v in kinds.items()},
               sum(len(p) for p in lint), sorted(set(ready)),
               statusz[-1]['versions'] if statusz else None))
        if bad or not all(kinds.values()) or not all(ready) or \
                statusz[-1]['versions'].get('device') != \
                torch.cuda.get_device_name(0):
            raise AssertionError('status plane: %s' % bad[:4])
    return stop


def observability_phase(seed, dev):
    """Phase 18: the observability plane on the card."""
    card = card_line()
    log('[18] the observability plane (%s | %s): (a) profiler and worklist '
        'on BERT-base' % (torch.cuda.get_device_name(0), card))
    srv = fluid.health.serve(port=0)
    try:
        run = obs_profile(seed, card)
        obs_trace(run, card, lambda: health_poller(srv))
        free_run(run)
        obs_reader(seed, card)
        obs_union(seed, dev, card)
        obs_decodes(seed, card)
        obs_memory(seed, card)
        obs_cached_cpu(seed, card)
    finally:
        srv.stop()
        fluid.trace.disable()
        fluid.trace.reset()


# ----------------------------------------------------------- phase 19
P19_STEPS = 5         # LARK's schedule crosses its warmup after step 3
P19_WARMUP = 3
P19_PEAK = 1e-4
P19_TOTAL = 5         # polynomial_decay reaches 0 at step 6
P19_CALLS = 4         # training CompiledStep calls: eager, then 3 graphed
P19_DECODE_RUNS = 5   # eager, captured, 3 replays
P19_ROWS, P19_COLS = 4096, 1024   # (d)'s activations


def lark_warmup_decay(learning_rate, warmup_steps, num_train_steps):
    """PaddlePaddle LARK BERT's optimization.py ``linear_warmup_decay``:
    a persistable rate that fluid.layers.Switch sets from the global
    step, linear warmup then polynomial_decay to 0."""
    layers = fluid.layers
    lr = layers.create_global_var(shape=[1], value=0.0, dtype='float32',
                                  persistable=True,
                                  name='scheduled_learning_rate')
    global_step = layers.learning_rate_scheduler._global_step_counter()
    switch = layers.Switch()
    with switch.case(global_step < warmup_steps):
        layers.assign(learning_rate * (global_step / warmup_steps), lr)
    with switch.default():
        layers.assign(layers.polynomial_decay(
            learning_rate=learning_rate, decay_steps=num_train_steps,
            end_learning_rate=0.0, power=1.0, cycle=False), lr)
    return lr


def lark_rate(step):
    """The rate of 1-based step `step` (global step step - 1) in float32,
    each op of the schedule rounded as its lowering rounds it: the scale
    ops x * s + b, polynomial_decay's min, scales and pow(x, 1)."""
    f = np.float32
    gs = f(step - 1)
    if gs < P19_WARMUP:
        return f(f(gs * f(1.0 / P19_WARMUP)) * f(P19_PEAK))
    frac = f(f(min(gs, f(P19_TOTAL))) * f(1.0 / P19_TOTAL))
    one_minus = f(f(frac * f(-1.0)) + f(1.0))
    return f(f(one_minus * f(P19_PEAK - 0.0)) + f(0.0))


def p19_bert(seed, with_print=False):
    """Phase 5's BERT-base pretraining program (seq 512, batch 8) with
    Adam on LARK's schedule; with_print adds layers.Print(loss)."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed + 1
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        _, _, loss = bert.build_pretrain(bert.BASE, seq_len=SEQ)
        if with_print:
            fluid.layers.Print(loss, message='loss')
        lr = lark_warmup_decay(P19_PEAK, P19_WARMUP, P19_TOTAL)
        fluid.optimizer.Adam(learning_rate=lr, epsilon=EPSILON).minimize(loss)
    return main, startup, loss, lr


def p19_scope(startup, start):
    """A new executor and scope holding `start` (the startup state)."""
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    with fluid.scope_guard(scope):
        without_counting(lambda: exe.run(startup))
        for n, v in start.items():
            scope.find_var(n).copy_(v)
    return exe, scope


def differs_from(scope, want):
    """The names whose tensor in `scope` is not bitwise `want`'s."""
    return [n for n, v in want.items() if not torch.equal(scope.find_var(n),
                                                          v)]


def p19_decode(seed, card):
    """(a) The book's While decode captured with a WHILE node."""
    run = fresh_run(seq2seq_path(seed))
    path, exe, scope = run['path'], run['exe'], run['scope']
    feed = {k: path['batch'][k] for k in ('src', 'src_len')}
    main, fetch = decode_program(seed, seq2seq.build_while_decode)
    with fluid.scope_guard(scope):
        for _ in range(TRAIN_STEPS):
            without_counting(lambda: exe.run(path['main'], feed=path['batch'],
                                             fetch_list=[path['loss']]))
        eager, eager_s = [], []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eager = without_counting(lambda: eager_run(exe, main, feed,
                                                       fetch))
            eager_s.append(time.perf_counter() - t0)
        trips = int(np.asarray(eager[-1]).ravel()[0])
        if trips < S2S_MIN_LIVE:
            raise AssertionError('(a) a beam stays live for %d steps, fewer '
                                 'than %d' % (trips, S2S_MIN_LIVE))
        before = graph_stats()
        secs = []
        for i in range(P19_DECODE_RUNS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, counts = counted(lambda: exe.run(main, feed=feed,
                                                  fetch_list=fetch))
            secs.append(time.perf_counter() - t0)
            want = {k: 0 for k in common.KERNELS}
            want['embedding_lookup'] = 1 + trips
            want['graph_cond'] = 1 + trips if i else 0
            differ = [n for n, a, b in zip(fetch, out, eager)
                      if not np.array_equal(a, b)]
            if differ or counts != want:
                raise AssertionError(
                    '(a) run %d: differs from the eager host loop in %s; '
                    'launched %s, expected %s; refusals %s' % (
                        i + 1, differ, counts, want,
                        graph_refusals(main, scope)))
        moved = {k: v - before[k] for k, v in graph_stats().items()}
        if moved['graph_captures'] != 1 or \
                moved['graph_replays'] != P19_DECODE_RUNS - 1:
            raise AssertionError('(a) graphs: %s' % moved)
        early, d2h, kernels, prof_ms = without_counting(
            lambda: d2h_before_last_kernel(
                lambda: exe.run(main, feed=feed, fetch_list=fetch)))
        dev_ms = without_counting(lambda: events_ms(
            lambda: exe.run(main, feed=feed, fetch_list=fetch)))
    if early or not d2h:
        raise AssertionError('(a) a profiled replay copies to the host '
                             'before its last kernel: %s' % early)
    replay_ms = statistics.median(secs[2:]) * 1e3
    eager_ms = statistics.median(eager_s) * 1e3
    log('  (a) While decode (batch %d, beam %d, %d trips; %s | %s): %d runs '
        'bitwise the eager host loop (sequences, ids, parents, scores, '
        'trips), one capture with a WHILE node, %d replays, graph_cond %d '
        'and embedding_lookup %d launches a replay; a profiled replay: %d '
        'kernels, %d device-to-host copies, all after its last kernel; ms '
        'a decode: replayed %.2f (runs 3-5: %s), eager %.2f, device %.2f '
        'summed by the profiler, %.2f between CUDA events around a '
        'replayed run' % (
            S2S_BATCH, seq2seq.BASE.beam, trips,
            torch.cuda.get_device_name(0), card, P19_DECODE_RUNS,
            P19_DECODE_RUNS - 1, 1 + trips, 1 + trips, kernels, len(d2h),
            replay_ms, ['%.2f' % (x * 1e3) for x in secs[2:]], eager_ms,
            prof_ms, dev_ms))
    free_run(run)
    return {'replay_ms': replay_ms, 'eager_ms': eager_ms, 'device_ms': dev_ms}


def events_ms(fn):
    """The device time between CUDA events recorded on the current
    stream before and after fn() (ms)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def d2h_before_last_kernel(fn):
    """One profiled call of fn: (the device-to-host copies that start
    before its last kernel ends, every such copy, the kernel count, the
    summed device ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    d2h = [e for e in evs if 'DtoH' in e.name]
    kernels = [e for e in evs if 'Memcpy' not in e.name and
               'Memset' not in e.name]
    last = max(e.time_range.end for e in kernels)
    early = [(e.name, e.time_range.start) for e in d2h
             if e.time_range.start < last]
    return (early, d2h, len(kernels),
            sum(e.time_range.elapsed_us() for e in evs) / 1e3)


def p19_switch(seed, card):
    """(b) LARK's Switch schedule: 5 steps replayed in lockstep with the
    same steps run eagerly.  Returns what (c), (e) and (f) reuse."""
    main, startup, loss, lr = p19_bert(seed)
    names = weights.startup_names(startup)
    exe_g, scope_g = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    with fluid.scope_guard(scope_g):
        without_counting(lambda: exe_g.run(startup))
        start = snapshot(scope_g, names)
    exe_e, scope_e = p19_scope(startup, start)
    batch = bert.synthetic_batch(bert.BASE, TRAIN_BATCH, SEQ,
                                 np.random.RandomState(seed))
    want = pretrain_program(seed, 'adam')['expected']
    n_cond = sum(op.type == 'conditional_block'
                 for op in main.global_block().ops)
    before = graph_stats()
    losses, rates, states, eager_steps = [], [], [], []
    for k in range(P19_STEPS):
        with fluid.scope_guard(scope_g):
            out, counts = counted(lambda: exe_g.run(
                main, feed=batch, fetch_list=[loss, lr]))
        with fluid.scope_guard(scope_e):
            step = exe_e._step
            ref = without_counting(lambda: eager_run(exe_e, main, batch,
                                                     [loss, lr]))
        eager_steps.append(step)
        states.append(snapshot(scope_e, names))
        bad = differs_from(scope_g, states[-1])
        rate = np.asarray(out[1]).ravel()[0]
        expected = dict(want, graph_cond=n_cond if k else 0)
        if bad or not all(np.array_equal(a, b) for a, b in zip(out, ref)) \
                or rate != lark_rate(k + 1) or counts != expected:
            raise AssertionError(
                '(b) step %d: state differs from the eager step in %s; '
                'loss %s / %s; rate %r, the formula %r; launched %s, '
                'expected %s' % (k + 1, bad[:5], out[0], ref[0], rate,
                                 lark_rate(k + 1), counts, expected))
        losses.append(float(np.asarray(out[0]).ravel()[0]))
        rates.append(float(rate))
    moved = {k: v - before[k] for k, v in graph_stats().items()}
    if moved['graph_captures'] != 1 or moved['graph_replays'] != \
            P19_STEPS - 1 or moved['graph_refused']:
        raise AssertionError('(b) graphs: %s' % moved)
    log('  (b) BERT-base Adam on LARK\'s linear_warmup_decay (Switch: %d '
        'conditional_blocks, IF nodes in the graph; %s | %s): rates %s, '
        'each the numpy formula; losses %s; steps 2-%d from one graph, '
        'each step\'s whole state (%d tensors) bitwise the same step run '
        'eagerly; graph_cond %d launches a replayed step' % (
            n_cond, torch.cuda.get_device_name(0), card,
            ['%.4g' % r for r in rates], ['%.6f' % x for x in losses],
            P19_STEPS, len(names), n_cond))
    drop_graphs(main, scope_g)
    del exe_g, scope_g
    return {'main': main, 'startup': startup, 'loss': loss, 'lr': lr,
            'batch': batch, 'start': start, 'states': states,
            'losses': losses, 'steps': eager_steps, 'names': names,
            'exe_e': exe_e, 'scope_e': scope_e, 'expected': want,
            'n_cond': n_cond}


def p19_print(seed, card, b):
    """(c) The same step with layers.Print(loss): a device unit replayed
    and a host tail, through Executor.run and compile(allow_host=True)."""
    main, startup, loss, lr = p19_bert(seed, with_print=True)
    plan = fluid.Executor(fluid.CUDAPlace(0))._get_plan(
        main, b['batch'], [loss.name])
    kinds = ['host:' + u.steps[0].members[0].op.type if u.host else 'device'
             for u in plan.units]
    if kinds != ['device', 'host:print'] or plan.no_graph is not None:
        raise AssertionError('(c) pipeline units %s, refusal %r'
                             % (kinds, plan.no_graph))
    ms = {}
    for how in ('run', 'compile'):
        exe, scope = p19_scope(startup, b['start'])
        before = graph_stats()
        secs, printed = [], []
        with fluid.scope_guard(scope):
            if how == 'compile':
                pipe = exe.compile(main, feed_names=list(b['batch']),
                                   fetch_names=[loss], allow_host=True)
                step = lambda: pipe(b['batch'])  # noqa: E731
            else:
                step = lambda: exe.run(  # noqa: E731
                    main, feed=b['batch'], fetch_list=[loss])
            for k in range(P19_STEPS):
                buf = io.StringIO()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(buf):
                    out, _ = counted(step)
                secs.append(time.perf_counter() - t0)
                printed.append(sum(line.startswith('loss ')
                                   for line in buf.getvalue().splitlines()))
                if float(np.asarray(out[0]).ravel()[0]) != b['losses'][k]:
                    raise AssertionError('(c) %s step %d: loss %s, the eager '
                                         'step\'s %s' % (how, k + 1, out[0],
                                                         b['losses'][k]))
            bad = differs_from(scope, b['states'][-1])
        moved = {k: v - before[k] for k, v in graph_stats().items()}
        if bad or printed != [1] * P19_STEPS or \
                moved['graph_captures'] != 1 or \
                moved['graph_replays'] != P19_STEPS - 1:
            raise AssertionError('(c) %s: state differs in %s; printed %s; '
                                 'graphs %s' % (how, bad[:5], printed, moved))
        ms[how] = statistics.median(secs[2:]) * 1e3
        drop_graphs(main, scope)
        del exe, scope
    exe, scope = p19_scope(startup, b['start'])
    eager_s = []
    with fluid.scope_guard(scope), quiet_steps():
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            without_counting(lambda: eager_run(exe, main, b['batch'], [loss]))
            torch.cuda.synchronize()
            eager_s.append(time.perf_counter() - t0)
    del exe, scope
    log('  (c) the step with layers.Print(loss) (%s | %s): units %s, one '
        'line printed a step, %d steps bitwise (b)\'s eager steps through '
        'Executor.run and through compile(allow_host=True); ms a step '
        'replayed %.2f (run) / %.2f (CompiledPipeline), cached eager %.2f'
        % (torch.cuda.get_device_name(0), card, kinds, P19_STEPS,
           ms['run'], ms['compile'], statistics.median(eager_s) * 1e3))


def p19_save_load(seed, card):
    """(d) A save and a load between two device units: the first unit's
    activations saved, then a load of new values into them (the load
    rewrites what the save read, so the save runs first), which the
    second unit reads."""
    d = os.path.join(ROOT, 'build', 'chip_smoke', 'p19_saveload')
    os.makedirs(d, exist_ok=True)
    h_path, in_path = os.path.join(d, 'h'), os.path.join(d, 'h_in')
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed + 1
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data('x', shape=[P19_COLS], dtype='float32')
        h = fluid.layers.fc(x, P19_COLS, act='relu')
        block = main.global_block()
        block.append_op('save', inputs={'X': [h]}, outputs={},
                        attrs={'file_path': h_path})
        block.append_op('load', inputs={}, outputs={'Out': [h]},
                        attrs={'file_path': in_path})
        w2 = fluid.layers.create_parameter([P19_COLS, P19_COLS], 'float32',
                                           name='w2_unit2')
        out = fluid.layers.reduce_mean(fluid.layers.matmul(h, w2), dim=1)
    rng = np.random.RandomState(seed)
    xv = rng.randn(P19_ROWS, P19_COLS).astype('float32')
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    exe_e, scope_e = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    for e, sc in ((exe, scope), (exe_e, scope_e)):
        with fluid.scope_guard(sc):
            without_counting(lambda: e.run(startup))
    for p in main.all_parameters():
        scope_e.find_var(p.name).copy_(scope.find_var(p.name))
    plan = exe._get_plan(main, {'x': xv}, [out.name])
    kinds = ['host:' + u.steps[0].members[0].op.type if u.host else 'device'
             for u in plan.units]
    before = graph_stats()
    for k in range(4):
        hin = np.abs(rng.randn(P19_ROWS, P19_COLS)).astype('float32')
        np.save(in_path + '.npy', hin)
        with fluid.scope_guard(scope):
            got = without_counting(lambda: exe.run(
                main, feed={'x': xv}, fetch_list=[out]))[0]
            saved = np.load(h_path + '.npy')
        with fluid.scope_guard(scope_e):
            ref = without_counting(lambda: eager_run(
                exe_e, main, {'x': xv}, [out]))[0]
            saved_e = np.load(h_path + '.npy')
        if not (np.array_equal(got, ref) and np.array_equal(saved, saved_e)):
            raise AssertionError('(d) step %d: not bitwise the eager step, '
                                 'or another saved file' % (k + 1))
        w = scope.find_var('w2_unit2')
        direct = (torch.from_numpy(hin).cuda() @ w).mean(1).cpu().numpy()
        if not np.allclose(got, direct, rtol=1e-5, atol=1e-6):
            raise AssertionError('(d) step %d: the replay did not read the '
                                 'loaded values' % (k + 1))
    moved = {k: v - before[k] for k, v in graph_stats().items()}
    if kinds != ['device', 'host:save', 'host:load', 'device'] or \
            moved['graph_captures'] != 2 or moved['graph_stale'] or \
            moved['graph_refused']:
        raise AssertionError('(d) units %s, graphs %s' % (kinds, moved))
    log('  (d) a save and a load between two device units (%d x %d; %s | '
        '%s): units %s; 4 steps bitwise eager (the output and the saved '
        'file), each loading new values in place (no stale graph) that the '
        'second unit\'s replay reads; graphs %s' % (
            P19_ROWS, P19_COLS, torch.cuda.get_device_name(0), card, kinds,
            {k: v for k, v in moved.items() if v}))
    drop_graphs(main, scope)


def p19_compiled_step(seed, card, b):
    """(e) (b)'s step as a training CompiledStep."""
    main, loss = b['main'], b['loss']
    exe = fluid.Executor(fluid.CUDAPlace(0))
    step = exe.compile(main, feed_names=list(b['batch']),
                       fetch_names=[loss])
    state = {n: b['start'][n].clone() for n in step.state_names}
    held = {n: v.clone() for n, v in state.items()}
    data = {n: b['start'][n] if n in b['start'] else
            b['scope_e'].find_var(n)
            for n in step.input_names if n not in b['batch']}
    data.update(b['batch'])
    torch.cuda.synchronize()
    pool0 = torch.cuda.memory_reserved()
    before = graph_stats()
    secs = []
    for k in range(P19_CALLS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, _ = counted(lambda: step(b['steps'][k] + 1, state, data))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        if float(out[loss.name].reshape(-1)[0]) != b['losses'][k]:
            raise AssertionError('(e) call %d: loss %s, the eager step\'s %s'
                                 % (k + 1, out[loss.name], b['losses'][k]))
        bad = [n for n in step.state_names if n in out and
               n in b['states'][k] and
               not torch.equal(out[n], b['states'][k][n])]
        untouched = [n for n in state if torch.equal(state[n], held[n])]
        if bad or len(untouched) != len(state):
            raise AssertionError('(e) call %d: outputs differ from the '
                                 'eager step in %s; the caller\'s state '
                                 'changed' % (k + 1, bad[:5]))
        state = {n: out.get(n, v) for n, v in state.items()}
        held = {n: v.clone() for n, v in state.items()}
    pool = torch.cuda.memory_reserved() - pool0
    moved = {k: v - before[k] for k, v in graph_stats().items()}
    if moved['graph_captures'] != 1 or \
            moved['graph_replays'] != P19_CALLS - 1:
        raise AssertionError('(e) graphs: %s' % moved)
    log('  (e) training CompiledStep of (b)\'s step (%s | %s): %d calls '
        'bitwise (b)\'s eager steps (loss and every output), %d from the '
        'graph, the caller\'s %d state tensors bitwise untouched; ms a call '
        '%s (the last %d replayed); the pool grew %.3f GiB (the graph\'s '
        'state buffers and its memory)' % (
            torch.cuda.get_device_name(0), card, P19_CALLS, P19_CALLS - 1,
            len(state), ['%.2f' % (x * 1e3) for x in secs], P19_CALLS - 1,
            pool / 2 ** 30))


def p19_nan_check(seed, card, b, timer):
    """(f) (b)'s step under FLAGS_check_nan_inf; returns the finite_check
    row of the kernels line, timed at the step's checked set."""
    main, startup, loss = b['main'], b['startup'], b['loss']
    checked = []
    real = fluid.executor.Executor._verdict_launch

    def keep(self, entries):
        if not checked:
            checked.extend(v for n, v in entries
                           if not isinstance(n, tuple))
        return real(self, entries)
    ms = {}
    flags.set_flags({'FLAGS_check_nan_inf': True})
    try:
        exe, scope = p19_scope(startup, b['start'])
        torch.cuda.synchronize()
        pool0 = torch.cuda.memory_reserved()
        before = graph_stats()
        secs = []
        with fluid.scope_guard(scope):
            for k in range(4):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out, counts = counted(lambda: exe.run(
                    main, feed=b['batch'], fetch_list=[loss]))
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
                expected = dict(b['expected'], finite_check=1,
                                graph_cond=b['n_cond'] if k else 0)
                if counts != expected or \
                        float(np.asarray(out[0]).ravel()[0]) != \
                        b['losses'][k]:
                    raise AssertionError(
                        '(f) healthy step %d: launched %s, expected %s; '
                        'loss %s, the eager step\'s %s' % (
                            k + 1, counts, expected, out[0],
                            b['losses'][k]))
            pool = torch.cuda.memory_reserved() - pool0
            moved = {k: v - before[k] for k, v in graph_stats().items()}
            ms['replayed, check on'] = statistics.median(secs[2:]) * 1e3
            w = 'fc_0.w_0'
            held = snapshot(scope, b['names'])
            scope.find_var(w).fill_(float('inf'))
            errs = []
            try:
                without_counting(lambda: exe.run(main, feed=b['batch'],
                                                 fetch_list=[loss]))
            except FloatingPointError as e:
                errs.append(e)
            for n, v in held.items():
                scope.find_var(n).copy_(v)
        exe_e, scope_e = p19_scope(startup, held)
        scope_e.find_var(w).fill_(float('inf'))
        exe_e._step = exe._step - 1
        fluid.executor.Executor._verdict_launch = keep
        try:
            with fluid.scope_guard(scope_e):
                without_counting(lambda: eager_run(exe_e, main, b['batch'],
                                                   [loss]))
        except FloatingPointError as e:
            errs.append(e)
        finally:
            fluid.executor.Executor._verdict_launch = real
        if len(errs) != 2 or moved['graph_captures'] != 1:
            raise AssertionError('(f) the inf step raised %d of 2 times; '
                                 'graphs %s' % (len(errs), moved))
        bad = [str(e).splitlines()[0].split(' (step')[0] for e in errs]
        notes = ['\n'.join(getattr(e, '__notes__', [])) for e in errs]
        if bad[0] != bad[1] or not all('op' in n for n in notes):
            raise AssertionError('(f) the replayed step named %r, the eager '
                                 '%r; notes %r' % (bad[0], bad[1], notes))
        for n, v in held.items():
            scope_e.find_var(n).copy_(v)
        with fluid.scope_guard(scope_e):
            ms['eager, check on'] = p19_step_ms(
                lambda: eager_run(exe_e, main, b['batch'], [loss]))
    finally:
        flags.set_flags({'FLAGS_check_nan_inf': False})
    with fluid.scope_guard(scope):
        for _ in range(2):
            without_counting(lambda: exe.run(main, feed=b['batch'],
                                             fetch_list=[loss]))
        ms['replayed, check off'] = p19_step_ms(
            lambda: exe.run(main, feed=b['batch'], fetch_list=[loss]))
    with fluid.scope_guard(scope_e):
        ms['eager, check off'] = p19_step_ms(
            lambda: eager_run(exe_e, main, b['batch'], [loss]))
    drop_graphs(main, scope)
    del exe, scope, exe_e, scope_e
    nbytes = sum(t.numel() * t.element_size() for t in checked)
    log('  (f) FLAGS_check_nan_inf on (b)\'s step (%s | %s): finite_check '
        'launched once a step over %d values (%.3f GiB), no trip over 4 '
        'healthy steps; with %s set to inf through the scope the replayed '
        'step raised FloatingPointError naming the eager step\'s %d '
        'variables (%s, ...), with provenance; ms a step %s; the pool grew '
        '%.3f GiB under the check (its input copies and the checked values '
        'kept to the step\'s end)' % (
            torch.cuda.get_device_name(0), card, len(checked),
            nbytes / 2 ** 30, w, bad[0].count(',') + 1,
            bad[0].split('[')[1][:60],
            ', '.join('%s %.2f' % kv for kv in ms.items()), pool / 2 ** 30))
    got = fin_k.finite_check(checked)
    plain = fin_k.finite_check_plain(checked)
    torch.cuda.synchronize()
    if not torch.equal(got.cpu(), plain.cpu()):
        raise AssertionError('(f) finite_check differs from its plain '
                             'version at the checked set')
    found = torch.zeros(1, device=checked[0].device)
    one = torch.ones(1, device=checked[0].device)
    f32 = [t for t in checked if t.dtype == torch.float32]
    row = {'name': 'finite_check', 'route': 'cuda',
           'source': 'paddle_tpu_torch/ops/kernels/csrc/finite_check.cu',
           'replaces': common.KERNELS['finite_check']['replaces'].split(
               ' ')[0],
           'launches': 0, 'max_abs_err': 0.0,
           'ms': timer.ms(lambda: fin_k.finite_check(checked)),
           'plain_ms': timer.ms(lambda: fin_k.finite_check_plain(checked)),
           'bound_ms': nbytes / HBM_BYTES_PER_S * 1e3, 'bound_by': 'bytes',
           'library_ms': timer.ms(
               lambda: torch._amp_foreach_non_finite_check_and_unscale_(
                   f32, found, one))}
    log('  %-28s cold L2, (f)\'s %d values: kernel %.4f ms  plain %.4f ms  '
        'library %.4f ms (_amp_foreach_non_finite_check_and_unscale_, '
        'the %d f32 ones, one flag)  bound %.4f ms (bytes)' % (
            'finite_check', len(checked), row['ms'], row['plain_ms'],
            row['library_ms'], len(f32), row['bound_ms']))
    return row


def p19_step_ms(fn, steps=3):
    secs = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        without_counting(fn)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return statistics.median(secs) * 1e3


def graph_cond_row(dev, decode):
    """graph_cond's row: the kernel timed in a graph of 100 launches on a
    handle of an IF node with an empty body, beside the host read of a
    condition (the plain version's cost: a device-to-host copy)."""
    pred = torch.ones((), dtype=torch.bool, device=dev)
    scratch = torch.zeros((), device=dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    graph = torch.cuda.CUDAGraph()
    reps = 100

    def capture():
        with torch.cuda.graph(graph, stream=side):
            handle = graph_cond.create_handle(torch.cuda.current_stream(dev))
            for _ in range(reps):
                graph_cond.set_cond(handle, pred)
            body = torch.cuda.Stream(dev)
            graph_cond.begin_body(torch.cuda.current_stream(dev), handle,
                                  False, body)
            with torch.cuda.stream(body):
                scratch.add_(1.0)
            graph_cond.end_body(body)
    without_counting(capture)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(10):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (10 * reps)
    secs = []
    for _ in range(100):
        t0 = time.perf_counter()
        bool(pred)
        secs.append(time.perf_counter() - t0)
    plain_ms = statistics.median(secs) * 1e3
    row = {'name': 'graph_cond', 'route': 'cuda',
           'source': 'paddle_tpu_torch/ops/kernels/csrc/graph_cond.cu',
           'replaces': common.KERNELS['graph_cond']['replaces'].split(' ')[0],
           'launches': 0, 'max_abs_err': 0.0, 'ms': ms, 'plain_ms': plain_ms,
           'bound_ms': 1.0 / HBM_BYTES_PER_S * 1e3, 'bound_by': 'bytes',
           'library_ms': None}
    log('  %-28s warm: kernel %.4f ms a launch (100 in a graph), the plain '
        'version\'s host read of the condition %.4f ms (host clock), library '
        'none; the (a) decode replayed %.2f ms against %.2f eager (device '
        '%.2f)' % ('graph_cond', ms, plain_ms, decode['replay_ms'],
                   decode['eager_ms'], decode['device_ms']))
    return row


def compile_plane_phase(seed, dev, timer):
    """Phase 19: the rest of the compile plane.  Returns the kernels
    line's rows of finite_check and graph_cond."""
    card = card_line()
    log('[19] the compile plane: conditional nodes, pipelines, the '
        'training CompiledStep, the in-graph finite check (%s | %s)' % (
            torch.cuda.get_device_name(0), card))
    decode = p19_decode(seed, card)
    torch.cuda.empty_cache()
    b = p19_switch(seed, card)
    p19_print(seed, card, b)
    torch.cuda.empty_cache()
    p19_compiled_step(seed, card, b)
    torch.cuda.empty_cache()
    fin_row = p19_nan_check(seed, card, b, timer)
    b.clear()
    gc.collect()
    torch.cuda.empty_cache()
    p19_save_load(seed, card)
    torch.cuda.empty_cache()
    return [fin_row, graph_cond_row(dev, decode)]


# ----------------------------------------------------------- phase 20
CIFAR_BATCH = 128   # Fluid 1.6 book test_image_classification.py
CIFAR_LR = 0.001    # its Adam(learning_rate=0.001)
CIFAR_STEPS = 20
WD_AUC_STEPS = 10
WD_AUC_THRESHOLDS = 4095
WD_AUC_TOL = 1e-6
NN_TOL = 1e-5       # (c): floats within 1e-5 of the largest magnitude
DRAW_BATCH = 1024   # (d): 1024 x 1024 = 10^6 draws of each op a step
DRAW_DIM = 1024
DRAW_STEPS = 6
DRAW_STD = 0.1
DRAW_SIGMAS = 3.0


def cifar_path(seed):
    """The book's image classifier: the JAX package's resnet18_cifar
    (models.resnet.build(image_shape=(3, 32, 32), class_dim=10,
    depth=18)) trained by Fluid 1.6's book recipe, Adam(0.001) at batch
    128, with its for_test clone."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed + 1
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        feeds, _, loss, acc = resnet.build(image_shape=(3, 32, 32),
                                           class_dim=10, depth=18)
        test = main.clone(for_test=True)
        fluid.optimizer.Adam(learning_rate=CIFAR_LR).minimize(loss)
    expected = {k: 0 for k in common.KERNELS}
    expected['fused_adam'] = 1
    return {'name': 'ResNet-18 CIFAR-10 Adam', 'main': main,
            'startup': startup, 'test': test, 'feeds': feeds, 'loss': loss,
            'acc': acc, 'expected': expected, 'bitwise': True,
            'batch': None}


def cifar_reader(train):
    """cifar's samples as [3, 32, 32] images and int64 labels."""
    return rdr.map_readers(lambda s: (s[0].reshape(3, 32, 32), s[1]),
                           train)


def cifar_loader(path, seed):
    """dataset.cifar.train10() through reader.shuffle and reader.batch
    (drop_last) into a DataLoader staging onto the card, for as many
    epochs as CIFAR_STEPS takes."""
    batches = rdr.batch(rdr.shuffle(cifar_reader(cifar.train10()), 1024),
                        CIFAR_BATCH, drop_last=True)

    def epochs():
        for _ in range(-(-CIFAR_STEPS * CIFAR_BATCH // 1024)):
            yield from batches()
    random.seed(seed)
    loader = fluid.io.DataLoader.from_generator(
        feed_list=[path['feeds']['image'], path['feeds']['label']],
        capacity=4)
    return loader.set_sample_list_generator(epochs, fluid.CUDAPlace(0))


def p20_steps(path, feeds, fetch, start=None, eager=False, watch=()):
    """`feeds` (an iterable of feed dicts) as steps of path['main'] on a
    new executor and scope after path['startup'], from `start` where
    given (else the startup state, returned): through Executor.run,
    counted (step 1 eager, step 2 captured, later steps replayed), or
    with `eager` through eager_run, uncounted.  Returns {'steps': [{'out'
    (fetched tensors), 'counts', 'replayed' (by kernel), 'secs',
    'before' / 'after' (copies of the `watch` variables)}], 'feeds' (a
    copy of each), 'start', 'refused' (capture refusals), 'exe',
    'scope'}."""
    main = path['main']
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    res = {'steps': [], 'feeds': [], 'exe': exe, 'scope': scope}
    with fluid.scope_guard(scope):
        without_counting(lambda: exe.run(path['startup']))
        if start is None:
            start = snapshot(scope, weights.startup_names(path['startup']))
        else:
            for n, v in start.items():
                scope.set_var(n, v.clone())
        for feed in feeds:
            res['feeds'].append({k: torch.as_tensor(v).clone()
                                 for k, v in feed.items()})
            step = {'before': snapshot(scope, watch)}
            t0 = time.perf_counter()
            if eager:
                out = without_counting(lambda: eager_run(
                    exe, main, feed, fetch, return_numpy=False))
            else:
                out, step['counts'] = counted(lambda: exe.run(
                    main, feed=feed, fetch_list=fetch, return_numpy=False))
                step['replayed'] = {k: common.replayed(k)
                                    for k in common.KERNELS}
            torch.cuda.synchronize()
            step['secs'] = time.perf_counter() - t0
            step['out'] = [v.clone() for v in out]
            step['after'] = snapshot(scope, watch)
            res['steps'].append(step)
        res['refused'] = graph_refusals(main, scope)
    res['start'] = start
    return res


def check_replayed(label, res, expected, kernel):
    """Every step launched `expected`, every step after the first was
    replayed from a CUDA graph (its `kernel` launches all replayed), and
    no capture was refused."""
    for k, step in enumerate(res['steps']):
        if step['counts'] != expected:
            raise AssertionError('%s step %d launched %s, expected %s' % (
                label, k + 1, step['counts'], expected))
    replayed = sum(s['replayed'][kernel] for s in res['steps'])
    if res['refused'] or replayed != \
            (len(res['steps']) - 1) * expected[kernel]:
        raise AssertionError('%s: %d %s launches replayed; refused: %s' % (
            label, replayed, kernel, res['refused']))
    return replayed


def same_steps(label, res, eager, names=()):
    """Each step's outputs and `names`' values after it bitwise the eager
    run's."""
    for k, (a, b) in enumerate(zip(res['steps'], eager['steps'])):
        bad = [n for n in names if not torch.equal(a['after'][n],
                                                   b['after'][n])]
        if bad or not all(torch.equal(x, y) for x, y in zip(a['out'],
                                                            b['out'])):
            raise AssertionError('%s step %d: the replayed outputs or %s '
                                 'differ from the eager run' % (
                                     label, k + 1, bad))


def step_ms(res, skip):
    return statistics.median(s['secs'] for s in res['steps'][skip:]) * 1e3


def cifar_phase(seed, card):
    """Phase 20 (a): CIFAR_STEPS steps of the book's image classifier fed
    by the CIFAR reader through Executor.run (step 1 eager, step 2
    captured, the rest replayed), each launching K4 once; the losses and
    the whole state bitwise a second, eager-only run on the same
    batches; step 1 bitwise its plain-kernel step; the loss falling;
    the test clone over test10()."""
    path = cifar_path(seed)
    loss = path['loss']
    names = weights.startup_names(path['startup'])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # earlier phases' tensors still resident: the phase's own peak is
    # what it allocated above them
    resting = torch.cuda.memory_allocated()
    batches = iter(cifar_loader(path, seed))
    res = p20_steps(path, itertools.islice(batches, CIFAR_STEPS), [loss])
    batches.close()
    peak = torch.cuda.max_memory_allocated() - resting
    replayed = check_replayed('(a)', res, path['expected'], 'fused_adam')
    eager = p20_steps(path, res['feeds'], [loss], res['start'], eager=True)
    same_steps('(a)', res, eager)
    with fluid.scope_guard(res['scope']):
        end = snapshot(res['scope'], names)
        dev_ms = without_counting(lambda: device_ms(profile_run(
            '', lambda: res['exe'].run(path['main'], feed=res['feeds'][-1],
                                       fetch_list=[loss]), quiet=True)))
    differ = [n for n in names
              if not torch.equal(eager['scope'].find_var(n), end[n])]
    if differ:
        raise AssertionError('(a) the state after the replayed steps '
                             'differs from the eager run in %s' % differ[:5])
    losses = [float(s['out'][0]) for s in res['steps']]
    after1 = p20_steps(path, res['feeds'][:1], [loss], res['start'],
                       eager=True, watch=names)['steps'][0]['after']
    check_plain_step(path, [loss.name], res['start'], after1, losses[0], [],
                     CIFAR_LR, batch=res['feeds'][0])
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError('(a) losses not finite or not falling: %s'
                             % losses)
    # the for_test clone over test10()'s batches
    feeder = fluid.DataFeeder([path['feeds']['image'],
                               path['feeds']['label']], fluid.CUDAPlace(0),
                              program=path['test'])
    evals = []
    with fluid.scope_guard(res['scope']):
        for batch in rdr.batch(cifar_reader(cifar.test10()), CIFAR_BATCH)():
            (l, a), counts = counted(lambda: res['exe'].run(
                path['test'], feed=feeder.feed(batch),
                fetch_list=[path['loss'], path['acc']]))
            evals.append((float(l), float(a), len(batch)))
            if any(counts.values()):
                raise AssertionError('(a) the test clone launched %s'
                                     % counts)
    if len(evals) != 2 or not np.isfinite([e[:2] for e in evals]).all():
        raise AssertionError('(a) test clone: %s' % evals)
    rep_ms, eager_ms = step_ms(res, 2), step_ms(eager, 1)
    log('  (a) %d steps at batch %d from the CIFAR reader (DataLoader, '
        'reader.shuffle + batch): losses %s; K4 launched %d times (%d '
        'replayed); replayed bitwise the eager-only run, step 1 bitwise '
        'its plain-kernel step' % (
            CIFAR_STEPS, CIFAR_BATCH, ['%.4f' % x for x in losses[::4]] +
            ['%.4f' % losses[-1]], CIFAR_STEPS, replayed))
    log('  (a) replayed %.3f ms a step (%.0f images/s), cached eager %.3f '
        'ms, device %.3f ms (one profiled replay), peak %.3f GiB over the '
        'resident %.3f; test clone over %d images: loss %.4f, accuracy '
        '%.4f (%s | %s)' % (
            rep_ms, CIFAR_BATCH / rep_ms * 1e3, eager_ms, dev_ms,
            peak / 2 ** 30, resting / 2 ** 30, sum(e[2] for e in evals),
            np.mean([e[0] for e in evals]), np.mean([e[1] for e in evals]),
            torch.cuda.get_device_name(0), card))


def wide_deep_auc_program(seed):
    """wide_deep_program's Wide&Deep (its batch and launches) with the
    PaddleRec CTR recipe's streaming AUC on its [1 - p, p]
    predictions."""
    path = wide_deep_program(seed)
    cfg = wide_deep.WideDeepConfig(sparse_feature_dim=WD_ROWS)
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed + 1
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        feeds, preds, loss = wide_deep.build(cfg)
        auc, _, stats = fluid.layers.auc(preds, feeds['label'],
                                         num_thresholds=WD_AUC_THRESHOLDS)
        fluid.optimizer.Adagrad(WD_LR, epsilon=1e-6).minimize(loss)
    path.update(name='Wide&Deep Adagrad + auc', main=main, startup=startup,
                loss=loss, preds=preds, auc=auc,
                stats=[v.name for v in stats])
    return path


def wd_auc_phase(seed, card):
    """Phase 20 (b): Wide&Deep with auc, WD_AUC_STEPS steps replayed from
    a CUDA graph after the first two, K6 and K7 launched and counted
    each step; StatPos / StatNeg and the outputs bitwise an eager-only
    run's after every step, the AUC of step WD_AUC_STEPS within
    WD_AUC_TOL of the auc op's CPU lowering on that step's predictions
    and statistics (which it must reproduce bitwise); the replayed step
    against Wide&Deep without auc."""
    path = wide_deep_auc_program(seed)
    feeds = [path['batch']] * WD_AUC_STEPS
    fetch = [path['loss'], path['auc'], path['preds']]
    res = p20_steps(path, feeds, fetch, watch=path['stats'])
    check_replayed('(b)', res, path['expected'], 'embedding_update')
    eager = p20_steps(path, feeds, fetch, res['start'], eager=True,
                      watch=path['stats'])
    same_steps('(b)', res, eager, path['stats'])
    last = res['steps'][-1]
    stat_pos, stat_neg = path['stats']
    cpu = registry.get('auc').run(registry.LowerCtx(step=0, device='cpu'), {
        'Predict': [last['out'][2].cpu()],
        'Label': [torch.as_tensor(path['batch']['label'])],
        'StatPos': [last['before'][stat_pos].cpu()],
        'StatNeg': [last['before'][stat_neg].cpu()]},
        {'num_thresholds': WD_AUC_THRESHOLDS})
    err = abs(float(cpu['AUC'][0]) - float(last['out'][1]))
    if err > WD_AUC_TOL or not (
            torch.equal(cpu['StatPosOut'][0], last['after'][stat_pos].cpu())
            and torch.equal(cpu['StatNegOut'][0],
                            last['after'][stat_neg].cpu())):
        raise AssertionError('(b) step %d: AUC %.9f against the CPU '
                             'lowering\'s %.9f, or its statistics differ'
                             % (WD_AUC_STEPS, float(last['out'][1]),
                                float(cpu['AUC'][0])))
    plain = wide_deep_program(seed)
    plain = without_counting(lambda: p20_steps(plain, feeds, [plain['loss']],
                                               res['start']))
    log('  (b) Wide&Deep (%d-row tables, batch %d) with auc(num_thresholds='
        '%d): losses %.6f -> %.6f, AUC %s; StatPos + StatNeg count %d '
        'examples, bitwise the eager-only run after every step; step %d\'s '
        'AUC %.9f, the CPU lowering %.9f (|diff| %.1e); K6 and K7 launched '
        'and replayed each step (%s)' % (
            WD_ROWS, WD_BATCH, WD_AUC_THRESHOLDS,
            float(res['steps'][0]['out'][0]), float(last['out'][0]),
            ['%.5f' % float(s['out'][1]) for s in res['steps']],
            sum(float(v.sum()) for v in last['after'].values()),
            WD_AUC_STEPS, float(last['out'][1]), float(cpu['AUC'][0]), err,
            {k: n for k, n in path['expected'].items() if n}))
    log('  (b) replayed step with auc %.4f ms, without %.4f ms, cached '
        'eager with auc %.4f ms (%s | %s)' % (
            step_ms(res, 2), step_ms(plain, 2), step_ms(eager, 1),
            torch.cuda.get_device_name(0), card))


def nn_op_cases(rng):
    """Every op type of the nn slice at a size its users run: (op,
    make_inputs, attrs), the inputs made when make_inputs() is called.
    tests/test_torch_coverage.py holds the list of those op types and
    checks that each has a case here."""
    f = lambda *s: rng.randn(*s).astype('float32')  # noqa: E731
    prob = lambda *s: rng.uniform(0.02, 0.98, s).astype('float32')  # noqa

    def pooled(x):
        """(max, flat h * w index) of x's 2 x 2 windows, for unpool."""
        n, c, h, w = x.shape
        win = x.reshape(n, c, h // 2, 2, w // 2, 2).transpose(
            0, 1, 2, 4, 3, 5).reshape(n, c, h // 2, w // 2, 4)
        am = win.argmax(-1)
        rows = np.arange(h // 2)[:, None] * 2 + am // 2
        cols = np.arange(w // 2)[None, :] * 2 + am % 2
        return win.max(-1), (rows * w + cols).astype('int32')

    def unpool_ins():
        vals, idx = pooled(f(8, 64, 112, 112))
        return {'X': [vals], 'Indices': [idx]}

    def auc_ins():
        p = prob(4096)
        return {'Predict': [np.stack([1 - p, p], 1)],
                'Label': [(rng.rand(4096, 1) < p[:, None]).astype('int64')],
                'StatPos': [rng.randint(0, 50, 4096).astype('float32')],
                'StatNeg': [rng.randint(0, 50, 4096).astype('float32')]}

    fpn = lambda: f(8, 256, 64, 64)  # noqa: E731  an FPN level at batch 8
    return [
        # a DCGAN / FPN decoder stage; grouped and dilated, asymmetric
        ('conv2d_transpose', lambda: {'Input': [f(8, 256, 32, 32)],
                                      'Filter': [f(256, 128, 4, 4) * 0.02]},
         {'strides': [2, 2], 'paddings': [1, 1]}),
        ('conv2d_transpose', lambda: {'Input': [f(8, 64, 28, 28)],
                                      'Filter': [f(64, 16, 3, 3) * 0.05]},
         {'strides': [2, 2], 'paddings': [0, 1, 1, 0], 'groups': 4,
          'dilations': [2, 1]}),
        ('depthwise_conv2d_transpose',
         lambda: {'Input': [f(8, 128, 32, 32)],
                  'Filter': [f(128, 1, 3, 3) * 0.1]},
         {'strides': [2, 2], 'paddings': [1, 1], 'groups': 128}),
        # style transfer's instance norm, ResNet-50 group norm (32 groups)
        ('instance_norm', lambda: {'X': [f(4, 128, 128, 128)],
                                   'Scale': [f(128)], 'Bias': [f(128)]},
         {'epsilon': 1e-5}),
        ('group_norm', lambda: {'X': [f(32, 256, 56, 56)],
                                'Scale': [f(256)], 'Bias': [f(256)]},
         {'groups': 32, 'epsilon': 1e-5}),
        # detection box regression, CTR, distillation, regression
        ('huber_loss', lambda: {'X': [f(8192, 4)], 'Y': [f(8192, 4)]},
         {'delta': 1.0}),
        ('smooth_l1_loss', lambda: {'X': [f(8192, 4)], 'Y': [f(8192, 4)]},
         {'sigma': 3.0}),
        ('log_loss', lambda: {'Predicted': [prob(4096, 1)],
                              'Labels': [(rng.rand(4096, 1) > 0.5).astype(
                                  'float32')]}, {'epsilon': 1e-4}),
        ('kldiv_loss', lambda: {'X': [np.log(prob(256, 1000))],
                                'Target': [prob(256, 1000) / 500.0]},
         {'reduction': 'batchmean'}),
        ('mse_loss', lambda: {'X': [f(128, 1000)], 'Y': [f(128, 1000)]}, {}),
        ('auc', auc_ins, {'num_thresholds': 4095}),
        # FPN's 2x top-down up-sampling, and a non-integer down-sampling
        ('bilinear_interp', lambda: {'X': [fpn()]}, {'out_h': 128,
                                                     'out_w': 128}),
        ('bilinear_interp', lambda: {'X': [fpn()]}, {'out_h': 40,
                                                     'out_w': 40}),
        ('nearest_interp', lambda: {'X': [fpn()]}, {'scale': 2.0}),
        ('interp_nearest', lambda: {'X': [fpn()]}, {'out_h': 45,
                                                    'out_w': 90}),
        # a spatial transformer's sampler
        ('grid_sampler', lambda: {'X': [f(32, 64, 56, 56)],
                                  'Grid': [rng.uniform(-1.05, 1.05, (
                                      32, 56, 56, 2)).astype('float32')]},
         {}),
        # TSM on a ResNet-50 stage: 8 clips of 8 segments
        ('temporal_shift', lambda: {'X': [f(64, 64, 56, 56)]},
         {'seg_num': 8, 'shift_ratio': 0.125}),
        # AlexNet's first lrn
        ('lrn', lambda: {'X': [f(32, 96, 55, 55)]},
         {'n': 5, 'k': 2.0, 'alpha': 1e-4, 'beta': 0.75}),
        # a SegNet encoder stage; a C3D / 3-D U-Net pool
        ('max_pool2d_with_index', lambda: {'X': [f(8, 64, 112, 112)]},
         {'ksize': [2, 2], 'strides': [2, 2]}),
        ('max_pool2d_with_index', lambda: {'X': [np.round(f(
            8, 64, 56, 56))]},
         {'ksize': [3, 3], 'strides': [2, 2], 'paddings': [1, 1]}),
        ('max_pool3d_with_index', lambda: {'X': [f(4, 64, 16, 56, 56)]},
         {'ksize': [2, 2, 2], 'strides': [2, 2, 2]}),
        ('unpool', unpool_ins, {'ksize': [2, 2], 'strides': [2, 2]}),
        # an NTM's shift weighting
        ('conv_shift', lambda: {'X': [f(32, 128)], 'Y': [f(32, 3)]}, {}),
        ('size', lambda: {'Input': [f(8, 256, 64, 64)]}, {}),
        ('rank', lambda: {'Input': [f(8, 256, 64, 64)]}, {}),
        ('soft_relu', lambda: {'X': [f(128, 1000) * 30]},
         {'threshold': 40.0}),
        ('gaussian_random_batch_size_like',
         lambda: {'Input': [f(4096, 8)]},
         {'shape': [-1, 1024], 'mean': 0.0, 'std': 0.1, 'seed': 0,
          'dtype': 'float32'}),
    ]


# (c): the gradient that F.grid_sample adds into X with atomics on the
# card, in an order that varies from launch to launch
NN_NOT_TWICE = {('grid_sampler', 'grad 0')}


def ops_against_cpu(cases, dev, seed, tol, not_twice=frozenset()):
    """Each case's op on the card, forward and gradient, twice, against
    the same lowering on the CPU: floats within `tol` of the largest
    magnitude, integers, shapes and dtypes exact, and the second launch
    bitwise the first but for the (op, output) pairs in `not_twice`; a
    host op runs through a one-op program (host_op_run).  Returns (the
    worst float error, the outputs and gradients compared)."""
    worst, n_out = 0.0, 0
    for op, make, attrs in cases:
        ins = make()
        if registry.get(op).host:
            run = lambda place: host_op_run(op, ins, place, attrs)  # noqa
            first, second = run(fluid.CUDAPlace(0)), run(fluid.CUDAPlace(0))
            cpu = run(fluid.CPUPlace())
        else:
            first = lang_op_run(op, ins, attrs, dev, seed)
            second = lang_op_run(op, ins, attrs, dev, seed)
            cpu = lang_op_run(op, ins, attrs, 'cpu', seed)
        outs = [(s, a, b, c) for s in sorted(first[0]) for a, b, c in
                zip(first[0][s], second[0][s], cpu[0][s])]
        outs += [('grad %d' % k, a, b, c) for k, (a, b, c) in enumerate(
            zip(first[1], second[1], cpu[1])) if a is not None]
        twice = [s for s, a, b, _ in outs if not torch.equal(a, b) and
                 (op, s) not in not_twice]
        bad = []
        for s, a, _, c in outs:
            n_out += 1
            if a.shape != c.shape or a.dtype != c.dtype:
                bad.append('%s %s %s against %s %s' % (
                    s, tuple(a.shape), a.dtype, tuple(c.shape), c.dtype))
            elif a.is_floating_point() and a.numel():
                err = max_abs(a, c) / max(c.abs().max().item(), 1e-30)
                worst = max(worst, err)
                if err > tol:
                    bad.append('%s %.2e' % (s, err))
            elif not torch.equal(a, c):
                bad.append(s)
        if twice or bad:
            raise AssertionError(
                '%s on the card: second launch differs in %s; against the '
                'CPU: %s' % (op, twice, bad))
        del ins, first, second, cpu, outs
    return worst, n_out


def nn_ops_phase(seed, dev):
    """Phase 20 (c): every op type of the nn slice on the card, forward
    and gradient, against the same lowering on the CPU (floats within
    NN_TOL of the largest magnitude, integers exact), and twice bitwise
    but NN_NOT_TWICE, cuDNN deterministic."""
    cases = nn_op_cases(np.random.RandomState(seed + 20))
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        worst, n_out = ops_against_cpu(cases, dev, seed, NN_TOL,
                                       NN_NOT_TWICE)
    finally:
        torch.backends.cudnn.deterministic = saved
    log('  (c) %d op types (%d cases, %d outputs and gradients) on the card '
        'against the CPU (integers exact, floats within %g of the largest '
        'magnitude; worst %.1e), twice bitwise but %s' % (
            len({op for op, _, _ in cases}), len(cases), n_out, NN_TOL,
            worst, sorted(NN_NOT_TWICE)))


def draws_path(seed):
    """A denoising step: x + gaussian_random_batch_size_like(x, std 0.1)
    + gaussian_random, times a uniform_random keep mask at 0.9, through
    an fc, against x (square error), Adam."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed + 1
    L = fluid.layers
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = L.data('x', [DRAW_BATCH, DRAW_DIM], dtype='float32',
                   append_batch_size=False)
        like = L.gaussian_random_batch_size_like(x, [-1, DRAW_DIM],
                                                 std=DRAW_STD)
        gauss = L.gaussian_random([DRAW_BATCH, DRAW_DIM], std=DRAW_STD)
        unif = L.uniform_random([DRAW_BATCH, DRAW_DIM], min=0.0, max=1.0)
        keep = L.cast(L.greater_equal(unif, L.fill_constant(
            [1], 'float32', 0.1)), 'float32')
        noisy = L.elementwise_mul(L.elementwise_add(
            L.elementwise_add(x, like), gauss), keep)
        loss = L.mean(L.square_error_cost(L.fc(noisy, DRAW_DIM), x))
        fluid.optimizer.Adam(1e-3).minimize(loss)
    expected = {k: 0 for k in common.KERNELS}
    expected['fused_adam'] = 1
    return {'main': main, 'startup': startup, 'expected': expected,
            'fetch': [loss, like, gauss, unif]}


def draws_phase(seed, card):
    """Phase 20 (d): the device draws of a main program replayed from a
    CUDA graph: each step draws anew, each replay bitwise the eager step
    of the same number, and 10^6 draws of each op with the mean and the
    standard deviation within DRAW_SIGMAS of their sampling error."""
    path = draws_path(seed)
    feeds = [{'x': torch.as_tensor(np.random.RandomState(seed).rand(
        DRAW_BATCH, DRAW_DIM).astype('float32'), device='cuda')}] * \
        DRAW_STEPS
    res = p20_steps(path, feeds, path['fetch'])
    replayed = check_replayed('(d)', res, path['expected'], 'fused_adam')
    eager = p20_steps(path, feeds, path['fetch'], res['start'], eager=True)
    same_steps('(d)', res, eager)
    draws = [s['out'][1:] for s in res['steps']]
    for k in range(1, DRAW_STEPS):
        if any(torch.equal(a, b) for a, b in zip(draws[k], draws[k - 1])):
            raise AssertionError('(d) step %d drew what step %d drew' % (
                k + 1, k))
    n = DRAW_BATCH * DRAW_DIM
    stats = []
    for (name, mean, std, std_err), v in zip((
            ('gaussian_random_batch_size_like', 0.0, DRAW_STD,
             DRAW_STD / math.sqrt(2 * n)),
            ('gaussian_random', 0.0, DRAW_STD, DRAW_STD / math.sqrt(2 * n)),
            ('uniform_random', 0.5, math.sqrt(1 / 12.0),
             math.sqrt(1 / 80.0 - 1 / 144.0) / (2 * math.sqrt(1 / 12.0)) /
             math.sqrt(n))), draws[0]):
        m, s = v.double().mean().item(), v.double().std().item()
        dm, ds = (m - mean) / (std / math.sqrt(n)), (s - std) / std_err
        stats.append('%s mean %.3g sd, std %.3g sd' % (name, dm, ds))
        if abs(dm) > DRAW_SIGMAS or abs(ds) > DRAW_SIGMAS:
            raise AssertionError('(d) %s: mean %.6f, std %.6f over %d draws '
                                 '(%.2f and %.2f sigma)' % (name, m, s, n,
                                                            dm, ds))
    log('  (d) a denoising step drawing 3 x 10^6 values a step on the card: '
        '%d steps, %d replayed, each bitwise the eager step of the same '
        'number, each drawing anew; step 1 against the expected moments: '
        '%s; replayed %.3f ms a step, eager %.3f ms (%s | %s)' % (
            DRAW_STEPS, replayed, '; '.join(stats), step_ms(res, 2),
            step_ms(eager, 1), torch.cuda.get_device_name(0), card))


def nn_slice_phase(seed, dev):
    """Phase 20: the loaders, the rest of the core and the nn ops."""
    card = card_line()
    log('[20] the dataset loaders, the rest of the core, the nn ops (%s | '
        '%s)' % (torch.cuda.get_device_name(0), card))
    saved = torch.backends.cudnn.deterministic, \
        torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    out = {}
    try:
        for key, fn in (('a', lambda: cifar_phase(seed, card)),
                        ('b', lambda: wd_auc_phase(seed, card)),
                        ('c', lambda: without_counting(
                            lambda: nn_ops_phase(seed, dev))),
                        ('d', lambda: draws_phase(seed, card))):
            t0 = time.perf_counter()
            out[key] = fn()
            gc.collect()
            torch.cuda.empty_cache()
            log('  (%s): %.1f s' % (key, time.perf_counter() - t0))
    finally:
        torch.backends.cudnn.deterministic, \
            torch.backends.cudnn.benchmark = saved
    return out


# ----------------------------------------------------------- phase 21
# (a) C3D (Tran et al., "Learning Spatiotemporal Features with 3D
# Convolutional Networks", ICCV 2015, Fig. 3 and section 3.3): eight
# 3x3x3 convolutions in five blocks, five max pools (pool1 1x2x2, pool5
# padded (0, 1, 1): 512 x 1 x 4 x 4 = 8192), fc6 and fc7 of 4096 with
# dropout 0.5, fc8 over Sports-1M's 487 classes; 16-frame 112 x 112
# clips at batch 30, SGD at 0.003
C3D = {'widths': ((64,), (128,), (256, 256), (512, 512), (512, 512)),
       'pools': ((1, 2, 2), (2, 2, 2), (2, 2, 2), (2, 2, 2), (2, 2, 2)),
       'pads': ((0, 0, 0),) * 4 + ((0, 1, 1),),
       'clip': (16, 112, 112), 'fc': 4096, 'classes': 487, 'dropout': 0.5}
C3D_BATCH = 30
C3D_LR = 0.003
C3D_STEPS = 6
# (b) the CTR-DNN of PaddlePaddle/models PaddleRec/ctr/dnn
# (network_conf.py ctr_dnn_model at its train.py defaults): 13 dense
# features, 26 sparse slots in one 1,000,001-row table of width 10,
# three fc layers of 400, softmax over 2, auc over 2^12 thresholds; its
# dense features through data_norm, each slot's pooled row with the
# instance's show and click in front through continuous_value_model
CTR = {'dense': 13, 'slots': 26, 'rows': 1000001, 'emb': 10,
       'num_hash': 2, 'hidden': (400, 400, 400), 'thresholds': 2 ** 12}
CTR_BATCH = 4096
CTR_LR = WD_LR      # Wide&Deep's sparse Adagrad (phase 7)
CTR_STEPS = 10
AB_TOL = 1e-5       # (c): floats within 1e-5 of the largest magnitude
TWO_LOSS_STEPS = 6  # (d)
TWO_LOSS_RTOL, TWO_LOSS_ATOL = 1e-5, 1e-6
SDPA_STEPS = 4


def c3d_build(fluid, cfg):
    """C3D from `fluid`'s layers (either package's): conv3d (3x3x3,
    stride 1, padding 1, relu) blocks, each closed by a max pool3d,
    then fc6 / fc7 (relu, dropout) and fc8 with softmax cross
    entropy.  Returns (feeds, logits, loss)."""
    L = fluid.layers
    clip = L.data('clip', [3] + list(cfg['clip']), dtype='float32')
    label = L.data('label', [1], dtype='int64')
    h = clip
    for widths, pool, pad in zip(cfg['widths'], cfg['pools'], cfg['pads']):
        for w in widths:
            h = L.conv3d(h, w, 3, stride=1, padding=1, act='relu')
        h = L.pool3d(h, pool_size=list(pool), pool_type='max',
                     pool_stride=list(pool), pool_padding=list(pad))
    for _ in range(2):
        h = L.fc(h, cfg['fc'], act='relu')
        if cfg['dropout']:
            h = L.dropout(h, dropout_prob=cfg['dropout'])
    logits = L.fc(h, cfg['classes'])
    loss = L.mean(L.softmax_with_cross_entropy(logits, label))
    return {'clip': clip, 'label': label}, logits, loss


def ctr_build(fluid, cfg, cvm_layer='continuous_value_model'):
    """The CTR-DNN from `fluid`'s layers: the raw ids of each slot
    hashed num_hash times into the table (hash), looked up (is_sparse,
    so Adagrad updates the rows with fused_emb_update) and sum-pooled a
    slot; [show, click] in front of each slot's row through
    continuous_value_model (use_cvm; `cvm_layer` 'cvm' takes the cvm
    layer, the same op under its own name, as the JAX package runs it:
    its continuous_value_model layer's program has no value for its
    output); the dense features through data_norm; three relu fc
    layers, softmax over 2, cross entropy, and auc.  Returns (feeds,
    predict, loss, auc, auc statistics)."""
    L = fluid.layers
    s, e = cfg['slots'], cfg['emb']
    dense = L.data('dense_input', [cfg['dense']], dtype='float32')
    ids = L.data('slot_ids', [s], dtype='int64')
    show_click = L.data('show_click', [2], dtype='float32')
    label = L.data('label', [1], dtype='int64')
    rows = L.hash(ids, hash_size=cfg['rows'], num_hash=cfg['num_hash'])
    emb = L.embedding(rows, size=[cfg['rows'], e], is_sparse=True,
                      param_attr=fluid.ParamAttr(
                          name='SparseFeatFactors',
                          initializer=fluid.initializer.Uniform()))
    pooled = L.reduce_sum(L.reshape(emb, [0, s, cfg['num_hash'], e]), dim=2)
    sc = L.expand(L.unsqueeze(show_click, [1]), [1, s, 1])
    rows_in = L.reshape(L.concat([sc, pooled], axis=2), [-1, e + 2])
    if cvm_layer == 'cvm':
        cvm = L.cvm(rows_in, use_cvm=True)
    else:
        cvm = L.continuous_value_model(rows_in, L.reshape(sc, [-1, 2]),
                                       use_cvm=True)
    h = L.concat([L.reshape(cvm, [-1, s * (e + 2)]), L.data_norm(dense)],
                 axis=1)
    for w in cfg['hidden']:
        h = L.fc(h, w, act='relu', param_attr=fluid.ParamAttr(
            initializer=fluid.initializer.Normal(
                scale=1.0 / math.sqrt(h.shape[1]))))
    predict = L.fc(h, 2, act='softmax', param_attr=fluid.ParamAttr(
        initializer=fluid.initializer.Normal(
            scale=1.0 / math.sqrt(h.shape[1]))))
    loss = L.mean(L.cross_entropy(predict, label))
    auc, _, stats = L.auc(predict, label, num_thresholds=cfg['thresholds'])
    feeds = {'dense_input': dense, 'slot_ids': ids,
             'show_click': show_click, 'label': label}
    return feeds, predict, loss, auc, stats


def ctr_batch(cfg, batch, rng):
    """A synthetic Criteo-like batch: 13 non-negative dense counts, a
    raw 31-bit id a slot, show counts from 1 and clicks at most the
    shows, and a label that follows the dense features and the clicks."""
    dense = np.floor(rng.exponential(3.0, (batch, cfg['dense']))).astype(
        'float32')
    ids = rng.randint(0, 2 ** 31 - 1, (batch, cfg['slots'])).astype('int64')
    show = 1.0 + rng.poisson(3.0, batch)
    click = np.minimum(rng.poisson(0.5, batch), show)
    score = dense.mean(1) / 3.0 + click / show + rng.rand(batch) * 0.5
    label = (score > np.median(score)).astype('int64')[:, None]
    return {'dense_input': dense, 'slot_ids': ids,
            'show_click': np.stack([show, click], 1).astype('float32'),
            'label': label}


def c3d_path(seed):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed + 1
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        feeds, _, loss = c3d_build(fluid, C3D)
        fluid.optimizer.SGD(C3D_LR).minimize(loss)
    expected = {k: 0 for k in common.KERNELS}
    expected.update(dropout_launches(main))
    n_params = sum(int(np.prod(p.shape)) for p in main.all_parameters())
    return {'main': main, 'startup': startup, 'feeds': feeds, 'loss': loss,
            'expected': expected, 'params': n_params}


def conv_share(events):
    """(the share of device time in convolution kernels, the five
    longest kernels with their ms) of a profile: cuDNN's kernels name
    their pass (fprop / dgrad / wgrad) or convolution."""
    from torch.autograd import DeviceType
    cuda = [e for e in events if e.device_type == DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in cuda) or 1.0
    conv = sum(e.self_device_time_total for e in cuda if any(
        k in e.key.lower() for k in ('conv', 'fprop', 'dgrad', 'wgrad')))
    top = sorted(cuda, key=lambda e: -e.self_device_time_total)[:5]
    return conv / total, [(e.key[:60], e.self_device_time_total / 1e3)
                          for e in top]


def c3d_phase(seed, card):
    """Phase 21 (a): C3D at the paper's widths, C3D_STEPS SGD steps at
    batch C3D_BATCH on clips drawn on the card from the seed (step 1
    eager, step 2 captured, the rest replayed), the dropout kernels
    launched and counted each step; losses and the whole state bitwise
    a second, eager-only run on the same batches."""
    path = c3d_path(seed)
    loss = path['loss']
    names = weights.startup_names(path['startup'])
    gen = torch.Generator(device='cuda')
    gen.manual_seed(seed + 21)
    feeds = [{'clip': torch.randn((C3D_BATCH, 3) + C3D['clip'],
                                  generator=gen, device='cuda'),
              'label': torch.randint(0, C3D['classes'], (C3D_BATCH, 1),
                                     generator=gen, device='cuda')}
             for _ in range(C3D_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resting = torch.cuda.memory_allocated()
    res = p20_steps(path, feeds, [loss])
    peak = torch.cuda.max_memory_allocated() - resting
    check_replayed('(a)', res, path['expected'], 'dropout')
    eager = p20_steps(path, res['feeds'], [loss], res['start'], eager=True)
    same_steps('(a)', res, eager)
    differ = [n for n in names if not torch.equal(
        eager['scope'].find_var(n), res['scope'].find_var(n))]
    if differ:
        raise AssertionError('(a) the state after the replayed steps '
                             'differs from the eager run in %s' % differ[:5])
    # one more step each way, profiled (padded: late in a run the
    # profiler drops the first device ops it sees): a replay, and an
    # eager step
    with fluid.scope_guard(res['scope']):
        dev_ms = without_counting(lambda: device_ms(profile_run(
            '', lambda: res['exe'].run(path['main'], feed=res['feeds'][-1],
                                       fetch_list=[loss]), quiet=True,
            pad=True)))
    with fluid.scope_guard(eager['scope']):
        share, top = conv_share(without_counting(lambda: profile_run(
            '', lambda: eager_run(eager['exe'], path['main'],
                                  eager['feeds'][-1], [loss]), quiet=True,
            pad=True)))
    losses = [float(s['out'][0]) for s in res['steps']]
    if not np.isfinite(losses).all():
        raise AssertionError('(a) losses not finite: %s' % losses)
    rep_ms, eager_ms = step_ms(res, 2), step_ms(eager, 1)
    log('  (a) C3D (%d parameters) at batch %d of 3 x %d x %d x %d clips, '
        '%d SGD steps: losses %s; dropout + dropout_grad launched %d + %d '
        'a step; replayed bitwise the eager-only run' % (
            path['params'], C3D_BATCH, *C3D['clip'], C3D_STEPS,
            ['%.4f' % x for x in losses], path['expected']['dropout'],
            path['expected']['dropout_grad']))
    log('  (a) replayed %.3f ms a step (%.1f clips/s), cached eager %.3f '
        'ms, device %.3f ms (one profiled replay), %.1f%% of an eager '
        'step\'s device time in convolution kernels, peak %.3f GiB over '
        'the resident %.3f (%s | %s)' % (
            rep_ms, C3D_BATCH / rep_ms * 1e3, eager_ms, dev_ms, 100 * share,
            peak / 2 ** 30, resting / 2 ** 30,
            torch.cuda.get_device_name(0), card))
    log('  (a) longest kernels of the eager step: %s' % '; '.join(
        '%s %.2f ms' % kv for kv in top))
    drop_graphs(path['main'], res['scope'])


def ctr_path(seed):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed + 1
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        feeds, predict, loss, auc, stats = ctr_build(fluid, CTR)
        fluid.optimizer.Adagrad(CTR_LR, epsilon=1e-6).minimize(loss)
    n_update = sum(op.type == 'fused_emb_update'
                   for op in main.global_block().ops)
    expected = {k: 0 for k in common.KERNELS}
    expected.update({'embedding_lookup': 1, 'embedding_update': n_update})
    norm = [p.name for p in main.all_parameters()
            if p.name.startswith('data_norm')]
    return {'main': main, 'startup': startup, 'loss': loss,
            'predict': predict, 'auc': auc, 'stats': [v.name for v in stats],
            'norm': norm, 'expected': expected,
            'batch': ctr_batch(CTR, CTR_BATCH, np.random.RandomState(seed))}


def ctr_phase(seed, card):
    """Phase 21 (b): the CTR-DNN at batch CTR_BATCH for CTR_STEPS steps
    (step 1 eager, step 2 captured, the rest replayed), K6 and K7
    launched and counted each step; the outputs, the auc statistics and
    data_norm's parameters bitwise an eager-only run's after every step;
    the AUC of the last step within WD_AUC_TOL of the auc op's CPU
    lowering on that step's predictions and statistics."""
    path = ctr_path(seed)
    feeds = [path['batch']] * CTR_STEPS
    fetch = [path['loss'], path['auc'], path['predict']]
    watch = path['stats'] + path['norm']
    res = p20_steps(path, feeds, fetch, watch=watch)
    check_replayed('(b)', res, path['expected'], 'embedding_update')
    eager = p20_steps(path, feeds, fetch, res['start'], eager=True,
                      watch=watch)
    same_steps('(b)', res, eager, watch)
    first, last = res['steps'][0], res['steps'][-1]
    moved = [n for n in path['norm'] if torch.equal(
        first['before'][n], last['after'][n])]
    if len(path['norm']) != 3 or moved:
        raise AssertionError('(b) data_norm parameters %s, unmoved %s' % (
            path['norm'], moved))
    stat_pos, stat_neg = path['stats']
    cpu = registry.get('auc').run(registry.LowerCtx(step=0, device='cpu'), {
        'Predict': [last['out'][2].cpu()],
        'Label': [torch.as_tensor(path['batch']['label'])],
        'StatPos': [last['before'][stat_pos].cpu()],
        'StatNeg': [last['before'][stat_neg].cpu()]},
        {'num_thresholds': CTR['thresholds']})
    err = abs(float(cpu['AUC'][0]) - float(last['out'][1]))
    losses = [float(s['out'][0]) for s in res['steps']]
    if err > WD_AUC_TOL or not np.isfinite(losses).all() or \
            losses[-1] >= losses[0]:
        raise AssertionError('(b) losses %s; AUC %.9f against the CPU '
                             'lowering\'s %.9f' % (
                                 losses, float(last['out'][1]),
                                 float(cpu['AUC'][0])))
    log('  (b) CTR-DNN (%d-row table, %d slots x %d hashes, width %d, '
        'batch %d, sparse Adagrad): losses %.6f -> %.6f, AUC %s; the auc '
        'statistics and data_norm\'s parameters bitwise the eager-only run '
        'after every step; step %d\'s AUC %.9f, the CPU lowering %.9f '
        '(|diff| %.1e); launched and replayed each step: %s' % (
            CTR['rows'], CTR['slots'], CTR['num_hash'], CTR['emb'],
            CTR_BATCH, losses[0], losses[-1],
            ['%.5f' % float(s['out'][1]) for s in res['steps']], CTR_STEPS,
            float(last['out'][1]), float(cpu['AUC'][0]), err,
            {k: n for k, n in path['expected'].items() if n}))
    log('  (b) replayed %.4f ms a step, cached eager %.4f ms (%s | %s)' % (
        step_ms(res, 2), step_ms(eager, 1), torch.cuda.get_device_name(0),
        card))


def vision_op_cases(rng):
    """Every op type of item 11b-A at a size its users run: (op,
    make_inputs, attrs).  tests/test_torch_coverage.py checks that each
    has a case here."""
    f = lambda *s: rng.randn(*s).astype('float32')  # noqa: E731

    def deform(modulated):
        ins = {'Input': [f(8, 512, 7, 7)], 'Filter': [f(512, 512, 3, 3) *
                                                      0.02],
               'Offset': [rng.uniform(-2.0, 2.0, (8, 18, 7, 7)).astype(
                   'float32')]}
        if modulated:
            ins['Mask'] = [rng.rand(8, 9, 7, 7).astype('float32')]
        return ins

    return [
        # C3D's conv5a at batch 4; a 3-D U-Net encoder step (SAME, 2)
        ('conv3d', lambda: {'Input': [f(4, 512, 2, 7, 7)],
                            'Filter': [f(512, 512, 3, 3, 3) * 0.02]},
         {'strides': [1, 1, 1], 'paddings': [1, 1, 1]}),
        ('conv3d', lambda: {'Input': [f(2, 32, 16, 32, 32)],
                            'Filter': [f(64, 32, 3, 3, 3) * 0.05]},
         {'strides': [2, 2, 2], 'padding_algorithm': 'SAME'}),
        # a 3-D U-Net decoder's up-convolution
        ('conv3d_transpose', lambda: {'Input': [f(2, 64, 8, 16, 16)],
                                      'Filter': [f(64, 32, 2, 2, 2) * 0.1]},
         {'strides': [2, 2, 2], 'paddings': [0, 0, 0]}),
        # C3D's pool1 (batch 2) and its padded pool5 (batch 30); an
        # average
        ('pool3d', lambda: {'X': [f(2, 64, 16, 112, 112)]},
         {'pooling_type': 'max', 'ksize': [1, 2, 2], 'strides': [1, 2, 2]}),
        ('pool3d', lambda: {'X': [f(30, 512, 2, 7, 7)]},
         {'pooling_type': 'max', 'ksize': [2, 2, 2], 'strides': [2, 2, 2],
          'paddings': [0, 1, 1]}),
        ('pool3d', lambda: {'X': [f(4, 256, 8, 28, 28)]},
         {'pooling_type': 'avg', 'ksize': [2, 2, 2], 'strides': [2, 2, 2]}),
        # a V-Net decoder's 2x up-sampling, both corner rules
        ('trilinear_interp', lambda: {'X': [f(2, 32, 8, 32, 32)]},
         {'out_d': 16, 'out_h': 64, 'out_w': 64, 'align_corners': True}),
        ('trilinear_interp', lambda: {'X': [f(2, 32, 8, 32, 32)]},
         {'out_d': 16, 'out_h': 64, 'out_w': 64, 'align_corners': False}),
        # ESPCN's x3 sub-pixel layer, ShuffleNet's shuffle, YOLOv2's
        # passthrough
        ('pixel_shuffle', lambda: {'X': [f(16, 576, 32, 32)]},
         {'upscale_factor': 3}),
        ('shuffle_channel', lambda: {'X': [f(32, 240, 28, 28)]},
         {'group': 3}),
        ('space_to_depth', lambda: {'X': [f(16, 64, 26, 26)]},
         {'blocksize': 2}),
        # Detectron's frozen batch norm, a spatial transformer's grid
        ('affine_channel', lambda: {'X': [f(8, 256, 56, 56)],
                                    'Scale': [f(256)], 'Bias': [f(256)]},
         {'data_layout': 'NCHW'}),
        ('affine_grid', lambda: {'Theta': [f(32, 2, 3)]},
         {'output_shape': [32, 3, 64, 64]}),
        ('unfold', lambda: {'X': [f(8, 64, 56, 56)]},
         {'kernel_sizes': [3, 3], 'paddings': [1, 1]}),
        # FCN's score crop
        ('crop_tensor', lambda: {'X': [f(8, 21, 128, 128)]},
         {'shape': [-1, 21, 112, 112], 'offsets': [0, 0, 8, 8]}),
        ('crop', lambda: {'X': [f(8, 21, 128, 128)]},
         {'shape': [8, 21, 100, 120], 'offsets': [0, 0, 19, 0]}),
        # SPP-net's pyramid over conv5
        ('spp', lambda: {'X': [f(16, 256, 13, 13)]},
         {'pyramid_height': 3, 'pooling_type': 'max'}),
        ('spp', lambda: {'X': [f(16, 256, 13, 13)]},
         {'pyramid_height': 3, 'pooling_type': 'avg'}),
        # DCNv2 on ResNet-50's res5 3x3 convolution
        ('deformable_conv', lambda: deform(True),
         {'strides': [1, 1], 'paddings': [1, 1], 'dilations': [1, 1],
          'groups': 1, 'deformable_groups': 1, 'im2col_step': 1}),
        ('deformable_conv_v1', lambda: deform(False),
         {'strides': [1, 1], 'paddings': [1, 1], 'dilations': [1, 1],
          'groups': 1, 'deformable_groups': 1, 'im2col_step': 1}),
    ]


def loss_op_cases(rng):
    """Every op type of item 11b-B at a size its users run, as
    vision_op_cases; unique and unique_with_counts are host ops, run
    through a program (host_op_run)."""
    f = lambda *s: rng.randn(*s).astype('float32')  # noqa: E731
    col = lambda: f(4096, 1)  # noqa: E731  a CTR batch's scores
    ints = lambda hi, *s: rng.randint(0, hi, s).astype('int64')  # noqa

    def cvm_ins(with_cvm):
        x = np.abs(f(4096 * 26, 12)) * 3
        ins = {'X': [x]}
        if with_cvm:
            ins['CVM'] = [x[:, :2].copy()]
        return ins

    def data_norm_ins():
        return {'X': [np.abs(f(4096, 13)) * 4],
                'BatchSize': [np.full(13, 1e4, 'float32')],
                'BatchSum': [f(13) * 100],
                'BatchSquareSum': [np.full(13, 1e4, 'float32') +
                                   np.abs(f(13)) * 1e3]}

    probs = lambda: np.exp(f(1024, 1000)).astype('float32')  # noqa: E731
    return [
        ('rank_loss', lambda: {'Label': [rng.rand(4096, 1).astype('float32')],
                               'Left': [col()], 'Right': [col()]}, {}),
        ('margin_rank_loss',
         lambda: {'Label': [np.sign(col())], 'X1': [col()], 'X2': [col()]},
         {'margin': 0.1}),
        ('hinge_loss', lambda: {'Logits': [col()],
                                'Labels': [(col() > 0).astype('float32')]},
         {}),
        ('bpr_loss', lambda: {'X': [f(1024, 100)],
                              'Label': [ints(100, 1024, 1)]}, {}),
        ('modified_huber_loss', lambda: {'X': [col() * 2],
                                         'Y': [(col() > 0).astype(
                                             'float32')]}, {}),
        ('teacher_student_sigmoid_loss',
         lambda: {'X': [col()], 'Label': [rng.uniform(
             -2.0, 2.0, (4096, 1)).astype('float32')]}, {}),
        # face recognition's center loss over 1000 identities
        ('center_loss', lambda: {'X': [f(512, 512)],
                                 'Label': [ints(1000, 512, 1)],
                                 'Centers': [f(1000, 512)]},
         {'alpha': 0.5, 'need_update': True}),
        ('cvm', lambda: cvm_ins(False), {'use_cvm': True}),
        ('continuous_value_model', lambda: cvm_ins(True), {'use_cvm': True}),
        # FSP distillation between two ResNet stages
        ('fsp', lambda: {'X': [f(32, 64, 28, 28)], 'Y': [f(32, 128, 28, 28)]},
         {}),
        ('l1_norm', lambda: {'X': [f(1000, 1000)]}, {}),
        # VOC segmentation at 512 x 512
        ('mean_iou', lambda: {'Predictions': [ints(21, 8, 512 * 512)],
                              'Labels': [ints(21, 8, 512 * 512)]},
         {'num_classes': 21}),
        ('shard_index', lambda: {'X': [ints(1000001, 4096, 1)]},
         {'index_num': 1000001, 'nshards': 8, 'shard_id': 3,
          'ignore_value': -1}),
        ('multiplex', lambda: {'Ids': [ints(4, 4096, 1).astype('int32')],
                               'X': [f(4096, 64) for _ in range(4)]}, {}),
        ('bilinear_tensor_product',
         lambda: {'X': [f(1024, 128)], 'Y': [f(1024, 128)],
                  'Weight': [f(64, 128, 128) * 0.05],
                  'Bias': [f(1, 64)]}, {}),
        ('sampling_id', lambda: {'X': [probs()]}, {'seed': 0}),
        ('scatter_nd_add', lambda: {'X': [f(10000, 64)],
                                    'Index': [ints(10000, 4096, 1)],
                                    'Updates': [f(4096, 64)]}, {}),
        ('pad_constant_like', lambda: {'X': [f(32, 3, 224, 224)],
                                       'Y': [f(32, 3, 200, 200)]},
         {'pad_value': 0.0}),
        # SN-GAN's discriminator convolution
        ('spectral_norm', lambda: {'Weight': [f(512, 256, 4, 4)],
                                   'U': [f(512)], 'V': [f(4096)]},
         {'dim': 0, 'power_iters': 1, 'eps': 1e-12}),
        ('data_norm', data_norm_ins, {'epsilon': 1e-5}),
        ('random_crop', lambda: {'X': [f(64, 3, 256, 256)]},
         {'shape': [224, 224]}),
        ('unique_with_counts', lambda: {'X': [ints(100000, 4096 * 26)]}, {}),
        ('add_position_encoding', lambda: {'X': [f(64, 128, 512)]},
         {'alpha': 1.0, 'beta': 1.0}),
        ('hash', lambda: {'X': [rng.randint(0, 2 ** 31 - 1, (4096, 26))
                                .astype('int64')]},
         {'num_hash': 2, 'mod_by': 1000001}),
        ('scatter_nd', lambda: {'Index': [ints(512, 4096, 2)],
                                'Updates': [f(4096)]}, {'shape': [512, 512]}),
        ('similarity_focus', lambda: {'X': [f(32, 64, 28, 28)]},
         {'axis': 1, 'indexes': [0, 5]}),
        ('unique', lambda: {'X': [ints(100000, 4096 * 26)]}, {}),
    ]


def host_outputs(op, attrs):
    """{slot: count} of a host op's outputs."""
    if op == 'distribute_fpn_proposals':
        return {'MultiFpnRois': attrs['max_level'] - attrs['min_level'] + 1,
                'RestoreIndex': 1}
    slots = {
        'unique': ('Out', 'Index'),
        'unique_with_counts': ('Out', 'Index', 'Count'),
        'rpn_target_assign': ('LocationIndex', 'ScoreIndex', 'TargetLabel',
                              'TargetBBox', 'BBoxInsideWeight'),
        'generate_proposal_labels': ('Rois', 'LabelsInt32', 'BboxTargets',
                                     'BboxInsideWeights',
                                     'BboxOutsideWeights'),
        'generate_mask_labels': ('MaskRois', 'RoiHasMaskInt32', 'MaskInt32'),
        'collect_fpn_proposals': ('FpnRois',),
        'locality_aware_nms': ('Out',),
        'roi_perspective_transform': ('Out',),
        'bipartite_match': ('ColToRowMatchIndices', 'ColToRowMatchDist'),
    }
    slots['retinanet_target_assign'] = slots['rpn_target_assign']
    return {s: 1 for s in slots[op]}


def host_op_run(op, ins, place, attrs=None):
    """A host op through a one-op program on `place`, fed `ins` (a data
    variable for each array): its outputs by slot as CPU tensors."""
    attrs = dict(attrs or {})
    main = fluid.Program()
    feed, inputs = {}, {}
    with fluid.unique_name.guard(), fluid.program_guard(main,
                                                        fluid.Program()):
        block = main.global_block()
        for slot, vals in sorted(ins.items()):
            inputs[slot] = []
            for i, a in enumerate(vals):
                a = np.asarray(a)
                name = '%s_%d' % (slot.lower(), i)
                inputs[slot].append(fluid.layers.data(
                    name, list(a.shape), dtype=str(a.dtype),
                    append_batch_size=False))
                feed[name] = a
        outputs = {slot: [block.create_var(
            name='%s_out_%d' % (slot.lower(), i), dtype='float32')
            for i in range(n)] for slot, n in host_outputs(op, attrs).items()}
        block.append_op(type=op, inputs=inputs, outputs=outputs, attrs=attrs)
    fetch = [v for slot in sorted(outputs) for v in outputs[slot]]
    with fluid.scope_guard(fluid.Scope()):
        exe = fluid.Executor(place)
        got = exe.run(main, feed=feed, fetch_list=fetch, return_numpy=False)
    out, k = {}, 0
    for slot in sorted(outputs):
        n = len(outputs[slot])
        out[slot] = [torch.as_tensor(v).cpu() for v in got[k:k + n]]
        k += n
    return out, []


def ab_ops_phase(seed, dev):
    """Phase 21 (c): every op type of item 11b's groups A and B on the
    card against the CPU, as ops_against_cpu holds them (floats within
    AB_TOL), under the phase's deterministic cuDNN; no gradient adds
    with float atomics, so none is exempt from the second launch."""
    cases = vision_op_cases(np.random.RandomState(seed + 21)) + \
        loss_op_cases(np.random.RandomState(seed + 22))
    worst, n_out = ops_against_cpu(cases, dev, seed, AB_TOL)
    log('  (c) %d op types (%d cases, %d outputs and gradients) on the card '
        'against the CPU (integers exact, floats within %g of the largest '
        'magnitude; worst %.1e), every one twice bitwise' % (
            len({op for op, _, _ in cases}), len(cases), n_out, AB_TOL,
            worst))


def two_loss_build(fluid):
    """The JAX package's multi-loss oracle
    (tests/test_wpg_default.py::test_multi_loss_takes_wpg_and_matches_per_op)
    at a size: a two-layer regressor with a square loss and an absolute
    auxiliary loss, one append_backward each, SGD applying the last
    walk's gradients."""
    L = fluid.layers
    x = L.data('x', shape=[256], dtype='float32')
    y = L.data('y', shape=[1], dtype='float32')
    pred = L.fc(L.fc(x, 512, act='relu'), 1)
    loss = L.mean(L.square(pred - y))
    aux = L.mean(L.abs(pred))
    pgs = fluid.backward.append_backward(loss) + \
        fluid.backward.append_backward(aux)
    merged = {}
    for p, g in pgs:
        merged.setdefault(p.name, (p, []))[1].append(g)
    fluid.optimizer.SGD(0.05).apply_gradients(
        [(p, gs[-1]) for p, gs in merged.values()])
    return loss, aux


@contextlib.contextmanager
def per_op_grads():
    """The executor's per-op grad path: no program takes the
    whole-program grad while this is open."""
    from paddle_tpu_torch.fluid import executor as texec
    saved = texec._wpg_partition
    texec._wpg_partition = lambda *a, **k: None
    try:
        yield
    finally:
        texec._wpg_partition = saved


def two_loss_phase(seed, card):
    """Phase 21 (d), first half: the two-loss program on the card, on
    the whole-program grad (its plan with 2 seeds) against the per-op
    grad path, TWO_LOSS_STEPS steps from one startup state: losses and
    parameters within rtol TWO_LOSS_RTOL / atol TWO_LOSS_ATOL."""
    from paddle_tpu_torch.fluid import executor as texec

    def program():
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = startup.random_seed = seed + 1
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            return (main, startup) + two_loss_build(fluid)
    main, _, loss, aux = program()
    part = texec._wpg_partition(main.global_block().ops, main,
                                [loss.name, aux.name])
    if part is None or len(part['seeds']) != 2:
        raise AssertionError('(d) the two-loss program does not take the '
                             'whole-program grad with 2 seeds')
    rng = np.random.RandomState(seed + 4)
    feeds = []
    for _ in range(TWO_LOSS_STEPS):
        xb = rng.randn(512, 256).astype('float32')
        feeds.append({'x': xb, 'y': xb[:, :8].sum(1, keepdims=True)})

    def run(per_op):
        """Losses and parameters of the steps on a program of its own (a
        plan is cached on its program)."""
        main, startup, loss, aux = program()
        exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
        with fluid.scope_guard(scope), (per_op_grads() if per_op else
                                        contextlib.nullcontext()):
            exe.run(startup)
            losses = [[float(v) for v in exe.run(
                main, feed=f, fetch_list=[loss, aux])] for f in feeds]
            return np.array(losses), {
                p.name: scope.find_var(p.name).cpu().numpy()
                for p in main.all_parameters()}
    got, got_p = without_counting(lambda: run(False))
    want, want_p = without_counting(lambda: run(True))
    np.testing.assert_allclose(got, want, rtol=TWO_LOSS_RTOL,
                               atol=TWO_LOSS_ATOL)
    worst = 0.0
    for n in sorted(want_p):
        np.testing.assert_allclose(got_p[n], want_p[n], rtol=TWO_LOSS_RTOL,
                                   atol=TWO_LOSS_ATOL, err_msg=n)
        worst = max(worst, float(np.abs(got_p[n] - want_p[n]).max()))
    log('  (d) two losses, one append_backward each: the whole-program grad '
        '(2 seeds) against the per-op grad path over %d SGD steps: losses '
        '%s against %s, parameters within %.1e (%s | %s)' % (
            TWO_LOSS_STEPS, ['%.5f' % v for v in got[:, 0]],
            ['%.5f' % v for v in want[:, 0]], worst,
            torch.cuda.get_device_name(0), card))


def sdpa_path(seed):
    """nets.scaled_dot_product_attention over Transformer-base's widths
    (8 heads of 64) on projections of a [64, 64, 512] input, attention
    dropout 0.1, a square error against the input, SGD.  Its result is
    the JAX package's [B, H, T D] view of the [B, T, H, D] context
    (ROADMAP Queue 3), so the step reshapes it back to [B, T, H D]."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed + 1
    L = fluid.layers
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = L.data('x', [64, 512], dtype='float32')
        q, k, v = (L.fc(x, 512, num_flatten_dims=2) for _ in range(3))
        ctx = L.reshape(fluid.nets.scaled_dot_product_attention(
            q, k, v, num_heads=8, dropout_rate=0.1), [0, 64, 512])
        loss = L.mean(L.square_error_cost(L.fc(ctx, 512,
                                               num_flatten_dims=2), x))
        fluid.optimizer.SGD(0.01).minimize(loss)
    expected = {k: 0 for k in common.KERNELS}
    expected.update(dropout_launches(main))
    return {'main': main, 'startup': startup, 'loss': loss,
            'expected': expected}


def sdpa_phase(seed, card):
    """Phase 21 (d), second half: SDPA_STEPS steps of sdpa_path replayed
    from a CUDA graph after the first two, each bitwise the eager-only
    step of the same number, the loss falling."""
    path = sdpa_path(seed)
    feeds = [{'x': torch.as_tensor(np.random.RandomState(seed + k).randn(
        64, 64, 512).astype('float32'), device='cuda')}
        for k in range(SDPA_STEPS)]
    res = p20_steps(path, feeds, [path['loss']])
    check_replayed('(d)', res, path['expected'], 'dropout')
    eager = p20_steps(path, res['feeds'], [path['loss']], res['start'],
                      eager=True)
    same_steps('(d)', res, eager)
    losses = [float(s['out'][0]) for s in res['steps']]
    if not np.isfinite(losses).all():
        raise AssertionError('(d) attention losses %s' % losses)
    log('  (d) nets.scaled_dot_product_attention (8 heads, dropout 0.1) at '
        '[64, 64, 512]: %d SGD steps, losses %s, replayed bitwise the '
        'eager-only steps; replayed %.3f ms, eager %.3f ms (%s | %s)' % (
            SDPA_STEPS, ['%.5f' % x for x in losses], step_ms(res, 2),
            step_ms(eager, 1), torch.cuda.get_device_name(0), card))


def vision_loss_phase(seed, dev):
    """Phase 21: item 11b's groups A and B."""
    card = card_line()
    log('[21] dense vision, losses and misc: C3D, the CTR-DNN, the op '
        'types of 11b-A and 11b-B (%s | %s)' % (
            torch.cuda.get_device_name(0), card))
    saved = torch.backends.cudnn.deterministic, \
        torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        for key, fn in (('a', lambda: c3d_phase(seed, card)),
                        ('b', lambda: ctr_phase(seed, card)),
                        ('c', lambda: without_counting(
                            lambda: ab_ops_phase(seed, dev))),
                        ('d', lambda: (two_loss_phase(seed, card),
                                       sdpa_phase(seed, card)))):
            t0 = time.perf_counter()
            fn()
            gc.collect()
            torch.cuda.empty_cache()
            log('  (%s): %.1f s' % (key, time.perf_counter() - t0))
    finally:
        torch.backends.cudnn.deterministic, \
            torch.backends.cudnn.benchmark = saved


# ---------------------------------------------------------------- phase 22

# MobileNet-SSD (PaddlePaddle/models PaddleCV/ssd/mobilenet_ssd.py):
# MobileNet-v1 at scale 1.0 on 300 x 300 images, its head on the maps of
# 19^2, 10^2, 5^2, 3^2, 2^2 and 1^2 cells, 21 VOC classes
MOBILENET_SSD = {
    'image': 300, 'classes': 21, 'gts': 1, 'first': 32,
    # depthwise-separable blocks: (depthwise channels, pointwise
    # channels, stride); the first head map follows `blocks`, the
    # second `blocks2`
    'blocks': ((32, 64, 1), (64, 128, 2), (128, 128, 1), (128, 256, 2),
               (256, 256, 1), (256, 512, 2)) + ((512, 512, 1),) * 5,
    'blocks2': ((512, 1024, 2), (1024, 1024, 1)),
    'extras': ((256, 512), (128, 256), (128, 256), (64, 128)),
    'min_sizes': [60.0, 105.0, 150.0, 195.0, 240.0, 285.0],
    'max_sizes': [[], 150.0, 195.0, 240.0, 285.0, 300.0],
    'aspect_ratios': [[2.0], [2.0, 3.0], [2.0, 3.0], [2.0, 3.0], [2.0, 3.0],
                      [2.0, 3.0]],
    'steps': [8, 16, 32, 64, 100, 300], 'priors': 1917}
SSD_BATCH = 64
SSD_LR = 0.001        # RMSProp, L2Decay 5e-5, as PaddleCV's ssd/train.py
SSD_DECAY = 5e-5
SSD_STEPS = 6
SSD_NMS = 0.45

# The Faster R-CNN RPN and RoI head at Detectron's shapes (the defaults
# of PaddlePaddle/models PaddleCV/rcnn, C4 model, 800 x 1333 input): the
# res4 map is fed; one trainable 1 x 1 convolution stands in for the
# backbone's last layer; the res5 stage of the head is left out
RCNN = {
    'channels': 1024, 'map': (50, 84), 'image': (800, 1333), 'gts': 7,
    'classes': 81, 'anchor_sizes': [32.0, 64.0, 128.0, 256.0, 512.0],
    'ratios': [0.5, 1.0, 2.0], 'stride': 16.0, 'pre_nms': 12000,
    'post_nms': 2000, 'nms': 0.7, 'rpn_batch': 256, 'rpn_fg': 0.5,
    'rois': 512, 'roi_fg': 0.25, 'pool': 14, 'rpn_channels': 1024}
RCNN_LR = 0.01        # momentum 0.9, L2Decay 1e-4
RCNN_DECAY = 1e-4
RCNN_STEPS = 3
ROI_POOL = 7          # (b): roi_pool, psroi_pool, prroi_pool and
#                       deformable_roi_pooling at 7 x 7 on the head's rois
DET_TOL = 1e-5        # (c): floats within 1e-5 of the largest magnitude


def ssd_build(fluid, cfg):
    """MobileNet-SSD from `fluid`'s layers: conv_bn (convolution without
    bias, learning rate 0.1, batch norm and relu) blocks, the head's
    multi_box_head over six maps, the summed ssd_loss.  Returns (feeds,
    mbox_locs, mbox_confs, priors, prior variances, loss)."""
    L = fluid.layers
    size = cfg['image']
    image = L.data('image', [3, size, size], dtype='float32')
    gt_box = L.data('gt_box', [cfg['gts'], 4], dtype='float32')
    gt_label = L.data('gt_label', [cfg['gts']], dtype='int32')

    def conv_bn(x, k, ch, stride, pad, groups=1):
        conv = L.conv2d(x, ch, k, stride=stride, padding=pad, groups=groups,
                        bias_attr=False,
                        param_attr=fluid.ParamAttr(learning_rate=0.1))
        return L.batch_norm(conv, act='relu')

    def separable(x, dw, pw, stride):
        return conv_bn(conv_bn(x, 3, dw, stride, 1, groups=dw), 1, pw, 1, 0)

    h = conv_bn(image, 3, cfg['first'], 2, 1)
    for dw, pw, stride in cfg['blocks']:
        h = separable(h, dw, pw, stride)
    maps = [h]
    for dw, pw, stride in cfg['blocks2']:
        h = separable(h, dw, pw, stride)
    maps.append(h)
    for a, b in cfg['extras']:
        h = conv_bn(conv_bn(h, 1, a, 1, 0), 3, b, 2, 1)
        maps.append(h)
    locs, confs, box, var = L.multi_box_head(
        inputs=maps, image=image, base_size=size, num_classes=cfg['classes'],
        aspect_ratios=cfg['aspect_ratios'], min_ratio=20, max_ratio=90,
        min_sizes=cfg['min_sizes'], max_sizes=cfg['max_sizes'],
        steps=cfg['steps'], offset=0.5, flip=True)
    loss = L.reduce_sum(L.ssd_loss(locs, confs, gt_box, gt_label, box, var))
    feeds = {'image': image, 'gt_box': gt_box, 'gt_label': gt_label}
    return feeds, locs, confs, box, var, loss


def ssd_detect(fluid, locs, confs, box, var, nms=SSD_NMS):
    """SSD's inference head: detection_output over the softmax of the
    confidences (the layer applies none, as the JAX package's)."""
    return fluid.layers.detection_output(
        locs, fluid.layers.softmax(confs), box, var, nms_threshold=nms)


def voc_ssd_batches(cfg, batch, n):
    """n batches of dataset.voc2012.train()'s synthetic stand-in, each
    image scaled from 128 to cfg['image'] (nearest pixels) and its blob
    the one gt box (normalized xyxy; unchanged by the scale) of its
    class, the reader cycled."""
    from paddle_tpu_torch.dataset import voc2012
    samples = list(voc2012.train()())
    size = cfg['image']
    pick = (np.arange(size) * 128) // size
    out = []
    for k in range(n):
        imgs, boxes, labels = [], [], []
        for j in range(batch):
            img, mask = samples[(k * batch + j) % len(samples)]
            ys, xs = np.nonzero(mask)
            imgs.append(img[:, pick][:, :, pick] / 255.0)
            boxes.append([[xs.min() / 128.0, ys.min() / 128.0,
                           (xs.max() + 1) / 128.0, (ys.max() + 1) / 128.0]])
            labels.append([int(mask[ys[0], xs[0]])])
        out.append({'image': np.stack(imgs).astype('float32'),
                    'gt_box': np.asarray(boxes, 'float32'),
                    'gt_label': np.asarray(labels, 'int32')})
    return out


def rcnn_build(fluid, cfg):
    """The Faster R-CNN RPN and RoI head from `fluid`'s layers: a fed
    res4 map through a 1 x 1 convolution (the backbone's stand-in), the
    RPN (3 x 3 conv and relu, 1 x 1 heads of A and 4 A), its anchors,
    rpn_target_assign and the sigmoid cross entropy and smooth L1 of the
    sampled rows, generate_proposals, generate_proposal_labels, roi_align
    (sampling ratio 0), a global average pool and fc heads of `classes`
    and 4 `classes`, softmax cross entropy and the smooth L1 of the
    foreground rows' class slots.  The box targets (the matched gt boxes,
    as the JAX package's ops give them) are encoded with box_coder on
    the anchors and on the rois with a pixel added to their far sides;
    box_coder declares no shape (as in the JAX package), so this
    declares its rows [-1, 4].  Returns (feeds, losses, the proposals,
    the sampled rois)."""
    L = fluid.layers
    c, (h, w) = cfg['channels'], cfg['map']
    g, classes = cfg['gts'], cfg['classes']
    a = len(cfg['anchor_sizes']) * len(cfg['ratios'])
    feat = L.data('res4', [1, c, h, w], dtype='float32',
                  append_batch_size=False)
    gt_box = L.data('gt_box', [1, g, 4], dtype='float32',
                    append_batch_size=False)
    gt_class = L.data('gt_class', [1, g, 1], dtype='int32',
                      append_batch_size=False)
    im_info = L.data('im_info', [1, 3], dtype='float32',
                     append_batch_size=False)
    x = L.conv2d(feat, c, 1)
    rpn = L.conv2d(x, cfg['rpn_channels'], 3, padding=1, act='relu')
    cls = L.conv2d(rpn, a, 1)
    bbox = L.conv2d(rpn, 4 * a, 1)
    anchors, var = L.anchor_generator(
        x, cfg['anchor_sizes'], cfg['ratios'], [cfg['stride']] * 2,
        variance=[1.0, 1.0, 1.0, 1.0])
    loc_idx, score_idx, tgt_label, tgt_box, _ = L.rpn_target_assign(
        bbox, cls, anchors, var, gt_box,
        rpn_batch_size_per_im=cfg['rpn_batch'],
        rpn_fg_fraction=cfg['rpn_fg'], rpn_positive_overlap=0.7,
        rpn_negative_overlap=0.3)
    cls_rows = L.reshape(L.transpose(cls, [0, 2, 3, 1]), [-1, 1])
    box_rows = L.reshape(L.transpose(bbox, [0, 2, 3, 1]), [-1, 4])
    score_pred = L.gather(cls_rows, score_idx)
    loc_pred = L.gather(box_rows, loc_idx)
    loc_tgt = L.box_coder(L.gather(L.reshape(anchors, [-1, 4]), loc_idx),
                          None, tgt_box, code_type='encode_center_size')
    loc_tgt.shape = (-1, 4)
    rpn_cls = L.mean(L.sigmoid_cross_entropy_with_logits(
        score_pred, L.cast(tgt_label, 'float32')))
    rpn_reg = L.mean(L.smooth_l1(loc_pred, loc_tgt, sigma=3.0))
    rois, _ = L.generate_proposals(
        L.sigmoid(cls), bbox, im_info, anchors, var,
        pre_nms_top_n=cfg['pre_nms'], post_nms_top_n=cfg['post_nms'],
        nms_thresh=cfg['nms'], min_size=0.0)
    s_rois, labels, tgts, _, _ = L.generate_proposal_labels(
        rois, gt_class, None, gt_box, im_info,
        batch_size_per_im=cfg['rois'], fg_fraction=cfg['roi_fg'],
        fg_thresh=0.5, bg_thresh_hi=0.5, bg_thresh_lo=0.0,
        class_nums=classes)
    pooled = L.roi_align(x, s_rois, cfg['pool'], cfg['pool'],
                         1.0 / cfg['stride'], sampling_ratio=0)
    pooled = L.pool2d(pooled, pool_type='avg', global_pooling=True)
    cls_score = L.fc(pooled, classes)
    bbox_pred = L.fc(pooled, 4 * classes)
    head_cls = L.mean(L.softmax_with_cross_entropy(cls_score,
                                                   L.cast(labels, 'int64')))
    px = L.assign(np.array([0.0, 0.0, 1.0, 1.0], 'float32'))
    deltas = L.box_coder(L.elementwise_add(s_rois, px), None,
                         L.elementwise_add(tgts, px),
                         code_type='encode_center_size')
    deltas.shape = (-1, 4)
    # each roi's deltas in its class's 4 slots; background's left out
    tgt = L.reshape(L.expand(L.reshape(deltas, [-1, 1, 4]),
                             [1, classes, 1]), [-1, 4 * classes])
    slot = L.reshape(L.expand(L.reshape(L.one_hot(labels, classes),
                                        [-1, classes, 1]), [1, 1, 4]),
                     [-1, 4 * classes])
    fg = lambda v: L.slice(L.elementwise_mul(v, slot), axes=[1],  # noqa
                           starts=[4], ends=[4 * classes])
    head_reg = L.mean(L.smooth_l1(fg(bbox_pred), fg(tgt)))
    loss = L.sums([rpn_cls, rpn_reg, head_cls, head_reg])
    feeds = {'res4': feat, 'gt_box': gt_box, 'gt_class': gt_class,
             'im_info': im_info}
    return feeds, [loss, rpn_cls, rpn_reg, head_cls, head_reg], rois, s_rois


def rcnn_inputs(cfg, rng):
    """A res4 map (relu'd normal values) and `gts` gt boxes inside the
    image with sides from 32 pixels to a quarter of its shorter side
    plus 32, their classes in [1, classes)."""
    c, (h, w) = cfg['channels'], cfg['map']
    ih, iw = cfg['image']
    hi = min(ih, iw) // 4 + 33
    bw, bh = rng.uniform(32, hi, cfg['gts']), rng.uniform(32, hi, cfg['gts'])
    x1 = rng.uniform(0, 1, cfg['gts']) * (iw - bw)
    y1 = rng.uniform(0, 1, cfg['gts']) * (ih - bh)
    boxes = np.stack([x1, y1, x1 + bw, y1 + bh], 1)[None].astype('float32')
    return {'res4': np.maximum(rng.randn(1, c, h, w), 0).astype('float32'),
            'gt_box': boxes,
            'gt_class': rng.randint(1, cfg['classes'],
                                    (1, cfg['gts'], 1)).astype('int32'),
            'im_info': np.array([[ih, iw, 1.0]], 'float32')}


def ssd_path(seed):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed + 1
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        feeds, locs, confs, box, var, loss = ssd_build(fluid, MOBILENET_SSD)
        test = main.clone(for_test=True)
        fluid.optimizer.RMSProp(SSD_LR, regularization=fluid.regularizer
                                .L2Decay(SSD_DECAY)).minimize(loss)
    with fluid.program_guard(test, fluid.Program()):
        with fluid.unique_name.guard('infer'):
            det = ssd_detect(fluid, locs, confs, box, var)
    if box.shape[0] != MOBILENET_SSD['priors']:
        raise AssertionError('(a) %d priors, MobileNet-SSD has %d' % (
            box.shape[0], MOBILENET_SSD['priors']))
    n_params = sum(int(np.prod(p.shape)) for p in main.all_parameters())
    # ssd_loss gathers the matched gt rows (K6); the fed boxes take no
    # gradient, so no K6b
    expected = {k: 0 for k in common.KERNELS}
    expected['embedding_lookup'] = 1
    return {'main': main, 'startup': startup, 'loss': loss, 'test': test,
            'det': det, 'locs': locs, 'confs': confs, 'box': box, 'var': var,
            'params': n_params, 'expected': expected,
            'feeds': voc_ssd_batches(MOBILENET_SSD, SSD_BATCH, SSD_STEPS)}


def top_share(events, k=3):
    """The k kernels of a profile with the most device time: [(name,
    ms, share of the device time)]."""
    from torch.autograd import DeviceType
    cuda = [e for e in events if e.device_type == DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in cuda) or 1.0
    top = sorted(cuda, key=lambda e: -e.self_device_time_total)[:k]
    return [(e.key[:60], e.self_device_time_total / 1e3,
             e.self_device_time_total / total) for e in top]


def ssd_detect_phase(path, scope, exe, card):
    """(a)'s inference: the for_test clone with detection_output on the
    last batch, run eagerly (eager_run) and through Executor.run (the
    second run captured, the third replayed), the replay bitwise the
    eager rows; a program of detection_output alone on the same
    locations and confidences timed replayed and eager, its kernel
    launches a call from a profiled eager call (medians of 5 calls
    between CUDA events, host gaps included); the detections' mAP
    (DetectionMAP over the 20 object classes at IoU 0.5)."""
    test, det = path['test'], path['det']
    feed = path['staged'][-1]
    with fluid.scope_guard(scope):
        ref = eager_run(exe, test, feed, [det], return_numpy=False)[0].clone()
        for _ in range(3):
            got = exe.run(test, feed=feed, fetch_list=[det],
                          return_numpy=False)[0]
        if not torch.equal(got, ref):
            raise AssertionError('(a) detection_output replayed differs from '
                                 'its eager run')
        refused = graph_refusals(test, scope)
        if refused:
            raise AssertionError('(a) inference capture refused: %s' % refused)
        outs = eager_run(exe, test, feed, [path[k].name for k in (
            'locs', 'confs', 'box', 'var')], return_numpy=False)
    # detection_output alone, fed the network's outputs
    locs, confs, box, var = [v.clone() for v in outs]
    prog = fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(prog, fluid.Program()):
        L = fluid.layers
        lv = L.data('locs', list(locs.shape), append_batch_size=False)
        cv = L.data('confs', list(confs.shape), append_batch_size=False)
        bv = L.data('box', [MOBILENET_SSD['priors'], 4],
                    append_batch_size=False)
        vv = L.data('var', [MOBILENET_SSD['priors'], 4],
                    append_batch_size=False)
        only = ssd_detect(fluid, lv, cv, bv, vv)
    dfeed = {'locs': locs, 'confs': confs, 'box': box, 'var': var}
    dscope, dexe = fluid.Scope(), fluid.Executor(fluid.CUDAPlace(0))
    with fluid.scope_guard(dscope):
        first = eager_run(dexe, prog, dfeed, [only], return_numpy=False)[0]
        if not torch.equal(first, ref):
            raise AssertionError('(a) detection_output alone differs from the '
                                 'inference program\'s rows')
        ev = profile_run('', lambda: eager_run(dexe, prog, dfeed, [only],
                                                return_numpy=False),
                         quiet=True, pad=True)
        launches = device_ops(ev)
        eager_ms = statistics.median(events_ms(lambda: eager_run(
            dexe, prog, dfeed, [only], return_numpy=False))
            for _ in range(5))
        for _ in range(3):
            again = dexe.run(prog, feed=dfeed, fetch_list=[only],
                             return_numpy=False)[0]
        if not torch.equal(again, ref) or graph_refusals(prog, dscope):
            raise AssertionError('(a) detection_output alone not replayed '
                                 'bitwise')
        rep_ms = statistics.median(events_ms(lambda: dexe.run(
            prog, feed=dfeed, fetch_list=[only], return_numpy=False))
            for _ in range(5))
        drop_graphs(prog, dscope)
    mapm = metrics.DetectionMAP(class_num=MOBILENET_SSD['classes'],
                                overlap_threshold=0.5)
    rows = ref.cpu().numpy()
    gts = path['feeds'][-1]
    for i in range(rows.shape[0]):
        keep = rows[i][rows[i][:, 0] >= 0]
        mapm.update(keep, gts['gt_box'][i], gts['gt_label'][i])
    drop_graphs(test, scope)
    return {'rows': int((rows[..., 0] >= 0).sum()), 'map': mapm.eval(),
            'launches': launches, 'eager_ms': eager_ms, 'rep_ms': rep_ms}


def ssd_phase(seed, card):
    """Phase 22 (a): MobileNet-SSD at 300 x 300, SSD_STEPS RMSProp steps
    at batch SSD_BATCH of the VOC2012 stand-in (step 1 eager, step 2
    captured, the rest replayed), the losses and the whole state bitwise
    an eager-only run; then the inference clone (ssd_detect_phase)."""
    path = ssd_path(seed)
    loss = path['loss']
    names = weights.startup_names(path['startup'])
    # the batches staged on the card before the steps, as a loader
    # overlapping the copies would have them
    path['staged'] = [{k: torch.as_tensor(v, device='cuda')
                       for k, v in b.items()} for b in path['feeds']]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resting = torch.cuda.memory_allocated()
    res = p20_steps(path, path['staged'], [loss])
    peak = torch.cuda.max_memory_allocated() - resting
    check_replayed('(a)', res, path['expected'], 'embedding_lookup')
    eager = p20_steps(path, res['feeds'], [loss], res['start'], eager=True)
    same_steps('(a)', res, eager)
    differ = [n for n in names if not torch.equal(
        eager['scope'].find_var(n), res['scope'].find_var(n))]
    if differ:
        raise AssertionError('(a) the state after the replayed steps '
                             'differs from the eager run in %s' % differ[:5])
    with fluid.scope_guard(eager['scope']):
        top = top_share(without_counting(lambda: profile_run(
            '', lambda: eager_run(eager['exe'], path['main'],
                                  eager['feeds'][-1], [loss]), quiet=True,
            pad=True)))
    losses = [float(s['out'][0]) for s in res['steps']]
    if not np.isfinite(losses).all():
        raise AssertionError('(a) losses not finite: %s' % losses)
    rep_ms, eager_ms = step_ms(res, 2), step_ms(eager, 1)
    log('  (a) MobileNet-SSD (%d parameters, %d priors) at batch %d of 3 x '
        '%d x %d images, %d RMSProp steps: losses %s; launched a step %s; '
        'replayed bitwise the eager-only run' % (
            path['params'], path['box'].shape[0], SSD_BATCH,
            MOBILENET_SSD['image'], MOBILENET_SSD['image'], SSD_STEPS,
            ['%.3f' % x for x in losses],
            {k: n for k, n in path['expected'].items() if n}))
    log('  (a) replayed %.3f ms a step (%.1f images/s), cached eager %.3f ms, '
        'peak %.3f GiB over the resident %.3f (%s | %s)' % (
            rep_ms, SSD_BATCH / rep_ms * 1e3, eager_ms, peak / 2 ** 30,
            resting / 2 ** 30, torch.cuda.get_device_name(0), card))
    log('  (a) three largest kernels of an eager step: %s' % '; '.join(
        '%s %.2f ms (%.1f%%)' % (k, ms, 100 * sh) for k, ms, sh in top))
    drop_graphs(path['main'], res['scope'])
    det = ssd_detect_phase(path, res['scope'], res['exe'], card)
    log('  (a) inference clone at batch %d: detection_output (softmax, box '
        'decode, NMS 0.45 over 400 a class, 200 kept) bitwise replayed and '
        'eager; %d rows kept; alone: replayed %.3f ms, eager %.3f ms, %d '
        'kernel launches an eager call; mAP %.4f (synthetic data: it shows '
        'the path, not the model) (%s | %s)' % (
            SSD_BATCH, det['rows'], det['rep_ms'], det['eager_ms'],
            det['launches'], det['map'], torch.cuda.get_device_name(0),
            card))


def rcnn_path(seed):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed + 1
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        feeds, losses, rois, s_rois = rcnn_build(fluid, RCNN)
        fluid.optimizer.Momentum(RCNN_LR, 0.9, regularization=fluid.regularizer
                                 .L2Decay(RCNN_DECAY)).minimize(losses[0])
    gp = [op for op in main.global_block().ops
          if op.type == 'generate_proposals'][0]
    n_params = sum(int(np.prod(p.shape)) for p in main.all_parameters())
    return {'main': main, 'startup': startup, 'losses': losses,
            'rois': rois, 's_rois': s_rois, 'gp': gp, 'params': n_params,
            'feed': rcnn_inputs(RCNN, np.random.RandomState(seed + 22))}


def rcnn_steps(path, start=None):
    """RCNN_STEPS steps of path['main'] through Executor.run (eager: its
    host ops' outputs change shape every step) on a new scope from
    `start` (else the startup state), counted: (per step the losses, the
    sampled rois and the seconds, the state after, the start, the
    launches, the executor and the scope)."""
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    names = weights.startup_names(path['startup'])
    feed = {k: torch.as_tensor(v, device='cuda') for k, v in
            path['feed'].items()}
    steps, ran = [], []
    with fluid.scope_guard(scope):
        without_counting(lambda: exe.run(path['startup']))
        if start is None:
            start = snapshot(scope, names)
        else:
            for n, v in start.items():
                scope.set_var(n, v.clone())
        for _ in range(RCNN_STEPS):
            t0 = time.perf_counter()
            out, counts = counted(lambda: exe.run(
                path['main'], feed=feed,
                fetch_list=path['losses'] + [path['s_rois']],
                return_numpy=False))
            torch.cuda.synchronize()
            steps.append({'out': [v.clone() for v in out],
                          'secs': time.perf_counter() - t0})
            ran.append({k: n for k, n in counts.items() if n})
        state = snapshot(scope, names)
    return {'steps': steps, 'state': state, 'start': start, 'ran': ran,
            'exe': exe, 'scope': scope, 'feed': feed}


def roi_op_cases(x, rois, rng):
    """The RoI ops at the head's shape: X the res4 map, the step's
    sampled rois (image scale, 1 / 16 to the map)."""
    dev = x.device
    r = rois.shape[0]
    scale = 1.0 / RCNN['stride']
    cls = RCNN['classes'] // 4 + 1          # R-FCN's 21 VOC classes
    ps_x = torch.as_tensor(rng.randn(1, cls * ROI_POOL ** 2, *RCNN['map'])
                           .astype('float32'), device=dev)
    trans = torch.as_tensor(rng.randn(r, 2, ROI_POOL, ROI_POOL).astype(
        'float32') * 0.1, device=dev)
    pooled = {'pooled_height': ROI_POOL, 'pooled_width': ROI_POOL,
              'spatial_scale': scale}
    return [
        ('roi_align', {'X': [x], 'ROIs': [rois]},
         {'pooled_height': RCNN['pool'], 'pooled_width': RCNN['pool'],
          'spatial_scale': scale, 'sampling_ratio': 0}),
        ('roi_pool', {'X': [x], 'ROIs': [rois]}, pooled),
        ('psroi_pool', {'X': [ps_x], 'ROIs': [rois]},
         dict(pooled, output_channels=cls)),
        ('prroi_pool', {'X': [x], 'ROIs': [rois]}, pooled),
        ('deformable_roi_pooling', {'X': [x], 'ROIs': [rois],
                                    'Trans': [trans]},
         dict(pooled, trans_std=0.1)),
    ]


def op_fwd_bwd(op, ins, attrs, seed):
    """The op's outputs and the gradients of its float inputs (tensors
    on the card) under cotangents drawn on the card from the seed, all
    left on the card: a flat list."""
    dev = torch.device('cuda', 0)
    ctx = registry.LowerCtx(step=3, op_seed=7, device=dev)
    opdef = registry.get(op)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    with torch.enable_grad():
        tins = {s: [t.detach().requires_grad_() if t.is_floating_point()
                    else t for t in v] for s, v in ins.items()}
        outs = opdef.run(ctx, tins, attrs)
        ys = [y for s, v in sorted(outs.items()) for y in v
              if s not in opdef.no_grad_out_slots and y.requires_grad]
        cts = [torch.randn(y.shape, generator=gen, device=dev) for y in ys]
        xs = [x for v in tins.values() for x in v if x.requires_grad]
        grads = torch.autograd.grad(ys, xs, cts, allow_unused=True)
    torch.cuda.synchronize()
    return [y.detach() for s in sorted(outs) for y in outs[s]] + \
        [g for g in grads if g is not None]


def rcnn_phase(seed, card):
    """Phase 22 (b): the Faster R-CNN RPN and RoI head at Detectron's
    shapes, RCNN_STEPS momentum steps twice from the same start, the
    losses and the whole state bitwise; generate_proposals timed alone
    on the last step's inputs; then each RoI op at the head's shape,
    forward and backward, twice bitwise, timed."""
    path = rcnn_path(seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resting = torch.cuda.memory_allocated()
    first = rcnn_steps(path)
    peak = torch.cuda.max_memory_allocated() - resting
    second = without_counting(lambda: rcnn_steps(path, first['start']))
    for k, (a, b) in enumerate(zip(first['steps'], second['steps'])):
        if not all(torch.equal(x, y) for x, y in zip(a['out'], b['out'])):
            raise AssertionError('(b) step %d differs between the two runs'
                                 % (k + 1))
    differ = [n for n in first['state'] if not torch.equal(
        first['state'][n], second['state'][n])]
    if differ:
        raise AssertionError('(b) the state after the two runs differs in '
                             '%s' % differ[:5])
    if not first['ran'][0].get('embedding_lookup'):
        raise AssertionError('(b) no embedding_lookup launch: %s'
                             % first['ran'])
    losses = [[float(v) for v in st['out'][:5]] for st in first['steps']]
    if not np.isfinite(losses).all():
        raise AssertionError('(b) losses not finite: %s' % losses)
    n_rois = [int(st['out'][5].shape[0]) for st in first['steps']]
    # generate_proposals alone on the inputs of a step
    gp = path['gp']
    scope, exe = first['scope'], first['exe']
    with fluid.scope_guard(scope):
        names = [gp.input(s)[0] for s in ('Scores', 'BboxDeltas', 'ImInfo',
                                           'Anchors', 'Variances')]
        vals = without_counting(lambda: eager_run(
            exe, path['main'], first['feed'], names, return_numpy=False))
    gp_ins = dict(zip(('Scores', 'BboxDeltas', 'ImInfo', 'Anchors',
                       'Variances'), ([v] for v in vals)))
    ctx = registry.LowerCtx(step=0, device=torch.device('cuda', 0))
    opdef = registry.get('generate_proposals')
    gp_ms = statistics.median(without_counting(lambda: events_ms(
        lambda: opdef.run(ctx, gp_ins, gp.attrs))) for _ in range(3))
    rois = first['steps'][-1]['out'][5]
    log('  (b) Faster R-CNN RPN + RoI head (%d parameters; res4 [1, %d, %d, '
        '%d], %d gt boxes, %d classes; the res5 stage left out), %d steps of '
        'momentum SGD twice from one start, bitwise: losses (sum, rpn cls, '
        'rpn box, head cls, head box) %s; %s sampled rois a step; launched '
        'a step %s' % (
            path['params'], RCNN['channels'], *RCNN['map'], RCNN['gts'],
            RCNN['classes'], RCNN_STEPS, [['%.4f' % v for v in row]
                                          for row in losses],
            n_rois, first['ran'][0]))
    log('  (b) step %.1f ms (median, eager), generate_proposals alone %.1f ms '
        '(%d anchors, %d pre-NMS, %d NMS steps), peak %.3f GiB over the '
        'resident %.3f (%s | %s)' % (
            statistics.median(st['secs'] for st in first['steps']) * 1e3,
            gp_ms, vals[3].numel() // 4, RCNN['pre_nms'], RCNN['post_nms'],
            peak / 2 ** 30, resting / 2 ** 30, torch.cuda.get_device_name(0),
            card))
    rng = np.random.RandomState(seed + 23)
    times = []
    for op, ins, attrs in roi_op_cases(first['feed']['res4'], rois, rng):
        def run():
            return without_counting(lambda: op_fwd_bwd(op, ins, attrs, seed))
        a, b = run(), run()
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            raise AssertionError('(b) %s at the head\'s shape: second run '
                                 'differs' % op)
        del a, b
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ms = statistics.median(events_ms(run) for _ in range(3))
        times.append('%s %.2f ms (peak %.2f GiB)' % (
            op, ms, (torch.cuda.max_memory_allocated() - base) / 2 ** 30))
    log('  (b) the RoI ops on the %d rois of step %d, forward and backward, '
        'twice bitwise: %s (%s | %s)' % (
            rois.shape[0], RCNN_STEPS, '; '.join(times),
            torch.cuda.get_device_name(0), card))
    drop_graphs(path['main'], scope)


def iou_far_from(boxes, thr, rng, redraw, margin=1e-6):
    """boxes [M, 4] with every pair's IoU (float64) at least `margin`
    from thr: the boxes of a pair too near are redrawn (redraw(rng, k)
    -> [k, 4]) until none is."""
    boxes = boxes.copy()
    while True:
        b = boxes.astype('float64')
        lt = np.maximum(b[:, None, :2], b[None, :, :2])
        rb = np.minimum(b[:, None, 2:], b[None, :, 2:])
        inter = np.prod(np.maximum(rb - lt, 0), -1)
        area = np.prod(b[:, 2:] - b[:, :2], -1)
        iou = inter / np.maximum(area[:, None] + area[None] - inter, 1e-30)
        near = np.abs(iou - thr) < margin
        np.fill_diagonal(near, False)
        bad = np.unique(np.nonzero(near)[0])
        if not len(bad):
            return boxes
        boxes[bad] = redraw(rng, len(bad))


def draw_boxes(rng, n, h, w, lo, hi):
    """[n, 4] xyxy boxes with sides in [lo, hi) inside an h x w image."""
    bw = rng.uniform(lo, hi, n)
    bh = rng.uniform(lo, hi, n)
    x1 = rng.uniform(0, 1, n) * (w - bw)
    y1 = rng.uniform(0, 1, n) * (h - bh)
    return np.stack([x1, y1, x1 + bw, y1 + bh], 1).astype('float32')


def detection_op_cases(rng):
    """Every op type of item 11b's group C (detection) at a size its
    users run, as vision_op_cases; the host ops run through a program
    (host_op_run).  The boxes multiclass_nms gets have no pair at an IoU
    within 1e-6 of its threshold; generate_proposals' width and height
    deltas are 0, so its boxes (and so every NMS decision) come out of
    the same IEEE operations on the card and on the CPU."""
    f = lambda *s: rng.randn(*s).astype('float32')  # noqa: E731
    ints = lambda lo, hi, *s: rng.randint(lo, hi, s).astype('int32')  # noqa
    ssd = MOBILENET_SSD
    img = np.zeros((1, 3, ssd['image'], ssd['image']), 'float32')
    priors = np.concatenate([
        registry.get('prior_box').run(registry.LowerCtx(step=0, device='cpu'), {
            'Input': [torch.zeros(1, 1, m, m)], 'Image': [torch.as_tensor(img)]},
            {'min_sizes': [mn], 'max_sizes': [mx] if mx else [],
             'aspect_ratios': ar, 'flip': True, 'step_w': float(st),
             'step_h': float(st)})['Boxes'][0].reshape(-1, 4).numpy()
        for m, mn, mx, ar, st in zip((19, 10, 5, 3, 2, 1), ssd['min_sizes'],
                                     ssd['max_sizes'], ssd['aspect_ratios'],
                                     ssd['steps'])])
    p = len(priors)
    rh, rw = RCNN['map']
    ih, iw = RCNN['image']
    scale = 1.0 / RCNN['stride']
    head = lambda n: draw_boxes(rng, n, ih, iw, 16, 400)  # noqa: E731
    unit = lambda rg, n: draw_boxes(rg, n, 1.0, 1.0, 0.02, 0.6)  # noqa

    def nms_ins():
        boxes = np.stack([iou_far_from(unit(rng, p), SSD_NMS, rng, unit)
                          for _ in range(8)])
        logits = f(8, p, ssd['classes'])
        scores = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
        return {'BBoxes': [boxes],
                'Scores': [scores.transpose(0, 2, 1).astype('float32')]}

    def anchors():
        return registry.get('anchor_generator').run(
            registry.LowerCtx(step=0, device='cpu'),
            {'Input': [torch.zeros(1, 1, rh, rw)]},
            {'anchor_sizes': RCNN['anchor_sizes'],
             'aspect_ratios': RCNN['ratios'], 'stride': [RCNN['stride']] * 2,
             'variances': [1.0] * 4})['Anchors'][0].numpy()

    def proposals_ins():
        a = len(RCNN['anchor_sizes']) * len(RCNN['ratios'])
        deltas = f(1, a, 4, rh, rw) * 0.2
        deltas[:, :, 2:] = 0.0
        return {'Scores': [rng.rand(1, a, rh, rw).astype('float32')],
                'BboxDeltas': [deltas.reshape(1, 4 * a, rh, rw)],
                'ImInfo': [np.array([[ih, iw, 1.0]], 'float32')],
                'Anchors': [anchors()],
                'Variances': [np.ones((rh, rw, a, 4), 'float32')]}

    def yolo_gt():
        gt = np.zeros((8, 50, 4), 'float32')
        for i in range(8):
            k = rng.randint(1, 20)
            gt[i, :k, :2] = rng.uniform(0.05, 0.95, (k, 2))
            gt[i, :k, 2:] = rng.uniform(0.02, 0.6, (k, 2))
        return gt

    def ssd_gt():
        gt = np.zeros((8, 10, 4), 'float32')
        for i in range(8):
            k = rng.randint(1, 10)
            gt[i, :k] = unit(rng, k)
        return gt

    def quads(n):
        b = head(n)
        return np.stack([b[:, 0], b[:, 1], b[:, 2], b[:, 1], b[:, 2],
                         b[:, 3], b[:, 0], b[:, 3]], 1) * np.float32(0.1)

    fmap = lambda c: f(2, c, rh, rw)  # noqa: E731  two images' res4
    batch = lambda n: ints(0, 2, n)  # noqa: E731
    pooled = {'pooled_height': 7, 'pooled_width': 7, 'spatial_scale': scale}
    rpn = {'rpn_batch_size_per_im': 256, 'rpn_fg_fraction': 0.5,
           'rpn_positive_overlap': 0.7, 'rpn_negative_overlap': 0.3}
    gts = lambda: head(7)[None]  # noqa: E731
    yolo_anchors = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119, 116, 90,
                    156, 198, 373, 326]
    return [
        # SSD's priors on MobileNet-SSD's second map, clipped and not
        ('prior_box', lambda: {'Input': [np.zeros((1, 1, 10, 10), 'float32')],
                               'Image': [img]},
         {'min_sizes': [105.0], 'max_sizes': [150.0],
          'aspect_ratios': [2.0, 3.0], 'flip': True, 'clip': False,
          'step_w': 16.0, 'step_h': 16.0, 'offset': 0.5}),
        ('prior_box', lambda: {'Input': [np.zeros((1, 1, 19, 19), 'float32')],
                               'Image': [img]},
         {'min_sizes': [60.0], 'aspect_ratios': [2.0], 'flip': True,
          'clip': True}),
        # SSD's decode of batch 8 and its encode of matched boxes
        ('box_coder', lambda: {'PriorBox': [priors],
                               'PriorBoxVar': [np.tile(np.float32(
                                   [0.1, 0.1, 0.2, 0.2]), (p, 1))],
                               'TargetBox': [f(8, p, 4)]},
         {'code_type': 'decode_center_size'}),
        ('box_coder', lambda: {'PriorBox': [priors], 'TargetBox': [unit(
            rng, p)]}, {'code_type': 'encode_center_size'}),
        ('iou_similarity', lambda: {'X': [unit(rng, 64)], 'Y': [priors]}, {}),
        # YOLOv3's 13 x 13 head at 416 x 416, COCO's 80 classes
        ('yolo_box', lambda: {'X': [f(8, 255, 13, 13)],
                              'ImgSize': [np.full((8, 2), 416, 'int32')]},
         {'anchors': yolo_anchors[12:], 'class_num': 80, 'conf_thresh': 0.01,
          'downsample_ratio': 32}),
        ('yolov3_loss', lambda: {'X': [f(8, 255, 13, 13)],
                                 'GTBox': [yolo_gt()],
                                 'GTLabel': [ints(0, 80, 8, 50)]},
         {'anchors': yolo_anchors, 'anchor_mask': [6, 7, 8], 'class_num': 80,
          'ignore_thresh': 0.7, 'downsample_ratio': 32}),
        # SSD's detection_output NMS at batch 8
        ('multiclass_nms', nms_ins,
         {'score_threshold': 0.01, 'nms_top_k': 400, 'keep_top_k': 200,
          'nms_threshold': SSD_NMS}),
        ('ssd_loss', lambda: {'Location': [f(8, p, 4)],
                              'Confidence': [f(8, p, ssd['classes'])],
                              'GtBox': [ssd_gt()],
                              'GtLabel': [ints(1, 21, 8, 10)],
                              'PriorBox': [priors]},
         {'overlap_threshold': 0.5, 'neg_pos_ratio': 3.0}),
        # RetinaNet's classification loss over 20,000 anchors
        ('sigmoid_focal_loss', lambda: {'X': [f(20000, 80)],
                                        'Label': [ints(0, 81, 20000, 1)],
                                        'FgNum': [np.array([150], 'int32')]},
         {'gamma': 2.0, 'alpha': 0.25}),
        # the R-CNN head's proposals, rois and boxes
        ('generate_proposals', proposals_ins,
         {'pre_nms_topN': RCNN['pre_nms'], 'post_nms_topN': RCNN['post_nms'],
          'nms_thresh': RCNN['nms'], 'min_size': 0.0}),
        ('roi_align', lambda: {'X': [fmap(256)], 'ROIs': [head(256)],
                               'RoisBatch': [batch(256)]},
         dict(pooled, sampling_ratio=2)),
        ('roi_pool', lambda: {'X': [fmap(256)], 'ROIs': [head(128)],
                              'RoisBatch': [batch(128)]}, pooled),
        ('psroi_pool', lambda: {'X': [f(1, 21 * 49, rh, rw)],
                                'ROIs': [head(300)]},
         dict(pooled, output_channels=21)),
        ('prroi_pool', lambda: {'X': [fmap(256)], 'ROIs': [head(128)],
                                'BatchRoINums': [batch(128)]}, pooled),
        ('deformable_roi_pooling',
         lambda: {'X': [fmap(256)], 'ROIs': [head(128)],
                  'RoisBatch': [batch(128)],
                  'Trans': [f(128, 2, 7, 7) * 0.1]},
         dict(pooled, trans_std=0.1)),
        ('anchor_generator', lambda: {'Input': [np.zeros((1, 1, rh, rw),
                                                         'float32')]},
         {'anchor_sizes': RCNN['anchor_sizes'],
          'aspect_ratios': RCNN['ratios'], 'stride': [RCNN['stride']] * 2,
          'variances': [0.1, 0.1, 0.2, 0.2], 'offset': 0.5}),
        # FaceBoxes' densified anchors on its 32 x 32 map at 1024
        ('density_prior_box',
         lambda: {'Input': [np.zeros((1, 1, 32, 32), 'float32')],
                  'Image': [np.zeros((1, 3, 1024, 1024), 'float32')]},
         {'fixed_sizes': [32.0, 64.0, 128.0], 'fixed_ratios': [1.0],
          'densities': [4, 2, 1], 'variances': [0.1, 0.1, 0.2, 0.2]}),
        ('box_clip', lambda: {'Input': [head(2000) * np.float32(1.2) - 50],
                              'ImInfo': [np.array([[ih, iw, 1.0]],
                                                  'float32')]}, {}),
        ('box_decoder_and_assign',
         lambda: {'PriorBox': [head(512)], 'TargetBox': [f(512, 324) * 0.1],
                  'BoxScore': [f(512, 81)]}, {'box_clip': 4.135}),
        # EAST's geometry map; SSD's targets of batch 8
        ('polygon_box_transform', lambda: {'Input': [f(8, 8, 128, 128)]}, {}),
        ('target_assign', lambda: {'X': [ssd_gt()],
                                   'MatchIndices': [ints(-1, 10, 8, p)]},
         {'mismatch_value': 0}),
        # the host ops
        ('rpn_target_assign', lambda: {'Anchor': [anchors()],
                                       'GtBoxes': [gts()]}, rpn),
        ('retinanet_target_assign', lambda: {'Anchor': [anchors()],
                                             'GtBoxes': [gts()]},
         dict(rpn, rpn_positive_overlap=0.5, rpn_negative_overlap=0.4)),
        ('generate_proposal_labels',
         lambda: {'RpnRois': [head(RCNN['post_nms'])],
                  'GtClasses': [ints(1, 81, 7, 1)], 'GtBoxes': [head(7)]},
         {'batch_size_per_im': 512, 'fg_fraction': 0.25, 'fg_thresh': 0.5,
          'bg_thresh_hi': 0.5, 'bg_thresh_lo': 0.0}),
        ('generate_mask_labels', lambda: {'Rois': [head(128)]},
         {'resolution': 14}),
        ('distribute_fpn_proposals',
         lambda: {'FpnRois': [draw_boxes(rng, 2000, ih, iw, 16, 790)]},
         {'min_level': 2, 'max_level': 5, 'refer_level': 4,
          'refer_scale': 224}),
        ('collect_fpn_proposals',
         lambda: {'MultiLevelRois': [head(500) for _ in range(4)],
                  'MultiLevelScores': [rng.rand(500, 1).astype('float32')
                                       for _ in range(4)]},
         {'post_nms_topN': 2000}),
        ('locality_aware_nms', lambda: {'BBoxes': [quads(1000)[None]],
                                        'Scores': [rng.rand(1, 1, 1000)
                                                   .astype('float32')]},
         {'nms_threshold': 0.3, 'keep_top_k': 200}),
        ('roi_perspective_transform',
         lambda: {'X': [f(1, 64, 128, 128)], 'ROIs': [quads(100)]},
         {'transformed_height': 8, 'transformed_width': 64,
          'spatial_scale': 1.0}),
        ('bipartite_match', lambda: {'DistMat': [rng.rand(10, p).astype(
            'float32')]}, {'match_type': 'per_prediction',
                           'dist_threshold': 0.5}),
    ]


def detection_ops_phase(seed, dev):
    """Phase 22 (c): every op type of item 11b's group C on the card
    against the CPU, as ops_against_cpu holds them (floats within
    DET_TOL), twice bitwise, none exempt."""
    cases = detection_op_cases(np.random.RandomState(seed + 24))
    worst, n_out = ops_against_cpu(cases, dev, seed, DET_TOL)
    log('  (c) %d op types (%d cases, %d outputs and gradients) on the card '
        'against the CPU (integers exact, floats within %g of the largest '
        'magnitude; worst %.1e), every one twice bitwise' % (
            len({op for op, _, _ in cases}), len(cases), n_out, DET_TOL,
            worst))


def detection_phase(seed, dev):
    """Phase 22: item 11b's group C."""
    card = card_line()
    log('[22] detection: MobileNet-SSD, the Faster R-CNN RPN and RoI head, '
        'the op types of 11b-C (%s | %s)' % (
            torch.cuda.get_device_name(0), card))
    saved = torch.backends.cudnn.deterministic, \
        torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        for key, fn in (('a', lambda: ssd_phase(seed, card)),
                        ('b', lambda: rcnn_phase(seed, card)),
                        ('c', lambda: without_counting(
                            lambda: detection_ops_phase(seed, dev)))):
            t0 = time.perf_counter()
            fn()
            gc.collect()
            torch.cuda.empty_cache()
            log('  (%s): %.1f s' % (key, time.perf_counter() - t0))
    finally:
        torch.backends.cudnn.deterministic, \
            torch.backends.cudnn.benchmark = saved


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--profile', action='store_true')
    ap.add_argument('--dp-worker', action='store_true',
                    help=argparse.SUPPRESS)
    ap.add_argument('--dp-out', help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is false (torch %s)'
              % torch.__version__, file=sys.stderr)
        return 1
    if args.dp_worker:
        return dp_worker(args)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the kernels line's rows of one table or route, counted as the
    # kernels are
    tally_sub_rows()
    dev = torch.device('cuda', 0)
    card = card_line()
    t_start = time.perf_counter()
    log('[1] torch %s, CUDA %s, python %s' % (
        torch.__version__, torch.version.cuda, sys.version.split()[0]))
    drv, rt = graph_cond.versions()
    log('    CUDA driver %d, runtime %d (cudaDriverGetVersion / '
        'cudaRuntimeGetVersion)' % (drv, rt))
    graph_cond.require_conditional_nodes()
    log('    card: %s | %s (count %d)' % (
        torch.cuda.get_device_name(0), card, torch.cuda.device_count()))

    t0 = time.perf_counter()
    common.build()
    for info in common.KERNELS.values():
        common.library(info['source'])
    log('[2] built %s in %.1f s into %s' % (
        sorted({k['source'] for k in common.KERNELS.values()}),
        time.perf_counter() - t0, common.build_dir()))

    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    paths = [pretrain_program(args.seed, 'adam'),
             pretrain_program(args.seed, 'lamb'),
             wide_deep_program(args.seed)]
    adam_shapes = [tuple(p.shape) for p in sorted(
        paths[0]['main'].all_parameters(), key=lambda p: p.name)]
    lenet_shapes = [tuple(p.shape) for p in sorted(
        lenet_path(args.seed, 'adam')['main'].all_parameters(),
        key=lambda p: p.name)]
    log('[3] kernel parity on the card')
    max_err = {
        'flash_attention': without_counting(lambda: check_flash(gen, dev)),
        'flash_attention[dropout]': without_counting(
            lambda: check_flash_dropout(gen, dev)),
        'flash_attention_bwd': without_counting(
            lambda: check_flash_bwd(gen, dev)),
        **without_counting(lambda: check_flash_bf16(gen, dev)),
        'embedding_lookup': without_counting(
            lambda: check_embedding(gen, dev)),
        'embedding_scatter_add': without_counting(
            lambda: check_scatter(gen, dev)),
        'fused_adam': without_counting(
            lambda: check_adam(gen, dev, adam_shapes, lenet_shapes)),
        'fused_adam[zero]': without_counting(
            lambda: check_adam_rows(gen, dev, adam_shapes)),
        'fused_lamb': without_counting(
            lambda: check_lamb(gen, dev, adam_shapes)),
        'embedding_update': without_counting(
            lambda: check_emb_update(gen, dev)),
        'quant_quantize': without_counting(lambda: check_quant(gen, dev)),
        'quant_reduce': 0.0,
        'embedding_lookup[nmt]': without_counting(
            lambda: check_nmt_tables(gen, dev, args.seed)),
        'dropout': without_counting(lambda: check_dropout(gen, dev)),
    }
    for row in ('dropout[bf16]', 'dropout[no mask]', 'dropout[bf16,no mask]',
                'dropout_grad', 'dropout_grad[bf16]'):
        max_err[row] = max_err['dropout']
    max_err['embedding_scatter_add[nmt]'] = max_err['embedding_lookup[nmt]']
    torch.cuda.empty_cache()

    log('[4] BERT-base serving through create_paddle_predictor')
    os.makedirs(os.path.join(ROOT, 'build', 'chip_smoke'), exist_ok=True)
    with tempfile.TemporaryDirectory(
            dir=os.path.join(ROOT, 'build', 'chip_smoke')) as model_dir:
        t0 = time.perf_counter()
        cfg, n_attn, n_emb, n_params = build_model(model_dir, args.seed)
        log('  built, initialised and saved %d parameters (%d attention, '
            '%d lookup ops) in %.1f s' % (n_params, n_attn, n_emb,
                                          time.perf_counter() - t0))
        pred, requests, serve_launches, serve_replayed = serve(
            model_dir, cfg, n_attn, n_emb, args.seed)
    log('  launches on the 3 requests: %s; replayed: %s'
        % ({k: c for k, c in serve_launches.items() if c},
           {k: c for k, c in serve_replayed.items() if c}))

    runs = []
    for phase, path in zip((5, 6, 7), paths):
        log('[%d] %s training steps on CUDAPlace(0)' % (phase, path['name']))
        runs.append(train(path))
        log('  launches + replayed on the %d steps: %s' % (
            TRAIN_STEPS, {k: c for k, c in runs[-1]['launches'].items()
                          if c}))

    log('[8] timings at the main path\'s shapes (%s | %s)' % (
        torch.cuda.get_device_name(0), card))
    timer = Timer(dev)
    rows = without_counting(lambda: time_kernels(
        timer, gen, dev, requests[-1], paths[0]['batch'], paths[2]['batch'],
        MAIN_LAUNCHES, max_err, adam_shapes, lenet_shapes, args.seed))
    without_counting(lambda: attention_crossover(timer, gen, dev))
    without_counting(lambda: request_latency(pred, requests, n_attn, n_emb))
    for run in runs:
        med = without_counting(lambda: train_step_ms(run))
        if run is runs[0]:
            F32_RUNS['bert512'] = step_numbers(
                5, run, med, without_counting(lambda: step_device_ms(run)))
        without_counting(lambda: plan_cache_steps(
            run, required=run is runs[0]))
    if args.profile:
        without_counting(lambda: profile_requests(pred, requests))
        for run in runs:
            without_counting(lambda: profile_train(run))
    del pred, runs, timer
    torch.cuda.empty_cache()

    log('[9] data-parallel BERT-base training, %d ranks (%s | %s)' % (
        DP_RANKS, torch.cuda.get_device_name(0), card))
    dp = data_parallel(args.seed, args.profile)
    lenet_k4 = image_classification(args.seed, dev, args.profile)
    t0 = time.perf_counter()
    short_attention(args.seed)
    log('  phase 11: %.1f s' % (time.perf_counter() - t0))
    t0 = time.perf_counter()
    dp_world_one(args.seed, dev)
    log('  phase 12 at world size 1: %.1f s' % (time.perf_counter() - t0))
    t0 = time.perf_counter()
    mixed_precision(args.seed, dev, args.profile)
    log('  phase 13: %.1f s' % (time.perf_counter() - t0))
    t0 = time.perf_counter()
    data_plane(args.seed, dev)
    log('  phase 14: %.1f s' % (time.perf_counter() - t0))
    t0 = time.perf_counter()
    seq2seq_phase(args.seed)
    log('  phase 15: %.1f s' % (time.perf_counter() - t0))
    t0 = time.perf_counter()
    lang_phase(args.seed, dev)
    log('  phase 16: %.1f s' % (time.perf_counter() - t0))
    t0 = time.perf_counter()
    core_phase(args.seed, dev)
    log('  phase 17: %.1f s' % (time.perf_counter() - t0))
    t0 = time.perf_counter()
    without_counting(lambda: observability_phase(args.seed, dev))
    log('  phase 18: %.1f s' % (time.perf_counter() - t0))
    t0 = time.perf_counter()
    rows += compile_plane_phase(args.seed, dev, Timer(dev))
    log('  phase 19: %.1f s' % (time.perf_counter() - t0))
    t0 = time.perf_counter()
    nn_slice_phase(args.seed, dev)
    log('  phase 20: %.1f s' % (time.perf_counter() - t0))
    t0 = time.perf_counter()
    vision_loss_phase(args.seed, dev)
    log('  phase 21: %.1f s' % (time.perf_counter() - t0))
    t0 = time.perf_counter()
    detection_phase(args.seed, dev)
    log('  phase 22: %.1f s' % (time.perf_counter() - t0))
    # each row's launches at the wrappers and replayed from CUDA graphs'
    # manifests on the main path, as counted() read them in this
    # process; the data-parallel rows, as the ranks of phases 9 and 12
    # counted them; LeNet-5's K4 (also in K4's own row), as phase 10
    # counted it
    for row in rows:
        name = row['name']
        row['launches'] = MAIN_LAUNCHES.get(name, 0)
        row['replayed_launches'] = MAIN_REPLAYED.get(name, 0)
        if name in ('quant_quantize', 'quant_reduce'):
            row['launches'] = dp[0]['launches'][name]
        elif name == 'fused_adam[zero]':
            row['launches'] = dp[0]['phase12']['bert']['launches'][
                'fused_adam']
        elif name == 'fused_adam[lenet]':
            row['launches'], row['replayed_launches'] = lenet_k4
        elif name == 'graph_cond':
            # the kernel runs only inside graphs: its launches are the
            # replays' (each body's manifest times the trips counted)
            row['launches'] = row['replayed_launches']
    log('  launches by row of the kernels line (%s | %s): at the wrappers '
        '%s; replayed from CUDA graphs %s' % (
            torch.cuda.get_device_name(0), card,
            {r['name']: r['launches'] for r in rows},
            {r['name']: r['replayed_launches'] for r in rows}))
    log('  training steps from CUDA graphs (plan_cache_steps):')
    for line in GRAPH_NUMBERS:
        log('    ' + line)
    idle = [row['name'] for row in rows if not row['launches']]
    if idle:
        raise AssertionError('no launch on the main path: %s' % idle)
    log('  whole run %.1f s' % (time.perf_counter() - t_start))
    log('card: %s' % card_line())
    print(json.dumps({'kernels': rows}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
