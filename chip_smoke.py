#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card (H100).

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over; each
prints how long it took):

1. build   -- compile every CUDA kernel source in llm_guided_asr_tpu_torch/csrc
              with nvcc for sm_90a (one nvcc per source, started together)
              and print ptxas's register and spill lines;
2. kernels -- hold each kernel entry point against its plain PyTorch version
              and time it beside the plain version, the library call where
              one exists, and the bound from bytes and operations:
              the two forwards at the serving path's shapes (B=1, CUDA
              events around a CUDA graph of repeated launches), and at the
              training shapes (rel-attention B=64, H=4, T=312, dk=64;
              depthwise [64, 312, 256] x [31, 256] and an even K=8) the
              rel-attention forward with dropout and its backward against
              autograd through the plain version with the same hash mask
              (dropout 0 and 0.1, all keys valid and ragged), and the
              depthwise backward against its plain VJP, in float32 and
              bfloat16 (CUDA events around back-to-back launches; the
              depthwise kernels and F.conv1d, shorter than a call from
              Python, by CUDA graph);
3. serve   -- build the LLM-guided model at full width (Conformer 12x256,
              guided decoder 6x256, Llama-3.2-1B dims in bf16) with weights
              drawn from seed 0, serve one warm-up request at each of the
              3 lengths and then each request 3 times through Speech2Text
              with beam 10 (median latency and spread), and check the
              kernel launch counts of the timed requests (12 forward
              launches per request each, no backward), the hypotheses'
              score bookkeeping, and the card's encoder against the plain
              CPU path;
4. profile -- the 10 s request again: its encode time alone, then one run
              under torch.profiler (card activity only) for the device busy
              share of the unprofiled latency and the top kernels by device
              time;
5. train-1 -- phase 1 of the fork's training: the flagship CTC/attention
              ASRModel (bench.py build_flagship: vocab 5000, Conformer
              12x256, decoder 6x256) in float32 with SpecAug and attention
              dropout 0.1, AdamW, B=64 x 10 s of seeded noise: 2 warm-up and
              10 timed fused train steps (losses finite and falling, each of
              the four kernel entry points launched 12 times per step), peak
              memory, and one profiled step's device busy share;
6. train-2 -- phase 2: the serving model with encoder, ctc_head and llm
              frozen, B=2 x 10 s: 1 warm-up and 5 timed steps (forward
              kernels 12 launches per step, backward kernels none, frozen
              weights bit-identical afterwards) and one profiled step;
7. serve-transducer -- the RWKV transducer at full width (vocab 5000, the
              Conformer of train-1, RWKV prediction network 4 x 512, joint
              256) with weights drawn from seed 0: each of the 3 requests
              once to warm up and 3 times timed through Speech2Text with
              beam 5 (each timed request launches 12 of each encoder
              forward, 4 WKV forwards per prediction-network call, 2 calls
              per frame, and no backward), the 10 s request once greedily,
              the card's prediction and joint networks against the CPU
              plain path, and one profiled request;
8. train-transducer -- the same model trained with SpecAug and dropout
              0.1, AdamW, B=16 x 10 s, text [16, 24]: 2 warm-up and 5 timed
              steps (losses finite and falling, 12 launches of each encoder
              kernel entry point and 4 of each WKV entry point per step),
              peak memory and one profiled step;
9. serve-flash -- flash-ASR (the train-1 model with the long-form
              encoder: abs_pos encoding, flash self-attention) served as
              phase 3 serves, on requests of 60, 45 and 30 s (T' = 1874,
              1405, 937) at beam 10 with the stateless scorer: 12 flash and
              12 depthwise forward launches per request, nothing else, the
              card's encoder against the CPU plain path on the 30 s
              request; then the 60 s request profiled as phase 4;
10. train-flash -- flash-ASR trained at B=8 x 60 s, text [8, 96], SpecAug
              and dropout 0.1, AdamW: 2 warm-up and 5 timed steps (losses
              finite and falling, 12 launches of each flash and depthwise
              entry point per step, no rel-attention), peak memory and one
              profiled step;
11. golden -- the reference's golden fixtures (tests/parity/
              golden_conformer.npz, golden_llm_guided.npz, read with numpy
              through llm_guided_asr_tpu_torch/bin/golden_check.py) at the
              JAX package's parity tolerances: encoder outputs, CTC and
              decoder log-probs, beam-10/beam-1 hypotheses and scores, the
              guided model's loss, cached steps and beam 10; the encoders
              (2 x 32, head dim 16, conv kernel 7) launch the rel-pos and
              depthwise forward kernels 6 times each, nothing else; then
              both kernels on their own at those shapes against their
              plain versions (1e-5, 1e-4); golden_trained_guided.npz:
              the 30-utterance tone corpus made again from seed 0 (the
              int16 wav round trip included), the template split by the
              port's tokenizer, every utterance decoded at beam 10 from a
              reference-trained checkpoint: the reference's hypotheses,
              scores within 5e-3, its CER (one encoder pass of 2 blocks an
              utterance); and golden_trained.npz at its three operating
              points: the corpus at beam 5 offline and with the
              reference-trained TransformerLM at lm_weight 0.3 (hypotheses,
              scores within 5e-3, CER), and 8 utterances through the
              resumable search in 3 cuts (the offline hypotheses);
              golden_transducer.npz: the reference LSTM transducer's tsd,
              tsd3 and nsc 4-best lists from its encoder rows (tokens
              equal, scores within 1e-4; no kernel runs);
12. serve-batch -- phase 3's model serving 8 requests in one
              Speech2Text.batch_call (10.0, 7.3, 4.1, 10.0, 7.3, 4.1, 10.0,
              7.3 s of phase 3's seeded noise, padded to 10 s: T' = 312
              with 312, 229 or 129 valid frames a lane; beam 10, the
              24-token cap): one warm-up and 3 timed batches (median
              latency and spread, audio seconds per second, peak memory,
              12 launches of each encoder forward kernel a batch and no
              backward), the hypotheses' score bookkeeping, one profiled
              batch's device busy share; then, with a float32 copy of the
              LLM, each lane of a batch against the same lane decoded
              alone from the batch's encoder rows (tokens equal, scores
              within 1e-3; a lane that differs must be a near tie, the two
              candidates within 1e-4);
13. serve-lm -- phase 5's CTC/attention ASRModel (vocab 5000, Conformer
              12x256, decoder 6x256, float32, seed 0) served with shallow
              fusion: a TransformerLM at the widths of ESPnet's LibriSpeech
              recipe (train_lm_transformer2.yaml: embed 128, att 512, 8
              heads, 2048 units, 16 layers, sinusoidal; seed 0) at
              lm_weight 0.6, phase 3's requests at beam 10, ctc_weight 0.3
              and the 24-token cap: one warm-up and 3 timed runs of each
              (median, min, max, RTFx), peak memory, 12 launches of each
              encoder forward a request and no backward, the scores'
              bookkeeping with the LM part, one profiled request (busy
              share, top kernels, the LM's share of the device time), and
              the card's LM log-probs against the CPU (1e-4);
14. serve-stream -- a streaming ASRModel (contextual-block Conformer at
              the widths of ESPnet's AISHELL streaming Conformer: 12x256,
              4 heads, 2048 units, cnn kernel 15, block 40; global MVN
              with seeded statistics; decoder 6x256; vocab 5000; seed 0)
              fed the 10 s request in 1 s chunks through
              Speech2TextStreaming (beam 10, ctc_weight 0.3, the 24-token
              cap): each chunk's latency and the last one's, 12 depthwise
              launches a block and no rel-pos launch, the streamed encoder
              rows against the offline encode (1e-5), the final hypothesis
              equal to the offline decode (its score gap held to the JAX
              test's 0.5: the stream keeps only the blank row of the
              carried CTC state) and to the same resumable search replayed
              over the offline rows with the stream's cuts (score 1e-4).

15. train-run -- Trainer.run (runs right after phase 6, while phase 3's
              model is resident).  Part 1: phase 5's model trained from
              160 int16 wav files of seeded noise (6-10 s; text_int of 2.4
              tokens a second from 1..4998) written to a temporary
              directory, 128 train and 32 validate, through the ported
              data path (ESPnetDataset, the sorted sampler at B=32, speech
              padded to a multiple of 1600 samples, SequenceIterFactory):
              accum_grad 2 (64 utterances an update), AdamW lr 1e-3 with
              warmuplr over 6 updates, 2-best by valid acc and valid loss,
              greedy-CTC error on validation, a probe every 2 microbatches;
              run A trains 2 epochs and resumes to 3, run B trains 3; each
              run's launch counts (12 of each encoder forward a train
              microbatch and 24 a validation batch, 12 of each backward a
              train microbatch), finite stats, per-epoch wall time and
              audio seconds per second, the probes' grad, optimizer and
              iterator times, each save's seconds and bytes and peak
              memory; the epoch files pruned to the union of both
              criteria's best two and the latest, the best links, the
              2-best average against the float64 mean; A's update count
              and epochs equal B's, its epoch-3 stats within tolerance.
              Part 2: phase 6's freezing on phase 3's model, 1 epoch of 2
              microbatches (B=2 x 10 s) and 1 validation batch with
              exclude_prefixes ("params/llm",): no file holds an llm key,
              1epoch.pth's bytes, frozen weights bit-identical, and
              load_partial into a freshly built model restores every
              non-LLM tensor.
16. asr-cli -- the task and CLI layer, driven only through the CLIs'
              main(argv) in a temporary directory.  A: phase 15's corpus
              with its text as words (w0002..w4998, a 5,000-entry word
              token list), a YAML config written by the port's dump_yaml
              at build_train1's widths (global MVN, SpecAug, adamw,
              warmuplr, sorted batches of 32, 2 epochs, 2-best, device
              null = the card): asr_train --collect_stats (every frame
              counted), asr_train (12 launches of each encoder entry point
              a train microbatch and of each forward a validation batch),
              the model's names and shapes against build_train1()'s,
              asr_inference at beam 10, ctc_weight 0.3, the 24-token cap on
              the 32 valid utterances (12 forward launches each, every
              utterance written, the scores' bookkeeping, the hypotheses
              equal to Speech2Text(config.yaml, checkpoint)'s, scores
              within 1e-4), score.  B: model llm_guided_asr over
              tests/parity/tiny_llm_bpe with part A's encoder by init_param,
              frozen (no backward launch, its weights unchanged), 1 epoch
              of letter texts, no llm tensor in any .pth, a beam-10 decode
              of 2 utterances with the cached guided scorer.  C: lm_train
              at LM_CONF's widths for 1 epoch of part A's text,
              lm_calc_perplexity (finite), and part A's model decoding 2
              utterances with --lm_train_config/--lm_file at lm_weight 0.3
              (the LM part in each score).  Prints collect_stats seconds,
              each epoch's wall time and train audio s/s, each save's
              seconds and bytes, and the RTF and RTFx of the CLI's rtf file.

17. serve-transducer-rnn -- phase 7's transducer with the LSTM prediction
              network of the JAX config's widths (embed 256, hidden 256, one
              layer; one launch of the LSTM recurrence kernel over the whole
              label prefix a call), seed 0, served at beam 5 through
              Speech2Text: the default search on the 3 requests, and alsd,
              tsd (max_sym_exp 2) and nsc (nstep 2, prefix_alpha 4) on the
              10 s request, each once to warm up and 3 times timed (median,
              min, max latency and RTFx; 12 launches of each encoder
              forward a request, one lstm_fwd a prediction-network call,
              nothing else); the card's LSTM and joint networks against the
              CPU plain path (1e-4); each search's 5-best against the same
              search on the CPU from the first 64 of the card's encoder rows
              of the 4.1 s request (tokens equal, scores within 1e-3, a
              differing entry only as a near tie within 1e-4); the 4.1 s
              request's tsd profiled (busy share, top kernels, one
              recurrence kernel a prediction-network call);
18. train-transducer-mb -- that model with big blanks of 2, 4 and 8 frames
              (the top 3 ids, sigma 0.05) trained as phase 8 trains (2
              warm-up, 5 timed steps, the multi-blank loss; 12 launches of
              each encoder entry point and one of each LSTM entry point a
              step, peak memory, audio s/s, one profiled step), its mbg
              decode of the 10 s request against the CPU from the card's
              encoder rows (tokens equal); then the MEGA transducer (hidden
              256, 4 blocks, qk 64, 4 EMA heads, FFN 512) trained 2 + 3
              steps (finite, falling) and its prediction network on the
              card against the CPU at 301 positions, the rfft path (1e-4).

19. serve-st -- phase 3's model as the LLM-guided ST model (source
              vocabulary the LLM's, an extra ASR decoder at the guided
              decoder's widths), served through Speech2Translation at the
              JAX defaults (beam 5, ctc_weight 0, 48-token cap, the
              full-prefix scorer) on the 10.0, 7.3 and 4.1 s requests at
              B=1: one warm-up each, 3 timed runs (median, min, max, RTFx),
              12 launches of each encoder forward a request, peak memory,
              the 10 s request profiled (busy share), the 5-best sorted
              and finite, the card's encoder against the CPU plain path
              (1e-3);
20. train-st -- that model trained at B=8 x 10 s by the fused step
              (SpecAug, AdamW; asr_weight 0.3, mtlalpha 0.5, lsm_weight
              0.1; the LLM frozen and bit-identical after): 1 warm-up and
              5 timed steps, 12 launches of each encoder entry point a
              step, audio s/s, peak memory, one profiled step, the loss
              falling;
21. recipe-io -- the first 24 utterances of phase 15's corpus as 16-bit flac
              (read equal to their wavs bitwise), 4 of their feature
              matrices as Kaldi ark FM (bitwise) and CM (within the
              format's quantization bound) through the kaldi_ark data
              type; st_train and st_inference through the CLIs over the
              byte-level fixture tokenizer and its tiny LLM; asr_pipeline
              stages 3-15 with --decode_nj 2 (two asr_inference processes)
              writing the text of a --decode_nj 1 decode, and
              Speech2Text.from_packed decoding as the experiment directory
              does.
22. serve-ebf -- a CTC/attention ASRModel with the E-Branchformer of
              ESPnet's LibriSpeech-100 recipe (12 x 256, 4 heads, 1024
              units for the FFNs and the cgMLP, cgMLP kernel 31; the merge
              conv's kernel 3 as JAX fixes it; decoder 6 x 256, vocab
              5000) served as phase 3 serves (12 rel-pos and 12 depthwise
              forward launches a request at C = 512, the encoder against
              the CPU), one request profiled; the Branchformer at the same
              widths and the Transformer encoder (2048 units, abs
              positions, no kernel) serve one 10 s request each against
              the CPU plain path.
23. train-ebf -- that model trained as phase 5 trains (B=64 x 10 s,
              SpecAug, attention dropout 0.1, AdamW): 12 launches of each
              encoder entry point a step, one step profiled; then the
              Bayes-risk CTC (risk 0.1) on the batch's CTC logits
              [64, 312, 5000], loss and logits gradient on the card
              against the CPU, timed beside the builtin CTC.

28. serve-ssl -- ``frontend: ssl``: a frozen HuBERT-Base trunk (facebook/
              hubert-base-ls960's widths: 12 x 768, 12 heads, 3,072 units,
              7 x 512 conv channels, group norm, post-norm; weights from
              seed 1, written by this script as a local config.json +
              model.safetensors directory and read back through ASRTask)
              feeding train-1's Conformer (12 x 256, conv2d input over the
              768-dim features: T' = 124 for 10 s) and the 6 x 256 decoder,
              vocab 5000, served as phase 3 serves (beam 10, ctc_weight 0.3;
              12 launches of each encoder forward a request); the SSL
              features (1e-4) and encoder rows (1e-3) against the CPU, the
              10-best from the card's encoder rows against the CPU's search
              (scores 1e-4), one request traced;
29. train-ssl -- that model trained with SpecAug and attention dropout 0.1,
              AdamW (weight decay 0.01), B=8 x 10 s: the B=2 loss against
              the CPU (1e-5), 1 warm-up and 5 timed steps (finite, falling;
              12 launches of each encoder entry point a step), the frozen
              trunk's weights decayed as optax's AdamW leaves them (JAX
              freezes it by stop_gradient alone), one step traced;
30. serve-hf -- hubert_hf and wav2vec2_hf (wav2vec2-base-960h's widths) on
              the raw waveform, whisper_hf (whisper-base's encoder: 6 x 512,
              8 heads, 2,048 units, 80 mels, 1,500 positions), the sliding
              window + sinc pre-encoder + Conformer + length adaptor,
              Conformer + the BERT-base post-encoder (12 x 768), Conformer +
              the hugging_face decoder at Llama-3.2-1B's widths in float32
              (as ASRTask builds it; its 10-best of the 4.1 s request, 6
              tokens, from the card's encoder rows against the CPU's search,
              scores 1e-4): each one 10 s request at beam 10 (launches, the
              encoder against the CPU) and one B=2 AdamW step.
31. serve-mc -- train-1's CTC/attention model (vocab 5000, Conformer
              12 x 256, decoder 6 x 256, seed 0) behind the multichannel
              frontend at the JAX defaults (n_fft 512, hop 128, WPE of 5
              taps, delay 3, 2 iterations, MVDR from the masks of a
              64-unit BiLSTM over the reference channel's 257
              log-magnitude bins), fed six channels (CHiME-4's tablet
              array: one seeded source reaching microphone c c samples
              late, plus noise): the 10.0, 7.3 and 4.1 s requests at beam
              10 (one warm-up and one timed run each; 12 launches of each
              encoder forward and 2 lstm_fwd a request, nothing else; the
              features and the encoder against a CPU copy, 1e-3), then the
              10 s request traced: busy share, each mask-estimator LSTM
              launch in us, WPE's and MVDR's shares of the device time;
32. train-mc -- that model trained with SpecAug, attention dropout 0.1,
              AdamW at B=8 x 10 s x 6 channels: the B=2 loss (1e-5) and
              gradients (1e-3 of the norm, the whole and the mask
              estimator's) against the CPU on the weights of seed 0, then 1
              warm-up and 3 timed steps (finite, falling; 12 launches of
              each encoder entry point and 2 of each LSTM entry point a
              step);
33. serve-avhubert -- an ASRModel over AV-HuBERT Base
              (facebookresearch/av_hubert's base: 768 wide, 12 layers, 12
              heads, 3,072 units), audio-only as ASRTask builds it (the
              log-mel frames, T' = 1251 for 10 s), the 6 x 256 decoder:
              one 10 s request at beam 10 (no hand-written kernel runs),
              the encoder against a CPU copy on its first 2 s (1e-3), one
              encode traced;
34. train-avhubert -- that model trained at B=8 x 10 s (SpecAug, dropout
              0.1, AdamW): 1 warm-up and 3 timed steps; then the
              audio-visual module (concat fusion, the ResNet-18 trunk of
              the 3-D stem, GroupNorm and the SAME-padded stride-2 convs) on
              B=2 x 10 s of 88 x 88 lip crops at 25 fps, forward and
              backward timed, and on a 2 s slice the card's output (1e-3)
              and whole gradient (1e-3 of its norm) against a CPU copy;
35. align-cli -- in phase 16's directory: asr_align on two valid
              utterances with part A's model (segments in order inside
              each utterance; the Viterbi on the card equal to the CPU's
              from the same log-posteriors) and lm_inference with part C's
              LM, greedy (each token within 1e-4 of the CPU LM's best) and
              sampled at temperature 1 from seed 0 (the same text again
              from the same seed), each CLI call timed;
36. serve-bf16 -- phase 3's guided model and its bfloat16-compute twin
              (train_dtype: bfloat16: the same float32 weights, bf16
              activations) serving the 10.0/7.3/4.1 s requests at beam 10 in
              turns: latencies, encode times, peak memory, launches by
              operand dtype (the encoder kernels in bf16 for the twin), one
              traced bf16 request; with the first pass pinned to float32's,
              each length's best against float32's (one token sequence's
              scores in both dtypes within 5e-3, BatchBeamSearch.rescore),
              and what three deliberately wrong bf16 paths read there;
              then twins at full width and 4 encoder blocks: the LSTM
              transducer, E-Branchformer, MultiConvformer, rnn decoder,
              the SSL frontend (4 of HuBERT-Base's layers), AV-HuBERT and
              the six-channel WPE/MVDR model on the 10 s request, the
              streaming Conformer in 1 s chunks, one request each of
              hubert_hf, wav2vec2_hf, whisper_hf, sinc and fused models,
              and the Transformer and RNN LMs' NLL of one batch;
37. train-bf16 -- train-1's, train-flash's and train-2's models in float32
              and bf16 from the same weights, each on its own phase's
              batch: a B=4 (B=2) step's losses (5e-3) and gradients (each
              tensor and the whole within 5e-2 of its norm, or so on the
              float32 run's ReLU gates) against float32, then warm-up and
              timed steps of each dtype in turns, every encoder entry
              point launched once a block a step in the step's dtype;
              then twins at 4 encoder blocks: the RWKV transducer,
              E-Branchformer, MultiConvformer, SSL-frontend, AV-HuBERT and
              ST models.
The kernel table of phase 2 also holds rows 1-4 at the SSL Conformer's
shapes: [1, 4, 124, 64] and [8, 4, 124, 64] (with the backward), the
depthwise [1, 124, 256] and [8, 124, 256] (with the backward).

``--phase train-1|train-run|train-transducer|golden|serve|serve-batch|serve-lm|serve-stream|
asr-cli|serve-transducer-rnn|train-transducer-mb|serve-st|train-st|recipe-io|serve-ebf|
train-ebf|serve-dec|train-dec|serve-enc|train-enc|serve-ssl|train-ssl|serve-hf|serve-mc|
train-mc|serve-avhubert|train-avhubert|align-cli|serve-bf16|train-bf16`` builds the
kernels and runs that phase alone (no kernel table; several, comma-separated, in turn);
``--package-root DIR`` then imports the port from another checkout, so that
two revisions run one phase in turns.

Phase 2 also holds the LSTM recurrence kernels (csrc/lstm.cu: one launch
a call, a thread-block cluster a row group; phases 17-18's prediction
network) against the plain loop: the forward at the beam-5 prefix
[5, 201, 256] and the training labels [16, 25, 256], the backward and the
autograd function's gradients at the latter, each call repeated and
bitwise equal, timed by CUDA events beside the loop and cuDNN's
torch.lstm of the same function (the yardstick only), with each call's
launch count, cluster shape and microseconds a step printed.  It holds
the WKV forward against its plain loop at the
transducer's shapes (beam-5 serving [5, 201, 512], greedy [1, 313, 512]
and training [16, 25, 512], each timed by CUDA graph with its chunk count
printed, each call repeated and bitwise equal; |k| up to ~100; a state
chained across two calls) and the WKV backward against autograd through
the plain loop at the training shape and at [16, 101, 512] (chunked; also
with |k| up to ~100), each timed by CUDA graph with its chunk count
printed and each call repeated and bitwise equal; the depthwise backward's repeat
calls must be bitwise equal (dw included); the flash forward at the
serving shape [1, 4, 1874, 64] (CUDA graph; its key splits printed) and the
forward, dK/dV and dQ at the training shape [8, 4, 1874, 64] under autograd
against autograd through the plain version (all frames valid and ragged,
pad query rows and masked keys exactly 0, repeat calls of every entry point
bitwise equal, the forward's lse against the plain logsumexp; CUDA
events), each beside F.scaled_dot_product_attention with the same key mask
(timed only; the forward's and the backward pair's TFLOP/s and ratio to it
printed); and
the rel-pos forward at the long-form length [1, 4, 1874, 64], the
yardstick beside the flash forward; and the two encoder forwards at the
batched serving shapes of phase 12 ([8, 4, 312, 64] with 312, 229, 129,
312, 229, 129, 312 and 229 valid keys; [8, 312, 256] x [31, 256]), f32,
CUDA graph, the depthwise forward at the streaming encoder's block
[1, 40, 256] x [15, 256] (phase 14), f32, CUDA graph, and the depthwise
forward and backward at the E-Branchformer cgMLP's 512 channels
([1, 312, 512] and [64, 312, 512] x [31, 512], phases 22-23), f32; the
MultiConvformer's depthwise convs (K = 7 and 23 on 512 channels, the merge
conv's K = 31 on 2048; the forward at B=1, the forward and backward at
B=16 and 64) and the LSTM recurrence at the RNN encoders' 320 units (the
forward at [1, 312, 320] and [1, 1251, 320], forward and backward at
[16, 312, 320], [16, 1251, 320] and [64, 312, 320]; W_hh in shared
memory) and at ESPnet's LSTM LM unit 650 ([16, 100, 650], forward and
backward; W_hh read from L2), phases 26-27, and at the multichannel
mask estimator's 64 units over 1251 frames ([1, 1251, 64] and
[8, 1251, 64], forward and backward), phases 31-32, f32.  The
rel-pos entry points are also
held at logits x3 and with a batch row whose keys are all masked
([2, 4, 312, 64], dropout 0.1), their repeat calls must be bitwise equal
(serving and training shapes, the backward's dp included), and their
TFLOP/s and key splits are printed.  Bounds take float32 matrix products
(the attention kernels) at the 3xTF32 rate, 165 TFLOP/s, and other float32
work at the CUDA cores' 67 TFLOP/s.

Each row of the kernel table also carries phase 2's bfloat16 numbers at
its timed and serving shapes (``bf16_*``, ``bf16_serve_*``; bounds at the
bf16 rate) and its bfloat16 launches in phases 36-37
(``bf16_launches_by_path``).

The last two lines of standard output are the kernel table as one JSON
object and {"ok": true, "device": {...}}; the line before them is the
card's name and power limit.  Without a card the script exits with
status 2 and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np
import torch

# Published H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
# float32-accurate matrix products on the tensor cores: 3xTF32 (each operand
# split into two TF32 parts, three TF32 products) at 495 TFLOP/s of TF32.
# The bound of the attention and LSTM kernels' float32 products; elementwise
# and recurrent work (depthwise, WKV) keeps the 67 TFLOP/s CUDA-core rate.
F32_PRODUCT_FLOPS = 495e12 / 3

SR = 16000
REQUEST_SECONDS = (10.0, 7.3, 4.1)
# phase 12: one batch of 8 requests of phase 3's lengths, padded to 10 s
BATCH_SECONDS = (10.0, 7.3, 4.1, 10.0, 7.3, 4.1, 10.0, 7.3)
BATCH_T, BATCH_LENS = 312, (312, 229, 129, 312, 229, 129, 312, 229)  # encoder frames
BATCH_ROUNDS = 3
ROUNDS = 3  # timed runs of each request (phases 3 and 7)
TRAIN_B, TRAIN_SECONDS, TRAIN_WARMUP, TRAIN_STEPS = 64, 10.0, 2, 10
GUIDED_B, GUIDED_WARMUP, GUIDED_STEPS = 2, 1, 5
TRANSDUCER_BEAM = 5
MB_DURATIONS = (2, 4, 8)  # phase 18's big blanks (Xu et al. 2023)
# phase 17's CPU checks search the first CHECK_FRAMES encoder rows of the
# 4.1 s request (the CPU's searches, not the card's, set the phase's time)
CHECK_FRAMES = 64
TRD_B, TRD_WARMUP, TRD_STEPS = 16, 2, 5
# the RWKV prediction network's depth (the reference's default is 4 blocks;
# cut to 2 to pay for the bf16 twins of phases 36-37)
RWKV_LAYERS = 2
# the LSTM recurrence of phases 17-18: the beam-5 prefix (200 labels after
# the blank) and the training labels (U + 1 = 25), hidden 256
LSTM_SERVE = (TRANSDUCER_BEAM, 201, 256)
LSTM_TRAIN = (TRD_B, 25, 256)
WKV_SERVE = {"serve beam-5 [5,201,512]": (5, 201, 512), "serve greedy [1,313,512]": (1, 313, 512)}
WKV_TRAIN = (16, 25, 512)  # B=16, U+1 = 25 labels, hidden 512
WKV_BWD_LONG = (16, 101, 512)  # the labels of ~40 s of audio at 24 tokens per 10 s
ENCODER_FWD = ("rel_attention_fwd", "dwconv1d_fwd")  # one launch per Conformer block
ENCODER_BWD = ("rel_attention_bwd", "dwconv1d_bwd")
REL_SHAPE = dict(b=64, h=4, t=312, dk=64)  # phase 1: 10 s of audio, 4 heads of 64
DW_SHAPE = (64, 312, 256)
# the flash-attention Conformer (phases 9-10): long-form requests, one pass
FLASH_SECONDS = (60.0, 45.0, 30.0)
FLASH_B, FLASH_TEXT, FLASH_WARMUP, FLASH_STEPS = 8, 96, 2, 5
FLASH_T = 1874  # encoder frames of 60 s of audio (hop 128, x4 subsampling)
FLASH_SERVE = (1, 4, FLASH_T, 64)
FLASH_TRAIN = (FLASH_B, 4, FLASH_T, 64)
FLASH_FWD = ("flash_attention_fwd", "dwconv1d_fwd")
# phase 13 (serve-lm): the TransformerLM of ESPnet's LibriSpeech recipe
# (egs2/librispeech/asr1/conf/tuning/train_lm_transformer2.yaml)
LM_CONF = dict(embed_unit=128, att_unit=512, head=8, unit=2048, layer=16)
LM_WEIGHT = 0.6
# phase 14 (serve-stream): ESPnet's AISHELL streaming Conformer
# (egs2/aishell/asr1/conf/tuning/train_asr_streaming_conformer.yaml)
STREAM_BLOCK, STREAM_KERNEL, STREAM_CHUNK = 40, 15, 16000
STREAM_DW_SHAPE = f"serve-stream [1,{STREAM_BLOCK},256] K={STREAM_KERNEL}"
STREAM_FWD = ("dwconv1d_fwd",)
FLASH_BWD = ("flash_attention_bwd_dkv", "flash_attention_bwd_dq", "dwconv1d_bwd")
# phases 22-23 (serve-ebf, train-ebf): the E-Branchformer of ESPnet's
# LibriSpeech-100 recipe (egs2/librispeech_100/asr1/conf/tuning/
# train_asr_e_branchformer_size256_mlp1024_linear1024_e12_mactrue_edrop0.0_ddrop0.0.yaml):
# 12 blocks of 256, 4 heads, 1024 units for the FFNs and the cgMLP (JAX has
# one field for both), cgMLP kernel 31; the merge conv's kernel is fixed at 3
EBF_KERNEL = 31
EBF_ENCODER = dict(output_size=256, attention_heads=4, linear_units=1024, num_blocks=12,
                   cnn_module_kernel=EBF_KERNEL)
# the recipe's Transformer baseline widths (2048 units, abs positions)
TRANSFORMER_ENCODER = dict(output_size=256, attention_heads=4, linear_units=2048, num_blocks=12,
                           pos_enc_layer_type="abs_pos", selfattention_layer_type="selfattn")
CGMLP_C = EBF_ENCODER["linear_units"] // 2
CGMLP_SERVE = f"serve-ebf [1,312,{CGMLP_C}] K={EBF_KERNEL}"
CGMLP_TRAIN = (TRAIN_B, 312, CGMLP_C)
CGMLP_TRAIN_SHAPE = f"train-ebf [{TRAIN_B},312,{CGMLP_C}] K={EBF_KERNEL}"
BRCTC_RISK = 0.1
# phases 24-25 (serve-dec, train-dec): train-1's Conformer ASRModel with each
# decoder of this slice, in the JAX config mapping (decoder_conf holds the
# TransformerDecoderConfig fields; models/asr_model.py make_decoder)
NEW_DECODERS = {
    # ESPnet's RNNDecoder default: one LSTM layer of 320 (JAX: hidden =
    # linear_units, layers = num_blocks; embed min(D, 256), att_dim D)
    "rnn": dict(num_blocks=1, linear_units=320),
    # ESPnet's LightweightConvolution/DynamicConvolutionTransformerDecoder
    # defaults: 6 blocks, 4 heads, 2048 units, kernel 11 (JAX fixes 11)
    "lightconv": dict(num_blocks=6, attention_heads=4, linear_units=2048),
    "dynamicconv": dict(num_blocks=6, attention_heads=4, linear_units=2048),
    # 6 blocks; JAX fixes d_state 16 and the diag kernel
    "s4": dict(num_blocks=6, attention_heads=4, linear_units=2048),
}
DEC_ROUNDS = 2  # timed runs of each request a decoder (phase 24)
DEC_B, DEC_WARMUP, DEC_STEPS = 64, 1, 3  # phase 25
GRAD_B = 2  # phase 25's card-vs-CPU gradients
# phases 26-27 (serve-enc, train-enc): the encoders of this slice with the
# 6 x 256 Transformer decoder (its width follows the encoder's)
NEW_ENCODERS = {
    # ESPnet's LibriSpeech-100 MultiConvformer: 12 x 256, 4 heads, 1024
    # units (FFNs and the cgMLP), kernels 7/15/23/31, merge 31, rel_pos, macaron
    "multiconvformer": dict(output_size=256, attention_heads=4, linear_units=1024,
                            num_blocks=12, multicgmlp_kernel_sizes=(7, 15, 23, 31)),
    # ESPnet VGGRNNEncoder's / RNNEncoder's defaults: 4 bidirectional LSTM
    # layers of 320 (elayers 4, eunits = eprojs 320)
    "vgg_rnn": dict(output_size=320, num_blocks=4),
    "rnn": dict(output_size=320, num_blocks=4),
    # ESPnet's LongformerEncoder widths at 12 x 256 (2048 units), window 64
    "longformer": dict(output_size=256, attention_heads=4, linear_units=2048, num_blocks=12,
                       pos_enc_layer_type="abs_pos", selfattention_layer_type="selfattn"),
    # Whisper base's encoder widths: 6 blocks of 512, 8 heads, 2048 units, 80 mels
    "whisper_style": dict(output_size=512, attention_heads=8, linear_units=2048, num_blocks=6,
                          pos_enc_layer_type="abs_pos", selfattention_layer_type="selfattn"),
    # 12 x 256 with the ss_* defaults (s4 NPLR + ff a block, d_state 64,
    # pre-norm LayerNorm, residual, bidirectional, no pooling)
    "s4": dict(output_size=256, attention_heads=4, num_blocks=12,
               pos_enc_layer_type="abs_pos", selfattention_layer_type="selfattn"),
}
ENC_B, ENC_WARMUP, ENC_STEPS = 16, 1, 2  # phase 27: 3 steps an encoder
MCF_KERNELS = (7, 15, 23, 31)
MCF_C = NEW_ENCODERS["multiconvformer"]["linear_units"] // 2  # 512: the cgMLP's gate
MCF_MERGE_C = MCF_C * len(MCF_KERNELS)  # 2048: the merge conv's channels
# the shapes phases 26-27 give the depthwise kernels (serving B=1, training
# B=ENC_B) and the training batch of train-1 (B=64)
MCF_DW = [(7, MCF_C), (23, MCF_C), (31, MCF_MERGE_C)]  # (K, C): K = 15 and 31 at 512 as in 22-23
# the LSTM recurrence at the RNN encoders' 320 units: 10 s of audio is 1251
# frames (hop 128), 312 after VGG2L
RNN_H, RNN_T, VGG_T = 320, 1251, 312
LSTM_ENC_SERVE = [(1, VGG_T, RNN_H), (1, RNN_T, RNN_H)]
LSTM_ENC_TRAIN = [(ENC_B, VGG_T, RNN_H), (ENC_B, RNN_T, RNN_H), (64, VGG_T, RNN_H)]
# the other side of the kernels' width choice (W_hh read from L2 above 320
# units): ESPnet SequentialRNNLM's default unit, 16 sentences of 100 tokens
LSTM_WIDE = [(16, 100, 650)]
MCF_SHAPES = {f"[{b},312,{c}] K={k}" for k, c in MCF_DW for b in (1, ENC_B, 64)}
# phases 28-30 (serve-ssl, train-ssl, serve-hf): the pretrained Hugging Face
# choices.  The SSL frontend is HuBERT-Base at facebook/hubert-base-ls960's
# config.json widths (W2VConfig's defaults: 12 x 768, 12 heads, 3,072 units,
# 7 x 512 conv channels, group norm, post-norm); 10 s of audio is 499 of its
# 50 Hz frames, 124 after the Conformer's conv2d subsampling
SSL_T = 124
SSL_B, SSL_WARMUP, SSL_STEPS = 8, 1, 5
SSL_SHAPES = {f"serve-ssl [1,4,{SSL_T},64]", f"train-ssl [{SSL_B},4,{SSL_T},64] dropout 0.1",
              f"serve-ssl [1,{SSL_T},256] K=31", f"train-ssl [{SSL_B},{SSL_T},256] K=31"}
# train-1's Conformer and decoder, ESPnet's recipe widths (bench.py build_flagship)
SSL_ENCODER = dict(output_size=256, attention_heads=4, linear_units=1024, num_blocks=12,
                   macaron_style=True, use_cnn_module=True, cnn_module_kernel=31)
SSL_DECODER = dict(attention_heads=4, linear_units=2048, num_blocks=6)
# openai/whisper-base's encoder (config.json): 6 x 512, 8 heads, 2,048 units,
# 80 mels, 1,500 positions
WHISPER_BASE = dict(d_model=512, encoder_layers=6, encoder_attention_heads=8,
                    encoder_ffn_dim=2048, num_mel_bins=80, max_source_positions=1500)
# bert-base-uncased (config.json): 12 x 768, 12 heads, 3,072 units
BERT_BASE = dict(model_type="bert", hidden_size=768, num_hidden_layers=12, num_attention_heads=12,
                 intermediate_size=3072, vocab_size=30522, max_position_embeddings=512,
                 type_vocab_size=2, layer_norm_eps=1e-12, pad_token_id=0)
# the hugging_face decoder's depth at Llama-3.2-1B's widths: 4 of its 16
# layers (the CPU's 10-best check of serve-hf took ~55 s at 16), the depth
# cut that pays for the bf16 twins of phases 36-37
HF_LLM_LAYERS = 4
# the hugging_face decoder's 10-best held against the CPU's search: its
# stateless scorer runs the 1B LM over the whole prompt each step, which
# the CPU takes seconds for
HF_LLM_NBEST_TOKENS = 6
# phases 31-32 (serve-mc, train-mc): the multichannel frontend at the JAX
# defaults (n_fft 512, hop 128; WPE of 5 taps, delay 3, 2 iterations; MVDR
# from the masks of a 64-unit BiLSTM over the reference channel's 257
# log-magnitude bins) before train-1's Conformer, fed the six microphones
# of CHiME-4's tablet array
MC_FRONTEND = dict(use_wpe=True, wpe_taps=5, wpe_delay=3, wpe_iterations=2,
                   use_beamformer=True, mask_units=64, ref_channel=0)
MC_CHANNELS = 6
MC_T = 1251  # STFT frames of 10 s at hop 128: the mask estimator's length
MC_B, MC_WARMUP, MC_STEPS = 8, 1, 3
# the mask estimator's recurrence at serving (B = 1) and training (B = MC_B)
LSTM_MASK = [(1, MC_T, MC_FRONTEND["mask_units"]), (MC_B, MC_T, MC_FRONTEND["mask_units"])]
# phases 33-34 (serve-avhubert, train-avhubert): AV-HuBERT Base
# (facebookresearch/av_hubert's base: 768 wide, 12 layers, 12 heads, 3,072
# FFN units, a ResNet-18 video trunk), audio-only through ASRTask's encoder
# (the log-mel frames, no subsampling: T' = 1251 for 10 s), and the
# audio-visual module on 88 x 88 grayscale lip crops at 25 fps with 104
# stacked filterbank features a video frame
AVH_ENCODER = dict(output_size=768, attention_heads=12, linear_units=3072, num_blocks=12)
AVH_B, AVH_WARMUP, AVH_STEPS = 8, 1, 3
AV_B, AV_FPS, AV_PIXELS, AV_AUDIO_DIM, AV_ROUNDS = 2, 25, 88, 104, 3
CPU_SLICE_SECONDS = 2.0  # the CPU's side of the AV-HuBERT checks, at full width
LSTM_ENC_SHAPES = {f"[{b},{t},{h}]" for b, t, h in LSTM_ENC_SERVE + LSTM_ENC_TRAIN + LSTM_WIDE
                   + LSTM_MASK}


def nvidia_smi_name_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def graph_time_ms(fn, launches: int = 20, replays: int = 10) -> float:
    """Device time per call: ``launches`` calls captured in one CUDA graph,
    replayed ``replays`` times between two CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (launches * replays)


def event_time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Device time per call of work long enough to hide the launches:
    ``iters`` calls back to back between two CUDA events, after a warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: float, flops: float, dtype, products: bool = False) -> tuple:
    """The least time for ``n_bytes`` and ``flops``: matrix ``products``
    in float32 at the 3xTF32 rate, other work at the dtype's peak."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    peak = F32_PRODUCT_FLOPS if products and dtype == torch.float32 else PEAK_FLOPS[dtype]
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


def reset_counts(kernels) -> None:
    for k in kernels:
        k.reset_launches()


def counts(kernels) -> dict:
    return {name: n for k in kernels for name, n in k.launches.items()}


# ---------------------------------------------------------------------------
def phase_build(kernels):
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(kernels)) as pool:  # one nvcc per source, together
        list(pool.map(lambda k: k.build(), kernels))
    print(f"[build] {len(kernels)} kernel sources built in {time.perf_counter() - t0:.1f} s")
    for k in kernels:
        entry = ""
        for line in k.ptxas_log.splitlines():
            if "Compiling entry" in line:
                entry = line.split("'")[1] if "'" in line else line
            elif "registers" in line or "spill" in line:
                print(f"[build] {k.source.name} {entry[:70]}: {line.strip()}")


def rel_attention_tol(ref: torch.Tensor) -> float:
    """float32 differs from the plain version only in the order of the sums;
    bfloat16 also rounds the output, by at most one unit in the last place
    (2**-7 of the largest output) when the two sit on either side of a tie."""
    if ref.dtype == torch.float32:
        return 1e-5
    return 2.0 ** -7 * ref.float().abs().max().item() + 1e-5


def grad_tol(ref: torch.Tensor, dtype) -> float:
    """Gradients: float32 1e-4 of the largest reference gradient (the order
    of the sums over up to 312 keys and 64 batch rows);
    bfloat16 2**-6 of it, four units in the last place: the stored
    gradients are rounded once and the backward's delta is taken from the
    bfloat16 output."""
    scale = ref.float().abs().max().item()
    return (1e-4 if dtype == torch.float32 else 2.0 ** -6) * scale + 1e-6


def check_rel_attention(ra, dtype, gen, card, t=312, n_masked=25, plain_launches=20):
    """Serving shapes: B=1, H=4, T=312 (10 s of audio), dk=64, no gradient;
    also T=1874 (60 s), the long-form length, in float32.

    Unit-scale inputs give logits of standard deviation about 1.4, so the
    softmax is peaked enough that dropping or misplacing the positional
    term moves outputs far beyond the tolerance.  The error is checked with
    all keys valid (the serving path: every frame of a B=1 request is
    valid) and with ``n_masked`` keys masked; the time and the bound are
    taken with all keys valid, as the serving path calls the kernel.
    """
    b, h, dk = 1, 4, 64
    mk = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(dtype)  # noqa: E731
    qu, qv, k, v = (mk(b, h, t, dk) for _ in range(4))
    p = mk(h, 2 * t - 1, dk)
    sm = 1.0 / math.sqrt(dk)
    errs = {}
    for n_valid in (t, t - n_masked):
        kv_valid = (torch.arange(t, device="cuda")[None] < n_valid).to(torch.int32)
        out = ra.rel_attention(qu, qv, k, v, p, kv_valid, sm)
        ref = ra.rel_attention_plain(qu, qv, k, v, p, kv_valid, sm)
        torch.cuda.synchronize()
        err = max_err(out, ref)
        tol = rel_attention_tol(ref)
        if not err <= tol:
            raise AssertionError(f"rel_attention {dtype} {n_valid} valid keys: {err} > {tol}")
        errs[n_valid] = (err, tol)
    kv_valid = torch.ones(b, t, dtype=torch.int32, device="cuda")
    first, second = (ra.rel_attention_fwd(qu, qv, k, v, p, kv_valid, sm) for _ in range(2))
    torch.cuda.synchronize()
    if not all(map(torch.equal, first, second)):
        raise AssertionError(f"rel_attention_fwd {dtype} B=1 T={t}: a repeat call differs")
    # what the function needs for these inputs: each query row against the
    # valid keys only (a masked key adds exactly 0), the k and v rows of
    # those keys, the T + n - 1 positional rows they index
    n = kv_valid.sum(dim=1)
    item = dtype.itemsize
    n_bytes = (item * (3 * b * h * t * dk + 2 * h * dk * n.sum().item()
                       + h * (t + n.max().item() - 1) * dk) + 4 * b * t)
    flops = 6.0 * h * t * dk * n.sum().item()  # qu.k, qv.p and probs.v products
    bms, by = bound_ms(n_bytes, flops, dtype, products=True)
    err, tol = max(errs.values())
    r = dict(
        err=err, tol=tol,
        ms=graph_time_ms(lambda: ra.rel_attention(qu, qv, k, v, p, kv_valid, sm)),
        plain_ms=graph_time_ms(lambda: ra.rel_attention_plain(qu, qv, k, v, p, kv_valid, sm),
                               launches=plain_launches),
        library_ms=None,  # no single PyTorch call computes rel-pos attention
        bound_ms=bms, bound_by=by,
    )
    print(f"[kernels] rel_attention_fwd serve [{b},{h},{t},{dk}] {str(dtype)[6:]}: "
          f"{r['ms'] * 1e3:.2f} us ({flops / (r['ms'] * 1e9):.1f} TFLOP/s, {ra.key_splits(qu)} key "
          f"splits) against the plain version's {r['plain_ms'] * 1e3:.2f} us "
          f"({r['ms'] / r['plain_ms']:.2f}x) [{card}]")
    return r


def check_rel_attention_batch(ra, gen, card):
    """The batched serving shape of phase 12, float32: [8, 4, 312, 64] with
    each lane's valid keys; the time and the bound at these inputs (each
    query row against its lane's valid keys)."""
    b, h, t, dk = len(BATCH_LENS), 4, BATCH_T, 64
    mk = lambda *s: torch.randn(*s, generator=gen, device="cuda")  # noqa: E731
    qu, qv, k, v = (mk(b, h, t, dk) for _ in range(4))
    p = mk(h, 2 * t - 1, dk)
    sm = 1.0 / math.sqrt(dk)
    lens = torch.tensor(BATCH_LENS, device="cuda")
    kv_valid = (torch.arange(t, device="cuda")[None] < lens[:, None]).to(torch.int32)
    out = ra.rel_attention(qu, qv, k, v, p, kv_valid, sm)
    ref = ra.rel_attention_plain(qu, qv, k, v, p, kv_valid, sm)
    torch.cuda.synchronize()
    err, tol = max_err(out, ref), rel_attention_tol(ref)
    if not err <= tol:
        raise AssertionError(f"rel_attention serve-batch: {err} > {tol}")
    n = lens.sum().item()
    n_bytes = 4 * (3 * b * h * t * dk + 2 * h * dk * n + h * (t + max(BATCH_LENS) - 1) * dk) + 4 * b * t
    flops = 6.0 * h * t * dk * n
    bms, by = bound_ms(n_bytes, flops, torch.float32, products=True)
    r = dict(err=err, tol=tol, ms=graph_time_ms(lambda: ra.rel_attention(qu, qv, k, v, p, kv_valid, sm)),
             plain_ms=graph_time_ms(lambda: ra.rel_attention_plain(qu, qv, k, v, p, kv_valid, sm),
                                    launches=5),
             library_ms=None, bound_ms=bms, bound_by=by)
    print(f"[kernels] rel_attention_fwd serve-batch [{b},{h},{t},{dk}] lanes {list(BATCH_LENS)}: "
          f"{r['ms'] * 1e3:.2f} us ({flops / (r['ms'] * 1e9):.1f} TFLOP/s, "
          f"{ra.key_splits(qu)} key splits) [{card}]")
    return r


def check_dwconv(dc, dtype, k_size, gen, card, b=1, t=312, c=256):
    """Serving shape: [1, 312, 256] x [31, 256]; also an even K, the
    batched serving shape [8, 312, 256], the streaming encoder's block
    [1, 40, 256] x [15, 256] and the E-Branchformer cgMLP's [1, 312, 512]
    x [31, 512]."""
    x = torch.randn(b, t, c, generator=gen, device="cuda").to(dtype)
    w = torch.randn(k_size, c, generator=gen, device="cuda").to(dtype)
    y = dc.depthwise_conv1d(x, w)
    ref = dc.depthwise_conv1d_plain(x, w)
    # library yardstick, timed only: F.conv1d over the channels-first view
    xt, wt = x.transpose(1, 2), w.t()[:, None, :]
    lib = lambda: torch.nn.functional.conv1d(xt, wt, groups=c, padding="same")  # noqa: E731
    torch.cuda.synchronize()
    err = max_err(y, ref)
    lib_err = max_err(lib().transpose(1, 2), ref)
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    if not err <= tol:
        raise AssertionError(f"depthwise fwd {dtype} K={k_size}: {err} > {tol}")
    if lib_err > 10 * tol:
        raise AssertionError(f"library yardstick computes another function (err {lib_err})")
    n_bytes = dtype.itemsize * (2 * b * t * c + k_size * c)
    flops = 2.0 * b * t * c * k_size
    bms, by = bound_ms(n_bytes, flops, dtype)
    r = dict(
        err=err, tol=tol,
        ms=graph_time_ms(lambda: dc.depthwise_conv1d(x, w)),
        plain_ms=graph_time_ms(lambda: dc.depthwise_conv1d_plain(x, w)),
        library_ms=graph_time_ms(lib),
        bound_ms=bms, bound_by=by,
    )
    print(f"[kernels] dwconv1d_fwd [{b},{t},{c}] K={k_size} {str(dtype)[6:]}: "
          f"{r['ms'] * 1e3:.2f} us against F.conv1d's {r['library_ms'] * 1e3:.2f} us "
          f"({r['ms'] / r['library_ms']:.2f}x) [{card}]")
    return r


def check_rel_attention_train(ra, dtype, gen, card, b=REL_SHAPE["b"], t=REL_SHAPE["t"]):
    """Training shapes (phase 1: B=64, H=4, T=312, dk=64; train-ssl: B=8,
    T=124): the forward with
    the saved log-sum-exp and the backward, under autograd, against autograd
    through the plain version with the same hash mask; dropout 0 and 0.1,
    all keys valid and ragged (lengths from T down to 56).  Timed with all
    keys valid and dropout 0.1, as phase 1 calls them; the plain backward's
    time includes the forward it recomputes."""
    h, dk = REL_SHAPE["h"], REL_SHAPE["dk"]
    mk = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(dtype)  # noqa: E731
    qu, qv, k, v, dout = (mk(b, h, t, dk) for _ in range(5))
    p = mk(h, 2 * t - 1, dk)
    sm, seed = 1.0 / math.sqrt(dk), 1234567
    full = torch.ones(b, t, dtype=torch.int32, device="cuda")
    lengths = torch.linspace(t, 56, b, device="cuda").long()
    ragged = (torch.arange(t, device="cuda")[None] < lengths[:, None]).to(torch.int32)
    errs = {"out": 0.0, "dqu": 0.0, "dqv": 0.0, "dk": 0.0, "dv": 0.0, "dp": 0.0}
    for rate in (0.0, 0.1):
        for valid_name, kv_valid in (("all", full), ("ragged", ragged)):
            for name, err in check_rel_grads(ra, dtype, (qu, qv, k, v, p), kv_valid, dout, sm,
                                             seed, rate, f"dropout {rate} keys {valid_name}"):
                errs[name] = max(errs[name], err)
    # a repeat call of each entry point is bitwise equal (the forward's key
    # splits merge in a fixed order; dp is summed from per-block partials in
    # a fixed order, without atomics)
    for valid_name, kv_valid in (("all", full), ("ragged", ragged)):
        args = (qu, qv, k, v, p, kv_valid)
        fwd1, fwd2 = (ra.rel_attention_fwd(*args, sm, seed, 0.1) for _ in range(2))
        bwd1, bwd2 = (ra.rel_attention_bwd(*args, *fwd1, dout, sm, seed, 0.1) for _ in range(2))
        torch.cuda.synchronize()
        if not all(map(torch.equal, (*fwd1, *bwd1), (*fwd2, *bwd2))):
            raise AssertionError(f"rel_attention {dtype} keys {valid_name}: a repeat call of "
                                 "the forward or the backward differs")
        del fwd1, fwd2, bwd1, bwd2
    rate = 0.1
    out, lse = ra.rel_attention_fwd(qu, qv, k, v, p, full, sm, seed, rate)
    fwd = lambda: ra.rel_attention_fwd(qu, qv, k, v, p, full, sm, seed, rate)  # noqa: E731
    bwd = lambda: ra.rel_attention_bwd(qu, qv, k, v, p, full, out, lse, dout, sm,  # noqa: E731
                                       seed, rate)
    item, n = dtype.itemsize, float(full.sum().item())
    table = h * (2 * t - 1) * dk
    fwd_bytes = item * (5 * b * h * t * dk + table) + 4 * b * h * t + 4 * b * t
    # backward reads qu, qv, k, v, out, dout, p, lse, kv_valid; writes the
    # four [B, H, T, dk] gradients and dp in float32
    bwd_bytes = item * (10 * b * h * t * dk + table) + 4 * (table + b * h * t + b * t)
    fwd_bound, fwd_by = bound_ms(fwd_bytes, 6.0 * h * t * dk * n, dtype, products=True)
    bwd_bound, bwd_by = bound_ms(bwd_bytes, 16.0 * h * t * dk * n, dtype, products=True)
    plain_fwd = lambda: ra.rel_attention_plain(qu, qv, k, v, p, full, sm, seed, rate)  # noqa: E731
    plain_bwd = lambda: ra.rel_attention_bwd_plain(  # noqa: E731
        qu, qv, k, v, p, full, dout, sm, seed, rate)
    fwd_r = dict(err=errs["out"], ms=event_time_ms(fwd), plain_ms=event_time_ms(plain_fwd),
                 library_ms=None, bound_ms=fwd_bound, bound_by=fwd_by)
    bwd_r = dict(err=max(v for n_, v in errs.items() if n_ != "out"), errs=errs,
                 ms=event_time_ms(bwd), plain_ms=event_time_ms(plain_bwd, iters=5),
                 library_ms=None, bound_ms=bwd_bound, bound_by=bwd_by)
    fwd_rate = 6.0 * h * t * dk * n / (fwd_r["ms"] * 1e9)  # TFLOP/s
    bwd_rate = 16.0 * h * t * dk * n / (bwd_r["ms"] * 1e9)
    print(f"[kernels] rel_attention train [{b},{h},{t},{dk}] {str(dtype)[6:]} dropout {rate}: "
          f"forward {fwd_r['ms'] * 1e3:.2f} us ({fwd_rate:.1f} TFLOP/s, {ra.key_splits(qu)} key "
          f"splits), backward {bwd_r['ms'] * 1e3:.2f} us ({bwd_rate:.1f} TFLOP/s) [{card}]")
    return fwd_r, bwd_r


def check_rel_grads(ra, dtype, inputs, kv_valid, dout, sm, seed, rate, what):
    """The forward and the backward under autograd against autograd through
    the plain version with the same hash mask: the output at
    rel_attention_tol, each gradient at grad_tol; prints and returns the
    errors."""
    leaves = [x.clone().requires_grad_(True) for x in inputs]
    out = ra.rel_attention(*leaves, kv_valid, sm, seed=seed, dropout_rate=rate)
    grads = torch.autograd.grad(out, leaves, dout)
    ref = ra.rel_attention_plain(*inputs, kv_valid, sm, seed, rate)
    refs = ra.rel_attention_bwd_plain(*inputs, kv_valid, dout, sm, seed, rate)
    torch.cuda.synchronize()
    parts = [("out", out, ref, rel_attention_tol(ref))]
    parts += [(n, g, r, grad_tol(r.to(dtype), dtype)) for n, g, r in
              zip(("dqu", "dqv", "dk", "dv", "dp"), grads, refs)]
    line, errs = [], []
    for name, got, want, tol in parts:
        err = max_err(got, want.to(dtype))
        if not err <= tol:
            raise AssertionError(f"rel_attention {dtype} {what}: {name} error {err} > {tol}")
        errs.append((name, err))
        line.append(f"{name} {err:.2e}/{tol:.1e}")
    b, h, t, dk = inputs[0].shape
    print(f"[kernels] rel_attention [{b},{h},{t},{dk}] {str(dtype)[6:]} {what}: max_abs_err/tol "
          + ", ".join(line))
    return errs


def check_rel_attention_edges(ra, gen):
    """Two inputs the training shapes do not reach, at B=2, H=4, T=312, dk=64
    with dropout 0.1: a sharp softmax (qu and qv at 3x: logits of standard
    deviation ~4, where plain TF32 products would miss the float32
    tolerances), and a batch row whose keys are all masked (scores all
    -1e30: each query averages v over all T keys, as the plain version
    does, and the masked scores pass no gradient)."""
    b, h, t, dk = 2, 4, 312, 64
    for dtype in (torch.float32, torch.bfloat16):
        mk = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(dtype)  # noqa: E731
        inputs = [mk(b, h, t, dk) for _ in range(4)] + [mk(h, 2 * t - 1, dk)]
        dout = mk(b, h, t, dk)
        none = torch.tensor([[1] * t, [0] * t], dtype=torch.int32, device="cuda")
        check_rel_grads(ra, dtype, inputs, none, dout, 0.125, 99, 0.1, "batch row 1 all masked")
        if dtype == torch.float32:
            inputs = [inputs[0] * 3, inputs[1] * 3] + inputs[2:]
            full = torch.ones(b, t, dtype=torch.int32, device="cuda")
            check_rel_grads(ra, dtype, inputs, full, dout, 0.125, 99, 0.1, "logits x3")


def check_dwconv_train(dc, dtype, k_size, gen, card, shape=DW_SHAPE):
    """Training shape [64, 312, 256] x [K, 256] (train-ebf's cgMLP:
    [64, 312, 512] x [31, 512]): the backward against the plain VJP, and
    the forward; the library yardstick of the backward is autograd's
    backward of F.conv1d(groups=C) (timed only)."""
    b, t, c = shape
    x, dy = (torch.randn(b, t, c, generator=gen, device="cuda").to(dtype) for _ in range(2))
    w = torch.randn(k_size, c, generator=gen, device="cuda").to(dtype)
    dx, dw = dc.depthwise_conv1d_bwd(x, w, dy)
    dx2, dw2 = dc.depthwise_conv1d_bwd(x, w, dy)
    ref_dx, ref_dw = dc.depthwise_conv1d_bwd_plain(x, w, dy)
    y, ref_y = dc.depthwise_conv1d(x, w), dc.depthwise_conv1d_plain(x, w)
    torch.cuda.synchronize()
    # dw is summed from per-slab partials in a fixed order (no atomics)
    if not (torch.equal(dx, dx2) and torch.equal(dw, dw2)):
        raise AssertionError(f"depthwise bwd {dtype} K={k_size}: a repeat call differs")
    errs = {"dx": max_err(dx, ref_dx), "dw": max_err(dw, ref_dw)}
    for name, ref in (("dx", ref_dx), ("dw", ref_dw)):
        if not errs[name] <= grad_tol(ref, dtype):
            raise AssertionError(f"depthwise bwd {dtype} K={k_size}: {name} {errs[name]} > "
                                 f"{grad_tol(ref, dtype)}")
    fwd_err = max_err(y, ref_y)
    fwd_tol = 1e-4 if dtype == torch.float32 else 5e-2
    if not fwd_err <= fwd_tol:
        raise AssertionError(f"depthwise fwd {dtype} K={k_size}: {fwd_err} > {fwd_tol}")
    xt = x.transpose(1, 2).detach().requires_grad_(True)
    wt = w.t()[:, None, :].detach().requires_grad_(True)
    yt = torch.nn.functional.conv1d(xt, wt, groups=c, padding="same")
    dyt = dy.transpose(1, 2)
    lib = lambda: torch.autograd.grad(yt, (xt, wt), dyt, retain_graph=True)  # noqa: E731
    lib_dx, lib_dw = lib()
    if max_err(lib_dx.transpose(1, 2), ref_dx) > 10 * grad_tol(ref_dx, dtype):
        raise AssertionError("library yardstick computes another backward")
    item = dtype.itemsize
    bwd_bound, bwd_by = bound_ms(item * (3 * b * t * c + k_size * c) + 4 * k_size * c,
                                 4.0 * b * t * c * k_size, dtype)
    fwd_bound, fwd_by = bound_ms(item * (2 * b * t * c + k_size * c),
                                 2.0 * b * t * c * k_size, dtype)
    xf, wf = x.transpose(1, 2), w.t()[:, None, :]
    lib_fwd = lambda: torch.nn.functional.conv1d(xf, wf, groups=c, padding="same")  # noqa: E731
    # the kernels and F.conv1d run for less time than a call from Python
    # takes, so they are timed by CUDA graph (back-to-back launches between
    # events would time the host); the plain versions and autograd's
    # backward by CUDA events
    fwd_r = dict(err=fwd_err, ms=graph_time_ms(lambda: dc.depthwise_conv1d(x, w)),
                 plain_ms=event_time_ms(lambda: dc.depthwise_conv1d_plain(x, w)),
                 library_ms=graph_time_ms(lib_fwd), bound_ms=fwd_bound, bound_by=fwd_by)
    bwd_r = dict(err=max(errs.values()), errs=errs,
                 ms=graph_time_ms(lambda: dc.depthwise_conv1d_bwd(x, w, dy)),
                 plain_ms=event_time_ms(lambda: dc.depthwise_conv1d_bwd_plain(x, w, dy)),
                 library_ms=event_time_ms(lib), bound_ms=bwd_bound, bound_by=bwd_by)
    print(f"[kernels] dwconv1d train [{b},{t},{c}] K={k_size} {str(dtype)[6:]}: forward "
          f"{fwd_r['ms'] * 1e3:.2f} us against F.conv1d's {fwd_r['library_ms'] * 1e3:.2f} us "
          f"({fwd_r['ms'] / fwd_r['library_ms']:.2f}x), backward {bwd_r['ms'] * 1e3:.2f} us "
          f"against autograd's {bwd_r['library_ms'] * 1e3:.2f} us "
          f"({bwd_r['ms'] / bwd_r['library_ms']:.2f}x; dw from {dc.dw_slabs(x, k_size)} slabs "
          f"a batch row, bitwise repeatable) [{card}]")
    return fwd_r, bwd_r


def flash_fwd_tol(ref: torch.Tensor) -> float:
    """float32: 2e-5 of the largest output, the order of the sums over up to
    1874 keys; bfloat16: one unit in the last place, as the rel-attention
    checks."""
    scale = ref.float().abs().max().item()
    return (2e-5 if ref.dtype == torch.float32 else 2.0 ** -7) * scale + 1e-5


def flash_flops(q, valid) -> dict:
    """Operations of the three entry points over the pairs of valid frames
    only (a masked key or a pad query row costs nothing): per pair and head
    4*dk FLOPs forward (scores, P.v), 8*dk dK/dV (scores, dP, dV, dK), 6*dk
    dQ (scores, dP, dQ)."""
    b, h, t, dk = q.shape
    n = valid.sum(dim=1).double()
    pairs = h * float((n * n).sum().item())
    return {"flash_attention_fwd": 4.0 * dk * pairs, "flash_attention_bwd_dkv": 8.0 * dk * pairs,
            "flash_attention_bwd_dq": 6.0 * dk * pairs}


def flash_bounds(q, valid, with_lse: bool = True) -> dict:
    """Bounds of the three entry points on these inputs: each [B, H, T, dk]
    operand read or written once, lse and delta float32 [B, H, T], the int32
    mask; the operations of :func:`flash_flops`, all matrix products."""
    b, h, t, dk = q.shape
    flops = flash_flops(q, valid)
    slab, rows, mask = q.dtype.itemsize * b * h * t * dk, 4 * b * h * t, 4 * b * t
    n_bytes = {"flash_attention_fwd": 4 * slab + rows * with_lse + mask,
               "flash_attention_bwd_dkv": 6 * slab + 2 * rows + mask,
               "flash_attention_bwd_dq": 5 * slab + 2 * rows + mask}
    return {name: bound_ms(n_bytes[name], flops[name], q.dtype, products=True)
            for name in flops}


FLASH_LIBRARY = "jax/experimental/pallas/ops/tpu/flash_attention.py"
# the JAX transducer's LSTM: flax's nn.RNN over OptimizedLSTMCell
LSTM_SCAN = "llm_guided_asr_tpu/models/transducer.py:104"

# the library yardsticks are checked only to compute the same function (a
# lost mask or scale is an O(1) error), not to any kernel's tolerance: their
# float32 may run on TF32 tensor cores
LIBRARY_RTOL = 5e-2


def sdpa(q, k, v, valid, sm):
    """The library yardstick (timed only, never on the port's path):
    F.scaled_dot_product_attention with the same key mask; it computes the
    same function on the valid query rows (it does not zero the pad rows)."""
    mask = valid.bool()[:, None, None, :]
    return torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=sm)


def check_flash_lse(lse, q, k, valid, sm):
    """The kernel's log-sum-exp against the plain float32 logsumexp over the
    valid keys (0 at pad query rows), at 1e-5 absolute + 1e-5 relative."""
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm
    scores = scores.masked_fill(~valid.bool()[:, None, None, :], -math.inf)
    ref = torch.where(valid.bool()[:, None, :], torch.logsumexp(scores, -1), 0.0)
    torch.testing.assert_close(lse, ref, rtol=1e-5, atol=1e-5)


def check_flash_attention(fa, dtype, gen, card):
    """Serving shape [1, 4, 1874, 64] (the 60 s request), no gradient: all
    frames valid (B=1 serving) and 469 pads (the 45 s request's frames in a
    60 s wide batch), the pad query rows exactly 0.  Timed with all frames
    valid, as the serving path calls it."""
    b, h, t, dk = FLASH_SERVE
    q, k, v = (torch.randn(b, h, t, dk, generator=gen, device="cuda").to(dtype) for _ in range(3))
    sm = 1.0 / math.sqrt(dk)
    errs = []
    for n_valid in (1405, t):  # the last, all frames valid, is timed
        valid = (torch.arange(t, device="cuda")[None] < n_valid).to(torch.int32)
        out = fa.flash_attention(q, k, v, valid, sm)
        (out2, lse), (out3, lse3) = (fa.flash_attention_fwd(q, k, v, valid, sm) for _ in range(2))
        ref = fa.flash_attention_plain(q, k, v, valid, sm)
        torch.cuda.synchronize()
        err, tol = max_err(out, ref), flash_fwd_tol(ref)
        if not err <= tol or not torch.all(out[:, :, n_valid:] == 0):
            raise AssertionError(f"flash_attention {dtype} {n_valid} valid: {err} > {tol}, or a "
                                 "pad query row is not 0")
        if not (torch.equal(out, out2) and torch.equal(out2, out3) and torch.equal(lse, lse3)):
            raise AssertionError(f"flash_attention_fwd {dtype} {n_valid} valid: a repeat call "
                                 "differs")
        check_flash_lse(lse, q, k, valid, sm)
        errs.append((err, tol))
    lib = lambda: sdpa(q, k, v, valid, sm)  # noqa: E731
    lib_err = max_err(lib(), ref) / ref.float().abs().max().item()
    if lib_err > LIBRARY_RTOL:
        raise AssertionError(f"library yardstick computes another function ({lib_err})")
    bms, by = flash_bounds(q, valid, with_lse=False)["flash_attention_fwd"]
    err, tol = max(errs)
    r = dict(
        err=err, tol=tol, ms=graph_time_ms(lambda: fa.flash_attention(q, k, v, valid, sm)),
        plain_ms=graph_time_ms(lambda: fa.flash_attention_plain(q, k, v, valid, sm), launches=5),
        library_ms=event_time_ms(lib), bound_ms=bms, bound_by=by,
    )
    rate = flash_flops(q, valid)["flash_attention_fwd"] / (r["ms"] * 1e9)
    print(f"[kernels] flash_attention_fwd serve [{b},{h},{t},{dk}] {str(dtype)[6:]} all frames: "
          f"{r['ms'] * 1e3:.2f} us ({rate:.1f} TFLOP/s, {fa.key_splits(q)} key splits) against "
          f"SDPA's {r['library_ms'] * 1e3:.2f} us ({r['ms'] / r['library_ms']:.2f}x) [{card}]")
    return r


def check_flash_attention_train(fa, dtype, gen, card):
    """Training shape [8, 4, 1874, 64] (train-flash: 8 x 60 s): the forward
    and both backward kernels under autograd against autograd through the
    plain version, all frames valid and ragged (lengths 1874 down to 400:
    pad query rows exactly 0 in out and dq, masked keys exactly 0 in dk and
    dv), and each backward entry point called twice on the same inputs,
    bitwise equal (one owner per output element, no atomics).  Timed with
    all frames valid, as train-flash calls them, each entry point alone; the
    plain backward's time is all three gradients with the forward
    recomputed, the library's the autograd backward of
    F.scaled_dot_product_attention (dq, dk, dv), printed beside the pair."""
    b, h, t, dk = FLASH_TRAIN
    mk = lambda: torch.randn(b, h, t, dk, generator=gen, device="cuda").to(dtype)  # noqa: E731
    q, k, v, dout = mk(), mk(), mk(), mk()
    sm = 1.0 / math.sqrt(dk)
    full = torch.ones(b, t, dtype=torch.int32, device="cuda")
    lengths = torch.linspace(t, 400, b, device="cuda").long()
    ragged = (torch.arange(t, device="cuda")[None] < lengths[:, None]).to(torch.int32)
    errs = dict.fromkeys(("out", "dq", "dk", "dv"), 0.0)
    for valid_name, valid in (("ragged", ragged), ("all", full)):
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out = fa.flash_attention(*leaves, valid, sm)
        grads = torch.autograd.grad(out, leaves, dout)
        ref = fa.flash_attention_plain(q, k, v, valid, sm)
        refs = fa.flash_attention_bwd_plain(q, k, v, valid, dout, sm)
        torch.cuda.synchronize()
        pads = ~valid.bool()[:, None, :, None].expand_as(q)
        if not all(torch.all(x[pads] == 0) for x in (out, *grads)):
            raise AssertionError(f"flash_attention {dtype}: a pad query row is not 0 in out "
                                 "or dq, or a masked key's dk or dv is not 0")
        parts = [("out", out, ref, flash_fwd_tol(ref))]
        parts += [(n, g, r, grad_tol(r, dtype)) for n, g, r in zip(("dq", "dk", "dv"), grads, refs)]
        line = []
        for name, got, want, tol in parts:
            err = max_err(got, want)
            if not err <= tol:
                raise AssertionError(f"flash_attention {dtype} frames {valid_name}: {name} error "
                                     f"{err} > {tol}")
            errs[name] = max(errs[name], err)
            line.append(f"{name} {err:.2e}/{tol:.1e}")
        print(f"[kernels] flash_attention train {str(dtype)[6:]} frames {valid_name}: "
              "max_abs_err/tol " + ", ".join(line))
        del leaves, out, grads
        out, lse = fa.flash_attention_fwd(q, k, v, valid, sm)
        out2, lse2 = fa.flash_attention_fwd(q, k, v, valid, sm)
        torch.cuda.synchronize()
        if not (torch.equal(out, out2) and torch.equal(lse, lse2)):
            raise AssertionError(f"flash_attention_fwd {dtype} frames {valid_name}: a repeat call "
                                 "differs")
        check_flash_lse(lse, q, k, valid, sm)
        del out2, lse2
        delta = (out.float() * dout.float()).sum(dim=-1)
        for name, fn in (("flash_attention_bwd_dkv", fa.flash_attention_bwd_dkv),
                         ("flash_attention_bwd_dq", fa.flash_attention_bwd_dq)):
            first, second = (fn(q, k, v, valid, dout, lse, delta, sm) for _ in range(2))
            torch.cuda.synchronize()
            if not all(map(torch.equal, first, second) if isinstance(first, tuple)
                       else [torch.equal(first, second)]):
                raise AssertionError(f"{name} {dtype} frames {valid_name}: a repeat call differs")
        del out, lse, delta
    # the yardsticks compute the same function (all frames valid here)
    lq = [x.clone().requires_grad_(True) for x in (q, k, v)]
    y = sdpa(*lq, full, sm)
    lib_fwd = lambda: sdpa(q, k, v, full, sm)  # noqa: E731
    lib_bwd = lambda: torch.autograd.grad(y, lq, dout, retain_graph=True)  # noqa: E731
    lib_err = max(max_err(g, r) / r.float().abs().max().item()
                  for g, r in zip((y, *lib_bwd()), (ref, *refs)))
    if lib_err > LIBRARY_RTOL:
        raise AssertionError(f"library yardstick computes another function ({lib_err})")
    del ref, refs
    out, lse = fa.flash_attention_fwd(q, k, v, full, sm)
    delta = (out.float() * dout.float()).sum(dim=-1)
    bounds = flash_bounds(q, full)
    plain_bwd_ms = event_time_ms(lambda: fa.flash_attention_bwd_plain(q, k, v, full, dout, sm),
                                 iters=5)
    lib_bwd_ms = event_time_ms(lib_bwd, iters=5)
    timed = {
        "flash_attention_fwd": (lambda: fa.flash_attention_fwd(q, k, v, full, sm),
                                event_time_ms(lambda: fa.flash_attention_plain(q, k, v, full, sm)),
                                event_time_ms(lib_fwd), errs["out"]),
        "flash_attention_bwd_dkv": (
            lambda: fa.flash_attention_bwd_dkv(q, k, v, full, dout, lse, delta, sm),
            plain_bwd_ms, lib_bwd_ms, max(errs["dk"], errs["dv"])),
        "flash_attention_bwd_dq": (
            lambda: fa.flash_attention_bwd_dq(q, k, v, full, dout, lse, delta, sm),
            plain_bwd_ms, lib_bwd_ms, errs["dq"]),
    }
    results = {}
    for name, (fn, plain_ms, lib_ms, err) in timed.items():
        bms, by = bounds[name]
        results[name] = dict(err=err, errs=errs, ms=event_time_ms(fn), plain_ms=plain_ms,
                             library_ms=lib_ms, bound_ms=bms, bound_by=by)
    flops = flash_flops(q, full)
    rate = {n: flops[n] / (results[n]["ms"] * 1e9) for n in flops}  # TFLOP/s
    pair = results["flash_attention_bwd_dkv"]["ms"] + results["flash_attention_bwd_dq"]["ms"]
    print(f"[kernels] flash_attention backward {str(dtype)[6:]} [{b},{h},{t},{dk}] all frames: "
          f"dK/dV {results['flash_attention_bwd_dkv']['ms'] * 1e3:.2f} us "
          f"({rate['flash_attention_bwd_dkv']:.1f} TFLOP/s), dQ "
          f"{results['flash_attention_bwd_dq']['ms'] * 1e3:.2f} us "
          f"({rate['flash_attention_bwd_dq']:.1f} TFLOP/s); pair {pair * 1e3:.2f} us against "
          f"SDPA's autograd backward {lib_bwd_ms * 1e3:.2f} us ({pair / lib_bwd_ms:.2f}x) [{card}]")
    fwd = results["flash_attention_fwd"]
    print(f"[kernels] flash_attention_fwd train {str(dtype)[6:]} [{b},{h},{t},{dk}] all frames: "
          f"{fwd['ms'] * 1e3:.2f} us ({rate['flash_attention_fwd']:.1f} TFLOP/s) against SDPA's "
          f"{fwd['library_ms'] * 1e3:.2f} us ({fwd['ms'] / fwd['library_ms']:.2f}x) [{card}]")
    return results


def wkv_inputs(gen, b, t, c, k_scale=1.0):
    w = -torch.exp(0.5 * torch.randn(c, generator=gen, device="cuda"))
    u = 0.5 * torch.randn(c, generator=gen, device="cuda")
    k = k_scale * torch.randn(b, t, c, generator=gen, device="cuda")
    v = torch.randn(b, t, c, generator=gen, device="cuda")
    return w, u, k, v


def wkv_close(got, want) -> float:
    """Max abs error, after checking |got - want| <= 1e-5 + 1e-5 |want|
    elementwise (float32: the same formula with expf and IEEE division;
    only the kernel's fused multiply-adds round differently)."""
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    return max_err(got, want)


def wkv_fwd_bound(b, t, c):
    """k, v in and y out, w and u, the state in and out; 20 operations per
    (b, t, c) step (four exponentials and a division counted as one each)."""
    return bound_ms(4 * (3 * b * t * c + 2 * c + 6 * b * c), 20.0 * b * t * c, torch.float32)


def check_wkv_repeat(wk, w, u, k, v, state, first, what):
    """A repeat call of the chunked forward is bitwise equal (the chunk
    summaries are folded in a fixed order, no atomics)."""
    y2, st2 = wk.wkv_fwd(w, u, k, v, state)
    torch.cuda.synchronize()
    if not (torch.equal(first[0], y2) and all(map(torch.equal, first[1], st2))):
        raise AssertionError(f"wkv_fwd {what}: a repeat call is not bitwise equal")


def wkv_bwd_bound(b, t, c):
    """k, v, y, gy in, gk and gv out, w and u in, gw and gu out; 50
    operations per (b, t, c) for the two sweeps (exponentials and the
    division counted as one each)."""
    return bound_ms(4 * (6 * b * t * c + 4 * c), 50.0 * b * t * c, torch.float32)


def check_wkv_bwd(wk, w, u, k, v, y, gy, what) -> dict:
    """The backward against autograd through the plain loop, each gradient
    within 1e-4 of its largest reference value (float32: the kernel sums
    over T in another order, across chunks through the fold of their
    summaries, and gw, gu over the batch in a fixed order of per-(b, chunk)
    partials); a repeat call bitwise equal (no atomics)."""
    grads = wk.wkv_bwd(w, u, k, v, y, gy)
    again = wk.wkv_bwd(w, u, k, v, y, gy)
    refs = wk.wkv_bwd_plain(w, u, k, v, gy)
    torch.cuda.synchronize()
    if not all(map(torch.equal, grads, again)):
        raise AssertionError(f"wkv_bwd {what}: a repeat call is not bitwise equal")
    gerrs = {}
    for name, g, r in zip(("gw", "gu", "gk", "gv"), grads, refs):
        tol = 1e-4 * r.abs().max().item() + 1e-6
        gerrs[name] = max_err(g, r)
        if not gerrs[name] <= tol:
            raise AssertionError(f"wkv_bwd {what} {name}: {gerrs[name]} > {tol}")
    return gerrs


def check_wkv(wk, gen, card):
    """The forward at the serving and training shapes (each call repeated
    and bitwise equal; the chunk count printed beside the time), with
    |k| ~ 30 and a state chained across two calls; the backward at the
    training shape and at the labels of ~40 s of audio [16, 101, 512]
    (chunked), with |k| ~ 30 at the latter, against autograd through the
    plain loop (the plain backward's time includes the forward it
    recomputes), each call repeated and bitwise equal."""
    results = {}
    for shape, (b, t, c) in WKV_SERVE.items():
        w, u, k, v = wkv_inputs(gen, b, t, c)
        state = wk.wkv_init_state(b, c, "cuda")
        y, st = wk.wkv_fwd(w, u, k, v, state)
        ref_y, ref_st = wk.wkv_scan(w, u, k, v, state)
        torch.cuda.synchronize()
        err = max([wkv_close(y, ref_y)] + [wkv_close(a, r) for a, r in zip(st, ref_st)])
        check_wkv_repeat(wk, w, u, k, v, state, (y, st), shape)
        bms, by = wkv_fwd_bound(b, t, c)
        results[shape] = dict(
            err=err, ms=graph_time_ms(lambda: wk.wkv_fwd(w, u, k, v, state)),
            plain_ms=graph_time_ms(lambda: wk.wkv_scan(w, u, k, v, state), launches=2, replays=3),
            library_ms=None, bound_ms=bms, bound_by=by)
        print(f"[kernels] wkv_fwd {shape}: {results[shape]['ms'] * 1e3:.2f} us with "
              f"{wk.chunks(k)} chunks, bitwise repeatable [{card}]")
    b, t, c = WKV_TRAIN
    w, u, k, v = wkv_inputs(gen, b, t, c)
    y, st = wk.wkv_fwd(w, u, k, v)
    check_wkv_repeat(wk, w, u, k, v, None, (y, st), f"train [{b},{t},{c}]")
    errs = {"y": wkv_close(y, wk.wkv_scan(w, u, k, v)[0])}
    wb, ub, kb, vb = wkv_inputs(gen, 3, 40, 100, k_scale=30.0)  # the running max carries it
    yb, stb = wk.wkv_fwd(wb, ub, kb, vb)
    ref_yb, ref_stb = wk.wkv_scan(wb, ub, kb, vb)
    errs["large_k"] = max([wkv_close(yb, ref_yb)] + [wkv_close(a, r) for a, r in zip(stb, ref_stb)])
    y1, st1 = wk.wkv_fwd(w, u, k[:, :12], v[:, :12])  # a state chained across two calls
    y2, st2 = wk.wkv_fwd(w, u, k[:, 12:], v[:, 12:], st1)
    ref_y, ref_st = wk.wkv_scan(w, u, k, v)
    errs["chained"] = max([wkv_close(torch.cat([y1, y2], 1), ref_y)]
                          + [wkv_close(a, r) for a, r in zip(st2, ref_st)])
    gy = torch.randn(b, t, c, generator=gen, device="cuda")
    gerrs = check_wkv_bwd(wk, w, u, k, v, y, gy, "train [16,25,512]")
    wl, ul, kl, vl = wkv_inputs(gen, *WKV_BWD_LONG, k_scale=30.0)  # |k| up to ~100
    gerrs_large = check_wkv_bwd(wk, wl, ul, kl, vl, wk.wkv_fwd(wl, ul, kl, vl)[0],
                                torch.randn_like(kl), "large k [16,101,512]")
    wl, ul, kl, vl = wkv_inputs(gen, *WKV_BWD_LONG)
    yl, gyl = wk.wkv_fwd(wl, ul, kl, vl)[0], torch.randn_like(kl)
    gerrs_long = check_wkv_bwd(wk, wl, ul, kl, vl, yl, gyl, "[16,101,512]")
    print("[kernels] wkv_fwd max_abs_err " + ", ".join(f"{n} {e:.2e}" for n, e in errs.items())
          + "; wkv_bwd max_abs_err " + ", ".join(f"{n} {e:.2e}" for n, e in gerrs.items())
          + "; at [16,101,512] " + ", ".join(f"{n} {e:.2e}" for n, e in gerrs_long.items())
          + "; with |k| ~ 100 " + ", ".join(f"{n} {e:.2e}" for n, e in gerrs_large.items()))
    # the kernels at the training shape run for a few microseconds, less
    # than a launch from Python takes, so they too are timed by CUDA graph
    # (back-to-back launches between events would time the host); the
    # plain versions, thousands of launches each, by CUDA events
    bms, by = wkv_fwd_bound(b, t, c)
    results["train [16,25,512]"] = dict(
        err=max(errs.values()), ms=graph_time_ms(lambda: wk.wkv_fwd(w, u, k, v)),
        plain_ms=event_time_ms(lambda: wk.wkv_scan(w, u, k, v)), library_ms=None,
        bound_ms=bms, bound_by=by)
    print(f"[kernels] wkv_fwd train [{b},{t},{c}]: {results['train [16,25,512]']['ms'] * 1e3:.2f}"
          f" us with {wk.chunks(k)} chunks, bitwise repeatable [{card}]")
    for shape, args, gerr in (("bwd train [16,25,512]", (w, u, k, v, y, gy), gerrs),
                              ("bwd [16,101,512]", (wl, ul, kl, vl, yl, gyl), gerrs_long)):
        bms, by = wkv_bwd_bound(*args[2].shape)
        results[shape] = dict(
            err=max(gerr.values()), errs=gerr, chunks=wk.bwd_chunks(args[2]),
            ms=graph_time_ms(lambda: wk.wkv_bwd(*args)),
            plain_ms=event_time_ms(lambda: wk.wkv_bwd_plain(*args[:4], args[5]), iters=5),
            library_ms=None, bound_ms=bms, bound_by=by)
        print(f"[kernels] wkv_bwd {shape[4:]}: {results[shape]['ms'] * 1e3:.2f} us with "
              f"{results[shape]['chunks']} chunks, bitwise repeatable [{card}]")
    return results


def lstm_inputs(gen, b, t, h):
    xi = 0.5 * torch.randn(b, t, 4 * h, generator=gen, device="cuda")
    w = torch.randn(4 * h, h, generator=gen, device="cuda") / math.sqrt(h)
    bias = 0.1 * torch.randn(4 * h, generator=gen, device="cuda")
    return xi, w, bias


def lstm_bound(b, t, h, bwd=False):
    """Forward: xi, W_hh and the bias in, h out; backward: dy, the saved
    gates and cells and W_hh in, da out.  Operations: the [B, H] x [H, 4H]
    product of every step (2 x 4H x H a row) at the 3xTF32 rate of the
    kernels' tensor cores, and ~10 per gate element at the CUDA cores'."""
    elems = b * t * h
    n_bytes = 4 * ((9 if bwd else 5) * elems + 4 * h * h + (0 if bwd else 4 * h))
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = (8.0 * elems * h / F32_PRODUCT_FLOPS + 40.0 * elems / PEAK_FLOPS[torch.float32]) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def lstm_plan_text(lk, x, backward=False):
    """The launch plan of a call on x [B, L, ·] (ops/lstm.py launch_plan)."""
    b, t = x.shape[:2]
    h = x.shape[2] if backward else x.shape[2] // 4
    p = lk.plan_for(b, h, backward, x.device)
    return (f"{p.groups} cluster(s) of {p.cluster} CTAs x {p.rows} rows, {p.units} units a "
            f"CTA, W_hh {'read from L2' if p.streamed else 'in shared memory'}, "
            f"{p.smem_bytes} B of shared memory a CTA, "
            f"{lk.max_active_clusters(h, backward, x.device.index)} one-tile clusters "
            f"of this width fit the card at once")


def library_lstm(xi, w, bias):
    """The same function of xi by one cuDNN call: torch.lstm with W_ih the
    identity (timed as the yardstick only; the port never calls it)."""
    b, _, g4 = xi.shape
    h0 = xi.new_zeros(1, b, g4 // 4)
    eye = torch.eye(g4, device=xi.device)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="RNN module weights are not part")
        return torch.lstm(xi, (h0, h0), [eye, w, torch.zeros_like(bias), bias], True, 1, 0.0,
                          torch.is_grad_enabled(), False, True)[0]


def check_lstm(lk, gen, card):
    """The forward at phase 17's beam-5 shape and phase 18's training shape,
    and the backward at the latter, against the plain loop (the forward
    within 1e-5 abs + 1e-5 rel: float32, the products summed in another
    order; the backward's da and the autograd function's gradients of xi,
    W_hh and the bias within 1e-4 of their largest reference value),
    each call repeated and bitwise equal; timed by CUDA events beside the
    plain loop and cuDNN's torch.lstm of the same function."""
    results = {}
    for shape, (b, t, h) in (("serve beam-5 [5,201,256]", LSTM_SERVE),
                             ("train [16,25,256]", LSTM_TRAIN)):
        xi, w, bias = lstm_inputs(gen, b, t, h)
        lk.KERNEL.reset_launches()
        y = lk.lstm_fwd(xi, w, bias)[0]
        n_fwd = lk.KERNEL.launches["lstm_fwd"]
        again = lk.lstm_fwd(xi, w, bias)[0]
        ref = lk.lstm_recurrence_plain(xi, w, bias)
        lib = library_lstm(xi, w, bias)
        torch.cuda.synchronize()
        if not torch.equal(y, again):
            raise AssertionError(f"lstm_fwd {shape}: a repeat call is not bitwise equal")
        torch.testing.assert_close(y, ref, rtol=1e-5, atol=1e-5)
        bms, by = lstm_bound(b, t, h)
        results[("lstm_fwd", shape)] = dict(
            err=max_err(y, ref), ms=event_time_ms(lambda: lk.lstm_fwd(xi, w, bias)),
            plain_ms=event_time_ms(lambda: lk.lstm_recurrence_plain(xi, w, bias), iters=3),
            library_ms=event_time_ms(lambda: library_lstm(xi, w, bias)),
            bound_ms=bms, bound_by=by)
        print(f"[kernels] lstm_fwd {shape}: {n_fwd} launch(es) a call, "
              f"{lstm_plan_text(lk, xi)}; {results[('lstm_fwd', shape)]['ms'] * 1e3 / t:.3f} us "
              f"a step, bitwise repeatable; cuDNN's torch.lstm of the same function differs "
              f"by {max_err(lib, ref):.2e} [{card}]")
    b, t, h = LSTM_TRAIN
    xi, w, bias = lstm_inputs(gen, b, t, h)
    dy = torch.randn(b, t, h, generator=gen, device="cuda")
    _, gates, cells = lk.lstm_fwd(xi, w, bias, save=True)
    lk.KERNEL.reset_launches()
    da = lk.lstm_bwd(dy, gates, cells, w)
    n_bwd = lk.KERNEL.launches["lstm_bwd"]
    again = lk.lstm_bwd(dy, gates, cells, w)
    with torch.enable_grad():
        leaves = [x.clone().requires_grad_(True) for x in (xi, w, bias)]
        refs = torch.autograd.grad(lk.lstm_recurrence_plain(*leaves), leaves, dy)
        kern = [x.clone().requires_grad_(True) for x in (xi, w, bias)]
        grads = torch.autograd.grad(lk.lstm_recurrence(*kern), kern, dy)
        lib_in = [x.clone().requires_grad_(True) for x in (xi, w, bias)]
        lib_out = library_lstm(*lib_in)
    torch.cuda.synchronize()
    if not torch.equal(da, again):
        raise AssertionError("lstm_bwd: a repeat call is not bitwise equal")
    errs = {}
    for name, g, r in (("da", da, refs[0]), ("d_xi", grads[0], refs[0]),
                       ("d_w_hh", grads[1], refs[1]), ("d_bias", grads[2], refs[2])):
        errs[name] = max_err(g, r)
        tol = 1e-4 * r.abs().max().item() + 1e-6
        if not errs[name] <= tol:
            raise AssertionError(f"lstm_bwd {name}: {errs[name]} > {tol}")

    def plain_backward():
        with torch.enable_grad():
            leaves = [x.clone().requires_grad_(True) for x in (xi, w, bias)]
            torch.autograd.grad(lk.lstm_recurrence_plain(*leaves), leaves, dy)

    bms, by = lstm_bound(b, t, h, bwd=True)
    results[("lstm_bwd", "train [16,25,256]")] = dict(
        err=max(errs.values()), errs=errs,
        ms=event_time_ms(lambda: lk.lstm_bwd(dy, gates, cells, w)),
        plain_ms=event_time_ms(plain_backward, iters=3),
        library_ms=event_time_ms(lambda: torch.autograd.grad(lib_out, lib_in, dy,
                                                             retain_graph=True)),
        bound_ms=bms, bound_by=by)
    print("[kernels] lstm_bwd train [16,25,256] max_abs_err " + ", ".join(
        f"{n} {e:.2e}" for n, e in errs.items()) + f", bitwise repeatable; {n_bwd} launch(es) "
        f"a call, {lstm_plan_text(lk, dy, True)}; "
        f"{results[('lstm_bwd', 'train [16,25,256]')]['ms'] * 1e3 / t:.3f} us a step (plain: "
        f"autograd through the loop with its forward; library: cuDNN's backward alone) [{card}]")
    return results


def check_lstm_encoder(lk, gen, card):
    """The LSTM recurrence at the (VGG-)RNN encoders' shapes (phases 26-27:
    320 units over 312 frames after VGG2L, 1251 without it; W_hh in
    shared memory), at the LSTM LM's 650 units (W_hh read from L2) and at
    the multichannel mask estimator's 64 units over 1251 frames (phases
    31-32: B = 1 serving, B = MC_B training; both ways at both): the
    forward at the serving shapes, the forward and the backward at the
    training shapes (B = ENC_B, train-1's B = 64, the LM's 16), each
    against the plain loop at check_lstm's tolerances, repeated and bitwise
    equal, its launch count, cluster shape and microseconds a step printed;
    timed by CUDA events beside cuDNN's torch.lstm and the loop (one call of
    the loop, already warm from the check: a yardstick only)."""
    results = {}
    for b, t, h in LSTM_ENC_SERVE + LSTM_ENC_TRAIN + LSTM_WIDE + LSTM_MASK:
        shape = f"[{b},{t},{h}]"
        xi, w, bias = lstm_inputs(gen, b, t, h)
        lk.KERNEL.reset_launches()
        y = lk.lstm_fwd(xi, w, bias)[0]
        n_fwd = lk.KERNEL.launches["lstm_fwd"]
        again = lk.lstm_fwd(xi, w, bias)[0]
        ref = lk.lstm_recurrence_plain(xi, w, bias)
        torch.cuda.synchronize()
        if not torch.equal(y, again):
            raise AssertionError(f"lstm_fwd {shape}: a repeat call is not bitwise equal")
        torch.testing.assert_close(y, ref, rtol=1e-5, atol=1e-5)
        bms, by = lstm_bound(b, t, h)
        results[("lstm_fwd", shape)] = dict(
            err=max_err(y, ref), ms=event_time_ms(lambda: lk.lstm_fwd(xi, w, bias), iters=5),
            plain_ms=event_time_ms(lambda: lk.lstm_recurrence_plain(xi, w, bias), iters=1,
                                   warmup=0),
            library_ms=event_time_ms(lambda: library_lstm(xi, w, bias), iters=5),
            bound_ms=bms, bound_by=by, launches_per_call=n_fwd)
        print(f"[kernels] lstm_fwd {shape}: {n_fwd} launch(es) a call, "
              f"{lstm_plan_text(lk, xi)}; "
              f"{results[('lstm_fwd', shape)]['ms'] * 1e3 / t:.3f} us a step [{card}]")
        if (b, t, h) in LSTM_ENC_SERVE:
            continue
        dy = torch.randn(b, t, h, generator=gen, device="cuda")
        _, gates, cells = lk.lstm_fwd(xi, w, bias, save=True)
        lk.KERNEL.reset_launches()
        da = lk.lstm_bwd(dy, gates, cells, w)
        n_bwd = lk.KERNEL.launches["lstm_bwd"]
        with torch.enable_grad():
            leaves = [x.clone().requires_grad_(True) for x in (xi, w, bias)]
            refs = torch.autograd.grad(lk.lstm_recurrence_plain(*leaves), leaves, dy)
            lib_in = [x.clone().requires_grad_(True) for x in (xi, w, bias)]
            lib_out = library_lstm(*lib_in)
        torch.cuda.synchronize()
        if not torch.equal(da, lk.lstm_bwd(dy, gates, cells, w)):
            raise AssertionError(f"lstm_bwd {shape}: a repeat call is not bitwise equal")
        err = max_err(da, refs[0])
        tol = 1e-4 * refs[0].abs().max().item() + 1e-6
        if not err <= tol:
            raise AssertionError(f"lstm_bwd {shape}: da {err} > {tol}")

        def plain_backward():
            with torch.enable_grad():
                leaves = [x.clone().requires_grad_(True) for x in (xi, w, bias)]
                torch.autograd.grad(lk.lstm_recurrence_plain(*leaves), leaves, dy)

        bms, by = lstm_bound(b, t, h, bwd=True)
        results[("lstm_bwd", shape)] = dict(
            err=err, ms=event_time_ms(lambda: lk.lstm_bwd(dy, gates, cells, w), iters=5),
            plain_ms=event_time_ms(plain_backward, iters=1, warmup=0),
            library_ms=event_time_ms(lambda: torch.autograd.grad(lib_out, lib_in, dy,
                                                                 retain_graph=True), iters=5),
            bound_ms=bms, bound_by=by, launches_per_call=n_bwd)
        print(f"[kernels] lstm_bwd {shape}: {n_bwd} launch(es) a call, "
              f"{lstm_plan_text(lk, dy, True)}; "
              f"{results[('lstm_bwd', shape)]['ms'] * 1e3 / t:.3f} us a step, bitwise "
              f"repeatable [{card}]")
    return results


def check_multiconv_dwconv(dc, gen, card):
    """The depthwise kernels at the MultiConvformer's shapes (phases 26-27):
    K = 7 and 23 (compiled since this slice; the runtime-K path lost to
    autograd's backward at B = 64) on the 512-channel gate and the merge
    conv's K = 31 on 2048 channels, the forward at B = 1 and the
    forward and backward at B = ENC_B and train-1's B = 64, against the
    plain versions and beside F.conv1d (check_dwconv, check_dwconv_train)."""
    results = {}
    for k_size, c in MCF_DW:
        shape = f"[1,312,{c}] K={k_size}"
        results[("dwconv1d_fwd", shape)] = check_dwconv(dc, torch.float32, k_size, gen, card, c=c)
        for b in (ENC_B, 64):
            shape = f"[{b},312,{c}] K={k_size}"
            fwd_r, bwd_r = check_dwconv_train(dc, torch.float32, k_size, gen, card,
                                              shape=(b, 312, c))
            results[("dwconv1d_fwd", shape)] = fwd_r
            results[("dwconv1d_bwd", shape)] = bwd_r
    return results


def _print_timing(card, name, shape, dtype, r):
    lib = "none (no one PyTorch call)" if r["library_ms"] is None else \
        f"{r['library_ms'] * 1e3:.2f} us"
    print(f"[kernels] {name} {shape} {str(dtype)[6:]}: max_abs_err {r['err']:.3e}, kernel "
          f"{r['ms'] * 1e3:.2f} us, plain {r['plain_ms'] * 1e3:.2f} us, library {lib}, "
          f"bound {r['bound_ms'] * 1e3:.3f} us ({r['bound_by']}) [{card}]")


def phase_kernels(ra, dc, wk, fa, lk, card):
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    for (name, shape), r in check_lstm(lk, gen, card).items():
        _print_timing(card, name, shape, torch.float32, r)
        results[(name, shape, torch.float32)] = r
    # the rel-pos kernel at the long-form length, the yardstick beside the
    # flash forward at the same shape
    r = check_rel_attention(ra, torch.float32, gen, card, t=FLASH_T, n_masked=469,
                            plain_launches=5)
    _print_timing(card, "rel_attention_fwd", f"serve B=1 T={FLASH_T}", torch.float32, r)
    results[("rel_attention_fwd", f"serve B=1 T={FLASH_T}", torch.float32)] = r
    check_rel_attention_edges(ra, gen)
    for name, shape, r in (
            ("rel_attention_fwd", "serve-batch", check_rel_attention_batch(ra, gen, card)),
            ("dwconv1d_fwd", "serve-batch", check_dwconv(dc, torch.float32, 31, gen, card,
                                                         b=len(BATCH_LENS)))):
        _print_timing(card, name, f"serve-batch B={len(BATCH_LENS)} T={BATCH_T}", torch.float32, r)
        results[(name, shape, torch.float32)] = r
    r = check_dwconv(dc, torch.float32, STREAM_KERNEL, gen, card, t=STREAM_BLOCK)
    _print_timing(card, "dwconv1d_fwd", STREAM_DW_SHAPE, torch.float32, r)
    results[("dwconv1d_fwd", STREAM_DW_SHAPE, torch.float32)] = r
    # the E-Branchformer cgMLP's channels (linear_units / 2 = 512), serve-ebf
    # and train-ebf
    cases = [("dwconv1d_fwd", CGMLP_SERVE, check_dwconv(dc, torch.float32, EBF_KERNEL, gen, card,
                                                         c=CGMLP_C))]
    fwd_r, bwd_r = check_dwconv_train(dc, torch.float32, EBF_KERNEL, gen, card, shape=CGMLP_TRAIN)
    cases += [("dwconv1d_fwd", CGMLP_TRAIN_SHAPE, fwd_r),
              ("dwconv1d_bwd", CGMLP_TRAIN_SHAPE, bwd_r)]
    for name, shape, r in cases:
        _print_timing(card, name, shape, torch.float32, r)
        results[(name, shape, torch.float32)] = r
    # the MultiConvformer's depthwise convs and the RNN encoders' LSTM
    # recurrence (phases 26-27), and the recurrence at the LSTM LM's width
    for (name, shape), r in {**check_multiconv_dwconv(dc, gen, card),
                             **check_lstm_encoder(lk, gen, card),
                             **check_ssl_shapes(ra, dc, gen, card)}.items():
        _print_timing(card, name, shape, torch.float32, r)
        results[(name, shape, torch.float32)] = r
    torch.cuda.empty_cache()
    for shape, r in check_wkv(wk, gen, card).items():
        name = "wkv_bwd" if shape.startswith("bwd") else "wkv_fwd"
        shape = shape.removeprefix("bwd ")
        _print_timing(card, name, shape, torch.float32, r)
        results[(name, shape, torch.float32)] = r
    for dtype in (torch.float32, torch.bfloat16):
        cases = [("rel_attention_fwd", "serve B=1 T=312", check_rel_attention(ra, dtype, gen, card))]
        for k_size in (31, 8):
            cases.append(("dwconv1d_fwd", f"serve [1,312,256] K={k_size}",
                          check_dwconv(dc, dtype, k_size, gen, card)))
        fwd_r, bwd_r = check_rel_attention_train(ra, dtype, gen, card)
        cases += [("rel_attention_fwd", "train B=64 T=312 dropout 0.1", fwd_r),
                  ("rel_attention_bwd", "train B=64 T=312 dropout 0.1", bwd_r)]
        for k_size in (31, 8):
            fwd_r, bwd_r = check_dwconv_train(dc, dtype, k_size, gen, card)
            cases += [("dwconv1d_fwd", f"train [64,312,256] K={k_size}", fwd_r),
                      ("dwconv1d_bwd", f"train [64,312,256] K={k_size}", bwd_r)]
        cases.append(("flash_attention_fwd", f"serve [1,4,{FLASH_T},64]",
                      check_flash_attention(fa, dtype, gen, card)))
        for name, r in check_flash_attention_train(fa, dtype, gen, card).items():
            cases.append((name, f"train [{FLASH_B},4,{FLASH_T},64]", r))
        for name, shape, r in cases:
            _print_timing(card, name, shape, dtype, r)
            results.setdefault((name, shape, dtype), r)
        torch.cuda.empty_cache()
    return results


def serve_parts() -> dict:
    """Phase 3's model parts (bench.py:447-512): the Llama-3.2-1B dims, the
    prompt template's ids, the Conformer 12x256 and the 6x256 guided
    decoder."""
    from llm_guided_asr_tpu_torch.models.conformer import ConformerConfig
    from llm_guided_asr_tpu_torch.models.llm.llama import LlamaConfig
    from llm_guided_asr_tpu_torch.models.llm.prompt import PromptTemplate
    from llm_guided_asr_tpu_torch.models.transformer_decoder import TransformerDecoderConfig
    from llm_guided_asr_tpu_torch.ops.frontend import FrontendConfig

    # meta-llama/Llama-3.2-1B dims (HF config.json)
    llm = LlamaConfig(
        vocab_size=128256, hidden_size=2048, intermediate_size=8192, num_hidden_layers=16,
        num_attention_heads=32, num_key_value_heads=8, rms_norm_eps=1e-5,
        rope_theta=500000.0, max_position_embeddings=131072, tie_word_embeddings=True,
        rope_scaling_factor=32.0, rope_low_freq_factor=1.0, rope_high_freq_factor=4.0,
        rope_original_max_position=8192,
    )
    return dict(
        vocab_size=llm.vocab_size, llm=llm,
        prompt=PromptTemplate(prefix_ids=tuple(range(2, 50)), suffix_ids=tuple(range(50, 66)),
                              start_of_response_id=70, end_of_response_id=70, pad_id=0),
        frontend=FrontendConfig(), normalize="utterance_mvn",
        encoder=ConformerConfig(output_size=256, attention_heads=4, linear_units=1024,
                                num_blocks=12, macaron_style=True, use_cnn_module=True,
                                cnn_module_kernel=31),
        decoder=TransformerDecoderConfig(attention_heads=4, linear_units=2048, num_blocks=6),
    )


def build_model():
    from llm_guided_asr_tpu_torch.convert import init_weights
    from llm_guided_asr_tpu_torch.models.llm_guided import LLMGuidedASRConfig, LLMGuidedASRModel

    cfg = LLMGuidedASRConfig(ctc_weight=0.3, **serve_parts())
    model = LLMGuidedASRModel(cfg, llm_dtype=torch.bfloat16, device="cuda")
    return init_weights(model, seed=0).eval()


def encoder_frames(model, waves) -> list:
    """Each request's encoder frames T' (outside any counted run)."""
    with torch.inference_mode():
        return [int(model.encode(torch.from_numpy(w[None]).cuda(),
                                 torch.tensor([w.shape[0]], device="cuda"))[1][0]) for w in waves]


def phase_serve(model, kernels, card, tag="serve", seconds=REQUEST_SECONDS, encoder_fwd=ENCODER_FWD,
                rounds=ROUNDS, encoder_tol=1e-3, check=None):
    """Serve every request ``rounds`` times, after one warm-up at each
    length; returns the launch counts, the waveforms and the first length's
    median latency.  The guided model (phase 3), the flash ASRModel
    (phase 9) and the decoders of phase 24 take the same beam-10 search and
    the same checks."""
    from llm_guided_asr_tpu_torch.bin.asr_inference import Speech2Text

    s2t = Speech2Text.from_model(model, ctc_weight=0.3, beam_size=10, maxlenratio=-24.0)
    waves = request_waves(seconds)
    frames = encoder_frames(model, waves)
    print(f"[{tag}] encoder frames T' of the " + ", ".join(f"{s:.1f}" for s in seconds)
          + " s requests: " + ", ".join(map(str, frames)))
    # one warm-up request at each length, so that the timed ones pay for no
    # first use of a cuBLAS/cuDNN path or allocator growth at their shapes;
    # the launch counts start after them
    for sec, wave in zip(seconds, waves):
        t0 = time.perf_counter()
        s2t(wave)
        torch.cuda.synchronize()
        print(f"[{tag}] warm-up request, {sec:.1f} s audio: "
              f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)
    lat = {sec: [] for sec in seconds}
    hyps = []
    for _ in range(rounds):
        for sec, wave in zip(seconds, waves):
            t0 = time.perf_counter()
            (ids, hyp), = s2t(wave)
            torch.cuda.synchronize()
            lat[sec].append(time.perf_counter() - t0)
            hyps.append((ids, hyp))
    launches = counts(kernels)
    peak = torch.cuda.max_memory_allocated()

    n_requests = len(hyps)
    for sec in seconds:
        ms = sorted(x * 1e3 for x in lat[sec])
        med = float(np.median(ms))
        print(f"[{tag}] {sec:.1f} s audio, {len(ms)} runs: latency median {med:.1f} ms "
              f"(min {ms[0]:.1f}, max {ms[-1]:.1f}), RTFx at the median {sec / med * 1e3:.2f} "
              f"[{card}]")
    for sec, (ids, hyp) in zip(seconds, hyps):
        print(f"[{tag}] {sec:.1f} s audio: hyp {len(ids)} tokens, score {hyp.score:.4f} "
              f"{hyp.scores}")
    for ids, hyp in hyps:
        if not all(0 <= i < model.cfg.vocab_size for i in ids):
            raise AssertionError(f"bad hypothesis: {hyp}")
        check_scores(hyp)
    for i, (ids, _) in enumerate(hyps):
        if ids != hyps[i % len(seconds)][0]:
            raise AssertionError("the same request gave different hypotheses across rounds")
    n_blocks = model.cfg.encoder.num_blocks
    print(f"[{tag}] kernel launches over {n_requests} requests: {launches}")
    for name, n in launches.items():
        want = n_blocks * n_requests if name in encoder_fwd else 0
        if n != want:
            raise AssertionError(f"{name}: {n} launches, expected {want}")
    print(f"[{tag}] torch.cuda.max_memory_allocated: {peak} bytes ({peak / 2**30:.2f} GiB)")

    (check or check_encoder_on_cpu)(tag, model, waves[-1], seconds[-1], encoder_tol)
    return launches, waves, float(np.median(lat[seconds[0]]))


def check_encoder_on_cpu(tag, model, wave, sec, tol=1e-3):
    """The card's encoder (CUDA kernels) against the plain path on the CPU
    (the model's frontend and utterance MVN, then a CPU copy of its
    encoder): max_abs_err within ``tol``."""
    import copy

    from llm_guided_asr_tpu_torch.ops.frontend import default_frontend, utterance_mvn

    speech, n = torch.from_numpy(wave[None]), torch.tensor([wave.shape[0]])
    with torch.inference_mode():
        enc_gpu, lens_gpu = model.encode(speech.cuda(), n.cuda())
        cpu_model = copy.deepcopy(model.encoder).cpu()
        feats, flens = default_frontend(speech, n)
        enc_cpu, lens_cpu = cpu_model(utterance_mvn(feats, flens), flens)
    err = (enc_gpu.cpu() - enc_cpu).abs().max().item()
    print(f"[{tag}] encoder card vs CPU plain path, {sec} s: max_abs_err "
          f"{err:.3e} (tol {tol:g})")
    if not (err <= tol and torch.equal(lens_gpu.cpu(), lens_cpu)):
        raise AssertionError(f"encoder disagrees with the CPU plain path: {err}")


def request_waves(seconds=REQUEST_SECONDS) -> list:
    """Phase 3's seeded noise: one waveform per request length."""
    rng = np.random.default_rng(0)
    return [(rng.standard_normal(int(s * SR)) * 0.1).astype(np.float32) for s in seconds]


def check_scores(hyp) -> None:
    """Finite, and score = att_weight * decoder + ctc_weight * ctc (0.7 and
    0.3, penalty 0)."""
    want = 0.7 * hyp.scores["decoder"] + 0.3 * hyp.scores["ctc"]
    if not math.isfinite(hyp.score) or abs(hyp.score - want) > 1e-3 * max(1.0, abs(want)):
        raise AssertionError(f"score {hyp.score} != weighted parts {want}")


def phase_serve_batch(model, kernels, card):
    """Phase 3's model serving 8 ragged requests in one batch_call: one
    warm-up and BATCH_ROUNDS timed batches, launch counts, score
    bookkeeping, a profiled batch; then each lane against the same lane
    decoded alone, with a float32 copy of the LLM."""
    from torch.profiler import ProfilerActivity, profile

    from llm_guided_asr_tpu_torch.bin.asr_inference import Speech2Text

    by_len = dict(zip(REQUEST_SECONDS, request_waves()))
    waves = [by_len[s] for s in BATCH_SECONDS]
    audio_s = sum(BATCH_SECONDS)
    s2t = Speech2Text.from_model(model, ctc_weight=0.3, beam_size=10, maxlenratio=-24.0)
    t0 = time.perf_counter()
    s2t.batch_call(waves)
    torch.cuda.synchronize()
    print(f"[serve-batch] warm-up batch of {len(waves)} requests ({audio_s:.1f} s of audio): "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)
    lat, outs = [], []
    for _ in range(BATCH_ROUNDS):
        t0 = time.perf_counter()
        outs.append(s2t.batch_call(waves))
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
    launches = counts(kernels)
    peak = torch.cuda.max_memory_allocated()
    ms = sorted(x * 1e3 for x in lat)
    med = float(np.median(ms))
    print(f"[serve-batch] B={len(waves)} ({audio_s:.1f} s of audio), {len(ms)} batches: latency "
          f"median {med:.1f} ms (min {ms[0]:.1f}, max {ms[-1]:.1f}), {audio_s / med * 1e3:.2f} "
          f"audio s/s at the median; peak memory {peak} bytes ({peak / 2**30:.2f} GiB) [{card}]")
    print(f"[serve-batch] kernel launches over {len(ms)} batches: {launches}")
    n_blocks = model.cfg.encoder.num_blocks
    for name, n in launches.items():
        want = n_blocks * len(ms) if name in ENCODER_FWD else 0
        if n != want:
            raise AssertionError(f"serve-batch: {name}: {n} launches, expected {want}")
    for sec, ((ids, hyp),) in zip(BATCH_SECONDS, outs[0]):
        print(f"[serve-batch] {sec:.1f} s lane: hyp {len(ids)} tokens, score {hyp.score:.4f}")
    for out in outs:
        for (ids, hyp), in out:
            check_scores(hyp)
            if not all(0 <= i < model.cfg.vocab_size for i in ids):
                raise AssertionError(f"bad hypothesis: {hyp}")
        if [r[0][0] for r in out] != [r[0][0] for r in outs[0]]:
            raise AssertionError("the same batch gave different hypotheses across rounds")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        s2t.batch_call(waves)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_ms, events = device_busy(prof)
    print(f"[serve-batch] batch traced (host and card): wall {wall * 1e3:.1f} ms, device busy "
          f"{dev_ms:.1f} ms = {100 * dev_ms / med:.1f}% of the unprofiled median latency [{card}]")
    print_top("serve-batch", events)
    # the PyTorch ops whose kernels take the most device time
    ops = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CPU and e.self_device_time_total > 0]
    for e in sorted(ops, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"[serve-batch]   op {e.key[:40]:40s} {e.self_device_time_total / 1e3:8.2f} ms "
              f"device, {e.count:6d} calls")
    check_batch_against_single(model, waves)
    return launches


def check_batch_against_single(model, waves):
    """A float32 copy of the model (the LLM in float32, so that bf16
    rounding at another row count decides nothing) decodes the batch, and
    each lane alone from the batch's own encoder rows (alone through
    Speech2Text, a 7.3 s request would get 227 encoder frames where the
    batch gives it 229: sub4_lengths rounds up and clamps to the padded
    width, as in JAX).  Tokens equal and scores within 1e-3; where a lane
    differs, the step where it parts and the gap between the two
    candidates (the lone search's score of its best against that of the
    batch's best) are printed, and a gap above 1e-4 fails."""
    from llm_guided_asr_tpu_torch.bin.asr_inference import round_up
    from llm_guided_asr_tpu_torch.models.llm_guided import LLMGuidedASRModel
    from llm_guided_asr_tpu_torch.search.beam_search import BatchBeamSearch
    from llm_guided_asr_tpu_torch.search.scorers import CachedGuidedScorer

    f32 = LLMGuidedASRModel(model.cfg, llm_dtype=torch.float32, device="cuda")
    f32.load_state_dict(model.state_dict())
    f32.eval()
    cfg = f32.cfg
    bs = BatchBeamSearch(f32, vocab_size=cfg.vocab_size, sos=cfg.sos_id, eos=cfg.eos_id,
                         beam_size=10, ctc_weight=0.3, att_scorer=CachedGuidedScorer(f32))
    n = round_up(max(len(w) for w in waves), 1600)
    batch = np.zeros((len(waves), n), np.float32)
    for i, w in enumerate(waves):
        batch[i, : len(w)] = w
    with torch.inference_mode():
        enc, lens = f32.encode(torch.from_numpy(batch).cuda(),
                               torch.tensor([len(w) for w in waves], device="cuda"))
    if tuple(lens.tolist()) != BATCH_LENS:
        raise AssertionError(f"serve-batch encoder frames {lens.tolist()}, expected {BATCH_LENS}")
    batched = bs.batch_decode(enc, lens, maxlenratio=-24.0, nbest=10)
    worst = 0.0
    for b, got in enumerate(batched):
        alone = bs(enc[b:b + 1], lens[b:b + 1], maxlenratio=-24.0, nbest=10)
        if got[0].yseq == alone[0].yseq:
            err = abs(got[0].score - alone[0].score)
            if err > 1e-3:
                raise AssertionError(f"serve-batch lane {b}: score {got[0].score}, alone "
                                     f"{alone[0].score}")
            worst = max(worst, err)
            continue
        step = next(i for i, (x, y) in enumerate(zip(got[0].yseq + [-1], alone[0].yseq + [-1]))
                    if x != y)
        mine = [h.score for h in alone if h.yseq == got[0].yseq]
        gap = alone[0].score - mine[0] if mine else math.inf
        print(f"[serve-batch] lane {b} differs from its lone decode at token {step}: gap between "
              f"the two candidates {gap:.3e}")
        if gap > 1e-4:
            raise AssertionError(f"serve-batch lane {b}: not a near tie (gap {gap})")
    print(f"[serve-batch] float32 LLM: each lane's hypothesis equals its lone decode from the "
          f"batch's encoder rows, score error at most {worst:.2e} (tol 1e-3)")
    del f32, bs
    torch.cuda.empty_cache()


def device_busy(prof) -> tuple:
    """Device time (ms) of a traced run (card activity only) and its events."""
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(e.self_device_time_total for e in events) / 1e3, events


def print_top(tag, events, n=12):
    """The n kernels of most device time, then every kernel of the WKV and
    depthwise sources by name (their shares of a run, top n or not)."""
    ranked = sorted(events, key=lambda e: -e.self_device_time_total)
    for e in ranked[:n]:
        print(f"[{tag}]   {e.self_device_time_total / 1e3:8.2f} ms  {e.count:6d}x  {e.key[:90]}")
    for e in ranked:
        if any(name in e.key for name in ("wkv_", "dwconv1d_")):
            print(f"[{tag}]   port kernel {e.self_device_time_total / 1e3:8.3f} ms  "
                  f"{e.count:6d}x  {e.key[:90]}")


def phase_profile(model, wave, wall_s: float, card, tag="profile", sec=REQUEST_SECONDS[0]):
    """The longest request (10 s guided, 60 s flash): its encode time alone
    (median of ``ROUNDS``), then one run with the profiler tracing the card
    only; the busy share divides that run's device time by the request's
    unprofiled median latency."""
    from torch.profiler import ProfilerActivity, profile

    from llm_guided_asr_tpu_torch.bin.asr_inference import Speech2Text

    s2t = Speech2Text.from_model(model, ctc_weight=0.3, beam_size=10, maxlenratio=-24.0)
    speech = torch.from_numpy(wave[None]).cuda()
    n = torch.tensor([wave.shape[0]], device="cuda")
    t_enc = []
    with torch.inference_mode():
        for _ in range(ROUNDS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.encode(speech, n)
            torch.cuda.synchronize()
            t_enc.append(time.perf_counter() - t0)
    enc_ms = sorted(x * 1e3 for x in t_enc)
    med_enc = float(np.median(enc_ms))
    print(f"[{tag}] {sec} s request, median latency {wall_s * 1e3:.1f} ms, of "
          f"which encode (frontend + encoder) median {med_enc:.1f} ms (min {enc_ms[0]:.1f}, "
          f"max {enc_ms[-1]:.1f}, {len(enc_ms)} runs); first pass and search "
          f"{wall_s * 1e3 - med_enc:.1f} ms [{card}]")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        s2t(wave)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_ms, events = device_busy(prof)
    print(f"[{tag}] {sec} s request traced (card only): wall {wall * 1e3:.1f} ms, "
          f"device busy {dev_ms:.1f} ms = {100 * dev_ms / 1e3 / wall_s:.1f}% of the "
          f"unprofiled median latency")
    print_top(tag, events)


def run_steps(tag, step, batch, n_warmup, n_steps, kernels, card):
    """Warm-up steps, then timed steps with the launch counts reset before
    them; returns (per-step stats of all steps, timed seconds, counts)."""
    all_stats = []
    for i in range(n_warmup):
        t0 = time.perf_counter()
        stats, _ = step(batch)
        torch.cuda.synchronize()
        all_stats.append({k: float(v) for k, v in stats.items()})
        print(f"[{tag}] warm-up step {i + 1}: {(time.perf_counter() - t0) * 1e3:.1f} ms "
              f"[{card}], {all_stats[-1]}")
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)
    dts, timed = [], []
    for _ in range(n_steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats, _ = step(batch)
        torch.cuda.synchronize()
        dts.append(time.perf_counter() - t0)
        timed.append(stats)
    launches = counts(kernels)
    for i, (dt, stats) in enumerate(zip(dts, timed)):
        all_stats.append({k: float(v) for k, v in stats.items()})
        print(f"[{tag}] step {n_warmup + i + 1}: {dt * 1e3:.1f} ms [{card}], "
              + ", ".join(f"{k} {v:.4f}" for k, v in all_stats[-1].items()))
    for s in all_stats:
        if not all(math.isfinite(v) for v in s.values()):
            raise AssertionError(f"{tag}: non-finite stats {s}")
    ms = sorted(x * 1e3 for x in dts)
    med = float(np.median(ms))
    peak = torch.cuda.max_memory_allocated()
    print(f"[{tag}] {n_steps} timed steps: median {med:.1f} ms (min {ms[0]:.1f}, max "
          f"{ms[-1]:.1f}); peak memory {peak} bytes ({peak / 2**30:.2f} GiB) [{card}]")
    print(f"[{tag}] kernel launches over {n_steps} steps: {launches}")
    return all_stats, med, launches


def build_train1():
    """Phase 5's model: the flagship CTC/attention ASRModel (bench.py
    build_flagship) in float32 with SpecAug and attention dropout 0.1,
    weights from seed 0."""
    from llm_guided_asr_tpu_torch.convert import init_weights
    from llm_guided_asr_tpu_torch.models.asr_model import ASRModel, ASRModelConfig
    from llm_guided_asr_tpu_torch.models.conformer import ConformerConfig
    from llm_guided_asr_tpu_torch.models.transformer_decoder import TransformerDecoderConfig
    from llm_guided_asr_tpu_torch.ops.frontend import FrontendConfig
    from llm_guided_asr_tpu_torch.ops.specaug import SpecAugConfig

    cfg = ASRModelConfig(
        vocab_size=5000, frontend=FrontendConfig(), normalize="utterance_mvn",
        specaug=SpecAugConfig(),
        encoder=ConformerConfig(output_size=256, attention_heads=4, linear_units=1024,
                                num_blocks=12, macaron_style=True, use_cnn_module=True,
                                cnn_module_kernel=31, attention_dropout_rate=0.1),
        decoder=TransformerDecoderConfig(attention_heads=4, linear_units=2048, num_blocks=6),
        ctc_weight=0.3,
    )
    return init_weights(ASRModel(cfg, device="cuda"), seed=0)


def phase_train1(kernels, card):
    """The flagship CTC/attention model (bench.py build_flagship) trained
    at B=64 x 10 s, float32 with TF32 off, SpecAug and attention dropout."""
    from llm_guided_asr_tpu_torch.train.optim import build_optimizer
    from llm_guided_asr_tpu_torch.train.trainer import init_train_state, make_fused_train_step

    print("[train-1] flagship as bench.py build_flagship, with two deviations from the JAX "
          "defaults: specaug=SpecAugConfig() (JAX default None) and "
          "attention_dropout_rate=0.1 (JAX default 0.0), so that the kernels' dropout runs")
    model = build_train1()
    cfg = model.cfg
    n_params = sum(p.numel() for p in model.parameters())
    state = init_train_state(model, build_optimizer("adamw", {"lr": 1e-3}))
    step = make_fused_train_step(model, state, torch.Generator().manual_seed(0))
    samples = int(TRAIN_SECONDS * SR)
    rng = np.random.default_rng(4)
    batch = {
        "speech": torch.from_numpy((rng.standard_normal((TRAIN_B, samples)) * 0.1)
                                   .astype(np.float32)).cuda(),
        "speech_lengths": torch.full((TRAIN_B,), samples, device="cuda"),
        "text": torch.ones((TRAIN_B, 24), dtype=torch.long, device="cuda"),
        "text_lengths": torch.full((TRAIN_B,), 24, device="cuda"),
    }
    print(f"[train-1] {n_params} parameters, batch {TRAIN_B} x {TRAIN_SECONDS} s, text [64, 24]")
    all_stats, med, launches = run_steps("train-1", step, batch, TRAIN_WARMUP, TRAIN_STEPS,
                                         kernels, card)
    losses = [s["loss"] for s in all_stats]
    if not np.mean(losses[-3:]) < losses[0]:
        raise AssertionError(f"train-1: loss did not fall: {losses}")
    n_blocks = cfg.encoder.num_blocks
    for name, n in launches.items():
        want = n_blocks * TRAIN_STEPS if name in ENCODER_FWD + ENCODER_BWD else 0
        if n != want:
            raise AssertionError(f"train-1: {name} launched {n} times in {TRAIN_STEPS} steps, "
                                 f"expected {want}")
    print(f"[train-1] audio seconds per second at the median: "
          f"{TRAIN_B * TRAIN_SECONDS / (med / 1e3):.1f} [{card}]")
    profile_step("train-1", step, batch, med)
    return launches, med


def profile_step(tag, step, batch, median_ms):
    """One more step with the profiler tracing the card only: its device
    time over the unprofiled median step, and the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step(batch)
        torch.cuda.synchronize()
    dev_ms, events = device_busy(prof)
    print(f"[{tag}] one step traced (card only): device busy {dev_ms:.1f} ms = "
          f"{100 * dev_ms / median_ms:.1f}% of the unprofiled median step")
    print_top(tag, events, n=15)


def phase_train2(model, kernels, card):
    """Phase 2 on the serving model: encoder, ctc_head and llm frozen."""
    from llm_guided_asr_tpu_torch.train.optim import build_optimizer, path_prefix_mask
    from llm_guided_asr_tpu_torch.train.trainer import init_train_state, make_fused_train_step

    frozen = path_prefix_mask(model, ["encoder", "ctc_head", "llm"])
    snapshot = {n: p.detach().clone() for n, p in model.named_parameters() if n in frozen}
    stats_before = {n: b.clone() for n, b in model.named_buffers() if "running_" in n}
    tx = build_optimizer("adamw", {"lr": 1e-3}, freeze_mask=frozen)
    state = init_train_state(model, tx)
    n_train = sum(p.numel() for p in state.params)
    print(f"[train-2] {len(frozen)} frozen tensors ({sum(t.numel() for t in snapshot.values())} "
          f"values), {n_train} trainable parameters")
    step = make_fused_train_step(model, state, torch.Generator().manual_seed(1))
    samples = int(TRAIN_SECONDS * SR)
    rng = np.random.default_rng(1)
    batch = {
        "speech": torch.from_numpy((rng.standard_normal((GUIDED_B, samples)) * 0.1)
                                   .astype(np.float32)).cuda(),
        "speech_lengths": torch.full((GUIDED_B,), samples, device="cuda"),
        "text": torch.ones((GUIDED_B, 16), dtype=torch.long, device="cuda"),
        "text_lengths": torch.full((GUIDED_B,), 16, device="cuda"),
    }
    _, med, launches = run_steps("train-2", step, batch, GUIDED_WARMUP, GUIDED_STEPS, kernels,
                                 card)
    n_blocks = model.cfg.encoder.num_blocks
    for name, n in launches.items():
        want = n_blocks * GUIDED_STEPS if name in ENCODER_FWD else 0
        if n != want:
            raise AssertionError(f"train-2: {name} launched {n} times, expected {want}")
    print(f"[train-2] audio seconds per second at the median: "
          f"{GUIDED_B * TRAIN_SECONDS / (med / 1e3):.1f} [{card}]")
    profile_step("train-2", step, batch, med)
    changed = [n for n, p in model.named_parameters() if n in frozen
               and not torch.equal(p, snapshot[n])]
    changed += [n for n, b in model.named_buffers() if n in stats_before
                and not torch.equal(b, stats_before[n])]
    if changed:
        raise AssertionError(f"train-2: frozen weights moved: {changed[:5]}")
    print(f"[train-2] frozen parameters and running statistics bit-identical after "
          f"{GUIDED_WARMUP + GUIDED_STEPS + 1} steps")
    return launches, med


# phase 15 (train-run): Trainer.run from a wav corpus on disk
RUN_UTTS, RUN_TRAIN, RUN_B, RUN_TOKENS_PER_S = 160, 128, 32, 2.4
RUN_CRITERIA = (("valid", "acc", "max"), ("valid", "loss", "min"))
RUN_TIME_KEYS = ("time", "iter_time", "grad_time", "optim_step_time", "train_step_time")
# epoch-3 losses of a resumed run against an uninterrupted one, relative:
# two uninterrupted runs part by 1e-6 to 3e-6 on an H100 (F.ctc_loss's
# backward sums in no fixed order), a resume that loses its optimizer
# state by ~1e-1 and one that draws epoch 1's masks by ~2e-4; the smoke
# plants both faults and checks that they fail the limit
RUN_RESUME_RTOL = 2e-5


def write_run_corpus(root: Path, seed: int = 0, n_utts: int = RUN_UTTS,
                     n_train: int = RUN_TRAIN) -> dict:
    """RUN_UTTS int16 wav files of seeded noise, 6-10 s, and a text_int file
    of 2.4 tokens a second drawn from 1..4998; the first RUN_TRAIN
    utterances train, the rest validate (``n_utts``/``n_train`` take the
    first of them only).  Returns each split's (wav.scp, text) paths and
    audio seconds."""
    from llm_guided_asr_tpu_torch.data.fileio import write_wav

    rng = np.random.default_rng(seed)
    splits = {}
    for split, ids in (("train", range(n_train)), ("valid", range(n_train, n_utts))):
        wav, text, seconds = [], [], 0.0
        for i in ids:
            n = int(rng.integers(6 * SR, 10 * SR + 1))
            path = root / f"utt{i:03d}.wav"
            write_wav(path, SR, (rng.standard_normal(n) * 0.1).astype(np.float32))
            tokens = rng.integers(1, 4999, max(1, round(RUN_TOKENS_PER_S * n / SR)))
            wav.append(f"utt{i:03d} {path}")
            text.append(f"utt{i:03d} " + " ".join(map(str, tokens)))
            seconds += n / SR
        (root / f"{split}.scp").write_text("\n".join(wav) + "\n")
        (root / f"{split}.text").write_text("\n".join(text) + "\n")
        splits[split] = (root / f"{split}.scp", root / f"{split}.text", seconds)
    return splits


def run_iter_factory(scp: Path, text: Path):
    """The ported data path: ESPnetDataset (sound + text_int), the sorted
    sampler at RUN_B, speech padded to a multiple of 1600 samples."""
    from llm_guided_asr_tpu_torch.data.dataset import CommonCollateFn, ESPnetDataset
    from llm_guided_asr_tpu_torch.data.iterator import SequenceIterFactory
    from llm_guided_asr_tpu_torch.data.samplers import build_batch_sampler

    data = ESPnetDataset([(str(scp), "speech", "sound"), (str(text), "text", "text_int")])
    lengths = {u: data.peek_length(u) for u in data.keys}
    batches = build_batch_sampler("sorted", data.keys, lengths, batch_size=RUN_B)
    collate = CommonCollateFn(pad_multiples={"speech": 1600})
    return SequenceIterFactory(data, batches, collate, seed=0, device="cuda"), len(batches)


def check_run_files(out: Path, reporter, tag: str):
    """{n}epoch.pth pruned to the union of each criterion's best two and
    the latest; checkpoint.pth; the best links; valid.acc.ave_2best.pth
    equal to the float64 mean of the two best-acc epochs (1e-6)."""
    from llm_guided_asr_tpu_torch.train.checkpoint import load

    keep = {reporter.epoch}
    for phase, key, mode in RUN_CRITERIA:
        keep.update(reporter.sort_epochs(phase, key, mode)[:2])
    have = {int(p.name[: -len("epoch.pth")]) for p in out.glob("*epoch.pth")}
    if have != keep or not (out / "checkpoint.pth").is_file():
        raise AssertionError(f"{tag}: epoch files {sorted(have)}, expected {sorted(keep)}")
    for phase, key, mode in RUN_CRITERIA:
        best = reporter.get_best_epoch(phase, key, mode)
        link = out / f"{phase}.{key}.best.pth"
        if not link.is_symlink() or link.resolve().name != f"{best}epoch.pth":
            raise AssertionError(f"{tag}: {link.name} does not name epoch {best}")
    best2 = reporter.sort_epochs("valid", "acc", "max")[:2]
    ave = load(out / "valid.acc.ave_2best.pth")
    parts = [load(out / f"{e}epoch.pth") for e in best2]
    err = max(float((ave[k].double() - (parts[0][k].double() + parts[1][k].double()) / 2)
                    .abs().max()) for k in ave)
    if not err <= 1e-6 or ave.keys() != parts[0].keys():
        raise AssertionError(f"{tag}: the average of epochs {best2} is {err} off")
    print(f"[train-run] {tag}: epoch files {sorted(have)}, best by acc {best2[0]}, by loss "
          f"{reporter.get_best_epoch('valid', 'loss', 'min')}; valid.acc.ave_2best.pth = mean "
          f"of epochs {best2} within {err:.2e} (tol 1e-6)")


def phase_train_run(kernels, card, guided=None):
    """Phase 15: Trainer.run.  Part 1: phase 5's model trained from a wav
    corpus on disk through the ported data path, accum_grad 2, three epochs
    run as 2 + a resume to 3 (run A) and uninterrupted (run B).  Part 2:
    phase 2 on the guided model (``guided``, else built here) with the LLM
    left out of every checkpoint file."""
    import shutil
    import tempfile

    import llm_guided_asr_tpu_torch.train.trainer as trainer_mod
    from llm_guided_asr_tpu_torch.train.checkpoint import load, load_partial
    from llm_guided_asr_tpu_torch.train.optim import build_optimizer, path_prefix_mask
    from llm_guided_asr_tpu_torch.train.reporter import Reporter
    from llm_guided_asr_tpu_torch.train.trainer import Trainer, TrainerOptions

    with tempfile.TemporaryDirectory(prefix="train-run-") as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        splits = write_run_corpus(root)
        train_iter, n_train = run_iter_factory(*splits["train"][:2])
        valid_iter, n_valid = run_iter_factory(*splits["valid"][:2])
        train_secs = splits["train"][2]
        print(f"[train-run] corpus: {RUN_TRAIN} + {RUN_UTTS - RUN_TRAIN} wav files, "
              f"{train_secs:.1f} + {splits['valid'][2]:.1f} s of audio, written in "
              f"{time.perf_counter() - t0:.1f} s; {n_train} train microbatches of {RUN_B} and "
              f"{n_valid} validation batch an epoch")

        def run(name, out, max_epoch, resume):
            model = build_train1()
            blocks = model.cfg.encoder.num_blocks
            fwd_epoch = blocks * (n_train + 2 * n_valid)  # report_ctc_er encodes valid twice
            bwd_epoch = blocks * n_train
            tx = build_optimizer("adamw", {"lr": 1e-3}, scheduler="warmuplr",
                                 scheduler_conf={"warmup_steps": 6})
            opts = TrainerOptions(max_epoch=max_epoch, accum_grad=2, keep_nbest_models=2,
                                  best_model_criterion=RUN_CRITERIA, report_ctc_er=True,
                                  log_interval=2, resume=resume, seed=0)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts(kernels)
            t_run = time.perf_counter()
            state = Trainer.run(model, tx, train_iter, valid_iter, out, opts)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t_run
            launches = counts(kernels)
            reporter = Reporter.load(out / "reporter.json")
            epochs = max_epoch - (2 if resume else 0)
            tag = f"run {name}"
            for name, n in launches.items():
                want = {"rel_attention_fwd": fwd_epoch, "dwconv1d_fwd": fwd_epoch,
                        "rel_attention_bwd": bwd_epoch, "dwconv1d_bwd": bwd_epoch}.get(name, 0)
                if n != want * epochs:
                    raise AssertionError(f"train-run {tag}: {name} launched {n} times in "
                                         f"{epochs} epochs, expected {want * epochs}")
            first = max_epoch - epochs + 1
            for e in range(first, max_epoch + 1):
                st = reporter.stats[e]
                for phase in ("train", "valid"):
                    bad = {k: v for k, v in st[phase].items() if not math.isfinite(v)}
                    if bad:
                        raise AssertionError(f"train-run {tag}: epoch {e} {phase} {bad}")
                tr = st["train"]
                i = 2 * (e - first)  # two saves an epoch
                wall_e = tr["time"] + st["valid"]["time"] + sum(
                    sec for _, sec, _ in state.saves[i:i + 2])
                print(f"[train-run] {tag} epoch {e}: wall {wall_e:.2f} s (train, valid, saves); "
                      f"train {tr['time']:.2f} s = "
                      f"{train_secs / tr['time']:.1f} audio s/s, probes grad_time "
                      f"{tr['grad_time'] * 1e3:.1f} ms, optim_step_time "
                      f"{tr['optim_step_time'] * 1e3:.1f} ms, iter_time "
                      f"{tr['iter_time'] * 1e3:.1f} ms; loss {tr['loss']!r}; valid "
                      f"{st['valid']['time']:.2f} s, loss {st['valid']['loss']!r}, acc "
                      f"{st['valid']['acc']:.5f}, cer_ctc {st['valid']['cer_ctc']:.2f} [{card}]")
            for name, sec, size in state.saves:
                print(f"[train-run] {tag} saved {name}: {sec:.3f} s, {size} bytes "
                      f"({size / 2**20:.1f} MiB) [{card}]")
            peak = torch.cuda.max_memory_allocated()
            print(f"[train-run] {tag}: {epochs} epochs in {wall:.1f} s, {state.step} updates, "
                  f"peak memory {peak} bytes ({peak / 2**30:.2f} GiB) [{card}]")
            print(f"[train-run] {tag} kernel launches: {launches} (per epoch: {fwd_epoch} of "
                  f"each forward, {bwd_epoch} of each backward)")
            return model, state, reporter, launches

        run("A", root / "a", 2, False)
        # faults planted in the resume, by attribute: (owner, name, stand-in)
        real_seed = trainer_mod.epoch_seed
        faults = {"optimizer state dropped": (torch.optim.AdamW, "load_state_dict",
                                              lambda self, state_dict: None),
                  "epoch 1's masks": (trainer_mod, "epoch_seed",
                                      lambda seed, epoch: real_seed(seed, 1))}
        for i in range(len(faults)):
            shutil.copytree(root / "a", root / f"fault{i}", symlinks=True)
        model_a, state_a, rep_a, _ = run("A resumed", root / "a", 3, True)
        model_b, state_b, rep_b, launches = run("B", root / "b", 3, False)
        # a second uninterrupted run: how far two runs part on this card
        model_c, _, _, _ = run("C", root / "c", 3, False)
        check_run_files(root / "a", rep_a, "run A")
        check_run_files(root / "b", rep_b, "run B")
        if state_a.step != state_b.step or not sorted(rep_a.stats) == sorted(rep_b.stats) == [
                1, 2, 3]:
            raise AssertionError(f"train-run: resumed {state_a.step} updates, epochs "
                                 f"{sorted(rep_a.stats)}; uninterrupted {state_b.step}, "
                                 f"{sorted(rep_b.stats)}")
        # F.ctc_loss's CUDA backward (and cuDNN's convolution backward) sum
        # in no fixed order, so the runs' weights part at float32 rounding
        # and drift over 6 updates: the losses are held to RUN_RESUME_RTOL,
        # acc and cer_ctc to one of the ~600 validation tokens (on this
        # noise corpus the greedy CTC output is all blank and both stay put)
        n_tokens = sum(len(line.split()) - 1 for line in
                       splits["valid"][1].read_text().splitlines())
        tols = {"acc": 1 / n_tokens, "cer_ctc": 100 / n_tokens}

        def epoch3_gap(rep):
            """(largest relative loss gap to run B, discrete stats out of
            their tolerance) at epoch 3."""
            rel, off = 0.0, []
            for phase in ("train", "valid"):
                for k, v in rep_b.stats[3][phase].items():
                    if k in RUN_TIME_KEYS or k == "iterations":
                        continue
                    a = rep.stats[3][phase][k]
                    if k in tols:
                        off += [f"{phase} {k} {a} vs {v}"] if not abs(a - v) <= tols[k] else []
                    else:
                        rel = max(rel, abs(a - v) / abs(v))
            return rel, off

        rel_a, off_a = epoch3_gap(rep_a)
        if not rel_a <= RUN_RESUME_RTOL or off_a:
            raise AssertionError(f"train-run: epoch 3 resumed vs B: losses {rel_a:.3e} relative "
                                 f"(limit {RUN_RESUME_RTOL:g}), {off_a}")
        # the limit's power: each planted fault must fail it
        rel_faults = []
        for i, (fault, (owner, attr, stand_in)) in enumerate(faults.items()):
            real = getattr(owner, attr)
            setattr(owner, attr, stand_in)
            try:
                _, _, rep_f, _ = run(f"fault ({fault})", root / f"fault{i}", 3, True)
            finally:
                setattr(owner, attr, real)
            rel_f, off_f = epoch3_gap(rep_f)
            if not rel_f > RUN_RESUME_RTOL:
                raise AssertionError(f"train-run: a resume with {fault} passes the limit: "
                                     f"losses {rel_f:.3e} relative")
            rel_faults.append(f"{fault} {rel_f:.3e}")
        rel_c, _ = epoch3_gap(Reporter.load(root / "c" / "reporter.json"))

        def max_diff(m1, m2):
            return max(float((x - y).abs().max()) for x, y in
                       zip(m1.state_dict().values(), m2.state_dict().values()))

        print(f"[train-run] resume: {state_a.step} updates and epochs {sorted(rep_a.stats)} as "
              f"the uninterrupted run; epoch-3 losses {rel_a:.3e} relative to run B (limit "
              f"{RUN_RESUME_RTOL:g}; run C {rel_c:.3e}; planted faults, which must fail it: "
              f"{', '.join(rel_faults)}), acc within {tols['acc']:.2e}, cer_ctc within "
              f"{tols['cer_ctc']:.3f}; largest parameter difference "
              f"{max_diff(model_a, model_b):.3e} resumed vs B, "
              f"{max_diff(model_c, model_b):.3e} between the uninterrupted runs B and C [{card}]")
        del model_a, model_b, model_c
        torch.cuda.empty_cache()

        # ---- part 2: phase 2 through the same loop ----
        model = guided if guided is not None else build_model()
        frozen = path_prefix_mask(model, ["encoder", "ctc_head", "llm"])
        snapshot = {n: p.detach().clone() for n, p in model.named_parameters() if n in frozen}
        rng = np.random.default_rng(15)
        samples = int(TRAIN_SECONDS * SR)
        batches = [{
            "speech": torch.from_numpy((rng.standard_normal((GUIDED_B, samples)) * 0.1)
                                       .astype(np.float32)).cuda(),
            "speech_lengths": torch.full((GUIDED_B,), samples, device="cuda"),
            "text": torch.from_numpy(rng.integers(100, 5000, (GUIDED_B, 16))).cuda(),
            "text_lengths": torch.full((GUIDED_B,), 16, device="cuda"),
        } for _ in range(3)]
        out = root / "guided"
        reset_counts(kernels)
        t_run = time.perf_counter()
        state = Trainer.run(model, build_optimizer("adamw", {"lr": 1e-3}, freeze_mask=frozen),
                            lambda e: batches[:2], lambda e: batches[2:], out,
                            TrainerOptions(max_epoch=1, log_interval=1,
                                           exclude_prefixes=("params/llm",)))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_run
        guided_launches = counts(kernels)
        for name, n in guided_launches.items():
            want = model.cfg.encoder.num_blocks * 3 if name in ENCODER_FWD else 0
            if n != want:
                raise AssertionError(f"train-run guided: {name} launched {n} times, expected "
                                     f"{want}")
        loss = Reporter.load(out / "reporter.json").stats[1]["train"]["loss"]
        if not math.isfinite(loss) or state.step != 2:
            raise AssertionError(f"train-run guided: loss {loss}, {state.step} updates")
        for path in sorted(out.glob("*.pth")):
            obj = load(path)
            keys = obj["model"] if "model" in obj else obj
            if not keys or any(k == "llm" or k.startswith("llm.") for k in keys):
                raise AssertionError(f"train-run guided: {path.name} holds an llm key")
        epoch_bytes = (out / "1epoch.pth").stat().st_size
        llm_bytes = sum(p.numel() * p.element_size() for n, p in model.named_parameters()
                        if n.startswith("llm."))
        if not epoch_bytes < llm_bytes / 4:
            raise AssertionError(f"train-run guided: 1epoch.pth {epoch_bytes} bytes")
        moved = [n for n, p in model.named_parameters() if n in frozen
                 and not torch.equal(p, snapshot[n])]
        if moved:
            raise AssertionError(f"train-run guided: frozen weights moved: {moved[:5]}")
        del snapshot
        fresh = build_model()
        missing = load_partial(fresh, out / "1epoch.pth")
        want_sd, got_sd = model.state_dict(), fresh.state_dict()
        wrong = [k for k in want_sd if not k.startswith("llm.")
                 and not torch.equal(want_sd[k], got_sd[k])]
        if wrong or not all(k.startswith("llm.") for k in missing):
            raise AssertionError(f"train-run guided: load_partial left {wrong[:5]}, missing "
                                 f"{[k for k in missing if not k.startswith('llm.')][:5]}")
        del fresh
        torch.cuda.empty_cache()
        for name, sec, size in state.saves:
            print(f"[train-run] guided saved {name}: {sec:.3f} s, {size} bytes "
                  f"({size / 2**20:.1f} MiB) [{card}]")
        print(f"[train-run] guided: 1 epoch of 2 microbatches (B={GUIDED_B} x {TRAIN_SECONDS} "
              f"s) and 1 validation batch in {wall:.1f} s, loss {loss:.4f}; no file holds an "
              f"llm key; 1epoch.pth {epoch_bytes} bytes against the LLM's {llm_bytes}; frozen "
              f"weights bit-identical; load_partial restored every non-LLM tensor into a "
              f"fresh model; launches {guided_launches} [{card}]")
    return launches


def build_transducer():
    """The RWKV transducer at full width: vocab 5000, utterance MVN, the
    flagship Conformer of train-1 with SpecAug and encoder and attention
    dropout 0.1 (training mode only), the reference RWKVDecoder's defaults
    (block_size 512; 2 blocks of its 4: the depth cut that pays for the
    bf16 twins of phases 36-37), joint 256, aux CTC 0.3; float32."""
    from llm_guided_asr_tpu_torch.convert import init_weights
    from llm_guided_asr_tpu_torch.models.transducer import TransducerModel

    return init_weights(TransducerModel(build_transducer_config(), device="cuda"), seed=0)


def build_transducer_config():
    from llm_guided_asr_tpu_torch.models.conformer import ConformerConfig
    from llm_guided_asr_tpu_torch.models.transducer import (
        TransducerDecoderConfig,
        TransducerModelConfig,
    )
    from llm_guided_asr_tpu_torch.ops.frontend import FrontendConfig
    from llm_guided_asr_tpu_torch.ops.specaug import SpecAugConfig

    return TransducerModelConfig(
        vocab_size=5000, frontend=FrontendConfig(), normalize="utterance_mvn",
        specaug=SpecAugConfig(),
        encoder=ConformerConfig(output_size=256, attention_heads=4, linear_units=1024,
                                num_blocks=12, macaron_style=True, use_cnn_module=True,
                                cnn_module_kernel=31, dropout_rate=0.1,
                                attention_dropout_rate=0.1),
        decoder=TransducerDecoderConfig(decoder_type="rwkv", embed_size=512, hidden_size=512,
                                        num_layers=RWKV_LAYERS),
        joint_size=256, aux_ctc_weight=0.3,
    )


def phase_serve_transducer(model, waves, kernels, card):
    """Beam-5 serving of the three requests (one warm-up each, then
    ``ROUNDS`` timed runs with the counts reset before each),
    the 10 s request greedily, the card's prediction and joint networks
    against the CPU plain path, and one profiled request."""
    import copy

    from llm_guided_asr_tpu_torch.bin.asr_inference import Speech2Text

    s2t = Speech2Text.from_model(model, beam_size=TRANSDUCER_BEAM, nbest=TRANSDUCER_BEAM)
    n_blocks, n_layers = model.cfg.encoder.num_blocks, model.cfg.decoder.num_layers
    frames = encoder_frames(model, waves)
    for sec, wave in zip(REQUEST_SECONDS, waves):
        t0 = time.perf_counter()
        s2t(wave)
        torch.cuda.synchronize()
        print(f"[serve-transducer] warm-up request, {sec:.1f} s audio: "
              f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    torch.cuda.reset_peak_memory_stats()
    lat = {sec: [] for sec in REQUEST_SECONDS}
    total = dict.fromkeys(counts(kernels), 0)
    for _ in range(ROUNDS):
        for sec, wave, n_frames in zip(REQUEST_SECONDS, waves, frames):
            reset_counts(kernels)
            t0 = time.perf_counter()
            out = s2t(wave)
            torch.cuda.synchronize()
            lat[sec].append(time.perf_counter() - t0)
            launches = counts(kernels)
            # 2 prediction-network calls per frame (max_sym_exp 2), each
            # running the WKV forward once per RWKV block
            want = dict.fromkeys(launches, 0)
            want.update(rel_attention_fwd=n_blocks, dwconv1d_fwd=n_blocks,
                        wkv_fwd=n_layers * 2 * n_frames)
            if launches != want:
                raise AssertionError(f"serve-transducer {sec} s: launches {launches} != {want}")
            scores = [h.score for _, h in out]
            if not (all(math.isfinite(x) for x in scores) and scores == sorted(scores, reverse=True)
                    and all(0 < i < model.cfg.vocab_size for ids, _ in out for i in ids)):
                raise AssertionError(f"serve-transducer {sec} s: bad hypotheses {scores}")
            total = {k: total[k] + n for k, n in launches.items()}
    peak = torch.cuda.max_memory_allocated()
    for sec, n_frames in zip(REQUEST_SECONDS, frames):
        ms = sorted(x * 1e3 for x in lat[sec])
        med = float(np.median(ms))
        print(f"[serve-transducer] {sec:.1f} s audio ({n_frames} frames), {len(ms)} runs, beam "
              f"{TRANSDUCER_BEAM}: latency median {med:.1f} ms (min {ms[0]:.1f}, max "
              f"{ms[-1]:.1f}), RTFx at the median {sec / med * 1e3:.2f} [{card}]")
    print(f"[serve-transducer] 10.0 s request launches: rel_attention_fwd {n_blocks}, "
          f"dwconv1d_fwd {n_blocks}, wkv_fwd {n_layers * 2 * frames[0]} "
          f"(= {n_layers} blocks x 2 calls x {frames[0]} frames), backward 0; over all "
          f"{ROUNDS * len(waves)} timed requests {total}")
    print(f"[serve-transducer] torch.cuda.max_memory_allocated: {peak} bytes "
          f"({peak / 2**30:.2f} GiB)")

    greedy = Speech2Text.from_model(model, beam_size=1)
    reset_counts(kernels)
    t0 = time.perf_counter()
    (ids, _), = greedy(waves[0])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    g_launches = counts(kernels)
    if g_launches["wkv_fwd"] % n_layers or not g_launches["wkv_fwd"] or any(
            g_launches[k] != n_blocks for k in ENCODER_FWD):
        raise AssertionError(f"serve-transducer greedy: launches {g_launches}")
    print(f"[serve-transducer] 10.0 s request greedy (beam 1), one run, first at this shape: "
          f"{dt * 1e3:.1f} ms, {len(ids)} tokens, {g_launches['wkv_fwd'] // n_layers} "
          f"prediction-network calls, launches {g_launches} [{card}]")

    # the card's prediction and joint networks against the CPU plain path
    gen = torch.Generator().manual_seed(7)
    tokens = torch.randint(1, model.cfg.vocab_size, (TRANSDUCER_BEAM, 200), generator=gen)
    with torch.inference_mode():
        enc, _ = model.encode(torch.from_numpy(waves[-1][None]).cuda(),
                              torch.tensor([waves[-1].shape[0]], device="cuda"))
        h = enc[0, :TRANSDUCER_BEAM]
        g = model.decode_labels(tokens.cuda())
        logits = model.joint_step(h[:, None, :], g)
        cpu_dec, cpu_joint = copy.deepcopy(model.decoder).cpu(), copy.deepcopy(model.joint).cpu()
        ref_g = cpu_dec(tokens)
        ref_logits = cpu_joint(h.cpu()[:, None, :], ref_g)
    errs = (max_err(g.cpu(), ref_g), max_err(logits.cpu(), ref_logits))
    print(f"[serve-transducer] decode_labels [5, 201, 512] and joint_step [5, 201, 5000], card "
          f"vs CPU plain path: max_abs_err {errs[0]:.3e} and {errs[1]:.3e} (tol 1e-4)")
    if not max(errs) <= 1e-4:
        raise AssertionError(f"serve-transducer: card and CPU disagree: {errs}")

    from torch.profiler import ProfilerActivity, profile

    wall_s = float(np.median(lat[REQUEST_SECONDS[0]]))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        s2t(waves[0])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_ms, events = device_busy(prof)
    print(f"[serve-transducer] 10.0 s request traced (card only): wall {wall * 1e3:.1f} ms, "
          f"device busy {dev_ms:.1f} ms = {100 * dev_ms / 1e3 / wall_s:.1f}% of the unprofiled "
          f"median latency")
    print_top("serve-transducer", events)
    return total


def phase_train_transducer(model, kernels, card, tag="train-transducer", n_warmup=TRD_WARMUP,
                           n_steps=TRD_STEPS, profiled=True):
    """The transducer trained at B=16 x 10 s, float32 with TF32 off,
    SpecAug and dropout 0.1, AdamW lr 1e-3: losses finite and falling, 12
    launches of each encoder entry point a step and one of each WKV
    (RWKV) or LSTM entry point a prediction-network block or layer."""
    from llm_guided_asr_tpu_torch.train.optim import build_optimizer
    from llm_guided_asr_tpu_torch.train.trainer import init_train_state, make_fused_train_step

    state = init_train_state(model, build_optimizer("adamw", {"lr": 1e-3}))
    step = make_fused_train_step(model, state, torch.Generator().manual_seed(2))
    samples = int(TRAIN_SECONDS * SR)
    rng = np.random.default_rng(5)
    batch = {
        "speech": torch.from_numpy((rng.standard_normal((TRD_B, samples)) * 0.1)
                                   .astype(np.float32)).cuda(),
        "speech_lengths": torch.full((TRD_B,), samples, device="cuda"),
        "text": torch.from_numpy(rng.integers(1, 5000, (TRD_B, 24))).cuda(),
        "text_lengths": torch.full((TRD_B,), 24, device="cuda"),
    }
    n_params = sum(p.numel() for p in model.parameters())
    dec = model.cfg.decoder
    print(f"[{tag}] {n_params} parameters, {dec.decoder_type} prediction network "
          f"{dec.num_layers} x {dec.hidden_size}, multi-blank durations "
          f"{model.cfg.multi_blank_durations}, batch {TRD_B} x {TRAIN_SECONDS} s, text "
          f"[{TRD_B}, 24]; joint lattice [{TRD_B}, T', 25, {model.cfg.vocab_size}] float32")
    all_stats, med, launches = run_steps(tag, step, batch, n_warmup, n_steps, kernels, card)
    losses = [s["loss"] for s in all_stats]
    if not np.mean(losses[-3:]) < losses[0]:
        raise AssertionError(f"{tag}: loss did not fall: {losses}")
    n_blocks = model.cfg.encoder.num_blocks
    for name, n in launches.items():
        if name.startswith("wkv"):
            want = dec.num_layers * n_steps if dec.decoder_type == "rwkv" else 0
        elif name.startswith("lstm"):  # one recurrence a layer a step
            want = dec.num_layers * n_steps if dec.decoder_type == "rnn" else 0
        else:
            want = 0 if name.startswith("flash") else n_blocks * n_steps
        if n != want:
            raise AssertionError(f"{tag}: {name} launched {n} times in {n_steps} steps, "
                                 f"expected {want}")
    print(f"[{tag}] audio seconds per second at the median: "
          f"{TRD_B * TRAIN_SECONDS / (med / 1e3):.1f} [{card}]")
    if profiled:
        profile_step(tag, step, batch, med)
    return launches, med


def build_transducer_lstm(decoder_type="rnn", multi_blank=False, num_blocks=None):
    """build_transducer's model with another prediction network: the LSTM at
    the JAX config's widths (embed 256, hidden 256, 1 layer) or MEGA
    (hidden 256, 4 blocks, the reference RWKV network's depth, the JAX defaults: qk
    64, 4 EMA heads, the simple bias, FFN 2 x hidden), dropout 0.1; with
    ``multi_blank``, big blanks of 2, 4 and 8 frames at the default ids
    (the top 3 of the 5000) and sigma 0.05 (Xu et al. 2023)."""
    import dataclasses

    from llm_guided_asr_tpu_torch.convert import init_weights
    from llm_guided_asr_tpu_torch.models.transducer import TransducerDecoderConfig, TransducerModel

    base = build_transducer_config()
    if decoder_type == "rnn":
        dec = TransducerDecoderConfig(decoder_type="rnn", embed_size=256, hidden_size=256,
                                      num_layers=1, dropout_rate=0.1)
    else:
        dec = TransducerDecoderConfig(decoder_type="mega", hidden_size=256, num_layers=4,
                                      dropout_rate=0.1)
    cfg = dataclasses.replace(base, decoder=dec,
                              multi_blank_durations=MB_DURATIONS if multi_blank else ())
    if num_blocks is not None:  # the encoder's depth (the bf16 twins')
        cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(cfg.encoder,
                                                                   num_blocks=num_blocks))
    return init_weights(TransducerModel(cfg, device="cuda"), seed=0)


def check_nbest(tag, got, want) -> float:
    """Two n-best lists of one search from the same encoder rows (card and
    CPU): entry by entry, equal tokens with scores within 1e-3, or a near
    tie (the two entries' scores within 1e-4, as phase 12 rules); returns
    the largest score error of the equal entries."""
    if len(got) != len(want):
        raise AssertionError(f"{tag}: {len(got)} hypotheses on the card, {len(want)} on the CPU")
    worst = 0.0
    for k, (g, w) in enumerate(zip(got, want)):
        err = abs(g.score - w.score)
        if g.yseq == w.yseq:
            if not err <= 1e-3:
                raise AssertionError(f"{tag} entry {k}: score {g.score} on the card, {w.score} "
                                     f"on the CPU")
            worst = max(worst, err)
        elif err <= 1e-4:
            print(f"[{tag}] entry {k} differs from the CPU's: a near tie, scores {err:.2e} apart")
        else:
            raise AssertionError(f"{tag} entry {k}: {g.yseq} ({g.score}) on the card, {w.yseq} "
                                 f"({w.score}) on the CPU")
    return worst


def phase_serve_transducer_rnn(model, waves, kernels, card):
    """The LSTM transducer served at beam 5 through Speech2Text: the
    default search on the three requests, alsd, tsd (max_sym_exp 2) and
    nsc (nstep 2, prefix_alpha 4) on the 10 s one, each request once to
    warm up and then ``ROUNDS`` times timed, with 12 launches of
    each encoder forward a request, one lstm_fwd launch a prediction-network
    call and nothing else; the card's prediction and joint networks against
    the CPU plain path; each search's n-best from the first
    ``CHECK_FRAMES`` encoder rows of the 4.1 s request against the same
    search on the CPU from those rows; and the 4.1 s request's tsd
    profiled: one recurrence kernel a prediction-network call."""
    import copy

    from torch.profiler import ProfilerActivity, profile

    from llm_guided_asr_tpu_torch.bin.asr_inference import TRANSDUCER_BEAMS, Speech2Text

    tag = "serve-transducer-rnn"
    t_start = time.perf_counter()
    n_blocks = model.cfg.encoder.num_blocks
    frames = encoder_frames(model.eval(), waves)
    want = dict.fromkeys(counts(kernels), 0)
    want.update(rel_attention_fwd=n_blocks, dwconv1d_fwd=n_blocks)
    total = dict.fromkeys(want, 0)
    calls = []  # prediction-network calls: one lstm_fwd launch each (one layer)
    hook = model.decoder.register_forward_hook(lambda *_: calls.append(1))
    torch.cuda.reset_peak_memory_stats()
    for search in ("default", "alsd", "tsd", "nsc"):
        n_req = len(waves) if search == "default" else 1
        s2t = Speech2Text.from_model(model, beam_size=TRANSDUCER_BEAM, nbest=TRANSDUCER_BEAM,
                                     transducer_search=search)
        requests = list(zip(REQUEST_SECONDS, waves, frames))[:n_req]
        for sec, wave, _ in requests:
            t0 = time.perf_counter()
            s2t(wave)
            torch.cuda.synchronize()
            print(f"[{tag}] {search} warm-up request, {sec:.1f} s audio: "
                  f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
        lat = {sec: [] for sec, _, _ in requests}
        labels, n_calls = {}, {}
        for _ in range(ROUNDS):
            for sec, wave, _ in requests:
                reset_counts(kernels)
                calls.clear()
                t0 = time.perf_counter()
                out = s2t(wave)
                torch.cuda.synchronize()
                lat[sec].append(time.perf_counter() - t0)
                launches = counts(kernels)
                if launches != dict(want, lstm_fwd=len(calls)) or not calls:
                    raise AssertionError(f"{tag} {search} {sec} s: launches {launches}, "
                                         f"{len(calls)} prediction-network calls")
                total = {k: total[k] + n for k, n in launches.items()}
                scores = [h.score for _, h in out]
                if not (all(math.isfinite(x) for x in scores)
                        and all(0 < i < model.cfg.vocab_size for ids, _ in out for i in ids)):
                    raise AssertionError(f"{tag} {search} {sec} s: bad hypotheses {scores}")
                # default and alsd sort by the reported (normalized) score;
                # tsd and nsc report raw scores sorted by the normalized one
                if search in ("default", "alsd") and scores != sorted(scores, reverse=True):
                    raise AssertionError(f"{tag} {search} {sec} s: scores out of order {scores}")
                labels[sec] = sorted(len(h.yseq) for _, h in out)
                n_calls[search, sec] = len(calls)
        for sec, _, n_frames in requests:
            ms = sorted(x * 1e3 for x in lat[sec])
            med = float(np.median(ms))
            print(f"[{tag}] {search}, {sec:.1f} s audio ({n_frames} frames), {len(ms)} runs, "
                  f"beam {TRANSDUCER_BEAM}: latency median {med:.1f} ms (min {ms[0]:.1f}, max "
                  f"{ms[-1]:.1f}), RTFx at the median {sec / med * 1e3:.2f}; "
                  f"{n_calls[search, sec]} prediction-network calls (lstm_fwd launches) a "
                  f"request; n-best label counts {labels[sec]} [{card}]")
    hook.remove()
    peak = torch.cuda.max_memory_allocated()
    print(f"[{tag}] launches per request: rel_attention_fwd {n_blocks}, dwconv1d_fwd {n_blocks}, "
          f"lstm_fwd one a prediction-network call, nothing else; over all timed requests "
          f"{total}; peak memory {peak} bytes "
          f"({peak / 2**30:.2f} GiB); timed serving took {time.perf_counter() - t_start:.1f} s "
          f"[{card}]")

    # the card's prediction and joint networks against the CPU plain path
    t0 = time.perf_counter()
    cpu = copy.deepcopy(model).cpu().eval()
    gen = torch.Generator().manual_seed(7)
    tokens = torch.randint(1, model.cfg.vocab_size, (TRANSDUCER_BEAM, 200), generator=gen)
    wave = waves[-1]
    with torch.inference_mode():
        enc, lens = model.encode(torch.from_numpy(wave[None]).cuda(),
                                 torch.tensor([wave.shape[0]], device="cuda"))
        g = model.decode_labels(tokens.cuda())
        logits = model.joint_step(enc[0, :TRANSDUCER_BEAM, None, :], g)
        ref_g = cpu.decode_labels(tokens)
        ref_logits = cpu.joint_step(enc[0, :TRANSDUCER_BEAM, None, :].cpu(), ref_g)
    errs = (max_err(g.cpu(), ref_g), max_err(logits.cpu(), ref_logits))
    print(f"[{tag}] LSTM decode_labels [5, 201, 256] and joint_step [5, 201, 5000], card vs CPU "
          f"plain path: max_abs_err {errs[0]:.3e} and {errs[1]:.3e} (tol 1e-4)")
    if not max(errs) <= 1e-4:
        raise AssertionError(f"{tag}: card and CPU disagree: {errs}")
    sec = REQUEST_SECONDS[-1]
    n_check = min(CHECK_FRAMES, enc.shape[1])
    rows, n_rows = enc[:, :n_check], torch.tensor([n_check], device="cuda")
    for search, fn in TRANSDUCER_BEAMS.items():
        with torch.inference_mode():
            got = fn(model, rows, n_rows, beam_size=TRANSDUCER_BEAM, nbest=TRANSDUCER_BEAM)
            ref = fn(cpu, rows.cpu(), n_rows.cpu(), beam_size=TRANSDUCER_BEAM,
                     nbest=TRANSDUCER_BEAM)
        worst = check_nbest(f"{tag} {search}", got, ref)
        print(f"[{tag}] {search} from the first {n_check} encoder rows of the {sec:.1f} s "
              f"request: the card's {len(got)}-best equals the CPU's (largest score error "
              f"{worst:.2e}, tol 1e-3); label counts {[len(h.yseq) for h in got]}")
    del cpu
    print(f"[{tag}] the checks against the CPU took {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    calls = []
    hook = model.decoder.register_forward_hook(lambda *_: calls.append(1))
    s2t = Speech2Text.from_model(model, beam_size=TRANSDUCER_BEAM, nbest=TRANSDUCER_BEAM,
                                 transducer_search="tsd")
    s2t(wave)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    n_calls = len(calls)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        s2t(wave)
        torch.cuda.synchronize()
    hook.remove()
    dev_ms, events = device_busy(prof)
    n_kernels = sum(e.count for e in events)
    rec = [e for e in events if "lstm_fwd_kernel" in e.key]
    rec_n, rec_ms = sum(e.count for e in rec), sum(e.self_device_time_total for e in rec) / 1e3
    if rec_n != n_calls:
        raise AssertionError(f"{tag}: {rec_n} recurrence kernels for {n_calls} calls")
    print(f"[{tag}] tsd {sec:.1f} s request: {wall_s * 1e3:.1f} ms unprofiled; traced (card "
          f"only): device busy {dev_ms:.1f} ms = {100 * dev_ms / 1e3 / wall_s:.1f}% of it; "
          f"{n_calls} prediction-network calls, each one launch of the recurrence kernel over "
          f"the [{TRANSDUCER_BEAM}, {min(200, enc.shape[1] + 1) + 1}] prefix ({rec_n} launches, "
          f"{rec_ms:.1f} ms); {n_kernels} device kernels and copies in all "
          f"({n_kernels / max(n_calls, 1):.1f} a call); profile and its summary took "
          f"{time.perf_counter() - t0:.1f} s")
    print_top(tag, events)
    return total


def phase_train_transducer_mb(waves, kernels, card):
    """The multi-blank LSTM transducer trained as phase 8 trains it, its
    mbg decode of the 10 s request against the CPU from the card's encoder
    rows; then the MEGA transducer, 2 warm-up and 3 timed steps, and its
    prediction network on the card against the CPU at 301 positions (the
    rfft path)."""
    import copy

    from llm_guided_asr_tpu_torch.bin.asr_inference import Speech2Text
    from llm_guided_asr_tpu_torch.search.transducer_extra import transducer_multiblank_greedy

    tag = "train-transducer-mb"
    model = build_transducer_lstm("rnn", multi_blank=True)
    launches, _ = phase_train_transducer(model, kernels, card, tag)
    model.eval()
    cfg = model.cfg
    s2t = Speech2Text.from_model(model, beam_size=1, transducer_search="mbg")
    s2t(waves[0])
    torch.cuda.synchronize()
    reset_counts(kernels)
    calls = []
    hook = model.decoder.register_forward_hook(lambda *_: calls.append(1))
    t0 = time.perf_counter()
    (ids, hyp), = s2t(waves[0])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    hook.remove()
    mbg_launches = counts(kernels)
    want = dict.fromkeys(mbg_launches, 0)
    want.update(rel_attention_fwd=cfg.encoder.num_blocks, dwconv1d_fwd=cfg.encoder.num_blocks,
                lstm_fwd=len(calls))
    if mbg_launches != want or not calls:
        raise AssertionError(f"{tag} mbg: launches {mbg_launches}, {len(calls)} calls")
    with torch.inference_mode():
        enc, lens = model.encode(torch.from_numpy(waves[0][None]).cuda(),
                                 torch.tensor([waves[0].shape[0]], device="cuda"))
        ref = transducer_multiblank_greedy(copy.deepcopy(model).cpu(), enc.cpu(), lens.cpu(),
                                           cfg.big_blank_ids, cfg.multi_blank_durations)[0]
    if hyp.yseq != ref.yseq or not abs(hyp.score - ref.score) <= 1e-3:
        raise AssertionError(f"{tag} mbg: card {hyp.yseq} ({hyp.score}), CPU {ref.yseq} "
                             f"({ref.score})")
    print(f"[{tag}] mbg (big blanks {cfg.big_blank_ids} of {cfg.multi_blank_durations} frames) "
          f"of the 10.0 s request after training: {dt * 1e3:.1f} ms, {len(hyp.yseq)} labels, "
          f"equal to the CPU's from the card's encoder rows (score {hyp.score:.4f} vs "
          f"{ref.score:.4f}); {len(calls)} prediction-network calls; launches {mbg_launches} "
          f"[{card}]")
    del model, s2t
    torch.cuda.empty_cache()

    mega = build_transducer_lstm("mega")
    mega_launches, _ = phase_train_transducer(mega, kernels, card, "train-transducer-mega",
                                              n_warmup=2, n_steps=3, profiled=False)
    mega.eval()
    labels = torch.randint(1, cfg.vocab_size, (TRANSDUCER_BEAM, 300),
                           generator=torch.Generator().manual_seed(8))
    with torch.inference_mode():
        got = mega.decode_labels(labels.cuda())
        want = copy.deepcopy(mega.decoder).cpu()(labels)
    err = max_err(got.cpu(), want)
    print(f"[train-transducer-mega] MEGA decode_labels [5, 301, 256] (rfft path) card vs CPU "
          f"plain path: max_abs_err {err:.3e} (tol 1e-4) [{card}]")
    if not err <= 1e-4:
        raise AssertionError(f"train-transducer-mega: card and CPU disagree: {err}")
    del mega
    torch.cuda.empty_cache()
    return {k: launches[k] + mega_launches[k] + mbg_launches[k] for k in launches}


def build_flash_asr():
    """flash-ASR: bench.py build_flagship's CTC/attention ASRModel with the
    long-form encoder (abs_pos, flash self-attention; head dim 64); vocab
    5000, utterance MVN, SpecAugConfig() and attention dropout 0.1 (used in
    training mode only), float32 with TF32 off, weights from seed 0."""
    from llm_guided_asr_tpu_torch.convert import init_weights
    from llm_guided_asr_tpu_torch.models.asr_model import ASRModel, ASRModelConfig
    from llm_guided_asr_tpu_torch.models.conformer import ConformerConfig
    from llm_guided_asr_tpu_torch.models.transformer_decoder import TransformerDecoderConfig
    from llm_guided_asr_tpu_torch.ops.frontend import FrontendConfig
    from llm_guided_asr_tpu_torch.ops.specaug import SpecAugConfig

    cfg = ASRModelConfig(
        vocab_size=5000, frontend=FrontendConfig(), normalize="utterance_mvn",
        specaug=SpecAugConfig(),
        encoder=ConformerConfig(output_size=256, attention_heads=4, linear_units=1024,
                                num_blocks=12, macaron_style=True, use_cnn_module=True,
                                cnn_module_kernel=31, pos_enc_layer_type="abs_pos",
                                selfattention_layer_type="flash", attention_dropout_rate=0.1),
        decoder=TransformerDecoderConfig(attention_heads=4, linear_units=2048, num_blocks=6),
        ctc_weight=0.3,
    )
    return init_weights(ASRModel(cfg, device="cuda"), seed=0)


def phase_train_flash(model, kernels, card):
    """flash-ASR trained at B=8 x 60 s, text [8, 96] of seeded ids, AdamW
    lr 1e-3: losses finite and falling, 12 launches of each flash and
    depthwise entry point per step, none of the others."""
    from llm_guided_asr_tpu_torch.train.optim import build_optimizer
    from llm_guided_asr_tpu_torch.train.trainer import init_train_state, make_fused_train_step

    state = init_train_state(model, build_optimizer("adamw", {"lr": 1e-3}))
    step = make_fused_train_step(model, state, torch.Generator().manual_seed(3))
    samples = int(FLASH_SECONDS[0] * SR)
    rng = np.random.default_rng(6)
    batch = {
        "speech": torch.from_numpy((rng.standard_normal((FLASH_B, samples)) * 0.1)
                                   .astype(np.float32)).cuda(),
        "speech_lengths": torch.full((FLASH_B,), samples, device="cuda"),
        "text": torch.from_numpy(rng.integers(1, 5000, (FLASH_B, FLASH_TEXT))).cuda(),
        "text_lengths": torch.full((FLASH_B,), FLASH_TEXT, device="cuda"),
    }
    print(f"[train-flash] {sum(p.numel() for p in model.parameters())} parameters, batch "
          f"{FLASH_B} x {FLASH_SECONDS[0]} s, text [{FLASH_B}, {FLASH_TEXT}]")
    all_stats, med, launches = run_steps("train-flash", step, batch, FLASH_WARMUP, FLASH_STEPS,
                                         kernels, card)
    losses = [s["loss"] for s in all_stats]
    if not np.mean(losses[-3:]) < losses[0]:
        raise AssertionError(f"train-flash: loss did not fall: {losses}")
    n_blocks = model.cfg.encoder.num_blocks
    for name, n in launches.items():
        want = n_blocks * FLASH_STEPS if name in FLASH_FWD + FLASH_BWD else 0
        if n != want:
            raise AssertionError(f"train-flash: {name} launched {n} times in {FLASH_STEPS} steps, "
                                 f"expected {want}")
    print(f"[train-flash] audio seconds per second at the median: "
          f"{FLASH_B * FLASH_SECONDS[0] / (med / 1e3):.1f} [{card}]")
    profile_step("train-flash", step, batch, med)
    return launches, med


def phase_golden(kernels, card):
    """The port against the reference's golden fixtures (tests/parity/) on
    the card, at the JAX package's parity tolerances: the Conformer
    CTC/attention model's encoder outputs (13 and 41 frames), CTC and
    decoder log-probs and beam-10, beam-1 and long-utterance hypotheses, and
    the LLM-guided model's loss, decoder log-probs, cached steps and
    beam-10 hypothesis; the reference-trained guided model's decodes and
    CER on the 30-utterance tone corpus; and the reference-trained plain
    model at its three operating points (offline beam 5, LM fusion with the
    reference-trained TransformerLM, the streamed search over 8
    utterances).  Their encoders (2 blocks of 32, head dim 16, conv kernel
    7) run the rel-pos and depthwise forward kernels: 3 encoder passes and
    one an utterance a decode, one launch of each a block; and the
    reference LSTM transducer's tsd, tsd3 and nsc searches, one LSTM
    recurrence launch a prediction-network call."""
    from llm_guided_asr_tpu_torch.bin import golden_check

    reset_counts(kernels)
    errs = golden_check.run_all("cuda")
    torch.cuda.synchronize()
    launches = counts(kernels)
    blocks = golden_check.load_fixture("golden_conformer").meta["blocks"]
    trained = golden_check.load_fixture("golden_trained_guided").meta
    passes = 3 * blocks + (trained["corpus"]["n_train"] + trained["corpus"]["n_valid"]) * trained["blocks"]
    # golden_trained: the corpus offline and with the LM, 8 utterances streamed
    plain = golden_check.load_fixture("golden_trained").meta
    n_utts = plain["corpus"]["n_train"] + plain["corpus"]["n_valid"]
    passes += (2 * n_utts + golden_check.N_STREAMED) * plain["blocks"]
    # golden_transducer: per frame, tsd calls its one-layer LSTM max_sym_exp
    # times, nsc nstep + 2 times (the prefix search and nstep + 1 rounds)
    tr = golden_check.load_fixture("golden_transducer").meta
    lstm_calls = sum(tr["t"] * (c["max_sym_exp"] if c["search_type"] == "tsd" else c["nstep"] + 2)
                     for c in tr["configs"].values() if c["search_type"] in ("tsd", "nsc"))
    for name, n in launches.items():
        want = passes if name in ENCODER_FWD else (lstm_calls if name == "lstm_fwd" else 0)
        if n != want:
            raise AssertionError(f"golden: {name} launched {n} times, expected {want}")
    print("[golden] every check passed: " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
          + f"; launches {launches} [{card}]")
    print("[golden] kernels against their plain versions at the fixtures' shapes: "
          + check_golden_shapes() + f" [{card}]")
    return launches


def check_golden_shapes() -> str:
    """The two forward kernels on their own at the golden fixtures' shapes
    (outside the counted run): rel-pos [2, 2, 13, 16] with 11 valid keys
    in the second row and [1, 2, 41, 16], float32 within 1e-5; depthwise
    [2, 13, 32] and [1, 41, 32] by [7, 32] within 1e-4."""
    from llm_guided_asr_tpu_torch.ops import depthwise_conv as dc
    from llm_guided_asr_tpu_torch.ops import rel_attention as ra

    gen = torch.Generator(device="cuda").manual_seed(9)
    mk = lambda *s: torch.randn(*s, generator=gen, device="cuda")  # noqa: E731
    errs = []
    for b, t, lens in ((2, 13, (13, 11)), (1, 41, (41,))):
        h, dk = 2, 16
        qu, qv, k, v = (mk(b, h, t, dk) for _ in range(4))
        p, sm = mk(h, 2 * t - 1, dk), 1.0 / math.sqrt(dk)
        kv_valid = (torch.arange(t, device="cuda")[None] < torch.tensor(lens, device="cuda")[:, None]
                    ).to(torch.int32)
        out, _ = ra.rel_attention_fwd(qu, qv, k, v, p, kv_valid, sm)
        ref = ra.rel_attention_plain(qu, qv, k, v, p, kv_valid, sm)
        x, w = mk(b, t, 32), mk(7, 32)
        y, y_ref = dc.depthwise_conv1d(x, w), dc.depthwise_conv1d_plain(x, w)
        torch.cuda.synchronize()
        for name, got, want, tol in (("rel_attention_fwd", out, ref, 1e-5),
                                     ("dwconv1d_fwd", y, y_ref, 1e-4)):
            err = max_err(got, want)
            if not err <= tol:
                raise AssertionError(f"golden shapes: {name} [{b},{t}]: {err} > {tol}")
            errs.append(f"{name} [{b},{t}] {err:.2e}")
    return ", ".join(errs)


def build_serve_asr(encoder_type="conformer", normalize="utterance_mvn", decoder_type="transformer",
                    decoder=None, train=False, frontend=None, model=None, **encoder):
    """The CTC/attention ASRModel of phase 5 (bench.py build_flagship: vocab
    5000, Conformer 12 x 256 with 4 heads, decoder 6 x 256) for serving,
    float32 with TF32 off, weights from seed 0; ``encoder`` overrides the
    encoder's fields, ``decoder`` the decoder's (of ``decoder_type``),
    ``frontend`` the log-mel FrontendConfig(), ``model`` any other
    ASRModelConfig field (``frontend`` None among them).  ``train``:
    SpecAug and attention dropout 0.1 as train-1 trains, in training
    mode."""
    from llm_guided_asr_tpu_torch.convert import init_weights
    from llm_guided_asr_tpu_torch.models.asr_model import ASRModel, ASRModelConfig
    from llm_guided_asr_tpu_torch.models.conformer import ConformerConfig
    from llm_guided_asr_tpu_torch.models.transformer_decoder import TransformerDecoderConfig
    from llm_guided_asr_tpu_torch.ops.frontend import FrontendConfig
    from llm_guided_asr_tpu_torch.ops.specaug import SpecAugConfig

    enc = {**dict(output_size=256, attention_heads=4, linear_units=1024, num_blocks=12,
                  macaron_style=True, use_cnn_module=True, cnn_module_kernel=31), **encoder}
    if train:
        enc["attention_dropout_rate"] = 0.1
    dec = {**dict(attention_heads=4, linear_units=2048, num_blocks=6), **(decoder or {})}
    cfg = ASRModelConfig(**{
        "vocab_size": 5000, "frontend": frontend or FrontendConfig(), "normalize": normalize,
        "specaug": SpecAugConfig() if train else None,
        "encoder_type": encoder_type, "encoder": ConformerConfig(**enc),
        "decoder_type": decoder_type, "decoder": TransformerDecoderConfig(**dec),
        "ctc_weight": 0.3, **(model or {})})
    model = init_weights(ASRModel(cfg, device="cuda"), seed=0)
    return model.train() if train else model.eval()


def phase_serve_lm(kernels, card):
    """Phase 5's ASRModel served with shallow fusion: a TransformerLM at the
    widths of ESPnet's LibriSpeech recipe (embed 128, att 512, 8 heads,
    2048 units, 16 layers, vocab 5000, sinusoidal positions; weights from
    seed 0), lm_weight 0.6, beam 10, ctc_weight 0.3, the 24-token cap: one
    warm-up request of each length, then each ROUNDS times; the launch
    counts (12 of each encoder forward a request, no backward), peak memory,
    one profiled 10 s request (busy share, top kernels, the LM's share of
    the device time), and the card's LM log-probs against the CPU plain
    path on one prefix batch (1e-4)."""
    import copy

    from torch.profiler import ProfilerActivity, profile, record_function

    from llm_guided_asr_tpu_torch.bin.asr_inference import Speech2Text
    from llm_guided_asr_tpu_torch.convert import init_weights
    from llm_guided_asr_tpu_torch.models.lm import TransformerLM, TransformerLMConfig, make_lm_score_fn

    model = build_serve_asr()
    lm = init_weights(TransformerLM(TransformerLMConfig(vocab_size=5000, dropout_rate=0.0,
                                                        **LM_CONF), device="cuda"), seed=0).eval()
    n_lm = sum(p.numel() for p in lm.parameters())
    print(f"[serve-lm] ASRModel {sum(p.numel() for p in model.parameters())} parameters, "
          f"TransformerLM {n_lm} parameters ({LM_CONF}), lm_weight {LM_WEIGHT}")
    score = make_lm_score_fn(lm)

    def lm_score(tokens, lengths):
        with record_function("lm_score"):
            return score(tokens, lengths)

    s2t = Speech2Text.from_model(model, ctc_weight=0.3, beam_size=10, maxlenratio=-24.0,
                                 lm=lm_score, lm_weight=LM_WEIGHT)
    waves = request_waves()
    for sec, wave in zip(REQUEST_SECONDS, waves):
        t0 = time.perf_counter()
        s2t(wave)
        torch.cuda.synchronize()
        print(f"[serve-lm] warm-up request, {sec:.1f} s audio: "
              f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)
    lat = {sec: [] for sec in REQUEST_SECONDS}
    hyps = []
    for _ in range(ROUNDS):
        for sec, wave in zip(REQUEST_SECONDS, waves):
            t0 = time.perf_counter()
            (ids, hyp), = s2t(wave)
            torch.cuda.synchronize()
            lat[sec].append(time.perf_counter() - t0)
            hyps.append((ids, hyp))
    launches = counts(kernels)
    peak = torch.cuda.max_memory_allocated()
    for sec in REQUEST_SECONDS:
        ms = sorted(x * 1e3 for x in lat[sec])
        med = float(np.median(ms))
        print(f"[serve-lm] {sec:.1f} s audio, {len(ms)} runs: latency median {med:.1f} ms "
              f"(min {ms[0]:.1f}, max {ms[-1]:.1f}), RTFx at the median {sec / med * 1e3:.2f} "
              f"[{card}]")
    print(f"[serve-lm] torch.cuda.max_memory_allocated: {peak} bytes ({peak / 2**30:.2f} GiB)")
    for i, (ids, hyp) in enumerate(hyps):
        want = 0.7 * hyp.scores["decoder"] + 0.3 * hyp.scores["ctc"] + LM_WEIGHT * hyp.scores["lm"]
        if not (math.isfinite(hyp.score) and abs(hyp.score - want) <= 1e-3 * max(1.0, abs(want))):
            raise AssertionError(f"serve-lm: score {hyp.score} != weighted parts {want}")
        if not all(0 <= t < 5000 for t in ids) or ids != hyps[i % len(REQUEST_SECONDS)][0]:
            raise AssertionError(f"serve-lm: bad or unsteady hypothesis {hyp}")
    for sec, (ids, hyp) in zip(REQUEST_SECONDS, hyps):
        print(f"[serve-lm] {sec:.1f} s audio: hyp {len(ids)} tokens, score {hyp.score:.4f} "
              f"{hyp.scores}")
    n_req = len(hyps)
    print(f"[serve-lm] kernel launches over {n_req} requests: {launches}")
    for name, n in launches.items():
        want = model.cfg.encoder.num_blocks * n_req if name in ENCODER_FWD else 0
        if n != want:
            raise AssertionError(f"serve-lm: {name}: {n} launches, expected {want}")
    med10 = float(np.median(lat[REQUEST_SECONDS[0]])) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        s2t(waves[0])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # the LM's range is also a span on the card's timeline (first to last
    # kernel, gaps included): it is left out of the busy sum, and the LM's
    # device time is its kernels' time, read from the host-side range
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and e.key != "lm_score"]
    dev_ms = sum(e.self_device_time_total for e in events) / 1e3
    lm_ev = [e for e in prof.key_averages()
             if e.key == "lm_score" and e.device_type == torch.autograd.DeviceType.CPU]
    lm_ms = lm_ev[0].device_time_total / 1e3 if lm_ev else float("nan")
    print(f"[serve-lm] {REQUEST_SECONDS[0]} s request traced (host and card): wall "
          f"{wall * 1e3:.1f} ms, device busy {dev_ms:.1f} ms = {100 * dev_ms / med10:.1f}% of the "
          f"unprofiled median latency; the LM's kernels {lm_ms:.1f} ms = "
          f"{100 * lm_ms / max(dev_ms, 1e-9):.1f}% of the device time "
          f"({lm_ev[0].count if lm_ev else 0} LM calls) [{card}]")
    print_top("serve-lm", events)

    # the card's LM against the plain path on the CPU, one prefix batch
    rng = np.random.default_rng(5)
    tokens = torch.from_numpy(rng.integers(0, 5000, (10, 26)))
    lens = torch.from_numpy(rng.integers(1, 27, 10))
    with torch.inference_mode():
        got = score(tokens.cuda(), lens.cuda()).cpu()
        want = make_lm_score_fn(copy.deepcopy(lm).cpu())(tokens, lens)
    err = (got - want).abs().max().item()
    print(f"[serve-lm] LM log-probs card vs CPU, [10, 26] prefixes: max_abs_err {err:.3e} "
          f"(tol 1e-4)")
    if not err <= 1e-4:
        raise AssertionError(f"serve-lm: the card's LM disagrees with the CPU: {err}")
    return launches


def phase_serve_stream(kernels, card):
    """A streaming ASRModel (contextual-block Conformer at the widths of
    ESPnet's AISHELL streaming Conformer: 12 x 256, 4 heads, 2048 units,
    cnn kernel 15, block 40; global MVN with seeded statistics; decoder
    6 x 256 with 2048 units; vocab 5000; weights from seed 0) fed phase
    3's 10 s request in 1 s chunks through Speech2TextStreaming (beam 10,
    ctc_weight 0.3, the 24-token cap), once to warm up and ROUNDS times
    timed: each chunk's latency and the last one's; 12 depthwise launches
    a completed block and no rel-pos launch; the streamed encoder rows
    against an offline encode (1e-5); the final hypothesis against the
    offline decode (equal tokens; the score gap printed and held to the
    JAX test's 0.5: the streamed search keeps only the blank row of the
    carried CTC state) and against the same resumable search replayed over
    the offline encoder's rows with the stream's own cuts and budgets
    (score within 1e-4)."""
    from llm_guided_asr_tpu_torch.bin.asr_inference_streaming import Speech2TextStreaming

    model = build_serve_asr(encoder_type="contextual_block_conformer", normalize="global_mvn",
                            linear_units=2048, cnn_module_kernel=STREAM_KERNEL,
                            block_size=STREAM_BLOCK)
    seed_stream_mvn(model)
    print("[serve-stream] AISHELL streaming Conformer widths; the recipe's hop_size 16 and "
          "look_ahead 16 have no counterpart in the JAX encoder (context: mean-pooled blocks)")
    kw = dict(beam_size=10, ctc_weight=0.3, maxlenratio=-24.0)
    st = Speech2TextStreaming(model, chunk_samples=STREAM_CHUNK, **kw)
    wave = request_waves()[0]
    sec = REQUEST_SECONDS[0]

    steps = []  # (old, new, maxlen, minlen) of each resumed search, for the replay
    stream_step = st.beam.stream_step

    def logged_step(enc_buf, old, new, maxlen, minlen, carry, ctc_logp):
        steps.append((int(old), int(new), int(maxlen), int(minlen)))
        return stream_step(enc_buf, old, new, maxlen, minlen, carry, ctc_logp)

    st.beam.stream_step = logged_step

    def stream_once():
        st.reset()
        steps.clear()
        chunk_ms, out = [], None
        for start in range(0, len(wave), STREAM_CHUNK):
            t0 = time.perf_counter()
            out = st(wave[start: start + STREAM_CHUNK], is_final=start + STREAM_CHUNK >= len(wave))
            torch.cuda.synchronize()
            chunk_ms.append((time.perf_counter() - t0) * 1e3)
        return chunk_ms, out

    stream_once()  # warm-up
    reset_counts(kernels)
    runs = [stream_once() for _ in range(ROUNDS)]
    launches = counts(kernels)
    mids = sorted(ms for chunk_ms, _ in runs for ms in chunk_ms[:-1])
    finals = sorted(chunk_ms[-1] for chunk_ms, _ in runs)
    print(f"[serve-stream] {sec:.1f} s request in {len(runs[0][0])} chunks of "
          f"{STREAM_CHUNK / SR:.1f} s, {ROUNDS} runs: chunk latency median "
          f"{float(np.median(mids)):.1f} ms (max {mids[-1]:.1f}); the last chunk (to the final "
          f"hypothesis) median {float(np.median(finals)):.1f} ms (max {finals[-1]:.1f}) [{card}]")
    # the offline encode of the request padded by one bucket of 1600 zeros (as
    # a wider batch pads it): alone, 10 s fill their 1251 feature frames
    # exactly and the subsampling's width clamps the length to 312, while
    # the stream's last sub-frame reads zero frames past the end (313)
    with torch.inference_mode():
        speech = torch.from_numpy(np.pad(wave, (0, 1600))[None]).cuda()
        enc, enc_lens = model.encode(speech, torch.tensor([len(wave)], device="cuda"))
    n_frames = int(enc_lens[0])
    blocks = -(-n_frames // STREAM_BLOCK)
    print(f"[serve-stream] kernel launches over {ROUNDS} streamed requests ({n_frames} encoder "
          f"frames, {blocks} blocks each): {launches}")
    for name, n in launches.items():
        want = model.cfg.encoder.num_blocks * blocks * ROUNDS if name in STREAM_FWD else 0
        if n != want:
            raise AssertionError(f"serve-stream: {name}: {n} launches, expected {want}")

    # the stream once more, kept after the last chunk: its encoder rows and
    # final hypothesis against the offline encode and decode
    st.reset()
    steps.clear()
    for start in range(0, len(wave), STREAM_CHUNK):
        st._buffer = np.concatenate([st._buffer, wave[start: start + STREAM_CHUNK]])
        with torch.inference_mode():
            st._advance(start + STREAM_CHUNK >= len(wave))
    st_rows = st._enc[: st._sub_done]
    hyp = st.beam.stream_hyps(st._carry)[0]
    ids = [t for t in hyp.yseq if t not in (model.cfg.sos_id, model.cfg.eos_id)]
    if ids != runs[-1][1][0][0]:
        raise AssertionError("serve-stream: the same request streamed to another hypothesis")
    if st._sub_done != n_frames:
        raise AssertionError(f"serve-stream: {st._sub_done} streamed frames, offline {n_frames}")
    enc_err = (st_rows - enc[0, :n_frames]).abs().max().item()
    off_hyp = st.beam(enc, enc_lens, maxlenratio=-24.0)[0]
    off_ids = [t for t in off_hyp.yseq if t not in (model.cfg.sos_id, model.cfg.eos_id)]
    gap = abs(hyp.score - off_hyp.score)
    print(f"[serve-stream] streamed encoder rows vs offline encode: max_abs_err {enc_err:.3e} "
          f"(tol 1e-5); final hypothesis {len(ids)} tokens, score {hyp.score:.4f}; offline "
          f"{len(off_ids)} tokens, score {off_hyp.score:.4f} (gap {gap:.4e})")
    if not enc_err <= 1e-5:
        raise AssertionError(f"serve-stream: streamed encoder rows differ: {enc_err}")
    if ids != off_ids or not gap <= 0.5:
        raise AssertionError(f"serve-stream: streamed {ids} ({hyp.score}) != offline {off_ids} "
                             f"({off_hyp.score})")
    # the resumable search replayed over the offline rows with the stream's cuts
    beam = st.beam
    with torch.inference_mode():
        ctc = model.ctc_log_softmax(enc)[0, :n_frames]
        cap = st._cap
        enc_buf = torch.zeros(1, cap, enc.shape[2], device="cuda")
        ctc_buf = torch.zeros(cap, ctc.shape[1], device="cuda")
        carry = None
        for old, new, maxlen, minlen in steps:
            enc_buf[0, :new], ctc_buf[:new] = enc[0, :new], ctc[:new]
            if carry is None:
                carry = beam.stream_start(ctc_buf, enc_buf, new, cap + 2)
            carry = stream_step(enc_buf, old, new, maxlen, minlen, carry, ctc_buf)
        replay = beam.stream_hyps(carry)[0]
    r_ids = [t for t in replay.yseq if t not in (model.cfg.sos_id, model.cfg.eos_id)]
    r_err = abs(replay.score - hyp.score)
    print(f"[serve-stream] the stream's {len(steps)} resumed searches replayed over the offline "
          f"rows: score error {r_err:.3e} (tol 1e-4), tokens equal {r_ids == ids} [{card}]")
    if r_ids != ids or not r_err <= 1e-4:
        raise AssertionError(f"serve-stream: replay {r_ids} ({replay.score}) != stream {ids}")
    return launches


CLI_TEMPLATE = 'fix "((HYP))" -> "'
CLI_DECODE = ["--beam_size", "10", "--ctc_weight", "0.3", "--maxlenratio", "-24"]


def cli_config(root: Path, splits: dict, **over) -> dict:
    """Part A's task config: build_train1's widths (Conformer 12x256, 4
    heads, 1024 units, kernel 31, macaron, attention dropout 0.1; decoder
    6x256, 4 heads, 2048 units; ctc_weight 0.3), the default frontend,
    SpecAug, global MVN, a 5,000-entry word token list, AdamW with warmuplr,
    sorted batches of 32, 2 epochs, 2-best; ``device: null`` (the card)."""
    cfg = {
        "token_type": "word", "token_list": str(root / "tokens.txt"),
        "specaug": "specaug", "normalize": "global_mvn",
        "encoder": "conformer",
        "encoder_conf": {"output_size": 256, "attention_heads": 4, "linear_units": 1024,
                         "num_blocks": 12, "macaron_style": True, "use_cnn_module": True,
                         "cnn_module_kernel": 31, "attention_dropout_rate": 0.1},
        "decoder": "transformer",
        "decoder_conf": {"attention_heads": 4, "linear_units": 2048, "num_blocks": 6},
        "model_conf": {"ctc_weight": 0.3},
        "optim": "adamw", "optim_conf": {"lr": 1.0e-3},
        "scheduler": "warmuplr", "scheduler_conf": {"warmup_steps": 6},
        "batch_type": "sorted", "batch_size": RUN_B, "max_epoch": 2, "keep_nbest_models": 2,
        "log_interval": 2, "seed": 0, "device": None,
        "train_data_path_and_name_and_type": [[str(splits["train"][0]), "speech", "sound"],
                                              [str(splits["train"][1]), "text", "text"]],
        "valid_data_path_and_name_and_type": [[str(splits["valid"][0]), "speech", "sound"],
                                              [str(splits["valid"][1]), "text", "text"]],
    }
    cfg.update(over)
    return cfg


def cli_launch_check(tag: str, launches: dict, fwd: int, bwd: int):
    for name, n in launches.items():
        want = {"rel_attention_fwd": fwd, "dwconv1d_fwd": fwd, "rel_attention_bwd": bwd,
                "dwconv1d_bwd": bwd}.get(name, 0)
        if n != want:
            raise AssertionError(f"asr-cli {tag}: {name} launched {n} times, expected {want}")


def read_scores(d: Path) -> dict:
    """1best_recog/score* files -> {file: {uid: float}}."""
    return {p.name: {u: float(v) for u, v in (line.split() for line in p.read_text().splitlines())}
            for p in sorted((d / "1best_recog").glob("score*"))}


def check_cli_scores(tag: str, d: Path, lm_weight: float = 0.0) -> dict:
    """Every hypothesis's score = 0.7 decoder + 0.3 ctc [+ lm_weight lm]."""
    sc = read_scores(d)
    for uid, total in sc["score"].items():
        want = 0.7 * sc["score_decoder"][uid] + 0.3 * sc["score_ctc"][uid]
        if lm_weight:
            want += lm_weight * sc["score_lm"][uid]
        if not (math.isfinite(total) and abs(total - want) <= 1e-3 * max(1.0, abs(want))):
            raise AssertionError(f"asr-cli {tag}: {uid} score {total} != weighted parts {want}")
    return sc


def read_rtf(d: Path) -> dict:
    return {k: float(v) for k, v in (line.split() for line in (d / "rtf").read_text().splitlines())}


def phase_asr_cli(kernels, card, root=None):
    """Phase 16: the task and CLI layer on the card, driven only through the
    CLIs' main(argv) in process, in a temporary directory.  A: phase 15's
    corpus with word text, collect_stats, 2 epochs of the flagship from a
    YAML config, a beam-10 decode of the valid split, scoring.  B: the
    LLM-guided config (tests/parity/tiny_llm_bpe) with part A's encoder by
    init_param, frozen, 1 epoch and a beam-10 decode of 2 utterances.  C: a
    TransformerLM at LM_CONF's widths for 1 epoch, its perplexity, and part
    A's model decoded with it (lm_weight 0.3).  ``root``: a directory to
    keep the files in (phase 35 reads them), else a temporary one."""
    import contextlib
    import tempfile

    from llm_guided_asr_tpu_torch.bin import (
        asr_inference,
        asr_train,
        lm_calc_perplexity,
        lm_train,
        score,
    )
    from llm_guided_asr_tpu_torch.bin.asr_inference import Speech2Text
    from llm_guided_asr_tpu_torch.data.fileio import read_2columns_text, read_wav
    from llm_guided_asr_tpu_torch.tasks.asr import ASRTask
    from llm_guided_asr_tpu_torch.train.checkpoint import load
    from llm_guided_asr_tpu_torch.train.reporter import Reporter
    from llm_guided_asr_tpu_torch.utils.config import dump_yaml

    total = {}

    def run(tag, fn, *args):
        torch.cuda.synchronize()
        reset_counts(kernels)
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        launches = counts(kernels)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        return out, sec, launches

    with (contextlib.nullcontext(str(root)) if root is not None
          else tempfile.TemporaryDirectory(prefix="asr-cli-")) as tmp:
        root = Path(tmp)
        # ---- A: the flagship through the CLIs ----
        splits = write_run_corpus(root)
        for split in ("train", "valid"):  # text_int -> words w0002..w4998 (w0001: <unk>)
            lines = splits[split][1].read_text().splitlines()
            (root / f"{split}.words").write_text("".join(
                u + " " + " ".join(f"w{int(t):04d}" for t in rest.split()) + "\n"
                for u, rest in (line.split(maxsplit=1) for line in lines)))
            splits[split] = (splits[split][0], root / f"{split}.words", splits[split][2])
        tokens = ["<blank>", "<unk>"] + [f"w{i:04d}" for i in range(2, 4999)] + ["<sos/eos>"]
        (root / "tokens.txt").write_text("\n".join(tokens) + "\n")
        dump_yaml(cli_config(root, splits), root / "train.yaml")
        stats_dir, exp = root / "stats", root / "exp"
        _, sec, launches = run("collect", asr_train.main, [
            "--config", str(root / "train.yaml"), "--collect_stats", "true",
            "--output_dir", str(stats_dir)])
        npz = np.load(stats_dir / "train" / "feats_stats.npz")
        want_frames = sum(len(read_wav(p)[1]) // 128 + 1 for p in
                          read_2columns_text(splits["train"][0]).values())
        if int(npz["count"]) != want_frames or not np.isfinite(npz["sum_square"]).all():
            raise AssertionError(f"asr-cli: feats_stats counts {int(npz['count'])} frames, "
                                 f"expected {want_frames}")
        cli_launch_check("collect_stats", launches, 0, 0)
        print(f"[asr-cli] A collect_stats: {RUN_UTTS} utterances in {sec:.2f} s, "
              f"{want_frames} train frames counted [{card}]")
        state, sec, launches = run("train", asr_train.main, [
            "--config", str(root / "train.yaml"), "--output_dir", str(exp),
            "--normalize_conf", f"stats_file={stats_dir / 'train' / 'feats_stats.npz'}"])
        n_train, n_valid, blocks = RUN_TRAIN // RUN_B, -(-(RUN_UTTS - RUN_TRAIN) // RUN_B), 12
        cli_launch_check("A train", launches, 2 * blocks * (n_train + n_valid),
                         2 * blocks * n_train)
        reporter = Reporter.load(exp / "reporter.json")
        for e in (1, 2):
            st = reporter.stats[e]
            bad = {f"{ph} {k}": v for ph in ("train", "valid") for k, v in st[ph].items()
                   if not math.isfinite(v)}
            if bad:
                raise AssertionError(f"asr-cli A: epoch {e}: {bad}")
            saves = sum(s for _, s, _ in state.saves[2 * (e - 1):2 * e])
            wall = st["train"]["time"] + st["valid"]["time"] + saves
            print(f"[asr-cli] A epoch {e}: wall {wall:.2f} s (train, valid, saves); train "
                  f"{st['train']['time']:.2f} s = "
                  f"{splits['train'][2] / st['train']['time']:.1f} audio s/s; loss "
                  f"{st['train']['loss']!r}, valid loss {st['valid']['loss']!r} [{card}]")
        for name, s_, size in state.saves:
            print(f"[asr-cli] A saved {name}: {s_:.3f} s, {size} bytes [{card}]")
        print(f"[asr-cli] A train: 2 epochs in {sec:.1f} s, {state.step} updates; launches "
              f"{launches} [{card}]")
        ave = exp / "valid.loss.ave_2best.pth"
        model, _ = ASRTask.build_model_from_file(exp / "config.yaml", ave)
        want = {k: tuple(v.shape) for k, v in build_train1().state_dict().items()}
        got = {k: tuple(v.shape) for k, v in model.state_dict().items()
               if k not in ("mvn_mean", "mvn_inv_std")}
        if got != want:
            raise AssertionError(f"asr-cli A: parameters differ from build_train1(): "
                                 f"{sorted(set(got) ^ set(want))[:5]}")
        del model
        dec = root / "decode"
        _, sec, launches = run("decode", asr_inference.main, [
            "--asr_train_config", str(exp / "config.yaml"), "--asr_model_file", str(ave),
            "--data_path_and_name_and_type", f"{splits['valid'][0]},speech,sound",
            "--output_dir", str(dec)] + CLI_DECODE)
        n_dec = RUN_UTTS - RUN_TRAIN
        cli_launch_check("A decode", launches, blocks * n_dec, 0)
        sc = check_cli_scores("A", dec)
        hyp_tokens = read_2columns_text(dec / "1best_recog" / "token")
        if sorted(sc["score"]) != sorted(read_2columns_text(splits["valid"][0])):
            raise AssertionError("asr-cli A: 1best_recog misses utterances")
        s2t = Speech2Text(exp / "config.yaml", ave, ctc_weight=0.3, beam_size=10,
                          maxlenratio=-24.0)
        gap = 0.0
        for uid, path in read_2columns_text(splits["valid"][0]).items():
            text, toks, ids, hyp = s2t(read_wav(path)[1])[0]
            gap = max(gap, abs(hyp.score - sc["score"][uid]))
            if " ".join(toks) != hyp_tokens.get(uid, "") or not gap <= 1e-4:
                raise AssertionError(f"asr-cli A: {uid}: Speech2Text(config.yaml, checkpoint) "
                                     f"gives {toks} {hyp.score}, the CLI wrote "
                                     f"{hyp_tokens.get(uid)} {sc['score'][uid]}")
        del s2t
        rtf = read_rtf(dec)
        result = score.main(["--ref", str(splits["valid"][1]),
                             "--hyp", str(dec / "1best_recog" / "text"),
                             "--output_dir", str(root / "score")])
        print(f"[asr-cli] A decode: {n_dec} utterances, {rtf['audio_s']:.1f} s of audio in "
              f"{rtf['decode_s']:.2f} s: RTF {rtf['RTF']:.4f}, RTFx {rtf['RTFx']:.2f}; the CLI's "
              f"hypotheses = Speech2Text(config.yaml, checkpoint)'s (scores within {gap:.1e}, "
              f"tol 1e-4); WER {result['err']:.2f} (noise corpus) [{card}]")

        # ---- B: the LLM-guided config through the CLIs ----
        llm_dir = Path(__file__).resolve().parent / "tests" / "parity" / "tiny_llm_bpe"
        rng = np.random.default_rng(16)
        letters = list("abcdefghijklmnopqrstuvwxyz")
        for split in ("train", "valid"):
            uids = list(read_2columns_text(splits[split][0]))
            (root / f"{split}.letters").write_text("".join(
                f"{u} {''.join(rng.choice(letters) for _ in range(rng.integers(4, 12)))}\n"
                for u in uids))
        two = root / "valid2.scp"
        two.write_text("".join(splits["valid"][0].read_text().splitlines(keepends=True)[:2]))
        gcfg = cli_config(
            root, splits, model="llm_guided_asr", llm="llama", token_type="hugging_face",
            token_list=None, max_epoch=1, keep_nbest_models=1,
            llm_conf={"model_name_or_path": str(llm_dir), "template_prompt": CLI_TEMPLATE,
                      "pad_token": "<pad>"},
            normalize_conf={"stats_file": str(stats_dir / "train" / "feats_stats.npz")},
            init_param=[f"{ave}:encoder:encoder"], freeze_param=["encoder"],
            train_data_path_and_name_and_type=[[str(splits["train"][0]), "speech", "sound"],
                                               [str(root / "train.letters"), "text", "text"]],
            valid_data_path_and_name_and_type=[[str(splits["valid"][0]), "speech", "sound"],
                                               [str(root / "valid.letters"), "text", "text"]])
        dump_yaml(gcfg, root / "guided.yaml")
        gexp = root / "gexp"
        gstate, sec, launches = run("guided", asr_train.main, [
            "--config", str(root / "guided.yaml"), "--output_dir", str(gexp)])
        cli_launch_check("B train", launches, blocks * (n_train + n_valid), 0)
        gst = Reporter.load(gexp / "reporter.json").stats[1]
        if not all(math.isfinite(gst[ph]["loss"]) for ph in ("train", "valid")):
            raise AssertionError(f"asr-cli B: losses {gst}")
        for path in sorted(gexp.glob("*.pth")):
            obj = load(path)
            keys = obj["model"] if "model" in obj else obj
            if not keys or any(k == "llm" or k.startswith("llm.") for k in keys):
                raise AssertionError(f"asr-cli B: {path.name} holds an llm tensor")
        enc_a, enc_b = load(ave), load(gexp / "valid.loss.ave_1best.pth")
        moved = [k for k in enc_a if k.startswith("encoder.") and not torch.equal(enc_a[k],
                                                                                   enc_b[k])]
        if moved:
            raise AssertionError(f"asr-cli B: the frozen encoder moved: {moved[:5]}")
        gdec = root / "gdecode"
        _, dsec, dlaunch = run("guided decode", asr_inference.main, [
            "--asr_train_config", str(gexp / "config.yaml"),
            "--asr_model_file", str(gexp / "valid.loss.ave_1best.pth"),
            "--data_path_and_name_and_type", f"{two},speech,sound",
            "--output_dir", str(gdec)] + CLI_DECODE)
        cli_launch_check("B decode", dlaunch, blocks * 2, 0)
        gsc = check_cli_scores("B", gdec)
        print(f"[asr-cli] B guided: 1 epoch with part A's encoder frozen in {sec:.1f} s, loss "
              f"{gst['train']['loss']:.4f}, valid {gst['valid']['loss']:.4f}; no .pth holds an "
              f"llm tensor; 2 utterances decoded at beam 10 (cached guided scorer) in "
              f"{dsec:.2f} s, RTFx {read_rtf(gdec)['RTFx']:.2f}, scores "
              f"{list(gsc['score'].values())} [{card}]")

        # ---- C: the LM through the CLIs ----
        lm_yaml = root / "lm.yaml"
        dump_yaml({"token_type": "word", "token_list": str(root / "tokens.txt"),
                   "lm": "transformer", "lm_conf": {**LM_CONF, "dropout_rate": 0.0},
                   "optim": "adamw", "optim_conf": {"lr": 1.0e-3}, "max_epoch": 1,
                   "keep_nbest_models": 1, "batch_size": 64,
                   "train_data_path_and_name_and_type": [[str(splits["train"][1]), "text",
                                                          "text"]],
                   "valid_data_path_and_name_and_type": [[str(splits["valid"][1]), "text",
                                                          "text"]]}, lm_yaml)
        lexp = root / "lmexp"
        lstate, sec, _ = run("lm train", lm_train.main,
                             ["--config", str(lm_yaml), "--output_dir", str(lexp)])
        lm_file = lexp / "valid.loss.ave_1best.pth"
        ppl, psec, _ = run("perplexity", lm_calc_perplexity.main, [
            "--train_config", str(lexp / "config.yaml"), "--model_file", str(lm_file),
            "--data_path_and_name_and_type", f"{splits['valid'][1]},text,text"])
        if not math.isfinite(ppl):
            raise AssertionError(f"asr-cli C: perplexity {ppl}")
        ldec = root / "ldecode"
        _, dsec, dlaunch = run("lm decode", asr_inference.main, [
            "--asr_train_config", str(exp / "config.yaml"), "--asr_model_file", str(ave),
            "--data_path_and_name_and_type", f"{two},speech,sound", "--output_dir", str(ldec),
            "--lm_train_config", str(lexp / "config.yaml"), "--lm_file", str(lm_file),
            "--lm_weight", "0.3"] + CLI_DECODE)
        cli_launch_check("C decode", dlaunch, blocks * 2, 0)
        lsc = check_cli_scores("C", ldec, lm_weight=0.3)
        print(f"[asr-cli] C LM ({LM_CONF}): 1 epoch in {sec:.1f} s, {lstate.step} updates; "
              f"valid perplexity {ppl:.2f} in {psec:.2f} s; 2 utterances decoded with "
              f"lm_weight 0.3 in {dsec:.2f} s, RTFx {read_rtf(ldec)['RTFx']:.2f}, LM parts "
              f"{list(lsc['score_lm'].values())} [{card}]")
    print(f"[asr-cli] kernel launches over the phase: {total}")
    return total


# phases 19-21: LLM-guided speech translation and the recipe inputs
ST_B, ST_WARMUP, ST_STEPS = 8, 1, 5
ST_SRC_LEN, ST_TGT_LEN = 24, 16  # source and translation tokens of a 10 s utterance
# the ST model's LLM depth at Llama-3.2-1B's widths: 4 of its 16 layers (its
# full-prefix scorer runs the LLM over every row's whole prefix each step,
# 2.2-2.7 s a request at 16), the depth cut that pays for phases 36-37's
# new twins
ST_LLM_LAYERS = 4
RECIPE_UTTS, RECIPE_TRAIN = 24, 16  # the first of phase 15's utterances, flac
RECIPE_LLM = Path(__file__).resolve().parent / "tests" / "parity" / "tiny_llm_bytelevel"
RECIPE_WORDS = ("hello", "world", "speech", "model", "guided", "large", "language", "the",
                "numbers", "translate", "café", "zwölf")


def build_st(num_blocks=None):
    """Phase 3's model as LLMGuidedSTModel: the same Conformer (or its first
    ``num_blocks`` blocks), guided decoder and Llama-3.2-1B's widths (bf16)
    at ST_LLM_LAYERS layers, its source vocabulary the LLM's
    (tasks/st.py:96), an extra ASR decoder at the guided decoder's widths,
    SpecAug for phase 20; asr_weight 0.3, mtlalpha 0.5, lsm_weight 0.1;
    weights from seed 0."""
    import dataclasses

    from llm_guided_asr_tpu_torch.convert import init_weights
    from llm_guided_asr_tpu_torch.models.llm_guided_st import LLMGuidedSTConfig, LLMGuidedSTModel
    from llm_guided_asr_tpu_torch.ops.specaug import SpecAugConfig

    parts = serve_parts()
    parts["llm"] = dataclasses.replace(parts["llm"], num_hidden_layers=ST_LLM_LAYERS)
    if num_blocks is not None:
        parts["encoder"] = dataclasses.replace(parts["encoder"], num_blocks=num_blocks)
    cfg = LLMGuidedSTConfig(src_vocab_size=parts["vocab_size"], specaug=SpecAugConfig(),
                            extra_asr_decoder=parts["decoder"], asr_weight=0.3, mtlalpha=0.5,
                            lsm_weight=0.1, **parts)
    model = LLMGuidedSTModel(cfg, llm_dtype=torch.bfloat16, device="cuda")
    return init_weights(model, seed=0).eval()


def phase_serve_st(model, kernels, card):
    """Phase 19: the ST model serving the 10.0, 7.3 and 4.1 s requests at
    B=1 through Speech2Translation at its JAX defaults (beam 5, ctc_weight
    0, the 48-token cap, the full-prefix scorer): one warm-up each, then
    ROUNDS timed runs; 12 launches of each encoder forward a request; the
    5-best sorted and finite; the 10 s request profiled; the encoder on the
    card against the CPU plain path (1e-3)."""
    from torch.profiler import ProfilerActivity, profile

    from llm_guided_asr_tpu_torch.bin.st_inference import Speech2Translation

    s2tr = Speech2Translation.from_model(model, nbest=5)
    waves = request_waves()
    for sec, wave in zip(REQUEST_SECONDS, waves):
        t0 = time.perf_counter()
        s2tr(wave)
        torch.cuda.synchronize()
        print(f"[serve-st] warm-up request, {sec:.1f} s audio: "
              f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)
    lat = {sec: [] for sec in REQUEST_SECONDS}
    results = []
    for _ in range(ROUNDS):
        for sec, wave in zip(REQUEST_SECONDS, waves):
            t0 = time.perf_counter()
            nbest = s2tr(wave)
            torch.cuda.synchronize()
            lat[sec].append(time.perf_counter() - t0)
            results.append(nbest)
    launches = counts(kernels)
    peak = torch.cuda.max_memory_allocated()
    for sec in REQUEST_SECONDS:
        ms = sorted(x * 1e3 for x in lat[sec])
        med = float(np.median(ms))
        print(f"[serve-st] {sec:.1f} s audio, {len(ms)} runs: latency median {med:.1f} ms "
              f"(min {ms[0]:.1f}, max {ms[-1]:.1f}), RTFx at the median "
              f"{sec / med * 1e3:.2f} [{card}]")
    for sec, nbest in zip(REQUEST_SECONDS, results):
        scores = [h.score for _, h in nbest]
        print(f"[serve-st] {sec:.1f} s audio: {len(nbest)}-best of "
              f"{[len(ids) for ids, _ in nbest]} tokens, scores {[round(x, 4) for x in scores]}")
    for nbest in results:
        scores = [h.score for _, h in nbest]
        if not (len(nbest) == 5 and all(math.isfinite(x) for x in scores)
                and scores == sorted(scores, reverse=True)):
            raise AssertionError(f"serve-st: n-best not 5 finite sorted scores: {scores}")
        if not all(0 <= i < model.cfg.vocab_size for ids, _ in nbest for i in ids):
            raise AssertionError("serve-st: a hypothesis id outside the vocabulary")
    for i, nbest in enumerate(results):
        if [ids for ids, _ in nbest] != [ids for ids, _ in results[i % len(REQUEST_SECONDS)]]:
            raise AssertionError("serve-st: the same request gave different hypotheses")
    n_req = len(results)
    n_blocks = model.cfg.encoder.num_blocks
    print(f"[serve-st] kernel launches over {n_req} requests: {launches}; a request: "
          + ", ".join(f"{k} {v / n_req:g}" for k, v in launches.items()))
    for name, n in launches.items():
        want = n_blocks * n_req if name in ENCODER_FWD else 0
        if n != want:
            raise AssertionError(f"serve-st: {name}: {n} launches, expected {want}")
    print(f"[serve-st] torch.cuda.max_memory_allocated: {peak} bytes ({peak / 2**30:.2f} GiB)")
    wall_10s = float(np.median(lat[REQUEST_SECONDS[0]]))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        s2tr(waves[0])
        torch.cuda.synchronize()
    dev_ms, events = device_busy(prof)
    print(f"[serve-st] {REQUEST_SECONDS[0]} s request traced (card only): device busy "
          f"{dev_ms:.1f} ms = {100 * dev_ms / 1e3 / wall_10s:.1f}% of the unprofiled median "
          f"latency [{card}]")
    print_top("serve-st", events)
    check_encoder_on_cpu("serve-st", model, waves[-1], REQUEST_SECONDS[-1])
    return launches


def st_batch(b, seed=2):
    """b x 10 s of seeded noise, a translation of ST_TGT_LEN and a source
    of ST_SRC_LEN seeded LLM ids (100 to 5,000) an utterance."""
    samples = int(TRAIN_SECONDS * SR)
    rng = np.random.default_rng(seed)
    return {
        "speech": torch.from_numpy((rng.standard_normal((b, samples)) * 0.1)
                                   .astype(np.float32)).cuda(),
        "speech_lengths": torch.full((b,), samples, device="cuda"),
        "text": torch.from_numpy(rng.integers(100, 5000, (b, ST_TGT_LEN))).cuda(),
        "text_lengths": torch.full((b,), ST_TGT_LEN, device="cuda"),
        "src_text": torch.from_numpy(rng.integers(100, 5000, (b, ST_SRC_LEN))).cuda(),
        "src_text_lengths": torch.full((b,), ST_SRC_LEN, device="cuda"),
    }


def phase_train_st(model, kernels, card):
    """Phase 20: the ST model trained by make_fused_train_step at B=8 x
    10 s (translation [8, 16], source [8, 24] in LLM ids), SpecAug, AdamW
    (lr 1e-3) as phase 6; encoder, CTC head, guided decoder and extra ASR
    decoder trainable, the LLM frozen and bit-identical after; 12 launches
    of each encoder entry point a step; the loss falling."""
    from llm_guided_asr_tpu_torch.tasks.st import ST_BATCH_ARGS
    from llm_guided_asr_tpu_torch.train.optim import build_optimizer, path_prefix_mask
    from llm_guided_asr_tpu_torch.train.trainer import init_train_state, make_fused_train_step

    frozen = path_prefix_mask(model, ["llm"])
    snapshot = {n: p.detach().clone() for n, p in model.named_parameters() if n in frozen}
    state = init_train_state(model, build_optimizer("adamw", {"lr": 1e-3}, freeze_mask=frozen))
    print(f"[train-st] {len(frozen)} frozen LLM tensors, "
          f"{sum(p.numel() for p in state.params)} trainable parameters")
    step = make_fused_train_step(model, state, torch.Generator().manual_seed(2), ST_BATCH_ARGS)
    batch = st_batch(ST_B)
    all_stats, med, launches = run_steps("train-st", step, batch, ST_WARMUP, ST_STEPS, kernels,
                                         card)
    losses = [s["loss"] for s in all_stats]
    if not np.mean(losses[-3:]) < losses[0]:
        raise AssertionError(f"train-st: loss did not fall: {losses}")
    if not all(k in all_stats[-1] for k in ("loss_st_att", "loss_asr_ctc", "loss_asr_att")):
        raise AssertionError(f"train-st: stats {sorted(all_stats[-1])}")
    n_blocks = model.cfg.encoder.num_blocks
    for name, n in launches.items():
        want = n_blocks * ST_STEPS if name in ENCODER_FWD + ENCODER_BWD else 0
        if n != want:
            raise AssertionError(f"train-st: {name} launched {n} times in {ST_STEPS} steps, "
                                 f"expected {want}")
    print(f"[train-st] audio seconds per second at the median: "
          f"{ST_B * TRAIN_SECONDS / (med / 1e3):.1f} [{card}]")
    profile_step("train-st", step, batch, med)
    moved = [n for n, p in model.named_parameters() if n in frozen
             and not torch.equal(p, snapshot[n])]
    if moved:
        raise AssertionError(f"train-st: frozen LLM weights moved: {moved[:5]}")
    print(f"[train-st] the LLM bit-identical after {ST_WARMUP + ST_STEPS + 1} steps")
    model.eval()
    return launches, med


def _int16_flac(src: Path, dst: Path, subframe: str) -> np.ndarray:
    """The int16 samples of a wav file written as 16-bit flac (exact: the
    writer rounds x * 32767 of the ints over 32767); returns the samples
    as read_wav gives them."""
    from scipy.io import wavfile

    from llm_guided_asr_tpu_torch.data.fileio import read_wav
    from llm_guided_asr_tpu_torch.data.flac import write_flac

    rate, ints = wavfile.read(str(src))
    write_flac(dst, rate, ints.astype(np.float64) / 32767.0, subframe=subframe)
    return read_wav(src)[1]


def cm_bound(x: np.ndarray) -> float:
    """The CM format's error bound for ``x``: each column's largest
    quantization step over two (its 0/25/75/100 % quantiles split into 64,
    128 and 63 steps), plus the 16-bit header quantiles' rounding."""
    cols = np.sort(x, axis=0)
    r = cols.shape[0]
    q = np.stack([cols[0], cols[r // 4], cols[(3 * r) // 4], cols[-1]])
    step = np.maximum.reduce([(q[1] - q[0]) / 64, (q[2] - q[1]) / 128, (q[3] - q[2]) / 63])
    return float(step.max() / 2 + 4 * (x.max() - x.min()) / 65535)


def phase_recipe_io(kernels, card):
    """Phase 21: the recipe inputs on the card.  A: the first RECIPE_UTTS
    utterances of phase 15's corpus as 16-bit flac (verbatim subframes,
    every sixth with the order-2 fixed predictor and rice residuals), each
    read equal to its wav bitwise;
    their log-mel features as a Kaldi ark of FM and one of CM matrices,
    read through the kaldi_ark data type (FM bitwise, CM within its
    quantization bound).  B: st_train (1 epoch, the byte-level fixture's
    tokenizer and tiny LLM, a 2x256 Conformer) and st_inference over the
    flac wav.scp.  C: asr_pipeline stages 3-15 over the flac data dirs
    with --decode_nj 2 (two asr_inference processes), the text equal to a
    --decode_nj 1 decode; Speech2Text.from_packed equal to
    Speech2Text(config.yaml, checkpoint)."""
    import tempfile

    from llm_guided_asr_tpu_torch.bin import asr_pipeline, st_inference, st_train
    from llm_guided_asr_tpu_torch.bin.asr_inference import Speech2Text
    from llm_guided_asr_tpu_torch.data.dataset import ESPnetDataset
    from llm_guided_asr_tpu_torch.data.fileio import read_2columns_text, read_audio
    from llm_guided_asr_tpu_torch.data.kaldi_ark import KaldiArkWriter, write_compressed_matrix
    from llm_guided_asr_tpu_torch.ops.frontend import default_frontend
    from llm_guided_asr_tpu_torch.train.checkpoint import load
    from llm_guided_asr_tpu_torch.utils.config import dump_yaml

    total = {}

    def timed(tag, fn, *args):
        torch.cuda.synchronize()
        reset_counts(kernels)
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        launches = counts(kernels)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        print(f"[recipe-io] {tag}: {sec:.1f} s, launches {launches} [{card}]")
        return out, sec, launches

    with tempfile.TemporaryDirectory(prefix="recipe-io-") as tmp:
        root = Path(tmp)
        # ---- A: flac and Kaldi ark ----
        splits = write_run_corpus(root, n_utts=RECIPE_UTTS, n_train=RECIPE_TRAIN)
        rng = np.random.default_rng(21)
        data = {}
        t0 = time.perf_counter()
        n_samples = 0
        for split, (scp, _, _) in splits.items():
            d = root / "data" / split
            d.mkdir(parents=True)
            lines, texts, src = [], [], []
            for i, (uid, path) in enumerate(read_2columns_text(scp).items()):
                flac = d / f"{uid}.flac"
                want = _int16_flac(Path(path), flac, "fixed" if i % 6 == 0 else "verbatim")
                got = read_audio(str(flac))[1]
                n_samples += want.shape[0]
                if got.dtype != want.dtype or not np.array_equal(got, want):
                    raise AssertionError(f"recipe-io: {flac.name} differs from its wav")
                words = [RECIPE_WORDS[j] for j in rng.integers(0, len(RECIPE_WORDS), 4)]
                lines.append(f"{uid} {flac}")
                src.append(f"{uid} {' '.join(words)}")
                texts.append(f"{uid} {' '.join(reversed(words))}")
            for name, rows in (("wav.scp", lines), ("text", src), ("text.tgt", texts)):
                (d / name).write_text("\n".join(rows) + "\n")
            data[split] = d
        print(f"[recipe-io] {RECIPE_UTTS} utterances as 16-bit flac ({n_samples / SR:.1f} s of "
              f"audio), each read equal to its wav bitwise; write and read "
              f"{time.perf_counter() - t0:.1f} s [{card}]")
        feats = {}
        for uid, path in list(read_2columns_text(data["valid"] / "wav.scp").items())[:4]:
            wave = torch.from_numpy(read_audio(path)[1][None])
            f, n = default_frontend(wave, torch.tensor([wave.shape[1]]))
            feats[uid] = f[0, : int(n[0])].numpy()
            np.save(root / f"{uid}.npy", feats[uid])
        with KaldiArkWriter(root / "fm.ark", root / "fm.scp") as w:
            for uid, x in feats.items():
                w[uid] = np.load(root / f"{uid}.npy")
        with open(root / "cm.ark", "wb") as f:
            offsets = {uid: write_compressed_matrix(f, np.load(root / f"{uid}.npy"), uid)
                       for uid in feats}
        (root / "cm.scp").write_text("".join(f"{u} {root / 'cm.ark'}:{o}\n"
                                             for u, o in offsets.items()))
        for kind in ("fm", "cm"):
            ds = ESPnetDataset([(str(root / f"{kind}.scp"), "feats", "kaldi_ark")])
            for uid, x in feats.items():
                got = ds[uid]["feats"]
                if ds.peek_length(uid) != x.shape[0] or got.shape != x.shape:
                    raise AssertionError(f"recipe-io: {kind} {uid} shape {got.shape}")
                err, bound = float(np.abs(got - x).max()), cm_bound(x)
                if (kind == "fm" and not np.array_equal(got, x)) or err > bound:
                    raise AssertionError(f"recipe-io: {kind} {uid} error {err} > {bound}")
            print(f"[recipe-io] Kaldi ark {kind.upper()}: {len(feats)} feature matrices "
                  f"[T, 80] read through the kaldi_ark data type "
                  + ("bitwise equal to the npy" if kind == "fm" else
                     f"within the CM bound (largest error {err:.3e}, bound {bound:.3e})"))

        # ---- B: ST through the CLIs ----
        st_cfg = {
            "llm_conf": {"model_name_or_path": str(RECIPE_LLM), "template_prompt":
                         "fix ((HYP)) -> \"", "dtype": "float32"},
            "bpemodel": str(RECIPE_LLM), "normalize": "utterance_mvn", "specaug": "specaug",
            "encoder_conf": {"output_size": 256, "attention_heads": 4, "linear_units": 1024,
                             "num_blocks": 2, "cnn_module_kernel": 31},
            "decoder_conf": {"attention_heads": 4, "linear_units": 1024, "num_blocks": 2},
            "extra_asr_decoder_conf": {"attention_heads": 4, "linear_units": 1024,
                                       "num_blocks": 1},
            "model_conf": {"asr_weight": 0.3, "mtlalpha": 0.5, "lsm_weight": 0.1},
            "optim": "adamw", "optim_conf": {"lr": 1.0e-3}, "scheduler": None,
            "batch_type": "sorted", "batch_size": 8, "max_epoch": 1, "keep_nbest_models": 1,
            "device": None,
            "train_data_path_and_name_and_type": [
                [str(data["train"] / "wav.scp"), "speech", "sound"],
                [str(data["train"] / "text.tgt"), "text", "text"],
                [str(data["train"] / "text"), "src_text", "text"]],
            "valid_data_path_and_name_and_type": [
                [str(data["valid"] / "wav.scp"), "speech", "sound"],
                [str(data["valid"] / "text.tgt"), "text", "text"],
                [str(data["valid"] / "text"), "src_text", "text"]],
        }
        dump_yaml(st_cfg, root / "st.yaml")
        exp = root / "exp_st"
        _, sec, launches = timed("st_train", st_train.main,
                                 ["--config", str(root / "st.yaml"), "--output_dir", str(exp)])
        n_steps = RECIPE_TRAIN // 8
        for name in ENCODER_FWD + ENCODER_BWD:
            if launches[name] < 2 * n_steps:
                raise AssertionError(f"recipe-io st_train: {name} {launches[name]}")
        ckpt = next(exp.glob("valid.*.ave_*best.pth"), None) or exp / "latest.pth"
        saved = load(ckpt)
        if any(k.startswith("llm.") for k in saved) or not any(
                k.startswith("extra_asr_decoder.") for k in saved):
            raise AssertionError(f"recipe-io: {ckpt.name} holds the LLM or lacks the ASR decoder")
        _, sec, launches = timed("st_inference", st_inference.main, [
            "--train_config", str(exp / "config.yaml"), "--model_file", str(ckpt),
            "--wav_scp", str(data["valid"] / "wav.scp"), "--output_dir", str(root / "st_dec")])
        out = read_2columns_text(root / "st_dec" / "1best_recog" / "score")
        n_valid = RECIPE_UTTS - RECIPE_TRAIN
        if len(out) != n_valid or not all(math.isfinite(float(v)) for v in out.values()):
            raise AssertionError(f"recipe-io st_inference: {out}")
        if launches["rel_attention_fwd"] != 2 * n_valid:
            raise AssertionError(f"recipe-io st_inference: {launches}")
        print(f"[recipe-io] st_inference: {n_valid} utterances translated (beam 5, 48-token "
              f"cap), e.g. {read_2columns_text(root / 'st_dec' / '1best_recog' / 'text')}"[:300])

        # ---- C: the pipeline with array jobs, pack and from_packed ----
        asr_cfg = {"encoder_conf": st_cfg["encoder_conf"], "normalize": "global_mvn",
                   "decoder_conf": {"attention_heads": 4, "linear_units": 1024, "num_blocks": 1},
                   "optim": "adamw", "optim_conf": {"lr": 1.0e-3}, "scheduler": None,
                   "batch_type": "sorted", "batch_size": 8, "max_epoch": 1,
                   "keep_nbest_models": 1}
        dump_yaml(asr_cfg, root / "asr.yaml")
        pexp = root / "exp_asr"
        common = ["--config", str(root / "asr.yaml"), "--train_dir", str(data["train"]),
                  "--valid_dir", str(data["valid"]), "--expdir", str(pexp), "--device", "cuda",
                  "--beam_size", "4", "--min_samples", "0", "--max_samples", "1000000"]
        result, sec, _ = timed("asr_pipeline stages 3-15, --decode_nj 2", asr_pipeline.main,
                               common + ["--stage", "3", "--stop_stage", "15", "--decode_nj", "2"])
        dec = pexp / "decode" / "valid"
        two = (dec / "1best_recog" / "text").read_text()
        logs = sorted(p.name for p in (dec / "log").iterdir())
        if logs != ["decode.1.log", "decode.2.log"] or len(two.splitlines()) != n_valid:
            raise AssertionError(f"recipe-io: decode jobs {logs}, {len(two.splitlines())} lines")
        dec.rename(pexp / "decode" / "valid_nj2")
        _, sec1, _ = timed("asr_pipeline stage 12, --decode_nj 1", asr_pipeline.main,
                           common + ["--stage", "12", "--stop_stage", "12", "--decode_nj", "1"])
        if (dec / "1best_recog" / "text").read_text() != two:
            raise AssertionError("recipe-io: --decode_nj 2 text differs from --decode_nj 1")
        print(f"[recipe-io] --decode_nj 2 wrote the text of --decode_nj 1 ({n_valid} "
              f"utterances); stage 13: {json.dumps(result)}")
        for name in ("asr_model.zip", "README.md"):
            if not (pexp / "pack" / name).is_file():
                raise AssertionError(f"recipe-io: stage 14-15 wrote no {name}")
        model_file = next((pexp / "train").glob("valid.*.ave_*best.pth"), None) or \
            pexp / "train" / "latest.pth"
        packed = Speech2Text.from_packed(pexp / "pack" / "asr_model.zip",
                                         workdir=str(root / "unpacked"), beam_size=4)
        direct = Speech2Text(pexp / "train" / "config.yaml", model_file, beam_size=4)
        for uid, path in list(read_2columns_text(data["valid"] / "wav.scp").items())[:3]:
            wave = read_audio(path)[1]
            (a_text, a_tok, _, a_hyp), = packed(wave)
            (b_text, b_tok, _, b_hyp), = direct(wave)
            if (a_text, a_tok) != (b_text, b_tok) or not abs(a_hyp.score - b_hyp.score) <= \
                    1e-4 * max(1.0, abs(b_hyp.score)):
                raise AssertionError(f"recipe-io: from_packed {uid} differs")
        print(f"[recipe-io] Speech2Text.from_packed decodes 3 utterances as "
              f"Speech2Text(config.yaml, {model_file.name}) does [{card}]")
    return total


def serve_one(tag, model, wave, kernels, card, encoder_fwd, expected=None, encoder_tol=1e-3,
              check=None):
    """One warm-up and one timed request through Speech2Text (beam 10,
    ctc_weight 0.3, the 24-token cap): its latency, the score bookkeeping,
    one launch of each ``encoder_fwd`` entry point a block (or the counts
    of ``expected``) and none of any other, and the card's encoder against
    the CPU plain path on it."""
    from llm_guided_asr_tpu_torch.bin.asr_inference import Speech2Text

    s2t = Speech2Text.from_model(model, ctc_weight=0.3, beam_size=10, maxlenratio=-24.0)
    s2t(wave)
    torch.cuda.synchronize()
    reset_counts(kernels)
    t0 = time.perf_counter()
    (ids, hyp), = s2t(wave)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = counts(kernels)
    sec = wave.shape[0] / SR
    check_scores(hyp)
    print(f"[{tag}] {sec:.1f} s audio, one run after one warm-up: {ms:.1f} ms, RTFx "
          f"{sec / ms * 1e3:.2f}; hyp {len(ids)} tokens, score {hyp.score:.4f} [{card}]")
    print(f"[{tag}] kernel launches over 1 request: {launches}")
    for name, n in launches.items():
        want = model.cfg.encoder.num_blocks if name in encoder_fwd else 0
        if expected is not None:
            want = expected.get(name, 0)
        if n != want:
            raise AssertionError(f"{tag}: {name}: {n} launches, expected {want}")
    (check or check_encoder_on_cpu)(tag, model, wave, sec, encoder_tol)
    return launches


def phase_serve_ebf(kernels, card):
    """Phase 22: a CTC/attention ASRModel with the E-Branchformer of
    ESPnet's LibriSpeech-100 recipe (EBF_ENCODER; decoder 6 x 256 with 2048
    units, vocab 5000, ctc_weight 0.3; float32, TF32 off, weights from seed
    0) served as phase 3 serves (phase_serve: phase 3's requests at beam 10,
    one warm-up each, 3 timed runs each; 12 rel-pos and 12 depthwise
    forward launches a request, no backward; peak memory; the card's
    encoder against the CPU on the 4.1 s request), one request profiled;
    then the Branchformer at the same widths and the Transformer encoder
    (2048 units, abs positions; no kernel) serve one 10 s request each,
    held against the CPU plain path with their launch counts."""
    print("[serve-ebf] E-Branchformer 12 x 256 (4 heads, 1024 units for the FFNs and the "
          "cgMLP, cgMLP kernel 31, rel_pos), as ESPnet's LibriSpeech-100 recipe, except the "
          "merge conv's kernel: 3, fixed in JAX (llm_guided_asr_tpu/models/branchformer.py:65), "
          "where the recipe sets 31")
    model = build_serve_asr("e_branchformer", **EBF_ENCODER)
    print(f"[serve-ebf] ASRModel {sum(p.numel() for p in model.parameters())} parameters")
    launches, waves, wall_10s = phase_serve(model, kernels, card, "serve-ebf")
    phase_profile(model, waves[0], wall_10s, card, "profile-ebf")
    del model
    torch.cuda.empty_cache()
    for tag, encoder_type, enc, fwd in (("serve-bf", "branchformer", EBF_ENCODER, ENCODER_FWD),
                                        ("serve-tf", "transformer", TRANSFORMER_ENCODER, ())):
        model = build_serve_asr(encoder_type, **enc)
        print(f"[{tag}] ASRModel with the {encoder_type} encoder {enc}: "
              f"{sum(p.numel() for p in model.parameters())} parameters")
        serve_one(tag, model, waves[0], kernels, card, fwd)
        del model
        torch.cuda.empty_cache()
    return launches


def build_train_ebf():
    """Phase 23's model: phase 22's E-Branchformer ASRModel trained as
    train-1 trains (SpecAug, attention dropout 0.1), weights from seed 0."""
    from llm_guided_asr_tpu_torch.convert import init_weights
    from llm_guided_asr_tpu_torch.models.asr_model import ASRModel, ASRModelConfig
    from llm_guided_asr_tpu_torch.models.conformer import ConformerConfig
    from llm_guided_asr_tpu_torch.models.transformer_decoder import TransformerDecoderConfig
    from llm_guided_asr_tpu_torch.ops.frontend import FrontendConfig
    from llm_guided_asr_tpu_torch.ops.specaug import SpecAugConfig

    cfg = ASRModelConfig(
        vocab_size=5000, frontend=FrontendConfig(), normalize="utterance_mvn",
        specaug=SpecAugConfig(), encoder_type="e_branchformer",
        encoder=ConformerConfig(**EBF_ENCODER, attention_dropout_rate=0.1),
        decoder=TransformerDecoderConfig(attention_heads=4, linear_units=2048, num_blocks=6),
        ctc_weight=0.3,
    )
    return init_weights(ASRModel(cfg, device="cuda"), seed=0)


def phase_train_ebf(kernels, card):
    """Phase 23: the E-Branchformer ASRModel trained at B=64 x 10 s (seeded
    noise, 24 seeded token ids an utterance), AdamW, the fused step, 2
    warm-up and 10 timed steps: losses finite and falling, 12 launches of
    each encoder entry point a step, peak memory, audio s/s, one profiled
    step; then the Bayes-risk CTC (risk BRCTC_RISK) on the batch's CTC
    logits [64, 312, 5000] on the card against the CPU, timed beside the
    builtin CTC."""
    from llm_guided_asr_tpu_torch.train.optim import build_optimizer
    from llm_guided_asr_tpu_torch.train.trainer import init_train_state, make_fused_train_step

    model = build_train_ebf()
    n_params = sum(p.numel() for p in model.parameters())
    state = init_train_state(model, build_optimizer("adamw", {"lr": 1e-3}))
    step = make_fused_train_step(model, state, torch.Generator().manual_seed(0))
    samples = int(TRAIN_SECONDS * SR)
    rng = np.random.default_rng(4)
    batch = {
        "speech": torch.from_numpy((rng.standard_normal((TRAIN_B, samples)) * 0.1)
                                   .astype(np.float32)).cuda(),
        "speech_lengths": torch.full((TRAIN_B,), samples, device="cuda"),
        "text": torch.from_numpy(rng.integers(1, 4999, (TRAIN_B, 24))).cuda(),
        "text_lengths": torch.full((TRAIN_B,), 24, device="cuda"),
    }
    print(f"[train-ebf] {n_params} parameters, batch {TRAIN_B} x {TRAIN_SECONDS} s, "
          f"text [{TRAIN_B}, 24]")
    all_stats, med, launches = run_steps("train-ebf", step, batch, TRAIN_WARMUP, TRAIN_STEPS,
                                         kernels, card)
    losses = [s["loss"] for s in all_stats]
    if not np.mean(losses[-3:]) < losses[0]:
        raise AssertionError(f"train-ebf: loss did not fall: {losses}")
    for name, n in launches.items():
        want = model.cfg.encoder.num_blocks * TRAIN_STEPS if name in ENCODER_FWD + ENCODER_BWD \
            else 0
        if n != want:
            raise AssertionError(f"train-ebf: {name} launched {n} times in {TRAIN_STEPS} steps, "
                                 f"expected {want}")
    print(f"[train-ebf] audio seconds per second at the median: "
          f"{TRAIN_B * TRAIN_SECONDS / (med / 1e3):.1f} [{card}]")
    profile_step("train-ebf", step, batch, med)
    check_brctc(model, batch, card)
    return launches, med


def check_brctc(model, batch, card):
    """The Bayes-risk CTC's per-example loss and logits gradient on the card
    against the same computation on the CPU, on the CTC logits of the batch
    (eval-mode encode): loss rtol 1e-5; the gradient within twice the
    builtin CTC's own card-vs-CPU difference on the same logits plus 1e-5,
    the CPU tests' tolerance against JAX (both run
    F.ctc_loss's lattice in float32 log space, where -log P ~ T log V
    ~ 2,600 rounds the posteriors by ~1e-4 at this length, 312 frames;
    the tiny CPU tests hold it to JAX at 1e-5 over 30 frames).  Then its
    forward and backward timed beside the builtin CTC's on the same
    logits, CUDA events."""
    from llm_guided_asr_tpu_torch.ops.losses import ctc_loss_per_example

    model.eval()
    with torch.no_grad():
        enc, enc_lens = model.encode(batch["speech"], batch["speech_lengths"])
        logits = model.ctc_logits(enc)
    model.train()
    text, text_lens = batch["text"], batch["text_lengths"]

    def loss_and_grad(x, lens, labels, label_lens, risk):
        x = x.detach().requires_grad_(True)
        per_ex = ctc_loss_per_example(x, lens, labels, label_lens, time_risk=risk)
        per_ex.sum().backward()
        return per_ex.detach(), x.grad

    cpu_args = (enc_lens.cpu(), text.cpu(), text_lens.cpu())
    got = loss_and_grad(logits, enc_lens, text, text_lens, BRCTC_RISK)
    want = loss_and_grad(logits.cpu(), *cpu_args, BRCTC_RISK)
    loss_err = ((got[0].cpu() - want[0]).abs() / want[0].abs().clamp(min=1.0)).max().item()
    grad_err = (got[1].cpu() - want[1]).abs().max().item()
    builtin = loss_and_grad(logits, enc_lens, text, text_lens, 0.0)
    builtin_err = (builtin[1].cpu() - loss_and_grad(logits.cpu(), *cpu_args, 0.0)[1]).abs().max()
    grad_tol = 2.0 * builtin_err.item() + 1e-5
    print(f"[train-ebf] brctc (risk {BRCTC_RISK}) at {list(logits.shape)}: loss card vs CPU "
          f"max rel err {loss_err:.3e} (tol 1e-5), logits gradient max_abs_err {grad_err:.3e} "
          f"(tol {grad_tol:.3e}: the builtin CTC's own card-vs-CPU gradient max_abs_err "
          f"{builtin_err.item():.3e}, x2, + 1e-5); mean loss {float(got[0].mean()):.4f} against the "
          f"builtin CTC's {float(builtin[0].mean()):.4f}")
    if not (loss_err <= 1e-5 and grad_err <= grad_tol):
        raise AssertionError(f"brctc on the card disagrees with the CPU: {loss_err}, {grad_err}")
    if not torch.all(got[0] > builtin[0]):
        raise AssertionError("brctc: the delay risk did not raise every example's loss")
    ms = {risk: event_time_ms(lambda: loss_and_grad(logits, enc_lens, text, text_lens, risk),
                              iters=5, warmup=1) for risk in (0.0, BRCTC_RISK)}
    print(f"[train-ebf] CTC loss + backward at {list(logits.shape)}: brctc {ms[BRCTC_RISK]:.3f} "
          f"ms, builtin F.ctc_loss {ms[0.0]:.3f} ms ({ms[BRCTC_RISK] / ms[0.0]:.2f}x) [{card}]")


def check_decoder_on_cpu(tag, model, wave, card):
    """The 10-best of one request on the card against the same search on a
    CPU copy of the model from the card's encoder rows (check_nbest: tokens
    equal, scores within 1e-3, a differing entry only as a near tie), then
    the decoder's teacher-forced logits over those 10 hypotheses, card
    against the CPU plain path (1e-4)."""
    import copy

    from llm_guided_asr_tpu_torch.bin.asr_inference import Speech2Text

    decode = dict(ctc_weight=0.3, beam_size=10, maxlenratio=-24.0, nbest=10)
    cpu_model = copy.deepcopy(model).cpu()
    with torch.inference_mode():
        speech, n = torch.from_numpy(wave[None]).cuda(), torch.tensor([wave.shape[0]]).cuda()
        enc, lens = model.encode(speech, n)
        got = Speech2Text.from_model(model, **decode).beam(enc, lens, maxlenratio=-24.0, nbest=10)
        want = Speech2Text.from_model(cpu_model, **decode).beam(enc.cpu(), lens.cpu(),
                                                                maxlenratio=-24.0, nbest=10)
        worst = check_nbest(tag, got, want)
        ys_lens = torch.tensor([len(h.yseq) - 1 for h in got])
        ys = torch.zeros(len(got), int(ys_lens.max()), dtype=torch.long)
        for i, h in enumerate(got):
            ys[i, : ys_lens[i]] = torch.tensor(h.yseq[:-1])
        rows = enc.expand(len(got), -1, -1)
        card_logits = model.decoder_logits(rows, lens.expand(len(got)), ys.cuda(), ys_lens.cuda())
        cpu_logits = cpu_model.decoder_logits(rows.cpu(), lens.cpu().expand(len(got)), ys,
                                              ys_lens)
    valid = (torch.arange(ys.shape[1])[None] < ys_lens[:, None])[..., None]
    err = ((card_logits.cpu() - cpu_logits) * valid).abs().max().item()
    print(f"[{tag}] 10-best on the card equal to the CPU's from the card's encoder rows (score "
          f"max err {worst:.2e}); decoder logits [{len(got)}, {ys.shape[1]}, "
          f"{cpu_logits.shape[-1]}] card vs CPU plain path: max_abs_err {err:.3e} (tol 1e-4) "
          f"[{card}]")
    if not err <= 1e-4:
        raise AssertionError(f"{tag}: decoder logits disagree with the CPU: {err}")


def add_counts(total: dict, launches: dict) -> dict:
    return {k: total.get(k, 0) + v for k, v in launches.items()}


def phase_serve_dec(kernels, card):
    """Phase 24: train-1's Conformer ASRModel (12 x 256, vocab 5000, weights
    from seed 0) with each decoder of NEW_DECODERS, served as phase 3
    serves (phase 3's requests at beam 10, ctc_weight 0.3, the 24-token cap;
    the rnn and s4 decoders rescore the whole prefix every step through the
    stateless scorer, as every non-Transformer decoder does): one warm-up
    each, DEC_ROUNDS timed runs each (median, min, max, RTFx), 12 launches
    of each encoder forward a request and none of anything else, peak
    memory, the encoder against the CPU (1e-4), the 10 s request profiled
    (busy share), and check_decoder_on_cpu on the 4.1 s request."""
    total = {}
    for kind, dec in NEW_DECODERS.items():
        tag = f"serve-{kind}"
        model = build_serve_asr(decoder_type=kind, decoder=dec)
        n_dec = sum(p.numel() for p in model.decoder.parameters())
        print(f"[{tag}] ASRModel with the {kind} decoder {dec}: "
              f"{sum(p.numel() for p in model.parameters())} parameters, {n_dec} in the decoder")
        launches, waves, wall_10s = phase_serve(model, kernels, card, tag, rounds=DEC_ROUNDS,
                                                encoder_tol=1e-4)
        t0 = time.perf_counter()
        phase_profile(model, waves[0], wall_10s, card, f"profile-{kind}")
        t1 = time.perf_counter()
        check_decoder_on_cpu(tag, model, waves[-1], card)
        print(f"[{tag}] the profile took {t1 - t0:.1f} s, the checks against the CPU "
              f"{time.perf_counter() - t1:.1f} s")
        total = add_counts(total, launches)
        del model
        torch.cuda.empty_cache()
    return total


def train_batch(b, seed=4, channels=0):
    """b x 10 s of seeded noise with 24 seeded token ids an utterance; with
    ``channels``, [b, samples, channels] of mc_waves' kind."""
    samples = int(TRAIN_SECONDS * SR)
    rng = np.random.default_rng(seed)
    speech = (np.stack([mc_wave(rng, samples) for _ in range(b)]) if channels
              else (rng.standard_normal((b, samples)) * 0.1).astype(np.float32))
    return {
        "speech": torch.from_numpy(speech).cuda(),
        "speech_lengths": torch.full((b,), samples, device="cuda"),
        "text": torch.from_numpy(rng.integers(1, 4999, (b, 24))).cuda(),
        "text_lengths": torch.full((b,), 24, device="cuda"),
    }


def check_grads_on_cpu(tag, model, card, batch=None, exclude=(), decoder_rows=True):
    """The B = GRAD_B gradients in eval mode (no SpecAug or dropout; running
    batch statistics), the card against a CPU copy (plain paths).  The
    whole model: the loss within 1e-5 relative and the gradient within
    1e-3 of its norm (float32 sums through the 12-block Conformer, cuDNN's
    weight gradient of the subsampling conv over ~49 k products an element
    among them, part by up to ~2e-4 of it).  The decoder, from the same
    encoder rows (the card's) through the attention loss: each gradient
    within 1e-4 of its largest CPU value (+ 1e-6), the kernels' own
    gradient tolerance.  From each device's own rows (printed, not held)
    a decoder's gradient can move by orders more than the rows differ:
    a ReLU gate of its feed-forward layers whose pre-activation lies
    within float32 rounding of 0 opens on one device and not on the other
    (bin/relu_gates.py finds such gates on the CPU alone, float32 against
    float64); the gates that differ between the devices are counted.
    ``batch``: another batch than train_batch(GRAD_B); ``exclude``:
    parameter prefixes left out of the whole gradient's norm (held by the
    caller); ``decoder_rows`` False: the decoder's gradients from the
    card's rows are printed, not held (a phase whose subject is not the
    decoder: its gradients are in the whole one, and a gate within float32
    rounding of 0 can flip from the same rows too)."""
    import copy

    from llm_guided_asr_tpu_torch.models.transformer import PositionwiseFeedForward
    from llm_guided_asr_tpu_torch.ops.losses import add_sos_eos, label_smoothing_loss

    batch = train_batch(GRAD_B, seed=5) if batch is None else batch
    cpu_model = copy.deepcopy(model).cpu().eval()
    model.eval()
    args = ("speech", "speech_lengths", "text", "text_lengths")
    losses, grads, gates = {}, {}, {}
    for name, m, dev in (("card", model, "cuda"), ("cpu", cpu_model, "cpu")):
        gates[name] = []
        hooks = [f.w_1.register_forward_hook(
                     lambda mod, i, out, z=gates[name]: z.append(out.detach().cpu()))
                 for f in m.decoder.modules() if isinstance(f, PositionwiseFeedForward)]
        m.zero_grad(set_to_none=True)
        loss, _, _ = m(*(batch[k].to(dev) for k in args))
        loss.backward()
        for h in hooks:
            h.remove()
        losses[name] = loss.item()
        grads[name] = {n: q.grad.cpu() for n, q in m.named_parameters()}
    flipped = [z[(z > 0) != (c > 0)] for z, c in zip(gates["cpu"], gates["card"])]
    n_flipped = sum(f.numel() for f in flipped)
    n_gates = sum(z.numel() for z in gates["cpu"])
    z_flipped = max((f.abs().max().item() for f in flipped if f.numel()), default=0.0)
    loss_err = abs(losses["card"] - losses["cpu"]) / abs(losses["cpu"])
    sq = [(float(((grads["card"][n] - g).double() ** 2).sum()), float((g.double() ** 2).sum()))
          for n, g in grads["cpu"].items() if not n.startswith(tuple(exclude))]
    norm_err = (sum(d for d, _ in sq) / sum(r for _, r in sq)) ** 0.5
    cfg = model.cfg
    with torch.no_grad():
        enc, enc_lens = model.encode(batch["speech"], batch["speech_lengths"])
    ys_in, ys_out = add_sos_eos(batch["text"], batch["text_lengths"], cfg.sos_id, cfg.eos_id,
                                cfg.ignore_id)
    dec = {}
    for name, m, dev in (("card", model, "cuda"), ("cpu", cpu_model, "cpu")):
        m.zero_grad(set_to_none=True)
        logits = m.decoder_logits(enc.to(dev), enc_lens.to(dev), ys_in.to(dev),
                                  (batch["text_lengths"] + 1).to(dev))
        label_smoothing_loss(logits, ys_out.to(dev), cfg.lsm_weight, cfg.ignore_id,
                             cfg.length_normalized_loss).backward()
        dec[name] = {n: q.grad.cpu() for n, q in m.decoder.named_parameters()}
    model.zero_grad(set_to_none=True)
    model.train()
    def closest(got, want):
        """(largest ratio of difference to tolerance, its tensor)."""
        return max(((got[n] - ref).abs().max().item() / (1e-4 * ref.abs().max().item() + 1e-6), n)
                   for n, ref in want.items())

    worst, worst_name = closest(dec["card"], dec["cpu"])
    own, own_name = closest({n: g for n, g in grads["card"].items() if n.startswith("decoder.")},
                            {n: g for n, g in grads["cpu"].items() if n.startswith("decoder.")})
    print(f"[{tag}] B={GRAD_B} loss {losses['cpu']:.5f}, card vs CPU rel err {loss_err:.2e} (tol "
          f"1e-5); the whole gradient{' but ' + ', '.join(exclude) if exclude else ''} within "
          f"{norm_err:.2e} of its norm (tol 1e-3); from the "
          f"card's encoder rows the {len(dec['cpu'])} decoder gradients within {worst:.2f} of "
          f"their tolerance, 1e-4 of each one's largest value + 1e-6 (closest: {worst_name}); "
          f"from each device's own rows {own:.2f} of it ({own_name}), {n_flipped} of the "
          f"decoder's {n_gates} ReLU gates on the other side of 0 on the card (CPU |z| <= "
          f"{z_flipped:.1e}) [{card}]")
    if not loss_err <= 1e-5:
        raise AssertionError(f"{tag}: loss on the card differs from the CPU's: {loss_err}")
    if not norm_err <= 1e-3:
        raise AssertionError(f"{tag}: the gradient on the card differs from the CPU's by "
                             f"{norm_err} of its norm")
    if decoder_rows and not worst <= 1.0:
        raise AssertionError(f"{tag}: the decoder gradient of {worst_name} on the card differs "
                             f"from the CPU's by {worst:.2f} times its tolerance")


def train_model(tag, model, b, n_warmup, n_steps, kernels, card, expected, channels=0):
    """The fused AdamW step on ``b`` x 10 s (of ``channels`` microphones
    with them): warm-up and timed steps (run_steps), losses finite and
    (over the steps) falling, and the launches of the timed steps equal to
    ``expected`` per step."""
    from llm_guided_asr_tpu_torch.train.optim import build_optimizer
    from llm_guided_asr_tpu_torch.train.trainer import init_train_state, make_fused_train_step

    state = init_train_state(model, build_optimizer("adamw", {"lr": 1e-3}))
    step = make_fused_train_step(model, state, torch.Generator().manual_seed(0))
    batch = train_batch(b, channels=channels)
    print(f"[{tag}] {sum(p.numel() for p in model.parameters())} parameters, batch {b} x "
          f"{TRAIN_SECONDS} s{f' x {channels} channels' if channels else ''}, text [{b}, 24]")
    all_stats, med, launches = run_steps(tag, step, batch, n_warmup, n_steps, kernels, card)
    losses = [s["loss"] for s in all_stats]
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{tag}: loss did not fall: {losses}")
    for name, n in launches.items():
        if n != expected.get(name, 0) * n_steps:
            raise AssertionError(f"{tag}: {name} launched {n} times in {n_steps} steps, "
                                 f"expected {expected.get(name, 0)} a step")
    print(f"[{tag}] launches a step: { {k: v // n_steps for k, v in launches.items() if v} }; "
          f"audio seconds per second at the median: {b * TRAIN_SECONDS / (med / 1e3):.1f} "
          f"[{card}]")
    return launches, med


def phase_train_dec(kernels, card):
    """Phase 25: each model of phase 24 trained as train-1 trains (SpecAug,
    attention dropout 0.1, AdamW, B = DEC_B x 10 s, text [B, 24]), DEC_WARMUP
    warm-up and DEC_STEPS timed steps: finite, falling losses, 12 launches
    of each encoder entry point a step (the decoders launch none); before
    them check_grads_on_cpu at B = GRAD_B on the weights drawn from seed 0
    (after the steps the weights, and so the gradients' float32 rounding,
    differ from run to run: the card's training is not bitwise
    repeatable)."""
    total = {}
    blocks = 12
    for kind, dec in NEW_DECODERS.items():
        tag = f"train-{kind}"
        model = build_serve_asr(decoder_type=kind, decoder=dec, train=True)
        check_grads_on_cpu(tag, model, card)
        launches, _ = train_model(tag, model, DEC_B, DEC_WARMUP, DEC_STEPS, kernels, card,
                                  {k: blocks for k in ENCODER_FWD + ENCODER_BWD})
        total = add_counts(total, launches)
        del model
        torch.cuda.empty_cache()
    return total


def encoder_launches(kind, train=False) -> dict:
    """The kernel launches of one 10 s request (or one training step at
    ENC_B) through the encoder ``kind`` of NEW_ENCODERS: the
    MultiConvformer one rel-pos and five depthwise launches a block (each
    way in training); the (VGG-)RNN encoders one LSTM launch a direction a
    layer (each way); the others none."""
    enc = NEW_ENCODERS[kind]
    names = ENCODER_FWD + (ENCODER_BWD if train else ())
    if kind == "multiconvformer":
        per = {"rel_attention_fwd": 1, "rel_attention_bwd": 1,
               "dwconv1d_fwd": len(MCF_KERNELS) + 1, "dwconv1d_bwd": len(MCF_KERNELS) + 1}
        return {k: per[k] * enc["num_blocks"] for k in names}
    if kind in ("rnn", "vgg_rnn"):
        return {k: 2 * enc["num_blocks"] for k in ("lstm_fwd", "lstm_bwd")[: 2 if train else 1]}
    return {}


def phase_serve_enc(kernels, card):
    """Phase 26: an ASRModel (vocab 5000, the 6 x 256 Transformer decoder,
    weights from seed 0) over each encoder of NEW_ENCODERS serves one
    warm-up and one timed 10 s request at beam 10 (serve_one: latency,
    the score bookkeeping, the launches of encoder_launches and nothing
    else, the encoder against the CPU plain path within 1e-4), then one
    encode of it traced (card only): the device's time, which the host's
    spread does not hide, and the LSTM kernels' share of it."""
    from torch.profiler import ProfilerActivity, profile

    total = {}
    wave = request_waves()[0]
    speech = torch.from_numpy(wave[None]).cuda()
    n = torch.tensor([wave.shape[0]], device="cuda")
    for kind, enc in NEW_ENCODERS.items():
        tag = f"serve-{kind}"
        model = build_serve_asr(kind, **enc)
        frames = encoder_frames(model, [wave])[0]
        print(f"[{tag}] ASRModel with the {kind} encoder {enc}: "
              f"{sum(p.numel() for p in model.parameters())} parameters, "
              f"{sum(p.numel() for p in model.encoder.parameters())} in the encoder; "
              f"T' = {frames} for {REQUEST_SECONDS[0]} s")
        launches = serve_one(tag, model, wave, kernels, card, (),
                             expected=encoder_launches(kind), encoder_tol=1e-4)
        total = add_counts(total, launches)
        with torch.inference_mode(), profile(activities=[ProfilerActivity.CUDA]) as prof:
            model.encode(speech, n)
            torch.cuda.synchronize()
        dev_ms, events = device_busy(prof)
        lstm = [e for e in events if "lstm_" in e.key]
        print(f"[{tag}] encode traced (card only): device busy {dev_ms:.3f} ms, of which "
              f"the LSTM kernels {sum(e.self_device_time_total for e in lstm) / 1e3:.3f} ms "
              f"over {sum(e.count for e in lstm)} traced launches of "
              f"{launches.get('lstm_fwd', 0)} [{card}]")
        del model
        torch.cuda.empty_cache()
    return total


def phase_train_enc(kernels, card):
    """Phase 27: each model of phase 26 trained with SpecAug, attention
    dropout 0.1 and AdamW at B = ENC_B x 10 s: ENC_WARMUP warm-up and
    ENC_STEPS timed steps, finite and falling losses, the launches of
    encoder_launches(train=True) a step."""
    total = {}
    for kind, enc in NEW_ENCODERS.items():
        tag = f"train-{kind}"
        model = build_serve_asr(kind, train=True, **enc)
        launches, _ = train_model(tag, model, ENC_B, ENC_WARMUP, ENC_STEPS, kernels, card,
                                  encoder_launches(kind, train=True))
        total = add_counts(total, launches)
        del model
        torch.cuda.empty_cache()
    return total


# ---------------------------------------------------------------------------
# phases 28-30: the pretrained Hugging Face choices, read from local
# directories that this script writes (config.json + model.safetensors; the
# weights are drawn from a seed, nothing is downloaded)
# ---------------------------------------------------------------------------

def check_ssl_shapes(ra, dc, gen, card) -> dict:
    """The two encoder kernels at the Conformer's shapes over the SSL
    frontend's 10 s of features (T' = SSL_T): the rel-pos forward at
    serve-ssl's [1, 4, T', 64] and, with its backward, at train-ssl's
    [SSL_B, 4, T', 64] (dropout 0.1); the depthwise forward at
    [1, T', 256] and forward and backward at [SSL_B, T', 256], K = 31."""
    f32 = torch.float32
    out = {("rel_attention_fwd", f"serve-ssl [1,4,{SSL_T},64]"):
           check_rel_attention(ra, f32, gen, card, t=SSL_T, n_masked=10)}
    fwd_r, bwd_r = check_rel_attention_train(ra, f32, gen, card, b=SSL_B, t=SSL_T)
    shape = f"train-ssl [{SSL_B},4,{SSL_T},64] dropout 0.1"
    out.update({("rel_attention_fwd", shape): fwd_r, ("rel_attention_bwd", shape): bwd_r})
    out[("dwconv1d_fwd", f"serve-ssl [1,{SSL_T},256] K=31")] = check_dwconv(dc, f32, 31, gen, card,
                                                                          t=SSL_T)
    fwd_r, bwd_r = check_dwconv_train(dc, f32, 31, gen, card, shape=(SSL_B, SSL_T, 256))
    shape = f"train-ssl [{SSL_B},{SSL_T},256] K=31"
    out.update({("dwconv1d_fwd", shape): fwd_r, ("dwconv1d_bwd", shape): bwd_r})
    return out


def write_safetensors(path: Path, tensors: dict) -> int:
    """``tensors`` ({name: float32 or bfloat16 tensor}) as a .safetensors
    file: an 8-byte little-endian header length, the JSON header (padded
    with spaces to 8 bytes), the raw little-endian bytes; one tensor copied
    to the host at a time.  Returns the bytes written."""
    import struct

    types = {torch.float32: "F32", torch.bfloat16: "BF16"}
    header, offset = {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": types[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    blob = json.dumps(header).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for t in tensors.values():
            t = t.detach().contiguous().cpu()
            f.write((t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().tobytes())
    return 8 + len(blob) + offset


def write_hf_dir(path: Path, config: dict, tensors: dict) -> Path:
    path.mkdir(parents=True, exist_ok=True)
    (path / "config.json").write_text(json.dumps(config))
    n = write_safetensors(path / "model.safetensors", tensors)
    print(f"[hf-dir] {path.name}: {len(tensors)} tensors, {n} bytes of model.safetensors")
    return path


def renamed(module, seed: int, rules, dtype=None) -> dict:
    """``module``'s weights drawn from ``seed`` by convert.init_weights,
    renamed to Hugging Face's names by ``rules`` ((regex, replacement), in
    order)."""
    import re

    from llm_guided_asr_tpu_torch.convert import init_weights

    init_weights(module, seed)
    out = {}
    for name, t in module.state_dict().items():
        for pat, rep in rules:
            name = re.sub(pat, rep, name)
        out[name] = t if dtype is None else t.to(dtype)
    return out


W2V_RULES = [(r"conv_layers_(\d+)_(conv|layer_norm)", r"conv_layers.\1.\2"),
             (r"^feature_projection_", "feature_projection."),
             (r"^encoder_layer_norm", "encoder.layer_norm"),
             (r"^layers_(\d+)\.", r"encoder.layers.\1."),
             (r"feed_forward_(intermediate|output)_dense", r"feed_forward.\1_dense")]


def write_w2v_dir(path: Path, model_type: str, seed: int) -> Path:
    """A wav2vec2-base / hubert-base directory (W2VConfig's defaults) with
    weights from ``seed``; the positional conv in the legacy weight-norm
    layout (weight_g = the norm of weight_v over dims 0 and 1, so that the
    folded weight is weight_v)."""
    import dataclasses

    from llm_guided_asr_tpu_torch.models.ssl_encoders import W2VConfig, Wav2Vec2Encoder

    cfg = W2VConfig()
    with torch.device("cuda"):
        trunk = Wav2Vec2Encoder(cfg)
    sd = renamed(trunk, seed, W2V_RULES)
    v = sd.pop("pos_conv_embed_conv.weight")
    sd["encoder.pos_conv_embed.conv.weight_v"] = v
    sd["encoder.pos_conv_embed.conv.weight_g"] = v.norm(dim=(0, 1), keepdim=True)
    sd["encoder.pos_conv_embed.conv.bias"] = sd.pop("pos_conv_embed_conv.bias")
    config = {k: list(v) if isinstance(v, tuple) else v
              for k, v in dataclasses.asdict(cfg).items()}
    return write_hf_dir(path, {**config, "model_type": model_type}, sd)


def write_whisper_dir(path: Path, seed: int) -> Path:
    from llm_guided_asr_tpu_torch.models.ssl_encoders import WhisperEncConfig, WhisperEncoder

    with torch.device("cuda"):
        enc = WhisperEncoder(WhisperEncConfig(**WHISPER_BASE))
    sd = renamed(enc, seed, [(r"^embed_positions$", "embed_positions.weight"),
                             (r"^layers_(\d+)_", r"layers.\1."), (r"^", "encoder.")])
    return write_hf_dir(path, {**WHISPER_BASE, "model_type": "whisper"}, sd)


def write_bert_dir(path: Path, seed: int) -> Path:
    from llm_guided_asr_tpu_torch.models.hf_encoder import BertBody, BertBodyConfig, BertEmbeddings

    cfg = BertBodyConfig.from_hf_config(BERT_BASE)
    with torch.device("cuda"):
        body, emb = BertBody(cfg), BertEmbeddings(cfg)
    layer = {"query": "attention.self.query", "key": "attention.self.key",
             "value": "attention.self.value", "attn_out": "attention.output.dense",
             "attn_ln": "attention.output.LayerNorm", "ff1": "intermediate.dense",
             "ff2": "output.dense", "ff_ln": "output.LayerNorm"}
    sd = renamed(body, seed, [(rf"^layers_(\d+)\.{k}\.", rf"encoder.layer.\1.{v}.")
                              for k, v in layer.items()])
    sd.update(renamed(emb, seed + 1,
                      [(r"^(word|position|token_type)\.", r"embeddings.\1_embeddings."),
                       (r"^ln\.", "embeddings.LayerNorm.")]))
    return write_hf_dir(path, BERT_BASE, sd)


def write_llama_dir(path: Path, seed: int, layers: int) -> Path:
    """Llama-3.2-1B's widths (serve_parts) at ``layers`` layers, bfloat16
    weights from ``seed`` (the published checkpoint's type; ASRTask loads
    them into its float32 model), and a word-level tokenizer.json of its
    128,256 ids (letters, space and ':' split one by one, the rest
    placeholders)."""
    import dataclasses

    from llm_guided_asr_tpu_torch.models.llm.llama import LlamaModel

    cfg = dataclasses.replace(serve_parts()["llm"], num_hidden_layers=layers)
    llm = LlamaModel(cfg, dtype=torch.bfloat16, device="cuda")
    sd = renamed(llm, seed, [(r"^layers_(\d+)\.", r"model.layers.\1."),
                             (r"^(embed_tokens|norm)\.", r"model.\1.")])
    config = {"model_type": "llama", "vocab_size": cfg.vocab_size,
              "hidden_size": cfg.hidden_size, "intermediate_size": cfg.intermediate_size,
              "num_hidden_layers": layers, "num_attention_heads": cfg.num_attention_heads,
              "num_key_value_heads": cfg.num_key_value_heads, "rms_norm_eps": cfg.rms_norm_eps,
              "rope_theta": cfg.rope_theta, "tie_word_embeddings": cfg.tie_word_embeddings,
              "max_position_embeddings": cfg.max_position_embeddings,
              "rope_scaling": {"rope_type": "llama3", "factor": cfg.rope_scaling_factor,
                               "low_freq_factor": cfg.rope_low_freq_factor,
                               "high_freq_factor": cfg.rope_high_freq_factor,
                               "original_max_position_embeddings":
                                   cfg.rope_original_max_position}}
    write_hf_dir(path, config, sd)
    words = ["<unk>"] + list("abcdefghijklmnopqrstuvwxyz :")
    vocab = {w: i for i, w in enumerate(words)}
    vocab.update({f"<t{i}>": i for i in range(len(words), cfg.vocab_size)})
    (path / "tokenizer.json").write_text(json.dumps({
        "version": "1.0", "added_tokens": [], "normalizer": None, "post_processor": None,
        "decoder": None,
        "pre_tokenizer": {"type": "Split", "pattern": {"String": ""}, "behavior": "Isolated",
                          "invert": False},
        "model": {"type": "WordLevel", "vocab": vocab, "unk_token": "<unk>"}}))
    (path / "tokenizer_config.json").write_text(json.dumps(
        {"tokenizer_class": "PreTrainedTokenizerFast", "unk_token": "<unk>"}))
    return path


def task_model(config: dict, tag: str):
    """An ASRModel through ASRTask's build_model and init_model_variables
    (weights from seed 0, the pretrained parts from their directories),
    on the card (the config's device null), in eval mode."""
    from llm_guided_asr_tpu_torch.tasks import asr as tasr

    config = {**tasr.ASRTask.get_default_config(), **config}
    t0 = time.perf_counter()
    model = tasr.build_model(config)
    tasr.init_model_variables(model, config, 0)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in model.parameters())
    print(f"[{tag}] ASRTask built and loaded the model in {time.perf_counter() - t0:.1f} s: "
          f"{n} parameters")
    return model.eval()


def asr_config(root: Path, **over) -> dict:
    """The task config of train-1's model (vocab 5000, the Conformer and
    decoder of SSL_ENCODER/SSL_DECODER, ctc_weight 0.3) with ``over``."""
    tokens = root / "tokens.txt"
    if not tokens.exists():
        tokens.write_text("\n".join(["<blank>", "<unk>"] + [f"t{i}" for i in range(2, 4999)]
                                    + ["<sos/eos>"]) + "\n")
    return {"token_list": str(tokens), "normalize": "utterance_mvn",
            "encoder_conf": dict(SSL_ENCODER), "decoder_conf": dict(SSL_DECODER),
            "model_conf": {"ctc_weight": 0.3}, **over}


def cpu_copy(model, keep_decoder=True):
    """A CPU copy of ``model`` (without its decoder unless ``keep_decoder``)."""
    import copy

    dec = None if keep_decoder else model._modules.pop("decoder", None)
    try:
        return copy.deepcopy(model).cpu()
    finally:
        if dec is not None:
            model._modules["decoder"] = dec


def check_hf_on_cpu(tag, model, wave, sec, tol=1e-3):
    """The card's features (the frozen SSL trunk's, within 1e-4 of their
    largest value, where the model has one) and encoder output (within
    ``tol``) against a CPU copy of the model on the same request."""
    cpu = cpu_copy(model, keep_decoder=False)
    speech, n = torch.from_numpy(wave[None]), torch.tensor([wave.shape[0]])
    with torch.inference_mode():
        if model.cfg.ssl_frontend is not None:
            got = model.raw_features(speech.cuda(), n.cuda())[0]
            want = cpu.raw_features(speech, n)[0]
            scale = max(1.0, want.abs().max().item())
            err = (got.cpu() - want).abs().max().item()
            print(f"[{tag}] SSL features {list(want.shape)} card vs CPU: max_abs_err {err:.3e} "
                  f"(tol 1e-4 x {scale:.2f})")
            if not err <= 1e-4 * scale:
                raise AssertionError(f"{tag}: SSL features disagree with the CPU: {err}")
        enc_gpu, lens_gpu = model.encode(speech.cuda(), n.cuda())
        enc_cpu, lens_cpu = cpu.encode(speech, n)
    err = (enc_gpu.cpu() - enc_cpu).abs().max().item()
    print(f"[{tag}] encoder {list(enc_cpu.shape)} card vs CPU plain path, {sec} s: max_abs_err "
          f"{err:.3e} (tol {tol:g})")
    if not (err <= tol and torch.equal(lens_gpu.cpu(), lens_cpu)):
        raise AssertionError(f"{tag}: encoder disagrees with the CPU plain path: {err}")


def check_nbest_from_card_rows(tag, model, wave, card, maxlen=24):
    """The 10-best of one request searched on the card and on a CPU copy of
    the model from the card's encoder rows, at most ``maxlen`` tokens:
    equal tokens (a differing entry only as a near tie), scores within
    1e-4."""
    from llm_guided_asr_tpu_torch.bin.asr_inference import Speech2Text

    decode = dict(ctc_weight=0.3, beam_size=10, maxlenratio=-float(maxlen), nbest=10)
    cpu = cpu_copy(model)
    with torch.inference_mode():
        speech, n = torch.from_numpy(wave[None]).cuda(), torch.tensor([wave.shape[0]]).cuda()
        enc, lens = model.encode(speech, n)
        got = Speech2Text.from_model(model, **decode).beam(enc, lens, maxlenratio=-float(maxlen),
                                                           nbest=10)
        t0 = time.perf_counter()
        want = Speech2Text.from_model(cpu, **decode).beam(enc.cpu(), lens.cpu(),
                                                          maxlenratio=-float(maxlen), nbest=10)
        cpu_s = time.perf_counter() - t0
    del cpu
    worst = check_nbest(tag, got, want)
    print(f"[{tag}] 10-best (<= {maxlen} tokens, {wave.shape[0] / 16000:.1f} s request) from the "
          f"card's encoder rows, card vs CPU: tokens equal, score max err {worst:.2e} (tol 1e-4; "
          f"the CPU's search {cpu_s:.1f} s) [{card}]")
    if not worst <= 1e-4:
        raise AssertionError(f"{tag}: 10-best scores differ from the CPU's by {worst}")


def phase_serve_ssl(kernels, card, root: Path):
    """Phase 28: ``frontend: ssl`` -- a frozen HuBERT-Base trunk (W2VConfig's
    defaults, facebook/hubert-base-ls960's widths; weights from seed 1
    written as a local directory and read back by ASRTask) feeding train-1's
    Conformer (12 x 256, conv2d input over its 768-dim features, utterance
    MVN) and the 6 x 256 decoder, vocab 5000: phase 3's requests at beam
    10, ctc_weight 0.3 (phase_serve: one warm-up each, 3 timed runs each;
    12 launches of each encoder forward a request, nothing else; latency,
    RTFx, peak memory), the SSL features (1e-4) and the encoder rows (1e-3)
    against the CPU on the 4.1 s request, the 10-best from the card's
    encoder rows against the CPU's search (1e-4), the 10 s request
    traced (busy share)."""
    hubert = write_w2v_dir(root / "hubert-base", "hubert", seed=1)
    model = task_model(asr_config(root, frontend="ssl", frontend_conf={
        "model_name_or_path": str(hubert), "kind": "hubert"}), "serve-ssl")
    print(f"[serve-ssl] {sum(p.numel() for p in model.ssl_frontend.parameters())} parameters in "
          f"the frozen HuBERT-Base trunk")
    launches, waves, wall_10s = phase_serve(model, kernels, card, "serve-ssl",
                                            check=check_hf_on_cpu)
    check_nbest_from_card_rows("serve-ssl", model, waves[-1], card)
    phase_profile(model, waves[0], wall_10s, card, "profile-ssl")
    return launches, hubert


def phase_train_ssl(kernels, card, root: Path, hubert: Path):
    """Phase 29: phase 28's model trained as train-1 trains (SpecAug,
    attention dropout 0.1, AdamW lr 1e-3 with weight decay 0.01) at
    B = SSL_B x 10 s: first its B = 2 loss in eval mode against a CPU copy
    (1e-5 relative); then SSL_WARMUP warm-up and SSL_STEPS timed fused
    steps (finite, falling losses; 12 launches of each encoder entry point
    a step; step ms, audio s/s, peak memory); the frozen trunk's weights
    after them are what JAX's optax AdamW step leaves, which decays them
    with no gradient: w0 * (1 - lr * wd) per update, within 1e-6 of w0."""
    from llm_guided_asr_tpu_torch.train.optim import build_optimizer
    from llm_guided_asr_tpu_torch.train.trainer import init_train_state, make_fused_train_step

    model = task_model(asr_config(
        root, frontend="ssl", specaug="specaug",
        frontend_conf={"model_name_or_path": str(hubert), "kind": "hubert"},
        encoder_conf={**SSL_ENCODER, "attention_dropout_rate": 0.1}), "train-ssl")
    batch = train_batch(2, seed=5)
    cpu = cpu_copy(model)
    args = ("speech", "speech_lengths", "text", "text_lengths")
    with torch.no_grad():
        got = model(*(batch[k] for k in args))[0].item()
        want = cpu(*(batch[k].cpu() for k in args))[0].item()
    del cpu
    err = abs(got - want) / abs(want)
    print(f"[train-ssl] B=2 eval-mode loss {want:.6f} on the CPU, card rel err {err:.2e} "
          f"(tol 1e-5) [{card}]")
    if not err <= 1e-5:
        raise AssertionError(f"train-ssl: the card's loss differs from the CPU's by {err}")
    model.train()
    if model.ssl_frontend.training:
        raise AssertionError("train-ssl: the frozen SSL trunk left eval mode")
    lr, wd = 1e-3, 0.01
    w0 = {n: p.detach().clone() for n, p in model.ssl_frontend.named_parameters()}
    state = init_train_state(model, build_optimizer("adamw", {"lr": lr, "weight_decay": wd}))
    step = make_fused_train_step(model, state, torch.Generator().manual_seed(0))
    batch = train_batch(SSL_B)
    print(f"[train-ssl] {sum(p.numel() for p in model.parameters())} parameters, batch {SSL_B} x "
          f"{TRAIN_SECONDS} s, text [{SSL_B}, 24]")
    all_stats, med, launches = run_steps("train-ssl", step, batch, SSL_WARMUP, SSL_STEPS, kernels,
                                         card)
    losses = [s["loss"] for s in all_stats]
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train-ssl: loss did not fall: {losses}")
    blocks = model.cfg.encoder.num_blocks
    for name, n in launches.items():
        want_n = SSL_STEPS * blocks if name in ENCODER_FWD + ENCODER_BWD else 0
        if n != want_n:
            raise AssertionError(f"train-ssl: {name} launched {n} times, expected {want_n}")
    decay = (1.0 - lr * wd) ** state.step
    worst = max(((p.detach() - w0[n] * decay).abs().max() / w0[n].abs().max().clamp(min=1e-30))
                .item() for n, p in model.ssl_frontend.named_parameters())
    print(f"[train-ssl] audio seconds per second at the median: "
          f"{SSL_B * TRAIN_SECONDS / (med / 1e3):.1f}; the frozen trunk after {state.step} "
          f"AdamW updates equal to w0 x (1 - lr wd)^{state.step} within {worst:.2e} of each "
          f"tensor's largest value (tol 1e-6) [{card}]")
    if not worst <= 1e-6:
        raise AssertionError(f"train-ssl: the frozen trunk moved otherwise than AdamW's decay: "
                             f"{worst}")
    profile_step("train-ssl", step, batch, med)
    return launches, med


def hf_models(root: Path, hubert: Path) -> list:
    """(tag, task config, encoder kernels a block: launches of one request
    and one step are 12 of each, or none) of phase 30."""
    w2v = write_w2v_dir(root / "wav2vec2-base", "wav2vec2", seed=2)
    whisper = write_whisper_dir(root / "whisper-base", seed=3)
    bert = write_bert_dir(root / "bert-base", seed=4)
    llm = write_llama_dir(root / "llama-3.2-1b", seed=5, layers=HF_LLM_LAYERS)
    raw = dict(frontend="none", normalize="none")
    return [
        ("serve-hubert_hf", asr_config(root, encoder="hubert_hf", encoder_conf={
            "model_name_or_path": str(hubert), "output_size": 256}, **raw), False),
        ("serve-wav2vec2_hf", asr_config(root, encoder="wav2vec2_hf", encoder_conf={
            "model_name_or_path": str(w2v), "output_size": 256}, **raw), False),
        ("serve-whisper_hf", asr_config(root, encoder="whisper_hf", encoder_conf={
            "model_name_or_path": str(whisper), "output_size": 512}), False),
        ("serve-sinc", asr_config(
            root, frontend_conf={"type": "sliding_window", "win_length": 400, "hop_length": 160},
            normalize="none", preencoder="sinc", postencoder="length_adaptor",
            postencoder_conf={"n_layers": 1},
            encoder_conf={**SSL_ENCODER, "input_layer": "linear"}), True),
        ("serve-bert", asr_config(root, postencoder="hugging_face_transformers",
                                  postencoder_conf={"model_name_or_path": str(bert)}), True),
        ("serve-hf_decoder", asr_config(
            root, token_list=None, token_type="hugging_face", bpemodel=str(llm),
            decoder="hugging_face", decoder_conf={"model_name_or_path": str(llm),
                                                  "prefix": "transcribe:", "postfix": " text:"}),
         True),
    ]


def phase_serve_hf(kernels, card, root: Path, hubert: Path):
    """Phase 30: the other pretrained choices, each built by ASRTask from a
    directory this script writes: ``hubert_hf`` (phase 28's HuBERT-Base)
    and ``wav2vec2_hf`` (wav2vec2-base-960h's widths) on the raw waveform,
    ``whisper_hf`` (whisper-base's encoder) on 80 log-mel bins, each with a
    Linear to 256 (whisper: 512) and the 6 x 256 decoder; the sliding
    window + sinc pre-encoder (128 sinc channels, 256 out) + train-1's
    Conformer (linear input) + the length adaptor; train-1's Conformer +
    the BERT-base post-encoder (12 x 768); train-1's Conformer + the
    ``hugging_face`` decoder at Llama-3.2-1B's widths (HF_LLM_LAYERS
    layers, float32 as ASRTask builds it), with a text prompt around the
    audio span.  Each serves one warm-up and one timed 10 s request at
    beam 10 (serve_one: latency, the score bookkeeping, the launches: 12 of
    each encoder forward over a Conformer, none over the SSL and Whisper
    encoders), its encoder against the CPU copy (1e-3; the LLM decoder's
    model without its decoder), and takes one fused AdamW step at B = 2
    (finite loss, the launches of one step).  The LLM decoder's 10-best
    of the 4.1 s request, at most HF_LLM_NBEST_TOKENS tokens, is held
    against the CPU's search from the card's encoder rows (1e-4)."""
    from llm_guided_asr_tpu_torch.train.optim import build_optimizer
    from llm_guided_asr_tpu_torch.train.trainer import init_train_state, make_fused_train_step

    total = {}
    wave = request_waves()[0]
    for tag, config, conformer in hf_models(root, hubert):
        model = task_model(config, tag)
        llm_decoder = config.get("decoder") == "hugging_face"
        if llm_decoder:
            depth = "its full depth" if HF_LLM_LAYERS == 16 else "cut from its 16"
            print(f"[{tag}] the decoder's LM: {HF_LLM_LAYERS} layers of Llama-3.2-1B's widths "
                  f"({depth}), {next(model.decoder.llm.parameters()).dtype}; prompt ids "
                  f"{model.cfg.hf_decoder.prefix_ids} + audio + "
                  f"{model.cfg.hf_decoder.postfix_ids}")
        blocks = model.cfg.encoder.num_blocks if conformer else 0
        expected = {k: blocks for k in ENCODER_FWD}
        launches = serve_one(tag, model, wave, kernels, card, (), expected=expected,
                             check=check_hf_on_cpu)
        if llm_decoder:
            check_nbest_from_card_rows(tag, model, request_waves()[-1], card,
                                       maxlen=HF_LLM_NBEST_TOKENS)
        state = init_train_state(model, build_optimizer("adamw", {"lr": 1e-3}))
        step = make_fused_train_step(model, state, torch.Generator().manual_seed(0))
        batch = train_batch(2)
        model.train()
        reset_counts(kernels)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats, _ = step(batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        step_launches = counts(kernels)
        print(f"[{tag}] one B=2 x {TRAIN_SECONDS} s AdamW step (the first, warm-up included): "
              f"{ms:.1f} ms, loss {float(stats['loss']):.4f}; launches {step_launches} [{card}]")
        if not math.isfinite(float(stats["loss"])):
            raise AssertionError(f"{tag}: non-finite loss {stats}")
        for name, n in step_launches.items():
            want_n = blocks if name in ENCODER_FWD + ENCODER_BWD else 0
            if n != want_n:
                raise AssertionError(f"{tag}: {name} launched {n} times in a step, "
                                     f"expected {want_n}")
        total = add_counts(add_counts(total, launches), step_launches)
        del model, state, step
        torch.cuda.empty_cache()
    return total


# ---------------------------------------------------------------------------
# phases 31-35: the multichannel WPE/MVDR frontend, AV-HuBERT, and the CTC
# alignment and LM generation CLIs
# ---------------------------------------------------------------------------

def mc_wave(rng, samples: int) -> np.ndarray:
    """[samples, MC_CHANNELS] of seeded noise at CHiME-4's six tablet
    microphones: one source reaching microphone c c samples late, plus
    independent noise at each."""
    src = rng.standard_normal(samples + MC_CHANNELS) * 0.1
    mics = [src[MC_CHANNELS - c: MC_CHANNELS - c + samples] + 0.02 * rng.standard_normal(samples)
            for c in range(MC_CHANNELS)]
    return np.stack(mics, axis=1).astype(np.float32)


def mc_waves(seconds=REQUEST_SECONDS, seed=7) -> list:
    rng = np.random.default_rng(seed)
    return [mc_wave(rng, int(s * SR)) for s in seconds]


def build_mc_asr(train=False):
    """train-1's CTC/attention model (vocab 5000, Conformer 12 x 256,
    decoder 6 x 256, weights from seed 0) behind the multichannel frontend
    of MC_FRONTEND."""
    from llm_guided_asr_tpu_torch.ops.frontend import FrontendConfig

    return build_serve_asr(frontend=FrontendConfig(**MC_FRONTEND), train=train)


def mc_launches(train=False) -> dict:
    """One launch of each encoder entry point a block and one LSTM launch
    a direction of the mask estimator, a request or a step."""
    out = {k: 12 for k in ENCODER_FWD + (ENCODER_BWD if train else ())}
    out.update({k: 2 for k in ("lstm_fwd", "lstm_bwd")[: 2 if train else 1]})
    return out


def check_mc_on_cpu(tag, model, wave, sec, tol=1e-3):
    """The card's multichannel features (WPE, the mask estimator's LSTM
    kernels, MVDR, log-mel) and encoder output against a CPU copy of the
    model (plain paths) on the same request, each within ``tol``."""
    import copy

    speech, n = torch.from_numpy(wave[None]), torch.tensor([wave.shape[0]])
    with torch.inference_mode():
        f_gpu, _ = model.raw_features(speech.cuda(), n.cuda())
        enc_gpu, lens_gpu = model.encode(speech.cuda(), n.cuda())
        cpu = copy.deepcopy(model).cpu()
        f_cpu, _ = cpu.raw_features(speech, n)
        enc_cpu, lens_cpu = cpu.encode(speech, n)
    f_err, e_err = max_err(f_gpu.cpu(), f_cpu), max_err(enc_gpu.cpu(), enc_cpu)
    print(f"[{tag}] {sec} s x {wave.shape[1]} channels, card vs CPU plain path: features "
          f"{tuple(f_cpu.shape)} max_abs_err {f_err:.3e} (largest |feature| "
          f"{f_cpu.abs().max().item():.2f}), encoder max_abs_err {e_err:.3e} (tol {tol:g})")
    if not (f_err <= tol and e_err <= tol and torch.equal(lens_gpu.cpu(), lens_cpu)):
        raise AssertionError(f"{tag}: the card disagrees with the CPU plain path: features "
                             f"{f_err}, encoder {e_err}")


class traced_ranges:
    """Wrap ops.frontend's WPE and MVDR in profiler ranges while the block
    runs (the port's code stays as it is outside the trace)."""

    def __enter__(self):
        from torch.profiler import record_function

        from llm_guided_asr_tpu_torch.ops import frontend as fe

        self.saved = {n: getattr(fe, n) for n in ("wpe_dereverb", "mvdr_beamform")}
        for name, fn in self.saved.items():
            def ranged(*a, _fn=fn, _name=name, **k):
                with record_function(_name):
                    return _fn(*a, **k)
            setattr(fe, name, ranged)
        return self

    def __exit__(self, *exc):
        from llm_guided_asr_tpu_torch.ops import frontend as fe

        for name, fn in self.saved.items():
            setattr(fe, name, fn)


def phase_serve_mc(kernels, card):
    """Phase 31: the multichannel model serves the 10.0, 7.3 and 4.1 s
    requests of six channels at beam 10 (serve_one: one warm-up and one
    timed run each; 12 launches of each encoder forward and 2 lstm_fwd a
    request, nothing else; the features and encoder against the CPU),
    then the 10 s request traced (host and card): the busy share, the
    mask estimator's two LSTM launches in µs each, and WPE's and MVDR's
    shares of the device time."""
    from torch.profiler import ProfilerActivity, profile

    from llm_guided_asr_tpu_torch.bin.asr_inference import Speech2Text

    model = build_mc_asr()
    waves = mc_waves()
    print(f"[serve-mc] ASRModel behind the multichannel frontend {MC_FRONTEND}, "
          f"{MC_CHANNELS} channels: {sum(p.numel() for p in model.parameters())} parameters, "
          f"{sum(p.numel() for p in model.mc_frontend.parameters())} in the mask estimator; "
          f"T' = {encoder_frames(model, waves[:1])[0]} for {REQUEST_SECONDS[0]} s")
    total = {}
    for wave in waves:
        launches = serve_one("serve-mc", model, wave, kernels, card, (), expected=mc_launches(),
                             check=check_mc_on_cpu)
        total = add_counts(total, launches)
    s2t = Speech2Text.from_model(model, ctc_weight=0.3, beam_size=10, maxlenratio=-24.0)
    t0 = time.perf_counter()
    s2t(waves[0])
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    with traced_ranges(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
        s2t(waves[0])
        torch.cuda.synchronize()
    ranges = {"wpe_dereverb", "mvdr_beamform"}
    averages = prof.key_averages()
    events = [e for e in averages
              if e.device_type == torch.autograd.DeviceType.CUDA and e.key not in ranges]
    dev_ms = sum(e.self_device_time_total for e in events) / 1e3
    shares = {e.key: e.device_time_total / 1e3 for e in averages
              if e.key in ranges and e.device_type == torch.autograd.DeviceType.CPU}
    lstm = [e for e in events if "lstm_fwd" in e.key]
    print(f"[serve-mc] {REQUEST_SECONDS[0]} s request traced (host and card): unprofiled "
          f"{wall:.1f} ms, device busy {dev_ms:.3f} ms = {100 * dev_ms / wall:.1f}% of it; "
          + ", ".join(f"{k} {v:.3f} ms = {100 * v / max(dev_ms, 1e-9):.1f}% of the device time"
                      for k, v in shares.items())
          + "; the mask estimator's LSTM: "
          + ", ".join(f"{e.count} launch(es) of {e.key[:40]} at "
                      f"{e.self_device_time_total / max(e.count, 1):.1f} us each" for e in lstm)
          + f" [{card}]")
    print_top("serve-mc", events)
    if sum(e.count for e in lstm) != 2:
        raise AssertionError(f"serve-mc: {sum(e.count for e in lstm)} traced lstm_fwd "
                             f"launches, expected 2")
    del model, s2t
    torch.cuda.empty_cache()
    return total


def phase_train_mc(kernels, card):
    """Phase 32: that model trained with SpecAug and attention dropout 0.1,
    AdamW, B = MC_B x 10 s of six channels: first the B = GRAD_B loss and
    gradients on the weights of seed 0 against a CPU copy
    (check_grads_on_cpu, the mask estimator's gradients left out of the
    whole gradient's norm and held by check_mc_frontend_grads; the
    decoder, phases 24-25's subject, held within the whole: at seed 5 one
    of its ReLU gates lies 3.9e-10 from 0 and flips between the devices
    from the same encoder rows), then
    MC_WARMUP warm-up and MC_STEPS timed steps (finite, falling; 12
    launches of each encoder entry point and 2 of each LSTM entry point a
    step)."""
    model = build_mc_asr(train=True)
    batch = train_batch(GRAD_B, seed=5, channels=MC_CHANNELS)
    check_grads_on_cpu("train-mc", model, card, batch=batch, exclude=("mc_frontend.",),
                       decoder_rows=False)
    check_mc_frontend_grads("train-mc", model, batch, card)
    launches, _ = train_model("train-mc", model, MC_B, MC_WARMUP, MC_STEPS, kernels, card,
                              mc_launches(train=True), channels=MC_CHANNELS)
    del model
    torch.cuda.empty_cache()
    return launches


def mc_frontend_grads(frontend, speech, lens, cot) -> dict:
    """The multichannel frontend's parameter gradients of sum(features *
    cot), in the frontend's dtype and on its device (float64 on the CPU)."""
    dev = next(frontend.parameters()).device
    dtype = next(frontend.parameters()).dtype
    frontend.zero_grad(set_to_none=True)
    feats, _ = frontend(speech.to(dev, dtype), lens.to(dev))
    (feats * cot.to(dev, dtype)).sum().backward()
    return {n: p.grad.detach().cpu().double() for n, p in frontend.named_parameters()}


def check_mc_frontend_grads(tag, model, batch, card):
    """The mask estimator's gradients through WPE, MVDR and log-mel, of
    the features against a fixed random cotangent: the card's float32
    (the LSTM kernels, forward and backward) and the CPU's float32 (the
    plain loop) against the CPU's float64.  The float32 gradient of this
    chain sits ~1e-3 off float64 on the CPU alone (tools/mc_grad_rounding.py),
    so each tensor is held to 1e-4 of its largest CPU value (+ 1e-6 of the
    largest) and, where it misses that, to no further from float64 than
    the CPU's float32 one plus that tolerance; the relative distances of
    the whole are printed."""
    import copy

    fe = model.mc_frontend
    speech, lens = batch["speech"], batch["speech_lengths"]
    with torch.no_grad():
        t = fe(speech[:1], lens[:1])[0].shape[1]
    cot = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (speech.shape[0], t, fe.cfg.n_mels)).astype(np.float32))
    cpu = copy.deepcopy(fe).cpu()
    g = {"card": mc_frontend_grads(fe, speech, lens, cot),
         "cpu": mc_frontend_grads(cpu, speech, lens, cot),
         "f64": mc_frontend_grads(cpu.double(), speech, lens, cot)}
    fe.zero_grad(set_to_none=True)

    def rel(a, b):
        return (sum(float(((a[k] - b[k]) ** 2).sum()) for k in b)
                / sum(float((b[k] ** 2).sum()) for k in b)) ** 0.5

    floor = 1e-6 * max(x.abs().max().item() for x in g["cpu"].values())
    worst = 0.0
    for k, ref in g["cpu"].items():
        tol = 1e-4 * ref.abs().max().item() + floor
        if (g["card"][k] - ref).abs().max().item() > tol:
            card_d = (g["card"][k] - g["f64"][k]).abs().max().item()
            cpu_d = (ref - g["f64"][k]).abs().max().item()
            worst = max(worst, (card_d - cpu_d) / tol)
            if not card_d <= cpu_d + tol:
                raise AssertionError(f"{tag}: {k}: the card's gradient is {card_d:.3e} from "
                                     f"float64, the CPU's {cpu_d:.3e} (tol {tol:.3e})")
    print(f"[{tag}] the mask estimator's gradients ({len(g['cpu'])} tensors) through WPE, MVDR "
          f"and log-mel at B={speech.shape[0]}: card vs CPU {rel(g['card'], g['cpu']):.2e} of "
          f"their norm; from float64, card {rel(g['card'], g['f64']):.2e}, CPU "
          f"{rel(g['cpu'], g['f64']):.2e}; each tensor within 1e-4 of the CPU's largest value "
          f"or no further from float64 than the CPU's (worst excess {worst:.2f} of the "
          f"tolerance) [{card}]")


def check_slice_on_cpu(tag, model, wave, sec, tol=1e-3):
    """The card's encode (frontend, normalization, encoder) of the first
    CPU_SLICE_SECONDS of the request against a CPU copy of the model,
    within ``tol``: the full width, a short input, so the CPU's side
    stays short."""
    import copy

    n = int(CPU_SLICE_SECONDS * SR)
    speech, lens = torch.from_numpy(wave[None, :n]), torch.tensor([n])
    with torch.inference_mode():
        enc_gpu, lens_gpu = model.encode(speech.cuda(), lens.cuda())
        enc_cpu, lens_cpu = copy.deepcopy(model).cpu().encode(speech, lens)
    err = max_err(enc_gpu.cpu(), enc_cpu)
    print(f"[{tag}] encoder card vs CPU plain path on the first {CPU_SLICE_SECONDS} s of the "
          f"{sec} s request: max_abs_err {err:.3e} (tol {tol:g})")
    if not (err <= tol and torch.equal(lens_gpu.cpu(), lens_cpu)):
        raise AssertionError(f"{tag}: the card disagrees with the CPU plain path: {err}")


def phase_serve_avhubert(kernels, card):
    """Phase 33: an ASRModel over AV-HuBERT Base, audio-only (vocab 5000,
    the 6 x 256 decoder, weights from seed 0), serves the 10 s request at
    beam 10 (serve_one: no hand-written kernel launched; the encoder
    against the CPU on the request's first CPU_SLICE_SECONDS), then one
    encode traced (card only)."""
    from torch.profiler import ProfilerActivity, profile

    model = build_serve_asr("avhubert", **AVH_ENCODER)
    wave = request_waves()[0]
    print(f"[serve-avhubert] ASRModel over AV-HuBERT Base {AVH_ENCODER}, audio-only: "
          f"{sum(p.numel() for p in model.parameters())} parameters, "
          f"{sum(p.numel() for p in model.encoder.parameters())} in the encoder; T' = "
          f"{encoder_frames(model, [wave])[0]} for {REQUEST_SECONDS[0]} s")
    launches = serve_one("serve-avhubert", model, wave, kernels, card, (), expected={},
                         check=check_slice_on_cpu)
    speech, n = torch.from_numpy(wave[None]).cuda(), torch.tensor([wave.shape[0]], device="cuda")
    with torch.inference_mode(), profile(activities=[ProfilerActivity.CUDA]) as prof:
        model.encode(speech, n)
        torch.cuda.synchronize()
    dev_ms, events = device_busy(prof)
    print(f"[serve-avhubert] encode traced (card only): device busy {dev_ms:.3f} ms [{card}]")
    print_top("serve-avhubert", events, n=6)
    del model
    torch.cuda.empty_cache()
    return launches


def check_av_module(card):
    """The audio-visual path through the module: AVHubertModel (Base,
    concat fusion, the ResNet-18 trunk; weights from seed 0) on B = AV_B x
    10 s of AV_PIXELS x AV_PIXELS lip crops at AV_FPS with AV_AUDIO_DIM
    audio features a frame, forward and backward in training mode
    (dropout 0.1): one warm-up and AV_ROUNDS timed runs, peak memory; then
    in eval mode on the first CPU_SLICE_SECONDS (lengths 50 and 40
    frames) the card's output and every gradient against a CPU copy: the
    output within 1e-3, the whole gradient within 1e-3 of its norm, or,
    where it misses that, settled in float64 (the stem's and the first
    stages' convolution gradients through GroupNorm round at ~7e-4 of
    their norm on the CPU alone)."""
    import copy

    from llm_guided_asr_tpu_torch.convert import init_weights
    from llm_guided_asr_tpu_torch.models.avhubert import AVHubertConfig, AVHubertModel
    from llm_guided_asr_tpu_torch.utils.rng import StepRNG

    with torch.device("cuda"):
        model = AVHubertModel(AVHubertConfig(), AV_AUDIO_DIM)
    init_weights(model, seed=0)
    frames = int(TRAIN_SECONDS * AV_FPS)
    rng = np.random.default_rng(8)
    audio = torch.from_numpy(rng.standard_normal((AV_B, frames, AV_AUDIO_DIM))
                             .astype(np.float32)).cuda()
    video = torch.from_numpy(rng.uniform(0.0, 1.0, (AV_B, frames, AV_PIXELS, AV_PIXELS))
                             .astype(np.float32)).cuda()
    lens = torch.tensor([frames, frames - 40], device="cuda")
    model.train()
    gen = torch.Generator().manual_seed(0)
    dts = []
    torch.cuda.reset_peak_memory_stats()
    for i in range(1 + AV_ROUNDS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, _ = model(audio, lens, video, rng=StepRNG(gen, "cuda"))
        out.square().mean().backward()
        torch.cuda.synchronize()
        if i:
            dts.append((time.perf_counter() - t0) * 1e3)
        model.zero_grad(set_to_none=True)
    ms = sorted(dts)
    peak = torch.cuda.max_memory_allocated()
    print(f"[train-avhubert] the audio-visual module (AV-HuBERT Base, concat, ResNet-18 trunk; "
          f"{sum(p.numel() for p in model.parameters())} parameters, "
          f"{sum(p.numel() for p in model.video_resnet.parameters())} in the trunk) on "
          f"B={AV_B} x {TRAIN_SECONDS} s: {frames} frames of {AV_PIXELS}x{AV_PIXELS} at "
          f"{AV_FPS} fps, forward and backward median {float(np.median(ms)):.1f} ms (min "
          f"{ms[0]:.1f}, max {ms[-1]:.1f}, {AV_ROUNDS} runs), peak memory {peak / 2**30:.2f} "
          f"GiB [{card}]")
    model.eval()
    n = int(CPU_SLICE_SECONDS * AV_FPS)
    args = (audio[:, :n].contiguous(), torch.tensor([n, n - 10], device="cuda"),
            video[:, :n].contiguous())
    cot = torch.from_numpy(rng.standard_normal((AV_B, n, model.cfg.encoder_embed_dim))
                           .astype(np.float32))
    cpu = copy.deepcopy(model).cpu()
    outs, grads = {}, {}
    for name, m in (("card", model), ("cpu", cpu)):
        dev = next(m.parameters()).device
        out, _ = m(*(a.to(dev) for a in args))
        (out * cot.to(dev)).sum().backward()
        outs[name] = out.detach().cpu()
        grads[name] = {k: p.grad.detach().cpu().double() for k, p in m.named_parameters()}
    def rel(a, b):
        return (sum(float(((a[k] - g) ** 2).sum()) for k, g in b.items())
                / sum(float((g ** 2).sum()) for g in b.values())) ** 0.5

    err, g_err = max_err(outs["card"], outs["cpu"]), rel(grads["card"], grads["cpu"])
    print(f"[train-avhubert] the module card vs CPU on the first {CPU_SLICE_SECONDS} s "
          f"(B={AV_B}, {n} and {n - 10} frames, eval mode): output max_abs_err {err:.3e} "
          f"(tol 1e-3), the whole gradient within {g_err:.2e} of its norm (tol 1e-3) [{card}]")
    if not err <= 1e-3:
        raise AssertionError(f"train-avhubert: the module's output on the card disagrees with "
                             f"the CPU's: {err}")
    if not g_err <= 1e-3:
        # settled in float64, as tests/test_torch_gpu.py settles a miss: the
        # module has no hand-written kernel, so it runs in float64 on the
        # card too; the two float64 gradients must agree, and the card's
        # float32 one sit no further from them than the CPU's plus 1e-3
        g64 = {}
        for name, m in (("card", model), ("cpu", cpu)):
            m64 = copy.deepcopy(m).double()
            m64.zero_grad(set_to_none=True)
            dev = next(m64.parameters()).device
            out, _ = m64(*(a.to(dev, torch.float64) if a.is_floating_point() else a.to(dev)
                           for a in args))
            (out * cot.to(dev, torch.float64)).sum().backward()
            g64[name] = {k: p.grad.detach().cpu() for k, p in m64.named_parameters()}
        gap, card_d, cpu_d = (rel(g64["card"], g64["cpu"]), rel(grads["card"], g64["cpu"]),
                              rel(grads["cpu"], g64["cpu"]))
        print(f"[train-avhubert] settled in float64: the card's float64 gradient within "
              f"{gap:.2e} of the CPU's (tol 1e-9); from it the card's float32 {card_d:.2e}, the "
              f"CPU's {cpu_d:.2e} of its norm (the card's within the CPU's + 1e-3) [{card}]")
        if not (gap <= 1e-9 and card_d <= cpu_d + 1e-3):
            raise AssertionError(f"train-avhubert: the module's gradient on the card: float64 "
                                 f"{gap} from the CPU's, float32 {card_d} from it (CPU {cpu_d})")
    del model, cpu
    torch.cuda.empty_cache()


def phase_train_avhubert(kernels, card):
    """Phase 34: the serve-avhubert model trained with SpecAug, dropout 0.1
    and AdamW at B = AVH_B x 10 s, audio-only: AVH_WARMUP warm-up and
    AVH_STEPS timed steps (finite, falling; no hand-written kernel); then
    the audio-visual module's forward and backward (check_av_module)."""
    model = build_serve_asr("avhubert", train=True, **AVH_ENCODER)
    launches, _ = train_model("train-avhubert", model, AVH_B, AVH_WARMUP, AVH_STEPS, kernels,
                              card, {})
    del model
    torch.cuda.empty_cache()
    reset_counts(kernels)
    check_av_module(card)
    if any(counts(kernels).values()):
        raise AssertionError(f"train-avhubert: the module launched {counts(kernels)}")
    return launches


def phase_align_cli(kernels, card, root: Path):
    """Phase 35, in phase 16's directory: asr_align on two valid
    utterances with part A's model (12 launches of each encoder forward an
    utterance, nothing else; every token a segment, in order, inside its
    utterance; the Viterbi on the card equal to the same on the CPU from
    the card's log-posteriors), then lm_inference with part C's LM on two
    word prompts, greedily (each token the CPU LM's best or within 1e-4 of
    it, on the card's continuation) and sampled at temperature 1 from
    seed 0 (in the vocabulary; a second run with the same seed draws the
    same text).  Each CLI call is timed."""
    from llm_guided_asr_tpu_torch.bin import asr_align, lm_inference
    from llm_guided_asr_tpu_torch.bin.asr_inference import Speech2Text, encode_request
    from llm_guided_asr_tpu_torch.data.fileio import read_2columns_text, read_wav
    from llm_guided_asr_tpu_torch.ops.ctc_align import ctc_forced_align
    from llm_guided_asr_tpu_torch.tasks.asr import build_text_converter
    from llm_guided_asr_tpu_torch.tasks.lm import LMTask

    exp, lexp = root / "exp", root / "lmexp"
    config, ave = exp / "config.yaml", exp / "valid.loss.ave_2best.pth"
    two, words = root / "valid2.scp", root / "valid.words"
    total = {}

    def run(fn, argv):
        torch.cuda.synchronize()
        reset_counts(kernels)
        t0 = time.perf_counter()
        out = fn(argv)
        torch.cuda.synchronize()
        launches = counts(kernels)
        total.update(add_counts(total, launches))
        return out, time.perf_counter() - t0, launches

    aligned, sec, launches = run(asr_align.main, [
        "--asr_train_config", str(config), "--asr_model_file", str(ave), "--wav_scp", str(two),
        "--text", str(words), "--output_dir", str(root / "align")])
    for name, n in launches.items():
        if n != (12 * len(aligned) if name in ENCODER_FWD else 0):
            raise AssertionError(f"align-cli: {name} launched {n} times")
    texts, wavs = read_2columns_text(words), read_2columns_text(two)
    segments = (root / "align" / "segments").read_text().splitlines()
    if sorted(aligned) != sorted(wavs) or len(segments) != sum(map(len, aligned.values())):
        raise AssertionError(f"align-cli: {len(segments)} segments for {sorted(aligned)}")
    for uid, parts in aligned.items():
        dur = len(read_wav(wavs[uid])[1]) / SR
        if [t for t, _, _ in parts] != texts[uid].split():
            raise AssertionError(f"align-cli: {uid}: aligned tokens differ from the text")
        bounds = [x for _, t0, t1 in parts for x in (t0, t1)]
        if bounds != sorted(bounds) or bounds[-1] > dur + 0.05:
            raise AssertionError(f"align-cli: {uid}: boundaries {bounds} out of order or past "
                                 f"{dur} s")
    s2t = Speech2Text(config, ave, beam_size=1, ctc_weight=1.0)
    uid = sorted(aligned)[0]
    with torch.inference_mode():
        enc, enc_lens = encode_request(s2t.model, read_wav(wavs[uid])[1],
                                       s2t.speech_pad_multiple, s2t.device)
        logp = s2t.model.ctc_log_softmax(enc)[0]
    ids = torch.tensor(s2t.converter.tokens2ids(texts[uid].split()))
    got, want = ctc_forced_align(logp, ids, enc_lens[0]), ctc_forced_align(logp.cpu(), ids,
                                                                           enc_lens[0].cpu())
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"align-cli: {uid}: the Viterbi on the card differs from the CPU's")
    print(f"[align-cli] asr_align: {len(aligned)} utterances, {len(segments)} token segments, "
          f"{sec:.2f} s (the model's build included); {uid}'s {int(enc_lens[0])} frames' state "
          f"path on the card = the CPU's [{card}]")

    prompts = root / "prompts"
    prompts.write_text("p1 w0002 w0003 w0004\np2 w0100\n")
    lm_args = ["--train_config", str(lexp / "config.yaml"),
               "--model_file", str(lexp / "valid.loss.ave_1best.pth"), "--text", str(prompts),
               "--n_new", "12"]
    greedy, g_sec, launches = run(lm_inference.main, lm_args + ["--output_dir",
                                                                str(root / "gen_greedy")])
    sampled, s_sec, _ = run(lm_inference.main, lm_args + [
        "--output_dir", str(root / "gen_sampled"), "--temperature", "1.0", "--seed", "0"])
    again, _, _ = run(lm_inference.main, lm_args + [
        "--output_dir", str(root / "gen_again"), "--temperature", "1.0", "--seed", "0"])
    if any(launches.values()) or again != sampled:
        raise AssertionError(f"align-cli: lm_inference launched {launches}, or one seed drew "
                             f"{sampled} then {again}")
    lm, lm_config = LMTask.build_model_from_file(lexp / "config.yaml",
                                                 lexp / "valid.loss.ave_1best.pth", "cpu")
    tokenizer, converter = build_text_converter(lm_config)
    vocab = set(converter.token_list)
    gap = 0.0
    sos = lm.vocab_size - 1
    for uid, prompt in read_2columns_text(prompts).items():
        head = [sos] + converter.tokens2ids(tokenizer.text2tokens(prompt))
        cont = converter.tokens2ids(tokenizer.text2tokens(greedy[uid]))
        seq = torch.tensor([head + cont])
        with torch.inference_mode():
            logits = lm.lm(seq, torch.tensor([seq.shape[1]]))[0]
        for i, tok in enumerate(cont):
            row = logits[len(head) + i - 1]
            gap = max(gap, float(row.max() - row[tok]))
        if not set(sampled[uid].split()) <= vocab:
            raise AssertionError(f"align-cli: {uid}: sampled tokens outside the vocabulary")
    print(f"[align-cli] lm_inference (part C's LM, {LM_CONF}): greedy 2 prompts x 12 tokens in "
          f"{g_sec:.2f} s, each token within {gap:.2e} of the CPU LM's best logit (tol 1e-4); "
          f"sampled at temperature 1, seed 0, in {s_sec:.2f} s, the same text again from the "
          f"same seed; greedy {greedy}, sampled {sampled} [{card}]")
    if not gap <= 1e-4:
        raise AssertionError(f"align-cli: a greedy token is {gap} below the CPU LM's best")
    return total


# phases 36-37 (serve-bf16, train-bf16): the two headline models in
# bfloat16 compute (train_dtype: bfloat16), float32 parameters
# bfloat16 scores and losses against float32, relative to their size: with
# the guided model's first pass pinned (pinned_first_pass), one 24-token
# sequence scored at most 2.81e-4 apart in the two dtypes, and the steps'
# losses at most 4.1e-4 (the first loss of train-2's timed steps), on an
# H100 80GB HBM3 at 700 W; the limit keeps a tenfold margin over both
BF16_REL = 5e-3
BF16_GRAD_REL = 5e-2  # a tensor's gradient against float32, of max(its norm, 0.1 the largest)
BF16_GRAD_B = 4  # the gradient check's batch rows (of train-1's batch)
F32, BF16 = torch.float32, torch.bfloat16


def dtype_counts(kernels) -> dict:
    """{entry point: {dtype: launches}} since the counts were last reset."""
    return {name: dict(by) for k in kernels for name, by in k.dtype_launches.items() if by}


def check_dtype_launches(tag, kernels, want: dict) -> dict:
    """Each entry point of ``want`` ({name: {dtype: n}}) launched exactly
    so; a bfloat16 path that launched nothing in bfloat16 fails."""
    got = dtype_counts(kernels)
    print(f"[{tag}] kernel launches by operand dtype: {got}")
    for name, by in want.items():
        if got.get(name, {}) != {str(k): n for k, n in by.items() if n}:
            raise AssertionError(f"{tag}: {name} launched {got.get(name)}, expected {by}")
        if by.get(BF16, 0) and not got[name].get(str(BF16)):
            raise AssertionError(f"{tag}: {name} launched nothing in bfloat16")
    return got


def bf16_twin(model):
    """A model of ``model``'s config and weights computing in bfloat16 (an
    ASRModel, the guided or ST model or a transducer)."""
    from llm_guided_asr_tpu_torch.models.llm_guided import LLMGuidedASRModel

    if isinstance(model, LLMGuidedASRModel):  # the guided model or the ST model
        twin = type(model)(model.cfg, llm_dtype=next(model.llm.parameters()).dtype,
                           device="cuda", dtype=BF16)
    else:
        twin = type(model)(model.cfg, device="cuda", dtype=BF16)
    twin.load_state_dict(model.state_dict())
    for p, q in zip(model.parameters(), twin.parameters()):  # a phase may have frozen some
        q.requires_grad_(p.requires_grad)
    return twin.train(model.training)


class pinned_first_pass:
    """Within the block, the bfloat16 guided model's first pass (its greedy
    CTC hypothesis, the LLM's prompt) is the float32 model's of the same
    input: on random weights the CTC head's 128,256 outputs sit within
    rounding of one another at many frames, so bfloat16 can pick another
    token there and hand the LLM another prompt.  Pinned, the two dtypes
    compare the same computation.  The first passes are taken in eval mode
    (no SpecAug draw)."""

    def __init__(self, bf16, f32, speech, lengths):
        self.bf16 = bf16
        modes = [(m, m.training) for m in (bf16, f32)]
        with torch.inference_mode():
            enc32 = f32.eval().encode(speech, lengths)
            enc16 = bf16.eval().encode(speech, lengths)
            self.hyp = f32._first_pass_hyp(*enc32)
            own = bf16._first_pass_hyp(*enc16)
        for m, mode in modes:
            m.train(mode)
        self.same = (torch.equal(own[1], self.hyp[1])
                     and all(torch.equal(a[: int(n)], b[: int(n)])
                             for a, b, n in zip(own[0], self.hyp[0], self.hyp[1])))

    def __enter__(self):
        self.bf16._first_pass_hyp = lambda *args: self.hyp
        return self

    def __exit__(self, *exc):
        del self.bf16._first_pass_hyp


class no_first_pass(contextlib.nullcontext):
    """pinned_first_pass's stand-in for a model without a first pass."""

    same = True


def pin_request(wave, s2t16, s2t32) -> pinned_first_pass:
    """pinned_first_pass for one request as Speech2Text pads it (nothing
    to pin for a model without a first pass: the CTC/attention model)."""
    from llm_guided_asr_tpu_torch.bin.asr_inference import round_up

    if not hasattr(s2t32.model, "_first_pass_hyp"):
        return no_first_pass()

    padded = np.zeros((1, round_up(wave.shape[0], s2t32.speech_pad_multiple)), np.float32)
    padded[0, : wave.shape[0]] = wave
    return pinned_first_pass(s2t16.model, s2t32.model, torch.from_numpy(padded).cuda(),
                             torch.tensor([wave.shape[0]], device="cuda"))


@contextlib.contextmanager
def bf16_fault(kind, model):
    """A deliberately wrong bfloat16 path, to show what the comparison's
    limit tells apart: ``softmax``, the attention softmax of
    models/transformer.py on bfloat16 scores with a bfloat16 result (no
    float32 step); ``logp``, ``model``'s decoder log-probs rounded to
    bfloat16 (a log-softmax left in bfloat16); ``ctc``, its CTC
    log-softmax left in bfloat16, so that the search's CTC prefix scores
    follow it into bfloat16."""
    from llm_guided_asr_tpu_torch.models import transformer as tr

    plain = tr.masked_softmax
    if kind == "softmax":
        def masked_softmax(scores, mask):
            mask = mask[:, None] if mask.dim() == 3 else mask
            attn = torch.softmax(scores.to(BF16).masked_fill(~mask, tr.NEG_INF), dim=-1)
            return attn.masked_fill(~mask, 0.0)

        tr.masked_softmax = masked_softmax
    elif kind == "logp":
        step = model.decode_step

        def decode_step(*args, **kwargs):
            logp, state = step(*args, **kwargs)
            return logp.to(BF16).float(), state

        model.decode_step = decode_step
    elif kind == "ctc":
        ctc = model.ctc_log_softmax
        model.ctc_log_softmax = lambda enc: ctc(enc).to(BF16)
    else:
        raise ValueError(kind)
    try:
        yield
    finally:
        tr.masked_softmax = plain
        model.__dict__.pop("decode_step", None)
        model.__dict__.pop("ctc_log_softmax", None)


def bf16_fault_readings(tag, wave, s2t16, s2t32, best) -> dict:
    """The float32 search's ``best`` of one request forced through the
    bfloat16 search (first pass pinned) on the sound path and on each
    bf16_fault: {path: relative error against its float32 score}."""
    from llm_guided_asr_tpu_torch.bin.asr_inference import encode_request

    out = {}
    with pin_request(wave, s2t16, s2t32):
        for kind in ("sound", "softmax", "logp", "ctc"):
            fault = (contextlib.nullcontext() if kind == "sound"
                     else bf16_fault(kind, s2t16.model))
            with fault, torch.inference_mode():
                enc16 = encode_request(s2t16.model, wave, s2t16.speech_pad_multiple,
                                       s2t16.device)
                score = s2t16.beam.rescore(*enc16, best.yseq, maxlenratio=s2t16.maxlenratio)
            out[kind] = abs(score - best.score) / max(1.0, abs(best.score))
    print(f"[{tag}] the float32 best ({best.score:.4f}) forced through bfloat16: "
          + ", ".join(f"{k} {v:.2e}" for k, v in out.items()) + f" of the score (limit "
          f"{BF16_REL}; softmax: the attention softmax without its float32 step; logp: the "
          "log-probs rounded to bfloat16; ctc: the CTC log-softmax and prefix scores in "
          "bfloat16)")
    return out


def compare_best_bf16(tag, wave, s2t16, s2t32, bests=None) -> tuple:
    """The bfloat16 and float32 searches' best of one request, a and b,
    with the first pass pinned (pinned_first_pass).  Equal: the scores
    within BF16_REL of their size.  Different (random weights leave the
    beam among near ties at every step, so bfloat16's rounding can move
    its path): each sequence forced through the other dtype's search
    (``BatchBeamSearch.rescore``) scores within BF16_REL of its own
    search's score, so that the two dtypes score the same tokens alike and
    part only on the path; the token where they part and the float32 gap
    between them are printed.  ``bests``: the two searches' bests of this
    request already found, for a model without a first pass to pin.
    Returns (equal, the largest relative score error, whether bfloat16's
    own first pass was float32's)."""
    pin = pin_request(wave, s2t16, s2t32)
    with pin:
        if bests is not None and isinstance(pin, no_first_pass):
            a, b = bests
        else:
            (_, a), = s2t16(wave)
            (_, b), = s2t32(wave)
        if a.yseq == b.yseq:
            err = abs(a.score - b.score) / max(1.0, abs(b.score))
            print(f"[{tag}] the bfloat16 and float32 bests are equal (bfloat16's own first "
                  f"pass {'equal' if pin.same else 'different'}), scores {a.score:.4f} and "
                  f"{b.score:.4f}")
            if err > BF16_REL:
                raise AssertionError(f"{tag}: score {a.score} in bfloat16, {b.score} in "
                                     "float32")
            return True, err, pin.same
        own = "equal" if pin.same else "different"
        err = rescore_pair_bf16(tag, wave, s2t16, s2t32, a, b,
                                f"bfloat16's own first pass {own}")
    return False, err, pin.same


def rescore_pair_bf16(tag, wave, s2t16, s2t32, a, b, note="") -> float:
    """Two different bests of one request, ``a`` bfloat16's and ``b``
    float32's: each forced through the other dtype's search
    (``BatchBeamSearch.rescore`` over the request as Speech2Text pads it)
    scores within BF16_REL of its own search's score, so that the dtypes
    score the same tokens alike and part only on the path; the token where
    they part and the float32 gap printed.  Returns the larger error."""
    from llm_guided_asr_tpu_torch.bin.asr_inference import encode_request

    with torch.inference_mode():
        enc16 = encode_request(s2t16.model, wave, s2t16.speech_pad_multiple, s2t16.device)
        enc32 = encode_request(s2t32.model, wave, s2t32.speech_pad_multiple, s2t32.device)
        a32 = s2t32.beam.rescore(*enc32, a.yseq, maxlenratio=s2t32.maxlenratio)
        b16 = s2t16.beam.rescore(*enc16, b.yseq, maxlenratio=s2t16.maxlenratio)
    errs = (abs(a.score - a32) / max(1.0, abs(a32)), abs(b16 - b.score) / max(1.0, abs(b.score)))
    part = next(i for i, (x, y) in enumerate(zip(a.yseq + [-1], b.yseq + [-1])) if x != y)
    print(f"[{tag}] the bfloat16 and float32 bests part at token {part} of {len(b.yseq) - 2} "
          f"({note}): bfloat16's best scores {a.score:.4f} (float32 {a32:.4f}), float32's "
          f"{b.score:.4f} (bfloat16 {b16:.4f}); float32 gap {b.score - a32:.4f}, bfloat16 gap "
          f"{a.score - b16:.4f}")
    if max(errs) > BF16_REL:
        raise AssertionError(f"{tag}: the dtypes score one sequence apart: {errs}")
    return max(errs)


def phase_serve_bf16(model, kernels, card):
    """Phase 3's guided model (12 x 256 Conformer, 6 x 256 guided decoder,
    the Llama-3.2-1B-wide bf16 LLM) and its bfloat16-compute twin (the same
    float32 weights), each serving the 10.0, 7.3 and 4.1 s requests at beam
    10 in turns (f32, bf16, bf16, f32 ...), ROUNDS timed runs a length
    after one warm-up each: latencies, encode times, peak memory, launches
    by dtype (the encoder kernels in bfloat16 for the twin, float32 for the
    model), one traced bfloat16 10 s request; each length's bfloat16
    hypothesis against the float32 one by compare_best_bf16 (tokens
    compared; a sequence's scores in both dtypes within BF16_REL); then
    the twins of the transducer, the other encoders and decoders, the SSL,
    pretrained and AV-HuBERT trunks, the raw-audio and multichannel
    frontends, streaming and the LMs (serve_bf16_twins)."""
    from torch.profiler import ProfilerActivity, profile

    from llm_guided_asr_tpu_torch.bin.asr_inference import Speech2Text

    models = {F32: model.eval(), BF16: bf16_twin(model).eval()}
    s2t = {dt: Speech2Text.from_model(m, ctc_weight=0.3, beam_size=10, maxlenratio=-24.0)
           for dt, m in models.items()}
    waves = request_waves()
    for dt in (F32, BF16):
        for wave in waves:
            s2t[dt](wave)
    torch.cuda.synchronize()
    reset_counts(kernels)
    lat = {dt: {sec: [] for sec in REQUEST_SECONDS} for dt in (F32, BF16)}
    peak = dict.fromkeys((F32, BF16), 0)
    hyps = {}
    for r in range(ROUNDS):
        for dt in ((F32, BF16) if r % 2 == 0 else (BF16, F32)):
            for sec, wave in zip(REQUEST_SECONDS, waves):
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                (ids, hyp), = s2t[dt](wave)
                torch.cuda.synchronize()
                lat[dt][sec].append(time.perf_counter() - t0)
                peak[dt] = max(peak[dt], torch.cuda.max_memory_allocated())
                if hyps.setdefault((dt, sec), hyp).yseq != hyp.yseq:
                    raise AssertionError(f"serve-bf16 {dt}: the same request gave another "
                                         "hypothesis")
    n = ROUNDS * len(REQUEST_SECONDS)
    blocks = model.cfg.encoder.num_blocks
    launches = counts(kernels)
    by_dtype = check_dtype_launches("serve-bf16", kernels, {
        name: {F32: blocks * n, BF16: blocks * n} for name in ENCODER_FWD})
    med = {}
    for sec, wave in zip(REQUEST_SECONDS, waves):
        row = []
        for dt in (F32, BF16):
            ms = sorted(x * 1e3 for x in lat[dt][sec])
            med[(dt, sec)] = float(np.median(ms))
            row.append(f"{str(dt)[6:]} median {med[(dt, sec)]:.1f} ms (min {ms[0]:.1f}, max "
                       f"{ms[-1]:.1f}), RTFx {sec / med[(dt, sec)] * 1e3:.2f}")
        print(f"[serve-bf16] {sec:.1f} s request, {ROUNDS} runs each: " + "; ".join(row)
              + f" [{card}]")
    for dt in (F32, BF16):
        speech = torch.from_numpy(waves[0][None]).cuda()
        n_s = torch.tensor([waves[0].shape[0]], device="cuda")
        t_enc = []
        with torch.inference_mode():
            for _ in range(ROUNDS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                models[dt].encode(speech, n_s)
                torch.cuda.synchronize()
                t_enc.append(time.perf_counter() - t0)
        print(f"[serve-bf16] {str(dt)[6:]}: 10 s encode median "
              f"{float(np.median(t_enc)) * 1e3:.1f} ms; peak memory {peak[dt]} bytes "
              f"({peak[dt] / 2**30:.2f} GiB) [{card}]")
    worst, equal, first = 0.0, 0, 0
    for sec, wave in zip(REQUEST_SECONDS, waves):
        check_scores(hyps[(BF16, sec)])
        same, err, pass_same = compare_best_bf16(f"serve-bf16 {sec} s", wave, s2t[BF16],
                                                 s2t[F32])
        equal, worst, first = equal + same, max(worst, err), first + pass_same
    print(f"[serve-bf16] first pass pinned to float32's ({first} of {len(waves)} equal "
          f"unpinned): {equal} of {len(waves)} bfloat16 bests equal the float32 ones; one "
          f"sequence's scores in the two dtypes at most {worst:.2e} of the score apart (tol "
          f"{BF16_REL})")
    bf16_fault_readings("serve-bf16 10.0 s", waves[0], s2t[BF16], s2t[F32],
                        hyps[(F32, REQUEST_SECONDS[0])])
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        s2t[BF16](waves[0])
        torch.cuda.synchronize()
    dev_ms, events = device_busy(prof)
    print(f"[serve-bf16] 10.0 s bfloat16 request traced (card only): device busy {dev_ms:.1f} "
          f"ms = {100 * dev_ms / med[(BF16, REQUEST_SECONDS[0])]:.1f}% of the unprofiled "
          f"median [{card}]")
    print_top("serve-bf16", events)
    del models[BF16], s2t
    torch.cuda.empty_cache()
    more, more_by = serve_bf16_twins(kernels, card)
    for name, d in more_by.items():
        for dt, n in d.items():
            by_dtype.setdefault(name, {})[dt] = by_dtype.get(name, {}).get(dt, 0) + n
    return add_counts(launches, more), by_dtype


@contextlib.contextmanager
def relu_gates(model, gates=None):
    """Within the block, every ReLU that ``model``'s run calls
    (``torch.relu``/``F.relu`` and the stored ``activation`` of the
    feed-forwards: the decoders', the subsampling convs', the length
    adaptor's) either records its gate (``gates`` None: the yielded list,
    h > 0 a call each, in call order) or takes the recorded one in place of
    its own (h * gate), as tests/test_torch_bf16_models.py's
    relu_replayed_grads runs bfloat16 on the float32 run's gates."""
    functional = torch.nn.functional
    relus = (torch.relu, functional.relu)
    record = gates is None
    gates = [] if record else gates
    pending = iter(gates)

    def gate(h, *args, **kwargs):
        if record:
            gates.append(h.detach() > 0)
            return relus[0](h)
        return h * next(pending).to(h.dtype)

    mods = [m for m in model.modules() if getattr(m, "activation", None) in relus]
    saved = [m.activation for m in mods]
    for m in mods:
        m.activation = gate
    torch.relu = functional.relu = gate
    try:
        yield gates
        if not record and next(pending, None) is not None:
            raise AssertionError("the bfloat16 run called ReLU fewer times than float32's")
    finally:
        torch.relu, functional.relu = relus
        for m, act in zip(mods, saved):
            m.activation = act


def check_grads_bf16(tag, f32, bf16, batch, args):
    """One training-mode forward and backward of ``batch`` in each model
    from the same step generator (the same SpecAug and dropout draws; the
    guided and ST models' first pass pinned to float32's in both,
    pinned_first_pass): the
    losses within BF16_REL, the whole gradient within BF16_GRAD_REL of its
    norm, and each float32 parameter's float32 gradient within
    BF16_GRAD_REL of max(its float32 norm, 0.1 of the largest).  A tensor
    that misses is held to the same limit on a bfloat16 run that takes the
    float32 run's ReLU gates (relu_gates): a gate within rounding of 0
    flips with the dtype and moves the gradient behind it, as the CPU test
    settles it."""
    from llm_guided_asr_tpu_torch.utils.rng import StepRNG

    from llm_guided_asr_tpu_torch.models.llm_guided import LLMGuidedASRModel

    pin = pin32 = contextlib.nullcontext()
    if isinstance(f32, LLMGuidedASRModel):
        pin = pinned_first_pass(bf16, f32, batch["speech"], batch["speech_lengths"])
        pin32 = pinned_first_pass(f32, f32, batch["speech"], batch["speech_lengths"])
        print(f"[{tag}] the first pass pinned to float32's (bfloat16's own "
              f"{'equal' if pin.same else 'different'})")

    def run(m):
        m.zero_grad()
        loss, stats, _ = m(*(batch[k] for k in args), rng=StepRNG(
            torch.Generator().manual_seed(5), "cuda"))
        loss.backward()
        grads = {n: p.grad.detach().clone() for n, p in m.named_parameters()
                 if p.grad is not None}
        m.zero_grad()
        return {k: float(v.detach()) for k, v in stats.items()}, grads

    with pin, pin32:
        with relu_gates(f32) as gates:
            s32, g32 = run(f32)
        s16, g16 = run(bf16)
    for k in s32:
        if k != "acc" and abs(s16[k] - s32[k]) > BF16_REL * max(1.0, abs(s32[k])):
            raise AssertionError(f"{tag}: {k} {s16[k]} in bfloat16, {s32[k]} in float32")
    if g16.keys() != g32.keys() or any(g.dtype != F32 for g in g16.values()):
        raise AssertionError(f"{tag}: bfloat16 gradients are not the float32 parameters'")
    # L2 norms: a ReLU gate within rounding of 0 flips a few elements of a
    # tensor's gradient in either dtype, which a max-abs check would count
    floor = 0.1 * max(g.norm().item() for g in g32.values())

    def errs(g):
        return {n: (g[n] - g32[n]).norm().item() / max(g32[n].norm().item(), floor)
                for n in g32}

    err = errs(g16)
    whole = (math.sqrt(sum((g16[n] - g).norm().item() ** 2 for n, g in g32.items()))
             / math.sqrt(sum(g.norm().item() ** 2 for g in g32.values())))
    name_w = max(err, key=err.get)
    print(f"[{tag}] B={batch['speech'].shape[0]} step, bfloat16 against float32: losses "
          + ", ".join(f"{k} {s16[k]:.4f}/{s32[k]:.4f}" for k in s32)
          + f"; {len(g32)} gradients, the whole {whole:.3e} of its norm, the worst tensor "
          f"{err[name_w]:.3e} of its norm ({name_w}; tol {BF16_GRAD_REL})")
    if whole > BF16_GRAD_REL:
        raise AssertionError(f"{tag}: the whole gradient {whole} > {BF16_GRAD_REL}")
    missed = sorted(n for n, e in err.items() if e > BF16_GRAD_REL)
    if missed:
        with pin, relu_gates(bf16, gates):
            gated = errs(run(bf16)[1])
        print(f"[{tag}] on the float32 run's ReLU gates ({len(gates)} calls): "
              + ", ".join(f"{n} {err[n]:.3e} -> {gated[n]:.3e}" for n in missed)
              + f" of its norm (tol {BF16_GRAD_REL}); the worst tensor there "
              f"{max(gated.values()):.3e}")
        bad = [n for n in missed if gated[n] > BF16_GRAD_REL]
        if bad:
            raise AssertionError(f"{tag}: gradients {bad} > {BF16_GRAD_REL} on the float32 "
                                 "gates too")


def train_bf16_case(tag, f32, bf16, batch, n_warm, n_steps, names, kernels, card,
                    frozen=(), check_loss_falls=True, per_step=None, f32_rows=(),
                    args=("speech", "speech_lengths", "text", "text_lengths")):
    """One model's float32 and bfloat16 twins on one batch (its ``args``):
    the gradient check (check_grads_bf16) on up to BF16_GRAD_B rows, then
    ``n_warm`` + ``n_steps`` steps of each dtype in turns (f32, bf16) from
    the same weights: step times, audio s/s, peak memory, the first loss
    against float32's, ``names`` launched once a block a step each (or as
    ``per_step`` says: {entry point: launches a step}), all in the step's
    dtype but ``f32_rows``, float32 whatever it (the WKV and LSTM kernels,
    which JAX runs in float32 inside a bfloat16 model); one bfloat16 step
    traced.  A model with a first pass (guided, ST) runs its own in the
    steps, so the two dtypes' first losses may read two prompts (near
    ties of the random CTC head); check_grads_bf16 compares the losses on
    one.  Returns the bfloat16 steps' (launches, launches by dtype)."""
    from llm_guided_asr_tpu_torch.train.optim import build_optimizer, path_prefix_mask
    from llm_guided_asr_tpu_torch.train.trainer import init_train_state, make_fused_train_step

    check_grads_bf16(f"train-bf16 {tag}", f32, bf16,
                     {k: v[:BF16_GRAD_B] for k, v in batch.items()}, args)
    blocks = f32.cfg.encoder.num_blocks
    per_step = per_step or {name: blocks for name in names}
    out = {}
    for dt, m in ((F32, f32), (BF16, bf16)):
        tx = build_optimizer("adamw", {"lr": 1e-3},
                             freeze_mask=path_prefix_mask(m, frozen) if frozen else ())
        step = make_fused_train_step(m, init_train_state(m, tx), torch.Generator().manual_seed(0),
                                     args)
        stats, med, launches = run_steps(f"train-bf16 {tag} {str(dt)[6:]}", step, batch,
                                         n_warm, n_steps, kernels, card)
        peak = torch.cuda.max_memory_allocated()
        by_dtype = check_dtype_launches(f"train-bf16 {tag} {str(dt)[6:]}", kernels, {
            name: {(F32 if name in f32_rows else dt): n * n_steps}
            for name, n in per_step.items()})
        out[dt] = (stats, med, peak, (launches, by_dtype), step)
    (s32, m32, p32, _, _), (s16, m16, p16, l16, step16) = out[F32], out[BF16]
    audio = batch["speech"].shape[0] * batch["speech"].shape[1] / SR
    l0, l1 = s32[0]["loss"], s16[0]["loss"]
    print(f"[train-bf16] {tag}: step median float32 {m32:.1f} ms, bfloat16 {m16:.1f} ms "
          f"({m32 / m16:.2f}x); audio s/s {audio / m32 * 1e3:.1f} and {audio / m16 * 1e3:.1f}; "
          f"peak memory {p32 / 2**30:.2f} and {p16 / 2**30:.2f} GiB; first loss {l0:.4f} and "
          f"{l1:.4f} [{card}]")
    if abs(l1 - l0) > BF16_REL * max(1.0, abs(l0)):
        raise AssertionError(f"train-bf16 {tag}: first loss {l1} in bfloat16, {l0} in float32")
    if check_loss_falls and not np.mean([s["loss"] for s in s16][-3:]) < l1:
        raise AssertionError(f"train-bf16 {tag}: the bfloat16 loss did not fall")
    profile_step(f"train-bf16 {tag} bf16", step16, batch, m16)
    return l16


def phase_train_bf16(guided, kernels, card):
    """train-1's model (12 x 256 Conformer, 6 x 256 decoder, vocab 5000,
    SpecAug, attention dropout 0.1, AdamW, B=64 x 10 s), train-flash's
    (the same with flash self-attention, B=8 x 60 s) and train-2's (phase
    3's guided model, encoder, CTC head and LLM frozen, B=2) in float32 and
    in bfloat16 compute from the same weights (train_bf16_case): every
    encoder entry point, forward and backward where the encoder trains,
    launched in bfloat16 by the twins; then the twins of the transducer,
    the other encoders, the SSL-frontend, AV-HuBERT and ST models
    (train_bf16_twins).  Returns the bfloat16 timed steps' launches of all
    cases (all, and by dtype)."""
    samples = int(TRAIN_SECONDS * SR)

    def noise_batch(seed, b, n_samples, text):
        rng = np.random.default_rng(seed)
        return {"speech": torch.from_numpy((rng.standard_normal((b, n_samples)) * 0.1)
                                           .astype(np.float32)).cuda(),
                "speech_lengths": torch.full((b,), n_samples, device="cuda"),
                "text": torch.from_numpy(rng.integers(1, 5000, (b, text))).cuda(),
                "text_lengths": torch.full((b,), text, device="cuda")}

    f32 = build_train1().train()
    batch = noise_batch(4, TRAIN_B, samples, 24)
    batch["text"] = torch.ones_like(batch["text"])  # train-1's
    out = [train_bf16_case("train-1", f32, bf16_twin(f32), batch, TRAIN_WARMUP, TRAIN_STEPS,
                           ENCODER_FWD + ENCODER_BWD, kernels, card)]
    del f32
    torch.cuda.empty_cache()
    f32 = build_flash_asr().train()
    batch = noise_batch(6, FLASH_B, int(FLASH_SECONDS[0] * SR), FLASH_TEXT)  # train-flash's
    out.append(train_bf16_case("train-flash", f32, bf16_twin(f32), batch, FLASH_WARMUP,
                               FLASH_STEPS, FLASH_FWD + FLASH_BWD, kernels, card))
    del f32
    torch.cuda.empty_cache()
    batch = noise_batch(1, GUIDED_B, samples, 16)
    batch["text"] = torch.ones_like(batch["text"])  # train-2's
    guided.train()
    out.append(train_bf16_case("train-2", guided, bf16_twin(guided), batch, GUIDED_WARMUP,
                               GUIDED_STEPS, ENCODER_FWD, kernels, card,
                               frozen=["encoder", "ctc_head", "llm"], check_loss_falls=False))
    torch.cuda.empty_cache()
    out += train_bf16_twins(kernels, card)
    launches = {name: sum(c[0][name] for c in out) for name in out[0][0]}
    by_dtype = {}
    for _, case in out:
        for name, by in case.items():
            for dt, n in by.items():
                by_dtype.setdefault(name, {})[dt] = by_dtype.get(name, {}).get(dt, 0) + n
    return launches, by_dtype


# the bfloat16 twins of the transducers and of the other encoders and
# decoders: full width, TWIN_BLOCKS encoder blocks (a depth cut that keeps
# phases 36-37 short), each beside its float32 twin in turns
TWIN_BLOCKS = 4
TWIN_ROUNDS = 2  # timed runs of the 10 s request a dtype


def forced_transducer_score(model, enc, n, yseq, per_frame=1, blank=0) -> float:
    """The best alignment's log-probability of the labels ``yseq`` over the
    first ``n`` rows of ``enc`` [1, T, D] in ``model``'s own arithmetic (the
    joint's log-probs in float32, as the searches take them): at most
    ``per_frame`` labels a frame, each frame closed by a blank (the
    default beam's lattice at max_sym_exp 2)."""
    u, dev = len(yseq), enc.device
    tokens = torch.tensor([list(yseq)], dtype=torch.long, device=dev).reshape(1, u)
    with torch.inference_mode():
        g = model.decode_labels(tokens)
        logp = torch.log_softmax(model.joint_full(enc[:, :n], g).float(), dim=-1)[0].double()
    emit = logp[:, torch.arange(u, device=dev), tokens[0]]  # [n, U]
    neg = torch.full((1,), -1e30, dtype=torch.float64, device=dev)
    alpha = torch.cat([torch.zeros(1, dtype=torch.float64, device=dev), neg.expand(u)])
    for t in range(n):
        cur = best = alpha
        for _ in range(per_frame):
            cur = torch.cat([neg, cur[:-1] + emit[t]])
            best = torch.maximum(best, cur)
        alpha = best + logp[t, :, blank]
    return float(alpha[u])


def compare_transducer_bf16(tag, wave, s2t16, s2t32) -> tuple:
    """compare_best_bf16 for the transducer's default beam: the two dtypes'
    bests equal, their scores within BF16_REL of their size; or, where
    bfloat16's rounding moved the path, each best's forced alignment
    (forced_transducer_score) scored by both dtypes within BF16_REL of its
    size, so that the dtypes score the same labels alike, and the float32
    gap between the two bests printed.  Returns (equal, the largest
    relative error)."""
    from llm_guided_asr_tpu_torch.bin.asr_inference import encode_request

    a, b = s2t16(wave)[0][1], s2t32(wave)[0][1]
    if a.yseq == b.yseq:
        err = abs(a.score - b.score) / max(1.0, abs(b.score))
        print(f"[{tag}] the bfloat16 and float32 bests are equal ({len(a.yseq)} labels), "
              f"scores {a.score:.4f} and {b.score:.4f}")
        if err > BF16_REL:
            raise AssertionError(f"{tag}: score {a.score} in bfloat16, {b.score} in float32")
        return True, err
    rows = {dt: encode_request(s.model, wave, s.speech_pad_multiple, s.device)
            for dt, s in ((BF16, s2t16), (F32, s2t32))}
    scores = {(dt, w): forced_transducer_score(s.model, rows[dt][0], int(rows[dt][1][0]),
                                               h.yseq) / (len(h.yseq) + 1)
              for dt, s in ((BF16, s2t16), (F32, s2t32)) for w, h in (("a", a), ("b", b))}
    errs = [abs(scores[(BF16, w)] - scores[(F32, w)]) / max(1.0, abs(scores[(F32, w)]))
            for w in ("a", "b")]
    part = next(i for i, (x, y) in enumerate(zip(a.yseq + [-1], b.yseq + [-1])) if x != y)
    print(f"[{tag}] the bfloat16 and float32 bests part at label {part} ({len(a.yseq)} and "
          f"{len(b.yseq)} labels): forced alignments, normalized, bfloat16's best "
          f"{scores[(BF16, 'a')]:.4f} (float32 {scores[(F32, 'a')]:.4f}), float32's "
          f"{scores[(F32, 'b')]:.4f} (bfloat16 {scores[(BF16, 'b')]:.4f}); float32 gap "
          f"{scores[(F32, 'b')] - scores[(F32, 'a')]:.4f}")
    if max(errs) > BF16_REL:
        raise AssertionError(f"{tag}: the dtypes score one label sequence apart: {errs}")
    return False, max(errs)


def serve_bf16_twin(tag, f32, wave, kernels, card, decode, per_request, f32_rows=(),
                    f32_per_request=None) -> tuple:
    """``f32`` and its bfloat16 twin (bf16_twin) serve the 10 s request
    through Speech2Text (``decode``) after one warm-up each, TWIN_ROUNDS
    timed runs a dtype in turns (f32, bf16, bf16, f32): latencies, peak
    memory, the same hypothesis every run; ``per_request`` ({entry point:
    launches a request}) launched in the request's dtype, ``f32_rows``
    ({entry point: None}: one launch a prediction-network call) and
    ``f32_per_request`` ({entry point: launches a request}: the
    multichannel mask estimator's LSTM) in float32 whatever it; the two
    bests compared (compare_best_bf16, or compare_transducer_bf16 for a
    transducer).  Returns (launches, launches by dtype)."""
    from llm_guided_asr_tpu_torch.bin.asr_inference import Speech2Text

    models = {F32: f32.eval(), BF16: bf16_twin(f32).eval()}
    s2t = {dt: Speech2Text.from_model(m, **decode) for dt, m in models.items()}
    for dt in (F32, BF16):
        s2t[dt](wave)
    torch.cuda.synchronize()
    calls = dict.fromkeys((F32, BF16), 0)  # prediction-network calls (transducer)
    hooks = [m.decoder.register_forward_hook(
        lambda *_, dt=dt: calls.__setitem__(dt, calls[dt] + 1)) for dt, m in models.items()]
    reset_counts(kernels)
    lat, peak, hyps = {F32: [], BF16: []}, dict.fromkeys((F32, BF16), 0), {}
    for r in range(TWIN_ROUNDS):
        for dt in ((F32, BF16) if r % 2 == 0 else (BF16, F32)):
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            hyp = s2t[dt](wave)[0][1]
            torch.cuda.synchronize()
            lat[dt].append(time.perf_counter() - t0)
            peak[dt] = max(peak[dt], torch.cuda.max_memory_allocated())
            if hyps.setdefault(dt, hyp).yseq != hyp.yseq:
                raise AssertionError(f"{tag} {dt}: the same request gave another hypothesis")
    for h in hooks:
        h.remove()
    launches = counts(kernels)
    want = {name: {F32: n * TWIN_ROUNDS, BF16: n * TWIN_ROUNDS}
            for name, n in per_request.items()}
    want.update({name: {F32: calls[F32] + calls[BF16]} for name in f32_rows})
    want.update({name: {F32: 2 * n * TWIN_ROUNDS} for name, n in (f32_per_request or {}).items()})
    by_dtype = check_dtype_launches(tag, kernels, want)
    print(f"[{tag}] 10.0 s request, {TWIN_ROUNDS} runs each: " + "; ".join(
        f"{str(dt)[6:]} median {float(np.median(lat[dt])) * 1e3:.1f} ms (min "
        f"{min(lat[dt]) * 1e3:.1f}, max {max(lat[dt]) * 1e3:.1f}), peak memory "
        f"{peak[dt] / 2**30:.2f} GiB" for dt in (F32, BF16)) + f" [{card}]")
    if hasattr(f32, "joint_full"):
        compare_transducer_bf16(tag, wave, s2t[BF16], s2t[F32])
    else:
        check_scores(hyps[BF16])
        compare_best_bf16(tag, wave, s2t[BF16], s2t[F32], (hyps[BF16], hyps[F32]))
    del models[BF16], s2t
    torch.cuda.empty_cache()
    return launches, by_dtype


def serve_bf16_twins(kernels, card) -> tuple:
    """The bfloat16 twins' serving: the LSTM transducer (its default beam
    5: the encoder kernels in bfloat16, the LSTM recurrence in float32 as
    flax promotes it), the E-Branchformer and the MultiConvformer
    CTC/attention models, and the Conformer with the rnn decoder (beam 10,
    ctc_weight 0.3), each at TWIN_BLOCKS blocks of full width beside its
    float32 twin (serve_bf16_twin).  Returns the summed (launches, launches
    by dtype).  Then the twins of the SSL frontend (HuBERT-Base's widths at
    TWIN_SSL_LAYERS layers), AV-HuBERT Base (TWIN_BLOCKS of its 12 layers)
    and the six-channel WPE/MVDR frontend (the mask estimator's LSTM in
    float32 in both dtypes, as JAX computes the frontend) as the others;
    the streaming Conformer (serve_bf16_stream); one untimed request of
    hubert_hf, wav2vec2_hf, whisper_hf, sinc + sliding window and the fused
    frontend (serve_bf16_once); the LMs' nll (lm_bf16_twins)."""
    wave = request_waves()[0]
    beam = dict(ctc_weight=0.3, beam_size=10, maxlenratio=-24.0)
    enc = dict.fromkeys(ENCODER_FWD, TWIN_BLOCKS)
    mc_wave_10s = mc_waves()[0]
    cases = (
        ("serve-bf16 transducer-rnn", lambda: build_transducer_lstm(num_blocks=TWIN_BLOCKS),
         dict(beam_size=TRANSDUCER_BEAM, nbest=TRANSDUCER_BEAM), enc, ("lstm_fwd",)),
        ("serve-bf16 e_branchformer", lambda: build_serve_asr(
            "e_branchformer", **{**EBF_ENCODER, "num_blocks": TWIN_BLOCKS}), beam, enc, ()),
        ("serve-bf16 multiconvformer", lambda: build_serve_asr(
            "multiconvformer", **{**NEW_ENCODERS["multiconvformer"], "num_blocks": TWIN_BLOCKS}),
         beam, {"rel_attention_fwd": TWIN_BLOCKS,
                "dwconv1d_fwd": (len(MCF_KERNELS) + 1) * TWIN_BLOCKS}, ()),
        ("serve-bf16 rnn decoder", lambda: build_serve_asr(
            decoder_type="rnn", decoder=NEW_DECODERS["rnn"], num_blocks=TWIN_BLOCKS), beam, enc,
         ()),
        ("serve-bf16 ssl", build_twin_ssl, beam, enc, ()),
        ("serve-bf16 avhubert", lambda: build_serve_asr(
            "avhubert", **{**AVH_ENCODER, "num_blocks": TWIN_BLOCKS}), beam, {}, ()),
    )
    launches, by_dtype = {}, {}

    def add(got, by):
        nonlocal launches
        launches = add_counts(launches, got)
        for name, d in by.items():
            for dt, n in d.items():
                by_dtype.setdefault(name, {})[dt] = by_dtype.get(name, {}).get(dt, 0) + n
        torch.cuda.empty_cache()

    for tag, build, decode, per_request, f32_rows in cases:
        add(*serve_bf16_twin(tag, build(), wave, kernels, card, decode, per_request, f32_rows))
    from llm_guided_asr_tpu_torch.ops.frontend import FrontendConfig

    add(*serve_bf16_twin("serve-bf16 multichannel", build_serve_asr(
        frontend=FrontendConfig(**MC_FRONTEND), num_blocks=TWIN_BLOCKS), mc_wave_10s, kernels,
        card, beam, enc, f32_per_request={"lstm_fwd": 2}))
    add(*serve_bf16_stream(kernels, card))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_twins_") as tmp:
        for tag, build, per_request in twin_once_models(Path(tmp)):
            add(*serve_bf16_once(tag, build(), wave, kernels, card, beam, per_request))
    add(*lm_bf16_twins(kernels, card))
    return launches, by_dtype


# the twins of the choices that JAX's dtype reaches through the SSL,
# pretrained and AV-HuBERT trunks, the raw-audio and multichannel
# frontends, streaming, ST and the LMs: the SSL trunks at TWIN_SSL_LAYERS
# of their 12 layers (Whisper-base's 6), AV-HuBERT Base and every Conformer
# at TWIN_BLOCKS blocks (depth cuts that keep phases 36-37 short); the
# *_hf encoders' widths from a config.json alone (the weights from seed 0)
TWIN_SSL_LAYERS = 4
TWIN_FUSED = ((512, 128, 80), (1024, 256, 80))  # two log-mel resolutions, 100 each
TWIN_LM_B, TWIN_LM_LEN = 16, 24  # the LMs' nll batch: 16 rows of <= 24 tokens


def build_twin_ssl(train=False):
    """train-1's Conformer (TWIN_BLOCKS blocks) and decoder behind the
    frozen SSL frontend: HuBERT-Base's widths at TWIN_SSL_LAYERS layers."""
    from llm_guided_asr_tpu_torch.models.ssl_encoders import W2VConfig

    return build_serve_asr(train=train, num_blocks=TWIN_BLOCKS, model={
        "frontend": None, "ssl_frontend": W2VConfig(num_hidden_layers=TWIN_SSL_LAYERS)})


def write_config_dir(path: Path, config: dict) -> Path:
    """A model directory holding config.json alone."""
    path.mkdir(parents=True, exist_ok=True)
    (path / "config.json").write_text(json.dumps(config))
    return path


def twin_once_models(root: Path) -> list:
    """(tag, builder of the float32 model, encoder entry points a request)
    of the twins that serve one untimed request each: hubert_hf
    (HuBERT-Base's widths) and wav2vec2_hf (the same widths, with
    wav2vec2-large-lv60's layer-norm feature extractor and pre-norm
    layers) on the raw waveform, whisper_hf (whisper-base's) on 80 log-mel bins, each under
    the 6 x 256 decoder; the sliding window + sinc pre-encoder + the
    Conformer (linear input) + the length adaptor; the fused frontend +
    the Conformer."""
    import dataclasses

    from llm_guided_asr_tpu_torch.models.preencoder import (
        LengthAdaptorConfig,
        SincPreencoderConfig,
    )
    from llm_guided_asr_tpu_torch.models.ssl_encoders import W2VConfig
    from llm_guided_asr_tpu_torch.ops.frontend import FrontendConfig

    w2v = {k: list(v) if isinstance(v, tuple) else v
           for k, v in dataclasses.asdict(W2VConfig(num_hidden_layers=TWIN_SSL_LAYERS)).items()}
    dirs = {"hubert": write_config_dir(root / "hubert", {**w2v, "model_type": "hubert"}),
            # wav2vec2-large-lv60's layer-norm feature extractor and pre-norm
            # layers at the base's widths, the branches HuBERT-Base leaves out
            "wav2vec2": write_config_dir(root / "wav2vec2", {
                **w2v, "model_type": "wav2vec2", "feat_extract_norm": "layer",
                "do_stable_layer_norm": True, "conv_bias": True})}
    dirs["whisper"] = write_config_dir(root / "whisper", {
        **WHISPER_BASE, "encoder_layers": TWIN_SSL_LAYERS, "model_type": "whisper"})
    raw = {"frontend": None, "normalize": "none"}
    enc = dict.fromkeys(ENCODER_FWD, TWIN_BLOCKS)
    return [
        ("serve-bf16 hubert_hf", lambda: build_serve_asr(
            "hubert_hf", model=raw, model_name_or_path=str(dirs["hubert"])), {}),
        ("serve-bf16 wav2vec2_hf", lambda: build_serve_asr(
            "wav2vec2_hf", model=raw, model_name_or_path=str(dirs["wav2vec2"])), {}),
        ("serve-bf16 whisper_hf", lambda: build_serve_asr(
            "whisper_hf", model_name_or_path=str(dirs["whisper"]), output_size=512), {}),
        ("serve-bf16 sinc", lambda: build_serve_asr(
            frontend=FrontendConfig(type="sliding_window", win_length=400, hop_length=160),
            normalize="none", input_layer="linear", num_blocks=TWIN_BLOCKS, model={
                "preencoder": SincPreencoderConfig(),
                "postencoder": ("length_adaptor", LengthAdaptorConfig(n_layers=1))}), enc),
        ("serve-bf16 fused", lambda: build_serve_asr(
            frontend=FrontendConfig(fused=TWIN_FUSED, proj_dim=100), num_blocks=TWIN_BLOCKS),
         enc),
    ]


def serve_bf16_once(tag, f32, wave, kernels, card, decode, per_request) -> tuple:
    """``f32`` and its bfloat16 twin serve one untimed request each
    (Speech2Text, ``decode``): ``per_request`` launched in each request's
    dtype; the two bests compared (compare_best_bf16).  Returns (launches,
    launches by dtype)."""
    from llm_guided_asr_tpu_torch.bin.asr_inference import Speech2Text

    models = {F32: f32.eval(), BF16: bf16_twin(f32).eval()}
    s2t = {dt: Speech2Text.from_model(m, **decode) for dt, m in models.items()}
    torch.cuda.synchronize()
    reset_counts(kernels)
    hyps, ms = {}, {}
    for dt in (F32, BF16):
        t0 = time.perf_counter()
        hyps[dt] = s2t[dt](wave)[0][1]
        torch.cuda.synchronize()
        ms[dt] = (time.perf_counter() - t0) * 1e3
    launches = counts(kernels)
    by_dtype = check_dtype_launches(tag, kernels, {name: {F32: n, BF16: n}
                                                   for name, n in per_request.items()})
    print(f"[{tag}] one untimed 10.0 s request each (first calls): float32 {ms[F32]:.1f} ms, "
          f"bfloat16 {ms[BF16]:.1f} ms; {sum(p.numel() for p in f32.parameters())} parameters "
          f"[{card}]")
    check_scores(hyps[BF16])
    compare_best_bf16(tag, wave, s2t[BF16], s2t[F32], (hyps[BF16], hyps[F32]))
    del models[BF16], s2t
    torch.cuda.empty_cache()
    return launches, by_dtype


def seed_stream_mvn(model) -> None:
    """serve-stream's seeded global-MVN statistics of 80 log-mel bins."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    with torch.no_grad():
        model.mvn_mean.copy_(torch.randn(80, generator=gen, device="cuda") * 0.5 - 8.0)
        model.mvn_inv_std.copy_(1.0 / (0.5 + torch.rand(80, generator=gen, device="cuda")))


def serve_bf16_stream(kernels, card) -> tuple:
    """serve-stream's contextual-block Conformer (its 12 blocks: at 4 the
    random model's CTC budget lets the partial hypotheses grow past 100
    tokens, which the search rescores every chunk) and its bfloat16 twin
    stream the 10 s request in 1 s chunks through
    Speech2TextStreaming (beam 10, ctc_weight 0.3, the 24-token cap), one
    warm-up and TWIN_ROUNDS timed streams a dtype in turns: each chunk's
    latency and the last one's; the depthwise forward (K = 15) once a
    completed block a layer in the stream's dtype; the final hypotheses
    equal (scores within BF16_REL), or each of the two sequences scored
    alike by the two dtypes' offline searches (BatchBeamSearch.rescore).
    Returns (launches, launches by dtype)."""
    from llm_guided_asr_tpu_torch.bin.asr_inference import encode_request
    from llm_guided_asr_tpu_torch.bin.asr_inference_streaming import Speech2TextStreaming

    tag = "serve-bf16 stream"
    f32 = build_serve_asr(encoder_type="contextual_block_conformer", normalize="global_mvn",
                          linear_units=2048, cnn_module_kernel=STREAM_KERNEL,
                          block_size=STREAM_BLOCK)
    seed_stream_mvn(f32)
    models = {F32: f32, BF16: bf16_twin(f32).eval()}
    kw = dict(beam_size=10, ctc_weight=0.3, maxlenratio=-24.0)
    streams = {dt: Speech2TextStreaming(m, chunk_samples=STREAM_CHUNK, **kw)
               for dt, m in models.items()}
    wave = request_waves()[0]

    def stream_once(st):
        st.reset()
        chunk_ms, out = [], None
        for start in range(0, len(wave), STREAM_CHUNK):
            t0 = time.perf_counter()
            out = st(wave[start: start + STREAM_CHUNK], is_final=start + STREAM_CHUNK >= len(wave))
            torch.cuda.synchronize()
            chunk_ms.append((time.perf_counter() - t0) * 1e3)
        return chunk_ms, out[0]

    for dt in (F32, BF16):
        stream_once(streams[dt])
    reset_counts(kernels)
    runs = {F32: [], BF16: []}
    for r in range(TWIN_ROUNDS):
        for dt in ((F32, BF16) if r % 2 == 0 else (BF16, F32)):
            runs[dt].append(stream_once(streams[dt]))
    launches, got = counts(kernels), dtype_counts(kernels)
    with torch.inference_mode():  # padded by one more bucket, as serve-stream says why
        speech = torch.from_numpy(np.pad(wave, (0, 1600))[None]).cuda()
        _, lens = f32.encode(speech, torch.tensor([len(wave)], device="cuda"))
    blocks = -(-int(lens[0]) // STREAM_BLOCK)
    n = f32.cfg.encoder.num_blocks * blocks * TWIN_ROUNDS
    want = {str(F32): n, str(BF16): n}
    print(f"[{tag}] kernel launches by operand dtype: {got}")
    if got.get("dwconv1d_fwd") != want:
        raise AssertionError(f"{tag}: dwconv1d_fwd launched {got.get('dwconv1d_fwd')}, "
                             f"expected {want}")
    by_dtype = got
    print(f"[{tag}] 10.0 s in {len(runs[F32][0][0])} chunks of {STREAM_CHUNK / SR:.1f} s, "
          f"{TWIN_ROUNDS} streams each: " + "; ".join(
              f"{str(dt)[6:]} chunk median "
              f"{float(np.median([x for c, _ in runs[dt] for x in c[:-1]])):.1f} ms, the last "
              f"{float(np.median([c[-1] for c, _ in runs[dt]])):.1f} ms" for dt in (F32, BF16))
          + f" [{card}]")
    (_, a), (_, b) = runs[BF16][-1][1], runs[F32][-1][1]
    if a.yseq == b.yseq:
        err = abs(a.score - b.score) / max(1.0, abs(b.score))
        print(f"[{tag}] the final hypotheses are equal ({len(a.yseq) - 2} tokens), streamed "
              f"scores {a.score:.4f} and {b.score:.4f}")
        if err > BF16_REL:
            raise AssertionError(f"{tag}: streamed score {a.score} in bfloat16, {b.score} in "
                                 "float32")
    else:
        s2t = {dt: st.s2t for dt, st in streams.items()}
        with torch.inference_mode():
            rows = {dt: encode_request(s2t[dt].model, wave, s2t[dt].speech_pad_multiple,
                                       s2t[dt].device) for dt in (F32, BF16)}
            cap = -float(max(len(a.yseq), len(b.yseq)))  # a stream may pass the offline cap
            sc = {(dt, w): s2t[dt].beam.rescore(*rows[dt], h.yseq, maxlenratio=cap)
                  for dt in (F32, BF16) for w, h in (("a", a), ("b", b))}
        errs = [abs(sc[(BF16, w)] - sc[(F32, w)]) / max(1.0, abs(sc[(F32, w)]))
                for w in ("a", "b")]
        print(f"[{tag}] the final hypotheses part ({len(a.yseq) - 2} and {len(b.yseq) - 2} "
              f"tokens): offline scores of bfloat16's {sc[(BF16, 'a')]:.4f} / float32 "
              f"{sc[(F32, 'a')]:.4f}, of float32's {sc[(BF16, 'b')]:.4f} / "
              f"{sc[(F32, 'b')]:.4f}; float32 gap {sc[(F32, 'b')] - sc[(F32, 'a')]:.4f}")
        if max(errs) > BF16_REL:
            raise AssertionError(f"{tag}: the dtypes score one sequence apart: {errs}")
    del models, streams
    torch.cuda.empty_cache()
    return launches, by_dtype


def lm_bf16_twins(kernels, card) -> tuple:
    """serve-lm's Transformer LM (LM_CONF, vocab 5000) and ESPnet's
    sequential RNN LM (2 LSTM layers of 650, vocab 5000), each with its
    bfloat16 twin (as ``build_lm(config, device, bfloat16)`` builds it; the
    weights from seed 0): one nll batch of TWIN_LM_B rows of at most
    TWIN_LM_LEN tokens, one warm-up and TWIN_ROUNDS timed calls a dtype in
    turns: times, the rows' NLL within BF16_REL of float32's; the RNN LM's
    LSTM kernel with float32 operands in both.  Returns (launches, by
    dtype)."""
    from llm_guided_asr_tpu_torch.convert import init_weights
    from llm_guided_asr_tpu_torch.models.lm import (
        ESPnetLanguageModel,
        SequentialRNNLM,
        SequentialRNNLMConfig,
        TransformerLM,
        TransformerLMConfig,
    )

    rng = np.random.default_rng(9)
    text = torch.from_numpy(rng.integers(1, 4999, (TWIN_LM_B, TWIN_LM_LEN))).cuda()
    lens = torch.from_numpy(rng.integers(TWIN_LM_LEN // 2, TWIN_LM_LEN + 1, TWIN_LM_B)).cuda()
    launches, by_dtype = {}, {}
    for tag, build, lstm in (
            ("transformer LM", lambda dt: TransformerLM(TransformerLMConfig(
                vocab_size=5000, dropout_rate=0.0, **LM_CONF), device="cuda", dtype=dt), False),
            ("seq_rnn LM", lambda dt: SequentialRNNLM(SequentialRNNLMConfig(vocab_size=5000),
                                                      device="cuda", dtype=dt), True)):
        models = {dt: ESPnetLanguageModel(build(dt), 5000).eval() for dt in (F32, BF16)}
        init_weights(models[F32], seed=0)
        models[BF16].load_state_dict(models[F32].state_dict())
        nll, ms = {}, {F32: [], BF16: []}
        with torch.inference_mode():
            for dt in (F32, BF16):
                models[dt].nll(text, lens)
            torch.cuda.synchronize()
            reset_counts(kernels)
            for r in range(TWIN_ROUNDS):
                for dt in ((F32, BF16) if r % 2 == 0 else (BF16, F32)):
                    t0 = time.perf_counter()
                    nll[dt], _ = models[dt].nll(text, lens)
                    torch.cuda.synchronize()
                    ms[dt].append((time.perf_counter() - t0) * 1e3)
        n = 2 * models[F32].lm.cfg.nlayers * TWIN_ROUNDS if lstm else 0
        by = check_dtype_launches(f"serve-bf16 {tag}", kernels,
                                  {"lstm_fwd": {F32: n}} if lstm else {})
        launches = add_counts(launches, counts(kernels))
        for name, d in by.items():
            for dt, c in d.items():
                by_dtype.setdefault(name, {})[dt] = by_dtype.get(name, {}).get(dt, 0) + c
        err = ((nll[BF16] - nll[F32]).abs() / nll[F32].abs().clamp(min=1.0)).max().item()
        print(f"[serve-bf16 {tag}] nll of [{TWIN_LM_B}, <= {TWIN_LM_LEN}] tokens, "
              f"{TWIN_ROUNDS} calls each: float32 median {float(np.median(ms[F32])):.2f} ms, "
              f"bfloat16 {float(np.median(ms[BF16])):.2f} ms; rows' NLL in bfloat16 within "
              f"{err:.2e} of float32's (tol {BF16_REL}) [{card}]")
        if err > BF16_REL:
            raise AssertionError(f"serve-bf16 {tag}: bfloat16 NLL {err} from float32's")
        del models
        torch.cuda.empty_cache()
    return launches, by_dtype


def train_bf16_twins(kernels, card) -> list:
    """The bfloat16 twins' training (train_bf16_case: the gradient check,
    then 1 warm-up and 3 timed steps a dtype): the RWKV transducer at
    TRD_B x 10 s (the encoder kernels in bfloat16 forward and backward, the
    WKV kernels in float32 as JAX runs them), the E-Branchformer and the
    MultiConvformer CTC/attention models at ENC_B x 10 s, each at
    TWIN_BLOCKS blocks of full width; then the SSL-frontend model
    (build_twin_ssl, SSL_B) and AV-HuBERT Base (TWIN_BLOCKS of its 12
    layers, AVH_B), as train-ssl and train-avhubert train them, and the ST
    model (ST_B; the encoder at TWIN_BLOCKS blocks, the LLM frozen; the
    translation and source losses).  Returns each case's bfloat16
    (launches, launches by dtype)."""
    from llm_guided_asr_tpu_torch.tasks.st import ST_BATCH_ARGS
    import dataclasses

    from llm_guided_asr_tpu_torch.convert import init_weights
    from llm_guided_asr_tpu_torch.models.transducer import TransducerModel

    enc = dict.fromkeys(ENCODER_FWD + ENCODER_BWD, TWIN_BLOCKS)
    cfg = build_transducer_config()
    cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(cfg.encoder,
                                                               num_blocks=TWIN_BLOCKS))
    out = []
    for tag, build, b, per_step, f32_rows in (
            ("transducer-rwkv", lambda: init_weights(TransducerModel(cfg, device="cuda"), seed=0),
             TRD_B, {**enc, "wkv_fwd": RWKV_LAYERS, "wkv_bwd": RWKV_LAYERS},
             ("wkv_fwd", "wkv_bwd")),
            ("e_branchformer", lambda: build_serve_asr(
                "e_branchformer", train=True, **{**EBF_ENCODER, "num_blocks": TWIN_BLOCKS}),
             ENC_B, enc, ()),
            ("multiconvformer", lambda: build_serve_asr(
                "multiconvformer", train=True,
                **{**NEW_ENCODERS["multiconvformer"], "num_blocks": TWIN_BLOCKS}), ENC_B,
             {**enc, "dwconv1d_fwd": (len(MCF_KERNELS) + 1) * TWIN_BLOCKS,
              "dwconv1d_bwd": (len(MCF_KERNELS) + 1) * TWIN_BLOCKS}, ()),
            ("ssl", lambda: build_twin_ssl(train=True), SSL_B, enc, ()),
            ("avhubert", lambda: build_serve_asr(
                "avhubert", train=True, **{**AVH_ENCODER, "num_blocks": TWIN_BLOCKS}), AVH_B,
             {}, ())):
        f32 = build().train()
        out.append(train_bf16_case(tag, f32, bf16_twin(f32), train_batch(b, seed=5), 1, 3, (),
                                   kernels, card, per_step=per_step, f32_rows=f32_rows))
        del f32
        torch.cuda.empty_cache()
    f32 = build_st(num_blocks=TWIN_BLOCKS).train()
    out.append(train_bf16_case("st", f32, bf16_twin(f32), st_batch(ST_B), 1, 3, (), kernels,
                               card, frozen=["llm"], per_step=enc, args=ST_BATCH_ARGS))
    del f32
    torch.cuda.empty_cache()
    return out


def run_one_phase(name: str, card: str) -> int:
    """``--phase``: build the kernels and run one phase that needs nothing of
    the others (train-1, train-run, train-transducer, golden, serve,
    serve-batch, serve-lm, serve-stream, asr-cli, serve-transducer-rnn,
    train-transducer-mb, serve-st, train-st, recipe-io, serve-ebf,
    train-ebf, serve-dec, train-dec, serve-enc, train-enc, serve-ssl,
    train-ssl, serve-hf, serve-mc, train-mc, serve-avhubert,
    train-avhubert, align-cli, which runs asr-cli first, serve-bf16 or
    train-bf16), or several named with commas in turn, and print their
    results;
    no kernel table.  With ``--package-root`` the port comes from another
    checkout (an older revision unpacked by ``git archive``) while this
    script's phase code stays the same, so two revisions run the same
    phase in turns on one card."""
    from llm_guided_asr_tpu_torch.ops import depthwise_conv as dc
    from llm_guided_asr_tpu_torch.ops import flash_attention as fa
    from llm_guided_asr_tpu_torch.ops import lstm as lk
    from llm_guided_asr_tpu_torch.ops import rel_attention as ra
    from llm_guided_asr_tpu_torch.ops import wkv as wk

    phases = {"train-1": lambda: phase_train1(kernels, card),
              "train-run": lambda: phase_train_run(kernels, card),
              "train-transducer": lambda: phase_train_transducer(build_transducer(), kernels, card),
              "serve-transducer-rnn": lambda: phase_serve_transducer_rnn(
                  build_transducer_lstm(), request_waves(), kernels, card),
              "train-transducer-mb": lambda: phase_train_transducer_mb(request_waves(), kernels,
                                                                       card),
              "golden": lambda: phase_golden(kernels, card),
              "serve": lambda: phase_serve(build_model(), kernels, card),
              "serve-batch": lambda: phase_serve_batch(build_model(), kernels, card),
              "serve-lm": lambda: phase_serve_lm(kernels, card),
              "serve-stream": lambda: phase_serve_stream(kernels, card),
              "asr-cli": lambda: phase_asr_cli(kernels, card),
              "serve-st": lambda: phase_serve_st(build_st(), kernels, card),
              "train-st": lambda: phase_train_st(build_st(), kernels, card),
              "recipe-io": lambda: phase_recipe_io(kernels, card),
              "serve-ebf": lambda: phase_serve_ebf(kernels, card),
              "train-ebf": lambda: phase_train_ebf(kernels, card),
              "serve-dec": lambda: phase_serve_dec(kernels, card),
              "train-dec": lambda: phase_train_dec(kernels, card),
              "serve-enc": lambda: phase_serve_enc(kernels, card),
              "train-enc": lambda: phase_train_enc(kernels, card),
              "serve-ssl": lambda: hf_phase("serve-ssl"),
              "train-ssl": lambda: hf_phase("train-ssl"),
              "serve-hf": lambda: hf_phase("serve-hf"),
              "serve-mc": lambda: phase_serve_mc(kernels, card),
              "train-mc": lambda: phase_train_mc(kernels, card),
              "serve-avhubert": lambda: phase_serve_avhubert(kernels, card),
              "train-avhubert": lambda: phase_train_avhubert(kernels, card),
              "align-cli": lambda: align_phase(),
              "serve-bf16": lambda: phase_serve_bf16(build_model(), kernels, card),
              "train-bf16": lambda: phase_train_bf16(build_model(), kernels, card)}

    def align_phase():
        with tempfile.TemporaryDirectory(prefix="asr-cli-") as tmp:
            phase_asr_cli(kernels, card, Path(tmp))
            return phase_align_cli(kernels, card, Path(tmp))

    def hf_phase(phase):
        with tempfile.TemporaryDirectory(prefix="chip_smoke_hf_") as tmp:
            root = Path(tmp)
            if phase == "serve-ssl":
                return phase_serve_ssl(kernels, card, root)
            hubert = write_w2v_dir(root / "hubert-base", "hubert", seed=1)
            fn = phase_train_ssl if phase == "train-ssl" else phase_serve_hf
            return fn(kernels, card, root, hubert)

    names = name.split(",")
    unknown = [n for n in names if n not in phases]
    if unknown:
        raise SystemExit(f"chip_smoke: no standalone phase {unknown}; one of {sorted(phases)}")
    kernels = [ra.KERNEL, dc.KERNEL, wk.KERNEL, fa.KERNEL, lk.KERNEL]
    phase_build(kernels)
    package = Path(ra.__file__).resolve().parents[2]
    for n in names:
        t0 = time.perf_counter()
        phases[n]()
        torch.cuda.empty_cache()
        print(f"[{n}] phase alone took {time.perf_counter() - t0:.1f} s with the port from "
              f"{package} [{card}]")
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description="Smoke run of the PyTorch/CUDA port on one card.")
    ap.add_argument("--phase", help="run only this phase: train-1, train-run, train-transducer, "
                                    "golden, serve, serve-batch, serve-lm, serve-stream, "
                                    "asr-cli, serve-transducer-rnn, train-transducer-mb, "
                                    "serve-st, train-st, recipe-io, serve-ebf, train-ebf, "
                                    "serve-dec, train-dec, serve-enc, train-enc, serve-ssl, "
                                    "train-ssl, serve-hf, serve-mc, train-mc, serve-avhubert, "
                                    "train-avhubert, align-cli, serve-bf16 or train-bf16; "
                                    "several, comma-separated, run in turn")
    ap.add_argument("--package-root", type=Path,
                    help="with --phase: import the port from this checkout instead")
    args = ap.parse_args()
    if args.package_root is not None:
        sys.path.insert(0, str(args.package_root.resolve()))
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available; nothing was run", file=sys.stderr)
        return 2
    if args.phase is not None:
        from llm_guided_asr_tpu_torch.utils.device import resolve_device

        resolve_device("cuda")
        return run_one_phase(args.phase, nvidia_smi_name_power())
    from llm_guided_asr_tpu_torch.ops import depthwise_conv as dc
    from llm_guided_asr_tpu_torch.ops import flash_attention as fa
    from llm_guided_asr_tpu_torch.ops import lstm as lk
    from llm_guided_asr_tpu_torch.ops import rel_attention as ra
    from llm_guided_asr_tpu_torch.ops import wkv as wk
    from llm_guided_asr_tpu_torch.utils.device import resolve_device

    resolve_device("cuda")  # the card's float32 policy, before the first kernel check
    card = nvidia_smi_name_power()
    print(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}; {card}")
    t_start = time.perf_counter()
    kernels = [ra.KERNEL, dc.KERNEL, wk.KERNEL, fa.KERNEL, lk.KERNEL]
    phases = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        phases[name] = time.perf_counter() - t0
        print(f"[{name}] phase took {phases[name]:.1f} s [{card}]")
        return out

    timed("build", phase_build, kernels)
    timings = timed("kernels", phase_kernels, ra, dc, wk, fa, lk, card)
    model = build_model()
    paths = {}
    paths["serve"], waves, wall_10s = timed("serve", phase_serve, model, kernels, card)
    timed("profile", phase_profile, model, waves[0], wall_10s, card)
    paths["serve-batch"] = timed("serve-batch", phase_serve_batch, model, kernels, card)
    paths["train-1"], _ = timed("train-1", phase_train1, kernels, card)
    paths["train-2"], _ = timed("train-2", phase_train2, model, kernels, card)
    paths["train-run"] = timed("train-run", phase_train_run, kernels, card, model)
    bf16_paths = {}  # {phase: {entry point: {dtype: launches}}}
    paths["serve-bf16"], bf16_paths["serve-bf16"] = timed("serve-bf16", phase_serve_bf16, model,
                                                          kernels, card)
    paths["train-bf16"], bf16_paths["train-bf16"] = timed("train-bf16", phase_train_bf16, model,
                                                          kernels, card)
    del model
    torch.cuda.empty_cache()
    transducer = build_transducer()
    paths["serve-transducer"] = timed("serve-transducer", phase_serve_transducer, transducer,
                                      waves, kernels, card)
    paths["train-transducer"], _ = timed("train-transducer", phase_train_transducer, transducer,
                                         kernels, card)
    del transducer
    torch.cuda.empty_cache()
    lstm = build_transducer_lstm()
    paths["serve-transducer-rnn"] = timed("serve-transducer-rnn", phase_serve_transducer_rnn,
                                          lstm, waves, kernels, card)
    del lstm
    torch.cuda.empty_cache()
    paths["train-transducer-mb"] = timed("train-transducer-mb", phase_train_transducer_mb, waves,
                                         kernels, card)
    flash_asr = build_flash_asr()
    paths["serve-flash"], flash_waves, wall_60s = timed(
        "serve-flash", phase_serve, flash_asr, kernels, card, "serve-flash", FLASH_SECONDS,
        FLASH_FWD)
    timed("profile-flash", phase_profile, flash_asr, flash_waves[0], wall_60s, card,
          "profile-flash", FLASH_SECONDS[0])
    paths["train-flash"], _ = timed("train-flash", phase_train_flash, flash_asr, kernels, card)
    del flash_asr
    torch.cuda.empty_cache()
    paths["golden"] = timed("golden", phase_golden, kernels, card)
    paths["serve-lm"] = timed("serve-lm", phase_serve_lm, kernels, card)
    torch.cuda.empty_cache()
    paths["serve-stream"] = timed("serve-stream", phase_serve_stream, kernels, card)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="asr-cli-") as tmp:  # phase 35 reads phase 16's files
        paths["asr-cli"] = timed("asr-cli", phase_asr_cli, kernels, card, Path(tmp))
        paths["align-cli"] = timed("align-cli", phase_align_cli, kernels, card, Path(tmp))
    torch.cuda.empty_cache()
    st = build_st()
    paths["serve-st"] = timed("serve-st", phase_serve_st, st, kernels, card)
    paths["train-st"], _ = timed("train-st", phase_train_st, st, kernels, card)
    del st
    torch.cuda.empty_cache()
    paths["recipe-io"] = timed("recipe-io", phase_recipe_io, kernels, card)
    torch.cuda.empty_cache()
    paths["serve-ebf"] = timed("serve-ebf", phase_serve_ebf, kernels, card)
    paths["train-ebf"], _ = timed("train-ebf", phase_train_ebf, kernels, card)
    torch.cuda.empty_cache()
    for name, fn in (("serve-dec", phase_serve_dec), ("train-dec", phase_train_dec),
                     ("serve-enc", phase_serve_enc), ("train-enc", phase_train_enc)):
        paths[name] = timed(name, fn, kernels, card)
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_hf_") as tmp:  # the HF directories
        root = Path(tmp)
        paths["serve-ssl"], hubert = timed("serve-ssl", phase_serve_ssl, kernels, card, root)
        torch.cuda.empty_cache()
        paths["train-ssl"], _ = timed("train-ssl", phase_train_ssl, kernels, card, root, hubert)
        torch.cuda.empty_cache()
        paths["serve-hf"] = timed("serve-hf", phase_serve_hf, kernels, card, root, hubert)
    torch.cuda.empty_cache()
    for name, fn in (("serve-mc", phase_serve_mc), ("train-mc", phase_train_mc),
                     ("serve-avhubert", phase_serve_avhubert),
                     ("train-avhubert", phase_train_avhubert)):
        paths[name] = timed(name, fn, kernels, card)
        torch.cuda.empty_cache()
    print(f"[done] {time.perf_counter() - t_start:.1f} s; phases "
          + ", ".join(f"{k} {v:.1f} s" for k, v in phases.items()) + f" [{card}]")

    f32 = torch.float32
    table = []
    # (entry point, timed shape, serving shape or None, kernel, TPU kernel, path of "launches")
    for name, shape, serve_shape, kernel, replaces, path in (
        ("rel_attention_fwd", "train B=64 T=312 dropout 0.1", "serve B=1 T=312", ra.KERNEL,
         "llm_guided_asr_tpu/ops/rel_attention.py:143", "train-1"),
        ("rel_attention_bwd", "train B=64 T=312 dropout 0.1", None, ra.KERNEL,
         "llm_guided_asr_tpu/ops/rel_attention.py:200", "train-1"),
        ("dwconv1d_fwd", "train [64,312,256] K=31", "serve [1,312,256] K=31", dc.KERNEL,
         "llm_guided_asr_tpu/ops/depthwise_conv.py:37", "train-1"),
        ("dwconv1d_bwd", "train [64,312,256] K=31", None, dc.KERNEL,
         "llm_guided_asr_tpu/ops/depthwise_conv.py:48", "train-1"),
        ("wkv_fwd", "train [16,25,512]", "serve beam-5 [5,201,512]", wk.KERNEL,
         "llm_guided_asr_tpu/ops/wkv.py:79", "serve-transducer"),
        ("wkv_bwd", "train [16,25,512]", None, wk.KERNEL,
         "llm_guided_asr_tpu/ops/wkv.py:179", "train-transducer"),
        ("lstm_fwd", "train [16,25,256]", "serve beam-5 [5,201,256]", lk.KERNEL,
         LSTM_SCAN + " (a lax.scan; no Pallas kernel)", "serve-transducer-rnn"),
        ("lstm_bwd", "train [16,25,256]", None, lk.KERNEL,
         LSTM_SCAN + " (the scan's VJP; no Pallas kernel)", "train-transducer-mb"),
        ("flash_attention_fwd", f"train [{FLASH_B},4,{FLASH_T},64]", f"serve [1,4,{FLASH_T},64]",
         fa.KERNEL, FLASH_LIBRARY + ":331 (_flash_attention_kernel), called at "
         "llm_guided_asr_tpu/models/transformer.py:490", "train-flash"),
        ("flash_attention_bwd_dkv", f"train [{FLASH_B},4,{FLASH_T},64]", None, fa.KERNEL,
         FLASH_LIBRARY + ":796 (_flash_attention_dkv_kernel)", "train-flash"),
        ("flash_attention_bwd_dq", f"train [{FLASH_B},4,{FLASH_T},64]", None, fa.KERNEL,
         FLASH_LIBRARY + ":1146 (_flash_attention_dq_kernel)", "train-flash"),
    ):
        r = timings[(name, shape, f32)]
        row = {
            "name": name, "route": "cuda",
            "source": str(kernel.source.relative_to(kernel.source.parents[2])),
            "replaces": replaces, "launches": paths[path][name],
            "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": shape, "launches_path": path,
            "launches_by_path": {p_: c[name] for p_, c in paths.items()},
        }
        if serve_shape is not None:
            s = timings[(name, serve_shape, f32)]
            row.update(serve_ms=s["ms"], serve_plain_ms=s["plain_ms"],
                       serve_bound_ms=s["bound_ms"], serve_library_ms=s["library_ms"])
        # the bfloat16 operands of phases 36-37 (bounds at the bf16 rate)
        for key, bf_shape in (("bf16", shape), ("bf16_serve", serve_shape)):
            s = timings.get((name, bf_shape, torch.bfloat16))
            if s is not None:
                row.update({f"{key}_ms": s["ms"], f"{key}_plain_ms": s["plain_ms"],
                            f"{key}_bound_ms": s["bound_ms"], f"{key}_bound_by": s["bound_by"],
                            f"{key}_library_ms": s["library_ms"],
                            f"{key}_max_abs_err": s["err"]})
        if any(name in by for by in bf16_paths.values()):
            row["bf16_launches_by_path"] = {
                p_: by.get(name, {}).get(str(torch.bfloat16), 0) for p_, by in bf16_paths.items()}
            # every launch of phases 36-37 (float32 and bfloat16 twins) by
            # operand dtype: rows 5 and 7 stay float32 in the bfloat16 models
            row["bf16_phase_launches_by_dtype"] = {p_: by.get(name, {})
                                                   for p_, by in bf16_paths.items()}
        if name == "wkv_bwd":  # chunked: the labels of ~40 s of audio
            s = timings[(name, f"[{','.join(map(str, WKV_BWD_LONG))}]", f32)]
            row.update(chunks=timings[(name, shape, f32)]["chunks"], long_shape=list(WKV_BWD_LONG),
                       long_ms=s["ms"], long_chunks=s["chunks"], long_plain_ms=s["plain_ms"],
                       long_bound_ms=s["bound_ms"])
        if name == "rel_attention_fwd":  # the long-form yardstick beside the flash forward
            s = timings[(name, f"serve B=1 T={FLASH_T}", f32)]
            row.update(longform_ms=s["ms"], longform_plain_ms=s["plain_ms"],
                       longform_bound_ms=s["bound_ms"])
        if name == "dwconv1d_fwd":  # phase 14's streaming block, one launch a block a layer
            s = timings[(name, STREAM_DW_SHAPE, f32)]
            row.update(stream_shape=STREAM_DW_SHAPE, stream_ms=s["ms"],
                       stream_plain_ms=s["plain_ms"], stream_bound_ms=s["bound_ms"],
                       stream_library_ms=s["library_ms"], stream_max_abs_err=s["err"])
        if name in ("dwconv1d_fwd", "dwconv1d_bwd"):  # the E-Branchformer cgMLP's 512 channels
            shapes = {"train": CGMLP_TRAIN_SHAPE}
            if name == "dwconv1d_fwd":
                shapes["serve"] = CGMLP_SERVE
            for key, cg_shape in shapes.items():
                s = timings[(name, cg_shape, f32)]
                row.update({f"cgmlp_{key}_shape": cg_shape, f"cgmlp_{key}_ms": s["ms"],
                            f"cgmlp_{key}_plain_ms": s["plain_ms"],
                            f"cgmlp_{key}_bound_ms": s["bound_ms"],
                            f"cgmlp_{key}_library_ms": s["library_ms"],
                            f"cgmlp_{key}_max_abs_err": s["err"]})
        # the shapes of phases 26-27 (the MultiConvformer's depthwise convs,
        # the RNN encoders' LSTM recurrence) and 28-29 (the Conformer over
        # the SSL frontend's 50 Hz features)
        more = [key[1] for key in timings if key[0] == name and key[2] == f32
                and (key[1] in MCF_SHAPES or key[1] in LSTM_ENC_SHAPES or key[1] in SSL_SHAPES)]
        if more:
            row["more_shapes"] = [
                {"shape": m, **{k: timings[(name, m, f32)].get(k) for k in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "err",
                    "launches_per_call")}} for m in more]
        if name in ENCODER_FWD:  # phase 12's batched serving shape
            s = timings[(name, "serve-batch", f32)]
            row.update(batch_shape=f"B={len(BATCH_LENS)} T={BATCH_T} lanes {list(BATCH_LENS)}",
                       batch_ms=s["ms"], batch_plain_ms=s["plain_ms"], batch_bound_ms=s["bound_ms"],
                       batch_library_ms=s["library_ms"], batch_max_abs_err=s["err"],
                       batch_launches_per_batch=paths["serve-batch"][name] // BATCH_ROUNDS)
        table.append(row)
    print(card)
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
