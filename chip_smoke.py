#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (plip_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with an H100 (sm_90a), the
CUDA toolkit and PyTorch built for CUDA:

    python3 chip_smoke.py

1. Set-up: builds the port's CUDA kernels from plip_tpu_torch/csrc/ with
   nvcc and prints the card's name and power limit, and the HGMMA (wgmma)
   instructions in the SASS of each instantiation of the attention cores'
   kernels (csrc/mha.cu's mha_kernel, csrc/mha_bwd.cu's core_bwd_rows and
   core_bwd_keys, csrc/attention_sublayer.cu's attn_core_wgmma_kernel,
   csrc/attention_sublayer_bwd.cu's attn_core_bwd_wgmma_kernel), of
   grad_gemm's (csrc/attention_sublayer_bwd.cu's grad_gemm_wgmma_kernel) and
   of the epilogue GEMMs' (csrc/gemm.cuh's epilogue_gemm_wgmma_kernel): it
   fails unless every bf16 one has some (cuobjdump runs beside the phases;
   its output is checked after step 24).
2. Kernel phase: each CUDA kernel of the attention sublayer, and the whole
   sublayer, against its plain PyTorch version on the card, at the serving
   path's shapes (vision B=32 S=50 W=768 12 heads; text B=32 and B=8, S=77
   W=512 8 heads causal; text with s_valid < S). fp32: allclose atol 1e-4,
   rtol 1e-4, with TF32 off for every fp32 product. bf16: per-row cosine
   >= 0.999 and allclose atol 3e-2, rtol 1e-2 (one bf16 rounding step is
   2^-8 of the value). An attention core (attn_core, mha_core, flash_core)
   rounds P where its plain version does, so in bf16 it is held tighter:
   every element within one bf16 ulp of the largest |value| of its row, and
   at most CORE_DIFFER of the elements not bit-equal. Times with CUDA
   events, plain and kernel in turns.
3. Serving phase: PLIP("random:ViT-B/32", bf16) at full width (12 layers
   in both towers) encodes 64 synthetic 256x256 images in batches of 32 and
   8 prompts, classifies zero-shot and retrieves top-5. The vision tower's
   core must have launched once per layer and batch of the encode, and every
   K1 kernel in the run; the embeddings must match the same model run
   through the plain versions (row cosine >= 0.999). The same weights in
   fp32 must match their plain run to cosine >= 0.9999 with the same
   zero-shot argmax on every image (in bf16 the two paths' scores differ by
   more than the gap between a random model's top two labels on some
   images, so there the count of differing labels is printed). The rates
   are python -m plip_tpu_torch.profile_serve's.
4. Training phase (K2, the sublayer backward):
   a. each CUDA kernel of the sublayer backward, and the whole backward,
      against its plain version at the vision and text shapes above (B=32)
      and at the tuner's batch of 128 in both towers, with the bars of step
      2, times in turns; for a grad that sums the B*S token rows (weights,
      biases, LN) atol is scaled by its RMS, and both are printed;
   b. one full-width ViT-B/32 train step's loss and grads at batch 32, the
      kernel path against the plain sublayer (autograd through it): fp32
      loss within 1e-5 relative and every leaf's cosine >= 0.9999, bf16
      every leaf's cosine >= 0.995 (the worst leaf is printed);
   c. CLIPTuner(dtype=bf16, device="cuda").tuner(...) for one epoch of 6
      steps at batch 128 (remat "mlp") on synthetic 256x256 images: every
      loss finite, every K1 and K2 kernel launched by this run, the epoch
      checkpoint reloads;
   d. 8 steps of make_train_step on one fixed batch lower its loss. The
      step's pairs/s and peak memory are python -m
      plip_tpu_torch.profile_train's.
5. Wide kernel phase (K3, K5 and K1's widened core): mha_core at ViT-L/14
   vision (B=64, S=257, W=1024, 16 heads) and causal with s_valid=250;
   flash_core at ViT-L/14@336px vision (B=32, S=577, W=1024, 16 heads);
   attn_core at ViT-B/16 vision (B=32, S=197, W=768, 12 heads). Each in fp32
   and bf16 against its plain version, with the bars of step 2, times in
   turns. Controls of the bf16 bar: the kernel's output held against its
   plain version with a deliberate fault in the softmax's rounding schedule
   (normalize-first where the divide is deferred; the row sum taken of the
   cast P) must fail it. Every bf16 case prints its kernel, plain and
   PyTorch (SDPA) ms, the TFLOP/s it reaches and its share of the bound.
6. Wide serving phase: step 3 at full width and depth for
   PLIP("random:ViT-L/14@336px", bf16) with images in batches of 32 (the
   vision core flash_core), "random:ViT-L/14" in batches of 64 (mha_core)
   and "random:ViT-B/16" in batches of 32 (attn_core at S=197); fp32 for the
   two L/14 towers only.
7. Wide backward kernels: mha_core_bwd (K4) at ViT-L/14 vision (B=64,
   S=257, W=1024, 16 heads) and causal with s_valid=250; attn_core_bwd (K2's
   core, key-tiled past 128 tokens) at ViT-B/16 (B=32, S=197), ViT-L/14
   (B=64, S=257) and ViT-L/14@336px (B=32, S=577); attn_core (K1's core,
   key-tiled past 128 tokens in bf16, 256 in fp32) at @336; mha_core_bwd at
   the ViT-B/32 remat "block" step's shapes (vision B=128, S=50; text
   B=128, S=77, causal). Each in
   fp32 and bf16 against its plain version with the bars of step 2 and, in
   bf16, the cores' bar on every output (ctx within 1 ulp of its row max;
   dqkv within BWD_ULPS, at most CORE_DIFFER differing); times in turns,
   TFLOP/s beside the bound. Controls:
   each backward against the plain version in the other schedule (K4 in
   K2's deferred form, K2's core normalize-first), attn_core against the
   schedule faults of step 5; each must fail the bar. Every bf16 case prints
   the line of step 5 (PyTorch: SDPA's autograd backward, or its forward for
   attn_core).
8. Wide train steps at full depth, batch 8, fp32 and bf16: ViT-B/16 remat
   "mlp"; ViT-L/14 "mlp" (the hybrid) and False (K4); ViT-L/14@336px "mlp"
   (K1 and K2 at S=577) and False (K5; its backward is the VJP of the JAX
   package's _jnp_mha, which launches no kernel of ours). The loss and every
   grad leaf against the same autograd functions with every wrapper on its
   plain version, with the bars of step 4b; each step's launch counts must
   show the kernels of its path. Then one make_train_step step of each
   architecture under remat False, "mlp" and True (bf16, batch 8): finite
   losses.
9. CLIPTuner(model_type="ViT-L/14", bf16, cuda) for one epoch of 4 steps at
   batch 64 ("auto" remat: "mlp", so the hybrid): losses finite, the
   checkpoint reloads, the run launches mha_core, every K2 kernel and K1's
   kernels (the text tower).
10. (The wide train rates: python -m plip_tpu_torch.profile_train --arch
   ViT-L/14 --batch 64, and --arch ViT-L/14@336px --batch 32.)
11. remat="block" (K7, and the MLP half's K8 and K9):
   a. block_bwd (K7), mlp_bwd_flat (K8), mlp_fwd_flat (K9) and their two new
      GEMMs (gemm_bias_gelu, gemm_nt_gelu_bwd) against their plain versions
      at ViT-B/32 vision (B=128, S=50), text (B=128, S=77, causal) and
      ViT-B/16 vision (B=32, S=197), fp32 and bf16: every output with the
      bars of step 4a, K7's and K8's dx also with atol scaled by its RMS (in
      bf16 a cast flipped anywhere in the chain propagates: a third of K7's
      dx differs from the plain version by 1-2 ulps), and the rounding
      points of the chain (h1 and the activation, dh1, the core backward),
      recorded on the kernel path's inputs, with the cores' bars (the
      activation within ACT_ULPS); controls (a plain version with K2's
      deferred core backward, or with the composed forward's bf16
      QuickGELU) must fail them. bf16 times in turns beside the bound and a
      PyTorch yardstick (the autograd backward, or forward, of the same
      block built from F.layer_norm, F.linear and SDPA);
   b. full-depth train steps under remat "block": ViT-B/32 at batch 32 in
      fp32 and bf16 and ViT-B/16 at batch 8 in bf16 against the plain
      versions (the bars of step 4b), each launching K7 once a layer (24);
      a ViT-B/32 "mlp" step launches it never; ViT-L/14 at batch 8 bf16
      launches no K7 but mha_core and mha_core_bwd (the fallback); one
      make_train_step step under "block" and "mlp_h1";
   c. K8's and K9's own entry points (mlp_sublayer_flat forward and
      backward, mlp_fwd_flat) over the 12 ViT-B/32 vision layers, batch 128;
   d. at ViT-B/32 batch 128 bf16 under "mlp", "block" and "mlp_h1", the
      memory the forward keeps for the backward and the peak of the forward
      and backward ("block" must keep less than "mlp"); their pairs/s are
      profile_train's (--remat);
   e. a 3-step CLIPTuner(remat="block") epoch at ViT-B/32 batch 128.
12. The last four TPU kernels:
   a. K12: headgrid_core at ViT-L/14 vision (B=64, S=257, 16 heads), causal
      or not, fp32 and bf16, against its plain version with the cores' bars;
      control: K3's deferred core fails the bf16 bar. The jnp_mha core
      (forward K12) at ViT-L/14@336px (B=32, S=577); headgrid_core timed at
      both shapes in bf16 (the JSON line: @336's). One full-depth @336
      "block" step at batch 8 bf16 against the plain path (the bars of step
      4b): its vision fallback launches headgrid_core 48 times (24 layers,
      forward and recompute) and flash_core never;
   b. K10: block_fwd against its plain version at ViT-B/32 vision (B=256,
      S=50) and text (B=256, S=77, causal), fp32 and bf16, at every rounding
      point of the chain (qkv, ctx, a, the activation within ACT_ULPS, out)
      with the cores' bars; control: K7-K9's activation of the cast h1
      fails it. A 12-layer ViT-B/32 vision stack of transformer_block in
      PLIP("random:ViT-B/32", bf16) against the tower as it serves, 256
      tiles: pooled row cosine >= 0.999, 12 launches of block_fwd and of
      its fp32-h1 GEMM;
   c. K6: attention_sublayer_bwd_split against its plain version at ViT-B/32
      vision and text B=128 (qkv recomputed or saved); a full-depth ViT-B/32 step at
      batch 32 under each BWD_MODE, fp32 and bf16, the split modes against
      "fused" (the bars of step 4b), the split backward called 24 times and
      K2 never, and none of K12, K10 or K11 launched by these steps;
   d. K11: preprocess_batch(fused=True) against the two-matmul path on 256
      random tiles (256x256 -> 224, 300x400 -> 224, 256x256 -> 336,
      1024x700 -> 224): at most one uint8 level apart on at most 1e-3 of the
      elements, atol 1e-4 without the uint8 stores, bf16 out bit-equal to
      fp32 out cast, 16 float tiles in [-40, 300] within a level (on 1e-3 of
      the elements) of the plain path on their truncation to uint8;
      each timed in CUDA-event and device ms beside the plain path and its
      share of the bytes bound, the first also with bf16 out; the
      fused-preprocessed tiles through ViT-B/32 bf16 against the default
      path: row cosine >= 0.999.
13. K1's one-block core and K2's grad_gemm on wgmma:
   a. attn_core in bf16 at ViT-B/32 vision (B=32, S=50), text (B=32, S=77,
      causal, and s_valid=70) and ViT-B/16 vision (B=32, S=197) against its
      plain version with the cores' bars, past 128 tokens also the schedule
      faults' controls; timed in turns beside the plain version, SDPA and
      the key-tiled route (plip_attn_core_tiled called directly: a
      yardstick at S <= 128, where attn_core takes the one-block core; the
      kernel attn_core itself launches at S=197); "held" or "missed"
      against the bar SHORT_CORE_BAR_MS at B/16 and against that route;
   b. grad_gemm's four bf16 products (NT dctx and dln, TN dWout and dWqkv)
      at the ViT-B/32 vision (B=32) and ViT-L/14 vision (B=64) shapes
      against their plain versions with the bars of step 4a, timed in turns
      beside torch.matmul of the same operands (a yardstick the port never
      calls), "held" or "missed" within GRAD_GEMM_MATMUL_FACTOR of it.
14. The epilogue GEMMs of csrc/gemm.cuh on wgmma: gemm_bias_gelu,
   gemm_bias_gelu_f32, gemm_nt_gelu_bwd and gemm_bias_residual (fc2 with R)
   at the ViT-B/32 batch-128 MLP shapes (M=6400, W=768), the ViT-L/14
   batch-64 products (M=16448: qkv, the out-projection with R, fc1 and its
   NT backward at W=1024) and the ViT-L/14@336px batch-32 qkv (M=18464),
   bf16, against their plain versions (h1, dh1 and K10's activation within
   one ulp of the row max, the activation of the cast h1 within ACT_ULPS,
   at most CORE_DIFFER differing; the residual GEMM at step 2's bars), timed
   in turns beside torch.addmm / torch.matmul of the same bf16 operands (a
   yardstick the port never calls): TFLOP/s, share of the bound, device ms
   under torch.profiler, "held" or "missed" within EPILOGUE_LIBRARY_FACTOR
   of the library call.
15. K2's col_sum and its one-block core backward, redesigned:
   a. col_sum at the calls of the three training steps of PERF.md section 5
      (COL_SUM_CASES: ViT-B/32 dbqkv at batch 32, db1 and dbout at batch 128;
      ViT-L/14 batch 64 dbqkv, dbout, the LN partials and a stack of two TN
      slices; the text tower's dbqkv at batch 128), each in fp32 and bf16,
      against its plain version with the fp32 bars of a summed leaf, a rerun
      bit-equal, timed in turns beside t.sum(0, dtype=torch.float32) (a
      yardstick the port never calls) in CUDA-event ms (COL_SUM_ITERS calls:
      a small call's time is its host's) and device ms: the share of the
      bytes bound, "within torch.sum: held" or "missed" in each, and at
      ViT-B/32 db1 and ViT-L/14 dbqkv in bf16 "held" or "missed" against
      COL_SUM_BOUND_SHARE of the bound;
   b. attn_core_bwd in bf16 at ViT-B/32 vision (B=32 and 128, S=50), text
      (B=32 and 128, S=77, causal, and s_valid=70 at B=32) and ViT-L/14's
      text tower (B=64, S=77, W=768): the one-block wgmma kernel against its
      plain version (ctx within 1 ulp, dqkv within BWD_ULPS, at most
      CORE_DIFFER differing), the key-tiled route (plip_attn_core_bwd_tiled
      called directly, a yardstick at S <= 128) against it too, the plain
      version normalize-first as the control that must fail; timed in turns
      beside the plain version, the key-tiled route, SDPA's backward and
      the CUDA-core kernel it replaced (OLD_CORE_BWD_MS, at a shape where
      that was measured), in CUDA-event ms and device ms: "held" or
      "missed" for no slower than the key-tiled route.
16. fp32, the dtype PLIP and CLIPTuner take by default, on the redesigned
   kernels (csrc/simt_gemm.cuh's GEMM, the one-block CUDA-core core), and
   bf16 at head_dim != 64:
   a. gemm_bias_residual (qkv, out-projection + R) at ViT-B/32 vision W=768
      M=1,600 and 12,800 and text W=512 M=616 and 19,712, attn_core at
      vision B=32 and 256, text B=32 (causal, and s_valid=70) and ViT-B/16
      S=197, fp32, against their plain versions (step 2's fp32 bars), timed
      in turns (plip_tpu_torch/profile_kernels.py) beside the parent's
      kernel (PARENT_FP32_MS), torch.addmm or SDPA with TF32 off, and the
      bound (fp32 FLOPs at 67 TFLOP/s or bytes at 3.35 TB/s); the aims
      printed held or missed. attn_core and attn_core_bwd in bf16 at head
      dims 32 and 16 (vision S=50, text S=77 causal, s_valid=70) against
      their plain versions with the cores' bars, beside SDPA; attn_core
      where v goes over k (head_dim 96 at S=193, 128 at S=256), fp32 and
      bf16, against its plain version;
   b. PLIP("random:ViT-B/32") in fp32 at full depth: one encode of each
      tower launches every K1 kernel (counts reset just before), the
      embeddings match the plain run (row cosine >= 0.9999, the same
      zero-shot argmax);
   c. CLIPConfig.tiny (head_dim 16 and 8) in bf16: an encode of each tower
      and the grads of one step against the plain path (row cosine >=
      0.999, leaf cosine >= 0.995), one make_train_step step; both launch
      attn_core and attn_core_bwd.
17. The key-tiled cores at every head_dim up to 128, and K2's fp32 kernels
   redesigned (grad_gemm on csrc/simt_gemm.cuh, the register-tiled
   one-block core backward):
   a. attn_core (both schedules), attn_core_bwd, mha_core, mha_core_bwd,
      flash_core and headgrid_core at head_dim 80 and 104 past 128 tokens
      (ViT-H/14's and ViT-bigG/14's vision towers, WIDE_HEAD_CASES), fp32
      and bf16, against their plain versions with step 2's bars and, in
      bf16, the cores' bars; each launched once; K7 (block_bwd) where S <=
      512, every leaf at the summed bars; mha_core and its backward timed in
      turns beside SDPA at head_dim 80;
   b. grad_gemm's four products at ViT-B/32 vision batch 128 and
      attn_core_bwd at vision B=32 and 128 and text B=128 (causal), fp32,
      against their plain versions, timed in turns by profile_kernels
      beside the parent's kernel (PARENT_FP32_BWD_MS), torch.matmul or
      SDPA's backward with TF32 off, and the bound; the aims (each product
      within 1.25x torch.matmul and no slower than the parent's; the core
      backward at or under SDPA's backward in device ms and 2x the
      parent's) printed held or missed;
   c. one full-depth fp32 ViT-B/32 step at batch 128, remat "mlp"
      (CLIPTuner's defaults): the loss within 1e-5 relative of the plain
      path and every grad leaf's cosine >= 0.9999, every K2 kernel
      launched; then one make_train_step step, whose launches go into the
      JSON line.
18. The key-tiled cores off wgmma redesigned (csrc/tf32_attn.cuh: fp32 as
   three TF32 tensor-core products, bf16 at head_dim != 64 as one; the
   logits of a query tile computed once into shared memory), and heads
   wider than 128:
   a. every case of profile_kernels' TILED_CASES (mha_core, attn_core,
      flash_core, headgrid_core, mha_core_bwd and attn_core_bwd in fp32 at
      ViT-L/14 B=64, @336 B=32 and B/16 B=32, and at ViT-H/14's and
      ViT-bigG/14's head_dims 80 and 104 in fp32 and bf16) against its
      plain version (step 2's bars; bf16 the cores' bars); the JSON line's
      cases (TILED_JSON_CASES) timed in turns beside the parent's kernel
      (PARENT_TILED_MS), SDPA and the bound (fp32 at 67 TFLOP/s), the aims
      printed held or missed (every case: profile_kernels --tiled); every core at
      head_dim 160, fp32 and bf16, against its plain version, each launched
      once;
   b. PLIP("random:ViT-L/14") in fp32 at full depth: one encode launches
      mha_core once a layer, the embeddings match the plain run (row cosine
      >= 0.9999, the same zero-shot argmax);
   c. one full-depth fp32 ViT-L/14 step at batch 64, remat "mlp", and one
      under remat=False cut to two layers (its core backward K4) against the
      plain path: loss within 1e-5 relative, every leaf's cosine >= 0.9999;
   d. a head_dim-160 tower's encode and step, fp32 and bf16, against the
      plain path.
19. The LayerNorm kernels redesigned (csrc/layer_norm.cuh: a row in one
   warp's registers, 16-byte loads, shuffle sums; ln_bwd_rows' partial on
   the plan of ops.attention_bwd.ln_bwd_split), and every LayerNorm of the
   towers on them (ops.attention.layer_norm_rows: ln_pre, ln_post,
   ln_final, LN2, the composed sublayers' LN1); the plain paths above patch
   it to its plain version too:
   a. ln_rows, ln_bwd_rows (dln fp32 with the residual, and dln in the
      compute dtype without it) and layer_norm_rows' forward and grads
      against their plain versions at profile_kernels' LN_SHAPES (ViT-B/32
      vision batch 32 and 128, text batch 128), bf16 and fp32 (fp32 allclose
      1e-5, bf16 within one ulp of the row's largest value, dgamma and
      dbeta at a summed leaf's bars), reruns bit-equal; the two kernels at
      LN_JSON_CASE timed in device and CUDA-event ms beside the plain
      version, F.layer_norm's forward or backward and the bytes bound, the
      aims (half the bound, no slower than F.layer_norm) printed held or
      missed (every shape: profile_kernels --ln);
   b. the full-depth ViT-B/32 "mlp" step at batch 128, bf16 and fp32,
      against the plain path (no LayerNorm kernel launched there): ln_rows
      8L + 3 and ln_bwd_rows 4L + 3 launches;
   c. PLIP("random:ViT-B/32") bf16 encoding 256 tiles in batches of 32: ln_rows
      2L + 2 times a batch, the embeddings against the plain path.
20. Torch state_dicts and device retrieval (no new kernel):
   a. PLIP("random:ViT-B/32") in fp32 saved with save(format="openai") and
      save(format="hf"); PLIP(path) of each: the state_dict bit-equal to the
      original's, 64 synthetic tiles and 8 prompts encoded to the original's
      embeddings bit-equal (the worst difference printed) through K1's
      kernels (their launches printed); CLIPTuner(backbone=<the .pt>) loads
      the same parameters; a bf16 copy of the OpenAI dict loads as its fp32
      values; scripts.import_checkpoint --skip-verify on the .pt, then
      scripts.export_checkpoint back: the dict bit-equal to the first;
   b. ops.retrieval on a seed-0 corpus of 1,048,576 x 512 fp32 on the card
      (2 GiB; int8 512 MiB plus 4 MiB of scales), 64 queries, k=10:
      cosine_topk gives the host's exact top-k (argpartition and a stable
      sort; scores within 1e-5 relative) and cosine_topk_int8 with the
      rescore the same indices; the margin crusher of
      tests/test_retrieval_adversarial.py trips the int8 probe (two streams,
      then the exact fp32 fallback) and still returns the exact top-k;
      host-clock ms of the device fp32 and int8 calls at 262,144 and
      1,048,576 rows, and of the host backend at 262,144; retrieval()'s host
      and device ms at 16,384 and 262,144 rows (the auto gate), and
      backend="auto" takes the device at 262,144. Each time beside the
      card's name and power limit.

21. W8A8 serving and the reproducibility harness (no new kernel):
   a. PLIP("random:ViT-L/14", quantize="w8a8") at full depth in bf16 and
      fp32 and "random:ViT-L/14@336px" in bf16, 64 synthetic tiles in
      batches of 64 (L/14) and 32 (@336): every vision block linear holds
      int8 kernel_q on the card and the text tower's linears their fp32
      kernel; a batch launches mha_core (L/14) or flash_core (@336) 24
      times, attn_core and gemm_bias_residual never, and 96 int8 products;
      the embeddings against the same quantized model with plain cores and
      plain LayerNorm (row cosine >= 0.999 bf16, > 0.9999 fp32, and the
      largest |difference| printed: an activation integer that the cores'
      last bits flip moves an embedding by about 1e-2); the row cosine
      against the unquantized tower at the same weights printed (not
      asserted: quant.py's 0.9998 was stated for the published weights);
      images/s with and without quantize="w8a8", once each; the CUDA-event
      ms of torch._int_mm against bf16 torch.matmul at the four L/14 linear
      shapes (M = 64 x 257), beside their bound, and of the whole W8A8
      linear against the bf16 linear;
   b. the harness on the card: 64 synthetic tiles in two classes written
      as PNG files and a full-width ViT-B/32 .npz; EmbedderFactory ->
      image_embedder / text_embedder: the first call writes the cache, the
      second hits it and launches no kernel; the embeddings bit-equal to
      PLIP.encode_images L2-normalized; ZeroShotClassifier, ImageRetrieval
      and LinearProber(backend="torch") on the card: on the tiles'
      embeddings (nearly parallel at random weights, an ill-conditioned
      fit) its agreement with the same fit on the CPU is printed; on
      seed-0 Kather-like embeddings (9 classes, 1,800 + 600 rows, test
      accuracy about 0.94) its predictions agree with the CPU's fit on at
      least 99% of the rows;
      neither scikit-learn nor pandas loaded after the step.
22. WSI streaming, supervised fine-tuning and the CNN towers (no new kernel;
   seed 0, full width and depth, each part's seconds printed):
   a. a synthetic 8192 x 8192 uint8 slide (white, tissue blobs over about
      40% of it: 192 MiB on the host) through data.wsi.embed_wsi (tiles of
      224, non_bg_threshold 0.5, batches of 256) and embed_wsi_pyramid (the
      DigestPath defaults) over PLIP("random:ViT-B/32") in bf16 and fp32:
      the coordinates equal the iterators', the embeddings equal
      PLIP.encode_images of the same tiles L2-normalized (row cosine >
      0.9999 fp32, >= 0.999 bf16), the first batch against the same tiles
      through the plain cores and LayerNorm (the bars of step 3), and
      attn_core launched once a layer a batch (every K1 kernel launched,
      no mha kernel); tiles/s of embed_wsi beside encode_images of the same
      tiles, once each, with host ms, device ms (torch.profiler) and the
      idle share;
   b. train.finetune.FineTuner in fp32 (its default) on one fixed batch of
      32 synthetic 256 x 256 tiles with 9 labels: the plip backbone (a
      random ViT-B/32 CLIP image tower and a linear head), vit_b_32 and
      vit_b_16: one step's loss and every leaf's grad against the plain
      path (loss within 1e-5 relative, leaf cosine >= 0.9999), attn_core
      and attn_core_bwd launched once a layer, the cores' routes recorded
      (vit_b_16 at S=197: the one-block forward, the key-tiled backward);
      4 AdamW steps of the plip backbone lower the loss; resnet50 at 224 x
      224: 3 steps lower the loss and move every BatchNorm's running
      statistics, and an lr=0 step moves them while no parameter moves;
      valid_evaluation on the card, with neither scikit-learn nor pandas
      loaded; the peak device memory of each step;
   c. embedders.mudipath.DenseNetEmbedder (densenet121, random weights) on
      64 tiles: unit rows of width 1024, two of them against the same model
      on the CPU (allclose 1e-4), and images/s.

23. The profiling helpers and data parallelism (no new kernel; ViT-B/32 at
   full width, bf16, seed 0):
   a. utils.profiling.trace around two PLIP.encode_images calls of 256
      tiles, each inside record_function("encode"): parse_device_trace of
      the written Chrome trace (n_steps=2) within 1% of the device sum of
      the same profile's prof.events() (profile_train.kernel_times), the
      "encode" range at least 95% of it; the wall printed;
   b. a world of one over NCCL (parallel.distributed.initialize at a free
      local port, create_mesh(dp=1)): PLIP(mesh=) rows bit-equal to the
      meshless PLIP's on 256 tiles and the 8 prompts; dp cosine_topk and
      cosine_topk_int8 over 262,144 x 512 rows equal to the meshless
      stream; CLIPTuner(mesh=) 2 steps at batch 128 give the meshless
      losses (1e-5 relative), and its save_full_state="orbax" directory
      resumes (train.contrastive.load_train_state_sharded) and exports
      (scripts.export_checkpoint) bit for bit; the K1 and K2 launches of
      one dp step;
   c. two ranks on cuda:0 under gloo, spawned after step 24a together with
      step 24's children, all running while the parent runs step 23b; the
      multi-process runs (23c, 24b-e) and their one-process references take
      ViT-B/32 and ViT-L/14 at full width and MESH_LAYERS (4) layers a
      tower, seed-0 random .npz files written once (a depth cut):
      one dp=2 make_train_step at global batch 64 (32 rows a rank) against
      one process on the same 64 rows: loss within 1e-5 relative, every
      leaf's first moment (0.1 grad) at cosine >= 0.9999 and its norm within
      1e-3 relative (a cosine does not see a factor), every parameter
      within 2 lr of the one process's (a first AdamW step is
      lr * g / (|g| + eps): where g is at rounding level, as in the key
      biases, its sign may differ between two summation orders; the
      parameter leaves' cosine is printed);
      PLIP(mesh=dp2) rows against the meshless rows (cosine >= 0.999, the
      bf16 bar; bit-equality printed); each child has a time limit and a
      failed child fails the step.
24. Tensor parallelism (ops/tp.py, parallel/mesh.py's shard_params):
   a. the new epilogue kernel tp_epilogue (csrc/tp_epilogue.cu), K1's and the
      composed rounding orders, against its plain version (bit-equal) at the
      B/32 vision and text batch-128 and L/14 batch-64 out-projection shapes
      and a width of 770 (its one-value path), fp32 and bf16, with
      gemm_bias_residual's fp32 partial mode at the same products; its
      CUDA-event ms beside (acc + bias).to(dt) + x in PyTorch and its bytes
      bound;
   b. two ranks on cuda:0 under gloo (tp=2), spawned as 23c's:
      PLIP(<B/32 .npz>, mesh=) encodes of 256 tiles and the 8 prompts
      against the meshless rows (fp32 allclose rtol 1e-4 and atol 1e-5 of
      the largest value; bf16 row cosine >= 0.999), tp_epilogue once a
      sublayer and an MLP half a layer a batch; each split leaf at 1/tp of
      its numel on each rank;
   c. a bf16 and an fp32 "mlp" step at batch 128 (both ranks all rows)
      against one process: fp32 at 23c's bars (loss 1e-5 relative, leaf
      first-moment cosine >= 0.9999, norms 1e-3, parameters within 2 lr);
      bf16, where a partial sum's order flips some casts, leaf first-moment
      cosine >= 0.995 (step_check's bf16 bar) and parameters within 2 lr,
      the loss printed; each rank's K1 and K2 launches the meshless step's,
      gemm_bias_residual plus fc2's partial, col_sum as the TN products'
      slice plan gives it, tp_epilogue once a sublayer and an MLP half and
      again in the "mlp" recompute; the steps' seconds;
   d. PLIP(<L/14 .npz>, mesh=) bf16 encode of 64 tiles (the composed
      sublayer over K3 at 8 heads a rank) against meshless (row cosine >=
      0.999, the same mha_core launches), then W8A8 in place: every int8
      product's int32 sums equal to the meshless ones' (each rank's columns
      of qkv and fc1, the whole sums of out and fc2; exact fingerprints);
   e. four ranks (dp=2, tp=2): one fp32 "mlp" step at global batch 64 against
      one process at 23c's bars. NCCL with tp > 1 is not run (one card).

Every phase prints the seconds it took. Exits non-zero, printing no result,
when there is no CUDA device or any check fails. The line before the last
is a JSON summary of the kernels (K1's three, K2's four, mha_core,
flash_core, mha_core_bwd, gemm_bias_gelu, gemm_nt_gelu_bwd, block_bwd (K7),
mlp_bwd (K8), mlp_fwd (K9), headgrid_core (K12), block_fwd (K10),
gemm_bias_gelu_f32, attention_sublayer_bwd_split (K6), preprocess_fused
(K11) and tp_epilogue (step 24a's numbers at B/32 vision batch 128 bf16, its
launches in a rank's step 24c bf16 step): each one's launches in its own path's run, its worst error, and at
that path's shape in bf16 (K11: uint8 in, fp32 out, device ms too) its time and its plain
version's (gemm_bias_residual and attn_core also under "fp32": step 16's
numbers at the ViT-B/32 vision shape and launches of its fp32 run;
grad_gemm and attn_core_bwd step 17's, with the launches of its fp32
train step; mha_core and mha_core_bwd step 18's at ViT-L/14, with the
launches of its fp32 encode and remat=False step; ln_rows and ln_bwd_rows
step 19's at ViT-B/32 vision batch 128, device ms too, with the launches of
its bf16 "mlp" step; K1's and K2's kernels also the launches of step 23b's dp
step), the bound (the larger of its bytes over 3.35 TB/s and its FLOPs
over 989 TFLOP/s, or K11's over the 67 TFLOP/s of fp32 outside the tensor
cores, H100 SXM) and the time of the one PyTorch call that computes the
same function, or of the yardstick above; K11 none: no one call computes
PIL's bicubic with its uint8 stores, the crop and the normalize); the last line is
{"ok": true, "device": {...}}.
"""

import atexit
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from types import SimpleNamespace
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
# the yardsticks: CUDA-event and device ms, the bound, SDPA
from plip_tpu_torch.profile_kernels import (PEAK_BYTES, PEAK_FP32, bound,  # noqa: E402
                                            device_ms, in_turns, sdpa_backward,
                                            sdpa_forward, time_ms)
SOURCE = "plip_tpu_torch/csrc/attention_sublayer.cu"
REPLACES = "plip_tpu/ops/attention.py:644"  # _attn_sublayer_kernel (K1)
KERNELS = ("ln_rows", "gemm_bias_residual", "attn_core")
BWD_SOURCE = "plip_tpu_torch/csrc/attention_sublayer_bwd.cu"
BWD_REPLACES = "plip_tpu/ops/attention.py:1024"  # _attn_sublayer_bwd_kernel (K2)
BWD_KERNELS = ("grad_gemm", "attn_core_bwd", "ln_bwd_rows", "col_sum")
# the call of each K2 kernel whose time goes into the JSON line
BWD_TIMED = {"grad_gemm": "grad_gemm TN (dWqkv = ln^T . dqkv)",
             "attn_core_bwd": "attn_core_bwd", "ln_bwd_rows": "ln_bwd_rows",
             "col_sum": "col_sum (dbqkv)"}
# the backward calls whose outputs (all, or all but the first) sum token rows
SUMMED = ("grad_gemm TN (dWout = ctx^T . g)", "grad_gemm TN (dWqkv = ln^T . dqkv)",
          "col_sum (dbqkv)")
SUMMED_PARTS = ("ln_bwd_rows", "attention_sublayer_bwd")
TRAIN_BATCH, TRAIN_STEPS = 128, 6  # the tuner run: one epoch
MHA_SOURCE = "plip_tpu_torch/csrc/mha.cu"
MHA_REPLACES = {"mha_core": "plip_tpu/ops/attention.py:36",  # _mha_kernel (K3)
                "flash_core": "plip_tpu/ops/attention.py:243"}  # _flash_kernel (K5)
MHA_BWD_SOURCE = "plip_tpu_torch/csrc/mha_bwd.cu"
MHA_BWD_REPLACES = "plip_tpu/ops/attention.py:125"  # _mha_bwd_kernel (K4)
# the kernels whose bf16 instantiations run on wgmma (HGMMA in their SASS),
# and how many bf16 instantiations each has (the epilogue GEMMs' fifth:
# gemm_bias_residual's fp32 partial mode, tensor parallelism's)
WGMMA_KERNELS = {"mha_kernel": 2, "core_bwd_rows": 2, "core_bwd_keys": 2,
                 "attn_core_wgmma": 2, "grad_gemm_wgmma": 4, "epilogue_gemm_wgmma": 5,
                 "attn_core_bwd_wgmma": 2}
# The published bf16 dense tensor-core rate of one H100 SXM (profile_kernels
# has its HBM3 rate and the fp32 rate outside the tensor cores)
PEAK_FLOPS = 989e12
# (name, core, B, S, W, heads, causal, s_valid); the first of each core is the
# serving shape whose bf16 time goes into the JSON line
WIDE_CASES = (
    ("ViT-L/14 vision", "mha_core", 64, 257, 1024, 16, False, None),
    ("causal, s_valid=250", "mha_core", 8, 257, 1024, 16, True, 250),
    ("ViT-L/14@336px vision", "flash_core", 32, 577, 1024, 16, False, None),
    ("ViT-B/16 vision", "attn_core", 32, 197, 768, 12, False, None),
)
# (architecture, image batch, the vision tower's core, also held in fp32):
# ViT-B/32 is step 3, the others step 6
SERVING = (("ViT-B/32", 32, "attn_core", True),
           ("ViT-L/14@336px", 32, "flash_core", True),
           ("ViT-L/14", 64, "mha_core", True),
           ("ViT-B/16", 32, "attn_core", False))
CORES = ("attn_core", "mha_core", "flash_core")
# bf16 cores and key-tiled backwards: the largest share of elements that may
# differ from the plain version (H100 readings: at most 0.23% for the cores
# and 0.24% for the backwards, at least 1.4% for the schedule faults of step
# 5 and 51% for the backwards' other schedule), and the largest error in
# ulps of the row's largest value: 1 for a core, 2 for a backward's dqkv
# (its readings reach 2 at ViT-L/14, as do its controls': the share is what
# tells them apart)
CORE_DIFFER = 0.005
BWD_ULPS = 2
# a normalize-first core over more than 512 keys: P = e / sum with the fp32
# row sum taken in another order, so more of P's casts flip than in the
# deferred form, and their sum reaches 2 ulps of the row max (H100 reading,
# the jnp_mha core at B=32, S=577: 0.11% of the elements differing, 2 ulps;
# the deferred divide, its control at S=257, 48%)
LONG_ULPS = 2
# the MLP's bf16 activation: an h1 one ulp apart gives an activation up to
# two ulps apart (H100 readings: 2 ulps at 0.03-0.27% of the elements
# differing; the composed forward's bf16 QuickGELU, its control, 29%)
ACT_ULPS = 2
# (name, kernel, B, S, W, heads, causal, s_valid): step 7; the first case of
# mha_core_bwd is the one whose bf16 numbers go into the JSON line
WIDE_BWD_CASES = (
    ("ViT-L/14 vision", "mha_core_bwd", 64, 257, 1024, 16, False, None),
    ("causal, s_valid=250", "mha_core_bwd", 8, 257, 1024, 16, True, 250),
    ("ViT-B/16 vision", "attn_core_bwd", 32, 197, 768, 12, False, None),
    ("ViT-L/14 vision", "attn_core_bwd", 64, 257, 1024, 16, False, None),
    ("ViT-L/14@336px vision", "attn_core_bwd", 32, 577, 1024, 16, False, None),
    ("ViT-L/14@336px vision", "attn_core", 32, 577, 1024, 16, False, None),
    ("ViT-B/32 vision, remat block", "mha_core_bwd", 128, 50, 768, 12, False, None),
    ("ViT-B/32 text, remat block", "mha_core_bwd", 128, 77, 512, 8, True, None),
)
# step 8: (architecture, remat) -> the kernels its step must launch
WIDE_TRAIN = {
    ("ViT-B/16", "mlp"): ("attn_core", "attn_core_bwd"),
    ("ViT-L/14", "mlp"): ("mha_core", "attn_core_bwd"),  # the hybrid
    ("ViT-L/14", False): ("mha_core", "mha_core_bwd"),
    ("ViT-L/14@336px", "mlp"): ("attn_core", "attn_core_bwd"),
    ("ViT-L/14@336px", False): ("flash_core",),
}
WIDE_TRAIN_BATCH = 8
WIDE_TUNER = ("ViT-L/14", 64, 4)  # step 9: architecture, batch, steps
# step 11: (name, B, S, W, heads, causal); the first is the JSON line's shape
BLOCK_CASES = (("ViT-B/32 vision", 128, 50, 768, 12, False),
               ("ViT-B/32 text", 128, 77, 512, 8, True),
               ("ViT-B/16 vision", 32, 197, 768, 12, False))
MLP_SOURCE = "plip_tpu_torch/csrc/mlp.cu"
BLOCK_REPLACES = {"gemm_bias_gelu": "plip_tpu/ops/mlp.py:187",  # _mlp_fwd_kernel (K9)
                  "gemm_nt_gelu_bwd": "plip_tpu/ops/mlp.py:54",  # _mlp_bwd_kernel (K8)
                  "block_bwd": "plip_tpu/ops/block_bwd.py:70",  # _block_bwd_kernel (K7)
                  "mlp_bwd": "plip_tpu/ops/mlp.py:54",
                  "mlp_fwd": "plip_tpu/ops/mlp.py:187"}
# (architecture, batch, dtypes held against the plain versions, K7 launches)
BLOCK_TRAIN = (("ViT-B/32", 32, (torch.float32, torch.bfloat16), 24),
               ("ViT-B/16", 8, (torch.bfloat16,), 24),
               ("ViT-L/14", 8, (torch.bfloat16,), 0))
BLOCK_TUNER_STEPS = 3
# step 12: (name, B, S, W, heads) of K12 and of the jnp_mha core; the @336
# "block" step (as BLOCK_TRAIN); K10's (name, B, S, W, heads, causal), the
# first the JSON line's shape, and the tiles of its 12-layer stack; K6's
# batches (grads, rates); K11's (H, W, out) and tiles
HEADGRID_CASE = ("ViT-L/14 vision", 64, 257, 1024, 16)
JNP_MHA_CASE = ("ViT-L/14@336px vision", 32, 577, 1024, 16)
BLOCK_336 = (("ViT-L/14@336px", 8, (torch.bfloat16,), 0),)
K10_CASES = (("ViT-B/32 vision", 256, 50, 768, 12, False),
             ("ViT-B/32 text", 256, 77, 512, 8, True))
K10_TILES = 256
K6_BATCH = 32
K11_CASES = ((256, 256, 224), (300, 400, 224), (256, 256, 336), (1024, 700, 224))
K11_TILES = 256
# step 12's kernels: (source, the TPU kernel it replaces)
SLICE6 = {"headgrid_core": (MHA_SOURCE, "plip_tpu/ops/attention.py:324"),  # _headgrid_kernel
          "block_fwd": (MLP_SOURCE, "plip_tpu/ops/block.py:57"),  # _block_kernel (K10)
          "gemm_bias_gelu_f32": (MLP_SOURCE, "plip_tpu/ops/block.py:57"),
          "attention_sublayer_bwd_split": (BWD_SOURCE, "plip_tpu/ops/attention.py:1131"),
          "preprocess_fused": ("plip_tpu_torch/csrc/preprocess.cu",
                               "plip_tpu/ops/preprocess_pallas.py:36")}

# step 13: K1's core at S <= 256 (name, B, S, W, heads, causal, s_valid), the
# last ViT-B/16's, and its bar there (twice SDPA's 0.0282 ms at that shape,
# NVIDIA H100 80GB HBM3, 700 W); grad_gemm's four products at (name, token
# rows, W) and its bar against torch.matmul
SHORT_CORE_CASES = (("ViT-B/32 vision", 32, 50, 768, 12, False, None),
                    ("text", 32, 77, 512, 8, True, None),
                    ("text s_valid=70", 32, 77, 512, 8, True, 70),
                    ("ViT-B/16 vision", 32, 197, 768, 12, False, None))
SHORT_CORE_BAR_MS = 0.0564
GRAD_GEMM_CASES = (("ViT-B/32 vision B=32", 32 * 50, 768),
                   ("ViT-L/14 vision B=64", 64 * 257, 1024))
GRAD_GEMM_MATMUL_FACTOR = 2.0
# step 14: the epilogue GEMMs of csrc/gemm.cuh at (name, token rows, W); each
# case runs the products the path runs there (fc1 and its NT backward at 4W,
# fc2 or the out-projection with R, the QKV product) and the bar against
# torch.addmm / torch.matmul of the same bf16 operands
EPILOGUE_CASES = (("ViT-B/32 vision B=128", 128 * 50, 768,
                   ("gemm_bias_gelu", "gemm_bias_gelu_f32", "gemm_nt_gelu_bwd", "fc2 + R")),
                  ("ViT-L/14 vision B=64", 64 * 257, 1024,
                   ("qkv", "out-projection + R", "gemm_bias_gelu", "gemm_nt_gelu_bwd")),
                  ("ViT-L/14@336px vision B=32", 32 * 577, 1024, ("qkv",)))
EPILOGUE_LIBRARY_FACTOR = 2.0
# step 15: col_sum at the calls of the three training steps of PERF.md section
# 5 (name, rows, columns), each in fp32 and bf16, and its bar: at least this
# share of its bytes bound at the two large bf16 shapes; attn_core_bwd's
# one-block core at (name, B, S, W, heads, causal, s_valid), with the
# CUDA-event ms of the CUDA-core kernel it replaced, at the shape where that
# was measured (NVIDIA H100 80GB HBM3, 700 W)
COL_SUM_CASES = (("ViT-B/32 B=32 dbqkv", 32 * 50, 2304),
                 ("ViT-B/32 B=128 db1", 128 * 50, 3072),
                 ("ViT-B/32 B=128 dbout", 128 * 50, 768),
                 ("ViT-L/14 B=64 dbqkv", 64 * 257, 3072),
                 ("ViT-L/14 B=64 dbout", 64 * 257, 1024),
                 ("ViT-L/14 B=64 LN partials", -(-64 * 257 // 8), 2048),
                 ("ViT-L/14 B=64 TN slices of dWqkv", 2, 1024 * 3072),
                 ("text B=128 dbqkv", 128 * 77, 1536))
COL_SUM_BOUND_SHARE = 0.5
COL_SUM_ITERS = 200
COL_SUM_BOUND_CASES = ("ViT-B/32 B=128 db1", "ViT-L/14 B=64 dbqkv")
CORE_BWD_CASES = (("ViT-B/32 vision B=32", 32, 50, 768, 12, False, None),
                  ("ViT-B/32 vision B=128", 128, 50, 768, 12, False, None),
                  ("text B=32", 32, 77, 512, 8, True, None),
                  ("text B=128", 128, 77, 512, 8, True, None),
                  ("text B=32 s_valid=70", 32, 77, 512, 8, True, 70),
                  ("ViT-L/14 text B=64", 64, 77, 768, 12, True, None))
OLD_CORE_BWD_MS = {"ViT-B/32 vision B=32": 0.1328}

# step 16: fp32 (the dtype PLIP and CLIPTuner take by default) on the
# redesigned kernels. The parent's kernels' CUDA-event ms at the shapes of
# plip_tpu_torch/profile_kernels.py (its gemm_bias_residual and attn_core
# cases, run on the parent tree: NVIDIA H100 80GB HBM3, 700 W); the aims,
# printed as held or missed: the GEMM at ViT-B/32 vision qkv M=12,800 at
# least GEMM_BOUND_AIM of its 67 TFLOP/s bound and within GEMM_ADDMM_AIM of
# torch.addmm, the core at or under SDPA at CORE_SDPA_AIM_CASES and at least
# CORE_BOUND_AIM of its bytes bound at vision B=256; bf16 at head_dim 32 and
# 16 on the one-block cores (name, B, S, W, heads, causal, s_valid); the
# fp32 serving run (architecture, tiles, batch)
PARENT_FP32_MS = {
    "qkv vision W=768 M=1600": 0.3041, "out-projection + R vision W=768 M=1600": 0.1584,
    "qkv vision W=768 M=12800": 2.0167, "out-projection + R vision W=768 M=12800": 0.7703,
    "qkv text W=512 M=616": 0.0887, "out-projection + R text W=512 M=616": 0.0779,
    "qkv text W=512 M=19712": 1.3886, "out-projection + R text W=512 M=19712": 0.5309,
    "vision B=32 S=50": 0.0505, "vision B=256 S=50": 0.3309, "text B=32 S=77 causal": 0.0613,
    "text B=32 s_valid=70 S=77 causal": 0.0612, "ViT-B/16 vision B=32 S=197": 0.5994}
GEMM_AIM_CASE, GEMM_BOUND_AIM, GEMM_ADDMM_AIM = "qkv vision W=768 M=12800", 0.70, 1.1
CORE_SDPA_AIM_CASES = ("vision B=32 S=50", "text B=32 S=77 causal")
CORE_BOUND_AIM_CASE, CORE_BOUND_AIM = "vision B=256 S=50", 0.40
OTHER_HEAD_DIM_CASES = (("vision, head_dim 32", 32, 50, 768, 24, False, None),
                        ("vision, head_dim 16", 32, 50, 768, 48, False, None),
                        ("text, head_dim 32", 32, 77, 512, 16, True, None),
                        ("text, head_dim 16, s_valid=70", 32, 77, 512, 32, True, 70))
FP32_SERVING = ("ViT-B/32", 64, 32)
# the one-block core at the widest heads, v over k (attention.core_v_over_k):
# (name, B, S, W, heads, causal, s_valid)
V_OVER_K_CASES = (("head_dim 96, causal, s_valid=180", 8, 193, 384, 4, True, 180),
                  ("head_dim 128", 8, 256, 512, 4, False, None))

# step 17: the key-tiled cores at head_dims other than 64 (name, B, S, W,
# heads): ViT-H/14's vision tower (head_dim 80) and ViT-bigG/14's (104), at
# 224 px and at 336 px; K7 runs the ones that fit its 512 tokens. Then K2's
# fp32 kernels, redesigned: the parent's CUDA-event ms at the shapes of
# plip_tpu_torch/profile_kernels.py (its grad_gemm and attn_core_bwd cases,
# PERF.md section 6: NVIDIA H100 80GB HBM3, 700 W; device ms where the aim
# reads them), the aims printed as held or missed (each product within
# GRAD_GEMM_MATMUL_AIM of torch.matmul and no slower than the parent's; the
# core backward at or under SDPA's backward in device ms and at least
# CORE_BWD_SPEEDUP_AIM times the parent's at CORE_BWD_AIM_CASES), the case
# of each whose numbers go into the JSON line's "fp32" entry; one full-depth
# fp32 train step (architecture, batch, remat).
WIDE_HEAD_CASES = (("ViT-H/14 vision, head_dim 80", 8, 257, 1280, 16),
                   ("ViT-bigG/14 vision, head_dim 104", 4, 257, 1664, 16),
                   ("ViT-bigG/14 vision at 336 px, head_dim 104", 2, 577, 1664, 16))
PARENT_FP32_BWD_MS = {
    "NT dctx = g . Wout^T vision B=128": 0.5246, "NT dln = dqkv . Wqkv^T vision B=128": 1.6732,
    "TN dWout = ctx^T . g vision B=128": 0.5226, "TN dWqkv = ln^T . dqkv vision B=128": 1.2673,
    "vision B=32 S=50": 0.1324, "vision B=128 S=50": 0.4684, "text B=128 S=77 causal": 0.4776}
PARENT_FP32_BWD_DEVICE_MS = {"vision B=32 S=50": 0.1296, "vision B=128 S=50": 0.4653,
                             "text B=128 S=77 causal": 0.4748}
GRAD_GEMM_MATMUL_AIM, CORE_BWD_SPEEDUP_AIM = 1.25, 2.0
CORE_BWD_AIM_CASES = ("vision B=128 S=50", "text B=128 S=77 causal")
FP32_BWD_JSON_CASES = {"grad_gemm": "NT dln = dqkv . Wqkv^T vision B=128",
                       "attn_core_bwd": "vision B=128 S=50"}
FP32_STEP = ("ViT-B/32", 128, "mlp")

# step 18: the key-tiled cores off wgmma redesigned (TF32 products, the
# logits computed once a query tile). The parent's kernels' CUDA-event ms at
# the shapes of profile_kernels.py --tiled (its TILED_CASES, run on the parent
# tree: NVIDIA H100 80GB HBM3, 700.00 W), by (kernel, case); the aims,
# printed as held or missed: every case at least TILED_SPEEDUP_AIM times the
# parent's, an fp32 forward within FWD_SDPA_AIM of SDPA's fp32 forward and
# an fp32 backward within BWD_SDPA_AIM of SDPA's backward; the case of each
# kernel whose numbers go into the JSON line's "fp32" entry; the fp32 L/14
# serving run (architecture, tiles, batch) and train step (architecture,
# batch, remat, and the depth of its remat=False step, whose core backward
# is K4); the head_dim-160 check (B, S, heads) and tower (width, heads).
PARENT_TILED_MS = {
    ("mha_core", "ViT-L/14 B=64 S=257 float32"): 2.1457,
    ("attn_core", "ViT-L/14 B=64 S=257 float32"): 2.1232,
    ("attn_core", "ViT-L/14@336px B=32 S=577 float32"): 4.1889,
    ("flash_core", "ViT-L/14@336px B=32 S=577 float32"): 4.1825,
    ("headgrid_core", "ViT-L/14@336px B=32 S=577 float32"): 5.7924,
    ("mha_core_bwd", "ViT-L/14 B=64 S=257 float32"): 14.7362,
    ("attn_core_bwd", "ViT-L/14 B=64 S=257 float32"): 13.7099,
    ("attn_core_bwd", "ViT-L/14@336px B=32 S=577 float32"): 26.0485,
    ("attn_core_bwd", "ViT-B/16 B=32 S=197 float32"): 3.4061,
    ("mha_core", "ViT-H/14 B=8 head_dim 80 S=257 float32"): 0.8938,
    ("mha_core_bwd", "ViT-H/14 B=8 head_dim 80 S=257 float32"): 2.8983,
    ("mha_core", "ViT-H/14 B=8 head_dim 80 S=257 bfloat16"): 0.7522,
    ("mha_core_bwd", "ViT-H/14 B=8 head_dim 80 S=257 bfloat16"): 2.7787,
    ("mha_core", "ViT-bigG/14 B=4 head_dim 104 S=257 bfloat16"): 0.4921,
    ("mha_core_bwd", "ViT-bigG/14 B=4 head_dim 104 S=257 bfloat16"): 1.7204,
    ("flash_core", "ViT-bigG/14@336px B=2 head_dim 104 S=577 bfloat16"): 0.9842,
    ("attn_core_bwd", "ViT-bigG/14@336px B=2 head_dim 104 S=577 bfloat16"): 3.3335}
TILED_SPEEDUP_AIM, FWD_SDPA_AIM, BWD_SDPA_AIM = 3.0, 1.25, 1.5
TILED_JSON_CASES = {"mha_core": "ViT-L/14 B=64 S=257 float32",
                    "mha_core_bwd": "ViT-L/14 B=64 S=257 float32"}
FP32_L14_SERVING = ("ViT-L/14", 64, 64)
FP32_L14_STEP = ("ViT-L/14", 64, "mlp", 2)
WIDE_HEAD_CHECK = (2, 257, 4)
WIDE_HEAD_TOWER = (320, 2)

# step 19: the LayerNorm kernels redesigned (csrc/layer_norm.cuh: a row in one
# warp's registers, 16-byte loads, shuffle sums; ln_bwd_rows' planned partial)
# and every LayerNorm of the towers on them (ops.attention.layer_norm_rows).
# The aims, in device ms under torch.profiler, printed held or missed: each
# kernel at least LN_BOUND_AIM of its bytes bound at LN_AIM_SHAPES (rows,
# width), and no slower than F.layer_norm's forward (its autograd backward)
# at every shape of profile_kernels' LN_SHAPES; the case whose numbers go
# into the JSON line; the train step (architecture, batch, remat) and the
# encode (architecture, tiles, batch) held against the plain path.
LN_BOUND_AIM = 0.5
LN_AIM_SHAPES = ((6400, 768), (9856, 512))
LN_JSON_CASE = "vision B=128 [6400, 768] bfloat16"
LN_STEP = ("ViT-B/32", TRAIN_BATCH, "mlp")
LN_ENCODE = ("ViT-B/32", 256, 32)

# step 20: torch state_dicts and device retrieval. The checkpoints at full
# width (architecture, tiles); the retrieval corpus (rows at the timed sizes,
# the largest one checked; B/32's embed_dim wide, seed 0), queries, k and
# timed calls; the index sizes of the auto gate's host and device times; the
# margin crusher of tests/test_retrieval_adversarial.py (rows, dim, gap).
CKPT_CHECK = ("ViT-B/32", 64)
RETRIEVAL_ROWS = (262144, 1 << 20)
RETRIEVAL_Q, RETRIEVAL_K, RETRIEVAL_REPS = 64, 10, 1
GATE_ROWS = (16384, 262144)
PAD_ROWS = 262143  # step 20b's API index that is not a chunk multiple
INT8_OPS = 1979e12  # the H100 SXM's dense int8 rate, for the int8 stream's bound
CRUSHER = (2048, 64, 1e-5)

# step 21: W8A8 serving (architecture, batch, the vision core, dtypes held
# against the plain cores); the four L/14 vision linears (K, N) at M = 64 x
# 257 token rows; the harness's tiles, its full-width checkpoint and the
# probe's bar (the share of rows the card's fit and the CPU's agree on)
W8A8_SERVING = (("ViT-L/14", 64, "mha_core", (torch.bfloat16, torch.float32)),
                ("ViT-L/14@336px", 32, "flash_core", (torch.bfloat16,)))
W8A8_TILES = 64
INT8_LINEARS = (("qkv", 1024, 3072), ("out", 1024, 1024), ("fc1", 1024, 4096),
                ("fc2", 4096, 1024))
INT8_M = 64 * 257
HARNESS = ("ViT-B/32", 64)
PROBE_AGREE = 0.99
# the probe's held comparison: seed-0 embeddings of Kather-like data (9
# tissue classes, 1,800 train and 600 test rows, unit rows around class
# centres, noise 6 times a centre's scale: test accuracy about 0.94); the
# random-weight tower's embeddings of the tiles are nearly parallel, an
# ill-conditioned fit whose predictions are printed, not held
PROBE_DATA = (9, 1800, 600, 6.0)

# step 22: the synthetic slide (side, tissue share), the stream's batch,
# the fine-tuning batch (tiles, labels, side), each backbone's (steps, lr)
# and the DenseNet embedder's tiles
WSI_SLIDE = (8192, 0.4)
WSI_BATCH = 256
FT_BATCH = (32, 9, 256)
FT_RUNS = {"plip": (4, 1e-5), "vit_b_32": (1, 1e-4), "vit_b_16": (1, 1e-4),
           "resnet50": (3, 1e-4)}
DENSE_TILES = 64

# step 23: the encode of 23a and 23b (tiles, batch); the dp retrieval (index
# rows, queries, k); 23c's global batch (32 rows a rank), learning rate and
# its children's time limit in seconds
DP_TILES = (256, 32)
DP_RETRIEVAL = (262144, 64, 10)
DP2_BATCH, DP2_LR = 64, 1e-5
# steps 23c and 24's multi-process runs: ViT-B/32 and ViT-L/14 at full width and
# this many layers a tower (a depth cut: eight processes share one card there)
MESH_LAYERS = 4
DP2_TIMEOUT_S = 300

# step 24: tensor parallelism on cuda:0 under gloo. The tp=2 children's
# "mlp" step batch (all rows on both ranks; bf16 and fp32) and ViT-L/14
# tiles; the dp=2 x tp=2 children's global batch (fp32); their learning rate
# and time limit (s); a bf16 step's bar: every first moment's leaf cosine
# (step_check's bf16 grad bar); the epilogue kernel's shapes (name, M, N):
# the first the JSON line's, the last its one-value path (N % 8)
TP_BATCH, TP_DP_BATCH, TP_LR = 128, 64, 1e-5
TP_L14_TILES = 64
TP_TIMEOUT_S = 400
TP_BF16_COS = 0.995
TP_EPILOGUE_CASES = (("ViT-B/32 vision B=128", 128 * 50, 768),
                     ("ViT-B/32 text B=128", 128 * 77, 512),
                     ("ViT-L/14 vision B=64", 64 * 257, 1024),
                     ("odd width", 1000, 770))
TP_SOURCE = "plip_tpu_torch/csrc/tp_epilogue.cu"
# the epilogue completes K1's out-projection under tp (no TPU kernel of its own)
TP_REPLACES = "plip_tpu/ops/attention.py:644"

# (name, B, S, W, heads, causal, s_valid)
CASES = (
    ("vision", 32, 50, 768, 12, False, None),
    ("text", 32, 77, 512, 8, True, None),
    ("text s_valid=70", 32, 77, 512, 8, True, 70),
    ("text, 8 prompts", 8, 77, 512, 8, True, None),  # the requests below
)
# the backward at the tuner's batch: dW sums 6,400 and 9,856 token rows
TRAIN_CASES = (
    ("vision, tuner batch", TRAIN_BATCH, 50, 768, 12, False, None),
    ("text, tuner batch", TRAIN_BATCH, 77, 512, 8, True, None),
)
TIMED_CASE, TIMED_DTYPE = "vision", torch.bfloat16  # the numbers in the JSON line

PROMPTS = [
    "an H&E image of benign tissue",
    "an H&E image of malignant tumor",
    "an H&E image of normal colon mucosa",
    "an H&E image of adipose tissue",
    "an H&E image of lymphocytes",
    "an H&E image of necrosis",
    "an H&E image of smooth muscle",
    "an H&E image of stroma",
]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def yardstick(label, flops, nbytes, library_fn, peak=PEAK_FLOPS) -> dict:
    """The bound of a kernel's work and the time of one PyTorch call that
    computes the same function (never used by the port)."""
    bound_ms, bound_by = bound(flops, nbytes, peak)
    library_ms = time_ms(library_fn)
    print(f"  {label}: bound {bound_ms:.4f} ms ({bound_by}), PyTorch call "
          f"{library_ms:.4f} ms")
    return {"bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}


def core_line(label, ms, plain_ms, flops, nbytes, library_fn, peak=PEAK_FLOPS) -> dict:
    """A redesigned attention core (csrc/mha.cu, csrc/mha_bwd.cu) at one shape:
    its kernel, plain and PyTorch ms, the TFLOP/s it reaches and its share of
    the bound (FLOPs at ``peak``: bf16's, or PEAK_FP32 for an fp32 row);
    returns ``yardstick``'s keys."""
    y = yardstick(label, flops, nbytes, library_fn, peak)
    print(f"  {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, PyTorch "
          f"{y['library_ms']:.4f} ms; {flops / ms / 1e9:.1f} TFLOP/s, "
          f"{y['bound_ms'] / ms:.2%} of the bound ({y['bound_by']})")
    return y


def start_sass_dump(_build):
    """``cuobjdump --dump-sass`` of the built library, run beside the phases
    (its output in build/): (the process, the output's path)."""
    path = os.path.join(ROOT, "build", "chip_smoke_sass.txt")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        return subprocess.Popen(_build.sass_command(), stdout=f), path


def wgmma_check(_build, dump) -> None:
    """Prints the HGMMA (wgmma) instructions in the SASS (``start_sass_dump``'s)
    of each instantiation of the attention cores' kernels; fails unless every
    bf16 one has some."""
    proc, path = dump
    t = time.perf_counter()
    if proc.wait(timeout=600) != 0:
        raise AssertionError(f"cuobjdump exited {proc.returncode}")
    with open(path) as f:
        sass = f.read()
    os.remove(path)
    print(f"wgmma in the attention cores' SASS (cuobjdump, run beside the phases; "
          f"{time.perf_counter() - t:.1f} s waited for it):")
    counts = {k: n for k, n in _build.sass_counts("HGMMA", sass).items()
              if any(name in k for name in WGMMA_KERNELS)}
    for k, n in sorted(counts.items()):
        print(f"  HGMMA {n:3d}  {k}")
    for name, want in WGMMA_KERNELS.items():
        bf16 = [n for k, n in counts.items() if name in k and "nv_bfloat16" in k]
        if len(bf16) != want or not all(bf16):
            raise AssertionError(f"{name}: a bf16 instantiation issues no wgmma ({bf16})")


def layer_norm_backward(x, scale, bias, dln):
    """The autograd backward of F.layer_norm in x's dtype."""
    xl = x.detach().requires_grad_()
    w, b = (t.to(x.dtype).requires_grad_() for t in (scale, bias))
    y = F.layer_norm(xl, (x.shape[-1],), w, b)
    return lambda: torch.autograd.grad(y, (xl, w, b), dln.to(x.dtype), retain_graph=True)


class Patched:
    """Inside it every patch of ``patches`` is applied. Reusable."""

    def __init__(self, *patches):
        self.patches = list(patches)

    def __enter__(self):
        for p in self.patches:
            p.start()

    def __exit__(self, *exc):
        for p in reversed(self.patches):
            p.stop()


class PlainVersions(Patched):
    """Inside it every kernel wrapper of ``modules`` takes its plain version
    (each picks it by the device, with ``_on_cpu``), under the same autograd
    functions. Reusable."""

    def __init__(self, *modules):
        super().__init__(*(mock.patch.object(m, "_on_cpu", lambda t, name: True)
                           for m in modules))


def plain_layer_norm():
    """Patches that put the towers' LayerNorm (``ops.attention.layer_norm_rows``,
    as ``models.layers``, ``ops.mlp`` and ``ops.attention`` call it) on its
    plain version, so that a plain path launches no LayerNorm kernel."""
    from plip_tpu_torch.models import layers
    from plip_tpu_torch.ops import attention as att
    from plip_tpu_torch.ops import mlp as mlpm

    return [mock.patch.object(m, "layer_norm_rows", att.layer_norm_rows_reference)
            for m in (att, mlpm, layers)]


def plain_towers(att, mha, layers):
    """The towers' plain serving path: the attention sublayer, the cores and
    every LayerNorm on their plain versions."""
    return Patched(mock.patch.multiple(
        layers, attention_sublayer=att.attention_sublayer_reference,
        mha_core=mha.mha_core_reference, flash_core=mha.flash_core_reference),
        *plain_layer_norm())


def ulp_stats(got, want):
    """(share of the elements that differ, the worst |got - want| in bf16
    ulps of the largest |want| of its row)."""
    d = (got.float() - want.float()).abs()
    _, e = torch.frexp(want.float().abs().amax(-1, keepdim=True))
    row_ulp = torch.ldexp(torch.ones_like(d), e - 8)
    return (d != 0).float().mean().item(), (d / row_ulp).max().item()


def compare(label, got, want, dtype, summed=False, core=False, ulps_bar=1) -> float:
    """The bars above; ``summed``: each element sums the B*S token rows (a
    weight, bias or LN grad), so atol is scaled by the RMS of ``want``;
    ``core``: an attention core or backward, held in bf16 to at most
    CORE_DIFFER differing and every element within ``ulps_bar`` ulps of its
    row's largest value."""
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    scale = want.square().mean().sqrt().item() if summed else 1.0
    atol = (1e-4 if dtype == torch.float32 else 3e-2) * scale
    extra = f" rms={scale:.4e} atol={atol:.4e}" if summed else ""
    if dtype == torch.float32:
        ok = torch.allclose(got, want, atol=atol, rtol=1e-4)
    else:
        cos = torch.nn.functional.cosine_similarity(got, want, dim=-1).min().item()
        ok = cos >= 0.999 and torch.allclose(got, want, atol=atol, rtol=1e-2)
        extra += f" min_row_cos={cos:.6f}"
        if core:
            differ, ulps = ulp_stats(got, want)
            ok = ok and differ <= CORE_DIFFER and ulps <= ulps_bar
            extra += f" differ={differ:.5f} worst={ulps:g} ulp of the row max"
    print(f"  {label}: max_abs_err={err:.3e}{extra} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: kernel disagrees with its plain version")
    return err


def make_case(B, S, W, gen):
    dev = "cuda"

    def rnd(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen) * std).to(dev)

    x = rnd(B * S, W)
    ln = {"scale": 1 + rnd(W, std=0.1), "bias": rnd(W, std=0.05)}
    attn = {"qkv": {"kernel": rnd(W, 3 * W, std=W ** -0.5), "bias": rnd(3 * W, std=0.02)},
            "out": {"kernel": rnd(W, W, std=W ** -0.5), "bias": rnd(W, std=0.02)}}
    return x, ln, attn


def kernel_phase(att):
    worst = {k: 0.0 for k in KERNELS}
    timed = {}
    gen = torch.Generator().manual_seed(0)
    for name, B, S, W, heads, causal, s_valid in CASES:
        x32, ln, attn = make_case(B, S, W, gen)
        for dtype in (torch.float32, torch.bfloat16):
            print(f"[kernels] {name} B={B} S={S} W={W} heads={heads} "
                  f"causal={causal} s_valid={s_valid} {str(dtype)[6:]}")
            x = x32.to(dtype)
            wqkv = attn["qkv"]["kernel"].to(dtype)
            wout = attn["out"]["kernel"].to(dtype)
            bqkv, bout = attn["qkv"]["bias"], attn["out"]["bias"]
            h = att.layer_norm_rows_reference(x, ln["scale"], ln["bias"])
            qkv = att.gemm_bias_residual_reference(h, wqkv, bqkv)
            ctx = att.attn_core_reference(qkv, S, heads, causal, s_valid)
            calls = {
                "ln_rows": (lambda: att.ln_rows(x, ln["scale"], ln["bias"]),
                            lambda: att.layer_norm_rows_reference(x, ln["scale"], ln["bias"])),
                "gemm_bias_residual": (
                    lambda: att.gemm_bias_residual(h, wqkv, bqkv),
                    lambda: att.gemm_bias_residual_reference(h, wqkv, bqkv)),
                "attn_core": (
                    lambda: att.attn_core(qkv, S, heads, causal, s_valid),
                    lambda: att.attn_core_reference(qkv, S, heads, causal, s_valid)),
                "gemm_bias_residual +residual (out-proj)": (
                    lambda: att.gemm_bias_residual(ctx, wout, bout, x),
                    lambda: att.gemm_bias_residual_reference(ctx, wout, bout, x)),
                "attention_sublayer": (
                    lambda: att.attention_sublayer(x, ln, attn, heads, causal, s_valid, S=S),
                    lambda: att.attention_sublayer_reference(x, ln, attn, heads, causal,
                                                             s_valid, S=S)),
            }
            for label, (kernel_fn, plain_fn) in calls.items():
                got = kernel_fn()
                torch.cuda.synchronize()  # a fault in the kernel shows here
                err = compare(label, got, plain_fn(), dtype, core=label in CORES)
                kname = label.split(" ")[0]
                if kname in worst:
                    worst[kname] = max(worst[kname], err)
                ms, plain_ms = in_turns(kernel_fn, plain_fn)
                print(f"  {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
                if name == TIMED_CASE and dtype == TIMED_DTYPE and label in KERNELS:
                    timed[label] = {"ms": ms, "plain_ms": plain_ms}
            if name == TIMED_CASE and dtype == TIMED_DTYPE:
                N, it = B * S, x.element_size()
                work = {  # (FLOPs, bytes, the one PyTorch call)
                    "ln_rows": (8 * N * W, 2 * N * W * it + 2 * W * 4, lambda: F.layer_norm(
                        x, (W,), ln["scale"].to(dtype), ln["bias"].to(dtype))),
                    "gemm_bias_residual": (
                        2 * N * W * 3 * W, (N * W + 3 * W * W + 3 * N * W) * it + 3 * W * 4,
                        lambda: torch.addmm(bqkv.to(dtype), h, wqkv)),
                    "attn_core": (4 * B * S * S * W, 4 * N * W * it,
                                  sdpa_forward(qkv, B, S, heads)),
                }
                for k, (flops, nbytes, fn) in work.items():
                    timed[k].update(yardstick(k, flops, nbytes, fn))
    return worst, timed


def synthetic_images(n: int, seed: int = 0, size: int = 256) -> np.ndarray:
    """Smooth colour fields with noise: images that differ from each other."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / (size - 1)
    base = rng.uniform(0, 255, (n, 1, 1, 3)).astype(np.float32)
    tilt = rng.uniform(-120, 120, (n, 2, 1, 1, 3)).astype(np.float32)
    img = base + tilt[:, 0] * yy[None, :, :, None] + tilt[:, 1] * xx[None, :, :, None]
    img += rng.normal(0, 12, img.shape).astype(np.float32)
    return np.clip(img, 0, 255).astype(np.uint8)


def row_cos(a, b):
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def against_plain(model, images, plain, counts, img, txt, cos_bar, same_argmax, batch,
                  tag):
    """Hold the kernel path's embeddings and zero-shot argmax against the same
    model run through the plain versions; return the kernel path's labels.
    ``counts``: the LAUNCHES dicts the plain run must leave as they are."""
    launches = [dict(c) for c in counts]
    with plain:
        img_ref = model.encode_images(images, batch_size=batch)
        txt_ref = model.encode_text(PROMPTS)
    if [dict(c) for c in counts] != launches:
        raise AssertionError("the plain run launched a CUDA kernel")
    ci, ct = row_cos(img, img_ref).min(), row_cos(txt, txt_ref).min()
    print(f"{tag} kernels vs plain versions: image row cosine min {ci:.7f}, "
          f"text row cosine min {ct:.7f} (bar {cos_bar})")
    if ci < cos_bar or ct < cos_bar:
        raise AssertionError("embeddings disagree with the plain path")
    # zero_shot_classification's scores: images normalized, texts not
    sim = model._cosine_similarity(img, txt)
    sim_ref = model._cosine_similarity(img_ref, txt_ref)
    pred, pred_ref = sim.argmax(-1), sim_ref.argmax(-1)
    srt = np.sort(sim_ref, axis=-1)
    differ = int((pred != pred_ref).sum())
    print(f"{tag} zero-shot: {np.unique(pred_ref).size} distinct labels, smallest "
          f"top-2 score gap {(srt[:, -1] - srt[:, -2]).min():.3e}, largest "
          f"|score - score_plain| {np.abs(sim - sim_ref).max():.3e}, argmax differs "
          f"on {differ}/{len(pred)} images")
    if same_argmax and differ:
        raise AssertionError("zero-shot argmax differs from the plain path")
    return pred


def rate(fn, n, reps=3):
    """n items over the median host-clock time of ``fn`` (synchronized)."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    return n / statistics.median(times)


def serving_phase(arch, batch, core, fp32, att, mha, layers, PLIP):
    """Steps 3 and 6 for one architecture: (the launches of its run, the
    model's tokenizer)."""
    t0 = time.perf_counter()
    model = PLIP(f"random:{arch}", dtype=torch.bfloat16, device="cuda")
    cfg = model.cfg
    tag = f"[serving {arch}]"
    print(f"{tag} built in {time.perf_counter() - t0:.2f} s: vision S={cfg.vision.seq_len} "
          f"W={cfg.vision.width} {cfg.vision.layers} layers, text W={cfg.text.width} "
          f"{cfg.text.layers} layers, images in batches of {batch}")
    images = synthetic_images(64)
    counts = (att.LAUNCHES, mha.LAUNCHES)
    plain = plain_towers(att, mha, layers)
    model.encode_images(images, batch_size=batch)  # warm-up: cuBLAS, allocator
    model.encode_text(PROMPTS)
    torch.cuda.synchronize()

    att.reset_launch_counts()
    mha.reset_launch_counts()
    img = model.encode_images(images, batch_size=batch)
    torch.cuda.synchronize()
    encode = {**att.LAUNCHES, **mha.LAUNCHES}
    txt = model.encode_text(PROMPTS)
    labels = model.zero_shot_classification(images, PROMPTS, batch_size=batch)
    model.build_image_index(images, batch_size=batch)
    top = model.retrieval(PROMPTS, top_k=5)
    torch.cuda.synchronize()
    launches = {**att.LAUNCHES, **mha.LAUNCHES}
    print(f"{tag} kernel launches: the first encode_images {encode}; the whole run "
          f"{launches}")
    want = cfg.vision.layers * -(-len(images) // batch)
    if encode[core] != want:
        raise AssertionError(f"{core} launched {encode[core]} times by one encode, "
                             f"expected {want} (one a layer and batch)")
    for k in KERNELS:
        if launches[k] == 0:
            raise AssertionError(f"{k} was never launched by the {arch} run")
    dim = cfg.embed_dim
    if img.shape != (64, dim) or txt.shape != (8, dim):
        raise AssertionError(f"embedding shapes {img.shape}, {txt.shape}")
    if not (np.isfinite(img).all() and np.isfinite(txt).all()):
        raise AssertionError("non-finite embeddings")
    if len(labels) != 64 or not set(labels) <= set(PROMPTS):
        raise AssertionError("zero-shot labels malformed")
    if top.shape != (8, 5) or top.min() < 0 or top.max() >= 64:
        raise AssertionError(f"retrieval indices malformed: {top.shape}")
    pred = against_plain(model, images, plain, counts, img, txt, 0.999, False, batch,
                         tag + " bf16")
    if [PROMPTS[i] for i in pred] != labels:
        raise AssertionError("zero_shot_classification disagrees with the embeddings")
    if fp32:  # the same weights, fp32 compute: summation order only
        model.dtype = torch.float32
        img32 = model.encode_images(images, batch_size=batch)
        against_plain(model, images, plain, counts, img32, model.encode_text(PROMPTS),
                      0.9999, True, batch, tag + " fp32")
    tokenizer = model.tokenizer
    del model
    torch.cuda.empty_cache()
    return launches, tokenizer


# ---------------------------------------------------------------------------
# Training (K2)
# ---------------------------------------------------------------------------


def leaves(tree):
    """Flatten nested tuples/dicts of tensors into a list of (name, tensor)."""
    if isinstance(tree, torch.Tensor):
        return [("", tree)]
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    return [(f"{k}.{n}".rstrip("."), t) for k, v in items for n, t in leaves(v)]


def backward_kernel_phase(att, bwd):
    worst = {k: 0.0 for k in BWD_KERNELS}
    timed = {}
    gen = torch.Generator().manual_seed(1)
    for name, B, S, W, heads, causal, s_valid in CASES[:3] + TRAIN_CASES:
        x32, ln, attn = make_case(B, S, W, gen)
        g32 = torch.randn(B * S, W, generator=gen).to("cuda")
        for dtype in (torch.float32, torch.bfloat16):
            print(f"[backward kernels] {name} B={B} S={S} W={W} heads={heads} "
                  f"causal={causal} s_valid={s_valid} {str(dtype)[6:]}")
            x, g = x32.to(dtype), g32.to(dtype)
            wqkv = attn["qkv"]["kernel"].to(dtype)
            wout = attn["out"]["kernel"].to(dtype)
            h = att.layer_norm_rows_reference(x, ln["scale"], ln["bias"])
            qkv = att.gemm_bias_residual_reference(h, wqkv, attn["qkv"]["bias"])
            dctx = bwd.grad_gemm_nt_reference(g, wout, dtype)
            ctx, dqkv = bwd.attn_core_bwd_reference(qkv, dctx, S, heads, causal, s_valid)
            dln = bwd.grad_gemm_nt_reference(dqkv, wqkv, torch.float32)
            calls = {
                "grad_gemm NT (dctx = g . Wout^T)": (
                    lambda: bwd.grad_gemm_nt(g, wout, dtype),
                    lambda: bwd.grad_gemm_nt_reference(g, wout, dtype)),
                "grad_gemm NT (dln = dqkv . Wqkv^T)": (
                    lambda: bwd.grad_gemm_nt(dqkv, wqkv, torch.float32),
                    lambda: bwd.grad_gemm_nt_reference(dqkv, wqkv, torch.float32)),
                "grad_gemm TN (dWout = ctx^T . g)": (
                    lambda: bwd.grad_gemm_tn(ctx, g),
                    lambda: bwd.grad_gemm_tn_reference(ctx, g)),
                "grad_gemm TN (dWqkv = ln^T . dqkv)": (
                    lambda: bwd.grad_gemm_tn(h, dqkv),
                    lambda: bwd.grad_gemm_tn_reference(h, dqkv)),
                "attn_core_bwd": (
                    lambda: bwd.attn_core_bwd(qkv, dctx, S, heads, causal, s_valid),
                    lambda: bwd.attn_core_bwd_reference(qkv, dctx, S, heads, causal,
                                                        s_valid)),
                "ln_bwd_rows": (
                    lambda: bwd.ln_bwd_rows(x, dln, g, ln["scale"]),
                    lambda: bwd.ln_bwd_rows_reference(x, dln, g, ln["scale"])),
                "col_sum (dbqkv)": (lambda: bwd.col_sum(dqkv),
                                    lambda: bwd.col_sum_reference(dqkv)),
                "attention_sublayer_bwd": (
                    lambda: bwd.attention_sublayer_bwd(x, g, ln, attn, S, heads, causal,
                                                       s_valid),
                    lambda: bwd.attention_sublayer_bwd_reference(x, g, ln, attn, S, heads,
                                                                 causal, s_valid)),
            }
            for label, (kernel_fn, plain_fn) in calls.items():
                got = kernel_fn()
                torch.cuda.synchronize()  # a fault in the kernel shows here
                for (leaf, want), (_, t) in zip(leaves(plain_fn()), leaves(got)):
                    summed = label in SUMMED or (label in SUMMED_PARTS and leaf != "0")
                    err = compare(f"{label} {leaf}".rstrip(), t, want, dtype, summed)
                    kname = label.split(" ")[0]
                    if kname in worst:
                        worst[kname] = max(worst[kname], err)
                ms, plain_ms = in_turns(kernel_fn, plain_fn)
                print(f"  {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
                kname = label.split(" ")[0]
                if (name == TIMED_CASE and dtype == TIMED_DTYPE
                        and BWD_TIMED.get(kname) == label):
                    timed[kname] = {"ms": ms, "plain_ms": plain_ms}
            if name == TIMED_CASE and dtype == TIMED_DTYPE:
                N, it = B * S, x.element_size()
                work = {  # (FLOPs, bytes, the one PyTorch call)
                    "grad_gemm": (2 * N * W * 3 * W, 4 * N * W * it + 3 * W * W * 4,
                                  lambda: torch.matmul(h.t(), dqkv)),
                    "attn_core_bwd": (12 * B * S * S * W, 8 * N * W * it,
                                      sdpa_backward(qkv, dctx, B, S, heads)),
                    "ln_bwd_rows": (10 * N * W,
                                    N * W * (3 * it + 4) + W * 4 + -(-N // 8) * 2 * W * 4,
                                    layer_norm_backward(x, ln["scale"], ln["bias"], dln)),
                    "col_sum": (3 * N * W, 3 * N * W * it + 3 * W * 4,
                                lambda: dqkv.sum(0, dtype=torch.float32)),
                }
                for k, (flops, nbytes, fn) in work.items():
                    timed[k].update(yardstick(k, flops, nbytes, fn))
    return worst, timed


def train_batch(tokenizer, cfg, n, seed=0):
    """n synthetic image-caption pairs, preprocessed on the card."""
    from plip_tpu_torch.ops.preprocess import preprocess_images

    pixels = preprocess_images(list(synthetic_images(n, seed)), cfg.vision.image_size,
                               device="cuda")
    captions = [PROMPTS[i % len(PROMPTS)] + f", case {i}" for i in range(n)]
    ids = tokenizer.tokenize(captions, cfg.text.context_length)
    return pixels, torch.as_tensor(ids, dtype=torch.long, device="cuda")


def leaf_cosine(a, b) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    na, nb = a.norm().item(), b.norm().item()
    if na == 0 and nb == 0:
        return 1.0
    return (a @ b).item() / (na * nb)


def train_step_check(layers, att, tokenizer):
    """(b): one train step's loss and grads, kernel path against plain."""
    from plip_tpu_torch.models.clip import CLIP
    from plip_tpu_torch.models.config import CLIPConfig
    from plip_tpu_torch.train.contrastive import clip_loss

    cfg = CLIPConfig.vit_b32()
    model = CLIP(cfg).init_params(torch.Generator().manual_seed(0)).to("cuda")
    pixels, ids = train_batch(tokenizer, cfg, 32)
    plain = Patched(mock.patch.object(layers, "attention_sublayer",
                                      att.attention_sublayer_reference), *plain_layer_norm())
    worst_by_dtype = {}
    for dtype, bar in ((torch.float32, 0.9999), (torch.bfloat16, 0.995)):
        def step():
            model.zero_grad(set_to_none=True)
            loss, _ = clip_loss(model, pixels, ids, dtype)
            loss.backward()
            return loss.item(), {k: p.grad.clone() for k, p in model.named_parameters()}

        loss, got = step()
        with plain:
            loss_ref, want = step()
        cos = {k: leaf_cosine(got[k], want[k]) for k in want}
        worst = min(cos, key=cos.get)
        rel = abs(loss - loss_ref) / abs(loss_ref)
        tag = f"[train step {str(dtype)[6:]}]"
        print(f"{tag} ViT-B/32 12+12 layers, batch 32: loss {loss:.6f} kernels, "
              f"{loss_ref:.6f} plain (rel {rel:.2e}); {len(cos)} grad leaves, worst "
              f"cosine {cos[worst]:.7f} at {worst} (norm {got[worst].norm():.4e} "
              f"kernels, {want[worst].norm():.4e} plain; bar {bar})")
        if not all(torch.isfinite(t).all() for t in got.values()):
            raise AssertionError("non-finite grads on the kernel path")
        if cos[worst] < bar or (dtype == torch.float32 and rel > 1e-5):
            raise AssertionError(f"{tag}: kernel path disagrees with the plain path")
        worst_by_dtype[str(dtype)[6:]] = (worst, cos[worst])
    model.zero_grad(set_to_none=True)
    return worst_by_dtype


def tuner_phase(counted, model_type="ViT-B/32", batch=TRAIN_BATCH, steps=TRAIN_STEPS,
                remat="mlp", need=KERNELS + BWD_KERNELS):
    """(c) and step 9: the tuner in bf16 for one epoch of ``steps`` steps at
    ``batch``; returns it and the launches of the modules ``counted``."""
    from plip_tpu_torch.train.clip_tuner import CLIPTuner
    from plip_tpu_torch.utils.checkpoint import load_checkpoint

    out_dir = os.path.join(ROOT, "build", "chip_smoke")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    images = list(synthetic_images(256, seed=1))
    n = steps * batch
    train = {"image": [images[i % len(images)] for i in range(n)],
             "caption": [f"{PROMPTS[i % 8]}, tile {i}" for i in range(n)]}
    valid = {"image": images[:batch],
             "caption": [f"{PROMPTS[i % 8]}, slide {i}" for i in range(batch)]}
    records = []
    log = SimpleNamespace(info=lambda msg, *a: records.append(msg % a if a else msg),
                          warning=lambda msg, *a: records.append(msg % a if a else msg))
    tag = f"[tuner {model_type}]"
    tuner = CLIPTuner(args=SimpleNamespace(first_resize=256, pxsize=224), logging=log,
                      model_type=model_type, lr=1e-5, warmup=2, dtype=torch.bfloat16,
                      device="cuda", remat=remat)
    torch.cuda.synchronize()
    for m in counted:
        m.reset_launch_counts()
    t0 = time.perf_counter()
    suffix = tuner.tuner(train, valid, save_directory=out_dir, batch_size=batch,
                         epochs=1, evaluation_steps=0, num_workers=8, start_time="smoke")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for m in counted for k, v in m.LAUNCHES.items()}
    losses = [float(r.rsplit("loss: ", 1)[1]) for r in records
              if "[Train - this batch]" in r]
    print(f"{tag} {len(losses)} steps at batch {batch} bf16, remat {remat!r}, in "
          f"{wall:.2f} s (data, augment, validation, checkpoint included); losses "
          f"{[round(x, 4) for x in losses]}")
    print(f"{tag} {[r for r in records if 'Validation - final' in r]}")
    print(f"{tag} kernel launches in the tuner run: {launches}")
    if len(losses) != steps or not np.isfinite(losses).all():
        raise AssertionError(f"tuner losses {losses}")
    for k in need:
        if launches[k] == 0:
            raise AssertionError(f"{k} was never launched by the tuner run")
    sd, _ = load_checkpoint(os.path.join(out_dir, f"epoch_0{suffix}"))
    for k, v in tuner.model.state_dict().items():
        if not torch.equal(sd[k], v.cpu()):
            raise AssertionError(f"epoch checkpoint: {k} differs from the model")
    print(f"{tag} epoch checkpoint epoch_0{suffix} reloads: {len(sd)} tensors equal")
    shutil.rmtree(out_dir)
    return tuner, launches


def fixed_batch_phase(tuner):
    """(d): 8 steps on one batch lower its loss."""
    from plip_tpu_torch.train.contrastive import (init_train_state, make_optimizer,
                                                  make_train_step)

    pixels, ids = train_batch(tuner.tokenizer, tuner.cfg, 32, seed=2)
    opt = make_optimizer(base_lr=2e-5, warmup=2, total_steps=8)
    step = make_train_step(tuner.cfg, opt, dtype=torch.bfloat16)
    state = init_train_state(tuner.model, opt)
    losses = []
    for _ in range(8):
        state, metrics = step(state, pixels, ids)
        losses.append(float(metrics["loss"]))
    print(f"[fixed batch] 8 steps, batch 32 bf16: losses {[round(x, 4) for x in losses]}")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError("8 steps on one batch did not lower its loss")


# ---------------------------------------------------------------------------
# The wide towers (K3, K5, K1's widened core)
# ---------------------------------------------------------------------------


def schedule_faults(att, mha, plain_fn):
    """{fault: plain_fn's output with that fault in the deferred-divide
    softmax}: the controls that the bf16 core bar must reject."""
    exact = att.softmax_pv_reference

    def swapped(logits, v, dt, defer):  # normalize-first, P cast after the divide
        return exact(logits, v, dt, not defer)

    def cast_sum(logits, v, dt, defer):  # the row sum of the cast P
        e = torch.exp(logits - logits.amax(-1, keepdim=True)).to(dt).float()
        return (torch.matmul(e, v.float()) / e.sum(-1, keepdim=True)).to(dt)

    out = {}
    for fault, fn in (("normalize-first", swapped), ("row sum of the cast P", cast_sum)):
        with mock.patch.object(att, "softmax_pv_reference", fn), \
                mock.patch.object(mha, "softmax_pv_reference", fn):
            out[fault] = plain_fn()
    return out


def wide_kernel_phase(att, mha):
    """Step 5: each core against its plain version at the wide shapes (all
    past DEFER_ABOVE, so the deferred divide), and the bar's controls."""
    calls = {"mha_core": (mha.mha_core, mha.mha_core_reference),
             "flash_core": (lambda q, S, h, c, sv: mha.flash_core(q, S, h, c),
                            lambda q, S, h, c, sv: mha.flash_core_reference(q, S, h, c)),
             "attn_core": (att.attn_core, att.attn_core_reference)}
    worst = {"mha_core": 0.0, "flash_core": 0.0, "attn_core": 0.0}
    timed = {}
    gen = torch.Generator().manual_seed(2)
    for name, core, B, S, W, heads, causal, s_valid in WIDE_CASES:
        qkv32 = torch.randn(B * S, 3 * W, generator=gen).to("cuda")
        kernel, plain = calls[core]
        for dtype in (torch.float32, torch.bfloat16):
            qkv = qkv32.to(dtype)
            if core != "attn_core":
                qkv = qkv.view(B, S, 3 * W)
            print(f"[wide kernels] {core} {name} B={B} S={S} W={W} heads={heads} "
                  f"causal={causal} s_valid={s_valid} {str(dtype)[6:]}")
            got = kernel(qkv, S, heads, causal, s_valid)
            torch.cuda.synchronize()  # a fault in the kernel shows here
            want = plain(qkv, S, heads, causal, s_valid)
            err = compare(core, got.reshape(B * S, W), want.reshape(B * S, W), dtype,
                          core=True)
            worst[core] = max(worst[core], err)
            if dtype == torch.bfloat16:
                faults = schedule_faults(att, mha, lambda: plain(qkv, S, heads, causal,
                                                                 s_valid))
                for fault, bad in faults.items():
                    differ, ulps = ulp_stats(got.reshape(B * S, W), bad.reshape(B * S, W))
                    print(f"  control, plain version with {fault}: differ={differ:.5f} "
                          f"worst={ulps:g} ulp of the row max")
                    if differ <= CORE_DIFFER and ulps <= 1:
                        raise AssertionError(f"{core}: the bf16 bar does not reject {fault}")
            ms, plain_ms = in_turns(lambda: kernel(qkv, S, heads, causal, s_valid),
                                    lambda: plain(qkv, S, heads, causal, s_valid))
            flops = 4 * B * S * S * W
            print(f"  {core}: kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), "
                  f"plain {plain_ms:.4f} ms")
            if dtype == torch.bfloat16:
                y = core_line(f"{core} {name}", ms, plain_ms, flops,
                              4 * B * S * W * qkv.element_size(), sdpa_forward(qkv, B, S, heads))
                if core not in timed:
                    timed[core] = {"ms": ms, "plain_ms": plain_ms, **y}
    return worst, timed


# ---------------------------------------------------------------------------
# Training the wide towers (K4, K1 and K2 key-tiled, the hybrid)
# ---------------------------------------------------------------------------


def wide_backward_phase(att, bwd, mha):
    """Step 7: the key-tiled core backwards and K1's key-tiled core against
    their plain versions, the bar's controls, times beside the bounds."""
    worst = {"mha_core_bwd": 0.0, "attn_core_bwd": 0.0, "attn_core": 0.0}
    timed = {}
    gen = torch.Generator().manual_seed(3)
    for name, core, B, S, W, heads, causal, s_valid in WIDE_BWD_CASES:
        qkv32 = torch.randn(B * S, 3 * W, generator=gen).to("cuda")
        g32 = torch.randn(B * S, W, generator=gen).to("cuda")
        args = (S, heads, causal, s_valid)
        pairs = att.keep_mask(S, causal, s_valid, "cpu").sum().item()  # kept (row, key)
        if core == "mha_core_bwd":  # dots: q.k, dv, dp, dq, dk; qkv and g in, dqkv out
            kernel = lambda: (mha.mha_core_bwd(qkv, g, *args),)
            plain = lambda: (mha.mha_core_bwd_reference(qkv, g, *args),)
            other = lambda: {"the deferred schedule": bwd.attn_core_bwd_reference(
                qkv, g, *args)[1]}
            outputs, dots, io = ("dqkv",), 5, 7
            ulps_bar = {"dqkv": BWD_ULPS}
        elif core == "attn_core_bwd":  # also ctx: one more dot, W more out
            kernel = lambda: bwd.attn_core_bwd(qkv, g, *args)
            plain = lambda: bwd.attn_core_bwd_reference(qkv, g, *args)
            other = lambda: {"normalize-first": mha.mha_core_bwd_reference(qkv, g, *args)}
            outputs, dots, io = ("ctx", "dqkv"), 6, 8
            ulps_bar = {"ctx": 1, "dqkv": BWD_ULPS}
        else:
            kernel = lambda: (att.attn_core(qkv, *args),)
            plain = lambda: (att.attn_core_reference(qkv, *args),)
            other = lambda: schedule_faults(att, mha, lambda: att.attn_core_reference(qkv, *args))
            outputs, dots, io = ("ctx",), 2, 4
            ulps_bar = {"ctx": 1}
        for dtype in (torch.float32, torch.bfloat16):
            qkv, g = qkv32.to(dtype), g32.to(dtype)
            print(f"[wide backward kernels] {core} {name} B={B} S={S} W={W} heads={heads} "
                  f"causal={causal} s_valid={s_valid} {str(dtype)[6:]}")
            got = kernel()
            torch.cuda.synchronize()  # a fault in the kernel shows here
            for label, t, want in zip(outputs, got, plain()):
                err = compare(f"{core} {label}", t.reshape(B * S, -1), want.reshape(B * S, -1),
                              dtype, core=True, ulps_bar=ulps_bar[label])
                worst[core] = max(worst[core], err)
            if dtype == torch.bfloat16:
                for fault, bad in other().items():
                    differ, ulps = ulp_stats(got[-1].reshape(B * S, -1), bad.reshape(B * S, -1))
                    print(f"  control, plain version with {fault}: differ={differ:.5f} "
                          f"worst={ulps:g} ulp of the row max")
                    if differ <= CORE_DIFFER and ulps <= ulps_bar[outputs[-1]]:
                        raise AssertionError(f"{core}: the bf16 bar does not reject {fault}")
            ms, plain_ms = in_turns(kernel, plain)
            flops, nbytes = 2 * dots * pairs * B * W, io * B * S * W * qkv.element_size()
            bound_ms, bound_by = bound(flops, nbytes, PEAK_FLOPS)
            print(f"  {core}: kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain "
                  f"{plain_ms:.4f} ms; bound {bound_ms:.4f} ms ({bound_by}), the kernel at "
                  f"{bound_ms / ms:.2%} of it")
            if dtype == torch.bfloat16:
                y = core_line(f"{core} {name}", ms, plain_ms, flops, nbytes,
                              sdpa_forward(qkv, B, S, heads) if core == "attn_core"
                              else sdpa_backward(qkv, g, B, S, heads))
                if core == "mha_core_bwd" and core not in timed:
                    timed[core] = {"ms": ms, "plain_ms": plain_ms, **y}
    return worst, timed


def wide_train_phase(att, bwd, mha, tokenizer):
    """Step 8: one full-depth train step of each wide (architecture, remat)
    against the same autograd functions on the plain versions. Returns the
    launches of the ViT-L/14 remat=False bf16 step, mha_core_bwd's path."""
    from plip_tpu_torch.models.clip import CLIP
    from plip_tpu_torch.models.config import ARCHITECTURES
    from plip_tpu_torch.train.contrastive import (clip_loss, init_train_state,
                                                  make_optimizer, make_train_step)

    counted = (att, bwd, mha)
    plain = PlainVersions(*counted)
    k4_path = None

    def counts():
        return {k: v for m in counted for k, v in m.LAUNCHES.items()}

    for arch in dict.fromkeys(a for a, _ in WIDE_TRAIN):
        t0 = time.perf_counter()
        cfg = ARCHITECTURES[arch]()
        model = CLIP(cfg).init_params(torch.Generator().manual_seed(0)).to("cuda")
        pixels, ids = train_batch(tokenizer, cfg, WIDE_TRAIN_BATCH, seed=5)
        print(f"[wide train {arch}] built in {time.perf_counter() - t0:.2f} s: vision "
              f"S={cfg.vision.seq_len} W={cfg.vision.width} {cfg.vision.layers} layers, "
              f"text W={cfg.text.width} {cfg.text.layers} layers, batch {WIDE_TRAIN_BATCH}")
        for remat in [r for a, r in WIDE_TRAIN if a == arch]:
            for dtype, bar in ((torch.float32, 0.9999), (torch.bfloat16, 0.995)):
                def step():
                    model.zero_grad(set_to_none=True)
                    loss, _ = clip_loss(model, pixels, ids, dtype, remat)
                    loss.backward()
                    return loss.item(), {k: p.grad.clone() for k, p in model.named_parameters()}

                torch.cuda.synchronize()
                for m in counted:
                    m.reset_launch_counts()
                loss, got = step()
                torch.cuda.synchronize()
                launches = counts()
                with plain:
                    loss_ref, want = step()
                if counts() != launches:
                    raise AssertionError("the plain run launched a CUDA kernel")
                cos = {k: leaf_cosine(got[k], want[k]) for k in want}
                worst = min(cos, key=cos.get)
                rel = abs(loss - loss_ref) / abs(loss_ref)
                tag = f"[wide train {arch} remat={remat!r} {str(dtype)[6:]}]"
                print(f"{tag} loss {loss:.6f} kernels, {loss_ref:.6f} plain (rel {rel:.2e}); "
                      f"{len(cos)} grad leaves, worst cosine {cos[worst]:.7f} at {worst} "
                      f"(bar {bar}); launches {launches}")
                if not all(torch.isfinite(t).all() for t in got.values()):
                    raise AssertionError("non-finite grads on the kernel path")
                if cos[worst] < bar or (dtype == torch.float32 and rel > 1e-5):
                    raise AssertionError(f"{tag}: kernel path disagrees with the plain path")
                for k in WIDE_TRAIN[arch, remat]:
                    if launches[k] == 0:
                        raise AssertionError(f"{tag}: {k} was never launched")
                if remat is False and "flash_core" in WIDE_TRAIN[arch, remat]:
                    text = cfg.text.layers
                    print(f"{tag} the vision core's backward is the VJP of the JAX package's "
                          f"_jnp_mha (its own path above 512 tokens, no Pallas kernel): it "
                          f"launches no hand-written kernel (mha_core_bwd "
                          f"{launches['mha_core_bwd']}, attn_core_bwd "
                          f"{launches['attn_core_bwd']} = the {text} text layers)")
                    if launches["mha_core_bwd"] or launches["attn_core_bwd"] != text:
                        raise AssertionError(f"{tag}: the flash backward launched a kernel")
                if (arch, remat, dtype) == ("ViT-L/14", False, torch.bfloat16):
                    k4_path = launches
                del got, want
        model.zero_grad(set_to_none=True)
        opt = make_optimizer(base_lr=1e-6, warmup=1, total_steps=10)
        state, losses = init_train_state(model, opt), {}
        for remat in (False, "mlp", True):
            step_fn = make_train_step(cfg, opt, dtype=torch.bfloat16, remat=remat)
            state, metrics = step_fn(state, pixels, ids)
            losses[repr(remat)] = round(float(metrics["loss"]), 6)
        print(f"[wide train {arch}] make_train_step, bf16, batch {WIDE_TRAIN_BATCH}, one "
              f"step under each remat: losses {losses}")
        if not np.isfinite(list(losses.values())).all():
            raise AssertionError(f"{arch}: non-finite train-step loss")
        del state, model
        torch.cuda.empty_cache()
        print(f"[wide train {arch}] {time.perf_counter() - t0:.1f} s")
    return k4_path


# ---------------------------------------------------------------------------
# remat="block" (K7, and the MLP half's K8 and K9)
# ---------------------------------------------------------------------------


def block_params(W, gen):
    """A block's fp32 parameters on the card (the JAX package's tree)."""
    def r(*shape, std=1.0, mean=0.0):
        return (mean + torch.randn(*shape, generator=gen) * std).to("cuda")

    return {"ln1": {"scale": r(W, std=0.1, mean=1.0), "bias": r(W, std=0.05)},
            "attn": {"qkv": {"kernel": r(W, 3 * W, std=W ** -0.5), "bias": r(3 * W, std=0.02)},
                     "out": {"kernel": r(W, W, std=W ** -0.5), "bias": r(W, std=0.02)}},
            "ln2": {"scale": r(W, std=0.1, mean=1.0), "bias": r(W, std=0.05)},
            "mlp": {"fc1": {"kernel": r(W, 4 * W, std=W ** -0.5), "bias": r(4 * W, std=0.02)},
                    "fc2": {"kernel": r(4 * W, W, std=(4 * W) ** -0.5),
                            "bias": r(W, std=0.02)}}}


class ChainSpy:
    """While entered, records the inputs and outputs of the kernel chain's
    activation (gemm_bias_gelu), its VJP (gemm_nt_gelu_bwd) and the core
    backward (mha_core_bwd) in ``ops.mlp.KERNEL_FNS`` and
    ``ops.block_bwd._ATTN_KERNELS``."""

    def __init__(self, mlpm, blk):
        self.seen = {}
        fns, attn = list(mlpm.KERNEL_FNS), list(blk._ATTN_KERNELS)
        for tup, i, name in ((fns, 1, "gelu"), (fns, 2, "gelu_bwd"), (attn, 3, "core_bwd")):
            tup[i] = self._wrap(name, tup[i])
        self.patches = [mock.patch.object(mlpm, "KERNEL_FNS", tuple(fns)),
                        mock.patch.object(blk, "KERNEL_FNS", tuple(fns)),
                        mock.patch.object(blk, "_ATTN_KERNELS", tuple(attn))]

    def _wrap(self, name, fn):
        def spy(*args):
            out = fn(*args)
            self.seen[name] = (args, out)
            return out
        return spy

    def __enter__(self):
        for p in self.patches:
            p.start()
        return self

    def __exit__(self, *exc):
        for p in reversed(self.patches):
            p.stop()


def rounding_points(seen, gelu, gelu_bwd, core_bwd):
    """[(name, kernel output, plain output on the same inputs, ulps bar)] of
    the chain's rounding points that ``seen`` recorded."""
    rows = []
    if "gelu" in seen:
        args, (h1, act) = seen["gelu"]
        want_h1, want_act = gelu(*args)
        rows += [("h1", h1, want_h1, 1)] if h1 is not None else []  # K9 keeps no h1
        rows.append(("activation", act, want_act, ACT_ULPS))
    if "gelu_bwd" in seen:
        args, dh1 = seen["gelu_bwd"]
        rows.append(("dh1", dh1, gelu_bwd(*args), 1))
    if "core_bwd" in seen:
        args, dqkv = seen["core_bwd"]
        rows.append(("core backward dqkv", dqkv, core_bwd(*args), BWD_ULPS))
    return rows


def block_yardsticks(x, g, p, S, heads, causal):
    """PyTorch calls beside the kernels (never used by the port): the
    autograd backward of the same block, and of its MLP half, built from
    F.layer_norm, F.linear and SDPA; the MLP half's forward; torch.addmm and
    torch.matmul for the two GEMMs."""
    dt, (N, W) = x.dtype, x.shape
    B, D = N // S, W // heads
    leaf = lambda t: t.detach().to(dt).contiguous().requires_grad_()
    xl = leaf(x)
    ln1s, ln1b, ln2s, ln2b = (leaf(p[a][b]) for a in ("ln1", "ln2") for b in ("scale", "bias"))
    wq, bq = leaf(p["attn"]["qkv"]["kernel"].t()), leaf(p["attn"]["qkv"]["bias"])
    wo, bo = leaf(p["attn"]["out"]["kernel"].t()), leaf(p["attn"]["out"]["bias"])
    w1, b1 = leaf(p["mlp"]["fc1"]["kernel"].t()), leaf(p["mlp"]["fc1"]["bias"])
    w2, b2 = leaf(p["mlp"]["fc2"]["kernel"].t()), leaf(p["mlp"]["fc2"]["bias"])
    mlp_leaves = [xl, ln2s, ln2b, w1, b1, w2, b2]

    def mlp_half(h):
        z = F.linear(F.layer_norm(h, (W,), ln2s, ln2b), w1, b1)
        return h + F.linear(z * torch.sigmoid(1.702 * z), w2, b2)

    def block(h):
        qkv = F.linear(F.layer_norm(h, (W,), ln1s, ln1b), wq, bq)
        q, k, v = qkv.view(B, S, 3, heads, D).permute(2, 0, 3, 1, 4).unbind(0)
        ctx = F.scaled_dot_product_attention(q, k, v, is_causal=causal)
        return mlp_half(h + F.linear(ctx.transpose(1, 2).reshape(N, W), wo, bo))

    out_b, out_m = block(xl), mlp_half(xl)
    ln2 = F.layer_norm(x, (W,), ln2s.detach(), ln2b.detach())
    w1c, w2c = p["mlp"]["fc1"]["kernel"].to(dt), p["mlp"]["fc2"]["kernel"].to(dt)

    def forward():
        with torch.no_grad():
            return mlp_half(xl)

    return {
        "block_bwd": lambda: torch.autograd.grad(
            out_b, mlp_leaves + [ln1s, ln1b, wq, bq, wo, bo], g, retain_graph=True),
        "mlp_bwd": lambda: torch.autograd.grad(out_m, mlp_leaves, g, retain_graph=True),
        "mlp_fwd": forward,
        "gemm_bias_gelu": lambda: torch.addmm(b1.detach(), ln2, w1c),
        "gemm_nt_gelu_bwd": lambda: torch.matmul(g, w2c.t()),
    }


def block_work(B, S, W, causal, it):
    """{kernel: (FLOPs, bytes)} of step 11's functions at [B, S, W] in a
    dtype of ``it`` bytes: each input read once, each output written once."""
    N, W4 = B * S, 4 * W
    pairs = S * (S + 1) // 2 if causal else S * S  # kept (row, key)
    mlp_w = 2 * W * W4 * it + (W4 + 3 * W) * 4  # weights, fp32 bias and LN
    mlp_g = (2 * W * W4 + W4 + 3 * W) * 4  # fp32 grads
    attn_w = 4 * W * W * it + 6 * W * 4
    attn_g = (4 * W * W + 6 * W) * 4
    return {
        "gemm_bias_gelu": (2 * N * W * W4, (N * W + W * W4 + 2 * N * W4) * it + W4 * 4),
        "gemm_nt_gelu_bwd": (2 * N * W * W4, (N * W + W * W4 + 2 * N * W4) * it),
        "mlp_fwd": (4 * N * W * W4, 2 * N * W * it + mlp_w),
        "mlp_bwd": (10 * N * W * W4, 3 * N * W * it + mlp_w + mlp_g),
        # recompute: qkv, core, out, fc1; backward: 4 MLP products, dWout and
        # dctx, the core's four dots, dWqkv and dln1
        "block_bwd": (2 * N * W * (3 * W + W + W4 + 4 * W4 + 2 * W + 6 * W)
                      + 12 * pairs * B * W,
                      3 * N * W * it + mlp_w + mlp_g + attn_w + attn_g),
    }


def block_kernel_phase(att, bwd, mha, mlpm, blk):
    """Step 11a."""
    worst = {k: 0.0 for k in BLOCK_REPLACES}
    timed = {}
    gen = torch.Generator().manual_seed(4)
    plain_rounding = (mlpm.gemm_bias_gelu_reference, mlpm.gemm_nt_gelu_bwd_reference,
                      mha.mha_core_bwd_reference)
    controls = {
        "K2's deferred core backward": (
            mlpm.gemm_bias_gelu_reference, mlpm.gemm_nt_gelu_bwd_reference,
            lambda *a: bwd.attn_core_bwd_reference(*a)[1]),
        "the composed forward's bf16 QuickGELU": (
            lambda a, w, b, keep_h=True: (
                att.gemm_bias_residual_reference(a, w, b),
                mlpm.quick_gelu(att.gemm_bias_residual_reference(a, w, b))),
            mlpm.gemm_nt_gelu_bwd_reference, mha.mha_core_bwd_reference)}
    for case, B, S, W, heads, causal in BLOCK_CASES:
        p = block_params(W, gen)
        N = B * S
        x32 = torch.randn(N, W, generator=gen).to("cuda")
        g32 = torch.randn(N, W, generator=gen).to("cuda")
        ln2, mp = p["ln2"], p["mlp"]
        for dtype in (torch.float32, torch.bfloat16):
            print(f"[block kernels] {case} B={B} S={S} W={W} heads={heads} causal={causal} "
                  f"{str(dtype)[6:]}")
            x, g = x32.to(dtype), g32.to(dtype)
            h = att.layer_norm_rows_reference(x, ln2["scale"], ln2["bias"])
            w1, b1 = mp["fc1"]["kernel"].to(dtype), mp["fc1"]["bias"]
            w2 = mp["fc2"]["kernel"].to(dtype)
            h1 = mlpm.gemm_bias_gelu_reference(h, w1, b1)[0]
            calls = {
                "gemm_bias_gelu": (lambda: mlpm.gemm_bias_gelu(h, w1, b1),
                                   lambda: mlpm.gemm_bias_gelu_reference(h, w1, b1)),
                "gemm_nt_gelu_bwd": (lambda: mlpm.gemm_nt_gelu_bwd(g, w2, h1),
                                     lambda: mlpm.gemm_nt_gelu_bwd_reference(g, w2, h1)),
                "mlp_fwd": (lambda: mlpm.mlp_fwd_flat(x, ln2, mp),
                            lambda: mlpm.mlp_fwd_reference(x, ln2, mp)),
                "mlp_bwd": (lambda: mlpm.mlp_bwd_flat(x, g, ln2, mp),
                            lambda: mlpm.mlp_bwd_reference(x, g, ln2, mp)),
                "block_bwd": (lambda: blk.block_bwd(x, g, p, S, heads, causal),
                              lambda: blk.block_bwd_reference(x, g, p, S, heads, causal)),
            }
            work = block_work(B, S, W, causal, x.element_size())
            sticks = (block_yardsticks(x, g, p, S, heads, causal)
                      if case == BLOCK_CASES[0][0] and dtype == torch.bfloat16 else {})
            for label, (kernel_fn, plain_fn) in calls.items():
                with ChainSpy(mlpm, blk) as spy:
                    got = kernel_fn()
                torch.cuda.synchronize()  # a fault in the kernel shows here
                for (leaf, want), (_, t) in zip(leaves(plain_fn()), leaves(got)):
                    tag = f"{label} {leaf}".rstrip()
                    if label.startswith("gemm"):  # leaf 1 of gemm_bias_gelu: the activation
                        err = compare(tag, t, want, dtype, core=True,
                                      ulps_bar=ACT_ULPS if tag == "gemm_bias_gelu 1" else 1)
                    else:  # K7's and K8's dx too: the end of a chain of sums (the doc)
                        err = compare(tag, t, want, dtype, summed=label != "mlp_fwd")
                        if dtype == torch.bfloat16 and leaf in ("", "0"):
                            differ, ulps = ulp_stats(t, want)
                            print(f"  {tag}: differ={differ:.5f} worst={ulps:g} ulp of the "
                                  f"row max (the chain's rounding noise; not a bar)")
                    worst[label] = max(worst[label], err)
                for point, t, want, ulps_bar in rounding_points(spy.seen, *plain_rounding):
                    compare(f"{label} rounding point {point}", t, want, dtype, core=True,
                            ulps_bar=ulps_bar)
                if dtype == torch.bfloat16 and label in ("block_bwd", "mlp_bwd"):
                    for control, fns in controls.items():
                        rows = rounding_points(spy.seen, *fns)
                        stats = [(n, *ulp_stats(t, w), u) for n, t, w, u in rows]
                        caught = [n for n, d, ul, u in stats if d > CORE_DIFFER or ul > u]
                        print(f"  control, plain version with {control}: rounding points "
                              + ", ".join(f"{n} differ={d:.5f} worst={ul:g}"
                                          for n, d, ul, _ in stats))
                        if label == "block_bwd" or "QuickGELU" in control:
                            if not caught:
                                raise AssertionError(f"{label}: the bar does not reject {control}")
                if dtype != torch.bfloat16:
                    continue
                iters = 10 if label in ("block_bwd", "mlp_bwd") else 30
                p1, k1, k2, p2 = (time_ms(f, iters) for f in (plain_fn, kernel_fn, kernel_fn,
                                                              plain_fn))
                ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
                flops, nbytes = work[label]
                bound_ms, bound_by = bound(flops, nbytes, PEAK_FLOPS)
                print(f"  {label}: kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain "
                      f"{plain_ms:.4f} ms; bound {bound_ms:.4f} ms ({bound_by}), the kernel at "
                      f"{bound_ms / ms:.2%} of it")
                if sticks:
                    timed[label] = {"ms": ms, "plain_ms": plain_ms,
                                    **yardstick(label, flops, nbytes, sticks[label])}
            del sticks
    return worst, timed


def block_train_phase(att, bwd, mha, mlpm, blk, tokenizer, cases=BLOCK_TRAIN):
    """Step 11b (and 12a's @336 step): {(architecture, dtype): (the launches
    of its "block" step, its worst grad leaf and that leaf's cosine)}."""
    from plip_tpu_torch.models.clip import CLIP
    from plip_tpu_torch.models.config import ARCHITECTURES
    from plip_tpu_torch.train.contrastive import (clip_loss, init_train_state,
                                                  make_optimizer, make_train_step)

    counted = (att, bwd, mha, mlpm, blk)
    plain = PlainVersions(*counted)
    results = {}

    def counts():
        return {k: v for m in counted for k, v in m.LAUNCHES.items()}

    def reset():
        torch.cuda.synchronize()
        for m in counted:
            m.reset_launch_counts()

    for arch, batch, dtypes, want_k7 in cases:
        t0 = time.perf_counter()
        cfg = ARCHITECTURES[arch]()
        model = CLIP(cfg).init_params(torch.Generator().manual_seed(0)).to("cuda")
        pixels, ids = train_batch(tokenizer, cfg, batch, seed=6)
        for dtype in dtypes:
            bar = 0.9999 if dtype == torch.float32 else 0.995

            def step(remat="block"):
                model.zero_grad(set_to_none=True)
                loss, _ = clip_loss(model, pixels, ids, dtype, remat)
                loss.backward()
                return loss.item(), {k: p.grad.clone() for k, p in model.named_parameters()}

            reset()
            loss, got = step()
            torch.cuda.synchronize()
            launches = counts()
            with plain:
                loss_ref, want = step()
            if counts() != launches:
                raise AssertionError("the plain run launched a CUDA kernel")
            cos = {k: leaf_cosine(got[k], want[k]) for k in want}
            worst = min(cos, key=cos.get)
            rel = abs(loss - loss_ref) / abs(loss_ref)
            tag = f"[block train {arch} batch {batch} {str(dtype)[6:]}]"
            print(f"{tag} remat 'block', full depth: loss {loss:.6f} kernels, {loss_ref:.6f} "
                  f"plain (rel {rel:.2e}); {len(cos)} grad leaves, worst cosine "
                  f"{cos[worst]:.7f} at {worst} (bar {bar}); launches {launches}")
            if not all(torch.isfinite(t).all() for t in got.values()):
                raise AssertionError("non-finite grads on the kernel path")
            if cos[worst] < bar or (dtype == torch.float32 and rel > 1e-5):
                raise AssertionError(f"{tag}: kernel path disagrees with the plain path")
            if launches["block_bwd"] != want_k7:
                raise AssertionError(f"{tag}: K7 launched {launches['block_bwd']} times, "
                                     f"expected {want_k7}")
            if want_k7 == 0 and not (launches["mha_core"] and launches["mha_core_bwd"]):
                raise AssertionError(f"{tag}: the fallback did not run mha_core and "
                                     f"mha_core_bwd")
            # above 512 tokens the fallback's core is K12 (the JAX package's
            # padded tower takes _jnp_mha), forward and recompute, never K5
            long = 2 * cfg.vision.layers if cfg.vision.seq_len > mha.MAX_SEQ else 0
            if launches["headgrid_core"] != long or launches["flash_core"]:
                raise AssertionError(f"{tag}: headgrid_core launched "
                                     f"{launches['headgrid_core']} times (expected {long}), "
                                     f"flash_core {launches['flash_core']}")
            results[arch, dtype] = (launches, worst, cos[worst])
            del got, want
        if arch == "ViT-B/32":
            reset()
            model.zero_grad(set_to_none=True)
            clip_loss(model, pixels, ids, torch.bfloat16, "mlp")[0].backward()
            torch.cuda.synchronize()
            print(f"[block train {arch}] a remat 'mlp' step launches K7 "
                  f"{blk.LAUNCHES['block_bwd']} times")
            if blk.LAUNCHES["block_bwd"]:
                raise AssertionError("a remat 'mlp' step launched K7")
            model.zero_grad(set_to_none=True)
            opt = make_optimizer(base_lr=1e-6, warmup=1, total_steps=10)
            state, losses = init_train_state(model, opt), {}
            for remat in ("block", "mlp_h1"):
                step_fn = make_train_step(cfg, opt, dtype=torch.bfloat16, remat=remat)
                state, metrics = step_fn(state, pixels, ids)
                losses[remat] = round(float(metrics["loss"]), 6)
            print(f"[block train {arch}] make_train_step, bf16, batch {batch}: losses {losses}")
            if not np.isfinite(list(losses.values())).all():
                raise AssertionError("non-finite train-step loss")
            del state
        del model
        torch.cuda.empty_cache()
        print(f"[block train {arch}] {time.perf_counter() - t0:.1f} s")
    return results


def mlp_path_phase(mlpm):
    """Step 11c: K8's and K9's entry points over the ViT-B/32 vision MLP
    halves at batch 128, bf16; K8's input grad against the plain version."""
    from plip_tpu_torch.models.clip import CLIP
    from plip_tpu_torch.models.config import CLIPConfig

    cfg = CLIPConfig.vit_b32()
    blocks = CLIP(cfg).init_params(torch.Generator().manual_seed(0)).visual.blocks.to("cuda")
    S, W = cfg.vision.seq_len, cfg.vision.width
    x0 = torch.randn(TRAIN_BATCH * S, W, generator=torch.Generator().manual_seed(7))
    x0 = x0.to("cuda").bfloat16()

    def backward():
        x = x0.clone().requires_grad_()
        h = x
        for b in blocks:
            h = mlpm.mlp_sublayer_flat(h, b.ln2, b.mlp, S)
        h.float().square().mean().backward()
        return x.grad

    torch.cuda.synchronize()
    mlpm.reset_launch_counts()
    got = backward()
    torch.cuda.synchronize()
    k8 = dict(mlpm.LAUNCHES)
    from plip_tpu_torch.ops import attention as att
    from plip_tpu_torch.ops import attention_bwd as bwd

    with PlainVersions(mlpm, att, bwd):  # LN2 (layer_norm_rows) on its plain versions too
        want = backward()
    cos = torch.nn.functional.cosine_similarity(got.float(), want.float(), dim=-1).min().item()
    mlpm.reset_launch_counts()
    with torch.no_grad():
        h = x0
        for b in blocks:
            h = mlpm.mlp_fwd_flat(h, b.ln2, b.mlp)
    torch.cuda.synchronize()
    k9 = dict(mlpm.LAUNCHES)
    print(f"[mlp paths] mlp_sublayer_flat over {len(blocks)} layers, batch {TRAIN_BATCH} bf16: "
          f"launches {k8}, input grad row cosine min {cos:.6f} vs plain; mlp_fwd_flat: "
          f"launches {k9}, output finite {bool(torch.isfinite(h).all())}")
    if k8["mlp_bwd"] != len(blocks) or k9["mlp_fwd"] != len(blocks) or cos < 0.995:
        raise AssertionError("K8's or K9's path")
    if not torch.isfinite(h).all():
        raise AssertionError("mlp_fwd_flat: non-finite output")
    return {"mlp_bwd": k8["mlp_bwd"], "mlp_fwd": k9["mlp_fwd"]}


def remat_memory_phase(tokenizer):
    """Step 11d: at ViT-B/32 batch 128 bf16, the memory the forward keeps for
    the backward under each remat policy ("block" must keep less than
    "mlp") and the peak of the forward and backward."""
    from plip_tpu_torch.models.clip import CLIP
    from plip_tpu_torch.models.config import CLIPConfig
    from plip_tpu_torch.ops.augment import AugmentConfig, augment_batch
    from plip_tpu_torch.train.contrastive import clip_loss

    cfg = CLIPConfig.vit_b32()
    model = CLIP(cfg).init_params(torch.Generator().manual_seed(0)).to("cuda")
    images = torch.from_numpy(synthetic_images(TRAIN_BATCH, seed=3))
    pixels = augment_batch(torch.Generator().manual_seed(0), images.to("cuda"),
                           AugmentConfig(out_size=cfg.vision.image_size))
    _, ids = train_batch(tokenizer, cfg, TRAIN_BATCH, seed=3)
    remats = ("mlp", "block", "mlp_h1")
    gib = 2.0 ** 30
    memory = {}
    for r in remats:  # the forward and backward alone
        model.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        loss, _ = clip_loss(model, pixels, ids, torch.bfloat16, r)
        saved = torch.cuda.memory_allocated() - base
        loss.backward()
        torch.cuda.synchronize()
        memory[r] = (saved / gib, torch.cuda.max_memory_allocated() / gib)
        del loss
    model.zero_grad(set_to_none=True)
    for r in remats:
        print(f"[remat memory] ViT-B/32 bf16 batch {TRAIN_BATCH} remat {r!r}: the forward "
              f"keeps {memory[r][0]:.3f} GiB for the backward, peak of the forward and "
              f"backward {memory[r][1]:.3f} GiB")
    if memory["block"][0] >= memory["mlp"][0]:
        raise AssertionError("'block' keeps no less for the backward than 'mlp'")
    del model
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Slice 6: K12 and the @336 "block" repair, K10, K6, K11
# ---------------------------------------------------------------------------


def timed_headgrid(mha, qkv, B, S, W, heads, label):
    """headgrid_core's (not causal) ms and plain ms in turns, its bound and
    SDPA's ms."""
    kernel = lambda: mha.headgrid_core(qkv, S, heads, False)
    plain = lambda: mha.headgrid_core_reference(qkv, S, heads, False)
    ms, plain_ms = in_turns(kernel, plain)
    flops, nbytes = 4 * B * S * S * W, 4 * B * S * W * qkv.element_size()
    return {"ms": ms, "plain_ms": plain_ms, **core_line(
        f"headgrid_core {label}", ms, plain_ms, flops, nbytes, sdpa_forward(qkv, B, S, heads))}


def headgrid_phase(mha):
    """Step 12a: headgrid_core (K12) at ViT-L/14 vision and the jnp_mha core
    at @336 against their plain versions; control: K3's deferred core. Times
    both shapes in bf16; returns the @336 one's, the shape of K12's launches
    on the path (the @336 "block" step)."""
    worst = 0.0
    gen = torch.Generator().manual_seed(8)
    name, B, S, W, heads = HEADGRID_CASE
    qkv32 = torch.randn(B, S, 3 * W, generator=gen).to("cuda")
    for causal in (False, True):
        for dtype in (torch.float32, torch.bfloat16):
            qkv = qkv32.to(dtype)
            print(f"[slice 6] headgrid_core {name} B={B} S={S} W={W} heads={heads} "
                  f"causal={causal} {str(dtype)[6:]}")
            kernel = lambda: mha.headgrid_core(qkv, S, heads, causal)
            plain = lambda: mha.headgrid_core_reference(qkv, S, heads, causal)
            got = kernel()
            torch.cuda.synchronize()  # a fault in the kernel shows here
            worst = max(worst, compare("headgrid_core", got.reshape(B * S, W),
                                       plain().reshape(B * S, W), dtype, core=True))
            if dtype != torch.bfloat16:
                continue
            bad = mha.mha_core_reference(qkv, S, heads, causal)  # deferred past 128
            differ, ulps = ulp_stats(got.reshape(B * S, W), bad.reshape(B * S, W))
            print(f"  control, K3's deferred core: differ={differ:.5f} worst={ulps:g} ulp of "
                  f"the row max")
            if differ <= CORE_DIFFER and ulps <= 1:
                raise AssertionError("headgrid_core: the bf16 bar does not reject K3's core")
            if not causal:
                timed_headgrid(mha, qkv, B, S, W, heads, name)
    name, B, S, W, heads = JNP_MHA_CASE
    qkv32 = torch.randn(B, S, 3 * W, generator=gen).to("cuda")
    for dtype in (torch.float32, torch.bfloat16):
        qkv = qkv32.to(dtype)
        print(f"[slice 6] jnp_mha_core (forward K12) {name} B={B} S={S} {str(dtype)[6:]}")
        with torch.no_grad():
            got = mha.jnp_mha_core(qkv, S, heads)
        worst = max(worst, compare("jnp_mha_core", got.reshape(B * S, W),
                                   mha.jnp_mha_reference(qkv, S, heads).reshape(B * S, W),
                                   dtype, core=True, ulps_bar=LONG_ULPS))
    return worst, timed_headgrid(mha, qkv, B, S, W, heads, name)


class Recorder:
    """While entered, records every call of K10's chain (``ops.block.
    KERNEL_FNS``) as (index in the chain, inputs, output)."""

    def __init__(self, bk):
        self.calls = []
        fns = [self._wrap(i, fn) for i, fn in enumerate(bk.KERNEL_FNS)]
        self.patch = mock.patch.object(bk, "KERNEL_FNS", tuple(fns))

    def _wrap(self, i, fn):
        def spy(*args):
            out = fn(*args)
            self.calls.append((i, args, out))
            return out
        return spy

    def __enter__(self):
        self.patch.start()
        return self

    def __exit__(self, *exc):
        self.patch.stop()


def block_forward_yardstick(x, p, S, heads, causal):
    """The same block forward from F.layer_norm, F.linear and SDPA (never
    used by the port)."""
    dt, (N, W) = x.dtype, x.shape
    B, D = N // S, W // heads
    c = lambda t: t.detach().to(dt).contiguous()
    ln1s, ln1b, ln2s, ln2b = (c(p[a][b]) for a in ("ln1", "ln2") for b in ("scale", "bias"))
    wq, bq = c(p["attn"]["qkv"]["kernel"].t()), c(p["attn"]["qkv"]["bias"])
    wo, bo = c(p["attn"]["out"]["kernel"].t()), c(p["attn"]["out"]["bias"])
    w1, b1 = c(p["mlp"]["fc1"]["kernel"].t()), c(p["mlp"]["fc1"]["bias"])
    w2, b2 = c(p["mlp"]["fc2"]["kernel"].t()), c(p["mlp"]["fc2"]["bias"])

    def forward():
        with torch.no_grad():
            qkv = F.linear(F.layer_norm(x, (W,), ln1s, ln1b), wq, bq)
            q, k, v = qkv.view(B, S, 3, heads, D).permute(2, 0, 3, 1, 4).unbind(0)
            ctx = F.scaled_dot_product_attention(q, k, v, is_causal=causal)
            a = x + F.linear(ctx.transpose(1, 2).reshape(N, W), wo, bo)
            z = F.linear(F.layer_norm(a, (W,), ln2s, ln2b), w1, b1)
            return a + F.linear(z * torch.sigmoid(1.702 * z), w2, b2)
    return forward


# K10's chain, in the order of its calls: the rounding point each one makes.
# The residual sums round twice (y cast, then x + y in the compute dtype):
# one flip of the first rounding is up to TWICE_ULPS after the second
# (H100: the text shape's a or out read 2 ulps at 0.026% of the elements
# differing). The activation of the fp32 h1 is cast once.
BLOCK_POINTS = ("LN1", "qkv", "ctx", "a", "LN2", "activation", "out")
TWICE, TWICE_ULPS = ("a", "out"), 2


def block_fwd_phase(mlpm, bk):
    """Step 12b: block_fwd (K10) and its fp32-h1 GEMM against their plain
    versions at the ViT-B/32 shapes, at every rounding point of the chain;
    control: K7-K9's activation of the cast h1."""
    worst = {"block_fwd": 0.0, "gemm_bias_gelu_f32": 0.0}
    timed = {}
    gen = torch.Generator().manual_seed(10)
    for case, B, S, W, heads, causal in K10_CASES:
        p = block_params(W, gen)
        x32 = torch.randn(B * S, W, generator=gen).to("cuda")
        for dtype in (torch.float32, torch.bfloat16):
            print(f"[slice 6] block_fwd {case} B={B} S={S} W={W} heads={heads} causal={causal} "
                  f"{str(dtype)[6:]}")
            x = x32.to(dtype)
            with Recorder(bk) as rec:
                got = bk.block_fwd(x, p, S, heads, causal)
            torch.cuda.synchronize()  # a fault in a kernel shows here
            worst["block_fwd"] = max(worst["block_fwd"], compare(
                "block_fwd", got, bk.block_fwd_reference(x, p, S, heads, causal), dtype))
            for (i, args, out), point in zip(rec.calls, BLOCK_POINTS):
                err = compare(f"block_fwd rounding point {point}", out, bk.REFERENCE_FNS[i](*args),
                              dtype, core=True, ulps_bar=TWICE_ULPS if point in TWICE else 1)
                if point == "activation":
                    worst["gemm_bias_gelu_f32"] = max(worst["gemm_bias_gelu_f32"], err)
                    gelu_args, act = args, out
            if dtype != torch.bfloat16:
                continue
            differ, ulps = ulp_stats(act, mlpm.gemm_bias_gelu_reference(*gelu_args)[1])
            print(f"  control, K7-K9's activation of the cast h1: differ={differ:.5f} "
                  f"worst={ulps:g} ulp of the row max")
            if differ <= CORE_DIFFER and ulps <= 1:
                raise AssertionError("block_fwd: the bar does not reject the cast-h1 activation")
            if case != K10_CASES[0][0]:
                continue
            N, it = B * S, x.element_size()
            calls = {  # (kernel, plain, FLOPs, bytes, PyTorch call)
                "block_fwd": (
                    lambda: bk.block_fwd(x, p, S, heads, causal),
                    lambda: bk.block_fwd_reference(x, p, S, heads, causal),
                    24 * N * W * W + 4 * B * S * S * W,
                    2 * N * W * it + 12 * W * W * it + 13 * W * 4,
                    block_forward_yardstick(x, p, S, heads, causal)),
                "gemm_bias_gelu_f32": (
                    lambda: mlpm.gemm_bias_gelu_f32(*gelu_args),
                    lambda: mlpm.gemm_bias_gelu_f32_reference(*gelu_args),
                    8 * N * W * W, (N * W + 4 * W * W + 4 * N * W) * it + 4 * W * 4,
                    lambda: torch.addmm(gelu_args[2].to(dtype), *gelu_args[:2])),
            }
            for label, (kernel_fn, plain_fn, flops, nbytes, library_fn) in calls.items():
                ms, plain_ms = in_turns(kernel_fn, plain_fn)
                print(f"  {label}: kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain "
                      f"{plain_ms:.4f} ms")
                timed[label] = {"ms": ms, "plain_ms": plain_ms,
                                **yardstick(label, flops, nbytes, library_fn)}
    return worst, timed


def block_stack_phase(bk, mlpm, layers, PLIP):
    """Step 12b: PLIP("random:ViT-B/32", bf16)'s vision tower with each of
    its 12 blocks run by transformer_block (K10) against the tower as it
    serves, on the same tiles. Returns the launches of K10 and of its
    fp32-h1 GEMM in the stack's run."""
    model = PLIP("random:ViT-B/32", dtype=torch.bfloat16, device="cuda")
    tiles = synthetic_images(K10_TILES, seed=11)
    batch = K10_TILES

    def k10_block(self, x, remat=False):
        return bk.transformer_block(x, {"ln1": self.ln1, "attn": self.attn, "ln2": self.ln2,
                                        "mlp": self.mlp}, self.heads, self.causal, self.eps)

    stack = mock.patch.object(layers.Block, "forward", k10_block)
    want = model.encode_images(tiles, batch_size=batch)  # also the warm-up
    with stack:
        model.encode_images(tiles, batch_size=batch)
        torch.cuda.synchronize()
        bk.reset_launch_counts()
        mlpm.reset_launch_counts()
        got = model.encode_images(tiles, batch_size=batch)
        torch.cuda.synchronize()
    launches = {k: d[k] for k, d in (("block_fwd", bk.LAUNCHES),
                                     ("gemm_bias_gelu_f32", mlpm.LAUNCHES))}
    cos = row_cos(got, want).min()
    layers_n = model.cfg.vision.layers
    print(f"[slice 6] {layers_n}-layer ViT-B/32 vision stack of transformer_block, "
          f"{len(tiles)} tiles bf16: launches {launches}; pooled embeddings against the "
          f"tower's: row cosine min {cos:.7f} (bar 0.999)")
    if (any(n != layers_n for n in launches.values()) or cos < 0.999
            or not np.isfinite(got).all()):
        raise AssertionError("the transformer_block stack")
    del model
    torch.cuda.empty_cache()
    return launches


def sublayer_backward_yardstick(x, g, ln, attn, S, heads, causal):
    """The autograd backward of the same sublayer built from F.layer_norm,
    F.linear and SDPA (never used by the port)."""
    dt, (N, W) = x.dtype, x.shape
    B, D = N // S, W // heads
    leaf = lambda t: t.detach().to(dt).contiguous().requires_grad_()
    xl, s, b = leaf(x), leaf(ln["scale"]), leaf(ln["bias"])
    wq, bq = leaf(attn["qkv"]["kernel"].t()), leaf(attn["qkv"]["bias"])
    wo, bo = leaf(attn["out"]["kernel"].t()), leaf(attn["out"]["bias"])
    qkv = F.linear(F.layer_norm(xl, (W,), s, b), wq, bq)
    q, k, v = qkv.view(B, S, 3, heads, D).permute(2, 0, 3, 1, 4).unbind(0)
    ctx = F.scaled_dot_product_attention(q, k, v, is_causal=causal)
    out = xl + F.linear(ctx.transpose(1, 2).reshape(N, W), wo, bo)
    return lambda: torch.autograd.grad(out, (xl, s, b, wq, bq, wo, bo), g, retain_graph=True)


def split_kernel_phase(att, bwd):
    """Step 12c: attention_sublayer_bwd_split (K6) against its plain version
    at ViT-B/32 vision and text (the shapes of the "dwsplit" step's two
    towers, at B=128), the qkv recomputed or saved; the vision shape's bf16
    times in turns beside the bound."""
    worst, timed = 0.0, {}
    for case in TRAIN_CASES:
        worst = max(worst, split_kernel_case(att, bwd, case, timed))
    return worst, timed


def split_kernel_case(att, bwd, case, timed):
    worst = 0.0
    name, B, S, W, heads, causal, s_valid = case
    x32, ln, attn = make_case(B, S, W, torch.Generator().manual_seed(12))
    g32 = torch.randn(B * S, W, generator=torch.Generator().manual_seed(13)).to("cuda")
    for dtype in (torch.float32, torch.bfloat16):
        x, g = x32.to(dtype), g32.to(dtype)
        h = att.layer_norm_rows_reference(x, ln["scale"], ln["bias"])
        qkv = att.gemm_bias_residual_reference(h, attn["qkv"]["kernel"].to(dtype),
                                               attn["qkv"]["bias"])
        for saved in (None, qkv):
            print(f"[slice 6] attention_sublayer_bwd_split {name} B={B} S={S} W={W} "
                  f"{'saved' if saved is not None else 'recomputed'} qkv {str(dtype)[6:]}")
            kernel = lambda: bwd.attention_sublayer_bwd_split(x, g, ln, attn, S, heads, causal,
                                                              s_valid, qkv2=saved)
            plain = lambda: bwd.attention_sublayer_bwd_split_reference(
                x, g, ln, attn, S, heads, causal, s_valid, qkv2=saved)
            got = kernel()
            torch.cuda.synchronize()  # a fault in a kernel shows here
            for (leaf, want), (_, t) in zip(leaves(plain()), leaves(got)):
                worst = max(worst, compare(f"attention_sublayer_bwd_split {leaf}", t, want,
                                           dtype, summed=leaf != "0"))
            if dtype == torch.bfloat16 and saved is None and case == TRAIN_CASES[0]:
                ms, plain_ms = in_turns(kernel, plain)
                N, it = B * S, x.element_size()
                flops = 22 * N * W * W + 12 * B * S * S * W
                nbytes = 3 * N * W * it + 4 * W * W * it + (4 * W * W + 8 * W) * 4
                print(f"  attention_sublayer_bwd_split: kernel {ms:.4f} ms "
                      f"({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms")
                timed.update(ms=ms, plain_ms=plain_ms, **yardstick(
                    "attention_sublayer_bwd_split", flops, nbytes,
                    sublayer_backward_yardstick(x, g, ln, attn, S, heads, causal)))
    return worst


def bwd_mode_phase(att, bwd, tokenizer, others):
    """Step 12c: one full-depth ViT-B/32 train step at batch 32 under each
    BWD_MODE, fp32 and bf16, the split modes against "fused". The default
    steps (and the split ones) launch none of step 12's other kernels
    (``others``: {name: module}). Returns the launches of the bf16
    "dwsplit" step."""
    from plip_tpu_torch.models.clip import CLIP
    from plip_tpu_torch.models.config import CLIPConfig
    from plip_tpu_torch.train.contrastive import clip_loss

    for m in others.values():
        m.reset_launch_counts()
    cfg = CLIPConfig.vit_b32()
    model = CLIP(cfg).init_params(torch.Generator().manual_seed(0)).to("cuda")
    pixels, ids = train_batch(tokenizer, cfg, K6_BATCH, seed=14)
    layers_n = cfg.vision.layers + cfg.text.layers
    split_path = None
    for dtype, bar in ((torch.float32, 0.9999), (torch.bfloat16, 0.995)):
        steps = {}
        for mode in att.BWD_MODES:
            bwd.reset_launch_counts()
            model.zero_grad(set_to_none=True)
            with mock.patch.object(att, "BWD_MODE", mode):
                loss, _ = clip_loss(model, pixels, ids, dtype, "mlp")
                loss.backward()
            torch.cuda.synchronize()
            steps[mode] = (loss.item(), {k: q.grad.clone() for k, q in model.named_parameters()},
                           dict(bwd.LAUNCHES))
        loss0, grads0, n0 = steps["fused"]
        for mode in att.BWD_MODES:
            loss, got, n = steps[mode]
            split = mode != "fused"
            want = {"attention_sublayer_bwd": 0 if split else layers_n,
                    "attention_sublayer_bwd_split": layers_n if split else 0}
            calls = {k: n[k] for k in want}
            cos = {k: leaf_cosine(got[k], grads0[k]) for k in grads0}
            worst = min(cos, key=cos.get)
            rel = abs(loss - loss0) / abs(loss0)
            tag = f"[slice 6 BWD_MODE {mode!r} {str(dtype)[6:]}]"
            print(f"{tag} ViT-B/32 batch {K6_BATCH}: loss {loss:.6f} ('fused' {loss0:.6f}, rel "
                  f"{rel:.2e}); worst leaf cosine {cos[worst]:.7f} at {worst} (bar {bar}); "
                  f"backwards called {calls}; launches {n}")
            if calls != want or cos[worst] < bar or (dtype == torch.float32 and rel > 1e-5):
                raise AssertionError(f"{tag}: disagrees with the 'fused' step")
            if (mode, dtype) == ("dwsplit", torch.bfloat16):
                split_path = n
        del steps
    new = {k: m.LAUNCHES[k] for k, m in others.items()}
    print(f"[slice 6] the ViT-B/32 steps' (batches preprocessed by default) launches of "
          f"step 12's other kernels: {new}")
    if any(new.values()):
        raise AssertionError("a default ViT-B/32 step launched a kernel of step 12")
    del model
    torch.cuda.empty_cache()
    return split_path


def preprocess_phase(pk, pf, pre, PLIP):
    """Step 12d: preprocess_batch(fused=True) (K11) against the two-matmul
    path at K11_CASES, bf16 out, float input, each case timed (the module
    doc); then the fused-preprocessed tiles through ViT-B/32 against the
    default path. Returns (worst error, the JSON line's times: the first
    case, fp32 out; K11's launches in the encode run)."""
    from plip_tpu_torch.models.config import CLIP_IMAGE_STD

    level = (1 / (255 * torch.tensor(CLIP_IMAGE_STD))).to("cuda")
    rng = np.random.default_rng(15)
    gen = torch.Generator("cuda").manual_seed(15)
    worst, timed, first = 0.0, {}, None
    for h, w, out in K11_CASES:
        imgs = torch.from_numpy(rng.integers(0, 256, (K11_TILES, h, w, 3), np.uint8)).to("cuda")
        got = pre.preprocess_batch(imgs, out, fused=True)
        torch.cuda.synchronize()  # a fault in the kernel shows here
        d = (got - pre.preprocess_batch(imgs, out)).abs()
        off = (d > 1e-5).float().mean().item()
        levels = (d / level).max().item()
        raw = (pre.preprocess_batch(imgs, out, fused=True, emulate_uint8=False)
               - pre.preprocess_batch(imgs, out, emulate_uint8=False)).abs().max().item()
        half = torch.equal(pre.preprocess_batch(imgs, out, fused=True, dtype=torch.bfloat16),
                           got.to(torch.bfloat16))
        floats = torch.rand((16, h, w, 3), device="cuda", generator=gen) * 340 - 40
        df = (pre.preprocess_batch(floats, out, fused=True)
              - pre.preprocess_batch(floats.to(torch.int32).to(torch.uint8), out)).abs()
        f_levels, f_off = (df / level).max().item(), (df > 1e-5).float().mean().item()
        ok = (levels <= 1 + 1e-4 and off <= 1e-3 and raw <= 1e-4 and half
              and f_levels <= 1 + 1e-4 and f_off <= 1e-3)
        print(f"[slice 6] preprocess_fused {K11_TILES} tiles {h}x{w} -> {out}: "
              f"max_abs_err={d.max().item():.3e} ({levels:.4f} uint8 levels), on {off:.2e} of "
              f"the elements; emulate_uint8=False max_abs_err={raw:.3e} (bar 1e-4); bf16 out "
              f"{'bit-equal' if half else 'NOT bit-equal'} to fp32 out cast; float input "
              f"{f_levels:.4f} uint8 levels from the plain path on its uint8 truncation, on "
              f"{f_off:.2e} of the elements {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("preprocess_fused disagrees with the two-matmul path")
        worst = max(worst, d.max().item())
        for dtype in (torch.float32, torch.bfloat16) if first is None else (torch.float32,):
            row = pk.measure(pk.preprocess_case(imgs, out, dtype), plain_device=True)
            print(f"  preprocess_fused {row['case']}: device {row['device_ms']:.4f} ms "
                  f"(CUDA-event {row['ms']:.4f}), plain device {row['plain_device_ms']:.4f} "
                  f"({row['plain_ms']:.4f}); bound {row['bound_ms']:.4f} ms ({row['bound_by']}), "
                  f"{row['bound_ms'] / row['device_ms']:.1%} of it in device ms")
            if not timed:
                timed = {k: row[k] for k in ("ms", "device_ms", "plain_ms", "plain_device_ms",
                                             "bound_ms", "bound_by", "library_ms")}
                timed["case"] = row["case"]
        first = imgs if first is None else first
    model = PLIP("random:ViT-B/32", dtype=torch.bfloat16, device="cuda")
    n_px = model.cfg.vision.image_size
    pf.reset_launch_counts()
    with torch.inference_mode():
        fused = model.model.encode_image(pre.preprocess_batch(first, n_px, fused=True),
                                         torch.bfloat16)
        launches = pf.LAUNCHES["preprocess_fused"]
        default = model.model.encode_image(pre.preprocess_batch(first, n_px), torch.bfloat16)
    cos = torch.nn.functional.cosine_similarity(fused, default, dim=-1).min().item()
    print(f"[slice 6] ViT-B/32 bf16 embeddings of {K11_TILES} tiles, fused preprocessing against "
          f"the default: row cosine min {cos:.7f} (bar 0.999); preprocess_fused launches "
          f"{launches}")
    if cos < 0.999 or launches != 1:
        raise AssertionError("the fused preprocessing's embeddings")
    del model
    torch.cuda.empty_cache()
    return worst, timed, launches


# ---------------------------------------------------------------------------
# Slice 8: K1's one-block core and grad_gemm on wgmma
# ---------------------------------------------------------------------------


def tiled_core(att, qkv, B, S, heads, causal, s_valid):
    """The key-tiled route (csrc/mha.cu's plip_attn_core_tiled) called
    directly, K1's schedule: at S <= 128 a yardstick only (attn_core takes
    the one-block core there)."""
    W = qkv.shape[1] // 3
    ctx = torch.empty((B * S, W), dtype=qkv.dtype, device=qkv.device)
    rc = att._lib().plip_attn_core_tiled(
        qkv.data_ptr(), ctx.data_ptr(), B, S, heads, W // heads, int(causal),
        S if s_valid is None else s_valid, int(S > att.DEFER_ABOVE),
        att.tiled_plan(S, W // heads)[1], 1, qkv.device.index, att._stream(qkv.device))
    if rc != 0:
        raise RuntimeError(f"plip_attn_core_tiled failed with error {rc}")
    return ctx


def short_core_phase(att, mha):
    """Step 13a: bf16 attn_core at the towers' S <= 256 shapes (the one-block
    core up to 128 tokens, the key-tiled kernel past them) against its plain
    version (the cores' bars), SDPA and the key-tiled route called directly;
    the schedule-fault controls at B/16."""
    gen = torch.Generator().manual_seed(13)
    out = {}
    for name, B, S, W, heads, causal, s_valid in SHORT_CORE_CASES:
        qkv = torch.randn(B * S, 3 * W, generator=gen).to("cuda").bfloat16()
        kernel = lambda: att.attn_core(qkv, S, heads, causal, s_valid)
        plain = lambda: att.attn_core_reference(qkv, S, heads, causal, s_valid)
        tiled = lambda: tiled_core(att, qkv, B, S, heads, causal, s_valid)
        print(f"[slice 8] attn_core {name} B={B} S={S} W={W} heads={heads} causal={causal} "
              f"s_valid={s_valid} bf16")
        got = kernel()
        torch.cuda.synchronize()  # a fault in the kernel shows here
        compare("attn_core", got, plain(), torch.bfloat16, core=True)
        compare("plip_attn_core_tiled (yardstick)", tiled(), plain(), torch.bfloat16, core=True)
        if S > att.DEFER_ABOVE:
            for fault, bad in schedule_faults(att, mha, plain).items():
                differ, ulps = ulp_stats(got, bad)
                print(f"  control, plain version with {fault}: differ={differ:.5f} "
                      f"worst={ulps:g} ulp of the row max")
                if differ <= CORE_DIFFER and ulps <= 1:
                    raise AssertionError(f"attn_core: the bf16 bar does not reject {fault}")
        ms, plain_ms = in_turns(kernel, plain)
        tiled_ms = (time_ms(tiled) + time_ms(tiled)) / 2
        pairs = att.keep_mask(S, causal, s_valid, "cpu").sum().item()
        sdpa = sdpa_forward(qkv, B, S, heads)
        y = core_line(f"attn_core {name}", ms, plain_ms, 4 * B * pairs * W,
                      4 * B * S * W * qkv.element_size(), sdpa)
        dev = {k: (device_ms(f) + device_ms(f)) / 2
               for k, f in (("attn_core", kernel), ("key-tiled", tiled), ("SDPA", sdpa))}
        verdict = "held" if dev["attn_core"] <= dev["key-tiled"] else "missed"
        route = "one-block" if S <= att.BF16_ROW_MAX_SEQ else "key-tiled"
        print(f"  attn_core {name} ({route}): CUDA-event ms {ms:.4f}, key-tiled route "
              f"{tiled_ms:.4f}; device ms {dev['attn_core']:.4f}, key-tiled route "
              f"{dev['key-tiled']:.4f}, SDPA {dev['SDPA']:.4f} (no slower than the "
              f"key-tiled route: {verdict})")
        out[name] = {"ms": ms, "plain_ms": plain_ms, "tiled_ms": tiled_ms, "device_ms": dev, **y}
    ms = out[SHORT_CORE_CASES[-1][0]]["ms"]
    print(f"  attn_core {SHORT_CORE_CASES[-1][0]}: {ms:.4f} ms against the bar "
          f"{SHORT_CORE_BAR_MS} ms: {'held' if ms <= SHORT_CORE_BAR_MS else 'missed'}")
    return out


def grad_gemm_phase(bwd):
    """Step 13b: grad_gemm's four bf16 products at the ViT-B/32 and ViT-L/14
    vision shapes against their plain versions (the bars of step 4a), timed
    in turns beside torch.matmul of the same bf16 operands."""
    gen = torch.Generator().manual_seed(14)
    out = {}
    for name, N, W in GRAD_GEMM_CASES:
        r = lambda *shape, std=1.0: (torch.randn(*shape, generator=gen) * std).to(
            "cuda").bfloat16()
        g, ctx, h = r(N, W), r(N, W), r(N, W)
        dqkv, wout, wqkv = r(N, 3 * W), r(W, W, std=W ** -0.5), r(W, 3 * W, std=W ** -0.5)
        products = {  # (kernel, plain, torch.matmul, M, N, K, output bytes an element)
            "NT dctx = g . Wout^T": (lambda: bwd.grad_gemm_nt(g, wout, torch.bfloat16),
                                     lambda: bwd.grad_gemm_nt_reference(g, wout, torch.bfloat16),
                                     lambda: torch.matmul(g, wout.t()), N, W, W, 2),
            "NT dln = dqkv . Wqkv^T": (lambda: bwd.grad_gemm_nt(dqkv, wqkv, torch.float32),
                                       lambda: bwd.grad_gemm_nt_reference(dqkv, wqkv,
                                                                          torch.float32),
                                       lambda: torch.matmul(dqkv, wqkv.t()), N, W, 3 * W, 4),
            "TN dWout = ctx^T . g": (lambda: bwd.grad_gemm_tn(ctx, g),
                                     lambda: bwd.grad_gemm_tn_reference(ctx, g),
                                     lambda: torch.matmul(ctx.t(), g), W, W, N, 4),
            "TN dWqkv = ln^T . dqkv": (lambda: bwd.grad_gemm_tn(h, dqkv),
                                       lambda: bwd.grad_gemm_tn_reference(h, dqkv),
                                       lambda: torch.matmul(h.t(), dqkv), W, 3 * W, N, 4),
        }
        for label, (kernel, plain, matmul, M_, N_, K_, out_size) in products.items():
            print(f"[slice 8] grad_gemm {label} {name}: M={M_} N={N_} K={K_} bf16")
            got = kernel()
            torch.cuda.synchronize()  # a fault in the kernel shows here
            err = compare(f"grad_gemm {label}", got, plain(), torch.bfloat16,
                          summed=label.startswith("TN"))
            ms, plain_ms = in_turns(kernel, plain)
            flops = 2 * M_ * N_ * K_
            y = yardstick(f"grad_gemm {label} (torch.matmul)", flops,
                          2 * (M_ + N_) * K_ + out_size * M_ * N_, matmul)
            factor = ms / y["library_ms"]
            dev = {k: (device_ms(f) + device_ms(f)) / 2
                   for k, f in (("grad_gemm", kernel), ("torch.matmul", matmul))}
            verdict = "held" if factor <= GRAD_GEMM_MATMUL_FACTOR else "missed"
            print(f"  grad_gemm {label}: kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s, "
                  f"{y['bound_ms'] / ms:.2%} of the bound), plain {plain_ms:.4f} ms, "
                  f"torch.matmul {y['library_ms']:.4f} ms: {factor:.2f}x "
                  f"(within {GRAD_GEMM_MATMUL_FACTOR}x: {verdict}); device ms grad_gemm "
                  f"{dev['grad_gemm']:.4f} (with col_sum), torch.matmul "
                  f"{dev['torch.matmul']:.4f}")
            out[name, label] = {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err,
                                "device_ms": dev, **y}
        del g, ctx, h, dqkv, wout, wqkv
        torch.cuda.empty_cache()
    return out


def epilogue_gemm_phase(att, mlpm):
    """Step 14: the four bf16 entry points of csrc/gemm.cuh's wgmma GEMM at
    the ViT-B/32 (batch 128), ViT-L/14 (batch 64) and ViT-L/14@336px (batch
    32) products against their plain versions (h1, dh1 and K10's activation
    within one ulp of the row max, the activation of the cast h1 within
    ACT_ULPS, at most CORE_DIFFER differing; the residual GEMM at step 2's
    bars), timed in turns beside torch.addmm or torch.matmul of the same bf16
    operands (a yardstick the port never calls)."""
    gen = torch.Generator().manual_seed(15)
    out = {}
    for name, N, W, wanted in EPILOGUE_CASES:
        r = lambda *shape, std=1.0: (torch.randn(*shape, generator=gen) * std).to(
            "cuda").bfloat16()
        b = lambda n: (torch.randn(n, generator=gen) * 0.1).to("cuda")
        W4 = 4 * W
        x, ctx = r(N, W), r(N, W)
        ln, act, g = r(N, W), r(N, W4), r(N, W)
        h1 = r(N, W4, std=2.0)
        w1, w2 = r(W, W4, std=W ** -0.5), r(W4, W, std=W4 ** -0.5)
        wqkv, wout = r(W, 3 * W, std=W ** -0.5), r(W, W, std=W ** -0.5)
        b1, b2, bqkv, bout = b(W4), b(W), b(3 * W), b(W)
        # label: (kernel, plain, library call, M, N, K, the bytes of bias, R, h and
        # the outputs)
        products = {
            "gemm_bias_gelu": (lambda: mlpm.gemm_bias_gelu(ln, w1, b1),
                               lambda: mlpm.gemm_bias_gelu_reference(ln, w1, b1),
                               lambda: torch.addmm(b1.bfloat16(), ln, w1), N, W4, W,
                               4 * W4 + 2 * 2 * N * W4),
            "gemm_bias_gelu_f32": (lambda: mlpm.gemm_bias_gelu_f32(ln, w1, b1),
                                   lambda: mlpm.gemm_bias_gelu_f32_reference(ln, w1, b1),
                                   lambda: torch.addmm(b1.bfloat16(), ln, w1), N, W4, W,
                                   4 * W4 + 2 * N * W4),
            "gemm_nt_gelu_bwd": (lambda: mlpm.gemm_nt_gelu_bwd(g, w2, h1),
                                 lambda: mlpm.gemm_nt_gelu_bwd_reference(g, w2, h1),
                                 lambda: torch.matmul(g, w2.t()), N, W4, W,
                                 2 * 2 * N * W4),
            "fc2 + R": (lambda: att.gemm_bias_residual(act, w2, b2, x),
                        lambda: att.gemm_bias_residual_reference(act, w2, b2, x),
                        lambda: torch.addmm(b2.bfloat16(), act, w2), N, W, W4,
                        4 * W + 2 * 2 * N * W),
            "qkv": (lambda: att.gemm_bias_residual(ln, wqkv, bqkv),
                    lambda: att.gemm_bias_residual_reference(ln, wqkv, bqkv),
                    lambda: torch.addmm(bqkv.bfloat16(), ln, wqkv), N, 3 * W, W,
                    4 * 3 * W + 2 * N * 3 * W),
            "out-projection + R": (lambda: att.gemm_bias_residual(ctx, wout, bout, x),
                                   lambda: att.gemm_bias_residual_reference(ctx, wout, bout, x),
                                   lambda: torch.addmm(bout.bfloat16(), ctx, wout), N, W, W,
                                   4 * W + 2 * 2 * N * W),
        }
        for label in wanted:
            kernel, plain, library, M_, N_, K_, io_bytes = products[label]
            entry = label if label in mlpm.LAUNCHES else "gemm_bias_residual"
            lib_name = "torch.matmul" if label == "gemm_nt_gelu_bwd" else "torch.addmm"
            print(f"[slice 9] {entry} ({label}) {name}: M={M_} N={N_} K={K_} bf16")
            got = kernel()
            torch.cuda.synchronize()  # a fault in the kernel shows here
            want = plain()
            if label == "gemm_bias_gelu":
                err = max(compare(f"{label} h1", got[0], want[0], torch.bfloat16, core=True),
                          compare(f"{label} activation", got[1], want[1], torch.bfloat16,
                                  core=True, ulps_bar=ACT_ULPS))
            elif entry == "gemm_bias_residual":
                err = compare(label, got, want, torch.bfloat16)
                differ, ulps = ulp_stats(got, want)
                print(f"  {label}: differ={differ:.5f} worst={ulps:g} ulp of the row max "
                      f"(step 2's bars hold it)")
            else:
                err = compare(label, got, want, torch.bfloat16, core=True)
            ms, plain_ms = in_turns(kernel, plain)
            flops = 2 * M_ * N_ * K_
            y = yardstick(f"{entry} ({label}, {lib_name})", flops,
                          2 * (M_ + N_) * K_ + io_bytes, library)
            factor = ms / y["library_ms"]
            dev = {k: (device_ms(f) + device_ms(f)) / 2
                   for k, f in ((entry, kernel), ("library", library))}
            verdict = "held" if factor <= EPILOGUE_LIBRARY_FACTOR else "missed"
            print(f"  {entry} ({label}) {name}: kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} "
                  f"TFLOP/s, {y['bound_ms'] / ms:.2%} of the bound), plain {plain_ms:.4f} ms, "
                  f"{lib_name} {y['library_ms']:.4f} ms: {factor:.2f}x (within "
                  f"{EPILOGUE_LIBRARY_FACTOR}x of the library call: {verdict}); device ms "
                  f"{dev[entry]:.4f}, {lib_name} {dev['library']:.4f}")
            out[name, label] = {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err,
                                "device_ms": dev, **y}
        del x, ctx, ln, act, g, h1, w1, w2, wqkv, wout
        torch.cuda.empty_cache()
    return out


def col_sum_phase(bwd):
    """Step 15a: col_sum at the shapes the training steps call it with, fp32
    and bf16, against its plain version (the fp32 bars of a summed leaf),
    reruns bit-equal, timed in turns beside t.sum(0, dtype=torch.float32)."""
    gen = torch.Generator().manual_seed(16)
    out = {}
    for name, R, C in COL_SUM_CASES:
        t32 = torch.randn(R, C, generator=gen).to("cuda")
        for dtype in (torch.float32, torch.bfloat16):
            t = t32.to(dtype)
            plan = bwd.col_sum_plan(R, C, t.element_size(), t.data_ptr(),
                                    bwd._sm_count(t.device))
            print(f"[slice 10] col_sum {name} [{R}, {C}] {str(dtype)[6:]}: {plan}")
            kernel = lambda: bwd.col_sum(t)
            plain = lambda: bwd.col_sum_reference(t)
            library = lambda: t.sum(0, dtype=torch.float32)
            got = kernel()
            torch.cuda.synchronize()  # a fault in the kernel shows here
            err = compare("col_sum", got, plain(), torch.float32, summed=True)
            if not torch.equal(got, kernel()):
                raise AssertionError(f"col_sum {name}: a rerun gave other bits")
            # a small call's time is its host's: many calls even out the host's spread
            ms, library_ms = in_turns(kernel, library, COL_SUM_ITERS)
            plain_ms = time_ms(plain)
            nbytes = R * C * t.element_size() + 4 * C  # in read once, out written once
            bound_ms, bound_by = bound(R * C, nbytes, PEAK_FP32)  # fp32 adds
            y = {"bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}
            dev = {k: (device_ms(f) + device_ms(f)) / 2
                   for k, f in (("col_sum", kernel), ("t.sum", library))}
            share = bound_ms / ms
            held = lambda ok: "held" if ok else "missed"
            print(f"  col_sum {name}: kernel {ms:.4f} ms ({share:.2%} of the bytes bound, "
                  f"{nbytes / ms / 1e9:.2f} TB/s), plain {plain_ms:.4f} ms, t.sum "
                  f"{library_ms:.4f} ms; device ms col_sum {dev['col_sum']:.4f} "
                  f"({bound_ms / dev['col_sum']:.2%} of the bound), t.sum {dev['t.sum']:.4f} "
                  f"(within torch.sum: CUDA-event ms {held(ms <= library_ms)}, device ms "
                  f"{held(dev['col_sum'] <= dev['t.sum'])})")
            if dtype == torch.bfloat16 and name in COL_SUM_BOUND_CASES:
                print(f"  col_sum {name}: {share:.2%} of the bytes bound against the bar "
                      f"{COL_SUM_BOUND_SHARE:.0%}: "
                      f"{'held' if share >= COL_SUM_BOUND_SHARE else 'missed'}")
            out[name, dtype] = {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err,
                                "device_ms": dev, **y}
        del t32, t
        torch.cuda.empty_cache()
    return out


def tiled_core_bwd(bwd, qkv, dctx, B, S, heads, causal, s_valid):
    """K2's key-tiled core backward (csrc/mha_bwd.cu's core_bwd_rows and
    core_bwd_keys, plip_attn_core_bwd_tiled) called directly: a yardstick at
    S <= 128, where attn_core_bwd takes the one-block kernel."""
    W = qkv.shape[1] // 3
    ctx = torch.empty((B * S, W), dtype=qkv.dtype, device=qkv.device)
    dqkv = torch.empty_like(qkv)
    stats = torch.empty((3, B, heads, S), dtype=torch.float32, device=qkv.device)
    rc = bwd._lib().plip_attn_core_bwd_tiled(
        qkv.data_ptr(), dctx.data_ptr(), ctx.data_ptr(), dqkv.data_ptr(), stats.data_ptr(), B,
        S, heads, W // heads, int(causal), S if s_valid is None else s_valid,
        *bwd.tiled_plan(S, W // heads, backward=True), 1, qkv.device.index,
        bwd._stream(qkv.device))
    if rc != 0:
        raise RuntimeError(f"plip_attn_core_bwd_tiled failed with error {rc}")
    return ctx, dqkv


def core_bwd_phase(bwd, mha):
    """Step 15b: bf16 attn_core_bwd's one-block wgmma kernel at the towers'
    S <= 128 shapes against its plain version (ctx within 1 ulp, dqkv within
    BWD_ULPS, at most CORE_DIFFER differing), the plain version in the other
    schedule as the control, timed beside the key-tiled route, SDPA's
    backward and the CUDA-core kernel it replaced."""
    gen = torch.Generator().manual_seed(17)
    out = {}
    for name, B, S, W, heads, causal, s_valid in CORE_BWD_CASES:
        qkv = torch.randn(B * S, 3 * W, generator=gen).to("cuda").bfloat16()
        dctx = torch.randn(B * S, W, generator=gen).to("cuda").bfloat16()
        args = (S, heads, causal, s_valid)
        kernel = lambda: bwd.attn_core_bwd(qkv, dctx, *args)
        plain = lambda: bwd.attn_core_bwd_reference(qkv, dctx, *args)
        tiled = lambda: tiled_core_bwd(bwd, qkv, dctx, B, *args)
        print(f"[slice 10] attn_core_bwd {name} B={B} S={S} W={W} heads={heads} "
              f"causal={causal} s_valid={s_valid} bf16")
        got = kernel()
        torch.cuda.synchronize()  # a fault in the kernel shows here
        want = plain()
        err = max(compare("attn_core_bwd ctx", got[0], want[0], torch.bfloat16, core=True),
                  compare("attn_core_bwd dqkv", got[1], want[1], torch.bfloat16, core=True,
                          ulps_bar=BWD_ULPS))
        for label, t, w in zip(("ctx", "dqkv"), tiled(), want):
            compare(f"key-tiled route (yardstick) {label}", t, w, torch.bfloat16, core=True,
                    ulps_bar=BWD_ULPS)
        differ, ulps = ulp_stats(got[1], mha.mha_core_bwd_reference(qkv, dctx, *args))
        print(f"  control, plain version normalize-first: differ={differ:.5f} worst={ulps:g} "
              f"ulp of the row max")
        if differ <= CORE_DIFFER and ulps <= BWD_ULPS:
            raise AssertionError("attn_core_bwd: the bf16 bar does not reject normalize-first")
        ms, plain_ms = in_turns(kernel, plain)
        tiled_ms = (time_ms(tiled) + time_ms(tiled)) / 2
        pairs = bwd.keep_mask(S, causal, s_valid, "cpu").sum().item()  # kept (row, key)
        flops, nbytes = 2 * 6 * pairs * B * W, 8 * B * S * W * qkv.element_size()
        sdpa = sdpa_backward(qkv, dctx, B, S, heads)
        y = core_line(f"attn_core_bwd {name}", ms, plain_ms, flops, nbytes, sdpa)
        dev = {k: (device_ms(f) + device_ms(f)) / 2
               for k, f in (("attn_core_bwd", kernel), ("key-tiled", tiled), ("SDPA", sdpa))}
        old = OLD_CORE_BWD_MS.get(name)
        vs_old = ("not measured" if old is None else
                  f"{old:.4f}, faster: {'held' if ms < old else 'missed'}")
        verdict = "held" if dev["attn_core_bwd"] <= dev["key-tiled"] else "missed"
        print(f"  attn_core_bwd {name}: CUDA-event ms {ms:.4f}, key-tiled route {tiled_ms:.4f}, "
              f"the CUDA-core kernel {vs_old}; device ms {dev['attn_core_bwd']:.4f}, key-tiled "
              f"route {dev['key-tiled']:.4f}, SDPA {dev['SDPA']:.4f} (no slower than the "
              f"key-tiled route: {verdict})")
        out[name] = {"ms": ms, "plain_ms": plain_ms, "tiled_ms": tiled_ms, "max_abs_err": err,
                     "device_ms": dev, **y}
        del qkv, dctx
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Step 16: fp32 on the redesigned GEMM and one-block core; bf16 at
# head_dim != 64
# ---------------------------------------------------------------------------


def fp32_kernel_phase(pk):
    """Step 16a, fp32: gemm_bias_residual and attn_core at the shapes of
    profile_kernels against their plain versions (atol 1e-4, rtol 1e-4, TF32
    off), timed in turns beside the parent's kernel, the PyTorch call and the
    bound (fp32 at 67 TFLOP/s or bytes at 3.35 TB/s); the aims held or
    missed. Returns {kernel: the JSON line's fp32 numbers} at its serving
    shape and the worst error of each."""
    out, worst = {}, {"gemm_bias_residual": 0.0, "attn_core": 0.0}
    for case in pk.cases("cuda", torch.Generator().manual_seed(16)):
        if case.kernel not in worst:
            continue
        print(f"[step 16] {case.kernel} {case.label} fp32")
        got = case.fn()
        torch.cuda.synchronize()  # a fault in the kernel shows here
        err = compare(f"{case.kernel} {case.label}", got, case.plain(), torch.float32)
        worst[case.kernel] = max(worst[case.kernel], err)
        row = pk.measure(case)
        parent = PARENT_FP32_MS[case.label]
        print(f"  {case.kernel} {case.label}: kernel {row['ms']:.4f} ms (device "
              f"{row['device_ms']:.4f}; {row['tflops']:.1f} TFLOP/s, {row['bound_share']:.2%} "
              f"of the bound {row['bound_ms']:.4f} ({row['bound_by']})), parent's kernel "
              f"{parent:.4f} ({parent / row['ms']:.2f}x), plain {row['plain_ms']:.4f}, "
              f"{row['library']} {row['library_ms']:.4f} (device {row['library_device_ms']:.4f}"
              f": {', '.join(row['library_kernels'])}): {row['ms'] / row['library_ms']:.2f}x")
        held = lambda ok: "held" if ok else "missed"
        if case.label == GEMM_AIM_CASE:
            print(f"  aim, {case.label}: >= {GEMM_BOUND_AIM:.0%} of the bound: "
                  f"{held(row['bound_share'] >= GEMM_BOUND_AIM)}; within {GEMM_ADDMM_AIM}x "
                  f"of torch.addmm: {held(row['ms'] <= GEMM_ADDMM_AIM * row['library_ms'])}")
        if case.label in CORE_SDPA_AIM_CASES:
            print(f"  aim, {case.label}: at or under SDPA: "
                  f"{held(row['ms'] <= row['library_ms'])}")
        if case.label == CORE_BOUND_AIM_CASE:
            print(f"  aim, {case.label}: >= {CORE_BOUND_AIM:.0%} of the bytes bound: "
                  f"{held(row['bound_share'] >= CORE_BOUND_AIM)}")
        out.setdefault(case.kernel, {"case": case.label, "ms": row["ms"],
                                     "plain_ms": row["plain_ms"],
                                     "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                                     "library_ms": row["library_ms"]})
    return out, worst


def other_head_dim_phase(att, bwd):
    """Step 16a, bf16 at head_dim 32 and 16: attn_core (the one-block
    CUDA-core kernel) and attn_core_bwd (its CUDA-core kernel) against their
    plain versions at the cores' bars, in turns beside SDPA."""
    gen = torch.Generator().manual_seed(17)
    for name, B, S, W, heads, causal, s_valid in OTHER_HEAD_DIM_CASES:
        D = W // heads
        qkv = torch.randn(B * S, 3 * W, generator=gen).to("cuda").bfloat16()
        dctx = torch.randn(B * S, W, generator=gen).to("cuda").bfloat16()
        args = (S, heads, causal, s_valid)
        print(f"[step 16] {name} B={B} S={S} W={W} heads={heads} causal={causal} "
              f"s_valid={s_valid} bf16: routes {att.core_route(S, D, torch.bfloat16)}, "
              f"{att.core_route(S, D, torch.bfloat16, backward=True)}")
        att.reset_launch_counts()
        bwd.reset_launch_counts()
        got = att.attn_core(qkv, *args)
        ctx, dqkv = bwd.attn_core_bwd(qkv, dctx, *args)
        torch.cuda.synchronize()  # a fault in the kernels shows here
        if att.LAUNCHES["attn_core"] != 1 or bwd.LAUNCHES["attn_core_bwd"] != 1:
            raise AssertionError(f"{name}: launches {att.LAUNCHES}, {bwd.LAUNCHES}")
        compare("attn_core", got, att.attn_core_reference(qkv, *args), torch.bfloat16,
                core=True)
        want = bwd.attn_core_bwd_reference(qkv, dctx, *args)
        compare("attn_core_bwd ctx", ctx, want[0], torch.bfloat16, core=True)
        compare("attn_core_bwd dqkv", dqkv, want[1], torch.bfloat16, core=True,
                ulps_bar=BWD_ULPS)
        pairs = att.keep_mask(S, causal, s_valid, "cpu").sum().item()
        ms, plain_ms = in_turns(lambda: att.attn_core(qkv, *args),
                                lambda: att.attn_core_reference(qkv, *args))
        core_line(f"attn_core {name}", ms, plain_ms, 4 * B * pairs * W, 4 * B * S * W * 2,
                  sdpa_forward(qkv, B, S, heads))
        ms, plain_ms = in_turns(lambda: bwd.attn_core_bwd(qkv, dctx, *args),
                                lambda: bwd.attn_core_bwd_reference(qkv, dctx, *args))
        core_line(f"attn_core_bwd {name}", ms, plain_ms, 2 * 6 * pairs * B * W,
                  8 * B * S * W * 2, sdpa_backward(qkv, dctx, B, S, heads))


def v_over_k_phase(att):
    """Step 16a: the one-block core where v goes over k, fp32 and bf16,
    against its plain version (fp32 at step 2's bars, bf16 at the cores')."""
    gen = torch.Generator().manual_seed(18)
    for name, B, S, W, heads, causal, s_valid in V_OVER_K_CASES:
        if not att.core_v_over_k(S, W // heads):
            raise AssertionError(f"{name}: v fits beside k")
        for dt in (torch.float32, torch.bfloat16):
            qkv = torch.randn(B * S, 3 * W, generator=gen).to("cuda", dt)
            args = (S, heads, causal, s_valid)
            att.reset_launch_counts()
            got = att.attn_core(qkv, *args)
            torch.cuda.synchronize()  # a fault in the kernel shows here
            if att.LAUNCHES["attn_core"] != 1:
                raise AssertionError(f"{name}: launches {att.LAUNCHES}")
            compare(f"attn_core {name} S={S} {dt}", got,
                    att.attn_core_reference(qkv, *args), dt, core=True)


def fp32_serving_phase(att, mha, layers, PLIP):
    """Step 16b: PLIP("random:ViT-B/32") in fp32, its default, at full depth:
    the launches of one encode of each tower (counts reset just before),
    the embeddings against the plain run (row cosine >= 0.9999, the same
    zero-shot argmax)."""
    arch, tiles, batch = FP32_SERVING
    model = PLIP(f"random:{arch}", device="cuda")
    if model.dtype != torch.float32:
        raise AssertionError(f"PLIP's default dtype is {model.dtype}")
    tag = f"[step 16] {arch} fp32"
    images = synthetic_images(tiles)
    plain = plain_towers(att, mha, layers)
    model.encode_images(images, batch_size=batch)  # warm-up
    model.encode_text(PROMPTS)
    torch.cuda.synchronize()
    att.reset_launch_counts()
    img = model.encode_images(images, batch_size=batch)
    torch.cuda.synchronize()
    launches = dict(att.LAUNCHES)
    att.reset_launch_counts()
    txt = model.encode_text(PROMPTS)
    torch.cuda.synchronize()
    text_launches = dict(att.LAUNCHES)
    print(f"{tag} launches: encode_images of {tiles} tiles in batches of {batch} {launches}, "
          f"encode_text of {len(PROMPTS)} prompts {text_launches}")
    for counts in (launches, text_launches):
        for k in KERNELS:
            if counts[k] == 0:
                raise AssertionError(f"{k} was never launched by the fp32 {arch} run")
    against_plain(model, images, plain, (att.LAUNCHES, mha.LAUNCHES), img, txt, 0.9999, True,
                  batch, tag)
    del model
    torch.cuda.empty_cache()
    return {k: launches[k] + text_launches[k] for k in ("gemm_bias_residual", "attn_core")}


def tiny_bf16_phase(att, bwd, mha):
    """Step 16c: CLIPConfig.tiny (head_dim 16 and 8) in bf16 on the card:
    one encode of each tower and one train step (make_train_step) against
    the plain path: embeddings row cosine >= 0.999, grads leaf cosine >=
    0.995; the kernel path launches attn_core and attn_core_bwd."""
    from plip_tpu_torch.models.clip import CLIP
    from plip_tpu_torch.models.config import CLIPConfig
    from plip_tpu_torch.train.contrastive import (clip_loss, init_train_state,
                                                  make_optimizer, make_train_step)

    cfg = CLIPConfig.tiny()
    model = CLIP(cfg).init_params(torch.Generator().manual_seed(0)).to("cuda")
    gen = torch.Generator().manual_seed(18)
    n = cfg.vision.image_size
    px = torch.randn(16, n, n, 3, generator=gen).to("cuda")
    ids = torch.randint(1, cfg.text.vocab_size - 1, (16, cfg.text.context_length),
                        generator=gen)
    ids[:, 9] = cfg.text.eot
    ids = ids.to("cuda")
    dt, plain = torch.bfloat16, PlainVersions(att, bwd, mha)

    def run():
        with torch.no_grad():
            emb = (model.encode_image(px, dt).float(), model.encode_text(ids, dt).float())
        model.zero_grad(set_to_none=True)
        loss, _ = clip_loss(model, px, ids, dt, "mlp")
        loss.backward()
        return emb, loss.item(), {k: p.grad.clone() for k, p in model.named_parameters()}

    for m in (att, bwd, mha):
        m.reset_launch_counts()
    emb, loss, grads = run()
    torch.cuda.synchronize()
    launches = {**att.LAUNCHES, **bwd.LAUNCHES}
    with plain:
        emb_ref, loss_ref, want = run()
    cos = [torch.nn.functional.cosine_similarity(a, b, dim=-1).min().item()
           for a, b in zip(emb, emb_ref)]
    leaf = min(torch.nn.functional.cosine_similarity(grads[k].flatten().double(),
                                                     w.flatten().double(), 0).item()
               for k, w in want.items() if w.abs().max() > 0)
    print(f"[step 16] tiny bf16 (head_dim {cfg.vision.width // cfg.vision.heads} and "
          f"{cfg.text.width // cfg.text.heads}): launches {launches}; image / text row cosine "
          f"min {cos[0]:.6f} / {cos[1]:.6f}, loss {loss:.5f} vs plain {loss_ref:.5f}, worst "
          f"leaf cosine {leaf:.6f}")
    if min(cos) < 0.999 or leaf < 0.995:
        raise AssertionError("tiny bf16: the kernel path disagrees with the plain path")
    opt = make_optimizer(base_lr=1e-5, warmup=1, total_steps=10)
    step = make_train_step(cfg, opt, dtype=dt, remat="mlp")
    state = init_train_state(model, opt)
    for m in (att, bwd):
        m.reset_launch_counts()
    state, metrics = step(state, px, ids)
    torch.cuda.synchronize()
    step_launches = {**att.LAUNCHES, **bwd.LAUNCHES}
    print(f"[step 16] tiny bf16 make_train_step: "
          f"{ {k: round(float(v), 5) for k, v in metrics.items()} }, launches {step_launches}")
    for counts in (launches, step_launches):
        if counts["attn_core"] == 0 or counts["attn_core_bwd"] == 0:
            raise AssertionError(f"tiny bf16: attn_core / attn_core_bwd not launched: {counts}")
    if not all(np.isfinite(float(v)) for v in metrics.values()):
        raise AssertionError(f"tiny bf16 train step: {metrics}")


# ---------------------------------------------------------------------------
# Step 17: the key-tiled cores at every head_dim; K2's fp32 kernels
# ---------------------------------------------------------------------------


def wide_head_phase(att, bwd, mha, blk):
    """Step 17a: attn_core (both schedules, key-tiled), attn_core_bwd
    (key-tiled), mha_core, mha_core_bwd, flash_core and headgrid_core at
    WIDE_HEAD_CASES in fp32 and bf16 against their plain versions (step 2's
    bars; bf16 the cores' bars), each launched once; K7 (block_bwd) where S
    <= 512, every leaf at the summed bars; mha_core and mha_core_bwd timed in
    turns beside SDPA at the first case."""
    gen = torch.Generator().manual_seed(20)
    for name, B, S, W, heads in WIDE_HEAD_CASES:
        D = W // heads
        for dt in (torch.float32, torch.bfloat16):
            qkv = torch.randn(B * S, 3 * W, generator=gen).to("cuda", dt)
            g = torch.randn(B * S, W, generator=gen).to("cuda", dt)
            causal, s_valid = False, None
            print(f"[step 17] {name}: B={B} S={S} W={W} heads={heads} {str(dt)[6:]}, routes "
                  f"{att.core_route(S, D, dt)}, {att.core_route(S, D, dt, backward=True)}")
            for m in (att, bwd, mha):
                m.reset_launch_counts()
            for defer in (False, True):
                args = (S, heads, causal, s_valid, defer)
                compare(f"attn_core defer={defer}", att.attn_core(qkv, *args),
                        att.attn_core_reference(qkv, *args), dt, core=True)
            ctx, dqkv = bwd.attn_core_bwd(qkv, g, S, heads, causal, s_valid)
            want = bwd.attn_core_bwd_reference(qkv, g, S, heads, causal, s_valid)
            compare("attn_core_bwd ctx", ctx, want[0], dt, core=True)
            compare("attn_core_bwd dqkv", dqkv, want[1], dt, core=True, ulps_bar=BWD_ULPS)
            for core, fn, ref in (("flash_core", mha.flash_core, mha.flash_core_reference),
                                  ("headgrid_core", mha.headgrid_core,
                                   mha.headgrid_core_reference)):
                compare(core, fn(qkv, S, heads, causal), ref(qkv, S, heads, causal), dt,
                        core=True)
            short = S <= mha.MAX_SEQ
            if short:
                compare("mha_core", mha.mha_core(qkv, S, heads, causal),
                        mha.mha_core_reference(qkv, S, heads, causal), dt, core=True)
                compare("mha_core_bwd", mha.mha_core_bwd(qkv, g, S, heads, causal),
                        mha.mha_core_bwd_reference(qkv, g, S, heads, causal), dt, core=True,
                        ulps_bar=BWD_ULPS)
            torch.cuda.synchronize()  # a fault in the kernels shows here
            want_launches = ({"attn_core": 2}, {"attn_core_bwd": 1},
                             {"mha_core": int(short), "mha_core_bwd": int(short),
                              "flash_core": 1, "headgrid_core": 1})
            for m, counts in zip((att, bwd, mha), want_launches):
                if any(m.LAUNCHES[k] != n for k, n in counts.items()):
                    raise AssertionError(f"{name}: launches {m.LAUNCHES}, expected {counts}")
            if name == WIDE_HEAD_CASES[0][0]:
                pairs = B * heads * S * S
                ms, plain_ms = in_turns(lambda: mha.mha_core(qkv, S, heads),
                                        lambda: mha.mha_core_reference(qkv, S, heads))
                peak = PEAK_FP32 if dt == torch.float32 else PEAK_FLOPS
                core_line(f"mha_core {name} {str(dt)[6:]}", ms, plain_ms, 4 * pairs * D,
                          4 * B * S * W * qkv.element_size(), sdpa_forward(qkv, B, S, heads),
                          peak)
                ms, plain_ms = in_turns(lambda: mha.mha_core_bwd(qkv, g, S, heads),
                                        lambda: mha.mha_core_bwd_reference(qkv, g, S, heads))
                core_line(f"mha_core_bwd {name} {str(dt)[6:]}", ms, plain_ms, 10 * pairs * D,
                          7 * B * S * W * qkv.element_size(),
                          sdpa_backward(qkv, g, B, S, heads), peak)
            del qkv, g, ctx, dqkv, want
            if S > mha.MAX_SEQ:
                continue
            p = block_params(W, gen)
            x = torch.randn(B * S, W, generator=gen).to("cuda", dt)
            gy = torch.randn(B * S, W, generator=gen).to("cuda", dt)
            blk.reset_launch_counts()
            got = dict(leaves(blk.block_bwd(x, gy, p, S, heads)))
            torch.cuda.synchronize()
            if blk.LAUNCHES["block_bwd"] != 1:
                raise AssertionError(f"{name}: block_bwd launches {blk.LAUNCHES}")
            ref = dict(leaves(blk.block_bwd_reference(x, gy, p, S, heads)))
            for k in ref:
                compare(f"block_bwd {k}", got[k], ref[k], dt, summed=True)
            del p, x, gy, got, ref
        torch.cuda.empty_cache()


def fp32_bwd_phase(pk):
    """Step 17b, fp32: grad_gemm's four products and attn_core_bwd at the
    shapes of profile_kernels against their plain versions (step 2's fp32
    bars; the TN products' atol scaled by their RMS), timed in turns beside
    the parent's kernel, the PyTorch call and the bound (fp32 at 67 TFLOP/s
    or bytes at 3.35 TB/s); the aims held or missed. Returns {kernel: the
    JSON line's fp32 numbers} at FP32_BWD_JSON_CASES and the worst error of
    each."""
    out, worst = {}, {"grad_gemm": 0.0, "attn_core_bwd": 0.0}
    held = lambda ok: "held" if ok else "missed"
    for case in pk.cases("cuda", torch.Generator().manual_seed(17)):
        if case.kernel not in worst:
            continue
        print(f"[step 17] {case.kernel} {case.label} fp32")
        got, want = case.fn(), case.plain()
        torch.cuda.synchronize()  # a fault in the kernel shows here
        pairs = zip(got, want) if isinstance(got, tuple) else ((got, want),)
        for i, (a, b) in enumerate(pairs):
            err = compare(f"{case.kernel} {case.label} [{i}]", a, b, torch.float32,
                          summed=case.label.startswith("TN"))
            worst[case.kernel] = max(worst[case.kernel], err)
        row = pk.measure(case)
        parent = PARENT_FP32_BWD_MS[case.label]
        ratio = row["ms"] / row["library_ms"]
        print(f"  {case.kernel} {case.label}: kernel {row['ms']:.4f} ms (device "
              f"{row['device_ms']:.4f}; {row['tflops']:.1f} TFLOP/s, {row['bound_share']:.2%} "
              f"of the bound {row['bound_ms']:.4f} ({row['bound_by']})), parent's kernel "
              f"{parent:.4f} ({parent / row['ms']:.2f}x), plain {row['plain_ms']:.4f}, "
              f"{row['library']} {row['library_ms']:.4f} (device {row['library_device_ms']:.4f}"
              f"): {ratio:.2f}x")
        if case.kernel == "grad_gemm":
            print(f"  aim, {case.label}: within {GRAD_GEMM_MATMUL_AIM}x of torch.matmul: "
                  f"{held(ratio <= GRAD_GEMM_MATMUL_AIM)}; no slower than the parent's "
                  f"{parent:.4f}: {held(row['ms'] <= parent)}")
        if case.label in CORE_BWD_AIM_CASES:
            pdev = PARENT_FP32_BWD_DEVICE_MS[case.label]
            print(f"  aim, {case.label}: device {row['device_ms']:.4f} ms at or under SDPA's "
                  f"backward {row['library_device_ms']:.4f}: "
                  f"{held(row['device_ms'] <= row['library_device_ms'])}; "
                  f"{CORE_BWD_SPEEDUP_AIM}x the parent's {pdev:.4f}: "
                  f"{held(pdev >= CORE_BWD_SPEEDUP_AIM * row['device_ms'])} "
                  f"({pdev / row['device_ms']:.2f}x); {row['bound_share']:.2%} of the bound")
        if case.label == FP32_BWD_JSON_CASES[case.kernel]:
            out[case.kernel] = {"case": case.label, "ms": row["ms"], "plain_ms": row["plain_ms"],
                                "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                                "library_ms": row["library_ms"]}
    return out, worst


def fp32_step_phase(att, bwd, mha, layers, tokenizer):
    """Step 17c: one full-depth fp32 train step (FP32_STEP, CLIPTuner's
    default dtype and remat) against the plain path (step_check: the
    loss within 1e-5 relative and every grad leaf's cosine >= 0.9999), every
    K2 kernel launched; then one make_train_step step (counts reset just
    before), whose launches of grad_gemm and attn_core_bwd go into the JSON
    line."""
    from plip_tpu_torch.models.clip import CLIP
    from plip_tpu_torch.models.config import ARCHITECTURES
    from plip_tpu_torch.train.contrastive import init_train_state, make_optimizer, make_train_step

    arch, batch, remat = FP32_STEP
    tag = f"[step 17] {arch} fp32 batch {batch} remat {remat}"
    counts = step_check(att, bwd, mha, tokenizer, arch, batch, remat, tag)
    missing = [k for k in BWD_KERNELS if counts[k] == 0]
    if missing:
        raise AssertionError(f"{tag}: launched no {missing}")
    cfg = ARCHITECTURES[arch]()
    model = CLIP(cfg).init_params(torch.Generator().manual_seed(0)).to("cuda")
    pixels, ids = train_batch(tokenizer, cfg, batch)
    opt = make_optimizer(base_lr=1e-6, warmup=1, total_steps=10)
    step = make_train_step(cfg, opt, dtype=torch.float32, remat=remat)
    state = init_train_state(model, opt)
    for m in (att, bwd):
        m.reset_launch_counts()
    state, metrics = step(state, pixels, ids)
    torch.cuda.synchronize()
    launches = {k: bwd.LAUNCHES[k] for k in ("grad_gemm", "attn_core_bwd")}
    print(f"{tag} make_train_step: {dict((k, round(float(v), 5)) for k, v in metrics.items())}, "
          f"launches {launches}")
    if not all(np.isfinite(float(v)) for v in metrics.values()) or not all(launches.values()):
        raise AssertionError(f"{tag} make_train_step: {metrics}, {launches}")
    del model, state
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# Step 18: the key-tiled cores off wgmma, redesigned; fp32 ViT-L/14
# ---------------------------------------------------------------------------


def tiled_phase(pk, att, bwd, mha):
    """Step 18a: every case of profile_kernels' TILED_CASES (the key-tiled
    cores in fp32 at ViT-L/14, @336 and B/16, and at ViT-H/14's and
    ViT-bigG/14's head_dims 80 and 104 in fp32 and bf16) against its plain
    version (step 2's bars; in bf16 the cores' bars, dqkv within BWD_ULPS);
    the cases of TILED_JSON_CASES timed in turns by profile_kernels beside
    the parent's kernel (PARENT_TILED_MS), SDPA and the bound (fp32 FLOPs at 67 TFLOP/s, bf16 at
    989, or bytes at 3.35 TB/s), the aims printed held or missed; then every
    core at head_dim 160 (WIDE_HEAD_CHECK), fp32 and bf16, against its plain
    version. Returns {kernel: the JSON line's fp32 numbers} at
    TILED_JSON_CASES and the worst error of each."""
    out, worst = {}, {"mha_core": 0.0, "mha_core_bwd": 0.0}
    held = lambda ok: "held" if ok else "missed"
    for case in pk.tiled_cases("cuda", torch.Generator().manual_seed(18)):
        got, want = case.fn(), case.plain()
        torch.cuda.synchronize()  # a fault in the kernel shows here
        pairs = zip(got, want) if isinstance(got, tuple) else ((got, want),)
        for i, (a, b) in enumerate(pairs):  # dqkv at the backwards' bar, a context at 1 ulp
            dqkv = case.kernel == "mha_core_bwd" or (case.kernel == "attn_core_bwd" and i == 1)
            err = compare(f"[step 18] {case.kernel} {case.label} [{i}]", a, b, case.dtype,
                          core=True, ulps_bar=BWD_ULPS if dqkv else 1)
            if case.dtype == torch.float32 and case.kernel in worst:
                worst[case.kernel] = max(worst[case.kernel], err)
        if TILED_JSON_CASES.get(case.kernel) != case.label:
            del got, want  # timed by python -m plip_tpu_torch.profile_kernels --tiled
            continue
        row = pk.measure(case)
        parent = PARENT_TILED_MS[case.kernel, case.label]
        sdpa = row["library_ms"] / row["ms"]
        print(f"  {case.kernel} {case.label}: kernel {row['ms']:.4f} ms (device "
              f"{row['device_ms']:.4f}; {row['tflops']:.1f} TFLOP/s, {row['bound_share']:.2%} "
              f"of the bound {row['bound_ms']:.4f} ({row['bound_by']})), parent's kernel "
              f"{parent:.4f} ({parent / row['ms']:.2f}x), plain {row['plain_ms']:.4f}, "
              f"{row['library']} {row['library_ms']:.4f} (device "
              f"{row['library_device_ms']:.4f}): {row['ms'] / row['library_ms']:.2f}x")
        aims = [f"{TILED_SPEEDUP_AIM}x the parent's {parent:.4f}: "
                f"{held(parent >= TILED_SPEEDUP_AIM * row['ms'])}"]
        if case.dtype == torch.float32:
            bar = BWD_SDPA_AIM if case.kernel.endswith("_bwd") else FWD_SDPA_AIM
            aims.append(f"within {bar}x of {row['library']}'s {row['library_ms']:.4f}: "
                        f"{held(row['ms'] <= bar * row['library_ms'])} ({1 / sdpa:.2f}x)")
        print(f"  aim, {case.kernel} {case.label}: " + "; ".join(aims))
        out[case.kernel] = {"case": case.label, "ms": row["ms"], "plain_ms": row["plain_ms"],
                            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                            "library_ms": row["library_ms"]}
        del got, want
        torch.cuda.empty_cache()
    B, S, heads = WIDE_HEAD_CHECK
    gen = torch.Generator().manual_seed(160)
    for dt in (torch.float32, torch.bfloat16):
        qkv = torch.randn(B * S, 3 * heads * 160, generator=gen).to("cuda", dt)
        g = torch.randn(B * S, heads * 160, generator=gen).to("cuda", dt)
        tag = f"[step 18] head_dim 160 B={B} S={S} heads={heads} {str(dt)[6:]}"
        print(f"{tag}: routes {att.core_route(S, 160, dt)}, {att.core_route(S, 160, dt, True)}")
        for m in (att, bwd, mha):
            m.reset_launch_counts()
        args = (S, heads, True, S - 7)
        compare(f"{tag} attn_core", att.attn_core(qkv, *args), att.attn_core_reference(qkv, *args),
                dt, core=True)
        ctx, dqkv = bwd.attn_core_bwd(qkv, g, *args)
        want = bwd.attn_core_bwd_reference(qkv, g, *args)
        compare(f"{tag} attn_core_bwd ctx", ctx, want[0], dt, core=True)
        compare(f"{tag} attn_core_bwd dqkv", dqkv, want[1], dt, core=True, ulps_bar=BWD_ULPS)
        compare(f"{tag} mha_core", mha.mha_core(qkv, *args), mha.mha_core_reference(qkv, *args),
                dt, core=True)
        compare(f"{tag} mha_core_bwd", mha.mha_core_bwd(qkv, g, *args),
                mha.mha_core_bwd_reference(qkv, g, *args), dt, core=True, ulps_bar=BWD_ULPS)
        for core in ("flash_core", "headgrid_core"):
            compare(f"{tag} {core}", getattr(mha, core)(qkv, S, heads, True),
                    getattr(mha, f"{core}_reference")(qkv, S, heads, True), dt, core=True)
        torch.cuda.synchronize()
        launches = {**att.LAUNCHES, **bwd.LAUNCHES, **mha.LAUNCHES}
        want_launches = {"attn_core": 1, "attn_core_bwd": 1, "mha_core": 1, "mha_core_bwd": 1,
                         "flash_core": 1, "headgrid_core": 1}
        if any(launches[k] != n for k, n in want_launches.items()):
            raise AssertionError(f"{tag}: launches {launches}, expected {want_launches}")
    return out, worst


def fp32_l14_serving_phase(att, mha, layers, PLIP):
    """Step 18b: PLIP("random:ViT-L/14") in fp32, its default, at full depth:
    one encode of FP32_L14_SERVING's tiles (counts reset just before)
    launches mha_core once a vision layer and batch; the embeddings against
    the plain run (row cosine >= 0.9999, the same zero-shot argmax).
    Returns mha_core's launches."""
    arch, tiles, batch = FP32_L14_SERVING
    model = PLIP(f"random:{arch}", device="cuda")
    if model.dtype != torch.float32:
        raise AssertionError(f"PLIP's default dtype is {model.dtype}")
    cfg = model.cfg
    tag = f"[step 18] {arch} fp32 ({cfg.vision.layers} vision layers, full depth)"
    images = synthetic_images(tiles)
    plain = plain_towers(att, mha, layers)
    model.encode_images(images, batch_size=batch)  # warm-up
    torch.cuda.synchronize()
    att.reset_launch_counts()
    mha.reset_launch_counts()
    img = model.encode_images(images, batch_size=batch)
    torch.cuda.synchronize()
    launches = {**att.LAUNCHES, **mha.LAUNCHES}
    want = cfg.vision.layers * -(-tiles // batch)
    print(f"{tag}: launches of one encode of {tiles} tiles in batches of {batch} {launches}")
    if launches["mha_core"] != want:
        raise AssertionError(f"{tag}: mha_core launched {launches['mha_core']}, expected {want}")
    txt = model.encode_text(PROMPTS)
    against_plain(model, images, plain, (att.LAUNCHES, mha.LAUNCHES), img, txt, 0.9999, True,
                  batch, tag)
    del model
    torch.cuda.empty_cache()
    return launches["mha_core"]


def step_check(att, bwd, mha, tokenizer, arch, batch, remat, tag, depth=None,
               dtype=torch.float32):
    """One train step (clip_loss at ``batch`` in ``dtype``, remat ``remat``;
    the towers cut to ``depth`` layers when given) against the plain path,
    which must launch no kernel: in fp32 the loss within 1e-5 relative and
    every grad leaf's cosine >= 0.9999, in bf16 every leaf's cosine >= 0.995.
    Returns the launches of the kernel path."""
    import dataclasses

    from plip_tpu_torch.models.clip import CLIP
    from plip_tpu_torch.models.config import ARCHITECTURES
    from plip_tpu_torch.train.contrastive import clip_loss

    cfg = ARCHITECTURES[arch]()
    if depth is not None:
        cfg = dataclasses.replace(cfg, vision=dataclasses.replace(cfg.vision, layers=depth),
                                  text=dataclasses.replace(cfg.text, layers=depth))
    model = CLIP(cfg).init_params(torch.Generator().manual_seed(0)).to("cuda")
    pixels, ids = train_batch(tokenizer, cfg, batch)

    def run():
        model.zero_grad(set_to_none=True)
        loss, _ = clip_loss(model, pixels, ids, dtype, remat)
        loss.backward()
        return loss.item(), {k: p.grad.clone() for k, p in model.named_parameters()}

    for m in (att, bwd, mha):
        m.reset_launch_counts()
    loss, got = run()
    torch.cuda.synchronize()
    counts = {**att.LAUNCHES, **bwd.LAUNCHES, **mha.LAUNCHES}
    with PlainVersions(att, bwd, mha):
        loss_ref, want = run()
    if {**att.LAUNCHES, **bwd.LAUNCHES, **mha.LAUNCHES} != counts:
        raise AssertionError(f"{tag}: the plain run launched a CUDA kernel")
    cos = {k: leaf_cosine(got[k], want[k]) for k in want}
    worst = min(cos, key=cos.get)
    rel = abs(loss - loss_ref) / abs(loss_ref)
    print(f"{tag}: {cfg.vision.layers} vision and {cfg.text.layers} text layers; loss "
          f"{loss:.7f} kernels, {loss_ref:.7f} plain (rel {rel:.2e}); {len(cos)} leaves, worst "
          f"cosine {cos[worst]:.7f} at {worst}; launches {counts}")
    fp32 = dtype == torch.float32
    if (fp32 and rel > 1e-5) or cos[worst] < (0.9999 if fp32 else 0.995):
        raise AssertionError(f"{tag}: the kernel path disagrees with the plain path")
    del model, got, want
    torch.cuda.empty_cache()
    return counts


def fp32_l14_step_phase(att, bwd, mha, tokenizer):
    """Step 18c: one full-depth fp32 ViT-L/14 step at batch 64, remat "mlp"
    (the hybrid: mha_core forward, K2's key-tiled core backward), against
    the plain path, every K2 kernel and mha_core launched; then a step under
    remat=False cut to FP32_L14_STEP's depth, whose core backward is K4
    (mha_core_bwd). Returns (mha_core's launches in the "mlp" step,
    mha_core_bwd's in the remat=False step)."""
    arch, batch, remat, depth = FP32_L14_STEP
    counts = step_check(att, bwd, mha, tokenizer, arch, batch, remat,
                             f"[step 18] {arch} fp32 batch {batch} remat {remat}")
    missing = [k for k in BWD_KERNELS + ("mha_core",) if counts[k] == 0]
    if missing:
        raise AssertionError(f"[step 18] {arch} {remat} step launched no {missing}")
    k4 = step_check(att, bwd, mha, tokenizer, arch, batch, False,
                         f"[step 18] {arch} fp32 batch {batch} remat False", depth)
    if k4["mha_core_bwd"] == 0:
        raise AssertionError(f"[step 18] {arch} remat=False step launched no mha_core_bwd")
    return counts["mha_core"], k4["mha_core_bwd"]


def wide_head_tower_phase(att, bwd, mha):
    """Step 18d: a tiny CLIPConfig of head_dim 160 in both towers
    (WIDE_HEAD_TOWER), fp32 and bf16: one encode of each tower and one
    step's grads against the plain path (fp32: row cosine >= 0.9999, loss
    1e-5 relative, leaf cosine >= 0.9999; bf16: 0.999 and 0.995), launching
    attn_core and attn_core_bwd on the key-tiled kernels."""
    from plip_tpu_torch.models.clip import CLIP
    from plip_tpu_torch.models.config import CLIPConfig, TextConfig, VisionConfig
    from plip_tpu_torch.train.contrastive import clip_loss

    width, heads = WIDE_HEAD_TOWER
    cfg = CLIPConfig(vision=VisionConfig(width=width, layers=2, heads=heads, image_size=64,
                                         patch_size=16),
                     text=TextConfig(width=width, layers=2, heads=heads, vocab_size=128,
                                     context_length=16), embed_dim=32)
    model = CLIP(cfg).init_params(torch.Generator().manual_seed(1)).to("cuda")
    gen = torch.Generator().manual_seed(160)
    n = cfg.vision.image_size
    px = torch.randn(16, n, n, 3, generator=gen).to("cuda")
    ids = torch.randint(1, cfg.text.vocab_size - 1, (16, cfg.text.context_length), generator=gen)
    ids[:, 9] = cfg.text.eot
    ids = ids.to("cuda")
    for dt, cos_bar, leaf_bar in ((torch.float32, 0.9999, 0.9999), (torch.bfloat16, 0.999, 0.995)):
        def run():
            with torch.no_grad():
                emb = (model.encode_image(px, dt).float(), model.encode_text(ids, dt).float())
            model.zero_grad(set_to_none=True)
            loss, _ = clip_loss(model, px, ids, dt, "mlp")
            loss.backward()
            return emb, loss.item(), {k: p.grad.clone() for k, p in model.named_parameters()}

        for m in (att, bwd, mha):
            m.reset_launch_counts()
        emb, loss, grads = run()
        torch.cuda.synchronize()
        launches = {**att.LAUNCHES, **bwd.LAUNCHES}
        with PlainVersions(att, bwd, mha):
            emb_ref, loss_ref, want = run()
        cos = [torch.nn.functional.cosine_similarity(a, b, dim=-1).min().item()
               for a, b in zip(emb, emb_ref)]
        leaf = min(leaf_cosine(grads[k], w) for k, w in want.items())
        rel = abs(loss - loss_ref) / abs(loss_ref)
        print(f"[step 18] head_dim {width // heads} tower {str(dt)[6:]}: launches {launches}; "
              f"image / text row cosine min {cos[0]:.7f} / {cos[1]:.7f}, loss {loss:.6f} vs "
              f"plain {loss_ref:.6f} (rel {rel:.2e}), worst leaf cosine {leaf:.7f}")
        if min(cos) < cos_bar or leaf < leaf_bar or (dt == torch.float32 and rel > 1e-5):
            raise AssertionError(f"head_dim {width // heads} tower: the kernel path disagrees")
        if launches["attn_core"] == 0 or launches["attn_core_bwd"] == 0:
            raise AssertionError(f"head_dim {width // heads} tower: launches {launches}")
    del model
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Step 19: the LayerNorm kernels redesigned; every LayerNorm of the towers on them
# ---------------------------------------------------------------------------


def ln_compare(label, got, want, dtype, scale=None) -> float:
    """Step 19's bars (PERF.md section 2): fp32 allclose 1e-5; bf16 every
    element within one bf16 ulp of its row's largest |want| (of ``scale``
    where given). Returns the largest |got - want|."""
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    if dtype == torch.float32:
        ok, extra = torch.allclose(got, want, atol=1e-5, rtol=1e-5), ""
    else:
        top = (want.abs() if scale is None else scale.float()).amax(-1, keepdim=True)
        _, e = torch.frexp(top.clamp_min(2.0 ** -126))
        ulps = ((got - want).abs() / torch.ldexp(torch.ones_like(top), e - 8)).max().item()
        ok, extra = ulps <= 1, f" worst={ulps:g} ulp of the row max"
    print(f"  {label}: max_abs_err={err:.3e}{extra} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: kernel disagrees with its plain version")
    return err


def ln_kernel_phase(pk, att, bwd):
    """Step 19a: ln_rows, ln_bwd_rows (dln fp32 with the residual g, as K2,
    K7 and K8 call it; dln in the compute dtype without g, as
    layer_norm_rows' backward) and the towers' LayerNorm against their plain
    versions at profile_kernels' LN_SHAPES, bf16 and fp32, reruns bit-equal;
    then the two kernels at LN_JSON_CASE timed (CUDA-event and device ms)
    beside the plain version, F.layer_norm's forward or backward and the
    bytes bound, the aims printed.
    Returns (worst error, the JSON line's times) by kernel."""
    gen = torch.Generator().manual_seed(19)
    worst = {"ln_rows": 0.0, "ln_bwd_rows": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        for label, N, W in pk.LN_SHAPES:
            x = (torch.randn(N, W, generator=gen) * 2 + 0.5).to("cuda", dtype)
            dln = torch.randn(N, W, generator=gen).to("cuda")
            g, dy = (torch.randn(N, W, generator=gen).to("cuda", dtype) for _ in range(2))
            sc = (1 + 0.1 * torch.randn(W, generator=gen)).to("cuda")
            bi = (0.1 * torch.randn(W, generator=gen)).to("cuda")
            tag = f"[step 19] {label} [{N}, {W}] {str(dtype)[6:]}"
            y = att.ln_rows(x, sc, bi)
            torch.cuda.synchronize()
            err = ln_compare(f"{tag} ln_rows", y, att.layer_norm_rows_reference(x, sc, bi), dtype)
            worst["ln_rows"] = max(worst["ln_rows"], err)
            if not torch.equal(att.ln_rows(x, sc, bi), y):
                raise AssertionError(f"{tag} ln_rows: a rerun gave other bits")
            for d, res, how in ((dln, g, "dln fp32, + g"), (dy, None, "dln compute dtype")):
                dx, partial = bwd.ln_bwd_rows(x, d, res, sc)
                torch.cuda.synchronize()
                want_dx, want_partial = bwd.ln_bwd_rows_reference(x, d, res, sc)
                err = ln_compare(f"{tag} ln_bwd_rows ({how}) dx", dx, want_dx, dtype,
                                 None if res is None else want_dx.abs() + res.abs())
                worst["ln_bwd_rows"] = max(worst["ln_bwd_rows"], err)
                compare(f"{tag} ln_bwd_rows ({how}) [dgamma | dbeta] of {len(partial)} "
                        f"partial rows", bwd.col_sum(partial),
                        bwd.col_sum_reference(want_partial), torch.float32, summed=True)
                again = bwd.ln_bwd_rows(x, d, res, sc)
                if not (torch.equal(again[0], dx) and torch.equal(again[1], partial)):
                    raise AssertionError(f"{tag} ln_bwd_rows: a rerun gave other bits")
            grads = []
            for fn in (att.layer_norm_rows, att.layer_norm_rows_reference):
                xl, sl, bl = (t.clone().requires_grad_() for t in (x, sc, bi))
                out = fn(xl, sl, bl)
                out.backward(dy)
                grads.append((out.detach(), xl.grad, sl.grad, bl.grad))
            (y1, dx1, ds1, db1), (y0, dx0, ds0, db0) = grads
            ln_compare(f"{tag} layer_norm_rows y", y1, y0, dtype)
            ln_compare(f"{tag} layer_norm_rows dx", dx1, dx0, dtype)
            compare(f"{tag} layer_norm_rows dscale", ds1, ds0, torch.float32, summed=True)
            compare(f"{tag} layer_norm_rows dbias", db1, db0, torch.float32, summed=True)
    timed = {}
    for case in pk.ln_cases("cuda", torch.Generator().manual_seed(0)):
        if case.kernel == "layer_norm_rows" or not case.label.startswith(LN_JSON_CASE):
            continue  # timed by python -m plip_tpu_torch.profile_kernels --ln
        row = pk.measure(case, plain_device=True)
        share = row["bound_ms"] / row["device_ms"]
        print(f"[step 19] {case.kernel} {case.label}: device {row['device_ms']:.4f} ms "
              f"(CUDA-event {row['ms']:.4f}), plain device {row['plain_device_ms']:.4f} "
              f"({row['plain_ms']:.4f}), {row['library']} device "
              f"{row['library_device_ms']:.4f} ({row['library_ms']:.4f}); bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']}), {share:.1%} of it")
        shape = tuple(int(n) for n in case.label.split("[")[1].split("]")[0].split(","))
        if shape in LN_AIM_SHAPES:
            print(f"  aim, at least {LN_BOUND_AIM:.0%} of the bound in device ms: "
                  f"{'held' if share >= LN_BOUND_AIM else 'missed'}")
        print(f"  aim, no slower than {row['library']} in device ms: "
              f"{'held' if row['device_ms'] <= row['library_device_ms'] else 'missed'}")
        timed[case.kernel] = {k: row[k] for k in (
            "ms", "device_ms", "plain_ms", "plain_device_ms", "bound_ms", "bound_by",
            "library_ms", "library_device_ms")}
        timed[case.kernel]["case"] = case.label
    return worst, timed


def profiled_run(fn, calls=2):
    """(device ms, kernel launches) of one call of ``fn`` under torch.profiler,
    the mean of ``calls`` after one unprofiled call."""
    from torch.profiler import ProfilerActivity, profile

    from plip_tpu_torch.profile_train import kernel_times

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by_name = kernel_times(prof, calls)
    return sum(t for _, t in by_name.values()), sum(n for n, _ in by_name.values())


def ln_step_phase(att, bwd, mha, tokenizer):
    """Step 19b: the full-depth ViT-B/32 "mlp" step at batch 128 (LN_STEP),
    bf16 and fp32, against the plain path (step_check), which launches no
    LayerNorm kernel; ln_rows launched 8L + 3 times and ln_bwd_rows 4L + 3
    (L layers a tower: every LayerNorm once forward and once backward, LN1
    and LN2 once more each in K2's and the checkpoint's recompute). Returns
    the bf16 step's LayerNorm launches."""
    from plip_tpu_torch.models.config import ARCHITECTURES

    arch, batch, remat = LN_STEP
    cfg = ARCHITECTURES[arch]()
    L = cfg.vision.layers
    assert cfg.text.layers == L
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        tag = f"[step 19] {arch} {str(dtype)[6:]} batch {batch} remat {remat}"
        counts = step_check(att, bwd, mha, tokenizer, arch, batch, remat, tag, dtype=dtype)
        ln = {"ln_rows": counts["ln_rows"], "ln_bwd_rows": counts["ln_bwd_rows"]}
        print(f"{tag}: LayerNorm launches {ln}, expected ln_rows {8 * L + 3}, ln_bwd_rows "
              f"{4 * L + 3}")
        if ln != {"ln_rows": 8 * L + 3, "ln_bwd_rows": 4 * L + 3}:
            raise AssertionError(f"{tag}: a LayerNorm did not run the kernels")
        out.setdefault("launches", ln)
    return out["launches"]


def ln_encode_phase(att, mha, layers, PLIP):
    """Step 19c: PLIP("random:ViT-B/32", bf16) encodes 256 tiles in batches of
    32 (LN_ENCODE): ln_rows launched 2L + 2 times a batch, the embeddings
    against the plain path (no LayerNorm kernel launched: row cosine >=
    0.999)."""
    arch, tiles, batch = LN_ENCODE
    model = PLIP(f"random:{arch}", dtype=torch.bfloat16, device="cuda")
    images = synthetic_images(tiles, seed=19)
    tag = f"[step 19] {arch} bf16 encode_images, {tiles} tiles in batches of {batch}"
    model.encode_images(images[:batch], batch_size=batch)  # warm-up
    model.encode_text(PROMPTS)
    att.reset_launch_counts()
    img = model.encode_images(images, batch_size=batch)
    torch.cuda.synchronize()
    want = (2 * model.cfg.vision.layers + 2) * -(-tiles // batch)
    print(f"{tag}: launches {dict(att.LAUNCHES)}, ln_rows expected {want}")
    if att.LAUNCHES["ln_rows"] != want:
        raise AssertionError(f"{tag}: a LayerNorm did not run ln_rows")
    plain = plain_towers(att, mha, layers)
    against_plain(model, images, plain, (att.LAUNCHES, mha.LAUNCHES), img,
                  model.encode_text(PROMPTS), 0.999, False, batch, tag)
    del model
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# step 20: torch state_dicts and device retrieval
# ---------------------------------------------------------------------------


def same_state(a, b) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k].cpu(), b[k].cpu()) for k in a)


def checkpoint_phase(att, PLIP):
    """Step 20a: PLIP("random:ViT-B/32") in fp32 saved as OpenAI- and
    HF-named torch files; each loads back bit-equal and encodes 64 tiles and
    8 prompts through K1's kernels to the original's embeddings, bit-equal;
    CLIPTuner(backbone=) loads the same parameters; a bf16 copy of the OpenAI
    dict loads as its fp32 values; import_checkpoint --skip-verify and
    export_checkpoint give back the first dict. Returns the model."""
    import tempfile

    from plip_tpu_torch.scripts import export_checkpoint, import_checkpoint
    from plip_tpu_torch.train.clip_tuner import CLIPTuner
    from plip_tpu_torch.utils.checkpoint import from_openai_clip

    arch, tiles = CKPT_CHECK
    orig = PLIP(f"random:{arch}", device="cuda")
    images = synthetic_images(tiles, seed=20)
    want = orig.encode_images(images), orig.encode_text(PROMPTS)
    state = orig.model.state_dict()
    with tempfile.TemporaryDirectory() as d:
        paths = {}
        for fmt in ("openai", "hf"):
            t = time.perf_counter()
            paths[fmt] = orig.save(os.path.join(d, f"{fmt}.pt"), format=fmt)
            t_save = time.perf_counter() - t
            loaded = PLIP(paths[fmt], device="cuda")
            t_load = time.perf_counter() - t - t_save
            if loaded.cfg != orig.cfg or not same_state(loaded.model.state_dict(), state):
                raise AssertionError(f"[step 20] {fmt}: the loaded state_dict differs")
            att.reset_launch_counts()
            got = loaded.encode_images(images), loaded.encode_text(PROMPTS)
            torch.cuda.synchronize()
            launches = dict(att.LAUNCHES)
            worst = max(float(np.abs(g - w).max()) for g, w in zip(got, want))
            print(f"[step 20] {arch} fp32 {fmt}: {os.path.getsize(paths[fmt]) / 2**20:.1f} "
                  f"MiB, save {t_save:.2f} s, load {t_load:.2f} s; state_dict bit-equal; "
                  f"{tiles} tiles and {len(PROMPTS)} prompts, worst |difference| {worst:.3g}; "
                  f"launches {launches}")
            if worst != 0.0:
                raise AssertionError(f"[step 20] {fmt}: embeddings differ from the original's")
            if not all(launches.values()):
                raise AssertionError(f"[step 20] {fmt}: a K1 kernel did not run: {launches}")
            del loaded
        tuner = CLIPTuner(backbone=paths["openai"], device="cuda")
        if tuner.cfg != orig.cfg or not same_state(tuner.model.state_dict(), state):
            raise AssertionError("[step 20] CLIPTuner(backbone=) loaded other parameters")
        del tuner
        sd = torch.load(paths["openai"], map_location="cpu", weights_only=True)
        bf16_path = os.path.join(d, "bf16.pt")
        torch.save({k: v.to(torch.bfloat16) for k, v in sd.items()}, bf16_path)
        half = PLIP(bf16_path, device="cuda")
        upcast, _ = from_openai_clip({k: v.to(torch.bfloat16).float() for k, v in sd.items()})
        if not same_state(half.model.state_dict(), upcast):
            raise AssertionError("[step 20] the bf16 dict did not load as its fp32 values")
        del half
        t = time.perf_counter()
        summary = import_checkpoint.main([paths["openai"], "--out", os.path.join(d, "imported"),
                                          "--skip-verify", "--device", "cuda"])
        back = export_checkpoint.main([summary["checkpoint"], os.path.join(d, "back.pt"),
                                       "--naming", "openai", "--device", "cuda"])
        again = torch.load(back, map_location="cpu", weights_only=True)
        if not same_state(again, sd):
            raise AssertionError("[step 20] import_checkpoint + export_checkpoint changed the dict")
        print(f"[step 20] CLIPTuner(backbone=) and the bf16 dict load the same parameters; "
              f"import_checkpoint --skip-verify + export_checkpoint round trip bit-equal "
              f"({time.perf_counter() - t:.1f} s)")
    return orig


def margin_crusher(rng, n, d, gap):
    """tests/test_retrieval_adversarial.py's corpus: rows whose scores to one
    query descend in ``gap`` steps, far below int8 noise."""
    q = rng.standard_normal(d).astype(np.float64)
    q /= np.linalg.norm(q)
    orth = rng.standard_normal((n, d))
    orth -= np.outer(orth @ q, q)
    orth /= np.linalg.norm(orth, axis=1, keepdims=True)
    target = 0.9 - gap * np.arange(n)
    x = target[:, None] * q[None, :] + np.sqrt(1 - target**2)[:, None] * orth
    return x.astype(np.float32), q.astype(np.float32)[None, :]


def host_exact(q, x, k):
    """The exact ranking on the host (queries normalized): argpartition, then
    a stable sort of the k best."""
    s = (q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-12)) @ x.T
    part = np.argpartition(-s, k, axis=1)[:, :k]
    order = np.argsort(-np.take_along_axis(s, part, 1), axis=1, kind="stable")
    idx = np.take_along_axis(part, order, 1)
    return idx, np.take_along_axis(s, idx, 1)


def host_ms(fn, reps=RETRIEVAL_REPS):
    """Host-clock ms of each of ``reps`` calls after a warm-up, each ending
    in a synchronize."""
    fn()
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t) * 1e3)
    return out


def retrieval_phase(model, card):
    """Step 20b: ops.retrieval on a seed-0 corpus of RETRIEVAL_ROWS x 512 on
    the card. At the largest size cosine_topk and cosine_topk_int8 (rescored)
    give the host's exact top-k (fp32 scores within 1e-5 relative); the
    margin crusher trips the int8 probe (two streams, then the fp32
    fallback) and still returns the exact top-k; each call timed at each size
    in host-clock ms, retrieval(backend="host") at the smallest; at the auto
    gate's sizes the API's host and device times, and "auto" takes the
    device at 262,144 rows; at PAD_ROWS, one short of a chunk multiple, the
    API's fp32 and int8 device indices (padded once, the pad rows masked by
    n_valid) give the host's top-k."""
    from plip_tpu_torch import api
    from plip_tpu_torch.ops import retrieval as R

    n_max, d = max(RETRIEVAL_ROWS), model.cfg.embed_dim
    g = torch.Generator(device="cuda").manual_seed(0)
    corpus = torch.randn((n_max, d), generator=g, device="cuda")
    queries = torch.randn((RETRIEVAL_Q, d), generator=g, device="cuda").cpu().numpy()
    x = corpus.cpu().numpy()
    t = time.perf_counter()
    q8, inv = R.quantize_rows(x, normalize=False)  # per row: a prefix is a smaller index
    q8d, invd = torch.as_tensor(q8, device="cuda"), torch.as_tensor(inv, device="cuda")
    print(f"[step 20] corpus {n_max} x {d} fp32 ({corpus.numel() * 4 / 2**30:.2f} GiB on the "
          f"card), int8 {q8.nbytes / 2**20:.0f} MiB + {inv.nbytes / 2**20:.0f} MiB of scales "
          f"(quantized in {time.perf_counter() - t:.1f} s); Q={RETRIEVAL_Q}, k={RETRIEVAL_K}; "
          f"card {card}")
    k, chunk = RETRIEVAL_K, api.RETRIEVAL_CHUNK
    for n in RETRIEVAL_ROWS:
        f32 = lambda: R.cosine_topk(queries, corpus[:n], k=k, normalize="queries",  # noqa: E731
                                    chunk=chunk)
        i8 = lambda: R.cosine_topk_int8(queries, q8d[:n], invd[:n], k=k,  # noqa: E731
                                        rescore_vectors=x[:n], chunk=chunk)
        tag = f"[step 20] N={n}"
        if n == n_max:
            ref_i, ref_v = host_exact(queries, x, k)
            got_i, got_v = f32()
            rel = float((np.abs(got_v - ref_v) / np.abs(ref_v)).max())
            if not np.array_equal(got_i, ref_i) or rel > 1e-5:
                raise AssertionError(f"{tag}: cosine_topk is not the exact top-k (rel {rel:.3g})")
            if not np.array_equal(i8()[0], ref_i):
                raise AssertionError(f"{tag}: cosine_topk_int8 is not the exact top-k")
            print(f"{tag}: cosine_topk and cosine_topk_int8 (rescored) give the host's exact "
                  f"top-{k}; fp32 scores within {rel:.3g} relative")
        print(f"{tag}: host-clock ms, device fp32 {host_ms(f32)}, device int8 {host_ms(i8)}; "
              f"card {card}")
        for name, fn, nbytes, peak in (("fp32", f32, n * d * 4, PEAK_FP32),
                                       ("int8", i8, n * (d + 4), INT8_OPS)):
            dev_ms, launches = profiled_run(fn)
            b_ms, b_by = bound(2 * RETRIEVAL_Q * n * d, nbytes, peak)
            print(f"{tag} {name}: device ms {dev_ms:.3f} in {launches:.0f} kernel launches; "
                  f"bound {b_ms:.4f} ms ({b_by}; the index read once, the dots at "
                  f"{peak / 1e12:.0f} T/s)")
        if n == min(RETRIEVAL_ROWS):
            hv = x[:n]
            ms = host_ms(lambda: model._nearest_neighbours(k, queries, hv))
            print(f"{tag}: host-clock ms, host (numpy, the API's host backend) {ms}; card {card}")

    rng = np.random.default_rng(2)
    xc, qc = margin_crusher(rng, *CRUSHER)
    c8, cinv = R.quantize_rows(xc, normalize=False)
    with mock.patch.object(R, "_scan_int8", wraps=R._scan_int8) as streams, \
            mock.patch.object(R, "_scan_f32", wraps=R._scan_f32) as fallback:
        got = R.cosine_topk_int8(qc, torch.as_tensor(c8, device="cuda"),
                                 torch.as_tensor(cinv, device="cuda"), k=k, rescore_vectors=xc,
                                 chunk=1024)
    ref = host_exact(qc, xc, k)
    print(f"[step 20] margin crusher {CRUSHER}: {streams.call_count} int8 streams, "
          f"{fallback.call_count} fp32 fallback")
    if streams.call_count != 2 or fallback.call_count != 1:
        raise AssertionError("[step 20] the margin crusher did not trip the probe")
    if not np.array_equal(got[0], ref[0]):
        raise AssertionError("[step 20] the margin crusher's top-k is not exact")

    texts = [f"{p}, case {i}" for i in range(RETRIEVAL_Q // len(PROMPTS)) for p in PROMPTS]
    for n in GATE_ROWS:
        model.set_image_index(x[:n])
        host = model.retrieval(texts, top_k=k, backend="host")
        dev = model.retrieval(texts, top_k=k, backend="device")
        if not np.array_equal(host, dev):
            raise AssertionError(f"[step 20] N={n}: device retrieval differs from the host's")
        ms = {b: host_ms(lambda: model.retrieval(texts, top_k=k, backend=b))
              for b in ("host", "device")}
        print(f"[step 20] retrieval() N={n} Q={len(texts)} (N*Q = 2^"
              f"{np.log2(n * len(texts)):.0f}), host-clock ms: host {ms['host']}, device "
              f"{ms['device']}; card {card}")
    model._device_index_key = None
    auto = model.retrieval(texts, top_k=k, backend="auto")
    if model._device_index_key is None or not np.array_equal(auto, dev):
        raise AssertionError("[step 20] backend='auto' did not take the device at the gate")
    print(f"[step 20] retrieval(backend='auto') at N={n}, Q={len(texts)} took the device")

    n = PAD_ROWS  # not a chunk multiple: the API pads the index once, n_valid masks the pad
    for quantize in (False, "int8"):
        model.set_image_index(x[:n], quantize=quantize)
        host = model.retrieval(texts, top_k=k, backend="host")
        dev = model.retrieval(texts, top_k=k, backend="device")
        index = model._device_index_cache
        rows = (index[0] if quantize else index).shape[0]
        if rows % chunk or rows == n or not np.array_equal(host, dev):
            raise AssertionError(f"[step 20] N={n} {quantize or 'fp32'}: device retrieval "
                                 f"over the padded index ({rows} rows) differs from the host's")
        ms = host_ms(lambda: model.retrieval(texts, top_k=k, backend="device"))
        print(f"[step 20] retrieval() N={n} ({rows} rows on the card) index "
              f"{quantize or 'fp32'}: the host's top-{k}; host-clock ms device {ms}; card {card}")
    model._device_index_cache = model._device_index_key = None


# ---------------------------------------------------------------------------
# step 21: W8A8 serving and the reproducibility harness
# ---------------------------------------------------------------------------


def tower_linears(tower):
    """Every linear ParameterDict of a tower's blocks."""
    return [getattr(b, half)[n] for b in tower.blocks
            for half, names in (("attn", ("qkv", "out")), ("mlp", ("fc1", "fc2")))
            for n in names]


def w8a8_phase(att, mha, layers, PLIP, card):
    """Step 21a's serving runs (module doc)."""
    from plip_tpu_torch.ops import quant

    images = synthetic_images(W8A8_TILES, seed=21)
    counts = (att.LAUNCHES, mha.LAUNCHES)
    plain = plain_towers(att, mha, layers)
    for arch, batch, core, dtypes in W8A8_SERVING:
        tag = f"[step 21 {arch} w8a8]"
        t = time.perf_counter()
        model = PLIP(f"random:{arch}", dtype=torch.bfloat16, device="cuda", quantize="w8a8")
        base = PLIP(f"random:{arch}", dtype=torch.bfloat16, device="cuda")  # the same weights
        vis, txt = tower_linears(model.model.visual), tower_linears(model.model.text)
        if any("kernel" in p or p["kernel_q"].dtype != torch.int8 or not p["kernel_q"].is_cuda
               for p in vis) or any("kernel_q" in p or p["kernel"].dtype != torch.float32
                                    or not p["kernel"].is_cuda for p in txt):
            raise AssertionError(f"{tag}: the quantized model's structure is not W8A8 vision only")
        print(f"{tag} both models built in {time.perf_counter() - t:.1f} s: {len(vis)} int8 "
              f"linears (kernel_q on the card) in the vision tower, {len(txt)} fp32 in the text "
              f"tower")
        L, nb = model.cfg.vision.layers, -(-W8A8_TILES // batch)
        model.encode_images(images, batch_size=batch)  # warm-up: cuBLAS, the allocator
        base.encode_images(images, batch_size=batch)
        for dtype in dtypes:
            model.dtype = base.dtype = dtype
            d = str(dtype)[6:]
            for m in (att, mha, quant):
                m.reset_launch_counts()
            img = model.encode_images(images, batch_size=batch)
            torch.cuda.synchronize()
            launches = {k: v for c in (*counts, quant.LAUNCHES) for k, v in c.items() if v}
            print(f"{tag} {d}: the launches of one encode of {W8A8_TILES} tiles in {nb} "
                  f"batches: {launches}")
            if (mha.LAUNCHES[core] != L * nb or att.LAUNCHES["attn_core"]
                    or att.LAUNCHES["gemm_bias_residual"] or not att.LAUNCHES["ln_rows"]
                    or quant.LAUNCHES["int8_mm"] != 4 * L * nb):
                raise AssertionError(f"{tag} {d}: expected {core} {L} times a batch, no K1 "
                                     f"sublayer kernel and {4 * L} int8 products a batch")
            if img.shape != (W8A8_TILES, model.cfg.embed_dim) or not np.isfinite(img).all():
                raise AssertionError(f"{tag} {d}: embeddings {img.shape}, or not finite")
            before = [dict(c) for c in counts]
            with plain:
                ref = model.encode_images(images, batch_size=batch)
            if [dict(c) for c in counts] != before:
                raise AssertionError(f"{tag}: the plain run launched a CUDA kernel")
            # fp32 holds the cosine bar only: the cores' last-bit differences
            # flip activation integers, each flip worth about 1e-2 of an
            # embedding (tests/test_torch_quant.py), so |difference| is printed
            cos, err = row_cos(img, ref).min(), float(np.abs(img - ref).max())
            ok = cos >= 0.999 if dtype == torch.bfloat16 else cos > 0.9999
            print(f"{tag} {d} against the same model with plain cores and LayerNorm: row cosine "
                  f"min {cos:.7f}, max |difference| {err:.3e} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{tag} {d}: the kernels disagree with the plain path")
            unq = base.encode_images(images, batch_size=batch)
            uc = row_cos(img, unq)
            print(f"{tag} {d} against the unquantized tower at the same weights (printed, not "
                  f"held): row cosine min {uc.min():.7f}, mean {uc.mean():.7f}")
            q = rate(lambda: model.encode_images(images, batch_size=batch), W8A8_TILES)
            u = rate(lambda: base.encode_images(images, batch_size=batch), W8A8_TILES)
            print(f"{tag} {d} images/s ({W8A8_TILES} tiles of 256x256 uint8 in batches of "
                  f"{batch}, preprocess to {model.cfg.vision.image_size} on the card): "
                  f"w8a8 {q:.1f}, unquantized {u:.1f}; card {card}")
        model.dtype = torch.bfloat16
        att.reset_launch_counts()
        emb = model.encode_text(PROMPTS)
        torch.cuda.synchronize()
        if not att.LAUNCHES["attn_core"] or not np.isfinite(emb).all():
            raise AssertionError(f"{tag}: the unquantized text tower did not run K1")
        print(f"{tag} the text tower stays on K1: {dict(att.LAUNCHES)}")
        del model, base
        torch.cuda.empty_cache()


def int8_gemm_phase(card):
    """Step 21a's products: torch._int_mm (int8 in, int32 out, the second
    operand column-major as kernel_q is) against bf16 torch.matmul at the
    four L/14 vision linears, and the whole W8A8 linear (activation
    quantization, product, dequantization) against the bf16 linear."""
    from plip_tpu_torch.ops import attention as att
    from plip_tpu_torch.ops import quant

    g = torch.Generator(device="cuda").manual_seed(21)
    M = INT8_M
    for name, K, N in INT8_LINEARS:
        a8 = torch.randint(-127, 128, (M, K), generator=g, device="cuda", dtype=torch.int8)
        b8 = torch.randint(-127, 128, (N, K), generator=g, device="cuda", dtype=torch.int8).T
        x = torch.randn(M, K, generator=g, device="cuda").bfloat16()
        p = {"kernel": torch.randn(K, N, generator=g, device="cuda") * K ** -0.5,
             "bias": torch.randn(N, generator=g, device="cuda") * 0.02}
        pq = quant.quantize_linear(p)
        w16 = p["kernel"].bfloat16()
        i8_ms, bf16_ms = in_turns(lambda: torch._int_mm(a8, b8), lambda: torch.matmul(x, w16))
        lin_ms, lin_bf16_ms = in_turns(lambda: quant.linear_w8a8(x, pq),
                                       lambda: att.linear(x, p))
        flops = 2 * M * K * N
        b_i8 = bound(flops, M * K + K * N + 4 * M * N, INT8_OPS)
        b_bf16 = bound(flops, 2 * (M * K + K * N + M * N), PEAK_FLOPS)
        print(f"[step 21] {name} [{M}, {K}] x [{K}, {N}]: torch._int_mm {i8_ms:.4f} ms "
              f"({flops / i8_ms / 1e9:.0f} TOP/s; bound {b_i8[0]:.4f} ms, {b_i8[1]}), bf16 "
              f"torch.matmul {bf16_ms:.4f} ms ({flops / bf16_ms / 1e9:.0f} TFLOP/s; bound "
              f"{b_bf16[0]:.4f} ms, {b_bf16[1]}); the W8A8 linear {lin_ms:.4f} ms against the "
              f"bf16 linear {lin_bf16_ms:.4f} ms; card {card}")


def probe_data(classes, n_train, n_test, noise, seed=0, dim=512):
    """Unit rows around ``classes`` random centres, labelled by centre."""
    rng = np.random.default_rng(seed)
    centres = rng.standard_normal((classes, dim))
    y = rng.integers(0, classes, n_train + n_test)
    e = centres[y] + rng.standard_normal((len(y), dim)) * noise
    return (e / np.linalg.norm(e, axis=1, keepdims=True)).astype(np.float32), y


def harness_phase(att, mha, PLIP, card):
    """Step 21b (module doc)."""
    import tempfile

    from PIL import Image

    from plip_tpu_torch.embedders import EmbedderFactory
    from plip_tpu_torch.eval.linear_probe import (LinearProber, TorchLogisticRegression,
                                                  encode_labels)
    from plip_tpu_torch.eval.retrieval import ImageRetrieval
    from plip_tpu_torch.eval.zero_shot import ZeroShotClassifier

    arch, tiles = HARNESS
    classes = ("benign", "malignant")
    labels = [classes[i % 2] for i in range(tiles)]
    imgs = synthetic_images(tiles, seed=22).astype(np.int16)
    imgs[1::2] += np.array([-40, -30, 40], np.int16)  # the second class bluer
    imgs = np.clip(imgs, 0, 255).astype(np.uint8)
    keys = ("PC_CACHE_FOLDER", "PC_RESULTS_FOLDER", "PC_EVALUATION_DATA_ROOT_FOLDER")
    saved = {k: os.environ.get(k) for k in keys}
    with tempfile.TemporaryDirectory() as d:
        paths = []
        for i, im in enumerate(imgs):
            paths.append(os.path.join(d, f"tile_{i}.png"))
            Image.fromarray(im).save(paths[-1])
        ckpt = os.path.join(d, "plip_b32.npz")
        t = time.perf_counter()
        PLIP(f"random:{arch}", device="cuda").save(ckpt)
        print(f"[step 21b] {tiles} tiles in two classes and a full-width {arch} .npz "
              f"({os.path.getsize(ckpt) / 2**20:.0f} MiB, {time.perf_counter() - t:.1f} s) "
              f"written")
        os.environ.update({k: os.path.join(d, k.split("_")[1].lower()) for k in keys})
        try:
            emb = EmbedderFactory().factory(SimpleNamespace(model_name="plip", backbone=ckpt,
                                                            device="cuda"))
            runs = []
            for _ in range(2):
                att.reset_launch_counts()
                mha.reset_launch_counts()
                t = time.perf_counter()
                x = emb.image_embedder(paths, additional_cache_name="chip_test.csv")
                torch.cuda.synchronize()
                runs.append((x, sum(att.LAUNCHES.values()) + sum(mha.LAUNCHES.values()),
                             time.perf_counter() - t))
            (x, first, t1), (x2, second, t2) = runs
            print(f"[step 21b] image_embedder: the first call {first} kernel launches in "
                  f"{t1:.2f} s (the cache written), the second {second} in {t2:.3f} s")
            if not first or second or not np.array_equal(x, x2):
                raise AssertionError("[step 21b] the second call did not hit the cache")
            raw = emb.model.encode_images(paths)
            if not np.array_equal(x, raw / np.linalg.norm(raw, axis=1, keepdims=True)):
                raise AssertionError("[step 21b] the embeddings are not PLIP.encode_images' "
                                     "L2-normalized")
            prompts = [f"an H&E image of {c} tissue" for c in classes]
            txt = emb.text_embedder(prompts, additional_cache_name="chip_test.csv")
            if not np.array_equal(emb.text_embedder(prompts, additional_cache_name=
                                                    "chip_test.csv"), txt):
                raise AssertionError("[step 21b] text_embedder missed its cache")
            captions = [f"an H&E image of {lab} tissue, tile {i}" for i, lab in enumerate(labels)]
            cap = emb.text_embedder(captions, additional_cache_name="chip_retrieval.tsv")
            for e in (x, txt, cap):
                if not np.allclose(np.linalg.norm(e, axis=1), 1.0, atol=1e-5):
                    raise AssertionError("[step 21b] embeddings not L2-normalized")
            _, zs = ZeroShotClassifier().zero_shot_classification(x, txt, classes, labels)
            _, rt = ImageRetrieval().retrieval(x, cap)
            print(f"[step 21b] zero-shot (random weights) accuracy {zs['Accuracy']:.4f}, "
                  f"WF1 {zs['WF1']:.4f}, mcc {zs['mcc']:.4f}; retrieval p@10 {rt['p@10']:.4f}, "
                  f"p@50 {rt['p@50']:.4f}")
            n_tr = tiles * 3 // 4
            pair = x @ x.T
            print(f"[step 21b] the tiles' embeddings: mean pairwise cosine "
                  f"{(pair.sum() - tiles) / (tiles * tiles - tiles):.4f}")
            kather = probe_data(*PROBE_DATA)
            for tag, ex, ey, n_tr, held in (("tiles", x, np.array(labels), n_tr, False),
                                            ("Kather-like", *kather, PROBE_DATA[1], True)):
                t = time.perf_counter()
                fit, (test_m, train_m) = LinearProber(alpha=0.01, seed=1, backend="torch",
                                                      device="cuda").train_and_test(
                    ex[:n_tr], list(ey[:n_tr]), ex[n_tr:], list(ey[n_tr:]))
                t_card = time.perf_counter() - t
                _, ytr, _ = encode_labels(list(ey[:n_tr]), list(ey[n_tr:]))
                t = time.perf_counter()
                cpu = TorchLogisticRegression(0.01, 1, device="cpu").fit(ex[:n_tr], ytr)
                t_cpu = time.perf_counter() - t
                agree = float((fit.predict(ex) == cpu.predict(ex)).mean())
                bar = f"bar {PROBE_AGREE}" if held else "printed, not held"
                print(f"[step 21b] LinearProber(backend='torch') on {tag} {ex.shape}: the "
                      f"card's fit {t_card:.2f} s, the CPU's {t_cpu:.2f} s; test accuracy "
                      f"{test_m['Accuracy']:.4f}, train {train_m['Accuracy']:.4f}; objective "
                      f"{fit.loss:.6f} (CPU {cpu.loss:.6f}); predictions agree with the CPU's "
                      f"fit on {agree:.4f} of the rows ({bar}); card {card}")
                if held and agree < PROBE_AGREE:
                    raise AssertionError("[step 21b] the card's probe disagrees with the CPU's")
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("sklearn", "pandas"))
    if leaked:
        raise AssertionError(f"[step 21b] the harness imported {leaked[:5]}")


# ---------------------------------------------------------------------------
# step 22: WSI streaming, supervised fine-tuning and the CNN towers
# ---------------------------------------------------------------------------


def synthetic_slide(side: int, tissue: float, seed: int = 0) -> np.ndarray:
    """A white ``side x side`` uint8 RGB slide with tissue: discs on a grid of
    64-px cells until they cover ``tissue`` of it, each cell an H&E-like
    colour with pixel noise."""
    rng = np.random.default_rng(seed)
    cell = 64
    g = side // cell
    yy, xx = np.mgrid[0:g, 0:g]
    mask = np.zeros((g, g), bool)
    while mask.mean() < tissue:
        cy, cx = rng.uniform(0, g, 2)
        mask |= (yy - cy) ** 2 + (xx - cx) ** 2 < rng.uniform(3, 12) ** 2
    colour = np.stack([rng.integers(lo, hi, (g, g)) for lo, hi in
                       ((150, 230), (60, 170), (120, 220))], -1).astype(np.int16)
    slide = np.full((side, side, 3), 255, np.uint8)
    for y in range(g):  # a strip of cells at a time
        rows = slice(y * cell, (y + 1) * cell)
        m = np.repeat(mask[y], cell)
        px = np.repeat(colour[y], cell, 0)[None] + rng.integers(-25, 26, (cell, side, 3),
                                                                  dtype=np.int16)
        slide[rows][:, m] = np.clip(px[:, m], 0, 255)
    return slide


def timed(fn, reps=1):
    """(the last result, host-clock seconds of each call, synchronized)."""
    out, times = None, []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    return out, times


def unit(x):
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def wsi_phase(att, mha, layers, PLIP, card):
    """Step 22a (module doc). Returns the launches of the bf16 embed_wsi."""
    from plip_tpu_torch.data.wsi import (embed_wsi, embed_wsi_pyramid, iter_wsi_pyramid,
                                         iter_wsi_tiles)
    from plip_tpu_torch.datagen.preprocess_digestpath import background_ratio

    side, tissue = WSI_SLIDE
    slide, (t_make,) = timed(lambda: synthetic_slide(side, tissue))
    print(f"[step 22a] slide {side} x {side} uint8 ({slide.nbytes / 2**20:.0f} MiB), tissue "
          f"{1 - background_ratio(slide):.3f}, made in {t_make:.1f} s")
    streams = {
        "embed_wsi": (lambda m: embed_wsi(m, slide, WSI_BATCH, 224, non_bg_threshold=0.5),
                      list(iter_wsi_tiles(slide, 224, non_bg_threshold=0.5))),
        "embed_wsi_pyramid": (lambda m: embed_wsi_pyramid(m, slide, batch_size=WSI_BATCH),
                              list(iter_wsi_pyramid(slide))),
    }
    out = None
    for dtype in (torch.bfloat16, torch.float32):
        fp32 = dtype == torch.float32
        model = PLIP("random:ViT-B/32", dtype=dtype, device="cuda")
        L = model.cfg.vision.layers
        for name, (run, tiles) in streams.items():
            tag = f"[step 22a] {name} {str(dtype)[6:]}"
            images = [t for t, _ in tiles]
            n, batches = len(tiles), -(-len(tiles) // WSI_BATCH)
            att.reset_launch_counts()
            mha.reset_launch_counts()
            (emb, coords), (t_run,) = timed(lambda: run(model))
            counts = dict(att.LAUNCHES)
            print(f"{tag}: {n} tiles in {batches} batches, {t_run:.2f} s; launches {counts} "
                  f"(attn_core expected {L * batches}), mha {dict(mha.LAUNCHES)}")
            if [tuple(c) for c in coords.tolist()] != [tuple(int(v) for v in c)
                                                       for _, c in tiles]:
                raise AssertionError(f"{tag}: the coordinates are not the iterator's")
            if (counts["attn_core"] != L * batches or not all(counts.values())
                    or any(mha.LAUNCHES.values())):
                raise AssertionError(f"{tag}: the stream did not run K1 once a layer a batch")
            direct = unit(model.encode_images(images, batch_size=WSI_BATCH))
            cos = row_cos(emb, direct).min()
            first = images[:WSI_BATCH]
            before = dict(att.LAUNCHES)
            with plain_towers(att, mha, layers):
                plain = unit(model.encode_images(first, batch_size=WSI_BATCH))
            if dict(att.LAUNCHES) != before or any(mha.LAUNCHES.values()):
                raise AssertionError(f"{tag}: the plain run launched a CUDA kernel")
            cos_plain = row_cos(emb[:len(first)], plain).min()
            err = np.abs(emb[:len(first)] - plain).max()
            print(f"{tag}: row cosine min {cos:.7f} against encode_images of the same tiles "
                  f"(max |diff| {np.abs(emb - direct).max():.3e}), first batch against the "
                  f"plain path {cos_plain:.7f} (max |diff| {err:.3e})")
            bar = (cos > 0.9999 and cos_plain > 0.9999 and err <= 5e-3) if fp32 else (
                cos >= 0.999 and cos_plain >= 0.999)
            if not bar:
                raise AssertionError(f"{tag}: the stream's embeddings disagree")
            if name == "embed_wsi":
                if not fp32:
                    out = counts
                wsi_fn = lambda: run(model)  # noqa: E731
                enc_fn = lambda: model.encode_images(images, batch_size=WSI_BATCH)  # noqa: E731
                _, (w1,) = timed(wsi_fn)
                _, (e1,) = timed(enc_fn)
                dev_w, _ = profiled_run(wsi_fn, calls=1)
                dev_e, _ = profiled_run(enc_fn, calls=1)
                print(f"{tag}: {n} tiles: embed_wsi {n / w1:.1f} tiles/s (host "
                      f"{w1 * 1e3:.1f} ms; device {dev_w:.1f} ms; idle "
                      f"{1 - dev_w / (w1 * 1e3):.3f}), encode_images of the same tiles "
                      f"{n / e1:.1f} tiles/s (host {e1 * 1e3:.1f} ms; device {dev_e:.1f} ms; "
                      f"idle {1 - dev_e / (e1 * 1e3):.3f}); card {card}")
        del model
        torch.cuda.empty_cache()
    return out


class RouteSpy(Patched):
    """Records each attention core's route, as (S, route, "fwd"/"bwd")."""

    def __init__(self, att, bwd):
        self.seen = []
        real = att.core_route

        def spy(S, head_dim, dtype, backward=False):
            route = real(S, head_dim, dtype, backward)
            self.seen.append((S, route, "bwd" if backward else "fwd"))
            return route

        super().__init__(mock.patch.object(att, "core_route", spy),
                         mock.patch.object(bwd, "core_route", spy))


def finetune_phase(att, bwd, mha, card):
    """Step 22b (module doc). Returns the launches of the vit_b_16 step."""
    from plip_tpu_torch.data.datasets import ImageLabelDataset
    from plip_tpu_torch.data.loader import PrefetchLoader
    from plip_tpu_torch.train.finetune import FineTuner, _make_optimizer

    n, classes, px = FT_BATCH
    images = torch.as_tensor(synthetic_images(n, seed=22, size=px), device="cuda")
    labels = torch.as_tensor(np.arange(n) % classes, device="cuda")
    out = None

    def grads(ft):
        ft.model.zero_grad(set_to_none=True)
        ft.model.train()
        loss = F.cross_entropy(ft._forward(ft._preprocess(images)), labels)
        loss.backward()
        return loss.item(), {k: p.grad.clone() for k, p in ft.model.named_parameters()}

    for name, (steps, lr) in FT_RUNS.items():
        tag = f"[step 22b] FineTuner {name} fp32"
        args = SimpleNamespace(model_name=name, optimizer="AdamW", PC_CLIP_ARCH="ViT-B/32")
        ft = FineTuner(args=args, num_classes=classes, lr=lr, device="cuda")
        if not name.startswith("resnet"):
            L = 12
            for m in (att, bwd, mha):
                m.reset_launch_counts()
            spy = RouteSpy(att, bwd)
            with spy:
                loss, got = grads(ft)
            torch.cuda.synchronize()
            counts = {**att.LAUNCHES, **bwd.LAUNCHES}
            with PlainVersions(att, bwd, mha):
                loss_ref, want = grads(ft)
            if {**att.LAUNCHES, **bwd.LAUNCHES} != counts or any(mha.LAUNCHES.values()):
                raise AssertionError(f"{tag}: the plain run launched a CUDA kernel")
            cos = {k: leaf_cosine(got[k], want[k]) for k in want}
            worst = min(cos, key=cos.get)
            rel = abs(loss - loss_ref) / abs(loss_ref)
            routes = sorted(set(spy.seen))
            print(f"{tag}: one step, loss {loss:.7f} kernels, {loss_ref:.7f} plain (rel "
                  f"{rel:.2e}); {len(cos)} leaves, worst cosine {cos[worst]:.7f} at {worst}; "
                  f"launches {counts}; core routes {routes}")
            if rel > 1e-5 or cos[worst] < 0.9999:
                raise AssertionError(f"{tag}: the kernel path disagrees with the plain path")
            if counts["attn_core"] != L or counts["attn_core_bwd"] != L:
                raise AssertionError(f"{tag}: K1's and K2's cores not launched once a layer")
            if name == "vit_b_16":
                if routes != [(197, "one_block", "fwd"), (197, "tiled", "bwd")]:
                    raise AssertionError(f"{tag}: the cores' routes at S=197 are {routes}")
                out = counts
            del got, want
        opt = _make_optimizer("AdamW", lambda _: lr, 0.2)
        state = opt.init(dict(ft.model.named_parameters()))
        start = {k: v.clone() for k, v in ft.model.state_dict().items()}
        losses, peaks, times = [], [], []
        for _ in range(steps):
            torch.cuda.reset_peak_memory_stats()
            loss, (t,) = timed(lambda: ft.train_step(opt, state, images, labels).item())
            losses.append(loss)
            times.append(t * 1e3)
            peaks.append(torch.cuda.max_memory_allocated() / 2**30)
        print(f"{tag}: {steps} AdamW steps (lr {lr}) on the fixed batch: losses "
              f"{[round(v, 6) for v in losses]}, step ms {[round(v, 1) for v in times]}, peak "
              f"device memory {[round(v, 3) for v in peaks]} GiB; card {card}")
        if not all(np.isfinite(losses)) or (steps > 1 and losses[-1] >= losses[0]):
            raise AssertionError(f"{tag}: the loss did not fall")
        if name.startswith("resnet"):
            bn = [k for k in start if k.endswith(("running_mean", "running_var"))]
            after = ft.model.state_dict()
            still = [k for k in bn if torch.equal(after[k], start[k])]
            ft0 = FineTuner(args=args, num_classes=classes, lr=0.0, device="cuda")
            opt0 = _make_optimizer("AdamW", lambda _: 0.0, 0.2)
            before = {k: v.clone() for k, v in ft0.model.state_dict().items()}
            ft0.train_step(opt0, opt0.init(dict(ft0.model.named_parameters())), images, labels)
            after0 = ft0.model.state_dict()
            moved = [k for k, _ in ft0.model.named_parameters()
                     if not torch.equal(after0[k], before[k])]
            frozen = [k for k in bn if torch.equal(after0[k], before[k])]
            print(f"{tag}: {len(bn)} running statistics, {len(still)} unmoved by the steps; "
                  f"an lr=0 step moved {len(bn) - len(frozen)} of them and {len(moved)} of "
                  f"{len(list(ft0.model.parameters()))} parameters")
            if still or frozen or moved:
                raise AssertionError(f"{tag}: BatchNorm's buffers or parameters misbehave")
            loader = PrefetchLoader(ImageLabelDataset({"image": list(images.cpu().numpy()),
                                                       "label": list(labels.tolist())}),
                                    16, num_workers=4, device="cuda")
            (vl, f1w, f1m), (t,) = timed(lambda: ft.valid_evaluation(loader, 16))
            leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("sklearn", "pandas"))
            print(f"{tag}: valid_evaluation on the card: loss {vl:.5f}, f1 weighted {f1w:.4f}, "
                  f"macro {f1m:.4f} in {t:.2f} s; loaded {leaked}")
            if leaked or not np.isfinite(vl):
                raise AssertionError(f"{tag}: valid_evaluation")
            del ft0
        del ft, opt, state
        torch.cuda.empty_cache()
    return out


def densenet_phase(card):
    """Step 22c (module doc)."""
    import copy

    from plip_tpu_torch.embedders.mudipath import DenseNetEmbedder, build_densenet

    model, arch = build_densenet(device="cuda")
    emb = DenseNetEmbedder(model, arch, "mudipath", "")
    tiles = list(synthetic_images(DENSE_TILES, seed=23))
    got, times = timed(lambda: emb.embed_images(tiles, num_workers=4, batch_size=32), 3)
    cpu = DenseNetEmbedder(copy.deepcopy(model).cpu(), arch, "mudipath", "")
    want = cpu.embed_images(tiles[:2], num_workers=2, batch_size=2)
    err = np.abs(got[:2] - want).max()
    norms = np.linalg.norm(got, axis=1)
    print(f"[step 22c] DenseNetEmbedder {arch}: {got.shape}, row norms {norms.min():.6f}-"
          f"{norms.max():.6f}, two tiles against the CPU forward max |diff| {err:.3e}; "
          f"{', '.join(f'{DENSE_TILES / t:.1f}' for t in times)} images/s; card {card}")
    if got.shape != (DENSE_TILES, 1024) or np.abs(norms - 1).max() > 1e-5 or not np.allclose(
            got[:2], want, rtol=1e-4, atol=1e-4):
        raise AssertionError("[step 22c] the DenseNet embedder disagrees")


# ---------------------------------------------------------------------------
# step 23: the profiling helpers and data parallelism
# ---------------------------------------------------------------------------


def free_ports(n: int) -> list:
    """``n`` distinct free local ports (held together while chosen)."""
    import socket

    socks = [socket.socket() for _ in range(n)]
    try:
        for sock in socks:
            sock.bind(("127.0.0.1", 0))
        return [sock.getsockname()[1] for sock in socks]
    finally:
        for sock in socks:
            sock.close()


class Spawn:
    """``n`` processes running ``code`` on cuda:0 under gloo, their
    coordinator at ``port``, started now and collected by ``wait`` (or ended
    by ``kill``): steps 23c and 24's children run while the parent runs
    step 23b."""

    def __init__(self, name, code, n, timeout, port, **env):
        os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
        coord = f"127.0.0.1:{port}"
        self.timeout, self.t0 = timeout, time.perf_counter()
        self.logs = [os.path.join(ROOT, "build", f"chip_smoke_{name}.{r}.log") for r in range(n)]
        self.procs = []
        for r, log in enumerate(self.logs):
            with open(log, "w") as f:
                # one intra-op thread a child: eight children and the parent
                # share the host's cores, and the children's work is the card's
                self.procs.append(subprocess.Popen(
                    [sys.executable, "-c", code], cwd=ROOT, stdout=f, stderr=subprocess.STDOUT,
                    env=dict(os.environ, _ROOT=ROOT, _RANK=str(r), _COORD=coord,
                             OMP_NUM_THREADS="1", **env)))

    def kill(self):
        for proc in self.procs:
            proc.kill()

    def wait(self, tag) -> float:
        """Print each child's output; raise unless every child exited 0 within
        the timeout (counted from the start). Returns the wall seconds."""
        try:
            for proc in self.procs:
                proc.wait(timeout=max(1.0, self.t0 + self.timeout - time.perf_counter()))
        finally:
            self.kill()
        wall = time.perf_counter() - self.t0
        for r, (proc, log) in enumerate(zip(self.procs, self.logs)):
            with open(log) as f:
                text = f.read()
            os.remove(log)
            print(f"{tag} child {r} (exit {proc.returncode}): {text.strip()[-3000:]}")
            if proc.returncode != 0:
                raise AssertionError(f"{tag} child {r} failed")
        return wall


def profiling_phase(PLIP, card):
    """Step 23a (module doc)."""
    from plip_tpu_torch.profile_train import kernel_times
    from plip_tpu_torch.utils.profiling import parse_device_trace, trace

    tiles, batch = DP_TILES
    model = PLIP("random:ViT-B/32", dtype=torch.bfloat16, device="cuda")
    images = list(synthetic_images(tiles))
    model.encode_images(images, batch_size=batch)  # warm-up
    logdir = os.path.join(ROOT, "build", "chip_smoke_trace")
    shutil.rmtree(logdir, ignore_errors=True)
    with trace(logdir) as info:
        for _ in range(2):
            with torch.profiler.record_function("encode"):
                model.encode_images(images, batch_size=batch)
    parsed = parse_device_trace(logdir, n_steps=2)
    events_ms = sum(t for _, t in kernel_times(info["profiler"], 2).values())
    total = parsed["step_total_ms"]
    agree = abs(total - events_ms) / events_ms
    encode = parsed["groups"].get("encode", {"total_ms": 0.0, "ops": []})
    share = encode["total_ms"] / total
    print(f"[step 23a] trace of 2 encode_images calls of {tiles} tiles (bf16, batch {batch}): "
          f"{os.path.basename(info['trace_path'])}, wall {info['wall_time_s']:.4f} s; "
          f"parse_device_trace {total:.4f} device-ms a call, prof.events() {events_ms:.4f} "
          f"(relative difference {agree:.2e}); the 'encode' range {share:.4f} of it, "
          f"outside {parsed['outside_ms']:.4f} ms; top ops "
          f"{[(n[:40], round(t, 4)) for n, t in encode['ops'][:3]]}; card {card}")
    if agree > 0.01 or share < 0.95:
        raise AssertionError("[step 23a] the parsed trace disagrees with the profiler's events")
    shutil.rmtree(logdir)


def dp_one_phase(att, bwd, PLIP, tokenizer, card, port):
    """Step 23b (module doc). Returns the K1 and K2 launches of a dp step."""
    from plip_tpu_torch.models.clip import CLIP
    from plip_tpu_torch.models.config import ARCHITECTURES
    from plip_tpu_torch.ops.retrieval import cosine_topk, cosine_topk_int8, quantize_rows
    from plip_tpu_torch.parallel import distributed
    from plip_tpu_torch.parallel.mesh import create_mesh
    from plip_tpu_torch.scripts.export_checkpoint import main as export
    from plip_tpu_torch.train import contrastive as tc
    from plip_tpu_torch.train.clip_tuner import CLIPTuner
    from plip_tpu_torch.utils.checkpoint import load_any_checkpoint

    tag = "[step 23b]"
    distributed.initialize(f"127.0.0.1:{port}", 1, 0)
    mesh = create_mesh(dp=1)
    print(f"{tag} {torch.distributed.get_backend()} group of {distributed.world_size()}, "
          f"mesh {mesh.shape} on {mesh.device}")
    tiles, batch = DP_TILES
    images = list(synthetic_images(tiles))
    plain = PLIP("random:ViT-B/32", dtype=torch.bfloat16, device="cuda")
    meshed = PLIP("random:ViT-B/32", dtype=torch.bfloat16, device="cuda", mesh=mesh)
    for fn in (lambda m: m.encode_images(images, batch_size=batch), lambda m: m.encode_text(
            PROMPTS)):
        fn(plain), fn(meshed)  # warm-up
        (a, (ta,)), (b, (tb,)) = timed(lambda: fn(plain)), timed(lambda: fn(meshed))
        print(f"{tag} {a.shape} rows: meshless {ta * 1e3:.2f}, mesh {tb * 1e3:.2f} ms (host "
              f"clock), bit-equal {np.array_equal(a, b)}")
        if not np.array_equal(a, b):
            raise AssertionError(f"{tag} PLIP(mesh=) rows differ from the meshless rows")
    del plain, meshed

    rows, q, k = DP_RETRIEVAL
    gen = torch.Generator(device="cuda").manual_seed(0)
    corpus = torch.randn(rows, 512, generator=gen, device="cuda")
    queries = torch.randn(q, 512, generator=gen, device="cuda").cpu().numpy()
    q8, inv = quantize_rows(corpus.cpu().numpy())
    q8_dev, inv_dev = torch.from_numpy(q8).cuda(), torch.from_numpy(inv).cuda()
    xn = torch.nn.functional.normalize(corpus, dim=1).cpu().numpy()
    streams = {"fp32": lambda **kw: cosine_topk(queries, corpus, k=k, **kw),
               "int8": lambda **kw: cosine_topk_int8(queries, q8_dev, inv_dev, k=k,
                                                     rescore_vectors=xn, **kw)}
    for name, run in streams.items():
        run(), run(mesh=mesh)  # warm-up
        (want, (t1,)), (got, (t2,)) = timed(run), timed(lambda: run(mesh=mesh))
        print(f"{tag} {name} stream over {rows} x 512 rows, {q} queries, k={k}: meshless "
              f"{t1 * 1e3:.1f}, mesh {t2 * 1e3:.1f} ms (host clock)")
        if not (np.array_equal(want[0], got[0]) and np.array_equal(want[1], got[1])):
            raise AssertionError(f"{tag} the dp {name} stream differs from the meshless one")
    del corpus, q8_dev, inv_dev

    # CLIPTuner(mesh=): 2 steps at batch 128 against the meshless tuner
    out_dir = os.path.join(ROOT, "build", "chip_smoke_dp")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    pics = list(synthetic_images(2 * TRAIN_BATCH, seed=1))
    train = {"image": pics, "caption": [f"{PROMPTS[i % 8]}, tile {i}" for i in range(len(pics))]}
    valid = {"image": pics[:TRAIN_BATCH], "caption": train["caption"][:TRAIN_BATCH]}
    losses = {}
    for name, kw in (("meshless", {}), ("mesh", {"mesh": mesh})):
        records = []
        log = SimpleNamespace(info=lambda msg, *a: records.append(msg % a if a else msg),
                              warning=lambda msg, *a: records.append(msg % a if a else msg))
        tuner = CLIPTuner(args=SimpleNamespace(first_resize=256, pxsize=224), logging=log,
                          model_type="ViT-B/32", lr=1e-5, warmup=2, dtype=torch.bfloat16,
                          device="cuda", remat="mlp", **kw)
        _, (t,) = timed(lambda: tuner.tuner(
            train, valid, save_directory=out_dir, batch_size=TRAIN_BATCH, epochs=1,
            evaluation_steps=0, num_workers=8, start_time=name,
            save_full_state="orbax" if kw else False))
        losses[name] = [float(r.rsplit("loss: ", 1)[1]) for r in records
                        if "[Train - this batch]" in r]
        print(f"{tag} CLIPTuner {name}: losses {losses[name]} in {t:.2f} s (2 steps at "
              f"batch {TRAIN_BATCH} bf16, data and checkpoint included)")
    a, b = np.array(losses["meshless"]), np.array(losses["mesh"])
    if len(a) != 2 or not np.allclose(a, b, rtol=1e-5, atol=0):
        raise AssertionError(f"{tag} the mesh tuner's losses differ")
    print(f"{tag} tuner losses bit-equal {np.array_equal(a, b)}")
    full = os.path.join(out_dir, "epoch_0_mesh_model.orbax")
    state, _ = tc.load_train_state_sharded(full, tc.make_optimizer(), "cuda")
    live = dict(tuner.model.named_parameters())
    same = all(torch.equal(p, live[k]) for k, p in state.model.named_parameters())
    same &= all(torch.equal(state.opt_state.mu[k], tuner.state.opt_state.mu[k])
                and torch.equal(state.opt_state.nu[k], tuner.state.opt_state.nu[k])
                for k in live)
    pt = export([full, os.path.join(out_dir, "exported.pt"), "--device", "cuda"])
    exported, _ = load_any_checkpoint(pt)
    same_export = all(torch.equal(p.cuda(), live[k]) for k, p in exported.named_parameters())
    print(f"{tag} sharded full state {sorted(os.listdir(full))}: resumed bit for bit {same} "
          f"(step {state.step}), export_checkpoint bit for bit {same_export}")
    if not (same and same_export and state.step == 2):
        raise AssertionError(f"{tag} the sharded full state did not round-trip")
    del tuner, state, exported
    shutil.rmtree(out_dir)

    # the K1 and K2 launches of one dp step
    cfg = ARCHITECTURES["ViT-B/32"]()
    model = CLIP(cfg).init_params(torch.Generator().manual_seed(0)).cuda()
    opt = tc.make_optimizer(base_lr=1e-5, warmup=2, total_steps=100)
    step = tc.make_train_step(cfg, opt, dtype=torch.bfloat16, remat="mlp", mesh=mesh)
    state = tc.init_train_state(model, opt)
    pixels, ids = train_batch(tokenizer, cfg, TRAIN_BATCH)
    step(state, pixels, ids)  # warm-up
    att.reset_launch_counts()
    bwd.reset_launch_counts()
    _, (t,) = timed(lambda: step(state, pixels, ids))
    launches = {**att.LAUNCHES, **bwd.LAUNCHES}
    print(f"{tag} one dp step (ViT-B/32 bf16 batch {TRAIN_BATCH}, remat 'mlp'): "
          f"{t * 1e3:.1f} ms host clock; K1 and K2 launches {launches}; card {card}")
    if not all(launches[k] for k in KERNELS + BWD_KERNELS):
        raise AssertionError(f"{tag} a K1 or K2 kernel was not launched by the dp step")
    torch.distributed.destroy_process_group()
    return launches


_DP2_CHILD = r"""
import os, sys, time
import numpy as np
import torch
sys.path.insert(0, os.environ["_ROOT"])
import chip_smoke as cs
from plip_tpu_torch.api import PLIP
from plip_tpu_torch.models.clip import CLIP
from plip_tpu_torch.parallel import distributed
from plip_tpu_torch.parallel.mesh import create_mesh, shard_batch
from plip_tpu_torch.tokenizer import default_tokenizer
from plip_tpu_torch.train import contrastive as tc

rank = int(os.environ["_RANK"])
distributed.initialize(os.environ["_COORD"], 2, rank, timeout_s=120, backend="gloo")
mesh = create_mesh(dp=2)
t0 = time.perf_counter()
cfg = cs.mesh_cfg("ViT-B/32")
model = CLIP(cfg).init_params(torch.Generator().manual_seed(0)).cuda()
opt = tc.make_optimizer(base_lr=cs.DP2_LR, warmup=1, total_steps=100)
state = tc.init_train_state(model, opt)
step = tc.make_train_step(cfg, opt, dtype=torch.bfloat16, remat="mlp", mesh=mesh)
pixels, ids = shard_batch(cs.train_batch(default_tokenizer(), cfg, cs.DP2_BATCH), mesh)
state, m = step(state, pixels, ids)
loss = float(m["loss"])
torch.cuda.synchronize()
t_step = time.perf_counter() - t0
plip = PLIP(cs.mesh_ckpt("ViT-B/32"), dtype=torch.bfloat16, device="cuda", mesh=mesh)
tiles, batch = cs.DP_TILES
emb = plip.encode_images(list(cs.synthetic_images(tiles)), batch_size=batch)
txt = plip.encode_text(cs.PROMPTS)
if rank == 0:
    torch.save({"loss": loss, "mu": {k: v.cpu() for k, v in state.opt_state.mu.items()},
                "params": {k: p.detach().cpu() for k, p in model.named_parameters()},
                "emb": torch.from_numpy(emb), "txt": torch.from_numpy(txt)},
               os.environ["_OUT"])
distributed.barrier()
print(f"rank {rank}: {pixels.shape[0]} of {cs.DP2_BATCH} rows, loss {loss:.6f}, step "
      f"{t_step:.2f} s (model init included)", flush=True)
"""


DP2_OUT = os.path.join(ROOT, "build", "chip_smoke_dp2.pt")


def mesh_cfg(arch):
    """``arch`` at full width and MESH_LAYERS layers a tower."""
    import dataclasses

    from plip_tpu_torch.models.config import ARCHITECTURES

    cfg = ARCHITECTURES[arch]()
    return dataclasses.replace(cfg, vision=dataclasses.replace(cfg.vision, layers=MESH_LAYERS),
                               text=dataclasses.replace(cfg.text, layers=MESH_LAYERS))


def mesh_ckpt(arch):
    """The ``.npz`` of ``write_mesh_ckpts``' random ``mesh_cfg(arch)`` tower."""
    return os.path.join(ROOT, "build", f"chip_smoke_{arch.replace('/', '')}_{MESH_LAYERS}.npz")


def write_mesh_ckpts():
    """Seed-0 random ``mesh_cfg`` towers of ViT-B/32 and ViT-L/14, for the
    children and the parent's meshless references."""
    from plip_tpu_torch.models.clip import CLIP
    from plip_tpu_torch.utils.checkpoint import save_checkpoint

    for arch in ("ViT-B/32", "ViT-L/14"):
        cfg = mesh_cfg(arch)
        save_checkpoint(mesh_ckpt(arch), CLIP(cfg).init_params(torch.Generator().manual_seed(0)),
                        cfg)


def start_dp_two(port) -> Spawn:
    return Spawn("dp2", _DP2_CHILD, 2, DP2_TIMEOUT_S, port, _OUT=DP2_OUT)


def dp_two_phase(tokenizer, PLIP, card, spawn):
    """Step 23c (module doc): collects ``start_dp_two``'s children."""
    from plip_tpu_torch.models.clip import CLIP
    from plip_tpu_torch.train import contrastive as tc

    tag = "[step 23c]"
    wall = spawn.wait(tag)
    print(f"{tag} two ranks on cuda:0 under gloo: {wall:.1f} s since their start, start-up "
          f"included, beside the other spawns and step 23b")
    got = torch.load(DP2_OUT, weights_only=True)
    os.remove(DP2_OUT)

    cfg = mesh_cfg("ViT-B/32")
    model = CLIP(cfg).init_params(torch.Generator().manual_seed(0)).cuda()
    opt = tc.make_optimizer(base_lr=DP2_LR, warmup=1, total_steps=100)
    state = tc.init_train_state(model, opt)
    step = tc.make_train_step(cfg, opt, dtype=torch.bfloat16, remat="mlp")
    state, m = step(state, *train_batch(tokenizer, cfg, DP2_BATCH))
    loss = float(m["loss"])
    rel = abs(got["loss"] - loss) / abs(loss)
    # the grads are held by the first moments (0.1 grad, every leaf); the
    # parameters by the step's bound: a first AdamW step moves an element by
    # lr * (g / (|g| + eps) + wd * p), so where g is at rounding level (the
    # key biases; a zero-initialized bias's sums that cancel) its sign, and
    # the element, may differ by up to 2 lr between two summation orders
    worst_mu, ratio, moved, worst = (1.0, ""), 0.0, 0.0, (1.0, "")
    for k, p in model.named_parameters():
        a, b = got["params"][k], p.detach().cpu()
        m_dp, m_one = got["mu"][k], state.opt_state.mu[k].cpu()
        worst_mu = min(worst_mu, (leaf_cosine(m_dp, m_one), k))
        if m_one.norm() > 0:  # a gradient off by a factor shows here, not in a cosine
            ratio = max(ratio, abs(m_dp.norm().item() / m_one.norm().item() - 1))
        worst = min(worst, (leaf_cosine(a, b), k))
        # beyond two fp32 roundings of the parameter
        moved = max(moved, ((a - b).abs() - 2.4e-7 * b.abs()).max().item())
    print(f"{tag} dp=2 step (32 rows a rank) against one process (64 rows): loss "
          f"{got['loss']:.6f} vs {loss:.6f} (relative {rel:.2e}); first moments (0.1 grad): "
          f"leaf cosine min {worst_mu[0]:.7f} ({worst_mu[1]}), leaf norms within "
          f"{ratio:.2e} relative; parameters differ by at most {moved:.3e} beyond two fp32 "
          f"roundings (bound 2 lr = {2 * DP2_LR:.0e}); parameter leaf cosine min {worst[0]:.7f} "
          f"({worst[1]})")
    if rel > 1e-5 or worst_mu[0] < 0.9999 or ratio > 1e-3 or moved > 2 * DP2_LR:
        raise AssertionError(f"{tag} the dp=2 step differs from the one-process step")
    del model, state
    plain = PLIP(mesh_ckpt("ViT-B/32"), dtype=torch.bfloat16, device="cuda")
    tiles, batch = DP_TILES
    img = plain.encode_images(list(synthetic_images(tiles)), batch_size=batch)
    txt = plain.encode_text(PROMPTS)
    ci = row_cos(got["emb"].numpy(), img).min()
    ct = row_cos(got["txt"].numpy(), txt).min()
    print(f"{tag} PLIP(mesh=dp2) against the meshless rows: image row cosine min {ci:.7f} "
          f"(bit-equal {np.array_equal(got['emb'].numpy(), img)}), text {ct:.7f} "
          f"(bit-equal {np.array_equal(got['txt'].numpy(), txt)}); card {card}")
    if ci < 0.999 or ct < 0.999:
        raise AssertionError(f"{tag} PLIP(mesh=dp2) rows differ from the meshless rows")


# ---------------------------------------------------------------------------
# step 24: tensor parallelism
# ---------------------------------------------------------------------------


def tp_epilogue_phase(att, tpm, card):
    """Step 24a (module doc). Returns (worst error, the JSON line's times)."""
    gen = torch.Generator().manual_seed(24)
    worst, timed = 0.0, None
    for label, M, N in TP_EPILOGUE_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            acc = (torch.randn(M, N, generator=gen) * 4).cuda()
            bias = torch.randn(N, generator=gen).cuda()
            res = torch.randn(M, N, generator=gen).to("cuda", dtype)
            tag = f"[step 24] tp_epilogue {label} [{M}, {N}] {str(dtype)[6:]}"
            for composed in (False, True):
                got = tpm.tp_epilogue(acc, bias, res, composed)
                want = tpm.tp_epilogue_reference(acc, bias, res, composed)
                err = (got.float() - want.float()).abs().max().item()
                worst = max(worst, err)
                print(f"  {tag} {'composed' if composed else 'K1'} order: max_abs_err {err:.3e} "
                      f"(bar: bit-equal)")
                if err != 0:
                    raise AssertionError(f"{tag}: the epilogue differs from its plain version")
            if N % 8 == 0:  # the fp32 partial mode of gemm_bias_residual at this product
                a = torch.randn(M, N, generator=gen).to("cuda", dtype)
                w = (torch.randn(N, N, generator=gen) * N ** -0.5).to("cuda", dtype)
                compare(f"{tag} gemm_bias_residual fp32 partial [{M}, {N}] x [{N}, {N}]",
                        att.gemm_bias_residual(a, w, None),
                        att.gemm_bias_residual_reference(a, w, None), torch.float32,
                        summed=True)
            ms, plain_ms = in_turns(lambda: tpm.tp_epilogue(acc, bias, res),
                                    lambda: tpm.tp_epilogue_reference(acc, bias, res))
            nbytes = M * N * (4 + 2 * res.element_size()) + 4 * N
            bound_ms, bound_by = bound(2 * M * N, nbytes, PEAK_FP32)
            print(f"  {tag}: {ms:.4f} ms, (acc + bias).to(dt) + x in PyTorch {plain_ms:.4f} ms, "
                  f"bound {bound_ms:.4f} ms ({bound_by}, {nbytes / 2**20:.1f} MiB), "
                  f"{bound_ms / ms:.1%} of it; card {card}")
            if timed is None:
                timed = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                         "bound_by": bound_by, "library_ms": None,
                         "case": f"{label} {str(dtype)[6:]}"}
    return worst, timed


class W8A8Prints:
    """While entered, records an exact fingerprint of the int32 sums of every
    W8A8 product (``ops.quant.w8a8_accumulate``'s): the float64 sum and a
    weighted sum of its integers (exact at these sizes). ``shares=tp``: a
    one-process run, recorded as each tp rank's share (the column layers,
    qkv and fc1, calls 0 and 2 of a block's 4, by ``parallel.mesh.
    shard_tensor``; the row layers' sums whole), a list per call."""

    def __init__(self, quant, shares=None):
        from plip_tpu_torch.parallel.mesh import shard_tensor

        self.quant, self.shares, self.shard, self.seen = quant, shares, shard_tensor, []
        self.real = quant.w8a8_accumulate

    @staticmethod
    def fingerprint(acc):
        a = acc.double()
        w = torch.arange(a.shape[-1], device=a.device, dtype=torch.float64) % 7 + 1
        return (a.sum().item(), (a * w).sum().item())

    def __call__(self, x, p, tp=None):
        acc, ascale = self.real(x, p, tp)
        if self.shares is None:
            self.seen.append(self.fingerprint(acc))
        else:
            spec = (("qkv", None, "col", None)[len(self.seen) % 4])
            self.seen.append([self.fingerprint(self.shard(acc, spec, t, self.shares))
                              for t in range(self.shares)])
        return acc, ascale

    def __enter__(self):
        self.quant.w8a8_accumulate = self
        return self

    def __exit__(self, *exc):
        self.quant.w8a8_accumulate = self.real


_TP_CHILD = r"""
import os, sys, time
import torch
sys.path.insert(0, os.environ["_ROOT"])
import chip_smoke as cs
from plip_tpu_torch.api import PLIP
from plip_tpu_torch.models.clip import CLIP
from plip_tpu_torch.ops import attention as att, attention_bwd as bwd, mha, quant, tp as tpm
from plip_tpu_torch.ops.quant import quantize_block_linears
from plip_tpu_torch.parallel import distributed
from plip_tpu_torch.parallel.mesh import (create_mesh, gather_params, gather_tree, param_spec,
                                          shard_batch, shard_params, tensor_parallel)
from plip_tpu_torch.tokenizer import default_tokenizer
from plip_tpu_torch.train import contrastive as tc

rank, dp, tp = (int(os.environ[k]) for k in ("_RANK", "_DP", "_TP"))
distributed.initialize(os.environ["_COORD"], dp * tp, rank, timeout_s=300, backend="gloo")
mesh = create_mesh(dp=dp, tp=tp)
cfg, tok, out = cs.mesh_cfg("ViT-B/32"), default_tokenizer(), {}


def step_once(batch, dtype):
    model = shard_params(CLIP(cfg).init_params(torch.Generator().manual_seed(0)).cuda(), mesh)
    opt = tc.make_optimizer(base_lr=cs.TP_LR, warmup=1, total_steps=100)
    state = tc.init_train_state(model, opt)
    step = tc.make_train_step(cfg, opt, dtype=dtype, remat="mlp", mesh=mesh)
    pixels, ids = shard_batch(cs.train_batch(tok, cfg, batch), mesh)
    for m in (att, bwd, tpm):
        m.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, m = step(state, pixels, ids)
    res = {"loss": float(m["loss"]), "step_s": time.perf_counter() - t0,
           "launches": {**att.LAUNCHES, **bwd.LAUNCHES, **tpm.LAUNCHES},
           "rows": pixels.shape[0]}
    full = gather_params(model, mesh)
    mu = gather_tree(state.opt_state.mu, mesh)
    held = dict(model.named_parameters())
    res["held"] = sum(held[k].numel() * tp == full[k].numel()
                      for k in held if param_spec(k) is not None)
    res["split"] = sum(param_spec(k) is not None for k in held)
    res["held_share"] = sum(p.numel() for p in held.values()) / sum(t.numel() for t in full.values())
    if rank == 0:
        res["params"] = {k: v.detach().cpu() for k, v in full.items()}
        res["mu"] = {k: v.cpu() for k, v in mu.items()}
    out[str(dtype)[6:]] = res
    print(f"rank {rank} (dp {mesh.dp_rank}, tp {mesh.tp_rank}) {str(dtype)[6:]}: {res['rows']} "
          f"rows, loss {res['loss']:.6f}, step {res['step_s']:.2f} s (first step, host clock); "
          f"{res['held']} of {res['split']} split leaves at 1/{tp} of their numel, "
          f"{res['held_share']:.4f} of the parameters held", flush=True)


if os.environ["_WHAT"] == "tp2":
    tiles, batch = cs.DP_TILES
    images = list(cs.synthetic_images(tiles))
    for name, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        plip = PLIP(cs.mesh_ckpt("ViT-B/32"), dtype=dt, device="cuda", mesh=mesh)
        tpm.reset_launch_counts()
        out[f"img_{name}"] = torch.from_numpy(plip.encode_images(images, batch_size=batch))
        out[f"txt_{name}"] = torch.from_numpy(plip.encode_text(cs.PROMPTS))
        out[f"epi_{name}"] = tpm.LAUNCHES["tp_epilogue"]
    del plip
    step_once(cs.TP_BATCH, torch.bfloat16)
    step_once(cs.TP_BATCH, torch.float32)
    l14 = list(cs.synthetic_images(cs.TP_L14_TILES, seed=2))
    plip = PLIP(cs.mesh_ckpt("ViT-L/14"), dtype=torch.bfloat16, device="cuda", mesh=mesh)
    mha.reset_launch_counts()
    out["l14"] = torch.from_numpy(plip.encode_images(l14, batch_size=cs.TP_L14_TILES))
    out["l14_mha"] = dict(mha.LAUNCHES)
    quantize_block_linears(plip.model.visual.blocks, tensor_parallel(mesh))
    with cs.W8A8Prints(quant) as prints:
        out["w8a8"] = torch.from_numpy(plip.encode_images(l14, batch_size=cs.TP_L14_TILES))
    out["w8a8_prints"] = prints.seen
else:
    step_once(cs.TP_DP_BATCH, torch.float32)
torch.save(out, os.environ["_OUT"] + f".{rank}")
distributed.barrier()
"""


def tp_out(what):
    return os.path.join(ROOT, "build", f"chip_smoke_{what}.pt")


def start_tp(what, dp, tp, port) -> Spawn:
    """``_TP_CHILD`` in dp * tp processes on cuda:0 under gloo."""
    return Spawn(what, _TP_CHILD, dp * tp, TP_TIMEOUT_S, port, _OUT=tp_out(what), _WHAT=what,
                 _DP=str(dp), _TP=str(tp))


def tp_children(spawn, what, tag):
    """Collect ``start_tp(what, ...)``'s children: each rank's results and
    the wall seconds."""
    wall = spawn.wait(tag)
    got = []
    for r in range(len(spawn.procs)):
        got.append(torch.load(f"{tp_out(what)}.{r}", weights_only=True))
        os.remove(f"{tp_out(what)}.{r}")
    print(f"{tag} {len(got)} ranks on cuda:0 under gloo: {wall:.1f} s since their start, "
          f"start-up included, beside the other spawns and step 23b")
    return got, wall


def hold_step(tag, got, batch, dtype, tokenizer, att, bwd):
    """One process's "mlp" step at ``batch`` in ``dtype`` against rank 0's
    gathered tree: in fp32 at step 23c's bars; in bf16, where the tp
    forward's partial sums flip some casts (so the loss and grads move by
    more than a dp step's), every first moment's leaf cosine at least
    ``TP_BF16_COS`` (step_check's bf16 bar) and every parameter within 2 lr,
    the loss and norms printed. Returns the one process's launches."""
    from plip_tpu_torch.models.clip import CLIP
    from plip_tpu_torch.train import contrastive as tc

    cfg = mesh_cfg("ViT-B/32")
    model = CLIP(cfg).init_params(torch.Generator().manual_seed(0)).cuda()
    opt = tc.make_optimizer(base_lr=TP_LR, warmup=1, total_steps=100)
    state = tc.init_train_state(model, opt)
    step = tc.make_train_step(cfg, opt, dtype=dtype, remat="mlp")
    pixels, ids = train_batch(tokenizer, cfg, batch)
    att.reset_launch_counts()
    bwd.reset_launch_counts()
    state, m = step(state, pixels, ids)
    loss = float(m["loss"])
    launches = {**att.LAUNCHES, **bwd.LAUNCHES}
    rel = abs(got["loss"] - loss) / abs(loss)
    worst_mu, ratio, moved, worst = (1.0, ""), 0.0, 0.0, (1.0, "")
    for k, p in model.named_parameters():
        a, b = got["params"][k], p.detach().cpu()
        m_tp, m_one = got["mu"][k], state.opt_state.mu[k].cpu()
        worst_mu = min(worst_mu, (leaf_cosine(m_tp, m_one), k))
        if m_one.norm() > 0:
            ratio = max(ratio, abs(m_tp.norm().item() / m_one.norm().item() - 1))
        worst = min(worst, (leaf_cosine(a, b), k))
        moved = max(moved, ((a - b).abs() - 2.4e-7 * b.abs()).max().item())
    print(f"{tag} against one process ({batch} rows): loss {got['loss']:.6f} vs {loss:.6f} "
          f"(relative {rel:.2e}); first moments: leaf cosine min {worst_mu[0]:.7f} "
          f"({worst_mu[1]}), norms within {ratio:.2e} relative; parameters differ by at most "
          f"{moved:.3e} beyond two fp32 roundings (bound 2 lr = {2 * TP_LR:.0e}); parameter "
          f"leaf cosine min {worst[0]:.7f} ({worst[1]})")
    if dtype == torch.float32:
        bad = rel > 1e-5 or worst_mu[0] < 0.9999 or ratio > 1e-3
    else:
        bad = worst_mu[0] < TP_BF16_COS
    if bad or moved > 2 * TP_LR:
        raise AssertionError(f"{tag} the tp step differs from the one-process step")
    del model, state
    torch.cuda.empty_cache()
    return launches


def tp_phase(att, bwd, mha, quant, tpm, tokenizer, PLIP, card, spawns):
    """Step 24b-e (module doc): collects the ``start_tp`` children of
    ``spawns``. Returns the epilogue's launches in a tp=2 rank's bf16 "mlp"
    step."""
    from plip_tpu_torch.ops.quant import quantize_block_linears

    tag = "[step 24b]"
    got, _ = tp_children(spawns["tp2"], "tp2", tag)
    r0 = got[0]
    for r in got[1:]:
        for k in ("img_fp32", "img_bf16", "txt_fp32", "txt_bf16", "l14", "w8a8"):
            if not torch.equal(r[k], r0[k]):
                raise AssertionError(f"{tag} the tp ranks' {k} rows differ")
        if (r["bfloat16"]["loss"], r["float32"]["loss"]) != (r0["bfloat16"]["loss"],
                                                               r0["float32"]["loss"]):
            raise AssertionError(f"{tag} the tp ranks' losses differ")
    tiles, batch = DP_TILES
    images = list(synthetic_images(tiles))
    layers_ = MESH_LAYERS  # both towers
    for name, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        plain = PLIP(mesh_ckpt("ViT-B/32"), dtype=dt, device="cuda")
        img, txt = plain.encode_images(images, batch_size=batch), plain.encode_text(PROMPTS)
        for what, a, b in (("image", r0[f"img_{name}"].numpy(), img),
                           ("text", r0[f"txt_{name}"].numpy(), txt)):
            cos = row_cos(a, b).min()
            err = np.abs(a - b).max() / np.abs(b).max()
            print(f"{tag} PLIP(mesh=tp2) {name} {what} rows against the meshless rows: row "
                  f"cosine min {cos:.7f}, max error {err:.2e} of the largest value, bit-equal "
                  f"{np.array_equal(a, b)}")
            ok = (np.allclose(a, b, rtol=1e-4, atol=1e-5 * np.abs(b).max()) if dt == torch.float32
                  else cos >= 0.999)
            if not ok:
                raise AssertionError(f"{tag} PLIP(mesh=tp2) {name} {what} rows differ")
        want = 2 * layers_ * (-(-tiles // batch) + 1)
        print(f"{tag} {name} encode: tp_epilogue launched {r0[f'epi_{name}']} times "
              f"(a sublayer and an MLP half a layer a batch: {want})")
        if r0[f"epi_{name}"] != want:
            raise AssertionError(f"{tag} the epilogue's launches are not one a half")
        del plain
    torch.cuda.empty_cache()

    tag = "[step 24c]"
    one = hold_step(f"{tag} tp=2 bf16 'mlp' step", r0["bfloat16"], TP_BATCH, torch.bfloat16,
                    tokenizer, att, bwd)
    hold_step(f"{tag} tp=2 fp32 'mlp' step", r0["float32"], TP_BATCH, torch.float32,
              tokenizer, att, bwd)
    blocks = 2 * layers_
    for r, res in enumerate(got):
        res = res["bfloat16"]
        tpl = res["launches"]
        print(f"{tag} rank {r} launches {tpl}; one process {one}; the step {res['step_s']:.2f} s "
              f"(host clock, first step); card {card}")
        want = dict(one, gemm_bias_residual=one["gemm_bias_residual"] + 2 * blocks,
                    tp_epilogue=3 * blocks)  # + fc2's partial, forward and recompute
        # col_sum also adds the K slices of the TN products, whose count
        # follows the product's shape (attention_bwd.tn_slice_rows): a rank's
        # dWqkv has a third of the meshless output tiles, so more slices
        if any(tpl[k] != v for k, v in want.items() if k != "col_sum"):
            raise AssertionError(f"{tag} rank {r}'s launches are not the meshless step's "
                                 f"with the epilogue's: want {want}")
    print(f"{tag} each rank's K1 and K2 launches are the meshless step's, gemm_bias_residual "
          f"plus fc2's fp32 partial ({2 * blocks}: forward and the 'mlp' recompute), "
          f"tp_epilogue {3 * blocks} (a sublayer and an MLP half a block, the MLP's again in "
          f"its recompute), col_sum {got[0]['bfloat16']['launches']['col_sum']} against "
          f"{one['col_sum']} (the TN products' K slices at a rank's shapes)")

    tag = "[step 24d]"
    l14 = list(synthetic_images(TP_L14_TILES, seed=2))
    plain = PLIP(mesh_ckpt("ViT-L/14"), dtype=torch.bfloat16, device="cuda")
    mha.reset_launch_counts()
    img = plain.encode_images(l14, batch_size=TP_L14_TILES)
    cos = row_cos(r0["l14"].numpy(), img).min()
    print(f"{tag} PLIP(ViT-L/14 at {MESH_LAYERS} layers, mesh=tp2) bf16, {TP_L14_TILES} tiles: "
          f"row cosine min {cos:.7f} against the meshless rows (bit-equal "
          f"{np.array_equal(r0['l14'].numpy(), img)}); mha_core launches a rank "
          f"{r0['l14_mha']['mha_core']} at 8 heads, meshless {mha.LAUNCHES['mha_core']} at 16")
    if cos < 0.999 or r0["l14_mha"]["mha_core"] != mha.LAUNCHES["mha_core"]:
        raise AssertionError(f"{tag} the tp ViT-L/14 encode differs")
    quantize_block_linears(plain.model.visual.blocks)
    with W8A8Prints(quant, shares=2) as prints:
        w8 = plain.encode_images(l14, batch_size=TP_L14_TILES)
    same = [[tuple(res["w8a8_prints"][i]) == tuple(prints.seen[i][r])
             for i in range(len(prints.seen))] for r, res in enumerate(got)]
    cos = row_cos(r0["w8a8"].numpy(), w8).min()
    print(f"{tag} W8A8 at tp=2: {len(prints.seen)} int8 products a rank, their int32 sums "
          f"equal to the meshless ones' (each rank's share): "
          f"{[sum(x) for x in same]} of {len(prints.seen)}; embeddings row cosine min "
          f"{cos:.7f}, bit-equal {np.array_equal(r0['w8a8'].numpy(), w8)}")
    if not all(all(x) for x in same) or len(prints.seen) != 4 * MESH_LAYERS or cos < 0.999:
        raise AssertionError(f"{tag} the tp W8A8 integers differ from the meshless ones")
    del plain
    torch.cuda.empty_cache()

    tag = "[step 24e]"
    got4, _ = tp_children(spawns["dp2tp2"], "dp2tp2", tag)
    if len({res["float32"]["loss"] for res in got4}) != 1:
        raise AssertionError(f"{tag} the ranks' losses differ")
    hold_step(f"{tag} dp=2 x tp=2 fp32 'mlp' step ({TP_DP_BATCH // 2} rows a dp rank)",
              got4[0]["float32"], TP_DP_BATCH, torch.float32, tokenizer, att, bwd)
    print(f"{tag} NCCL with tp > 1: not run (one card); card {card}")
    return r0["bfloat16"]["launches"]["tp_epilogue"]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from plip_tpu_torch import profile_kernels as pk
    from plip_tpu_torch.api import PLIP
    from plip_tpu_torch.models import layers
    from plip_tpu_torch.ops import _build
    from plip_tpu_torch.ops import attention as att
    from plip_tpu_torch.ops import attention_bwd as bwd
    from plip_tpu_torch.ops import block as bk
    from plip_tpu_torch.ops import block_bwd as blk
    from plip_tpu_torch.ops import mha
    from plip_tpu_torch.ops import mlp as mlpm
    from plip_tpu_torch.ops import preprocess as pre
    from plip_tpu_torch.ops import preprocess_fused as pf
    from plip_tpu_torch.ops import quant
    from plip_tpu_torch.ops import tp as tpm

    # fp32 products are the reference: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    lib = _build.build()
    print(f"build: {lib.name} in {time.perf_counter() - t0:.1f} s")
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}")
    sass = start_sass_dump(_build)
    atexit.register(sass[0].kill)  # a failed phase leaves it not running

    def phase(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        print(f"[phase] {name}: {time.perf_counter() - t:.1f} s")
        return out

    worst, timed = phase("kernels", kernel_phase, att)
    launches, tokenizer = phase("serving ViT-B/32", serving_phase, *SERVING[0], att, mha,
                                layers, PLIP)
    bwd_worst, bwd_timed = phase("backward kernels", backward_kernel_phase, att, bwd)
    phase("train step", train_step_check, layers, att, tokenizer)
    tuner, train_launches = phase("tuner", tuner_phase, (att, bwd))
    phase("fixed batch", fixed_batch_phase, tuner)
    del tuner
    torch.cuda.empty_cache()
    wide_worst, wide_timed = phase("wide kernels", wide_kernel_phase, att, mha)
    worst["attn_core"] = max(worst["attn_core"], wide_worst["attn_core"])
    wide_launches = {}
    for arch, batch, core, fp32 in SERVING[1:]:
        run, _ = phase(f"serving {arch}", serving_phase, arch, batch, core, fp32, att, mha,
                       layers, PLIP)
        if core in MHA_REPLACES:
            wide_launches[core] = run[core]
    tiled_worst, tiled_timed = phase("wide backward kernels", wide_backward_phase, att, bwd,
                                     mha)
    worst["attn_core"] = max(worst["attn_core"], tiled_worst["attn_core"])
    bwd_worst["attn_core_bwd"] = max(bwd_worst["attn_core_bwd"], tiled_worst["attn_core_bwd"])
    k4_path = phase("wide train steps", wide_train_phase, att, bwd, mha, tokenizer)
    arch, batch, steps = WIDE_TUNER
    phase(f"tuner {arch}", tuner_phase, (att, bwd, mha), arch, batch, steps, "auto",
          ("mha_core",) + KERNELS + BWD_KERNELS)
    block_worst, block_timed = phase("block kernels", block_kernel_phase, att, bwd, mha, mlpm,
                                     blk)
    k7_path = phase("block train steps", block_train_phase, att, bwd, mha, mlpm, blk,
                    tokenizer)["ViT-B/32", torch.bfloat16][0]
    block_launches = {k: k7_path[k] for k in ("gemm_bias_gelu", "gemm_nt_gelu_bwd",
                                              "block_bwd")}
    block_launches.update(phase("K8 and K9 paths", mlp_path_phase, mlpm))
    phase("remat memory", remat_memory_phase, tokenizer)
    phase("tuner ViT-B/32 remat block", tuner_phase, (att, bwd, mha, mlpm, blk), "ViT-B/32",
          TRAIN_BATCH, BLOCK_TUNER_STEPS, "block",
          KERNELS + ("block_bwd", "gemm_bias_gelu", "gemm_nt_gelu_bwd", "mha_core_bwd"))
    s6_worst, s6_timed, s6_launches = {}, {}, {}
    s6_worst["headgrid_core"], s6_timed["headgrid_core"] = phase("headgrid core", headgrid_phase,
                                                                 mha)
    block_336 = phase("@336 block step", block_train_phase, att, bwd, mha, mlpm, blk, tokenizer,
                      BLOCK_336)
    s6_launches["headgrid_core"] = block_336[BLOCK_336[0][0], torch.bfloat16][0]["headgrid_core"]
    k10_worst, k10_timed = phase("block forward kernels", block_fwd_phase, mlpm, bk)
    s6_worst.update(k10_worst)
    s6_timed.update(k10_timed)
    s6_launches.update(phase("transformer_block stack", block_stack_phase, bk, mlpm, layers,
                             PLIP))
    split_worst, s6_timed["attention_sublayer_bwd_split"] = phase(
        "split backward kernels", split_kernel_phase, att, bwd)
    s6_worst["attention_sublayer_bwd_split"] = split_worst
    split_path = phase("BWD_MODE steps", bwd_mode_phase, att, bwd, tokenizer,
                       {"headgrid_core": mha, "block_fwd": bk, "gemm_bias_gelu_f32": mlpm,
                        "preprocess_fused": pf})
    s6_launches["attention_sublayer_bwd_split"] = split_path["attention_sublayer_bwd_split"]
    (s6_worst["preprocess_fused"], s6_timed["preprocess_fused"],
     s6_launches["preprocess_fused"]) = phase("fused preprocessing", preprocess_phase, pk, pf,
                                              pre, PLIP)
    phase("slice 8: one-block core", short_core_phase, att, mha)
    phase("slice 8: grad_gemm", grad_gemm_phase, bwd)
    phase("slice 9: epilogue GEMMs", epilogue_gemm_phase, att, mlpm)
    phase("slice 10: col_sum", col_sum_phase, bwd)
    phase("slice 10: one-block core backward", core_bwd_phase, bwd, mha)
    fp32_timed, fp32_worst = phase("step 16: fp32 kernels", fp32_kernel_phase, pk)
    phase("step 16: bf16 at head_dim 32 and 16", other_head_dim_phase, att, bwd)
    phase("step 16: one-block core, v over k", v_over_k_phase, att)
    fp32_launches = phase("step 16: fp32 serving", fp32_serving_phase, att, mha, layers, PLIP)
    phase("step 16: tiny bf16", tiny_bf16_phase, att, bwd, mha)
    phase("step 17: key-tiled cores at head_dim 80 and 104", wide_head_phase, att, bwd, mha,
          blk)
    bwd32_timed, bwd32_worst = phase("step 17: K2's fp32 kernels", fp32_bwd_phase, pk)
    bwd32_launches = phase("step 17: fp32 train step", fp32_step_phase, att, bwd, mha, layers,
                           tokenizer)
    s18_timed, s18_worst = phase("step 18: key-tiled cores off wgmma", tiled_phase, pk, att,
                                 bwd, mha)
    s18_launches = {"mha_core": phase("step 18: fp32 ViT-L/14 serving",
                                      fp32_l14_serving_phase, att, mha, layers, PLIP)}
    _, s18_launches["mha_core_bwd"] = phase(
        "step 18: fp32 ViT-L/14 train steps", fp32_l14_step_phase, att, bwd, mha, tokenizer)
    phase("step 18: head_dim 160 tower", wide_head_tower_phase, att, bwd, mha)
    ln_worst, ln_timed = phase("step 19: LayerNorm kernels", ln_kernel_phase, pk, att, bwd)
    ln_step_launches = phase("step 19: B/32 mlp steps", ln_step_phase, att, bwd, mha,
                             tokenizer)
    phase("step 19: B/32 256-tile encode", ln_encode_phase, att, mha, layers, PLIP)
    model = phase("step 20: torch checkpoints", checkpoint_phase, att, PLIP)
    phase("step 20: device retrieval", retrieval_phase, model, card)
    del model
    torch.cuda.empty_cache()
    phase("step 21a: W8A8 serving", w8a8_phase, att, mha, layers, PLIP, card)
    phase("step 21a: int8 and bf16 products", int8_gemm_phase, card)
    phase("step 21b: the harness", harness_phase, att, mha, PLIP, card)
    s22 = {"wsi": phase("step 22a: WSI streaming", wsi_phase, att, mha, layers, PLIP, card),
           "vit_b_16": phase("step 22b: fine-tuning", finetune_phase, att, bwd, mha, card)}
    phase("step 22c: the DenseNet embedder", densenet_phase, card)
    phase("step 23a: profiling", profiling_phase, PLIP, card)
    tp_worst, tp_timed = phase("step 24a: the tp epilogue", tp_epilogue_phase, att, tpm, card)
    # the multi-process runs, timed by no figure of the JSON line, run together
    # from here on while the parent runs step 23b and then holds their results
    write_mesh_ckpts()
    ports = free_ports(4)
    spawns = {"dp2": start_dp_two(ports[0]), "tp2": start_tp("tp2", 1, 2, ports[1]),
              "dp2tp2": start_tp("dp2tp2", 2, 2, ports[2])}
    try:
        dp_launches = phase("step 23b: a world of one over NCCL", dp_one_phase, att, bwd,
                            PLIP, tokenizer, card, ports[3])
        phase("step 23c: two ranks on the card under gloo", dp_two_phase, tokenizer, PLIP,
              card, spawns["dp2"])
        tp_launches = phase("step 24b-e: tensor parallelism", tp_phase, att, bwd, mha, quant,
                            tpm, tokenizer, PLIP, card, spawns)
    finally:  # a failed phase leaves no child running
        for spawn in spawns.values():
            spawn.kill()
    wgmma_check(_build, sass)
    # the JSON line's LayerNorm entries: step 19's figures at LN_JSON_CASE
    for name, w, t in (("ln_rows", worst, timed), ("ln_bwd_rows", bwd_worst, bwd_timed)):
        w[name] = max(w[name], ln_worst[name])
        t[name] = ln_timed[name]
    print(f"device_time's profiler windows: {pk.WINDOWS}")
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "plip_tpu"))
    if leaked:
        raise AssertionError(f"the port imported {leaked[:5]}")

    def entry(name, source, replaces, n, err, t):
        out = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
               "launches": n, "max_abs_err": err, **t}
        if source == SOURCE and name in fp32_timed:  # step 16's fp32 run of K1's kernels
            out["fp32"] = {**fp32_timed[name], "launches": fp32_launches[name],
                           "max_abs_err": fp32_worst[name]}
        if source == BWD_SOURCE and name in bwd32_timed:  # step 17's of K2's
            out["fp32"] = {**bwd32_timed[name], "launches": bwd32_launches[name],
                           "max_abs_err": bwd32_worst[name]}
        if name in s18_timed:  # step 18's of the key-tiled cores
            out["fp32"] = {**s18_timed[name], "launches": s18_launches[name],
                           "max_abs_err": s18_worst[name]}
        if name in ln_step_launches:  # step 19's B/32 "mlp" step
            out["launches_b32_mlp_step"] = ln_step_launches[name]
        if name in s22["wsi"]:  # step 22a's bf16 embed_wsi of the slide
            out["launches_wsi_stream"] = s22["wsi"][name]
        if name in s22["vit_b_16"]:  # step 22b's fp32 vit_b_16 FineTuner step
            out["launches_vit_b_16_step"] = s22["vit_b_16"][name]
        if name in dp_launches:  # step 23b's bf16 B/32 dp step
            out["launches_dp_step"] = dp_launches[name]
        return out

    print(f"card: {card}")
    print(json.dumps({"kernels": [
        entry(k, SOURCE, REPLACES, launches[k], worst[k], timed[k]) for k in KERNELS] + [
        entry(k, BWD_SOURCE, BWD_REPLACES, train_launches[k], bwd_worst[k], bwd_timed[k])
        for k in BWD_KERNELS] + [
        entry(k, MHA_SOURCE, MHA_REPLACES[k], wide_launches[k], wide_worst[k], wide_timed[k])
        for k in MHA_REPLACES] + [
        entry("mha_core_bwd", MHA_BWD_SOURCE, MHA_BWD_REPLACES, k4_path["mha_core_bwd"],
              tiled_worst["mha_core_bwd"], tiled_timed["mha_core_bwd"])] + [
        entry(k, MLP_SOURCE, BLOCK_REPLACES[k], block_launches[k], block_worst[k],
              block_timed[k]) for k in BLOCK_REPLACES] + [
        entry(k, *SLICE6[k], s6_launches[k], s6_worst[k], s6_timed[k]) for k in SLICE6] + [
        entry("tp_epilogue", TP_SOURCE, TP_REPLACES, tp_launches, tp_worst, tp_timed)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
