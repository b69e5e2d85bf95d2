#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``torchmetrics_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--json PATH]

Phases, each of which fails the run (non-zero exit) on any mismatch:

1. device: the card's name and power limit; CUDA is required, there is no
   CPU fallback;
2. build: every CUDA kernel of the port, compiled from ``csrc/`` at once;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes the main path gives it and the edge cases of its contract
   (threshold grids up to 4000 with split bin ranges, duplicate, NaN and
   +-inf thresholds, non-finite scores, C % 4 != 0, out-of-range targets
   and ignored rows), from a random non-zero int32 state; the new states
   must be exactly equal. Times are CUDA-event medians of one call with the
   L2 cache flushed clean before each (a 256 MB write, then a 256 MB read:
   no dirty line left; an empty kernel's time after it, the launch floor,
   is printed first, with its time a call back to back) and a spin kernel
   holding the card while the
   host enqueues the call (``time_ms``, the kernel record's ``ms`` and
   ``plain_ms``); the kernel is also timed per call of a run of calls back to
   back over copies of the inputs that overflow the L2 cache
   (``time_stream_ms``, the record's ``stream_ms``), and beside it one
   PyTorch kernel that reads the same scores (``probs.sum(0)``);
   ``coco_match``, the greedy COCO matcher, is held equal (``torch.equal``) to
   its plain version on every chunk that phase 6's mAP compute launches it on
   (the (class, image) items of the 5,000-image set, padded as the metric pads
   them; the first chunk is timed the same way), and on synthetic batches at
   B=1024 items, D=128 detections, A=4 area ranges, T=10 IoU thresholds and
   G=1, 2, 4, 8, 16, 32, 33, 64 ground truths (every lane-group width; B=256
   at G=256), D=8 (byte stores), thresholds of 1.0 over IoUs of exactly 1.0,
   all-crowd and all-ignored items, rows of equal IoUs, invalid rows inside
   the live extent and items with no valid row; ``confmat_multiclass``, the
   fused multiclass confusion-matrix update, is held equal (``torch.equal``)
   to its plain version from a random non-zero int32 state at ImageNet-1k's
   batch (1,024 x 1,000 float32, the first record row) and a Cityscapes-shaped
   batch ((2, 19, 1024, 2048) float32, int64 targets, ~5 % void 255), and at
   C = 2, 3, 19, 32, 77 (scalar loads), 1000, 1001, S % 4 != 0, rows of NaN,
   ties, +-0.0 and -inf, targets C, C+3, -3 and -(C*C+1), out-of-range integer
   labels, ignore_index None, 255 and -3, int32 and int64 targets, float16
   and bfloat16 scores, an empty batch, and the labels' edges (N % 4 != 0,
   int32 and int64 arrays from element 1, preds and targets off each other's
   16-byte boundary, C = 90 and 91 at the shared histogram's limit, a batch
   smaller than its histogram); at the two main-path shapes and the contingency
   tables' (c), (d) it is timed as the others are, with the host's enqueue
   time of one call, beside ``torch.bincount(target * C + preds.argmax(1))``
   (two PyTorch calls, a yardstick, not the record's single-call
   ``library_ms``);
   ``binned_confmat_multilabel``, the per-label binned update, is held equal
   (``torch.equal``) to its plain version at phase 8's COCO batch (256 x 80,
   T=100) and binary batch (1,024 x 1, T=200), with ignored elements, NaN and
   +-inf scores, unsorted, duplicate, NaN and +-inf thresholds, T=4000 and the
   most thresholds (16,384), all-zero weights, L=81, L=1000 and two batches
   whose row chunks the last block merges (50,000 x 80; the whole 50,000-row
   binary set), each merged one launched twice; the two phase 8
   shapes are profiled (exactly one kernel a call, no memset) and timed
   beside ``bucketize`` + two ``bincount`` + ``flip``/``cumsum`` (several
   PyTorch calls, a yardstick); ``calibration_bins``, the fused
   calibration-error update, against its plain version at ImageNet-1k's batch
   as probabilities and as logits and at the binary batch (the three timed
   rows, beside ``softmax`` + ``max`` + ``bucketize`` + three ``bincount``),
   at C = 2, 3, 31, 33, 1001 and 2000, ``n_bins`` = 1, 15, 100 and the limit
   1023, with NaN, tie, +-inf, one-hot and bin-edge rows, ignored rows,
   float16 and bfloat16 scores, an empty batch, near-tie logit rows on every
   row path (an exponential of 1 below the raw argmax, and a sweep of x over
   every step of ``expf(x)`` near 1, found by a scan of every float32 x the
   divide filter admits, in rows built so that an exponential of 1 - 2^-24
   would tie ``1 / sum``: these against a reference that divides
   ``exp(x - max) / sum``), at 848 and 1,024 rows (four warps a row), 2,048
   (two, float32 and float16) and 16,384 and 65,536 (one), batches that
   take one block and just above, and 65,536 x 1,000 logits (the largest
   merge, also at 1023 bins); the timed rows are profiled (exactly
   one kernel a call): integer states equal (but
   that a row whose normalized confidence lies within 1e-5 of a bin edge,
   counted and printed, may move one count between the edge's two bins),
   ``conf_sum`` within 1e-5 relative (and 1e-6 absolute, for bins that hold
   almost nothing; plus such a row's confidence in those two bins), and two launches
   identical bit for bit; ``ranking_pairs``, the per-sample coverage, LRAP and
   ranking loss, against its plain version for each measure at MS-COCO's batch
   (256 x 80), (32, 1000) and (64, 4096) (the timed rows, beside the plain
   form and, for LRAP and the loss, ``torch.sort`` + ``gather`` + ``cumsum``,
   a yardstick), at L = 1, 31, 33, 4097 and the limit 16,384, with NaN,
   +-inf, tied, no-relevant and all-relevant rows, a 900-way tie in rows of
   1,000 and ignored labels: coverage and loss equal, LRAP within 1e-6
   relative, NaN placement equal, two launches equal bit for bit;
   ``retrieval_groups``, the per-query rank-and-reduce, against its plain
   version for every measure (precision with and without ``adaptive_k``,
   recall, hit rate, fall-out, AP, reciprocal rank, R-precision, NDCG on
   binary and graded targets, AUROC) at ``top_k`` None, 1, 10, 1,000 and past
   the longest query, and its ranked layout against the plain two stable
   sorts, at MS MARCO's shape (6,980 queries x 1,000 candidates, the timed
   rows beside the query-id sort of the torch glue, the plain version and
   ``torch.sort`` + ``cumsum`` + ``index_add_``, a yardstick), queries of 1,
   31, 33, 256, 257 and 16,384 documents, one of 100,000 (the long path,
   timed), long and short queries in one launch, a 900-way tie in queries of
   1,000, NaN, +-inf and +-0.0 scores, queries with no and with every
   document relevant, ids negative and not contiguous, rows shuffled: counts
   and the layout equal, AP, NDCG and AUROC within 1e-6 relative plus the
   float32 summation bound of the plain version's terms, two launches equal
   bit for bit; ``ssim_window``, the fused SSIM window, against its plain
   version in float64 at DIV2K's batch (4, 3, 1356, 2040) (timed beside
   cuDNN's depthwise convolution of the stacked maps plus the elementwise
   SSIM, a yardstick), its contrast sensitivity, the smallest input, odd
   sizes and sizes off the tile, uniform windows, sigma 0.5 and 4.3 (31
   taps), data ranges None, a float and a tuple (clamped in the kernel), the
   full map and the five MS-SSIM scales of the DIV2K batch: per-image SSIM
   and CS within 1e-5 relative, the map within 1e-5 absolute, two launches
   equal bit for bit; ``segmentation_counts``, the per-image class counts of
   two label maps, equal (``torch.equal``) to its plain version (JAX's
   one-hots) at the Cityscapes batch (2 x 1024 x 2048, C = 19, ~5 % void
   255) and the ADE20K-shaped batch (16 x 512 x 512, C = 150) in int64 (the
   timed rows, beside three ``bincount`` calls, a yardstick), uint8 and
   int32, on labels -1, -C, -C-1, -1000, C and C+3, at C = 1, 2, 1000 and
   4,097 (past the shared-memory histogram), on 3-D volumes, one-pixel
   images, odd sizes, mixed dtypes and an empty batch, two launches equal;
   ``pairwise_lp``, the tiled L_p distance matrix, within 1e-6 relative plus
   the float32 summation bound of the plain version's d terms at 1,024 x
   1,024 x 512 (p = 1, int 2, int 3 and 1.5 timed beside ``torch.cdist``;
   float 2.0 and 0.5), at N, M and d of 1, 31, 33 and 4,097 for p = 1, int
   2, 2.0, int 3, 4 and 5, 0.5 and 1.5, with NaN, +-inf and -0.0 in the rows, the
   square-root root and ``x is y`` with ``zero_diagonal``, on rows of
   magnitudes from 1e-30 to 1e30 with subnormal differences and values at p
   = 0.5, 1.5 and 5.5 and d = 1, 4,096 and 4,097, two launches
   equal bit for bit; ``segmentation_counts``' two timed rows are also timed
   after the flush's write alone, the earlier timer; ``confmat_multiclass`` also at the contingency tables
   of phase 11: (c) nominal's 1,024 labels at C = 42 with dropped rows,
   saturated +-inf and labels that wrap or drop, (d) clustering's 50,000
   labels at C = 1,000; ``snr_moments``, the SNR family's float64 moments
   and values, against its plain version (JAX's float32 forms) within 1e-4
   dB plus 1e-5 relative and a float64 evaluation within 1e-5 dB plus 1e-6
   relative, at the Libri2Mix batch (16 x 2 x 32,000: SI-SNR rows and
   PIT(SI-SNR) pairs timed beside one ``torch.bmm`` of the stacked rows; SNR,
   SI-SDR and SA-SDR groups), one 10-minute 16 kHz clip (timed), both
   ``zero_mean`` settings, identical inputs, inputs 80 dB apart, an all-zero
   target, T = 1, 3, 1003 and 4097, misaligned rows, pairs of S = 2 to 6 and
   an empty batch, two launches equal bit for bit; ``sdr_toeplitz``, SDR's
   Schur-type solve in float64, against a float64 LU within 1e-4 dB (the
   solution's normwise backward error within 1e-6) and its plain version (JAX's float32
   Toeplitz build and LU) within 1e-3 dB or, where the plain version itself
   drifts further from float64, within that drift plus 1e-4 dB, at the Libri2Mix batch's 32
   rows and PIT(SDR)'s 64 (timed beside ``torch.linalg.solve`` on the built
   matrices in float32 and float64), white, low-passed and speech-like
   targets, ``load_diag``, L = 1, 2, 33, 300 and the largest, 8,192, a
   silent target row and a 1e20 one whose norm overflows (NaN in those rows,
   as in the plain version and float64), and a pure tone (without
   ``load_diag`` recorded beside the plain and float64 values, not held);
   ``perplexity_nll``, Perplexity's fused log-softmax NLL, against its plain
   version (JAX's float32 ``log_softmax`` form), the total within 1e-5
   relative (NaN where it is NaN) and the count equal, two launches equal bit
   for bit, at GPT-2's vocabulary on 8 x 1,024 float32 rows and Llama-3's on
   4 x 2,048 bfloat16 rows (the timed rows, beside ``F.cross_entropy``), V =
   1, 2, 3, 4,096, 4,097 and 50,258, float16, ``ignore_index`` None, -100 and
   0, ignored rows of NaN and +-inf, targets -1, -V, V and -V-1 and an empty
   batch, and its backward against autograd of the plain version at 50,257;
   ``bert_greedy_match``, BERTScore's greedy matching, within 1e-5 of its
   plain version (F1 against its formula where P + R <= 0; NaN where it is
   NaN), two launches equal, at WMT16 newstest2016's 2,999 pairs of
   1,024-wide embeddings padded to 128 tokens (timed beside ``torch.bmm`` and
   two ``amax``, a yardstick; both and the plain version with TF32 matmuls
   off), the same shape with embeddings like a trained encoder's (a shared
   direction, four outlier dimensions at 40x), special-token masks with holes
   (position 0 and the last valid token), a NaN, +inf and -inf in a valid
   prediction row, a valid target row and masked rows (NaN in P, R and F1 of
   the first two pairs), Tp != Tt, T = 1, all-masked rows, rows whose
   valid similarities are all negative with and without an invalid entry on
   their axis, zero-norm embeddings, idf weights, H = 1, 33 and 4,096, Tp = Tt
   = 3,000 (past 128 listed tokens a side: passes over blocks) and an empty
   batch; ``mask_iou``, segm mAP's exact mask intersections and areas, held
   equal (``torch.equal``) to its plain version (JAX's float64 product) at a
   COCO image (100 detections, 7 ground truths, 480 x 640), a crowded one (60
   ground truths), PASCAL's 375 x 500 (the three timed beside ``torch.matmul``
   of float32 copies), all-empty and all-full masks, D = G = 1, 16 images of
   mixed sizes with D = 0 and G = 0 among them, an image of 300 + 40 masks
   and phase 14's launch, 200 images of 100 + 7 masks (timed beside
   ``torch.bmm`` of float32 copies);
   ``poly_mmd``, KID's subsets' polynomial MMD^2, within 1e-5 of the terms'
   scale of its plain version at KID's defaults (100 subsets of 1,000 of
   10,000 x 2,048, timed beside the gathered ``torch.bmm`` form), d = 64 and
   1,001, degrees 1-4 with given gamma and coef, m = 2, a NaN and a +inf
   feature, KID's defaults with 8 outlier dimensions, m = 129 and 255; at
   KID's defaults, with and without the outliers, within 1e-7 of the scale of
   a float64 evaluation; ``quantile_hist``, the curve sketch's insert, held
   equal (``torch.equal``) to its plain version (JAX's one-hot, stack and float
   scatter-add) from a random non-zero state, two launches equal, at
   ImageNet-1k's batch (1,024 x 1,000 multiclass), MS-COCO's (256 x 80
   multilabel) and the binary batch (the three timed, beside floor +
   ``index_add_``, a yardstick; library: none), on NaN, +-inf, -0.0, 0, 1.0,
   1.5, -0.5 and every cell edge with the values one ulp either side of it, ignored
   rows and elements, every row ignored, multiclass targets outside [0, C),
   multilabel targets 2 and -1, 50,000 binary rows (chunks of rows), the
   MS-COCO set in one launch, 10,000 bins (float atomics straight into the
   state), 3 cells and an empty batch; ``hll_insert``, DistinctNGrams'
   HyperLogLog insert, its registers and total equal to its plain version
   (JAX's window stack, key chain and scatter-max) from random registers, two
   launches equal, at phase 17's WikiText-103 batch (8 x 1,024 GPT-2 ids) at n
   = 1-4 (timed, beside ``scatter_reduce_(amax)`` of ranks computed outside the
   timing, a yardstick; library: none), precision 4, 14 and 18, ``ignore_index``
   windows, every window ignored, n longer than a row, ids -1, 2**31 - 1 and
   -2**31, the whole set in one launch at p = 14 and 18, and an empty batch;
   ``int8_quantize`` and ``int8_dequant_sum``, the int8 chunk codec of the
   compressed syncs, equal (``torch.equal``, a NaN equal to a NaN in its place)
   to their plain versions: the pack (the jitted scale and the host's), the
   sum of the n packed rows in JAX's order packed again and not, the host's
   sum, and the unpack side by side, at FID's 2,048-feature bucket in a world
   of 4 (the timed rows: the pack, phase 2's sum packed again, the final
   unpack) and of 1, the eval collection's bucket, chunks of 8, 9, 256 and
   1,024, lengths 1, chunk - 1 and n * chunk + 1, a chunk of zeros, values
   half-way between two codes, the +-127 edges, subnormals, NaN, +-inf and
   -0.0 (timed beside a chain of PyTorch calls, a yardstick; library: none);
4. main path: the single-device eval step (``MulticlassAccuracy`` micro,
   ``MulticlassF1Score`` macro, ``MulticlassAUROC(thresholds=20)``,
   ``MeanSquaredError``) over an ImageNet-1k validation-sized set, 50,000
   samples x 1,000 classes in batches of 1,024, through ``update_state`` and
   ``compute_state``; every kernel of the path must have launched, and the
   first 4 batches rerun on the port's CPU path must give the same states;
   the device operations of one profiled AUROC update are listed with
   their device times;
5. sync: the multi-device step. The same 50,000 x 1,000 scores, split over
   the ranks in whole batches of 1,024 (the 848-row batch on the last rank),
   go through a ``MetricCollection`` (``MulticlassAccuracy`` micro,
   ``MulticlassF1Score`` macro, ``MulticlassAUROC(thresholds=20)``,
   ``MulticlassAveragePrecision(thresholds=None)``), one coalesced
   ``sync_states`` and ``compute_states`` on every rank, in two worlds: NCCL
   with one rank per card, and gloo with 4 ranks on card 0 (CUDA tensors).
   Every rank's synced state must equal a single-process run over all
   50,000 rows (integer leaves and the cat rows exactly), and AP be within
   1e-6 of it; the collectives, bytes a bucket and sync time are printed.
   A second collection (mean, sum, max, cat, R2 and Pearson, whose sync is
   its own) syncs the rows' top score and whether it is right, timed apart;
   every rank must equal the single-process run. A third (phase 17 (vi)):
   a sketch-mode ``MulticlassAUROC`` over each rank's batches, a
   DistinctNGrams HyperLogLog over its blocks of phase 17's WikiText-103
   token batches and a BLEU reservoir of 256 over its blocks of phase 6's
   1,000 pairs, one coalesced sync: one ``all_reduce`` a (dtype, op) bucket
   (the histogram and the registers in theirs) and one fixed-shape gather
   for the reservoir, and every synced leaf equal to the single-process
   state bit for bit;
6. ragged: in the same two worlds, a different item count on every rank:
   ``ROUGEScore`` over 1,000 seeded sentence pairs and
   ``MeanAveragePrecision`` over a COCO-val2017-shaped seeded set (80
   classes, about 7 ground truths and 100 detections an image, 5,000 images),
   through ``sync_ragged_states`` and compute; the item counts must survive,
   the results equal a single-process run, and every rank's matcher launches
   be the chunks phase 3 checked; the single-process compute runs once, on
   rank 0 of the first world, under ``torch.profiler`` for the matcher's
   device time and the device operations it spends most time in, and both
   worlds' results are held equal to it;
7. classification tower, one card, no sync: (i) the ImageNet-1k set through a
   ``MetricCollection`` of the confusion matrix, Cohen's kappa, MCC and the
   Jaccard index (C=1,000) with macro precision, recall and specificity, and
   the composite ``1 - MulticlassAccuracy(average="micro")`` (top-1 error);
   the compute groups formed on the first batch are given to the timed
   collection, so ``confmat_multiclass`` must launch once a batch, 49 times;
   (ii) mIoU and the confusion matrix over 24 Cityscapes-shaped images (of
   the val set's 500, cut for the run's time) in batches of 2,
   ``ignore_index=255``; (iii) eight multilabel metrics over a MS-COCO 2014
   val-shaped set, 40,504 images x 80 labels in batches of 256; (iv) binary
   selective prediction over (i)'s scores (max softmax score, target "top-1
   correct"). Every leg reruns its first 4 batches on the port's CPU path
   and needs equal int32 states, and prints its update medians and values;
8. the curve family, aggregation and regression, one card, no sync: (i) phase
   4's 50,000 x 1,000 scores through the exact ``MulticlassAUROC`` and
   ``MulticlassROC`` (a 200 MB cat state, one exact compute over 1,000
   columns, no kernel); (ii) (iii)'s MS-COCO-shaped 40,504 x 80 set in
   batches of 256 through ``MultilabelAUROC``, ``MultilabelAveragePrecision``
   and ``MultilabelPrecisionRecallCurve`` at ``thresholds=100`` (one compute
   group: exactly 159 ``binned_confmat_multilabel`` launches) and the exact
   ``MultilabelAveragePrecision``; (iii) (iv)'s 50,000 binary rows through the
   exact ``BinaryAUROC`` (also at ``max_fpr=0.05``), ``BinaryAveragePrecision``
   and ``BinaryROC`` and ``BinaryAUROC(thresholds=200)`` (exactly 49 launches
   at one label); (iv) NYU Depth V2's labelled test split's shape, 654 seeded
   480 x 640 depth maps in batches of 8, through seven regression metrics and
   the mean, max and running mean of the per-batch L1 loss. Every leg reruns
   its first 4 batches on the CPU path (integer states equal, float states and
   values within a stated tolerance); every other new class runs over a seeded
   10,000-row set and is held against the CPU path;
9. the rest of classification, one card, no sync: (i) phase 4's ImageNet-1k
   set, as probabilities and again as their logits, through a
   ``MetricCollection`` of ``MulticlassCalibrationError(n_bins=15)`` with norm
   l1, l2 and max (one compute group: one ``calibration_bins`` launch a
   batch), ``MulticlassHingeLoss`` in both modes, ``MulticlassExactMatch``,
   ``Dice(num_classes=1000)`` and ``MulticlassRecallAtFixedPrecision``
   (``thresholds=20``: one ``binned_confmat_multiclass`` launch a batch);
   (ii) phase 7 (iii)'s MS-COCO shape through the three ranking metrics
   (exactly 477 ``ranking_pairs`` launches), ``MultilabelExactMatch`` and
   recall at fixed precision with precision at fixed recall at
   ``thresholds=100`` (one group: 159 ``binned_confmat_multilabel``
   launches); (iii) phase 7 (iv)'s 50,000 binary rows through
   ``BinaryCalibrationError`` (49 launches in binary mode), ``BinaryHingeLoss``
   plain and squared, the exact ``BinarySensitivityAtSpecificity`` and
   ``BinarySpecificityAtSensitivity(thresholds=200)`` (49 launches at one
   label); (iv) ``BinaryFairness`` and ``BinaryGroupStatRates`` over the
   CelebA test split's shape (19,962 seeded rows, two groups); (v)
   ``Dice(num_classes=19)`` on a Cityscapes-shaped batch with void 255
   raises the JAX package's ``ValueError``. Every leg reruns its first 4
   batches on the CPU path (integers equal, floats within 1e-5 relative);
10. retrieval and the image signal metrics, one card, no sync: (i) MS MARCO
   passage ranking's dev (small) shape, 6,980 queries x 1,000 seeded
   candidates (at least one and about 1.07 relevant a query), in updates of
   100 queries, through a ``MetricCollection`` of MRR@10, MAP, NDCG@10,
   recall@1000, precision@10, hit rate, R-precision, fall-out, AUROC and the
   precision-recall curve at ``max_k=100`` (exactly 10 ``retrieval_groups``
   launches: one a scalar measure, one ranked layout); (ii) TREC DL 2019
   passage's shape, 43 queries x 1,000 with graded relevance 0-3, through
   NDCG@10 and MAP on the binarized (>= 2) relevance; (iii) DIV2K
   validation's shape, 100 seeded 3 x 1356 x 2040 images with a noisy copy as
   ``preds`` in batches of 4, through PSNR, SSIM, MS-SSIM and VIF (exactly 25
   + 125 ``ssim_window`` launches), total variation, and PSNR-B on the luma;
   (iv) Kodak's shape, 24 images of 3 x 512 x 768, through UQI, SAM, ERGAS,
   RASE, RMSE-SW, SCC and D-lambda; (v) D-s and QNR over a small seeded
   4-band pan-sharpening set. The retrieval legs rerun their first 4
   updates on the CPU path, the image legs their first batch (floats within
   1e-5 relative);
11. segmentation, clustering, nominal and pairwise, one card, no sync: (i)
   24 seeded Cityscapes-shaped label maps (1024 x 2048, 19 classes, ~5 %
   void 255, counted as class 18 as JAX counts it) in batches of 2 through
   ``MeanIoU`` and ``GeneralizedDiceScore`` on index maps, each also per
   class (four groups: exactly 48 ``segmentation_counts`` launches); (ii) 64
   ADE20K-shaped maps (512 x 512, 150 classes) in batches of 16 through
   ``MeanIoU(per_class=True)`` and ``GeneralizedDiceScore(include_background=
   False, weight_type="square")`` (8 launches); (iii) ImageNet val's size:
   50,000 labels of 1,000 classes against 1,000 cluster ids through the
   nine extrinsic clustering metrics (one group; 10 ``confmat_multiclass``
   launches at compute), and 50,000 x 2,048 embeddings through
   Calinski-Harabasz, Davies-Bouldin and Dunn (2 ``pairwise_lp`` launches),
   each rerun on a 5,000-row subset on the CPU path (AMI also held against a
   float64 evaluation over all rows), and the contingency table of 50,000
   predicted ids (every row its own cluster) against the CPU path; (iv) the UCI Adult
   set's size, 48,842 rows of nine categorical columns at its
   cardinalities: Cramer's V, Tschuprow's T, Pearson's coefficient and
   Theil's U over occupation x education under both NaN strategies in
   batches of 1,024 (two groups: one launch a group and batch), the Cramer's
   V and Theil's U matrices over the nine columns (36 and 72 launches), and
   ``FleissKappa(mode="probs")`` over 10,000 x 5 x 10 ratings; (v)
   Market-1501's evaluation shape, 3,368 query x 19,732 gallery features of
   width 2,048: Manhattan, Minkowski at its default exponent 2, at 3 and 1.5
   (one ``pairwise_lp`` launch each, held whole against the plain version on
   the card and timed beside ``torch.cdist``; the SM clock printed beside
   the bounds, which take 1.98 GHz), Euclidean and cosine, the first 64 x
   512 block of each against the CPU path;
12. audio, one card, no sync: (i) Libri2Mix test's shape, 3,000 seeded
   two-speaker 8 kHz mixtures of 4 s (32,000 samples; the set's lengths
   vary, cut to one), estimates 5-15 dB below each source with a leak of the
   other, the speakers swapped in every other batch, in batches of 16 through
   ``SignalNoiseRatio``, SI-SNR, SI-SDR, SA-SDR, ``SignalDistortionRatio``
   (``filter_length=512``) and speaker-wise PIT over SI-SNR and SDR (seven
   groups: exactly 5 ``snr_moments`` and 2 ``sdr_toeplitz`` launches a
   batch); (ii) VoiceBank-DEMAND test's shape, 824 seeded speech-like 16 kHz
   clips of 3 s with silent gaps and a noisy copy at 0-15 dB, through STOI,
   extended STOI and SRMR; (iii) ``ComplexScaleInvariantSignalNoiseRatio``
   on the 512-point STFTs of (i)'s first 256 mixtures (one launch a batch).
   Every leg reruns its first batch on the CPU path (floats within 1e-4
   relative);
13. text, one card, no sync: (i) WikiText-103 test's length, about 280,000
   GPT-2 tokens, as 35 batches of 8 x 1,024 float32 logits seeded on the card,
   ``ignore_index=-100`` on the padded tail, through ``Perplexity`` (exactly
   35 ``perplexity_nll`` launches); (ii) WMT16 newstest2016's 2,999 seeded
   pairs (10-128 tokens) in updates of 64 through ``BERTScore(model=...,
   user_tokenizer=..., idf=True)`` on a random-init ``RobertaModel`` at
   roberta-large's widths cut to its first 17 layers (one
   ``bert_greedy_match`` launch at compute); (iii) 256 pairs through
   ``InfoLM`` on a random-init ``BertForMaskedLM`` at
   bert_uncased_L-2_H-128_A-2's widths saved to a temporary directory; (iv)
   WER, CER, MER, WIL, WIP, SacreBLEU (13a), chrF++, TER, EED, SQuAD and
   distinct bigrams over 2,000 seeded sentence pairs in updates of 100 (TER
   and EED, Python DPs, over the first 500: depth cut for the run's time),
   each update timed. Legs (i)-(iii) rerun their first batch on the CPU path
   (BERTScore's encoder stays on the card for both: the CPU path is the
   metric's), (iv) its first update (states equal);
14. detection beyond bbox, one card, no sync: (i) COCO val2017's shape for
   segm, 200 seeded images of 480 x 640 (``_coco_images``' boxes, labels,
   scores and 1 % crowds; each box's inscribed ellipse as its mask; the image
   count cut from 5,000 because the dense mask states hold 30.7 MB an image)
   in batches of 20 through ``MeanAveragePrecision(iou_type="segm")`` and
   ``iou_type=("bbox", "segm")`` with ``extended_summary=True`` (exactly 2
   ``mask_iou`` launches, one a compute; ``coco_match`` for the matching);
   (ii) COCO panoptic val2017's shape, 500 seeded 480 x 640 maps (133
   categories: 80 things with RGB-encoded instance ids, 53 stuffs; 20
   segments, void on the boundaries) in batches of 16 through
   ``PanopticQuality`` and ``ModifiedPanopticQuality`` (exactly 1,000
   ``confmat_multiclass`` launches, one an image and metric); (iii) the four
   IoU-family metrics on (i)'s boxes; (iv) a ``tm_to_coco`` -> ``coco_to_tm``
   round trip of (i)'s first batch (masks, labels, scores and crowds equal,
   segm ``map`` equal). Each leg reruns its first batch on the CPU path
   (counts equal, floats within 1e-6);
15. generative image metrics, one card, no sync: (i) CIFAR-10 test's size,
   10,000 seeded real and fake 32 x 32 images in batches of 250 through FID
   (2048), KID (defaults: exactly one ``poly_mmd`` launch at compute), IS
   (``logits_unbiased``, 10 splits) and MiFID, each on the random-init
   InceptionV3 at full width in full float32; (ii) BAPPS 2AFC val's patch
   size, 4,000 seeded 64 x 64 pairs through LPIPS with alex, vgg and squeeze;
   (iii) PPL with 2,000 samples (cut from 10,000) of a seeded conv generator
   (512-wide latent, 128 x 128 images resized to 64) with the VGG net. (i)'s
   computes are held on the final states: FID, MiFID and IS computed on the
   CPU from copies of the card's states (FID and MiFID within 1e-6 relative,
   IS within 1e-5), KID's 100 subsets, drawn as its compute draws them, by the plain
   version on the card within 1e-5 of the terms' scale; InceptionV3's resize
   and network are timed on a batch. Each leg reruns its first batch on the
   CPU path ((i) the batch's first 16 images through each metric's
   functional core, for the CPU's time: states within 1e-4 of their scale;
   LPIPS' first 16 pairs within 1e-4; PPL's distances on the same latents
   within 1e-2, float32 noise over epsilon ** 2);
16. multimodal and the wrappers, one card, no sync: (i) ``CLIPScore`` on a
   random-init ``CLIPModel`` at openai/clip-vit-large-patch14's widths
   (about 428 M parameters, drawn on the card from a seed) with a
   character-level vocabulary, saved to a temporary directory and loaded as
   a user would, over COCO val2017's shape: 1,000 seeded 3 x 480 x 640
   uint8 images with seeded captions of 5-20 words in batches of 50 (the
   truncation warning must fire); (ii) ``CLIPImageQualityAssessment`` on the
   same model over KonIQ-10k's shape, 500 seeded 3 x 768 x 1024 images in
   batches of 25 at ``data_range=255`` with the 16 prompt keywords and a
   custom pair; each times the host preprocessing, the towers and the update
   of every batch, and reruns its first batch (CLIPScore: its first 8 pairs)
   on the CPU path (features within 1e-4 of their scale, scores within 2e-2
   on the 0-100 scale, probabilities within 1e-2); (iii) ``FeatureShare`` of
   FID, KID and IS at the 2048-wide pool over 2,000 of phase 15's CIFAR-10
   images (one InceptionV3 forward an update, values within 1e-9 relative of
   the unshared metrics'; exactly one ``poly_mmd`` launch at compute),
   ``BootStrapper(MulticlassAccuracy)`` with 10 replicates over 10 of phase
   4's ImageNet-1k batches (raw values equal to the CPU path's on seed 0),
   and ``MetricTracker``, ``Running``, ``MultitaskWrapper``,
   ``ClasswiseWrapper(MulticlassJaccardIndex)`` and ``MinMaxMetric`` over
   those batches, each against the CPU path (exactly 20
   ``confmat_multiclass`` launches);
17. the sketches (every ``approx`` mode), one card, no sync: (i) phase 4's
   ImageNet-1k set (50,000 x 1,000 in batches of 1,024) through
   ``MulticlassAUROC`` and ``MulticlassAveragePrecision`` with
   ``approx="sketch"`` (one group: exactly 49 ``quantile_hist`` launches),
   phase 7 (iii)'s MS-COCO set (40,504 x 80 in batches of 256) through
   ``MultilabelAUROC(approx="sketch")`` (159) and phase 7 (iv)'s binary rows
   through ``BinaryAUROC`` and ``BinaryROC`` (49), and one batch of them
   that requires grad (one launch, the histogram of the detached scores);
   each value equal, within 1e-6, to the binned path at exactly the sketch's
   201 edges, and each AUROC within the histogram's ``auc_error_bound`` of
   the exact path; (ii)
   ``MulticlassCalibrationError(approx="sketch")`` on the ImageNet-1k
   batches (the ``calibration_bins`` kernel, its counts in float leaves),
   equal to the exact path at 200 bins; (iii) WikiText-103 test's length in
   GPT-2 token ids (Zipf-distributed, seeded) through
   ``DistinctNGrams(approx="sketch")`` at n = 1-4 (exactly 140 ``hll_insert``
   launches), each estimate within 4 x its RSE of the exact ratio; (iv)
   ``BLEUScore`` and ``SacreBLEUScore(approx="reservoir")`` over WMT16
   newstest2016's 2,999 seeded pairs (1,024 kept: the reservoir rows equal the
   CPU run's bit for bit; the estimate printed beside the exact score and the
   stamped bound) and ``ROUGEScore(approx="reservoir")`` over phase 6's
   1,000 pairs (all kept: equal to the exact path within 1e-6); (v)
   ``MeanAveragePrecision(approx="sketch")`` over phase 6's 5,000
   COCO-val2017-shaped images in updates of 100 (each update's items matched
   on the card by ``coco_match``), its histograms and counters equal to the
   CPU run's, the sketch ``map`` printed beside the exact one and the stamped
   bound (whether the documented one-sided bound held is recorded, and a miss
   does not fail the phase: no JAX test holds it). Legs (i)-(iii) rerun their
   first batches on the CPU path (states equal bit for bit; calibration's
   ``conf_sum`` within 1e-5).

18. sync engineering, in phase 5's two worlds: (i) FID's 2,048-feature state
   (integer-valued seeded features from a callable extractor, 10,000 real and
   10,000 fake rows fed over the ranks in proportion 1 : 2 : ... : world)
   synced exact, ``bf16``, ``int8``, sharded (both covariance sums a
   ``reduce_scatter``) and sharded ``int8``: the collectives each issued equal
   to its plan's ``n_collectives``, the exact and sharded states equal to one
   process's bit for bit (and FID's value on rank 0), each compressed bucket
   within its declared bound of the exact one, per chunk (bf16: ``2**-8`` a
   rounding, one a ring hop), each sync timed beside ``bucket_wire_bytes``'
   model; (ii) a weight-masked sync (the last rank's weight 0): sum, min, max
   and MEAN leaves equal to the other ranks' combination; (iii) phase 5's
   Accuracy, F1 and AUROC through ``sharded_collection_update`` with
   ``SyncPolicy(every_n_steps=4)`` (``None`` on deferred steps, each synced
   window equal to the every-step sync, the values equal to phase 5's bit for
   bit), with ``at_compute=True``, and a snapshot mid-window restored into a
   new stepper; (iv) mAP and ROUGE registered on one ``DeferredRaggedSync``
   over phase 6's data: one ``all_gather`` a wire type at compute, the values
   equal to phase 6's. The ``int8_quantize`` and ``int8_dequant_sum``
   launches of (i) are counted per rank.

Phases 5, 6 and 18 run each rank as a process of its own (this script with
``--worker``); every kernel must have launched on the paths that run it.

The line before the last is the kernel record (JSON); the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import collections
import datetime
import functools
import importlib
import importlib.util
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

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data sheet, dense, at the full 700 W power limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_OPS_PER_S = 67e12
PEAK_FP64_OPS_PER_S = 34e12  # outside the tensor cores
PEAK_TF32_OPS_PER_S = 495e12  # the tensor cores, dense

N_SAMPLES, N_CLASSES, BATCH = 50_000, 1_000, 1_024  # ILSVRC2012 validation set
SEED = 0


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


L2_BYTES = 50 * 2**20
HOST_US_PER_CALL = 200  # the spin before a timed call or run allows this much host time a call
CLOCK_HZ = 1.98e9  # the H100's boost clock: the spin's cycles; at a lower clock the spin lasts longer


def flush_buffer() -> torch.Tensor:
    """The L2 flush of ``time_ms``: 2 x 256 MB, past the 50 MB L2."""
    return torch.empty(2 * 64 * 2**20, dtype=torch.float32, device="cuda")


def flush_l2(flush: torch.Tensor, clean: bool = True) -> None:
    """Write the first half of ``flush``; then, if ``clean``, read the second half, so the L2 holds clean lines
    only and a timed call that follows pays for no write-back of the flush's dirty lines."""
    half = flush.shape[0] // 2
    flush[:half].zero_()
    if clean:
        flush[half:].sum()


def time_ms(fn, flush: torch.Tensor, reps: int = 30, warmup: int = 3, clean: bool = True) -> float:
    """Median device time of ``fn`` in ms, by CUDA events, the L2 cache flushed before each rep (``flush_l2``;
    ``clean=False``: the write alone, which leaves up to 50 MB of dirty lines to the timed call).

    After the flush a spin kernel holds the card while the host enqueues ``fn``, so the events
    time the device's work alone and not the host's enqueue; a rep whose enqueue outlasted the
    spin runs again with a spin twice as long. A ``fn`` that waits for the device itself (a host
    read, as ``bincount`` makes) outlasts any spin: it is timed without one, its host time in.
    """
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times, host_us = [], HOST_US_PER_CALL
    while len(times) < reps:
        flush_l2(flush, clean)
        spin_start, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        t0 = time.perf_counter()
        spin_start.record()
        if host_us:
            torch.cuda._sleep(int(host_us * 1e-6 * CLOCK_HZ))
        start.record()
        fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        torch.cuda.synchronize()
        if not host_us or host_ms < spin_start.elapsed_time(start):
            times.append(start.elapsed_time(end))
        elif host_us < 64 * HOST_US_PER_CALL:
            host_us *= 2
        else:
            host_us = 0  # fn waits for the device: no spin covers its enqueue
    return statistics.median(times)


def sm_clocks() -> str:
    """The SM clock now and at most, as ``nvidia-smi`` gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()


def launch_floor(flush: torch.Tensor) -> dict:
    """An empty kernel's time after the clean flush, after the write alone, and a call of a run back to back
    (``time_stream_ms``): the floors of every timed row."""
    empty = lambda: torch.cuda._sleep(0)  # noqa: E731
    floor = {"clean": time_ms(empty, flush), "write_only": time_ms(empty, flush, clean=False),
             "back_to_back": time_stream_ms(empty, [()] * 2, calls=96)}
    print(f"[time] an empty kernel after the clean L2 flush: {floor['clean']:.4f} ms (after the write alone "
          f"{floor['write_only']:.4f} ms; back to back {floor['back_to_back']:.4f} ms a call): the launch floor")
    return floor


def host_enqueue_us(fn, calls: int = 200) -> float:
    """Median host time in us to enqueue one call of ``fn``, over ``calls`` calls with no synchronize between
    them: what a host-bound loop pays a call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return statistics.median(times) * 1e6


def copies_for(set_bytes: int) -> int:
    """Copies of one input set that hold more than twice the L2 cache together."""
    return max(2, -(-2 * L2_BYTES // set_bytes))


def time_stream_ms(fn, arg_sets, calls: int, runs: int = 3) -> float:
    """Device ms per call of ``fn``, called back to back as an eval loop calls it.

    ``arg_sets`` are copies of the same inputs, more than twice the L2 cache in
    all (``copies_for``), taken in turn, so each call finds its inputs cold.
    A spin kernel holds the card while the host enqueues the ``calls`` calls,
    so the time between the CUDA events is the device's alone; the run fails
    if the host was not done before the spin ended. Median of ``runs`` runs.
    """
    for args in arg_sets:
        fn(*args)
    torch.cuda.synchronize()
    per_call, host_us = [], HOST_US_PER_CALL
    while len(per_call) < runs:
        spin_start, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        spin_start.record()
        torch.cuda._sleep(int(calls * host_us * 1e-6 * CLOCK_HZ))
        start.record()
        t0 = time.perf_counter()
        for i in range(calls):
            fn(*arg_sets[i % len(arg_sets)])
        host_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        torch.cuda.synchronize()
        if host_ms < spin_start.elapsed_time(start):
            per_call.append(start.elapsed_time(end) / calls)
        else:  # the card caught up with the host: spin longer and run again
            check(host_us < 16 * HOST_US_PER_CALL, f"the host took {host_ms:.3f} ms to enqueue {calls} calls")
            host_us *= 2
    return statistics.median(per_call)


def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(smi)
    info = {
        "nvidia_smi": smi,
        "name": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
    }
    print(f"[device] {info['name']} x{info['count']}, torch {info['torch']}, CUDA {info['cuda']}")
    return info


def phase_build() -> float:
    from torchmetrics_tpu_torch.kernels import _build

    sources = sorted(p[:-3] for p in os.listdir(_build.CSRC_DIR) if p.endswith(".cu"))
    t0 = time.perf_counter()
    logs = _build.build(sources)
    seconds = time.perf_counter() - t0
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "warning" in line:
                print(f"[build] {name}: {line.strip()}")
    print(f"[build] {len(sources)} source(s) {sources}, {len(logs)} compiled in {seconds:.2f} s")
    return seconds


def _confmat_inputs(n: int, c: int, thresholds, zero_weight_share: float, edits, gen: torch.Generator):
    """A formatted batch ``(probs, target, weights, thresholds)`` on the card and a random non-zero int32 state."""
    from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import _adjust_threshold_arg

    dev = torch.device("cuda")
    thr = _adjust_threshold_arg(thresholds, dev)
    logits = 3.0 * torch.randn((n, c), generator=gen, device=dev)
    probs = torch.softmax(logits, dim=1)
    target = torch.randint(0, c, (n,), generator=gen, device=dev, dtype=torch.int32)
    # scores exactly on thresholds, where `>=` decides the bin
    finite = thr[torch.isfinite(thr)]
    rows = torch.arange(0, n, 5, device=dev)
    probs[rows, rows % c] = finite[rows % finite.shape[0]]
    probs[rows, target[rows].long()] = finite[(rows + 1) % finite.shape[0]]
    weights = (torch.rand((n,), generator=gen, device=dev) >= zero_weight_share).to(torch.float32)
    target = torch.where(weights == 0, 0, target)  # as _multiclass_prc_format leaves an ignored row
    if "nonfinite_scores" in edits:
        for i, value in enumerate([float("nan"), float("inf"), float("-inf")]):
            probs[i::7, 3 + 2 * i] = value
            probs[torch.arange(3 + i, n, 11, device=dev), target[3 + i :: 11].long()] = value  # true classes too
    if "out_of_range" in edits:
        for i, value in enumerate([c, c + 3, -3]):
            target[i::6] = value
    state = torch.randint(-(2**20), 2**20, (thr.shape[0], c, 2, 2), generator=gen, device=dev, dtype=torch.int32)
    return probs.contiguous(), target, weights, thr, state


def phase_kernels(flush: torch.Tensor) -> dict:
    from torchmetrics_tpu_torch.functional.classification import precision_recall_curve as prc
    from torchmetrics_tpu_torch.kernels import binned_confmat as kbc

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    unsorted37 = torch.rand((37,), generator=gen, device="cuda").tolist()
    nan, inf = float("nan"), float("inf")
    # duplicates, NaN, +-inf, signed zeros and a finite span that overflows float32
    edge_list = [0.5, nan, 0.1, inf, -inf, 0.1, nan, 0.0, -0.0, 1.0, 0.9, 0.5, 0.05, -3e38, 3e38]
    cases = [  # (what, rows, classes, thresholds, share of zero weights, edits); the first is the main path's
        ("slice", BATCH, N_CLASSES, 20, 0.0, ()),
        ("ragged last batch", N_SAMPLES % BATCH, N_CLASSES, 20, 0.0, ()),
        ("fine grid", BATCH, N_CLASSES, 200, 0.0, ()),
        ("unsorted list, ~10% zero weights", BATCH, N_CLASSES, unsorted37, 0.1, ()),
        ("grid of 1000", BATCH, N_CLASSES, 1000, 0.0, ()),
        ("grid of 4000, bin ranges split", 256, N_CLASSES, 4000, 0.0, ()),
        ("duplicate, NaN and +-inf thresholds", BATCH, N_CLASSES, edge_list, 0.0, ()),
        ("NaN and +-inf scores", BATCH, N_CLASSES, 20, 0.0, ("nonfinite_scores",)),
        ("C % 4 != 0, scalar loads", BATCH, N_CLASSES + 1, 20, 0.0, ()),
        ("out-of-range targets, ~10% ignored rows", BATCH, N_CLASSES, 20, 0.1, ("out_of_range",)),
    ]
    rows = []
    for what, n, c, thresholds, zero_share, edits in cases:
        p, t, w, thr, state = _confmat_inputs(n, c, thresholds, zero_share, edits, gen)
        n_thr = thr.shape[0]
        sorted_thr, order = prc._sort_thresholds(thr)
        geometry = kbc.plan(n, c, n_thr, torch.cuda.get_device_properties(0).multi_processor_count)
        label = f"{what} N={n} C={c} T={n_thr}"
        before = state.clone()
        got = kbc.binned_confmat_multiclass(state, p, t, w, sorted_thr, order)
        want = prc._binned_confmat_multiclass_accumulate_plain(state, p, t, w, thr, c)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(torch.equal(got, want), f"fused update and plain state differ ({label}): max abs err {err}")
        check(torch.equal(state, before), f"the fused update wrote into the old state ({label})")
        check(int((want - state)[..., 1, :].sum()) > 0, f"no positive rows counted ({label})")
        if what == "slice":  # the per-batch counts function takes the kernel on the card too
            check(torch.equal(prc._binned_confmat_multiclass(p, t, w, thr, c),
                              prc._binned_confmat_multiclass_plain(p, t, w, thr, c)), "per-batch counts differ")
        if "split" in what:
            check(geometry.grid[2] > 1, f"bins were not split ({label}: {geometry})")
        # least work of the fused update: read probs, target, weights, the sorted
        # thresholds and their order, and the old state once, write the new state
        # once; bin each score with ceil(log2(T+1)) compares, plus the two suffix
        # sums over (T+1) x C bins. The count of a design that compares every
        # score with every threshold, 2*N*C*T (a compare and an add per
        # (n, c, t)), is printed beside it.
        nbytes = n * c * 4 + n * 4 * 2 + n_thr * 4 * 2 + 2 * n_thr * c * 16
        nops = n * c * math.ceil(math.log2(n_thr + 1)) + 2 * c * (n_thr + 1)
        bytes_ms, ops_ms = nbytes / PEAK_BYTES_PER_S * 1e3, nops / PEAK_FP32_OPS_PER_S * 1e3

        # times: one call after an L2 flush (the record's `ms` and `plain_ms`),
        # and per call back to back over cold copies of the inputs (`stream_ms`)
        fused = lambda s, p_, t_, w_: kbc.binned_confmat_multiclass(s, p_, t_, w_, sorted_thr, order)  # noqa: E731
        kernel_ms = time_ms(lambda: fused(state, p, t, w), flush)
        plain_ms = time_ms(lambda: prc._binned_confmat_multiclass_accumulate_plain(state, p, t, w, thr, c), flush)
        read_ms = time_ms(lambda: p.sum(0), flush)  # one PyTorch kernel that reads the same scores once
        sets = [(state, p, t, w)] + [tuple(x.clone() for x in (state, p, t, w))
                                     for _ in range(copies_for(nbytes) - 1)]
        stream_ms = time_stream_ms(fused, sets, calls=len(sets) * max(1, 96 // len(sets)))
        del sets
        # after the timed launches, each with its own scratch from the caching allocator, still exact
        check(torch.equal(fused(state, p, t, w), want), f"fused update differs after the timed launches ({label})")
        row = {
            "case": label, "n": n, "c": c, "t": n_thr, "max_abs_err": err, "plan": geometry._asdict(),
            "ms": kernel_ms, "stream_ms": stream_ms, "plain_ms": plain_ms, "read_ms": read_ms,
            "bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "ops": nops, "all_pairs_ops": 2 * n * c * n_thr, "library_ms": None,
        }
        print(
            f"[kernel] binned_confmat_multiclass {label}: exact, fused update {kernel_ms:.4f} ms after an L2 flush "
            f"({stream_ms:.4f} ms a call back to back; tile {geometry.tile_c} classes, grid {geometry.grid}), "
            f"plain {plain_ms:.4f} ms, probs.sum(0) {read_ms:.4f} ms, "
            f"bound {row['bound_ms'] * 1e3:.2f} us ({row['bound_by']}: {nbytes} bytes, {nops} ops; "
            f"{row['all_pairs_ops']} ops comparing every score with every threshold), library_ms: none"
        )
        rows.append(row)
    return {"binned_confmat_multiclass": rows}


def _multilabel_inputs(n: int, labels: int, thresholds, zero_weight_share: float, edits, gen: torch.Generator):
    """A formatted multilabel batch ``(probs, target, weights, thresholds)`` on the card (sigmoid scores,
    ~30 % positives, some scores exactly on thresholds) and a random non-zero int32 state."""
    from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import _adjust_threshold_arg

    dev = torch.device("cuda")
    thr = _adjust_threshold_arg(thresholds, dev)
    probs = torch.sigmoid(2.0 * torch.randn((n, labels), generator=gen, device=dev))
    target = (torch.rand((n, labels), generator=gen, device=dev) < 0.3).to(torch.int32)
    finite = thr[torch.isfinite(thr)]
    cells = torch.arange(0, n * labels, 5, device=dev)
    probs.view(-1)[cells] = finite[cells % finite.shape[0]]  # where `>=` decides the bin
    weights = (torch.rand((n, labels), generator=gen, device=dev) >= zero_weight_share).to(torch.float32)
    if "zero_weights" in edits:
        weights.zero_()
    target = torch.where(weights == 0, 0, target)  # as _multilabel_prc_format leaves an ignored element
    if "nonfinite_scores" in edits:
        for i, value in enumerate([float("nan"), float("inf"), float("-inf")]):
            probs.view(-1)[i::7] = value
    state = torch.randint(-(2**20), 2**20, (thr.shape[0], labels, 2, 2), generator=gen, device=dev, dtype=torch.int32)
    return probs.contiguous(), target, weights, thr, state


def _bucketize_bincount(probs, target, weights, sorted_thr):
    """The same counts by PyTorch calls, a yardstick: ``bucketize`` each score among the
    sorted thresholds, ``bincount`` of ``label * (T + 1) + bin`` weighted by ``w`` and by
    ``w * target``, and the suffix sums by ``flip`` + ``cumsum``."""
    n_thr, labels = sorted_thr.shape[0], probs.shape[1]
    bins = torch.bucketize(probs, sorted_thr, right=True)
    flat = (torch.arange(labels, device=probs.device) * (n_thr + 1) + bins).view(-1)
    hpos = torch.bincount(flat, weights=weights.view(-1), minlength=labels * (n_thr + 1)).view(labels, -1)
    htp = torch.bincount(flat, weights=(weights * target).view(-1), minlength=labels * (n_thr + 1)).view(labels, -1)
    return torch.flip(torch.cumsum(torch.flip(hpos, (1,)), 1), (1,)), torch.flip(torch.cumsum(torch.flip(htp, (1,)), 1), (1,))


ML_LABELS, ML_THRESHOLDS = 80, 100  # phase 8 (ii): MS-COCO's 80 labels at thresholds=100
BIN_THRESHOLDS = 200  # phase 8 (iii): BinaryAUROC(thresholds=200)
MAX_STREAM_COPIES = 200


PROFILE_TRIES = 3


def _profiled(fn):
    """``(profile, seconds)`` of one call of ``fn`` (synchronized) under ``torch.profiler``.
    CUPTI now and then hands back no device record for a whole short session; such a
    session is run again, up to ``PROFILE_TRIES`` times, and the last one is returned."""
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for attempt in range(PROFILE_TRIES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.profiler.profile(activities=activities) as prof:
            fn()
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        if any(e.device_type == torch.autograd.DeviceType.CUDA for e in prof.events()):
            break
        print(f"[profile] session {attempt + 1} of {PROFILE_TRIES} recorded no device operation", file=sys.stderr)
    return prof, seconds


def _device_ops(fn) -> list:
    """``(name, device us)`` of each device operation (kernel, memset, copy) of one call
    of ``fn``, in launch order, by ``torch.profiler``; ``fn`` runs once before, unprofiled."""
    fn()
    prof, _ = _profiled(fn)
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return [(e.name, e.time_range.elapsed_us()) for e in sorted(events, key=lambda e: e.time_range.start)]


def phase_multilabel_kernel(flush: torch.Tensor) -> list:
    """``binned_confmat_multilabel`` against its plain version on the card, timed and
    profiled (one kernel a call, no memset) at the two shapes phase 8 gives it: the COCO
    batch (256, 80) at T=100 (the first row) and the binary batch at one label, (1024, 1)
    at T=200."""
    prc = importlib.import_module("torchmetrics_tpu_torch.functional.classification.precision_recall_curve")
    from torchmetrics_tpu_torch.kernels import binned_multilabel as kbm

    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    nan, inf = float("nan"), float("inf")
    unsorted_dups = [0.7, 0.2, 0.2, 0.95, 0.01, 0.5, 0.5, 0.33, 0.9, 0.9]
    edge_list = [0.5, nan, 0.1, inf, -inf, 0.1, nan, 0.0, -0.0, 1.0, 0.9, 0.5, 0.05, -3e38, 3e38]
    cases = [  # (what, rows, labels, thresholds, share of ignored elements, edits); the first two are phase 8's
        ("COCO batch (a)", COCO_ML_BATCH, ML_LABELS, ML_THRESHOLDS, 0.0, ()),
        ("binary batch, one label (b)", BATCH, 1, BIN_THRESHOLDS, 0.0, ()),
        ("last binary batch, one label", N_SAMPLES % BATCH, 1, BIN_THRESHOLDS, 0.0, ()),
        ("~15% ignore_index elements", COCO_ML_BATCH, ML_LABELS, ML_THRESHOLDS, 0.15, ()),
        ("one label, ~15% ignored", BATCH, 1, BIN_THRESHOLDS, 0.15, ()),
        ("NaN and +-inf scores", COCO_ML_BATCH, ML_LABELS, ML_THRESHOLDS, 0.0, ("nonfinite_scores",)),
        ("one label, NaN and +-inf scores", BATCH, 1, BIN_THRESHOLDS, 0.0, ("nonfinite_scores",)),
        ("unsorted and duplicate thresholds", COCO_ML_BATCH, ML_LABELS, unsorted_dups, 0.0, ()),
        ("duplicate, NaN and +-inf thresholds", COCO_ML_BATCH, ML_LABELS, edge_list, 0.0, ()),
        ("grid of 4000", COCO_ML_BATCH, ML_LABELS, 4000, 0.0, ()),
        ("the most thresholds, one label a block", 64, 3, kbm.MAX_THRESHOLDS, 0.1, ()),
        ("all-zero weights", COCO_ML_BATCH, ML_LABELS, ML_THRESHOLDS, 0.0, ("zero_weights",)),
        ("L=81", COCO_ML_BATCH, ML_LABELS + 1, ML_THRESHOLDS, 0.1, ()),
        ("L=1000, 7 labels a block, a short last group", BATCH, 1000, 20, 0.05, ()),
        ("8 labels a block, row chunks merged by the last block", N_SAMPLES, ML_LABELS, ML_THRESHOLDS, 0.05,
         ("nonfinite_scores",)),
        ("the whole binary set, row chunks merged", N_SAMPLES, 1, BIN_THRESHOLDS, 0.0, ()),
    ]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for what, n, labels, thresholds, zero_share, edits in cases:
        p, t, w, thr, state = _multilabel_inputs(n, labels, thresholds, zero_share, edits, gen)
        n_thr = thr.shape[0]
        sorted_thr, order = prc._sort_thresholds(thr)
        geometry = kbm.plan(n, labels, n_thr, sms)  # as the launcher plans it
        label = f"{what} N={n} L={labels} T={n_thr}"
        before = state.clone()
        got = kbm.binned_confmat_multilabel(state, p, t, w, sorted_thr, order)
        want = prc._binned_confmat_multilabel_accumulate_plain(state, p, t, w, thr)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(torch.equal(got, want), f"binned_confmat_multilabel and plain state differ ({label}): max abs err {err}")
        check(torch.equal(state, before), f"the multilabel update wrote into the old state ({label})")
        added = int((want - state)[..., 1, :].sum())
        check(added > 0 or "zero_weights" in edits, f"no positive counted ({label})")
        check(added == 0 or "zero_weights" not in edits, f"zero weights counted ({label})")
        check((geometry.chunks > 1) == ("merged" in what), f"row chunks ({label}: {geometry})")
        if "merged" in what:  # a second launch: the tickets were set back to zero
            check(torch.equal(kbm.binned_confmat_multilabel(state, p, t, w, sorted_thr, order), want),
                  f"the merged update differs in a second launch ({label})")
        if labels == 1 and what.endswith("(b)"):  # the binary per-batch counts take the kernel on the card too
            check(torch.equal(prc._binned_curve_update(p[:, 0], t[:, 0], w[:, 0], thr),
                              prc._binned_confmat_multilabel_plain(p, t, w, thr)[:, 0]), "binary per-batch counts differ")
        if what.endswith("(a)"):
            check(torch.equal(prc._binned_confmat_multilabel(p, t, w, thr),
                              prc._binned_confmat_multilabel_plain(p, t, w, thr)), "multilabel per-batch counts differ")
        if not (what.endswith("(a)") or what.endswith("(b)")):
            rows.append({"case": label, "what": what, "max_abs_err": err, "plan": geometry._asdict()})
            continue
        # least work: read probs, target and weights, the sorted thresholds and their
        # order once, read the old state and write the new one; bin each score with
        # ceil(log2(T+1)) compares, plus the two suffix sums over (T+1) x L bins
        nbytes = 3 * n * labels * 4 + 2 * n_thr * 4 + 2 * n_thr * labels * 16
        nops = n * labels * math.ceil(math.log2(n_thr + 1)) + 2 * labels * (n_thr + 1)
        bytes_ms, ops_ms = nbytes / PEAK_BYTES_PER_S * 1e3, nops / PEAK_FP32_OPS_PER_S * 1e3
        fused = lambda s, p_, t_, w_: kbm.binned_confmat_multilabel(s, p_, t_, w_, sorted_thr, order)  # noqa: E731
        ops = _device_ops(lambda: fused(state, p, t, w))
        check(len(ops) == 1 and "binned_multilabel_kernel" in ops[0][0],
              f"a multilabel update is not exactly one kernel ({label}): {ops}")
        kernel_ms = time_ms(lambda: fused(state, p, t, w), flush)
        plain_ms = time_ms(lambda: prc._binned_confmat_multilabel_accumulate_plain(state, p, t, w, thr), flush)
        bincount_ms = time_ms(lambda: _bucketize_bincount(p, t, w, sorted_thr), flush)
        # at most MAX_STREAM_COPIES copies: more calls than the launch queue holds would block the
        # host behind the spin (the one-label batch's copies stay in L2)
        copies = min(copies_for(nbytes), MAX_STREAM_COPIES)
        sets = [(state, p, t, w)] + [tuple(x.clone() for x in (state, p, t, w)) for _ in range(copies - 1)]
        stream_ms = time_stream_ms(fused, sets, calls=len(sets) * max(1, 96 // len(sets)))
        del sets
        check(torch.equal(fused(state, p, t, w), want), f"multilabel update differs after the timed launches ({label})")
        row = {
            "case": label, "what": what, "n": n, "l": labels, "t": n_thr, "max_abs_err": err,
            "plan": geometry._asdict(), "device_ops": ops, "ms": kernel_ms, "stream_ms": stream_ms,
            "plain_ms": plain_ms, "bucketize_bincount_ms": bincount_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations", "bytes": nbytes, "ops": nops,
            "library_ms": None,
        }
        print(
            f"[kernel] binned_confmat_multilabel {label}: exact, {kernel_ms:.4f} ms after an L2 flush "
            f"({stream_ms:.4f} ms a call back to back; one device operation, {ops[0][0]} {ops[0][1]:.3f} us "
            f"in the profile; {geometry.labels} labels a block, grid ({geometry.groups}, {geometry.chunks})), "
            f"plain {plain_ms:.4f} ms, bucketize + 2 bincount + flip/cumsum (several calls, a yardstick) "
            f"{bincount_ms:.4f} ms, bound {row['bound_ms'] * 1e3:.2f} us ({row['bound_by']}: {nbytes} bytes, "
            f"{nops} ops), library_ms: none"
        )
        rows.append(row)
    print(f"[kernel] binned_confmat_multilabel: exact on all {len(cases)} cases, the two above and "
          + "; ".join(r["what"] for r in rows if "ms" not in r))
    return rows


# ------------------------------------------------ calibration_bins and ranking_pairs
CE_BINS = 15  # phase 9: MulticlassCalibrationError(n_bins=15), BinaryCalibrationError(n_bins=15)
EDGE_TOL = 1e-5  # a confidence this close to a bin edge may land on either side (expf and sum order)


def _ce_case(n, c, gen, logits=False, dtype=torch.float32, edits=()):
    """Scores (N, C) (C None: binary (N,)) of ``dtype`` and int64 targets on the card."""
    dev = torch.device("cuda")
    if c is None:
        scores = torch.sigmoid(2.0 * torch.randn((n,), generator=gen, device=dev))
        target = (torch.rand((n,), generator=gen, device=dev) < scores).to(torch.int64)
    else:
        target = torch.randint(0, c, (n,), generator=gen, device=dev)
        raw = 2.0 * torch.randn((n, c), generator=gen, device=dev)
        raw[torch.arange(n, device=dev), target] += 4.0 * (torch.rand((n,), generator=gen, device=dev) < 0.7)
        scores = raw if logits else torch.softmax(raw, 1)
    if n and c is not None and "edge_rows" in edits:  # NaN, ties, +-inf, one-hot (confidence exactly 1.0)
        nan, inf = float("nan"), float("inf")
        scores[0::11] = nan
        scores[1::11, c // 2] = nan
        scores[2::11] = 0.25 if not logits else 3.0  # all tied: the first index wins
        scores[3::11, 0], scores[3::11, c - 1] = scores[3::11].amax(1), scores[3::11].amax(1)
        scores[4::11] = 0.0
        scores[4::11, c - 1] = 1.0  # confidence exactly 1.0: the last bin
        if logits:
            scores[5::11, 1] = inf
            scores[6::11] = -inf
        scores[7::11, 0] = 1.0 / 3.0  # on k / n_bins edges when the row stays raw
        scores[8::11, 0] = 0.5
    if n and c is not None and "near_tie" in edits:
        # logit rows (max 0) with an e = expf(x - max) at or just below 1 at index 0 below the raw
        # argmax, the other scores -100 (e ~ 0, absorbed in any order), so every order of the sum
        # gives the same float32 sum; the target is 0. Kind 0: x = -1e-8 (e = 1) beside the max at 3.
        # Kinds 1 and 2 take x0 from the sweep in turn, beside the maxima at 1..3 (sum 4: an e of
        # 1 - 2^-24 gives (1 - 2^-24) / 4 < 1 / 4) or at 1..5 and an e of 0.25 at 6 (sum 6.25:
        # (1 - 2^-24) / 6.25 rounds to 1 / 6.25, a tie). No confidence lies on a bin edge.
        sweep = _near_tie_sweep()
        for rows in (slice(0, None, 4), slice(1, None, 4), slice(2, None, 4)):
            scores[rows] = -100.0
            target[rows] = 0
        scores[0::4, 0], scores[0::4, 3] = -1e-8, 0.0
        for kind, maxima in ((1, slice(1, 4)), (2, slice(1, 6))):
            picks = torch.arange(kind, n, 4, device=dev) // 4 % sweep.numel()
            scores[kind::4, 0], scores[kind::4, maxima] = sweep[picks], 0.0
        scores[2::4, 6] = math.log(0.25)
    if n and c is None and "edge_rows" in edits:
        scores[0::13] = float("nan")
        scores[1::13] = 1.0
        scores[2::13] = 0.0
        scores[3::13] = 0.2  # k / 15 for k = 3 once scaled
        scores[4::13] = 2.0 / 3.0
    if "ignored" in edits:
        target[torch.rand(target.shape, generator=gen, device=dev) < 0.1] = -1
    return scores.to(dtype).contiguous(), target


NEAR_ONE = 1.0 - 2.0**-24  # the one exponential below 1 that can tie 1 / sum (a sum of 6.25, say)
TIE_FLOOR = 1.0 - 2.0**-22  # the kernel divides only the exponentials at or above it


def _bits(x: float) -> int:
    return int(np.array(x, dtype=np.float32).view(np.int32))


@functools.lru_cache(maxsize=1)
def _exp_near_one() -> dict:
    """``torch.exp`` (CUDA's ``expf``, as the kernel's) of every float32 x in [-2^-21, 0], which
    holds every x whose exponential reaches the kernel's divide filter: for each value 1 - k 2^-24
    at or above the filter, how many x give it and the range of their bit patterns, and the first
    x that give 1 - 2^-24, if any do."""
    top = _bits(2.0**-21)
    found = {k: [0, None, None] for k in range(5)}
    near_one = []
    step = 2**26
    for lo in range(0, top + 1, step):
        bits = torch.arange(lo, min(lo + step, top + 1), dtype=torch.int32, device="cuda")
        e = torch.exp(-bits.view(torch.float32))
        check(not bool((e > 1).any()), "expf of a negative x exceeds 1")
        for k, entry in found.items():
            hit = e == 1.0 - k * 2.0**-24
            n = int(hit.sum())
            if n:
                entry[0] += n
                low, high = int(torch.where(hit, bits, top + 1).min()), int(torch.where(hit, bits, -1).max())
                entry[1] = low if entry[1] is None else min(entry[1], low)
                entry[2] = high if entry[2] is None else max(entry[2], high)
        if len(near_one) < 64:
            near_one += (-bits[e == NEAR_ONE][:64].view(torch.float32)).tolist()
    return {"values": {f"1 - {k} * 2^-24": tuple(v) for k, v in found.items()}, "x_at_1_minus_2^-24": near_one[:64]}


@functools.lru_cache(maxsize=1)
def _near_tie_sweep() -> torch.Tensor:
    """The x0 of the near-tie rows: -k 2^-28 for k < 64 (from 0 past the filter), the 8 float32 x
    on each side of every step between the values of ``expf`` near 1 (``_exp_near_one``), and
    every x found to give 1 - 2^-24."""
    scan = _exp_near_one()
    steps = [high for count, _, high in scan["values"].values() if count]
    edges = [b for high in steps for b in range(high - 7, high + 9)]
    x = [-k * 2.0**-28 for k in range(64)]
    x += (-np.array(edges, dtype=np.int32).view(np.float32)).tolist()
    x += scan["x_at_1_minus_2^-24"]
    return torch.tensor(x, dtype=torch.float32, device="cuda")


def _ce_divided(state, preds: torch.Tensor, target: torch.Tensor, num_classes: int, n_bins: int):
    """The update as JAX writes the softmax, ``exp(x - max) / sum`` divided, with the first index of
    the largest probability: the reference of the near-tie rows (no NaN, no ignored row)."""
    x = preds.float().reshape(-1, num_classes)
    if bool(((x < 0) | (x > 1)).any()):
        e = torch.exp(x - x.amax(1, keepdim=True))
        x = e / e.sum(1, keepdim=True)
    conf = x.amax(1)
    pred = torch.where(x == conf[:, None], torch.arange(num_classes, device=x.device), num_classes).amin(1)
    bins = torch.clamp(torch.floor(conf * n_bins), 0, n_bins).long()
    nb = n_bins + 1
    batch_conf = torch.zeros((nb,), dtype=torch.float64, device=x.device).index_add_(0, bins, conf.double())
    acc = torch.bincount(bins, weights=(pred == target.reshape(-1)).double(), minlength=nb)
    return (state[0] + batch_conf.float(), state[1] + acc.round().int(),
            state[2] + torch.bincount(bins, minlength=nb).int())


def _ce_edge_slack(preds: torch.Tensor, target: torch.Tensor, num_classes, n_bins: int, ignore_index=None):
    """What the rows on a bin edge may move, a bin: ``(edge rows, rows a bin, confidence a bin)``.

    A counted row whose plain confidence lies within EDGE_TOL of an edge k / n_bins may land in
    bin k - 1 or k (the kernel's ``expf`` and sum order against PyTorch's), so it adds one row
    and its confidence to the slack of both bins. Where the batch is not normalized both bin the
    same float32 confidence: no slack."""
    ce = importlib.import_module("torchmetrics_tpu_torch.functional.classification.calibration_error")
    if num_classes is None:
        conf, _, weights = ce._binary_ce_confidences(preds, target, ignore_index)
    else:
        conf, _, weights = ce._multiclass_ce_confidences(preds, target, num_classes, ignore_index)
    rows = torch.zeros((n_bins + 1,), dtype=torch.float64)
    confs = torch.zeros_like(rows)
    if not bool(((preds < 0) | (preds > 1)).any()):
        return 0, rows, confs
    scaled = conf.double().cpu() * n_bins
    edge = scaled.round()
    near = ((scaled - edge).abs() < EDGE_TOL * n_bins) & (weights.cpu() > 0)
    edge, near_conf = edge[near].long(), conf.double().cpu()[near]
    for b in (edge - 1, edge):
        inside = (b >= 0) & (b <= n_bins)
        rows.index_add_(0, b[inside], torch.ones_like(near_conf[inside]))
        confs.index_add_(0, b[inside], near_conf[inside])
    return int(near.sum()), rows, confs


def _ce_state_check(label, got, want, slack) -> float:
    """The kernel's ``(conf_sum, acc_sum, count)`` against the plain version's: each integer bin
    equal but for its slack rows (``_ce_edge_slack``), with equal totals; each ``conf_sum`` bin
    within 1e-5 relative plus its slack confidence, NaN where the plain version has NaN.
    Returns the max abs error of ``conf_sum``."""
    (gc, ga, gn), (wc, wa, wn) = [[x.cpu() for x in t] for t in (got, want)]
    _, rows, confs = slack
    for name, g, w in (("acc_sum", ga, wa), ("count", gn, wn)):
        off = (g.long() - w.long()).abs()
        check(bool((off <= rows).all()) and int(g.long().sum()) == int(w.long().sum()),
              f"calibration_bins {name} differs from plain by {off.tolist()} where the edge rows allow "
              f"{rows.long().tolist()} ({label})")
    check(torch.equal(gc.isnan(), wc.isnan()), f"calibration_bins conf_sum NaN placement differs ({label})")
    finite = ~wc.isnan()
    err = (gc[finite].double() - wc[finite].double()).abs()
    allowed = 1e-5 * wc[finite].double().abs() + confs[finite] + 1e-6
    check(bool((err <= allowed).all()), f"calibration_bins conf_sum differs ({label}): max abs err {float(err.max())}")
    return float(err.max()) if err.numel() else 0.0


def _softmax_bucketize_bincount(preds, target, n_bins, edges):
    """The update by PyTorch calls, a yardstick: softmax, max over the classes, bucketize
    into the bin edges, and three bincounts."""
    probs = torch.softmax(preds, 1)
    conf, pred = probs.max(1)
    bins = torch.bucketize(conf, edges, right=True) - 1
    acc = (pred == target).to(torch.float32)
    return (torch.bincount(bins, weights=conf, minlength=n_bins + 1), torch.bincount(bins, weights=acc, minlength=n_bins + 1),
            torch.bincount(bins, minlength=n_bins + 1))


def phase_calibration_kernel(flush: torch.Tensor) -> list:
    """``calibration_bins`` against its plain version on the card, and its times at the main
    path's shapes: ImageNet-1k's batch as probabilities (the first row) and as logits, and
    the binary batch."""
    from torchmetrics_tpu_torch.kernels import calibration as kce

    ce = importlib.import_module("torchmetrics_tpu_torch.functional.classification.calibration_error")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    limit = kce.MAX_BINS
    cases = [  # (what, rows, classes (None: binary), n_bins, kwargs, ignore_index); the first three are timed
        ("ImageNet-1k batch, probabilities (a)", BATCH, N_CLASSES, CE_BINS, {}, None),
        ("ImageNet-1k batch, logits (b)", BATCH, N_CLASSES, CE_BINS, {"logits": True}, None),
        ("binary batch (c)", BATCH, None, CE_BINS, {}, None),
        ("last ImageNet batch, logits", N_SAMPLES % BATCH, N_CLASSES, CE_BINS, {"logits": True}, None),
        ("C=2", BATCH, 2, CE_BINS, {}, None),
        ("C=3, logits", BATCH, 3, CE_BINS, {"logits": True}, None),
        ("C=31: a thread a row", BATCH, 31, CE_BINS, {"logits": True}, None),
        ("C=33: a warp a row, scalar loads", BATCH, 33, CE_BINS, {"logits": True}, None),
        ("C=1001, scalar loads", BATCH, 1001, CE_BINS, {"logits": True}, None),
        ("C=2000: rows re-read from L2", 256, 2000, CE_BINS, {"logits": True}, None),
        ("n_bins=1", BATCH, N_CLASSES, 1, {}, None),
        ("n_bins=100, logits", BATCH, N_CLASSES, 100, {"logits": True}, None),
        (f"n_bins={limit} (the limit)", BATCH, N_CLASSES, limit, {"logits": True}, None),
        ("binary, n_bins=100", BATCH, None, 100, {}, None),
        ("binary logits", BATCH, None, CE_BINS, {"logits": True}, None),
        ("NaN, tie, +-inf, one-hot and edge rows, probabilities", BATCH, N_CLASSES, CE_BINS, {"edits": ("edge_rows",)}, None),
        ("NaN, tie, +-inf rows, logits", BATCH, N_CLASSES, CE_BINS, {"logits": True, "edits": ("edge_rows",)}, None),
        ("NaN, tie and edge rows, C=3", BATCH, 3, CE_BINS, {"edits": ("edge_rows",)}, None),
        ("binary NaN, 0, 1 and edge scores", BATCH, None, CE_BINS, {"edits": ("edge_rows",)}, None),
        ("~10% ignored rows (ignore_index=-1)", BATCH, N_CLASSES, CE_BINS, {"logits": True, "edits": ("ignored",)}, -1),
        ("ignored NaN rows", BATCH, N_CLASSES, CE_BINS, {"logits": True, "edits": ("edge_rows", "ignored")}, -1),
        ("binary, ~10% ignored", BATCH, None, CE_BINS, {"edits": ("ignored",)}, -1),
        ("ignore_index=255, none present", BATCH, N_CLASSES, CE_BINS, {}, 255),
        ("float16 logits", BATCH, N_CLASSES, CE_BINS, {"logits": True, "dtype": torch.float16}, None),
        ("bfloat16 probabilities", BATCH, N_CLASSES, CE_BINS, {"dtype": torch.bfloat16}, None),
        ("bfloat16 logits, C=33", BATCH, 33, CE_BINS, {"logits": True, "dtype": torch.bfloat16}, None),
        ("empty batch", 0, N_CLASSES, CE_BINS, {}, None),
        ("near-tie logit rows, four warps a row", BATCH, N_CLASSES, CE_BINS, {"logits": True, "edits": ("near_tie",)}, None),
        ("near-tie logit rows, C=33, scalar loads", BATCH, 33, CE_BINS, {"logits": True, "edits": ("near_tie",)}, None),
        ("near-tie logit rows, a thread a row", BATCH, 7, CE_BINS, {"logits": True, "edits": ("near_tie",)}, None),
        ("near-tie logit rows, C=2000", 256, 2000, CE_BINS, {"logits": True, "edits": ("near_tie",)}, None),
        ("near-tie logit rows, two warps a row", 2 * BATCH, N_CLASSES, CE_BINS, {"logits": True, "edits": ("near_tie",)}, None),
        ("near-tie logit rows, a warp a row", 16 * BATCH, N_CLASSES, CE_BINS, {"logits": True, "edits": ("near_tie",)}, None),
        ("2,048 x 1,000 logits: two warps a row", 2 * BATCH, N_CLASSES, CE_BINS, {"logits": True}, None),
        ("2,048 x 1,000 float16 logits: two warps a row", 2 * BATCH, N_CLASSES, CE_BINS,
         {"logits": True, "dtype": torch.float16}, None),
        ("16,384 x 1,000 logits: a warp a row", 16 * BATCH, N_CLASSES, CE_BINS, {"logits": True}, None),
        ("two rows: one block", 2, N_CLASSES, CE_BINS, {"logits": True}, None),
        ("three rows: two blocks", 3, N_CLASSES, CE_BINS, {"logits": True}, None),
        ("binary, 1,025 scores: two blocks", BATCH + 1, None, CE_BINS, {"logits": True}, None),
        ("256 short rows: one block", 256, 3, CE_BINS, {"logits": True}, None),
        ("257 short rows: two blocks", 257, 3, CE_BINS, {"logits": True}, None),
        ("65,536 x 1,000 logits: the largest merge", 65_536, N_CLASSES, CE_BINS, {"logits": True}, None),
        (f"65,536 x 1,000 logits, n_bins={limit}", 65_536, N_CLASSES, limit, {"logits": True}, None),
    ]
    blocks_wanted = {"binary batch (c)": 1, "two rows: one block": 1, "three rows: two blocks": 2,
                     "binary, 1,025 scores: two blocks": 2, "256 short rows: one block": 1,
                     "257 short rows: two blocks": 2}
    warps_wanted = {"ImageNet-1k batch, probabilities (a)": 4, "ImageNet-1k batch, logits (b)": 4,
                    "last ImageNet batch, logits": 4, "near-tie logit rows, four warps a row": 4,
                    "near-tie logit rows, two warps a row": 2, "2,048 x 1,000 logits: two warps a row": 2,
                    "2,048 x 1,000 float16 logits: two warps a row": 2, "near-tie logit rows, a warp a row": 1,
                    "16,384 x 1,000 logits: a warp a row": 1, "65,536 x 1,000 logits: the largest merge": 1}
    scan = _exp_near_one()
    print(f"[kernel] calibration_bins near-tie rows: expf of every float32 x in [-2^-21, 0] on the card, the "
          f"values at or above the divide filter (x count, bit range): {scan['values']}; x giving 1 - 2^-24: "
          f"{len(scan['x_at_1_minus_2^-24'])}; sweep of {_near_tie_sweep().numel()} x0")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for what, n, c, n_bins, kwargs, ignore_index in cases:
        preds, target = _ce_case(n, c, gen, **kwargs)
        nb = n_bins + 1
        state = (100.0 * torch.rand((nb,), generator=gen, device="cuda"),
                 torch.randint(0, 2**20, (nb,), generator=gen, device="cuda", dtype=torch.int32),
                 torch.randint(0, 2**20, (nb,), generator=gen, device="cuda", dtype=torch.int32))
        got = kce.calibration_bins(*state, preds, target, c, ignore_index)
        again = kce.calibration_bins(*state, preds, target, c, ignore_index)
        want = ce._calibration_accumulate_plain(state, preds, target, c, ignore_index)
        near_tie = "near_tie" in kwargs.get("edits", ())
        extra = {}
        if near_tie:  # held against a divide; whether the plain version agrees is recorded
            plain, want = want, _ce_divided(state, preds, target, c, n_bins)
            e0 = torch.exp(preds[1::4, 0].float())
            extra = {"plain_equal": all(torch.equal(a, b) for a, b in zip(plain[1:], want[1:])),  # the counts
                     "x0_at_1": int((e0 == 1).sum()), "x0_at_1_minus_2^-24": int((e0 == NEAR_ONE).sum()),
                     "x0_below_1_at_or_above_filter": int(((e0 < 1) & (e0 >= TIE_FLOOR)).sum())}
            e = preds[2::4].float().exp()
            check(bool((e.sum(1) == 6.25)[e[:, 0] >= TIE_FLOOR].all()), f"near-tie rows of sum 6.25 ({what})")
        torch.cuda.synchronize()
        slack = _ce_edge_slack(preds, target, c, n_bins, ignore_index)
        edge_rows = slack[0]
        label = f"{what}: preds {tuple(preds.shape)} {str(preds.dtype)[6:]}, n_bins {n_bins}, ignore_index {ignore_index}"
        err = _ce_state_check(label, got, want, slack)
        check(all(torch.equal(g.view(torch.int32), a.view(torch.int32)) for g, a in zip(got, again)),
              f"calibration_bins is not deterministic bit for bit ({label})")
        added = int((want[2] - state[2]).sum())
        check(added > 0 or n == 0, f"no row counted ({label})")
        geometry = kce.plan(n, c, n_bins, sms) if n else None
        check(geometry is None or blocks_wanted.get(what, geometry.blocks) == geometry.blocks,
              f"calibration_bins plan {geometry} ({label})")
        check(geometry is None or warps_wanted.get(what, geometry.warps_per_row) == geometry.warps_per_row,
              f"calibration_bins plan {geometry}: not the warps a row wanted ({label})")
        if not what.endswith(("(a)", "(b)", "(c)")):
            rows.append({"case": label, "what": what, "max_abs_err": err, "edge_rows": edge_rows,
                         "plan": geometry._asdict() if geometry else None, **extra})
            continue
        # least work: read the scores and the targets once, read and write the 3 (n_bins + 1) state
        # values; for the softmax a compare, a subtract, an exp and an add a score, and a compare for
        # the argmax of the probabilities (their maximum is 1 / sum; the sigmoid's four a binary score)
        nbytes = preds.numel() * preds.element_size() + n * target.element_size() + 2 * 12 * nb
        nops = preds.numel() * (5 if c else 4)
        bytes_ms, ops_ms = nbytes / PEAK_BYTES_PER_S * 1e3, nops / PEAK_FP32_OPS_PER_S * 1e3
        kernel = lambda p_, t_: kce.calibration_bins(*state, p_, t_, c, ignore_index)  # noqa: E731
        ops = _device_ops(lambda: kernel(preds, target))
        check(len(ops) == 1 and "calib_" in ops[0][0], f"a calibration_bins call is not exactly one kernel ({label}): {ops}")
        kernel_ms = time_ms(lambda: kernel(preds, target), flush)
        plain_ms = time_ms(lambda: ce._calibration_accumulate_plain(state, preds, target, c, ignore_index), flush)
        edges = torch.linspace(0, 1, n_bins + 1, device="cuda")
        if c is None:
            yard = lambda: _softmax_bucketize_bincount(torch.stack([1 - preds, preds], 1), target, n_bins, edges)  # noqa: E731
        else:
            yard = lambda: _softmax_bucketize_bincount(preds, target, n_bins, edges)  # noqa: E731
        yard_ms = time_ms(yard, flush)
        copies = min(copies_for(nbytes), MAX_STREAM_COPIES)
        sets = [(preds, target)] + [(preds.clone(), target.clone()) for _ in range(copies - 1)]
        stream_ms = time_stream_ms(kernel, sets, calls=len(sets) * max(1, 96 // len(sets)))
        del sets
        after = kernel(preds, target)
        check(all(torch.equal(g.view(torch.int32), a.view(torch.int32)) for g, a in zip(got, after)),
              f"calibration_bins differs after the timed launches ({label})")
        row = {
            "case": label, "what": what, "max_abs_err": err, "edge_rows": edge_rows, "plan": geometry._asdict(),
            "device_ops": ops, "ms": kernel_ms, "stream_ms": stream_ms, "plain_ms": plain_ms, "softmax_bucketize_bincount_ms": yard_ms,
            "bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "ops": nops, "library_ms": None,
        }
        print(f"[kernel] calibration_bins {label}: {kernel_ms:.4f} ms after an L2 flush ({stream_ms:.4f} ms a call "
              f"back to back; one device operation, {ops[0][0]} {ops[0][1]:.3f} us in the profile; plan "
              f"{tuple(geometry)}), plain {plain_ms:.4f} ms, softmax + max + bucketize + 3 bincount "
              f"(several calls, a yardstick) {yard_ms:.4f} ms, bound {row['bound_ms'] * 1e3:.2f} us ({row['bound_by']}: "
              f"{nbytes} bytes, {nops} ops), {edge_rows} rows within {EDGE_TOL} of a bin edge, conf_sum max abs err "
              f"{err:.3g}, bit-identical over repeated launches, library_ms: none")
        rows.append(row)
    print(f"[kernel] calibration_bins: integer states equal to the plain version (but for the rows counted within "
          f"{EDGE_TOL} of a bin edge, each only in its two bins), conf_sum within 1e-5 relative (plus those rows' "
          f"confidences in their bins) and bit-identical over repeated launches on all {len(cases)} cases: "
          + "; ".join(f"{r['what']} ({r['edge_rows']} edge rows"
                      + (f"; x0 of rows of kind 1: {r['x0_at_1']} at 1, {r['x0_at_1_minus_2^-24']} at 1 - 2^-24, "
                         f"{r['x0_below_1_at_or_above_filter']} below 1 at or above the filter; the plain version's "
                         f"counts {'agree' if r['plain_equal'] else 'differ'}" if "plain_equal" in r else "") + ")"
                      for r in rows if "ms" not in r))
    return rows


COCO_RANK_LABELS = 80  # phase 9 (ii): the MS-COCO-shaped batch (256, 80)


def _ranking_case(n, labels, gen, edits=(), target_dtype=torch.int32):
    """Scores (N, L) float32 (sigmoid, on a 0.01 grid for ties) and 0/1 targets (~3.6 % positive,
    at least one a row unless an edit says otherwise) on the card."""
    dev = torch.device("cuda")
    target = (torch.rand((n, labels), generator=gen, device=dev) < max(2.9 / labels, 0.05)).to(target_dtype)
    logits = 1.5 * torch.randn((n, labels), generator=gen, device=dev) + 3.0 * target
    scores = torch.round(torch.sigmoid(logits) * 100) / 100
    if n and "edge_rows" in edits:
        nan = float("nan")
        target[0::9] = 0  # no relevant label
        target[1::9] = 1  # every label relevant
        scores[2::9] = 0.5  # all tied
        scores[3::9, 0] = nan
        scores[4::9, labels - 1] = nan
        target[4::9, labels - 1] = 1  # a relevant NaN
        scores[5::9, 0] = float("inf")
        scores[6::9, 0] = float("-inf")
        target[6::9, 0] = 1
    if "tie900" in edits:  # 900 of the row's labels tie, relevant ones among them
        scores[:, :900] = 0.42
    if "ignored" in edits:
        target[torch.rand((n, labels), generator=gen, device=dev) < 0.1] = -1
    return scores.contiguous(), target.contiguous()


def _sort_gather_cumsum(preds, target):
    """Each row's targets in descending score order, scanned: ``torch.sort`` + ``gather`` +
    ``cumsum``, several PyTorch calls. A yardstick for the sort-and-scan kernel, not the
    port's: the ranks still need the ends of the runs of equal scores."""
    order = torch.sort(preds, dim=1, descending=True).indices
    return torch.gather(target, 1, order).cumsum(1)


def phase_ranking_kernel(flush: torch.Tensor) -> list:
    """``ranking_pairs`` against its plain version on the card for each measure, and its times
    at MS-COCO's batch (the first three rows) and at (32, 1000) and (64, 4096), LRAP and the
    loss beside the ``_sort_gather_cumsum`` yardstick."""
    from torchmetrics_tpu_torch.kernels import ranking as krk

    rk = importlib.import_module("torchmetrics_tpu_torch.functional.classification.ranking")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    limit = krk.MAX_LABELS
    shapes = [  # (what, rows, labels, edits, ignore_index, timed)
        ("COCO batch", COCO_ML_BATCH, COCO_RANK_LABELS, (), None, True),
        ("(32, 1000)", 32, 1000, (), None, True),
        ("(64, 4096)", 64, 4096, (), None, True),
        ("L=1", 256, 1, (), None, False),
        ("L=31", 256, 31, ("edge_rows",), None, False),
        ("L=33", 256, 33, ("edge_rows",), None, False),
        ("L=4097, one past a power of two", 16, 4097, ("edge_rows",), None, False),
        ("(32, 1000), a 900-way tie in each row", 32, 1000, ("tie900",), None, False),
        (f"L={limit} (the limit)", 4, limit, (), None, False),
        ("COCO batch, NaN, +-inf, tie, none and all relevant rows", COCO_ML_BATCH, COCO_RANK_LABELS, ("edge_rows",),
         None, False),
        ("COCO batch, ~10% ignore_index=-1", COCO_ML_BATCH, COCO_RANK_LABELS, ("ignored",), -1, False),
        ("(32, 1000), edge rows and ignore_index=-1", 32, 1000, ("edge_rows", "ignored"), -1, False),
        ("COCO batch, ignore_index=255, none present", COCO_ML_BATCH, COCO_RANK_LABELS, (), 255, False),
        ("empty batch", 0, COCO_RANK_LABELS, (), None, False),
    ]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for what, n, labels, edits, ignore_index, timed in shapes:
        target_dtype = torch.int64 if "ignored" in edits else torch.int32
        preds, target = _ranking_case(n, labels, gen, edits, target_dtype)
        for measure in ("lrap", "loss", "coverage"):
            got = krk.ranking_pairs(preds, target, measure, ignore_index)
            want = rk._ranking_per_sample_plain(preds, target, measure, ignore_index)
            torch.cuda.synchronize()
            label = f"{measure}, {what}: ({n}, {labels}), target {str(target.dtype)[6:]}, ignore_index {ignore_index}"
            check(got.shape == want.shape == (n,), f"ranking_pairs shape {tuple(got.shape)} ({label})")
            check(torch.equal(got.isnan(), want.isnan()), f"ranking_pairs NaN placement differs ({label})")
            ok = ~want.isnan()
            err = float((got[ok] - want[ok]).abs().max()) if bool(ok.any()) else 0.0
            if measure == "lrap":  # the fractions are summed in another order
                check(bool(((got[ok] - want[ok]).abs() <= 1e-6 * want[ok].abs() + 1e-7).all()),
                      f"ranking_pairs differs from plain ({label}): max abs err {err}")
            else:
                check(torch.equal(got[ok], want[ok]), f"ranking_pairs differs from plain ({label}): max abs err {err}")
            check(torch.equal(krk.ranking_pairs(preds, target, measure, ignore_index).view(torch.int32),
                              got.view(torch.int32)), f"ranking_pairs is not deterministic ({label})")
            geometry = krk.plan(n, labels, measure, sms) if n else None
            if not timed:
                rows.append({"case": label, "what": f"{measure}, {what}", "max_abs_err": err,
                             "plan": geometry._asdict() if geometry else None})
                continue
            # least work: read the scores and targets once and write a value a row; LRAP and the loss
            # need each label's count of valid, relevant or irrelevant labels scored at or above it,
            # which a sort of the row (L ceil(log2 L) compares) and a scan give; coverage a min and a count
            sort_ops = n * labels * max(1, math.ceil(math.log2(labels)))
            nops = {"lrap": sort_ops, "loss": sort_ops, "coverage": 2 * n * labels}[measure]
            nbytes = n * labels * (4 + target.element_size()) + 4 * n
            bytes_ms, ops_ms = nbytes / PEAK_BYTES_PER_S * 1e3, nops / PEAK_FP32_OPS_PER_S * 1e3
            kernel = lambda p_, t_: krk.ranking_pairs(p_, t_, measure, ignore_index)  # noqa: E731
            kernel_ms = time_ms(lambda: kernel(preds, target), flush)
            plain = lambda: rk._ranking_per_sample_plain(preds, target, measure, ignore_index)  # noqa: E731
            plain_ms = time_ms(plain, flush, reps=5 if labels > 1000 else 30, warmup=1)
            yard_ms = None if measure == "coverage" else time_ms(lambda: _sort_gather_cumsum(preds, target), flush)
            copies = min(copies_for(nbytes), MAX_STREAM_COPIES)
            sets = [(preds, target)] + [(preds.clone(), target.clone()) for _ in range(copies - 1)]
            stream_ms = time_stream_ms(kernel, sets, calls=len(sets) * max(1, 96 // len(sets)))
            del sets
            row = {
                "case": label, "what": f"{measure}, {what}", "max_abs_err": err, "plan": geometry._asdict(),
                "ms": kernel_ms, "stream_ms": stream_ms, "plain_ms": plain_ms, "sort_gather_cumsum_ms": yard_ms,
                "bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "bytes": nbytes, "ops": nops, "library_ms": None,
            }
            yard = "" if yard_ms is None else (f", sort + gather + cumsum (several calls, a yardstick, not the port's) "
                                               f"{yard_ms:.4f} ms")
            print(f"[kernel] ranking_pairs {label}: {kernel_ms:.4f} ms after an L2 flush ({stream_ms:.4f} ms a call "
                  f"back to back; plan {tuple(geometry)}), plain (the JAX form, (N, L, L) temporaries) "
                  f"{plain_ms:.4f} ms{yard}, bound {row['bound_ms'] * 1e3:.3f} us ({row['bound_by']}: {nbytes} "
                  f"bytes, {nops} ops), max abs err {err:.3g}, library_ms: none")
            rows.append(row)
    print(f"[kernel] ranking_pairs: coverage and loss equal to the plain version, LRAP within 1e-6 relative, "
          f"deterministic, on all {len(shapes) * 3} cases: " + "; ".join(r["what"] for r in rows if "ms" not in r))
    return rows


MSMARCO_QUERIES, MSMARCO_CANDIDATES = 6_980, 1_000  # MS MARCO passage ranking, dev (small): 1,000 candidates a query
MSMARCO_RELEVANT = 1.07  # relevant passages a query in its qrels
RET_MEASURES = ("reciprocal_rank", "average_precision", "ndcg", "auroc", "precision", "recall", "hit_rate",
                "fall_out", "r_precision")
RET_COUNTED = {"precision", "recall", "hit_rate", "fall_out", "reciprocal_rank", "r_precision"}  # equal bit for bit


def _retrieval_case(sizes, gen, rel_share, edits=(), graded=False):
    """Rows of queries of ``sizes`` documents on the card: ids negative and not contiguous, rows shuffled,
    scores on a 0.05 grid (ties, +-0.0), ``rel_share`` of the targets relevant (graded 0-3 for NDCG)."""
    dev = torch.device("cuda")
    counts = torch.tensor(sizes, device=dev)
    ids = torch.repeat_interleave(-7 * torch.arange(len(sizes), device=dev) - 3, counts).to(torch.int32)
    n = ids.shape[0]
    within = torch.arange(n, device=dev) - torch.repeat_interleave(torch.cumsum(counts, 0) - counts, counts)
    scores = torch.round(torch.randn((n,), generator=gen, device=dev) * 20) / 20
    if graded:
        target = torch.randint(0, 4, (n,), generator=gen, device=dev).to(torch.float32)
    else:
        target = (torch.rand((n,), generator=gen, device=dev) < rel_share).to(torch.float32)
    if "nonfinite" in edits:
        u = torch.rand((n,), generator=gen, device=dev)
        scores[u < 0.02] = float("nan")
        scores[(u >= 0.02) & (u < 0.03)] = float("inf")
        scores[(u >= 0.03) & (u < 0.04)] = float("-inf")
        scores[(u >= 0.04) & (u < 0.06)] = -0.0
    if "none_all" in edits:  # a query with no relevant document and one with every document relevant
        q = torch.repeat_interleave(torch.arange(len(sizes), device=dev), counts)
        target[q == 0] = 0.0
        target[q == 1] = 1.0
    if "tie900" in edits:
        scores[within < 900] = 0.42
    perm = torch.randperm(n, generator=gen, device=dev)
    return scores[perm].contiguous(), target[perm].contiguous(), ids[perm].contiguous()


def _retrieval_terms(rg, top_k):
    """Each query's count of non-zero float32 terms in the plain version's sums (AP, NDCG, AUROC)."""
    from torchmetrics_tpu_torch.functional.retrieval import kernels as rk

    return rk._seg_sum((rg.target != 0) & rk._topk_mask(rg, top_k), rg)


def _sort_cumsum_segment(p, t, gid, n_groups):
    """A stable ``torch.sort`` of ``-score`` + ``gather`` + ``cumsum`` + ``index_add_``, several PyTorch
    calls over the whole batch: a yardstick for the kernel's per-query sort and scan, not the port's."""
    order = torch.sort(-p, stable=True).indices
    c = t[order].cumsum(0)
    return torch.zeros((n_groups,), dtype=torch.float32, device=p.device).index_add_(0, gid[order], c)


def phase_retrieval_kernel(flush: torch.Tensor) -> list:
    """``retrieval_groups`` against its plain version on the card, every measure, and its times at
    MS MARCO's shape (the first rows) and on one query of 100,000 documents (the long path)."""
    from torchmetrics_tpu_torch.functional.retrieval import kernels as rk
    from torchmetrics_tpu_torch.kernels import retrieval as krt

    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    msmarco = [MSMARCO_CANDIDATES] * MSMARCO_QUERIES
    cases = [  # (what, sizes, relevant share, edits, top_ks, timed measures)
        ("MS MARCO shape", msmarco, MSMARCO_RELEVANT / MSMARCO_CANDIDATES, (), (None, 10, 1000),
         ("reciprocal_rank", "average_precision", "ndcg", "auroc", "ranked")),
        # the sort path: 300 relevant documents a query, past the counting path's threshold
        ("MS MARCO shape at a 0.3 relevant share", msmarco, 0.3, (), (None, 10), ("average_precision",)),
        ("queries of 1, 31, 33, 256, 257 and 16,384 documents", [1, 31, 33, 256, 257, 16_384] * 2, 0.3,
         ("nonfinite", "none_all"), (None, 1, 10, 1000, 20_000), ()),
        ("one query of 100,000 documents (the long path)", [100_000], 0.3, ("nonfinite",), (None, 10, 1000),
         ("average_precision", "auroc")),
        # the counting path past 16,384 documents: about 107 relevant
        ("one sparse query of 100,000 documents", [100_000], MSMARCO_RELEVANT / MSMARCO_CANDIDATES,
         ("nonfinite",), (None, 10, 1000), ("average_precision", "auroc")),
        # both sides of the counting threshold in one launch, AUROC's top k below n on both
        ("queries of 1,000 around the counting threshold", [1_000] * 60, krt.COUNT_SHORT / 1_000,
         ("nonfinite", "none_all"), (None, 5, 10, 999), ()),
        ("long and short queries in one launch", [100_000, 3, 16_385, 700], 0.3, ("nonfinite", "none_all"),
         (None, 10), ()),
        ("a 900-way tie in queries of 1,000", [1_000] * 40, 0.3, ("tie900", "none_all"), (None, 10, 1000), ()),
        ("NaN, +-inf, +-0.0 scores, small queries", [5, 1, 40, 2, 64, 17] * 30, 0.4, ("nonfinite", "none_all"),
         (None, 1, 10, 70), ()),
    ]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows, checked = [], 0
    for what, sizes, share, edits, top_ks, timed in cases:
        for graded in (False, True):
            p, t, i = _retrieval_case(sizes, gen, share, edits, graded)
            ps, ts, offsets, longest = rk.query_layout(p, t, i)
            n_groups = offsets.shape[0] - 1
            geometry = krt.plan(longest)
            plain_rg = rk._rank_groups_plain(p, t, i)
            # the ranked layout against the plain two stable sorts
            rg = rk.rank_groups(p, t, i)
            for field in ("preds", "target", "gid", "rank", "wcum", "n_rel", "sizes"):
                g_, w_ = getattr(rg, field), getattr(plain_rg, field)
                check(g_.dtype == w_.dtype and torch.equal(g_.view(torch.int32), w_.view(torch.int32)),
                      f"retrieval_groups ranked layout differs from plain ({what}, {field})")
            measures = ("ndcg",) if graded else RET_MEASURES
            for measure in measures:
                for top_k in top_ks:
                    for adaptive in ((False, True) if measure == "precision" and top_k else (False,)):
                        label = (f"{measure}@{top_k}{' adaptive' if adaptive else ''}, {what}"
                                 f"{', graded' if graded else ''}: {n_groups} queries, {p.shape[0]} rows")
                        got, n_rel = krt.retrieval_groups(ps, ts, offsets, measure, top_k, adaptive, longest=longest)
                        want, want_rel, want_sizes = rk._retrieval_scores_plain(p, t, i, measure, top_k, adaptive)
                        again = krt.retrieval_groups(ps, ts, offsets, measure, top_k, adaptive, longest=longest)[0]
                        check(torch.equal(n_rel, want_rel), f"retrieval_groups n_rel differs ({label})")
                        check(torch.equal(torch.diff(offsets).float(), want_sizes), f"sizes differ ({label})")
                        check(torch.equal(again.view(torch.int32), got.view(torch.int32)),
                              f"retrieval_groups is not deterministic ({label})")
                        err = float((got - want).abs().max())
                        if measure in RET_COUNTED:
                            check(torch.equal(got, want), f"retrieval_groups differs from plain ({label}): {err}")
                        else:  # 1e-6 relative plus the float32 summation bound of the plain version's n terms
                            tol = 1e-6 * want.abs() + (_retrieval_terms(plain_rg, top_k) + 4) * 2.0**-24
                            check(bool(((got - want).abs() <= tol).all()),
                                  f"retrieval_groups differs from plain ({label}): max abs err {err}")
                        checked += 1
                        rows.append({"case": label, "what": f"{measure}@{top_k}, {what}", "max_abs_err": err,
                                     "plan": geometry._asdict()})
            for measure in (() if graded else timed):
                top_k = 10 if measure in ("reciprocal_rank", "ndcg") else None
                label = f"{measure}@{top_k}, {what}: {n_groups} queries, {p.shape[0]} rows"
                kernel = lambda a, b, c: krt.retrieval_groups(a, b, c, measure, top_k, False, longest=longest)  # noqa: E731
                kernel_ms = time_ms(lambda: kernel(ps, ts, offsets), flush)
                if measure == "ranked":
                    plain = lambda: rk._rank_groups_plain(p, t, i)  # noqa: E731
                else:
                    plain = lambda: rk._retrieval_scores_plain(p, t, i, measure, top_k, False)  # noqa: E731
                plain_ms = time_ms(plain, flush, reps=5, warmup=1)
                glue_ms = time_ms(lambda: rk.query_layout(p, t, i), flush, reps=5, warmup=1)
                # phase 10 (i)'s order: the rows of each query in one run, the queries in order of id
                in_runs = torch.repeat_interleave(torch.arange(n_groups, device=ps.device, dtype=torch.int32),
                                                  torch.diff(offsets))
                check(all(torch.equal(x_, y_) for x_, y_ in zip(rk.query_layout(ps, ts, in_runs)[:3], (ps, ts, offsets))),
                      f"query_layout of rows in order differs ({what})")
                glue_runs_ms = time_ms(lambda: rk.query_layout(ps, ts, in_runs), flush, reps=10, warmup=2)
                yard_ms = time_ms(lambda: _sort_cumsum_segment(ps, ts, plain_rg.gid.long(), n_groups), flush)
                nbytes = ps.shape[0] * 8 + offsets.numel() * 8 + (ps.shape[0] * 8 if measure == "ranked" else 8 * n_groups)
                counts = torch.diff(offsets).double()
                nops = int((counts * torch.ceil(torch.log2(torch.clamp(counts, min=2)))).sum()) * (2 if measure == "ndcg" else 1)
                bytes_ms, ops_ms = nbytes / PEAK_BYTES_PER_S * 1e3, nops / PEAK_FP32_OPS_PER_S * 1e3
                copies = min(copies_for(nbytes), MAX_STREAM_COPIES)
                sets = [(ps, ts, offsets)] + [(ps.clone(), ts.clone(), offsets.clone()) for _ in range(copies - 1)]
                stream_ms = time_stream_ms(kernel, sets, calls=len(sets) * max(1, 24 // len(sets)))
                del sets
                row = {
                    "case": label, "what": f"{measure}@{top_k}, {what}", "max_abs_err": 0.0, "plan": geometry._asdict(),
                    "ms": kernel_ms, "stream_ms": stream_ms, "plain_ms": plain_ms, "query_layout_ms": glue_ms,
                    "query_layout_in_runs_ms": glue_runs_ms,
                    "sort_cumsum_segment_ms": yard_ms, "bound_ms": max(bytes_ms, ops_ms),
                    "bound_by": "bytes" if bytes_ms >= ops_ms else "operations", "bytes": nbytes, "ops": nops,
                    "library_ms": None,
                }
                errs = [r["max_abs_err"] for r in rows if r["what"].startswith(f"{measure}@{top_k}, {what}")]
                row["max_abs_err"] = max(errs) if errs else 0.0
                print(f"[kernel] retrieval_groups {label}: {kernel_ms:.4f} ms after an L2 flush ({stream_ms:.4f} ms a "
                      f"call back to back; plan {tuple(geometry)}), the query-id layout (torch glue) "
                      f"{glue_ms:.4f} ms shuffled, {glue_runs_ms:.4f} ms in runs, plain {plain_ms:.4f} ms, sort + cumsum + index_add_ (several calls, a "
                      f"yardstick) {yard_ms:.4f} ms, bound {row['bound_ms'] * 1e3:.3f} us ({row['bound_by']}: "
                      f"{nbytes} bytes, {nops} ops), library_ms: none")
                rows.insert(sum(1 for r in rows if "ms" in r), row)
            del p, t, i, ps, ts, offsets, plain_rg, rg
    print(f"[kernel] retrieval_groups: counts and the ranked layout equal to the plain version, AP, NDCG and AUROC "
          f"within 1e-6 relative plus (terms + 4) 2^-24, deterministic, on {checked} cases over {len(cases)} "
          f"batches ({sms} SMs)")
    return rows


DIV2K_SHAPE = (4, 3, 1356, 2040)  # DIV2K validation's 2K images (one size for all, cut from 1356-2040 x 2040), batch of 4
SSIM_RTOL, SSIM_MAP_ATOL = 1e-5, 1e-5  # per-image SSIM and CS relative, the full map absolute


def _image_pair(shape, gen, noise=0.05, low=0.0, high=1.0):
    """A seeded smooth image (a 4x-upsampled random field) and a noisy copy as ``preds``, on the card."""
    b, c, h, w = shape
    coarse = torch.rand((b, c, -(-h // 4), -(-w // 4)), generator=gen, device="cuda")
    target = torch.nn.functional.interpolate(coarse, size=(h, w), mode="bilinear", align_corners=False)
    target = low + (high - low) * target
    preds = target + noise * (high - low) * torch.randn(shape, generator=gen, device="cuda")
    return preds.contiguous(), target.contiguous()


def _adversarial_pair(kind, shape, gen):
    """Images where float32 window sums lose digits, on the card: values in [100, 101] with light noise,
    [0, 255] with faint noise, a steep ramp across a tile, a step edge next to a flat region."""
    if kind == "offset":
        return _image_pair(shape, gen, noise=0.02, low=100.0, high=101.0)
    if kind == "0-255":
        return _image_pair(shape, gen, noise=0.002, low=0.0, high=255.0)
    h, w = shape[-2:]
    yy, xx = torch.meshgrid(torch.arange(h, device="cuda"), torch.arange(w, device="cuda"), indexing="ij")
    if kind == "ramp":
        target = (((7.3 * xx + 2.1 * yy) % 200) / 200 * 255).expand(shape)
    else:  # "step"
        target = torch.where(xx >= w // 2, 200.0, 0.0)
        target = torch.where(yy < h // 3, 37.0, target).expand(shape)
    noise = 0.3 if kind == "ramp" else 0.05
    preds = target + noise * torch.randn(shape, generator=gen, device="cuda")
    return preds.float().contiguous(), target.float().contiguous()


def _conv_ssim_yardstick(preds, target, kernel, c1, c2):
    """cuDNN's depthwise ``F.conv2d(groups=5 C)`` of the five stacked maps, then the elementwise SSIM and the
    per-image mean: several PyTorch calls, a yardstick for the kernel, not the port's."""
    b, c = preds.shape[:2]
    stacked = torch.cat((preds, target, preds * preds, target * target, preds * target), dim=1)
    out = torch.nn.functional.conv2d(stacked, kernel.repeat(5, 1, 1, 1), groups=5 * c)
    mu_p, mu_t, e_pp, e_tt, e_pt = out.chunk(5, dim=1)
    upper = 2 * (e_pt - mu_p * mu_t) + c2
    lower = (e_pp - mu_p**2).clamp(min=0) + (e_tt - mu_t**2).clamp(min=0) + c2
    return (((2 * mu_p * mu_t + c1) * upper) / ((mu_p**2 + mu_t**2 + c1) * lower)).reshape(b, -1).mean(-1)


def phase_ssim_kernel(flush: torch.Tensor) -> list:
    """``ssim_window`` against its plain version on the card, and its time at DIV2K's batch (the first row)
    beside cuDNN's depthwise convolution of the stacked maps plus the elementwise SSIM."""
    from torchmetrics_tpu_torch.functional.image import helper as ih
    from torchmetrics_tpu_torch.functional.image import ssim as fs
    from torchmetrics_tpu_torch.kernels import ssim as kss

    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    cases = [  # (what, shape, kwargs of _ssim_update, noise, timed)
        ("DIV2K batch", DIV2K_SHAPE, {"data_range": 1.0}, 0.05, True),
        ("DIV2K batch, contrast sensitivity (an MS-SSIM scale)", DIV2K_SHAPE,
         {"data_range": 1.0, "return_contrast_sensitivity": True}, 0.05, False),
        ("the smallest input", (1, 1, 11, 11), {}, 0.1, False),
        ("odd sizes", (2, 3, 67, 45), {}, 0.1, False),
        ("sizes off the tile", (3, 2, 33, 97), {"data_range": 1.0}, 0.1, False),
        ("uniform window of 7", (2, 3, 100, 70), {"gaussian_kernel": False, "kernel_size": 7}, 0.1, False),
        ("uniform 3 x 9", (2, 1, 50, 61), {"gaussian_kernel": False, "kernel_size": (3, 9)}, 0.1, False),
        ("sigma 0.5", (2, 3, 64, 64), {"sigma": 0.5}, 0.1, False),
        ("sigma 4.3 (31 taps)", (2, 3, 96, 131), {"sigma": 4.3}, 0.1, False),
        ("data range None", (2, 3, 128, 96), {"data_range": None}, 0.1, False),
        ("data range (0.1, 0.9), clamped in the kernel", (2, 3, 128, 96), {"data_range": (0.1, 0.9)}, 0.3, False),
        ("full image", (2, 3, 75, 83), {"return_full_image": True}, 0.1, False),
        ("full image, sigma 4.3", (1, 2, 40, 64), {"return_full_image": True, "sigma": 4.3}, 0.1, False),
        ("contrast sensitivity, uniform", (2, 3, 64, 64),
         {"return_contrast_sensitivity": True, "gaussian_kernel": False}, 0.1, False),
        # float32 window sums lose digits on these: the full map, c1 and c2 from max - min
        *((f"adversarial: {kind}, full image", (2, 3, 150, 211), {"return_full_image": True, "data_range": None},
           kind, False) for kind in ("offset", "0-255", "ramp", "step")),
    ]
    rows = []
    for what, shape, kwargs, noise, timed in cases:
        preds, target = _adversarial_pair(noise, shape, gen) if isinstance(noise, str) else _image_pair(shape, gen, noise)
        before = kss.ssim_window.launches
        got = fs._ssim_update(preds, target, **kwargs)
        check(kss.ssim_window.launches == before + 1, f"ssim_window did not launch once ({what})")
        again = fs._ssim_update(preds, target, **kwargs)
        # the plain version in float64 on the same inputs (the port's own path for float64 images): the
        # float32 cancellation of sum p^2 - mu^2 in cuDNN's sums then stays out of the comparison
        want = fs._ssim_update(preds.double(), target.double(), **kwargs)
        want32 = fs._ssim_update_plain(preds, target, kwargs.get("gaussian_kernel", True),
                                       *_ssim_window_args(fs, preds, kwargs))
        got_t, want_t, again_t, want32_t = (x if isinstance(x, tuple) else (x,) for x in (got, want, again, want32))
        label = f"{what} {tuple(shape)}"
        errs = {}
        for k, (g, w, a, w32) in enumerate(zip(got_t, want_t, again_t, want32_t)):
            check(torch.equal(g.view(torch.int32), a.view(torch.int32)), f"ssim_window is not deterministic ({label})")
            w = w.float()
            name = ("ssim", "cs" if kwargs.get("return_contrast_sensitivity") else "map")[k]
            err = float((g - w).abs().max())
            if name == "map":
                check(err <= SSIM_MAP_ATOL, f"ssim_window's map differs from plain ({label}): max abs err {err}")
            else:
                check(torch.equal(g.isnan(), w.isnan()) and bool(((g - w).abs() <= SSIM_RTOL * w.abs()).all()),
                      f"ssim_window's {name} differs from plain ({label}): max abs err {err}")
            errs[name] = err
            errs[f"{name}_vs_float32_plain"] = float((g - w32).abs().max())
        row = {"case": label, "what": what, "max_abs_err": max(v for k, v in errs.items() if "float32" not in k),
               "errors": errs}
        if timed:
            plan = kss.plan(*shape, 11, 11, False)
            rng = torch.tensor(1.0, device="cuda")
            c1, c2 = (0.01 * rng) ** 2, (0.03 * rng) ** 2
            kernel = ih._gaussian_kernel_2d(shape[1], [11, 11], [1.5, 1.5], torch.float32, "cuda").contiguous()
            call = lambda p_, t_: fs._ssim_update(p_, t_, **kwargs)  # noqa: E731
            kernel_ms = time_ms(lambda: call(preds, target), flush, reps=20)
            plain_ms = time_ms(lambda: fs._ssim_update_plain(preds, target, True, *_ssim_window_args(fs, preds, kwargs)),
                               flush, reps=5, warmup=1)
            with ih._full_precision(kernel):
                yard_ms = time_ms(lambda: _conv_ssim_yardstick(preds, target, kernel, c1, c2), flush, reps=10)
            n_px = preds.numel()
            nbytes = 2 * 4 * n_px + 4 * shape[0]
            halo = (32 + 10) / 32
            nops = int(n_px * (7 * 11 * halo + 5 * 11 + 20))
            bytes_ms, ops_ms = nbytes / PEAK_BYTES_PER_S * 1e3, nops / PEAK_FP32_OPS_PER_S * 1e3
            # the design's own bound: its float32 row pass (9 operations a tap with the shift, over the
            # halo's rows) at the fp32 rate plus its double column pass (5 fused multiply-adds a tap, 8
            # operations to rebase each of kh + 7 rows for 8 outputs) and map (20) at the fp64 rate
            rows_halo = (kss.TILE_H + 10) / kss.TILE_H
            fp32_ops, fp64_ops = n_px * 11 * 9 * rows_halo, n_px * 2 * (5 * 11 + 8 * 18 / 8 + 20)
            mixed_ms = (fp32_ops / PEAK_FP32_OPS_PER_S + fp64_ops / PEAK_FP64_OPS_PER_S) * 1e3
            sets = [(preds, target), (preds.clone(), target.clone())]
            stream_ms = time_stream_ms(call, sets, calls=8)
            del sets
            row.update({"plan": plan._asdict(), "ms": kernel_ms, "stream_ms": stream_ms, "plain_ms": plain_ms,
                        "conv_ssim_yardstick_ms": yard_ms, "bound_ms": max(bytes_ms, ops_ms), "mixed_bound_ms": mixed_ms,
                        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations", "bytes": nbytes, "ops": nops,
                        "library_ms": None})
            print(f"[kernel] ssim_window {label}: {kernel_ms:.4f} ms after an L2 flush ({stream_ms:.4f} ms a call "
                  f"back to back; {plan.blocks} blocks, {plan.shared_bytes} B shared), plain (float32, F.conv2d) "
                  f"{plain_ms:.4f} ms, cuDNN depthwise conv of the stacked maps + the elementwise SSIM (several "
                  f"calls, a yardstick) {yard_ms:.4f} ms, bound {row['bound_ms'] * 1e3:.3f} us ({row['bound_by']}: "
                  f"{nbytes} bytes, {nops} ops; this design's float32 row pass plus double column pass "
                  f"{mixed_ms * 1e3:.3f} us), errors {errs}, library_ms: none")
            rows.insert(0, row)
        else:
            rows.append(row)
        del preds, target, got, want, again, want32
    # MS-SSIM over the DIV2K batch: five launches, each scale against the float64 plain version
    preds, target = _image_pair(DIV2K_SHAPE, gen, 0.05)
    before = kss.ssim_window.launches
    got = fs._multiscale_ssim_update(preds, target, data_range=1.0, normalize="relu")
    check(kss.ssim_window.launches == before + 5, "MS-SSIM did not launch ssim_window once a scale")
    want = fs._multiscale_ssim_update(preds.double(), target.double(), data_range=1.0, normalize="relu").float()
    err = float((got - want).abs().max())
    check(bool(((got - want).abs() <= SSIM_RTOL * want.abs()).all()), f"MS-SSIM differs from plain: {err}")
    # the five scales' launches alone, on the pooled inputs, against one full-size call
    scales = [(preds, target)]
    for _ in range(4):
        scales.append(tuple(torch.nn.functional.avg_pool2d(x, 2) for x in scales[-1]))
    five = lambda: [fs._ssim_update(p_, t_, data_range=1.0, return_contrast_sensitivity=True)  # noqa: E731
                    for p_, t_ in scales]
    five_ms = time_ms(five, flush, reps=20)
    one_ms = time_ms(lambda: fs._ssim_update(preds, target, data_range=1.0, return_contrast_sensitivity=True),
                     flush, reps=20)
    rows.append({"case": f"MS-SSIM, five scales of the DIV2K batch {DIV2K_SHAPE}", "what": "MS-SSIM",
                 "max_abs_err": err, "five_scales_ms": five_ms, "one_scale_ms": one_ms})
    print(f"[kernel] ssim_window, MS-SSIM's five scales of the DIV2K batch: {five_ms:.4f} ms after an L2 flush, "
          f"{five_ms / one_ms:.3f}x one full-size call ({one_ms:.4f} ms)")
    print(f"[kernel] ssim_window: per-image SSIM and CS within {SSIM_RTOL} relative and the map within "
          f"{SSIM_MAP_ATOL} absolute of the plain version in float64, deterministic, on {len(rows)} cases: "
          + "; ".join(f"{r['what']} ({r['max_abs_err']:.3g}; float32 plain "
                      f"{max([v for k, v in r.get('errors', {}).items() if 'float32' in k] or [0.0]):.3g})"
                      for r in rows))
    return rows


def _ssim_window_args(fs, preds, kwargs):
    """``_ssim_update_plain``'s arguments after ``gaussian_kernel`` for ``_ssim_update``'s ``kwargs``."""
    gaussian = kwargs.get("gaussian_kernel", True)
    kernel_size, sigma = fs._window(preds, gaussian, kwargs.get("sigma", 1.5), kwargs.get("kernel_size", 11))
    win = [int(3.5 * s + 0.5) * 2 + 1 for s in sigma] if gaussian else list(kernel_size)
    return (sigma, kernel_size, win, kwargs.get("data_range"), 0.01, 0.03, kwargs.get("return_full_image", False),
            kwargs.get("return_contrast_sensitivity", False))


def _main_path_data(gen: torch.Generator):
    """Seeded eval-set stand-ins, made on the card: softmax probabilities of a
    classifier that adds logit mass to the true class on 3 rows in 4, integer
    targets, and regression value/reference pairs."""
    dev = torch.device("cuda")
    target = torch.randint(0, N_CLASSES, (N_SAMPLES,), generator=gen, device=dev)
    logits = 2.0 * torch.randn((N_SAMPLES, N_CLASSES), generator=gen, device=dev)
    boost = 6.0 * (torch.rand((N_SAMPLES,), generator=gen, device=dev) < 0.75)
    logits[torch.arange(N_SAMPLES, device=dev), target] += boost
    probs = torch.softmax(logits, dim=1)
    values = torch.randn((N_SAMPLES,), generator=gen, device=dev)
    references = values + 0.1 * torch.randn((N_SAMPLES,), generator=gen, device=dev)
    torch.cuda.synchronize()
    return probs, target, values, references


def _metrics(device):
    from torchmetrics_tpu_torch.classification import MulticlassAccuracy, MulticlassAUROC, MulticlassF1Score
    from torchmetrics_tpu_torch.regression import MeanSquaredError

    return {
        "accuracy": MulticlassAccuracy(num_classes=N_CLASSES, average="micro", validate_args=False, device=device),
        "f1": MulticlassF1Score(num_classes=N_CLASSES, average="macro", validate_args=False, device=device),
        "auroc": MulticlassAUROC(num_classes=N_CLASSES, thresholds=20, validate_args=False, device=device),
        "mse": MeanSquaredError(device=device),
    }


def _batches(data, n_batches=None):
    probs, target, values, references = data
    starts = range(0, N_SAMPLES, BATCH)
    for start in list(starts)[:n_batches]:
        sl = slice(start, start + BATCH)
        yield {"cls": (probs[sl], target[sl]), "reg": (values[sl], references[sl])}


def phase_main_path(kernels) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    data = _main_path_data(gen)
    print(f"[main] data on the card: probs {tuple(data[0].shape)} float32 "
          f"({data[0].numel() * 4 / 1e6:.0f} MB), {N_SAMPLES} targets and regression pairs")
    metrics = _metrics("cuda")
    states = {k: m.init_state() for k, m in metrics.items()}
    times = {k: [] for k in metrics}
    early = None
    n_batches = 0

    for kernel in kernels:
        kernel.launches = 0
    torch.cuda.synchronize()
    t_path = time.perf_counter()
    for batch in _batches(data):
        for name, metric in metrics.items():
            args = batch["reg"] if name == "mse" else batch["cls"]
            t0 = time.perf_counter()
            states[name] = metric.update_state(states[name], *args)
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
        n_batches += 1
        if n_batches == 4:
            early = {k: {n: v.clone() for n, v in s.items()} for k, s in states.items()}
    results, compute_ms = {}, {}
    for name, metric in metrics.items():
        t0 = time.perf_counter()
        results[name] = metric.compute_state(states[name])
        torch.cuda.synchronize()
        compute_ms[name] = (time.perf_counter() - t0) * 1e3
    path_s = time.perf_counter() - t_path
    launches = {k.__name__: k.launches for k in kernels}

    expected_batches = -(-N_SAMPLES // BATCH)
    check(n_batches == expected_batches, f"{n_batches} batches, expected {expected_batches}")
    check(launches["binned_confmat_multiclass"] == expected_batches,
          f"binned_confmat_multiclass launched {launches['binned_confmat_multiclass']} times, expected {expected_batches}")
    for name, value in results.items():
        check(value.shape == () and bool(torch.isfinite(value)), f"{name} result {value} is not a finite scalar")
        check(value.dtype == torch.float32, f"{name} result dtype {value.dtype}")
    for name, state in states.items():
        check(int(state["_n"]) == expected_batches, f"{name} counted {int(state['_n'])} updates")
    check(int(states["accuracy"]["tp"].sum() + states["accuracy"]["fn"].sum()) == N_SAMPLES, "accuracy support")
    check(int(states["auroc"]["confmat"][0].sum()) == N_SAMPLES * N_CLASSES, "auroc cells at threshold 0")
    check(int(states["mse"]["total"]) == N_SAMPLES, "mse row count")

    # the first 4 batches again, on the port's CPU path (the plain versions)
    cpu_metrics = _metrics("cpu")
    cpu_states = {k: m.init_state() for k, m in cpu_metrics.items()}
    for batch in _batches(data, 4):
        for name, metric in cpu_metrics.items():
            args = batch["reg"] if name == "mse" else batch["cls"]
            cpu_states[name] = metric.update_state(cpu_states[name], *(a.cpu() for a in args))
    for name, cpu_state in cpu_states.items():
        for leaf, cpu_value in cpu_state.items():
            card_value = early[name][leaf].cpu()
            check(card_value.dtype == cpu_value.dtype, f"{name}.{leaf} dtype {card_value.dtype} vs {cpu_value.dtype}")
            if cpu_value.dtype == torch.int32:
                check(torch.equal(card_value, cpu_value), f"{name}.{leaf} differs between the card and the CPU")
            else:
                torch.testing.assert_close(card_value, cpu_value, rtol=1e-5, atol=0)

    # the first compute above also loads each new CUDA kernel's module; steady state:
    compute_steady_ms = {}
    for name, metric in metrics.items():
        samples = []
        for _ in range(10):
            t0 = time.perf_counter()
            metric.compute_state(states[name])
            torch.cuda.synchronize()
            samples.append((time.perf_counter() - t0) * 1e3)
        compute_steady_ms[name] = statistics.median(samples)
    pipelined_s, busy_s = _pipelined_pass(metrics, data)
    auroc_ops = _profiled_update_ops(metrics["auroc"], states["auroc"], next(_batches(data, 1))["cls"])

    record = {
        "batches": n_batches, "launches": launches, "path_s": path_s,
        "update_ms_median": {k: statistics.median(v) for k, v in times.items()},
        "compute_first_ms": compute_ms, "compute_ms": compute_steady_ms,
        "pipelined_pass_s": pipelined_s, "pipelined_samples_per_s": N_SAMPLES / pipelined_s,
        "profiled_device_busy_s": busy_s, "auroc_update_device_ops": auroc_ops,
        "results": {k: float(v) for k, v in results.items()},
    }
    for name in metrics:
        print(f"[main] {name}: update median {record['update_ms_median'][name]:.4f} ms/batch, "
              f"compute {compute_steady_ms[name]:.4f} ms (first call {compute_ms[name]:.4f} ms), "
              f"value {record['results'][name]:.6f}")
    print(f"[main] {n_batches} batches in {path_s:.3f} s (host clock, a synchronize after each update); "
          f"launches {launches}; first 4 batches match the CPU path")
    busy = "not measured" if busy_s is None else f"{busy_s:.4f} s of device time"
    print(f"[main] pipelined pass (no synchronize between updates): {pipelined_s:.4f} s, "
          f"{record['pipelined_samples_per_s']:.0f} samples/s; profiled pass: {busy}")
    print(f"[main] one profiled AUROC update_state runs {len(auroc_ops)} device operations: "
          f"{[f'{name[:60]}: {us:.2f} us' for name, us in auroc_ops]}")
    return record


def _profiled_update_ops(metric, state, args):
    """``(name, device us)`` of each device operation of one ``update_state``, in launch order."""
    return _device_ops(lambda: metric.update_state(state, *args))


def _pipelined_pass(metrics, data):
    """Seconds for one pass over the set with no synchronize between updates,
    as an eval loop runs, and the device time of a second such pass under
    ``torch.profiler`` (kernels, copies and fills; ``None`` if the profiler
    records no device activity)."""

    def one_pass():
        states = {k: m.init_state() for k, m in metrics.items()}
        for batch in _batches(data):
            for name, metric in metrics.items():
                args = batch["reg"] if name == "mse" else batch["cls"]
                states[name] = metric.update_state(states[name], *args)
        for name, metric in metrics.items():
            metric.compute_state(states[name])
        torch.cuda.synchronize()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one_pass()
    seconds = time.perf_counter() - t0
    prof, _ = _profiled(one_pass)
    device_us = sum(
        e.time_range.elapsed_us() for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
    )
    return seconds, (device_us / 1e6 if device_us > 0 else None)


# --------------------------------------------------------------- coco_match
COCO_THRS = [0.5, 0.55, 0.6, 0.65, 0.7, 0.75, 0.8, 0.85, 0.9, 0.95]
SM_CLOCK_HZ = 1.98e9  # H100 SXM boost clock
DEP_OP_CYCLES = 4  # latency of one dependent FP32 operation, in cycles


def _match_inputs(n_items, n_dets, n_gts, thrs, edits, gen):
    """A padded matcher batch on the card: IoUs on a 0.05 grid (ties, and IoUs
    on the thresholds), ~10 % crowd ground truths, per-area ignore masks, items
    of 1..D real detections and 1..G real ground truths, padded rows of 0 and
    some rows of -inf; ``edits`` add the contract's edge cases."""
    dev = torch.device("cuda")
    n_areas = 4
    ious = torch.round(torch.rand((n_items, n_dets, n_gts), generator=gen, device=dev) * 20) / 20
    n_d = torch.randint(1, n_dets + 1, (n_items, 1), generator=gen, device=dev)
    n_g = torch.randint(1, n_gts + 1, (n_items, 1), generator=gen, device=dev)
    valid_d = torch.arange(n_dets, device=dev)[None, :] < n_d
    valid_g = torch.arange(n_gts, device=dev)[None, :] < n_g
    ious = torch.where(valid_d[:, :, None] & valid_g[:, None, :], ious, 0.0)
    ious[torch.arange(0, n_items, 7, device=dev), n_dets - 1] = -float("inf")  # an invalid row of -inf
    crowd = (torch.rand((n_items, n_gts), generator=gen, device=dev) < 0.1) & valid_g
    ignored = crowd[:, None, :] | (torch.rand((n_items, n_areas, n_gts), generator=gen, device=dev) < 0.25)
    if "one" in edits:  # IoUs of exactly 1.0, eligible at thr = 1.0
        ones = torch.rand((n_items, n_dets, n_gts), generator=gen, device=dev) < 0.1
        ious = torch.where(ones & valid_d[:, :, None] & valid_g[:, None, :], 1.0, ious)
    if "crowd_ignored" in edits:  # whole items all crowd, or all ignored
        crowd[0::2] = valid_g[0::2]
        ignored[1::2] = True
    if "ties" in edits:  # rows of equal IoUs: the last index must win
        ious[:, ::2] = torch.where(valid_g[:, None, :], 0.7, 0.0)
    if "gaps" in edits:  # invalid rows inside the live extent, keeping their IoUs: random ones and a run of them
        valid_d &= torch.rand(valid_d.shape, generator=gen, device=dev) < 0.7
        valid_d[:, n_dets // 4 : n_dets // 2] = False
    if "empty" in edits:  # every fifth item has no valid detection
        valid_d[::5] = False
    thr = torch.tensor(thrs, dtype=torch.float32, device=dev)
    return ious.contiguous(), crowd, ignored.contiguous(), valid_d, valid_g, thr


def _map_chunks() -> list:
    """The matcher's arguments of each launch of the mAP compute of phase 6:
    every (class, image) item of the 5,000-image set, in the metric's order,
    padded as the metric pads them, on the card."""
    from torchmetrics_tpu_torch.detection import MeanAveragePrecision
    from torchmetrics_tpu_torch.detection.mean_ap import _matcher_items
    from torchmetrics_tpu_torch.functional.detection.matcher import padded_chunks

    metric = MeanAveragePrecision(device="cuda")
    state = _map_state(metric, torch.device("cuda"), range(MAP_IMAGES // MAP_BATCH))
    _, _, items = metric._class_items(state)
    flat = [it for per_class in items for it in per_class]
    return [args for _, args in padded_chunks(_matcher_items(flat), metric.iou_thresholds, "cuda")]


def _shape(args) -> tuple:
    """``(B, D, G, A, T)`` of the matcher's arguments, as ``coco_match.shapes`` counts them."""
    ious, _, ignored, _, _, thrs = args
    return (*ious.shape, ignored.shape[1], thrs.shape[0])


def phase_matcher(flush: torch.Tensor):
    """The matcher's rows (the first at phase 6's first chunk) and the count
    of phase 6's chunks by ``(B, D, G, A, T)``."""
    from torchmetrics_tpu_torch.functional.detection.matcher import _match_batch_plain
    from torchmetrics_tpu_torch.kernels import coco_match as kcm

    t0 = time.perf_counter()
    chunks = _map_chunks()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for i, args in enumerate(chunks):
        got, want = kcm.coco_match(*args), _match_batch_plain(*args)
        mismatches = [int((x != y).sum()) for x, y in zip(got, want)]
        check(all(torch.equal(x, y) for x, y in zip(got, want)),
              f"coco_match and plain differ on mAP chunk {i} {_shape(args)}: {mismatches}")
    shapes = collections.Counter(_shape(args) for args in chunks)
    print(f"[kernel] coco_match: exact on all {len(chunks)} chunks of the {MAP_IMAGES:,}-image mAP compute, by (B, D, G, A, T) "
          f"{dict(shapes)} (items built and padded in {build_s:.2f} s, checked in {time.perf_counter() - t0:.2f} s)")

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    thr_one = COCO_THRS[:-1] + [1.0]
    cases = [  # (what, items, detections, ground truths, thresholds, edits); the first is phase 6's first chunk
        ("mAP chunk 0", chunks[0]),
        ("D=128, G=32", 1024, 128, 32, COCO_THRS, ()),
        ("G=8", 1024, 128, 8, COCO_THRS, ()),
        ("G=64, two gts a lane", 1024, 128, 64, COCO_THRS, ()),
        ("thr=1.0, IoUs of exactly 1.0", 1024, 128, 32, thr_one, ("one",)),
        ("all-crowd and all-ignored items", 1024, 128, 32, COCO_THRS, ("crowd_ignored",)),
        ("equal IoUs, last index wins", 1024, 128, 32, COCO_THRS, ("ties",)),
        ("G=256, tile read from device memory", 256, 128, 256, COCO_THRS, ()),
        ("G=1, a group of 8 lanes", 1024, 128, 1, COCO_THRS, ()),
        ("G=2", 1024, 128, 2, COCO_THRS, ()),
        ("G=4", 1024, 128, 4, COCO_THRS, ()),
        ("G=16", 1024, 128, 16, COCO_THRS, ()),
        ("G=33, two gts a lane", 1024, 128, 33, COCO_THRS, ()),
        ("G=128, four gts a lane", 1024, 128, 128, COCO_THRS, ()),
        ("gaps in valid_d", 1024, 128, 32, COCO_THRS, ("gaps",)),
        ("gaps and items with no valid row", 1024, 128, 8, COCO_THRS, ("gaps", "empty")),
        ("D=8, byte stores", 1024, 8, 8, COCO_THRS, ()),
    ]
    del chunks[1:]
    rows = []
    for what, *spec in cases:
        args = spec[0] if len(spec) == 1 else _match_inputs(*spec, gen)
        b, d, g, a, t = _shape(args)
        label = f"{what} B={b} D={d} G={g} A={a} T={t}"
        got = kcm.coco_match(*args)
        want = _match_batch_plain(*args)
        torch.cuda.synchronize()
        mismatches = [int((x != y).sum()) for x, y in zip(got, want)]
        check(all(torch.equal(x, y) for x, y in zip(got, want)), f"coco_match and plain differ ({label}): {mismatches}")
        check(bool(want[0].any()) and not bool(want[0].all()), f"a degenerate case ({label})")
        # least work: read the IoU rows of the valid detections, valid_d and the
        # gt masks once, write both maps once; a compare and an argmax step per
        # (b, a, t, d, g) of the valid detections. The scan's chain: the longest
        # live extent's dependent steps of a log2(G)-deep argmax and a carry
        # update, at DEP_OP_CYCLES a dependent operation
        valid_rows = int(args[3].sum())
        live = int((args[3] * torch.arange(1, d + 1, device=args[3].device)).amax())
        nbytes = 4 * g * valid_rows + b * d + b * g * 2 + b * a * g + t * 4 + 2 * b * a * t * d
        nops = 2 * a * t * g * valid_rows
        bytes_ms, ops_ms = nbytes / PEAK_BYTES_PER_S * 1e3, nops / PEAK_FP32_OPS_PER_S * 1e3
        chain_ms = live * (math.ceil(math.log2(g)) + 2) * DEP_OP_CYCLES / SM_CLOCK_HZ * 1e3
        plan = kcm.launch_plan(d, g, a, t)
        kernel_ms = time_ms(lambda: kcm.coco_match(*args), flush)
        plain_ms = time_ms(lambda: _match_batch_plain(*args), flush, reps=5, warmup=1)
        sets = [args] + [tuple(x.clone() for x in args) for _ in range(copies_for(nbytes) - 1)]
        stream_ms = time_stream_ms(kcm.coco_match, sets, calls=len(sets) * max(1, 48 // len(sets)))
        del sets
        row = {
            "case": label, "max_abs_err": float(max(mismatches)), "ms": kernel_ms, "stream_ms": stream_ms,
            "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations", "chain_ms": chain_ms,
            "bytes": nbytes, "ops": nops, "valid_rows": valid_rows, "live": live, "plan": plan._asdict(),
            "library_ms": None,
        }
        print(
            f"[kernel] coco_match {label}: exact, {kernel_ms:.4f} ms after an L2 flush "
            f"({stream_ms:.4f} ms a call back to back), plain {plain_ms:.4f} ms, bound {row['bound_ms'] * 1e3:.2f} us "
            f"({row['bound_by']}: {nbytes} bytes, {nops} ops; {valid_rows} valid rows, live extent up to {live}), "
            f"dependent chain {chain_ms * 1e3:.2f} us, library_ms: none; plan {tuple(plan)}"
        )
        rows.append(row)
    return rows, shapes


# ---------------------------------------------------------- confmat_multiclass
SEG_SHAPE = (2, 19, 1024, 2048)  # Cityscapes-shaped logits of one batch: 2 images, 19 classes, 1024 x 2048
SEG_IGNORE = 255  # Cityscapes' void label


def _seg_batch(gen: torch.Generator, dtype=torch.float32):
    """A Cityscapes-shaped batch on the card: logits (2, 19, 1024, 2048) with the
    true class boosted on 3 pixels in 4, int64 targets, ~5 % of them 255."""
    dev = torch.device("cuda")
    n, c, h, w = SEG_SHAPE
    target = torch.randint(0, c, (n, h, w), generator=gen, device=dev)
    logits = torch.randn(SEG_SHAPE, generator=gen, device=dev, dtype=dtype)
    boost = 4.0 * (torch.rand((n, 1, h, w), generator=gen, device=dev) < 0.75).to(dtype)
    logits.scatter_add_(1, target[:, None], boost)
    target[torch.rand((n, h, w), generator=gen, device=dev) < 0.05] = SEG_IGNORE
    return logits, target


def _confmat_case(n, c, spatial, gen, dtype=torch.float32, target_dtype=torch.int64, edits=()):
    """Scores (N, C, *S) of ``dtype`` (or int32 labels with "labels") and targets (N, *S) on the card."""
    dev = torch.device("cuda")
    shape = (n, *spatial)
    target = torch.randint(0, c, shape, generator=gen, device=dev, dtype=target_dtype)
    scores = torch.randn((n, c, *spatial), generator=gen, device=dev).to(dtype)
    if n and "edge_rows" in edits:  # where the argmax rule decides: NaN, ties, signed zeros, all -inf
        nan, inf = float("nan"), float("inf")
        rows = scores.view(n, c, -1)[:, :, 0]
        rows[0::9] = nan
        rows[1::9, c // 2] = nan
        rows[1::9, c - 1] = nan
        rows[2::9] = 0.25
        rows[3::9, 0], rows[3::9, c - 1] = 7.0, 7.0
        rows[4::9] = -0.0
        rows[4::9, c - 1] = 0.0
        rows[5::9] = -inf
        rows[6::9, c - 1] = inf
        rows[7::9] = -inf
        rows[7::9, c // 2] = nan
    if n and "out_of_range" in edits:  # wrapped (C, C+3, -3) and dropped (-(C*C+1)) flat indices
        flat = target.view(-1)
        for i, value in enumerate([c, c + 3, -3, -(c * c + 1)]):
            flat[i::10] = value
    if "labels" in edits:
        scores = torch.randint(-3, c + 3, shape, generator=gen, device=dev, dtype=torch.int32)  # out of range too
    return scores.contiguous(), target


def _nominal_kernel_labels(gen: torch.Generator):
    """The labels phase 11 (iv)'s contingency sends the kernel at a batch of 1,024 rows, C = 42: the dropped
    rows at target C (flat cell C * C), saturated +-inf (INT32_MAX, INT32_MIN), and labels -1, -43 and 43,
    which wrap or drop as JAX's ``.at[...].add`` does."""
    dev, c = torch.device("cuda"), max(ADULT_CARDINALITIES)
    preds = torch.randint(0, c, (ADULT_BATCH,), generator=gen, device=dev, dtype=torch.int32)
    target = torch.randint(0, c, (ADULT_BATCH,), generator=gen, device=dev, dtype=torch.int32)
    target[::50] = c
    preds[7::101], target[9::103] = 2**31 - 1, -(2**31)
    preds[11::97], target[13::89], target[17::83] = -1, -c - 1, c + 1
    return preds, target, c


def _clustering_kernel_labels(gen: torch.Generator):
    """Phase 11 (iii)'s contingency: 50,000 dense cluster ids against 50,000 class ids, C = 1,000."""
    dev = torch.device("cuda")
    target = torch.randint(0, CLUSTER_CLASSES, (CLUSTER_ROWS,), generator=gen, device=dev, dtype=torch.int32)
    preds = torch.where(torch.rand((CLUSTER_ROWS,), generator=gen, device=dev) < 0.5, target,
                        torch.randint(0, CLUSTER_CLASSES, (CLUSTER_ROWS,), generator=gen, device=dev, dtype=torch.int32))
    return preds, target, CLUSTER_CLASSES


def _label_edges(gen: torch.Generator) -> list:
    """The labels' edges: N % 4 != 0, arrays starting off a 16-byte boundary (a contiguous slice from element 1;
    int32 preds from element 1 beside aligned int32 targets), C at the shared/global switch (90, 91), a batch
    smaller than its histogram. Labels out of range too."""
    dev = torch.device("cuda")

    def labels(n, c, dtype=torch.int32, target_dtype=torch.int32, start=0, target_start=0):
        preds = torch.randint(-3, c + 3, (n + start,), generator=gen, device=dev, dtype=dtype)[start:]
        target = torch.randint(-3, c + 3, (n + target_start,), generator=gen, device=dev, dtype=target_dtype)
        return preds, target[target_start:], c

    return [
        ("labels, N % 4 = 3: 1,023 at C = 42", labels(1_023, 42), None),
        ("labels from element 1, int32", labels(4_097, 42, start=1, target_start=1), 0),
        ("labels from element 1, int64", labels(4_097, 42, torch.int64, torch.int64, 1, 1), None),
        ("labels from element 1, int32 preds, int64 targets", labels(4_097, 1_000, torch.int32, torch.int64, 1, 1),
         None),
        ("labels, int32 preds from element 1, aligned int32 targets",
         labels(4_097, 42, start=1), None),
        ("labels at C = 90 (shared histogram)", labels(20_001, 90, torch.int64), None),
        ("labels at C = 91 (the state)", labels(20_001, 91), -1),
        ("labels, a batch smaller than its histogram: 1,000 at C = 60", labels(1_000, 60), None),
    ]


def phase_confmat(flush: torch.Tensor) -> list:
    """``confmat_multiclass`` against its plain version on the card, and its times at
    the main path's shapes: ImageNet-1k's batch (the first row) and a Cityscapes batch."""
    from torchmetrics_tpu_torch.kernels import confmat as kcm

    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    cases = [  # (what, batch or (N, C, spatial, kwargs), ignore_index); the first two are the main path's shapes
        ("ImageNet-1k batch (a)", (BATCH, N_CLASSES, (), {}), None),
        ("Cityscapes batch (b)", _seg_batch(gen), SEG_IGNORE),
        ("C=2", (BATCH, 2, (), {}), None),
        ("C=3, spatial", (64, 3, (16, 16), {}), None),
        ("C=19, spatial, S % 4 != 0: a thread a pixel", (4, 19, (9, 7), {}), None),
        ("C=19", (BATCH, 19, (), {}), None),
        ("C=1001, scalar loads", (BATCH, 1001, (), {}), None),
        ("C=1000, NaN, tie, +-0.0 and -inf rows", (BATCH, N_CLASSES, (), {"edits": ("edge_rows",)}), None),
        ("C=19 spatial, NaN, tie, +-0.0 and -inf rows", (8, 19, (64, 64), {"edits": ("edge_rows",)}), None),
        ("C=3, NaN, tie, +-0.0 and -inf rows", (BATCH, 3, (), {"edits": ("edge_rows",)}), None),
        ("C=1000, targets C, C+3, -3, -(C*C+1)", (BATCH, N_CLASSES, (), {"edits": ("out_of_range",)}), None),
        ("C=19 spatial, targets C, C+3, -3, -(C*C+1)", (4, 19, (32, 32), {"edits": ("out_of_range",)}), None),
        ("C=19, out-of-range integer labels", (BATCH, 19, (8,), {"edits": ("labels",)}), None),
        ("C=1000, out-of-range integer labels", (BATCH, N_CLASSES, (), {"edits": ("labels",)}), None),
        ("C=19, ignore_index=-3", (4, 19, (32, 32), {"edits": ("out_of_range",)}), -3),
        ("C=1000, ignore_index=255", (BATCH, N_CLASSES, (), {}), 255),
        ("C=1000, int32 targets", (BATCH, N_CLASSES, (), {"target_dtype": torch.int32}), None),
        ("C=1000, float16 scores", (BATCH, N_CLASSES, (), {"dtype": torch.float16, "edits": ("edge_rows",)}), None),
        ("C=1000, bfloat16 scores", (BATCH, N_CLASSES, (), {"dtype": torch.bfloat16}), None),
        ("C=19 spatial, float16 scores", (4, 19, (32, 32), {"dtype": torch.float16, "edits": ("edge_rows",)}), None),
        ("C=19 spatial, bfloat16 scores", (4, 19, (32, 32), {"dtype": torch.bfloat16}), None),
        ("empty batch", (0, 19, (), {}), None),
        ("nominal contingency (c)", _nominal_kernel_labels(gen), None),
        ("clustering contingency (d)", _clustering_kernel_labels(gen), None),
        ("C=32 (ROW_MIN_SCORES)", (BATCH, 32, (), {}), None),
        ("C=77, odd: scalar loads", (BATCH, 77, (), {"edits": ("edge_rows",)}), None),
        *_label_edges(gen),
    ]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for what, spec, ignore_index in cases:
        preds, target, *given = spec if isinstance(spec[0], torch.Tensor) else _confmat_case(*spec[:3], gen, **spec[3])
        c = given[0] if given else (N_CLASSES if what.startswith("ImageNet") else (19 if what.startswith("City") else spec[1]))
        state = torch.randint(-(2**20), 2**20, (c, c), generator=gen, device="cuda", dtype=torch.int32)
        got = kcm.confmat_multiclass(state.clone(), preds, target, ignore_index)
        want = kcm._confmat_multiclass_plain(state.clone(), preds, target, ignore_index)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        label = f"{what}: preds {tuple(preds.shape)} {str(preds.dtype)[6:]}, target {str(target.dtype)[6:]}, " \
                f"ignore_index {ignore_index}"
        check(torch.equal(got, want), f"confmat_multiclass and plain differ ({label}): max abs err {err}")
        added = int((want - state).sum())
        check(added > 0 or preds.numel() == 0, f"no pair counted ({label})")
        if what[-3:] not in ("(a)", "(b)", "(c)", "(d)"):
            rows.append({"case": label, "what": what, "max_abs_err": err, "added": added})
            continue
        # least work: read the scores and the targets once, read and write the state cells
        # this batch touches; compare every score once
        touched = int((want != state).sum())
        nbytes = preds.numel() * preds.element_size() + target.numel() * target.element_size() + 8 * touched
        nops = preds.numel()
        bytes_ms, ops_ms = nbytes / PEAK_BYTES_PER_S * 1e3, nops / PEAK_FP32_OPS_PER_S * 1e3
        n, k, inner = kcm._layout(state, preds, target)
        plan = kcm.plan(n * inner, k, inner, c, not preds.is_floating_point(), sms)
        timed = state.clone()  # the timed launches add into it, far below 2**31
        kernel_ms = time_ms(lambda: kcm.confmat_multiclass(timed, preds, target, ignore_index), flush)
        plain_ms = time_ms(lambda: kcm._confmat_multiclass_plain(timed, preds, target, ignore_index), flush,
                           reps=10, warmup=1)
        if preds.is_floating_point():
            two_call_ms = time_ms(lambda: torch.bincount(target.view(-1) * c + preds.argmax(1).view(-1),
                                                         minlength=c * c), flush, reps=10, warmup=1)
        else:  # labels: the flat index clamped into a spare cell (three calls)
            two_call_ms = time_ms(lambda: torch.bincount((target.view(-1).long() * c + preds.view(-1)).clamp(0, c * c),
                                                         minlength=c * c + 1), flush, reps=10, warmup=1)
        sets = [(timed, preds, target)] + [(timed, preds.clone(), target.clone())
                                           for _ in range(min(copies_for(nbytes), MAX_STREAM_COPIES) - 1)]
        stream_ms = time_stream_ms(lambda s_, p_, t_: kcm.confmat_multiclass(s_, p_, t_, ignore_index), sets,
                                   calls=len(sets) * max(1, 48 // len(sets)))
        del sets
        host_us = host_enqueue_us(lambda: kcm.confmat_multiclass(timed, preds, target, ignore_index))
        after = kcm.confmat_multiclass(state.clone(), preds, target, ignore_index)
        check(torch.equal(after, want), f"confmat_multiclass differs after the timed launches ({label})")
        row = {
            "case": label, "max_abs_err": err, "added": added, "plan": plan._asdict(), "ms": kernel_ms,
            "stream_ms": stream_ms, "host_us": host_us, "plain_ms": plain_ms, "two_call_ms": two_call_ms,
            "bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "ops": nops, "touched_cells": touched, "library_ms": None,
        }
        print(f"[kernel] confmat_multiclass {label}: exact, {kernel_ms:.4f} ms after an L2 flush "
              f"({stream_ms:.4f} ms a call back to back; plan {tuple(plan)}; the host enqueues a call in "
              f"{host_us:.1f} us), plain {plain_ms:.4f} ms, "
              f"argmax + bincount (two calls, a yardstick) {two_call_ms:.4f} ms, bound {row['bound_ms'] * 1e3:.2f} us "
              f"({row['bound_by']}: {nbytes} bytes, {nops} compares; {touched} cells touched), library_ms: none")
        rows.append(row)
    print(f"[kernel] confmat_multiclass: exact on all {len(cases)} cases, the two above and "
          + "; ".join(r["what"] for r in rows if "ms" not in r))
    return rows


# ---------------------------------------------------- phases 5 and 6: ranks
WORLD_TIMEOUT_S = 420
SYNC_METRICS = ("acc", "f1", "auroc", "ap")
ROUGE_PAIRS, ROUGE_BATCH = 1_000, 50
MAP_IMAGES, MAP_BATCH, MAP_CLASSES = 5_000, 100, 80  # COCO val2017: 5,000 images, 80 classes
VOCAB = ("the a cat dog sat ran on in mat home fast slow red blue big small park street car tree man woman child "
         "ball game over under near far house road sky water").split()


def _rank_blocks(n_blocks: int, world: int, uneven: bool) -> list:
    """Contiguous block ranges of each rank: even, or in proportion 1 : 2 : ... : world."""
    weights = [r + 1 for r in range(world)] if uneven else [1] * world
    bounds = [round(n_blocks * sum(weights[:r]) / sum(weights)) for r in range(world + 1)]
    return [range(bounds[r], bounds[r + 1]) for r in range(world)]


def _sync_collection(device):
    from torchmetrics_tpu_torch.classification import (
        MulticlassAccuracy, MulticlassAUROC, MulticlassAveragePrecision, MulticlassF1Score,
    )
    from torchmetrics_tpu_torch.collections import MetricCollection

    return MetricCollection({
        "acc": MulticlassAccuracy(num_classes=N_CLASSES, average="micro", validate_args=False, device=device),
        "f1": MulticlassF1Score(num_classes=N_CLASSES, average="macro", validate_args=False, device=device),
        "auroc": MulticlassAUROC(num_classes=N_CLASSES, thresholds=20, validate_args=False, device=device),
        "ap": MulticlassAveragePrecision(num_classes=N_CLASSES, thresholds=None, validate_args=False, device=device),
    })


def _sync_collection2(device):
    """Phase 5's second collection: the sums, max and cat of the aggregators, R2 and
    Pearson's moments (its own sync), over the rows' top score and whether it is right."""
    from torchmetrics_tpu_torch import aggregation as agg, regression as reg
    from torchmetrics_tpu_torch.collections import MetricCollection

    return MetricCollection({
        "mean": agg.MeanMetric(device=device), "sum": agg.SumMetric(device=device), "max": agg.MaxMetric(device=device),
        "cat": agg.CatMetric(device=device), "pearson": reg.PearsonCorrCoef(device=device),
        "r2": reg.R2Score(device=device),
    })


def _collection2_inputs(probs, target) -> dict:
    conf, pred = probs.max(1)
    return {"value": conf, "preds": conf, "target": (pred == target).to(torch.float32)}


SYNC2_RTOL = 1e-5  # float sums and Pearson's pairwise merge against one pass in order; max and cat exact


def worker_sync(rank: int, world: int, device: torch.device) -> dict:
    """Phase 5 on one rank: this rank's whole batches of the 50,000 x 1,000
    set through the collection, one coalesced sync, compute; then the
    single-process run over all 50,000 rows on this rank, to compare."""
    import torch.distributed as dist

    from torchmetrics_tpu_torch.core.reductions import COLLECTIVES
    from torchmetrics_tpu_torch.kernels.binned_confmat import binned_confmat_multiclass
    from torchmetrics_tpu_torch.parallel.coalesce import plan_for_metrics

    data = _main_path_data(torch.Generator(device=device).manual_seed(SEED))
    batches = [b["cls"] for b in _batches(data)]
    mine = _rank_blocks(len(batches), world, uneven=False)[rank]
    col = _sync_collection(device)

    binned_confmat_multiclass.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    states = col.init_states()
    for i in mine:
        states = col.update_states(states, *batches[i])
    torch.cuda.synchronize()
    update_s = time.perf_counter() - t0
    plan = plan_for_metrics([col[k] for k in states], [states[k] for k in states])
    dist.barrier()
    before = dict(COLLECTIVES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    synced = col.sync_states(states)
    torch.cuda.synchronize()
    sync_ms = (time.perf_counter() - t0) * 1e3
    collectives = {k: v - before.get(k, 0) for k, v in COLLECTIVES.items() if v - before.get(k, 0)}
    t0 = time.perf_counter()
    values = col.compute_states(synced)
    torch.cuda.synchronize()
    compute_ms = (time.perf_counter() - t0) * 1e3
    launches = binned_confmat_multiclass.launches

    ref = col.init_states()
    for b in batches:
        ref = col.update_states(ref, *b)
    ref_values = col.compute_states(ref)
    leaves_equal = True
    for name in states:
        for leaf, want in ref[name].items():
            got = synced[name][leaf]
            if isinstance(want, tuple):  # rank after rank: the rows in the single-process order
                want = torch.cat(want)
                got = got[0] if len(got) == 1 else None
            leaves_equal &= got is not None and got.dtype == want.dtype and torch.equal(got, want)
    ap = synced["ap"]

    # the second collection, synced and timed apart: every rank against one process over every row
    col2 = _sync_collection2(device)
    states2 = col2.init_states()
    for i in mine:
        states2 = col2.update_states(states2, **_collection2_inputs(*batches[i]))
    dist.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    synced2 = col2.sync_states(states2)
    torch.cuda.synchronize()
    sync2_ms = (time.perf_counter() - t0) * 1e3
    values2 = col2.compute_states(synced2)
    ref2 = col2.init_states()
    for b in batches:
        ref2 = col2.update_states(ref2, **_collection2_inputs(*b))
    ref_values2 = col2.compute_states(ref2)
    equal2 = {}
    for k, want in ref_values2.items():
        got = values2[k]
        exact = k in ("max", "cat")
        equal2[k] = bool(got.shape == want.shape and (torch.equal(got, want) if exact else
                                                      torch.allclose(got, want, rtol=SYNC2_RTOL, atol=0)))
    sketch = _sketch_sync(rank, world, device, batches)
    return {
        **sketch,
        "col2_sync_ms": sync2_ms, "col2_equal": equal2, "col2_cat_rows": int(values2["cat"].shape[0]),
        "col2_pearson_n": float(synced2["pearson"]["n_total"]),
        "col2_values": {k: float(v) for k, v in values2.items() if v.numel() == 1},
        "rank": rank, "batches": len(mine), "rows": sum(batches[i][0].shape[0] for i in mine),
        "launches": {"binned_confmat_multiclass": launches, **sketch["sketch_launches"]}, "update_s": update_s,
        "sync_ms": sync_ms,
        "compute_ms": compute_ms, "collectives": collectives, "bucket_bytes": plan.bucket_bytes(),
        "gathered_bytes": {k: ap[k][0].numel() * ap[k][0].element_size() for k in ("preds", "target", "weight")},
        "ap_rows": ap["preds"][0].shape[0], "n": {k: int(v["_n"]) for k, v in synced.items()},
        "leaves_equal": bool(leaves_equal), "values": {k: float(v) for k, v in values.items()},
        "ref_values": {k: float(v) for k, v in ref_values.items()},
    }


def _sentence_pairs(n: int):
    rng = np.random.default_rng(SEED + 3)
    preds, target = [], []
    for _ in range(n):
        ref = list(rng.choice(VOCAB, int(rng.integers(6, 25))))
        hyp = [w if rng.uniform() < 0.7 else str(rng.choice(VOCAB)) for w in ref]
        if rng.uniform() < 0.3:
            del hyp[int(rng.integers(0, len(hyp)))]
        preds.append(" ".join(hyp))
        target.append(" ".join(ref))
    return preds, target


def _coco_images(lo: int, hi: int):
    """Images ``lo..hi-1`` of a COCO-val2017-shaped seeded set: 640 x 480
    frames, 80 classes, about 7 ground truths an image (1% crowd), 100
    detections an image: 60 % jittered copies of the ground truths, most with
    their label, 40 % boxes anywhere; higher scores for the copies."""
    preds, targets = [], []
    for i in range(lo, hi):
        rng = np.random.default_rng((SEED + 4, i))
        n_gt = int(min(1 + rng.poisson(6), 50))
        wh = np.exp(rng.uniform(np.log(8), np.log(400), (n_gt, 2)))
        xy = rng.uniform(0, 1, (n_gt, 2)) * np.maximum(np.array([640, 480]) - wh, 1)
        gt = np.concatenate([xy, xy + wh], 1).astype(np.float32)
        gl = rng.integers(0, MAP_CLASSES, n_gt).astype(np.int32)
        n_copy = 60
        src = rng.integers(0, n_gt, n_copy)
        jitter = rng.normal(0, 0.1, (n_copy, 4)) * np.repeat(wh[src], 2, axis=1)
        copies = gt[src] + jitter
        dl_copy = np.where(rng.uniform(size=n_copy) < 0.85, gl[src], rng.integers(0, MAP_CLASSES, n_copy))
        rwh = np.exp(rng.uniform(np.log(8), np.log(400), (100 - n_copy, 2)))
        rxy = rng.uniform(0, 1, (100 - n_copy, 2)) * np.maximum(np.array([640, 480]) - rwh, 1)
        boxes = np.concatenate([copies, np.concatenate([rxy, rxy + rwh], 1)]).astype(np.float32)
        boxes[:, 2:] = np.maximum(boxes[:, 2:], boxes[:, :2] + 1)
        labels = np.concatenate([dl_copy, rng.integers(0, MAP_CLASSES, 100 - n_copy)]).astype(np.int32)
        scores = np.concatenate([rng.beta(4, 2, n_copy), rng.beta(2, 4, 100 - n_copy)]).astype(np.float32)
        preds.append({"boxes": boxes, "scores": scores, "labels": labels})
        targets.append({"boxes": gt, "labels": gl, "iscrowd": (rng.uniform(size=n_gt) < 0.01).astype(np.int32)})
    return preds, targets


def _on(device, items):
    return [{k: torch.from_numpy(v).to(device) for k, v in d.items()} for d in items]


def _map_state(metric, device, batch_ids):
    """``metric``'s state after the image batches ``batch_ids`` of the mAP set, on ``device``."""
    st = metric.init_state()
    for j in batch_ids:
        p, t = _coco_images(j * MAP_BATCH, min((j + 1) * MAP_BATCH, MAP_IMAGES))
        st = metric.update_state(st, _on(device, p), _on(device, t))
    return st


def _device_s(prof, name: str = "") -> float:
    """Device seconds of the operations a ``torch.profiler`` run recorded whose names hold ``name``."""
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA and name in e.name) / 1e6


def _top_device_ops(prof, n: int = 8) -> list:
    """``[name, device s, count]`` of the ``n`` device operations a ``torch.profiler`` run spent most time in."""
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name][0] += e.time_range.elapsed_us() / 1e6
            by_name[e.name][1] += 1
    return sorted(([name[:90], s, c] for name, (s, c) in by_name.items()), key=lambda r: -r[1])[:n]


def worker_ragged(rank: int, world: int, device: torch.device) -> dict:
    """Phase 6 on one rank: ROUGE over its share of 1,000 sentence pairs and
    mAP over its share of the images, a different count on every rank, through
    the ragged sync and compute; then, on rank 0 of the first world, the single-process run to compare."""
    import torch.distributed as dist

    from torchmetrics_tpu_torch.core.reductions import COLLECTIVES
    from torchmetrics_tpu_torch.detection import MeanAveragePrecision
    from torchmetrics_tpu_torch.kernels.coco_match import coco_match
    from torchmetrics_tpu_torch.parallel import sync_ragged_states
    from torchmetrics_tpu_torch.text import ROUGEScore

    out = {"rank": rank}
    preds, target = _sentence_pairs(ROUGE_PAIRS)
    blocks = _rank_blocks(ROUGE_PAIRS // ROUGE_BATCH, world, uneven=True)
    rouge = ROUGEScore(rouge_keys=("rouge1", "rougeL"), device=device)

    def rouge_state(block_ids):
        st = rouge.init_state()
        for j in block_ids:
            sl = slice(j * ROUGE_BATCH, (j + 1) * ROUGE_BATCH)
            st = rouge.update_state(st, preds[sl], target[sl])
        return st

    st = rouge_state(blocks[rank])
    dist.barrier()
    t0 = time.perf_counter()
    synced = sync_ragged_states(rouge._reductions, st)
    out["rouge_sync_ms"] = (time.perf_counter() - t0) * 1e3
    out["rouge_items"] = [v.shape[0] for v in synced["rouge1_fmeasure"]]
    out["rouge"] = {k: float(v) for k, v in rouge.compute_state(synced).items()}
    ref = rouge_state(range(ROUGE_PAIRS // ROUGE_BATCH))
    out["rouge_ref"] = {k: float(v) for k, v in rouge.compute_state(ref).items()}
    out["rouge_items_equal"] = all(
        len(synced[k]) == len(ref[k]) and all(torch.equal(a, b.cpu()) for a, b in zip(synced[k], ref[k]))
        for k in ref if k != "_n"
    )

    n_batches = -(-MAP_IMAGES // MAP_BATCH)
    blocks = _rank_blocks(n_batches, world, uneven=True)
    metric = MeanAveragePrecision(device=device)
    ranges = {"detection_labels": (0, MAP_CLASSES - 1), "groundtruth_labels": (0, MAP_CLASSES - 1),
              "groundtruth_crowds": (0, 1)}

    st = _map_state(metric, device, blocks[rank])
    out["images"] = len(st["detection_scores"])
    coco_match.launches = 0
    coco_match.shapes.clear()
    dist.barrier()
    before = dict(COLLECTIVES)
    t0 = time.perf_counter()
    synced = sync_ragged_states(metric._reductions, st, value_ranges=ranges)
    out["map_sync_ms"] = (time.perf_counter() - t0) * 1e3
    out["map_collectives"] = {k: v - before.get(k, 0) for k, v in COLLECTIVES.items() if v - before.get(k, 0)}
    out["map_items"] = len(synced["detection_scores"])
    t0 = time.perf_counter()
    value = metric.compute_state(synced)
    torch.cuda.synchronize()
    out["map_compute_s"] = time.perf_counter() - t0
    out["launches"] = {"coco_match": coco_match.launches}
    out["shapes"] = [[list(shape), n] for shape, n in coco_match.shapes.items()]
    out["map"] = {k: float(v) for k, v in value.items() if v.numel() == 1 and k != "classes"}
    ref = _map_state(metric, device, range(n_batches))
    out["map_items_equal"] = all(
        len(synced[k]) == len(ref[k]) and all(torch.equal(a, b.cpu()) for a, b in zip(synced[k], ref[k]))
        for k in ref if k != "_n"
    )
    if rank == 0 and dist.get_backend() == _worlds()[0][0]:  # the single-process value, once, under the
        # profiler: the matcher's device time
        ref_values = []
        prof, out["map_ref_compute_s"] = _profiled(lambda: ref_values.append(metric.compute_state(ref)))
        ref_value = ref_values[-1]
        out["map_ref"] = {k: float(v) for k, v in ref_value.items() if v.numel() == 1 and k != "classes"}
        out["map_ref_device_s"] = _device_s(prof)
        out["map_ref_coco_match_s"] = _device_s(prof, "coco_match")
        out["map_ref_top_ops"] = _top_device_ops(prof)
        out["map_ref_coco_match_kernels"] = sum(
            1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA and "coco_match" in e.name
        )
    return out


def worker_main(args) -> int:
    """One rank of a phase-5, 6 or 18 world: ``--worker sync|ragged|engineering``."""
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    device = torch.device("cuda", args.rank if args.backend == "nccl" else 0)
    torch.cuda.set_device(device)
    dist.init_process_group(args.backend, init_method=args.init, rank=args.rank, world_size=args.world,
                            timeout=datetime.timedelta(seconds=WORLD_TIMEOUT_S - 60))
    try:
        if args.worker == "sync":
            result = worker_sync(args.rank, args.world, device)
        elif args.worker == "engineering":
            result = worker_engineering(args.rank, args.world, device)
        else:
            result = worker_ragged(args.rank, args.world, device)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(args.out, "w") as f:
        json.dump(result, f)
    return 0


def run_world(phase: str, backend: str, world: int) -> list:
    """Run ``world`` ranks of ``phase`` in processes of their own; their results in rank order."""
    tmp = tempfile.mkdtemp(prefix=f"chip_smoke_{phase}_{backend}_")
    procs = []
    for rank in range(world):
        cmd = [sys.executable, os.path.abspath(__file__), "--worker", phase, "--backend", backend,
               "--rank", str(rank), "--world", str(world), "--init", f"file://{tmp}/rendezvous",
               "--out", f"{tmp}/rank{rank}.json"]
        log = open(f"{tmp}/rank{rank}.log", "w")
        procs.append((subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT), log))
    deadline = time.monotonic() + WORLD_TIMEOUT_S
    failed = []
    try:
        for rank, (proc, _) in enumerate(procs):
            try:
                proc.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                failed.append(f"rank {rank} did not finish within {WORLD_TIMEOUT_S} s")
                break
            if proc.returncode:
                failed.append(f"rank {rank} exited {proc.returncode}")
    finally:
        for proc, log in procs:  # stop every rank, whatever happened
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    if failed:
        for rank in range(world):
            with open(f"{tmp}/rank{rank}.log") as f:
                print(f"--- {phase} {backend} rank {rank}:\n{f.read()[-3000:]}", file=sys.stderr)
        check(False, f"{phase} world ({backend} x{world}): " + "; ".join(failed))
    results = []
    for rank in range(world):
        with open(f"{tmp}/rank{rank}.json") as f:
            results.append(json.load(f))
    shutil.rmtree(tmp, ignore_errors=True)
    return results


def _worlds() -> list:
    """NCCL with one rank per card, and gloo with 4 ranks on card 0 (CUDA tensors)."""
    return [("nccl", torch.cuda.device_count()), ("gloo", 4)]


def phase_sync() -> dict:
    record = {}
    for backend, world in _worlds():
        results = run_world("sync", backend, world)
        label = f"{backend} x{world}"
        rows = [r["rows"] for r in results]
        check(sum(rows) == N_SAMPLES, f"[{label}] the ranks hold {rows} rows, not {N_SAMPLES} in all")
        check(results[-1]["rows"] % BATCH == N_SAMPLES % BATCH, f"[{label}] the 848-row batch is not on the last rank")
        first = results[0]
        for r in results:
            tag = f"[{label}] rank {r['rank']}"
            check(r["leaves_equal"], f"{tag}: the synced states differ from the single-process run")
            check(r["ap_rows"] == N_SAMPLES, f"{tag}: the AP cat state has {r['ap_rows']} rows")
            check(set(r["n"].values()) == {-(-N_SAMPLES // BATCH)}, f"{tag}: synced update counts {r['n']}")
            check(r["launches"]["binned_confmat_multiclass"] == r["batches"],
                  f"{tag}: binned_confmat_multiclass launched {r['launches']} times for {r['batches']} batches")
            for k, v in r["values"].items():
                check(math.isfinite(v), f"{tag}: {k} = {v}")
                tol = 1e-6 if k == "ap" else 0.0
                check(abs(v - r["ref_values"][k]) <= tol, f"{tag}: {k} {v} vs single-process {r['ref_values'][k]}")
                check(v == first["values"][k], f"{tag}: {k} differs from rank 0")
        for r in results:
            tag = f"[{label}] rank {r['rank']}, sketches"
            check(not r["sketch_unequal"], f"{tag}: synced leaves differ from the single-process run: "
                                           f"{r['sketch_unequal']}")
            check(r["sketch_collectives"] == {"all_reduce": len(r["sketch_buckets"]), "all_gather": 1},
                  f"{tag}: collectives {r['sketch_collectives']} for buckets {r['sketch_buckets']}")
            check(r["sketch_passthrough"] == ["corpus_sample"], f"{tag}: passthrough {r['sketch_passthrough']}")
            check(r["sketch_launches"]["quantile_hist"] > 0 and r["sketch_launches"]["hll_insert"] > 0,
                  f"{tag}: launches {r['sketch_launches']}")
            check(r["sketch_values"] == first["sketch_values"], f"{tag}: values differ from rank 0")
        print(f"[sync] {label}: sketches (a sketch-mode AUROC, a DistinctNGrams HyperLogLog and a BLEU reservoir of "
              f"{BLEU_SYNC_SAMPLE}): one coalesced plan, collectives {first['sketch_collectives']} for buckets "
              f"{first['sketch_buckets']} and the reservoir's fixed-shape gather; sync "
              f"{[round(r['sketch_sync_ms'], 3) for r in results]} ms; launches per rank "
              f"{[r['sketch_launches'] for r in results]}; every synced leaf equals the single-process state; values "
              f"{first['sketch_values']}")
        for r in results:
            tag = f"[{label}] rank {r['rank']}, second collection"
            check(all(r["col2_equal"].values()), f"{tag}: differs from the single-process run: {r['col2_equal']}")
            check(r["col2_cat_rows"] == N_SAMPLES and r["col2_pearson_n"] == N_SAMPLES, f"{tag}: rows")
        print(f"[sync] {label}: second collection (mean, sum, max, cat, R2, Pearson by its own sync): sync "
              f"{[round(r['col2_sync_ms'], 3) for r in results]} ms; values {first['col2_values']} equal the "
              f"single-process run on every rank (max and cat exactly, the rest within rtol {SYNC2_RTOL})")
        print(f"[sync] {label}: rows per rank {rows}; collectives {first['collectives']} "
              f"(one all_reduce a bucket: {first['bucket_bytes']} bytes; AP's cat leaves gathered: "
              f"{first['gathered_bytes']} bytes on every rank); sync {[round(r['sync_ms'], 3) for r in results]} ms, "
              f"updates {[round(r['update_s'], 4) for r in results]} s, compute {[round(r['compute_ms'], 3) for r in results]} ms; "
              f"values {first['values']} equal the single-process run")
        record[label] = results
    return record


def phase_ragged(chunk_shapes: collections.Counter) -> dict:
    record, reference = {}, None
    for backend, world in _worlds():
        results = run_world("ragged", backend, world)
        label = f"{backend} x{world}"
        first = results[0]
        reference = reference or first  # the first world's rank 0 ran the single-process compute
        n_batches = -(-MAP_IMAGES // MAP_BATCH)
        rouge_counts = [len(b) for b in _rank_blocks(ROUGE_PAIRS // ROUGE_BATCH, world, True)]
        for r in results:
            tag = f"[{label}] rank {r['rank']}"
            check(r["rouge_items"] == [ROUGE_BATCH] * sum(rouge_counts), f"{tag}: ROUGE items {r['rouge_items']}")
            check(r["rouge_items_equal"] and r["map_items_equal"], f"{tag}: synced items differ from the single process")
            for k, v in r["rouge"].items():
                check(abs(v - r["rouge_ref"][k]) <= 1e-6, f"{tag}: {k} {v} vs single-process {r['rouge_ref'][k]}")
            check(r["map_items"] == MAP_IMAGES, f"{tag}: {r['map_items']} images after the sync, expected {MAP_IMAGES}")
            check(r["map"] == first["map"], f"{tag}: mAP differs from rank 0")
            check(r["launches"]["coco_match"] > 0, f"{tag}: coco_match never launched")
            shapes = collections.Counter({tuple(shape): n for shape, n in r["shapes"]})
            check(shapes == chunk_shapes, f"{tag}: coco_match launched at {dict(shapes)}, phase 3 checked {dict(chunk_shapes)}")
        check(first["map"] == reference["map_ref"],
              f"[{label}] mAP {first['map']} vs single-process {reference['map_ref']}")
        check(0.0 < first["map"]["map"] < 1.0, f"[{label}] mAP {first['map']['map']}")
        images = [r["images"] for r in results]
        check(sum(images) == MAP_IMAGES and (world == 1 or len(set(images)) == world), f"[{label}] images per rank {images}")
        check(reference["map_ref_coco_match_kernels"] == sum(chunk_shapes.values()),
              f"[{label}] the profiler saw {reference['map_ref_coco_match_kernels']} coco_match kernels")
        profiled = (f"single process on rank 0 under the profiler: {first['map_ref_compute_s']:.3f} s, device "
                    f"{first['map_ref_device_s']:.6f} s, of which coco_match {first['map_ref_coco_match_s']:.6f} s in "
                    f"{first['map_ref_coco_match_kernels']} kernels; " if first is reference else "")
        print(f"[ragged] {label}: ROUGE updates per rank {rouge_counts}, sync {[round(r['rouge_sync_ms'], 3) for r in results]} ms, "
              f"{first['rouge']}; mAP images per rank {images} ({n_batches} batches of {MAP_BATCH}), sync "
              f"{[round(r['map_sync_ms'], 3) for r in results]} ms, collectives {first['map_collectives']}, compute "
              f"{[round(r['map_compute_s'], 3) for r in results]} s; coco_match launches "
              f"{[r['launches']['coco_match'] for r in results]} at the chunks phase 3 checked; {profiled}"
              f"map {first['map']['map']:.6f}, "
              f"map_50 {first['map']['map_50']:.6f}: equal to the single-process run")
        for name, sec, count in first.get("map_ref_top_ops", []):
            print(f"[ragged] {label}: single-process mAP compute, device operation {name}: {sec:.6f} s in {count}")
        record[label] = results
    return record


# ------------------------------------------------------ phase 7: the classification tower
SEG_IMAGES = 24  # of Cityscapes val's 500, cut for the run's time
COCO_ML_IMAGES, COCO_ML_LABELS, COCO_ML_BATCH = 40_504, 80, 256  # MS-COCO 2014 val, its 80 labels
CPU_RERUN_BATCHES = 4


def _grouped(make, first_batch):
    """``make(device, compute_groups)`` built twice on the card: once with automatic
    compute groups, updated with the first batch to form them, then with those groups
    given, so that every batch, the first too, runs one update a group."""
    probe = make("cuda", True)
    probe.update(*first_batch)
    groups = [list(members) for members in probe.compute_groups.values()]
    return make("cuda", groups), groups


def _states_of(collection, extra=()) -> dict:
    """Copies of every leaf of every member's state (and of ``extra`` metrics')."""
    out = {}
    for name, metric in list(collection.items(keep_base=True)) + list(extra):
        for leaf, value in metric.metric_state.items():
            out[f"{name}.{leaf}"] = tuple(v.clone() for v in value) if isinstance(value, tuple) else value.clone()
    return out


def _check_cpu_rerun(leg: str, card: dict, cpu: dict) -> int:
    """The card's integer states after the first batches equal the CPU path's; returns the leaves compared."""
    check(card.keys() == cpu.keys(), f"[tower {leg}] leaves {sorted(card)} vs {sorted(cpu)}")
    compared = 0
    for key, want in cpu.items():
        got = card[key]
        pairs = zip(got, want) if isinstance(want, tuple) else [(got, want)]
        for g, w in pairs:
            check(g.dtype == w.dtype, f"[tower {leg}] {key} dtype {g.dtype} vs {w.dtype}")
            if w.dtype == torch.int32:
                check(torch.equal(g.cpu(), w), f"[tower {leg}] {key} differs between the card and the CPU")
                compared += 1
    return compared


def _run_leg(leg, make, batches, extra=None):
    """Drive ``batches()`` (a generator of card batches) through the grouped collection
    (and ``extra``, a metric outside it); the first batches again on the CPU path."""
    from torchmetrics_tpu_torch.kernels.confmat import confmat_multiclass

    batch_iter = batches()
    first = next(batch_iter)
    col, groups = _grouped(make, first)
    extra_card = extra("cuda") if extra else None
    times, extra_times, early = [], [], None
    confmat_multiclass.launches = 0
    torch.cuda.synchronize()
    t_leg = time.perf_counter()
    for i, batch in enumerate(b for it in ([first], batch_iter) for b in it):
        t0 = time.perf_counter()
        col.update(*batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if extra_card is not None:
            t0 = time.perf_counter()
            extra_card.update(*batch)
            torch.cuda.synchronize()
            extra_times.append((time.perf_counter() - t0) * 1e3)
        if i + 1 == CPU_RERUN_BATCHES:
            early = _states_of(col, [("extra", extra_card.metric_b)] if extra_card is not None else [])
    n_batches = i + 1
    values = col.compute()
    extra_value = extra_card.compute() if extra_card is not None else None
    torch.cuda.synchronize()
    leg_s = time.perf_counter() - t_leg
    launches = confmat_multiclass.launches

    cpu_col = make("cpu", groups)
    cpu_extra = extra("cpu") if extra else None
    for batch in (b for _, b in zip(range(CPU_RERUN_BATCHES), batches())):
        cpu_batch = [x.cpu() for x in batch]
        cpu_col.update(*cpu_batch)
        if cpu_extra is not None:
            cpu_extra.update(*cpu_batch)
    compared = _check_cpu_rerun(leg, early, _states_of(cpu_col, [("extra", cpu_extra.metric_b)] if cpu_extra else []))
    return {
        "batches": n_batches, "groups": groups, "launches": launches, "leg_s": leg_s,
        "update_ms_median": statistics.median(times),
        "extra_update_ms_median": statistics.median(extra_times) if extra_times else None,
        "values": {k: v.tolist() if v.numel() <= 4 else f"{tuple(v.shape)} {str(v.dtype)[6:]}" for k, v in values.items()},
        "tensors": values, "extra_value": None if extra_value is None else float(extra_value),
        "cpu_leaves_equal": compared,
    }


def _tower_imagenet(device, compute_groups):
    from torchmetrics_tpu_torch import classification as tc
    from torchmetrics_tpu_torch.collections import MetricCollection

    kw = {"num_classes": N_CLASSES, "device": device}
    return MetricCollection({
        "confmat": tc.MulticlassConfusionMatrix(**kw), "kappa": tc.MulticlassCohenKappa(**kw),
        "mcc": tc.MulticlassMatthewsCorrCoef(**kw), "jaccard": tc.MulticlassJaccardIndex(average="macro", **kw),
        "precision": tc.MulticlassPrecision(average="macro", **kw), "recall": tc.MulticlassRecall(average="macro", **kw),
        "specificity": tc.MulticlassSpecificity(average="macro", **kw),
    }, compute_groups=compute_groups)


def _top1_error(device):
    from torchmetrics_tpu_torch.classification import MulticlassAccuracy

    return 1 - MulticlassAccuracy(num_classes=N_CLASSES, average="micro", device=device)


def _tower_cityscapes(device, compute_groups):
    from torchmetrics_tpu_torch import classification as tc
    from torchmetrics_tpu_torch.collections import MetricCollection

    kw = {"num_classes": SEG_SHAPE[1], "ignore_index": SEG_IGNORE, "device": device}
    return MetricCollection({"miou": tc.MulticlassJaccardIndex(**kw), "confmat": tc.MulticlassConfusionMatrix(**kw)},
                            compute_groups=compute_groups)


def _tower_coco(device, compute_groups):
    from torchmetrics_tpu_torch import classification as tc
    from torchmetrics_tpu_torch.collections import MetricCollection

    kw = {"num_labels": COCO_ML_LABELS, "device": device}
    return MetricCollection({
        "accuracy": tc.MultilabelAccuracy(**kw), "f1": tc.MultilabelF1Score(average="macro", **kw),
        "precision": tc.MultilabelPrecision(**kw), "recall": tc.MultilabelRecall(**kw),
        "hamming": tc.MultilabelHammingDistance(**kw), "confmat": tc.MultilabelConfusionMatrix(**kw),
        "jaccard": tc.MultilabelJaccardIndex(**kw), "mcc": tc.MultilabelMatthewsCorrCoef(**kw),
    }, compute_groups=compute_groups)


def _tower_binary(device, compute_groups):
    from torchmetrics_tpu_torch import classification as tc
    from torchmetrics_tpu_torch.collections import MetricCollection

    return MetricCollection({
        "accuracy": tc.BinaryAccuracy(device=device), "f1": tc.BinaryF1Score(device=device),
        "kappa": tc.BinaryCohenKappa(device=device), "jaccard": tc.BinaryJaccardIndex(device=device),
        "confmat": tc.BinaryConfusionMatrix(device=device),
    }, compute_groups=compute_groups)


def _coco_multilabel_data(gen: torch.Generator):
    """MS-COCO 2014 val's shape: 40,504 images x 80 labels, about 2.9 labels an
    image; sigmoid scores of a classifier that separates them, on the card."""
    dev = torch.device("cuda")
    target = (torch.rand((COCO_ML_IMAGES, COCO_ML_LABELS), generator=gen, device=dev) < 2.9 / COCO_ML_LABELS)
    logits = 1.5 * torch.randn((COCO_ML_IMAGES, COCO_ML_LABELS), generator=gen, device=dev) + 4.0 * target - 2.0
    return torch.sigmoid(logits), target.to(torch.int32)


def phase_tower() -> dict:
    """Phase 7: the classification tower on one card, no sync. (i) the ImageNet-1k set
    through the confusion-matrix family and the stat scores, and the top-1 error
    composite; (ii) Cityscapes-shaped segmentation; (iii) COCO-shaped multilabel;
    (iv) binary selective prediction over (i)'s scores."""
    from torchmetrics_tpu_torch.kernels.confmat import confmat_multiclass

    record = {}
    probs, target, _, _ = _main_path_data(torch.Generator(device="cuda").manual_seed(SEED))
    imagenet = lambda: ((probs[s:s + BATCH], target[s:s + BATCH]) for s in range(0, N_SAMPLES, BATCH))  # noqa: E731
    leg = _run_leg("imagenet", _tower_imagenet, imagenet, extra=_top1_error)
    n = leg["batches"]
    grouped = next(g for g in leg["groups"] if "confmat" in g)
    check(sorted(grouped)[:4] == ["confmat", "jaccard", "kappa", "mcc"] and len(grouped) == 4,
          f"[tower imagenet] the confusion-matrix metrics did not merge into one group: {leg['groups']}")
    check(leg["launches"] == n == -(-N_SAMPLES // BATCH),
          f"[tower imagenet] confmat_multiclass launched {leg['launches']} times for {n} batches")
    confmat = leg["tensors"]["confmat"]
    check(int(confmat.sum()) == N_SAMPLES and confmat.dtype == torch.int32, "[tower imagenet] confmat counts")
    top1 = 1.0 - float(confmat.diagonal().sum()) / N_SAMPLES
    check(abs(leg["extra_value"] - top1) <= 1e-6, f"[tower imagenet] top-1 error {leg['extra_value']} vs {top1}")
    for k in ("kappa", "mcc", "jaccard", "precision", "recall", "specificity"):
        v = leg["tensors"][k]
        check(v.shape == () and bool(torch.isfinite(v)) and 0.0 < float(v) <= 1.0, f"[tower imagenet] {k} = {v}")
    record["imagenet"] = leg
    del probs, target

    def cityscapes():
        gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
        return (_seg_batch(gen) for _ in range(SEG_IMAGES // SEG_SHAPE[0]))

    leg = _run_leg("cityscapes", _tower_cityscapes, cityscapes)
    check(leg["groups"] == [["miou", "confmat"]] or leg["groups"] == [["confmat", "miou"]],
          f"[tower cityscapes] groups {leg['groups']}")
    check(leg["launches"] == leg["batches"] == SEG_IMAGES // SEG_SHAPE[0],
          f"[tower cityscapes] confmat_multiclass launched {leg['launches']} times for {leg['batches']} batches")
    pixels = int(leg["tensors"]["confmat"].sum())
    total = SEG_IMAGES * SEG_SHAPE[2] * SEG_SHAPE[3]
    check(0.93 * total < pixels < 0.97 * total, f"[tower cityscapes] {pixels} of {total} pixels counted (~5 % void)")
    check(0.0 < float(leg["tensors"]["miou"]) < 1.0, f"[tower cityscapes] mIoU {leg['tensors']['miou']}")
    record["cityscapes"] = leg

    scores, labels = _coco_multilabel_data(torch.Generator(device="cuda").manual_seed(SEED + 6))
    coco = lambda: ((scores[s:s + COCO_ML_BATCH], labels[s:s + COCO_ML_BATCH])  # noqa: E731
                    for s in range(0, COCO_ML_IMAGES, COCO_ML_BATCH))
    leg = _run_leg("coco", _tower_coco, coco)
    check(leg["launches"] == 0, "[tower coco] the multilabel path launched confmat_multiclass")
    check(int(leg["tensors"]["confmat"].sum()) == COCO_ML_IMAGES * COCO_ML_LABELS, "[tower coco] confmat counts")
    for k, v in leg["tensors"].items():
        check(bool(torch.isfinite(v.float()).all()), f"[tower coco] {k} = {v}")
    record["coco"] = leg
    del scores, labels

    probs, target, _, _ = _main_path_data(torch.Generator(device="cuda").manual_seed(SEED))
    conf, pred = probs.max(1)
    correct = (pred == target).to(torch.int32)
    del probs
    binary = lambda: ((conf[s:s + BATCH], correct[s:s + BATCH]) for s in range(0, N_SAMPLES, BATCH))  # noqa: E731
    leg = _run_leg("binary", _tower_binary, binary)
    check(leg["launches"] == 0, "[tower binary] the binary path launched confmat_multiclass")
    cm = leg["tensors"]["confmat"]
    check(int(cm.sum()) == N_SAMPLES and int(cm[1].sum()) == int(correct.sum()), "[tower binary] confmat counts")
    record["binary"] = leg

    for name, leg in record.items():
        extra = "" if leg["extra_update_ms_median"] is None else \
            f"; top1_error = 1 - MulticlassAccuracy: update median {leg['extra_update_ms_median']:.4f} ms, " \
            f"value {leg['extra_value']:.6f}"
        print(f"[tower] {name}: {leg['batches']} batches in {leg['leg_s']:.3f} s; compute groups {leg['groups']}; "
              f"collection update median {leg['update_ms_median']:.4f} ms (host clock, a synchronize after each "
              f"update){extra}; confmat_multiclass launches {leg['launches']}; first {CPU_RERUN_BATCHES} batches "
              f"equal on the CPU path ({leg['cpu_leaves_equal']} int32 leaves); values {leg['values']}")
        del leg["tensors"]
    print(f"[tower] cityscapes: {SEG_IMAGES} images of the val set's 500 (cut for the run's time), "
          f"{SEG_IMAGES // SEG_SHAPE[0]} batches of {SEG_SHAPE}")
    return record


# ------------------------------------ phase 8: the curve family, aggregation and regression
DEPTH_MAPS, DEPTH_HW, DEPTH_BATCH = 654, (480, 640), 8  # NYU Depth V2's labelled test split: 654 maps of 480 x 640
OTHER_ROWS, OTHER_BATCH = 10_000, 2_500
# float states and values, the card against the CPU path (sums of up to ~10 M float32 terms in another order)
FLOAT_RTOL, FLOAT_ATOL = 1e-4, 1e-5


def _copy(value):
    if isinstance(value, dict):
        return {k: _copy(v) for k, v in value.items()}
    if isinstance(value, (tuple, list)):
        return type(value)(_copy(v) for v in value)
    return value.clone()


def _snapshot(col) -> dict:
    """Copies of every member's state."""
    return {name: _copy(m.metric_state) for name, m in col.items(keep_base=True)}


def _cpu(x):
    return x.cpu() if isinstance(x, torch.Tensor) else x


def _assert_same(tag: str, got, want, rtol: float = FLOAT_RTOL, atol: float = FLOAT_ATOL) -> int:
    """``got`` (the card) against ``want`` (the CPU path): integer tensors equal, float ones
    within ``rtol`` / ``atol`` (NaNs in place); returns the tensors compared."""
    if isinstance(want, dict):
        check(set(got) == set(want), f"{tag}: keys {sorted(got)} vs {sorted(want)}")
        return sum(_assert_same(f"{tag}.{k}", got[k], want[k], rtol, atol) for k in want)
    if isinstance(want, (tuple, list)):
        check(len(got) == len(want), f"{tag}: {len(got)} items vs {len(want)}")
        return sum(_assert_same(f"{tag}[{i}]", g, w, rtol, atol) for i, (g, w) in enumerate(zip(got, want)))
    got = got.cpu()
    check(got.dtype == want.dtype and got.shape == want.shape,
          f"{tag}: {got.dtype} {tuple(got.shape)} vs {want.dtype} {tuple(want.shape)}")
    if not want.dtype.is_floating_point:
        check(torch.equal(got, want), f"{tag} differs between the card and the CPU")
    else:
        try:
            torch.testing.assert_close(got, want, rtol=rtol, atol=atol, equal_nan=True)
        except AssertionError as err:
            check(False, f"{tag}: card and CPU differ: {err}")
    return 1


def _value_summary(value):
    if isinstance(value, (tuple, list)):
        return [_value_summary(v) for v in value[:3]] + ([f"... {len(value)} items"] if len(value) > 3 else [])
    return value.tolist() if value.numel() <= 4 else f"{tuple(value.shape)} {str(value.dtype)[6:]}"


def _curve_leg(leg, make, batches, kernels, rtol: float = FLOAT_RTOL, atol: float = FLOAT_ATOL,
               state_checks=None, cpu_batches: int = CPU_RERUN_BATCHES, value_checks=None) -> dict:
    """Drive ``batches()`` (``(args, kwargs)`` of card tensors) through ``make("cuda", groups)``,
    the compute groups formed on the first batch by a probe collection, so that every batch
    runs one update a group; the launches of ``kernels`` are counted from 0 over this run
    only. The first batches run again on the CPU path: the states and the values after them
    must match. ``state_checks`` (``{member name prefix: check(tag, card state, CPU state)}``)
    holds those members' states instead, and their values against the CPU path's compute of
    the card's state. ``cpu_batches`` is how many batches run again on the CPU."""
    batch_iter = batches()
    first = next(batch_iter)
    probe = make("cuda", True)
    probe.update(*first[0], **first[1])
    groups = [list(members) for members in probe.compute_groups.values()]
    del probe
    col = make("cuda", groups)
    times, early = [], None
    for kernel in kernels:
        kernel.launches = 0
    torch.cuda.synchronize()
    t_leg = time.perf_counter()
    for i, (args, kwargs) in enumerate(b for it in ([first], batch_iter) for b in it):
        t0 = time.perf_counter()
        col.update(*args, **kwargs)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if i + 1 == cpu_batches:
            early = _snapshot(col)
    t0 = time.perf_counter()
    values = col.compute()
    torch.cuda.synchronize()
    compute_ms = (time.perf_counter() - t0) * 1e3
    leg_s = time.perf_counter() - t_leg
    launches = {k.__name__: k.launches for k in kernels}

    t_cpu = time.perf_counter()
    cpu_col = make("cpu", groups)
    for args, kwargs in (b for _, b in zip(range(cpu_batches), batches())):
        cpu_col.update(*map(_cpu, args), **{k: _cpu(v) for k, v in kwargs.items()})
    cpu_states = _snapshot(cpu_col)
    cpu_values = {name: m.compute() for name, m in cpu_col.items(keep_base=True)}
    compared = 0
    for name in early:
        tag = f"[{leg}] {name} after {cpu_batches} batches"
        state_check = next((v for k, v in (state_checks or {}).items() if name.startswith(k)), None)
        if state_check is None:
            compared += _assert_same(f"{tag}: state", early[name], cpu_states[name], rtol, atol)
            want = cpu_values[name]
        else:
            state_check(f"{tag}: state", early[name], cpu_states[name])
            compared += len(early[name])
            want = cpu_col[name].compute_state({k: _cpu(v) for k, v in early[name].items()})
        got = col[name].compute_state(early[name])
        if name in (value_checks or {}):
            value_checks[name](f"{tag}: value", got, want, early[name])
            compared += 1
        else:
            compared += _assert_same(f"{tag}: value", got, want, rtol, atol)
    return {
        "batches": i + 1, "groups": groups, "launches": launches, "leg_s": leg_s,
        "update_ms_median": statistics.median(times), "compute_ms": compute_ms,
        "values": {k: _value_summary(v) for k, v in values.items()}, "tensors": values, "cpu_compared": compared,
        "cpu_rerun_s": time.perf_counter() - t_cpu,
    }


def _curves_imagenet(device, compute_groups):
    from torchmetrics_tpu_torch import classification as tc
    from torchmetrics_tpu_torch.collections import MetricCollection

    kw = {"num_classes": N_CLASSES, "thresholds": None, "device": device}
    return MetricCollection({"auroc": tc.MulticlassAUROC(average="macro", **kw), "roc": tc.MulticlassROC(**kw)},
                            compute_groups=compute_groups)


def _curves_coco(device, compute_groups):
    from torchmetrics_tpu_torch import classification as tc
    from torchmetrics_tpu_torch.collections import MetricCollection

    kw = {"num_labels": COCO_ML_LABELS, "device": device}
    return MetricCollection({
        "auroc": tc.MultilabelAUROC(thresholds=ML_THRESHOLDS, **kw),
        "ap": tc.MultilabelAveragePrecision(thresholds=ML_THRESHOLDS, **kw),
        "prc": tc.MultilabelPrecisionRecallCurve(thresholds=ML_THRESHOLDS, **kw),
        "ap_exact": tc.MultilabelAveragePrecision(thresholds=None, **kw),
    }, compute_groups=compute_groups)


def _curves_binary(device, compute_groups):
    from torchmetrics_tpu_torch import classification as tc
    from torchmetrics_tpu_torch.collections import MetricCollection

    return MetricCollection({
        "auroc": tc.BinaryAUROC(thresholds=None, device=device),
        "auroc_fpr05": tc.BinaryAUROC(thresholds=None, max_fpr=0.05, device=device),
        "auroc_200": tc.BinaryAUROC(thresholds=BIN_THRESHOLDS, device=device),
        "ap": tc.BinaryAveragePrecision(thresholds=None, device=device),
        "roc": tc.BinaryROC(thresholds=None, device=device),
    }, compute_groups=compute_groups)


def _curves_depth(device, compute_groups):
    from torchmetrics_tpu_torch import aggregation as agg, regression as reg
    from torchmetrics_tpu_torch.collections import MetricCollection

    return MetricCollection({
        "mae": reg.MeanAbsoluteError(device=device), "rmse": reg.MeanSquaredError(squared=False, device=device),
        "msle": reg.MeanSquaredLogError(device=device), "mape": reg.MeanAbsolutePercentageError(device=device),
        "r2": reg.R2Score(device=device), "explained_variance": reg.ExplainedVariance(device=device),
        "pearson": reg.PearsonCorrCoef(device=device),
        "loss_mean": agg.MeanMetric(device=device), "loss_max": agg.MaxMetric(device=device),
        "loss_running": agg.RunningMean(window=10, device=device),
    }, compute_groups=compute_groups)


def _depth_data(gen: torch.Generator):
    """NYU Depth V2's labelled test split's shape on the card: 654 float32 depth maps of
    480 x 640, seeded in 0.5-10 m, and predictions with ~10 % relative and 5 cm absolute
    seeded error (at least 1 cm)."""
    dev = torch.device("cuda")
    target = 0.5 + 9.5 * torch.rand((DEPTH_MAPS, *DEPTH_HW), generator=gen, device=dev)
    noise = torch.randn((DEPTH_MAPS, *DEPTH_HW), generator=gen, device=dev)
    preds = target * (1.0 + 0.1 * noise)
    noise.normal_(generator=gen)
    preds = torch.clamp(preds + 0.05 * noise, min=0.01)
    del noise
    return preds, target


def _other_metrics(device) -> dict:
    """Every other new class of the slice: ``{name: (metric, input kind)}``."""
    from torchmetrics_tpu_torch import aggregation as agg, regression as reg

    kw = {"device": device}
    return {
        "sum": (agg.SumMetric(**kw), "value"), "min": (agg.MinMetric(**kw), "value"),
        "cat": (agg.CatMetric(**kw), "value"), "running_sum": (agg.RunningSum(window=3, **kw), "value"),
        "concordance": (reg.ConcordanceCorrCoef(**kw), "pair"), "spearman": (reg.SpearmanCorrCoef(**kw), "pair"),
        "kendall": (reg.KendallRankCorrCoef(**kw), "pair"),
        "smape": (reg.SymmetricMeanAbsolutePercentageError(**kw), "pair"),
        "wmape": (reg.WeightedMeanAbsolutePercentageError(**kw), "pair"),
        "log_cosh": (reg.LogCoshError(**kw), "pair"), "minkowski": (reg.MinkowskiDistance(p=3.0, **kw), "pair"),
        "tweedie": (reg.TweedieDevianceScore(power=1.5, **kw), "positive"),
        "csi": (reg.CriticalSuccessIndex(threshold=0.5, **kw), "pair"),
        "rse": (reg.RelativeSquaredError(**kw), "pair"), "kl": (reg.KLDivergence(**kw), "distribution"),
        "cosine": (reg.CosineSimilarity(reduction="mean", **kw), "vectors"),
    }


def _other_data(gen: torch.Generator) -> dict:
    dev = torch.device("cuda")
    x = torch.randn((OTHER_ROWS,), generator=gen, device=dev)
    y = x + 0.3 * torch.randn((OTHER_ROWS,), generator=gen, device=dev)
    v = torch.randn((OTHER_ROWS, 8), generator=gen, device=dev)
    return {
        "value": (10.0 * x,), "pair": (x, y), "positive": (x.abs() + 0.1, y.abs() + 0.1),
        "distribution": (torch.softmax(v, 1), torch.softmax(v + 0.5 * torch.randn_like(v), 1)),
        "vectors": (v, v + 0.3 * torch.randn((OTHER_ROWS, 8), generator=gen, device=dev)),
    }


def phase_curves() -> dict:
    """Phase 8 on one card, no sync: (i) the exact multiclass AUROC and ROC over the
    ImageNet-1k set; (ii) the COCO-shaped multilabel curves, binned and exact; (iii) the
    binary curves over the selective-prediction rows; (iv) dense depth regression with
    the loss aggregators; then every other new class over a 10,000-row set."""
    from torchmetrics_tpu_torch.kernels.binned_confmat import binned_confmat_multiclass
    from torchmetrics_tpu_torch.kernels.binned_multilabel import binned_confmat_multilabel

    kernels = (binned_confmat_multiclass, binned_confmat_multilabel)
    n_batches = -(-N_SAMPLES // BATCH)
    record = {}
    probs, target, _, _ = _main_path_data(torch.Generator(device="cuda").manual_seed(SEED))
    imagenet = lambda: (((probs[s:s + BATCH], target[s:s + BATCH]), {}) for s in range(0, N_SAMPLES, BATCH))  # noqa: E731
    leg = _curve_leg("imagenet", _curves_imagenet, imagenet, kernels)
    check(leg["groups"] in ([["auroc", "roc"]], [["roc", "auroc"]]), f"[curves imagenet] groups {leg['groups']}")
    check(leg["launches"] == {"binned_confmat_multiclass": 0, "binned_confmat_multilabel": 0},
          f"[curves imagenet] the exact path launched {leg['launches']}")
    auroc, (fprs, tprs, thrs) = leg["tensors"]["auroc"], leg["tensors"]["roc"]
    check(auroc.shape == () and 0.5 < float(auroc) < 1.0, f"[curves imagenet] AUROC {auroc}")
    check(len(fprs) == len(tprs) == len(thrs) == N_CLASSES, "[curves imagenet] ROC curves a class")
    check(all(f.shape == (N_SAMPLES + 1,) and float(f[-1]) == 1.0 and float(t[-1]) == 1.0 for f, t in zip(fprs, tprs)),
          "[curves imagenet] every ROC curve runs from (0, 0) to (1, 1) over 50,001 points")
    record["imagenet"] = leg
    del imagenet

    scores, labels = _coco_multilabel_data(torch.Generator(device="cuda").manual_seed(SEED + 6))
    coco = lambda: (((scores[s:s + COCO_ML_BATCH], labels[s:s + COCO_ML_BATCH]), {})  # noqa: E731
                    for s in range(0, COCO_ML_IMAGES, COCO_ML_BATCH))
    leg = _curve_leg("coco", _curves_coco, coco, kernels)
    coco_batches = -(-COCO_ML_IMAGES // COCO_ML_BATCH)
    check(sorted(map(sorted, leg["groups"])) == [["ap", "auroc", "prc"], ["ap_exact"]], f"[curves coco] groups {leg['groups']}")
    check(leg["launches"] == {"binned_confmat_multiclass": 0, "binned_confmat_multilabel": coco_batches},
          f"[curves coco] launches {leg['launches']}, expected {coco_batches} binned_confmat_multilabel")
    for k in ("auroc", "ap", "ap_exact"):
        v = leg["tensors"][k]
        check(v.shape == () and 0.5 < float(v) <= 1.0, f"[curves coco] {k} = {v}")
    check(abs(float(leg["tensors"]["ap"]) - float(leg["tensors"]["ap_exact"])) < 0.03,
          f"[curves coco] binned AP {leg['tensors']['ap']} far from the exact {leg['tensors']['ap_exact']}")
    check(leg["tensors"]["prc"][0].shape == (COCO_ML_LABELS, ML_THRESHOLDS + 1), "[curves coco] PR curve shape")
    record["coco"] = leg
    del scores, labels, coco

    conf, pred = probs.max(1)
    correct = (pred == target).to(torch.int32)
    del probs, target
    binary = lambda: (((conf[s:s + BATCH], correct[s:s + BATCH]), {}) for s in range(0, N_SAMPLES, BATCH))  # noqa: E731
    leg = _curve_leg("binary", _curves_binary, binary, kernels)
    check(sorted(map(sorted, leg["groups"])) == [["ap", "auroc", "auroc_fpr05", "roc"], ["auroc_200"]],
          f"[curves binary] groups {leg['groups']}")
    check(leg["launches"] == {"binned_confmat_multiclass": 0, "binned_confmat_multilabel": n_batches},
          f"[curves binary] launches {leg['launches']}, expected {n_batches} binned_confmat_multilabel")
    t = leg["tensors"]
    check(abs(float(t["auroc"]) - float(t["auroc_200"])) < 0.03, f"[curves binary] AUROC {t['auroc']} vs binned {t['auroc_200']}")
    check(0.5 <= float(t["auroc_fpr05"]) <= 1.0, f"[curves binary] partial AUROC {t['auroc_fpr05']}")
    check(t["roc"][0].shape == (N_SAMPLES + 1,), "[curves binary] ROC points")
    record["binary"] = leg
    del conf, correct, binary

    preds, depth = _depth_data(torch.Generator(device="cuda").manual_seed(SEED + 8))

    def depth_batches():
        for s in range(0, DEPTH_MAPS, DEPTH_BATCH):
            p, t = preds[s:s + DEPTH_BATCH], depth[s:s + DEPTH_BATCH]
            loss = (p - t).abs().mean()  # the eval loop's per-batch L1 loss
            yield (), {"preds": p.reshape(-1), "target": t.reshape(-1), "value": loss}

    leg = _curve_leg("depth", _curves_depth, depth_batches, kernels)
    check(leg["launches"] == {"binned_confmat_multiclass": 0, "binned_confmat_multilabel": 0},
          f"[curves depth] launches {leg['launches']}")
    check(leg["batches"] == -(-DEPTH_MAPS // DEPTH_BATCH), f"[curves depth] {leg['batches']} batches")
    losses = torch.stack([kw["value"] for _, kw in depth_batches()])
    t = leg["tensors"]
    check(abs(float(t["loss_mean"]) - float(losses.mean())) <= 1e-5 * float(losses.mean()), "[curves depth] mean loss")
    check(float(t["loss_max"]) == float(losses.max()), "[curves depth] max loss")
    check(abs(float(t["loss_running"]) - float(losses[-10:].mean())) <= 1e-5 * float(losses.mean()),
          "[curves depth] running mean of the last 10 losses")
    check(0.0 < float(t["r2"]) < 1.0 and 0.0 < float(t["pearson"]) < 1.0, f"[curves depth] R2 {t['r2']}, r {t['pearson']}")
    for k, v in t.items():
        check(bool(torch.isfinite(v).all()), f"[curves depth] {k} = {v}")
    record["depth"] = leg
    del preds, depth

    # every other new class: the card against the CPU path over one seeded set
    data = _other_data(torch.Generator(device="cuda").manual_seed(SEED + 9))
    card, cpu = _other_metrics("cuda"), _other_metrics("cpu")
    others, t0 = {}, time.perf_counter()
    for name, (metric, kind) in card.items():
        for s in range(0, OTHER_ROWS, OTHER_BATCH):
            args = [x[s:s + OTHER_BATCH] for x in data[kind]]
            metric.update(*args)
            cpu[name][0].update(*(a.cpu() for a in args))
        value = metric.compute()
        _assert_same(f"[curves others] {name}", value, cpu[name][0].compute())
        _assert_same(f"[curves others] {name} state", metric.metric_state, cpu[name][0].metric_state)
        others[name] = _value_summary(value)
    record["others"] = {"values": others, "s": time.perf_counter() - t0}

    for name, leg in record.items():
        if name == "others":
            continue
        print(f"[curves] {name}: {leg['batches']} batches in {leg['leg_s']:.3f} s; compute groups {leg['groups']}; "
              f"collection update median {leg['update_ms_median']:.4f} ms (host clock, a synchronize after each), "
              f"compute {leg['compute_ms']:.4f} ms; launches {leg['launches']}; first {CPU_RERUN_BATCHES} batches "
              f"match the CPU path ({leg['cpu_compared']} tensors: integers equal, floats within rtol {FLOAT_RTOL}, "
              f"atol {FLOAT_ATOL}); values {leg['values']}")
        del leg["tensors"]
    print(f"[curves] others: {len(others)} classes over {OTHER_ROWS} seeded rows on the card equal the CPU path "
          f"(rtol {FLOAT_RTOL}, atol {FLOAT_ATOL}) in {record['others']['s']:.2f} s: {others}")
    return record


# ------------------------------------------ phase 9: the rest of classification
CELEBA_ROWS = 19_962  # the CelebA test split
# the card against the CPU path: float states and values within 1e-5 relative
REST_RTOL, REST_ATOL = 1e-5, 1e-6


def _rest_imagenet(device, compute_groups):
    from torchmetrics_tpu_torch import classification as tc
    from torchmetrics_tpu_torch.collections import MetricCollection

    kw = {"num_classes": N_CLASSES, "device": device}
    return MetricCollection({
        "ece_l1": tc.MulticlassCalibrationError(n_bins=CE_BINS, norm="l1", **kw),
        "ece_l2": tc.MulticlassCalibrationError(n_bins=CE_BINS, norm="l2", **kw),
        "ece_max": tc.MulticlassCalibrationError(n_bins=CE_BINS, norm="max", **kw),
        "hinge_cs": tc.MulticlassHingeLoss(multiclass_mode="crammer-singer", **kw),
        "hinge_ova": tc.MulticlassHingeLoss(multiclass_mode="one-vs-all", **kw),
        "exact": tc.MulticlassExactMatch(**kw),
        "dice": tc.Dice(**kw),
        "recall_at_p50": tc.MulticlassRecallAtFixedPrecision(min_value=0.5, thresholds=20, **kw),
    }, compute_groups=compute_groups)


def _rest_coco(device, compute_groups):
    from torchmetrics_tpu_torch import classification as tc
    from torchmetrics_tpu_torch.collections import MetricCollection

    kw = {"num_labels": COCO_ML_LABELS, "device": device}
    return MetricCollection({
        "coverage": tc.MultilabelCoverageError(**kw), "lrap": tc.MultilabelRankingAveragePrecision(**kw),
        "ranking_loss": tc.MultilabelRankingLoss(**kw), "exact": tc.MultilabelExactMatch(**kw),
        "recall_at_p50": tc.MultilabelRecallAtFixedPrecision(min_value=0.5, thresholds=ML_THRESHOLDS, **kw),
        "precision_at_r50": tc.MultilabelPrecisionAtFixedRecall(min_value=0.5, thresholds=ML_THRESHOLDS, **kw),
    }, compute_groups=compute_groups)


def _rest_binary(device, compute_groups):
    from torchmetrics_tpu_torch import classification as tc
    from torchmetrics_tpu_torch.collections import MetricCollection

    return MetricCollection({
        "ece": tc.BinaryCalibrationError(n_bins=CE_BINS, device=device),
        "hinge": tc.BinaryHingeLoss(device=device), "hinge_sq": tc.BinaryHingeLoss(squared=True, device=device),
        "sens_at_spec90": tc.BinarySensitivityAtSpecificity(min_value=0.9, device=device),
        "spec_at_sens90": tc.BinarySpecificityAtSensitivity(min_value=0.9, thresholds=BIN_THRESHOLDS,
                                                            device=device),
    }, compute_groups=compute_groups)


def _rest_fairness(device, compute_groups):
    from torchmetrics_tpu_torch import classification as tc
    from torchmetrics_tpu_torch.collections import MetricCollection

    return MetricCollection({
        "fairness": tc.BinaryFairness(num_groups=2, task="all", device=device),
        "group_rates": tc.BinaryGroupStatRates(num_groups=2, device=device),
    }, compute_groups=compute_groups)


def _celeba_data(gen: torch.Generator):
    """The CelebA test split's shape: 19,962 rows of an attribute classifier's score, the
    binary attribute and a binary group (a second attribute, ~42 % of rows), with the
    score drawn a little higher in group 1, on the card."""
    dev = torch.device("cuda")
    groups = (torch.rand((CELEBA_ROWS,), generator=gen, device=dev) < 0.42).to(torch.int32)
    target = (torch.rand((CELEBA_ROWS,), generator=gen, device=dev) < 0.3 + 0.1 * groups).to(torch.int32)
    logits = 1.5 * torch.randn((CELEBA_ROWS,), generator=gen, device=dev) + 2.5 * target - 1.5 + 0.3 * groups
    return torch.sigmoid(logits), target, groups


def phase_rest() -> dict:
    """Phase 9 on one card, no sync: (i) the ImageNet-1k set, as probabilities and as their
    logits, through calibration, hinge, exact match, Dice and recall at fixed precision;
    (ii) the COCO-shaped multilabel set through the ranking metrics, exact match and two
    fixed operating points; (iii) the binary rows through calibration, hinge and two fixed
    operating points; (iv) group fairness over CelebA's test-split shape; (v) Dice's void
    error on a Cityscapes batch."""
    from torchmetrics_tpu_torch.kernels.binned_confmat import binned_confmat_multiclass
    from torchmetrics_tpu_torch.kernels.binned_multilabel import binned_confmat_multilabel
    from torchmetrics_tpu_torch.kernels.calibration import calibration_bins
    from torchmetrics_tpu_torch.kernels.ranking import ranking_pairs

    kernels = (calibration_bins, ranking_pairs, binned_confmat_multiclass, binned_confmat_multilabel)
    n_batches = -(-N_SAMPLES // BATCH)
    record = {}
    probs, target, _, _ = _main_path_data(torch.Generator(device="cuda").manual_seed(SEED))
    for form in ("probabilities", "logits"):
        scores = probs if form == "probabilities" else torch.log(probs)
        batches = lambda: (((scores[s:s + BATCH], target[s:s + BATCH]), {}) for s in range(0, N_SAMPLES, BATCH))  # noqa: E731
        rows = CPU_RERUN_BATCHES * BATCH
        slack = _ce_edge_slack(scores[:rows], target[:rows], N_CLASSES, CE_BINS)
        edge_rows = slack[0]
        ece_state = lambda tag, g, w: _ce_state_check(  # noqa: E731
            tag, [g[k] for k in ("conf_sum", "acc_sum", "count")], [w[k] for k in ("conf_sum", "acc_sum", "count")], slack)
        leg = _curve_leg(f"imagenet {form}", _rest_imagenet, batches, kernels, REST_RTOL, REST_ATOL,
                         {"ece_": ece_state} if edge_rows else None)
        ce_groups = sum(1 for g in leg["groups"] if any(m.startswith("ece_") for m in g))
        want = {"calibration_bins": n_batches * ce_groups, "ranking_pairs": 0,
                "binned_confmat_multiclass": n_batches, "binned_confmat_multilabel": 0}
        check(leg["launches"] == want, f"[rest imagenet {form}] launches {leg['launches']}, expected {want} "
                                       f"({ce_groups} calibration compute group(s))")
        t = leg["tensors"]
        for k in ("ece_l1", "ece_l2", "ece_max", "hinge_cs", "exact", "dice"):
            check(t[k].shape == () and bool(torch.isfinite(t[k])) and 0.0 <= float(t[k]) <= 1.5, f"[rest imagenet] {k} = {t[k]}")
        check(t["hinge_ova"].shape == (N_CLASSES,), "[rest imagenet] one-vs-all hinge a class")
        check(float(t["ece_l1"]) <= float(t["ece_l2"]) <= float(t["ece_max"]) + 1e-6, "[rest imagenet] l1 <= l2 <= max")
        leg["calibration_groups"], leg["edge_rows"] = ce_groups, edge_rows
        record[f"imagenet {form}"] = leg
        del scores, batches
    check(torch.allclose(record["imagenet probabilities"]["tensors"]["ece_l1"],
                         record["imagenet logits"]["tensors"]["ece_l1"], rtol=1e-3),
          "[rest imagenet] ECE of the probabilities and of their logits differ")

    scores, labels = _coco_multilabel_data(torch.Generator(device="cuda").manual_seed(SEED + 6))
    coco = lambda: (((scores[s:s + COCO_ML_BATCH], labels[s:s + COCO_ML_BATCH]), {})  # noqa: E731
                    for s in range(0, COCO_ML_IMAGES, COCO_ML_BATCH))
    coco_batches = -(-COCO_ML_IMAGES // COCO_ML_BATCH)
    leg = _curve_leg("coco", _rest_coco, coco, kernels, REST_RTOL, REST_ATOL)
    want = {"calibration_bins": 0, "ranking_pairs": 3 * coco_batches, "binned_confmat_multiclass": 0,
            "binned_confmat_multilabel": coco_batches}
    check(leg["launches"] == want, f"[rest coco] launches {leg['launches']}, expected {want}")
    check(sorted(sorted(g) for g in leg["groups"] if "recall_at_p50" in g) == [["precision_at_r50", "recall_at_p50"]],
          f"[rest coco] the two fixed operating points did not share a group: {leg['groups']}")
    t = leg["tensors"]
    check(0.5 < float(t["lrap"]) <= 1.0 and 0.0 <= float(t["ranking_loss"]) < 0.5 and float(t["coverage"]) >= 1.0,
          f"[rest coco] LRAP {t['lrap']}, loss {t['ranking_loss']}, coverage {t['coverage']}")
    record["coco"] = leg
    del scores, labels, coco

    conf, pred = probs.max(1)
    correct = (pred == target).to(torch.int32)
    del probs, target
    binary = lambda: (((conf[s:s + BATCH], correct[s:s + BATCH]), {}) for s in range(0, N_SAMPLES, BATCH))  # noqa: E731
    leg = _curve_leg("binary", _rest_binary, binary, kernels, REST_RTOL, REST_ATOL)
    want = {"calibration_bins": n_batches, "ranking_pairs": 0, "binned_confmat_multiclass": 0,
            "binned_confmat_multilabel": n_batches}
    check(leg["launches"] == want, f"[rest binary] launches {leg['launches']}, expected {want}")
    t = leg["tensors"]
    check(0.0 <= float(t["ece"]) < 1.0 and 0.0 < float(t["hinge"]) < 2.0, f"[rest binary] ECE {t['ece']}, hinge {t['hinge']}")
    record["binary"] = leg
    del conf, correct, binary

    preds, attr, groups = _celeba_data(torch.Generator(device="cuda").manual_seed(SEED + 12))
    celeba = lambda: (((preds[s:s + BATCH], attr[s:s + BATCH], groups[s:s + BATCH]), {})  # noqa: E731
                      for s in range(0, CELEBA_ROWS, BATCH))
    leg = _curve_leg("celeba", _rest_fairness, celeba, kernels, REST_RTOL, REST_ATOL)
    check(all(v == 0 for v in leg["launches"].values()), f"[rest celeba] launches {leg['launches']}")
    # the collection flattens the members' dicts: group_0, group_1, DP_i_j, EO_i_j
    rates = {k: v for k, v in leg["tensors"].items() if k.startswith("group_")}
    total = float(torch.stack(list(rates.values())).sum())
    check(len(rates) == 2 and abs(total - 2.0) < 1e-5, f"[rest celeba] each group's rates sum to 1: {rates}")
    fair = {k: v for k, v in leg["tensors"].items() if k.startswith(("DP_", "EO_"))}
    check(len(fair) == 2 and all(0.0 < float(v) <= 1.0 for v in fair.values()), f"[rest celeba] fairness {fair}")
    record["celeba"] = leg
    del preds, attr, groups, celeba

    # (v) Dice on Cityscapes targets with void 255 raises the JAX package's error
    from torchmetrics_tpu_torch.classification import Dice

    logits, seg_target = _seg_batch(torch.Generator(device="cuda").manual_seed(SEED + 5))
    errors = {}
    for ignore_index in (None, SEG_IGNORE):
        try:
            Dice(num_classes=SEG_SHAPE[1], ignore_index=ignore_index, device="cuda").update(logits, seg_target)
            errors[str(ignore_index)] = None
        except ValueError as err:
            errors[str(ignore_index)] = str(err)
    expected = "The highest `target` label must be below the C dimension of `preds`."
    check(all(e == expected for e in errors.values()), f"[rest dice] Cityscapes void: {errors}")
    record["cityscapes_dice"] = {"errors": errors}
    del logits, seg_target

    for name, leg in record.items():
        if name == "cityscapes_dice":
            continue
        extra = "" if "calibration_groups" not in leg else \
            f" ({leg['calibration_groups']} calibration compute group: {leg['launches']['calibration_bins']} " \
            f"calibration_bins launches for {leg['batches']} batches; {leg['edge_rows']} rows of the first " \
            f"{CPU_RERUN_BATCHES} batches within {EDGE_TOL} of a bin edge)"
        print(f"[rest] {name}: {leg['batches']} batches in {leg['leg_s']:.3f} s; compute groups {leg['groups']}; "
              f"collection update median {leg['update_ms_median']:.4f} ms (host clock, a synchronize after each), "
              f"compute {leg['compute_ms']:.4f} ms; launches {leg['launches']}{extra}; first {CPU_RERUN_BATCHES} "
              f"batches match the CPU path ({leg['cpu_compared']} tensors: integers equal, floats within rtol "
              f"{REST_RTOL}, atol {REST_ATOL}); values {leg['values']}")
        del leg["tensors"]
    print(f"[rest] cityscapes: Dice(num_classes=19) on a batch with void 255 raises ValueError({expected!r}) "
          f"with ignore_index None and 255")
    return record


MSMARCO_UPDATE_QUERIES = 100  # phase 10 (i): updates of 100 queries
TREC_QUERIES, TREC_UPDATE_QUERIES = 43, 8  # TREC DL 2019 passage: 43 judged queries, 1,000 candidates each
DIV2K_IMAGES, DIV2K_BATCH = 100, 4  # DIV2K validation: 100 2K images
KODAK_IMAGES, KODAK_SHAPE, KODAK_BATCH = 24, (3, 512, 768), 4  # the Kodak set: 24 images of 768 x 512
PANSHARP_IMAGES, PANSHARP_BANDS, PANSHARP_PAN, PANSHARP_MS = 8, 4, 256, 64  # (v): a small 4-band set, ratio 4
IMAGE_CPU_BATCHES = 1  # the image legs rerun their first batch on the CPU path
SIGNAL_RTOL, SIGNAL_ATOL = 1e-5, 1e-6  # the card against the CPU path


def _msmarco_batches(gen_seed: int, queries: int, per_update: int, candidates: int, relevant: float, graded=False):
    """Seeded retrieval runs: ``queries`` x ``candidates`` scores, relevance (binary, at least one and about
    ``relevant`` a query, or graded 0-3) with the relevant documents scored higher, in updates of
    ``per_update`` queries."""
    def batches():
        gen = torch.Generator(device="cuda").manual_seed(gen_seed)
        for q0 in range(0, queries, per_update):
            nq = min(per_update, queries - q0)
            ids = torch.arange(q0, q0 + nq, device="cuda", dtype=torch.int32).repeat_interleave(candidates)
            n = ids.shape[0]
            if graded:
                u = torch.rand((n,), generator=gen, device="cuda")
                target = (u < 0.05).int() + (u < 0.02).int() + (u < 0.008).int()
            else:  # one relevant document a query, and about relevant - 1 more
                target = (torch.rand((n,), generator=gen, device="cuda") < (relevant - 1) / candidates).int()
                first = torch.randint(0, candidates, (nq,), generator=gen, device="cuda")
                target[torch.arange(nq, device="cuda") * candidates + first] = 1
            scores = torch.randn((n,), generator=gen, device="cuda") + 1.5 * target
            yield (scores, target, ids), {}
    return batches


def _retrieval_msmarco(device, compute_groups):
    from torchmetrics_tpu_torch import retrieval as tr
    from torchmetrics_tpu_torch.collections import MetricCollection

    kw = {"device": device}
    return MetricCollection({
        "mrr@10": tr.RetrievalMRR(top_k=10, **kw), "map": tr.RetrievalMAP(**kw),
        "ndcg@10": tr.RetrievalNormalizedDCG(top_k=10, **kw), "recall@1000": tr.RetrievalRecall(top_k=1000, **kw),
        "precision@10": tr.RetrievalPrecision(top_k=10, **kw), "hit_rate": tr.RetrievalHitRate(**kw),
        "r_precision": tr.RetrievalRPrecision(**kw), "fall_out": tr.RetrievalFallOut(**kw),
        "auroc": tr.RetrievalAUROC(**kw), "pr_curve": tr.RetrievalPrecisionRecallCurve(max_k=100, **kw),
    }, compute_groups=compute_groups)


def _retrieval_trec_ndcg(device, compute_groups):
    from torchmetrics_tpu_torch import retrieval as tr
    from torchmetrics_tpu_torch.collections import MetricCollection

    return MetricCollection({"ndcg@10": tr.RetrievalNormalizedDCG(top_k=10, device=device)},
                            compute_groups=compute_groups)


def _retrieval_trec_map(device, compute_groups):
    from torchmetrics_tpu_torch import retrieval as tr
    from torchmetrics_tpu_torch.collections import MetricCollection

    return MetricCollection({"map": tr.RetrievalMAP(device=device)}, compute_groups=compute_groups)


def _image_batches(gen_seed: int, n_images: int, batch: int, shape, noise: float, luma=False, single=False):
    """Seeded image batches made on the card, a batch at a time: a smooth field and a noisy copy as
    ``preds`` (``_image_pair``), as luma (BT.601) for PSNR-B, or ``preds`` alone for total variation."""
    def batches():
        gen = torch.Generator(device="cuda").manual_seed(gen_seed)
        for i0 in range(0, n_images, batch):
            preds, target = _image_pair((min(batch, n_images - i0), *shape), gen, noise)
            if luma:
                weights = torch.tensor([0.299, 0.587, 0.114], device="cuda").view(1, 3, 1, 1)
                preds, target = (x.mul(weights).sum(1, keepdim=True).contiguous() for x in (preds, target))
            yield ((preds,) if single else (preds, target)), {}
    return batches


def _signal_div2k(device, compute_groups):
    from torchmetrics_tpu_torch import image as ti
    from torchmetrics_tpu_torch.collections import MetricCollection

    kw = {"device": device}
    return MetricCollection({
        "psnr": ti.PeakSignalNoiseRatio(data_range=1.0, **kw), "ssim": ti.StructuralSimilarityIndexMeasure(**kw),
        "ms_ssim": ti.MultiScaleStructuralSimilarityIndexMeasure(**kw), "vif": ti.VisualInformationFidelity(**kw),
    }, compute_groups=compute_groups)


def _signal_tv(device, compute_groups):
    from torchmetrics_tpu_torch import image as ti
    from torchmetrics_tpu_torch.collections import MetricCollection

    return MetricCollection({"tv": ti.TotalVariation(device=device)}, compute_groups=compute_groups)


def _signal_psnrb(device, compute_groups):
    from torchmetrics_tpu_torch import image as ti
    from torchmetrics_tpu_torch.collections import MetricCollection

    return MetricCollection({"psnrb": ti.PeakSignalNoiseRatioWithBlockedEffect(device=device)},
                            compute_groups=compute_groups)


def _signal_kodak(device, compute_groups):
    from torchmetrics_tpu_torch import image as ti
    from torchmetrics_tpu_torch.collections import MetricCollection

    kw = {"device": device}
    return MetricCollection({
        "uqi": ti.UniversalImageQualityIndex(**kw), "sam": ti.SpectralAngleMapper(**kw),
        "ergas": ti.ErrorRelativeGlobalDimensionlessSynthesis(**kw), "rase": ti.RelativeAverageSpectralError(**kw),
        "rmse_sw": ti.RootMeanSquaredErrorUsingSlidingWindow(**kw), "scc": ti.SpatialCorrelationCoefficient(**kw),
        "d_lambda": ti.SpectralDistortionIndex(**kw),
    }, compute_groups=compute_groups)


def _signal_pansharp(device, compute_groups):
    from torchmetrics_tpu_torch import image as ti
    from torchmetrics_tpu_torch.collections import MetricCollection

    return MetricCollection({"d_s": ti.SpatialDistortionIndex(device=device),
                             "qnr": ti.QualityWithNoReference(device=device)}, compute_groups=compute_groups)


def _pansharp_batches():
    """A small seeded pan-sharpening set: 4-band fused images at 256 x 256 with their 64 x 64 multispectral
    source and 256 x 256 panchromatic band, two a batch."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 24)
    for _ in range(0, PANSHARP_IMAGES, 2):
        fused, pan = _image_pair((2, PANSHARP_BANDS, PANSHARP_PAN, PANSHARP_PAN), gen, 0.03)
        ms = torch.nn.functional.avg_pool2d(fused, PANSHARP_PAN // PANSHARP_MS) + 0.01 * torch.randn(
            (2, PANSHARP_BANDS, PANSHARP_MS, PANSHARP_MS), generator=gen, device="cuda")
        yield (fused,), {"target": {"ms": ms.contiguous(), "pan": pan}}


def phase_signal() -> dict:
    """Phase 10 on one card, no sync: (i) MS MARCO passage ranking's dev (small) shape through ten retrieval
    metrics; (ii) TREC DL 2019 passage's shape through NDCG@10 (graded) and MAP (binarized); (iii) DIV2K
    validation's shape through PSNR, SSIM, MS-SSIM, VIF, total variation and PSNR-B on the luma; (iv) Kodak's
    shape through the cat-state spectral metrics; (v) D-s and QNR over a small pan-sharpening set."""
    from torchmetrics_tpu_torch.kernels.retrieval import retrieval_groups
    from torchmetrics_tpu_torch.kernels.ssim import ssim_window

    kernels = (retrieval_groups, ssim_window)
    record = {}
    msmarco = _msmarco_batches(SEED + 20, MSMARCO_QUERIES, MSMARCO_UPDATE_QUERIES, MSMARCO_CANDIDATES,
                               MSMARCO_RELEVANT)
    leg = _curve_leg("msmarco", _retrieval_msmarco, msmarco, kernels, SIGNAL_RTOL, SIGNAL_ATOL)
    check(leg["launches"] == {"retrieval_groups": 10, "ssim_window": 0},
          f"[signal msmarco] launches {leg['launches']}: one a scalar measure and one ranked layout expected")
    t = leg["tensors"]
    for k in ("mrr@10", "map", "ndcg@10", "recall@1000", "precision@10", "hit_rate", "r_precision", "auroc"):
        check(t[k].shape == () and 0.0 < float(t[k]) <= 1.0, f"[signal msmarco] {k} = {t[k]}")
    check(float(t["recall@1000"]) > 0.99 and float(t["hit_rate"]) > 0.99, "[signal msmarco] every query retrieved")
    check(t["pr_curve"][0].shape == (100,) and 0.0 <= float(t["fall_out"]) <= 1.0,
          f"[signal msmarco] curve, fall-out: {leg['values']}")
    record["msmarco"] = leg

    trec = _msmarco_batches(SEED + 21, TREC_QUERIES, TREC_UPDATE_QUERIES, MSMARCO_CANDIDATES, 1.0, graded=True)
    leg = _curve_leg("trec ndcg", _retrieval_trec_ndcg, trec, kernels, SIGNAL_RTOL, SIGNAL_ATOL)
    check(leg["launches"]["retrieval_groups"] == 1, f"[signal trec] NDCG launches {leg['launches']}")
    record["trec ndcg"] = leg
    binarized = lambda: (((p, (t_ >= 2).int(), i), kw) for (p, t_, i), kw in trec())  # noqa: E731
    leg = _curve_leg("trec map", _retrieval_trec_map, binarized, kernels, SIGNAL_RTOL, SIGNAL_ATOL)
    check(leg["launches"]["retrieval_groups"] == 1, f"[signal trec] MAP launches {leg['launches']}")
    record["trec map"] = leg
    for name in ("trec ndcg", "trec map"):
        value = next(iter(record[name]["tensors"].values()))
        check(0.0 < float(value) <= 1.0, f"[signal {name}] {value}")

    div2k = _image_batches(SEED + 22, DIV2K_IMAGES, DIV2K_BATCH, DIV2K_SHAPE[1:], 0.05)
    n_batches = -(-DIV2K_IMAGES // DIV2K_BATCH)
    leg = _curve_leg("div2k", _signal_div2k, div2k, kernels, SIGNAL_RTOL, SIGNAL_ATOL, cpu_batches=IMAGE_CPU_BATCHES)
    check(leg["launches"] == {"retrieval_groups": 0, "ssim_window": 6 * n_batches},
          f"[signal div2k] launches {leg['launches']}: one a batch for SSIM and five for MS-SSIM expected")
    t = leg["tensors"]
    check(20.0 < float(t["psnr"]) < 40.0 and 0.0 < float(t["ssim"]) <= float(t["ms_ssim"]) <= 1.0
          and 0.0 < float(t["vif"]) <= 1.0, f"[signal div2k] values {leg['values']}")
    record["div2k"] = leg
    for name, make, batches in (
        ("div2k tv", _signal_tv, _image_batches(SEED + 22, DIV2K_IMAGES, DIV2K_BATCH, DIV2K_SHAPE[1:], 0.05,
                                                single=True)),
        ("div2k psnrb luma", _signal_psnrb, _image_batches(SEED + 22, DIV2K_IMAGES, DIV2K_BATCH, DIV2K_SHAPE[1:],
                                                           0.05, luma=True)),
    ):
        leg = _curve_leg(name, make, batches, kernels, SIGNAL_RTOL, SIGNAL_ATOL, cpu_batches=IMAGE_CPU_BATCHES)
        check(leg["launches"] == {"retrieval_groups": 0, "ssim_window": 0}, f"[signal {name}] {leg['launches']}")
        value = next(iter(leg["tensors"].values()))
        check(bool(torch.isfinite(value)) and float(value) > 0.0, f"[signal {name}] {value}")
        record[name] = leg

    kodak = _image_batches(SEED + 23, KODAK_IMAGES, KODAK_BATCH, KODAK_SHAPE, 0.05)
    leg = _curve_leg("kodak", _signal_kodak, kodak, kernels, SIGNAL_RTOL, SIGNAL_ATOL, cpu_batches=IMAGE_CPU_BATCHES)
    check(all(bool(torch.isfinite(v)) for v in leg["tensors"].values()), f"[signal kodak] values {leg['values']}")
    check(0.0 < float(leg["tensors"]["uqi"]) <= 1.0 and 0.0 <= float(leg["tensors"]["d_lambda"]) < 1.0,
          f"[signal kodak] values {leg['values']}")
    record["kodak"] = leg

    leg = _curve_leg("pansharp", _signal_pansharp, _pansharp_batches, kernels, SIGNAL_RTOL, SIGNAL_ATOL,
                     cpu_batches=IMAGE_CPU_BATCHES)
    check(all(bool(torch.isfinite(v)) for v in leg["tensors"].values()), f"[signal pansharp] values {leg['values']}")
    record["pansharp"] = leg

    for name, leg in record.items():
        print(f"[signal] {name}: {leg['batches']} batches in {leg['leg_s']:.3f} s (the CPU rerun "
              f"{leg['cpu_rerun_s']:.1f} s); compute groups {leg['groups']}; "
              f"collection update median {leg['update_ms_median']:.4f} ms (host clock, a synchronize after each), "
              f"compute {leg['compute_ms']:.4f} ms; launches {leg['launches']}; the first batches match the CPU "
              f"path ({leg['cpu_compared']} tensors: integers equal, floats within rtol {SIGNAL_RTOL}, atol "
              f"{SIGNAL_ATOL}); values {leg['values']}")
        del leg["tensors"]
    return record


# ------------------------------------------- segmentation_counts and pairwise_lp (phase 3), phase 11
CITYSCAPES_IMAGES, CITYSCAPES_HW, CITYSCAPES_BATCH, CITYSCAPES_CLASSES = 24, (1024, 2048), 2, 19
ADE_IMAGES, ADE_HW, ADE_BATCH, ADE_CLASSES = 64, (512, 512), 16, 150  # ADE20K SceneParsing's 150 classes
CLUSTER_ROWS, CLUSTER_CLASSES, CLUSTER_WIDTH, CLUSTER_BATCH = 50_000, 1_000, 2_048, 5_000  # ImageNet val, ResNet-50
ADULT_ROWS, ADULT_BATCH = 48_842, 1_024  # the UCI Adult census set: train + test
ADULT_CARDINALITIES = (9, 16, 7, 15, 6, 5, 2, 42, 2)  # workclass .. native-country, income
ADULT_OCCUPATION, ADULT_EDUCATION, ADULT_NAN_COLUMNS = 3, 1, (0, 3)  # NaN every 500th value in these two
FLEISS_SHAPE, FLEISS_BATCH = (10_000, 5, 10), 1_000  # subjects, categories, raters
MARKET_QUERY, MARKET_GALLERY, MARKET_WIDTH = 3_368, 19_732, 2_048  # Market-1501's evaluation, ResNet-50 features
FP32_INSTR_PER_S = PEAK_FP32_OPS_PER_S / 2  # 132 SMs x 128 lanes x 1.98 GHz: one FMA counts as two operations
PAIRWISE_INSTR = {1: 2, 2: 2, 3: 4}  # fp32 instructions a pair: the difference, then |d| (1), d * d (2), x * (x * x)
SFU_OPS_PER_S = FP32_INSTR_PER_S / 8  # powf: lg2 and ex2 on the special-function units, an eighth of the fp32 rate
SEG_CPU_BATCHES = 1  # the segmentation legs rerun their first batch on the CPU path (JAX's one-hots there)


def _label_maps(shape, c, gen, dtype=torch.int64, void=0.05, agree=0.75):
    """Seeded index maps on the card: a uniform target, ``void`` of it 255; the prediction equal to the
    target on ``agree`` of the pixels, else uniform (as phase 7 (ii)'s argmax makes it)."""
    dev = torch.device("cuda")
    target = torch.randint(0, c, shape, generator=gen, device=dev)
    preds = torch.where(torch.rand(shape, generator=gen, device=dev) < agree, target,
                        torch.randint(0, c, shape, generator=gen, device=dev))
    target[torch.rand(shape, generator=gen, device=dev) < void] = SEG_IGNORE
    return preds.to(dtype).contiguous(), target.to(dtype).contiguous()


def _bincount_counts(preds, target, c):
    """Three ``bincount(n * C + label)`` calls (several PyTorch calls, a yardstick): in-range labels only."""
    n = preds.shape[0]
    base = torch.arange(n, device=preds.device).view(n, *([1] * (preds.ndim - 1))) * c
    p, t = (preds.long() + base).view(-1), (target.long().clamp(0, c - 1) + base).view(-1)
    inter = torch.bincount(torch.where(p == t, p, n * c), minlength=n * c + 1)[:-1]
    return inter, torch.bincount(p, minlength=n * c), torch.bincount(t, minlength=n * c)


def phase_segmentation_kernel(flush: torch.Tensor) -> list:
    """``segmentation_counts`` against its plain version (JAX's one-hots) on the card: equal. Timed at the
    Cityscapes batch (the first row) and the ADE20K-shaped batch, beside three ``bincount`` calls."""
    from torchmetrics_tpu_torch.kernels import segmentation as kseg

    gen = torch.Generator(device="cuda").manual_seed(SEED + 30)
    city, ade = (CITYSCAPES_BATCH, *CITYSCAPES_HW), (ADE_BATCH, *ADE_HW)
    dev = torch.device("cuda")
    cases = [  # (what, shape, C, dtype, edits, timed)
        ("Cityscapes batch (a)", city, 19, torch.int64, (), True),
        ("ADE20K-shaped batch (b)", ade, 150, torch.int64, (), True),
        *((f"Cityscapes batch, {str(dt)[6:]}", city, 19, dt, (), False) for dt in (torch.uint8, torch.int32)),
        *((f"ADE20K-shaped batch, {str(dt)[6:]}", ade, 150, dt, (), False) for dt in (torch.uint8, torch.int32)),
        ("labels -1, -C, -C-1, -1000, C, C+3", (4, 96, 80), 19, torch.int64, ("odd",), False),
        ("labels past C, int32", (4, 96, 80), 19, torch.int32, ("odd",), False),
        *((f"C={c}", (3, 64, 72), c, torch.int64, ("odd",), False) for c in (1, 2, 1000)),
        (f"C={kseg.SHARED_CLASSES + 1}: global atomics", (2, 128, 96), kseg.SHARED_CLASSES + 1, torch.int32, ("odd",),
         False),
        ("3-D volumes", (2, 8, 64, 64), 5, torch.int64, ("odd",), False),
        ("one-pixel images", (7, 1, 1), 3, torch.int64, ("odd",), False),
        ("odd sizes: scalar loads", (3, 37, 41), 7, torch.int32, ("odd",), False),
        ("uint8 and int64 maps", (2, 61, 33), 19, (torch.uint8, torch.int64), (), False),
        ("empty batch", (0, 16, 16), 19, torch.int64, (), False),
    ]
    rows = []
    for what, shape, c, dtype, edits, timed in cases:
        p_dt, t_dt = dtype if isinstance(dtype, tuple) else (dtype, dtype)
        preds, target = _label_maps(shape, c, gen, torch.int64, void=0.05 if c > 18 else 0.0)
        if "odd" in edits and preds.numel():
            for i, value in enumerate([-1, -c, -c - 1, -1000, c, c + 3]):
                target.view(-1)[i::97] = value
                preds.view(-1)[i + 11::89] = value
        if p_dt == torch.uint8:
            preds = preds.clamp(0, 255)
        preds, target = preds.to(p_dt).contiguous(), target.to(t_dt).contiguous()
        before = kseg.segmentation_counts.launches
        got = kseg.segmentation_counts(preds, target, c)
        again = kseg.segmentation_counts(preds, target, c)
        want = kseg._segmentation_counts_plain(preds, target, c)
        torch.cuda.synchronize()
        label = f"{what}: {tuple(shape)} {str(p_dt)[6:]}/{str(t_dt)[6:]}, C={c}"
        check(kseg.segmentation_counts.launches == before + (2 if preds.numel() else 0), f"launches ({label})")
        check(torch.equal(got, want), f"segmentation_counts and plain differ ({label}): max abs err "
                                      f"{int((got - want).abs().max()) if got.numel() else 0}")
        check(torch.equal(got, again), f"segmentation_counts is not deterministic ({label})")
        row = {"case": label, "what": what, "max_abs_err": 0.0}
        if timed:
            nbytes = preds.numel() * preds.element_size() + target.numel() * target.element_size() + got.numel() * 4
            bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
            plan = kseg.plan(shape[0], preds[0].numel(), c, torch.cuda.get_device_properties(0).multi_processor_count)
            kernel_ms = time_ms(lambda: kseg.segmentation_counts(preds, target, c), flush)
            dirty_ms = time_ms(lambda: kseg.segmentation_counts(preds, target, c), flush, clean=False)
            plain_ms = time_ms(lambda: kseg._segmentation_counts_plain(preds, target, c), flush, reps=5, warmup=1)
            yard_ms = time_ms(lambda: _bincount_counts(preds, target, c), flush, reps=10, warmup=1)
            sets = [(preds, target)] + [(preds.clone(), target.clone()) for _ in range(copies_for(nbytes) - 1)]
            stream_ms = time_stream_ms(lambda p_, t_: kseg.segmentation_counts(p_, t_, c), sets,
                                       calls=len(sets) * max(1, 24 // len(sets)))
            del sets
            row.update({"plan": plan._asdict(), "ms": kernel_ms, "write_only_flush_ms": dirty_ms, "stream_ms": stream_ms,
                        "plain_ms": plain_ms,
                        "bincount_yardstick_ms": yard_ms, "bound_ms": bytes_ms, "bound_by": "bytes", "bytes": nbytes,
                        "library_ms": None})
            print(f"[kernel] segmentation_counts {label}: exact, {kernel_ms:.4f} ms after an L2 flush "
                  f"({dirty_ms:.4f} ms after the flush's write alone, which leaves dirty lines; {stream_ms:.4f} ms a "
                  f"call back to back; plan {tuple(plan)}), plain (one-hots) {plain_ms:.4f} ms, "
                  f"three bincount calls (a yardstick) {yard_ms:.4f} ms, bound {bytes_ms * 1e3:.2f} us (bytes: "
                  f"{nbytes}), library_ms: none")
        rows.append(row)
        del preds, target, got, again, want
    print(f"[kernel] segmentation_counts: equal to plain and deterministic on all {len(cases)} cases: "
          + "; ".join(r["what"] for r in rows))
    return rows


def _lp_bound_ms(n, m, d, p):
    """The least time of an (n, m) L_p matrix over d columns: fp32 instructions a pair (integer p) or powf's two
    special-function operations (float p), against the bytes of x, y and the output."""
    pairs = n * m * d
    ops_ms = (pairs * 2 / SFU_OPS_PER_S if isinstance(p, float) else
              pairs * PAIRWISE_INSTR.get(p, 4) / FP32_INSTR_PER_S) * 1e3
    bytes_ms = ((n + m) * d + n * m) * 4 / PEAK_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes"


def _lp_check(label, got, want, x, y, p, root, terms=None):
    """``got`` within 1e-6 relative of ``want`` plus the float32 summation bound of the plain version's d
    terms (``d 2**-24 sum |term|``, taken through the root); NaN and +-inf in the same places. ``terms``, the
    float64 ``sum |term|`` of each pair, is taken here from ``x`` and ``y`` unless the caller gives it."""
    if terms is None:
        terms = torch.zeros_like(want, dtype=torch.float64)
        for xb, rows in zip(x.split(256), torch.arange(x.shape[0], device=x.device).split(256)):
            terms[rows] = (xb.double()[:, None, :] - y.double()[None, :, :]).abs().pow(float(p)).sum(-1)
    d = x.shape[1]
    bound = d * 2.0**-24 * terms
    if root == "pow":
        bound = bound / p * terms.clamp_min(1e-30).pow(1.0 / p - 1.0)
    elif root == "sqrt":
        bound = bound / 2.0 / terms.clamp_min(1e-30).sqrt()
    g, w = got.double(), want.double()
    finite = torch.isfinite(w)
    check(torch.equal(g.isnan(), w.isnan()) and torch.equal(g[w.isinf()], w[w.isinf()]),
          f"pairwise_lp's non-finite values differ from plain ({label})")
    err = (g - w).abs()
    check(bool((err[finite] <= 1e-6 * w[finite].abs() + bound[finite] + 1e-30).all()),
          f"pairwise_lp differs from plain ({label}): max abs err {float(err[finite].max())}")
    return float(err[finite].max()) if finite.any() else 0.0


def _wide_rows(n: int, d: int, gen: torch.Generator) -> torch.Tensor:
    """Rows of magnitudes from 1e-30 to 1e30, log-uniform, either sign; rows 8-11 hold values near 2^-120 that
    differ in their last bits from row 8's (subnormal differences, and zeros), row 12 subnormal values."""
    dev = torch.device("cuda")
    sign = torch.where(torch.rand((n, d), generator=gen, device=dev) < 0.5, -1.0, 1.0)
    x = sign * torch.pow(10.0, 60.0 * torch.rand((n, d), generator=gen, device=dev) - 30.0)
    if n > 12:
        steps = torch.randint(0, 8, (4, d), generator=gen, device=dev).float()
        x[8:12] = 2.0**-120 * (1.0 + steps * 2.0**-23)
        x[12] = 1e-40 * torch.rand((d,), generator=gen, device=dev)
    return x.contiguous()


def phase_pairwise_kernel(flush: torch.Tensor) -> list:
    """``pairwise_lp`` against its plain version (JAX's broadcast) on the card. Timed at 1,024 x 1,024 x 512
    (the first row: p = 1; then int 2, int 3, 1.5) beside ``torch.cdist``; Market-1501's shape is phase 11. The
    rows of magnitudes from 1e-30 to 1e30 (``_wide_rows``) reach every binary exponent of a float p's table, its
    fast range and the accurate path, at d = 1 (each output one term), 4,096 (16-byte copies) and 4,097."""
    from torchmetrics_tpu_torch.functional import pairwise as fpw
    from torchmetrics_tpu_torch.kernels import pairwise as kpw

    gen = torch.Generator(device="cuda").manual_seed(SEED + 31)
    dev = torch.device("cuda")
    cases = [((1024, 1024, 512), p, "pow" if p != 1 else None, True) for p in (1, 2, 3, 1.5)]
    cases += [((1024, 1024, 512), p, "pow", False) for p in (2.0, 0.5)]
    for n, m, d in ((1, 1, 1), (31, 33, 33), (33, 31, 4097), (4097, 31, 1), (1, 4097, 31), (33, 33, 31)):
        cases += [((n, m, d), p, "pow", False) for p in (1, 2, 2.0, 3, 4, 5, 0.5, 1.5)]
    cases += [((100, 80, 2048), 2, "sqrt", False), ((64, 64, 64), 1, None, False)]
    # magnitudes from 1e-30 to 1e30, subnormal differences and values: every E of a float p's table
    cases += [((n, m, d), p, "pow", "wide") for n, m, d in ((64, 48, 1), (40, 33, 4096), (40, 33, 4097))
              for p in (0.5, 1.5, 5.5)]
    rows = []
    for (n, m, d), p, root, timed in cases:
        x = torch.randn((n, d), generator=gen, device=dev)
        y = torch.randn((m, d), generator=gen, device=dev)
        wide = timed == "wide"
        if wide:
            x, y = (_wide_rows(r, d, gen) for r in (n, m))
            timed = False
        if not timed and n > 8 and m > 8:  # rows of NaN and +-inf, a signed zero
            x[3, d // 2], x[5, 0], y[7, d - 1], x[6, 0] = float("nan"), float("inf"), float("-inf"), -0.0
        before = kpw.pairwise_lp.launches
        got = kpw.pairwise_lp(x, y, p, root)
        again = kpw.pairwise_lp(x, y, p, root)
        want = kpw._pairwise_lp_plain(x, y, p, root)
        torch.cuda.synchronize()
        label = f"({n}, {m}, {d}), p={p!r}, root {root}"
        check(kpw.pairwise_lp.launches == before + 2, f"pairwise_lp did not launch twice ({label})")
        check(torch.equal(got.view(torch.int32), again.view(torch.int32)), f"pairwise_lp is not deterministic ({label})")
        err = _lp_check(label, got, want, x, y, p, root)
        if wide:  # outputs up to 1e35: the error relative to the output, out of the record's absolute one
            finite = torch.isfinite(want) & (want != 0)
            rel = ((got.double() - want.double()).abs() / want.double().abs())[finite]
            row = {"case": label, "max_rel_err": float(rel.max()) if rel.numel() else 0.0}
        else:
            row = {"case": label, "max_abs_err": err}
        if timed:
            bound_ms, bound_by = _lp_bound_ms(n, m, d, p)
            kernel_ms = time_ms(lambda: kpw.pairwise_lp(x, y, p, root), flush, reps=10)
            plain_ms = time_ms(lambda: kpw._pairwise_lp_plain(x, y, p, root), flush, reps=3, warmup=1)
            kw = {"compute_mode": "donot_use_mm_for_euclid_dist"} if p == 2 else {}
            cdist_ms = time_ms(lambda: torch.cdist(x, y, float(p), **kw), flush, reps=5, warmup=1)
            stream_ms = time_stream_ms(lambda x_, y_: kpw.pairwise_lp(x_, y_, p, root), [(x, y), (x.clone(), y.clone())],
                                       calls=8)
            row.update({"ms": kernel_ms, "stream_ms": stream_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "library_ms": cdist_ms, "pairs": n * m * d})
            print(f"[kernel] pairwise_lp {label}: {kernel_ms:.4f} ms after an L2 flush ({stream_ms:.4f} ms a call "
                  f"back to back), plain {plain_ms:.4f} ms, torch.cdist {cdist_ms:.4f} ms, "
                  f"bound {bound_ms:.4f} ms ({bound_by}), max abs err {row['max_abs_err']:.3g}")
        rows.append(row)
    # x is y through the public function: zero_diagonal multiplies by 1 - eye, a non-finite diagonal gives NaN
    x = torch.randn((70, 40), generator=gen, device=dev)
    x[4, 3] = float("inf")
    got = fpw.pairwise_manhattan_distance(x)
    want = kpw._pairwise_lp_plain(x, x, 1, None) * (1.0 - torch.eye(70, device=dev))
    check(torch.equal(got.isnan(), want.isnan()) and bool(got[4, 4].isnan()), "zero_diagonal on x is y")
    rows.append({"case": "x is y, zero_diagonal, an inf row", "max_abs_err": _lp_check("x is y", got, want, x, x, 1, None)})
    wide_rel = max(r["max_rel_err"] for r in rows if "max_rel_err" in r)
    print(f"[kernel] pairwise_lp: within 1e-6 relative plus the float32 summation bound of the plain version's d "
          f"terms, NaN and +-inf in place, deterministic, on {len(rows)} cases (the rows of magnitudes 1e-30 to "
          f"1e30: max relative err {wide_rel:.3g})")
    return rows


def _cityscapes_batches():
    gen = torch.Generator(device="cuda").manual_seed(SEED + 32)
    for _ in range(0, CITYSCAPES_IMAGES, CITYSCAPES_BATCH):
        yield _label_maps((CITYSCAPES_BATCH, *CITYSCAPES_HW), CITYSCAPES_CLASSES, gen), {}


def _ade_batches():
    gen = torch.Generator(device="cuda").manual_seed(SEED + 33)
    for _ in range(0, ADE_IMAGES, ADE_BATCH):
        yield _label_maps((ADE_BATCH, *ADE_HW), ADE_CLASSES, gen, void=0.0), {}


def _seg_cityscapes(device, compute_groups):
    from torchmetrics_tpu_torch import segmentation as ts
    from torchmetrics_tpu_torch.collections import MetricCollection

    kw = {"num_classes": CITYSCAPES_CLASSES, "input_format": "index", "device": device}
    return MetricCollection({
        "miou": ts.MeanIoU(**kw), "dice": ts.GeneralizedDiceScore(**kw),
        "miou_per_class": ts.MeanIoU(per_class=True, **kw), "dice_per_class": ts.GeneralizedDiceScore(per_class=True, **kw),
    }, compute_groups=compute_groups)


def _seg_ade(device, compute_groups):
    from torchmetrics_tpu_torch import segmentation as ts
    from torchmetrics_tpu_torch.collections import MetricCollection

    kw = {"num_classes": ADE_CLASSES, "input_format": "index", "device": device}
    return MetricCollection({
        "miou_per_class": ts.MeanIoU(per_class=True, **kw),
        "dice_no_background": ts.GeneralizedDiceScore(include_background=False, weight_type="square", **kw),
    }, compute_groups=compute_groups)


def _cluster_labels():
    """ImageNet val's size: 50,000 seeded labels of 1,000 classes against 1,000 cluster ids, half agreeing."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 34)
    target = torch.randint(0, CLUSTER_CLASSES, (CLUSTER_ROWS,), generator=gen, device="cuda")
    preds = torch.where(torch.rand((CLUSTER_ROWS,), generator=gen, device="cuda") < 0.5, target,
                        torch.randint(0, CLUSTER_CLASSES, (CLUSTER_ROWS,), generator=gen, device="cuda"))
    for i0 in range(0, CLUSTER_ROWS, CLUSTER_BATCH):
        yield (preds[i0:i0 + CLUSTER_BATCH], target[i0:i0 + CLUSTER_BATCH]), {}


def _cluster_data():
    """50,000 seeded float32 embeddings of ResNet-50's pooled width (2,048) about 1,000 class centres."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 35)
    centres = 2.0 * torch.randn((CLUSTER_CLASSES, CLUSTER_WIDTH), generator=gen, device="cuda")
    for _ in range(0, CLUSTER_ROWS, CLUSTER_BATCH):
        labels = torch.randint(0, CLUSTER_CLASSES, (CLUSTER_BATCH,), generator=gen, device="cuda")
        data = centres[labels] + torch.randn((CLUSTER_BATCH, CLUSTER_WIDTH), generator=gen, device="cuda")
        yield (data, labels), {}


def _clustering_labels_collection(device, compute_groups):
    from torchmetrics_tpu_torch import clustering as tcl
    from torchmetrics_tpu_torch.collections import MetricCollection

    kw = {"device": device}
    return MetricCollection({
        "mi": tcl.MutualInfoScore(**kw), "ami": tcl.AdjustedMutualInfoScore(**kw),
        "nmi": tcl.NormalizedMutualInfoScore(**kw), "rand": tcl.RandScore(**kw), "ari": tcl.AdjustedRandScore(**kw),
        "fmi": tcl.FowlkesMallowsIndex(**kw), "homogeneity": tcl.HomogeneityScore(**kw),
        "completeness": tcl.CompletenessScore(**kw), "v_measure": tcl.VMeasureScore(**kw),
    }, compute_groups=compute_groups)


def _clustering_data_collection(device, compute_groups):
    from torchmetrics_tpu_torch import clustering as tcl
    from torchmetrics_tpu_torch.collections import MetricCollection

    kw = {"device": device}
    return MetricCollection({"ch": tcl.CalinskiHarabaszScore(**kw), "db": tcl.DaviesBouldinScore(**kw),
                             "dunn": tcl.DunnIndex(**kw)}, compute_groups=compute_groups)


def _adult_columns():
    """The UCI Adult set's shape: 48,842 rows of nine seeded categorical columns at its cardinalities (float32
    codes), every 500th value NaN in workclass and occupation, as the set misses values there."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 36)
    cols = [torch.randint(0, c, (ADULT_ROWS,), generator=gen, device="cuda").float() for c in ADULT_CARDINALITIES]
    cols[ADULT_EDUCATION] = torch.where(torch.rand((ADULT_ROWS,), generator=gen, device="cuda") < 0.3,
                                        cols[ADULT_OCCUPATION], cols[ADULT_EDUCATION])  # some association
    for j in ADULT_NAN_COLUMNS:
        cols[j][::500] = float("nan")
    return torch.stack(cols, 1).contiguous()


def _adult_batches(matrix):
    def batches():
        for i0 in range(0, ADULT_ROWS, ADULT_BATCH):
            rows = matrix[i0:i0 + ADULT_BATCH]
            yield (rows[:, ADULT_OCCUPATION].contiguous(), rows[:, ADULT_EDUCATION].contiguous()), {}
    return batches


def _nominal_collection(device, compute_groups):
    from torchmetrics_tpu_torch import nominal as tn
    from torchmetrics_tpu_torch.collections import MetricCollection

    c = max(ADULT_CARDINALITIES)
    members = {}
    for strategy in ("replace", "drop"):
        kw = {"num_classes": c, "nan_strategy": strategy, "device": device}
        members.update({f"cramers_v_{strategy}": tn.CramersV(**kw), f"tschuprows_t_{strategy}": tn.TschuprowsT(**kw),
                        f"pearson_{strategy}": tn.PearsonsContingencyCoefficient(**kw),
                        f"theils_u_{strategy}": tn.TheilsU(**kw)})
    return MetricCollection(members, compute_groups=compute_groups)


def _fleiss_batches():
    gen = torch.Generator(device="cuda").manual_seed(SEED + 37)
    for _ in range(0, FLEISS_SHAPE[0], FLEISS_BATCH):
        yield (torch.rand((FLEISS_BATCH, *FLEISS_SHAPE[1:]), generator=gen, device="cuda"),), {}


def _fleiss_collection(device, compute_groups):
    from torchmetrics_tpu_torch import nominal as tn
    from torchmetrics_tpu_torch.collections import MetricCollection

    return MetricCollection({"fleiss": tn.FleissKappa(mode="probs", device=device)}, compute_groups=compute_groups)


AMI_BOUND_FULL = 0.005  # |float32 AMI - float64| at 50,000 labels of 1,000 clusters


def _ami_float64(preds: torch.Tensor, target: torch.Tensor) -> float:
    """The adjusted mutual information (arithmetic mean) in float64: the contingency of the dense ids, MI, both
    entropies and E[MI]'s hypergeometric sum over every possible cell count, ``lgamma`` in float64."""
    _, p = torch.unique(preds, return_inverse=True)
    _, t = torch.unique(target, return_inverse=True)
    kt, kp = int(t.max()) + 1, int(p.max()) + 1
    c = torch.bincount(t * kp + p, minlength=kt * kp).view(kt, kp).double()
    n, a, b = c.sum(), c.sum(1), c.sum(0)
    nz = c > 0
    mi = (c[nz] / n * torch.log(n * c[nz] / torch.outer(a, b)[nz])).sum()
    entropy = lambda x: -(x[x > 0] / n * torch.log(x[x > 0] / n)).sum()  # noqa: E731
    ai, bj = a[:, None, None], b[None, :, None]
    start = torch.clamp_min(ai + bj - n, 1.0)
    k = start + torch.arange(int((torch.minimum(ai, bj) - start).max()) + 1, device=c.device, dtype=torch.float64)
    valid = k <= torch.minimum(ai, bj)
    k = torch.where(valid, k, torch.ones_like(k))
    lg = torch.lgamma
    log_p = (lg(ai + 1) + lg(bj + 1) + lg(n - ai + 1) + lg(n - bj + 1) - lg(n + 1) - lg(k + 1) - lg(ai - k + 1)
             - lg(bj - k + 1) - lg(n - ai - bj + k + 1))
    terms = k / n * (torch.log(n) + torch.log(k) - torch.log(ai) - torch.log(bj)) * torch.exp(log_p)
    emi = torch.where(valid, terms, torch.zeros_like(terms)).sum()
    return float((mi - emi) / ((entropy(a) + entropy(b)) / 2 - emi))


def _ami_check(record: dict):
    """AMI's value check on the subset: the card against the CPU path within the leg's float tolerance (both take
    JAX's float32 E[MI] form with each ``lgamma`` in float64, rounded once), and the float64 evaluation recorded
    beside them; the float32 form's own drift from float64 is held over all rows with ``AMI_BOUND_FULL``."""
    def check_ami(tag, got, want, state):
        record.update({"float64": _ami_float64(torch.cat(state["preds"]), torch.cat(state["target"])),
                       "card": float(got), "cpu": float(want)})
        _assert_same(tag, got, want)
    return check_ami


def _host_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def phase_contingency() -> dict:
    """Phase 11 on one card, no sync: (i) Cityscapes val's shape and (ii) ADE20K SceneParsing's through the
    segmentation metrics; (iii) clustering at ImageNet val's size; (iv) nominal association at the UCI Adult set's
    size and Fleiss' kappa; (v) the pairwise matrices at Market-1501's shape."""
    from torchmetrics_tpu_torch.functional import nominal as fn_nominal
    from torchmetrics_tpu_torch.functional import pairwise as fpw
    from torchmetrics_tpu_torch.functional.clustering.utils import calculate_contingency_matrix
    from torchmetrics_tpu_torch.functional.segmentation.mean_iou import _index_counts
    from torchmetrics_tpu_torch.kernels.confmat import confmat_multiclass
    from torchmetrics_tpu_torch.kernels.pairwise import pairwise_lp
    from torchmetrics_tpu_torch.kernels.segmentation import segmentation_counts

    kernels = (segmentation_counts, confmat_multiclass, pairwise_lp)
    record = {}

    # (i) Cityscapes: four metrics, four groups (their states differ), one launch a group and batch
    leg = _curve_leg("contingency cityscapes", _seg_cityscapes, _cityscapes_batches, kernels,
                     cpu_batches=SEG_CPU_BATCHES)
    n_batches = CITYSCAPES_IMAGES // CITYSCAPES_BATCH
    check(len(leg["groups"]) == 4 and leg["launches"] == {"segmentation_counts": 4 * n_batches,
                                                          "confmat_multiclass": 0, "pairwise_lp": 0},
          f"[contingency cityscapes] groups {leg['groups']}, launches {leg['launches']}")
    (preds, target), _ = next(_cityscapes_batches())
    counts = _index_counts(preds, target, CITYSCAPES_CLASSES)
    void = int((target == SEG_IGNORE).sum())
    check(int(counts[:, 2, CITYSCAPES_CLASSES - 1].sum()) == void + int((target == CITYSCAPES_CLASSES - 1).sum()),
          "[contingency cityscapes] void 255 is not counted as class 18")
    leg["void_share"] = void / target.numel()
    t = leg["tensors"]
    check(all(0.0 < float(v) < 1.0 for v in (t["miou"], t["dice"])) and t["miou_per_class"].shape == (19,),
          f"[contingency cityscapes] values {leg['values']}")
    record["cityscapes"] = leg

    # (ii) ADE20K-shaped: two metrics, two groups
    leg = _curve_leg("contingency ade20k", _seg_ade, _ade_batches, kernels, cpu_batches=SEG_CPU_BATCHES)
    n_batches = ADE_IMAGES // ADE_BATCH
    check(leg["launches"]["segmentation_counts"] == 2 * n_batches and len(leg["groups"]) == 2,
          f"[contingency ade20k] groups {leg['groups']}, launches {leg['launches']}")
    check(leg["tensors"]["miou_per_class"].shape == (ADE_CLASSES,) and 0.0 < float(leg["tensors"]["dice_no_background"]) < 1.0,
          f"[contingency ade20k] values {leg['values']}")
    record["ade20k"] = leg

    # (iii) clustering: nine extrinsic metrics in one group, one contingency a compute (two for the V-measure)
    ami_subset = {}
    leg = _curve_leg("contingency clustering labels", _clustering_labels_collection, _cluster_labels, kernels,
                     cpu_batches=1, value_checks={"ami": _ami_check(ami_subset)})
    check(len(leg["groups"]) == 1 and leg["launches"] == {"segmentation_counts": 0, "confmat_multiclass": 10,
                                                          "pairwise_lp": 0},
          f"[contingency clustering labels] groups {leg['groups']}, launches {leg['launches']}")
    t = leg["tensors"]
    check(all(0.0 < float(t[k]) < 1.0 for k in ("ami", "nmi", "ari", "homogeneity", "v_measure")),
          f"[contingency clustering labels] values {leg['values']}")
    labels = [torch.cat(x) for x in zip(*(args for args, _ in _cluster_labels()))]
    ami_full = {"float64": _ami_float64(*labels), "card": float(t["ami"])}
    check(abs(ami_full["card"] - ami_full["float64"]) <= AMI_BOUND_FULL,
          f"[contingency clustering labels] AMI over all rows {ami_full}: more than {AMI_BOUND_FULL} apart")
    leg["ami_against_float64"] = {"subset": ami_subset, "all rows": ami_full}
    # every row its own cluster: 50,000 ids against the 1,000 classes, past the 46,340 ids whose square table
    # an int32 cell index holds; one launch counts the 1,000 x 50,000 table in a state of side 7,072
    own = torch.randperm(CLUSTER_ROWS, generator=torch.Generator(device="cuda").manual_seed(SEED + 39),
                         device="cuda")
    before = confmat_multiclass.launches
    table = calculate_contingency_matrix(own, labels[1])
    torch.cuda.synchronize()
    check(confmat_multiclass.launches - before == 1 and table.shape == (CLUSTER_CLASSES, CLUSTER_ROWS)
          and torch.equal(table.cpu(), calculate_contingency_matrix(own.cpu(), labels[1].cpu())),
          "[contingency clustering labels] the table of 50,000 predicted ids differs from the CPU path")
    leg["own_clusters"] = {"table": list(table.shape), "launches": confmat_multiclass.launches - before}
    del table
    record["clustering labels"] = leg
    leg = _curve_leg("contingency clustering data", _clustering_data_collection, _cluster_data, kernels,
                     cpu_batches=1)
    check(len(leg["groups"]) == 1 and leg["launches"] == {"segmentation_counts": 0, "confmat_multiclass": 0,
                                                          "pairwise_lp": 2},
          f"[contingency clustering data] groups {leg['groups']}, launches {leg['launches']}")
    check(all(bool(torch.isfinite(v)) and float(v) > 0.0 for v in leg["tensors"].values()),
          f"[contingency clustering data] values {leg['values']}")
    record["clustering data"] = leg

    # (iv) nominal: occupation x education under both NaN strategies, one group (one launch) a strategy and batch
    matrix = _adult_columns()
    leg = _curve_leg("contingency nominal", _nominal_collection, _adult_batches(matrix), kernels)
    n_batches = -(-ADULT_ROWS // ADULT_BATCH)
    check(len(leg["groups"]) == 2 and leg["launches"]["confmat_multiclass"] == 2 * n_batches,
          f"[contingency nominal] groups {leg['groups']}, launches {leg['launches']}")
    check(all(0.0 <= float(v) <= 1.0 for v in leg["tensors"].values()), f"[contingency nominal] values {leg['values']}")
    record["nominal"] = leg
    confmat_multiclass.launches = 0
    matrices = {}
    for name, count in (("cramers_v_matrix", 36), ("theils_u_matrix", 72)):
        before = confmat_multiclass.launches
        value, ms = _host_ms(lambda: getattr(fn_nominal, name)(matrix))
        check(confmat_multiclass.launches - before == count, f"[contingency nominal] {name}: "
                                                             f"{confmat_multiclass.launches - before} launches")
        cpu = getattr(fn_nominal, name)(matrix.cpu())
        _assert_same(f"[contingency nominal] {name}", value, cpu)
        matrices[name] = {"ms": ms, "launches": count, "values": value.diagonal().tolist()[:1] + [float(value.min())]}
    record["nominal matrices"] = {"launches": {"confmat_multiclass": confmat_multiclass.launches}, **matrices}
    leg = _curve_leg("contingency fleiss", _fleiss_collection, _fleiss_batches, kernels)
    check(bool(torch.isfinite(leg["tensors"]["fleiss"])), f"[contingency fleiss] {leg['values']}")
    record["fleiss"] = leg

    # (v) Market-1501: one pairwise_lp launch a Manhattan or Minkowski call, held whole against the plain
    # version on the card and timed beside torch.cdist
    from torchmetrics_tpu_torch.kernels.pairwise import _pairwise_lp_plain

    gen = torch.Generator(device="cuda").manual_seed(SEED + 38)
    query = torch.rand((MARKET_QUERY, MARKET_WIDTH), generator=gen, device="cuda")
    gallery = torch.rand((MARKET_GALLERY, MARKET_WIDTH), generator=gen, device="cuda")
    flush = flush_buffer()
    calls = {"manhattan": (fpw.pairwise_manhattan_distance, {}, 1, None),
             "minkowski_2": (fpw.pairwise_minkowski_distance, {}, 2, "pow"),
             "minkowski_3": (fpw.pairwise_minkowski_distance, {"exponent": 3}, 3, "pow"),
             "minkowski_1.5": (fpw.pairwise_minkowski_distance, {"exponent": 1.5}, 1.5, "pow"),
             "euclidean": (fpw.pairwise_euclidean_distance, {}, None, None),
             "cosine": (fpw.pairwise_cosine_similarity, {}, None, None)}
    market, path_launches = {}, 0
    cpu_q, cpu_g = query[:64].cpu(), gallery[:512].cpu()
    for name, (fn, kwargs, p, root) in calls.items():
        before = pairwise_lp.launches
        out = fn(query, gallery, **kwargs)
        torch.cuda.synchronize()
        path_launches += pairwise_lp.launches - before
        check(pairwise_lp.launches - before == (1 if p is not None else 0), f"[contingency market] {name} launches")
        check(out.shape == (MARKET_QUERY, MARKET_GALLERY) and bool(torch.isfinite(out).all()),
              f"[contingency market] {name}")
        _assert_same(f"[contingency market] {name}, the first 64 x 512 against the CPU path", out[:64, :512],
                     fn(cpu_q, cpu_g, **kwargs))
        entry = {"mean": float(out.mean())}
        if p is not None:  # every term |x - y|^p is >= 0: the sum of their magnitudes is the plain pre-root sum
            want = _pairwise_lp_plain(query, gallery, p, root)
            sums = want.double().pow(float(p)) if root == "pow" else want.double()
            entry["max_abs_err"] = _lp_check(f"Market-1501 {name}", out, want, query, gallery, p, root, sums)
            del want, sums
        entry["ms"] = time_ms(lambda: fn(query, gallery, **kwargs), flush, reps=3, warmup=1)
        if p is not None:
            kw = {"compute_mode": "donot_use_mm_for_euclid_dist"} if p == 2 else {}
            entry["cdist_ms"] = time_ms(lambda: torch.cdist(query, gallery, float(p), **kw), flush, reps=3, warmup=1)
            entry["bound_ms"], entry["bound_by"] = _lp_bound_ms(MARKET_QUERY, MARKET_GALLERY, MARKET_WIDTH, p)
        market[name] = entry
        del out
    del flush
    record["market"] = {"launches": {"pairwise_lp": path_launches}, "calls": market}
    check(path_launches == 4, f"[contingency market] {path_launches} pairwise_lp launches")
    record["market"]["sm_clocks"] = sm_clocks()

    for name, leg in record.items():
        if "batches" in leg:
            print(f"[contingency] {name}: {leg['batches']} batches in {leg['leg_s']:.3f} s (the CPU rerun "
                  f"{leg['cpu_rerun_s']:.1f} s); compute groups {leg['groups']}; collection update median "
                  f"{leg['update_ms_median']:.4f} ms (host clock, a synchronize after each), compute "
                  f"{leg['compute_ms']:.4f} ms; launches {leg['launches']}; the first batches match the CPU path "
                  f"({leg['cpu_compared']} tensors); values {leg['values']}"
                  + (f"; void 255 share {leg['void_share']:.4f}, counted as class 18" if "void_share" in leg else "")
                  + (f"; AMI against float64 (bound over all rows {AMI_BOUND_FULL}): "
                     f"{leg['ami_against_float64']}" if "ami_against_float64" in leg else "")
                  + (f"; every row its own cluster: a {leg['own_clusters']['table']} table in "
                     f"{leg['own_clusters']['launches']} launch, equal to the CPU path" if "own_clusters" in leg else ""))
            del leg["tensors"]
    for name, entry in matrices.items():
        print(f"[contingency] nominal {name} over 9 Adult-shaped columns: {entry['ms']:.1f} ms (host clock), "
              f"{entry['launches']} confmat_multiclass launches, equal to the CPU path within {FLOAT_RTOL}")
    print(f"[contingency] market: the bounds take a 1.98 GHz SM clock; SM clock after the timed calls, now and at "
          f"most: {record['market']['sm_clocks']}")
    for name, entry in market.items():
        extra = (f", torch.cdist {entry['cdist_ms']:.4f} ms, bound {entry['bound_ms']:.4f} ms ({entry['bound_by']})"
                 if "cdist_ms" in entry else "")
        print(f"[contingency] market {name} ({MARKET_QUERY} x {MARKET_GALLERY} x {MARKET_WIDTH}): "
              f"{entry['ms']:.4f} ms after an L2 flush{extra}; the first 64 x 512 match the CPU path"
              + (f"; all of it the plain version on the card (max abs err {entry['max_abs_err']:.3g})"
                 if "max_abs_err" in entry else ""))
    return record


# ------------------------------------------- snr_moments and sdr_toeplitz (phase 3), phase 12
LIBRI_MIXTURES, LIBRI_SAMPLES, LIBRI_BATCH, LIBRI_FS = 3_000, 32_000, 16, 8_000  # Libri2Mix test, 8 kHz, cut to 4 s
VOICEBANK_CLIPS, VOICEBANK_SAMPLES, VOICEBANK_BATCH, VOICEBANK_FS = 824, 48_000, 16, 16_000  # VoiceBank-DEMAND test
CSISNR_MIXTURES, CSISNR_NFFT, CSISNR_HOP = 256, 512, 128  # phase 12 (iii): (i)'s first 256 mixtures as STFTs
SDR_FILTER = 512  # SignalDistortionRatio's default filter_length
AUDIO_CPU_BATCHES = 1  # the audio legs rerun their first batch on the CPU path
EPS32 = 2.0**-23  # JAX's finfo(float32).eps in the SNR family's ratios
SNR_ATOL_DB, SNR_RTOL = 1e-4, 1e-5  # snr_moments against the plain version (float32 sums of up to 9.6 M terms)
SNR64_ATOL_DB, SNR64_RTOL = 1e-5, 1e-6  # snr_moments against float64 (its output's float32 rounding)
SDR_PLAIN_DB, SDR64_DB = 1e-3, 1e-4  # sdr_toeplitz against the plain version (float32 LU) and float64 LU
X_BACKWARD_BOUND = 1e-6  # sdr_toeplitz's float32 solution: normwise backward error (its rounding is 6e-8)
DEP_FP64_CYCLES = 8  # the latency taken for one dependent fp64 operation in sdr_toeplitz's chain bound
# the least step of any O(L^2) recursion of sdr_toeplitz's kind: one block barrier, one fp64 reciprocal and one
# fused multiply-add, in cycles, as `tools/kernel_ablation.py --sections sdr` times dependent chains of each on an
# H100 (the barrier of one warp, the cheapest; the reciprocal by rcp.approx and two Newton steps, the faster form)
BARRIER_CYCLES, RCP64_CYCLES, FMA64_CYCLES = 14.6, 47.6, 9.4


def _speech_like(gen: torch.Generator, shape, fs: int, gaps: bool = False) -> torch.Tensor:
    """Seeded speech-like signals on the card: white noise low-passed by ``1 / (1 + (f / 1 kHz)^2)`` under a
    syllable-rate envelope (2-6 Hz); with ``gaps``, exact silences where a slow (0.4-0.8 Hz) wave is low."""
    dev = torch.device("cuda")
    n = shape[-1]
    rows = int(np.prod(shape[:-1]))
    freqs = torch.fft.rfftfreq(n, 1.0 / fs, device=dev)
    white = torch.randn((rows, n), generator=gen, device=dev)
    shaped = torch.fft.irfft(torch.fft.rfft(white) / (1.0 + (freqs / 1000.0) ** 2), n=n)
    t = torch.arange(n, device=dev) / fs
    rate = 2.0 + 4.0 * torch.rand((rows, 1), generator=gen, device=dev)
    phase = 2 * math.pi * torch.rand((rows, 1), generator=gen, device=dev)
    envelope = 0.2 + torch.sin(2 * math.pi * rate * t + phase).abs()
    if gaps:
        slow = 0.4 + 0.4 * torch.rand((rows, 1), generator=gen, device=dev)
        envelope = envelope * (torch.sin(2 * math.pi * slow * t + phase) > -0.5)
    x = shaped * envelope
    return (x / x.pow(2).mean(dim=-1, keepdim=True).sqrt().clamp_min(1e-12)).reshape(shape).contiguous()


def _mix_estimates(gen: torch.Generator, sources: torch.Tensor, low_db: float, high_db: float) -> torch.Tensor:
    """Each source plus a leak of the other speakers and white noise, scaled to a seeded SNR in [low_db, high_db],
    and a small seeded DC offset (so that the zero-mean and plain forms differ)."""
    dev = sources.device
    leak = sources.sum(1, keepdim=True) - sources if sources.shape[1] > 1 else torch.zeros_like(sources)
    noise = torch.randn(sources.shape, generator=gen, device=dev)
    distortion = 0.5 * leak + noise
    snr_db = low_db + (high_db - low_db) * torch.rand(sources.shape[:-1] + (1,), generator=gen, device=dev)
    scale = (sources.norm(dim=-1, keepdim=True) / distortion.norm(dim=-1, keepdim=True)) * 10 ** (-snr_db / 20)
    dc = 0.05 * (2 * torch.rand(sources.shape[:-1] + (1,), generator=gen, device=dev) - 1)
    return (sources + scale * distortion + dc).contiguous()


def _snr_float64(preds, target, scale_invariant, zero_mean, group=1, pairs=False):
    """The SNR family's direct form (the noise, then its energy) in float64 with float32's eps."""
    if pairs:
        b, s = target.shape[:2]
        preds = preds[:, None].expand(b, s, s, preds.shape[-1]).reshape(-1, preds.shape[-1])
        target = target[:, :, None].expand(b, s, s, target.shape[-1]).reshape(-1, target.shape[-1])
        return _snr_float64(preds, target, scale_invariant, zero_mean).reshape(b, s, s)
    p, t = preds.double(), target.double()
    if zero_mean:
        p, t = p - p.mean(-1, keepdim=True), t - t.mean(-1, keepdim=True)
    p, t = p.reshape(-1, group, p.shape[-1]), t.reshape(-1, group, t.shape[-1])
    if scale_invariant:
        t = ((p * t).sum((-1, -2), keepdim=True) + EPS32) / ((t * t).sum((-1, -2), keepdim=True) + EPS32) * t
    return 10 * torch.log10(((t * t).sum((-1, -2)) + EPS32) / (((t - p) ** 2).sum((-1, -2)) + EPS32))


def _db_check(label, got, want, atol, rtol):
    """``got`` within ``atol`` dB plus ``rtol`` relative of ``want``; returns the largest difference."""
    g, w = got.double(), want.double()
    err = (g - w).abs()
    worst = float(err.max()) if err.numel() else 0.0
    check(bool((err <= atol + rtol * w.abs()).all()), f"{label}: max abs err {worst} dB")
    return worst


def phase_snr_kernel(flush: torch.Tensor) -> list:
    """``snr_moments`` against its plain version (JAX's float32 forms) and a float64 evaluation on the card.
    Timed at the Libri2Mix batch (SI-SNR rows, the first row; PIT(SI-SNR) pairs) and one 10-minute 16 kHz clip,
    beside one ``torch.bmm`` of the stacked rows (their Gram matrices)."""
    from torchmetrics_tpu_torch.kernels import snr_moments as ksnr

    gen = torch.Generator(device="cuda").manual_seed(SEED + 40)
    dev = torch.device("cuda")
    libri = (LIBRI_BATCH, 2, LIBRI_SAMPLES)
    cases = [  # (what, shape, mode, scale_invariant, zero_mean, edit, timed); mode: rows, group (SA-SDR), pairs
        ("Libri2Mix batch, SI-SNR rows (a)", libri, "rows", True, True, None, True),
        ("Libri2Mix batch, PIT(SI-SNR) pairs (b)", libri, "pairs", True, True, None, True),
        ("Libri2Mix batch, SNR rows", libri, "rows", False, False, None, False),
        ("Libri2Mix batch, SNR rows, zero_mean", libri, "rows", False, True, None, False),
        ("Libri2Mix batch, SI-SDR rows", libri, "rows", True, False, None, False),
        ("Libri2Mix batch, SA-SDR groups", libri, "group", True, False, None, False),
        ("Libri2Mix batch, SA-SDR groups, plain SNR, zero_mean", libri, "group", False, True, None, False),
        ("Libri2Mix batch, PIT(SNR) pairs", libri, "pairs", False, False, None, False),
        ("one 10-minute 16 kHz clip (c)", (1, 1, 600 * 16_000), "rows", True, True, None, True),
        *((f"identical inputs, si={si}, zero_mean={zm}", (4, 2, 8000), "rows", si, zm, "identical", False)
          for si in (False, True) for zm in (False, True)),
        *((f"inputs 80 dB apart, si={si}", (4, 2, 32_000), "rows", si, False, "80db", False) for si in (False, True)),
        *((f"an all-zero target, si={si}", (2, 2, 4000), "rows", si, False, "zero", False) for si in (False, True)),
        *((f"T={n}", (3, 2, n), "rows", True, True, None, False) for n in (1, 3, 1003, 4097)),
        ("misaligned rows: scalar loads", (3, 2, 4000), "rows", True, False, "misaligned", False),
        *((f"pairs, S={s}", (5, s, 6001), "pairs", si, zm, None, False) for s in range(2, ksnr.MAX_SPEAKERS + 1)
          for si, zm in ((True, True), (False, False))),
        ("empty batch", (0, 2, 100), "rows", True, False, None, False),
    ]
    rows = []
    for what, shape, mode, si, zm, edit, timed in cases:
        target = _speech_like(gen, shape, LIBRI_FS) if shape[0] else torch.zeros(shape, device=dev)
        preds = _mix_estimates(gen, target, 5.0, 15.0) if shape[0] else torch.zeros(shape, device=dev)
        if edit == "identical":
            preds = target.clone()
        elif edit == "80db":
            preds = target + 1e-4 * torch.randn(shape, generator=gen, device=dev) * target.std()
        elif edit == "zero":
            target = torch.zeros_like(target)
        if mode != "pairs":
            preds, target = preds.reshape(-1, shape[-1]), target.reshape(-1, shape[-1])
        if edit == "misaligned":  # rows one float past a 16-byte boundary
            store = torch.empty(2 * preds.numel() + 2, device=dev)
            preds, target = (store[1 + i * preds.numel():1 + (i + 1) * preds.numel()].view(preds.shape).copy_(x)
                             for i, x in enumerate((preds, target)))
        group = shape[1] if mode == "group" else 1
        kw = {"scale_invariant": si, "zero_mean": zm, "group": group, "pairs": mode == "pairs"}
        before = ksnr.snr_moments.launches
        got = ksnr.snr_moments(preds, target, **kw)
        again = ksnr.snr_moments(preds, target, **kw)
        want = ksnr._snr_moments_plain(preds, target, **kw)
        exact = _snr_float64(preds, target, si, zm, group, mode == "pairs")
        torch.cuda.synchronize()
        label = f"{what}: {tuple(preds.shape)}, {mode}, si={si}, zero_mean={zm}"
        check(ksnr.snr_moments.launches == before + (2 if preds.shape[0] else 0), f"launches ({label})")
        check(torch.equal(got.view(torch.int32), again.view(torch.int32)), f"snr_moments is not deterministic ({label})")
        row = {"case": label, "what": what,
               "max_abs_err": _db_check(f"snr_moments against plain ({label})", got, want, SNR_ATOL_DB, SNR_RTOL),
               "max_abs_err_float64": _db_check(f"snr_moments against float64 ({label})", got, exact, SNR64_ATOL_DB,
                                                SNR64_RTOL)}
        if edit == "identical":  # a noise of exactly 0: JAX's (S + eps) / eps from the kernel's own sums
            check(bool(torch.isfinite(got).all()) and bool((got > 60).all()), f"identical inputs ({label}): {got}")
        if timed:
            nbytes = 2 * preds.numel() * 4 + got.numel() * 4
            bound_ms = nbytes / PEAK_BYTES_PER_S * 1e3
            plan = ksnr.plan(preds.shape[0], preds.shape[-1], torch.cuda.get_device_properties(0).multi_processor_count,
                             group, preds.shape[1] if mode == "pairs" else 1)
            fn = lambda p_, t_: ksnr.snr_moments(p_, t_, **kw)  # noqa: E731
            kernel_ms = time_ms(lambda: fn(preds, target), flush)
            plain_ms = time_ms(lambda: ksnr._snr_moments_plain(preds, target, **kw), flush, reps=10, warmup=1)
            stacked = torch.cat([preds.view(-1, shape[1] if mode == "pairs" else 1, shape[-1]),
                                 target.view(-1, shape[1] if mode == "pairs" else 1, shape[-1])], 1).contiguous()
            library_ms = time_ms(lambda: torch.bmm(stacked, stacked.transpose(1, 2)), flush, reps=10, warmup=1)
            del stacked
            sets = [(preds, target)] + [(preds.clone(), target.clone()) for _ in range(copies_for(nbytes) - 1)]
            stream_ms = time_stream_ms(fn, sets, calls=len(sets) * max(1, 24 // len(sets)))
            del sets
            row.update({"plan": plan._asdict(), "ms": kernel_ms, "stream_ms": stream_ms, "plain_ms": plain_ms,
                        "bound_ms": bound_ms, "bound_by": "bytes", "bytes": nbytes, "library_ms": library_ms})
            print(f"[kernel] snr_moments {label}: {kernel_ms:.4f} ms after an L2 flush ({stream_ms:.4f} ms a call "
                  f"back to back; plan {tuple(plan)}), plain {plain_ms:.4f} ms, torch.bmm of the stacked rows "
                  f"(library_ms) {library_ms:.4f} ms, bound {bound_ms * 1e3:.2f} us (bytes: {nbytes}); max abs err "
                  f"{row['max_abs_err']:.3g} dB against plain, {row['max_abs_err_float64']:.3g} against float64")
        rows.append(row)
        del preds, target, got, again, want, exact
    print(f"[kernel] snr_moments: within {SNR_ATOL_DB} dB + {SNR_RTOL} relative of plain and {SNR64_ATOL_DB} dB + "
          f"{SNR64_RTOL} relative of float64, deterministic, on all {len(cases)} cases: "
          + "; ".join(f"{r['what']} ({r['max_abs_err']:.2g}, {r['max_abs_err_float64']:.2g})" for r in rows))
    return rows


def _sdr_correlations(gen, kind, rows, length, filter_length, load_diag=None):
    """SDR's float32 ``r_0`` and ``b`` on the card, made by the port's own normalization and FFTs from seeded
    signals: speech-like (``_speech_like``; ``silent``: row 1 of it zero, ``overflow``: row 0 of it times 1e20),
    white or low-passed (8th-order Butterworth at 0.1 Nyquist) noise, or a 440 Hz tone, with a noisy estimate 10 dB
    below."""
    from torchmetrics_tpu_torch.functional.audio.sdr import _compute_autocorr_crosscorr

    dev = torch.device("cuda")
    if kind in ("speech", "silent", "overflow"):
        target = _speech_like(gen, (rows, length), LIBRI_FS)
    elif kind == "tone":
        target = torch.sin(2 * math.pi * 440 * torch.arange(length, device=dev) / LIBRI_FS).repeat(rows, 1)
    else:
        target = torch.randn((rows, length), generator=gen, device=dev)
        if kind == "lowpass":
            import scipy.signal

            b_coef, a_coef = scipy.signal.butter(8, 0.1)
            target = torch.as_tensor(scipy.signal.lfilter(b_coef, a_coef, target.cpu().double().numpy()),
                                     dtype=torch.float32, device=dev)
    preds = _mix_estimates(gen, target[:, None], 10.0, 10.0)[:, 0]
    if kind == "silent":  # row 1 silent: a singular system, NaN in plain (JAX's solve) and kernel alike
        target[1] = 0.0
    elif kind == "overflow":  # row 0 at 1e20: its float32 norm overflows, so it normalises to silence
        target[0] *= 1e20
    target = target / target.norm(dim=-1, keepdim=True).clamp_min(1e-6)
    preds = preds / preds.norm(dim=-1, keepdim=True).clamp_min(1e-6)
    r_0, b = _compute_autocorr_crosscorr(target, preds, filter_length)
    if load_diag is not None:
        r_0 = torch.cat([r_0[:, :1] + load_diag, r_0[:, 1:]], dim=-1)
    return r_0.contiguous(), b.contiguous()


def _backward_error(r_0: torch.Tensor, b: torch.Tensor, x: torch.Tensor) -> float:
    """The largest normwise backward error of the solutions ``x`` of ``toeplitz(r_0) x = b``, in float64:
    ``|R x - b|_inf / (|R|_inf |x|_inf + |b|_inf)``. An ill-conditioned system (a low-passed target) leaves x
    itself far from a float64 LU's, but not its residual."""
    from torchmetrics_tpu_torch.kernels.sdr_toeplitz import _symmetric_toeplitz

    worst = 0.0
    for rows in torch.arange(r_0.shape[0], device=r_0.device).split(64 if r_0.shape[1] <= 1024 else 1):
        matrix = _symmetric_toeplitz(r_0[rows].double())
        xs, bs = x[rows].double(), b[rows].double()
        residual = (matrix @ xs[..., None])[..., 0] - bs
        scale = matrix.abs().sum(-1).amax(-1) * xs.abs().amax(-1) + bs.abs().amax(-1)
        worst = max(worst, float((residual.abs().amax(-1) / scale).max()))
    return worst


def _sdr_chain_bound_ms(length: int) -> float:
    """The Levinson chain's least latency: a step's two dot products reduce over k terms in ceil(log2 k)
    dependent adds, then mu, alpha and the update take about 3 more, each ``DEP_FP64_CYCLES`` at the boost clock."""
    steps = sum(math.ceil(math.log2(k)) + 3 if k > 1 else 3 for k in range(1, length))
    return steps * DEP_FP64_CYCLES / CLOCK_HZ * 1e3


def _sdr_least_chain_ms(length: int) -> float:
    """The least chain of any O(L^2) recursion of ``sdr_toeplitz``'s kind: L - 1 steps of one block barrier, one fp64
    reciprocal and one fused multiply-add (``BARRIER_CYCLES``, ``RCP64_CYCLES``, ``FMA64_CYCLES``) at the boost
    clock."""
    return max(length - 1, 0) * (BARRIER_CYCLES + RCP64_CYCLES + FMA64_CYCLES) / CLOCK_HZ * 1e3


def phase_sdr_kernel(flush: torch.Tensor) -> list:
    """``sdr_toeplitz`` against its plain version (JAX's float32 build and LU) and a float64 LU on the card.
    Timed at the Libri2Mix batch's 32 rows (the first row) and PIT(SDR)'s 64, L = 512, beside
    ``torch.linalg.solve`` on the built matrices in float32 (``library_ms``) and float64."""
    from torchmetrics_tpu_torch.kernels import sdr_toeplitz as ksdr

    gen = torch.Generator(device="cuda").manual_seed(SEED + 41)
    cases = [  # (what, kind, rows, samples, L, load_diag, timed)
        ("Libri2Mix batch (a)", "speech", 2 * LIBRI_BATCH, LIBRI_SAMPLES, SDR_FILTER, None, True),
        ("PIT(SDR)'s tile of the Libri2Mix batch (b)", "speech", 4 * LIBRI_BATCH, LIBRI_SAMPLES, SDR_FILTER, None,
         True),
        ("white target", "white", 8, 8000, SDR_FILTER, None, False),
        ("low-passed target", "lowpass", 8, 8000, SDR_FILTER, None, False),
        ("load_diag 1e-2", "lowpass", 8, 8000, SDR_FILTER, 1e-2, False),
        ("L=1", "white", 8, 2000, 1, None, False),
        ("L=2", "white", 4, 2000, 2, None, False),
        ("L=300, not a power of two", "speech", 8, 4000, 300, None, False),
        ("L=33", "speech", 8, 4000, 33, None, False),
        (f"the largest L, {ksdr.MAX_LENGTH}", "white", 2, 2 * ksdr.MAX_LENGTH, ksdr.MAX_LENGTH, None, False),
        ("a pure tone, no load_diag (recorded, not held)", "tone", 2, 8000, SDR_FILTER, None, False),
        ("a pure tone, load_diag 1e-6", "tone", 2, 8000, SDR_FILTER, 1e-6, False),
        ("a silent target row (NaN)", "silent", 4, 8000, SDR_FILTER, None, False),
        ("a 1e20 target row, its norm overflowing (NaN)", "overflow", 4, 8000, SDR_FILTER, None, False),
    ]
    rows = []
    for what, kind, n_rows, samples, length, load_diag, timed in cases:
        r_0, b = _sdr_correlations(gen, kind, n_rows, samples, length, load_diag)
        before = ksdr.sdr_toeplitz.launches
        got, x = ksdr.sdr_toeplitz(r_0, b)
        again, _ = ksdr.sdr_toeplitz(r_0, b)
        want, _ = ksdr._sdr_toeplitz_plain(r_0, b)
        exact, x64 = ksdr._sdr_toeplitz_plain(r_0.double(), b.double())
        torch.cuda.synchronize()
        label = f"{what}: {n_rows} x L={length}, {kind}, load_diag {load_diag}"
        check(ksdr.sdr_toeplitz.launches == before + 2, f"launches ({label})")
        check(torch.equal(got.view(torch.int32), again.view(torch.int32)), f"sdr_toeplitz is not deterministic ({label})")
        # a singular system (a silent row) is NaN in the plain version and float64 alike: the kernel's too
        nan_rows = torch.isnan(want)
        check(torch.equal(torch.isnan(got), nan_rows) and torch.equal(torch.isnan(exact), nan_rows)
              and bool(nan_rows.any()) == (kind in ("silent", "overflow")),
              f"sdr_toeplitz's NaN rows ({label}): kernel {got.tolist()}, plain {want.tolist()}")
        keep = ~nan_rows
        got, want, exact, x, x64, r_0, b = (v[keep] for v in (got, want, exact, x, x64, r_0, b))
        err_plain = float((got.double() - want.double()).abs().max())
        err64 = float((got.double() - exact).abs().max())
        x_err = float((x.double() - x64).abs().max() / x64.abs().max().clamp_min(1e-30))
        x_backward = _backward_error(r_0, b, x)
        row = {"case": label, "what": what, "sdr": [float(v) for v in got[:2]], "plain": [float(v) for v in want[:2]],
               "float64": [float(v) for v in exact[:2]], "nan_rows": int(nan_rows.sum())}
        if kind == "tone" and load_diag is None:  # recorded beside the plain version's value, not held
            row.update({"unheld_abs_err": err_plain, "unheld_abs_err_float64": err64, "unheld_x_rel_err": x_err,
                        "unheld_x_backward_error": x_backward})
        else:  # against plain within 1e-3 dB, or within the plain version's own distance from float64 (+ 1e-4)
            plain_drift = (want.double() - exact).abs()
            row.update({"max_abs_err": err_plain, "max_abs_err_float64": err64, "x_rel_err_float64": x_err,
                        "x_backward_error": x_backward, "plain_drift_float64": float(plain_drift.max())})
            held = bool(((got.double() - want.double()).abs() <= (plain_drift + SDR64_DB).clamp_min(SDR_PLAIN_DB)).all())
            check(held and err64 <= SDR64_DB and x_backward <= X_BACKWARD_BOUND,
                  f"sdr_toeplitz ({label}): {err_plain:.3g} dB from plain (plain {float(plain_drift.max()):.3g} from "
                  f"float64), {err64:.3g} dB from float64, x's backward error {x_backward:.3g}")
        if timed:
            ops = 4 * length**2 * n_rows
            ops_ms = ops / PEAK_FP64_OPS_PER_S * 1e3
            nbytes = (3 * n_rows * length + n_rows) * 4
            bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
            bound_ms, bound_by = max((ops_ms, "operations"), (bytes_ms, "bytes"))
            chain_ms = _sdr_chain_bound_ms(length)
            least_ms = _sdr_least_chain_ms(length)
            kernel_ms = time_ms(lambda: ksdr.sdr_toeplitz(r_0, b), flush)
            plain_ms = time_ms(lambda: ksdr._sdr_toeplitz_plain(r_0, b), flush, reps=10, warmup=1)
            matrix = ksdr._symmetric_toeplitz(r_0)
            rhs = b[..., None].contiguous()
            library_ms = time_ms(lambda: torch.linalg.solve(matrix, rhs), flush, reps=10, warmup=1)
            matrix64, rhs64 = matrix.double(), rhs.double()
            library64_ms = time_ms(lambda: torch.linalg.solve(matrix64, rhs64), flush, reps=10, warmup=1)
            del matrix, rhs, matrix64, rhs64
            sets = [(r_0, b)] + [(r_0.clone(), b.clone()) for _ in range(3)]
            stream_ms = time_stream_ms(lambda r_, b_: ksdr.sdr_toeplitz(r_, b_), sets, calls=16)
            row.update({"ms": kernel_ms, "stream_ms": stream_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "operations": ops, "chain_bound_ms": chain_ms,
                        "least_chain_ms": least_ms, "chain_share": min(chain_ms, least_ms) / kernel_ms,
                        "plan": ksdr.plan(length), "library_ms": library_ms, "library_float64_ms": library64_ms})
            print(f"[kernel] sdr_toeplitz {label}: {kernel_ms:.4f} ms after an L2 flush ({stream_ms:.4f} ms a call "
                  f"back to back), plain (build + float32 solve + coherence) {plain_ms:.4f} ms, torch.linalg.solve "
                  f"on the built matrices (library_ms) {library_ms:.4f} ms in float32, {library64_ms:.4f} ms in "
                  f"float64; bound {bound_ms * 1e3:.3f} us ({bound_by}: {ops} fp64 operations), the L-step chain "
                  f"{chain_ms:.4f} ms at {DEP_FP64_CYCLES} cycles a dependent fp64 operation and {CLOCK_HZ / 1e9} GHz "
                  f"(Levinson's), the least chain {least_ms:.4f} ms ({BARRIER_CYCLES} + {RCP64_CYCLES} + "
                  f"{FMA64_CYCLES} cycles a step), share {row['chain_share']:.1%} of the smaller; block "
                  f"{row['plan'][1]} threads x {row['plan'][0]} entries")
        rows.append(row)
    print(f"[kernel] sdr_toeplitz: within {SDR64_DB} dB of float64 LU (x's backward error within {X_BACKWARD_BOUND}) "
          f"and, of plain, within "
          f"{SDR_PLAIN_DB} dB or the plain version's own distance from float64 plus {SDR64_DB}, deterministic, on "
          f"all held cases (from plain, from float64, plain from float64): "
          + "; ".join(f"{r['what']} ({r['max_abs_err']:.2g}, {r['max_abs_err_float64']:.2g}, "
                      f"{r['plain_drift_float64']:.2g})" for r in rows if "max_abs_err" in r))
    tone = next(r for r in rows if "unheld_abs_err" in r)
    print(f"[kernel] sdr_toeplitz on the pure tone without load_diag (not held): kernel {tone['sdr']}, plain "
          f"(float32 LU) {tone['plain']}, float64 LU {tone['float64']} dB (x {tone['unheld_x_rel_err']:.3g} from "
          f"float64 relative, backward error {tone['unheld_x_backward_error']:.3g})")
    return rows


def _libri_batches(n_mixtures=None, stft: bool = False):
    """Libri2Mix test's shape: seeded two-speaker sources at 8 kHz (``_speech_like``) and estimates 5-15 dB below
    them (``_mix_estimates``), the speakers swapped in every other batch; with ``stft``, both as 512-point STFTs
    (hop 128, Hann), complex ``(B, 2, 257, frames)``."""
    n_mixtures = n_mixtures or LIBRI_MIXTURES

    def batches():
        gen = torch.Generator(device="cuda").manual_seed(SEED + 42)
        window = torch.hann_window(CSISNR_NFFT, device="cuda")
        for i, i0 in enumerate(range(0, n_mixtures, LIBRI_BATCH)):
            sources = _speech_like(gen, (min(LIBRI_BATCH, n_mixtures - i0), 2, LIBRI_SAMPLES), LIBRI_FS)
            estimates = _mix_estimates(gen, sources, 5.0, 15.0)
            if i % 2:
                estimates = estimates.flip(1).contiguous()
            if stft:
                estimates, sources = (torch.stft(x.view(-1, LIBRI_SAMPLES), CSISNR_NFFT, CSISNR_HOP, window=window,
                                                 return_complex=True).view(*x.shape[:2], CSISNR_NFFT // 2 + 1, -1)
                                      for x in (estimates, sources))
            yield (estimates, sources), {}
    return batches


def _voicebank_batches():
    """VoiceBank-DEMAND test's shape: 824 seeded speech-like 16 kHz clips of 3 s with exact silences (so that
    silent-frame removal has work) and a noisy copy at a seeded 0-15 dB, passed by keyword (SRMR takes ``preds``)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 43)
    for i0 in range(0, VOICEBANK_CLIPS, VOICEBANK_BATCH):
        clean = _speech_like(gen, (min(VOICEBANK_BATCH, VOICEBANK_CLIPS - i0), VOICEBANK_SAMPLES), VOICEBANK_FS,
                             gaps=True)
        snr_db = 15.0 * torch.rand((clean.shape[0], 1), generator=gen, device="cuda")
        noise = torch.randn(clean.shape, generator=gen, device="cuda")
        noisy = clean + noise * clean.norm(dim=-1, keepdim=True) / noise.norm(dim=-1, keepdim=True) * 10 ** (-snr_db / 20)
        yield (), {"preds": noisy.contiguous(), "target": clean}


def _audio_libri(device, compute_groups):
    from torchmetrics_tpu_torch import audio as ta
    from torchmetrics_tpu_torch.collections import MetricCollection
    from torchmetrics_tpu_torch.functional import audio as fa

    kw = {"device": device}
    return MetricCollection({
        "snr": ta.SignalNoiseRatio(**kw), "si_snr": ta.ScaleInvariantSignalNoiseRatio(**kw),
        "si_sdr": ta.ScaleInvariantSignalDistortionRatio(**kw), "sa_sdr": ta.SourceAggregatedSignalDistortionRatio(**kw),
        "sdr": ta.SignalDistortionRatio(filter_length=SDR_FILTER, **kw),
        "pit_si_snr": ta.PermutationInvariantTraining(fa.scale_invariant_signal_noise_ratio, **kw),
        "pit_sdr": ta.PermutationInvariantTraining(fa.signal_distortion_ratio, **kw),
    }, compute_groups=compute_groups)


def _audio_voicebank(device, compute_groups):
    from torchmetrics_tpu_torch import audio as ta
    from torchmetrics_tpu_torch.collections import MetricCollection

    kw = {"fs": VOICEBANK_FS, "device": device}
    return MetricCollection({"stoi": ta.ShortTimeObjectiveIntelligibility(**kw),
                             "estoi": ta.ShortTimeObjectiveIntelligibility(extended=True, **kw),
                             "srmr": ta.SpeechReverberationModulationEnergyRatio(**kw)}, compute_groups=compute_groups)


def _audio_csisnr(device, compute_groups):
    from torchmetrics_tpu_torch import audio as ta
    from torchmetrics_tpu_torch.collections import MetricCollection

    return MetricCollection({"c_si_snr": ta.ComplexScaleInvariantSignalNoiseRatio(device=device)},
                            compute_groups=compute_groups)


def phase_audio() -> dict:
    """Phase 12 on one card, no sync: (i) Libri2Mix test's shape through the SNR family, SDR and speaker-wise PIT
    over SI-SNR and SDR; (ii) VoiceBank-DEMAND test's shape through STOI, extended STOI and SRMR; (iii) C-SI-SNR on
    the 512-point STFTs of (i)'s first 256 mixtures."""
    from torchmetrics_tpu_torch.kernels.sdr_toeplitz import sdr_toeplitz
    from torchmetrics_tpu_torch.kernels.snr_moments import snr_moments

    kernels = (snr_moments, sdr_toeplitz)
    record = {}

    # (i) seven metrics, seven groups: one snr_moments launch a batch each for SNR, SI-SNR, SI-SDR, SA-SDR and
    # PIT(SI-SNR) (its pairs mode); one sdr_toeplitz launch a batch each for SDR and PIT(SDR) (its tile's rows)
    leg = _curve_leg("audio libri2mix", _audio_libri, _libri_batches(), kernels, cpu_batches=AUDIO_CPU_BATCHES)
    n_batches = -(-LIBRI_MIXTURES // LIBRI_BATCH)
    check(len(leg["groups"]) == 7 and leg["launches"] == {"snr_moments": 5 * n_batches, "sdr_toeplitz": 2 * n_batches},
          f"[audio libri2mix] groups {leg['groups']}, launches {leg['launches']}: {5 * n_batches} snr_moments and "
          f"{2 * n_batches} sdr_toeplitz launches expected")
    t = leg["tensors"]
    check(all(bool(torch.isfinite(v)) for v in t.values()), f"[audio libri2mix] values {leg['values']}")
    check(float(t["pit_si_snr"]) > float(t["si_snr"]) + 5.0 and float(t["pit_sdr"]) > float(t["sdr"]) + 5.0,
          f"[audio libri2mix] PIT does not undo the swapped batches: {leg['values']}")
    record["libri2mix"] = leg

    # (ii) three metrics, three groups, no kernel (torch float64 ops on the card)
    leg = _curve_leg("audio voicebank", _audio_voicebank, _voicebank_batches, kernels, cpu_batches=AUDIO_CPU_BATCHES)
    check(len(leg["groups"]) == 3 and leg["launches"] == {"snr_moments": 0, "sdr_toeplitz": 0},
          f"[audio voicebank] groups {leg['groups']}, launches {leg['launches']}")
    t = leg["tensors"]
    check(0.3 < float(t["stoi"]) < 1.0 and 0.1 < float(t["estoi"]) < 1.0 and 0.0 < float(t["srmr"]) < 100.0,
          f"[audio voicebank] values {leg['values']}")
    record["voicebank"] = leg

    # (iii) one snr_moments launch a batch over the STFTs' F x T x 2 values of each source
    leg = _curve_leg("audio csisnr", _audio_csisnr, _libri_batches(CSISNR_MIXTURES, stft=True), kernels,
                     cpu_batches=AUDIO_CPU_BATCHES)
    n_batches = CSISNR_MIXTURES // LIBRI_BATCH
    check(leg["launches"] == {"snr_moments": n_batches, "sdr_toeplitz": 0}, f"[audio csisnr] {leg['launches']}")
    check(bool(torch.isfinite(leg["tensors"]["c_si_snr"])), f"[audio csisnr] {leg['values']}")
    record["csisnr"] = leg

    for name, leg in record.items():
        print(f"[audio] {name}: {leg['batches']} batches in {leg['leg_s']:.3f} s (the CPU rerun "
              f"{leg['cpu_rerun_s']:.1f} s); compute groups {leg['groups']}; collection update median "
              f"{leg['update_ms_median']:.4f} ms (host clock, a synchronize after each), compute "
              f"{leg['compute_ms']:.4f} ms; launches {leg['launches']}, as the batches and metrics imply; the first "
              f"batch matches the CPU path ({leg['cpu_compared']} tensors within rtol {FLOAT_RTOL}, atol "
              f"{FLOAT_ATOL}); values {leg['values']}")
        del leg["tensors"]
    return record


# ------------------------------------------- perplexity_nll and bert_greedy_match (phase 3), phase 13
GPT2_VOCAB, LLAMA3_VOCAB = 50_257, 128_256  # GPT-2's and Llama-3's tokenizers
PPL_RTOL = 1e-5  # perplexity_nll's total against the plain version (float32 sums of up to 8,192 row NLLs)
BERT_ATOL = 1e-5  # bert_greedy_match's P, R and F1 against the plain version
WMT16_PAIRS, WMT16_MAX_TOKENS = 2_999, 128  # newstest2016 de-en, padded to 128 tokens
ROBERTA_LARGE = {"vocab_size": 50_265, "hidden_size": 1_024, "num_attention_heads": 16, "intermediate_size": 4_096,
                 "max_position_embeddings": 514, "type_vocab_size": 1, "layer_norm_eps": 1e-5, "pad_token_id": 1,
                 "bos_token_id": 0, "eos_token_id": 2}
ROBERTA_LAYERS = 17  # torchmetrics' default layer for roberta-large: the layers above it leave hidden_states[17]
BERT_TINY = {"vocab_size": 30_522, "hidden_size": 128, "num_hidden_layers": 2, "num_attention_heads": 2,
             "intermediate_size": 512}  # google/bert_uncased_L-2_H-128_A-2
WIKITEXT103_TOKENS, PPL_BATCH, PPL_SEQ = 280_000, 8, 1_024  # WikiText-103 test in GPT-2 tokens, about
TEXT_PAIRS, TEXT_UPDATE = 2_000, 100  # phase 13 (iv): the host metrics
TEXT_DP_UPDATES = 5  # TER's and EED's Python DPs (about 2 s and 0.7 s an update): their first 500 pairs, for the
# run's time when phases 14 and 15 came
BERT_UPDATE, INFOLM_PAIRS, INFOLM_UPDATE, INFOLM_MAX_LENGTH = 64, 256, 32, 32


def _ppl_case(gen, n_rows, vocab, dtype, ignore_index, edit):
    """Seeded ``(N, V)`` logits (scale 3) and targets on the card, with ``ignore_index`` on about 2 % of the rows,
    and the edit: ignored rows of NaN and +-inf, or a target of -1, -V, V or -V - 1 on row 0."""
    dev = torch.device("cuda")
    logits = (3.0 * torch.randn((n_rows, vocab), generator=gen, device=dev)).to(dtype)
    target = torch.randint(0, vocab, (n_rows,), generator=gen, device=dev)
    if ignore_index is not None and n_rows:
        target[torch.rand((n_rows,), generator=gen, device=dev) < 0.02] = ignore_index
    if edit == "ignored non-finite":
        target[1:4] = ignore_index
        logits[1], logits[2, 0], logits[3, 0] = float("nan"), float("inf"), float("-inf")
    elif isinstance(edit, int):
        target[0] = edit
    return logits.contiguous(), target.contiguous()


def phase_perplexity_kernel(flush: torch.Tensor) -> list:
    """``perplexity_nll`` against its plain version (JAX's float32 ``log_softmax`` form) on the card: the total
    within 1e-5 relative (NaN where it is NaN), the count exactly, two launches equal bit for bit; timed at GPT-2's
    vocabulary on 8 x 1,024 float32 rows (the first row) and Llama-3's on 4 x 2,048 bfloat16 rows, beside
    ``F.cross_entropy(reduction="sum")`` (``library_ms``); its backward against autograd of the plain version."""
    from torchmetrics_tpu_torch.kernels import perplexity as kppl

    gen = torch.Generator(device="cuda").manual_seed(SEED + 50)
    f32, bf16, f16 = torch.float32, torch.bfloat16, torch.float16
    cases = [  # (what, rows, V, dtype, ignore_index, edit, timed)
        ("GPT-2 batch, 8 x 1,024 (a)", PPL_BATCH * PPL_SEQ, GPT2_VOCAB, f32, -100, None, True),
        ("Llama-3 batch, 4 x 2,048 (b)", 4 * 2_048, LLAMA3_VOCAB, bf16, -100, None, True),
        *((f"V={v}", 1_000, v, f32, -100, None, False) for v in (1, 2, 3, GPT2_VOCAB + 1)),
        ("V=4096, a warp a row (the largest)", 2_000, 4_096, f32, None, None, False),
        ("V=4097, a block a row (the smallest)", 2_000, 4_097, f32, None, None, False),
        ("float16", 2_048, 32_000, f16, -100, None, False),
        ("bfloat16, a warp a row", 3_001, 1_000, bf16, 0, None, False),
        *((f"ignore_index {ii}", 1_024, 8_000, f32, ii, None, False) for ii in (None, -100, 0)),
        ("ignored rows of NaN and +-inf", 1_024, 8_000, f32, -100, "ignored non-finite", False),
        *((f"target {t}", 512, 5_000, f32, -100, t, False) for t in (-1, -5_000, 5_000, -5_001)),
        ("an empty batch", 0, 5_000, f32, -100, None, False),
    ]
    rows = []
    for what, n_rows, vocab, dtype, ignore_index, edit, timed in cases:
        logits, target = _ppl_case(gen, n_rows, vocab, dtype, ignore_index, edit)
        before = kppl.perplexity_nll.launches
        got = kppl.perplexity_nll(logits, target, ignore_index)
        again = kppl.perplexity_nll(logits, target, ignore_index)
        want = kppl._perplexity_nll_plain(logits, target, ignore_index)
        torch.cuda.synchronize()
        label = f"{what}: {n_rows} x {vocab} {str(dtype)[6:]}, ignore_index {ignore_index}"
        check(kppl.perplexity_nll.launches == before + (2 if n_rows else 0), f"launches ({label})")
        check(all(torch.equal(g.view(torch.int32), a.view(torch.int32)) for g, a in zip(got, again)),
              f"perplexity_nll is not deterministic ({label})")
        total, want_total = float(got[0]), float(want[0])
        nan = math.isnan(want_total)
        check(math.isnan(total) == nan and float(got[1]) == float(want[1])
              and (nan or abs(total - want_total) <= PPL_RTOL * abs(want_total) or total == want_total),
              f"perplexity_nll ({label}): ({total}, {float(got[1])}) against plain ({want_total}, {float(want[1])})")
        err = 0.0 if nan or total == want_total else abs(total - want_total) / max(abs(want_total), 1e-30)
        row = {"case": label, "what": what, "total": total, "plain_total": want_total, "count": float(got[1]),
               "max_abs_err": 0.0 if nan or total == want_total else abs(total - want_total), "rel_err": err}
        if edit in (-1, -vocab):
            check(not math.isnan(total), f"perplexity_nll ({label}): a target in [-V, 0) wraps once")
        if edit in (vocab, -vocab - 1):
            check(math.isnan(total), f"perplexity_nll ({label}): a target outside [-V, V) makes the total NaN")
        if edit == "ignored non-finite":
            check(math.isfinite(total), f"perplexity_nll ({label}): ignored rows add nothing")
        if n_rows == 0:
            check(total == 0.0 and math.copysign(1.0, total) < 0 and float(got[1]) == 0.0, f"empty batch: {got}")
        if timed:
            tkind = target.element_size()
            nbytes = logits.numel() * logits.element_size() + n_rows * (tkind + 4) + 8
            bound_ms = nbytes / PEAK_BYTES_PER_S * 1e3
            fn = lambda x_, t_: kppl.perplexity_nll(x_, t_, ignore_index)  # noqa: E731
            kernel_ms = time_ms(lambda: fn(logits, target), flush)
            plain_ms = time_ms(lambda: kppl._perplexity_nll_plain(logits, target, ignore_index), flush, reps=10,
                               warmup=1)
            library_ms = time_ms(lambda: torch.nn.functional.cross_entropy(
                logits, target, ignore_index=-100 if ignore_index is None else ignore_index, reduction="sum"),
                flush, reps=10, warmup=1)
            sets = [(logits, target)] + [(logits.clone(), target.clone()) for _ in range(copies_for(nbytes) - 1)]
            stream_ms = time_stream_ms(fn, sets, calls=len(sets) * max(1, 24 // len(sets)))
            del sets
            row.update({"ms": kernel_ms, "stream_ms": stream_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": "bytes", "bytes": nbytes, "library_ms": library_ms,
                        "row_threads": kppl.plan(vocab)})
            print(f"[kernel] perplexity_nll {label}: {kernel_ms:.4f} ms after an L2 flush ({stream_ms:.4f} ms a call "
                  f"back to back), plain (log_softmax + gather + sums) {plain_ms:.4f} ms, F.cross_entropy "
                  f"(library_ms) {library_ms:.4f} ms, bound {bound_ms * 1e3:.2f} us (bytes: {nbytes}), share "
                  f"{bound_ms / kernel_ms:.1%}; {kppl.plan(vocab)} threads a row; total {total!r}, rel err {err:.3g}")
        rows.append(row)
        del logits, target, got, again, want

    # the backward: the kernel forward with grad, against autograd of the plain version, at GPT-2's vocabulary
    logits, target = _ppl_case(gen, 512, GPT2_VOCAB, f32, -100, None)
    x = logits.clone().requires_grad_()
    before = kppl.perplexity_nll.launches
    kppl.perplexity_nll(x, target, -100)[0].mul(0.5).backward()
    check(kppl.perplexity_nll.launches == before + 1, "perplexity_nll: an input that requires grad takes the kernel")
    y = logits.clone().requires_grad_()
    kppl._perplexity_nll_plain(y, target, -100)[0].mul(0.5).backward()
    grad_err = float((x.grad - y.grad).abs().max())
    check(torch.allclose(x.grad, y.grad, rtol=1e-5, atol=1e-8),
          f"perplexity_nll's backward differs from autograd of the plain version by {grad_err}")
    rows.append({"case": "backward, 512 x 50,257 float32, ignore_index -100", "what": "backward",
                 "max_abs_err_grad": grad_err})
    print(f"[kernel] perplexity_nll: the total within {PPL_RTOL} relative of plain and the count equal, "
          f"deterministic, on all {len(cases)} cases; the backward within 1e-5 relative of autograd (max abs err "
          f"{grad_err:.3g}): " + "; ".join(f"{r['what']} ({r.get('rel_err', 0):.2g})" for r in rows[:-1]))
    return rows


def _encoder_like(gen, x):
    """Embeddings shaped like a trained encoder's from Gaussian ones: a direction shared by every token (mean cosine
    about 0.24) and four outlier dimensions 40 times the others, where one TF32 product errs by about 1e-4."""
    h = x.shape[-1]
    u = torch.randn(h, generator=gen, device=x.device)
    x = x + u * (0.8 * h**0.5 / u.norm())
    dims = torch.randperm(h, generator=gen, device=x.device)[:4]
    x[..., dims] *= 40.0
    return x


def _bert_case(gen, pairs, tp, tt, h, lengths=None, edit=None):
    """Seeded ``(B, Tp, H)`` and ``(B, Tt, H)`` float32 embeddings on the card with 0/1 masks (a seeded valid
    length a row, or ``lengths``: the range the lengths are drawn from), and the edit's weights or changes."""
    dev = torch.device("cuda")
    pe = torch.randn((pairs, tp, h), generator=gen, device=dev)
    te = torch.randn((pairs, tt, h), generator=gen, device=dev)
    if edit == "encoder-like":
        pe, te = _encoder_like(gen, pe), _encoder_like(gen, te)
    lo, hi = lengths or (1, max(tp, tt))
    lp = torch.randint(lo, min(hi, tp) + 1, (pairs, 1), generator=gen, device=dev)
    lt = torch.randint(lo, min(hi, tt) + 1, (pairs, 1), generator=gen, device=dev)
    pm = (torch.arange(tp, device=dev) < lp).float()
    tm = (torch.arange(tt, device=dev) < lt).float()
    pw = tw = None
    if edit == "idf":
        pw, tw = (torch.rand(m.shape, generator=gen, device=dev) * 5 for m in (pm, tm))
    elif edit == "masked rows":
        pm[0], tm[1] = 0.0, 0.0
    elif edit == "negative rows":  # every valid similarity of pairs 0 and 1 negative; pair 1 has an invalid entry
        te = te.abs()
        pe = -pe.abs()
        tm[0], tm[1] = 1.0, 1.0
        tm[1, -1] = 0.0
    elif edit == "zero norms":
        pe[:, :2] = 0.0
        te[:, 1] = 0.0
    elif edit == "holes":  # [CLS] and [SEP] left out: position 0 and the last valid token
        for m, n in ((pm, lp), (tm, lt)):
            m[:, 0] = 0.0
            m.scatter_(1, n - 1, 0.0)
    elif edit in NON_FINITE:  # pair 0: a valid prediction row; pair 1: a valid target row; pair 2: masked rows
        value = NON_FINITE[edit]
        pm[:, 1], tm[:, 1] = 1.0, 1.0
        pm[2, 3], tm[2, 4] = 0.0, 0.0
        pe[0, 1, h // 2] = value
        te[1, 1, 0] = value
        pe[2, 3, 1], te[2, 4, h - 1] = value, value
    return pe.contiguous(), pm, te.contiguous(), tm, pw, tw


NON_FINITE = {"NaN": float("nan"), "+inf": float("inf"), "-inf": float("-inf")}


def _no_tf32():
    """The plain version's and the yardstick's float32 products in full float32: TF32 matmuls off, printed."""
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[kernel] bert_greedy_match: torch.backends.cuda.matmul.allow_tf32 = "
          f"{torch.backends.cuda.matmul.allow_tf32} for the plain version and the yardstick")


def phase_bert_kernel(flush: torch.Tensor) -> list:
    """``bert_greedy_match`` against its plain version (JAX's ``_bert_score_from_embeddings``) on the card: P, R
    and F1 within 1e-5 absolute (where P + R <= 0, F1's 1e-12 clamp makes it up to 1e11: there it is held within
    1e-5 relative to the formula on the kernel's own P and R), NaN exactly where the plain version is NaN, two
    launches equal bit for bit; timed at WMT16 newstest2016's 2,999 pairs of roberta-large's 1,024-wide
    embeddings, lengths 10-128 padded to 128 (the first row), beside ``torch.bmm`` and two ``amax`` (several
    calls, a yardstick). The plain version and the yardstick run with TF32 matmuls off."""
    from torchmetrics_tpu_torch.kernels import bert_match as kbm

    _no_tf32()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 51)
    t_max = WMT16_MAX_TOKENS
    cases = [  # (what, pairs, Tp, Tt, H, lengths, edit, timed)
        ("WMT16 newstest2016 pairs (a)", WMT16_PAIRS, t_max, t_max, 1_024, (10, t_max), None, True),
        ("WMT16 pairs, encoder-like embeddings (a shared direction, four outlier dimensions at 40x)", WMT16_PAIRS,
         t_max, t_max, 1_024, (10, t_max), "encoder-like", False),
        ("special-token holes (position 0 and the last valid token masked)", 64, t_max, t_max, 1_024, (3, t_max),
         "holes", False),
        *((f"{name} in a valid prediction row, a valid target row and masked rows", 8, 12, 14, 1_024, (6, 12), name,
           False) for name in NON_FINITE),
        ("Tp != Tt", 64, 37, 100, 768, None, None, False),
        ("T = 1", 16, 1, 1, 1_024, None, None, False),
        ("all-masked rows", 8, 20, 30, 64, None, "masked rows", False),
        ("negative valid similarities, with and without an invalid entry", 4, 6, 9, 32, None, "negative rows",
         False),
        ("zero-norm embeddings", 4, 10, 12, 48, None, "zero norms", False),
        ("idf weights", 64, t_max, t_max, 1_024, (10, t_max), "idf", False),
        *((f"H = {h}", 16, 50, 70, h, None, None, False) for h in (1, 33, 4_096)),
        ("Tp = Tt = 3,000: past 128 listed tokens a side, passes over blocks", 2, 3_000, 3_000, 64, None, None, False),
        ("an empty batch", 0, 10, 10, 64, None, None, False),
    ]
    rows = []
    for what, pairs, tp, tt, h, lengths, edit, timed in cases:
        pe, pm, te, tm, pw, tw = _bert_case(gen, pairs, tp, tt, h, lengths, edit)
        before = kbm.bert_greedy_match.launches
        got = kbm.bert_greedy_match(pe, pm, te, tm, pw, tw)
        again = kbm.bert_greedy_match(pe, pm, te, tm, pw, tw)
        want = kbm._bert_greedy_match_plain(pe, pm, te, tm, pw, tw)
        torch.cuda.synchronize()
        label = f"{what}: {pairs} pairs, Tp={tp}, Tt={tt}, H={h}"
        check(kbm.bert_greedy_match.launches == before + (2 if pairs else 0), f"launches ({label})")
        check(all(torch.equal(g.view(torch.int32), a.view(torch.int32)) for g, a in zip(got, again)),
              f"bert_greedy_match is not deterministic ({label})")  # bit for bit, NaN too
        nan_equal = all(torch.equal(g.isnan(), w.isnan()) for g, w in zip(got, want))
        check(nan_equal, f"bert_greedy_match ({label}): NaN at {[g.isnan().nonzero().flatten().tolist() for g in got]}, "
                         f"plain at {[w.isnan().nonzero().flatten().tolist() for w in want]}")
        finite = ~want[0].isnan() & ~want[1].isnan()  # the entries past the NaN check
        err = max((float((g - w)[finite].abs().max()) if finite.any() else 0.0) for g, w in zip(got[:2], want[:2]))
        # F1 = 2 P R / max(P + R, 1e-12) reaches 1e11 where P + R <= 0 (a single negative similarity): there it
        # amplifies P's and R's last bits, so it is held, relative, to the formula on the kernel's own P and R
        clamped = want[0] + want[1] <= 1e-12
        own = 2 * got[0] * got[1] / (got[0] + got[1]).clamp_min(1e-12)
        f1_err = float(torch.where(clamped, (got[2] - own).abs() / own.abs().clamp_min(1.0), (got[2] - want[2]).abs())
                       [finite].max()) if finite.any() else 0.0
        check(err <= BERT_ATOL and f1_err <= BERT_ATOL,
              f"bert_greedy_match ({label}): P and R {err:.3g} from plain, F1 {f1_err:.3g}")
        if edit in NON_FINITE:  # a NaN or +-inf in a valid row: NaN in P, R and F1; in masked rows: finite
            check(all(bool(g[:2].isnan().all()) and bool(g[2:].isfinite().all()) for g in got),
                  f"bert_greedy_match ({label}): P, R, F1 {[g.tolist() for g in got]}")
        err = max(err, f1_err)
        if edit == "negative rows":
            check(float(got[0][0]) < 0.0 and float(got[0][1]) == 0.0 and float(want[0][1]) == 0.0,
                  f"bert_greedy_match ({label}): precision {got[0][:2].tolist()}, plain {want[0][:2].tolist()}")
        row = {"case": label, "what": what, "max_abs_err": err}
        if timed:
            lp, lt = pm.sum(1), tm.sum(1)
            ops = float(2 * (lp * lt).sum()) * h  # the valid pairs' dot products: what this run's data needs
            nbytes = int(float((lp + lt).sum()) * h * 4 + 4 * pairs * (tp + tt) + 12 * pairs)
            # the products run as three TF32 passes on the tensor cores
            ops_ms, bytes_ms = 3 * ops / PEAK_TF32_OPS_PER_S * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
            bound_ms, bound_by = max((ops_ms, "operations"), (bytes_ms, "bytes"))
            padded_ops = 2 * pairs * tp * tt * h
            fn = lambda a, b_, c, d: kbm.bert_greedy_match(a, b_, c, d)  # noqa: E731
            kernel_ms = time_ms(lambda: fn(pe, pm, te, tm), flush)
            plain_ms = time_ms(lambda: kbm._bert_greedy_match_plain(pe, pm, te, tm), flush, reps=10, warmup=1)

            def yardstick():
                sim = torch.bmm(pe, te.transpose(1, 2))
                return sim.amax(2), sim.amax(1)

            yard_ms = time_ms(yardstick, flush, reps=10, warmup=1)
            all_bytes = 4 * (pe.numel() + te.numel())
            sets = [(pe, pm, te, tm)] + [(pe.clone(), pm, te.clone(), tm) for _ in range(copies_for(all_bytes) - 1)]
            stream_ms = time_stream_ms(fn, sets, calls=len(sets) * max(1, 12 // len(sets)))
            del sets
            row.update({"ms": kernel_ms, "stream_ms": stream_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "operations": ops, "bytes": nbytes, "padded_operations": padded_ops,
                        "bytes_ms": bytes_ms, "tf32_three_pass_ms": ops_ms, "library_ms": None,
                        "bmm_amax_yardstick_ms": yard_ms})
            print(f"[kernel] bert_greedy_match {label}: {kernel_ms:.4f} ms after an L2 flush ({stream_ms:.4f} ms a "
                  f"call back to back), plain {plain_ms:.4f} ms, torch.bmm + two amax (a yardstick) {yard_ms:.4f} ms; "
                  f"bound {bound_ms * 1e3:.2f} us ({bound_by}): the valid tokens' {nbytes} bytes {bytes_ms * 1e3:.2f} "
                  f"us, the valid pairs' {ops:.4g} operations in three TF32 passes {ops_ms * 1e3:.2f} us (the padded "
                  f"shape is {padded_ops:.4g} operations), share {bound_ms / kernel_ms:.1%}; max abs err {err:.3g}")
        rows.append(row)
        del pe, pm, te, tm, pw, tw, got, again, want
    print(f"[kernel] bert_greedy_match: within {BERT_ATOL} of plain, deterministic, on all {len(cases)} cases: "
          + "; ".join(f"{r['what']} ({r['max_abs_err']:.2g})" for r in rows))
    return rows


def _wikitext_batches():
    """WikiText-103 test's length in GPT-2 tokens as batches of 8 x 1,024 float32 logits seeded on the card (scale
    3), the last batch's tail past the set's end padded with ``-100``."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 52)
    per_batch = PPL_BATCH * PPL_SEQ
    for start in range(0, WIKITEXT103_TOKENS, per_batch):
        logits = 3.0 * torch.randn((PPL_BATCH, PPL_SEQ, GPT2_VOCAB), generator=gen, device="cuda")
        target = torch.randint(0, GPT2_VOCAB, (PPL_BATCH, PPL_SEQ), generator=gen, device="cuda")
        target.view(-1)[max(0, WIKITEXT103_TOKENS - start):] = -100
        yield (logits, target), {}


def _text_perplexity(device, compute_groups):
    from torchmetrics_tpu_torch import text as tt
    from torchmetrics_tpu_torch.collections import MetricCollection

    return MetricCollection({"perplexity": tt.Perplexity(ignore_index=-100, device=device)},
                            compute_groups=compute_groups)


def _seeded_words(n: int, gen: np.random.Generator) -> list:
    """``n`` distinct seeded lowercase words."""
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    words = set()
    while len(words) < n:
        for length in gen.integers(2, 10, n):
            words.add("".join(gen.choice(letters, length)))
    return sorted(words)[:n]


def _zipf_sentences(n: int, vocab: list, lengths, gen: np.random.Generator) -> list:
    """``n`` seeded sentences of Zipf-distributed words (so that idf has frequent and rare words)."""
    ranks = np.minimum(gen.zipf(1.2, size=(n, lengths[1])), len(vocab)) - 1
    sizes = gen.integers(lengths[0], lengths[1] + 1, n)
    return [" ".join(vocab[r] for r in ranks[i, :sizes[i]]) for i in range(n)]


class _FixedVocabTokenizer:
    """A user tokenizer: whitespace words to the ids of a fixed vocabulary (3 on), padded with 1 to the longest
    sentence of the call, at most ``max_length`` tokens: RoBERTa's pad id."""

    def __init__(self, vocab: list, max_length: int):
        self.ids = {w: i + 3 for i, w in enumerate(vocab)}
        self.max_length = max_length

    def __call__(self, texts):
        rows = [[self.ids.get(w, 3) for w in t.split()][: self.max_length] for t in texts]
        width = max((len(r) for r in rows), default=1) or 1
        ids = np.ones((len(rows), width), np.int64)
        mask = np.zeros((len(rows), width), np.int64)
        for i, r in enumerate(rows):
            ids[i, : len(r)], mask[i, : len(r)] = r, 1
        return {"input_ids": ids, "attention_mask": mask}


def _roberta_large_encoder():
    """A random-init ``RobertaModel`` at roberta-large's published widths cut to its first 17 layers, on the card,
    as a ``model=`` callable: ``hidden_states[17]``, the last, in chunks of 256 sequences."""
    from transformers import RobertaConfig, RobertaModel

    torch.manual_seed(SEED + 53)
    with torch.device("cuda"):
        encoder = RobertaModel(RobertaConfig(num_hidden_layers=ROBERTA_LAYERS, **ROBERTA_LARGE),
                               add_pooling_layer=False).eval()

    def embed(input_ids, attention_mask):
        ids, mask = input_ids.to("cuda", torch.long), attention_mask.to("cuda", torch.long)
        with torch.no_grad():
            out = [encoder(input_ids=i, attention_mask=m).last_hidden_state
                   for i, m in zip(ids.split(256), mask.split(256))]
        return torch.cat(out).to(input_ids.device)

    return embed


def _bert_batches(pairs: int, vocab: list):
    def batches():
        gen = np.random.default_rng(SEED + 54)
        preds = _zipf_sentences(pairs, vocab, (10, WMT16_MAX_TOKENS), gen)
        target = _zipf_sentences(pairs, vocab, (10, WMT16_MAX_TOKENS), gen)
        for i in range(0, pairs, BERT_UPDATE):
            yield (preds[i:i + BERT_UPDATE], target[i:i + BERT_UPDATE]), {}
    return batches


def _tiny_mlm_checkpoint(directory: str, vocab: list) -> str:
    """A random-init ``BertForMaskedLM`` at bert_uncased_L-2_H-128_A-2's widths and a WordPiece vocabulary of
    its 30,522 entries (the special tokens, then seeded words), saved to ``directory``."""
    from transformers import BertConfig, BertForMaskedLM

    specials = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    with open(os.path.join(directory, "vocab.txt"), "w") as f:
        f.write("\n".join(specials + vocab[: BERT_TINY["vocab_size"] - len(specials)]) + "\n")
    with open(os.path.join(directory, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "BertTokenizer", "do_lower_case": True, "model_max_length": 512}, f)
    torch.manual_seed(SEED + 55)
    BertForMaskedLM(BertConfig(**BERT_TINY)).eval().save_pretrained(directory)
    return directory


def _host_leg(name: str, make, batches: list) -> dict:
    """One metric over ``batches`` on the card: each update's host time (a synchronize after it), the compute, and
    the state after the first batch against the CPU path's (equal)."""
    metric, times = make("cuda"), []
    for i, batch in enumerate(batches):
        t0 = time.perf_counter()
        metric.update(*batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            early = _copy(metric.metric_state)
    t0 = time.perf_counter()
    value = metric.compute()
    torch.cuda.synchronize()
    compute_ms = (time.perf_counter() - t0) * 1e3
    cpu = make("cpu")
    cpu.update(*[_cpu(x) for x in batches[0]])
    compared = _assert_same(f"[text {name}] state after the first batch", early, cpu.metric_state, 0.0, 0.0)
    compared += _assert_same(f"[text {name}] value after the first batch", metric.compute_state(early),
                             cpu.compute(), FLOAT_RTOL, FLOAT_ATOL)
    return {"batches": len(batches), "update_ms_median": statistics.median(times), "compute_ms": compute_ms,
            "values": ({k: _value_summary(v) for k, v in value.items()} if isinstance(value, dict)
                       else _value_summary(value)),
            "tensors": value, "cpu_compared": compared}


def _squad_batches(preds: list, target: list) -> list:
    out = []
    for i0 in range(0, len(preds), TEXT_UPDATE):
        p = [{"prediction_text": s, "id": str(i)} for i, s in enumerate(preds[i0:i0 + TEXT_UPDATE], i0)]
        t = [{"answers": {"answer_start": [0], "text": [r[0]]}, "id": str(i)}
             for i, r in enumerate(target[i0:i0 + TEXT_UPDATE], i0)]
        out.append((p, t))
    return out


def phase_text() -> dict:
    """Phase 13 on one card, no sync: (i) WikiText-103 test's length through ``Perplexity``; (ii) WMT16
    newstest2016's 2,999 pairs through ``BERTScore`` on a random-init roberta-large cut to 17 layers, ``idf=True``;
    (iii) 256 pairs through ``InfoLM`` on a random-init bert_uncased_L-2_H-128_A-2 checkpoint; (iv) the host
    metrics over 2,000 seeded sentence pairs (TER and EED over the first 500)."""
    from torchmetrics_tpu_torch import text as tt
    from torchmetrics_tpu_torch.collections import MetricCollection
    from torchmetrics_tpu_torch.kernels.bert_match import bert_greedy_match
    from torchmetrics_tpu_torch.kernels.perplexity import perplexity_nll

    kernels = (perplexity_nll, bert_greedy_match)
    record = {}
    gen = np.random.default_rng(SEED + 56)

    # (i) one perplexity_nll launch a batch
    leg = _curve_leg("text perplexity", _text_perplexity, _wikitext_batches, kernels, cpu_batches=1)
    n_batches = -(-WIKITEXT103_TOKENS // (PPL_BATCH * PPL_SEQ))
    t = leg["tensors"]["perplexity"]
    check(leg["launches"] == {"perplexity_nll": n_batches, "bert_greedy_match": 0} and math.isfinite(float(t))
          and float(t) > 1.0, f"[text perplexity] launches {leg['launches']}, value {leg['values']}")
    record["perplexity"] = leg

    # (ii) the 2,999 pairs, one bert_greedy_match launch at compute
    vocab = _seeded_words(ROBERTA_LARGE["vocab_size"] - 3, gen)
    t0 = time.perf_counter()
    encoder = _roberta_large_encoder()
    tokenizer = _FixedVocabTokenizer(vocab, WMT16_MAX_TOKENS)
    build_s = time.perf_counter() - t0

    def bertscore(device, compute_groups):
        return MetricCollection({"bertscore": tt.BERTScore(model=encoder, user_tokenizer=tokenizer, idf=True,
                                                           device=device)}, compute_groups=compute_groups)

    leg = _curve_leg("text bertscore", bertscore, _bert_batches(WMT16_PAIRS, vocab), kernels, cpu_batches=1)
    f1 = leg["tensors"]["f1"]
    check(leg["launches"] == {"perplexity_nll": 0, "bert_greedy_match": 1} and f1.shape == (WMT16_PAIRS,)
          and bool(torch.isfinite(f1).all()) and bool(((f1 > 0) & (f1 <= 1)).all()),
          f"[text bertscore] launches {leg['launches']}, values {leg['values']}")
    leg["encoder_build_s"] = build_s
    record["bertscore"] = leg
    del encoder

    # (iii) InfoLM through the checkpoint: per-position masking, no kernel
    with tempfile.TemporaryDirectory() as directory:
        words = _seeded_words(BERT_TINY["vocab_size"], gen)
        path = _tiny_mlm_checkpoint(directory, words)
        preds = _zipf_sentences(INFOLM_PAIRS, words, (5, 30), gen)
        target = _zipf_sentences(INFOLM_PAIRS, words, (5, 30), gen)

        def infolm(device, compute_groups):
            return MetricCollection({"infolm": tt.InfoLM(model_name_or_path=path, max_length=INFOLM_MAX_LENGTH,
                                                         idf=True, device=device)}, compute_groups=compute_groups)

        def infolm_batches():
            for i in range(0, INFOLM_PAIRS, INFOLM_UPDATE):
                yield (preds[i:i + INFOLM_UPDATE], target[i:i + INFOLM_UPDATE]), {}

        leg = _curve_leg("text infolm", infolm, infolm_batches, kernels, cpu_batches=1)
        check(math.isfinite(float(leg["tensors"]["infolm"])), f"[text infolm] values {leg['values']}")
        record["infolm"] = leg

    # (iv) the host metrics: strings in, float32 sums on the card
    words = _seeded_words(5_000, gen)
    preds = _zipf_sentences(TEXT_PAIRS, words, (5, 40), gen)
    target = [[s] for s in _zipf_sentences(TEXT_PAIRS, words, (5, 40), gen)]
    pairs = [(preds[i:i + TEXT_UPDATE], target[i:i + TEXT_UPDATE]) for i in range(0, TEXT_PAIRS, TEXT_UPDATE)]
    flat = [(p, [r[0] for r in t]) for p, t in pairs]
    ids = torch.tensor(tokenizer(preds)["input_ids"])
    host = {
        "wer": (lambda d: tt.WordErrorRate(device=d), flat), "cer": (lambda d: tt.CharErrorRate(device=d), flat),
        "mer": (lambda d: tt.MatchErrorRate(device=d), flat), "wil": (lambda d: tt.WordInfoLost(device=d), flat),
        "wip": (lambda d: tt.WordInfoPreserved(device=d), flat),
        "sacrebleu": (lambda d: tt.SacreBLEUScore(tokenize="13a", device=d), pairs),
        "chrf++": (lambda d: tt.CHRFScore(n_word_order=2, device=d), pairs),
        "ter": (lambda d: tt.TranslationEditRate(device=d), pairs[:TEXT_DP_UPDATES]),
        "eed": (lambda d: tt.ExtendedEditDistance(device=d), pairs[:TEXT_DP_UPDATES]),
        "squad": (lambda d: tt.SQuAD(device=d), _squad_batches(preds, target)),
        "distinct": (lambda d: tt.DistinctNGrams(ngram=2, ignore_index=1, device=d),
                     [(ids[i:i + TEXT_UPDATE].cuda(),) for i in range(0, TEXT_PAIRS, TEXT_UPDATE)]),
    }
    for name, (make, batches) in host.items():
        record[f"host {name}"] = _host_leg(name, make, batches)

    for name, leg in record.items():
        extra = f", the CPU rerun {leg['cpu_rerun_s']:.1f} s" if "cpu_rerun_s" in leg else ""
        print(f"[text] {name}: {leg['batches']} batches{extra}; update median {leg['update_ms_median']:.4f} ms (host "
              f"clock, a synchronize after each), compute {leg['compute_ms']:.4f} ms; launches "
              f"{leg.get('launches', {'perplexity_nll': 0, 'bert_greedy_match': 0})}; the first batch matches the "
              f"CPU path ({leg['cpu_compared']} tensors); values {leg['values']}")
        del leg["tensors"]
    print(f"[text] bertscore: the random-init roberta-large (17 layers) built on the card in "
          f"{record['bertscore']['encoder_build_s']:.1f} s")
    return record


# ------------------------------------------------ mask_iou and poly_mmd (phase 3), phases 14 and 15
SEGM_IMAGES, SEGM_BATCH, SEGM_HW = 200, 20, (480, 640)  # of COCO val2017's 5,000: the dense mask states
PANOPTIC_MAPS, PANOPTIC_BATCH, PANOPTIC_SEGMENTS = 500, 16, 20  # COCO panoptic val2017's shape, cut from 5,000
PANOPTIC_THINGS, PANOPTIC_STUFFS = tuple(range(1, 81)), tuple(range(81, 134))  # 80 things, 53 stuffs
PANOPTIC_VOID = 0  # a category outside both: void in the target
CIFAR_IMAGES, CIFAR_BATCH = 10_000, 250  # CIFAR-10 test: 10,000 images of 32 x 32
BAPPS_PAIRS, BAPPS_BATCH = 4_000, 250  # BAPPS 2AFC val's patches: 64 x 64
PPL_SAMPLES, PPL_LATENT = 2_000, 512  # of PPL's default 10,000; a 512-wide latent
GEN_CPU_IMAGES = 16  # the generative legs rerun the first 16 images or pairs of their first batch on the CPU path
FID_RTOL = 1e-6  # FID and MiFID, the card's compute against the CPU's on the same float64 states: the float32
# result's rounding and two eigensolvers (cuSOLVER's, LAPACK's) on covariances of full rank
PPL_CPU_RTOL = 1e-2  # PPL's distances, the card against the CPU: float32 image noise over epsilon ** 2 = 1e-8
KID_TOL = 1e-5  # poly_mmd against plain: of the terms' scale (|kt_xx| + |kt_yy|) / (m (m - 1)) + 2 |k_xy| / m^2


def _ellipse_masks(boxes: torch.Tensor, hw) -> torch.Tensor:
    """Each xyxy box's inscribed ellipse, ``(N, H, W)`` bool on the boxes' device."""
    h, w = hw
    yy = torch.arange(h, device=boxes.device, dtype=torch.float32).view(1, h, 1) + 0.5
    xx = torch.arange(w, device=boxes.device, dtype=torch.float32).view(1, 1, w) + 0.5
    x1, y1, x2, y2 = (boxes[:, k].view(-1, 1, 1) for k in range(4))
    rx, ry = ((x2 - x1) / 2).clamp_min(0.5), ((y2 - y1) / 2).clamp_min(0.5)
    return ((xx - (x1 + x2) / 2) / rx) ** 2 + ((yy - (y1 + y2) / 2) / ry) ** 2 <= 1.0


def _mask_case(gen, shapes, hw_list=None, kinds=None):
    """Images of ellipse masks (boxes anywhere) with a few masks all empty or all full."""
    dets, gts = [], []
    for i, (n_d, n_g) in enumerate(shapes):
        hw = hw_list[i] if hw_list else SEGM_HW
        boxes = torch.rand((n_d + n_g, 4), generator=gen, device="cuda") * torch.tensor(
            [hw[1], hw[0], hw[1], hw[0]], device="cuda", dtype=torch.float32)
        boxes = torch.cat([torch.minimum(boxes[:, :2], boxes[:, 2:]), torch.maximum(boxes[:, :2], boxes[:, 2:])], 1)
        masks = _ellipse_masks(boxes, hw)
        if kinds == "edges" and n_d + n_g >= 4:
            masks[0], masks[1], masks[-1] = False, True, True
        dets.append(masks[:n_d].contiguous())
        gts.append(masks[n_d:].contiguous())
    return dets, gts


def phase_mask_iou_kernel(flush: torch.Tensor) -> list:
    """``mask_iou`` against its plain version (JAX's float64 product) on the card, counts equal (``torch.equal``):
    (a) a COCO image, 100 detections and 7 ground truths of 480 x 640 (timed, the record's row), (b) a crowded one
    of 60 ground truths (timed), (c) PASCAL's 375 x 500 (timed: H W not a multiple of 32), (d) all-empty and
    all-full masks, (e) D = G = 1, (f) a batch of 16 images of mixed sizes with D = 0 and G = 0 among them, (g) an
    image of 300 + 40 masks (entries of detection and ground-truth blocks), (h) phase 14's launch (timed,
    ``_mask_iou_phase14_launch``). Library: ``torch.matmul`` of the masks as float32 copies made outside the timing
    (exact below 2**24), TF32 off."""
    from torchmetrics_tpu_torch.kernels import mask_iou as kmi
    from torchmetrics_tpu_torch.utilities.precision import full_float32

    gen = torch.Generator(device="cuda").manual_seed(SEED + 61)
    sizes = [(480, 640), (375, 500), (427, 640), (640, 480), (333, 500), (1, 1), (7, 37), (512, 512)]
    mixed_shapes = [(int(d), int(g)) for d, g in zip(
        torch.randint(0, 100, (16,), generator=gen, device="cuda").tolist(),
        torch.randint(0, 20, (16,), generator=gen, device="cuda").tolist())]
    mixed_shapes[3], mixed_shapes[7] = (0, 5), (9, 0)
    cases = [("(a) COCO image, D=100, G=7, 480 x 640", [(100, 7)], None, None, True),
             ("(b) crowded, D=100, G=60, 480 x 640", [(100, 60)], None, None, True),
             ("(c) PASCAL, D=100, G=7, 375 x 500", [(100, 7)], [(375, 500)], None, True),
             ("(d) all-empty and all-full masks", [(6, 5)], [(48, 64)], "edges", False),
             ("(e) D=1, G=1", [(1, 1)], None, None, False),
             ("(f) 16 images of mixed sizes", mixed_shapes, [sizes[i % len(sizes)] for i in range(16)], None, False),
             ("(g) D=300, G=40 at 64 x 80", [(300, 40)], [(64, 80)], None, False)]
    rows = []
    for label, shapes, hw, kinds, timed in cases:
        dets, gts = _mask_case(gen, shapes, hw, kinds)
        before = kmi.mask_iou.launches
        got = kmi.mask_iou(dets, gts)
        again = kmi.mask_iou(dets, gts)
        want = kmi._mask_iou_plain(dets, gts)
        torch.cuda.synchronize()
        launched = any(d.shape[0] and g.shape[0] for d, g in zip(dets, gts))
        check(kmi.mask_iou.launches == before + 2 * launched, f"mask_iou launches ({label})")
        for i, (g_, a_, w_) in enumerate(zip(got, again, want)):
            for part, x, y, z in zip(("inter", "det_area", "gt_area"), g_, a_, w_):
                check(torch.equal(x, z) and torch.equal(x, y), f"mask_iou {part} differs from plain ({label}, image {i})")
        row = {"case": label, "max_abs_err": 0.0, "images": len(shapes)}
        if timed:
            n_d, n_g = shapes[0]
            h, w = hw[0] if hw else SEGM_HW
            bytes_ = (n_d + n_g) * h * w + 4 * (n_d * n_g + n_d + n_g)
            bound_ms = bytes_ / PEAK_BYTES_PER_S * 1e3
            kernel_ms = time_ms(lambda: kmi.mask_iou(dets, gts), flush)
            plain_ms = time_ms(lambda: kmi._mask_iou_plain(dets, gts), flush, reps=5, warmup=1)
            df, gf = dets[0].flatten(1).float(), gts[0].flatten(1).float()
            with full_float32():
                library_ms = time_ms(lambda: torch.matmul(df, gf.T), flush, reps=10)
            stream_ms = time_stream_ms(lambda d_, g_: kmi.mask_iou(d_, g_), [(dets, gts)] + [
                ([d.clone() for d in dets], [g.clone() for g in gts]) for _ in range(copies_for(bytes_) - 1)], calls=8)
            row.update({"ms": kernel_ms, "stream_ms": stream_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": "bytes", "library_ms": library_ms, "bytes": bytes_})
            print(f"[kernel] mask_iou {label}: {kernel_ms:.4f} ms after an L2 flush ({stream_ms:.4f} ms a call back "
                  f"to back), plain (float64 product) {plain_ms:.4f} ms, torch.matmul of float32 masks (library_ms) "
                  f"{library_ms:.4f} ms, bound {bound_ms * 1e3:.2f} us (bytes: {bytes_}), share "
                  f"{bound_ms / kernel_ms:.1%}; entries {len(kmi.plan([(n_d, n_g, h * w)]))}")
        rows.append(row)
        del dets, gts, got, again, want
    rows.append(_mask_iou_phase14_launch(gen, flush))
    print(f"[kernel] mask_iou: SM clock, now and at most: {sm_clocks()}")
    print(f"[kernel] mask_iou: counts and areas equal to plain (torch.equal) and across two launches on all "
          f"{len(rows)} cases")
    return rows


def _mask_iou_phase14_launch(gen, flush: torch.Tensor) -> dict:
    """(h) the launch of phase 14's segm computes: ``SEGM_IMAGES`` images of 100 + 7 masks of 480 x 640 (6.59 GB)
    in one launch, counts equal to plain, timed beside its bound, the plain version and ``torch.bmm`` of float32
    copies (26.3 GB, made outside the timing; TF32 off)."""
    from torchmetrics_tpu_torch.kernels import mask_iou as kmi
    from torchmetrics_tpu_torch.utilities.precision import full_float32

    label = f"(h) phase 14's launch: {SEGM_IMAGES} images, D=100, G=7, 480 x 640"
    n_d, n_g, (h, w) = 100, 7, SEGM_HW
    dets, gts = _mask_case(gen, [(n_d, n_g)] * SEGM_IMAGES)
    before = kmi.mask_iou.launches
    got = kmi.mask_iou(dets, gts)
    want = kmi._mask_iou_plain(dets, gts)
    torch.cuda.synchronize()
    check(kmi.mask_iou.launches == before + 1, f"mask_iou launches ({label})")
    for i, (g_, w_) in enumerate(zip(got, want)):
        check(all(torch.equal(x, z) for x, z in zip(g_, w_)), f"mask_iou differs from plain ({label}, image {i})")
    del got, want
    bytes_ = SEGM_IMAGES * ((n_d + n_g) * h * w + 4 * (n_d * n_g + n_d + n_g))
    bound_ms = bytes_ / PEAK_BYTES_PER_S * 1e3
    kernel_ms = time_ms(lambda: kmi.mask_iou(dets, gts), flush, reps=10)
    plain_ms = time_ms(lambda: kmi._mask_iou_plain(dets, gts), flush, reps=3, warmup=1)
    df = torch.stack([d.flatten(1) for d in dets]).float()
    gf = torch.stack([g.flatten(1) for g in gts]).float().transpose(1, 2)
    with full_float32():
        library_ms = time_ms(lambda: torch.bmm(df, gf), flush, reps=5, warmup=1)
    del df, gf, dets, gts
    torch.cuda.empty_cache()
    print(f"[kernel] mask_iou {label}: {kernel_ms:.4f} ms after an L2 flush, plain (float64 products an image) "
          f"{plain_ms:.4f} ms, torch.bmm of float32 masks (library_ms) {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"(bytes: {bytes_}), share {bound_ms / kernel_ms:.1%}")
    return {"case": label, "max_abs_err": 0.0, "images": SEGM_IMAGES, "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": library_ms, "bytes": bytes_}


def _kid_features(gen, n, d, shift=0.0):
    """Non-negative features like InceptionV3's pool (ReLU then mean): |N(0, 1)| scaled, plus ``shift``."""
    return (torch.randn((n, d), generator=gen, device="cuda").abs() * 0.5 + shift).contiguous()


def _kid_subsets(gen, n_r, n_f, subsets, m):
    ix = torch.stack([torch.randperm(n_r, generator=gen, device="cuda")[:m] for _ in range(subsets)])
    iy = torch.stack([torch.randperm(n_f, generator=gen, device="cuda")[:m] for _ in range(subsets)])
    return ix, iy


def _kid_float64(x, y, ix, iy, degree, gamma, coef):
    """A float64 evaluation a subset from float64 kernel matrices of the gathered rows: the MMD^2 and the terms'
    scale ``(|kt_xx| + |kt_yy|) / (m (m - 1)) + 2 |k_xy| / m^2``."""
    mmd, scale = [], []
    m = ix.shape[1]
    for rx, ry in zip(ix, iy):
        xs, ys = x[rx].double(), y[ry].double()
        k = [((a @ b.T) * gamma + coef) ** degree for a, b in ((xs, xs), (ys, ys), (xs, ys))]
        kt = k[0].sum() - k[0].diagonal().sum() + k[1].sum() - k[1].diagonal().sum()
        mmd.append(float(kt / (m * (m - 1)) - 2 * k[2].sum() / m**2))
        k = [v.abs() for v in k]
        scale.append(float((k[0].sum() - k[0].diagonal().sum() + k[1].sum() - k[1].diagonal().sum()) / (m * (m - 1))
                           + 2 * k[2].sum() / m**2))
    as64 = lambda v: torch.tensor(v, dtype=torch.float64, device=x.device)  # noqa: E731
    return as64(mmd), as64(scale)


def _kid_library(x, y, ix, iy, degree, gamma, coef):
    """The batched PyTorch form: the subsets gathered, ``torch.bmm`` for the three kernel matrices, the power
    and the sums."""
    xs, ys = x[ix], y[iy]
    k = [(torch.bmm(a, b.transpose(1, 2)) * gamma + coef) ** degree for a, b in ((xs, xs), (ys, ys), (xs, ys))]
    m = ix.shape[1]
    kt = (k[0].sum((1, 2)) - k[0].diagonal(dim1=1, dim2=2).sum(1) + k[1].sum((1, 2))
          - k[1].diagonal(dim1=1, dim2=2).sum(1))
    return kt / (m * (m - 1)) - 2 * k[2].sum((1, 2)) / m**2


KID_FLOAT64_TOL = 1e-7  # poly_mmd against a float64 evaluation at (a) and (f): of the terms' scale
KID_OUTLIERS, KID_OUTLIER_SCALE = 8, 30.0  # (f): feature dimensions this many times the others, as trained nets'


def _poly_mmd_bounds(subsets: int, m: int, d: int) -> dict:
    """The least times of ``poly_mmd``'s products, the xx and yy halves counted once: 2 m^2 d multiply-adds a
    subset as float32 on the CUDA cores, and as the kernel's three TF32 passes on the tensor cores; and the bytes
    its tiles read from L2 (each block its rows and columns once) and from device memory (a subset's rows once,
    the tiles of a subset running together)."""
    from torchmetrics_tpu_torch.kernels import poly_mmd as kpm

    flop = 2 * d * (m * m + m * (m - 1)) * subsets
    return {"flop": flop, "fp32_bound_ms": flop / PEAK_FP32_OPS_PER_S * 1e3,
            "tf32_bound_ms": 3 * flop / PEAK_TF32_OPS_PER_S * 1e3,
            "l2_bytes": kpm.blocks(m) * subsets * (kpm.ROWS + kpm.COLS) * d * 4,
            "dram_bytes": 2 * m * d * 4 * subsets}


def phase_poly_mmd_kernel(flush: torch.Tensor) -> list:
    """``poly_mmd`` against its plain version (JAX's gathered subsets, float32) on the card, within
    ``KID_TOL`` of the terms' scale: (a) KID's defaults, 100 subsets of 1,000 of 10,000 x 2,048 features (timed,
    the record's row), (b) d = 64 and d = 1,001 (4-byte loads, a ragged chunk), (c) degrees 1-4 with given
    ``gamma`` and ``coef``, (d) m = 2, (e) a NaN feature (NaN in the subsets that hold it, as plain), (f) KID's
    defaults with ``KID_OUTLIERS`` dimensions ``KID_OUTLIER_SCALE`` times the others, (g) a +inf feature (the
    plain version's NaN pattern), (h) m = 129 and 255 (against the 64-row warpgroups and 128 x 128 tiles: 129 gives
    a second row and column tile of one row, 255 a ragged one); at (a) and (f) also within ``KID_FLOAT64_TOL`` of a float64 evaluation (gathered float64 products), plain's error
    beside. Library: the batched gather + ``torch.bmm`` + power + sums (several calls, TF32 off)."""
    from torchmetrics_tpu_torch.kernels import poly_mmd as kpm
    from torchmetrics_tpu_torch.utilities.precision import full_float32

    gen = torch.Generator(device="cuda").manual_seed(SEED + 62)
    kid = ("(a) KID defaults: 100 subsets of 1,000 of 10,000 x 2,048", 10_000, 2048, 100, 1000, 3, None, 1.0, True)
    cases = [kid]
    cases += [(f"(b) d = {d}", 2000, d, 10, 300, 3, None, 1.0, False) for d in (64, 1001)]
    cases += [(f"(c) degree {k}, gamma {g}, coef {c}", 1500, 200, 6, 257, k, g, c, False)
              for k, g, c in ((1, 0.01, 0.5), (2, 0.003, 2.0), (3, 0.002, 1.5), (4, 0.005, 1.0))]
    cases += [("(d) m = 2", 50, 128, 20, 2, 3, None, 1.0, False),
              ("(e) a NaN feature", 400, 96, 8, 150, 3, None, 1.0, "nan"),
              (f"(f) KID defaults, {KID_OUTLIERS} dimensions x {KID_OUTLIER_SCALE:g}", *kid[1:-1], "outliers"),
              ("(g) a +inf feature", 400, 96, 8, 150, 3, None, 1.0, "inf")]
    cases += [(f"(h) m = {m}", 600, 160, 4, m, 3, None, 1.0, False) for m in (129, 255)]
    rows = []
    for label, n, d, subsets, m, degree, gamma, coef, kind in cases:
        x, y = _kid_features(gen, n, d), _kid_features(gen, n, d, shift=0.05)
        if kind in ("nan", "inf"):
            x[7, 3] = float(kind)
        if kind == "outliers":
            x[:, :KID_OUTLIERS] *= KID_OUTLIER_SCALE
            y[:, :KID_OUTLIERS] *= KID_OUTLIER_SCALE
        ix, iy = _kid_subsets(gen, n, n, subsets, m)
        g = 1.0 / d if gamma is None else gamma
        before = kpm.poly_mmd.launches
        got = kpm.poly_mmd(x, y, ix, iy, degree, g, coef)
        again = kpm.poly_mmd(x, y, ix, iy, degree, g, coef)
        with full_float32():
            want = kpm._poly_mmd_plain(x, y, ix, iy, degree, g, coef)
        torch.cuda.synchronize()
        check(kpm.poly_mmd.launches == before + 2, f"poly_mmd launches ({label})")
        check(torch.equal(got.isnan(), want.isnan()), f"poly_mmd's NaN differ from plain ({label})")
        if kind in ("nan", "inf"):
            check(bool(got.isnan().any()) and not bool(got.isnan().all()), f"poly_mmd NaN pattern ({label})")
        fin = ~want.isnan()
        exact, scale = _kid_float64(x, y, ix, iy, degree, g, coef)
        err = (got.double() - want.double()).abs()
        check(bool((err[fin] <= KID_TOL * scale[fin]).all()),
              f"poly_mmd differs from plain ({label}): max err over scale {float((err[fin] / scale[fin]).max()):.3g}")
        check(bool(((got.double() - again.double()).abs()[fin] <= 1e-12 * scale[fin]).all()),
              f"poly_mmd is not repeatable ({label})")
        row = {"case": label, "max_abs_err": float(err[fin].max()) if fin.any() else 0.0,
               "max_err_over_scale": float((err[fin] / scale[fin]).max()) if fin.any() else 0.0}
        if kind in (True, "outliers"):
            f64 = float(((got.double() - exact).abs() / scale).max())
            plain_f64 = float(((want.double() - exact).abs() / scale).max())
            row.update({"float64_err_over_scale": f64, "plain_float64_err_over_scale": plain_f64})
            print(f"[kernel] poly_mmd {label}: against float64, max err over scale {f64:.3g} (plain {plain_f64:.3g}); "
                  f"against plain {row['max_err_over_scale']:.3g}")
            check(f64 <= KID_FLOAT64_TOL, f"poly_mmd differs from float64 ({label}): {f64:.3g} of the terms' scale")
        if kind is True:
            bounds = _poly_mmd_bounds(subsets, m, d)
            kernel_ms = time_ms(lambda: kpm.poly_mmd(x, y, ix, iy, degree, g, coef), flush, reps=10)
            with full_float32():
                plain_ms = time_ms(lambda: kpm._poly_mmd_plain(x, y, ix, iy, degree, g, coef), flush, reps=3,
                                   warmup=1)
                library_ms = time_ms(lambda: _kid_library(x, y, ix, iy, degree, g, coef), flush, reps=3, warmup=1)
            stream_ms = time_stream_ms(lambda *a: kpm.poly_mmd(*a, degree, g, coef),
                                       [(x, y, ix, iy), (x.clone(), y.clone(), ix.clone(), iy.clone())], calls=4)
            row.update({"ms": kernel_ms, "stream_ms": stream_ms, "plain_ms": plain_ms,
                        "bound_ms": bounds["tf32_bound_ms"], "bound_by": "operations", "library_ms": library_ms,
                        **bounds})
            print(f"[kernel] poly_mmd {label}: {kernel_ms:.4f} ms after an L2 flush ({stream_ms:.4f} ms a call back "
                  f"to back), plain (a subset at a time) {plain_ms:.4f} ms, gather + torch.bmm + power + sums "
                  f"(library_ms) {library_ms:.4f} ms; bounds ({bounds['flop']:.3g} flop): three TF32 passes "
                  f"{bounds['tf32_bound_ms']:.4f} ms (share {bounds['tf32_bound_ms'] / kernel_ms:.1%}), float32 "
                  f"{bounds['fp32_bound_ms']:.4f} ms (share {bounds['fp32_bound_ms'] / kernel_ms:.1%}); L2 bytes "
                  f"{bounds['l2_bytes']:.4g} ({bounds['l2_bytes'] / kernel_ms * 1e-9:.3g} TB/s), device memory "
                  f"{bounds['dram_bytes']:.4g}; max err over scale {row['max_err_over_scale']:.3g}")
        rows.append(row)
    print(f"[kernel] poly_mmd: SM clock, now and at most: {sm_clocks()}")
    print(f"[kernel] poly_mmd: within {KID_TOL} of the terms' scale of plain, NaN in place, repeatable, on "
          f"{len(rows)} cases: " + "; ".join(f"{r['case']} ({r['max_err_over_scale']:.2g})" for r in rows))
    return rows


def _segm_batches():
    """(i)'s COCO-val2017-shaped batches: ``_coco_images``' boxes, labels, scores and crowds, each box's inscribed
    ellipse as its mask (480 x 640), on the card."""
    for lo in range(0, SEGM_IMAGES, SEGM_BATCH):
        preds, targets = _coco_images(lo, min(lo + SEGM_BATCH, SEGM_IMAGES))
        preds, targets = _on("cuda", preds), _on("cuda", targets)
        for d in preds + targets:
            d["masks"] = _ellipse_masks(d["boxes"], SEGM_HW)
        yield preds, targets


def _to_cpu(items):
    return [{k: v.cpu() for k, v in d.items()} for d in items]


def _panoptic_batch(gen, n):
    """``n`` COCO-panoptic-shaped maps (480 x 640): a nearest-seed partition into ``PANOPTIC_SEGMENTS`` segments,
    60 % things with RGB-encoded instance ids (up to 2**24), 40 % stuffs, void (category 0) on the 2-pixel
    boundaries in the target; the prediction's seeds jittered by 8 pixels, 90 % of its categories kept."""
    h, w = SEGM_HW
    yy = torch.arange(h, device="cuda", dtype=torch.float32).view(1, h, 1)
    xx = torch.arange(w, device="cuda", dtype=torch.float32).view(1, 1, w)
    things = torch.tensor(PANOPTIC_THINGS, device="cuda")
    stuffs = torch.tensor(PANOPTIC_STUFFS, device="cuda")
    preds, target = [], []
    for _ in range(n):
        seeds = torch.rand((PANOPTIC_SEGMENTS, 2), generator=gen, device="cuda") * torch.tensor([w, h], device="cuda")
        is_thing = torch.rand(PANOPTIC_SEGMENTS, generator=gen, device="cuda") < 0.6
        cat = torch.where(is_thing, things[torch.randint(0, len(things), (PANOPTIC_SEGMENTS,), generator=gen,
                                                         device="cuda")],
                          stuffs[torch.randint(0, len(stuffs), (PANOPTIC_SEGMENTS,), generator=gen, device="cuda")])
        inst = torch.where(is_thing, torch.randint(1, 2**24, (PANOPTIC_SEGMENTS,), generator=gen, device="cuda"), 0)
        jitter = torch.randn((PANOPTIC_SEGMENTS, 2), generator=gen, device="cuda") * 8.0
        keep = torch.rand(PANOPTIC_SEGMENTS, generator=gen, device="cuda") < 0.9
        p_cat = torch.where(keep, cat, torch.where(is_thing, things[torch.randint(0, len(things), (
            PANOPTIC_SEGMENTS,), generator=gen, device="cuda")], stuffs[torch.randint(0, len(stuffs), (
                PANOPTIC_SEGMENTS,), generator=gen, device="cuda")]))
        maps = []
        for s, c, i_ in ((seeds, cat, inst), (seeds + jitter, p_cat, inst)):
            dist = (xx - s[:, 0].view(-1, 1, 1)) ** 2 + (yy - s[:, 1].view(-1, 1, 1)) ** 2
            two = dist.topk(2, dim=0, largest=False)
            seg = two.indices[0]
            m = torch.stack([c[seg], i_[seg]], dim=-1)
            maps.append((m, two.values[1].sqrt() - two.values[0].sqrt() < 2.0))
        (t_map, boundary), (p_map, _) = maps
        t_map[boundary] = torch.tensor([PANOPTIC_VOID, 0], device="cuda")
        preds.append(p_map)
        target.append(t_map)
    return torch.stack(preds), torch.stack(target)


def _panoptic_batches():
    gen = torch.Generator(device="cuda").manual_seed(SEED + 63)
    for lo in range(0, PANOPTIC_MAPS, PANOPTIC_BATCH):
        yield _panoptic_batch(gen, min(PANOPTIC_BATCH, PANOPTIC_MAPS - lo))


def _timed_updates(metrics: dict, batches, each=None) -> dict:
    """Update every metric with every batch (``each(batch) -> args``), each update's host time with a
    synchronize after it; returns the medians by metric."""
    times = {name: [] for name in metrics}
    for batch in batches:
        args = each(batch) if each else batch
        for name, metric in metrics.items():
            t0 = time.perf_counter()
            metric.update(*args)
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
    return {name: statistics.median(t) for name, t in times.items()}


def _timed_computes(metrics: dict) -> tuple:
    values, ms = {}, {}
    for name, metric in metrics.items():
        t0 = time.perf_counter()
        values[name] = metric.compute()
        torch.cuda.synchronize()
        ms[name] = (time.perf_counter() - t0) * 1e3
    return values, ms


def phase_detection() -> dict:
    """Phase 14 on one card, no sync: (i) COCO val2017's shape for segm, 200 images of 480 x 640 in batches of 20
    through ``MeanAveragePrecision(iou_type="segm")`` and ``iou_type=("bbox", "segm")`` with
    ``extended_summary``; (ii) COCO panoptic val2017's shape, 500 maps through ``PanopticQuality`` and
    ``ModifiedPanopticQuality``; (iii) the IoU family on (i)'s boxes; (iv) a ``tm_to_coco`` -> ``coco_to_tm``
    round trip of (i)'s first batch. Each leg reruns its first batch on the CPU path."""
    from torchmetrics_tpu_torch import detection as td
    from torchmetrics_tpu_torch.kernels import mask_iou as kmi
    from torchmetrics_tpu_torch.kernels.coco_match import coco_match
    from torchmetrics_tpu_torch.kernels.confmat import confmat_multiclass

    record = {}
    n_batches = -(-SEGM_IMAGES // SEGM_BATCH)

    # (i) segm: one mask_iou launch a compute, over all 200 images; the matching through coco_match
    t0 = time.perf_counter()
    batches = list(_segm_batches())
    torch.cuda.synchronize()
    data_s = time.perf_counter() - t0
    mask_bytes = sum(d["masks"].numel() for p, t in batches for d in p + t)
    metrics = {"segm": td.MeanAveragePrecision(iou_type="segm", device="cuda"),
               "both": td.MeanAveragePrecision(iou_type=("bbox", "segm"), extended_summary=True, device="cuda")}
    kmi.mask_iou.launches = coco_match.launches = 0
    t0 = time.perf_counter()
    update_ms = _timed_updates(metrics, batches)
    values, compute_ms = _timed_computes(metrics)
    leg_s = time.perf_counter() - t0
    launches = {"mask_iou": kmi.mask_iou.launches, "coco_match": coco_match.launches}
    check(launches["mask_iou"] == 2 and launches["coco_match"] > 0,
          f"[detection segm] launches {launches}: one mask_iou launch a compute, coco_match expected")
    segm, both = values["segm"], values["both"]
    for key in ("map", "map_50", "mar_100"):
        check(0.0 < float(segm[key]) <= 1.0 and float(segm[key]) == float(both[f"segm_{key}"]),
              f"[detection segm] {key} {float(segm[key])} vs {float(both[f'segm_{key}'])}")
    n_cls = len(both["classes"])
    check(tuple(both["segm_precision"].shape) == (10, 101, n_cls, 4, 3) and len(both["segm_ious"]) == n_cls
          * SEGM_IMAGES and tuple(both["bbox_scores"].shape) == (10, 101, n_cls, 4, 3),
          f"[detection segm] extended summary shapes {tuple(both['segm_precision'].shape)}, {len(both['segm_ious'])}")
    t_cpu = time.perf_counter()
    first_p, first_t = batches[0]
    card, cpu = (td.MeanAveragePrecision(iou_type=("bbox", "segm"), extended_summary=True, device=dev)
                 for dev in ("cuda", "cpu"))
    card.update(first_p, first_t)
    cpu.update(_to_cpu(first_p), _to_cpu(first_t))
    got, want = card.compute(), cpu.compute()
    counts_card = kmi.mask_iou_counts([p["masks"] for p in first_p], [t["masks"] for t in first_t])
    counts_cpu = kmi.mask_iou_counts([p["masks"].cpu() for p in first_p], [t["masks"].cpu() for t in first_t])
    for i, (a, b) in enumerate(zip(counts_card, counts_cpu)):
        check(all(torch.equal(x.cpu(), y) for x, y in zip(a, b)), f"[detection segm] image {i}'s counts differ")
    compared = _assert_same("[detection segm] first batch", {k: v for k, v in got.items() if k[-4:] != "ious"},
                            {k: v for k, v in want.items() if k[-4:] != "ious"}, 1e-6, 1e-6)
    compared += _assert_same("[detection segm] first batch ious", list(got["segm_ious"].values()),
                             list(want["segm_ious"].values()), 0.0, 0.0)
    record["segm"] = {"images": SEGM_IMAGES, "batches": n_batches, "mask_bytes": mask_bytes, "data_s": data_s,
                      "leg_s": leg_s, "update_ms_median": update_ms, "compute_ms": compute_ms, "launches": launches,
                      "values": {k: float(segm[k]) for k in ("map", "map_50", "map_75", "mar_100")},
                      "both_values": {k: float(both[k]) for k in ("bbox_map", "segm_map")},
                      "cpu_compared": compared, "cpu_rerun_s": time.perf_counter() - t_cpu}
    print(f"[detection] segm: {SEGM_IMAGES} images ({mask_bytes / 1e9:.2f} GB of masks, made in {data_s:.1f} s) in "
          f"{leg_s:.1f} s; update medians {update_ms} ms, computes {compute_ms} ms; launches {launches}; values "
          f"{record['segm']['values']}, both types {record['segm']['both_values']}; the first batch matches the CPU "
          f"path ({compared} tensors within 1e-6, the IoUs and the {len(counts_card)} images' counts equal)")
    del card, cpu, got, want, counts_card, counts_cpu

    # (iii) the IoU family on (i)'s boxes (no kernel)
    family = {"iou": td.IntersectionOverUnion(class_metrics=True, device="cuda"),
              "giou": td.GeneralizedIntersectionOverUnion(device="cuda"),
              "diou": td.DistanceIntersectionOverUnion(device="cuda"),
              "ciou": td.CompleteIntersectionOverUnion(device="cuda")}
    t0 = time.perf_counter()
    update_ms = _timed_updates(family, batches)
    values, compute_ms = _timed_computes(family)
    leg_s = time.perf_counter() - t0
    for name, v in values.items():
        check(all(math.isfinite(float(x)) for x in v.values()) and -2.0 < float(v[name]) <= 1.0,
              f"[detection iou] {name}: {v[name]}")
    t_cpu, compared = time.perf_counter(), 0
    for name, metric in family.items():
        card, cpu = (type(metric)(class_metrics=metric.class_metrics, device=dev) for dev in ("cuda", "cpu"))
        card.update(first_p, first_t)
        cpu.update(_to_cpu(first_p), _to_cpu(first_t))
        compared += _assert_same(f"[detection iou] {name} first batch", card.compute(), cpu.compute(), 1e-6, 1e-6)
    record["iou_family"] = {"leg_s": leg_s, "update_ms_median": update_ms, "compute_ms": compute_ms,
                            "values": {n: float(v[n]) for n, v in values.items()}, "classes": len(values["iou"]) - 1,
                            "cpu_compared": compared, "cpu_rerun_s": time.perf_counter() - t_cpu}
    print(f"[detection] IoU family over {SEGM_IMAGES} images in {leg_s:.1f} s: update medians {update_ms} ms, "
          f"computes {compute_ms} ms, values {record['iou_family']['values']} ({record['iou_family']['classes']} "
          f"per-class IoUs); the first batch matches the CPU path ({compared} tensors within 1e-6)")

    # (iv) the COCO round trip of (i)'s first batch
    t0 = time.perf_counter()
    first = td.MeanAveragePrecision(iou_type=("bbox", "segm"), device="cuda")
    first.update(first_p, first_t)
    with tempfile.TemporaryDirectory() as tmp:
        first.tm_to_coco(os.path.join(tmp, "segm"))
        sizes = {side: os.path.getsize(os.path.join(tmp, f"segm_{side}.json")) for side in ("preds", "target")}
        p2, t2 = td.MeanAveragePrecision.coco_to_tm(os.path.join(tmp, "segm_preds.json"),
                                                    os.path.join(tmp, "segm_target.json"),
                                                    iou_type=["bbox", "segm"], device="cuda")
    for i, (pa, pb, ta, tb) in enumerate(zip(first_p, p2, first_t, t2)):
        check(torch.equal(pa["masks"], pb["masks"].bool()) and torch.equal(ta["masks"], tb["masks"].bool())
              and torch.equal(pa["labels"], pb["labels"]) and torch.equal(pa["scores"], pb["scores"])
              and torch.equal(ta["iscrowd"], tb["iscrowd"]), f"[detection coco] image {i} changed in the round trip")
        xyxy = torch.cat([pb["boxes"][:, :2], pb["boxes"][:, :2] + pb["boxes"][:, 2:]], 1)
        check(bool(torch.allclose(xyxy, pa["boxes"], atol=1e-3, rtol=0)), f"[detection coco] image {i}'s boxes")
    again = td.MeanAveragePrecision(box_format="xywh", iou_type=("bbox", "segm"), device="cuda")
    again.update(p2, t2)
    a, b = first.compute(), again.compute()
    # the written areas are the boxes' (``tm_to_coco``'s rule), so the area ranges differ; "all" does not
    for key in ("segm_map", "segm_map_50", "segm_mar_100"):
        check(float(a[key]) == float(b[key]), f"[detection coco] {key}: {float(a[key])} vs {float(b[key])}")
    record["coco_round_trip"] = {"json_bytes": sizes, "s": time.perf_counter() - t0, "segm_map": float(a["segm_map"])}
    print(f"[detection] COCO round trip of the first batch ({SEGM_BATCH} images) in {record['coco_round_trip']['s']:.1f}"
          f" s: json {sizes} bytes; masks (compressed RLE), labels, scores and crowds equal, boxes within 1e-3 after "
          f"xywh, segm map, map_50 and mar_100 equal")
    del batches, metrics, values, segm, both, first, again, p2, t2, first_p, first_t
    torch.cuda.empty_cache()

    # (ii) panoptic: one confmat_multiclass launch an image and metric
    kw = {"things": set(PANOPTIC_THINGS), "stuffs": set(PANOPTIC_STUFFS)}
    pq = {"pq": td.PanopticQuality(return_sq_and_rq=True, device="cuda", **kw),
          "pq_modified": td.ModifiedPanopticQuality(device="cuda", **kw)}
    confmat_multiclass.launches = 0
    t0 = time.perf_counter()
    update_ms = _timed_updates(pq, _panoptic_batches())
    values, compute_ms = _timed_computes(pq)
    leg_s = time.perf_counter() - t0
    launches = confmat_multiclass.launches
    check(launches == 2 * PANOPTIC_MAPS, f"[detection panoptic] {launches} confmat_multiclass launches, "
          f"{2 * PANOPTIC_MAPS} expected (one an image and metric)")
    check(all(0.0 < float(x) <= 1.0 for x in values["pq"]) and 0.0 < float(values["pq_modified"]) <= 1.0,
          f"[detection panoptic] values {values}")
    t_cpu = time.perf_counter()
    first = next(_panoptic_batches())
    compared = 0
    for name, metric in pq.items():
        card, cpu = (type(metric)(device=dev, **kw) for dev in ("cuda", "cpu"))
        card.update(*first)
        cpu.update(*(x.cpu() for x in first))
        for leaf in ("true_positives", "false_positives", "false_negatives"):
            check(torch.equal(card.metric_state[leaf].cpu(), cpu.metric_state[leaf]), f"[detection panoptic] {leaf}")
        compared += 3 + _assert_same(f"[detection panoptic] {name} iou_sum", card.metric_state["iou_sum"],
                                     cpu.metric_state["iou_sum"], 1e-6, 0.0)
        compared += _assert_same(f"[detection panoptic] {name} value", card.compute(), cpu.compute(), 1e-6, 1e-7)
    record["panoptic"] = {"maps": PANOPTIC_MAPS, "leg_s": leg_s, "update_ms_median": update_ms,
                          "compute_ms": compute_ms, "launches": {"confmat_multiclass": launches},
                          "values": {"pq_sq_rq": values["pq"].tolist(), "pq_modified": float(values["pq_modified"])},
                          "cpu_compared": compared, "cpu_rerun_s": time.perf_counter() - t_cpu}
    print(f"[detection] panoptic: {PANOPTIC_MAPS} maps in {leg_s:.1f} s: update medians {update_ms} ms ({PANOPTIC_BATCH}"
          f" maps), computes {compute_ms} ms; {launches} confmat_multiclass launches; values "
          f"{record['panoptic']['values']}; the first batch matches the CPU path (counts equal, iou_sum within 1e-6)")
    return record


class _ConvGenerator(torch.nn.Module):
    """A seeded random conv generator: a 512-wide latent to 3 x 128 x 128 images in [-1, 1] (a linear layer to
    256 x 8 x 8, four nearest-upsampling 3 x 3 convolutions with ReLUs, tanh)."""

    def __init__(self, seed: int):
        super().__init__()
        with torch.random.fork_rng(devices=[]):  # the layers' default init from ``seed``, the global state kept
            torch.manual_seed(seed)
            self.fc = torch.nn.Linear(PPL_LATENT, 256 * 8 * 8)
            chans = (256, 128, 64, 32, 3)
            self.convs = torch.nn.ModuleList(torch.nn.Conv2d(a, b, 3, padding=1) for a, b in zip(chans, chans[1:]))

    def sample(self, generator: torch.Generator, n: int) -> torch.Tensor:
        return torch.randn((n, PPL_LATENT), generator=generator, device=generator.device)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        from torchmetrics_tpu_torch.utilities.precision import full_float32

        with full_float32():  # TF32 would put noise in the images that epsilon ** 2 magnifies
            x = self.fc(z).view(-1, 256, 8, 8)
            for i, conv in enumerate(self.convs):
                x = conv(torch.nn.functional.interpolate(x, scale_factor=2.0, mode="nearest"))
                x = torch.relu(x) if i < len(self.convs) - 1 else torch.tanh(x)
        return x


def _cifar_batches():
    """CIFAR-10 test's size: seeded real uint8 32 x 32 images (blurred noise) and fake ones (brighter, noisier)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 64)
    for _ in range(0, CIFAR_IMAGES, CIFAR_BATCH):
        base = torch.rand((CIFAR_BATCH, 3, 8, 8), generator=gen, device="cuda") * 255
        real = torch.nn.functional.interpolate(base, size=(32, 32), mode="bilinear", align_corners=False)
        fake = real * 0.8 + 40 + torch.randn(real.shape, generator=gen, device="cuda") * 12
        yield real.clamp(0, 255).to(torch.uint8), fake.clamp(0, 255).to(torch.uint8)


def _bapps_batches():
    gen = torch.Generator(device="cuda").manual_seed(SEED + 65)
    for _ in range(0, BAPPS_PAIRS, BAPPS_BATCH):
        ref = torch.rand((BAPPS_BATCH, 3, 16, 16), generator=gen, device="cuda")
        ref = torch.nn.functional.interpolate(ref, size=(64, 64), mode="bilinear", align_corners=False)
        dist = (ref + torch.randn(ref.shape, generator=gen, device="cuda") * 0.1).clamp(0, 1)
        yield ref * 2 - 1, dist * 2 - 1


def _generative_computes(metrics: dict, cpu_metrics: dict, values: dict) -> dict:
    """Phase 15 (i)'s computes held on the final states: FID, MiFID and IS computed on the CPU from copies of the
    card's states (LAPACK's eigensolvers against cuSOLVER's) within ``FID_RTOL`` (IS within 1e-5); KID's subsets,
    drawn as its compute draws them, by the plain version on the card within ``KID_TOL`` of the terms' scale, each
    subset and the metric's mean and standard deviation."""
    from torchmetrics_tpu_torch.kernels import poly_mmd as kpm
    from torchmetrics_tpu_torch.utilities.precision import full_float32

    states = {name: {k: tuple(v.cpu() for v in x) if isinstance(x, tuple) else x.cpu()
                     for k, x in metrics[name].metric_state.items()} for name in ("fid", "mifid", "is")}
    out = {}
    for name in ("fid", "mifid"):
        want = float(cpu_metrics[name].compute_state(states[name]))
        got = float(values[name])
        tol = FID_RTOL * abs(want)
        out[name] = {"card": got, "cpu": want, "err": abs(got - want), "tol": tol}
        check(abs(got - want) <= tol, f"[generative cifar] {name}: the card's compute {got!r} vs the CPU's {want!r} "
              f"on the same states (tolerance {tol:.3g})")
    _assert_same("[generative cifar] IS of the final states", values["is"],
                 cpu_metrics["is"].compute_state(states["is"]), 1e-5, 1e-6)
    out["is"] = {"card": [float(v) for v in values["is"]]}

    kid = metrics["kid"]
    x, y = (torch.cat(kid.metric_state[k]).contiguous() for k in ("real_features", "fake_features"))
    gen = torch.Generator(device=x.device).manual_seed(0)  # ``kid_from_features``' default draws, in its order
    ix = torch.stack([torch.randperm(x.shape[0], generator=gen, device=x.device)[:kid.subset_size]
                      for _ in range(kid.subsets)])
    iy = torch.stack([torch.randperm(y.shape[0], generator=gen, device=x.device)[:kid.subset_size]
                      for _ in range(kid.subsets)])
    g = 1.0 / x.shape[1] if kid.gamma is None else kid.gamma
    got = kpm.poly_mmd(x, y, ix, iy, kid.degree, g, kid.coef).double()
    with full_float32():
        want = kpm._poly_mmd_plain(x, y, ix, iy, kid.degree, g, kid.coef).double()
    scale = _kid_float64(x, y, ix, iy, kid.degree, g, kid.coef)[1]
    err = (got - want).abs()
    check(bool((err <= KID_TOL * scale).all()),
          f"[generative cifar] KID's subsets: poly_mmd differs from plain by {float((err / scale).max()):.3g} of scale")
    n = kid.subsets
    mean_tol = KID_TOL * float(scale.mean()) + 1e-6 * abs(float(want.mean()))
    std_tol = KID_TOL * float(scale.max()) * math.sqrt(n / (n - 1)) + 1e-6 * float(want.std())
    mean_err = abs(float(values["kid"][0]) - float(want.mean()))
    std_err = abs(float(values["kid"][1]) - float(want.std()))
    check(mean_err <= mean_tol and std_err <= std_tol, f"[generative cifar] KID {[float(v) for v in values['kid']]} "
          f"vs plain {float(want.mean())!r}, {float(want.std())!r} (tolerances {mean_tol:.3g}, {std_tol:.3g})")
    out["kid"] = {"card": [float(v) for v in values["kid"]], "plain": [float(want.mean()), float(want.std())],
                  "errs": [mean_err, std_err], "tols": [mean_tol, std_tol],
                  "max_err_over_scale": float((err / scale).max()), "scale_mean": float(scale.mean())}
    return out


def _inception_times(extractor, imgs: torch.Tensor) -> dict:
    """InceptionV3 on a batch by CUDA events (median of 5 after a warm-up): ``preprocess`` (the resize to 299) and
    the network to the pool tap, as ``InceptionFeatureExtractor`` calls them."""
    from torchmetrics_tpu_torch.image.backbones.inception import preprocess

    x = imgs.to(torch.float32)
    pre = preprocess(x)

    def events_ms(fn) -> float:
        fn()
        times = []
        for _ in range(5):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    with torch.no_grad():
        return {"preprocess_ms": events_ms(lambda: preprocess(x)),
                "network_ms": events_ms(lambda: extractor.net(pre, ("pool",)))}


def phase_generative() -> dict:
    """Phase 15 on one card, no sync: (i) CIFAR-10 test's size, 10,000 seeded real and fake 32 x 32 images in
    batches of 250, through FID (2048), KID (defaults: one ``poly_mmd`` launch at compute), IS
    (``logits_unbiased``, 10 splits) and MiFID on the random-init InceptionV3 at full width, the computes held on
    the final states (``_generative_computes``); (ii) BAPPS 2AFC val's patches, 4,000 seeded 64 x 64 pairs through
    LPIPS with alex, vgg and squeeze; (iii) PPL with 2,000 samples of a seeded conv generator (512-wide latent,
    128 x 128 images resized to 64) and the VGG net. Each leg reruns its first batch (its first
    ``GEN_CPU_IMAGES`` images or pairs) on the CPU path."""
    from torchmetrics_tpu_torch import image as ti
    from torchmetrics_tpu_torch.kernels.poly_mmd import poly_mmd

    record = {}
    # (i) four metrics, each with its own InceptionV3 (the same seeded weights)
    t0 = time.perf_counter()
    make = {"fid": lambda dev: ti.FrechetInceptionDistance(feature=2048, device=dev),
            "kid": lambda dev: ti.KernelInceptionDistance(device=dev),
            "is": lambda dev: ti.InceptionScore(device=dev),
            "mifid": lambda dev: ti.MemorizationInformedFrechetInceptionDistance(device=dev)}
    metrics = {name: f("cuda") for name, f in make.items()}
    build_s = time.perf_counter() - t0
    times = {name: [] for name in metrics}
    poly_mmd.launches = 0
    t0 = time.perf_counter()
    for j, (real, fake) in enumerate(_cifar_batches()):
        for name, metric in metrics.items():
            t1 = time.perf_counter()
            if name == "is":
                metric.update(fake)
            else:
                metric.update(real, real=True)
                metric.update(fake, real=False)
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t1) * 1e3)
        if j == 0:
            first = (real, fake)
    values, compute_ms = _timed_computes(metrics)
    leg_s = time.perf_counter() - t0
    launches = poly_mmd.launches
    check(launches == 1, f"[generative cifar] {launches} poly_mmd launches, 1 expected")
    check(float(values["fid"]) > 0 and float(values["mifid"]) > 0 and float(values["is"][0]) >= 1.0 - 1e-6
          and math.isfinite(float(values["kid"][0])) and float(values["kid"][1]) > 0,
          f"[generative cifar] values {values}")
    cpu_metrics = {name: f("cpu") for name, f in make.items()}
    t_ref = time.perf_counter()
    computes = _generative_computes(metrics, cpu_metrics, values)
    computes_s = time.perf_counter() - t_ref
    network = _inception_times(metrics["fid"].inception, first[0])
    # the first batch's first images again, through each card metric's functional core and on the CPU path
    t_cpu = time.perf_counter()
    compared = 0
    for name, card in metrics.items():
        cpu = cpu_metrics[name]
        states = []
        for metric, dev in ((card, "cuda"), (cpu, "cpu")):
            real, fake = (x[:GEN_CPU_IMAGES].to(dev) for x in first)
            st = metric.init_state()
            if name == "is":
                st = metric.update_state(st, fake)
            else:
                st = metric.update_state(metric.update_state(st, real, real=True), fake, real=False)
            states.append(st)
        for leaf, want in states[1].items():
            got = states[0][leaf]
            got, want = (torch.cat(got) if isinstance(got, tuple) else got).cpu(), (
                torch.cat(want) if isinstance(want, tuple) else want)
            if not got.dtype.is_floating_point:
                check(torch.equal(got, want), f"[generative cifar] {name}.{leaf}")
            else:
                err = float((got.double() - want.double()).abs().max())
                check(err <= 1e-4 * float(want.double().abs().max()) + 1e-30,
                      f"[generative cifar] {name}.{leaf}: card and CPU differ by {err:.3g}")
            compared += 1
        if name == "is":
            compared += _assert_same("[generative cifar] IS of the first images", card.compute_state(states[0]),
                                     cpu.compute_state(states[1]), 1e-4, 1e-5)
    record["cifar"] = {"images": CIFAR_IMAGES, "build_s": build_s, "leg_s": leg_s,
                       "update_ms_median": {n: statistics.median(t) for n, t in times.items()},
                       "compute_ms": compute_ms, "launches": {"poly_mmd": launches}, "computes_held": computes,
                       "computes_held_s": computes_s, "inception_ms": network,
                       "values": {n: _value_summary(v) for n, v in values.items()}, "cpu_compared": compared,
                       "cpu_rerun_s": time.perf_counter() - t_cpu}
    print(f"[generative] CIFAR-10: {CIFAR_IMAGES} real and fake images in {leg_s:.1f} s (the four InceptionV3 built "
          f"in {build_s:.1f} s): update medians {record['cifar']['update_ms_median']} ms a batch of {CIFAR_BATCH} "
          f"(real and fake), computes {compute_ms} ms; {launches} poly_mmd launch; values "
          f"{record['cifar']['values']}; the first batch's first {GEN_CPU_IMAGES} images match the CPU path "
          f"({compared} leaves within 1e-4 of their scale) in {record['cifar']['cpu_rerun_s']:.1f} s")
    print(f"[generative] CIFAR-10: the card's computes on the final states held in {computes_s:.1f} s: {computes}")
    print(f"[generative] CIFAR-10: InceptionV3 a batch of {CIFAR_BATCH} (CUDA events, median of 5): preprocess "
          f"(32 -> 299) {network['preprocess_ms']:.4f} ms, the network to the pool {network['network_ms']:.4f} ms "
          f"({network['network_ms'] / CIFAR_BATCH:.4f} ms an image)")
    del metrics, cpu_metrics, first, values
    torch.cuda.empty_cache()

    # (ii) LPIPS with the three nets
    nets = {f"lpips_{n}": (lambda dev, n=n: ti.LearnedPerceptualImagePatchSimilarity(net_type=n, device=dev))
            for n in ("alex", "vgg", "squeeze")}
    lp = {name: f("cuda") for name, f in nets.items()}
    t0 = time.perf_counter()
    update_ms = _timed_updates(lp, _bapps_batches())
    values, compute_ms = _timed_computes(lp)
    leg_s = time.perf_counter() - t0
    check(all(0.0 < float(v) < 10.0 for v in values.values()), f"[generative lpips] values {values}")
    t_cpu, compared = time.perf_counter(), 0
    first = [x[:GEN_CPU_IMAGES].cpu() for x in next(_bapps_batches())]
    for name, f in nets.items():
        card, cpu = f("cuda"), f("cpu")
        card.update(*(x.cuda() for x in first))
        cpu.update(*first)
        compared += _assert_same(f"[generative lpips] {name} first batch", card.compute(), cpu.compute(), 1e-4, 1e-6)
    record["lpips"] = {"pairs": BAPPS_PAIRS, "leg_s": leg_s, "update_ms_median": update_ms, "compute_ms": compute_ms,
                       "values": {n: float(v) for n, v in values.items()}, "cpu_compared": compared,
                       "cpu_rerun_s": time.perf_counter() - t_cpu}
    print(f"[generative] LPIPS: {BAPPS_PAIRS} pairs in {leg_s:.1f} s: update medians {update_ms} ms a batch of "
          f"{BAPPS_BATCH}, values {record['lpips']['values']}; the first batch's first {GEN_CPU_IMAGES} pairs match "
          f"the CPU path (within 1e-4)")
    del lp

    # (iii) PPL on the seeded generator and the VGG net
    gen_card = _ConvGenerator(SEED + 66).cuda().eval()
    ppl = ti.PerceptualPathLength(num_samples=PPL_SAMPLES, device="cuda")
    t0 = time.perf_counter()
    ppl.update(gen_card)
    torch.cuda.synchronize()
    update_s = time.perf_counter() - t0
    mean, std, kept = ppl.compute()
    check(math.isfinite(float(mean)) and float(mean) > 0 and 0 < kept.numel() < PPL_SAMPLES,
          f"[generative ppl] mean {float(mean)}, kept {kept.numel()}")
    # the first batch again on the CPU path, on the same latents and t (the card's Philox draws are not the CPU's)
    t_cpu = time.perf_counter()
    rng = torch.Generator(device="cuda").manual_seed(0)
    z1, z2 = gen_card.sample(rng, ppl.batch_size), gen_card.sample(rng, ppl.batch_size)
    t = torch.rand((ppl.batch_size, 1), generator=rng, device="cuda")
    card_d = ppl._distances(gen_card, z1, z2, t, None)
    check(torch.allclose(card_d, ppl.metric_state["distances"][0][:ppl.batch_size]),
          "[generative ppl] the update's first batch is not its first draws")
    ppl_cpu = ti.PerceptualPathLength(num_samples=PPL_SAMPLES, device="cpu")
    cpu_d = ppl_cpu._distances(_ConvGenerator(SEED + 66).eval(), z1.cpu(), z2.cpu(), t.cpu(), None)
    rel = float(((card_d.cpu() - cpu_d).abs() / cpu_d.abs()).max())
    check(rel <= PPL_CPU_RTOL, f"[generative ppl] the first batch's distances differ from the CPU path by {rel:.3g}")
    record["ppl"] = {"samples": PPL_SAMPLES, "update_s": update_s, "mean": float(mean), "std": float(std),
                     "kept": kept.numel(), "cpu_max_rel_err": rel, "cpu_rerun_s": time.perf_counter() - t_cpu}
    print(f"[generative] PPL: {PPL_SAMPLES} samples in {update_s:.1f} s (batches of {ppl.batch_size}); mean "
          f"{float(mean):.6g}, std {float(std):.6g}, {kept.numel()} kept; the first batch's distances within "
          f"{rel:.3g} relative of the CPU path's (tolerance {PPL_CPU_RTOL}: float32 noise over epsilon ** 2)")
    return record


# ------------------------------------------------ phase 16: multimodal and the wrappers
CLIP_VIT_L14 = {  # openai/clip-vit-large-patch14's published widths: about 428 M parameters
    "text": dict(vocab_size=49_408, hidden_size=768, intermediate_size=3_072, num_hidden_layers=12,
                 num_attention_heads=12, max_position_embeddings=77, hidden_act="quick_gelu"),
    "vision": dict(hidden_size=1_024, intermediate_size=4_096, num_hidden_layers=24, num_attention_heads=16,
                   image_size=224, patch_size=14, hidden_act="quick_gelu"),
    "projection_dim": 768,
}
CLIP_CHARS = "abcdefghijklmnopqrstuvwxyz0123456789.,!?;:'\"-()&/"  # each a token, and each with its </w> form
COCO_CAPTION_IMAGES, COCO_CAPTION_BATCH, COCO_CAPTION_HW = 1_000, 50, (480, 640)  # COCO val2017's images
KONIQ_IMAGES, KONIQ_BATCH, KONIQ_HW = 500, 25, (768, 1_024)  # KonIQ-10k's 1024 x 768 images
CLIP_CPU_PAIRS = 8  # CLIPScore's first batch's first pairs again on the CPU path
CLIP_FEATURE_TOL = 1e-4  # CLIP features, the card against the CPU, of their largest magnitude: full float32
# on both, 24 layers of products summed in other orders (cuBLAS's, oneDNN's)
CLIP_SCORE_TOL = 100 * 2 * CLIP_FEATURE_TOL  # a pair's score: 100 cos of two unit rows each off by the above
CLIP_PROB_TOL = 100 * 2 * 2 * CLIP_FEATURE_TOL / 4  # a CLIP-IQA probability: two logits (100 cos) each off by
# the score's bound, through the softmax's slope of at most 1/4
SHARE_IMAGES = 2_000  # CIFAR-10 images (and as many fakes) through FeatureShare
BOOT_BATCHES = 10  # ImageNet-1k batches of phase 4 through BootStrapper and the short wrapper leg


class _Stopwatch:
    """A callable's host time a call, the card synchronized before and after, appended to ``times``."""

    def __init__(self, fn, times: list):
        self.fn, self.times = fn, times

    def __call__(self, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.fn(*args, **kwargs)
        torch.cuda.synchronize()
        self.times.append((time.perf_counter() - t0) * 1e3)
        return out


def _clip_checkpoint(directory: str) -> dict:
    """A random-init ``CLIPModel`` at ViT-L/14's widths (weights from ``torch.manual_seed``, drawn on the card), a
    character-level CLIP vocabulary (``CLIP_CHARS`` and their ``</w>`` forms after the start and end tokens, no
    merges; the text config's ``bos_token_id``/``eos_token_id`` pinned to them: a character outside the vocabulary
    would map to the end token, where the text tower pools) and ``CLIPImageProcessor()`` at its defaults (224
    shortest edge, 224 crop, OpenAI's mean and std), saved to ``directory``; returns the parameter count and the
    seconds of each step."""
    t0 = time.perf_counter()
    from transformers import CLIPConfig, CLIPImageProcessor, CLIPModel, CLIPTokenizer

    out = {"import_s": time.perf_counter() - t0}

    vocab = {"<|startoftext|>": 0, "<|endoftext|>": 1}
    for c in CLIP_CHARS:
        vocab[c] = len(vocab)
        vocab[c + "</w>"] = len(vocab)
    vocab_path, merges_path = os.path.join(directory, "vocab.json"), os.path.join(directory, "merges.txt")
    with open(vocab_path, "w") as f:
        json.dump(vocab, f)
    with open(merges_path, "w") as f:
        f.write("#version: 0.2\n")
    CLIPTokenizer(vocab_path, merges_path, model_max_length=77).save_pretrained(directory)
    CLIPImageProcessor().save_pretrained(directory)
    cfg = CLIPConfig(text_config=dict(CLIP_VIT_L14["text"], bos_token_id=0, eos_token_id=1, pad_token_id=1),
                     vision_config=dict(CLIP_VIT_L14["vision"]), projection_dim=CLIP_VIT_L14["projection_dim"])
    t0 = time.perf_counter()
    torch.manual_seed(SEED + 70)
    with torch.device("cuda"):
        model = CLIPModel(cfg)
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    model.eval().save_pretrained(directory)
    out["save_s"] = time.perf_counter() - t0
    out["parameters"] = sum(p.numel() for p in model.parameters())
    return out


def _clip_images(n: int, batch: int, hw, seed: int):
    """Seeded uint8 ``(batch, 3, *hw)`` images made on the card: noise at a sixteenth of the size, upsampled."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for _ in range(0, n, batch):
        base = torch.rand((batch, 3, hw[0] // 16, hw[1] // 16), generator=gen, device="cuda") * 255
        yield torch.nn.functional.interpolate(base, size=hw, mode="bilinear", align_corners=False).round().to(
            torch.uint8)


def _captions(n: int, seed: int) -> list:
    """``n`` seeded captions of 5-20 words from a vocabulary of 2,000 seeded words, each ending in a period (one
    token a character: about half run past the text tower's 77 positions)."""
    gen = np.random.default_rng(seed)
    words = _seeded_words(2_000, gen)
    return [" ".join(gen.choice(words, k)) + "." for k in gen.integers(5, 21, n)]


def _kept(encoder, kept: dict, key: str, x):
    """``encoder(x)``, kept in ``kept[key]``."""
    kept[key] = encoder(x)
    return kept[key]


class _TowerEvents:
    """CUDA events around a CLIP tower and its projection (a forward pre-hook on the tower, a forward hook on the
    projection): each call's device time, ms."""

    def __init__(self, tower, projection):
        self.pairs = []
        self.handles = [tower.register_forward_pre_hook(self._start), projection.register_forward_hook(self._end)]

    def _start(self, module, args):
        self.pairs.append([torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)])
        self.pairs[-1][0].record()

    def _end(self, module, args, out):
        self.pairs[-1][1].record()

    def times_ms(self) -> list:
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.pairs]

    def remove(self) -> None:
        for handle in self.handles:
            handle.remove()


def _clip_timers(metric, image_encoder, text_encoder) -> dict:
    """Stopwatches on a CLIP metric's encoders and on the image processor's host pass, CUDA events on the towers."""
    times = {"preprocess": [], "image_encoder": [], "text_encoder": [],
             "image_tower": _TowerEvents(image_encoder.model.vision_model, image_encoder.model.visual_projection)}
    image_encoder._pixel_values = _Stopwatch(type(image_encoder)._pixel_values.__get__(image_encoder),
                                             times["preprocess"])
    metric.image_encoder = _Stopwatch(image_encoder, times["image_encoder"])
    if text_encoder is not None:
        metric.text_encoder = _Stopwatch(text_encoder, times["text_encoder"])
        times["text_tower"] = _TowerEvents(text_encoder.model.text_model, text_encoder.model.text_projection)
    return times


def _clip_medians(times: dict, updates: list) -> dict:
    """Medians a batch, ms, and the towers' share of the card's float32 rate: the host preprocessing; the image
    encoder (the batch's copy to the host, the preprocessing, the pixels' copy back, the tower); the image tower
    and the text tower by CUDA events; the text encoder (the tokenizer, the copies, the tower); the update. The
    timers are removed."""
    out = {"preprocess": statistics.median(times["preprocess"]),
           "image_encoder": statistics.median(times["image_encoder"]), "update": statistics.median(updates)}
    towers = [k for k in ("image_tower", "text_tower") if k in times]
    for key in towers:
        out[key] = statistics.median(times[key].times_ms()[:len(updates)])
        times[key].remove()
    if times["text_encoder"]:
        out["text_encoder"] = statistics.median(times["text_encoder"])
    return out


def _clip_tower_flop(tower: dict, tokens: int, projection: int) -> float:
    """A CLIP tower's multiply-adds, times 2, for one input of ``tokens`` positions: the attention projections
    and the MLP of each layer, the attention's two products, the projection of the pooled output (and for the
    vision tower, the patch embedding)."""
    h, i, layers = tower["hidden_size"], tower["intermediate_size"], tower["num_hidden_layers"]
    flop = layers * (2 * tokens * (4 * h * h + 2 * h * i) + 4 * tokens * tokens * h) + 2 * h * projection
    if "patch_size" in tower:
        flop += 2 * (tokens - 1) * 3 * tower["patch_size"] ** 2 * h
    return float(flop)


def _clip_leg(ckpt: str) -> dict:
    """(i) CLIPScore over COCO val2017's shape, 1,000 captioned images in batches of 50, and (ii) CLIP-IQA over
    KonIQ-10k's, 500 images in batches of 25 at ``data_range=255`` with every prompt keyword and a custom pair,
    both on the checkpoint's model on the card; each reruns its first batch (CLIPScore: its first 8 pairs) on the
    CPU path at the same weights."""
    import warnings

    from torchmetrics_tpu_torch.multimodal import CLIPImageQualityAssessment, CLIPScore
    from torchmetrics_tpu_torch.multimodal.backbones.clip import load_clip_encoders

    tcs = importlib.import_module("torchmetrics_tpu_torch.functional.multimodal.clip_score")
    record = {}
    t0 = time.perf_counter()
    image_encoder, text_encoder = load_clip_encoders(ckpt, "cuda")
    record["load_s"] = time.perf_counter() - t0
    check(image_encoder.model.training is False and image_encoder.device.type == "cuda",
          "[multimodal] the CLIP model is not on the card in eval mode")
    import PIL
    import transformers

    record["libraries"] = {"transformers": transformers.__version__, "PIL": PIL.__version__,
                           "torchvision": importlib.util.find_spec("torchvision") is not None,
                           "image_processor": type(image_encoder.processor.image_processor).__name__}
    print(f"[multimodal] {record['libraries']}; the CLIP model loaded in {record['load_s']:.1f} s")

    # (i) CLIPScore
    metric = CLIPScore(model_name_or_path=ckpt, device="cuda")
    times = _clip_timers(metric, image_encoder, text_encoder)
    captions = _captions(COCO_CAPTION_IMAGES, SEED + 71)
    updates, first = [], None
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for j, imgs in enumerate(_clip_images(COCO_CAPTION_IMAGES, COCO_CAPTION_BATCH, COCO_CAPTION_HW, SEED + 72)):
            caps = captions[j * COCO_CAPTION_BATCH:(j + 1) * COCO_CAPTION_BATCH]
            t1 = time.perf_counter()
            metric.update(imgs, caps)
            torch.cuda.synchronize()
            updates.append((time.perf_counter() - t1) * 1e3)
            if j == 0:
                first = (imgs[:CLIP_CPU_PAIRS], caps[:CLIP_CPU_PAIRS])
    truncated = sum("max_position_embeddings=77" in str(w.message) for w in caught)
    values, compute_ms = _timed_computes({"clip_score": metric})
    leg_s = time.perf_counter() - t0
    medians = _clip_medians(times, updates)
    vision = CLIP_VIT_L14["vision"]
    image_flop = COCO_CAPTION_BATCH * _clip_tower_flop(
        vision, (vision["image_size"] // vision["patch_size"]) ** 2 + 1, CLIP_VIT_L14["projection_dim"])
    text = CLIP_VIT_L14["text"]  # every batch holds a caption cut to the 77 positions
    text_flop = COCO_CAPTION_BATCH * _clip_tower_flop(text, text["max_position_embeddings"],
                                                      CLIP_VIT_L14["projection_dim"])
    medians["image_tower_fp32_share"] = image_flop / (medians["image_tower"] * 1e-3) / PEAK_FP32_OPS_PER_S
    medians["text_tower_fp32_share"] = text_flop / (medians["text_tower"] * 1e-3) / PEAK_FP32_OPS_PER_S
    score = float(values["clip_score"])
    check(truncated > 0, "[multimodal clip_score] no caption ran past 77 tokens: the truncation warning never fired")
    check(math.isfinite(score) and 0.0 <= score <= 100.0, f"[multimodal clip_score] score {score}")
    check(float(metric.metric_state["n_samples"]) == COCO_CAPTION_IMAGES, "[multimodal clip_score] n_samples")
    # the first batch's first pairs through each metric's functional core, on the card and on the CPU path (one
    # pass of each tower, the features kept): the features, each pair's score, the state
    t_cpu = time.perf_counter()
    imgs, caps = first
    cpu_metric = CLIPScore(model_name_or_path=ckpt, device="cpu")
    feats = {}
    for m, encoders, tag in ((metric, (image_encoder, text_encoder), "card"),
                             (cpu_metric, (cpu_metric.image_encoder, cpu_metric.text_encoder), "cpu")):
        m.image_encoder = functools.partial(_kept, encoders[0], feats, f"{tag} image")
        m.text_encoder = functools.partial(_kept, encoders[1], feats, f"{tag} text")
    card_state = metric.update_state(metric.init_state(), imgs, caps)
    cpu_state = cpu_metric.update_state(cpu_metric.init_state(), imgs.cpu(), caps)
    feature_err = max(float((feats[f"card {k}"].cpu() - feats[f"cpu {k}"]).abs().max() / feats[f"cpu {k}"].abs().max())
                      for k in ("image", "text"))
    card_pairs, cpu_pairs = (100 * (tcs._unit_rows(feats[f"{tag} image"], dev)
                                    * tcs._unit_rows(feats[f"{tag} text"], dev)).sum(-1)
                             for tag, dev in (("card", torch.device("cpu")), ("cpu", torch.device("cpu"))))
    score_err = float((card_pairs - cpu_pairs).abs().max())
    state_err = abs(float(card_state["score"]) - float(cpu_state["score"]))
    check(feature_err <= CLIP_FEATURE_TOL and score_err <= CLIP_SCORE_TOL
          and state_err <= CLIP_SCORE_TOL * CLIP_CPU_PAIRS
          and float(card_state["n_samples"]) == float(cpu_state["n_samples"]) == CLIP_CPU_PAIRS,
          f"[multimodal clip_score] the card against the CPU: features {feature_err:.3g} of scale (tolerance "
          f"{CLIP_FEATURE_TOL}), pair scores {score_err:.3g} (tolerance {CLIP_SCORE_TOL}), state {state_err:.3g}")
    record["clip_score"] = {"images": COCO_CAPTION_IMAGES, "batch": COCO_CAPTION_BATCH, "leg_s": leg_s,
                            "medians_ms": medians, "compute_ms": compute_ms["clip_score"],
                            "value": score, "truncation_warnings": truncated,
                            "captions_past_77": sum(len(ids) > 77 for ids in
                                                    text_encoder.processor.tokenizer(captions)["input_ids"]),
                            "cpu": {"pairs": CLIP_CPU_PAIRS, "feature_err": feature_err, "score_err": score_err,
                                    "state_err": state_err, "s": time.perf_counter() - t_cpu}}
    print(f"[multimodal] CLIPScore: {COCO_CAPTION_IMAGES} images of {COCO_CAPTION_HW} with captions in "
          f"{leg_s:.1f} s: medians a batch of {COCO_CAPTION_BATCH} {record['clip_score']['medians_ms']} ms, compute "
          f"{compute_ms['clip_score']:.3f} ms; score {score:.6g}; {truncated} truncation warnings; the first "
          f"{CLIP_CPU_PAIRS} pairs on the CPU path: features within {feature_err:.3g} of scale, scores within "
          f"{score_err:.3g}, state within {state_err:.3g} ({record['clip_score']['cpu']['s']:.1f} s)")

    # (ii) CLIP-IQA: every keyword and a custom pair
    from torchmetrics_tpu_torch.functional.multimodal.clip_iqa import _PROMPTS

    prompts = (*_PROMPTS, ("Crisp photo.", "Soft photo."))
    t0 = time.perf_counter()
    iqa = CLIPImageQualityAssessment(model_name_or_path=ckpt, data_range=255.0, prompts=prompts, device="cuda")
    torch.cuda.synchronize()
    init_ms = (time.perf_counter() - t0) * 1e3
    times = _clip_timers(iqa, image_encoder, None)
    updates, first = [], None
    t0 = time.perf_counter()
    for j, imgs in enumerate(_clip_images(KONIQ_IMAGES, KONIQ_BATCH, KONIQ_HW, SEED + 73)):
        t1 = time.perf_counter()
        iqa.update(imgs)
        torch.cuda.synchronize()
        updates.append((time.perf_counter() - t1) * 1e3)
        if j == 0:
            first = imgs
    values, compute_ms = _timed_computes({"clip_iqa": iqa})
    leg_s = time.perf_counter() - t0
    medians = _clip_medians(times, updates)
    medians["image_tower_fp32_share"] = (KONIQ_BATCH / COCO_CAPTION_BATCH * image_flop
                                         / (medians["image_tower"] * 1e-3) / PEAK_FP32_OPS_PER_S)
    del image_encoder._pixel_values  # the stopwatch
    probs = values["clip_iqa"]
    check(len(probs) == len(prompts) and "user_defined_0" in probs
          and all(p.shape == (KONIQ_IMAGES,) and bool(((p >= 0) & (p <= 1)).all()) for p in probs.values()),
          f"[multimodal clip_iqa] probabilities: {[(k, tuple(p.shape)) for k, p in probs.items()]}")
    t_cpu = time.perf_counter()
    cpu_iqa = CLIPImageQualityAssessment(model_name_or_path=ckpt, data_range=255.0, prompts=prompts, device="cpu")
    anchor_err = float((iqa.anchors.cpu() - cpu_iqa.anchors).abs().max())
    card_state = iqa.update_state(iqa.init_state(), first)
    cpu_state = cpu_iqa.update_state(cpu_iqa.init_state(), first.cpu())
    feat_err = float((card_state["img_features"][0].cpu() - cpu_state["img_features"][0]).abs().max())
    card_p, cpu_p = iqa.compute_state(card_state), cpu_iqa.compute_state(cpu_state)
    prob_err = max(float((card_p[k].cpu() - cpu_p[k]).abs().max()) for k in cpu_p)
    check(anchor_err <= CLIP_FEATURE_TOL and feat_err <= CLIP_FEATURE_TOL and prob_err <= CLIP_PROB_TOL,
          f"[multimodal clip_iqa] the card against the CPU: anchors {anchor_err:.3g}, unit features {feat_err:.3g} "
          f"(tolerance {CLIP_FEATURE_TOL}), probabilities {prob_err:.3g} (tolerance {CLIP_PROB_TOL})")
    record["clip_iqa"] = {"images": KONIQ_IMAGES, "batch": KONIQ_BATCH, "prompts": len(prompts), "leg_s": leg_s,
                          "init_ms": init_ms, "medians_ms": medians,
                          "compute_ms": compute_ms["clip_iqa"],
                          "means": {k: float(p.mean()) for k, p in list(probs.items())[:3]},
                          "cpu": {"anchor_err": anchor_err, "feature_err": feat_err, "prob_err": prob_err,
                                  "s": time.perf_counter() - t_cpu}}
    print(f"[multimodal] CLIP-IQA: {KONIQ_IMAGES} images of {KONIQ_HW}, {len(prompts)} prompt pairs (anchors "
          f"embedded at init in {init_ms:.1f} ms) in {leg_s:.1f} s: medians a batch of {KONIQ_BATCH} "
          f"{record['clip_iqa']['medians_ms']} ms, compute {compute_ms['clip_iqa']:.3f} ms; the first batch on the "
          f"CPU path: anchors within {anchor_err:.3g}, unit features {feat_err:.3g}, probabilities {prob_err:.3g} "
          f"({record['clip_iqa']['cpu']['s']:.1f} s)")
    return record


def _feature_share_leg() -> dict:
    """``FeatureShare([FID, KID, IS], feature_attr="inception")``, all three at the 2048-wide pool (the shared
    network is the first member's), over 2,000 of phase 15's CIFAR-10 real and fake images, against the same three
    metrics unshared on the same updates: one InceptionV3 forward an update, the values equal."""
    from torchmetrics_tpu_torch import image as ti
    from torchmetrics_tpu_torch.kernels.poly_mmd import poly_mmd
    from torchmetrics_tpu_torch.wrappers import FeatureShare, NetworkCache

    def make():
        return [ti.FrechetInceptionDistance(feature=2048, device="cuda"),
                ti.KernelInceptionDistance(feature=2048, device="cuda"),
                ti.InceptionScore(feature=2048, device="cuda")]

    fs = FeatureShare(make(), feature_attr="inception")
    cache = fs["FrechetInceptionDistance"].inception
    check(isinstance(cache, NetworkCache) and all(m.inception is cache for m in fs.values()),
          "[wrappers featureshare] the members do not share one cache")
    forwards = [0]
    network = cache.network

    def counted(x):
        forwards[0] += 1
        return network(x)

    cache.network = counted
    plain = dict(zip(fs.keys(), make()))
    times = {"FeatureShare": [], **{name: [] for name in plain}}
    calls = 0
    t0 = time.perf_counter()
    for j, (real, fake) in enumerate(_cifar_batches()):
        if j * CIFAR_BATCH >= SHARE_IMAGES:
            break
        for imgs, is_real in ((real, True), (fake, False)):
            t1 = time.perf_counter()
            fs.update(imgs, real=is_real)
            torch.cuda.synchronize()
            times["FeatureShare"].append((time.perf_counter() - t1) * 1e3)
            calls += 1
            for name, m in plain.items():
                t1 = time.perf_counter()
                m.update(imgs, **m._filter_kwargs(real=is_real))
                torch.cuda.synchronize()
                times[name].append((time.perf_counter() - t1) * 1e3)
    check(forwards[0] == calls, f"[wrappers featureshare] {forwards[0]} InceptionV3 forwards for {calls} updates")
    poly_mmd.launches = 0
    shared, shared_ms = _timed_computes({"FeatureShare": fs})
    launches = poly_mmd.launches
    unshared, unshared_ms = _timed_computes(plain)
    leg_s = time.perf_counter() - t0
    errs = {}
    for name, want in unshared.items():
        got = shared["FeatureShare"][name]
        pairs = list(zip(got, want)) if isinstance(want, tuple) else [(got, want)]
        errs[name] = max(abs(float(g) - float(w)) / max(abs(float(w)), 1e-30) for g, w in pairs)
    check(launches == 1 and all(e <= 1e-9 for e in errs.values()),
          f"[wrappers featureshare] {launches} poly_mmd launches; shared against unshared, relative: {errs}")
    record = {"images": SHARE_IMAGES, "updates": calls, "forwards": forwards[0], "leg_s": leg_s,
              "update_ms_median": {n: statistics.median(t) for n, t in times.items()},
              "compute_ms": {"FeatureShare": shared_ms["FeatureShare"], **unshared_ms},
              "launches": {"poly_mmd": launches}, "rel_err": errs,
              "values": {n: _value_summary(v) if isinstance(v, torch.Tensor) else [float(x) for x in v]
                         for n, v in shared["FeatureShare"].items()}}
    print(f"[wrappers] FeatureShare: {SHARE_IMAGES} real and fake CIFAR-10 images, {calls} updates, {forwards[0]} "
          f"InceptionV3 forwards, in {leg_s:.1f} s: update medians {record['update_ms_median']} ms a batch of "
          f"{CIFAR_BATCH}; computes {record['compute_ms']} ms; values {record['values']}, the unshared metrics' "
          f"within {errs} relative; {launches} poly_mmd launch")
    return record


def _wrapper_legs() -> dict:
    """BootStrapper over 10 of phase 4's ImageNet-1k batches, and a short leg of MetricTracker, Running,
    MultitaskWrapper, ClasswiseWrapper and MinMaxMetric on the same batches, each against the CPU path."""
    from torchmetrics_tpu_torch.classification import (
        MulticlassAccuracy,
        MulticlassConfusionMatrix,
        MulticlassJaccardIndex,
    )
    from torchmetrics_tpu_torch.kernels.confmat import confmat_multiclass
    from torchmetrics_tpu_torch.regression import MeanSquaredError
    from torchmetrics_tpu_torch.wrappers import (
        BootStrapper,
        ClasswiseWrapper,
        MetricTracker,
        MinMaxMetric,
        MultitaskWrapper,
        Running,
    )

    data = _main_path_data(torch.Generator(device="cuda").manual_seed(SEED))
    batches = list(_batches(data, BOOT_BATCHES))
    cls = [b["cls"] for b in batches]
    record = {}

    def accuracy(dev):
        return MulticlassAccuracy(num_classes=N_CLASSES, average="micro", device=dev)

    def boot(metric, bs):
        times = []
        for b in bs:
            t0 = time.perf_counter()
            metric.update(*b)
            if b[0].is_cuda:
                torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return metric.compute(), statistics.median(times)

    t0 = time.perf_counter()
    card, card_ms = boot(BootStrapper(accuracy("cuda"), num_bootstraps=10, raw=True, seed=0), cls)
    cpu, cpu_ms = boot(BootStrapper(accuracy("cpu"), num_bootstraps=10, raw=True, seed=0),
                       [tuple(x.cpu() for x in b) for b in cls])
    compared = _assert_same("[wrappers bootstrapper] raw", card["raw"], cpu["raw"], 0.0, 0.0)
    compared += _assert_same("[wrappers bootstrapper] mean and std", {k: card[k] for k in ("mean", "std")},
                             {k: cpu[k] for k in ("mean", "std")}, 1e-6, 0.0)
    record["bootstrapper"] = {"batches": BOOT_BATCHES, "replicates": 10, "update_ms_median": card_ms,
                              "cpu_update_ms_median": cpu_ms, "mean": float(card["mean"]), "std": float(card["std"]),
                              "s": time.perf_counter() - t0}
    print(f"[wrappers] BootStrapper(MulticlassAccuracy, 10 replicates, seed 0): {BOOT_BATCHES} batches of "
          f"{BATCH} x {N_CLASSES}, update median {card_ms:.3f} ms (CPU path {cpu_ms:.3f}); mean "
          f"{float(card['mean']):.6f}, std {float(card['std']):.6f}; raw equal to the CPU path's, mean and std "
          f"within 1e-6")

    def drive_all(metrics, bs):
        out = {}
        tracker, running, multitask, classwise, minmax = metrics
        for step in range(3):  # three steps of three batches
            tracker.increment()
            for b in bs[3 * step:3 * step + 3]:
                tracker.update(*b)
        out["tracker"] = tracker.best_metric(return_step=True)
        for b in bs:
            running.update(*b)
            classwise.update(*b)
            out["minmax_forward"] = minmax(*b)
        out["running"], out["classwise"] = running.compute(), classwise.compute()
        for b, r in zip(bs, batches):
            reg = r["reg"] if b[0].is_cuda else tuple(x.cpu() for x in r["reg"])
            multitask.update({"cls": b[0], "reg": reg[0]}, {"cls": b[1], "reg": reg[1]})
        out["multitask"] = multitask.compute()
        return out

    def make_all(dev):
        return (MetricTracker(accuracy(dev)), Running(MulticlassConfusionMatrix(num_classes=N_CLASSES, device=dev),
                                                      window=3),
                MultitaskWrapper({"cls": accuracy(dev), "reg": MeanSquaredError(device=dev)}),
                ClasswiseWrapper(MulticlassJaccardIndex(num_classes=N_CLASSES, average=None, device=dev)),
                MinMaxMetric(accuracy(dev)))

    t0 = time.perf_counter()
    confmat_multiclass.launches = 0
    card = drive_all(make_all("cuda"), cls)
    torch.cuda.synchronize()
    launches = confmat_multiclass.launches
    card_s = time.perf_counter() - t0
    cpu = drive_all(make_all("cpu"), [tuple(x.cpu() for x in b) for b in cls])
    check(card["tracker"][1] == cpu["tracker"][1], f"[wrappers tracker] best step {card['tracker'][1]} on the card, "
          f"{cpu['tracker'][1]} on the CPU path")
    compared += _assert_same("[wrappers tracker] best value", card["tracker"][0], cpu["tracker"][0], 1e-6, 0.0)
    for name in ("running", "classwise", "multitask", "minmax_forward"):
        compared += _assert_same(f"[wrappers {name}]", card[name], cpu[name], 1e-6, 1e-7)
    check(launches == 2 * BOOT_BATCHES, f"[wrappers] {launches} confmat_multiclass launches, "
          f"{2 * BOOT_BATCHES} expected (Running's and ClasswiseWrapper's updates)")
    record["short"] = {"card_s": card_s, "launches": {"confmat_multiclass": launches}, "cpu_compared": compared,
                       "best_step": card["tracker"][1], "minmax": {k: float(card["minmax_forward"][k])
                                                                   for k in ("min", "max")}}
    print(f"[wrappers] MetricTracker (best step {card['tracker'][1]}), Running(window=3), MultitaskWrapper, "
          f"ClasswiseWrapper(MulticlassJaccardIndex) and MinMaxMetric over {BOOT_BATCHES} batches in {card_s:.2f} s: "
          f"{launches} confmat_multiclass launches; every result equal to the CPU path's ({compared} tensors)")
    return record


def phase_multimodal_wrappers() -> dict:
    """Phase 16 on one card, no sync: (i) CLIPScore on a random-init CLIP at ViT-L/14's widths saved to a
    temporary directory (``_clip_checkpoint``) over COCO val2017's shape, 1,000 seeded 3 x 480 x 640 uint8 images
    with seeded captions of 5-20 words in batches of 50 (the truncation warning must fire); (ii) CLIP-IQA on the
    same model over KonIQ-10k's shape, 500 seeded 3 x 768 x 1024 images in batches of 25, ``data_range=255``, the
    16 prompt keywords and a custom pair; (iii) ``FeatureShare`` of FID, KID and IS over 2,000 of phase 15's
    CIFAR-10 images (one InceptionV3 forward an update, values equal to the unshared metrics'; one ``poly_mmd``
    launch at compute), ``BootStrapper`` over 10 of phase 4's ImageNet-1k batches (raw equal to the CPU path's on
    the same seed), and MetricTracker, Running, MultitaskWrapper, ClasswiseWrapper and MinMaxMetric on those
    batches, each against the CPU path (20 ``confmat_multiclass`` launches). Each CLIP leg times the host
    preprocessing, the towers and the update of every batch, and reruns its first batch on the CPU path."""
    from torchmetrics_tpu_torch.multimodal.backbones import clip as clip_backbone

    tcs = importlib.import_module("torchmetrics_tpu_torch.functional.multimodal.clip_score")
    record = {}
    with tempfile.TemporaryDirectory() as ckpt:
        t0 = time.perf_counter()
        record["checkpoint"] = _clip_checkpoint(ckpt)
        torch.cuda.empty_cache()
        record["checkpoint"]["build_s"] = time.perf_counter() - t0
        print(f"[multimodal] CLIP at ViT-L/14's widths: {record['checkpoint']['parameters'] / 1e6:.1f} M parameters, "
              f"built and saved in {record['checkpoint']['build_s']:.1f} s ({record['checkpoint']})")
        record.update(_clip_leg(ckpt))
        clip_backbone._CLIP_CACHE.clear()  # the models of a directory that goes now
        tcs._RESOLVED_PAIRS.clear()
    torch.cuda.empty_cache()
    record["featureshare"] = _feature_share_leg()
    torch.cuda.empty_cache()
    record.update(_wrapper_legs())
    return record


# ------------------------------------------ quantile_hist and hll_insert (phase 3), phase 17: the sketches
SKETCH_BINS = 200  # approx="sketch"'s default grid (approx_error 1/200): 201 cells
SKETCH_TOL = 1e-6  # a sketch curve against the binned curve at the sketch's edges (JAX's property)
BLEU_SYNC_SAMPLE = 256  # phase 5's BLEU reservoir: 1,000 pairs overflow it, so its merge keeps the bottom k
DISTINCT_NGRAMS = (1, 2, 3, 4)
ZIPF_EXPONENT = 1.1  # the token ids of the DistinctNGrams legs: Zipf-distributed over GPT-2's vocabulary
# an H100 SM has 64 INT32 lanes beside its 128 FP32 ones: integer operations at half the float32 rate
INT32_OPS_PER_S = PEAK_FP32_OPS_PER_S / 2
HLL_OPS_PER_TOKEN, HLL_OPS_PER_WINDOW = 11, 16  # a key-chain step (an add, mix32's ten); the seed's mix, the rank


def _sketch_edge_scores(sketch, dev) -> torch.Tensor:
    """NaN, +-inf, -0.0, 0, 1.0, 1.5, -0.5 and every cell edge with the float32 values one ulp either side."""
    edges = sketch.edges_on(dev)
    special = torch.tensor([float("nan"), float("inf"), float("-inf"), -0.0, 0.0, 1.0, 1.5, -0.5], device=dev)
    return torch.cat([special, edges, torch.nextafter(edges, edges - 1), torch.nextafter(edges, edges + 1)])


def _qh_case(gen, n, k, task, sketch, edits=()):
    """A formatted curve batch on the card (float32 scores, int32 targets, 0/1 float32 weights) and a random
    non-zero integer-valued float32 state."""
    dev = torch.device("cuda")
    shape = (n,) if task == "binary" else (n, k)
    if task == "multiclass":
        scores = torch.softmax(3.0 * torch.randn((n, k), generator=gen, device=dev), dim=1)
        target = torch.randint(0, k, (n,), generator=gen, device=dev, dtype=torch.int32)
        weights = torch.ones((n,), device=dev)
    else:
        scores = torch.rand(shape, generator=gen, device=dev)
        target = (torch.rand(shape, generator=gen, device=dev) < 0.3).to(torch.int32)
        weights = torch.ones(shape, device=dev)
    if "edges" in edits and scores.numel():
        special = _sketch_edge_scores(sketch, dev)
        m = min(scores.numel(), special.numel())
        scores.view(-1)[:m] = special[:m]
    if "ignored" in edits:
        weights[torch.rand(weights.shape, generator=gen, device=dev) < 0.2] = 0.0
    if "all ignored" in edits:
        weights.zero_()
    if "targets" in edits and n:
        if task == "multiclass":  # outside [0, k): a negative for every class
            target[::7], target[3::11] = k, -1
        else:  # a target t adds 1 - t to the negative cell and t to the positive one
            target.view(-1)[::5], target.view(-1)[1::7] = 2, -1
    cells = sketch.bins + 1
    hist = torch.randint(0, 50, (2, cells) if task == "binary" else (k, 2, cells), generator=gen, device=dev)
    return scores.contiguous(), target.contiguous(), weights.contiguous(), hist.to(torch.float32)


def _floor_index_add(hist, scores, target, weights, sketch):
    """floor + index_add_ (several PyTorch calls, a yardstick): each entry's cell and side, then one ``index_add_``
    of the weights into the state."""
    n = scores.shape[0]
    k = scores.shape[1] if scores.ndim == 2 else 1
    cell = torch.nan_to_num(torch.floor(scores.reshape(n, k) * sketch.scale).clamp_(0, sketch.bins), nan=0.0).long()
    cls = torch.arange(k, device=scores.device)
    if scores.ndim == 2 and target.ndim == 1:
        side, w = (target[:, None] == cls).long(), weights[:, None].expand(n, k)
    else:
        side, w = target.reshape(n, k).long(), weights.reshape(n, k)
    idx = (cls * 2 + side) * (sketch.bins + 1) + cell
    hist.view(-1).index_add_(0, idx.reshape(-1), w.reshape(-1))


def phase_quantile_hist_kernel(flush: torch.Tensor) -> list:
    """``quantile_hist`` against its plain version (JAX's one-hot, broadcast, stack and float scatter-add) on the
    card, from a random non-zero state: the new state equal (``torch.equal``) and two launches equal. Timed at
    ImageNet-1k's batch (1,024 x 1,000 multiclass, the record's row), MS-COCO's multilabel batch (256 x 80) and the
    binary batch (1,024), beside floor + ``index_add_`` (a yardstick; library: none)."""
    from torchmetrics_tpu_torch.kernels import quantile_hist as kqh
    from torchmetrics_tpu_torch.sketches import QuantileSketch

    gen = torch.Generator(device="cuda").manual_seed(SEED + 70)
    grid = QuantileSketch(SKETCH_BINS)
    fine = QuantileSketch(10_000)  # 10,001 cells: past a block's shared memory, float atomics into the state
    cases = [  # (what, n, k, task, sketch, edits, timed)
        ("(a) ImageNet-1k batch, multiclass", BATCH, N_CLASSES, "multiclass", grid, (), True),
        ("(b) MS-COCO batch, multilabel", COCO_ML_BATCH, COCO_ML_LABELS, "multilabel", grid, (), True),
        ("(c) binary batch", BATCH, 1, "binary", grid, (), True),
        ("NaN, +-inf, -0.0, 1.0 and an ulp either side of every cell edge, multiclass", 300, 7, "multiclass", grid,
         ("edges",), False),
        ("edge scores, multilabel", 256, 5, "multilabel", grid, ("edges",), False),
        ("edge scores, binary", 700, 1, "binary", grid, ("edges",), False),
        ("ignored rows, multiclass", BATCH, N_CLASSES, "multiclass", grid, ("ignored",), False),
        ("ignored elements, multilabel", COCO_ML_BATCH, COCO_ML_LABELS, "multilabel", grid, ("ignored",), False),
        ("every row ignored", 512, 10, "multiclass", grid, ("all ignored",), False),
        ("every element ignored, multilabel", 100, 3, "multilabel", grid, ("all ignored",), False),
        ("targets outside [0, C)", 1000, 9, "multiclass", grid, ("targets",), False),
        ("targets 2 and -1, multilabel", 300, 4, "multilabel", grid, ("targets",), False),
        ("50,000 binary rows: chunks of rows", N_SAMPLES, 1, "binary", grid, ("edges",), False),
        ("the MS-COCO set in one launch", COCO_ML_IMAGES, COCO_ML_LABELS, "multilabel", grid, (), False),
        ("10,000 bins: global atomics", 256, 10, "multiclass", fine, ("edges",), False),
        ("3 cells", 333, 2, "multilabel", QuantileSketch(2), ("edges", "ignored"), False),
        ("empty batch", 0, 6, "multiclass", grid, (), False),
    ]
    rows = []
    for what, n, k, task, sketch, edits, timed in cases:
        scores, target, weights, hist = _qh_case(gen, n, k, task, sketch, edits)
        before = kqh.quantile_hist.launches
        got = kqh.quantile_hist(hist.clone(), scores, target, weights, sketch)
        again = kqh.quantile_hist(hist.clone(), scores, target, weights, sketch)
        want = kqh._quantile_hist_plain(hist, scores, target, weights, sketch)
        torch.cuda.synchronize()
        label = f"{what}: {task} {tuple(scores.shape)}, {sketch.bins} bins"
        check(kqh.quantile_hist.launches == before + (2 if n else 0), f"quantile_hist launches ({label})")
        check(torch.equal(got, want), f"quantile_hist and plain differ ({label}): max abs err "
                                      f"{float((got - want).abs().max()) if got.numel() else 0.0}")
        check(torch.equal(got, again), f"quantile_hist is not deterministic ({label})")
        row = {"case": label, "what": what, "max_abs_err": 0.0}
        if timed:
            nbytes = 4 * (scores.numel() + target.numel() + weights.numel() + 2 * hist.numel())
            bound_ms = nbytes / PEAK_BYTES_PER_S * 1e3
            pl = kqh.plan(n, k, sketch.bins + 1, torch.cuda.get_device_properties(0).multi_processor_count)
            h_kernel, h_yard = hist.clone(), hist.clone()
            kernel_ms = time_ms(lambda: kqh.quantile_hist(h_kernel, scores, target, weights, sketch), flush)
            plain_ms = time_ms(lambda: kqh._quantile_hist_plain(hist, scores, target, weights, sketch), flush,
                               reps=10, warmup=1)
            yard_ms = time_ms(lambda: _floor_index_add(h_yard, scores, target, weights, sketch), flush, reps=10,
                              warmup=1)
            # copies past the L2 where they fit in MAX_STREAM_COPIES (a small batch's calls stay under a few hundred)
            sets = [(scores, target, weights)] + [(scores.clone(), target.clone(), weights.clone())
                                                  for _ in range(min(copies_for(nbytes), MAX_STREAM_COPIES) - 1)]
            stream_ms = time_stream_ms(lambda s_, t_, w_: kqh.quantile_hist(h_kernel, s_, t_, w_, sketch), sets,
                                       calls=len(sets) * max(1, 24 // len(sets)))
            del sets
            row.update({"plan": pl._asdict(), "ms": kernel_ms, "stream_ms": stream_ms, "plain_ms": plain_ms,
                        "floor_index_add_yardstick_ms": yard_ms, "bound_ms": bound_ms, "bound_by": "bytes",
                        "bytes": nbytes, "library_ms": None})
            print(f"[kernel] quantile_hist {label}: exact, {kernel_ms:.4f} ms after an L2 flush ({stream_ms:.4f} ms "
                  f"a call back to back; plan {tuple(pl)}), plain (one-hot, stack, index_add) {plain_ms:.4f} ms, "
                  f"floor + index_add_ (a yardstick) {yard_ms:.4f} ms, bound {bound_ms * 1e3:.2f} us (bytes: "
                  f"{nbytes}), share {bound_ms / kernel_ms:.1%}; library_ms: none")
        rows.append(row)
        del scores, target, weights, hist, got, again, want
    print(f"[kernel] quantile_hist: equal to plain and deterministic on all {len(cases)} cases: "
          + "; ".join(r["what"] for r in rows))
    return rows


def _zipf_ids(gen: np.random.Generator, shape) -> np.ndarray:
    """Seeded int32 token ids, Zipf-distributed over GPT-2's vocabulary (frequent and rare n-grams, as text has)."""
    return (np.minimum(gen.zipf(ZIPF_EXPONENT, size=shape), GPT2_VOCAB) - 1).astype(np.int32)


def _wikitext_token_batches() -> list:
    """WikiText-103 test's length in GPT-2 token ids (``WIKITEXT103_TOKENS``) as the ``(8, 1,024)`` batches of
    phase 13, the last batch's tail past the set's end ``-100``, on the card."""
    gen = np.random.default_rng(SEED + 71)
    per_batch = PPL_BATCH * PPL_SEQ
    out = []
    for start in range(0, WIKITEXT103_TOKENS, per_batch):
        ids = _zipf_ids(gen, (PPL_BATCH, PPL_SEQ))
        ids.reshape(-1)[max(0, WIKITEXT103_TOKENS - start):] = -100
        out.append(torch.from_numpy(ids).cuda())
    return out


def phase_hll_kernel(flush: torch.Tensor) -> list:
    """``hll_insert`` against its plain version (JAX's window stack, key chain, rank and scatter-max) on the card:
    the registers and the total equal (``torch.equal``), two launches equal. Timed at phase 17's batch, 8 x 1,024
    GPT-2 token ids at n = 2 and precision 11 (the record's row), and at n = 1, 3 and 4, beside
    ``scatter_reduce_(amax)`` of the keys' ranks computed outside the timing (a yardstick; library: none)."""
    from torchmetrics_tpu_torch.kernels import hll as khll
    from torchmetrics_tpu_torch.sketches import HyperLogLog

    gen = np.random.default_rng(SEED + 72)
    wiki = (PPL_BATCH, PPL_SEQ)
    cases = [  # (what, shape, ngram, ignore_index, precision, edits, timed)
        ("(a) WikiText-103 batch, n=2, p=11", wiki, 2, -100, 11, ("tail",), True),
        *((f"WikiText-103 batch, n={n}, p=11", wiki, n, -100, 11, ("tail",), True) for n in (1, 3, 4)),
        *((f"precision {p}", wiki, 2, -100, p, ("tail",), False) for p in (4, 14, 18)),
        ("ignore_index windows (10 % of the tokens), n=3", wiki, 3, -100, 11, ("ignore",), False),
        ("every window ignored", (4, 64), 2, -100, 11, ("all ignored",), False),
        ("n longer than a row", (5, 3), 4, None, 11, (), False),
        ("ids -1, 2**31 - 1 and -2**31, no ignore_index", (3, 200), 2, None, 11, ("wrap",), False),
        ("the whole set in one launch, p=14", (WIKITEXT103_TOKENS // PPL_SEQ, PPL_SEQ), 2, -100, 14, (), False),
        ("the whole set in one launch, p=18", (WIKITEXT103_TOKENS // PPL_SEQ, PPL_SEQ), 4, -100, 18, (), False),
        ("empty batch", (0, PPL_SEQ), 2, -100, 11, (), False),
    ]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for what, shape, ngram, ignore_index, precision, edits, timed in cases:
        ids = _zipf_ids(gen, shape)
        if "tail" in edits:
            ids.reshape(-1)[-100:] = -100
        if "ignore" in edits:
            ids[gen.random(shape) < 0.1] = -100
        if "all ignored" in edits:
            ids[:, ::2] = -100
        if "wrap" in edits:
            ids.reshape(-1)[::7], ids.reshape(-1)[3::11], ids.reshape(-1)[5::13] = -1, 2**31 - 1, -2**31
        tokens = torch.from_numpy(ids).cuda()
        hll = HyperLogLog(precision=precision)
        regs0 = torch.randint(0, 4, (hll.m,), dtype=torch.int32, device="cuda")
        total0 = torch.tensor(float(gen.integers(0, 1000)), device="cuda")
        before = khll.hll_insert.launches
        got, got_total = khll.hll_insert(regs0.clone(), total0, tokens, ngram, ignore_index, hll)
        again, again_total = khll.hll_insert(regs0.clone(), total0, tokens, ngram, ignore_index, hll)
        want, want_total = khll._hll_insert_plain(regs0, total0, tokens, ngram, ignore_index, hll)
        torch.cuda.synchronize()
        windows = shape[0] * max(0, shape[1] - ngram + 1)
        label = f"{what}: {tuple(shape)}, n={ngram}, p={precision}"
        check(khll.hll_insert.launches == before + (2 if windows else 0), f"hll_insert launches ({label})")
        check(torch.equal(got, want) and torch.equal(got_total, want_total),
              f"hll_insert and plain differ ({label}): registers {int((got != want).sum())} apart, total "
              f"{float(got_total)} vs {float(want_total)}")
        check(torch.equal(got, again) and torch.equal(got_total, again_total), f"hll_insert is not deterministic ({label})")
        row = {"case": label, "what": what, "max_abs_err": 0.0}
        if timed:
            nbytes = 4 * (tokens.numel() + 2 * hll.m + 2)
            ops = windows * (HLL_OPS_PER_TOKEN * ngram + HLL_OPS_PER_WINDOW)
            bytes_ms, ops_ms = nbytes / PEAK_BYTES_PER_S * 1e3, ops / INT32_OPS_PER_S * 1e3
            from torchmetrics_tpu_torch.sketches.cardinality import hll_index_rank, mix32
            from torchmetrics_tpu_torch.text.distinct import window_keys

            keys, valid = window_keys(tokens, ngram, ignore_index)

            idx, rank = hll_index_rank(mix32(keys, hll.seed), precision)
            rank = torch.where(valid, rank, 0).to(torch.int32)
            r_kernel, r_yard = regs0.clone(), regs0.clone()
            kernel_ms = time_ms(lambda: khll.hll_insert(r_kernel, total0, tokens, ngram, ignore_index, hll), flush)
            plain_ms = time_ms(lambda: khll._hll_insert_plain(regs0, total0, tokens, ngram, ignore_index, hll), flush,
                               reps=10, warmup=1)
            yard_ms = time_ms(lambda: r_yard.scatter_reduce_(0, idx, rank, reduce="amax"), flush, reps=10, warmup=1)
            sets = [(tokens,)] + [(tokens.clone(),) for _ in range(min(copies_for(nbytes), MAX_STREAM_COPIES) - 1)]
            stream_ms = time_stream_ms(lambda t_: khll.hll_insert(r_kernel, total0, t_, ngram, ignore_index, hll),
                                       sets, calls=len(sets) * max(1, 24 // len(sets)))
            del sets
            bound_ms = max(bytes_ms, ops_ms)
            row.update({"blocks": khll.blocks_for(windows, precision, sms), "ms": kernel_ms, "stream_ms": stream_ms,
                        "plain_ms": plain_ms, "scatter_amax_yardstick_ms": yard_ms, "bound_ms": bound_ms,
                        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations", "bytes": nbytes,
                        "int_ops": ops, "library_ms": None})
            print(f"[kernel] hll_insert {label}: exact, {kernel_ms:.4f} ms after an L2 flush ({stream_ms:.4f} ms a "
                  f"call back to back; {row['blocks']} blocks), plain (window stack, key chain, scatter_reduce) "
                  f"{plain_ms:.4f} ms, scatter_reduce_(amax) of precomputed ranks (a yardstick) {yard_ms:.4f} ms, "
                  f"bound {bound_ms * 1e3:.3f} us (by {row['bound_by']}: {nbytes} bytes, {ops} integer operations "
                  f"at {INT32_OPS_PER_S / 1e12:.1f} TOP/s), share {bound_ms / kernel_ms:.1%}; library_ms: none")
        rows.append(row)
        del tokens, got, again, want
    print(f"[kernel] hll_insert: equal to plain and deterministic on all {len(cases)} cases: "
          + "; ".join(r["what"] for r in rows))
    return rows


CE_SUM_RTOL, CE_SUM_ATOL = 1e-5, 1e-6  # calibration_bins' conf_sum (32.32 sums) against plain float32 (phase 9)


def _equal_states(tag: str, got: dict, want: dict, close=()) -> None:
    """Every leaf equal (``torch.equal``) between the card and the CPU: the sketches' counts are exact. The leaves
    named in ``close`` (calibration's ``conf_sum``, sums of confidences) within ``CE_SUM_RTOL``/``CE_SUM_ATOL``."""
    check(set(got) == set(want), f"{tag}: keys {sorted(got)} vs {sorted(want)}")
    for k, w in want.items():
        g = got[k].cpu()
        if k in close:
            _assert_same(f"{tag}.{k}", g, w, CE_SUM_RTOL, CE_SUM_ATOL)
        else:
            check(g.dtype == w.dtype and torch.equal(g, w), f"{tag}.{k} differs between the card and the CPU")


def _sketch_leg(leg, make, batches, kernels, cpu_batches: int = CPU_RERUN_BATCHES, close=(),
                value_rtol: float = SKETCH_TOL):
    """``batches()`` (``(args, kwargs)`` of card tensors) through the collection ``make("cuda")``, the launches of
    ``kernels`` counted from 0 over this run only; the first ``cpu_batches`` batches again through ``make("cpu")``:
    the states equal (the sketches count exactly; the leaves in ``close`` as ``_equal_states`` says), the values
    within ``value_rtol``. Returns the record, the card collection and its values."""
    col, times, early = make("cuda"), [], None
    for kernel in kernels:
        kernel.launches = 0
    torch.cuda.synchronize()
    t_leg = time.perf_counter()
    for i, (args, kwargs) in enumerate(batches()):
        t0 = time.perf_counter()
        col.update(*args, **kwargs)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if i + 1 == cpu_batches:
            early = _snapshot(col)
    t0 = time.perf_counter()
    values = col.compute()
    torch.cuda.synchronize()
    compute_ms = (time.perf_counter() - t0) * 1e3
    leg_s = time.perf_counter() - t_leg
    launches = {k.__name__: k.launches for k in kernels}
    t_cpu = time.perf_counter()
    cpu_col = make("cpu")
    for args, kwargs in (b for _, b in zip(range(cpu_batches), batches())):
        cpu_col.update(*map(_cpu, args), **{k: _cpu(v) for k, v in kwargs.items()})
    for name, member in cpu_col.items(keep_base=True):
        tag = f"[{leg}] {name} after {cpu_batches} batches"
        _equal_states(f"{tag}: state", early[name], member.metric_state, close)
        _assert_same(f"{tag}: value", col[name].compute_state(early[name]), member.compute(), value_rtol, 1e-7)
    record = {"batches": i + 1, "launches": launches, "leg_s": leg_s, "update_ms_median": statistics.median(times),
              "compute_ms": compute_ms, "values": {k: _value_summary(v) for k, v in values.items()},
              "cpu_rerun_s": time.perf_counter() - t_cpu}
    return record, col, values


def _max_abs_diff(got, want) -> float:
    """The largest absolute difference of two results (tensors, or tuples of them: a ROC's three)."""
    if isinstance(want, (tuple, list)):
        check(len(got) == len(want), f"{len(got)} parts vs {len(want)}")
        return max((_max_abs_diff(g, w) for g, w in zip(got, want)), default=0.0)
    check(got.shape == want.shape, f"shape {tuple(got.shape)} vs {tuple(want.shape)}")
    return float((got - want).abs().max()) if want.numel() else 0.0


def _sketch_against(leg, record, values, reference: dict, tol: float, what: str) -> None:
    """Each value of the sketch run within ``tol`` of ``reference`` (the binned path at the sketch's edges)."""
    record[f"vs_{what}"] = {}
    for name, want in reference.items():
        diff = _max_abs_diff(values[name], want)
        check(diff <= tol, f"[{leg}] {name}: the sketch is {diff:.3g} from the {what} path (> {tol})")
        record[f"vs_{what}"][name] = diff


def _curve_references(make_binned, make_exact, batches) -> tuple:
    """The binned path at the sketch's edges and the exact path over the same batches, on the card."""
    binned, exact = make_binned(), make_exact()
    for args, kwargs in batches():
        binned.update(*args, **kwargs)
        exact.update(*args, **kwargs)
    return binned.compute(), exact.compute()


def _auroc_bound_check(leg, record, metric, value, exact) -> None:
    """The sketch AUROC within the largest per-class ``auc_error_bound`` of its histogram from the exact AUROC."""
    bound = float(metric._sketch.auc_error_bound(metric.metric_state["score_hist"]).max())
    diff = abs(float(value) - float(exact))
    check(diff <= bound + SKETCH_TOL, f"[{leg}] AUROC {float(value):.6f} is {diff:.3g} from exact {float(exact):.6f}, "
                                      f"past the sketch's bound {bound:.3g}")
    record["auroc"] = {"sketch": float(value), "exact": float(exact), "diff": diff, "auc_error_bound": bound}


def _sketch_curves(kernels) -> dict:
    """Phase 17 (i) and (ii): ImageNet-1k's set through sketch-mode multiclass AUROC and AP (one compute group:
    one quantile_hist launch a batch) and calibration error; MS-COCO's multilabel set through MultilabelAUROC;
    the binary rows of phase 7 (iv) through BinaryAUROC and BinaryROC."""
    from torchmetrics_tpu_torch import classification as tc
    from torchmetrics_tpu_torch.collections import MetricCollection

    record = {}
    data = _main_path_data(torch.Generator(device="cuda").manual_seed(SEED))
    probs, target = data[0], data[1]

    def imagenet_batches():
        return ((b["cls"], {}) for b in _batches(data))

    def imagenet(d, **kw):  # one compute group: one update a batch
        return MetricCollection({"auroc": tc.MulticlassAUROC(num_classes=N_CLASSES, validate_args=False, device=d, **kw),
                                 "ap": tc.MulticlassAveragePrecision(num_classes=N_CLASSES, validate_args=False, device=d,
                                                                     **kw)}, compute_groups=[["auroc", "ap"]])

    n_batches = -(-N_SAMPLES // BATCH)
    leg = "sketches imagenet"
    rec, col, values = _sketch_leg(leg, lambda d: imagenet(d, approx="sketch"), imagenet_batches, kernels)
    check(rec["launches"] == {"quantile_hist": n_batches, "hll_insert": 0}, f"[{leg}] launches {rec['launches']}")
    edges = col["auroc"].thresholds.tolist()
    binned, exact = _curve_references(lambda: imagenet("cuda", thresholds=edges), lambda: imagenet("cuda"),
                                      imagenet_batches)
    _sketch_against(leg, rec, values, binned, SKETCH_TOL, "binned")
    _auroc_bound_check(leg, rec, col["auroc"], values["auroc"], exact["auroc"])
    rec["ap"] = {"sketch": float(values["ap"]), "exact": float(exact["ap"])}
    record["imagenet"] = rec
    del col, binned, exact
    torch.cuda.empty_cache()

    # (ii) calibration: the kernel of the exact path computes the update, its counts added into float leaves
    leg = "sketches calibration"

    def calibration(d, **kw):
        return MetricCollection({"ce": tc.MulticlassCalibrationError(num_classes=N_CLASSES, validate_args=False,
                                                                     device=d, **kw)}, compute_groups=False)

    rec, col, values = _sketch_leg(leg, lambda d: calibration(d, approx="sketch"), imagenet_batches, kernels,
                                   close=("conf_sum",), value_rtol=CE_SUM_RTOL)
    check(col["ce"].n_bins == SKETCH_BINS, f"[{leg}] {col['ce'].n_bins} bins")
    exact_col = calibration("cuda", n_bins=SKETCH_BINS)
    for args, kwargs in imagenet_batches():
        exact_col.update(*args, **kwargs)
    _sketch_against(leg, rec, values, exact_col.compute(), SKETCH_TOL, "binned")
    for leaf in ("acc_sum", "count"):
        check(torch.equal(col["ce"].metric_state[leaf], exact_col["ce"].metric_state[leaf].to(torch.float32)),
              f"[{leg}] {leaf} differs from the exact path's int32 counts")
    record["calibration"] = rec
    del col, exact_col

    # MS-COCO 2014 val's multilabel shape
    leg = "sketches coco"
    scores, labels = _coco_multilabel_data(torch.Generator(device="cuda").manual_seed(SEED + 73))

    def coco_batches():
        return (((scores[i:i + COCO_ML_BATCH], labels[i:i + COCO_ML_BATCH]), {})
                for i in range(0, COCO_ML_IMAGES, COCO_ML_BATCH))

    def coco(d, **kw):
        return MetricCollection({"auroc": tc.MultilabelAUROC(num_labels=COCO_ML_LABELS, validate_args=False, device=d,
                                                             **kw)}, compute_groups=False)

    rec, col, values = _sketch_leg(leg, lambda d: coco(d, approx="sketch"), coco_batches, kernels)
    check(rec["launches"] == {"quantile_hist": -(-COCO_ML_IMAGES // COCO_ML_BATCH), "hll_insert": 0},
          f"[{leg}] launches {rec['launches']}")
    binned, exact = _curve_references(lambda: coco("cuda", thresholds=col["auroc"].thresholds.tolist()),
                                      lambda: coco("cuda"), coco_batches)
    _sketch_against(leg, rec, values, binned, SKETCH_TOL, "binned")
    _auroc_bound_check(leg, rec, col["auroc"], values["auroc"], exact["auroc"])
    record["coco"] = rec
    del col, binned, exact, scores, labels

    # the binary rows: the top score and whether the top-1 prediction is right
    leg = "sketches binary"
    conf, pred = probs.max(1)
    right = (pred == target).to(torch.int32)

    def binary_batches():
        return (((conf[i:i + BATCH], right[i:i + BATCH]), {}) for i in range(0, N_SAMPLES, BATCH))

    def binary(d, **kw):
        return MetricCollection({"auroc": tc.BinaryAUROC(validate_args=False, device=d, **kw),
                                 "roc": tc.BinaryROC(validate_args=False, device=d, **kw)},
                                compute_groups=[["auroc", "roc"]])

    rec, col, values = _sketch_leg(leg, lambda d: binary(d, approx="sketch"), binary_batches, kernels)
    check(rec["launches"] == {"quantile_hist": n_batches, "hll_insert": 0}, f"[{leg}] launches {rec['launches']}")
    binned, exact = _curve_references(lambda: binary("cuda", thresholds=col["auroc"].thresholds.tolist()),
                                      lambda: binary("cuda"), binary_batches)
    _sketch_against(leg, rec, values, binned, SKETCH_TOL, "binned")
    _auroc_bound_check(leg, rec, col["auroc"], values["auroc"], exact["auroc"])
    record["binary"] = rec
    del col, binned, exact

    # scores that require grad take the kernel as well (they only choose a cell: the histogram has no gradient)
    leg = "sketches requires_grad"
    with_grad, detached = (tc.BinaryAUROC(validate_args=False, approx="sketch", device="cuda") for _ in range(2))
    kernels[0].launches = 0
    with_grad.update(conf[:BATCH].clone().requires_grad_(), right[:BATCH])
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in kernels}
    check(launches == {"quantile_hist": 1, "hll_insert": 0}, f"[{leg}] launches {launches}")
    detached.update(conf[:BATCH], right[:BATCH])
    check(torch.equal(with_grad.metric_state["score_hist"], detached.metric_state["score_hist"]),
          f"[{leg}] the histogram differs from the detached scores' one")
    record["requires_grad"] = {"launches": launches}
    del data
    torch.cuda.empty_cache()
    return record


def _sketch_distinct(kernels) -> dict:
    """Phase 17 (iii): WikiText-103 test's length in GPT-2 token ids through DistinctNGrams(approx="sketch") at
    n = 1-4 (one hll_insert launch a batch and n), each estimate within 4 x its RSE of the exact ratio."""
    from torchmetrics_tpu_torch import text as tt
    from torchmetrics_tpu_torch.collections import MetricCollection

    leg = "sketches distinct"
    batches_ = _wikitext_token_batches()

    def batches():
        return (((b,), {}) for b in batches_)

    def make(d, **kw):
        return MetricCollection({f"n{n}": tt.DistinctNGrams(n, ignore_index=-100, device=d, **kw)
                                 for n in DISTINCT_NGRAMS}, compute_groups=False)

    rec, col, values = _sketch_leg(leg, lambda d: make(d, approx="sketch"), batches, kernels, cpu_batches=1)
    check(rec["launches"] == {"quantile_hist": 0, "hll_insert": len(batches_) * len(DISTINCT_NGRAMS)},
          f"[{leg}] launches {rec['launches']}")
    exact = make("cuda")
    for (args, _) in batches():
        exact.update(*args)
    exact_values = exact.compute()
    rec["ratios"] = {}
    for name, value in values.items():
        rse = col[name]._hll.relative_error
        want = float(exact_values[name])
        diff = abs(float(value) - want)
        check(diff <= 4 * rse * want, f"[{leg}] {name}: estimate {float(value):.6f} vs exact {want:.6f}, past 4 x RSE")
        rec["ratios"][name] = {"sketch": float(value), "exact": want, "rel_err": diff / want, "rse": rse,
                               "total": float(col[name].metric_state["total"])}
    return rec


def _reservoir_leg(leg, make, updates, exact_make=None) -> dict:
    """A reservoir metric over ``updates`` on the card and on the CPU: the reservoir rows and the sample count
    equal bit for bit; the estimate beside the exact path's value (on the card) and the stamped bound."""
    card, cpu = make("cuda"), make("cpu")
    t0 = time.perf_counter()
    for preds, target in updates:
        card.update(preds, target)
    value = card.compute()
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    for preds, target in updates:
        cpu.update(preds, target)
    for leaf in ("corpus_sample", "samples_total"):
        got, want = card.metric_state[leaf].cpu(), cpu.metric_state[leaf]
        check(got.dtype == want.dtype and torch.equal(got, want), f"[{leg}] {leaf} differs from the CPU run's")
    rec = {"card_s": card_s, "kept": int(card._reservoir.count(card.metric_state["corpus_sample"])),
           "seen": int(card.metric_state["samples_total"]), "bound": card._gather_approx_provenance()["bound"],
           "value": _value_summary(value) if not isinstance(value, dict) else {k: float(v) for k, v in value.items()}}
    if exact_make is not None:
        exact = exact_make("cuda")
        for preds, target in updates:
            exact.update(preds, target)
        rec["exact"] = (float(exact.compute()) if not isinstance(value, dict)
                        else {k: float(v) for k, v in exact.compute().items()})
        rec["tensors"], rec["exact_tensors"] = value, exact.compute()
    return rec


def _sketch_reservoirs() -> dict:
    """Phase 17 (iv): BLEU and SacreBLEU reservoirs over WMT16 newstest2016's 2,999 seeded pairs (past the
    default sample of 1,024) and the ROUGE reservoir over phase 6's 1,000 pairs (all kept: equal to exact)."""
    from torchmetrics_tpu_torch import text as tt

    gen = np.random.default_rng(SEED + 74)
    words = _seeded_words(5_000, gen)
    preds = _zipf_sentences(WMT16_PAIRS, words, (10, WMT16_MAX_TOKENS), gen)
    target = [[s] for s in _zipf_sentences(WMT16_PAIRS, words, (10, WMT16_MAX_TOKENS), gen)]
    updates = [(preds[i:i + TEXT_UPDATE], target[i:i + TEXT_UPDATE]) for i in range(0, WMT16_PAIRS, TEXT_UPDATE)]
    record = {}
    for name, cls in (("bleu", tt.BLEUScore), ("sacrebleu", tt.SacreBLEUScore)):
        rec = _reservoir_leg(f"sketches {name}", lambda d: cls(approx="reservoir", device=d), updates,
                             lambda d: cls(device=d))
        check(rec["seen"] == WMT16_PAIRS and rec["kept"] == 1024 and 0 < rec["bound"] < 1,
              f"[sketches {name}] kept {rec['kept']} of {rec['seen']}, bound {rec['bound']}")
        del rec["tensors"], rec["exact_tensors"]
        record[name] = rec
    r_preds, r_target = _sentence_pairs(ROUGE_PAIRS)
    r_updates = [(r_preds[i:i + ROUGE_BATCH], r_target[i:i + ROUGE_BATCH]) for i in range(0, ROUGE_PAIRS, ROUGE_BATCH)]
    rec = _reservoir_leg("sketches rouge", lambda d: tt.ROUGEScore(approx="reservoir", device=d), r_updates,
                         lambda d: tt.ROUGEScore(device=d))
    check(rec["kept"] == ROUGE_PAIRS and rec["bound"] == 0.0, f"[sketches rouge] kept {rec['kept']}")
    for k, want in rec.pop("exact_tensors").items():
        got = rec["tensors"][k]
        check(abs(float(got) - float(want)) <= SKETCH_TOL, f"[sketches rouge] {k} {float(got)} vs exact {float(want)}")
    del rec["tensors"]
    record["rouge"] = rec
    return record


def _sketch_map() -> dict:
    """Phase 17 (v): the ``MAP_IMAGES`` COCO-val2017-shaped images through MeanAveragePrecision(approx="sketch")
    on the card (each update's items matched by one ``coco_match`` launch a chunk) and on the CPU (histograms and
    counters equal), the sketch map beside the exact map and the bound."""
    from torchmetrics_tpu_torch.detection import MeanAveragePrecision
    from torchmetrics_tpu_torch.kernels.coco_match import coco_match

    leg = "sketches map"
    batches = [_coco_images(i, min(i + MAP_BATCH, MAP_IMAGES)) for i in range(0, MAP_IMAGES, MAP_BATCH)]
    card, cpu, exact = (MeanAveragePrecision(approx="sketch", device="cuda"),
                        MeanAveragePrecision(approx="sketch", device="cpu"), MeanAveragePrecision(device="cuda"))
    on_card = [(_on("cuda", preds), _on("cuda", target)) for preds, target in batches]
    coco_match.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for preds, target in on_card:
        card.update(preds, target)
    value = card.compute()
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    launches = {"coco_match": coco_match.launches}
    check(launches["coco_match"] >= len(batches), f"[{leg}] coco_match launches {launches}")
    t0 = time.perf_counter()
    for preds, target in batches:
        cpu.update(_on("cpu", preds), _on("cpu", target))
    cpu_s = time.perf_counter() - t0
    _equal_states(f"[{leg}] state", card.metric_state, cpu.metric_state)
    for preds, target in on_card:
        exact.update(preds, target)
    exact_value = exact.compute()
    sketch_map, exact_map = float(value["map"]), float(exact_value["map"])
    bound = card._gather_approx_provenance()["bound"]
    # JAX's docstring: the sketch never exceeds the exact value and stays within the bound; no JAX test holds it,
    # so a miss is recorded as a finding about the reference and does not fail the phase
    holds = sketch_map <= exact_map + SKETCH_TOL and exact_map - sketch_map <= bound + SKETCH_TOL
    return {"images": MAP_IMAGES, "batches": len(batches), "launches": launches, "card_s": card_s, "cpu_s": cpu_s,
            "map": sketch_map, "exact_map": exact_map, "bound": bound, "documented_bound_holds": holds,
            "mar_100": float(value["mar_100"]), "exact_mar_100": float(exact_value["mar_100"])}


def phase_sketches() -> dict:
    """Phase 17 on one card, no sync: every approx mode through the metric classes a user calls, at the shapes of
    the earlier phases (``_sketch_curves``, ``_sketch_distinct``, ``_sketch_reservoirs``, ``_sketch_map``)."""
    from torchmetrics_tpu_torch.kernels.hll import hll_insert
    from torchmetrics_tpu_torch.kernels.quantile_hist import quantile_hist

    kernels = (quantile_hist, hll_insert)
    record = _sketch_curves(kernels)
    record["distinct"] = _sketch_distinct(kernels)
    record["reservoirs"] = _sketch_reservoirs()
    record["map"] = _sketch_map()
    for name in ("imagenet", "calibration", "coco", "binary", "distinct"):
        leg = record[name]
        print(f"[sketches] {name}: {leg['batches']} batches, the first {CPU_RERUN_BATCHES if name != 'distinct' else 1} "
              f"again on the CPU path (states equal); update median {leg['update_ms_median']:.4f} ms (host clock, a "
              f"synchronize after each), compute {leg['compute_ms']:.4f} ms, leg {leg['leg_s']:.2f} s; launches "
              f"{leg['launches']}; values {leg['values']}; against the binned path at the edges "
              f"{leg.get('vs_binned')}; {('AUROC ' + str(leg['auroc'])) if 'auroc' in leg else ''}"
              f"{('ratios ' + str(leg['ratios'])) if 'ratios' in leg else ''}")
    for name, leg in record["reservoirs"].items():
        print(f"[sketches] {name} reservoir: kept {leg['kept']} of {leg['seen']} (rows equal to the CPU run's), "
              f"estimate {leg['value']} beside exact {leg.get('exact')}, stamped bound {leg['bound']:.6f}, "
              f"{leg['card_s']:.2f} s on the card")
    m = record["map"]
    print(f"[sketches] map: {m['images']} images in {m['batches']} updates, {m['card_s']:.2f} s on the card "
          f"({m['launches']['coco_match']} coco_match launches), {m['cpu_s']:.2f} s on the CPU (histograms and "
          f"counters equal to the CPU run's), sketch map "
          f"{m['map']:.6f} beside exact {m['exact_map']:.6f}, stamped bound {m['bound']:.6f}: the documented "
          f"one-sided bound {'holds' if m['documented_bound_holds'] else 'does NOT hold (a finding about the JAX '
          'reference, ROADMAP Queue 3)'}; mar_100 {m['mar_100']:.6f} beside {m['exact_mar_100']:.6f}")
    return record


def _sketch_sync_collection(device):
    """Phase 5's sketch leg (phase 17 (vi)): a sketch-mode AUROC, a DistinctNGrams HyperLogLog and a BLEU
    reservoir, synced by one coalesced plan."""
    from torchmetrics_tpu_torch import classification as tc, text as tt
    from torchmetrics_tpu_torch.collections import MetricCollection

    return MetricCollection({
        "auroc": tc.MulticlassAUROC(num_classes=N_CLASSES, approx="sketch", validate_args=False, device=device),
        "distinct": tt.DistinctNGrams(2, ignore_index=-100, approx="sketch", device=device),
        "bleu": tt.BLEUScore(approx="reservoir", sample_size=BLEU_SYNC_SAMPLE, device=device),
    }, compute_groups=False)


def _sketch_sync(rank: int, world: int, device: torch.device, cls_batches: list) -> dict:
    """Phase 17 (vi) on one rank of a phase-5 world: this rank's blocks of the ImageNet-1k batches, the WikiText-103
    token batches and phase 6's 1,000 pairs through the three sketch metrics, one coalesced sync, then the
    single-process states over every block, which every synced leaf must equal bit for bit."""
    import torch.distributed as dist

    from torchmetrics_tpu_torch.core.reductions import COLLECTIVES
    from torchmetrics_tpu_torch.kernels.hll import hll_insert
    from torchmetrics_tpu_torch.kernels.quantile_hist import quantile_hist
    from torchmetrics_tpu_torch.parallel.coalesce import plan_for_metrics

    preds, target = _sentence_pairs(ROUGE_PAIRS)
    check(len(set(preds)) == len(preds), "phase 6's pairs repeat a prediction: the reservoir keys would tie")
    streams = {
        "auroc": cls_batches,
        "distinct": [(t.to(device),) for t in _wikitext_token_batches()],
        "bleu": [(preds[i:i + ROUGE_BATCH], [[t] for t in target[i:i + ROUGE_BATCH]])
                 for i in range(0, ROUGE_PAIRS, ROUGE_BATCH)],
    }
    col = _sketch_sync_collection(device)
    metrics = dict(col.items(keep_base=True))
    for kernel in (quantile_hist, hll_insert):
        kernel.launches = 0
    states = {}
    for name, metric in metrics.items():
        st = metric.init_state()
        for i in _rank_blocks(len(streams[name]), world, uneven=False)[rank]:
            st = metric.update_state(st, *streams[name][i])
        states[name] = st
    torch.cuda.synchronize()
    launches = {"quantile_hist": quantile_hist.launches, "hll_insert": hll_insert.launches}
    plan = plan_for_metrics(list(metrics.values()), [states[n] for n in metrics])
    dist.barrier()
    before = dict(COLLECTIVES)
    t0 = time.perf_counter()
    synced = col.sync_states(states)
    torch.cuda.synchronize()
    sync_ms = (time.perf_counter() - t0) * 1e3
    collectives = {k: v - before.get(k, 0) for k, v in COLLECTIVES.items() if v - before.get(k, 0)}
    unequal = []
    for name, metric in metrics.items():
        ref = metric.init_state()
        for args in streams[name]:
            ref = metric.update_state(ref, *args)
        for leaf, want in ref.items():
            got = synced[name][leaf]
            if not (got.dtype == want.dtype and torch.equal(got, want)):
                unequal.append(f"{name}.{leaf}")
    return {"sketch_launches": launches, "sketch_sync_ms": sync_ms, "sketch_collectives": collectives,
            "sketch_buckets": [(b.dtype, b.op, [s.name for s in b.slots]) for b in plan.buckets],
            "sketch_passthrough": [name for _, name, _ in plan.passthrough], "sketch_unequal": unequal,
            "sketch_values": {k: float(v) for k, v in col.compute_states(synced).items()}}



# ------------------------------------------------ phase 3 and 18: the int8 codec, sync engineering
FID_FEATURES = 2_048
FID_BUCKET = 2 * (FID_FEATURES * FID_FEATURES + FID_FEATURES)  # FID's float32 sum bucket: 8,392,704 values
EVAL_BUCKET = 88_003  # the size of the eval collection's (Accuracy, F1, AUROC at 1,000 classes) count bucket
CODEC_CHUNK = 256
CODEC_OPS_PER_VALUE = 8  # |x|, max, the divide, rint, two clamps, the convert, the store's address: fp32 work a value


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """``torch.equal``, a NaN equal to a NaN in the same place."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if not a.is_floating_point():
        return torch.equal(a, b)
    return torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0))


def _codec_values(gen: torch.Generator, size: int, chunk: int, edits) -> torch.Tensor:
    """``size`` float32 values on the card: a covariance-like spread of magnitudes (a chunk's scale between
    1e-3 and 1e3), counts for ``"counts"``, and the edge chunks of ``edits`` at the front."""
    dev = torch.device("cuda")
    if "counts" in edits:
        return torch.randint(0, 50_000, (size,), generator=gen, device=dev).to(torch.float32)
    x = torch.randn((size,), generator=gen, device=dev)
    n_chunks = -(-size // chunk)
    scale = 10.0 ** torch.randint(-3, 4, (n_chunks,), generator=gen, device=dev).to(torch.float32)
    x = (x * scale.repeat_interleave(chunk)[:size]).contiguous()
    pos = 0
    for edit in edits:
        seg = x[pos : pos + chunk]
        if seg.numel() == 0:
            break
        if edit == "zeros":
            seg.zero_()
        elif edit == "halfway":  # scale 0.5 exactly: (k + 0.5) * 0.5 lies half-way between two codes
            k = torch.randint(-126, 126, seg.shape, generator=gen, device=dev).to(torch.float32)
            seg.copy_((k + 0.5) * 0.5)
            seg[0] = 63.5
        elif edit == "edges":  # +-127 codes and the values just inside them
            seg.uniform_(-1.0, 1.0, generator=gen).mul_(3.0)
            seg[: min(4, seg.numel())] = torch.tensor([3.0, -3.0, 2.9999998, -2.9999998], device=dev)[: seg.numel()]
        elif edit == "subnormal":
            seg.copy_(torch.randint(-50, 50, seg.shape, generator=gen, device=dev).to(torch.float32) * 1e-44)
        elif edit == "nan":
            seg[seg.numel() // 2] = float("nan")
            seg[0], seg[-1] = float("inf"), -float("inf")
        elif edit == "inf":
            seg[1 % seg.numel()] = float("inf")
        elif edit == "neg_zero":
            seg.fill_(-0.0)
        pos += chunk
    return x


def _codec_chain(blocks: torch.Tensor, chunk: int) -> torch.Tensor:
    """The codec as a short chain of PyTorch calls (abs, amax, divide, round, clamp, convert, cat): a
    yardstick, not the function (no NaN rule, the scale by a division)."""
    xc = blocks.reshape(blocks.shape[0], -1, chunk)
    scale = xc.abs().amax(-1, keepdim=True) / 127.0
    q = (xc / scale).round().clamp(-127, 127).to(torch.int8)
    return torch.cat([q.reshape(blocks.shape[0], -1).view(torch.uint8),
                      scale.reshape(blocks.shape[0], -1).view(torch.uint8)], 1)


def phase_int8_codec_kernel(flush: torch.Tensor) -> dict:
    """``int8_quantize`` and ``int8_dequant_sum`` against their plain versions on the card, ``torch.equal`` (a
    NaN equal to a NaN in its place): each case packs ``n`` destination blocks (the in-graph and the host scale),
    sums the ``n`` packed rows as the int8 all-reduce's phase 2 does (packed again, and not), in JAX's jitted
    order and in the host's, and unpacks them side by side (k = n). Timed at FID's 2,048-feature bucket in a
    world of 4 (the record's rows: phase 1's pack, phase 2's sum packed again, the final unpack) and of 1, beside
    a chain of PyTorch calls (a yardstick; library: none)."""
    from torchmetrics_tpu_torch.kernels import int8_codec as kic

    gen = torch.Generator(device="cuda").manual_seed(SEED + 180)
    edge = ("zeros", "halfway", "edges", "subnormal", "nan", "inf", "neg_zero")
    cases = [  # (what, size, n, chunk, edits, timed)
        ("(a) FID's 2,048-feature bucket, n=4", FID_BUCKET, 4, CODEC_CHUNK, (), True),
        ("FID's 2,048-feature bucket, n=1", FID_BUCKET, 1, CODEC_CHUNK, (), True),
        ("the eval collection's bucket, n=4", EVAL_BUCKET, 4, CODEC_CHUNK, ("counts",), False),
        *((f"chunk {c}, n=4, the edge chunks", 40_000 + 3, 4, c, edge, False) for c in (8, 256, 1024)),
        *((f"chunk {c}, n=1, the edge chunks", 9 * c, 1, c, edge, False) for c in (8, 9, 256, 1024)),
        *((f"length {what}, chunk {c}, n=4", size, 4, c, ("edges",), False)
          for c in (8, 256, 1024) for what, size in (("1", 1), ("chunk-1", c - 1), ("n*chunk+1", 4 * c + 1))),
    ]
    rows = {"int8_quantize": [], "int8_dequant_sum": []}
    for what, size, n, chunk, edits, timed in cases:
        flat = _codec_values(gen, size, chunk, edits)
        n_chunks = -(-size // (n * chunk))
        blocks = torch.nn.functional.pad(flat, (0, n * n_chunks * chunk - size)).reshape(n, n_chunks * chunk)
        label = f"{what}: {size} values, {n_chunks} chunks of {chunk} a block"
        before = (kic.int8_quantize.launches, kic.int8_dequant_sum.launches)
        checks = {}
        for host in (False, True):
            got, want = kic.int8_quantize(blocks, chunk, host), kic._int8_quantize_plain(blocks, chunk, host)
            checks[f"pack{' host' if host else ''}"] = torch.equal(got, want)
        packed = kic.int8_quantize(blocks, chunk)
        again = kic.int8_quantize(blocks, chunk)
        checks["pack twice"] = torch.equal(packed, again)
        for mode, req, host in (("sum", True, False), ("sum", False, False), ("sum", False, True),
                                ("concat", False, False)):
            got = kic.int8_dequant_sum(packed, chunk, mode, req, host)
            want = kic._int8_dequant_sum_plain(packed, chunk, mode, req, host)
            checks[f"{mode}{' packed' if req else ''}{' host' if host else ''}"] = _same(got, want)
        torch.cuda.synchronize()
        check(all(checks.values()), f"int8 codec and plain differ ({label}): {checks}")
        check((kic.int8_quantize.launches - before[0], kic.int8_dequant_sum.launches - before[1]) == (4, 4),
              f"int8 codec launches ({label})")
        q_row = {"case": label, "what": what, "max_abs_err": 0.0}
        d_row = {"case": f"{label}, phase 2 (the sum of {n} packed rows, packed again)", "what": what, "max_abs_err": 0.0}
        if timed:
            width = kic.packed_width(n_chunks, chunk)
            in_bytes, out_bytes = 4 * blocks.numel(), packed.numel()
            sets = [(blocks,)] + [(blocks.clone(),) for _ in range(min(copies_for(in_bytes), 8) - 1)]
            q_ms = time_ms(lambda: kic.int8_quantize(blocks, chunk), flush)
            q_stream = time_stream_ms(lambda b_: kic.int8_quantize(b_, chunk), sets, calls=len(sets) * 3)
            q_plain = time_ms(lambda: kic._int8_quantize_plain(blocks, chunk), flush, reps=10, warmup=1)
            q_chain = time_ms(lambda: _codec_chain(blocks, chunk), flush, reps=10, warmup=1)
            del sets
            q_bytes_ms = (in_bytes + out_bytes) / PEAK_BYTES_PER_S * 1e3
            q_ops_ms = blocks.numel() * CODEC_OPS_PER_VALUE / FP32_INSTR_PER_S * 1e3
            q_row.update({"ms": q_ms, "stream_ms": q_stream, "plain_ms": q_plain, "torch_chain_yardstick_ms": q_chain,
                          "bound_ms": max(q_bytes_ms, q_ops_ms), "bound_by": "bytes" if q_bytes_ms >= q_ops_ms
                          else "operations", "bytes": in_bytes + out_bytes, "library_ms": None})
            d_sets = [(packed,)] + [(packed.clone(),) for _ in range(min(copies_for(packed.numel()), 8) - 1)]
            d_ms = time_ms(lambda: kic.int8_dequant_sum(packed, chunk, "sum", True), flush)
            d_stream = time_stream_ms(lambda p_: kic.int8_dequant_sum(p_, chunk, "sum", True), d_sets,
                                      calls=len(d_sets) * 3)
            d_plain = time_ms(lambda: kic._int8_dequant_sum_plain(packed, chunk, "sum", True), flush, reps=10, warmup=1)
            c_ms = time_ms(lambda: kic.int8_dequant_sum(packed, chunk, "concat"), flush)
            c_plain = time_ms(lambda: kic._int8_dequant_sum_plain(packed, chunk, "concat"), flush, reps=10, warmup=1)
            del d_sets
            d_bytes_ms = (packed.numel() + width) / PEAK_BYTES_PER_S * 1e3
            c_bytes_ms = (packed.numel() + 4 * blocks.numel()) / PEAK_BYTES_PER_S * 1e3
            # a convert and an FMA for each of the n x N/n summed values, then the pack of the N/n sums
            d_ops_ms = (2 * blocks.numel() + CODEC_OPS_PER_VALUE * blocks.numel() // n) / FP32_INSTR_PER_S * 1e3
            d_row.update({"ms": d_ms, "stream_ms": d_stream, "plain_ms": d_plain,
                          "bound_ms": max(d_bytes_ms, d_ops_ms),
                          "bound_by": "bytes" if d_bytes_ms >= d_ops_ms else "operations",
                          "bytes": packed.numel() + width, "library_ms": None,
                          "concat_ms": c_ms, "concat_plain_ms": c_plain, "concat_bound_ms": c_bytes_ms})
            print(f"[kernel] int8_quantize {label}: equal, {q_ms:.4f} ms after an L2 flush ({q_stream:.4f} ms a call "
                  f"back to back), plain {q_plain:.4f} ms, a PyTorch chain (a yardstick) {q_chain:.4f} ms, bound "
                  f"{q_row['bound_ms'] * 1e3:.3f} us (by {q_row['bound_by']}: {in_bytes} + {out_bytes} bytes), share "
                  f"{q_row['bound_ms'] / q_ms:.1%}; library_ms: none")
            print(f"[kernel] int8_dequant_sum {label}: phase 2 (sum of {n} packed rows, packed again) {d_ms:.4f} ms "
                  f"({d_stream:.4f} back to back), plain {d_plain:.4f} ms, bound {d_row['bound_ms'] * 1e3:.3f} us "
                  f"(by {d_row['bound_by']}: {packed.numel()} + {width} bytes), share {d_row['bound_ms'] / d_ms:.1%}; "
                  f"the final unpack {c_ms:.4f} ms, plain {c_plain:.4f} ms, bound {c_bytes_ms * 1e3:.3f} us "
                  f"({packed.numel()} + {4 * blocks.numel()} bytes), share {c_bytes_ms / c_ms:.1%}; library_ms: none")
        rows["int8_quantize"].append(q_row)
        rows["int8_dequant_sum"].append(d_row)
        del flat, blocks, packed, again
    print(f"[kernel] int8 codec: equal to plain on all {len(cases)} cases: " + "; ".join(r["what"] for r in
                                                                                          rows["int8_quantize"]))
    return rows


FID_SYNC_ROWS = 10_000  # real rows, and as many fake ones, fed unevenly over the ranks
FID_SYNC_BATCH = 500
CADENCE_K = 4
WEIGHT_LEAF = 4_096
SYNC_MODES = ("exact", "bf16", "int8", "sharded", "sharded int8")


def _fid_feature_set(real: bool, device) -> torch.Tensor:
    """The whole seeded feature set on the card: integer-valued 2,048-wide rows, so every float32 moment sum
    is exact in any order (the sync is measured, not InceptionV3)."""
    gen = torch.Generator(device=device).manual_seed(SEED + 181 + (0 if real else 1))
    rows = torch.randint(-4, 5, (FID_SYNC_ROWS, FID_FEATURES), generator=gen, device=device)
    return (rows + (0 if real else 1)).to(torch.float32)


class _FeatureRows:
    """A feature extractor that returns its input: the rows are already 2,048-wide features."""

    num_features = FID_FEATURES

    def __call__(self, x):
        return x


def _fid_metric(device, mode: str):
    from torchmetrics_tpu_torch.image import FrechetInceptionDistance

    fid = FrechetInceptionDistance(feature=_FeatureRows(), device=device)
    if mode.startswith("sharded"):
        fid.set_state_sharding("real_features_cov_sum", "sharded")
        fid.set_state_sharding("fake_features_cov_sum", "sharded")
    return fid


def _fid_state(fid, real_rows: torch.Tensor, fake_rows: torch.Tensor):
    st = fid.init_state()
    for rows, real in ((real_rows, True), (fake_rows, False)):
        for i in range(0, rows.shape[0], FID_SYNC_BATCH):
            st = fid.update_state(st, rows[i : i + FID_SYNC_BATCH], real)
    return st


def _chunk_error_ok(got: torch.Tensor, want: torch.Tensor, chunk: int, rel: float) -> bool:
    """Every value of ``got`` within ``rel`` of the largest magnitude of its chunk of ``want`` (chunks of the
    layout the codec ran on, from the front)."""
    pad = -want.numel() % chunk
    amax = torch.nn.functional.pad(want.abs().reshape(-1), (0, pad)).reshape(-1, chunk).amax(1)
    bound = (rel * amax).repeat_interleave(chunk)[: want.numel()]
    return bool(((got.reshape(-1) - want.reshape(-1)).abs() <= bound).all())


def _equal_steps(batches: list, steps: int) -> list:
    """``batches`` as ``steps`` updates, the largest batch halved until there are as many: every rank of a
    deferred sync must take the same number of steps."""
    out = list(batches)
    while len(out) < steps:
        i = max(range(len(out)), key=lambda j: out[j][0].shape[0])
        p, t = out.pop(i)
        half = p.shape[0] // 2
        out[i:i] = [(p[:half], t[:half]), (p[half:], t[half:])]
    return out


def _sync_leg_fid(rank: int, world: int, device: torch.device) -> dict:
    """(i): FID's 2,048-feature state synced exact, bf16, int8, sharded and sharded int8."""
    import torch.distributed as dist

    from torchmetrics_tpu_torch.core.reductions import COLLECTIVES
    from torchmetrics_tpu_torch.parallel.coalesce import bucket_scatter_size, plan_for_metric
    from torchmetrics_tpu_torch.parallel.compress import CompressionConfig, bucket_wire_bytes, predicted_error_bound

    real_all, fake_all = _fid_feature_set(True, device), _fid_feature_set(False, device)
    mine = _rank_blocks(FID_SYNC_ROWS, world, uneven=True)[rank]
    ref_fid = _fid_metric(device, "exact")
    ref_state = _fid_state(ref_fid, real_all, fake_all)  # the single-process state
    out = {"rows": len(mine), "modes": {}}
    values = {}
    for mode in SYNC_MODES:
        fid = _fid_metric(device, mode)
        comp = CompressionConfig("int8") if "int8" in mode else CompressionConfig("bf16") if mode == "bf16" else None
        st = _fid_state(fid, real_all[mine.start : mine.stop], fake_all[mine.start : mine.stop])
        plan = plan_for_metric(fid, st, compression=comp)
        wire = sum(bucket_wire_bytes(bucket_scatter_size(b, world), 4, world, b.compression, sharded=b.sharded)
                   for b in plan.buckets)
        dist.barrier()
        torch.cuda.synchronize()
        before = dict(COLLECTIVES)
        t0 = time.perf_counter()
        synced = fid.sync_states(st, compression=comp)
        torch.cuda.synchronize()
        sync_ms = (time.perf_counter() - t0) * 1e3
        issued = {k: v - before.get(k, 0) for k, v in COLLECTIVES.items() if v - before.get(k, 0)}
        data = sum(v for k, v in issued.items() if k in ("all_reduce", "all_gather", "all_to_all", "reduce_scatter"))
        full = fid._unpad_sharded(synced)  # a collective where leaves are sharded: the blocks gathered
        record = {"sync_ms": sync_ms, "wire_bytes_model": wire, "collectives": issued, "plan_collectives":
                  plan.n_collectives, "collectives_match": data == plan.n_collectives,
                  "buckets": [(b.dtype, b.op, b.sharded, None if b.compression is None else b.compression.mode)
                              for b in plan.buckets]}
        if mode in ("exact", "sharded"):
            # every moment sum (the update counts differ: a rank's rows take their own batches)
            record["equal_single_process"] = all(torch.equal(full[k], ref_state[k]) for k in ref_state if k != "_n")
            if mode == "sharded":
                record["block_rows"] = int(synced["real_features_cov_sum"].shape[0])
        else:  # each compressed bucket within its declared bound, per chunk of the layout it was packed in
            exact = ref_state
            ok = {}
            for b in plan.buckets:
                if b.compression is None:
                    ok[b.dtype + "/" + b.op] = all(torch.equal(full[s.name], exact[s.name]) for s in b.slots
                                                   if s.name != "_n")
                    continue
                spec = b.compression
                # int8: the declared two-stage bound, one stage where sharded (psum_scatter_int8 packs once);
                # bf16: 2**-8 a rounding to bfloat16, one a hop of the ring
                rel = (world * 2.0 ** -8 if spec.mode == "bf16" else predicted_error_bound(spec.mode, stages=1)
                       if b.sharded else spec.error_bound)
                if b.sharded:  # this rank's block of each slot, chunked along its row
                    ok["sharded"] = all(_chunk_error_ok(synced[s.name], exact[s.name].reshape(
                        world, -1, FID_FEATURES)[rank], spec.chunk, rel) for s in b.slots)
                else:
                    got_flat = torch.cat([full[s.name].reshape(-1) for s in b.slots])
                    want_flat = torch.cat([exact[s.name].reshape(-1) for s in b.slots])
                    ok[b.dtype + "/" + b.op] = _chunk_error_ok(got_flat, want_flat, spec.chunk, rel)
            record["within_bound"] = ok
        if rank == 0 and mode in ("exact", "sharded"):
            values[mode] = float(fid.compute_state(full))
        out["modes"][mode] = record
    if rank == 0:
        values["single process"] = float(ref_fid.compute_state(ref_state))
    out["fid"] = values
    return out


def _sync_leg_weight(rank: int, world: int, device: torch.device) -> dict:
    """(ii): the last rank quarantined (weight 0): every leaf equals the other ranks' own combination."""
    from torchmetrics_tpu_torch.parallel import coalesced_sync_state

    def state_of(r):
        gen = torch.Generator(device=device).manual_seed(SEED + 190 + r)
        ints = lambda lo, hi, dtype=torch.float32: torch.randint(lo, hi, (WEIGHT_LEAF,), generator=gen,  # noqa: E731
                                                                 device=device).to(dtype)
        return {"s": ints(-1000, 1000), "m": ints(-1000, 1000), "lo": ints(-10**6, 10**6),
                "hi": ints(-10**6, 10**6, torch.int32), "_n": torch.tensor(r + 1, dtype=torch.int32, device=device)}

    table = {"s": "sum", "m": "mean", "lo": "min", "hi": "max"}
    masked = world - 1
    synced = coalesced_sync_state(state_of(rank), table, weight=0.0 if rank == masked else 1.0)
    others = [state_of(r) for r in range(world) if r != masked]
    want = {"s": torch.zeros(WEIGHT_LEAF, device=device), "m": torch.zeros(WEIGHT_LEAF, device=device),
            "lo": torch.full((WEIGHT_LEAF,), float("inf"), device=device),
            "hi": torch.full((WEIGHT_LEAF,), torch.iinfo(torch.int32).min, dtype=torch.int32, device=device),
            "_n": torch.tensor(0, dtype=torch.int32, device=device)}
    for st in others:
        want = {"s": want["s"] + st["s"], "m": want["m"] + st["m"], "lo": torch.minimum(want["lo"], st["lo"]),
                "hi": torch.maximum(want["hi"], st["hi"]), "_n": want["_n"] + st["_n"]}
    # a tensor divisor: a CUDA division by a Python number multiplies by its reciprocal, the sync divides
    want["m"] = want["m"] / torch.full_like(want["m"], float(max(len(others), 1)))
    return {"masked_rank": masked, "equal": {k: bool(torch.equal(synced[k], want[k])) for k in want}}


def _sync_leg_cadence(rank: int, world: int, device: torch.device) -> dict:
    """(iii): phase 5's eval collection through ``sharded_collection_update`` with ``SyncPolicy(every_n_steps=4)``
    and with ``at_compute=True``, against the every-step sync; a snapshot mid-window restored into a new
    stepper."""
    from torchmetrics_tpu_torch.parallel import SyncPolicy, SyncStepper, flush_sync, sharded_collection_update

    data = _main_path_data(torch.Generator(device=device).manual_seed(SEED))
    batches = [b["cls"] for b in _batches(data)]
    blocks = _rank_blocks(len(batches), world, uneven=False)
    steps = _equal_steps([batches[i] for i in blocks[rank]], max(len(b) for b in blocks))
    cadenced, per_step = _sync_collection3(device), _sync_collection3(device)
    ref, returned, equal_at_sync = None, [], []
    t0 = time.perf_counter()
    for p, t in steps:
        got = sharded_collection_update(cadenced, p, t, sync_policy=SyncPolicy(every_n_steps=CADENCE_K))
        synced = sharded_collection_update(per_step, p, t)
        ref = synced if ref is None else per_step.merge_states(ref, synced)
        returned.append(got is not None)
        if got is not None:
            equal_at_sync.append(all(torch.equal(got[k][leaf], ref[k][leaf]) for k in ref for leaf in ref[k]))
    final = flush_sync(cadenced)
    torch.cuda.synchronize()
    leg_s = time.perf_counter() - t0
    values = {k: float(v) for k, v in per_step.compute_states(final).items()}
    stepper = SyncStepper(_sync_collection3(device), policy=SyncPolicy(at_compute=True))
    deferred = [stepper.update(p, t) is None for p, t in steps]
    at_compute = {k: float(v) for k, v in stepper.compute().items()}
    policy = SyncPolicy(every_n_steps=CADENCE_K)
    stepper = SyncStepper(_sync_collection3(device), policy=policy)
    cut = CADENCE_K + CADENCE_K // 2
    for p, t in steps[:cut]:
        stepper.update(p, t)
    snap, pending = stepper.snapshot(), stepper.pending
    for p, t in steps[cut:]:
        stepper.update(p, t)
    uninterrupted = {k: float(v) for k, v in stepper.compute().items()}
    restored = SyncStepper(_sync_collection3(device), policy=policy)
    restored.restore(snap)
    for p, t in steps[cut:]:
        restored.update(p, t)
    resumed = {k: float(v) for k, v in restored.compute().items()}
    return {"steps": len(steps), "returned": returned, "equal_at_sync": equal_at_sync,
            "final_equal": all(torch.equal(final[k][leaf], ref[k][leaf]) for k in ref for leaf in ref[k]),
            "values": values, "at_compute_deferred": all(deferred), "at_compute": at_compute,
            "snapshot_pending": pending, "resumed": resumed, "uninterrupted": uninterrupted, "leg_s": leg_s}


def _sync_collection3(device):
    """Phase 5's eval collection less AP (its cat states take the ragged path): Accuracy, F1 and AUROC."""
    col = _sync_collection(device)
    return type(col)({k: col[k] for k in ("acc", "f1", "auroc")})


def _sync_leg_deferred(rank: int, world: int, device: torch.device) -> dict:
    """(iv): mAP and ROUGE registered on one ``DeferredRaggedSync`` over phase 6's data, one gather a dtype;
    every rank computes ROUGE, rank 0 mAP too (its compute is host-bound: phase 6 computes it on every rank)."""
    import torch.distributed as dist

    from torchmetrics_tpu_torch.core.reductions import COLLECTIVES
    from torchmetrics_tpu_torch.detection import MeanAveragePrecision
    from torchmetrics_tpu_torch.parallel import DeferredRaggedSync
    from torchmetrics_tpu_torch.text import ROUGEScore

    preds, target = _sentence_pairs(ROUGE_PAIRS)
    rouge = ROUGEScore(rouge_keys=("rouge1", "rougeL"), device=device)
    metric = MeanAveragePrecision(device=device)
    metric._value_ranges.update({"detection_labels": (0, MAP_CLASSES - 1), "groundtruth_labels": (0, MAP_CLASSES - 1),
                                 "groundtruth_crowds": (0, 1)})
    shared = DeferredRaggedSync()
    shared.register(metric, "map")
    shared.register(rouge, "rouge")
    for j in _rank_blocks(ROUGE_PAIRS // ROUGE_BATCH, world, uneven=True)[rank]:
        sl = slice(j * ROUGE_BATCH, (j + 1) * ROUGE_BATCH)
        shared.update_for("rouge", preds[sl], target[sl])
    for j in _rank_blocks(-(-MAP_IMAGES // MAP_BATCH), world, uneven=True)[rank]:
        p, t = _coco_images(j * MAP_BATCH, min((j + 1) * MAP_BATCH, MAP_IMAGES))
        shared.update_for("map", _on(device, p), _on(device, t))
    dist.barrier()
    before = dict(COLLECTIVES)
    t0 = time.perf_counter()
    synced = shared.sync()
    sync_ms = (time.perf_counter() - t0) * 1e3
    issued = {k: v - before.get(k, 0) for k, v in COLLECTIVES.items() if v - before.get(k, 0)}
    wires = set()
    for key, m in shared._members.items():
        from torchmetrics_tpu_torch.parallel.compress import packed_int_dtype

        for leaf, items in synced[key].items():
            if isinstance(items, tuple) and items:
                rng = m._value_ranges.get(leaf)
                wires.add(str(packed_int_dtype(items[0].dtype, rng) if rng else items[0].dtype))
    t0 = time.perf_counter()
    keys = list(synced) if rank == 0 else ["rouge"]  # mAP's host-bound compute once a world: phase 6 holds the rest
    values = {key: {k: float(v) for k, v in shared._members[key].compute_state(synced[key]).items()
                    if v.numel() == 1 and k != "classes"} for key in keys}
    torch.cuda.synchronize()
    return {"sync_ms": sync_ms, "collectives": issued, "wire_dtypes": sorted(wires), "values": values,
            "compute_s": time.perf_counter() - t0, "images": len(synced["map"]["detection_scores"])}


def worker_engineering(rank: int, world: int, device: torch.device) -> dict:
    """Phase 18 on one rank: (i) FID's sync in five forms, (ii) the weight mask, (iii) the deferred eval
    collection, (iv) the shared deferred ragged sync; the int8 codec's launches counted on the way."""
    from torchmetrics_tpu_torch.kernels.int8_codec import int8_dequant_sum, int8_quantize

    int8_quantize.launches = int8_dequant_sum.launches = 0
    seconds = {}
    t0 = time.perf_counter()
    fid = _sync_leg_fid(rank, world, device)
    launches = {"int8_quantize": int8_quantize.launches, "int8_dequant_sum": int8_dequant_sum.launches}
    seconds["fid"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    weight = _sync_leg_weight(rank, world, device)
    cadence = _sync_leg_cadence(rank, world, device)
    seconds["weight and cadence"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    deferred = _sync_leg_deferred(rank, world, device)
    seconds["deferred"] = time.perf_counter() - t0
    return {"rank": rank, "launches": launches, "fid": fid, "weight": weight, "cadence": cadence,
            "deferred": deferred, "seconds": seconds}


def phase_engineering(sync: dict, ragged: dict) -> dict:
    """Phase 18 in both worlds; the cadence leg's values against phase 5's, the deferred leg's against phase 6's."""
    record = {}
    for backend, world in _worlds():
        results = run_world("engineering", backend, world)
        label = f"{backend} x{world}"
        first = results[0]
        for r in results:
            tag = f"[{label}] rank {r['rank']}"
            for mode, m in r["fid"]["modes"].items():
                check(m["collectives_match"], f"{tag}: FID {mode}: collectives {m['collectives']} vs the plan's "
                                              f"{m['plan_collectives']}")
                if "equal_single_process" in m:
                    check(m["equal_single_process"], f"{tag}: FID {mode}: the synced state differs from one process's")
                else:
                    check(all(m["within_bound"].values()), f"{tag}: FID {mode} outside its bound: {m['within_bound']}")
            check(r["fid"]["modes"]["sharded"]["block_rows"] == FID_FEATURES // world, f"{tag}: sharded block rows")
            check(r["launches"]["int8_quantize"] > 0 and r["launches"]["int8_dequant_sum"] > 0,
                  f"{tag}: int8 codec launches {r['launches']}")
            check(all(r["weight"]["equal"].values()), f"{tag}: weighted sync {r['weight']['equal']}")
            c = r["cadence"]
            want_returned = [(i + 1) % CADENCE_K == 0 for i in range(c["steps"])]
            check(c["returned"] == want_returned and all(c["equal_at_sync"]) and c["final_equal"],
                  f"{tag}: cadence returned {c['returned']}, equal at sync steps {c['equal_at_sync']}, final "
                  f"{c['final_equal']}")
            check(c["values"] == {k: sync[label][0]["values"][k] for k in c["values"]},
                  f"{tag}: cadence values {c['values']} vs phase 5's {sync[label][0]['values']}")
            check(c["at_compute_deferred"] and c["at_compute"] == c["values"], f"{tag}: at_compute {c['at_compute']}")
            check(c["resumed"] == c["uninterrupted"] == c["values"] and c["snapshot_pending"] == CADENCE_K // 2,
                  f"{tag}: restored {c['resumed']} vs {c['uninterrupted']}")
            d = r["deferred"]
            gathers = d["collectives"].get("all_gather", 0)
            # a gather a wire type, and the shape tables' gather with its size exchange
            check(gathers == len(d["wire_dtypes"]) + 1 and d["collectives"].get("shape_gather") == 1,
                  f"{tag}: deferred ragged collectives {d['collectives']} for wire types {d['wire_dtypes']}")
            check(d["images"] == MAP_IMAGES, f"{tag}: {d['images']} images after the deferred sync")
            ragged_first = ragged[label][0]
            check(r["rank"] != 0 or d["values"]["map"] == ragged_first["map"],
                  f"{tag}: deferred mAP {d['values'].get('map')} vs phase 6's {ragged_first['map']}")
            for k, v in d["values"]["rouge"].items():
                check(abs(v - ragged_first["rouge"][k]) <= 1e-6, f"{tag}: deferred {k} {v} vs phase 6's")
        fid = first["fid"]["fid"]
        check(fid["exact"] == fid["sharded"] == fid["single process"] and math.isfinite(fid["exact"]),
              f"[{label}] FID exact {fid['exact']}, sharded {fid['sharded']}, one process {fid['single process']}")
        for mode in SYNC_MODES:
            m = first["fid"]["modes"][mode]
            print(f"[engineering] {label}: FID {mode}: sync {[round(r['fid']['modes'][mode]['sync_ms'], 3) for r in results]}"
                  f" ms per rank beside {m['wire_bytes_model']} modelled wire bytes a rank (bucket_wire_bytes), "
                  f"collectives {m['collectives']} = the plan's {m['plan_collectives']}, buckets {m['buckets']}")
        print(f"[engineering] {label}: FID exact = sharded = one process's = {fid['exact']!r}; rows per rank "
              f"{[r['fid']['rows'] for r in results]}; int8 codec launches per rank {[r['launches'] for r in results]}")
        print(f"[engineering] {label}: weight mask (rank {first['weight']['masked_rank']} out): every leaf equals the "
              f"other ranks' combination; cadence every {CADENCE_K} steps over {first['cadence']['steps']} steps "
              f"({[round(r['cadence']['leg_s'], 2) for r in results]} s with the every-step reference), values "
              f"{first['cadence']['values']} equal phase 5's, at_compute and a restore mid-window equal")
        print(f"[engineering] {label}: deferred mAP + ROUGE: one gather a wire type {first['deferred']['wire_dtypes']} "
              f"beside the shape tables', "
              f"collectives {first['deferred']['collectives']}, sync {[round(r['deferred']['sync_ms'], 3) for r in results]}"
              f" ms, compute {[round(r['deferred']['compute_s'], 3) for r in results]} s; values equal phase 6's; leg "
              f"seconds per rank {[{k: round(v, 2) for k, v in r['seconds'].items()} for r in results]}")
        record[label] = results
    return record


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--json", help="also write the full record to this file")
    for flag in ("--worker", "--backend", "--init", "--out"):  # one rank of a phase-5/6 world
        parser.add_argument(flag, help=argparse.SUPPRESS)
    for flag in ("--rank", "--world"):
        parser.add_argument(flag, type=int, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on a GPU", file=sys.stderr)
        return 1
    if args.worker:
        return worker_main(args)
    sys.path.insert(0, REPO)
    from torchmetrics_tpu_torch.kernels.binned_confmat import binned_confmat_multiclass

    kernels = [binned_confmat_multiclass]
    sources = {
        "binned_confmat_multiclass": "torchmetrics_tpu_torch/csrc/binned_confmat.cu",
        "coco_match": "torchmetrics_tpu_torch/csrc/coco_match.cu",
        "confmat_multiclass": "torchmetrics_tpu_torch/csrc/confmat.cu",
        "binned_confmat_multilabel": "torchmetrics_tpu_torch/csrc/binned_multilabel.cu",
        "calibration_bins": "torchmetrics_tpu_torch/csrc/calibration.cu",
        "ranking_pairs": "torchmetrics_tpu_torch/csrc/ranking.cu",
        "retrieval_groups": "torchmetrics_tpu_torch/csrc/retrieval.cu",
        "ssim_window": "torchmetrics_tpu_torch/csrc/ssim.cu",
        "segmentation_counts": "torchmetrics_tpu_torch/csrc/segmentation.cu",
        "pairwise_lp": "torchmetrics_tpu_torch/csrc/pairwise.cu",
        "snr_moments": "torchmetrics_tpu_torch/csrc/snr_moments.cu",
        "sdr_toeplitz": "torchmetrics_tpu_torch/csrc/sdr_toeplitz.cu",
        "perplexity_nll": "torchmetrics_tpu_torch/csrc/perplexity.cu",
        "bert_greedy_match": "torchmetrics_tpu_torch/csrc/bert_match.cu",
        "mask_iou": "torchmetrics_tpu_torch/csrc/mask_iou.cu",
        "poly_mmd": "torchmetrics_tpu_torch/csrc/poly_mmd.cu",
        "quantile_hist": "torchmetrics_tpu_torch/csrc/quantile_hist.cu",
        "hll_insert": "torchmetrics_tpu_torch/csrc/hll.cu",
        "int8_quantize": "torchmetrics_tpu_torch/csrc/int8_codec.cu",
        "int8_dequant_sum": "torchmetrics_tpu_torch/csrc/int8_codec.cu",
    }
    replaces = {
        "binned_confmat_multiclass": "torchmetrics_tpu/functional/classification/precision_recall_curve.py:128",
        "coco_match": "torchmetrics_tpu/functional/detection/matcher.py:29",
        "confmat_multiclass": "torchmetrics_tpu/functional/classification/confusion_matrix.py:65",
        "binned_confmat_multilabel": "torchmetrics_tpu/functional/classification/precision_recall_curve.py:152",
        "calibration_bins": "torchmetrics_tpu/functional/classification/calibration_error.py:96",
        "ranking_pairs": "torchmetrics_tpu/functional/classification/ranking.py:44",
        "retrieval_groups": "torchmetrics_tpu/functional/retrieval/kernels.py:57",
        "ssim_window": "torchmetrics_tpu/functional/image/ssim.py:111",
        "segmentation_counts": "torchmetrics_tpu/functional/segmentation/mean_iou.py:43",
        "pairwise_lp": "torchmetrics_tpu/functional/pairwise/pairwise.py:118",
        "snr_moments": "torchmetrics_tpu/functional/audio/snr.py:27",
        "sdr_toeplitz": "torchmetrics_tpu/functional/audio/sdr.py:69",
        "perplexity_nll": "torchmetrics_tpu/functional/text/perplexity.py:46",
        "bert_greedy_match": "torchmetrics_tpu/functional/text/bert.py:234",
        "mask_iou": "torchmetrics_tpu/detection/mean_ap.py:65",
        "poly_mmd": "torchmetrics_tpu/functional/image/generative.py:60",
        "quantile_hist": "torchmetrics_tpu/classification/precision_recall_curve.py:110",
        "hll_insert": "torchmetrics_tpu/text/distinct.py:83",
        "int8_quantize": "torchmetrics_tpu/parallel/compress.py:222",
        "int8_dequant_sum": "torchmetrics_tpu/parallel/compress.py:233",
    }

    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        print(f"[time] {name}: {seconds[name]:.1f} s")
        return out

    device = phase_device()
    build_s = phase_build()
    flush = flush_buffer()
    floor = launch_floor(flush)
    kernel_rows = timed("phase 3 binned_confmat_multiclass", phase_kernels, flush)
    kernel_rows["coco_match"], chunk_shapes = timed("phase 3 coco_match", phase_matcher, flush)
    kernel_rows["confmat_multiclass"] = timed("phase 3 confmat_multiclass", phase_confmat, flush)
    kernel_rows["binned_confmat_multilabel"] = timed("phase 3 binned_confmat_multilabel", phase_multilabel_kernel,
                                                     flush)
    kernel_rows["calibration_bins"] = timed("phase 3 calibration_bins", phase_calibration_kernel, flush)
    kernel_rows["ranking_pairs"] = timed("phase 3 ranking_pairs", phase_ranking_kernel, flush)
    kernel_rows["retrieval_groups"] = timed("phase 3 retrieval_groups", phase_retrieval_kernel, flush)
    kernel_rows["ssim_window"] = timed("phase 3 ssim_window", phase_ssim_kernel, flush)
    kernel_rows["segmentation_counts"] = timed("phase 3 segmentation_counts", phase_segmentation_kernel, flush)
    kernel_rows["pairwise_lp"] = timed("phase 3 pairwise_lp", phase_pairwise_kernel, flush)
    kernel_rows["snr_moments"] = timed("phase 3 snr_moments", phase_snr_kernel, flush)
    kernel_rows["sdr_toeplitz"] = timed("phase 3 sdr_toeplitz", phase_sdr_kernel, flush)
    kernel_rows["perplexity_nll"] = timed("phase 3 perplexity_nll", phase_perplexity_kernel, flush)
    kernel_rows["bert_greedy_match"] = timed("phase 3 bert_greedy_match", phase_bert_kernel, flush)
    kernel_rows["mask_iou"] = timed("phase 3 mask_iou", phase_mask_iou_kernel, flush)
    kernel_rows["poly_mmd"] = timed("phase 3 poly_mmd", phase_poly_mmd_kernel, flush)
    kernel_rows["quantile_hist"] = timed("phase 3 quantile_hist", phase_quantile_hist_kernel, flush)
    kernel_rows["hll_insert"] = timed("phase 3 hll_insert", phase_hll_kernel, flush)
    kernel_rows.update(timed("phase 3 int8 codec", phase_int8_codec_kernel, flush))
    del flush
    main = timed("phase 4", phase_main_path, kernels)
    sync = timed("phase 5", phase_sync)
    ragged = timed("phase 6", phase_ragged, chunk_shapes)
    tower = timed("phase 7", phase_tower)
    curves = timed("phase 8", phase_curves)
    rest = timed("phase 9", phase_rest)
    signal = timed("phase 10", phase_signal)
    contingency = timed("phase 11", phase_contingency)
    audio = timed("phase 12", phase_audio)
    text = timed("phase 13", phase_text)
    detection = timed("phase 14", phase_detection)
    generative = timed("phase 15", phase_generative)
    wrapped = timed("phase 16", phase_multimodal_wrappers)
    sketches = timed("phase 17", phase_sketches)
    engineering = timed("phase 18", phase_engineering, sync, ragged)
    kernel_rows["pairwise_lp"] += [{"case": f"Market-1501 {name} (phase 11)", "max_abs_err": entry["max_abs_err"]}
                                   for name, entry in contingency["market"]["calls"].items() if "max_abs_err" in entry]

    # launches of each kernel on the paths that run it: the eval step (phase 4),
    # every rank of the sync worlds (phase 5) and of the ragged worlds (phase 6)
    by_path = {
        "binned_confmat_multiclass": {"eval": main["launches"]["binned_confmat_multiclass"]},
        "coco_match": {},
        "confmat_multiclass": {f"tower {leg}": tower[leg]["launches"] for leg in ("imagenet", "cityscapes")},
        "binned_confmat_multilabel": {f"curves {leg}": curves[leg]["launches"]["binned_confmat_multilabel"]
                                      for leg in ("coco", "binary")},
        "calibration_bins": {f"rest {leg}": rest[leg]["launches"]["calibration_bins"]
                             for leg in ("imagenet probabilities", "imagenet logits", "binary")},
        "ranking_pairs": {"rest coco": rest["coco"]["launches"]["ranking_pairs"]},
        "retrieval_groups": {f"signal {leg}": signal[leg]["launches"]["retrieval_groups"]
                             for leg in ("msmarco", "trec ndcg", "trec map")},
        "ssim_window": {"signal div2k": signal["div2k"]["launches"]["ssim_window"]},
        "segmentation_counts": {f"contingency {leg}": contingency[leg]["launches"]["segmentation_counts"]
                                for leg in ("cityscapes", "ade20k")},
        "pairwise_lp": {f"contingency {leg}": contingency[leg]["launches"]["pairwise_lp"]
                        for leg in ("clustering data", "market")},
        "snr_moments": {f"audio {leg}": audio[leg]["launches"]["snr_moments"] for leg in ("libri2mix", "csisnr")},
        "sdr_toeplitz": {"audio libri2mix": audio["libri2mix"]["launches"]["sdr_toeplitz"]},
        "perplexity_nll": {"text perplexity": text["perplexity"]["launches"]["perplexity_nll"]},
        "bert_greedy_match": {"text bertscore": text["bertscore"]["launches"]["bert_greedy_match"]},
        "mask_iou": {"detection segm": detection["segm"]["launches"]["mask_iou"]},
        "poly_mmd": {"generative cifar": generative["cifar"]["launches"]["poly_mmd"]},
        "quantile_hist": {f"sketches {leg}": sketches[leg]["launches"]["quantile_hist"]
                          for leg in ("imagenet", "coco", "binary", "requires_grad")},
        "hll_insert": {"sketches distinct": sketches["distinct"]["launches"]["hll_insert"]},
        "int8_quantize": {},
        "int8_dequant_sum": {},
    }
    by_path["coco_match"]["detection segm"] = detection["segm"]["launches"]["coco_match"]
    by_path["coco_match"]["sketches map"] = sketches["map"]["launches"]["coco_match"]
    by_path["poly_mmd"]["wrappers featureshare"] = wrapped["featureshare"]["launches"]["poly_mmd"]
    by_path["confmat_multiclass"]["wrappers short leg"] = wrapped["short"]["launches"]["confmat_multiclass"]
    by_path["confmat_multiclass"]["detection panoptic"] = detection["panoptic"]["launches"]["confmat_multiclass"]
    for leg in ("clustering labels", "nominal", "nominal matrices"):
        by_path["confmat_multiclass"][f"contingency {leg}"] = contingency[leg]["launches"]["confmat_multiclass"]
    for leg in ("imagenet probabilities", "imagenet logits"):
        by_path["binned_confmat_multiclass"][f"rest {leg}"] = rest[leg]["launches"]["binned_confmat_multiclass"]
    for leg in ("coco", "binary"):
        by_path["binned_confmat_multilabel"][f"rest {leg}"] = rest[leg]["launches"]["binned_confmat_multilabel"]
    for name, record in (("sync", sync), ("ragged", ragged), ("engineering", engineering)):
        for label, results in record.items():
            for kernel, count in ((k, sum(r["launches"][k] for r in results)) for k in results[0]["launches"]):
                by_path[kernel][f"{name} {label}"] = count
    line = {"kernels": []}
    for name in sources:
        first_row = kernel_rows[name][0]  # the main path's shape; pairwise_lp's is 1,024^2 x 512 (phase 11 times
        # Market-1501's, where the plain version runs only a block of rows at a time)
        check(all(n > 0 for n in by_path[name].values()) and by_path[name], f"{name} did not launch: {by_path[name]}")
        line["kernels"].append({
            "name": name, "route": "cuda", "source": sources[name], "replaces": replaces[name],
            "launches": sum(by_path[name].values()), "launches_by_path": by_path[name],
            "max_abs_err": max(r["max_abs_err"] for r in kernel_rows[name] if "max_abs_err" in r),
            "ms": first_row["ms"], "stream_ms": first_row["stream_ms"], "plain_ms": first_row["plain_ms"],
            "bound_ms": first_row["bound_ms"], "bound_by": first_row["bound_by"],
            "library_ms": first_row.get("library_ms"),
            **{k: first_row[k] for k in ("two_call_ms", "bucketize_bincount_ms", "softmax_bucketize_bincount_ms",
                                         "sort_gather_cumsum_ms", "query_layout_ms", "sort_cumsum_segment_ms",
                                         "conv_ssim_yardstick_ms", "bincount_yardstick_ms", "chain_bound_ms",
                                         "least_chain_ms", "library_float64_ms", "bmm_amax_yardstick_ms",
                                         "floor_index_add_yardstick_ms", "scatter_amax_yardstick_ms",
                                         "torch_chain_yardstick_ms", "concat_ms", "concat_plain_ms",
                                         "concat_bound_ms")
               if k in first_row},
        })
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"device": device, "build_s": build_s, "seconds": seconds, "launch_floor": floor,
                       "kernels": kernel_rows, "main_path": main,
                       "sync": sync, "ragged": ragged, "tower": tower, "curves": curves, "rest": rest,
                       "signal": signal, "contingency": contingency, "audio": audio, "text": text,
                       "detection": detection, "generative": generative, "multimodal_wrappers": wrapped,
                       "sketches": sketches, "engineering": engineering}, f,
                      indent=1)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device["name"], "count": device["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
