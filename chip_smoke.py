#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (transmogrifai_tpu_torch) on one GPU.

    python3 chip_smoke.py            # the full check, as run on an H100
    python3 chip_smoke.py --rows 2000000 --configs 4   # a shorter run

Phases, each of which fails the run on error:

1. device  — a CUDA device must be present; prints the card's name and
             power limit as nvidia-smi reports them;
2. build   — compiles csrc/tree_kernels.cu with nvcc (seconds), prints
             ptxas's registers and spills and, from cuobjdump's SASS, the
             shared-memory atomics of each kernel; fails if route_hist's
             sorted histogram kernel holds an f32 shared atomic (a CAS
             loop: ATOMS.CAS*);
3. kernels — each of the four kernels at every shape the main path gives
             it (hist_folds at the root, with uniform and skewed bins, and
             at the rank-metric shapes of the tree sweep, 5 lanes, and of
             the GLM sweep, 8 lanes; route_hist at S = 1..16; route at 8
             and 32 nodes, and at 32 with one split table shared by the
             lanes; table_lookup at 16 and 64 leaves; route and
             table_lookup at 2M and 10M rows; and a depth-12 forest
             tree's shapes at 1M rows, F = 164, 3 payload channels + the
             count: the root, route_hist at S = 32, 256, 1024, route at
             2048 nodes, table_lookup over 4096 leaves) against its plain PyTorch
             version on the same inputs (stated tolerance; the g/h
             histograms, like the plain version's, against the float64
             sums: `hist_paths.accuracy`), with its time
             (CUDA events, warm, median), the kernel's rows path (the
             row-mapped kernels) timed in turns beside the chosen path
             (old, new, new, old; where the planner chose the rows path,
             it alone, twice, and `earlier_ms` null; on route_hist's
             sorted path also its sort alone, `sort_ms`, and its share of
             the launch, `sort_share`), the plain version's
             time (one warm call where it takes over 0.2 s), one library
             call's time where one computes the same function, its bound
             on this card and, for the histograms, the shared-memory floor
             (one read and one write per add, 32 lanes a clock per SM), for
             route and table_lookup the time of a device copy of the lane
             plane they read and write (the card's streaming floor);
4. small   — a small CV sweep on the CPU (plain versions) and on the GPU
             (kernels): same winner, per-cell AuPR within 5e-3;
5. main    — the model selector's tree sweep at full width: 5-fold
             CrossValidation over the 16-config XGBoost grid (depth {4, 6}
             x eta {.05, .1, .2, .3} x lambda {1, 5}, 10 rounds, 32 bins)
             on `--rows` x 64 features, then the refit of the winner and
             its scoring. Launch counters (per kernel and per kernel
             shape) are reset just before and read just after; every
             kernel must have launched, route and table_lookup at the
             shapes of every depth swept;
6. profile — the winner's 5-fold cell under torch.profiler: device time by
             kernel (and of each of the port's kernels) and the device's
             busy share; it must see device time;
7. glm-small — one GLM sweep (logistic regression, 12 grids, and the
             linear SVC, 4 grids; 5 folds, 16 features) on the CPU (plain
             versions) and on the GPU, at 200 000 rows (streamed route)
             and at 50 000 (vmapped route): the same winner, the same
             route labels, identical retirement telemetry and every fold
             metric within 1e-4;
8. glm-main — the BASELINE sweep's GLM half at full width: 5-fold
             CrossValidation over 48 logistic-regression grids (reg
             logspace(-4, -0.5, 16) x elastic net {0, .25, .5},
             max_iter 15, no standardization) on `--rows` x 64 features
             without missing values, then the refit of the winner and its
             scoring: wall, route and retirement telemetry, executed
             FLOPs (bench.py's streamed model) and their share of the
             card's f32 rate, CV and refit AuPR. Launch counters are
             reset just before the sweep and read just after; the rank-
             metric kernel must have launched at the grid chunk's 8 lanes;
9. baseline — one validate over the 48 LR grids and the 16 XGBoost
             configs on the same data: the port's whole BASELINE sweep;
10. tree-sweep-10M-fused — main's sweep (its X and y, the 16 configs)
             with TMOG_GRID_FUSE on: each depth's 8 configs as one fit of
             40 lanes (the lane planner's chunk printed), the wall beside
             main's, peak device memory, launches by kernel, shape and
             lanes, each fold metric within 1e-3 of main's or its tie
             witness (`split_witness` on the two fits' first differing
             node), the same winner or a tie within WINNER_TIE_TOL; then
             every kernel at each 40-lane key of a one-round fit of each
             depth group, timed at the full rows and held to its plain
             version on its first 2M rows (rows of the kernels line,
             phase "fused"); then the lane planner's residency model
             (C5) against a depth-6 group's measured peaks at 40 and 10
             lanes (`tools/fit_memory.measure`): the fit's own and the
             group's, at or above each, within C5_MAX_OVER;
11. baseline-bf16 — baseline's sweep with sweep_dtype=torch.bfloat16 and
             fusion on (the BASELINE sweep as bench.py runs it on the
             TPU): wall, routes, winner, peak memory, X's bytes against
             the f32 sweep's, every cell's gap to its f32 cell, the best
             CV AuPR within 1e-3 of baseline's;
12. glm-profile — one round of the streamed route (240 lanes, 5 Newton
             iterations) under torch.profiler: the device's busy share
             and the top operations;
13. workflow-small — the user's flow (FeatureBuilder -> transmogrify ->
             SanityChecker -> BinaryClassificationModelSelector ->
             Workflow.train() -> score()) on 50 000 titanic-shaped
             records through ListReader, on the CPU (plain versions) and
             twice on the card: identical matrix and metadata, the same
             drops and winner, cells within 5e-3, the scores' AuPR within
             1e-3, the CPU-fitted workflow scored on the card within 1e-5
             on every row, and the card's scores within 1e-5 of the CPU's
             on every row unless the refit trees split a node differently,
             where the first such node must be a tie within the f32 noise
             of the two histograms (the witness is printed); the second
             card run is held to the first the same way;
14. workflow-titanic — the port's example flow
             (examples/op_titanic_simple.py: a Text name hashed into 512
             bins, DSL arithmetic, pivot, fill + z-normalize, a lambda
             map) on `titanic_named_records`: CPU against card at 2 000
             records (LR's 2 least regularised default grid points, RF
             10 trees at depth {3, 5}: the
             matrix and metadata identical, the same drops and winner,
             scores within 1e-5 a row or a tie witness; where the CPU's
             train() goes), then 100 000 records through
             `titanic_selector()` (the example's reference_selector: LR's
             default grid, RF's cut to depth {3, 6}, 3 folds) on the
             card: stage walls,
             peak device memory, winner, CV and holdout AuPR and AuROC
             against the prevalence; every kernel at each (kernel, F, S,
             C, Fo) key of train() (F ~ 590) against its plain version
             (rows of the kernels line, phase "titanic");
15. workflow-wide — bench.py's wide schema (PickLists of 50 and 12
             categories, a Text, two Reals, a Date, a RealMap) with one
             feature of each date, map, geolocation and structured text
             group (Email, URL, Phone, Base64, Geolocation, DateList,
             PickListMap, a DateMap through to_unit_circle_map;
             `wide_columns`): at 5 000 rows with a cut grid twice on the
             card (C1: the largest |dp| between the runs, identical
             matrices, the same winner, the largest CV-cell difference, a
             tie witness where the refits split apart) and on the CPU
             (as in workflow-titanic), then at 1 000 000 rows on the card
             through transmogrify, SanityChecker() and a 3-fold sweep of
             LR's default grid, RF of 10 trees at depth {3, 6} and GBT of
             10 rounds at depth 4: each group's width, each stage's and
             derivation's walls, train and score walls, each family's
             sweep, peak memory, winner and holdout AuPR against the
             prevalence, and every kernel at each (kernel, F, S, C, Fo)
             key of train() (F = 650) against its plain version (rows of
             the kernels line, phase "wide"), while the CPU's leg trains
             in a thread;
16. workflow-events — an event log through the data-prep flow
             (`event_log`: 200 000 users' profiles, 1.5M events over 60
             days): the profiles through an AggregateReader keyed by user,
             left-outer joined with the events and re-aggregated around a
             day-45 cutoff (sums over 1, 7 and 30 days, mean, last, union,
             concat, logical or, midpoint; the label a purchase within 7
             days after), RawFeatureFilter with the day-52 snapshot's reader
             as its score reader (three seeded drops: a drift, a low fill
             rate, a label leak), transmogrify, SanityChecker() and the
             workflow-wide selector inside Workflow().train(), then score()
             of the score snapshot: each reader's wall and rows, the
             filter's drops and reasons, walls, winner and holdout AuPR
             against the prevalence, every kernel at each key of train()
             against its plain version (phase "events"); the leg at 2 500
             users on the CPU and on the card: readers, drops, reasons,
             matrix and winner identical, scores within 1e-5 or a tie;
17. workflow-main — the same flow at 10M rows (64 Reals, two PickLists,
             5 folds, the selector's default model types and grids: LR,
             RF (cut to depth {3, 6} and one depth-12 point), GBT and SVC,
             max_depth up to 12): the wall of each stage
             and of each family's sweep, each host-to-device copy, peak
             device memory, widths, winner and AuPRs; launch counters
             reset just before train() and read just after, every kernel
             must have launched, at the depth-12 keys too; each kernel at
             every (kernel, F, S, channels C, lanes Fo) key of train()
             (a forest's, a boosted sweep's and a refit's launches apart),
             on the inputs of its first launch there, against its plain
             version (rows of the kernels line, phase "workflow"); the
             forest's and boosted tree's sweep walls and the winner beside
             those of route_hist's rows path (ROWS_PATH_SWEEP_S,
             ROWS_PATH_WINNER); then one statistics pass over the whole
             matrix, streamed, against the fused route; then its insights
             (`insights_leg`): `model_insights()` (wall, JSON bytes, top 5
             contributions), `loco_insights` through the dsl on 20 000
             rows with the model's fitted stages (top 20 columns a row),
             `insights_matrix` timed on 200 000 rows, and the knockouts of
             256 rows on the card within 1e-5 of the CPU's;
18. workflow-regression — op_boston's flow at user scale
             (`housing_columns`: 1 000 000 rows, all 13 predictors of
             HOUSING_COLUMNS, chas a PickList, rad an Integral, the Reals
             2% missing): transmogrify, SanityChecker() and a 3-fold
             RegressionModelSelector (linear regression's default grid on
             the Gram route, RF 10 trees at depth {3, 6}, GBT 10 rounds at
             depth 4) inside Workflow(device="cuda").with_workflow_cv()
             .train(): each stage's and each fold's walls, each family's
             sweep, the GLM route, peak memory, winner, CV RMSE, holdout
             RMSE and R2 beside the label's spread; 100 000 new rows scored,
             the model saved, loaded and scored again (identical), loaded
             onto the CPU (10 000 rows within 1e-5 relative); every kernel
             at each key of train() against its plain version (phase
             "regression"); the leg at 8 000 rows on the CPU and twice on
             the card: the matrix identical, the same winner, CV fold
             metrics within 1e-3 relative or a tie witness in that cell's
             fits, scores within 1e-5 relative or a tie witness;
19. workflow-multiclass — a Covertype-shaped flow (`covertype_columns`:
             581 012 rows, UCI Covertype's published counts of its 7 cover
             types, 10 quantitative columns 1% missing, wilderness area and
             soil type PickLists of 4 and 40) through transmogrify,
             SanityChecker() and a 3-fold MultiClassificationModelSelector
             (DataCutter, the multiclass error; LR's default grid as
             softmax lanes, RF 10 trees at depth {3, 6} with K + 2 = 9
             histogram channels a lane, softmax XGBoost 10 rounds at depth
             4 as 7 class lanes a fold, naive Bayes) inside
             Workflow().train(): walls, each family's sweep, the routes,
             peak memory, winner, CV and holdout error against the majority
             class; 100 000 new rows scored, saved, loaded and scored again
             (identical), loaded onto the CPU (10 000 rows within 1e-5); the
             port's op_iris on the card (K = 3: C = 5); every kernel at each
             key of the two train()s against its plain version (phases
             "multiclass" and "iris"); `model_insights()` of the winner
             with its contributions a class (`multiclass_insights`); the
             leg at 8 000 rows on the CPU
             and twice on the card: the matrix identical, the same winner,
             CV fold metrics within 1e-3 or a tie witness in that fold's
             lanes, the scores (predicted class, probabilities) within 1e-5
             relative or a tie witness;
20. workflow-text — support tickets (`ticket_columns`: 100 000 records,
             a body of 40-80 tokens from 10 planted topics over 5 000
             words, 10% German, French or Spanish, names of people,
             places and organisations from the NER gazetteers; a subject,
             a reply, a product and two numerics) through `text_features`
             (tokens without stop words counted into LDA topics, TF-IDF,
             word2vec; regex bigrams; n-gram and Jaccard similarity;
             language, entities, length, substring; the product indexed
             and deindexed), transmogrify, SanityChecker() and a 3-fold
             sweep of LR's default grid and a GBT of 10 rounds at depth 4
             inside Workflow().train(): each text stage's fit and
             transform wall, LDA's and the ALS's device walls, train and
             score walls, winner, CV and holdout AuPR against the
             prevalence, 5 000 new records scored, saved, loaded and
             scored again (identical); every kernel at each key of train()
             against its plain version (phase "text"); the leg at 2 000
             records (the GBT alone) on the CPU and on the card: host
             stages identical,
             LDA's topics and the word vectors within tolerance, scores
             within 1e-5 or a tie witness, the CPU-fitted workflow
             carried onto the card within 1e-5;
21. workflow-stream — bench.py's streaming scenario (2 000 000 rows x
             16 float columns, 3 folds) written once as Avro shards of
             250 000 rows, the only full copy of X, and read through
             `sharded_reader_source` (4 parse workers) into the
             tileplane: the streamed statistics pass against the resident
             route (rtol 1e-5, atol 1e-6) with rows 2M and peak host rows
             <= 2 tiles, the same pass at prefetch depth 2 and under
             TMOG_TILEPLANE=0 bit-identical; the GLM rounds over the
             source (2 lanes a fold, max_iter 15, warm start) within rtol
             5e-3 / atol 7e-4 of the resident round driver; streamed
             edges within one histogram bin of the exact quantiles and
             streamed bins exactly `bin_matrix`; a boosted fit on the
             streamed bins (every kernel at each key against its plain
             version, phase "stream"); a workflow holding its trees
             saved and scored by OpWorkflowRunner's StreamingScore over
             one shard's 250 000 records, every score within 1e-5 of
             `score()`; the 20 000-row leg on the CPU and on the card;
             rows/s of every pass, the GLM's data passes, a traced
             probe's overlap ratio with copy, compute and parse seconds,
             host-to-device GB/s through the pinned ring against
             pageable `to_device`;
22. serve — the model workflow-wide trained at 1M rows (saved there)
             through the real CLI in subprocesses: `serve DIR
             --prewarm-only --max-batch 64` (rc 0, buckets 1, 8, 16, 32 and
             64 with each one's wall, serve.json's model_hash equal to
             `model_content_hash`), then `serve DIR --port 0
             --metrics-location M`: /healthz warm, 1 000 single-record
             POSTs from 8 client threads, bulk bodies of 1, 3, 17, 63, 64
             and 100 records, an unknown key and a value its type rejects
             (400s naming them), every answer within 1e-5 of in-process
             score() of the same records (a record missing a key included:
             a saved model reads it as a missing value, as the JAX
             package's does), /metrics (post_warmup_compiles 0, pad and
             bucket rows, p50 / p95 / p99 of total, queue, assemble and
             device time), SIGTERM (rc 0 after the drain), `trace-report M
             --check` (rc 0) and `--requests`, and the kept request
             traces' coverage (`request_coverage`: the widest stretch of
             a request no segment covers); then workflow-titanic's
             model (a random forest won) in a ServingEngine in process: 200
             new records within 1e-5 of score(), its local route on 20
             within 1e-5 of the bucket route, and the four kernels' launch
             counters unmoved while it serves.

Float32 products stay in full f32: the run fails unless TF32 is off
(`torch.backends.cuda.matmul.allow_tf32` False, float32 matmul precision
"highest").

The last three lines of standard output are {"kernels": [...]} (each
row's `launches` at its (kernel, F, S) key in the phase it names, a
workflow, titanic, wide, events, regression, multiclass, iris, text or
stream row's at
its (kernel, F, S, C, Fo) key inside its phase's train(), a fused row's at
that key inside tree-sweep-10M-fused's sweep (with `full_rows_ms`, its
time at the sweep's rows), and, for the
tree, GLM and
workflow rows,
`workflow_launches` at that key inside workflow-main's train()), the
card's name and power limit, and
{"ok": true, "device": {...}}. Exits
non-zero, printing no result, when CUDA is unavailable or the package is
not beside this script.
"""
from __future__ import annotations

import argparse
import atexit
import collections
import contextlib
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

# the card's HBM bytes/s and float32 operations/s outside the tensor cores:
# set by card_roof() from transmogrifai_tpu_torch.utils.metrics.DEVICE_ROOFS,
# the one table the port's kernel records divide by too
HBM_BYTES_PER_S = FP32_OPS_PER_S = None
SOURCE = "transmogrifai_tpu_torch/csrc/tree_kernels.cu"
KERNEL_ROWS = 2_000_000       # rows of the per-kernel checks and timings
LANE_ROWS = 10_000_000        # route and table_lookup also at the main
#                               path's rows
DEEP_ROWS = 1_000_000         # the forest rows: the DataBalancer's sweep
SEED = 0
REPLACES = {   # the Pallas kernel body each CUDA kernel replaces
    "hist_folds": "transmogrifai_tpu/ops/pallas_hist.py:395",
    "route_hist": "transmogrifai_tpu/ops/pallas_hist.py:713",
    "route": "transmogrifai_tpu/ops/pallas_hist.py:598",
    "table_lookup": "transmogrifai_tpu/ops/pallas_hist.py:866",
}
GLM_EVAL_LANES = 8            # the streamed eval's grid chunk
TITANIC_ROWS = 100_000        # workflow-titanic's main path (PERF.md §4)
TITANIC_LEG_ROWS = 2_000      # its CPU-against-card leg (PERF.md §4)
WIDE_ROWS = 1_000_000         # bench.py's wide_rows: workflow-wide's main path
WIDE_LEG_ROWS = 5_000         # workflow-wide's CPU-against-card leg
WIDE_SCORE_ROWS = 100_000     # new rows workflow-wide scores
EVENTS_USERS = 200_000        # workflow-events' main path (PERF.md §4)
EVENTS_LEG_USERS = 2_500      # workflow-events' CPU-against-card leg
REGRESSION_ROWS = 1_000_000   # workflow-regression's main path (PERF.md §4)
REGRESSION_LEG_ROWS = 8_000   # its CPU-and-card leg
REGRESSION_SCORE_ROWS = 100_000   # new rows scored before and after save/load
REGRESSION_CPU_LOAD_ROWS = 10_000  # rows the model loaded onto the CPU scores
COVERTYPE_ROWS = 581_012      # UCI Covertype's rows: workflow-multiclass
COVERTYPE_CLASS_COUNTS = (211_840, 283_301, 35_754, 2_747, 9_493, 17_367,
                          20_510)     # its published counts of cover types
COVERTYPE_CLASS_SEED = 1999   # seeds the classes' means and category shares
COVERTYPE_LEG_ROWS = 8_000    # its CPU-and-card leg
COVERTYPE_SCORE_ROWS = 100_000    # new rows scored before and after save/load
COVERTYPE_CPU_LOAD_ROWS = 10_000  # rows the model loaded onto the CPU scores
MLP_GRID_SEED = 7             # RandomParamBuilder's seed of the MLP's grid
INSIGHTS_LOCO_ROWS = 20_000   # rows workflow-main's loco_insights scores
INSIGHTS_MATRIX_ROWS = 200_000    # rows of its timed insights_matrix
INSIGHTS_CHECK_ROWS = 256     # rows its knockouts are held card vs CPU
INSIGHTS_TOP_K = 20           # the dsl's default top_k
INSIGHTS_TOL = 1e-5           # card vs CPU knockout deltas, absolute
TEXT_ROWS = 100_000           # workflow-text's main path (PERF.md §4)
TEXT_LEG_ROWS = 2_000         # its CPU-against-card leg
TEXT_SCORE_ROWS = 5_000       # new records it scores, saves, loads, rescores
TEXT_TOPIC_SEED = 2024        # seeds the vocabulary and the 10 topics
TEXT_TOPICS = 10
TEXT_VOCAB = 5_000
# card against CPU: LDA's topics after 50 EM iterations and the ALS word
# vectors, as tests/test_torch_text_gpu.py holds them (of each entry or
# of the largest)
TEXT_LDA_RTOL = 1e-4
TEXT_W2V_RTOL = 1e-4
# workflow-stream: bench.py's streaming scenario (bench.py:1134-1136)
STREAM_ROWS = 2_000_000       # rows, written once as Avro shards
STREAM_COLS = 16              # float columns
STREAM_FOLDS = 3
STREAM_SLAB = 250_000         # rows an Avro shard (bench.py's slabs)
STREAM_WORKERS = 4            # parse workers of the sharded source
STREAM_BATCH = 65_536         # records a decoded chunk
STREAM_LEG_ROWS = 20_000      # its CPU-against-card leg
STREAM_BINS = 32              # quantile bins of the streamed tree binning
STREAM_HIST_BINS = 512        # histogram bins behind the streamed edges
STREAM_GBT = dict(n_rounds=10, depth=6, learning_rate=0.3)
STREAM_REGS = (0.01, 0.1)     # the GLM's 2 lanes a fold (bench.py:1202)
STREAM_SCORE_TILE = 16_384    # records a StreamingScore tile
C5_CHUNKS = (8, 2)            # configs a fused fit: 40 and 10 lanes
C5_MAX_OVER = 1.15            # the residency model's bound over its peak
# an MLP fold metric CPU against card (relative to max(1, |metric|)). Adam
# steps each weight by step_size times the sign of its gradient's running
# mean wherever that gradient is rounding noise (a sigmoid saturated by
# raw, unscaled inputs), so the two devices' fits part further with every
# step: fold errors of the Covertype-shaped matrix measured up to 0.181
# apart at 3 000 rows and 0.076 at 20 000 (3 seeds, 100 and 200 steps;
# NVIDIA H100 80GB HBM3, 700 W). The same fits agree within 3e-6 after
# 50 steps on well-conditioned inputs (tests/test_torch_mlp_gpu.py).
MLP_FOLD_TOL = 0.25
MLP_STEPS = 100               # the multiclass selector's MLP: Adam steps
#                               (the default 200 halved for the CPU leg)
# workflow-main's forest and boosted-tree sweep walls (s), winner and its
# CV AuPR with route_hist's levels on the rows path, before the sorted
# path: this script at 10M rows on an NVIDIA H100 80GB HBM3, 700.00 W (the
# forest's over its full default grid: workflow-main sweeps 13 of its 18
# points since PR 17, so only the boosted wall still compares)
ROWS_PATH_SWEEP_S = {"OpRandomForestClassifier": 157.605309327,
                     "OpGBTClassifier": 39.41479733400001}
ROWS_PATH_WINNER = ["OpGBTClassifier", {"max_depth": 12,
                                        "min_instances_per_node": 100,
                                        "min_info_gain": 0.1,
                                        "max_iter": 20, "step_size": 0.1}]
ROWS_PATH_WINNER_CV = 0.7845017075538635
# a winner other than the rows path's is a tie where the rows path's
# winner scores within this of the new winner in this run: card runs sum
# the boosted trees' f32 histograms in a changing order (atomic flushes),
# and workflow-main's boosted cells move by up to 3.1e-4 between runs,
# more than the 3.1e-5 to 3.1e-4 between its best depth-12 grid points
WINNER_TIE_TOL = 1e-3
XGB_GRID = [dict(num_round=10, max_depth=d, eta=e, reg_lambda=lam,
                 max_bins=32)
            for d in (4, 6) for e in (0.05, 0.1, 0.2, 0.3) for lam in (1.0, 5.0)]


def glm_grid(n_regs: int = 16):
    """The BASELINE sweep's logistic-regression grids (bench.py
    glm_grids): reg logspace(-4, -0.5, n_regs) x elastic net {0, .25, .5}."""
    import numpy as np
    return [{"reg_param": float(r), "elastic_net_param": a}
            for r in np.logspace(-4, -0.5, n_regs) for a in (0.0, 0.25, 0.5)]


def log(msg: str) -> None:
    print(msg, flush=True)


def card_roof() -> tuple:
    """(HBM bytes/s, f32 operations/s) of card 0 from the port's
    DEVICE_ROOFS, set once into HBM_BYTES_PER_S and FP32_OPS_PER_S; None
    for a card the table does not hold."""
    global HBM_BYTES_PER_S, FP32_OPS_PER_S
    if HBM_BYTES_PER_S is None:
        import torch
        from transmogrifai_tpu_torch.utils.metrics import device_roof
        roof = device_roof(torch.cuda.get_device_name(0))
        if roof is None:
            return None
        HBM_BYTES_PER_S, FP32_OPS_PER_S = roof
    return HBM_BYTES_PER_S, FP32_OPS_PER_S


def bound(n_bytes: float, n_ops: float):
    card_roof()
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def smem_floor_ms(n_adds: float) -> float:
    """The least time a shared-memory histogram needs for n_adds adds: one
    read and one write of a 4-byte cell each, 32 lanes a clock on each SM
    at the card's maximum SM clock (nvidia-smi)."""
    import torch
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.split()[0])
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    return 2 * n_adds / (n_sm * 32 * mhz * 1e6) * 1e3


def kernel_phase(seed: int):
    """Each kernel against its plain version at every shape the main path
    gives it, on `HP.kernel_inputs` at N = 2M rows (every shape) and 10M
    (route and table_lookup, as the main path runs them): F = 64, B = 33
    (32 bins + missing), Fo = 5 fold lanes; hist_folds at the tree root
    (uniform and skewed bins) and at the rank-metric shape (F = 1, 4096
    buckets, the 5 lanes in the slot axis), route_hist at S = 1, 2, 4, 8,
    16, route at the last level (8 and 32 nodes, and 32 with one split
    table shared by the lanes) and the 16- and 64-leaf lookups; then
    hist_folds at the GLM streamed eval's shape (F = 1, 4096 buckets, a
    grid chunk of 8 lanes over 10M rows). Every kernel is timed in turns
    against its rows path (the row-mapped kernels: old, new, new, old).
    Each row names the main-path phase whose launches it reads."""
    from transmogrifai_tpu_torch.tools import hist_paths as HP
    import torch

    d = HP.kernel_inputs(KERNEL_ROWS, seed)
    out = kernel_rows(HP.hist_shapes(d) + HP.lane_shapes(d))
    del d
    torch.cuda.empty_cache()
    d = HP.kernel_inputs(LANE_ROWS, seed, hist=False)
    out += kernel_rows(HP.lane_shapes(d))
    del d
    torch.cuda.empty_cache()
    # a depth-12 forest tree of the default grids at workflow-main's sweep
    # shapes (its launches are read from workflow-main's train())
    d = HP.deep_inputs(DEEP_ROWS, seed)
    out += kernel_rows(HP.deep_shapes(d), phase="workflow")
    del d
    torch.cuda.empty_cache()
    # the GLM streamed eval's rank-metric counts: a grid chunk of 8 lanes
    # over the 10M rows of a fold's scores
    gen = torch.Generator(device="cuda").manual_seed(seed + 7)
    d = dict(N=LANE_ROWS, F=1, B=0, Fo=GLM_EVAL_LANES,
             **HP.rank_inputs(gen, LANE_ROWS, GLM_EVAL_LANES))
    glm_rows = kernel_rows([HP.rank_shape(d, "rank metric, GLM eval")],
                           phase="glm")
    del d
    torch.cuda.empty_cache()
    return out + glm_rows


def kernel_rows(shapes: list, phase: str = "tree",
                before_timing=None) -> list:
    """One result row per (label, kernel, S, args, kwargs) of `shapes`: the
    kernel against its plain version on those inputs, timed in turns
    against its rows path (where the planner takes another), with its
    bound, plain and library times. Every
    count of the work (bytes, adds, data-dependent nonzeros) is taken from
    the inputs themselves. `phase` names the main-path phase whose launch
    counts the row reads. Every shape is checked first (its library call
    bound to that shape's own sizes), then
    `before_timing()` (where given) is called, then every shape is timed:
    what runs beside the checks has ended before the first timing."""
    import torch
    from transmogrifai_tpu_torch.ops import tree_kernels as TK
    from transmogrifai_tpu_torch.tools import hist_paths as HP

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count

    def nz(t):   # data-dependent work: nonzero payload entries
        return float((t != 0).sum())

    checked = []
    for label, name, S, args, kw in shapes:
        n_adds = moved = make_lib = None
        rank = name == "hist_folds" and not kw.get("derive_count")
        if name in ("hist_folds", "route_hist") and not rank:
            Xb, pay = args[0], args[1]
            F, N = Xb.shape
            Fo, B = args[2].shape[0], kw["n_bins"]
            C = pay.shape[0] // Fo          # payload channels; h the last
            chans = [pay[c::C] for c in range(C)]
            Co = C + 1                      # + the derived count
        if name == "route_hist":    # rows a level histograms: left rows
            left = (HP.plain("route", (Xb, *args[2:]), {})
                    == 2 * args[2]).float()
            n_bytes = TK.kernel_bytes("route_hist", F, N, Fo, channels=C,
                                      out_cells=Fo * S * Co * F * B)
            n_adds = F * (sum(nz(ch * left) for ch in chans)
                          + nz(chans[-1] * left))
            n_ops = n_adds + 4 * Fo * N
            del left
        elif rank:                  # lanes in the slot axis, 0/1 weights
            L, RB = kw["n_slots"], kw["n_bins"]
            n_bytes = TK.kernel_bytes("hist_folds", 1, args[0].shape[1], 1,
                                      xb_itemsize=4, out_cells=L * 2 * RB)
            n_ops = n_adds = nz(args[1])
            make_lib = lambda a, RB=RB, L=L: _bincount_hist(
                a[0], a[1], 1, RB, 1, L, slot=a[2])
        elif name == "hist_folds":
            n_bytes = TK.kernel_bytes("hist_folds", F, N, Fo, channels=C,
                                      out_cells=Fo * Co * F * B)
            n_ops = n_adds = F * (sum(nz(ch) for ch in chans)
                                  + nz(chans[-1]))
            make_lib = lambda a, F=F, B=B, Fo=Fo: _bincount_hist(
                a[0], a[1], F, B, Fo, 1, derive_count=True)
        elif name == "route":       # compares, select, multiply-add a lane
            F, N = args[0].shape
            Fo = args[1].shape[0]
            n_bytes = TK.kernel_bytes(
                "route", F, N, Fo, bins_read=HP.route_bins_read(args[1],
                                                                args[2]))
            n_ops = 4 * Fo * N
            # what the staged path moves: the node planes and a row of bins
            # of every feature some lane's table splits on
            moved = TK.kernel_bytes("route", F, N, Fo, bins_read=N * int(
                torch.unique(args[2]).numel()))
        else:                       # a compare and a select a lane
            Fo, N = args[1].shape
            n_bytes = TK.kernel_bytes("table_lookup", 1, N, Fo)
            n_ops = 2 * Fo * N
            make_lib = lambda a: lambda: torch.where(
                (a[1] >= 0) & (a[1] < a[0].shape[1]),
                torch.gather(a[0], 1,
                             a[1].long().clamp(0, a[0].shape[1] - 1)),
                0.0)
        dispatch = getattr(TK, name)
        t_check = time.perf_counter()
        got = dispatch(*args, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = HP.plain(name, args, kw)
        torch.cuda.synchronize()
        # a plain version slower than 0.2 s is timed once, warmed by the
        # call above
        slow_plain = time.perf_counter() - t0 > 0.2
        acc = HP.accuracy(name, got, want, args, kw)
        if name in ("route", "table_lookup"):
            tol = "exact"
        elif rank:                # 0/1 weights: integer sums are exact
            tol = "exact (integer payloads)"
        else:
            # f32 sums of up to N terms a cell, in the kernel's order and
            # the plain version's: both are held to the float64 sums
            tol = ("g/h cells: error over the cell's sum of |terms|, "
                   "against the float64 sums, within 1e-4 or the plain "
                   "version's own, whichever is larger; counts exact"
                   + ("; node ids exact" if name == "route_hist" else ""))
        del got, want
        torch.cuda.empty_cache()
        checked.append((label, name, S, args, kw, n_adds, moved, make_lib,
                        n_bytes, n_ops, dispatch, slow_plain, acc, tol,
                        time.perf_counter() - t_check))
    if before_timing is not None:
        before_timing()
    rows_out = []
    for (label, name, S, args, kw, n_adds, moved, make_lib, n_bytes, n_ops,
         dispatch, slow_plain, acc, tol, check_s) in checked:
        err, ok = acc["max_abs_err"], acc["ok"]
        t_timing = time.perf_counter()
        path = HP.planner(name, S, args, kw, n_sm)[0]().path
        turns = {}
        # where the planner takes the rows path itself, the two are one
        for p in (("rows", None, None, "rows") if path != "rows"
                  else (None, None)):
            turns.setdefault(p, []).append(HP.cuda_ms(
                lambda: dispatch(*args, **kw, path=p), reps=7))
        ms = statistics.mean(turns[None])
        earlier_ms = (statistics.mean(turns["rows"]) if "rows" in turns
                      else None)
        # the sorted path's sort alone (its first three kernels): its
        # share of the launch
        sort_ms = (HP.cuda_ms(lambda: TK.route_hist_sort(*args, **kw),
                              reps=7)
                   if path == "sorted" else None)
        plain_ms = HP.cuda_ms(lambda: HP.plain(name, args, kw),
                              reps=1 if slow_plain else 3,
                              warm=0 if slow_plain else 1)
        library_ms = None
        if make_lib is not None:
            # a library call slower than 0.2 s is timed once, by its first
            # call; a faster one 5 times after that first call
            lib = make_lib(args)
            library_ms = HP.cuda_ms(lib, reps=1, warm=0)
            if library_ms <= 200:
                library_ms = HP.cuda_ms(lib, reps=5, warm=0)
        # the streaming floor of route and table_lookup on this card: a
        # device-to-device copy of the lane plane they read and write
        copy_ms = (HP.cuda_ms(args[1].clone, reps=7)
                   if name in ("route", "table_lookup") else None)
        b_ms, b_by = bound(n_bytes, n_ops)
        key_f = 1 if name == "table_lookup" else args[0].shape[0]
        key = f"{name} F={key_f} S={S}"
        row = dict(phase=phase, name=name,
                   shape=f"{label} N={args[1].shape[1]}",
                   route="cuda", source=SOURCE, replaces=REPLACES[name],
                   launches=None, max_abs_err=err, tolerance=tol, ok=ok,
                   rel_err=acc["rel_err"],
                   plain_rel_err=acc["plain_rel_err"],
                   ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                   library_ms=library_ms, path=path, earlier_ms=earlier_ms,
                   sort_ms=sort_ms, sort_share=sort_ms and sort_ms / ms,
                   smem_floor_ms=n_adds and smem_floor_ms(n_adds),
                   copy_ms=copy_ms, moved_bytes=moved,
                   check_s=check_s, timing_s=time.perf_counter() - t_timing,
                   key=capture_key(key, name, args, kw)
                   if phase in ("workflow", "titanic", "wide", "events",
                                "regression", "multiclass", "iris", "fused",
                                "text", "stream")
                   else key)
        log(f"kernel {name} [{row['shape']}]: err={err:.3g} ok={ok} "
            f"rel_err={acc['rel_err']} plain_rel_err={acc['plain_rel_err']} "
            f"ms={ms:.4f} earlier_ms={earlier_ms} ({path} vs rows) "
            f"sort_ms={sort_ms} sort_share={row['sort_share']} "
            f"plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} ({b_by}) "
            f"smem_floor_ms={row['smem_floor_ms']} copy_ms={copy_ms} "
            f"library_ms={library_ms} check_s={check_s:.2f} "
            f"timing_s={row['timing_s']:.2f}")
        rows_out.append(row)
        torch.cuda.empty_cache()
    return rows_out


BINCOUNT_WEIGHT_BYTES = 40e9   # expanded bincount weights held at once


def _bincount_hist(Xb_t, pay, F, B, lanes, n_slots, slot=None,
                   derive_count=False):
    """One torch.bincount per (lane, channel) over precomputed (slot,
    feature, bin) ids — the library yardstick for the histogram kernel
    (the ids and weights are built outside the timed call, the weights
    inside it where they would pass BINCOUNT_WEIGHT_BYTES)."""
    import torch
    N = Xb_t.shape[1]
    C = pay.shape[0] // lanes
    base = torch.arange(F, device=Xb_t.device)[:, None] * B + Xb_t.long()
    if slot is not None:
        base = base + slot.long() * (F * B)
    ids = base.reshape(-1)
    chans = [pay[k * C + c] for k in range(lanes) for c in range(C)]
    if derive_count:
        chans += [(pay[k * C + C - 1] > 0).float() for k in range(lanes)]
    size = n_slots * F * B
    if len(chans) * ids.numel() * 4 > BINCOUNT_WEIGHT_BYTES:
        # too many lanes to hold every expanded weight at once (a fused
        # sweep's 40): each is expanded inside the call, just before its
        # bincount (a copy of F x N floats beside a bincount over them)
        def run_lazy():
            return [torch.bincount(ids, weights=c.expand(F, N).reshape(-1),
                                   minlength=size) for c in chans]
        return run_lazy
    weights = [c.expand(F, N).reshape(-1) for c in chans]

    def run():
        return [torch.bincount(ids, weights=w, minlength=size)
                for w in weights]
    return run


def make_data(rows: int, seed: int, n_feat: int = 64, dev: str = "cuda",
              missing: bool = True):
    """Seeded binary data on the device: a nonlinear label and, with
    `missing`, random missing values in a few columns and values missing
    when large in one (so the missing bin and the learned missing
    direction carry signal). The GLM phases take the data without missing
    values: logistic regression has no rule for NaN."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    X = torch.randn((rows, n_feat), generator=gen, device=dev)
    beta = torch.randn((8,), generator=gen, device=dev)
    logit = (X[:, :8] @ beta * 0.6 + 0.8 * X[:, 8] * X[:, 9]
             + torch.sin(2.0 * X[:, 10]) + 1.2 * (X[:, 12] > 1.0).float()
             - 1.0)
    y = (torch.rand((rows,), generator=gen, device=dev)
         < torch.sigmoid(logit)).float()
    if not missing:
        return X, y
    for j in range(4):
        X[torch.rand((rows,), generator=gen, device=dev) < 0.05, j] = \
            float("nan")
    X[X[:, 12] > 1.5, 12] = float("nan")
    return X, y


def small_phase(seed: int):
    """The same sweep on a small input, CPU plain versions vs GPU kernels."""
    import torch
    from transmogrifai_tpu_torch.automl.tuning.validators import \
        CrossValidation
    from transmogrifai_tpu_torch.evaluators.evaluators import Evaluators
    from transmogrifai_tpu_torch.models.trees import OpXGBoostClassifier

    X, y = make_data(20_000, seed + 1, n_feat=16)
    grids = [dict(g, num_round=4) for g in XGB_GRID[::4]]
    out = {}
    for dev in ("cpu", "cuda"):
        cv = CrossValidation(Evaluators.BinaryClassification.au_pr(),
                             num_folds=3, device=dev)
        best = cv.validate([(OpXGBoostClassifier(device=dev), grids)],
                           X.to(dev), y.to(dev))
        out[dev] = best
    torch.cuda.synchronize()
    diffs = [abs(a.mean_metric - b.mean_metric)
             for a, b in zip(out["cpu"].validated, out["cuda"].validated)]
    same = out["cpu"].best_grid == out["cuda"].best_grid
    log(f"small: winner cpu={out['cpu'].best_grid} cuda={out['cuda'].best_grid}"
        f" max |dAuPR|={max(diffs):.3g}")
    return same and max(diffs) < 5e-3, max(diffs)


def main_phase(rows: int, n_configs: int, seed: int, dev=None):
    import torch
    from transmogrifai_tpu_torch.automl.tuning.validators import \
        CrossValidation
    from transmogrifai_tpu_torch.evaluators.evaluators import Evaluators
    from transmogrifai_tpu_torch.models.trees import OpXGBoostClassifier
    from transmogrifai_tpu_torch.ops import metrics_ops as M
    from transmogrifai_tpu_torch.ops import tree_kernels as TK

    t0 = time.perf_counter()
    X, y = make_data(rows, seed, dev=dev or "cuda")
    torch.cuda.synchronize()
    prevalence = float(y.mean())
    log(f"main: data {rows} x {X.shape[1]} made in "
        f"{time.perf_counter() - t0:.2f}s, prevalence {prevalence:.4f}")
    grids = XGB_GRID[:n_configs]
    cv = CrossValidation(Evaluators.BinaryClassification.au_pr(),
                         num_folds=5, device=dev)
    torch.cuda.reset_peak_memory_stats()
    TK.reset_launches()
    t0 = time.perf_counter()
    best = cv.validate([(OpXGBoostClassifier(device=dev), grids)], X, y)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    model = best.estimator.fit_arrays(X, y)
    torch.cuda.synchronize()
    refit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pred, raw, prob = model.predict_arrays(X)
    score_s = time.perf_counter() - t0
    launches = dict(TK.launches)
    shape_launches = dict(TK.shape_launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    train_aupr = float(M.au_pr(torch.as_tensor(prob[:, 1], device=y.device),
                               y))
    res = dict(rows=rows, features=int(X.shape[1]), folds=5,
               configs=len(grids), sweep_s=sweep_s, refit_s=refit_s,
               score_s=score_s, winner=best.best_grid,
               winner_cv_aupr=best.best_metric, refit_train_aupr=train_aupr,
               prevalence=prevalence, peak_mem_gb=peak_gb,
               launches=launches, shape_launches=shape_launches,
               cells={json.dumps(v.grid, sort_keys=True): v.mean_metric
                      for v in best.validated})
    log("main: " + json.dumps(res))
    # the last level's route and the leaf lookup of every depth swept
    depths = {g["max_depth"] for g in grids}
    shapes = ([f"route F={X.shape[1]} S={1 << (dp - 1)}" for dp in depths]
              + [f"table_lookup F=1 S={1 << dp}" for dp in depths])
    ok = (all(n > 0 for n in launches.values())
          and all(shape_launches.get(k, 0) > 0 for k in shapes)
          and prob.shape == (rows, 2) and raw.shape == (rows, 2)
          and pred.shape == (rows,)
          and bool(torch.isfinite(torch.as_tensor(prob)).all())
          and best.best_metric > prevalence + 0.1
          and train_aupr > prevalence + 0.1)
    return ok, launches, shape_launches, (X, y, best.best_grid,
                                          dict(res, validated=best.validated))


def device_time(prof):
    """(busy ms, {name: (ms, records)}) from the profiler's device records
    (kernels, copies, fills): busy is the union of their intervals on the
    card, so nested or overlapping records count once. The sums of
    `key_averages()`' self device times count an aten op and the kernels
    it launched both. CUPTI's "Command Buffer Full" records (the host
    waiting on a full launch queue) are not device work."""
    from torch.autograd import DeviceType
    spans, per = [], {}
    for ev in prof.events():
        if (ev.device_type != DeviceType.CUDA
                or "Command Buffer Full" in ev.name):
            continue
        a, b = ev.time_range.start, ev.time_range.end
        spans.append((a, b))
        ms, n = per.get(ev.name, (0.0, 0))
        per[ev.name] = (ms + (b - a) / 1e3, n + 1)
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3, per


def profile_phase(X, y, grid) -> bool:
    """Where one sweep cell's time goes: the winner's 5-fold cell (fit of
    all folds + fold metrics) once unprofiled and warm, then under
    torch.profiler: device time by kernel and the device's busy share of
    the cell's wall (the profiler's host overhead lowers that share).
    False when the profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from transmogrifai_tpu_torch.automl.tuning.validators import \
        CrossValidation
    from transmogrifai_tpu_torch.evaluators.evaluators import Evaluators
    from transmogrifai_tpu_torch.models.trees import OpXGBoostClassifier
    from transmogrifai_tpu_torch.ops import tree_kernels as TK

    cv = CrossValidation(Evaluators.BinaryClassification.au_pr(),
                         num_folds=5)

    def cell():
        cv.validate([(OpXGBoostClassifier(), [dict(grid)])], X, y)
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    cell()
    warm_s = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        cell()
        prof_s = time.perf_counter() - t0
    busy, per = device_time(prof)
    top = sorted(per.items(), key=lambda kv: -kv[1][0])[:12]
    ours = sorted((kv for kv in per.items()
                   if re.search(r"(hist|route|lookup)\w*_kernel", kv[0])),
                  key=lambda kv: -kv[1][0])
    fit_bytes = TK.fused_fit_bytes(X.shape[0], X.shape[1], 5,
                                   grid["max_depth"], grid["num_round"])
    log("profile: " + json.dumps(dict(
        cell=grid, warm_wall_s=warm_s, profiled_wall_s=prof_s,
        device_busy_ms=busy, busy_share=busy / (prof_s * 1e3),
        fit_bytes=fit_bytes, fit_bound_ms=bound(fit_bytes, 0)[0],
        top=[dict(kernel=k[:80], ms=ms, calls=n, share=ms / busy)
             for k, (ms, n) in top],
        port_kernels=[dict(kernel=k[:80], ms=ms, calls=n, share=ms / busy)
                      for k, (ms, n) in ours])))
    return busy > 0


TEL_KEYS = ("glm_rounds", "data_passes", "lane_passes", "active_per_round",
            "iters_per_round", "lanes_retired", "lanes_at_cap")


def _glm_estimators(dev):
    from transmogrifai_tpu_torch.models.glm import (OpLinearSVC,
                                                    OpLogisticRegression)
    return [(OpLogisticRegression(max_iter=30, device=dev), glm_grid(4)),
            (OpLinearSVC(max_iter=30, device=dev),
             [{"reg_param": g["reg_param"]} for g in glm_grid(4)[::3]])]


def glm_small_phase(seed: int) -> bool:
    """One GLM sweep (LR 12 grids + SVC 4 grids, 5 folds, 16 features) on
    the CPU (plain versions) and on the card, at 200 000 rows (streamed
    route) and at 50 000 (vmapped route): the same winner, route labels
    and retirement telemetry, every fold metric within 1e-4 (f32 sums in
    another order inside Newton solves with tol 1e-6)."""
    import torch
    from transmogrifai_tpu_torch.automl.tuning.validators import \
        CrossValidation
    from transmogrifai_tpu_torch.evaluators.evaluators import Evaluators
    from transmogrifai_tpu_torch.ops import glm_sweep as GS

    ok = True
    for rows, route in ((200_000, "streamed"), (50_000, "vmapped")):
        X, y = make_data(rows, seed + 2, n_feat=16, missing=False)
        out = {}
        for dev in ("cpu", "cuda"):
            infos = []
            driver = GS.sweep_glm_streamed_rounds

            def recording(*a, **k):
                res = driver(*a, **k)
                infos.append({t: res[2][t] for t in TEL_KEYS})
                return res
            GS.sweep_glm_streamed_rounds = recording
            try:
                t0 = time.perf_counter()
                cv = CrossValidation(Evaluators.BinaryClassification.au_pr(),
                                     num_folds=5, device=dev)
                best = cv.validate(_glm_estimators(dev), X.to(dev), y.to(dev))
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            finally:
                GS.sweep_glm_streamed_rounds = driver
            out[dev] = (best, infos, wall)
        (cb, ci, cw), (gb, gi, gw) = out["cpu"], out["cuda"]
        diff = max(abs(a - b) for va, vb in zip(cb.validated, gb.validated)
                   for a, b in zip(va.fold_metrics, vb.fold_metrics))
        routes = {v.route for v in cb.validated + gb.validated}
        same = (cb.name == gb.name and cb.best_grid == gb.best_grid
                and routes == {route} and ci == gi
                and len(gi) == (2 if route == "streamed" else 0)
                and [v.grid for v in cb.validated]
                == [v.grid for v in gb.validated])
        log(f"glm-small {route} {rows} rows: winner cpu={cb.name} "
            f"{cb.best_grid} cuda={gb.name} {gb.best_grid}; routes {routes}; "
            f"max |dAuPR| {diff:.3g}; telemetry cpu={ci} cuda={gi}; "
            f"wall cpu {cw:.2f}s cuda {gw:.2f}s")
        ok = ok and same and diff <= 1e-4
    return ok


def glm_main_phase(rows: int, seed: int):
    """The BASELINE sweep's GLM half at full width, then the refit of the
    winner and its scoring. Returns (ok, shape launches, (X, y))."""
    import torch
    from transmogrifai_tpu_torch.automl.tuning.validators import \
        CrossValidation
    from transmogrifai_tpu_torch.evaluators.evaluators import Evaluators
    from transmogrifai_tpu_torch.models.glm import OpLogisticRegression
    from transmogrifai_tpu_torch.ops import metrics_ops as M
    from transmogrifai_tpu_torch.ops import tree_kernels as TK

    X, y = make_data(rows, seed, missing=False)
    torch.cuda.synchronize()
    prevalence = float(y.mean())
    n, d = X.shape
    cv = CrossValidation(Evaluators.BinaryClassification.au_pr(),
                         num_folds=5)
    lr = OpLogisticRegression(max_iter=15, standardization=False)
    torch.cuda.reset_peak_memory_stats()
    TK.reset_launches()
    t0 = time.perf_counter()
    best = cv.validate([(lr, glm_grid())], X, y)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    shape_launches = dict(TK.shape_launches)
    tel = cv.last_streamed_telemetry
    t0 = time.perf_counter()
    model = best.estimator.fit_arrays(X, y)
    torch.cuda.synchronize()
    refit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pred, raw, prob = model.predict_arrays(X)
    score_s = time.perf_counter() - t0
    refit_aupr = float(M.au_pr(torch.as_tensor(prob[:, 1], device=y.device),
                               y))
    # bench.py's streamed FLOP model: eta 2nd + gradient 2nd + the full
    # weighted Gram 2nd^2 per executed lane pass
    flops = (4 * n * d + 2 * n * d * d) * tel["padded_lane_passes"]
    res = dict(rows=n, features=d, folds=5, grids=len(best.validated),
               sweep_s=sweep_s, refit_s=refit_s, score_s=score_s,
               route=best.validated[0].route,
               telemetry={k: tel[k] for k in (
                   "route", "kernel", "lanes_total", "glm_rounds",
                   "data_passes", "lane_passes", "padded_lane_passes",
                   "lanes_retired", "lanes_at_cap", "active_per_round",
                   "iters_per_round", "warm_start")},
               executed_flops=flops,
               flop_share=flops / sweep_s / FP32_OPS_PER_S,
               winner=best.best_grid, winner_cv_aupr=best.best_metric,
               refit_aupr=refit_aupr, prevalence=prevalence,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               launches=dict(TK.launches))
    log("glm-main: " + json.dumps(res))
    key = f"hist_folds F=1 S={GLM_EVAL_LANES}"
    ok = (res["route"] == "streamed" and tel["kernel"] == "rounds"
          and tel["lanes_total"] == 240 and shape_launches.get(key, 0) > 0
          and prob.shape == (n, 2) and pred.shape == (n,)
          and bool(torch.isfinite(torch.as_tensor(raw)).all())
          and best.best_metric > prevalence + 0.05
          and refit_aupr > prevalence + 0.05)
    return ok, shape_launches, (X, y)


def baseline_phase(X, y) -> bool:
    """One validate over the 48 LR grids and the 16 XGBoost configs: the
    port's whole BASELINE sweep, wall and winner."""
    import torch
    from transmogrifai_tpu_torch.automl.tuning.validators import \
        CrossValidation
    from transmogrifai_tpu_torch.evaluators.evaluators import Evaluators
    from transmogrifai_tpu_torch.models.glm import OpLogisticRegression
    from transmogrifai_tpu_torch.models.trees import OpXGBoostClassifier

    cv = CrossValidation(Evaluators.BinaryClassification.au_pr(),
                         num_folds=5)
    t0 = time.perf_counter()
    best = cv.validate([
        (OpLogisticRegression(max_iter=15, standardization=False),
         glm_grid()),
        (OpXGBoostClassifier(), [dict(g) for g in XGB_GRID])], X, y)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    by_family = {}
    for v in best.validated:
        top = by_family.get(v.model_name)
        if top is None or v.mean_metric > top[1]:
            by_family[v.model_name] = (v.grid, v.mean_metric)
    routes = [v.route for v in best.validated]
    res = dict(
        rows=X.shape[0], features=X.shape[1], folds=5, cells=len(routes),
        wall_s=wall, winner=best.name, winner_grid=best.best_grid,
        winner_cv_aupr=best.best_metric, best_by_family=by_family,
        family_walls_s=dict(cv.family_walls),
        routes={r: routes.count(r) for r in set(routes)})
    log("baseline: " + json.dumps(res))
    ok = (routes.count("streamed") == 48 and routes.count("mask_folds") == 16
          and all(v.mean_metric == v.mean_metric for v in best.validated))
    return ok, dict(res, validated=best.validated)


def glm_profile_phase(X, y) -> bool:
    """One round of the streamed route (all 240 lanes from zero, 5 Newton
    iterations, as the driver runs a round) under torch.profiler: the
    device's busy share of the round's wall and the top operations.
    False when the profiler saw no device time."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from transmogrifai_tpu_torch.automl.tuning.validators import \
        CrossValidation
    from transmogrifai_tpu_torch.evaluators.evaluators import Evaluators
    from transmogrifai_tpu_torch.ops import glm_sweep as GS

    cv = CrossValidation(Evaluators.BinaryClassification.au_pr(),
                         num_folds=5)
    masks = torch.as_tensor(cv.fold_masks(y.cpu().numpy()), device=X.device)
    w = torch.ones_like(y)
    grid = glm_grid()
    regs = np.array([g["reg_param"] for g in grid], np.float32)
    alphas = np.array([g["elastic_net_param"] for g in grid], np.float32)
    F, Gn = masks.shape[0], len(grid)
    L = F * Gn
    sel = torch.repeat_interleave(torch.eye(F, device=X.device), Gn, dim=1)
    l1 = torch.as_tensor(np.tile(regs * alphas, F), device=X.device)
    l2 = torch.as_tensor(np.tile(regs * (1 - alphas), F), device=X.device)
    B0 = torch.zeros((L, X.shape[1]), device=X.device)
    b00 = torch.zeros(L, device=X.device)

    def one_round():
        out = GS.sweep_glm_round(X, y, w, masks, sel, l1, l2, B0, b00, None,
                                 None, GS.ROUND_ITERS_DEFAULT, 1e-6,
                                 loss="logistic")
        torch.cuda.synchronize()
        return out
    t0 = time.perf_counter()
    one_round()
    warm_s = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, _, _, iters = one_round()
        prof_s = time.perf_counter() - t0
    busy, per = device_time(prof)
    top = sorted(per.items(), key=lambda kv: -kv[1][0])[:12]
    n, d = X.shape
    flops = (4 * n * d + 2 * n * d * d) * L * iters
    log("glm-profile: " + json.dumps(dict(
        lanes=L, iterations=iters, warm_wall_s=warm_s,
        profiled_wall_s=prof_s, device_busy_ms=busy,
        busy_share=busy / (prof_s * 1e3), flops=flops,
        flop_share_of_warm_wall=flops / warm_s / FP32_OPS_PER_S,
        top=[dict(op=k[:80], ms=ms, calls=c, share=ms / busy)
             for k, (ms, c) in top])))
    return busy > 0


# a fused sweep's fold metric against the same cell of the per-config
# sweep: the card-against-card bound of the boosted fold metrics
# (workflow-regression's and workflow-multiclass's legs); beyond it, the
# first node the two fits split apart must be a tie (`split_witness`)
FUSED_CELL_TOL = 1e-3
# the best CV AuPR of the bf16 BASELINE sweep against the f32 one
# (BASELINE.md: the device-against-host parity bound)
BF16_BEST_TOL = 1e-3
# lanes of each fused fit: a depth's 8 configs x 5 folds
FUSED_LANES = 40


@contextlib.contextmanager
def grid_fuse_on():
    """TMOG_GRID_FUSE=1 inside the block only."""
    was = os.environ.get("TMOG_GRID_FUSE")
    os.environ["TMOG_GRID_FUSE"] = "1"
    try:
        yield
    finally:
        if was is None:
            del os.environ["TMOG_GRID_FUSE"]
        else:
            os.environ["TMOG_GRID_FUSE"] = was


@contextlib.contextmanager
def record_plans(store: list):
    """Inside the block, every answer of the lane planner
    (`TK.plan_lane_chunk`) is appended to `store`."""
    from transmogrifai_tpu_torch.ops import tree_kernels as TK
    original = TK.plan_lane_chunk

    def planning(n_feat, n_bins, n_folds, n_configs, depth, n_rows, **kw):
        chunk = original(n_feat, n_bins, n_folds, n_configs, depth, n_rows,
                         **kw)
        store.append(dict(configs=n_configs, folds=n_folds, depth=depth,
                          rows=n_rows, chunk=chunk, lanes=chunk * n_folds))
        return chunk
    TK.plan_lane_chunk = planning
    try:
        yield store
    finally:
        TK.plan_lane_chunk = original


def cut_rows(name: str, args: tuple, kw: dict, n: int):
    """(args, kwargs) of a kernel launch on its first `n` rows: contiguous
    copies of every operand with a row axis, the split and leaf tables as
    they are."""
    axis = {"hist_folds": (0, 1, 2), "route_hist": (0, 1, 2),
            "route": (0, 1), "table_lookup": (1,)}[name]
    args = tuple(a[:, :n].contiguous() if i in axis else a
                 for i, a in enumerate(args))
    kw = dict(kw)
    if kw.get("xb_rows") is not None:
        kw["xb_rows"] = kw["xb_rows"][:n].contiguous()
    return args, kw


def fused_cell_witnesses(ctx, y, w, masks, group: list, cells: list,
                         depth: int) -> list:
    """Why each (config index, fold) of `cells`, configs of one fused
    `group`, scores otherwise than its per-config fit: the group's fused
    fit and each such config's own fit again with every lane's levels
    recorded, and the first node of that fold's tree where they split
    apart (`first_divergence`) with its `split_witness`; {"divergence":
    None, "tie": False} where the trees agree."""
    from transmogrifai_tpu_torch.models.trees import OpXGBoostClassifier
    est = OpXGBoostClassifier()
    with record_refit_levels([], all_lanes=True) as fused:
        est.mask_fit_scores_grid(ctx, y, w, masks, group)
    names = [f"x{j}" for j in range(ctx[0].shape[1])]
    out = []
    for ci in sorted({c for c, _ in cells}):
        with record_refit_levels([], all_lanes=True) as per:
            est.copy(**group[ci]).mask_fit_scores(ctx, y, w, masks)
        for fold in sorted(f for c, f in cells if c == ci):
            a = [r for r in per if r["lane"] == fold]
            b = [r for r in fused if r["lane"] == fold * len(group) + ci]
            at = first_divergence(a, b)
            wit = (dict(divergence=None, tie=False) if at is None else
                   dict(divergence=list(at), **split_witness(
                       a, b, at[0], at[1], depth, names)))
            out.append(dict(grid=group[ci], fold=fold, **wit))
        del per
    return out


def fused_sweep_phase(rows: int, seed: int, main: dict):
    """tree-sweep-10M-fused: main_phase's sweep (the same X and y, 5 folds,
    the 16 XGBoost configs, 10 rounds, 32 bins) with TMOG_GRID_FUSE on, so
    that each depth's 8 configs fit as one fit of 40 lanes: the planner's
    chunks and lanes a launch, the wall beside main_phase's, peak device
    memory, launches by kernel and shape, each fold metric against
    main_phase's (FUSED_CELL_TOL, else a tie witness), the winner (the same
    or a tie within WINNER_TIE_TOL); then each fused launch shape (Fo = 40)
    captured from a one-round fit of each depth group, timed at the full
    rows and checked against its plain version on its first KERNEL_ROWS
    rows (the plain versions take seconds a call at 40 lanes x 10M rows).
    Returns (ok, launches by capture key, kernel rows)."""
    import torch
    from transmogrifai_tpu_torch.automl.tuning.validators import \
        CrossValidation
    from transmogrifai_tpu_torch.evaluators.evaluators import Evaluators
    from transmogrifai_tpu_torch.models.trees import OpXGBoostClassifier
    from transmogrifai_tpu_torch.ops import tree_kernels as TK
    from transmogrifai_tpu_torch.tools import fit_memory as FM
    from transmogrifai_tpu_torch.tools import hist_paths as HP

    t_phase = time.perf_counter()
    X, y = make_data(rows, seed)
    cv = CrossValidation(Evaluators.BinaryClassification.au_pr(),
                         num_folds=5)
    counts = collections.Counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    TK.reset_launches()
    with grid_fuse_on(), record_plans([]) as plans, \
            capture_kernel_inputs({}, counts, clone=False):
        t0 = time.perf_counter()
        best = cv.validate([(OpXGBoostClassifier(),
                             [dict(g) for g in XGB_GRID])], X, y)
        torch.cuda.synchronize()
        sweep_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches, shape_launches = dict(TK.launches), dict(TK.shape_launches)
    lanes = sorted({int(k.split("Fo=")[1]) for k in counts
                    if k.startswith(("route ", "route_hist", "table_lookup"))
                    or "C=3" in k})
    per = {json.dumps(v.grid, sort_keys=True): v
           for v in main["validated"]}
    cells, worst, beyond = {}, 0.0, []
    for v in best.validated:
        key = json.dumps(v.grid, sort_keys=True)
        gaps = [a - b for a, b in zip(v.fold_metrics,
                                      per[key].fold_metrics)]
        cells[key] = dict(fused=v.mean_metric, per_config=per[key].mean_metric,
                          fold_gaps=gaps, route=v.route)
        worst = max([worst] + [abs(g) for g in gaps])
        beyond += [(v.grid, f) for f, g in enumerate(gaps)
                   if abs(g) > FUSED_CELL_TOL]
    by_grid = {json.dumps(v.grid, sort_keys=True): v.mean_metric
               for v in best.validated}
    was = by_grid[json.dumps(main["winner"], sort_keys=True)]
    same_winner = best.best_grid == main["winner"]
    winner_ok = same_winner or best.best_metric - was <= WINNER_TIE_TOL
    res = dict(rows=rows, features=int(X.shape[1]), folds=5,
               configs=len(XGB_GRID), plans=plans, lanes_a_launch=lanes,
               sweep_s=sweep_s, per_config_sweep_s=main["sweep_s"],
               peak_mem_gb=peak_gb,
               per_config_peak_mem_gb=main["peak_mem_gb"],
               winner=best.best_grid, winner_cv_aupr=best.best_metric,
               per_config_winner=main["winner"],
               per_config_winner_cv_aupr=main["winner_cv_aupr"],
               same_winner=same_winner,
               per_config_winner_here=was, worst_fold_gap=worst,
               launches=launches, shape_launches=shape_launches,
               capture_launches=dict(counts), cells=cells)
    log("tree-sweep-10M-fused: " + json.dumps(res))

    # the kernels at the fused shapes, captured from one round of each
    # depth group on the sweep's own binned matrix and folds
    est = OpXGBoostClassifier()
    ctx = est.copy(max_bins=32).mask_sweep_context(X)
    w = torch.ones_like(y)
    masks = torch.as_tensor(cv.fold_masks(y.cpu().numpy()), device=X.device)
    groups = {d: [g for g in XGB_GRID if g["max_depth"] == d]
              for d in sorted({g["max_depth"] for g in XGB_GRID})}
    witnesses = []
    for d, group in groups.items():
        here = [(group.index(g), f) for g, f in beyond if g in group]
        if here:
            witnesses += fused_cell_witnesses(ctx, y, w, masks, group, here,
                                              d)
    for wit in witnesses:
        log(f"tree-sweep-10M-fused witness: {json.dumps(wit)}")
    captured = {}
    with grid_fuse_on(), capture_kernel_inputs(captured,
                                               collections.Counter()):
        for d, group in groups.items():
            est.mask_fit_scores_grid(ctx, y, w, masks,
                                     [dict(g, num_round=1) for g in group])
    torch.cuda.synchronize()
    keys = sorted(k for k in captured if k.endswith(f"Fo={FUSED_LANES}"))
    full_ms, shapes = {}, []
    for key in keys:
        name, args, kw = captured[key]
        full_ms[key] = HP.cuda_ms(
            lambda: getattr(TK, name)(*args, **kw), reps=5)
        cut, cut_kw = cut_rows(name, args, kw, KERNEL_ROWS)
        shapes.append(captured_shape(key, name, cut, cut_kw,
                                     prefix="tree-sweep-10M-fused"))
    del captured
    torch.cuda.empty_cache()
    # C5: the residency model of the lane planner against the fits' own
    # measured peaks, on the sweep's binned matrix, at 40 and 10 lanes
    t0 = time.perf_counter()
    c5 = [FM.measure(ctx, y, w, masks, depth=max(groups), chunk=c)
          for c in C5_CHUNKS]
    for r in c5:
        log("tree-sweep-10M-fused residency: " + json.dumps(r))
    log(f"tree-sweep-10M-fused residency: {time.perf_counter() - t0:.1f}s")
    c5_ok = all(1.0 <= r[k] <= C5_MAX_OVER for r in c5
                for k in ("model_over_fit_peak",
                          "group_model_over_group_peak"))
    del ctx, X, y, masks, w
    torch.cuda.empty_cache()
    kernel_out = kernel_rows(shapes, phase="fused")
    for r in kernel_out:
        r.update(full_rows=rows, full_rows_ms=full_ms[r["key"]],
                 check_rows=KERNEL_ROWS)
        log(f"kernel {r['name']} [{r['shape']}] at {rows} rows: "
            f"{r['full_rows_ms']:.4f} ms a launch")
    log(f"tree-sweep-10M-fused: phase {time.perf_counter() - t_phase:.1f}s")
    fused_routes = {c["route"] for c in cells.values()}
    ok = (fused_routes == {"mask_folds:grid_fused"} and c5_ok
          and lanes == [FUSED_LANES] and set(keys) == {r["key"] for r in kernel_out}
          and all(p["chunk"] == 8 for p in plans)
          and all(n > 0 for n in launches.values())
          and winner_ok
          and all(wi["tie"] for wi in witnesses))
    return ok, dict(counts), kernel_out


def baseline_bf16_phase(X, y, base: dict) -> bool:
    """baseline-bf16: baseline_phase's sweep (48 LR grids and 16 XGBoost
    configs in one validate) with sweep_dtype=torch.bfloat16 and fusion
    on, the BASELINE sweep as bench.py runs it on the TPU: wall, routes,
    winner, peak device memory, the bytes of the sweep's X against the
    f32 sweep's, each cell's gap to its f32 cell, and the best CV AuPR
    within BF16_BEST_TOL of the f32 sweep's."""
    import torch
    from transmogrifai_tpu_torch.automl.tuning.validators import \
        CrossValidation
    from transmogrifai_tpu_torch.evaluators.evaluators import Evaluators
    from transmogrifai_tpu_torch.models.glm import OpLogisticRegression
    from transmogrifai_tpu_torch.models.trees import OpXGBoostClassifier
    from transmogrifai_tpu_torch.ops import glm as G

    cv = CrossValidation(Evaluators.BinaryClassification.au_pr(),
                         num_folds=5, sweep_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with grid_fuse_on(), record_plans([]) as plans:
        t0 = time.perf_counter()
        best = cv.validate([
            (OpLogisticRegression(max_iter=15, standardization=False),
             glm_grid()),
            (OpXGBoostClassifier(), [dict(g) for g in XGB_GRID])], X, y)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    f32_cells = {(v.model_name, json.dumps(v.grid, sort_keys=True)): v
                 for v in base["validated"]}
    gaps = {}
    for v in best.validated:
        key = (v.model_name, json.dumps(v.grid, sort_keys=True))
        gaps[f"{key[0]} {key[1]}"] = v.mean_metric - f32_cells[key].mean_metric
    routes = [v.route for v in best.validated]
    res = dict(
        rows=X.shape[0], features=X.shape[1], folds=5, cells=len(routes),
        wall_s=wall, f32_wall_s=base["wall_s"],
        family_walls_s=dict(cv.family_walls),
        f32_family_walls_s=base["family_walls_s"], plans=plans,
        routes={r: routes.count(r) for r in set(routes)},
        winner=best.name, winner_grid=best.best_grid,
        winner_cv_aupr=best.best_metric,
        f32_winner=[base["winner"], base["winner_grid"]],
        f32_winner_cv_aupr=base["winner_cv_aupr"],
        best_gap=best.best_metric - base["winner_cv_aupr"],
        worst_cell_gap=max(abs(g) for g in gaps.values()),
        peak_mem_gb=peak_gb,
        x_bytes=X.numel() * torch.empty((), dtype=torch.bfloat16)
        .element_size(), f32_x_bytes=X.numel() * X.element_size(),
        out_dtype_product=bool(G._OUT_DTYPE.get(("cuda", "mm"))),
        cell_gaps=gaps)
    log("baseline-bf16: " + json.dumps(res))
    return (routes.count("streamed") == 48
            and routes.count("mask_folds:grid_fused") == 16
            and abs(res["best_gap"]) <= BF16_BEST_TOL
            and all(v.mean_metric == v.mean_metric for v in best.validated))


def titanic_records(n: int, seed: int):
    """Seeded titanic-shaped records (dicts, as a reader yields them):
    Reals with None, Integrals, a Binary with None, two PickLists, one
    MultiPickList and the survival label."""
    import numpy as np
    rng = np.random.default_rng(seed)
    female = rng.uniform(size=n) < 0.35
    pclass = rng.choice([1, 2, 3], p=[0.24, 0.21, 0.55], size=n)
    age = np.clip(rng.normal(29, 14, size=n), 0.4, 80)
    age_missing = rng.uniform(size=n) < 0.2
    sibsp, parch = rng.poisson(0.5, size=n), rng.poisson(0.4, size=n)
    fare = np.clip(rng.lognormal(3.6 - 0.5 * (pclass - 1), 0.6), 4, 512)
    embarked = rng.choice(["S", "C", "Q"], p=[0.72, 0.19, 0.09], size=n)
    embarked_missing = rng.uniform(size=n) < 0.02
    alone_missing = rng.uniform(size=n) < 0.05
    deck = rng.uniform(size=(n, 5)) < 0.08
    child = ~age_missing & (age < 12)
    # the interactions (children, women outside third class, large
    # families) give the trees a clear lead over the linear grid points
    logit = (3.0 * female * (pclass < 3) + 0.8 * female * (pclass == 3)
             + 2.5 * child - 0.9 * (pclass - 2) + 0.004 * fare
             - 2.0 * (sibsp + parch > 3) - 1.0)
    y = rng.uniform(size=n) < 1 / (1 + np.exp(-logit))
    return [{"survived": float(y[i]),
             "sex": "female" if female[i] else "male",
             "pClass": int(pclass[i]),
             "age": None if age_missing[i] else float(age[i]),
             "sibSp": int(sibsp[i]), "parCh": int(parch[i]),
             "fare": float(fare[i]),
             "embarked": None if embarked_missing[i] else str(embarked[i]),
             "alone": None if alone_missing[i]
             else bool(sibsp[i] + parch[i] == 0),
             "cabinDeck": {"ABCDE"[k] for k in np.flatnonzero(deck[i])}}
            for i in range(n)]


_SYLLABLES = ["an", "ber", "cal", "dor", "el", "fin", "gar", "hol", "is",
              "jor", "kel", "lin", "mar", "nor", "ol", "per", "quin", "ros",
              "son", "tar", "ul", "ven", "wick", "yng", "zel"]
_NON_ASCII_SURNAMES = ["Müller", "Nørgaard", "Šimić", "Ødegård", "Çelik",
                       "Ångström", "Ñúñez", "Dvořák", "Łukasz", "Öztürk"]
_GIVEN = {True: ["Mary", "Anna", "Elizabeth", "Margaret", "Helen", "Alice",
                 "Ellen", "Edith", "Bertha", "Laina", "Jane", "Ida", "Emily",
                 "Agnes", "Marie", "Hélène", "Zoë"],
          False: ["John", "William", "James", "Charles", "George", "Thomas",
                  "Owen", "Henry", "Edward", "Arthur", "Karl", "Johan",
                  "Frank", "Ernst", "Patrick", "José", "Jörgen"]}
_TITLES = {True: (["Miss", "Mrs", "Ms", "Mme", "Lady"],
                  [0.45, 0.5, 0.02, 0.02, 0.01]),
           False: (["Mr", "Master", "Dr", "Rev", "Col"],
                   [0.88, 0.08, 0.02, 0.01, 0.01])}


def titanic_named_records(n: int, seed: int):
    """Seeded records in the Kaggle Titanic shapes (the fields of
    PASSENGER_COLUMNS in the port's example): `name` as "Surname, Title.
    Given Names" from seeded word lists (4 000 surnames, and 3% of rows
    non-ASCII ones), so its cardinality is far above 30 and its tokens
    fill the 512 hash bins; `ticket`
    of high cardinality (30% share 300 family tickets, the rest are
    unique) in the Kaggle forms ("347082", "PC 17599", "A/5 21171"); `cabin`
    empty for 77% of rows, else deck and number; `embarked` with 0.2%
    empty; 20% of ages missing. Survival depends on sex (through the
    title), class, childhood, fare and family size."""
    import numpy as np
    rng = np.random.default_rng(seed)
    surnames = [(a + b + c).capitalize() for a in _SYLLABLES
                 for b in _SYLLABLES for c in ("",) + tuple(_SYLLABLES)]
    surnames = [surnames[i] for i in rng.permutation(len(surnames))[:4000]]
    female = rng.uniform(size=n) < 0.35
    pclass = rng.choice([1, 2, 3], p=[0.24, 0.21, 0.55], size=n)
    age = np.clip(rng.normal(29, 14, size=n), 0.4, 80)
    age_missing = rng.uniform(size=n) < 0.2
    sibsp, parch = rng.poisson(0.5, size=n), rng.poisson(0.4, size=n)
    fare = np.round(np.clip(rng.lognormal(3.6 - 0.5 * (pclass - 1), 0.6),
                            4, 512), 4)
    embarked = rng.choice(["S", "C", "Q"], p=[0.72, 0.19, 0.09], size=n)
    embarked_missing = rng.uniform(size=n) < 0.002
    sur = rng.integers(0, len(surnames), size=n)
    foreign = rng.uniform(size=n) < 0.03
    foreign_name = rng.integers(0, len(_NON_ASCII_SURNAMES), size=n)
    g1, g2 = rng.integers(0, 17, size=n), rng.integers(0, 17, size=n)
    two_given = rng.uniform(size=n) < 0.5
    title_no = {f: rng.choice(len(t), p=p, size=n)
                for f, (t, p) in _TITLES.items()}
    family_ticket = rng.uniform(size=n) < 0.3
    ticket_no = np.where(family_ticket, rng.integers(0, 300, size=n),
                         rng.integers(300, 4_000_000, size=n))
    prefix = rng.choice(["", "PC ", "A/5 ", "STON/O2. ", "CA. ", "SC/Paris "],
                        p=[0.7, 0.1, 0.06, 0.05, 0.05, 0.04], size=n)
    has_cabin = rng.uniform(size=n) < 0.23
    deck = rng.choice(list("ABCDEFG"), size=n)
    cabin_no = rng.integers(1, 150, size=n)
    child = ~age_missing & (age < 12)
    logit = (3.0 * female * (pclass < 3) + 0.8 * female * (pclass == 3)
             + 2.5 * child - 0.9 * (pclass - 2) + 0.004 * fare
             - 2.0 * (sibsp + parch > 3) + 0.4 * has_cabin - 1.0)
    y = rng.uniform(size=n) < 1 / (1 + np.exp(-logit))
    out = []
    for i in range(n):
        f = bool(female[i])
        title = "Master" if child[i] and not f \
            else _TITLES[f][0][title_no[f][i]]
        given = _GIVEN[f][g1[i]] + (" " + _GIVEN[f][g2[i]]
                                    if two_given[i] else "")
        last = (_NON_ASCII_SURNAMES[foreign_name[i]] if foreign[i]
                else surnames[sur[i]])
        out.append({
            "id": i + 1, "survived": float(y[i]), "pClass": int(pclass[i]),
            "name": f"{last}, {title}. {given}",
            "sex": "female" if f else "male",
            "age": None if age_missing[i] else float(round(age[i], 1)),
            "sibSp": int(sibsp[i]), "parCh": int(parch[i]),
            "ticket": f"{prefix[i]}{int(ticket_no[i])}",
            "fare": float(fare[i]),
            "cabin": f"{deck[i]}{int(cabin_no[i])}" if has_cabin[i]
            else None,
            "embarked": None if embarked_missing[i] else str(embarked[i])})
    return out


WIDE_REFERENCE_MS = 1_501_000_000_000   # the date vectorizers' "now"
_TLDS = ["com", "org", "net", "io", "co.uk", "de"]
_MIME_HEADS = [b"\x89PNG\r\n\x1a\n", b"%PDF-1.7\n", b"GIF89a", b'{"id": ',
               b"PK\x03\x04"]


def _object_array(values) -> "object":
    import numpy as np
    out = np.empty(len(values), dtype=object)
    for i, v in enumerate(values):
        out[i] = v
    return out


def wide_columns(n: int, seed: int) -> dict:
    """bench.py's wide schema (`make_wide_rows`: PickLists plA of 50 and plB
    of 12 categories, a Text txt of 5 words over 7 with n/100 distinct
    texts, Reals r1 and r2 with 10% missing, a Date dt = 1.5e12 + [0, 1e9)
    ms, a RealMap mp of keys k0 and k1) and one seeded feature of each
    other group of the date, map, geolocation and structured text slice:
    an Email (~20 000 local parts over ~200 domains, 5% invalid, 5%
    empty), a URL (http, https and ftp over ~300 domains, 5% invalid), a
    Phone (US, GB and DE numbers with and without +cc, ~10% invalid), a
    Base64 (PNG, PDF, GIF, JSON and ZIP headers and random bytes, 20%
    empty), a Geolocation (10% missing), a DateList of 0-5 dates, a
    PickListMap of 3 keys and a DateMap of 2 keys; the RealNN label is a
    seeded logistic of r1, dt's hour of day, mp's k0, the email domain's
    group and the phone's validity. Returns {name: (feature type name,
    numpy column: float64 with NaN, or objects)}."""
    import base64
    import numpy as np
    rng = np.random.default_rng(seed)
    words = ["alpha", "beta", "gamma", "delta", "omega", "sigma", "tau"]
    cats_a = np.array([f"cat{i}" for i in range(50)], dtype=object)
    cats_b = np.array([f"seg{i}" for i in range(12)], dtype=object)
    n_txt = max(n // 100, 1)
    texts = np.array([" ".join(rng.choice(words, size=5))
                      for _ in range(n_txt)], dtype=object)
    r1 = rng.normal(size=n)
    r2 = np.where(rng.uniform(size=n) < 0.1, np.nan, rng.normal(size=n))
    dt = (1_500_000_000_000 + rng.integers(0, 10**9, size=n)) \
        .astype(np.float64)
    k0, k1 = rng.normal(size=n), rng.normal(size=n)

    syl = _SYLLABLES
    locals_ = np.array(sorted({
        f"{syl[a]}{syl[b]}.{syl[c]}{d}" for a, b, c, d in zip(
            *(rng.integers(0, 25, 30_000) for _ in range(3)),
            rng.integers(0, 100, 30_000))})[:20_000], dtype=object)
    domains = [f"{syl[a]}{syl[b]}{syl[c]}.{_TLDS[t]}" for a, b, c, t in zip(
        *(rng.integers(0, 25, 200) for _ in range(3)),
        rng.integers(0, len(_TLDS), 200))]
    dom = rng.integers(0, 200, n)
    dom_group = dom % 4          # the label's signal
    em_u = rng.uniform(size=n).tolist()
    em_local = locals_[rng.integers(0, len(locals_), n)].tolist()
    email = [None if u < 0.05 else
             f"{lo}-at-{domains[d]}" if u < 0.08 else
             f"{lo}@" if u < 0.10 else f"{lo}@{domains[d]}"
             for u, lo, d in zip(em_u, em_local, dom.tolist())]

    url_domains = [f"www.{syl[a]}{syl[b]}.{_TLDS[t]}" for a, b, t in zip(
        rng.integers(0, 25, 300), rng.integers(0, 25, 300),
        rng.integers(0, len(_TLDS), 300))]
    schemes = rng.choice(["http", "https", "ftp"], p=[0.3, 0.6, 0.1],
                         size=n).tolist()
    ud, up, uu = (rng.integers(0, 300, n).tolist(),
                  rng.integers(0, 50, n).tolist(), rng.uniform(size=n))
    url = [None if u < 0.05 else
           f"{url_domains[d]}/page{p}" if u < 0.08 else
           f"mailto:{url_domains[d]}" if u < 0.10 else
           f"{s}://{url_domains[d]}/page{p}"
           for u, s, d, p in zip(uu.tolist(), schemes, ud, up)]

    kind = rng.choice(7, p=[0.3, 0.15, 0.15, 0.1, 0.1, 0.1, 0.1], size=n)
    a3, b3, c4 = (rng.integers(200, 1000, n).tolist(),
                  rng.integers(200, 1000, n).tolist(),
                  rng.integers(0, 10_000, n).tolist())
    g8 = rng.integers(10**7, 10**8, n).tolist()
    d8 = rng.integers(10**6, 10**8, n).tolist()
    phone_valid = kind < 6
    phone_missing = rng.uniform(size=n) < 0.05
    forms = [
        "({a}) {b}-{c:04d}", "+1 {a} {b} {c:04d}", "{a}-{b}-{c:04d}",
        "+44 20 {g1} {g2:04d}", "+49 30 {d:08d}", "+49 89 {d6:06d}",
        "{b}-{c:04d}"]                                   # too short
    phone = [None if m else forms[k].format(
        a=a, b=b, c=c, g1=g // 10**4, g2=g % 10**4, d=d, d6=d % 10**6)
        for m, k, a, b, c, g, d in zip(phone_missing.tolist(),
                                       kind.tolist(), a3, b3, c4, g8, d8)]

    pool = [base64.b64encode(_MIME_HEADS[h] + rng.bytes(24)).decode()
            for h in rng.integers(0, len(_MIME_HEADS), 20_000)] + \
        [base64.b64encode(rng.bytes(32)).decode() for _ in range(5_000)]
    pick = rng.integers(0, len(pool), n).tolist()
    bu = rng.uniform(size=n).tolist()
    b64 = [None if u < 0.1 else "" if u < 0.2 else pool[k]
           for u, k in zip(bu, pick)]

    geo_missing = (rng.uniform(size=n) < 0.1).tolist()
    geo = [None if m else [a, o, c] for m, a, o, c in zip(
        geo_missing, rng.uniform(25, 60, n).tolist(),
        rng.uniform(-125, 30, n).tolist(),
        rng.integers(1, 10, n).astype(np.float64).tolist())]

    lengths = rng.integers(0, 6, n)
    flat = (1_400_000_000_000 + rng.integers(0, 2 * 10**11,
                                             int(lengths.sum()))).tolist()
    ends = np.cumsum(lengths).tolist()
    visits = [flat[e - k:e] for e, k in zip(ends, lengths.tolist())]

    colors = ["red", "green", "blue", "black", "white", "Grey"]
    sizes = ["S", "M", "L", "XL"]
    tiers = ["free", "pro", "enterprise"]
    # every (color, size, tier) with each key present or not: one shared
    # dict per combination
    combos = [{k: v for k, v, p in (("color", c, pc), ("size", z, pz),
                                    ("tier", t, pt)) if p}
              for c in colors for z in sizes for t in tiers
              for pc in (0, 1) for pz in (0, 1) for pt in (0, 1)]
    weights = np.array([0.85 ** sum(p) * 0.15 ** (3 - sum(p)) for p in (
        (pc, pz, pt) for _ in range(len(colors) * len(sizes) * len(tiers))
        for pc in (0, 1) for pz in (0, 1) for pt in (0, 1))])
    attrs = [combos[i] for i in rng.choice(len(combos), size=n,
                                           p=weights / weights.sum())]
    created = 1_450_000_000_000 + rng.integers(0, 5 * 10**10, n)
    renewed = (created + rng.integers(0, 3 * 10**10, n)).tolist()
    has_renewal = (rng.uniform(size=n) < 0.6).tolist()
    events = [{"created": c, "renewed": r} if h else {"created": c}
              for c, r, h in zip(created.tolist(), renewed, has_renewal)]

    hour = (dt / 3_600_000.0) % 24.0
    logit = (0.8 * r1 + 0.9 * np.cos(2 * np.pi * hour / 24.0) + 0.7 * k0
             + 0.8 * (dom_group < 2) - 0.6 * ~phone_valid - 0.3)
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-logit))).astype(np.float64)
    mp = [{"k0": a, "k1": b} for a, b in zip(k0.tolist(), k1.tolist())]
    return {
        "label": ("RealNN", y),
        "plA": ("PickList", cats_a[rng.integers(0, 50, n)]),
        "plB": ("PickList", cats_b[rng.integers(0, 12, n)]),
        "txt": ("Text", texts[rng.integers(0, n_txt, n)]),
        "r1": ("Real", r1), "r2": ("Real", r2), "dt": ("Date", dt),
        "mp": ("RealMap", _object_array(mp)),
        "email": ("Email", _object_array(email)),
        "url": ("URL", _object_array(url)),
        "phone": ("Phone", _object_array(phone)),
        "b64": ("Base64", _object_array(b64)),
        "geo": ("Geolocation", _object_array(geo)),
        "visits": ("DateList", _object_array(visits)),
        "attrs": ("PickListMap", _object_array(attrs)),
        "events": ("DateMap", _object_array(events))}


def wide_dataset(cols: dict, Dataset, Column, types):
    """A Dataset of `wide_columns`' columns for either package (its
    Dataset, Column and types module)."""
    return Dataset({name: Column(getattr(types, t).column_kind, arr)
                    for name, (t, arr) in cols.items()})


def wide_vector(FB, transmogrify, Defaults):
    """(label, transmogrified vector) of the wide schema, built with either
    package's FeatureBuilder, transmogrify and TransmogrifierDefaults: every
    column a predictor, the DateMap through `to_unit_circle_map`, the date
    vectorizers' reference time fixed."""
    label = FB.RealNN("label").as_response()
    feats = [getattr(FB, t)(name).as_predictor() for name, t in (
        ("plA", "PickList"), ("plB", "PickList"), ("txt", "Text"),
        ("r1", "Real"), ("r2", "Real"), ("dt", "Date"), ("mp", "RealMap"),
        ("email", "Email"), ("url", "URL"), ("phone", "Phone"),
        ("b64", "Base64"), ("geo", "Geolocation"), ("visits", "DateList"),
        ("attrs", "PickListMap"))]
    events = FB.DateMap("events").as_predictor().to_unit_circle_map()
    return label, transmogrify(
        feats + [events], defaults=Defaults(
            reference_date_ms=WIDE_REFERENCE_MS))


def workflow_small_phase(seed: int) -> bool:
    """The user's flow on 50 000 titanic-shaped records through ListReader
    (FeatureBuilder -> transmogrify -> SanityChecker -> 3-fold
    BinaryClassificationModelSelector over OpLogisticRegression's default
    grid, and OpXGBoostClassifier, OpRandomForestClassifier (10 trees) and
    OpGBTClassifier at depth {3, 5} -> Workflow.train() -> score()) on
    the CPU (plain versions) and twice on the card. They must
    agree: the transmogrified matrix and its metadata identical, the same
    columns kept for the same reasons, the same winner, every cell's mean
    AuPR within 5e-3 and the AuPR of the scored probabilities within 1e-3;
    the CPU-fitted workflow, carried onto the card (convert.stage_state ->
    workflow_model_from_jax), scores every row within 1e-5 of the CPU. The
    card's own fit must score every row within 1e-5 of the CPU's, unless
    the refits split a node differently: then the first such node is the
    witness, and the two candidate splits must tie within the f32 noise of
    the two devices' histograms there (`split_witness`). The second card
    run is compared with the first the same way (is the card's fit
    reproducible from run to run?)."""
    import numpy as np
    import torch
    from transmogrifai_tpu_torch import convert
    from transmogrifai_tpu_torch.automl.preparators import SanityChecker
    from transmogrifai_tpu_torch.automl.selectors import (
        BinaryClassificationModelSelector, default_grid_for)
    from transmogrifai_tpu_torch.automl.transmogrifier import transmogrify
    from transmogrifai_tpu_torch.features.builder import FeatureBuilder as FB
    from transmogrifai_tpu_torch.models.glm import OpLogisticRegression
    from transmogrifai_tpu_torch.models.trees import (
        OpGBTClassifier, OpRandomForestClassifier, OpXGBoostClassifier)
    from transmogrifai_tpu_torch.ops import metrics_ops as M
    from transmogrifai_tpu_torch.readers import ListReader
    from transmogrifai_tpu_torch.utils.uid import reset_uids
    from transmogrifai_tpu_torch.workflow import Workflow

    rows = titanic_records(50_000, seed + 3)
    new = titanic_records(20_000, seed + 4)

    def score(model, pred):
        return model.score(ListReader(new).generate_dataset(
            model.raw_features())).data(pred.name)

    out = {}
    for run, dev in (("cpu", "cpu"), ("cuda", "cuda"), ("cuda2", "cuda")):
        reset_uids()
        survived = FB.RealNN("survived").as_response()
        feats = [FB.Real("age").as_predictor(), FB.Real("fare").as_predictor(),
                 FB.Integral("pClass").as_predictor(),
                 FB.Integral("sibSp").as_predictor(),
                 FB.Integral("parCh").as_predictor(),
                 FB.Binary("alone").as_predictor(),
                 FB.PickList("sex").as_predictor(),
                 FB.PickList("embarked").as_predictor(),
                 FB.MultiPickList("cabinDeck").as_predictor()]
        vec = transmogrify(feats)
        checked = SanityChecker(remove_bad_features=True).set_input(
            survived, vec).get_output()
        pred = BinaryClassificationModelSelector.with_cross_validation(
            num_folds=3, seed=42, models_and_parameters=[
                (OpLogisticRegression(),
                 default_grid_for("OpLogisticRegression")),
                (OpXGBoostClassifier(), [
                    dict(max_depth=d, eta=0.3, num_round=5, max_bins=32)
                    for d in (3, 5)]),
                (OpRandomForestClassifier(), [
                    dict(max_depth=d, num_trees=10, min_instances_per_node=10)
                    for d in (3, 5)]),
                (OpGBTClassifier(), [
                    dict(max_depth=d, max_iter=5, step_size=0.3)
                    for d in (3, 5)])]).set_input(survived, checked) \
            .get_output()
        t0 = time.perf_counter()
        with record_refit_levels([]) as levels:
            model = Workflow(device=dev).set_reader(ListReader(rows)) \
                .set_result_features(pred).train()
        train_s = time.perf_counter() - t0
        out[run] = dict(model=model, pred=pred, vec=vec.name,
                        checked=checked.name, scored=score(model, pred),
                        levels=levels, train_s=train_s)
    c, g, g2 = out["cpu"], out["cuda"], out["cuda2"]
    cm, gm = c["model"], g["model"]
    cx, gx = cm._train_data.column(c["vec"]), gm._train_data.column(g["vec"])
    cs, gs = cm.sanity_checker_summary(), gm.sanity_checker_summary()
    csel, gsel = cm.selector_summary(), gm.selector_summary()
    cells = max(abs(a["mean_metric"] - b["mean_metric"]) for a, b in
                zip(csel.validation_results, gsel.validation_results))
    y_new = np.array([r["survived"] for r in new], np.float32)
    aupr = [float(M.au_pr(torch.as_tensor(r["scored"][:, -1]),
                          torch.as_tensor(y_new))) for r in (c, g)]
    # the score path on the card, per row: the CPU's fitted stages scored
    # on the card
    carried = convert.workflow_model_from_jax(
        [c["pred"]], [convert.stage_state(st) for st in cm.stages],
        device="cuda")
    carried_diff = float(np.abs(score(carried, c["pred"])[:, -1]
                                - c["scored"][:, -1]).max())
    names = cm._train_data.column(c["checked"]).metadata.column_names()
    depth = csel.best_grid.get("max_depth", 0)

    def compare(a, b):
        """Largest probability difference, the share of rows within 1e-5
        and, where the refits split a node differently, the witness."""
        dprob = np.abs(a["scored"][:, -1] - b["scored"][:, -1])
        first = first_divergence(a["levels"], b["levels"])
        return dict(max_prob_diff=float(dprob.max()),
                    share_prob_within_1e5=float((dprob <= 1e-5).mean()),
                    refit_levels=[len(a["levels"]), len(b["levels"])],
                    witness=None if first is None else split_witness(
                        a["levels"], b["levels"], *first, depth, names))
    cpu_card, card_card = compare(c, g), compare(g, g2)
    res = dict(
        rows=len(rows), width=int(gx.data.shape[1]),
        kept=len(next(st for st in gm.stages if type(st).__name__
                      == "SanityCheckerModel").indices_to_keep),
        matrix_identical=cx.data.tobytes() == gx.data.tobytes(),
        metadata_identical=cx.metadata.to_json() == gx.metadata.to_json(),
        same_drops=(cs.dropped == gs.dropped
                    and list(cs.drop_reasons) == list(gs.drop_reasons)),
        winner_cpu=[csel.best_model_name, csel.best_grid],
        winner_cuda=[gsel.best_model_name, gsel.best_grid],
        max_cell_diff=cells, score_aupr_cpu=aupr[0], score_aupr_cuda=aupr[1],
        carried_cpu_model_on_card_max_prob_diff=carried_diff,
        cpu_vs_card=cpu_card, card_vs_card_rerun=card_card,
        routes=sorted({v["route"] for v in gsel.validation_results}),
        cells_cuda=[[v["model_name"], v["grid"], v["mean_metric"]]
                    for v in gsel.validation_results],
        train_s_cpu=c["train_s"], train_s_cuda=[g["train_s"], g2["train_s"]])
    log("workflow-small: " + json.dumps(res))

    def explained(cmp):   # every row within 1e-5, or a tie at the split
        w = cmp["witness"]
        return cmp["max_prob_diff"] <= 1e-5 or (w is not None and w["tie"])
    return (res["matrix_identical"] and res["metadata_identical"]
            and res["same_drops"] and res["winner_cpu"] == res["winner_cuda"]
            and cells < 5e-3 and abs(aupr[0] - aupr[1]) < 1e-3
            and carried_diff <= 1e-5
            and explained(cpu_card) and explained(card_card))


def lr_cut_grid() -> list:
    """Logistic regression's 2 least regularised default grid points (reg
    0.001, elastic net 0.1 and 0.5): the CPU legs' cut of its 8, for the
    CPU's sake (each point is a Newton solve over ~600 columns)."""
    from transmogrifai_tpu_torch.automl.selectors import default_grid_for
    return sorted(default_grid_for("OpLogisticRegression"),
                  key=lambda g: g["reg_param"])[:2]


def titanic_cut_selector():
    """The README sweep shape of the port's example (reference_selector:
    3-fold CV, 10% holdout) cut as workflow-small cuts it: `lr_cut_grid()`
    and random forests of 10 trees at depth {3, 5}."""
    from transmogrifai_tpu_torch.examples import op_titanic_simple as EX
    from transmogrifai_tpu_torch.models.glm import OpLogisticRegression
    from transmogrifai_tpu_torch.models.trees import OpRandomForestClassifier
    return EX.reference_selector(models_and_parameters=[
        (OpLogisticRegression(), lr_cut_grid()),
        (OpRandomForestClassifier(), [
            dict(max_depth=d, num_trees=10, min_instances_per_node=10)
            for d in (3, 5)])])


def titanic_selector():
    """workflow-titanic's main-path selector: the example's
    `reference_selector()` (3-fold CV, 10% holdout) over logistic
    regression's default grid and random forests of the default grid cut
    to depth {3, 6} (12 of its 18 points; the depth-12 points took 55 s of
    the phase's 88 s, PR 16's final run, and workflow-main keeps depth 12)."""
    from transmogrifai_tpu_torch.automl.selectors import default_grid_for
    from transmogrifai_tpu_torch.examples import op_titanic_simple as EX
    from transmogrifai_tpu_torch.models.glm import OpLogisticRegression
    from transmogrifai_tpu_torch.models.trees import OpRandomForestClassifier
    return EX.reference_selector(models_and_parameters=[
        (OpLogisticRegression(), default_grid_for("OpLogisticRegression")),
        (OpRandomForestClassifier(), [
            g for g in default_grid_for("OpRandomForestClassifier")
            if g["max_depth"] <= 6])])


def vector_names(model) -> tuple:
    """(transmogrified vector, checked vector) column names of a trained
    workflow: the SanityChecker's input and output."""
    sc = next(st for st in model.stages
              if type(st).__name__ == "SanityCheckerModel")
    return sc.input_names()[1], sc.output_name()


def workflow_titanic_phase(rows: int, seed: int):
    """The port's example flow (transmogrifai_tpu_torch/examples/
    op_titanic_simple.py: a hashed Text name, DSL arithmetic, pivot,
    fill_missing_with_mean + z_normalize, a lambda map, transmogrify,
    SanityChecker, the model selector) on `titanic_named_records`.

    First, CPU against card at `TITANIC_LEG_ROWS` records with
    `titanic_cut_selector`:
    the transmogrified matrix and its metadata bit-identical, the same
    columns kept for the same reasons, the same winner, scores of as many
    new records within 1e-5 a row or, where the refits split a node
    differently, the first such node a tie (`split_witness`); the
    CPU-fitted workflow carried onto the card scores within 1e-5; where
    the CPU's train() goes (stage walls, sweep / refit, each family's
    sweep, each plain kernel's calls and seconds).

    Then the main path: `rows` records through `build_workflow(
    titanic_selector())` (LR's default grid, RF's cut to depth {3, 6}, 3
    folds, 10% holdout) in `Workflow()` on the card. Launch
    counters are reset just before train() and read just after; every
    kernel must have launched. Stage walls (the text vectorizer's fit and
    transform apart), peak device memory, width, winner, its CV AuPR and
    holdout AuPR and AuROC against the prevalence; each kernel at every
    (kernel, F, S, C, Fo) key of train() on the inputs of its first
    launch there against its plain version (rows of the kernels line,
    phase "titanic"). Returns (ok, launches by capture key, kernel
    rows)."""
    import numpy as np
    import torch
    from transmogrifai_tpu_torch import convert
    from transmogrifai_tpu_torch.examples import op_titanic_simple as EX
    from transmogrifai_tpu_torch.ops import tree_kernels as TK
    from transmogrifai_tpu_torch.readers import ListReader
    from transmogrifai_tpu_torch.utils.uid import reset_uids

    t_phase = t0 = time.perf_counter()
    small = titanic_named_records(TITANIC_LEG_ROWS, seed + 11)
    new = titanic_named_records(TITANIC_LEG_ROWS, seed + 12)
    log(f"workflow-titanic: records made in "
        f"{time.perf_counter() - t0:.2f}s")

    def score(model, pred):
        return model.score(ListReader(new).generate_dataset(
            model.raw_features())).data(pred.name)

    out, cpu_kernels = {}, {}
    for run, dev in (("cpu", "cpu"), ("cuda", None)):
        reset_uids()
        wf, pred = EX.build_workflow(titanic_cut_selector(), device=dev)
        t0 = time.perf_counter()
        with record_refit_levels([]) as levels, \
                time_dispatch(cpu_kernels if run == "cpu" else {}):
            model = wf.set_reader(ListReader(small)).train()
        out[run] = dict(model=model, pred=pred, levels=levels,
                        train_s=time.perf_counter() - t0,
                        scored=score(model, pred))
    c, g = out["cpu"], out["cuda"]
    carried = convert.workflow_model_from_jax(
        [c["pred"]], [convert.stage_state(st) for st in c["model"].stages],
        device="cuda")
    carried_diff = float(np.abs(score(carried, c["pred"])[:, -1]
                                - c["scored"][:, -1]).max())
    cmp = dict(
        compare_runs(c, g), rows=len(small),
        carried_cpu_model_on_card_max_prob_diff=carried_diff,
        train_s_cpu=c["train_s"], train_s_cuda=g["train_s"],
        cpu_stage_walls_s=stage_walls(c["model"]),
        cpu_selector_walls_s=c["pred"].origin_stage.walls,
        cpu_family_sweep_s=c["pred"].origin_stage.validator.family_walls,
        cpu_plain_kernels=cpu_kernels)
    log("workflow-titanic cpu-vs-card: " + json.dumps(cmp))
    small_ok = runs_agree(cmp) and carried_diff <= 1e-5
    del out, c, g, carried
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    recs = titanic_named_records(rows, seed + 13)
    raw_s = time.perf_counter() - t0
    reset_uids()
    wf, pred = EX.build_workflow(titanic_selector())
    wf.set_reader(ListReader(recs))
    selector = pred.origin_stage
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    captured, capture_launches = {}, collections.Counter()
    TK.reset_launches()
    t0 = time.perf_counter()
    with capture_kernel_inputs(captured, capture_launches):
        model = wf.train()
    train_s = time.perf_counter() - t0
    launches = dict(TK.launches)
    shape_launches = dict(TK.shape_launches)
    capture_launches = dict(capture_launches)
    train_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    walls = stage_walls(model)
    sel = model.selector_summary()
    sc = model.sanity_checker_summary()
    vec, checked = vector_names(model)
    width = int(model._train_data.data(vec).shape[1])
    smart = next(st for st in model.stages
                 if type(st).__name__ == "SmartTextModel")
    kept = len(next(st for st in model.stages if type(st).__name__
                    == "SanityCheckerModel").indices_to_keep)
    y = np.array([r["survived"] for r in recs], np.float64)
    prevalence = float(y.mean())
    best = max(sel.validation_results, key=lambda v: v["mean_metric"])
    families = family_results(sel, selector)
    model._train_data = None
    t0 = time.perf_counter()
    scored = score(model, pred)
    score_s = time.perf_counter() - t0
    HELD["tree"] = model
    ti_rows = kernel_rows([captured_shape(key, *captured[key],
                                          prefix="workflow-titanic")
                           for key in sorted(captured)], phase="titanic")
    del captured
    torch.cuda.empty_cache()
    res = dict(
        rows=rows, phase_s=time.perf_counter() - t_phase, raw_data_s=raw_s,
        train_s=train_s, score_s=score_s,
        score_rows=len(new), stage_walls_s=walls,
        selector_walls_s=selector.walls, width_before=width,
        width_after=kept, flagged=len(sc.dropped),
        text_plans=[p["mode"] for p in smart.plans],
        winner=[sel.best_model_name, sel.best_grid],
        winner_cv_aupr=best["mean_metric"],
        holdout_aupr=sel.holdout_evaluation.get("au_pr"),
        holdout_auroc=sel.holdout_evaluation.get("au_roc"),
        prevalence=prevalence, families=families,
        peak_device_gb_train=train_peak_gb,
        peak_device_gb=torch.cuda.max_memory_allocated() / 1e9,
        launches=launches, shape_launches=shape_launches,
        capture_launches=capture_launches)
    log("workflow-titanic: " + json.dumps(res))
    by_shape = collections.Counter()
    for key, n in capture_launches.items():
        by_shape[launch_key(key)] += n
    ok = (small_ok and all(n > 0 for n in launches.values())
          and res["text_plans"] == ["hash"]
          and {r["key"] for r in ti_rows} == set(capture_launches)
          and dict(by_shape) == shape_launches
          and set(families) == {"OpLogisticRegression",
                                "OpRandomForestClassifier"}
          and scored.shape == (len(new), 5)
          and bool(np.isfinite(scored).all())
          and best["mean_metric"] > prevalence
          and sel.holdout_evaluation["au_pr"] > prevalence)
    return ok, capture_launches, ti_rows


def wide_selector(leg: bool = False, mlp: bool = False):
    """workflow-wide's selector: 3-fold CrossValidation (the DataBalancer's
    10% holdout) over logistic regression's default grid (8 points), random
    forests of 10 trees at depth {3, 6}, Spark GBT of 10 rounds at depth 4
    and, with `mlp`, the MLP's default grid (hidden layers [10, 10], 200
    Adam steps; the sequential route). `leg`: the CPU-against-card leg's
    cut of it, for the CPU's sake: `lr_cut_grid()`, a forest of 5 trees at
    depth 3, the GBT at 3 rounds of depth 3."""
    from transmogrifai_tpu_torch.automl.selectors import (
        BinaryClassificationModelSelector, default_grid_for)
    from transmogrifai_tpu_torch.models.glm import OpLogisticRegression
    from transmogrifai_tpu_torch.models.mlp import (
        OpMultilayerPerceptronClassifier)
    from transmogrifai_tpu_torch.models.trees import (
        OpGBTClassifier, OpRandomForestClassifier)
    lr = lr_cut_grid() if leg else default_grid_for("OpLogisticRegression")
    mlps = [(OpMultilayerPerceptronClassifier(),
             default_grid_for("OpMultilayerPerceptronClassifier"))] \
        if mlp else []
    return BinaryClassificationModelSelector.with_cross_validation(
        num_folds=3, seed=42, models_and_parameters=[
            (OpLogisticRegression(), lr),
            (OpRandomForestClassifier(), [
                dict(num_trees=5 if leg else 10, max_depth=d,
                     min_instances_per_node=10)
                for d in ((3,) if leg else (3, 6))]),
            (OpGBTClassifier(), [dict(max_iter=3 if leg else 10,
                                      max_depth=3 if leg else 4)])] + mlps)


def wide_workflow(cols: dict, device=None, leg: bool = False):
    """(workflow, prediction) of the wide flow in the port: transmogrify ->
    SanityChecker() -> `wide_selector(leg, mlp=not leg)` -> Workflow(device)
    over a Dataset of `cols`. Outside the leg a second result feature
    calibrates r1 (filled with its mean) against the label by isotonic
    regression (`to_isotonic_calibrated`); it does not enter the
    selector's vector."""
    from transmogrifai_tpu_torch import types as T
    from transmogrifai_tpu_torch.automl.preparators import SanityChecker
    from transmogrifai_tpu_torch.automl.transmogrifier import (
        TransmogrifierDefaults, transmogrify)
    from transmogrifai_tpu_torch.data.dataset import Column, Dataset
    from transmogrifai_tpu_torch.features.builder import FeatureBuilder
    from transmogrifai_tpu_torch.workflow import Workflow
    label, vec = wide_vector(FeatureBuilder, transmogrify,
                             TransmogrifierDefaults)
    checked = SanityChecker().set_input(label, vec).get_output()
    pred = wide_selector(leg, mlp=not leg).set_input(label, checked) \
        .get_output()
    extra = [] if leg else [FeatureBuilder.Real("r1").as_predictor()
                            .fill_missing_with_mean()
                            .to_isotonic_calibrated(label)]
    wf = Workflow(device=device).set_input_dataset(
        wide_dataset(cols, Dataset, Column, T)).set_result_features(
            pred, *extra)
    return wf, pred


def wide_scores(model, pred, cols: dict):
    from transmogrifai_tpu_torch import types as T
    from transmogrifai_tpu_torch.data.dataset import Column, Dataset
    return model.score(wide_dataset(cols, Dataset, Column, T)) \
        .data(pred.name)


def isotonic_check(model) -> dict:
    """The fitted IsotonicRegressionModel of a trained wide workflow applied
    to its whole score column (r1 filled) on the card and on the CPU: the
    two float64 transforms must be equal and monotone in the score. Its
    fit's wall is the stage wall of the calibrator."""
    import copy
    import numpy as np
    iso = next(st for st in model.stages
               if type(st).__name__ == "IsotonicRegressionModel")
    x = np.asarray(model._train_data.data(iso.input_names()[1]), np.float64)
    t0 = time.perf_counter()
    card = iso.apply(x)
    card_s = time.perf_counter() - t0
    on_cpu = copy.copy(iso)
    on_cpu.device = "cpu"
    t0 = time.perf_counter()
    host = on_cpu.apply(x)
    cpu_s = time.perf_counter() - t0
    order = np.argsort(x, kind="stable")
    fit_s = sum(w["seconds"] for w in model.runner.walls
                if w["stage"].startswith("IsotonicRegressionCalibrator"))
    return dict(rows=len(x), steps=len(iso.values), fit_s=fit_s,
                card_transform_s=card_s, cpu_transform_s=cpu_s,
                card_equals_cpu=bool(np.array_equal(card, host)),
                monotone=bool((np.diff(card[order]) >= 0).all()),
                device=str(iso.device))


def compare_runs(a: dict, b: dict) -> dict:
    """Two trained runs of one workflow (`model`, `pred`, refit `levels`,
    `scored`) side by side: the transmogrified matrix and metadata, the
    SanityChecker's drops and reasons, the winner, the largest CV-cell
    difference, the scores' largest difference, and where the refits split
    a node differently, the first such node's `split_witness`."""
    import numpy as np
    am, bm = a["model"], b["model"]
    vec, checked = vector_names(am)
    ax, bx = am._train_data.column(vec), bm._train_data.column(vec)
    asc, bsc = am.sanity_checker_summary(), bm.sanity_checker_summary()
    asel, bsel = am.selector_summary(), bm.selector_summary()
    dprob = np.abs(a["scored"][:, -1] - b["scored"][:, -1])
    first = first_divergence(a["levels"], b["levels"])
    names = am._train_data.column(checked).metadata.column_names()
    witness = None if first is None else split_witness(
        a["levels"], b["levels"], *first,
        asel.best_grid.get("max_depth", 0), names)
    return dict(
        width=int(bx.data.shape[1]),
        matrix_identical=ax.data.tobytes() == bx.data.tobytes(),
        metadata_identical=ax.metadata.to_json() == bx.metadata.to_json(),
        same_drops=(asc.dropped == bsc.dropped
                    and list(asc.drop_reasons) == list(bsc.drop_reasons)),
        dropped=len(bsc.dropped),
        winner=[[asel.best_model_name, asel.best_grid],
                [bsel.best_model_name, bsel.best_grid]],
        same_winner=(asel.best_model_name, asel.best_grid)
        == (bsel.best_model_name, bsel.best_grid),
        max_cell_diff=max(abs(x["mean_metric"] - y["mean_metric"])
                          for x, y in zip(asel.validation_results,
                                          bsel.validation_results)),
        max_prob_diff=float(dprob.max()),
        share_prob_within_1e5=float((dprob <= 1e-5).mean()),
        scored_rows=len(dprob), witness=witness)


def runs_agree(cmp: dict) -> bool:
    """compare_runs' verdict: identical matrix, metadata and drops, the
    same winner, and scores within 1e-5 a row or a tie at the first node
    the refits split differently."""
    return (cmp["matrix_identical"] and cmp["metadata_identical"]
            and cmp["same_drops"] and cmp["same_winner"]
            and (cmp["max_prob_diff"] <= 1e-5
                 or (cmp["witness"] is not None and cmp["witness"]["tie"])))


def group_widths(model) -> dict:
    """Width of each vectorizer's block in a trained workflow, by stage."""
    out = {}
    for st in model.stages:
        md = st.output_metadata() if hasattr(st, "output_metadata") \
            else None
        name = type(st).__name__
        if md is None or name in ("VectorsCombiner", "SanityCheckerModel") \
                or name.startswith("Selected"):
            continue
        key = f"{name} {','.join(st.input_names())}"
        out[key] = md.size
    return out


def wide_leg_run(cols: dict, new: dict, device) -> dict:
    """One run of workflow-wide's leg: `wide_workflow(cols,
    device, leg=True)` trained with its refit levels recorded, then scored
    on `new`."""
    from transmogrifai_tpu_torch.utils.uid import reset_uids
    reset_uids()
    wf, pred = wide_workflow(cols, device=device, leg=True)
    t0 = time.perf_counter()
    with record_refit_levels([]) as levels:
        model = wf.train()
    return dict(model=model, pred=pred, levels=levels,
                train_s=time.perf_counter() - t0,
                scored=wide_scores(model, pred, new))


def workflow_wide_phase(rows: int, seed: int):
    """bench.py's wide schema with one feature of each date, map,
    geolocation and structured text group (`wide_columns`) through the
    user's flow: transmogrify (every group's default, Email, URL and Base64
    derived to PickLists, Phone to a Binary) -> SanityChecker() ->
    `wide_selector()` -> Workflow().train() -> score().

    The leg at `WIDE_LEG_ROWS` rows with `wide_selector(leg=True)`, twice
    on the card with the same inputs and once on the CPU (plain versions).
    Card against card (C1: the histogram kernels flush float atomics in no
    fixed order): the largest |dp|, whether the matrices are identical,
    whether the winners match, the largest CV-cell difference, and where
    the refits split a node differently, the witness of the tie. CPU
    against card: the matrix and metadata identical, the same drops for
    the same reasons, the same winner, scores of new rows within 1e-5 a
    row or a tie witness, the CPU-fitted workflow carried onto the card
    within 1e-5.

    The main path: `rows` rows on the card. Launch counters are reset just
    before train() and read just after: every kernel must have launched,
    route_hist at S >= 2 too. The width of each group, each stage's fit and
    transform wall (the derivations' too), the train and score walls
    (score on `WIDE_SCORE_ROWS` new rows), each family's sweep, peak device
    memory, the winner and the holdout AuPR against the prevalence, the
    isotonic calibrator of r1 fitted on all rows (`isotonic_check`: its
    card transform equal to its CPU transform and monotone); each
    kernel at every (kernel, F, S, C, Fo) key of train() on the inputs of
    its first launch against its plain version (rows of the kernels line,
    phase "wide"), the capture keys' launches adding up to the
    dispatchers' counts. The CPU's leg trains in a thread beside those
    kernel checks (they keep the card busy and the host idle, and neither
    touches what the other patches or counts) and is joined before the
    kernels are timed, so no host work of its own delays a timed launch
    (`leg_wait_s`: how long the timing waited for it). Returns (ok,
    launches by capture key, kernel rows)."""
    import tempfile
    import threading
    import numpy as np
    import torch
    from transmogrifai_tpu_torch import convert
    from transmogrifai_tpu_torch.ops import tree_kernels as TK
    from transmogrifai_tpu_torch.utils.uid import reset_uids

    t_phase = t0 = time.perf_counter()
    small = wide_columns(WIDE_LEG_ROWS, seed + 21)
    small_new = wide_columns(WIDE_LEG_ROWS, seed + 22)
    log(f"workflow-wide: leg data made in {time.perf_counter() - t0:.2f}s")
    g, g2 = (wide_leg_run(small, small_new, None) for _ in range(2))
    c1 = dict(compare_runs(g, g2),
              train_s=[g["train_s"], g2["train_s"]])
    log("workflow-wide card-vs-card (C1): " + json.dumps(c1))
    del g2
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    cols = wide_columns(rows, seed + 23)
    new = wide_columns(WIDE_SCORE_ROWS, seed + 24)
    raw_s = time.perf_counter() - t0
    reset_uids()
    wf, pred = wide_workflow(cols)
    selector = pred.origin_stage
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    captured, capture_launches = {}, collections.Counter()
    TK.reset_launches()
    t0 = time.perf_counter()
    with capture_kernel_inputs(captured, capture_launches):
        model = wf.train()
    train_s = time.perf_counter() - t0
    launches = dict(TK.launches)
    shape_launches = dict(TK.shape_launches)
    capture_launches = dict(capture_launches)
    train_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    sel = model.selector_summary()
    sc = model.sanity_checker_summary()
    vec, _ = vector_names(model)
    width = int(model._train_data.data(vec).shape[1])
    kept = len(next(st for st in model.stages if type(st).__name__
                    == "SanityCheckerModel").indices_to_keep)
    widths = group_widths(model)
    walls = stage_walls(model)
    prevalence = float(cols["label"][1].mean())
    best = max(sel.validation_results, key=lambda v: v["mean_metric"])
    families = family_results(sel, selector)
    iso = isotonic_check(model)
    model._train_data = None
    del cols
    t0 = time.perf_counter()
    scored = wide_scores(model, pred, new)
    score_s = time.perf_counter() - t0
    score_walls = stage_walls(model)
    t0 = time.perf_counter()
    wide_root = tempfile.mkdtemp(prefix="chip_smoke_wide_model_")
    # removed at exit whatever fails between here and the serve phase
    atexit.register(shutil.rmtree, wide_root, ignore_errors=True)
    HELD["wide_dir"] = os.path.join(wide_root, "model")
    model.save(HELD["wide_dir"])
    save_s = time.perf_counter() - t0
    del model
    main_s = time.perf_counter() - t_phase

    cpu = {}

    def cpu_leg():
        try:
            cpu.update(wide_leg_run(small, small_new, "cpu"))
        except BaseException as e:     # re-raised by the phase's thread
            cpu["error"] = e
    leg = threading.Thread(target=cpu_leg, name="wide-cpu-leg")
    leg.start()
    leg_wait = {}

    def join_leg():
        t = time.perf_counter()
        leg.join()
        leg_wait["s"] = time.perf_counter() - t
    wide_rows_out = kernel_rows([captured_shape(key, *captured[key],
                                                prefix="workflow-wide")
                                 for key in sorted(captured)], phase="wide",
                                before_timing=join_leg)
    del captured
    torch.cuda.empty_cache()
    checks_s = time.perf_counter() - t_phase - main_s
    if "error" in cpu:
        raise cpu["error"]
    carried = convert.workflow_model_from_jax(
        [cpu["pred"]], [convert.stage_state(st) for st in
                        cpu["model"].stages], device="cuda")
    carried_diff = float(np.abs(
        wide_scores(carried, cpu["pred"], small_new)[:, -1]
        - cpu["scored"][:, -1]).max())
    cmp = dict(compare_runs(cpu, g), rows=WIDE_LEG_ROWS,
               carried_cpu_model_on_card_max_prob_diff=carried_diff,
               train_s_cpu=cpu["train_s"], train_s_cuda=g["train_s"],
               cpu_stage_walls_s=stage_walls(cpu["model"]),
               cpu_family_sweep_s=cpu["pred"].origin_stage.validator
               .family_walls)
    log("workflow-wide cpu-vs-card: " + json.dumps(cmp))
    leg_ok = (runs_agree(cmp) and carried_diff <= 1e-5
              and c1["matrix_identical"] and c1["same_drops"]
              and c1["same_winner"])
    del cpu, g, carried
    torch.cuda.empty_cache()
    res = dict(
        rows=rows, phase_s=time.perf_counter() - t_phase,
        kernel_checks_s=checks_s, leg_wait_s=leg_wait["s"],
        raw_data_s=raw_s,
        train_s=train_s, score_s=score_s, score_rows=WIDE_SCORE_ROWS,
        save_s=save_s, group_widths=widths, stage_walls_s=walls,
        score_stage_walls_s=score_walls, selector_walls_s=selector.walls,
        width_before=width, width_after=kept, flagged=len(sc.dropped),
        winner=[sel.best_model_name, sel.best_grid],
        winner_cv_aupr=best["mean_metric"],
        holdout_aupr=sel.holdout_evaluation.get("au_pr"),
        holdout_auroc=sel.holdout_evaluation.get("au_roc"),
        prevalence=prevalence, families=families,
        peak_device_gb_train=train_peak_gb,
        peak_device_gb=torch.cuda.max_memory_allocated() / 1e9,
        launches=launches, shape_launches=shape_launches,
        capture_launches=capture_launches, isotonic=iso)
    log("workflow-wide: " + json.dumps(res))
    by_shape = collections.Counter()
    for key, n in capture_launches.items():
        by_shape[launch_key(key)] += n
    level_keys = [k for k in shape_launches
                  if k.startswith("route_hist") and not k.endswith(" S=1")]
    ok = (leg_ok and all(n > 0 for n in launches.values())
          and set(launches) == set(TK.KERNELS)
          and any(shape_launches[k] > 0 for k in level_keys)
          and {r["key"] for r in wide_rows_out} == set(capture_launches)
          and dict(by_shape) == shape_launches
          and set(families) == {"OpLogisticRegression",
                                "OpRandomForestClassifier",
                                "OpGBTClassifier",
                                "OpMultilayerPerceptronClassifier"}
          and iso["card_equals_cpu"] and iso["monotone"]
          and iso["rows"] == rows
          and scored.shape == (WIDE_SCORE_ROWS, 5)
          and bool(np.isfinite(scored).all())
          and best["mean_metric"] > prevalence
          and sel.holdout_evaluation["au_pr"] > prevalence)
    return ok, capture_launches, wide_rows_out


EVENT_DAY_MS = 86_400_000
EVENTS_T0 = 1_600_000_000_000         # the event log's day 0 (epoch ms)
EVENTS_DAYS = 60
EVENTS_CUTOFF_DAY = 45                # train cutoff; the score reader's: 52
EVENTS_SCORE_DAY = 52
EVENTS_PER_USER = 10                  # events a user, on average
# workflow-events' main path: 1.5M events over 200 000 users. At 10 a user
# (2M events) the phase took 152 s of its 150 s clock on one host (PERF.md
# §4): the cut is the event count only, never the schema.
EVENTS_MAIN_PER_USER = 7.5
EVENTS_REFERENCE_MS = EVENTS_T0 + EVENTS_DAYS * EVENT_DAY_MS
EVENTS_DROPS = ("balance", "referral", "supportTicket")
_EVENT_CHANNELS = ["web", "app", "email", "store", "phone", "partner"]
_EVENT_TAGS = ["new", "sale", "gift", "bulk", "return", "promo"]


def event_log(n_users: int, seed: int,
              events_per_user: float = EVENTS_PER_USER) -> dict:
    """A seeded event log in the shape of the JAX package's
    JoinsAndAggregates: a profiles table (a Real income, a PickList segment
    of 12, a Date signup, a Geolocation home) and an events table over
    `EVENTS_DAYS` days (a Real amount, a PickList category of 20, a
    MultiPickList of tags, a Text channel, a Binary flag, a Percent
    discount, a Geolocation, an event time, and whether it was a
    purchase), `events_per_user` events a user on average, their rate and
    content driven by a latent user propensity. The profiles come as two
    snapshots, one per cutoff: day `EVENTS_CUTOFF_DAY` (train) and
    `EVENTS_SCORE_DAY` (score). Three profile fields are seeded for
    RawFeatureFilter: `balance` drifts between the snapshots (train
    uniform over [0, 100), score above 500: JS divergence ~0.96),
    `referral` is filled for one user in 4 000 (fill rate 0.00025), and
    `supportTicket` is filled exactly for the users who buy within 7 days
    after the snapshot's cutoff (the label: its nulls leak it). Every
    signup time differs by the millisecond, so no vectorized date column
    is a nonzero constant.
    Returns {"profiles_train", "profiles_score", "events"} as lists of
    dict records."""
    import numpy as np
    rng = np.random.default_rng(seed)
    n, day = n_users, EVENT_DAY_MS
    z = rng.normal(size=n)
    users = [f"u{i:07d}" for i in range(n)]
    income = np.round(rng.lognormal(3.6 + 0.3 * z, 0.4), 2).tolist()  # k$
    segment = [f"seg{k}" for k in np.clip(
        np.round(6 + 2 * z + rng.normal(0, 2, n)), 0, 11).astype(int)]
    signup = (EVENTS_T0 - rng.integers(day, 3 * 365 * day, n)).tolist()
    home_lat = rng.uniform(25, 50, n)
    home_lon = rng.uniform(-120, -70, n)
    home = [[a, o, float(c)] for a, o, c in zip(
        home_lat.tolist(), home_lon.tolist(), rng.integers(1, 6, n).tolist())]
    rate = np.exp(0.4 * z)
    counts = rng.poisson(rate * events_per_user / rate.mean())
    u = np.repeat(np.arange(n), counts)
    m = len(u)
    t = EVENTS_T0 + rng.integers(0, EVENTS_DAYS * day, m)
    amount = np.round(rng.lognormal(2.2 + 0.4 * z[u], 0.6), 2)
    cat = np.clip(np.round(10 + 3 * z[u] + rng.normal(0, 4, m)), 0, 19)
    n_tags = rng.integers(0, 3, m)
    tag_ids = rng.integers(0, len(_EVENT_TAGS), (m, 2))
    chan = rng.choice(len(_EVENT_CHANNELS), m,
                      p=[0.35, 0.3, 0.15, 0.1, 0.06, 0.04])
    flag = rng.uniform(size=m) < 1 / (1 + np.exp(1.5 - z[u]))
    pct = np.round(rng.uniform(-0.05, 1.05, m), 3)
    lat = np.round(home_lat[u] + rng.normal(0, 0.5, m), 4)
    lon = np.round(home_lon[u] + rng.normal(0, 0.5, m), 4)
    buy = rng.uniform(size=m) < 1 / (1 + np.exp(2.2 - 1.2 * z[u]))
    tags = [[_EVENT_TAGS[a] for a in row[:k]]
            for row, k in zip(tag_ids.tolist(), n_tags.tolist())]
    events = [
        {"user": users[i], "t": ti, "amount": a, "category": f"c{int(c)}",
         "tags": tg, "channel": _EVENT_CHANNELS[ch], "flag": f,
         "discount": d, "geo": [la, lo, 1.0],
         "kind": "purchase" if b else "view"}
        for i, ti, a, c, tg, ch, f, d, la, lo, b in zip(
            u.tolist(), t.tolist(), amount.tolist(), cat.tolist(), tags,
            chan.tolist(), flag.tolist(), pct.tolist(), lat.tolist(),
            lon.tolist(), buy.tolist())]
    ticket = np.round(rng.lognormal(2, 1, n), 2).tolist()
    referral_at = set(range(7, n, 4000))

    def profiles(cutoff_day: int, balance) -> list:
        c = EVENTS_T0 + cutoff_day * day
        # the label's rule: a purchase at cutoff <= t < cutoff + 7 days
        hit = buy & (t >= c) & (t < c + 7 * day)
        bought = np.bincount(u[hit], minlength=n) > 0
        return [{"user": users[i], "cutoff": c, "income": income[i],
                 "segment": segment[i], "signup": signup[i],
                 "home": home[i], "balance": balance[i],
                 "referral": 25.0 if i in referral_at else None,
                 "supportTicket": ticket[i] if bought[i] else None}
                for i in range(n)]
    base = rng.uniform(0, 100, n)
    return {"profiles_train": profiles(EVENTS_CUTOFF_DAY,
                                       np.round(base, 2).tolist()),
            "profiles_score": profiles(EVENTS_SCORE_DAY,
                                       np.round(base + 500, 2).tolist()),
            "events": events}


def _max0(a, b):
    return max(a, b)


def events_features(FB) -> dict:
    """The events flow's raw features, built with either package's
    FeatureBuilder: the profile side (`left`: income, segment, signup,
    home and the three seeded fields), the event side (`right`: spend
    summed over 1, 7 and 30 days, mean amount, last category, tag union,
    channel concat, the flag's logical or, the mean discount, the event
    midpoint), the two time columns (`cutoff`, `t`) and the response
    (`label`: a purchase within 7 days after the cutoff)."""
    day = EVENT_DAY_MS

    def get(key):
        return lambda r: r.get(key)
    left = [FB.Real("income").extract(get("income")).as_predictor(),
            FB.PickList("segment").extract(get("segment")).as_predictor(),
            FB.Date("signup").extract(get("signup")).as_predictor(),
            FB.Geolocation("home").extract(get("home")).as_predictor()] + \
        [FB.Real(name).extract(get(name)).as_predictor()
         for name in EVENTS_DROPS]
    spend = [FB.Real(f"spend{d}d").extract(get("amount")).aggregate("sum")
             .window(d * day).as_predictor() for d in (1, 7, 30)]
    right = spend + [
        FB.Real("meanAmount").extract(get("amount")).aggregate("mean")
        .as_predictor(),
        FB.PickList("lastCategory").extract(get("category"))
        .aggregate("last").as_predictor(),
        FB.MultiPickList("tags").extract(get("tags")).aggregate("union")
        .as_predictor(),
        FB.Text("channels").extract(get("channel")).aggregate("concat")
        .as_predictor(),
        FB.Binary("anyFlag").extract(get("flag")).aggregate("logical_or")
        .as_predictor(),
        FB.Percent("discount").extract(get("discount")).as_predictor(),
        FB.Geolocation("eventMidpoint").extract(get("geo"))
        .aggregate("midpoint").as_predictor()]
    label = FB.RealNN("purchased").extract(
        lambda r: 1.0 if r.get("kind") == "purchase" else 0.0) \
        .aggregate(_max0, zero=lambda: 0.0).window(7 * day).as_response()
    return dict(left=left, right=right, label=label,
                cutoff=FB.Date("cutoff").extract(get("cutoff"))
                .as_predictor(),
                t=FB.Date("t").extract(get("t")).as_predictor())


def events_reader(R, feats: dict, profiles: list, events: list):
    """The profiles through an AggregateReader keyed by user, left-outer
    joined with the event-level events (keyed by user), then re-aggregated
    per user around each profile's cutoff (`with_secondary_aggregation`,
    a 30-day TimeBasedFilter; the time columns dropped). `R` is either
    package's readers module."""
    names = lambda fs: [f.name for f in fs]   # noqa: E731
    prof = R.AggregateReader(R.ListReader(profiles),
                             key_fn=lambda r: r["user"])
    ev = R.ListReader(events, key_fn=lambda r: r["user"])
    return prof.left_outer_join(
        ev, left_features=names(feats["left"] + [feats["cutoff"]]),
        right_features=names(feats["right"] + [feats["t"],
                                               feats["label"]]),
    ).with_secondary_aggregation(R.TimeBasedFilter(
        condition=R.TimeColumn("cutoff", keep=False),
        primary=R.TimeColumn("t", keep=False),
        time_window=30 * EVENT_DAY_MS))


def events_workflow(pkg: dict, log: dict, selector, device=None):
    """(workflow, prediction, score reader) of the events flow in either
    package (`pkg`: FeatureBuilder FB, readers R, transmogrify,
    TransmogrifierDefaults Defaults, SanityChecker SC, RawFeatureFilter
    RFF, Workflow): the joined aggregate reader of the train snapshot ->
    RawFeatureFilter(score_reader=the score snapshot's reader) ->
    transmogrify -> SanityChecker() -> `selector` -> Workflow(device)."""
    feats = events_features(pkg["FB"])
    R = pkg["R"]
    train = events_reader(R, feats, log["profiles_train"], log["events"])
    score = events_reader(R, feats, log["profiles_score"], log["events"])
    vec = pkg["transmogrify"](
        feats["left"] + feats["right"], defaults=pkg["Defaults"](
            reference_date_ms=EVENTS_REFERENCE_MS))
    checked = pkg["SC"]().set_input(feats["label"], vec).get_output()
    pred = selector.set_input(feats["label"], checked).get_output()
    dev = {} if device is False else {"device": device}
    wf = pkg["Workflow"](**dev).set_reader(train).set_result_features(
        pred, feats["cutoff"], feats["t"]).with_raw_feature_filter(
            pkg["RFF"](score_reader=score))
    return wf, pred, score


def port_events_pkg() -> dict:
    from transmogrifai_tpu_torch import readers as R
    from transmogrifai_tpu_torch.automl.preparators import SanityChecker
    from transmogrifai_tpu_torch.automl.transmogrifier import (
        TransmogrifierDefaults, transmogrify)
    from transmogrifai_tpu_torch.features.builder import FeatureBuilder
    from transmogrifai_tpu_torch.filters import RawFeatureFilter
    from transmogrifai_tpu_torch.workflow import Workflow
    return dict(FB=FeatureBuilder, R=R, transmogrify=transmogrify,
                Defaults=TransmogrifierDefaults, SC=SanityChecker,
                RFF=RawFeatureFilter, Workflow=Workflow)


@contextlib.contextmanager
def time_calls(obj, method: str, store: list, keep: list = None):
    """Inside the block, each call of `obj.method` appends (wall seconds,
    rows of the dataset it returns or None) to `store`, and what it
    returns to `keep` where given."""
    original = getattr(obj, method)

    def run(*args, **kw):
        t0 = time.perf_counter()
        out = original(*args, **kw)
        ds = getattr(out, "cleaned", out)
        store.append((time.perf_counter() - t0,
                      getattr(ds, "n_rows", None)))
        if keep is not None:
            keep.append(out)
        return out
    setattr(obj, method, run)
    try:
        yield store
    finally:
        setattr(obj, method, original)


def events_dataset_digest(ds) -> str:
    """A digest of a reader's dataset: column names, kinds, keys, values
    and nulls (repr of every cell, NaN and None kept apart)."""
    import hashlib
    h = hashlib.sha256()
    for name in ds.column_names():
        col = ds.column(name)
        h.update(f"{name}:{col.kind}:{col.data.dtype}".encode())
        if col.data.dtype.kind == "f":
            h.update(col.data.tobytes())
        else:
            for v in col.data:
                h.update(repr(sorted(v) if isinstance(v, set)
                              else v).encode())
    return h.hexdigest()


def events_leg_run(log: dict, device) -> dict:
    """One run of workflow-events' CPU-against-card leg: the events flow
    with `wide_selector(leg=True)` trained on `device` with its refit
    levels recorded, the two readers' datasets digested, RawFeatureFilter's
    drops and exclusion reasons kept, and the score snapshot scored."""
    from transmogrifai_tpu_torch.utils.uid import reset_uids
    reset_uids()
    wf, pred, score = events_workflow(port_events_pkg(), log,
                                      wide_selector(leg=True), device)
    t0 = time.perf_counter()
    with record_refit_levels([]) as levels:
        model = wf.train()
    train_s = time.perf_counter() - t0
    score_ds = score.generate_dataset(model.raw_features())
    return dict(
        model=model, pred=pred, levels=levels, train_s=train_s,
        digests=[events_dataset_digest(wf._reader.generate_dataset(
            model.raw_features())), events_dataset_digest(score_ds)],
        blacklist=list(model.blacklist),
        reasons=[r.to_json() for r in
                 model.rff_results.exclusion_reasons],
        scored=model.score(score_ds).data(pred.name))


def workflow_events_phase(users: int, seed: int):
    """An event log through the data-prep flow (`event_log`,
    `events_workflow`): the profiles through an AggregateReader and the
    events, left-outer joined and re-aggregated around a day-45 cutoff
    (`with_secondary_aggregation`), RawFeatureFilter with the day-52
    snapshot's reader as its score reader, transmogrify, SanityChecker()
    and `wide_selector()` (LR's default grid, RF 10 trees at depth {3, 6},
    GBT 10 rounds at depth 4, 3 folds) inside Workflow().train(), then
    score() of the score snapshot's users (the dataset the filter's score
    reader made inside train(): each snapshot is read once).

    The leg at `EVENTS_LEG_USERS` users with `wide_selector(leg=True)` on
    the CPU and on the card: the two readers' datasets, RawFeatureFilter's
    drops and exclusion reasons, the matrix and the winner identical, the
    scores within 1e-5 a row or a tie witness (`compare_runs`).

    The main path: `users` users on the card. Each reader's wall and rows,
    RawFeatureFilter's wall and its drops with their reasons (exactly
    `EVENTS_DROPS`, each for its own reason), the width, the
    SanityChecker's flags, train and score walls, each family's sweep, peak
    device memory, the winner and the holdout AuPR against the prevalence;
    launch counters reset just before train() and read just after, every
    kernel launched; each kernel at every (kernel, F, S, C, Fo) key of
    train() on the inputs of its first launch against its plain version
    (rows of the kernels line, phase "events"). Returns (ok, launches by
    capture key, kernel rows)."""
    import numpy as np
    import torch
    from transmogrifai_tpu_torch.ops import tree_kernels as TK
    from transmogrifai_tpu_torch.readers import readers as R
    from transmogrifai_tpu_torch.filters import RawFeatureFilter
    from transmogrifai_tpu_torch.utils.uid import reset_uids

    t_phase = t0 = time.perf_counter()
    small = event_log(EVENTS_LEG_USERS, seed + 31)
    legs = {dev or "cuda": events_leg_run(small, dev)
            for dev in ("cpu", None)}
    cpu, card = legs["cpu"], legs["cuda"]
    cmp = dict(compare_runs(cpu, card), users=EVENTS_LEG_USERS,
               readers_identical=cpu["digests"] == card["digests"],
               rff_identical=(cpu["blacklist"] == card["blacklist"]
                              and cpu["reasons"] == card["reasons"]),
               blacklist=card["blacklist"], train_s_cpu=cpu["train_s"],
               train_s_cuda=card["train_s"])
    leg_s = time.perf_counter() - t0
    log(f"workflow-events cpu-vs-card ({leg_s:.2f}s): " + json.dumps(cmp))
    leg_ok = (runs_agree(cmp) and cmp["readers_identical"]
              and cmp["rff_identical"]
              and sorted(cmp["blacklist"]) == sorted(EVENTS_DROPS))
    del legs, cpu, card, small
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ev_log = event_log(users, seed + 33, EVENTS_MAIN_PER_USER)
    n_events = len(ev_log["events"])
    data_s = time.perf_counter() - t0
    reset_uids()
    wf, pred, _ = events_workflow(port_events_pkg(), ev_log,
                                      wide_selector())
    selector = pred.origin_stage
    reader_walls, rff_walls, read = [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    captured, capture_launches = {}, collections.Counter()
    TK.reset_launches()
    t0 = time.perf_counter()
    with time_calls(R.JoinedAggregateReader, "generate_dataset",
                    reader_walls, read), \
            time_calls(RawFeatureFilter, "apply", rff_walls), \
            capture_kernel_inputs(captured, capture_launches):
        model = wf.train()
    train_s = time.perf_counter() - t0
    launches = dict(TK.launches)
    shape_launches = dict(TK.shape_launches)
    capture_launches = dict(capture_launches)
    train_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    sel = model.selector_summary()
    sc = model.sanity_checker_summary()
    vec, _ = vector_names(model)
    width = int(model._train_data.data(vec).shape[1])
    label = model._train_data.data("purchased")
    prevalence = float(np.mean(label))
    best = max(sel.validation_results, key=lambda v: v["mean_metric"])
    families = family_results(sel, selector)
    walls = stage_walls(model)
    rff = model.rff_results
    reasons = {r.name: [k for k in ("low_fill_rate", "high_fill_rate_diff",
                                    "high_fill_ratio_diff",
                                    "high_js_divergence", "null_leakage")
                        if getattr(r, k)]
               for r in rff.exclusion_reasons
               if r.key is None and r.excluded}
    js = {r.name: r.js_divergence for r in rff.exclusion_reasons
          if r.name in EVENTS_DROPS}
    model._train_data = None
    score_ds = read[-1]
    del read
    t0 = time.perf_counter()
    scored = model.score(score_ds)
    score_s = time.perf_counter() - t0
    probs = scored.data(pred.name)
    main_s = time.perf_counter() - t_phase - leg_s
    rows_out = kernel_rows([captured_shape(key, *captured[key],
                                           prefix="workflow-events")
                            for key in sorted(captured)], phase="events")
    del captured
    torch.cuda.empty_cache()
    res = dict(
        users=users, events=n_events, phase_s=time.perf_counter() - t_phase,
        leg_s=leg_s, main_s=main_s, data_s=data_s,
        reader_walls_s_rows=dict(zip(("train", "score"), reader_walls)),
        rff_s=[w for w, _ in rff_walls], rff_drops=reasons,
        rff_js_of_seeded=js, train_s=train_s, score_s=score_s,
        stage_walls_s=walls, selector_walls_s=selector.walls,
        width=width, flagged=len(sc.dropped),
        winner=[sel.best_model_name, sel.best_grid],
        winner_cv_aupr=best["mean_metric"],
        holdout_aupr=sel.holdout_evaluation.get("au_pr"),
        holdout_auroc=sel.holdout_evaluation.get("au_roc"),
        prevalence=prevalence, families=families,
        peak_device_gb_train=train_peak_gb,
        peak_device_gb=torch.cuda.max_memory_allocated() / 1e9,
        launches=launches, shape_launches=shape_launches,
        capture_launches=capture_launches)
    log("workflow-events: " + json.dumps(res))
    by_shape = collections.Counter()
    for key, n in capture_launches.items():
        by_shape[launch_key(key)] += n
    ok = (leg_ok and sorted(model.blacklist) == sorted(EVENTS_DROPS)
          and reasons == {"balance": ["high_js_divergence"],
                          "referral": ["low_fill_rate"],
                          "supportTicket": ["null_leakage"]}
          and len(reader_walls) == 2
          and all(n == users for _, n in reader_walls)
          and all(n > 0 for n in launches.values())
          and set(launches) == set(TK.KERNELS)
          and {r["key"] for r in rows_out} == set(capture_launches)
          and dict(by_shape) == shape_launches
          and set(families) == {"OpLogisticRegression",
                                "OpRandomForestClassifier",
                                "OpGBTClassifier"}
          and probs.shape[0] == users
          and bool(np.isfinite(probs).all())
          and best["mean_metric"] > prevalence
          and sel.holdout_evaluation["au_pr"] > prevalence)
    return ok, capture_launches, rows_out


# workflow-regression: op_boston's flow at user scale
HOUSING_PREDICTORS = ("crim", "zn", "indus", "chas", "nox", "rm", "age",
                      "dis", "rad", "tax", "ptratio", "b", "lstat")


def housing_columns(n: int, seed: int) -> dict:
    """op_boston's housing records as numpy columns, all 13 predictors of
    `HOUSING_COLUMNS`: op_boston's `synthetic_housing` draws for crim, rm,
    age, dis, tax, ptratio and lstat (vectorised), zn (73% zero, else 12.5
    to 100 in steps of 2.5), indus, nox, b (396.9 less an exponential
    tail), chas a PickList "0"/"1" (7% "1"), rad an Integral of the UCI
    file's nine values; every Real 2% missing. medv, the RealNN response,
    adds nox, chas, dis and zn terms to op_boston's and is clipped to [5,
    50] as the file's is. Returns {name: (feature type name, float64 with
    NaN, or objects)}."""
    import numpy as np
    rng = np.random.default_rng(seed)
    crim = rng.lognormal(-1.5, 1.8, n)
    zn = np.where(rng.uniform(size=n) < 0.73, 0.0,
                  2.5 * rng.integers(5, 41, n))
    indus = rng.uniform(0.46, 27.74, n)
    chas = rng.uniform(size=n) < 0.07
    nox = rng.uniform(0.385, 0.871, n)
    rm = np.clip(rng.normal(6.3, 0.7, n), 3.5, 8.8)
    age = rng.uniform(2, 100, n)
    dis = rng.lognormal(1.2, 0.5, n)
    rad = rng.choice([1, 2, 3, 4, 5, 6, 7, 8, 24], n,
                     p=[.04, .05, .08, .22, .23, .05, .03, .04, .26])
    tax = rng.uniform(187, 711, n)
    ptratio = rng.uniform(12.6, 22.0, n)
    b = np.clip(396.9 - rng.exponential(30.0, n), 0.32, 396.9)
    lstat = np.clip(rng.lognormal(2.4, 0.5, n), 1.7, 38)
    medv = np.clip(
        22.5 + 5.0 * (rm - 6.3) - 0.6 * lstat / 3.0 - 1.2 * np.log1p(crim)
        - 0.3 * (ptratio - 18) - 6.0 * (nox - 0.55) + 2.5 * chas
        - 1.0 * np.log(dis) + 0.02 * zn + rng.normal(0, 2.5, n), 5, 50)
    reals = dict(crim=crim, zn=zn, indus=indus, nox=nox, rm=rm, age=age,
                 dis=dis, tax=tax, ptratio=ptratio, b=b, lstat=lstat)
    cols = {}
    for name in HOUSING_PREDICTORS:
        if name == "chas":
            cols[name] = ("PickList",
                          np.where(chas, "1", "0").astype(object))
        elif name == "rad":
            cols[name] = ("Integral", rad.astype(np.float64))
        else:
            v = reals[name].astype(np.float64)
            v[rng.uniform(size=n) < 0.02] = np.nan
            cols[name] = ("Real", v)
    cols["medv"] = ("RealNN", medv.astype(np.float64))
    return cols


def regression_selector():
    """workflow-regression's selector: RegressionModelSelector's 3-fold
    CrossValidation (a DataSplitter's 10% holdout, RMSE) over linear
    regression's default grid (8 points), random forests of 10 trees at
    depth {3, 6} and Spark GBT of 10 rounds at depth 4 (workflow-wide's
    cut of the tree grids)."""
    from transmogrifai_tpu_torch.automl.selectors import (
        RegressionModelSelector, default_grid_for)
    from transmogrifai_tpu_torch.models.glm import OpLinearRegression
    from transmogrifai_tpu_torch.models.trees import (
        OpGBTRegressor, OpRandomForestRegressor)
    return RegressionModelSelector.with_cross_validation(
        num_folds=3, seed=42, models_and_parameters=[
            (OpLinearRegression(), default_grid_for("OpLinearRegression")),
            (OpRandomForestRegressor(), [
                dict(num_trees=10, max_depth=d, min_instances_per_node=10)
                for d in (3, 6)]),
            (OpGBTRegressor(), [dict(max_iter=10, max_depth=4)])])


def regression_workflow(cols: dict, device=None):
    """(workflow, prediction) of op_boston's flow in the port over a
    Dataset of `housing_columns`: the example's features (chas a PickList,
    rad an Integral, the rest Reals) -> transmogrify -> SanityChecker() ->
    `regression_selector()` -> Workflow(device).with_workflow_cv()."""
    from transmogrifai_tpu_torch import types as T
    from transmogrifai_tpu_torch.automl.preparators import SanityChecker
    from transmogrifai_tpu_torch.automl.transmogrifier import transmogrify
    from transmogrifai_tpu_torch.data.dataset import Column, Dataset
    from transmogrifai_tpu_torch.examples import op_boston as EX
    from transmogrifai_tpu_torch.workflow import Workflow
    medv, feats = EX.housing_features(list(HOUSING_PREDICTORS))
    checked = SanityChecker().set_input(medv, transmogrify(feats)) \
        .get_output()
    pred = regression_selector().set_input(medv, checked).get_output()
    wf = Workflow(device=device).set_input_dataset(
        wide_dataset(cols, Dataset, Column, T)).set_result_features(pred)
    return wf.with_workflow_cv(), pred


def regression_scores(model, pred, cols: dict):
    """The predictions of `model` for the rows of `cols`, float64 [n]."""
    import numpy as np
    from transmogrifai_tpu_torch import types as T
    from transmogrifai_tpu_torch.data.dataset import Column, Dataset
    out = model.score(wide_dataset(cols, Dataset, Column, T)).data(pred.name)
    return np.asarray(out, np.float64)[:, 0]


@contextlib.contextmanager
def record_sweep_levels(levels: list, store: list):
    """Inside the block (nested in `record_refit_levels(levels)`), each
    mask-fold sweep fit of a tree estimator moves the level records it
    left in `levels` into a segment of its own in `store`, in call order:
    {"model": its class name, "params": its param values, "levels": the
    records}. A workflow-CV fold sweeps with one fold mask, so its tree
    fits are one-lane calls too; what stays in `levels` is the refit's."""
    from transmogrifai_tpu_torch.models import trees as M
    originals = {cls: cls.__dict__["mask_fit_scores"]
                 for cls in (M._ForestBase, M._GBTBase, M._XGBBase)}

    def wrap(original):
        def run(self, *args, **kw):
            n = len(levels)
            try:
                return original(self, *args, **kw)
            finally:
                store.append(dict(model=type(self).__name__,
                                  params=self.param_values(),
                                  levels=levels[n:]))
                del levels[n:]
        return run
    for cls, fn in originals.items():
        setattr(cls, "mask_fit_scores", wrap(fn))
    try:
        yield store
    finally:
        for cls, fn in originals.items():
            setattr(cls, "mask_fit_scores", fn)


def sweep_segment(segments: list, cell: dict, fold: int):
    """The segment of `record_sweep_levels` that fitted `cell` (a
    validation result: model name and grid) in its `fold`-th sweep."""
    hits = [sg for sg in segments if sg["model"] == cell["model_name"]
            and all(sg["params"].get(k) == v
                    for k, v in cell["grid"].items())]
    return hits[fold] if fold < len(hits) else None


def regression_leg_run(cols: dict, new: dict, device) -> dict:
    """One run of workflow-regression's leg: `regression_workflow(cols,
    device)` trained with its refit levels recorded, then scored on
    `new`."""
    from transmogrifai_tpu_torch.utils.uid import reset_uids
    reset_uids()
    wf, pred = regression_workflow(cols, device=device)
    t0 = time.perf_counter()
    with record_refit_levels([]) as levels, \
            record_sweep_levels(levels, []) as sweeps:
        model = wf.train()
    return dict(model=model, pred=pred, levels=levels, sweeps=sweeps, wf=wf,
                train_s=time.perf_counter() - t0,
                scored=regression_scores(model, pred, new))


def rel_diff(a, b) -> float:
    """The largest |a - b| relative to max(1, |b|), elementwise."""
    import numpy as np
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float((np.abs(a - b) / np.maximum(np.abs(b), 1.0)).max())


def fold_levels(levels: list, fold: int, n_folds: int) -> list:
    """The records of `levels` (`record_refit_levels(all_lanes=True)`) of
    fold `fold`'s lanes: a sweep fit's lanes are its folds, or, for a
    softmax fit, fold-major groups of class trees."""
    return [r for r in levels
            if r.get("lanes", 1) == 1
            or r["lane"] // max(r["lanes"] // n_folds, 1) == fold]


def compare_regression_runs(a: dict, b: dict, workflow_cv: bool = True,
                            n_folds: int = 1) -> dict:
    """Two trained runs of the regression flow side by side: the
    transmogrified matrix and metadata, the SanityChecker's drops, the
    winner, each workflow-CV cell's fold metrics (relative difference),
    the scores (absolute and relative to max(1, |score|)), and where the
    refits split a node differently, the first such node's
    `split_witness`. A fold metric further apart than 1e-3 relative gets
    the witness of the first node its own sweep fits split differently
    (`record_sweep_levels`): a tied split, resolved by f32 noise one way
    on one run and the other way on the other, explains it."""
    import numpy as np
    am, bm = a["model"], b["model"]
    vec, checked = vector_names(am)
    ax, bx = am._train_data.column(vec), bm._train_data.column(vec)
    asc, bsc = am.sanity_checker_summary(), bm.sanity_checker_summary()
    asel, bsel = am.selector_summary(), bm.selector_summary()
    acv = [v for v in asel.validation_results
           if v.get("workflow_cv") or not workflow_cv]
    bcv = [v for v in bsel.validation_results
           if v.get("workflow_cv") or not workflow_cv]
    names = am._train_data.column(checked).metadata.column_names()
    cells, apart, mlp_apart = {}, [], []
    for x, y in zip(acv, bcv):
        if (x["model_name"], x["grid"]) != (y["model_name"], y["grid"]):
            continue
        key = f"{x['model_name']} {x['grid']}"
        cells[key] = rel_diff(x["fold_metrics"], y["fold_metrics"])
        if x["model_name"] == "OpMultilayerPerceptronClassifier":
            # no tree split to witness: the MLP's own bound
            if cells[key] > MLP_FOLD_TOL:
                mlp_apart.append(dict(cell=key, rel_diff=cells[key]))
            continue
        for f, (p, q) in enumerate(zip(x["fold_metrics"],
                                       y["fold_metrics"])):
            d = rel_diff(p, q)
            if d <= 1e-3:
                continue
            # a workflow-CV fold sweeps alone (its f-th sweep); a plain
            # CV sweep fits every fold as lanes of one call
            sa = sweep_segment(a["sweeps"], x, f if workflow_cv else 0)
            sb = sweep_segment(b["sweeps"], y, f if workflow_cv else 0)
            la, lb = ((None, None) if sa is None or sb is None
                      else (sa["levels"], sb["levels"]) if workflow_cv
                      else (fold_levels(sa["levels"], f, n_folds),
                            fold_levels(sb["levels"], f, n_folds)))
            first = None if la is None else first_divergence(la, lb)
            apart.append(dict(cell=key, fold=f, rel_diff=d,
                              witness=None if first is None else
                              split_witness(la, lb, *first,
                                            sa["params"]["max_depth"],
                                            names)))
    first = first_divergence(a["levels"], b["levels"])
    witness = None if first is None else split_witness(
        a["levels"], b["levels"], *first,
        asel.best_grid.get("max_depth", 0), names)
    return dict(
        width=int(bx.data.shape[1]),
        matrix_identical=ax.data.tobytes() == bx.data.tobytes(),
        metadata_identical=ax.metadata.to_json() == bx.metadata.to_json(),
        same_drops=(asc.dropped == bsc.dropped
                    and list(asc.drop_reasons) == list(bsc.drop_reasons)),
        winner=[[asel.best_model_name, asel.best_grid],
                [bsel.best_model_name, bsel.best_grid]],
        same_winner=(asel.best_model_name, asel.best_grid)
        == (bsel.best_model_name, bsel.best_grid),
        cv_cells=len(acv), same_cells=len(cells) == len(acv) == len(bcv) > 0,
        max_cell_rel_diff=max(cells.values()) if cells else None,
        cell_rel_diffs={k: v for k, v in cells.items() if v},
        cells_apart=apart, mlp_cells_apart=mlp_apart,
        max_score_diff=float(np.abs(a["scored"] - b["scored"]).max()),
        max_score_rel_diff=rel_diff(a["scored"], b["scored"]),
        scored_rows=len(a["scored"]), witness=witness)


def regression_runs_agree(cmp: dict) -> bool:
    """compare_regression_runs' verdict: identical matrix, metadata and
    drops, the same winner, every CV fold metric within 1e-3 relative or,
    further apart, a tie at the first node its sweep fits split
    differently (an MLP cell within MLP_FOLD_TOL), and the scores within 1e-5 relative or a tie at the first
    node the refits split differently."""
    return (cmp["matrix_identical"] and cmp["metadata_identical"]
            and cmp["same_drops"] and cmp["same_winner"]
            and cmp["same_cells"] and not cmp["mlp_cells_apart"]
            and all(c["witness"] is not None and c["witness"]["tie"]
                    for c in cmp["cells_apart"])
            and (cmp["max_score_rel_diff"] <= 1e-5
                 or (cmp["witness"] is not None and cmp["witness"]["tie"])))


def workflow_regression_phase(rows: int, seed: int):
    """op_boston's flow at user scale (`housing_columns`, all 13
    predictors): transmogrify -> SanityChecker() -> `regression_selector()`
    inside Workflow(device="cuda").with_workflow_cv().train(): every fold
    refits the transmogrify and SanityChecker stages on its train rows and
    sweeps linear regression (the Gram route), the forests and the GBT on
    its matrix with the fold as one mask; the winner is refit on all rows.

    The leg at `REGRESSION_LEG_ROWS` rows, once on the CPU and twice on the
    card (C1: the histogram kernels flush float atomics in no fixed
    order): the matrix identical, the same winner, each workflow-CV fold
    metric within 1e-3 relative or, further apart, explained by a tie at
    the first node that cell's sweep fits split differently (a forest's
    per-node feature subsets follow the node ids, so a tie between
    complementary one-hot columns, which mirrors the children, grows
    another forest below it), the scores of new rows within 1e-5 relative
    or a tie witness (`compare_regression_runs`).

    The main path: `rows` rows on the card. Launch counters are reset just
    before train() and read just after: every kernel must have launched.
    Each stage's wall, each fold's during-DAG refit, transform and sweep
    with each family's sweep, the train wall, the GLM route (it must be
    the Gram route), peak device memory, the winner, its CV RMSE, the
    holdout RMSE and R2 beside the label's standard deviation (R2 must be
    above 0). Then `REGRESSION_SCORE_ROWS` new rows scored, the model saved
    to a temporary directory (wall, bytes), loaded and scored again: the
    scores identical; loaded again with device="cpu", its scores of
    `REGRESSION_CPU_LOAD_ROWS` rows within 1e-5 relative of the card's.
    Each kernel at every (kernel, F, S, C, Fo) key of train() on the inputs
    of its first launch against its plain version (rows of the kernels
    line, phase "regression"). Returns (ok, launches by capture key,
    kernel rows)."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from transmogrifai_tpu_torch.ops import tree_kernels as TK
    from transmogrifai_tpu_torch.utils.uid import reset_uids
    from transmogrifai_tpu_torch.workflow import WorkflowModel

    t_phase = t0 = time.perf_counter()
    small = housing_columns(REGRESSION_LEG_ROWS, seed + 41)
    small_new = housing_columns(REGRESSION_LEG_ROWS, seed + 42)
    runs = [regression_leg_run(small, small_new, dev)
            for dev in ("cpu", None, None)]
    c1 = compare_regression_runs(runs[1], runs[2])
    cmp = compare_regression_runs(runs[0], runs[1])
    leg = dict(rows=REGRESSION_LEG_ROWS, cpu_vs_card=cmp, card_vs_card=c1,
               train_s=[r["train_s"] for r in runs],
               cpu_stage_walls_s=stage_walls(runs[0]["model"]),
               cpu_fold_walls_s=runs[0]["wf"].workflow_cv_walls)
    leg_s = time.perf_counter() - t0
    log(f"workflow-regression leg ({leg_s:.2f}s): " + json.dumps(leg))
    leg_ok = regression_runs_agree(cmp) and regression_runs_agree(c1)
    del runs
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    cols = housing_columns(rows, seed + 43)
    new = housing_columns(REGRESSION_SCORE_ROWS, seed + 44)
    data_s = time.perf_counter() - t0
    reset_uids()
    wf, pred = regression_workflow(cols)
    selector = pred.origin_stage
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    captured, capture_launches = {}, collections.Counter()
    TK.reset_launches()
    t0 = time.perf_counter()
    with capture_kernel_inputs(captured, capture_launches):
        model = wf.train()
    train_s = time.perf_counter() - t0
    launches = dict(TK.launches)
    shape_launches = dict(TK.shape_launches)
    capture_launches = dict(capture_launches)
    train_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    sel = model.selector_summary()
    sc = model.sanity_checker_summary()
    vec, _ = vector_names(model)
    width = int(model._train_data.data(vec).shape[1])
    label_std = float(np.std(cols["medv"][1]))
    cv_cells = [v for v in sel.validation_results if v.get("workflow_cv")]
    best = min(cv_cells, key=lambda v: v["mean_metric"])
    families = sorted({v["model_name"] for v in cv_cells})
    telemetry = selector.validator.last_streamed_telemetry or {}
    glm_routes = sorted({r for (m, _), r in wf.workflow_cv_routes.items()
                         if m == 0})
    walls = stage_walls(model)
    model._train_data = None
    del cols

    t0 = time.perf_counter()
    scored = regression_scores(model, pred, new)
    score_s = time.perf_counter() - t0
    tmp = tempfile.mkdtemp(prefix="regression-model-")
    try:
        path = os.path.join(tmp, "model")
        t0 = time.perf_counter()
        model.save(path)
        save_s = time.perf_counter() - t0
        artifact = {f: os.path.getsize(os.path.join(path, f))
                    for f in sorted(os.listdir(path))}
        t0 = time.perf_counter()
        loaded = WorkflowModel.load(path, device="cuda")
        load_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        rescored = regression_scores(loaded, pred, new)
        rescore_s = time.perf_counter() - t0
        on_cpu = WorkflowModel.load(path, device="cpu")
        few = {k: (t, v[:REGRESSION_CPU_LOAD_ROWS])
               for k, (t, v) in new.items()}
        cpu_scored = regression_scores(on_cpu, pred, few)
    finally:
        shutil.rmtree(tmp)
    reload_identical = bool(np.array_equal(scored, rescored))
    cpu_load_rel = rel_diff(cpu_scored, scored[:REGRESSION_CPU_LOAD_ROWS])
    cpu_load_abs = float(np.abs(
        cpu_scored - scored[:REGRESSION_CPU_LOAD_ROWS]).max())
    main_s = time.perf_counter() - t_phase - leg_s
    rows_out = kernel_rows([captured_shape(key, *captured[key],
                                           prefix="workflow-regression")
                            for key in sorted(captured)], phase="regression")
    del captured, loaded, on_cpu
    torch.cuda.empty_cache()
    res = dict(
        rows=rows, phase_s=time.perf_counter() - t_phase, leg_s=leg_s,
        main_s=main_s, data_s=data_s, train_s=train_s,
        stage_walls_s=walls, fold_walls_s=wf.workflow_cv_walls,
        family_sweep_s_final=selector.validator.family_walls,
        selector_walls_s=selector.walls, glm_routes=glm_routes,
        glm_kernel=telemetry.get("kernel"),
        glm_telemetry=telemetry, width=width, flagged=len(sc.dropped),
        winner=[sel.best_model_name, sel.best_grid],
        winner_cv_rmse=best["mean_metric"],
        cv_cells={f"{v['model_name']} {v['grid']}": v["mean_metric"]
                  for v in cv_cells},
        holdout_rmse=sel.holdout_evaluation.get("rmse"),
        holdout_r2=sel.holdout_evaluation.get("r2"),
        label_std=label_std, score_s=score_s,
        score_rows=REGRESSION_SCORE_ROWS, save_s=save_s, load_s=load_s,
        rescore_s=rescore_s, artifact_bytes=artifact,
        reload_identical=reload_identical,
        cpu_load_rows=REGRESSION_CPU_LOAD_ROWS,
        cpu_load_max_abs_diff=cpu_load_abs,
        cpu_load_max_rel_diff=cpu_load_rel,
        peak_device_gb_train=train_peak_gb,
        peak_device_gb=torch.cuda.max_memory_allocated() / 1e9,
        launches=launches, shape_launches=shape_launches,
        capture_launches=capture_launches)
    log("workflow-regression: " + json.dumps(res))
    by_shape = collections.Counter()
    for key, n in capture_launches.items():
        by_shape[launch_key(key)] += n
    ok = (leg_ok and all(n > 0 for n in launches.values())
          and set(launches) == set(TK.KERNELS)
          and {r["key"] for r in rows_out} == set(capture_launches)
          and dict(by_shape) == shape_launches
          and families == ["OpGBTRegressor", "OpLinearRegression",
                           "OpRandomForestRegressor"]
          and len(cv_cells) == 11
          and glm_routes == ["streamed"] and res["glm_kernel"] == "gram"
          and scored.shape == (REGRESSION_SCORE_ROWS,)
          and bool(np.isfinite(scored).all())
          and reload_identical and cpu_load_rel <= 1e-5
          and sel.holdout_evaluation["r2"] > 0.0)
    return ok, capture_launches, rows_out


COVERTYPE_INTEGRALS = ("elevation", "aspect", "slope", "hillshade9am",
                       "hillshadeNoon", "hillshade3pm")
COVERTYPE_REALS = ("horizontalDistanceToHydrology",
                   "verticalDistanceToHydrology",
                   "horizontalDistanceToRoadways",
                   "horizontalDistanceToFirePoints")
# per quantitative column: (overall mean, spread of the class means, the
# within-class std, lower clip, upper clip), in the order of the two tuples
_COVERTYPE_NUMERIC = (
    (2960, 250, 160, 1859, 3858), (156, 40, 110, 0, 360),
    (14, 4, 7, 0, 66), (220, 90, 190, 0, 1397), (230, 30, 150, 0, 254),
    (142, 25, 38, 0, 254), (270, 80, 210, 0, 1397), (46, 20, 58, -173, 601),
    (2350, 700, 1400, 0, 7117), (1980, 500, 1300, 0, 7173))


def covertype_columns(n: int, seed: int) -> dict:
    """Covertype-shaped records (Blackard & Dean 1999, UCI Covertype) as
    numpy columns, synthesised from `seed`: the 10 quantitative columns
    (elevation, aspect, slope and the three hillshades Integral; the
    distances to hydrology, roadways and fire points Real), each 1%
    missing; wilderness area a PickList of 4 values and soil type one of
    40; the cover type (1..7, a RealNN) at the published class counts
    (`COVERTYPE_CLASS_COUNTS`, scaled to `n`). Each class has its own
    Gaussian means of the numerics and its own category shares of the two
    PickLists, drawn once from `COVERTYPE_CLASS_SEED` so that every call
    draws its rows (from `seed`) from the same classes. Returns {name:
    (feature type name, float64 with NaN, or objects)}."""
    import numpy as np
    rng = np.random.default_rng(seed)
    classes = np.random.default_rng(COVERTYPE_CLASS_SEED)
    share = np.array(COVERTYPE_CLASS_COUNTS, np.float64)
    counts = np.floor(n * share / share.sum()).astype(np.int64)
    counts[np.argsort(-(n * share / share.sum() - counts))[
        :n - counts.sum()]] += 1
    label = rng.permutation(np.repeat(np.arange(7), counts))
    cols = {}
    for name, (mean, spread, std, lo, hi) in zip(
            COVERTYPE_INTEGRALS[:3] + COVERTYPE_REALS[:2]
            + COVERTYPE_INTEGRALS[3:] + COVERTYPE_REALS[2:],
            _COVERTYPE_NUMERIC):
        means = mean + spread * classes.standard_normal(7)
        v = np.clip(means[label] + std * rng.standard_normal(n), lo, hi)
        kind = "Integral" if name in COVERTYPE_INTEGRALS else "Real"
        if kind == "Integral":
            v = np.round(v)
        v[rng.uniform(size=n) < 0.01] = np.nan
        cols[name] = (kind, v)
    for name, k, conc in (("wildernessArea", 4, 0.7), ("soilType", 40, 0.3)):
        probs = classes.dirichlet(np.full(k, conc), size=7)
        cum = probs.cumsum(1)
        idx = (rng.uniform(size=n)[:, None] > cum[label]).sum(1)
        idx = np.minimum(idx, k - 1)
        names = np.array([f"{name[:4]}{i + 1}" for i in range(k)], object)
        cols[name] = ("PickList", names[idx])
    cols["coverType"] = ("RealNN", (label + 1).astype(np.float64))
    return cols


def covertype_features():
    """(coverType response, predictors) of `covertype_columns` with the
    port's FeatureBuilder."""
    from transmogrifai_tpu_torch.features.builder import FeatureBuilder as FB
    label = FB.RealNN("coverType").as_response()
    feats = [getattr(FB, kind)(name).as_predictor() for name, kind in
             [(n, "Integral") for n in COVERTYPE_INTEGRALS]
             + [(n, "Real") for n in COVERTYPE_REALS]
             + [("wildernessArea", "PickList"), ("soilType", "PickList")]]
    return label, feats


def mlp_random_grid() -> list:
    """The MLP's grid in workflow-multiclass: 2 points drawn by
    RandomParamBuilder(`MLP_GRID_SEED`) over the step size (uniform in
    [0.02, 0.2]) and the hidden layers ([10] or [10, 10])."""
    from transmogrifai_tpu_torch.automl.random_param import (
        RandomParamBuilder)
    return RandomParamBuilder(MLP_GRID_SEED).uniform("step_size", 0.02, 0.2) \
        .subset("hidden_layers", [[10], [10, 10]]).build(2)


def multiclass_selector():
    """workflow-multiclass's selector: MultiClassificationModelSelector's
    3-fold CrossValidation (DataCutter, the multiclass error) over
    logistic regression's default grid (8 points, softmax on the vmapped
    route), random forests of 10 trees at depth {3, 6}, XGBoost of 10
    rounds at depth 4 (softmax: 7 class lanes a fold), naive Bayes and the
    MLP of `MLP_STEPS` Adam steps over `mlp_random_grid()` (sequential)."""
    from transmogrifai_tpu_torch.automl.selectors import (
        MultiClassificationModelSelector, default_grid_for)
    from transmogrifai_tpu_torch.models.glm import (
        OpLogisticRegression, OpNaiveBayes)
    from transmogrifai_tpu_torch.models.mlp import (
        OpMultilayerPerceptronClassifier)
    from transmogrifai_tpu_torch.models.trees import (
        OpRandomForestClassifier, OpXGBoostClassifier)
    return MultiClassificationModelSelector.with_cross_validation(
        num_folds=3, seed=42, models_and_parameters=[
            (OpLogisticRegression(), default_grid_for("OpLogisticRegression")),
            (OpRandomForestClassifier(), [
                dict(num_trees=10, max_depth=d, min_instances_per_node=10)
                for d in (3, 6)]),
            (OpXGBoostClassifier(), [dict(num_round=10, max_depth=4,
                                          eta=0.3)]),
            (OpNaiveBayes(), default_grid_for("OpNaiveBayes")),
            (OpMultilayerPerceptronClassifier(max_iter=MLP_STEPS),
             mlp_random_grid())])


def multiclass_workflow(cols: dict, device=None):
    """(workflow, prediction) of the Covertype flow in the port over a
    Dataset of `covertype_columns`: transmogrify -> SanityChecker() ->
    `multiclass_selector()` -> Workflow(device)."""
    from transmogrifai_tpu_torch import types as T
    from transmogrifai_tpu_torch.automl.preparators import SanityChecker
    from transmogrifai_tpu_torch.automl.transmogrifier import transmogrify
    from transmogrifai_tpu_torch.data.dataset import Column, Dataset
    from transmogrifai_tpu_torch.workflow import Workflow
    label, feats = covertype_features()
    checked = SanityChecker().set_input(label, transmogrify(feats)) \
        .get_output()
    pred = multiclass_selector().set_input(label, checked).get_output()
    wf = Workflow(device=device).set_input_dataset(
        wide_dataset(cols, Dataset, Column, T)).set_result_features(pred)
    return wf, pred


def multiclass_scores(model, pred, cols: dict):
    """The scores of `model` for the rows of `cols`: float64 [n, 8], the
    predicted cover type and the 7 class probabilities (the raw scores, a
    model's own logits or vote sums, are left out)."""
    import numpy as np
    from transmogrifai_tpu_torch import types as T
    from transmogrifai_tpu_torch.data.dataset import Column, Dataset
    from transmogrifai_tpu_torch.models.prediction import (prediction_of,
                                                           probability_of)
    col = model.score(wide_dataset(cols, Dataset, Column, T)).column(
        pred.name)
    return np.concatenate([prediction_of(col)[:, None], probability_of(col)],
                          axis=1).astype(np.float64)


def multiclass_leg_run(cols: dict, new: dict, device) -> dict:
    """One run of workflow-multiclass's leg: `multiclass_workflow(cols,
    device)` trained with every tree fit's levels recorded, lane by lane
    (`record_refit_levels(all_lanes=True)`, the sweep's in segments), then
    scored on `new`."""
    from transmogrifai_tpu_torch.utils.uid import reset_uids
    reset_uids()
    wf, pred = multiclass_workflow(cols, device=device)
    t0 = time.perf_counter()
    with record_refit_levels([], all_lanes=True) as levels, \
            record_sweep_levels(levels, []) as sweeps:
        model = wf.train()
    return dict(model=model, pred=pred, levels=levels, sweeps=sweeps, wf=wf,
                train_s=time.perf_counter() - t0,
                scored=multiclass_scores(model, pred, new))


def span_self_times(trace, kind: str) -> dict:
    """Self seconds of the spans of `kind` in a trace tree, summed by name,
    largest first."""
    out = collections.Counter()
    for sp in trace.spans:
        if sp.kind == kind:
            out[sp.name] += trace.self_seconds(sp)
    return dict(out.most_common())


def span_peaks_gb(trace, kinds=("run", "workflow", "layer")) -> dict:
    """Peak device memory (GB) inside each span of `kinds`, by name (the
    largest where a name repeats)."""
    out = {}
    for sp in trace.spans:
        peak = sp.attrs.get("hbm_peak_bytes")
        if sp.kind in kinds and peak is not None:
            out[sp.name] = max(out.get(sp.name, 0.0), peak / 1e9)
    return out


def traced_runner_run(cols: dict, new: dict) -> tuple:
    """The Covertype flow's train() through OpWorkflowRunner(TRAIN): with
    the run-metrics collector off, on (OpParams(collect_stage_metrics=True,
    metrics_location=...)) and off again, each saving its model; then
    SCORE of the traced run's saved model on `new` through a reader. The
    traced run writes train_stage_metrics.json, train_trace.json and
    events.jsonl; `trace_report(check=True)` must return 0 over them. The
    traced train()'s span tree gives the self time of each layer and
    stage, the peak device memory of each workflow and layer span, and
    the kernel records of its tree fits, whose launch counts must add up
    to the dispatchers' counts over that train(), every kernel launched.
    Returns (ok, result)."""
    import shutil
    import tempfile
    import numpy as np
    from transmogrifai_tpu_torch import types as T
    from transmogrifai_tpu_torch.data.dataset import Column, Dataset
    from transmogrifai_tpu_torch.ops import tree_kernels as TK
    from transmogrifai_tpu_torch.readers.readers import Reader
    from transmogrifai_tpu_torch.utils.metrics import collector
    from transmogrifai_tpu_torch.utils.tracing import trace_report_rc
    from transmogrifai_tpu_torch.utils.uid import reset_uids
    from transmogrifai_tpu_torch.workflow import OpParams, OpWorkflowRunner

    class DatasetReader(Reader):     # a reader over a built Dataset
        def __init__(self, ds):
            super().__init__()
            self.ds = ds

        def generate_dataset(self, raw_features):
            return self.ds

    tmp = tempfile.mkdtemp(prefix="runner-")
    try:
        reset_uids()
        wf, pred = multiclass_workflow(cols)
        runner = OpWorkflowRunner(wf, score_reader=DatasetReader(
            wide_dataset(new, Dataset, Column, T)))
        metrics_dir = os.path.join(tmp, "metrics")
        walls = {"off": [], "on": []}
        for turn in ("off", "on", "off"):
            params = OpParams(model_location=os.path.join(tmp, turn))
            if turn == "on":
                params = params.with_values(collect_stage_metrics=True,
                                            metrics_location=metrics_dir)
                TK.reset_launches()
            res = runner.run(OpWorkflowRunner.TRAIN, params)
            walls[turn].append(res.wall_seconds)
            if turn == "on":
                launches = dict(TK.launches)
                trace, app = collector.trace, collector.current
        score = runner.run(OpWorkflowRunner.SCORE, OpParams(
            model_location=os.path.join(tmp, "on"),
            metrics_location=metrics_dir))
        artifacts = sorted(os.listdir(metrics_dir))
        report, rc = trace_report_rc(metrics_dir, check=True)
        text, _ = trace_report_rc(metrics_dir, top=12)
    finally:
        shutil.rmtree(tmp)
    kern = [sp for sp in trace.spans if sp.kind == "kernel"
            and not sp.name.startswith("stats_pass")]
    counted = {k: sum(sp.attrs["launches"][k] for sp in kern)
               for k in TK.KERNELS}
    records = collections.defaultdict(lambda: [0, 0.0, 0.0])
    for sp in kern:
        r = records[f"{sp.name} lanes={sp.attrs['lanes']} "
                    f"depth={sp.attrs['depth']}"]
        r[0] += 1
        r[1] += sp.duration
        r[2] += sp.attrs["bytes_hbm"]
    on_off = walls["on"][0] / float(np.mean(walls["off"]))
    wf_span = next(sp for sp in trace.spans if sp.kind == "workflow")
    res = dict(
        train_wall_s=walls, collector_on_off_ratio=on_off,
        spans=len(trace.spans), workflow_train_s=wf_span.duration,
        layer_self_s=span_self_times(trace, "layer"),
        stage_self_s=dict(list(span_self_times(trace, "stage").items())[:15]),
        sweep_fit_self_s=span_self_times(trace, "sweep_fit"),
        peak_gb=span_peaks_gb(trace),
        kernel_records={k: dict(fits=v[0], s=v[1], gb=v[2] / 1e9)
                        for k, v in records.items()},
        kernel_launches=counted, dispatcher_launches=launches,
        stats_passes=[m.to_json() for m in app.stats_metrics],
        artifacts=artifacts, trace_report_rc=rc,
        score_rows=score.n_rows, score_s=score.wall_seconds)
    log("workflow-multiclass traced runner: " + json.dumps(res, default=str))
    log("workflow-multiclass trace-report:\n" + text)
    ok = (rc == 0 and counted == launches and all(counted.values())
          and {"train_stage_metrics.json", "train_trace.json",
               "events.jsonl", "train_metrics.json",
               "score_metrics.json"} <= set(artifacts)
          and score.n_rows == COVERTYPE_SCORE_ROWS
          and wf_span.attrs.get("hbm_peak_bytes", 0) > 0)
    if rc:
        log(report)
    return ok, res


def workflow_multiclass_phase(rows: int, seed: int):
    """Multiclass at user scale: the Covertype-shaped flow
    (`covertype_columns`, 581 012 rows, 7 cover types) through
    transmogrify -> SanityChecker() -> `multiclass_selector()` inside
    Workflow(device="cuda").train(); then the port's op_iris example on
    the card.

    The leg at `COVERTYPE_LEG_ROWS` rows, once on the CPU and twice on the
    card: the matrix identical, the same drops and winner, each CV fold
    metric (the error) within 1e-3 or, further apart, explained by a tie
    at the first node that cell's fold lanes split differently, the scores
    of new rows within 1e-5 relative or a tie witness in the refit
    (`compare_regression_runs(workflow_cv=False)`).

    The main path: `rows` rows on the card. Launch counters are reset just
    before train() and read just after: every kernel must have launched.
    Each stage's wall, each family's sweep, the train wall, peak device
    memory, the winner, its CV error, the holdout error and top-1
    accuracy beside the majority class's share, the label map (1..7 cut
    to 0..6, predictions mapped back to 1..7). Then
    `COVERTYPE_SCORE_ROWS` new rows scored, the model saved, loaded and
    scored again (identical), loaded with device="cpu" (its scores of
    `COVERTYPE_CPU_LOAD_ROWS` rows within 1e-5 relative of the card's);
    the accuracy on the new rows must beat the majority class's share.
    Then `traced_runner_run` (the same train() through OpWorkflowRunner
    with the run-metrics collector off, on and off: its span tree, kernel
    records, the on/off ratio of the train wall, trace_report, SCORE of
    the saved model), then op_iris.main([]) on the card (its winner, CV
    error and launches).
    Each kernel at every (kernel, F, S, C, Fo) key of the two train()s on
    the inputs of its first launch against its plain version (rows of the
    kernels line, phases "multiclass" and "iris": a forest's K = 7 lanes
    carry C = 9 channels, iris's K = 3 C = 5). Returns (ok, launches by
    capture key of each phase, kernel rows)."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from transmogrifai_tpu_torch.examples import op_iris
    from transmogrifai_tpu_torch.ops import tree_kernels as TK
    from transmogrifai_tpu_torch.tools import hist_paths as HP
    from transmogrifai_tpu_torch.utils.uid import reset_uids
    from transmogrifai_tpu_torch.workflow import WorkflowModel

    t_phase = t0 = time.perf_counter()
    small = covertype_columns(COVERTYPE_LEG_ROWS, seed + 51)
    small_new = covertype_columns(COVERTYPE_LEG_ROWS, seed + 52)
    runs = [multiclass_leg_run(small, small_new, dev)
            for dev in ("cpu", None, None)]
    c1 = compare_regression_runs(runs[1], runs[2], workflow_cv=False,
                                 n_folds=3)
    cmp = compare_regression_runs(runs[0], runs[1], workflow_cv=False,
                                  n_folds=3)
    leg = dict(rows=COVERTYPE_LEG_ROWS, cpu_vs_card=cmp, card_vs_card=c1,
               train_s=[r["train_s"] for r in runs],
               cpu_stage_walls_s=stage_walls(runs[0]["model"]),
               cpu_family_sweep_s=runs[0]["pred"].origin_stage
               .validator.family_walls)
    leg_s = time.perf_counter() - t0
    log(f"workflow-multiclass leg ({leg_s:.2f}s): " + json.dumps(leg))
    leg_ok = regression_runs_agree(cmp) and regression_runs_agree(c1)
    del runs
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    cols = covertype_columns(rows, seed + 53)
    new = covertype_columns(COVERTYPE_SCORE_ROWS, seed + 54)
    data_s = time.perf_counter() - t0
    reset_uids()
    wf, pred = multiclass_workflow(cols)
    selector = pred.origin_stage
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    captured, capture_launches = {}, collections.Counter()
    TK.reset_launches()
    t0 = time.perf_counter()
    with capture_kernel_inputs(captured, capture_launches):
        model = wf.train()
    train_s = time.perf_counter() - t0
    launches = dict(TK.launches)
    shape_launches = dict(TK.shape_launches)
    capture_launches = dict(capture_launches)
    train_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    sel = model.selector_summary()
    sc = model.sanity_checker_summary()
    vec, _ = vector_names(model)
    width = int(model._train_data.data(vec).shape[1])
    labels = cols["coverType"][1]
    majority = float(np.bincount(labels.astype(np.int64)).max() / len(labels))
    cells = sel.validation_results
    best = min(cells, key=lambda v: v["mean_metric"])
    families = sorted({v["model_name"] for v in cells})
    walls = stage_walls(model)
    label_map = model.selected_model().label_map
    model._train_data = None
    mlp_cells = {json.dumps(v["grid"], sort_keys=True): v["mean_metric"]
                 for v in cells
                 if v["model_name"] == "OpMultilayerPerceptronClassifier"}

    t0 = time.perf_counter()
    scored = multiclass_scores(model, pred, new)
    score_s = time.perf_counter() - t0
    new_labels = new["coverType"][1]
    new_acc = float((scored[:, 0] == new_labels).mean())
    tmp = tempfile.mkdtemp(prefix="multiclass-model-")
    try:
        path = os.path.join(tmp, "model")
        t0 = time.perf_counter()
        model.save(path)
        save_s = time.perf_counter() - t0
        artifact = {f: os.path.getsize(os.path.join(path, f))
                    for f in sorted(os.listdir(path))}
        t0 = time.perf_counter()
        loaded = WorkflowModel.load(path, device="cuda")
        load_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        rescored = multiclass_scores(loaded, pred, new)
        rescore_s = time.perf_counter() - t0
        on_cpu = WorkflowModel.load(path, device="cpu")
        few = {k: (t, v[:COVERTYPE_CPU_LOAD_ROWS])
               for k, (t, v) in new.items()}
        cpu_scored = multiclass_scores(on_cpu, pred, few)
    finally:
        shutil.rmtree(tmp)
    reload_identical = bool(np.array_equal(scored, rescored))
    cpu_load_rel = rel_diff(cpu_scored, scored[:COVERTYPE_CPU_LOAD_ROWS])
    main_s = time.perf_counter() - t_phase - leg_s
    del loaded, on_cpu
    torch.cuda.empty_cache()
    # the collector's per-span peaks reset the allocator's peak counter
    phase_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    t0 = time.perf_counter()
    runner_ok, runner_res = traced_runner_run(cols, new)
    runner_s = time.perf_counter() - t0
    del cols
    torch.cuda.empty_cache()

    # the port's op_iris example on the card (K = 3)
    iris_captured, iris_launches = {}, collections.Counter()
    reset_uids()
    TK.reset_launches()
    t0 = time.perf_counter()
    with capture_kernel_inputs(iris_captured, iris_launches):
        iris = op_iris.main([])
    iris_s = time.perf_counter() - t0
    iris_launches = dict(iris_launches)
    iris_sel = iris.selector_summary()
    iris_ok = (iris_sel.best_model_name in ("OpLogisticRegression",
                                            "OpRandomForestClassifier")
               and len(iris_sel.validation_results) == 26
               and iris_sel.holdout_evaluation.get("error", 1.0) <= 0.2
               and all(n > 0 for n in iris_launches.values())
               and any(" C=5 " in k + " " for k in iris_launches))

    rows_out = kernel_rows([captured_shape(key, *captured[key],
                                           prefix="workflow-multiclass")
                            for key in sorted(captured)], phase="multiclass")
    rows_out += kernel_rows([captured_shape(key, *iris_captured[key],
                                            prefix="op_iris")
                             for key in sorted(iris_captured)], phase="iris")
    del captured, iris_captured
    torch.cuda.empty_cache()
    res = dict(
        rows=rows, phase_s=time.perf_counter() - t_phase, leg_s=leg_s,
        main_s=main_s, data_s=data_s, train_s=train_s,
        stage_walls_s=walls,
        family_sweep_s=selector.validator.family_walls,
        selector_walls_s=selector.walls, width=width,
        flagged=len(sc.dropped),
        winner=[sel.best_model_name, sel.best_grid],
        winner_cv_error=best["mean_metric"],
        cv_cells={f"{v['model_name']} {v['grid']}": v["mean_metric"]
                  for v in cells},
        routes=sorted({(v["model_name"], v["route"]) for v in cells}),
        label_map=label_map,
        data_prep=sel.data_prep_results,
        holdout_error=sel.holdout_evaluation.get("error"),
        holdout_top1=sel.holdout_evaluation.get("top_1_accuracy"),
        majority_share=majority, new_rows_accuracy=new_acc,
        score_s=score_s, score_rows=COVERTYPE_SCORE_ROWS, save_s=save_s,
        load_s=load_s, rescore_s=rescore_s, artifact_bytes=artifact,
        reload_identical=reload_identical,
        cpu_load_rows=COVERTYPE_CPU_LOAD_ROWS,
        cpu_load_max_rel_diff=cpu_load_rel,
        peak_device_gb_train=train_peak_gb,
        peak_device_gb=max(phase_peak_gb,
                           torch.cuda.max_memory_allocated() / 1e9),
        launches=launches, shape_launches=shape_launches,
        capture_launches=capture_launches, mlp_cv_error=mlp_cells,
        runner_s=runner_s,
        iris=dict(s=iris_s, winner=[iris_sel.best_model_name,
                                    iris_sel.best_grid],
                  holdout_error=iris_sel.holdout_evaluation.get("error"),
                  launches=iris_launches))
    log("workflow-multiclass: " + json.dumps(res, default=str))
    insights_ok, _ = multiclass_insights(model, 7, HP.card_line())
    by_shape = collections.Counter()
    for key, n in capture_launches.items():
        by_shape[launch_key(key)] += n
    ok = (leg_ok and iris_ok and runner_ok and insights_ok
          and all(n > 0 for n in launches.values())
          and set(launches) == set(TK.KERNELS)
          and {r["key"] for r in rows_out}
          == set(capture_launches) | set(iris_launches)
          and dict(by_shape) == shape_launches
          and any(" C=9 " in k + " " for k in capture_launches)
          and families == ["OpLogisticRegression",
                           "OpMultilayerPerceptronClassifier",
                           "OpNaiveBayes", "OpRandomForestClassifier",
                           "OpXGBoostClassifier"]
          and len(cells) == 14 and len(mlp_cells) == 2
          and scored.shape == (COVERTYPE_SCORE_ROWS, 8)
          and bool(np.isfinite(scored).all())
          and set(np.unique(scored[:, 0])) <= set(range(1, 8))
          and reload_identical and cpu_load_rel <= 1e-5
          and label_map == {c: c - 1 for c in range(1, 8)}
          and new_acc > majority)
    return ok, (capture_launches, iris_launches), rows_out


@contextlib.contextmanager
def record_refit_levels(store: list, all_lanes: bool = False):
    """Inside the block, every one-lane call of the tree fit's level split
    (the refit: the sweep fits its folds as lanes) leaves its histograms,
    split arguments and the split it chose in `store`, in call order
    (round by round, level by level). With `all_lanes`, every call does,
    each of its lanes as a record of its own (lane-major within the call;
    `lane` and `lanes` say which): a sweep's folds and a softmax fit's
    class trees."""
    import torch
    from transmogrifai_tpu_torch.ops import trees as T
    original = T._level_split

    def run(full, B, split_kw, feature_mask, level_mask):
        out = original(full, B, split_kw, feature_mask, level_mask)
        lanes = full.shape[0]
        if lanes == 1 or all_lanes:
            for k in range(lanes):
                masks = tuple(m[k:k + 1] if m is not None and m.dim() == 3
                              else m for m in (feature_mask, level_mask))
                # a fused fit's per-lane scalars: this lane's own
                kw_k = {n: float(v[k]) if isinstance(v, torch.Tensor)
                        else v for n, v in split_kw.items()}
                store.append(dict(full=full[k:k + 1].clone(),
                                  split_kw=kw_k, masks=masks,
                                  split=[t[k].cpu() for t in out[:3]],
                                  lane=k, lanes=lanes))
        return out
    T._level_split = run
    try:
        yield store
    finally:
        T._level_split = original


@contextlib.contextmanager
def time_dispatch(store: dict):
    """Inside the block, each call of a kernel's dispatcher adds its
    calls and wall seconds to `store`: {kernel: [calls, seconds]}. For
    CPU tensors, where the dispatchers run the plain versions."""
    from transmogrifai_tpu_torch.ops import tree_kernels as TK
    originals = {name: getattr(TK, name) for name in TK.KERNELS}

    def timed(name):
        def run(*args, **kw):
            t0 = time.perf_counter()
            out = originals[name](*args, **kw)
            tally = store.setdefault(name, [0, 0.0])
            tally[0] += 1
            tally[1] += time.perf_counter() - t0
            return out
        return run
    for name in originals:
        setattr(TK, name, timed(name))
    try:
        yield store
    finally:
        for name, fn in originals.items():
            setattr(TK, name, fn)


def first_divergence(a: list, b: list):
    """(call, node) of the first node whose split (feature, threshold,
    missing direction) differs between two recorded fits, else None."""
    for i, (x, y) in enumerate(zip(a, b)):
        differ = sum((p != q).int() for p, q in zip(x["split"], y["split"]))
        nodes = differ.nonzero()
        if len(nodes):
            return i, int(nodes[0, 0])
    return None


def split_witness(a: list, b: list, i: int, node: int, depth: int,
                  names: list) -> dict:
    """Why two fits split node `node` of level call `i` differently: the two
    chosen candidates' gains as each device computed them (f32, on its own
    device) and in float64 from each device's histograms, the largest
    difference of the node's cumulative g and h sums between the devices,
    and the f32 noise bound: those differences carried to each candidate's
    gain to first order, plus 4 ulps of its terms. `tie` holds when the
    node's counts agree exactly and the float64 gains of the two candidates
    differ by no more than that bound on either device's histograms. A
    node left unsplit counts as gaining the validity threshold
    (min_info_gain, gamma), and a split below that threshold in float64
    (a zero-gain split of a pure node) keeps its raw gain, so a split
    within f32 noise of worthless ties with none. The gains sum over the K
    gradient channels (K = 2: a binary forest's class sums)."""
    import numpy as np
    import torch
    from transmogrifai_tpu_torch.ops import trees as T
    eps = float(np.finfo(np.float32).eps)
    gains, sums = [], []
    for rec in (a[i], b[i]):
        g32, _ = T._level_gains(rec["full"], rec["split_kw"], *rec["masks"])
        g64, s64 = T._level_gains(
            rec["full"].double().cpu(), rec["split_kw"],
            *[m if m is None else m.cpu() for m in rec["masks"]])
        gains.append((g32[0, node].double().cpu(), g64[0, node]))
        sums.append([t[0, node] for t in s64])
    cand = [tuple(int(t[node]) for t in rec["split"]) for rec in (a[i], b[i])]
    (GL, HL, CL, Gt, Ht, Ct, Gm, Hm, Cm), other = sums
    dG = float(max((GL - other[0]).abs().max(), (Gt - other[3]).abs().max()))
    dH = float(max((HL - other[1]).abs().max(), (Ht - other[4]).abs()))
    lam = a[i]["split_kw"]["reg_lambda"]

    def parts(c):   # left/right/parent sums of candidate c (CPU's sums);
        f, t, m = c  # the G sums over the K gradient channels
        gl = (GL[f, t] - m * Gm[f]).numpy()
        hl = float(HL[f, t] - m * Hm[f])
        cl = float(CL[f, t] - m * Cm[f])
        return gl, hl, cl, Gt.numpy(), float(Ht)

    def noise(c):
        gl, hl, _, gt, ht = parts(c)
        gr, hr = gt - gl, ht - hl
        dl, dr, dp = (max(v + lam, 1e-300) for v in (hl, hr, ht))
        d_gl = np.abs(2 * gl / dl - 2 * gr / dr).sum()
        d_hl = abs((gr @ gr) / dr ** 2 - (gl @ gl) / dl ** 2)
        d_gt = np.abs(2 * gr / dr - 2 * gt / dp).sum()
        d_ht = abs((gt @ gt) / dp ** 2 - (gr @ gr) / dr ** 2)
        terms = gl @ gl / dl + gr @ gr / dr + gt @ gt / dp
        return float((d_gl + d_gt) * dG + (d_hl + d_ht) * dH
                     + 4 * eps * terms)

    def gain(g, c):
        return float(g[c[0], c[1], c[2]])

    def raw_gain(s, c):   # candidate c's gain before the validity rules
        f, t, m = c
        gl, hl = s[0][f, t] - m * s[6][f], s[1][f, t] - m * s[7][f]

        def score(g, h):
            return float((g * g).sum() / (h + lam + 1e-12))
        return score(gl, hl) + score(s[3] - gl, s[4] - hl) - score(s[3], s[4])

    counts_equal = bool(torch.equal(CL, other[2]))
    kw = a[i]["split_kw"]
    norm = max(float(Ht), 1.0) if kw.get("normalize_gain") else 1.0
    thr = max(kw["min_info_gain"] * norm, 2.0 * kw["gamma"], 0.0)
    dead = (0, GL.shape[1] - 1, 0)

    def effective(k, c):   # (gain, noise) of candidate c on device k's sums
        if c == dead:      # no split: worth the validity threshold
            return thr, 0.0
        v = gain(gains[k][1], c)
        # a split below the validity threshold in float64 (a zero-gain
        # split of a pure node, say) keeps its raw gain
        return (v if np.isfinite(v) else raw_gain(sums[k], c)), noise(c)

    eff = [[effective(k, c) for c in cand] for k in range(2)]
    gaps = [e[0][0] - e[1][0] for e in eff]
    bound = eff[0][0][1] + eff[0][1][1]
    tie = counts_equal and all(abs(x) <= bound for x in gaps)
    return dict(
        round=i // depth, level=i % depth, node=node,
        split_a=[names[cand[0][0]], *cand[0]],
        split_b=[names[cand[1][0]], *cand[1]],
        left_rows=[parts(c)[2] for c in cand], node_rows=float(Ct),
        gains_f32_own_device=[[gain(g32, c) for c in cand]
                              for g32, _ in gains],
        gains_f64=[[gain(g64, c) for c in cand] for _, g64 in gains],
        gap_f64=gaps, noise_bound=bound,
        max_dG=dG, max_dH=dH,
        node_G=float(Gt[0]) if len(Gt) == 1 else [float(v) for v in Gt],
        node_H=float(Ht),
        counts_equal=counts_equal, tie=tie)


def insights_leg(model, ds, checked, card: str) -> tuple:
    """workflow-main's insights on its trained model, through the user's
    entry points: `model.model_insights()` (its wall, JSON size, the top
    5 features by contribution); `checked.loco_insights(winner)` through
    the dsl in a Workflow that reuses the model's fitted stages
    (`with_model_stages`), scored on the last INSIGHTS_LOCO_ROWS rows
    (INSIGHTS_TOP_K columns a row's map); `RecordInsightsLOCO
    .insights_matrix` timed on the last INSIGHTS_MATRIX_ROWS rows'
    vectors; and the knockout deltas of INSIGHTS_CHECK_ROWS rows on the
    card against the CPU's plain run of the same program (INSIGHTS_TOL
    absolute; the worst cell is printed). No fallback: a failing
    knockout raises out of the phase. Returns (ok, summary)."""
    import numpy as np
    import torch
    from transmogrifai_tpu_torch.insights import knockout as K
    from transmogrifai_tpu_torch.insights.loco import RecordInsightsLOCO
    from transmogrifai_tpu_torch.workflow import Workflow

    t_leg = t0 = time.perf_counter()
    mi = model.model_insights()
    mi_s = time.perf_counter() - t0
    doc = json.dumps(mi.to_json())
    top5 = [[f.feature_name, f.max_contribution()] for f in sorted(
        mi.features, key=lambda f: -f.max_contribution())[:5]]
    sel = model.selected_model()
    n = len(ds)
    tail = ds.take(np.arange(n - INSIGHTS_LOCO_ROWS, n))
    loco = checked.loco_insights(sel, top_k=INSIGHTS_TOP_K)
    t0 = time.perf_counter()
    loco_model = Workflow().with_model_stages(model) \
        .set_input_dataset(tail).set_result_features(loco).train()
    loco_train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    maps = loco_model.score(tail).data(loco.name)
    loco_score_s = time.perf_counter() - t0
    maps_ok = (len(maps) == INSIGHTS_LOCO_ROWS
               and all(len(m) == INSIGHTS_TOP_K for m in maps))
    first = dict(list(maps[0].items())[:3])
    del loco_model, maps, tail
    vec = model.transform(ds.take(np.arange(
        n - INSIGHTS_MATRIX_ROWS, n))).data(checked.name)
    stage = RecordInsightsLOCO(model=sel)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    deltas = stage.insights_matrix(vec)
    matrix_s = time.perf_counter() - t0
    shape = list(deltas.shape)
    finite = bool(np.isfinite(deltas).all())
    del deltas
    X = np.ascontiguousarray(vec[:INSIGHTS_CHECK_ROWS])
    on_card = K.knockout_deltas(sel, X)
    on_cpu = K.knockout_deltas(sel, X, device="cpu")
    diff = np.abs(on_card - on_cpu)
    worst = np.unravel_index(int(diff.argmax()), diff.shape)
    err = float(diff.max())
    res = dict(
        card=card, winner=type(sel.best_model).__name__,
        model_insights_s=mi_s, json_bytes=len(doc), top5=top5,
        loco_rows=INSIGHTS_LOCO_ROWS, loco_top_k=INSIGHTS_TOP_K,
        loco_train_s=loco_train_s, loco_score_s=loco_score_s,
        loco_first_row=first, matrix_rows=INSIGHTS_MATRIX_ROWS,
        matrix_shape=shape, matrix_s=matrix_s,
        active_features=(len(K.active_features(
            sel.best_model.feat, sel.best_model.thresh_val))
            if hasattr(sel.best_model, "feat") else None),
        check_rows=INSIGHTS_CHECK_ROWS, card_vs_cpu_max_abs=err,
        worst_cell=dict(row=int(worst[0]), column=int(worst[1]),
                        score=int(worst[2]),
                        card=float(on_card[worst]), cpu=float(on_cpu[worst])),
        leg_s=time.perf_counter() - t_leg)
    log("workflow-main insights: " + json.dumps(res))
    ok = (maps_ok and finite and shape[:2] == [INSIGHTS_MATRIX_ROWS,
                                               vec.shape[1]]
          and err <= INSIGHTS_TOL and len(top5) == 5 and top5[0][1] > 0)
    return ok, res


def multiclass_insights(model, n_classes: int, card: str) -> tuple:
    """workflow-multiclass's `model_insights()` on its winner: its wall,
    and each derived column's contributions, one a class for the linear
    families (softmax LR, naive Bayes), one for a tree ensemble, none for
    the MLP (no notion of contribution, as in the reference). Returns (ok,
    summary)."""
    t0 = time.perf_counter()
    mi = model.model_insights()
    mi_s = time.perf_counter() - t0
    doc = json.dumps(mi.to_json())
    winner = mi.selected_model["best_model_type"]
    widths = sorted({len(d.contributions) for f in mi.features
                     for d in f.derived if d.column_index >= 0})
    want = {"OpLogisticRegression": [n_classes], "OpNaiveBayes": [n_classes],
            "OpMultilayerPerceptronClassifier": [0]}.get(winner, [1])
    top5 = [[f.feature_name, f.max_contribution()] for f in sorted(
        mi.features, key=lambda f: -f.max_contribution())[:5]]
    res = dict(card=card, winner=winner, model_insights_s=mi_s,
               json_bytes=len(doc), contributions_per_column=widths,
               top5=top5, features=len(mi.features))
    log("workflow-multiclass insights: " + json.dumps(res))
    return widths == want and len(mi.features) > 0, res


def main_models() -> list:
    """workflow-main's model types and grids: the binary selector's
    defaults (LR, RF, GBT, SVC), RF's grid cut to depth {3, 6} and its one
    depth-12 point that scored best (min_instances_per_node 10,
    min_info_gain 0.001: 13 of its 18 points), which keeps the depth-12
    forest keys the kernel phase's forest rows read. The cut bought back
    time for workflow-text: RF's sweep was 50.3 s of workflow-main's
    train() at 10M rows and never won (PRs 8-17)."""
    from transmogrifai_tpu_torch.automl.selectors import default_grid_for
    from transmogrifai_tpu_torch.models.glm import (OpLinearSVC,
                                                    OpLogisticRegression)
    from transmogrifai_tpu_torch.models.trees import (
        OpGBTClassifier, OpRandomForestClassifier)
    out = []
    for est in (OpLogisticRegression(), OpRandomForestClassifier(),
                OpGBTClassifier(), OpLinearSVC()):
        if est.has_param("seed"):       # the selector's seed, as its defaults
            est.set_param("seed", 42)
        grid = default_grid_for(type(est).__name__)
        if isinstance(est, OpRandomForestClassifier):
            grid = [g for g in grid if g["max_depth"] <= 6 or (
                g["min_instances_per_node"] == 10
                and g["min_info_gain"] == 0.001)]
        out.append((est, grid))
    return out


def workflow_main_phase(rows: int, seed: int):
    """The user's flow at full size: a Dataset of numpy columns (64 Reals
    from the tree phases' generator, 5% missing in four columns and the
    value-dependent missing column; PickLists of 50 and 12 categories as
    bench.py's make_wide_rows draws plA and plB; the RealNN label) through
    set_input_dataset -> transmogrify -> SanityChecker (defaults) ->
    5-fold BinaryClassificationModelSelector with its default model types
    and grids (`main_models()`: LR 8, RF 13 x 50 trees (its 18 cut to
    depth {3, 6} and one depth-12 point), GBT 18 x 20 rounds, SVC 4 grid
    points; max_depth up to 12; the default DataBalancer splitter) ->
    Workflow.train() -> score(); each family's sweep wall and best CV
    AuPR. Launch counters are reset just before train() and read just
    after: every kernel must have launched, at the depth-12 keys too
    (route_hist at 1024 slots, route at 2048 nodes, the lookup over 4096
    leaves). The inputs of the first launch at each capture key of train()
    (`capture_key`: kernel, F, S, channels and lanes) are kept, and each
    kernel is held against its plain version on them (`kernel_rows`); the
    capture keys' launches must add up to the dispatchers' own counts.
    Then one statistics pass over the whole transmogrified matrix, which
    the router streams (it exceeds 4 GiB), held against the fused route on
    the card. Returns (ok, launches by (kernel, F, S) key, launches by
    capture key, kernel rows)."""
    import numpy as np
    import torch
    from transmogrifai_tpu_torch import device as D
    from transmogrifai_tpu_torch.automl.preparators import SanityChecker
    from transmogrifai_tpu_torch.automl.selectors import \
        BinaryClassificationModelSelector
    from transmogrifai_tpu_torch.automl.transmogrifier import transmogrify
    from transmogrifai_tpu_torch.data.dataset import Column, Dataset
    from transmogrifai_tpu_torch.features.builder import FeatureBuilder as FB
    from transmogrifai_tpu_torch.ops import stats_engine as SE
    from transmogrifai_tpu_torch.ops import tree_kernels as TK
    from transmogrifai_tpu_torch.tools import hist_paths as HP
    from transmogrifai_tpu_torch.types import ColumnKind
    from transmogrifai_tpu_torch.workflow import Workflow

    t0 = time.perf_counter()
    X, y = make_data(rows, seed)
    Xh, yh = X.cpu().numpy(), y.cpu().numpy().astype(np.float64)
    del X, y
    torch.cuda.empty_cache()
    rng = np.random.default_rng(seed + 5)
    cats_a = np.array([f"cat{i}" for i in range(50)], dtype=object)
    cats_b = np.array([f"seg{i}" for i in range(12)], dtype=object)
    cols = {f"x{j}": Column(ColumnKind.FLOAT,
                            np.ascontiguousarray(Xh[:, j], np.float64))
            for j in range(Xh.shape[1])}
    del Xh
    cols["plA"] = Column(ColumnKind.STRING, cats_a[rng.integers(0, 50, rows)])
    cols["plB"] = Column(ColumnKind.STRING, cats_b[rng.integers(0, 12, rows)])
    cols["label"] = Column(ColumnKind.FLOAT, yh)
    ds = Dataset(cols)
    raw_s = time.perf_counter() - t0

    label = FB.RealNN("label").as_response()
    feats = [FB.Real(f"x{j}").as_predictor() for j in range(64)] + \
        [FB.PickList("plA").as_predictor(), FB.PickList("plB").as_predictor()]
    vec = transmogrify(feats)
    checker = SanityChecker()
    checked = checker.set_input(label, vec).get_output()
    # the selector's default model types and grids: LR 8, RF 13 (its 18
    # cut to depth {3, 6} and one depth-12 point), GBT 18, SVC 4 grid points
    selector = BinaryClassificationModelSelector.with_cross_validation(
        num_folds=5, seed=42, models_and_parameters=main_models())
    pred = selector.set_input(label, checked).get_output()
    workflow = Workflow().set_input_dataset(ds).set_result_features(pred)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    captured, capture_launches = {}, collections.Counter()
    TK.reset_launches()
    t0 = time.perf_counter()
    with D.record_copies() as rec, \
            capture_kernel_inputs(captured, capture_launches):
        model = workflow.train()
    train_s = time.perf_counter() - t0
    launches = dict(TK.launches)
    shape_launches = dict(TK.shape_launches)
    capture_launches = dict(capture_launches)
    stats_pass = dict(SE.last_pass)
    train_copies = rec.copies
    sel = model.selector_summary()
    sc = model.sanity_checker_summary()
    width = len(sc.names)
    kept = len(next(st for st in model.stages if type(st).__name__
                    == "SanityCheckerModel").indices_to_keep)
    walls = stage_walls(model)
    train_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    captured_gb = sum(t.numel() * t.element_size() for _, args, _ in
                      captured.values() for t in args
                      if isinstance(t, torch.Tensor)) / 1e9
    # every (kernel, F, S, C, Fo) capture key of train(), on the inputs of
    # its first launch there, against the kernel's plain version
    wf_rows = kernel_rows([captured_shape(key, *captured[key])
                           for key in sorted(captured)], phase="workflow")
    del captured
    torch.cuda.empty_cache()

    def by_label(copies):
        out = {}
        for c in copies:
            n, b, t = out.get(c["label"], (0, 0, 0.0))
            out[c["label"]] = (n + 1, b + c["bytes"], t + c["seconds"])
        return {k: dict(copies=n, gb=b / 1e9, seconds=t, gb_per_s=b / 1e9 / t)
                for k, (n, b, t) in out.items()}

    # the streamed statistics route over the whole transmogrified matrix;
    # the train path's other columns stay on the model for evaluate(): they
    # are freed first, to score the 10M rows again within the host's memory
    full = model._train_data.data(vec.name)
    model._train_data = None
    t0 = time.perf_counter()
    streamed = SE.run_stats(full, yh.astype(np.float32),
                            distinct=np.array([0.0, 1.0]), corr_matrix=True)
    stream_pass = dict(SE.last_pass, wall_s=time.perf_counter() - t0)
    fused = SE.run_stats(full, yh.astype(np.float32), driver="fused",
                         distinct=np.array([0.0, 1.0]), corr_matrix=True)
    fused_pass = dict(SE.last_pass)
    stats_err = max(float(np.nanmax(np.abs(getattr(streamed, k)
                                            - getattr(fused, k))))
                    for k in ("mean", "variance", "corr_label",
                              "corr_matrix"))
    stats_exact = (all(np.array_equal(getattr(streamed, k),
                                      getattr(fused, k))
                       for k in ("count", "min", "max"))
                   and np.allclose(streamed.contingency, fused.contingency,
                                   rtol=1e-9, atol=0))
    del full, fused, streamed
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    with D.record_copies() as rec:
        scored = model.score(ds).data(pred.name)
    score_s = time.perf_counter() - t0
    score_copies = rec.copies
    insights_ok, insights = insights_leg(model, ds, checked,
                                         HP.card_line())

    best = max(sel.validation_results, key=lambda v: v["mean_metric"])
    prevalence = float(yh.mean())
    families = family_results(sel, selector)
    res = dict(
        rows=rows, raw_data_s=raw_s, train_s=train_s, score_s=score_s,
        stage_walls_s=walls, selector_walls_s=selector.walls,
        sanity_stats_pass=stats_pass, width_before=width, width_after=kept,
        flagged=len(sc.dropped), sanity_sample_fraction=sc.sample_fraction,
        data_prep=sel.data_prep_results,
        winner=[sel.best_model_name, sel.best_grid],
        winner_cv_aupr=best["mean_metric"],
        holdout_aupr=sel.holdout_evaluation.get("au_pr"),
        prevalence=prevalence, families=families,
        cells={f"{v['model_name']} {json.dumps(v['grid'], sort_keys=True)}":
               [v["mean_metric"], v["route"]]
               for v in sel.validation_results},
        train_copies=by_label(train_copies),
        score_copies=by_label(score_copies),
        peak_device_gb_train=train_peak_gb,
        captured_kernel_inputs_gb=captured_gb,
        peak_device_gb=torch.cuda.max_memory_allocated() / 1e9,
        launches=launches, shape_launches=shape_launches,
        capture_launches=capture_launches, stream_stats=stream_pass, fused_stats=fused_pass,
        stream_vs_fused_max_diff=stats_err, stream_counts_exact=stats_exact)
    log("workflow-main: " + json.dumps(res))
    # the rows path's winner in this run: the same cell, or a tie
    was_key = (f"{ROWS_PATH_WINNER[0]} "
               f"{json.dumps(ROWS_PATH_WINNER[1], sort_keys=True)}")
    was_cv = res["cells"].get(was_key, [None])[0]
    same_winner = res["winner"] == ROWS_PATH_WINNER
    winner_tie = (not same_winner and was_cv is not None
                  and best["mean_metric"] - was_cv <= WINNER_TIE_TOL)
    log("workflow-main sweeps against the rows path's: " + json.dumps({
        fam: dict(sweep_s=families.get(fam, {}).get("sweep_s"),
                  rows_path_sweep_s=was)
        for fam, was in ROWS_PATH_SWEEP_S.items()})
        + f"; winner {json.dumps(res['winner'])} CV "
        f"{best['mean_metric']}, the rows path's "
        f"{json.dumps(ROWS_PATH_WINNER)} CV {ROWS_PATH_WINNER_CV} there and "
        f"{was_cv} here; same: {same_winner}"
        + (f"; tie witness: the rows path's winner "
           f"{best['mean_metric'] - was_cv:.3g} below this run's best "
           f"(<= {WINNER_TIE_TOL}): {winner_tie}"
           if not same_winner and was_cv is not None else ""))
    # the depth-12 grid points' deepest levels: route_hist at 1024 slots,
    # route at 2048 nodes, the lookup over 4096 leaves
    deep = ("route_hist F=164 S=1024", "route F=164 S=2048",
            "table_lookup F=1 S=4096")
    by_shape = collections.Counter()
    for key, n in capture_launches.items():
        by_shape[launch_key(key)] += n
    ok = (all(n > 0 for n in launches.values())
          and all(shape_launches.get(k, 0) > 0 for k in deep)
          and set(families) == set(selector.validator.family_walls)
          and len(families) == 4
          and {r["key"] for r in wf_rows} == set(capture_launches)
          and dict(by_shape) == shape_launches
          and scored.shape == (rows, 5)
          and bool(np.isfinite(scored).all())
          and best["mean_metric"] > prevalence + 0.1
          and sel.holdout_evaluation["au_pr"] > prevalence + 0.1
          and stream_pass["driver"] == "streamed" and stats_exact
          and stats_err < 1e-4 and (same_winner or winner_tie)
          and insights_ok)
    return ok, shape_launches, capture_launches, wf_rows


def stage_walls(model) -> dict:
    """Wall seconds of a trained workflow's stages by "op class"."""
    walls = {}
    for w in model.runner.walls:
        key = f"{w['op']} {w['stage'].split('_')[0]}"
        walls[key] = walls.get(key, 0.0) + w["seconds"]
    return walls


def family_results(sel, selector) -> dict:
    """Each model family's sweep wall, cell count and best CV AuPR."""
    families = {}
    for v in sel.validation_results:
        fam = families.setdefault(v["model_name"], dict(
            sweep_s=selector.validator.family_walls.get(v["model_name"]),
            cells=0, best_cv_aupr=-1.0, best_grid=None))
        fam["cells"] += 1
        if v["mean_metric"] > fam["best_cv_aupr"]:
            fam.update(best_cv_aupr=v["mean_metric"], best_grid=v["grid"])
    return families


def capture_key(key: str, name: str, args: tuple, kw: dict) -> str:
    """The capture key of one launch: its (kernel, F, S) key of
    `TK.shape_launches`, the lane count Fo and, for the histograms, the
    channels C a cell (payload + derived count), which set the planner's
    tiles: a forest's and a boosted fit's launches at one (kernel, F, S)
    differ in both."""
    if name in ("route", "table_lookup"):
        return f"{key} Fo={args[1].shape[0]}"
    Fo = args[2].shape[0]
    C = args[1].shape[0] // Fo + int(bool(kw.get("derive_count")))
    return f"{key} C={C} Fo={Fo}"


def launch_key(capture: str) -> str:
    """The (kernel, F, S) launch key of a capture key."""
    return " ".join(capture.split()[:3])


@contextlib.contextmanager
def capture_kernel_inputs(store: dict, counts: collections.Counter,
                          clone: bool = True):
    """Inside the block, the first launch of each capture key (`capture_key`:
    the (kernel, F, S) key of `TK.shape_launches`, Fo and C) leaves a copy
    of its inputs in `store`: {key: (kernel, args, kwargs)} (tensors cloned
    once each, shared inputs such as the bin matrix shared), and `counts`
    adds one a capture key wherever a dispatcher's own count rose. Without
    `clone` it only counts (a timed run copies nothing)."""
    import torch
    from transmogrifai_tpu_torch.ops import tree_kernels as TK
    originals = {name: getattr(TK, name) for name in TK.KERNELS}
    clones = {}   # the original is held too: its address stays its own

    def keep(t):
        if not isinstance(t, torch.Tensor):
            return t
        k = (t.data_ptr(), t.dtype, tuple(t.shape), t.stride())
        if k not in clones:
            clones[k] = (t, t.clone())
        return clones[k][1]

    def capturing(name):
        def run(*args, **kw):
            before = dict(TK.shape_launches)
            out = originals[name](*args, **kw)
            for key, n in TK.shape_launches.items():
                if n == before.get(key, 0):
                    continue
                full = capture_key(key, name, args, kw)
                counts[full] += n - before.get(key, 0)
                if clone and full not in store:
                    store[full] = (name, tuple(keep(a) for a in args),
                                   dict(kw))
            return out
        return run
    for name in originals:
        setattr(TK, name, capturing(name))
    try:
        yield store
    finally:
        for name, fn in originals.items():
            setattr(TK, name, fn)
        clones.clear()


def captured_shape(key: str, name: str, args: tuple, kw: dict,
                   prefix: str = "workflow-main") -> tuple:
    """(label, kernel, S, args, kwargs) of one capture key; `prefix` names
    the phase whose train() launched it."""
    S = int(key.split("S=")[1].split()[0])
    if name == "table_lookup":
        label = f"leaves: Fo={args[1].shape[0]} M={S}"
    elif name == "route":
        label = f"last level {S} nodes: F={args[0].shape[0]} " \
                f"Fo={args[1].shape[0]}"
    elif not kw.get("derive_count"):
        label = f"rank metric: F=1 B={kw['n_bins']} S={S} lanes"
    else:
        F, Fo, B = args[0].shape[0], args[2].shape[0], kw["n_bins"]
        C = args[1].shape[0] // Fo
        chans = "" if C == 2 else f" C={C}+1"
        label = (f"tree root: F={F} B={B} Fo={Fo}{chans} S=1"
                 if name == "hist_folds"
                 else f"level S={S}: F={F} B={B} Fo={Fo}{chans}")
    return f"{prefix} {label}", name, S, args, kw


# the models the serve phase reuses: workflow-wide's saved 1M-row model and
# workflow-titanic's main-path model (a random forest won there), so the
# serve phase serves without a train() of its own
HELD = {}
SERVE_RECORDS = 1_000        # single-record POSTs of the serve phase
SERVE_CLIENTS = 8            # client threads sending them
SERVE_BULKS = (1, 3, 17, 63, 64, 100)
SERVE_TREE_RECORDS = 200     # records the tree ensemble scores in process
SERVE_LOCAL_RECORDS = 20     # of them through the local route


def wide_records(cols: dict) -> list:
    """`wide_columns`' rows as the JSON records a client posts: the label
    left out, NaN as null, numpy scalars as Python numbers, dates as
    integer milliseconds."""
    import numpy as np
    names = [n for n in cols if n != "label"]
    n_rows = len(cols[names[0]][1])
    out = []
    for i in range(n_rows):
        rec = {}
        for name in names:
            t, arr = cols[name]
            v = arr[i]
            if isinstance(v, (float, np.floating)):
                v = None if np.isnan(v) else (
                    int(v) if t == "Date" else float(v))
            elif isinstance(v, np.generic):
                v = v.item()
            rec[name] = v
        out.append(rec)
    return out


def _http(port: int, method: str, path: str, body=None,
          timeout: float = 60.0):
    """(status, parsed JSON) of one request to the local server."""
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        data = None if body is None else json.dumps(body).encode()
        conn.request(method, path, body=data,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read() or b"null")
    finally:
        conn.close()


def _max_result_diff(got: list, want: list, names: list) -> tuple:
    """(largest |difference|, predictions identical) of scored rows against
    expected rows: a Prediction's probabilities (or its prediction where it
    has none), a numeric result as is."""
    worst, same = 0.0, True
    for g, w in zip(got, want):
        for name in names:
            a, b = g[name], w[name]
            if isinstance(b, dict):
                keys = [k for k in b if k.startswith("probability_")] \
                    or ["prediction"]
                worst = max(worst, max(abs(a[k] - b[k]) for k in keys))
                same = same and a["prediction"] == b["prediction"]
            elif b is None or a is None:
                same = same and a is None and b is None
            else:
                worst = max(worst, abs(float(a) - float(b)))
    return worst, same


def _scored_rows(model, records: list) -> list:
    """model.score() of `records` (a Dataset of its predictor raw features)
    as the engine's row dicts."""
    from transmogrifai_tpu_torch.readers import ListReader
    from transmogrifai_tpu_torch.serve.engine import _row_value
    ds = ListReader(records).generate_dataset(
        [f for f in model.raw_features() if not f.is_response])
    scored = model.score(ds)
    cols = [(f.name, scored.column(f.name), f.feature_type)
            for f in model.result_features]
    return [{nm: _row_value(col, i, t) for nm, col, t in cols}
            for i in range(len(records))]


def _serve_cli(here: str, *args: str, timeout: float = 300.0):
    """`python -m transmogrifai_tpu_torch` with `args` from the checkout."""
    env = dict(os.environ, PYTHONPATH=here)
    return subprocess.run([sys.executable, "-m", "transmogrifai_tpu_torch",
                           *args], cwd=here, env=env, capture_output=True,
                          text=True, timeout=timeout)


def _cli_in_process(*args: str):
    """transmogrifai_tpu_torch.cli.main(args) in this process: (returncode,
    stdout) as a CompletedProcess (the trace reports need no card and no
    process start of their own)."""
    import io
    from transmogrifai_tpu_torch import cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(list(args))
    return subprocess.CompletedProcess(list(args), rc, buf.getvalue(), "")


def serve_http_leg(here: str, model_dir: str, records: list, bad: list,
                   metrics_dir: str) -> dict:
    """The real `serve` CLI in a subprocess on the card: wait for its
    "serving ... on http://" line, then /healthz, `records` as single-record
    POSTs from SERVE_CLIENTS threads, the SERVE_BULKS bodies, the `bad`
    records, /metrics, SIGTERM. Returns what came back."""
    import queue
    import signal
    import threading
    env = dict(os.environ, PYTHONPATH=here)
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "transmogrifai_tpu_torch", "serve", model_dir,
         "--port", "0", "--max-batch", "64", "--metrics-location",
         metrics_dir], cwd=here, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    lines, ready = [], queue.Queue()

    def read_log():
        for line in proc.stderr:
            lines.append(line.rstrip())
            m = re.search(r"serving .* on http://[^:]+:(\d+)", line)
            if m:
                ready.put(int(m.group(1)))
        ready.put(None)
    reader = threading.Thread(target=read_log, daemon=True)
    reader.start()
    out = {}
    try:
        port = ready.get(timeout=240)
        if port is None:
            raise RuntimeError("serve exited before serving:\n"
                               + "\n".join(lines[-20:]))
        out["startup_s"] = time.perf_counter() - t0
        out["healthz"] = _http(port, "GET", "/healthz")
        singles = [None] * len(records)
        errors = []

        def client(k):
            for i in range(k, len(records), SERVE_CLIENTS):
                try:
                    singles[i] = _http(port, "POST", "/score", records[i])
                except Exception as e:          # counted, fails the phase
                    errors.append(f"{type(e).__name__}: {e}")
        t1 = time.perf_counter()
        clients = [threading.Thread(target=client, args=(k,))
                   for k in range(SERVE_CLIENTS)]
        for c in clients:
            c.start()
        for c in clients:
            c.join()
        out["singles_s"] = time.perf_counter() - t1
        out["singles"], out["client_errors"] = singles, errors
        out["bulks"] = [_http(port, "POST", "/score", records[:n])
                        for n in SERVE_BULKS]
        out["bad"] = [_http(port, "POST", "/score", r) for r in bad]
        out["metrics"] = _http(port, "GET", "/metrics")[1]
        proc.send_signal(signal.SIGTERM)
        out["rc"] = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        reader.join(timeout=10)
    out["wall_s"] = time.perf_counter() - t0
    out["log_tail"] = lines[-3:]
    return out


def request_coverage(metrics_dir: str) -> dict:
    """The kept request traces of a serve run (C6): how many, the least
    share of a request's wall its segments cover, the widest stretch no
    segment covers (with that request's segments), and the mean of each
    segment over the kept requests."""
    from transmogrifai_tpu_torch.utils import tracing
    recs = tracing.load_request_traces(metrics_dir)
    gaps = []
    means: dict = collections.defaultdict(float)
    for r in recs:
        segs = r.get("segments") or {}
        gaps.append((r["wall_ms"] - sum(segs.values()), r))
        for k, v in segs.items():
            means[k] += v / len(recs)
    if not recs:
        return dict(kept=0)
    gap, worst = max(gaps, key=lambda g: g[0])
    return dict(kept=len(recs),
                min_cover=min(sum((r.get("segments") or {}).values())
                              / r["wall_ms"] for _, r in gaps
                              if r["wall_ms"] > 0),
                max_unattributed_ms=gap,
                worst=dict(wall_ms=worst["wall_ms"],
                           segments=worst.get("segments")),
                mean_segment_ms=dict(means))


def serve_phase(model_dir: str, tree_model):
    """18. serve: the workflow-wide model saved at `model_dir` served by the
    real CLI, and a tree ensemble served in process. Returns (ok, summary).

    `serve DIR --prewarm-only --max-batch 64` (rc 0, buckets 1..64, each
    bucket's wall, serve.json's model_hash equal to model_content_hash);
    then `serve DIR --port 0 --metrics-location M` answering SERVE_RECORDS
    single-record POSTs from SERVE_CLIENTS threads, the SERVE_BULKS bodies
    and three bad records, each answer held to in-process score() of the
    same records (probabilities within 1e-5, the same prediction);
    /metrics (post_warmup_compiles 0, pad and bucket rows, latency
    quantiles), SIGTERM (rc 0 after the drain), `trace-report M --check`
    (rc 0) and `--requests`. In process: a ServingEngine over `tree_model`
    (its winner a random forest) on SERVE_TREE_RECORDS new
    `titanic_named_records`, unlabeled, against score() within 1e-5, and its local route on SERVE_LOCAL_RECORDS
    against the bucket route within 1e-5; the four kernels' launch counters
    must not move while the engine serves. Everything serves on the card."""
    import tempfile
    import numpy as np
    from transmogrifai_tpu_torch.ops import tree_kernels as TK
    from transmogrifai_tpu_torch.serve import ServingEngine
    from transmogrifai_tpu_torch.workflow import WorkflowModel
    from transmogrifai_tpu_torch.workflow.io import model_content_hash

    here = os.path.dirname(os.path.abspath(__file__))
    t_phase = time.perf_counter()
    res, checks = {}, {}
    records = wide_records(wide_columns(SERVE_RECORDS, SEED + 25))
    model = WorkflowModel.load(model_dir)
    names = [f.name for f in model.result_features]
    missing = dict(records[0])
    del missing["r1"]
    bad = [dict(records[1], no_such_feature=1.0),          # unknown key
           dict(records[2], r1="not-a-number")]            # type rejects
    t0 = time.perf_counter()
    want = _scored_rows(model, records + [missing])
    res["in_process_score_s"] = time.perf_counter() - t0

    # 1. the deploy-time prewarm
    pw = _serve_cli(here, "serve", model_dir, "--prewarm-only",
                    "--max-batch", "64")
    summary = json.loads(pw.stdout.strip().splitlines()[-1])["prewarm"] \
        if pw.returncode == 0 else {}
    with open(os.path.join(model_dir, "serve.json")) as f:
        manifest = json.load(f)
    res["prewarm"] = dict(rc=pw.returncode, wall_s=summary.get("wall_s"),
                          per_bucket=summary.get("per_bucket"),
                          manifest_hash=manifest.get("model_hash"))
    checks["prewarm"] = (
        pw.returncode == 0 and summary["buckets"] == [1, 8, 16, 32, 64]
        and [b["bucket"] for b in summary["per_bucket"]]
        == [1, 8, 16, 32, 64]
        and all(b["wall_s"] > 0 for b in summary["per_bucket"])
        and manifest["model_hash"] == model_content_hash(model_dir))
    if pw.returncode != 0:
        log("serve --prewarm-only failed:\n" + pw.stderr[-3000:])

    # 2. the server under traffic
    metrics_dir = tempfile.mkdtemp(prefix="chip_smoke_serve_metrics_")
    try:
        http = serve_http_leg(here, model_dir, records + [missing], bad,
                              metrics_dir)
        check = _cli_in_process("trace-report", metrics_dir, "--check")
        reqs = _cli_in_process("trace-report", metrics_dir, "--requests")
        coverage = request_coverage(metrics_dir)
    finally:
        shutil.rmtree(metrics_dir, ignore_errors=True)
    singles = http["singles"]
    single_ok = all(s is not None and s[0] == 200 for s in singles)
    single_diff, single_same = _max_result_diff(
        [s[1] for s in singles], want, names) if single_ok else (None, False)
    bulk_ok = all(code == 200 and len(body) == n
                  for (code, body), n in zip(http["bulks"], SERVE_BULKS))
    bulk_diff, bulk_same = _max_result_diff(
        [row for _, body in http["bulks"] for row in body],
        [w for n in SERVE_BULKS for w in want[:n]], names) \
        if bulk_ok else (None, False)
    m = http["metrics"]
    lat = {k: {q: m["latency"][k][q] for q in ("p50_ms", "p95_ms",
                                               "p99_ms")}
           for k in ("total", "queue_wait", "batch_assemble",
                     "device_score")}
    res["http"] = dict(
        startup_s=http["startup_s"], singles_s=http["singles_s"],
        wall_s=http["wall_s"], rc=http["rc"], healthz=http["healthz"],
        single_requests=len(singles), single_max_diff=single_diff,
        bulk_sizes=list(SERVE_BULKS), bulk_max_diff=bulk_diff,
        missing_key_status=singles[-1][0] if singles[-1] else None,
        bad=[[code, body.get("error_type"), body.get("error")]
             for code, body in http["bad"]],
        client_errors=http["client_errors"][:3],
        requests=m["requests"], batches=m["batches"], rows=m["rows"],
        pad_rows=m["pad_rows"], bucket_rows=m["bucket_rows"],
        post_warmup_compiles=m["post_warmup_compiles"],
        prewarm=m["prewarm"], latency_ms=lat,
        trace_check_rc=check.returncode, trace_check=check.stdout[-300:],
        requests_rc=reqs.returncode,
        requests_report=reqs.stdout.splitlines()[:3],
        coverage=coverage, log_tail=http["log_tail"])
    checks["http"] = (
        http["healthz"][0] == 200 and http["healthz"][1]["warm"] is True
        and not http["client_errors"] and single_ok and single_same
        and single_diff <= 1e-5 and bulk_ok and bulk_same
        and bulk_diff <= 1e-5
        and [c for c, _ in http["bad"]] == [400, 400]
        and "no_such_feature" in http["bad"][0][1]["error"]
        and "'r1'" in http["bad"][1][1]["error"]
        and m["post_warmup_compiles"] == 0 and m["bucket_rows"] > 0
        and http["rc"] == 0 and check.returncode == 0
        and reqs.returncode == 0 and "kept trace" in reqs.stdout)

    # 3. a tree ensemble in process: bucket route and local route
    tree_records = [{k: v for k, v in r.items() if k != "survived"}
                    for r in titanic_named_records(SERVE_TREE_RECORDS,
                                                   SEED + 14)]
    TK.reset_launches()
    before = dict(TK.launches)
    t0 = time.perf_counter()
    tree_want = _scored_rows(tree_model, tree_records)
    eng = ServingEngine(tree_model, max_batch=64)
    eng.prewarm()
    got = eng.score_batch(tree_records)
    local = ServingEngine(tree_model, max_batch=64, single_record="local")
    local.prewarm()
    tree_names = [f.name for f in tree_model.result_features]
    loc = [local.score_batch([r])[0]
           for r in tree_records[:SERVE_LOCAL_RECORDS]]
    tree_diff, tree_same = _max_result_diff(got, tree_want, tree_names)
    local_diff, local_same = _max_result_diff(
        loc, got[:SERVE_LOCAL_RECORDS], tree_names)
    after = dict(TK.launches)
    winner = tree_model.selector_summary().best_model_name
    res["tree"] = dict(winner=winner, records=len(tree_records),
                       wall_s=time.perf_counter() - t0,
                       max_diff=tree_diff, local_max_diff=local_diff,
                       engine_device=str(eng.device),
                       launches_before=before, launches_after=after)
    checks["tree"] = (winner in ("OpRandomForestClassifier",
                                 "OpGBTClassifier",
                                 "OpXGBoostClassifier")
                      and eng.device.type == "cuda"
                      and tree_diff <= 1e-5 and tree_same
                      and local_diff <= 1e-5 and local_same
                      and before == after
                      and all(n == 0 for n in after.values()))
    log("serve: kernel launch counters while serving: "
        f"{before} -> {after} (unchanged: {before == after})")
    res["checks"] = checks
    res["phase_s"] = time.perf_counter() - t_phase
    log("serve: " + json.dumps(res, default=str))
    return all(checks.values()), res


_EN_FUNCTION = ("the and to of is it with for on this that my we you "
                "please can not when after was our your i have".split())
_FOREIGN = {
    "de": ("der die das und ist nicht mit ein sich den auf werden ich "
           "habe meine Rechnung für Bestellung über Konto möchte bitte "
           "prüfen schnell Lieferung Passwort geändert worden").split(),
    "fr": ("le la les de et un une est que dans pour qui pas vous je "
           "facture livraison compte problème très été mon mot passe "
           "commande reçu").split(),
    "es": ("el la los las de y un una es que en por con para no mi "
           "factura envío cuenta contraseña problema también pedido "
           "recibido ¿puede ayudarme?").split()}
_ORG_SUFFIX_WORDS = ["Inc", "Corp", "Ltd", "LLC", "Group", "Labs", "Bank"]
_PRODUCTS = ["router", "modem", "phone", "tablet", "laptop", "watch",
             "camera", "speaker", "printer", "monitor", "dock", "charger"]


def ticket_columns(n: int, seed: int) -> dict:
    """Support-ticket records as numpy columns, synthesised from `seed`:
    `body` (a Text of 40-80 tokens from a document's mix of `TEXT_TOPICS`
    planted topics over a vocabulary of `TEXT_VOCAB` syllable words, a
    quarter English function words; 10% of bodies German, French or
    Spanish sentences; a person, a place and an organisation from the NER
    gazetteers in 60%, 40% and 30% of bodies; 1% missing), `subject` (3-8
    words of the body's main topic, a fifth of them a phrase of the body),
    `reply` (5-20 words of the main topic or another, 5% the subject
    itself), `product` (a PickList of 12), `accountAgeDays` (Real, 3%
    missing), `priorTickets` (Integral) and `escalated` (RealNN): a label
    whose logit rises with topics 0 and 1, falls with topic 5 and rises
    with an organisation named in the body. The vocabulary and topics come
    from `TEXT_TOPIC_SEED`, so every call draws from the same topics.
    Returns {name: (feature type name, float64 with NaN, or objects)}."""
    import numpy as np
    from transmogrifai_tpu_torch.transformers import ner
    fixed = np.random.default_rng(TEXT_TOPIC_SEED)
    words = np.array([a + b + c for a in _SYLLABLES for b in _SYLLABLES
                      for c in _SYLLABLES], object)
    words = words[fixed.permutation(len(words))[:TEXT_VOCAB]]
    per_topic = TEXT_VOCAB // (TEXT_TOPICS + 2)
    background = words[TEXT_TOPICS * per_topic:]
    zipf = 1.0 / np.arange(1, per_topic + 1)
    zipf_cum = np.cumsum(zipf / zipf.sum())
    # the people, places and organisations the tickets name: 24 first
    # names and 20 places of the NER gazetteers, 12 surnames and 10
    # organisations (a suffix of the gazetteer's) made of syllables
    surnames = [w.capitalize() for w in words[:12]]
    orgs = [w.capitalize() for w in words[12:22]]
    firsts = sorted(w.capitalize() for w in ner._COMMON_FIRST_NAMES)
    firsts = [firsts[i] for i in fixed.permutation(len(firsts))[:24]]
    places = sorted(w.capitalize() for w in ner._CITIES | ner._COUNTRIES
                    if w != "usa")
    places = [places[i] for i in fixed.permutation(len(places))[:20]]

    rng = np.random.default_rng(seed)
    mix = rng.dirichlet(np.full(TEXT_TOPICS, 0.2), size=n)
    main = mix.argmax(1)
    lengths = rng.integers(40, 81, size=n)
    total = int(lengths.sum())
    doc = np.repeat(np.arange(n), lengths)
    topic = np.minimum((rng.uniform(size=total)[:, None]
                        > mix.cumsum(1)[doc]).sum(1), TEXT_TOPICS - 1)
    rank = np.minimum(np.searchsorted(zipf_cum, rng.uniform(size=total)),
                      per_topic - 1)
    kind = rng.uniform(size=total)
    tokens = np.where(
        kind < 0.25, np.array(_EN_FUNCTION, object)[
            rng.integers(0, len(_EN_FUNCTION), size=total)],
        np.where(kind < 0.35, background[rng.integers(
            0, len(background), size=total)],
            words[topic * per_topic + rank]))
    lang = np.where(rng.uniform(size=n) < 0.1,
                    rng.integers(0, 3, size=n), -1)
    foreign = [np.array(_FOREIGN[k], object) for k in ("de", "fr", "es")]
    person = rng.uniform(size=n) < 0.6
    place = rng.uniform(size=n) < 0.4
    org = rng.uniform(size=n) < 0.3
    who = rng.integers(0, len(firsts), size=n), \
        rng.integers(0, len(surnames), size=n)
    where = rng.integers(0, len(places), size=n)
    which = rng.integers(0, len(orgs), size=n), \
        rng.integers(0, len(_ORG_SUFFIX_WORDS), size=n)
    cut = rng.uniform(size=n)
    body, subject, reply = [], [], []
    starts = np.concatenate([[0], np.cumsum(lengths)])
    sub_len = rng.integers(3, 9, size=n)
    sub_phrase = rng.uniform(size=n) < 0.2
    rep_len = rng.integers(5, 21, size=n)
    rep_topic = np.where(rng.uniform(size=n) < 0.5, main,
                         rng.integers(0, TEXT_TOPICS, size=n))
    rep_same = rng.uniform(size=n) < 0.05
    sub_rank = rng.integers(0, 40, size=(n, 8))
    rep_rank = rng.integers(0, 40, size=(n, 20))
    missing = rng.uniform(size=(n, 3)) < (0.01, 0.02, 0.01)
    for i in range(n):
        toks = list(tokens[starts[i]:starts[i + 1]])
        if lang[i] >= 0:
            fw = foreign[lang[i]]
            toks = [fw[j] for j in
                    rng.integers(0, len(fw), size=len(toks) * 7 // 10)] \
                + toks[:len(toks) * 3 // 10]
        extra = []
        if person[i]:
            extra += [firsts[who[0][i]], surnames[who[1][i]]]
        if place[i]:
            extra += ["in", places[where[i]]]
        if org[i]:
            extra += ["at", orgs[which[0][i]],
                      _ORG_SUFFIX_WORDS[which[1][i]]]
        at = int(cut[i] * len(toks))
        text = " ".join(toks[:at] + extra + toks[at:]) + "."
        body.append(None if missing[i, 0] else text)
        if sub_phrase[i]:
            s = " ".join(toks[at // 2:at // 2 + 3])
        else:
            s = " ".join(words[main[i] * per_topic
                               + sub_rank[i, :sub_len[i]]])
        subject.append(None if missing[i, 1] else s)
        reply.append(None if missing[i, 2] else s if rep_same[i] else
                     " ".join(words[rep_topic[i] * per_topic
                                    + rep_rank[i, :rep_len[i]]]))
    product = rng.choice(len(_PRODUCTS), size=n,
                         p=(lambda w: w / w.sum())(
                             1.0 / np.arange(1, len(_PRODUCTS) + 1)))
    age = rng.lognormal(5.0, 1.0, size=n)
    age[rng.uniform(size=n) < 0.03] = np.nan
    prior = rng.poisson(2.0, size=n).astype(np.float64)
    logit = (6.0 * (mix[:, 0] + mix[:, 1]) - 4.0 * mix[:, 5]
             + 2.5 * org + 0.3 * prior - 0.5 * (product < 2) - 2.6)
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-logit))).astype(np.float64)
    return {"subject": ("Text", _object_array(subject)),
            "body": ("Text", _object_array(body)),
            "reply": ("Text", _object_array(reply)),
            "product": ("PickList", np.array(_PRODUCTS, object)[product]),
            "accountAgeDays": ("Real", age),
            "priorTickets": ("Integral", prior),
            "escalated": ("RealNN", y)}


def product_labels(cols: dict) -> list:
    """The product indexer's labels as OpStringIndexer fits them on these
    columns (frequency order, ties in first-seen order), for `deindexed`."""
    import collections as C
    return [w for w, _ in C.Counter(
        v for v in cols["product"][1] if v is not None and v != ""
    ).most_common()]


def text_features(FB, transmogrify, labels: list, vocab_size: int = 512,
                  vector_size: int = 100, vocab_bins: int = 2048):
    """(label, transmogrified vector, {name: feature}) of the ticket flow
    with either package's FeatureBuilder and transmogrify, at the dsl's
    default widths unless told otherwise: the body's tokens without stop
    words counted (`vocab_size` terms) into LDA topics (k 10, 50
    iterations), as TF-IDF (`vocab_size`) and word2vec (`vector_size` dims
    over `vocab_bins` bins); its regex tokens as bigrams; the subject's
    n-gram similarity to the reply's tokens and Jaccard similarity of the
    two as sets; the body's language, named entities and length; whether
    the subject is in the body; the product indexed and turned back into
    its label; then transmogrify of all of them with the product and the
    two numerics."""
    label = FB.RealNN("escalated").as_response()
    subject = FB.Text("subject").as_predictor()
    body = FB.Text("body").as_predictor()
    reply = FB.Text("reply").as_predictor()
    product = FB.PickList("product").as_predictor()
    toks = body.tokenize().remove_stop_words()
    index = product.index_string()
    feats = {
        "topics": toks.count_vectorize(vocab_size=vocab_size).lda(
            k=10, max_iter=50),
        "tfidf": toks.tf_idf(vocab_size),
        "w2v": toks.word2vec(vector_size=vector_size,
                             vocab_bins=vocab_bins),
        "bigrams": body.tokenize_regex().ngram(2),
        "ngram_sim": subject.tokenize().ngram_similarity(reply.tokenize()),
        "jaccard": subject.to_multi_pick_list().jaccard_similarity(
            reply.to_multi_pick_list()),
        "language": body.detect_languages(),
        "entities": body.recognize_entities(),
        "length": body.text_len(),
        "in_body": subject.is_substring(body),
        "product_index": index,
        "product_back": index.deindexed(labels),
    }
    vec = transmogrify(
        list(feats.values()) + [
            product, FB.Real("accountAgeDays").as_predictor(),
            FB.Integral("priorTickets").as_predictor()])
    return label, vec, feats


# the text stages of workflow-text, by the names text_features gives them:
# the host stages (strings and counts on the host) and the two whose fits
# run on the device
TEXT_HOST_FEATURES = ("tfidf", "bigrams", "ngram_sim", "jaccard",
                      "language", "entities", "length", "in_body",
                      "product_index", "product_back")
TEXT_DEVICE_OPS = (("lda", "fit_lda"), ("lda", "lda_fold_in"),
                   ("embeddings", "factorize_embeddings"),
                   ("embeddings", "mean_pool_docs"))


def text_selector(leg: bool = False):
    """workflow-text's selector: BinaryClassificationModelSelector's 3-fold
    CrossValidation over logistic regression's default grid and a GBT of 10
    rounds at depth 4; the leg's, the GBT alone, for the CPU's sake (a
    Newton fit of logistic regression over the ~1 400 columns costs a Gram
    matrix an iteration, up to 50 of them at the grid's L1 points)."""
    from transmogrifai_tpu_torch.automl.selectors import (
        BinaryClassificationModelSelector, default_grid_for)
    from transmogrifai_tpu_torch.models.glm import OpLogisticRegression
    from transmogrifai_tpu_torch.models.trees import OpGBTClassifier
    return BinaryClassificationModelSelector.with_cross_validation(
        num_folds=3, seed=42, models_and_parameters=(
            [] if leg else [(OpLogisticRegression(),
                             default_grid_for("OpLogisticRegression"))])
        + [(OpGBTClassifier(), [dict(max_iter=10, max_depth=4)])])


def text_workflow(cols: dict, device=None, leg: bool = False):
    """(workflow, prediction, {name: text feature}) of the ticket flow in
    the port over a Dataset of `ticket_columns`: `text_features` ->
    SanityChecker() -> `text_selector(leg)` -> Workflow(device)."""
    from transmogrifai_tpu_torch import types as T
    from transmogrifai_tpu_torch.automl.preparators import SanityChecker
    from transmogrifai_tpu_torch.automl.transmogrifier import transmogrify
    from transmogrifai_tpu_torch.data.dataset import Column, Dataset
    from transmogrifai_tpu_torch.features.builder import FeatureBuilder
    from transmogrifai_tpu_torch.workflow import Workflow
    label, vec, feats = text_features(FeatureBuilder, transmogrify,
                                      product_labels(cols))
    checked = SanityChecker().set_input(label, vec).get_output()
    pred = text_selector(leg).set_input(label, checked).get_output()
    wf = Workflow(device=device).set_input_dataset(
        wide_dataset(cols, Dataset, Column, T)).set_result_features(pred)
    return wf, pred, feats


def text_scores(model, pred, cols: dict):
    """The escalation probabilities `model` gives the rows of `cols`."""
    from transmogrifai_tpu_torch import types as T
    from transmogrifai_tpu_torch.data.dataset import Column, Dataset
    from transmogrifai_tpu_torch.models.prediction import probability_of
    col = model.score(wide_dataset(cols, Dataset, Column, T)).column(
        pred.name)
    return probability_of(col)[:, 1].astype("float64")


@contextlib.contextmanager
def time_text_ops(store: dict):
    """Inside the block, each call of the text stages' device functions
    (`TEXT_DEVICE_OPS`) adds its calls and wall seconds, the device
    synchronised before and after, to `store`: {function: [calls, s]}."""
    import importlib
    import torch
    patched = []
    for mod_name, name in TEXT_DEVICE_OPS:
        mod = importlib.import_module(
            f"transmogrifai_tpu_torch.ops.{mod_name}")
        original = getattr(mod, name)

        def run(*args, _f=original, _n=name, **kw):
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _f(*args, **kw)
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            tally = store.setdefault(_n, [0, 0.0])
            tally[0] += 1
            tally[1] += time.perf_counter() - t0
            return out
        setattr(mod, name, run)
        patched.append((mod, name, original))
    try:
        yield store
    finally:
        for mod, name, original in patched:
            setattr(mod, name, original)


def text_leg_run(cols: dict, new: dict, device) -> dict:
    """One run of workflow-text's leg: `text_workflow(cols, device,
    leg=True)` trained with its refit levels recorded, then scored on
    `new`."""
    from transmogrifai_tpu_torch.utils.uid import reset_uids
    reset_uids()
    wf, pred, feats = text_workflow(cols, device=device, leg=True)
    t0 = time.perf_counter()
    with record_refit_levels([]) as levels:
        model = wf.train()
    return dict(model=model, pred=pred, feats=feats, levels=levels,
                train_s=time.perf_counter() - t0, walls=stage_walls(model),
                scored=text_scores(model, pred, new))


def _fitted(model, cls: str):
    return next(st for st in model.stages if type(st).__name__ == cls)


def rel_close(got, want, rtol: float) -> tuple:
    """(largest |got - want| over the largest |want|, within rtol of each
    entry or of the largest entry)."""
    import numpy as np
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = float(np.abs(want).max()) or 1.0
    err = float(np.abs(got - want).max())
    ok = bool(np.all(np.abs(got - want)
                     <= rtol * np.maximum(np.abs(want), scale)))
    return err / scale, ok


def compare_text_runs(c: dict, g: dict) -> dict:
    """workflow-text's CPU and card runs side by side: each host stage's
    output bit for bit, LDA's topics and the word2vec vectors within
    `TEXT_LDA_RTOL` / `TEXT_W2V_RTOL`, the winner, and the scores' largest
    difference with, where the refits split a node differently, the first
    such node's `split_witness`."""
    import numpy as np
    host = {}
    for name in TEXT_HOST_FEATURES:
        a = c["model"]._train_data.column(c["feats"][name].name).data
        b = g["model"]._train_data.column(g["feats"][name].name).data
        host[name] = (list(a) == list(b)) if a.dtype == object else (
            a.dtype == b.dtype and a.tobytes() == b.tobytes())
    lda_rel, lda_ok = rel_close(_fitted(g["model"], "OpLDAModel").beta,
                                _fitted(c["model"], "OpLDAModel").beta,
                                TEXT_LDA_RTOL)
    w2v_rel, w2v_ok = rel_close(
        _fitted(g["model"], "OpWord2VecModel").embeddings,
        _fitted(c["model"], "OpWord2VecModel").embeddings, TEXT_W2V_RTOL)
    cs, gs = c["model"].selector_summary(), g["model"].selector_summary()
    dprob = np.abs(c["scored"] - g["scored"])
    first = first_divergence(c["levels"], g["levels"])
    _, checked = vector_names(c["model"])
    names = c["model"]._train_data.column(checked).metadata.column_names()
    witness = None if first is None else split_witness(
        c["levels"], g["levels"], *first,
        cs.best_grid.get("max_depth", 0), names)
    return dict(
        host_identical=host, lda_beta_rel_diff=lda_rel, lda_ok=lda_ok,
        w2v_rel_diff=w2v_rel, w2v_ok=w2v_ok,
        winner=[[cs.best_model_name, cs.best_grid],
                [gs.best_model_name, gs.best_grid]],
        same_winner=(cs.best_model_name, cs.best_grid)
        == (gs.best_model_name, gs.best_grid),
        max_cell_diff=max(abs(x["mean_metric"] - y["mean_metric"])
                          for x, y in zip(cs.validation_results,
                                          gs.validation_results)),
        max_prob_diff=float(dprob.max()),
        share_prob_within_1e5=float((dprob <= 1e-5).mean()),
        scored_rows=len(dprob), witness=witness)


def workflow_text_phase(rows: int, seed: int):
    """The ticket flow (`ticket_columns`, `text_features`: tokenize, stop
    words, counts into LDA, TF-IDF, word2vec, regex bigrams, n-gram and
    Jaccard similarity, language, named entities, length, substring, the
    product indexed and deindexed; transmogrify, SanityChecker and
    `text_selector()`).

    First the leg: `TEXT_LEG_ROWS` records on the CPU and on the card:
    every host stage's output identical (`TEXT_HOST_FEATURES`), LDA's
    topics and the word vectors within `TEXT_LDA_RTOL` / `TEXT_W2V_RTOL`,
    the scores of as many new records within 1e-5 or, where the refits
    split a node differently, the first such node a tie (`split_witness`);
    the CPU-fitted workflow carried onto the card scores within 1e-5.

    Then the main path: `rows` records through Workflow() on the card.
    Launch counters are reset just before train() and read just after;
    every kernel must have launched. Each text stage's fit and transform
    wall, the device walls of LDA's EM and fold-in and of the ALS and the
    pooling (`time_text_ops`), train and score walls, width, winner, CV
    and holdout AuPR against the prevalence; `TEXT_SCORE_ROWS` new records
    scored, the model saved, loaded and scored again (identical); each
    kernel at every (kernel, F, S, C, Fo) key of train() on the inputs of
    its first launch against its plain version (rows of the kernels line,
    phase "text"). Returns (ok, launches by capture key, kernel rows)."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from transmogrifai_tpu_torch import convert
    from transmogrifai_tpu_torch.ops import tree_kernels as TK
    from transmogrifai_tpu_torch.utils.uid import reset_uids
    from transmogrifai_tpu_torch.workflow import WorkflowModel

    t_phase = t0 = time.perf_counter()
    small = ticket_columns(TEXT_LEG_ROWS, seed + 51)
    small_new = ticket_columns(TEXT_LEG_ROWS, seed + 52)
    c, g = (text_leg_run(small, small_new, dev) for dev in ("cpu", None))
    cmp = compare_text_runs(c, g)
    carried = convert.workflow_model_from_jax(
        [c["pred"]], [convert.stage_state(st) for st in c["model"].stages],
        device="cuda")
    carried_diff = float(np.abs(text_scores(carried, c["pred"], small_new)
                                - c["scored"]).max())
    leg = dict(rows=TEXT_LEG_ROWS, cpu_vs_card=cmp,
               carried_cpu_model_on_card_max_prob_diff=carried_diff,
               train_s_cpu=c["train_s"], train_s_cuda=g["train_s"],
               cpu_stage_walls_s=c["walls"], card_stage_walls_s=g["walls"])
    leg_s = time.perf_counter() - t0
    log(f"workflow-text leg ({leg_s:.2f}s): " + json.dumps(leg))
    leg_ok = (all(cmp["host_identical"].values()) and cmp["lda_ok"]
              and cmp["w2v_ok"] and carried_diff <= 1e-5
              and (cmp["max_prob_diff"] <= 1e-5
                   or (cmp["witness"] is not None
                       and cmp["witness"]["tie"])))
    del c, g, carried
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    cols = ticket_columns(rows, seed + 53)
    new = ticket_columns(TEXT_SCORE_ROWS, seed + 54)
    data_s = time.perf_counter() - t0
    reset_uids()
    wf, pred, _ = text_workflow(cols)
    selector = pred.origin_stage
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    captured, capture_launches = {}, collections.Counter()
    device_walls = {}
    TK.reset_launches()
    t0 = time.perf_counter()
    with capture_kernel_inputs(captured, capture_launches), \
            time_text_ops(device_walls):
        model = wf.train()
    train_s = time.perf_counter() - t0
    launches = dict(TK.launches)
    shape_launches = dict(TK.shape_launches)
    capture_launches = dict(capture_launches)
    train_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    sel = model.selector_summary()
    sc = model.sanity_checker_summary()
    vec, _ = vector_names(model)
    width = int(model._train_data.data(vec).shape[1])
    widths = group_widths(model)
    prevalence = float(np.mean(cols["escalated"][1]))
    best = max(sel.validation_results, key=lambda v: v["mean_metric"])
    families = family_results(sel, selector)
    walls = stage_walls(model)
    model._train_data = None
    del cols

    score_walls = {}
    t0 = time.perf_counter()
    with time_text_ops(score_walls):
        scored = text_scores(model, pred, new)
    score_s = time.perf_counter() - t0
    tmp = tempfile.mkdtemp(prefix="text-model-")
    try:
        path = os.path.join(tmp, "model")
        t0 = time.perf_counter()
        model.save(path)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = WorkflowModel.load(path)
        load_s = time.perf_counter() - t0
        rescored = text_scores(loaded, pred, new)
    finally:
        shutil.rmtree(tmp)
    reload_identical = bool(np.array_equal(scored, rescored))
    main_s = time.perf_counter() - t_phase - leg_s
    rows_out = kernel_rows([captured_shape(key, *captured[key],
                                           prefix="workflow-text")
                            for key in sorted(captured)], phase="text")
    del captured, loaded
    torch.cuda.empty_cache()
    res = dict(
        rows=rows, phase_s=time.perf_counter() - t_phase, leg_s=leg_s,
        main_s=main_s, data_s=data_s, train_s=train_s, score_s=score_s,
        score_rows=TEXT_SCORE_ROWS, save_s=save_s, load_s=load_s,
        stage_walls_s=walls, device_walls_train_s=device_walls,
        device_walls_score_s=score_walls,
        selector_walls_s=selector.walls, width=width, group_widths=widths,
        flagged=len(sc.dropped),
        winner=[sel.best_model_name, sel.best_grid],
        winner_cv_aupr=best["mean_metric"],
        holdout_aupr=sel.holdout_evaluation.get("au_pr"),
        holdout_auroc=sel.holdout_evaluation.get("au_roc"),
        prevalence=prevalence, families=families,
        reload_identical=reload_identical,
        peak_device_gb_train=train_peak_gb,
        peak_device_gb=torch.cuda.max_memory_allocated() / 1e9,
        launches=launches, shape_launches=shape_launches,
        capture_launches=capture_launches)
    log("workflow-text: " + json.dumps(res))
    by_shape = collections.Counter()
    for key, n in capture_launches.items():
        by_shape[launch_key(key)] += n
    ok = (leg_ok and all(n > 0 for n in launches.values())
          and set(launches) == set(TK.KERNELS)
          and {r["key"] for r in rows_out} == set(capture_launches)
          and dict(by_shape) == shape_launches
          and set(families) == {"OpLogisticRegression", "OpGBTClassifier"}
          and all(op in device_walls for _, op in TEXT_DEVICE_OPS)
          and scored.shape == (TEXT_SCORE_ROWS,)
          and bool(np.isfinite(scored).all()) and reload_identical
          and best["mean_metric"] > prevalence
          and sel.holdout_evaluation["au_pr"] > prevalence)
    return ok, capture_launches, rows_out


STREAM_NAMES = tuple(f"x{j}" for j in range(STREAM_COLS))


def stream_schema() -> dict:
    """workflow-stream's Avro record, bench.py's (bench.py:1144-1147): 16
    float columns, the float label and a long row id (the fold is id %
    STREAM_FOLDS)."""
    return {"type": "record", "name": "Row", "fields": [
        {"name": nm, "type": "float"} for nm in STREAM_NAMES + ("y",)]
        + [{"name": "id", "type": "long"}]}


def stream_slab(seed: int, start: int, n: int) -> dict:
    """Rows [start, start + n) of workflow-stream's data as columns: x ~
    N(0, 1) float32, y = 1{x . beta + N(0, 0.5^2) > 0} (beta from
    `seed`), id = the row's index. Each slab draws from its own
    (seed, start) stream, so a slab is made without the rows before it."""
    import numpy as np
    beta = np.random.default_rng(seed).normal(size=STREAM_COLS)
    rng = np.random.default_rng([seed, start])
    X = rng.normal(size=(n, STREAM_COLS)).astype(np.float32)
    noise = rng.normal(0.0, 0.5, size=n)
    cols = {nm: X[:, j] for j, nm in enumerate(STREAM_NAMES)}
    cols["y"] = (X @ beta + noise > 0).astype(np.float32)
    cols["id"] = np.arange(start, start + n, dtype=np.int64)
    return cols


def write_stream_shards(root: str, rows: int, seed: int) -> list:
    """The rows as Avro shards of STREAM_SLAB rows (the only full copy of
    X): one slab in memory at a time, blocks of STREAM_BATCH records."""
    from transmogrifai_tpu_torch.readers.avro import write_avro_columns
    paths = []
    for start in range(0, rows, STREAM_SLAB):
        p = os.path.join(root, f"rows_{len(paths):04d}.avro")
        write_avro_columns(p, stream_schema(),
                           stream_slab(seed, start,
                                       min(STREAM_SLAB, rows - start)),
                           block_records=STREAM_BATCH)
        paths.append(p)
    return paths


def stream_resident(rows: int, seed: int):
    """(X [n, d] f32, y [n], fold [n]) of the same rows in host memory,
    for the checks only."""
    import numpy as np
    slabs = [stream_slab(seed, s, min(STREAM_SLAB, rows - s))
             for s in range(0, rows, STREAM_SLAB)]
    X = np.concatenate([np.stack([c[nm] for nm in STREAM_NAMES], 1)
                        for c in slabs])
    return (X, np.concatenate([c["y"] for c in slabs]),
            np.concatenate([c["id"] % STREAM_FOLDS for c in slabs]))


def stream_sources(paths: list, rows: int, workers: int = STREAM_WORKERS):
    """(stats, GLM, x-only) sharded sources over the Avro shards: chunks
    of (x, y, w), (x, y, w, fold masks [c, F]) and (x,); a row's fold is
    its id % STREAM_FOLDS (bench.py's)."""
    import numpy as np
    from transmogrifai_tpu_torch.parallel import ingest as ING

    def x_of(c):
        return np.stack([c[nm] for nm in STREAM_NAMES], 1)

    def stats_cols(c):
        return x_of(c), c["y"], np.ones(len(c["y"]), np.float32)

    def glm_cols(c):
        fold = c["id"] % STREAM_FOLDS
        masks = np.stack([(fold != k) for k in range(STREAM_FOLDS)],
                         1).astype(np.float32)
        return x_of(c), c["y"], np.ones(len(c["y"]), np.float32), masks

    return [ING.sharded_reader_source(
        paths, fn, batch_records=STREAM_BATCH, workers=workers,
        n_rows=rows, label=label)
        for fn, label in ((stats_cols, "stats"), (glm_cols, "glm"),
                          (lambda c: (x_of(c),), "trees"))]


@contextlib.contextmanager
def env_set(**kv):
    """The environment variables `kv` set inside the block, restored
    after."""
    old = {k: os.environ.get(k) for k in kv}
    os.environ.update({k: str(v) for k, v in kv.items()})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


STATS_FIELDS = ("count", "mean", "m2", "variance", "min", "max",
                "num_non_zeros", "corr_label", "corr_matrix")


def stats_close(a, b, rtol: float = 1e-5, atol: float = 1e-6) -> float:
    """The largest |a - b| - (atol + rtol |b|) over the statistics'
    fields: <= 0 when every field is within tolerance."""
    import numpy as np
    worst = -np.inf
    for k in STATS_FIELDS:
        u, v = np.asarray(getattr(a, k)), np.asarray(getattr(b, k))
        worst = max(worst, float((np.abs(u - v)
                                  - (atol + rtol * np.abs(v))).max()))
    return worst


def stats_identical(a, b) -> bool:
    import numpy as np
    return all(np.array_equal(np.asarray(getattr(a, k)),
                              np.asarray(getattr(b, k)), equal_nan=True)
               for k in STATS_FIELDS)


def stream_glm(src, device):
    """The streamed GLM rounds of workflow-stream (bench.py:1202-1206: 2
    lanes a fold, max_iter 15, tol 1e-5, warm start)."""
    import numpy as np
    from transmogrifai_tpu_torch.ops import glm_sweep as GS
    return GS.sweep_glm_streamed_rounds(
        src, None, None, None, np.asarray(STREAM_REGS, np.float32),
        np.zeros(len(STREAM_REGS), np.float32), loss="logistic",
        max_iter=15, tol=1e-5, warm_start=True, device=device)


def h2d_rates(dev, tile_rows: int, reps: int = 20) -> dict:
    """Host -> device GB/s of one stats tile ([tile_rows, 16] f32), each
    over `reps` copies: the copy out of a pinned ring slot alone (CUDA
    events on the copy stream), a tile put through the ring as the
    pipeline does (`_TileLander.alloc`, the rows written into the slot,
    `land`; wall to the last copy's end), and the port's pageable
    `to_device` (wall)."""
    import numpy as np
    import torch
    from transmogrifai_tpu_torch.device import to_device
    from transmogrifai_tpu_torch.parallel import tileplane as TP
    tile = np.random.default_rng(0).normal(
        size=(tile_rows, STREAM_COLS)).astype(np.float32)
    stream = torch.cuda.Stream()
    lander = TP._TileLander(dev, 2, stream)
    out = {"bytes": int(tile.nbytes), "reps": reps}
    slot = torch.from_numpy(tile).pin_memory()
    dst = torch.empty(tile.shape, device=dev)
    with torch.cuda.stream(stream):
        dst.copy_(slot, non_blocking=True)
        start, end = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        start.record(stream)
        for _ in range(reps):
            dst.copy_(slot, non_blocking=True)
        end.record(stream)
    end.synchronize()
    out["pinned_copy_gb_per_s"] = tile.nbytes * reps / 1e6 / \
        start.elapsed_time(end)

    def through_ring():
        (buf,) = lander.alloc((tile.shape,))
        buf[...] = tile
        lander.land((buf,))

    for name, copy in (
            ("ring_fill_land", through_ring),
            ("pageable_to_device", lambda: to_device(tile, dev))):
        copy()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            copy()
        torch.cuda.synchronize()
        out[name + "_gb_per_s"] = tile.nbytes * reps / 1e9 / (
            time.perf_counter() - t0)
    return out


def stream_leg(paths: list, rows: int) -> tuple:
    """The CPU leg: statistics, GLM rounds and streamed binning of the same
    `rows`-row shard on the CPU and on the card. Returns (record, ok)."""
    import numpy as np
    from transmogrifai_tpu_torch.ops import stats_engine as SE
    from transmogrifai_tpu_torch.ops import trees as T
    runs = {}
    for dev in ("cpu", "cuda"):
        st_src, glm_src, x_src = stream_sources(paths, rows)
        t0 = time.perf_counter()
        res = SE.run_stats(st_src, corr_matrix=True, device=dev)
        B, b0, info = stream_glm(glm_src, dev)
        edges = T.stream_quantile_edges(x_src, STREAM_BINS,
                                        hist_bins=STREAM_HIST_BINS,
                                        device=dev)
        binned = T.stream_bin_matrix(x_src, edges, device=dev)
        runs[dev] = dict(res=res, B=B, b0=b0, info=info, edges=edges,
                         binned=binned, s=time.perf_counter() - t0)
    c, g = runs["cpu"], runs["cuda"]
    rec = dict(rows=rows, cpu_s=c["s"], card_s=g["s"],
               stats_over_tol=stats_close(g["res"], c["res"]),
               glm_max_abs=float(max(np.abs(g["B"] - c["B"]).max(),
                                     np.abs(g["b0"] - c["b0"]).max())),
               glm_rounds=[c["info"]["glm_rounds"], g["info"]["glm_rounds"]],
               edges_identical=bool(np.array_equal(g["edges"], c["edges"],
                                                   equal_nan=True)),
               bins_identical=bool(np.array_equal(g["binned"],
                                                  c["binned"])))
    ok = (rec["stats_over_tol"] <= 0 and rec["glm_max_abs"] <= 1e-4
          and rec["edges_identical"] and rec["bins_identical"])
    return rec, ok


def stream_workflow(sample_rows: int, seed: int, device=None):
    """(workflow, prediction, trained model) of the scoring flow: the 16
    columns as RealNN predictors transmogrified into one vector (its
    columns are x0..x15 in order) into a Spark GBT, trained on
    `sample_rows` rows. workflow-stream swaps the fitted GBT's trees for
    the trees grown on the streamed bins."""
    import numpy as np
    from transmogrifai_tpu_torch.automl.transmogrifier import transmogrify
    from transmogrifai_tpu_torch.features.builder import FeatureBuilder
    from transmogrifai_tpu_torch.models.trees import OpGBTClassifier
    from transmogrifai_tpu_torch.readers.readers import ListReader
    from transmogrifai_tpu_torch.utils.uid import reset_uids
    from transmogrifai_tpu_torch.workflow import Workflow
    reset_uids()
    feats = [FeatureBuilder.RealNN(nm).extract(
        lambda r, nm=nm: r[nm]).as_predictor() for nm in STREAM_NAMES]
    label = FeatureBuilder.RealNN("y").extract(
        lambda r: r["y"]).as_response()
    pred = OpGBTClassifier(max_iter=2, max_depth=STREAM_GBT["depth"],
                           max_bins=STREAM_BINS).set_input(
        label, transmogrify(feats)).get_output()
    cols = stream_slab(seed + 1, 0, sample_rows)
    records = [dict(zip(cols, vals)) for vals in zip(
        *[np.asarray(v, np.float64).tolist() for v in cols.values()])]
    wf = Workflow(device=device).set_reader(ListReader(records)) \
        .set_result_features(pred)
    return wf, pred, wf.train()


def avro_records(path: str):
    """Records (dicts) of one Avro shard, decoded a block at a time: the
    streaming reader's record factory."""
    import numpy as np
    from transmogrifai_tpu_torch.readers.avro import read_avro_columns
    for cols in read_avro_columns(path, batch_records=STREAM_BATCH,
                                  arrays=True):
        names = list(cols)
        for vals in zip(*[np.asarray(cols[nm]).tolist() for nm in names]):
            yield dict(zip(names, vals))


def workflow_stream_phase(rows: int, seed: int):
    """bench.py's streaming scenario on the port: `rows` x 16 float columns
    and 3 folds written once from `seed` as Avro shards of STREAM_SLAB rows
    (the only full copy of X; the phase rebuilds X in host memory for its
    checks alone), read through `sharded_reader_source` with
    STREAM_WORKERS parse workers into the tileplane:
    - run_stats over the source against the resident route (the stats
      tolerances: rtol 1e-5, atol 1e-6), rows == `rows`, peak host rows <=
      2 tiles; the same pass at prefetch depth 2 and under TMOG_TILEPLANE=0
      bit-identical to the depth-1 pass;
    - the GLM rounds over the source (2 lanes a fold, max_iter 15, warm
      start) against the resident round driver on the card (rtol 5e-3,
      atol 7e-4), with their data passes;
    - stream_quantile_edges + stream_bin_matrix exactly `bin_matrix` at
      the same edges;
    - a boosted fit (`STREAM_GBT`) on the streamed bins on the card:
      every kernel launches; each (kernel, F, S, C, Fo) key on the inputs
      of its first launch against its plain version (phase "stream");
    - a workflow (16 RealNN -> transmogrify -> Spark GBT, trained on
      20 000 rows) given those trees, saved, and scored through
      OpWorkflowRunner's StreamingScore over one shard's STREAM_SLAB
      records (fixed record tiles of STREAM_SCORE_TILE): every score
      within 1e-5 of `model.score` on the same records;
    - the CPU leg at STREAM_LEG_ROWS rows (`stream_leg`).
    Printed: rows/s of each pass, the GLM's data passes, a traced probe's
    overlap ratio (copy + compute) / wall with copy, compute and parse
    seconds, H2D GB/s through the pinned ring against pageable
    `to_device`, the phase's wall, the card. Returns (ok, launches by
    capture key, kernel rows)."""
    import tempfile
    import numpy as np
    import torch
    from transmogrifai_tpu_torch.data.dataset import Column, Dataset
    from transmogrifai_tpu_torch.device import resolve_device
    from transmogrifai_tpu_torch.models.prediction import probability_of
    from transmogrifai_tpu_torch.ops import glm_sweep as GS
    from transmogrifai_tpu_torch.ops import stats_engine as SE
    from transmogrifai_tpu_torch.ops import tree_kernels as TK
    from transmogrifai_tpu_torch.ops import trees as T
    from transmogrifai_tpu_torch.readers.streaming import \
        IterStreamingReader
    from transmogrifai_tpu_torch.types import ColumnKind
    from transmogrifai_tpu_torch.utils.metrics import collector
    from transmogrifai_tpu_torch.workflow import runner as R
    from transmogrifai_tpu_torch.workflow.workflow import WorkflowModel

    dev = resolve_device()
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_stream_")
    atexit.register(shutil.rmtree, root, ignore_errors=True)
    res = dict(rows=rows, cols=STREAM_COLS, folds=STREAM_FOLDS,
               workers=STREAM_WORKERS)
    checks = {}
    t0 = time.perf_counter()
    paths = write_stream_shards(root, rows, seed)
    res["write_s"] = time.perf_counter() - t0
    res["shards"] = len(paths)
    res["disk_mb"] = sum(os.path.getsize(p) for p in paths) / 1e6
    leg_dir = os.path.join(root, "leg")
    os.makedirs(leg_dir)
    leg_paths = write_stream_shards(leg_dir, STREAM_LEG_ROWS, seed + 7)
    X, y, fold = stream_resident(rows, seed)
    st_src, glm_src, x_src = stream_sources(paths, rows)

    def timed(name, fn, passes=1):
        t = time.perf_counter()
        out = fn()
        wall = time.perf_counter() - t
        res[name] = dict(wall_s=wall, rows_per_s=rows * passes / wall)
        return out

    # statistics: depth 1, depth 2, the switch off
    passes = {}
    for name, env in (("stats_depth1", dict(TMOG_TILE_PREFETCH=1)),
                      ("stats_depth2", dict(TMOG_TILE_PREFETCH=2)),
                      ("stats_sync", dict(TMOG_TILEPLANE=0))):
        with env_set(**env):
            passes[name] = timed(name, lambda: SE.run_stats(
                st_src, corr_matrix=True, label=name))
        ps = SE._last_stream_stats
        res[name].update(tiles=ps.tiles, tile_rows=ps.tile_rows,
                         peak_host_rows=ps.peak_host_rows,
                         pinned_slots=ps.pinned_slots, pass_rows=ps.rows)
    fused = SE.run_stats(X, y, driver="fused", corr_matrix=True)
    checks["stats_over_tol"] = stats_close(passes["stats_depth1"], fused)
    checks["stats_rows"] = res["stats_depth1"]["pass_rows"] == rows
    checks["stats_peak_host"] = res["stats_depth1"]["peak_host_rows"] \
        <= 2 * res["stats_depth1"]["tile_rows"]
    checks["stats_depths_identical"] = stats_identical(
        passes["stats_depth2"], passes["stats_depth1"])
    checks["stats_switch_identical"] = stats_identical(
        passes["stats_sync"], passes["stats_depth1"])

    # GLM rounds: the source against the resident round driver
    t = time.perf_counter()
    B, b0, info = stream_glm(glm_src, None)
    wall = time.perf_counter() - t
    n_pass = info["data_passes"] + 1     # + the prep pass
    res["glm_stream"] = dict(wall_s=wall, data_passes=n_pass,
                             rows_per_s_effective=rows * n_pass / wall,
                             **{k: info[k] for k in (
                                 "glm_rounds", "active_per_round",
                                 "iters_per_round", "lanes_retired")})
    masks = np.stack([(fold != k) for k in range(STREAM_FOLDS)]
                     ).astype(np.float32)
    t = time.perf_counter()
    rB, rb0, rinfo = GS.sweep_glm_streamed_rounds(
        torch.from_numpy(X).to(dev), torch.from_numpy(y).to(dev),
        torch.ones(rows, device=dev), torch.from_numpy(masks).to(dev),
        np.asarray(STREAM_REGS, np.float32),
        np.zeros(len(STREAM_REGS), np.float32), loss="logistic",
        max_iter=15, tol=1e-5, warm_start=True)
    res["glm_resident"] = dict(wall_s=time.perf_counter() - t,
                               data_passes=rinfo["data_passes"],
                               glm_rounds=rinfo["glm_rounds"])
    checks["glm_max_over_tol"] = float(max(
        (np.abs(B - rB) - (7e-4 + 5e-3 * np.abs(rB))).max(),
        (np.abs(b0 - rb0) - (7e-4 + 5e-3 * np.abs(rb0))).max()))
    del masks

    # streamed tree binning, then a boosted fit on the bins
    edges = timed("tree_edges", lambda: T.stream_quantile_edges(
        x_src, STREAM_BINS, hist_bins=STREAM_HIST_BINS), passes=2)
    binned = timed("tree_bins", lambda: T.stream_bin_matrix(x_src, edges))
    Xd = torch.from_numpy(X).to(dev)
    resident_bins = T.bin_matrix(Xd, torch.from_numpy(edges).to(dev)).cpu()
    checks["bins_identical"] = bool(np.array_equal(binned,
                                                   resident_bins.numpy()))
    res["binned_mb"] = binned.nbytes / 1e6
    # edges: within one histogram bin width of the columns' exact
    # quantiles (resident quantile_edges samples 131 072 of the rows here)
    bw = (np.nanmax(X, 0) - np.nanmin(X, 0)) / STREAM_HIST_BINS
    qs = np.arange(1, STREAM_BINS) / STREAM_BINS
    exact = np.quantile(X.astype(np.float64), qs, axis=0).T
    q_res = T.quantile_edges(Xd, STREAM_BINS).cpu().numpy()
    checks["edges_bin_widths_from_exact"] = float(
        (np.abs(edges - exact) / bw[:, None]).max())
    res["edges_bin_widths_from_sampled_resident"] = float(
        (np.abs(edges - q_res) / bw[:, None]).max())
    del Xd, resident_bins
    Xb = torch.from_numpy(binned).to(dev)
    yd = torch.from_numpy(y).to(dev)
    captured, capture_launches = {}, collections.Counter()
    TK.reset_launches()
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    t = time.perf_counter()
    with capture_kernel_inputs(captured, capture_launches):
        trees, base = T.fit_gbt(Xb, yd, torch.ones_like(yd),
                                n_bins=STREAM_BINS, generator=gen,
                                **STREAM_GBT)
    torch.cuda.synchronize()
    res["gbt_fit_s"] = time.perf_counter() - t
    launches = dict(TK.launches)
    capture_launches = dict(capture_launches)
    res["gbt_launches"] = launches
    checks["gbt_all_kernels"] = set(launches) == set(TK.KERNELS) and all(
        n > 0 for n in launches.values())
    del Xb, yd

    # the workflow with those trees: saved, then StreamingScore
    wf, pred, model = stream_workflow(STREAM_LEG_ROWS, seed)
    gbt = next(st for st in model.stages
               if type(st).__name__ == "TreeEnsembleModel")
    edges_t = torch.from_numpy(edges).to(dev)
    tv = T.thresholds_to_values(trees.feat, trees.thresh, edges_t)
    gbt.feat = trees.feat.cpu().numpy().astype(np.int32)
    gbt.thresh_val = tv.cpu().numpy().astype(np.float32)
    gbt.leaf = trees.leaf.cpu().numpy().astype(np.float32)
    gbt.miss = trees.miss.cpu().numpy().astype(np.int32)
    gbt.depth, gbt.base = STREAM_GBT["depth"], float(base)
    model_dir = os.path.join(root, "model")
    model.save(model_dir)
    score_dir = os.path.join(root, "scores")
    reader = IterStreamingReader(lambda: avro_records(paths[0]),
                                 batch_records=STREAM_BATCH)
    TK.reset_launches()
    t = time.perf_counter()
    out = R.OpWorkflowRunner(wf, score_reader=reader).run(
        R.OpWorkflowRunner.STREAMING_SCORE, R.OpParams(
            model_location=model_dir, write_location=score_dir,
            custom_params={"score_tile_rows": STREAM_SCORE_TILE}))
    score_s = time.perf_counter() - t
    res["streaming_score"] = dict(records=out.n_rows, wall_s=score_s,
                                  records_per_s=out.n_rows / score_s,
                                  tile_records=STREAM_SCORE_TILE,
                                  kernel_launches=dict(TK.launches))
    with open(os.path.join(score_dir, "scores.jsonl")) as fh:
        streamed = np.array([json.loads(line)[pred.name]["probability_1"]
                             for line in fh])
    # model.score on the same records: the shard's columns as a Dataset
    loaded = WorkflowModel.load(model_dir)
    shard = stream_slab(seed, 0, STREAM_SLAB)
    ds = Dataset({nm: Column(kind=ColumnKind.FLOAT,
                             data=np.asarray(shard[nm], np.float64))
                  for nm in STREAM_NAMES + ("y",)})
    want = probability_of(loaded.score(ds).column(pred.name))[:, -1]
    checks["score_records"] = out.n_rows == len(streamed) == len(want) \
        >= STREAM_SLAB
    checks["score_max_abs"] = float(np.abs(streamed - want).max()) \
        if len(streamed) == len(want) else float("inf")
    res["streaming_score"]["mean_p"] = float(np.mean(streamed))
    del ds, loaded

    # the traced probe: overlap of copy and compute, parse seconds
    collector.enable("workflow-stream-probe")
    try:
        t = time.perf_counter()
        SE.run_stats(st_src, corr_matrix=True, label="overlap_probe")
        wall = time.perf_counter() - t
        ps = SE._last_stream_stats
        parse_s = sum(r.parse_seconds for r in
                      collector.current.ingest_metrics)
        res["overlap_probe"] = dict(
            overlap_ratio=(ps.copy_seconds + ps.compute_seconds)
            / ps.wall_seconds, copy_s=ps.copy_seconds,
            compute_s=ps.compute_seconds, parse_s=parse_s,
            pass_wall_s=ps.wall_seconds, wall_s=wall,
            copy_gb=ps.copy_bytes / 1e9)
    finally:
        collector.finish()
        collector.disable()
    res["h2d"] = h2d_rates(dev, res["stats_depth1"]["tile_rows"])

    leg, leg_ok = stream_leg(leg_paths, STREAM_LEG_ROWS)
    res["leg"] = leg
    main_s = time.perf_counter() - t_phase
    rows_out = kernel_rows([captured_shape(key, *captured[key],
                                           prefix="workflow-stream")
                            for key in sorted(captured)], phase="stream")
    del captured
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    res.update(checks=checks, main_s=main_s,
               phase_s=time.perf_counter() - t_phase,
               capture_launches=capture_launches)
    log("workflow-stream: " + json.dumps(res))
    ok = (leg_ok and checks["stats_over_tol"] <= 0 and checks["stats_rows"]
          and checks["stats_peak_host"] and checks["stats_depths_identical"]
          and checks["stats_switch_identical"]
          and checks["glm_max_over_tol"] <= 0 and checks["bins_identical"]
          and checks["edges_bin_widths_from_exact"] <= 1.0
          and checks["gbt_all_kernels"] and checks["score_records"]
          and checks["score_max_abs"] <= 1e-5
          and {r["key"] for r in rows_out} == set(capture_launches))
    return ok, capture_launches, rows_out


def tf32_phase() -> bool:
    """Float32 products must stay in full f32 (no TF32)."""
    import torch
    tf32 = torch.backends.cuda.matmul.allow_tf32
    prec = torch.get_float32_matmul_precision()
    log(f"tf32: torch.backends.cuda.matmul.allow_tf32={tf32} "
        f"float32_matmul_precision={prec!r}")
    return tf32 is False and prec == "highest"


def sass_phase(lib_path: str):
    """Shared-memory atomics in the built kernels, from the SASS: how many
    ATOMS instructions of each kind each kernel holds (a CAS loop shows as
    ATOMS.CAST.SPIN / ATOMS.CAS, a native add as ATOMS.ADD). Returns the
    counts by kernel, None where cuobjdump is missing."""
    from transmogrifai_tpu_torch.ops import _build
    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    if not os.path.isfile(tool):
        log("sass: not measured (no cuobjdump beside nvcc)")
        return None
    out = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    counts, fn = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : \S*?(\w+_kernel)(\w*)", line)
        if m:
            fn = m.group(1) + m.group(2)[:12]
            counts[fn] = {}
            continue
        m = re.search(r"\b(ATOMS\.[A-Z0-9.]+)", line)
        if m and fn:
            counts[fn][m.group(1)] = counts[fn].get(m.group(1), 0) + 1
    log("sass: " + json.dumps(counts, sort_keys=True))
    return counts


def sorted_hist_atomics(counts) -> list:
    """The f32 shared-memory atomics (a CAS loop: ATOMS.CAS*, ATOMS.CAST*)
    that the sorted path's histogram kernel holds, by kernel instance; the
    kernel is built to hold none. Raises where the SASS shows no instance of
    it (cuobjdump missing, or the kernel not built)."""
    if not counts or not any("sorted_hist_kernel" in fn for fn in counts):
        raise RuntimeError("sass: no sorted_hist_kernel in the SASS")
    return [f"{fn}: {kind} x{n}" for fn, kinds in sorted(counts.items())
            if "sorted_hist_kernel" in fn
            for kind, n in sorted(kinds.items()) if kind.startswith(
                ("ATOMS.CAS", "ATOMS.CAST"))]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=10_000_000,
                    help="rows of the main-path sweep (>= 2M keeps the "
                    "binned rank-metric kernel on the path)")
    ap.add_argument("--configs", type=int, default=16,
                    help="XGBoost grid points swept (of 16)")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    from transmogrifai_tpu_torch.device import resolve_device
    from transmogrifai_tpu_torch.ops import _build
    from transmogrifai_tpu_torch.tools import hist_paths as HP

    resolve_device()
    if card_roof() is None:
        print(f"chip_smoke: no roof for {torch.cuda.get_device_name(0)} "
              "in utils.metrics.DEVICE_ROOFS", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    card = HP.card_line()
    log(f"device: {card} ({torch.cuda.get_device_name(0)}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda})")
    t0 = time.perf_counter()
    lib = _build.library()
    log(f"build: {time.perf_counter() - t0:.2f}s")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log("  ptxas: " + line.strip())
    failures = [f"sass: f32 shared atomic in the sorted histogram "
                f"kernel ({a})"
                for a in sorted_hist_atomics(sass_phase(lib._name))]
    if not tf32_phase():
        failures.append("TF32 is on")
    rows = kernel_phase(SEED)
    failures += [f"kernel {r['name']} ({r['shape']})" for r in rows
                 if not r.pop("ok")]
    small_ok, _ = small_phase(SEED)
    if not small_ok:
        failures.append("small CPU/GPU sweep disagreement")
    main_ok, launches, shape_launches, (X, y, winner, main_res) = \
        main_phase(args.rows, args.configs, SEED)
    if not main_ok:
        failures.append("main path")
    if not profile_phase(X, y, winner):
        failures.append("profile: no device time")
    del X, y
    if not glm_small_phase(SEED):
        failures.append("glm-small CPU/GPU sweep disagreement")
    glm_ok, glm_launches, (X, y) = glm_main_phase(args.rows, SEED)
    if not glm_ok:
        failures.append("glm-main")
    base_ok, base_res = baseline_phase(X, y)
    if not base_ok:
        failures.append("baseline")
    fused_ok, fused_launches, fused_rows = fused_sweep_phase(
        args.rows, SEED, main_res)
    if not fused_ok:
        failures.append("tree-sweep-10M-fused")
    failures += [f"kernel {r['name']} ({r['shape']})" for r in fused_rows
                 if not r.pop("ok")]
    rows += fused_rows
    if not baseline_bf16_phase(X, y, base_res):
        failures.append("baseline-bf16")
    del main_res, base_res
    if not glm_profile_phase(X, y):
        failures.append("glm-profile: no device time")
    del X, y
    torch.cuda.empty_cache()
    if not workflow_small_phase(SEED):
        failures.append("workflow-small CPU/GPU disagreement")
    counts = {"tree": shape_launches, "glm": glm_launches,
              "fused": fused_launches}
    for name, phase, n_rows, key in (
            ("workflow-titanic", workflow_titanic_phase, TITANIC_ROWS,
             "titanic"),
            ("workflow-wide", workflow_wide_phase, WIDE_ROWS, "wide"),
            ("workflow-events", workflow_events_phase, EVENTS_USERS,
             "events")):
        ok, counts[key], new_rows = phase(n_rows, SEED)
        if not ok:
            failures.append(name)
        failures += [f"kernel {r['name']} ({r['shape']})" for r in new_rows
                     if not r.pop("ok")]
        rows += new_rows
        torch.cuda.empty_cache()
    wf_ok, wf_launches, wf_captures, wf_rows = workflow_main_phase(
        args.rows, SEED)
    if not wf_ok:
        failures.append("workflow-main")
    failures += [f"kernel {r['name']} ({r['shape']})" for r in wf_rows
                 if not r.pop("ok")]
    rows += wf_rows
    counts["workflow"] = wf_captures
    torch.cuda.empty_cache()
    reg_ok, counts["regression"], reg_rows = workflow_regression_phase(
        REGRESSION_ROWS, SEED)
    if not reg_ok:
        failures.append("workflow-regression")
    failures += [f"kernel {r['name']} ({r['shape']})" for r in reg_rows
                 if not r.pop("ok")]
    rows += reg_rows
    torch.cuda.empty_cache()
    mc_ok, (counts["multiclass"], counts["iris"]), mc_rows = \
        workflow_multiclass_phase(COVERTYPE_ROWS, SEED)
    if not mc_ok:
        failures.append("workflow-multiclass")
    failures += [f"kernel {r['name']} ({r['shape']})" for r in mc_rows
                 if not r.pop("ok")]
    rows += mc_rows
    torch.cuda.empty_cache()
    text_ok, counts["text"], text_rows = workflow_text_phase(TEXT_ROWS, SEED)
    if not text_ok:
        failures.append("workflow-text")
    failures += [f"kernel {r['name']} ({r['shape']})" for r in text_rows
                 if not r.pop("ok")]
    rows += text_rows
    torch.cuda.empty_cache()
    stream_ok, counts["stream"], stream_rows = workflow_stream_phase(
        STREAM_ROWS, SEED)
    if not stream_ok:
        failures.append("workflow-stream")
    failures += [f"kernel {r['name']} ({r['shape']})" for r in stream_rows
                 if not r.pop("ok")]
    rows += stream_rows
    torch.cuda.empty_cache()
    serve_ok, _ = serve_phase(HELD.pop("wide_dir"), HELD.pop("tree"))
    if not serve_ok:
        failures.append("serve")
    for r in rows:
        key = r.pop("key")
        r["launches"] = counts[r["phase"]].get(key, 0)
        if r["phase"] in ("tree", "glm", "workflow"):
            # launches at this row's key inside workflow-main's train():
            # its (kernel, F, S) key, a workflow row's own capture key
            r["workflow_launches"] = (wf_captures if r["phase"] == "workflow"
                                      else wf_launches).get(key, 0)
    failures += [f"kernel {r['name']} ({r['shape']}): no launch on its "
                 "main path" for r in rows if not r["launches"]]
    log(f"total: {time.perf_counter() - t_start:.1f}s")
    if failures:
        print("chip_smoke FAILED: " + "; ".join(failures), file=sys.stderr)
        return 1
    log(json.dumps({"kernels": rows}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
