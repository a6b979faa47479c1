#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths on one NVIDIA
GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line per record:

  env     torch/CUDA versions, the card, and the build of every kernel
          library from roc_tpu_torch/csrc/, one nvcc per source, all
          started together (timed; the compiler's register report goes to
          stderr)
  graph   host generation of the Reddit-shape synthetic graph (timed)
  native  the host graph builders (roc_tpu_torch/native): the g++ build's
          seconds; on Reddit each builder natively and under
          ROC_TPU_NO_NATIVE=1, twice each way (native, NumPy, NumPy,
          native), element-equal, with each way's faster seconds: the
          transpose with its edge map, RCM, the cut and the halo maps at
          P=4, the header, a row and a column slice and the whole read of
          a temporary .lux, a 20,000x602 feature CSV (written %.9g, parsed
          back to the same bits); GCN 602-256-41 (fast, dropout 0.5, 3
          epochs) built from the dataset both ways: the seconds to the
          trainer and to the end of its first epoch, the losses bitwise
          equal; -reorder on both ways (its RCM and reorder seconds, the
          same graph); then the serve selftest with deltas on
          reddit-small with the lock-order witness armed before the engine
          is made: the pairs it recorded, validate() == []
  kernel_sum_shapes  aggregate_sum (over a CSR and its transpose) and
          aggregate_linear (relu) against their plain versions on a small
          graph with a hub row of 20,000 in-edges and two rows with no
          in-edges, at H = 1, 7, 41, 255, 602, 608, 1000 (H_out 41, 256, 7,
          65, 300, 1, 64), both precisions, x contiguous and a column slice
          of a wider tensor (unaligned rows): bitwise on integer data,
          and on Gaussian data each element within 1e-5 of the sum of the
          absolute values of its terms (a one-column row may cancel to
          near 0, where its max-abs is no yardstick; the row error is
          reported beside it)
  kernel  the sum-aggregation kernel against its plain PyTorch version on
          the card, on that graph, at H = 41, 256, 602 in both precisions:
          bitwise on integer data ({0,1} features on the Reddit graph, and
          the in-degree-4 ring fixture), within 1e-5 of each row's max-abs
          on Gaussian data (fp32 reassociation only: both round at the same
          points).  Times: the kernel, the plain version, torch.sparse.mm
          on the same CSR (the library yardstick, fp32), and the bound
          (compulsory bytes over 3.35 TB/s vs E*H fp32 adds over 67
          TFLOP/s, the larger); in fast the time includes the staging
          launch, timed alone as stage_ms
  kernel  (training) the kernels of the training path on the same graph,
          each against its plain version as above (integer data: x in
          {0,1}, W in {-2..2}, g in {-3..3}, all sums exact in fp32):
          stage_plane (fast's bf16 plane of x) at H = 602, 256, 41;
          aggregate_sum over the transposed CSR at H = 256 and 41 (the
          unfused backward), aggregate_linear at 602->256 relu, 256->41
          none and 256->256 relu (stage_ms beside the total in fast),
          stage_cotangent (the backward's masked, rounded cotangent
          plane) at H = 256 relu and 41 none, aggregate_linear_bwd at
          602<-256 relu (u alone, as the first layer's backward asks, and
          with dx), 256<-256 relu with dx (gcn-chain's interior layer) and
          256<-41 none, both precisions; u also bitwise equal to
          aggregate_sum over the transposed CSR on the staged plane.
          Library: torch.sparse.mm then torch.matmul (fp32, TF32 off);
          for the staging, which no one call computes, the where + cast
          composition.  Bound: compulsory bytes over 3.35 TB/s vs the adds
          and GEMM operations over 67 TFLOP/s fp32, the larger.  A kernel
          under 0.2 ms (the stagings, the GAT score) is timed per launch
          over 100 launches between one event pair (kernel_ms; the lone
          launch is kept as kernel_one_launch_ms), its library call too
  kernel  (dropout) the dropout kernel (jax.random's threefry masks,
          csrc/dropout.cu) against its plain version (ops/prng.py) on the
          Reddit graph: fp32 at H = 602 and 256, rate 0.5, and bf16 (the
          -bf16 variant: bf16(f32(x) / f32(bf16(1 - rate))) where kept) at
          H = 602 and 256, rates 0.5 and 0.1: forward and backward
          bitwise, the kept fraction within 0.01 of 1 - rate; times of the
          kernel, the plain version and torch's own dropout (other masks:
          a yardstick, not the library call, which is null); bound: the
          bytes (8 an element in fp32, 4 in bf16) against the function's
          41 INT32-pipe instructions an element (threefry2x32-20's
          rotates and xors) over the INT32 rate, 64 lanes an SM (a
          quarter of the fp32 rate), or its 78 instructions at the least
          over the issue rate (half the fp32 rate), the larger
  small   the port's GCN forward on the audit graph, card vs CPU (exact)
  train_small  the port's Trainer on mega-shard (GCN 64-16-8, exact,
          dropout 0, 3 epochs), card vs CPU, unfused and megafuse: final
          loss and logits within 1e-5 of the row max-abs
  serve   ServeEngine with GCN 602-256-41 on the Reddit graph (precision
          fast, seeded random weights): warmup and 120 open-loop requests
          of sizes (1, 2, 3, 5, 8, 13), with every kernel launch count set
          to 0 just before and read just after; the sum kernel and the
          staging must each have run twice per forward.  Then served rows
          vs predict_logits (<= 32
          ULPs) and vs a forward through the plain aggregation in fp32
          (<= 5e-3 of each row's max-abs: one designed bf16 rounding).
  train   the Trainer with GCN 602-256-41 on the Reddit graph, fast,
          -lr 0.01 -decay 0.0001 -dropout 0.5 (test.sh), 10 epochs,
          eval every 5, without and with -megafuse: synced epoch times
          (median of epochs 3-10), peak memory, the first and the last
          train_loss (finite and falling), and each kernel's launches in
          the run (counts set to 0 just before, read just after) and in
          one more step: 4 aggregate_sum and 4 stage_plane unfused; 2
          aggregate_linear, 2 stage_plane, 2 aggregate_linear_bwd, 2
          stage_cotangent and no aggregate_sum with -megafuse; 3 dropout
          in both (2 forward, 1 backward: the first dropout's input, x,
          takes no gradient)
  train_bf16  the same under -bf16 (x placed in bf16), unfused and
          -megafuse: the bf16 dropout kernel at 602 columns, the bf16
          first GEMM, then the fp32 sums, stagings and megakernel rows
          (GCN's norm promotes); the launches per step are train's, the
          last train_loss within 5e-2 relative of train's (fp32 features
          and GEMM), epoch ms and peak memory beside fp32's
  profile_split  the unfused GCN step as train, fp32 and -bf16, under
          -profile (epochs 3-4 of 5): the trace's device kernel time per
          step, by kernel and by group (sums, staging, dropout, GEMMs,
          elementwise, reductions)
  serve_bf16  ServeEngine with GCN 602-256-41 under -bf16, 40 requests:
          x in bf16, launches as serve's, served rows vs predict_logits <=
          32 ULPs and vs the plain fp32 aggregation at -bf16 <= 5e-3
  ab      the same model in exact, dropout 0, 3 epochs from the same
          params, -megafuse vs unfused: final loss within 1e-3 relative
  tune    the autotuner (roc_tpu_torch/tune): (a) every candidate of the
          sum's launch lattice (lanes a row x edges in flight), over the
          Reddit CSR and its transpose at H = 256 fast and exact and H = 41
          fast, and every GAT forward lane group at (K, F) = (4, 64) and
          (1, 41), fast: bitwise the default launch on Gaussian data and
          the plain version on integer data, timed beside the default
          (CUDA events); (b) autotune_graph on the card over both
          directions into a temporary store: each winner with its
          confirmed and the default's seconds; (c) GCN 602-256-41, fast,
          dropout 0.5, 3 epochs with -autotune and without: losses bitwise
          equal, epoch times, and aggregate_sum's launches by launch pair
          (the tuned pairs only, against (0, 0) untuned); (d) the refit
          rates with the card's name and power limit; (e) one step on
          reddit-small under each kill switch (ROC_NO_MEGAFUSE=1,
          ROC_MEGA_BWD=0, ROC_XLAYER=0, ROC_NO_GATFUSE=1, ROC_GAT_BWD=0):
          none of the kernels it turns off launches, the loss is finite
  kernel  (gat) the GAT entry points (gat_score, gat_forward, gat_bwd_dst,
          gat_bwd_src, and gat_stage, the fp32 plane the forward first
          stages a single head of 41 columns into, aggregate_sum.cu's
          staging kernel in fp32) against their plain versions on the
          card: first on a small graph with a hub row and an isolated node
          at ragged head shapes (K, F) = (3, 5), (8, 8), (40, 2), (2, 200),
          (4, 6), (2, 2), (1, 41), (4, 64), (16, 4), (12, 5), and
          gat_forward also on a graph with a hub row of 20,000 in-edges, on
          x and on a column slice of a wider tensor (rows not 16-byte
          aligned), against the plain version on the CPU; then on the
          Reddit graph at the published GAT's layer 1 (K=8, F=8), the
          full-width model's layer 1 (K=4, F=64) and both models' layer 2
          (K=1, F=41), both precisions.  The
          backward is two kernels: gat_bwd_src gives dtable, dast and the
          per-edge score gradient dq (held against gat_dq_plain), and
          gat_bwd_dst sums dq; the composed backward is held against the
          function's plain versions (gat_bwd_dst_plain's dadl,
          gat_bwd_src_plain's dtable and dast), and run twice for equal
          bits.  The score bitwise equal to the serial-order reference
          (products rounded, added in f order from 0) everywhere, also on
          an x that starts 4 bytes into its buffer.  Every output bitwise
          on the integer fixture (a_src = 0 and a_dst, x >= 0, so every e
          and lrelu' is 1; integer du and dz); Gaussian data: out, m, z
          and dtable within 1e-5 of each row's max-abs; the scores and
          score gradients (as, dadl, dast, dq: signed sums that may cancel
          to ~0) each element within 1e-5 of the sum of the absolute
          values of its terms (the plain version run on |x|, |a_src|,
          |du|, |dz| with every e unchanged).  Times: kernel (the dst row:
          the dst kernel alone on the src kernel's dq), plain, and the
          library: for the score torch.einsum, for the forward
          torch.sparse.softmax over a sparse [N, N] score matrix per head,
          then torch.sparse.mm, for the dst kernel index_add_ of dq over
          the transposed edges' destinations, none for the src kernel;
          bound = compulsory bytes / 3.35 TB/s vs operations / 67 TFLOP/s
          fp32, the larger, of each kernel's own work.  The forward row
          carries its geometry (forward_geometry: floats a pack, lanes a
          row, packs a lane, staged or not), its instantiation's ptxas and,
          where it stages, the staging's time alone (stage_ms) and its
          ptxas; the gat_stage row has its own, with
          torch.nn.functional.pad as the library call;
          both backward rows
          carry the build's ptxas and the pair: pair_ms (src + dst), the
          whole backward's bound (pair_bound_ms, each edge's dot counted
          once) and its one library composition (pair_library_ms:
          sampled_addmm, segment_reduce, index_add_, sparse.mm)
  train_small_gat  the Trainer with GAT 64-8-8 (2 heads) on mega-shard,
          exact, dropout 0, 3 epochs, card vs CPU: within 1e-5
  serve_gat  ServeEngine with GAT 602-64-41 (4 heads) on the Reddit graph,
          fast, seeded weights: 40 requests; the score and forward kernels
          each ran twice per forward and the staging once; served rows vs
          predict_logits <= 32 ULPs
  train_gat  the Trainer with GAT 602-64-41 (4 heads) on the Reddit graph,
          fast, -lr 0.01 -decay 0.0001 -dropout 0.5, 10 epochs: as train,
          with 2 launches per step of each GAT kernel, 1 of gat_stage, 3
          of dropout and no aggregate_sum

  kernel_xlayer_shapes  the region kernels (xlayer_fwd, xlayer_bwd) against
          their plain versions on a small graph with a hub row of 700
          in-edges and an isolated row: depth 2 (37-64-130) and depth 3
          (602-300-42-256, an interior layer without relu), with and without
          the norm pair, both precisions; integer fixture bitwise (and the
          plain version equal to a float64 reference: the fixture is exact),
          two backward calls bitwise equal, Gaussian data within 1e-5 of the
          sum of the absolute values of each element's terms
  kernel  (xlayer) the same at the full-width path's region on the Reddit
          graph (depth 3, 602-256-256-256, relu, fold), both precisions,
          plus: the region equals the chain of per-layer megakernels
          bitwise (forward, and dx; part of the row's ok); times of the
          kernel (the backward as the path calls it, without dx, and with
          dx), the plain version and the library composition (per layer
          torch.sparse.mm, torch.matmul and the epilogue, forward and
          backward); the bound; the phase split (phase_ms: per phase of the
          launch, the median over 5 launches of the time between the
          kernel's %globaltimer stamps); each region kernel's registers
          and spill bytes from the build's ptxas report (ptxas)
  train_small_chain  the Trainer with gcn-chain 64-16-16-16-8 on mega-shard,
          exact, dropout 0, -megafuse -fusion-depth 0, card vs CPU: within
          1e-5; the card's run launched the region kernels
  train_chain  gcn-chain 602-256-256-256-41 on the Reddit graph, fast,
          -lr 0.01 -decay 0.0001 -dropout 0, 10 epochs, -megafuse with
          -fusion-depth 1, 2 and 0: median epoch (3-10), peak memory, the
          loss curve, launches per step (1: 4 + 4 megakernel; 2: 1 + 1
          region, 2 + 2 megakernel; 0: 1 + 1 region, 1 + 1 megakernel;
          one stage_plane per megakernel forward, one stage_cotangent per
          megakernel backward)
  ab_chain  the same in exact, 3 epochs, -fusion-depth 0 vs 1 from the same
          params: final loss within 1e-3 relative
  serve_mega  ServeEngine with GCN 602-256-41 and -megafuse, 40 requests:
          2 aggregate_linear, 2 stage_plane and no aggregate_sum launches
          per forward,
          served rows vs predict_logits <= 32 ULPs
  graph_file  the graph input layer, in a temporary directory the phase
          removes: the Reddit graph written with the port's lux writers
          (.add_self_edge.lux, a binary-only .feats.bin, .label, .mask)
          and read back through load_roc_dataset (what -file calls),
          eager and -lazy, every array bitwise equal to the in-memory one
          (graph_file_io: bytes, write and read seconds); GCN 602-256-41
          trained from the files as in train (unfused, fast, 10 epochs,
          launches per step 4 + 4) on Reddit in id order and in RCM order
          (-reorder on; -reorder auto's note beside it), and on the same
          shape with ring inter-community edges (seed 1, read -lazy) in id
          order and under -reorder auto, which must keep the order: per
          graph the RCM and reorder seconds, the occupancy statistic of
          auto (padded_rows) and its seconds, epoch ms, peak memory, the
          loss (finite and falling) and the sum kernel's ms over the CSR
          and its transpose at H = 256 and 41; Reddit in id and RCM order
          in exact, dropout 0, 3 epochs: final losses within 2e-4
          relative (graph_file_isomorphic); then karate, davis and lesmis
          written by the converter CLI and trained through python -m
          roc_tpu_torch -file with the docs/GOLDEN.md recipe on the card,
          the pins read from the final checkpoint's forward (golden):
          karate test 31/32 with node 8 the sole miss, davis 15/16 with
          node 15, lesmis val >= 13/19, test >= 43/48, loss <= 1.0; the
          same run on the CPU (plain versions, fast, the same parameters
          and masks: roc_tpu's random streams) within 1e-3 of the card's
          train loss

  run_controls  on small graphs on the card (GCN 8-4-3 on an 80-node
          synthetic graph, tests/test_fault.py's fixture): -fault
          seed=3,step.nan=1 a bitwise no-op against the clean shorter
          run (params, Adam m and v); the non-finite ladder (rung 1 turns
          -megafuse off with the params kept, rung 2 restores the
          checkpoint, or without one carries on); SIGTERM sent to
          python -m roc_tpu_torch after its first metric line: exit 0 and
          a checkpoint holding rng_key; -obs: trace.json passes
          validate_chrome_trace, one metrics record an epoch with
          roc_tpu's keys; -profile: a Chrome trace holding device kernel
          events; the resume under -seed 2 from a -seed 1 checkpoint
          equal to the unbroken run (1e-6 relative), the seed's own masks
          far off

  mem_plan  the memory planner: -mem-plan keep, remat and auto (its
          -mem-budget halfway between the plan's predicted keep and remat
          peaks) for gcn-chain 602-256-256-256-41 unfused and GCN
          602-256-41 on Reddit, fast, dropout 0.5, 5 epochs each: per plan
          the decisions, the predicted peak (and with the tensors the
          port's checkpoints keep beyond the plan), the measured peak
          (max_memory_allocated), ms a step, launches a step (keep's
          exact; a plan's between keep's and keep's plus one forward);
          the final loss and every parameter bitwise equal to keep's, the
          measured peaks under remat and auto below keep's
  stream  the streaming executor: GCN 602-256-41 on Reddit, -stream
          -parts 4 -stream-slots 2, fast, dropout 0, 3 epochs, against the
          in-core trainer from the same seed: each epoch's loss within
          1e-3 relative, the streamed peak below in-core's, pinned host
          stores with no fallback, the sum kernel launched by the streamed
          run; seconds an epoch, bytes moved beside predicted_epoch_bytes
          (roc_tpu's and the port's CSR wire), the ring's overlap and the
          scatter's hidden share.  Then on reddit-small (602-64-41):
          -bf16-storage within 1e-3 relative of the fp32 streamed losses,
          -stream-spill (a temporary directory the phase removes) bitwise
          equal to them, a streamed GAT (4 heads) within 1e-3 of the
          in-core GAT with the GAT kernels launched, and 64 rows served by
          a ServeEngine under -stream within 1e-5 of each row's max-abs of
          the in-core eval's, both in exact (the GEMM's order differs)
  delta   serving deltas: ServeEngine(delta_journal=...) for GCN
          602-256-41 on Reddit, fast: 100 batches of 32 adds and 32
          retires (the retires take earlier adds and base edges) under 200
          QPS of open-loop queries; the device CSR bitwise from_edges of
          the live edges, every row bitwise a fresh engine's on the
          mutated graph (4,096 through the queue), no CSR rebuild, no
          kernel build and two alternating col_idx buffers on the patch
          path, the sum and staging kernels launched, their plain versions
          never; apply ms (classify, journal, rewrite, install), bytes to the
          device a batch, served p50/p99 under churn beside the serve
          phase's, the delta-apply ledger ratio, and a full host rebuild
          and copy of col_idx timed once.  Then a batch past the headroom
          (mode "replanning", queries answered while delta.replan.slow
          stalls the rebuild, parity after the swap), five batches more, a
          restart from the snapshot and journal to the same rows, and 20
          batches under -megafuse against a fresh -megafuse engine
  fleet   a primary and two followers on the card over InProcTransport:
          50 batches through FleetRouter.apply_delta and pump under 200
          QPS of routed queries; every applied_seq the primary's, the
          three forwards bitwise equal, a late follower brought up by
          snapshot_blob / install_snapshot the same bits, no shed;
          replication lag, segments and records shipped, dispatches per
          replica

  spmd    the vertex-sharded SPMD trainer, -parts 4 on the card: (a) the
          CLI path, GCN 602-256-41 through make_trainer (k = 4 parts on
          the one device, the halo exchange), fast, dropout 0.5, 5 epochs:
          epoch ms, peak, halo K, table rows, host build seconds
          (partition, halo maps, CSRs, placement), wire bytes, launches
          (per step 16 aggregate_sum, 16 stage_plane, 3 dropout), beside
          train's single-device run; (b) -check-sharding (rtol 1e-3,
          count_tol 1) and 3 epochs at dropout 0 within 1e-3 of stream's
          in-core losses; (c) -no-halo and the bf16 wire (plain,
          compensated, stochastic), 3 epochs each, within 1e-3 (no-halo,
          compensated) or 5e-2 (bf16) of (b); (d) the k = 1 layout (mesh
          [cuda:0] * 4): halo overlap on and off within 1e-5;
          -balance-every 1 -e 6 from a 55/15/15/15 % cut: at least one
          reshard, the loss within 1e-3 of the unbalanced run's, the
          proposals, reshard seconds and epoch ms; -perhost from
          reddit-small's .lux (a temporary directory the phase removes):
          CSRs, halo maps and node tensors bitwise the full build's, the
          first loss equal; (e) GAT 602-64-41 (4 heads), -parts 4 on
          reddit-small, within 1e-3 of stream's in-core GAT.  No plain
          version (sums, stagings, dropout, GAT) runs on the card.

  spmd_modes  the rest of the SPMD trainer on the k = 1 layout (mesh
          [cuda:0] * 4), fast: (a) -exchange ring, GCN 602-256-41 on
          Reddit, dropout 0.5 for 5 epochs (epoch ms, peak, host build
          seconds of the groups and their CSRs, wire bytes, launches; per
          step 4 aggregate_sum and 4 stage_plane a non-empty owner group,
          12 dropout: one a mesh position), then the same trainer from its init at dropout 0 for
          3 epochs within 1e-3 of stream's in-core losses, and SAGE -aggr
          max on reddit-small against one device (1e-3); (b) -edge-shard
          on, the same prints and checks (span_fwd, span_bwd, the edge
          tax; per step 4 sums and stagings a block), and a hub graph at
          Reddit's node count (one hub of 12 in-edges a vertex, 3x E/P),
          2 epochs a mode: -edge-shard auto picks edge mode, its loss
          within 1e-3 of -edge-shard off's, both modes' epoch ms and
          taxes; (c) GAT 602-64-41, 4 heads, reddit-small, ring then edge
          (their attention plain fp32, as roc_tpu's is XLA), within 1e-3
          of the single-device GAT in exact; (d) -bf16-storage ring
          within 5e-2 of (a); (e) reddit-small's .lux and .t.lux in a
          temporary directory the phase removes: -perhost -edge-shard on
          and -perhost -exchange ring bitwise the full builds (blocks,
          windows, groups, CSRs, node tensors, first loss), -stream on the
          graph stub bitwise the full graph's streamed losses, -stream
          -balance-every 1 -e 3 from a 55/15/15/15 % cut with at least
          one reshard (its seconds) within 1e-3 of the unbalanced run; (f)
          -multihost as a world of one over NCCL: the CLI in a subprocess
          with RANK=0 WORLD_SIZE=1 LOCAL_RANK=0 on a free port, -parts 4,
          halo then ring on reddit-small, 3 epochs: NCCL collectives
          counted, losses within 1e-5 of the single-process trainer's
          (each run's epoch ms beside the other's), the checkpoint
          restored within 1e-5 of its params.  No plain
          version runs on the card; the phase prints its seconds.

Then the ``kernels`` line, the card's name and power limit as nvidia-smi
gives them, and last ``{"ok": true, "device": {...}}``.  Any failure
raises and the exit code is non-zero; without CUDA the script exits 2
before printing any result.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import re
import select
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
FP32_FLOPS = 67e12             # H100 SXM, fp32 outside the tensor cores
SEED = 0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median over ``reps`` launches of one call's CUDA-event time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def per_launch_ms(fn, launches: int = 100, runs: int = 5) -> float:
    """Median over ``runs`` of the CUDA-event time of ``launches`` calls
    between one event pair, per call: a lone launch of a kernel under ~0.1
    ms also holds the host's work of launching it (chip_ab.py's score
    measurement)."""
    out = []
    for _ in range(runs):
        fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(launches):
            fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / launches)
    return statistics.median(out)


SMALL_KERNEL_MS = 0.2


def retime_small(rec: dict, kern, library=None) -> None:
    """Where the kernel's one-launch time is under SMALL_KERNEL_MS, its
    ``kernel_ms`` (and the library call's, where there is one) becomes the
    per-launch time over 100 launches; the one-launch times are kept."""
    if rec["kernel_ms"] >= SMALL_KERNEL_MS:
        return
    rec["kernel_one_launch_ms"] = rec["kernel_ms"]
    rec["kernel_ms"] = per_launch_ms(kern)
    if library is not None and rec.get("library_ms") is not None:
        rec["library_one_launch_ms"] = rec["library_ms"]
        rec["library_ms"] = per_launch_ms(library)


def row_rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max over rows of max|got - want| / max|want| (0/0 counts as 0)."""
    d = (got.float() - want.float()).abs().amax(dim=1)
    s = want.float().abs().amax(dim=1)
    r = torch.where(d == 0, torch.zeros_like(d), d / s)
    return float(r.max())


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def launch_dict(**nonzero) -> dict:
    """Every kernel's launch count: ``nonzero``'s, 0 for the rest."""
    from roc_tpu_torch.ops.kernels import KERNELS
    return {k: nonzero.get(k, 0) for k in KERNELS}


def reset_launches() -> None:
    from roc_tpu_torch.ops.kernels import KERNELS
    for fn in KERNELS.values():
        fn.launches = 0


def read_launches() -> dict:
    from roc_tpu_torch.ops.kernels import KERNELS
    return {name: fn.launches for name, fn in KERNELS.items()}


def phase_env() -> dict:
    from roc_tpu_torch.ops.kernels import LIBRARIES, build_all
    t0 = time.perf_counter()
    build_all()
    build_s = time.perf_counter() - t0
    for lib in LIBRARIES:
        print(lib.info.get("log", ""), file=sys.stderr, flush=True)
    rec = {"phase": "env", "torch": torch.__version__,
           "cuda": torch.version.cuda,
           "device": torch.cuda.get_device_name(0),
           "capability": list(torch.cuda.get_device_capability(0)),
           "nvidia_smi": nvidia_smi(),
           "kernel_build_s": round(build_s, 3),
           "nvcc_s": {lib.source.name: round(lib.info["seconds"], 3)
                      for lib in LIBRARIES},
           "libraries": [lib.info["path"].rsplit("/", 1)[-1]
                         for lib in LIBRARIES]}
    emit(rec)
    return rec


def ring_fixture(n: int):
    """Every in-degree exactly 4: three ring neighbours and the self edge
    (the fixture of tests/test_stream_tiers.py, at n nodes)."""
    from roc_tpu_torch.graph.csr import add_self_edges, from_edges
    src = np.concatenate([(np.arange(n) + k) % n for k in (1, 17, 33)])
    dst = np.tile(np.arange(n), 3)
    g = add_self_edges(from_edges(n, src, dst))
    if np.unique(np.diff(g.row_ptr)).tolist() != [4]:
        raise AssertionError("ring fixture in-degrees are not all 4")
    return g


def phase_kernel(ds, dev) -> list:
    from roc_tpu_torch.ops import DeviceCsr
    from roc_tpu_torch.ops.kernels.aggregate_sum import (aggregate_sum,
                                                         aggregate_sum_plain,
                                                         stage_plane)
    from roc_tpu_torch.ops.kernels import aggregate_sum as KS
    g = ds.graph
    csr = DeviceCsr.from_csr(g, dev, transpose=False)
    ptxas = ptxas_report(KS.LIBRARY.info.get("log", ""))
    ring = DeviceCsr.from_csr(ring_fixture(g.num_nodes), dev,
                              transpose=False)
    lib_mat = torch.sparse_csr_tensor(
        csr.row_ptr, csr.col_idx.to(torch.int64),
        torch.ones(g.num_edges, dtype=torch.float32, device=dev),
        size=(g.num_nodes, g.num_nodes), check_invariants=False)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = []
    for h in (41, 256, 602):
        x = torch.randn((g.num_nodes, h), generator=gen, device=dev)
        xi = torch.randint(0, 2, (g.num_nodes, h), generator=gen,
                           device=dev).to(torch.float32)
        for prec in ("fast", "exact"):
            def kern(t=x, c=csr):
                return aggregate_sum(t, c.row_ptr, c.col_idx, prec)

            def plain(t=x, c=csr):
                return aggregate_sum_plain(t, c.row_ptr, c.col_idx, prec)

            k, p = kern(), plain()
            torch.cuda.synchronize()
            err = row_rel_err(k, p)
            int_ok = bool(torch.equal(kern(xi), plain(xi)))
            ring_ok = bool(torch.equal(kern(xi, ring), plain(xi, ring)))
            rec = {"phase": "kernel", "name": "aggregate_sum", "H": h,
                   "precision": prec, "nodes": g.num_nodes,
                   "edges": g.num_edges,
                   "max_abs_err": float((k - p).abs().max()),
                   "row_rel_err": err, "tolerance": 1e-5,
                   "int_bitwise": int_ok, "ring_bitwise": ring_ok,
                   "finite": bool(torch.isfinite(k).all())}
            rec["kernel_ms"] = time_ms(kern, reps=20, warmup=3)
            if prec == "fast":      # the staging launch the total includes
                rec["stage_ms"] = per_launch_ms(lambda t=x: stage_plane(t),
                                                20, 3)
            rec["plain_ms"] = time_ms(plain)
            rec["library_ms"] = time_ms(lambda t=x: lib_mat @ t)
            rec["ptxas"] = {k: v for k, v in ptxas.items()
                            if "sum_rows" in k or "stage_kernel" in k}
            nbytes = (x.numel() * 4 + k.numel() * 4
                      + csr.row_ptr.numel() * 8 + csr.col_idx.numel() * 4)
            flops = g.num_edges * h
            rec["bound_bytes"] = nbytes
            rec["bound_ms"] = max(nbytes / HBM_BYTES_PER_S,
                                  flops / FP32_FLOPS) * 1e3
            rec["bound_by"] = ("bytes" if nbytes / HBM_BYTES_PER_S
                               >= flops / FP32_FLOPS else "operations")
            emit(rec)
            rows.append(rec)
            if not (rec["finite"] and int_ok and ring_ok and err <= 1e-5):
                raise AssertionError(f"aggregate_sum disagrees with its "
                                     f"plain version: {rec}")
            del k, p
    return rows


SUM_SHAPES = (1, 7, 41, 255, 602, 608, 1000)
# H_out of the megakernel at each H_in above: narrow (<= 64, 64-column GEMM
# passes) and wide, ragged and aligned
SUM_SHAPES_OUT = (41, 256, 7, 65, 300, 1, 64)


def phase_kernel_sum_shapes(dev) -> dict:
    """aggregate_sum (over the CSR and its transpose) and aggregate_linear
    (relu) against their plain versions on a small graph with a hub row of
    20,000 in-edges and two rows with no in-edges, at the widths of
    SUM_SHAPES (every pack count and vector width: 1, 2 and 4 floats, 1 to
    125 bf16 packs), both precisions, x contiguous and x a column slice of
    a wider tensor (rows 4 bytes off 16-byte alignment, x.stride(0) > H):
    bitwise on integer data (aggregate_linear's sums all stay below 2^24,
    checked), rows with no in-edges exactly 0, and on Gaussian data each
    element within 1e-5 of the sum of the absolute values of its terms
    (the plain version on |x| and |W|: a signed sum over few columns may
    cancel to near 0, where a row's max-abs is no yardstick; the row
    error is reported beside it)."""
    from roc_tpu_torch.graph.csr import from_edges
    from roc_tpu_torch.ops import DeviceCsr
    from roc_tpu_torch.ops.kernels import aggregate_linear as KL
    from roc_tpu_torch.ops.kernels import aggregate_sum as KS
    rng = np.random.default_rng(SEED + 12)
    n, hub, empty = 3000, 17, (29, 2999)
    src = rng.integers(0, n, 50000)
    dst = rng.integers(0, n, 50000)
    dst[:20000] = hub
    keep = ~np.isin(dst, empty)
    csr = DeviceCsr.from_csr(from_edges(n, src[keep], dst[keep]), dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    cases, worst = [], 0.0

    def columns(h, ints):
        """x [n, h]: contiguous, and a column slice at offset 1."""
        def make(shape):
            if ints:
                return torch.randint(-3, 4, shape, generator=gen,
                                     device=dev).float()
            return torch.randn(shape, generator=gen, device=dev)
        return {"contiguous": make((n, h)),
                "slice": make((n, h + 3))[:, 1:1 + h]}

    for h, ho in zip(SUM_SHAPES, SUM_SHAPES_OUT):
        xs_i, xs_g = columns(h, True), columns(h, False)
        w_i = torch.randint(-1, 2, (h, ho), generator=gen,
                            device=dev).float()
        w_g = torch.randn((h, ho), generator=gen, device=dev)
        for layout in ("contiguous", "slice"):
            x01 = (xs_i[layout] > 0).float()          # {0, 1}, same layout
            if layout == "slice":
                x01 = torch.cat([x01[:, :1], x01, x01[:, :2]], 1)[:, 1:1 + h]
            agg = KS.aggregate_sum_plain(x01, csr.row_ptr, csr.col_idx,
                                         "exact")
            most = float((agg @ w_i.abs()).max())
            for prec in ("fast", "exact"):
                case = {"H": h, "H_out": ho, "layout": layout,
                        "precision": prec}
                for name, rp, ci in (("sum", csr.row_ptr, csr.col_idx),
                                     ("sum_t", csr.t_row_ptr, csr.t_col_idx)):
                    k = KS.aggregate_sum(xs_i[layout], rp, ci, prec)
                    case[f"{name}_int_bitwise"] = bool(torch.equal(
                        k, KS.aggregate_sum_plain(xs_i[layout], rp, ci, prec)))
                    k = KS.aggregate_sum(xs_g[layout], rp, ci, prec)
                    want = KS.aggregate_sum_plain(xs_g[layout], rp, ci, prec)
                    case[f"{name}_row_rel_err"] = row_rel_err(k, want)
                    err = term_rel_err(k, want, KS.aggregate_sum_plain(
                        xs_g[layout].abs(), rp, ci, prec))
                    case[f"{name}_term_rel_err"] = err
                    worst = max(worst, err)
                    if name == "sum":
                        case["sum_empty_rows_zero"] = bool(
                            (k[list(empty)] == 0).all())
                k = KL.aggregate_linear(x01, w_i, csr.row_ptr, csr.col_idx,
                                        prec, "relu")
                case["linear_int_bitwise"] = most < 2 ** 24 and bool(
                    torch.equal(k, KL.aggregate_linear_plain(
                        x01, w_i, csr.row_ptr, csr.col_idx, prec, "relu")))
                case["linear_int_most"] = most
                k = KL.aggregate_linear(xs_g[layout], w_g, csr.row_ptr,
                                        csr.col_idx, prec, "relu")
                want = KL.aggregate_linear_plain(
                    xs_g[layout], w_g, csr.row_ptr, csr.col_idx, prec, "relu")
                case["linear_row_rel_err"] = row_rel_err(k, want)
                err = term_rel_err(k, want, KL.aggregate_linear_plain(
                    xs_g[layout].abs(), w_g.abs(), csr.row_ptr, csr.col_idx,
                    prec, "none"))
                case["linear_term_rel_err"] = err
                case["linear_empty_rows_zero"] = bool(
                    (k[list(empty)] == 0).all())
                worst = max(worst, err)
                torch.cuda.synchronize()
                case["ok"] = all(v for key, v in case.items()
                                 if key.endswith(("bitwise", "zero"))) and \
                    all(v <= 1e-5 for key, v in case.items()
                        if key.endswith("term_rel_err"))
                cases.append(case)
                if not case["ok"]:
                    emit({"phase": "kernel_sum_shapes", "failed": case})
                    raise AssertionError(f"aggregate_sum/aggregate_linear "
                                         f"disagree with their plain "
                                         f"versions: {case}")
    rec = {"phase": "kernel_sum_shapes", "nodes": n,
           "hub_in_degree": int(torch.diff(csr.row_ptr)[hub]),
           "empty_rows": list(empty), "cases": cases, "worst_term_rel_err":
           worst, "tolerance": 1e-5, "int_bitwise": True}
    emit(rec)
    return rec


def phase_small(dev) -> dict:
    """The port's forward on a small input: card vs CPU, exact precision."""
    from roc_tpu_torch.graph import datasets
    from roc_tpu_torch.models import build_model
    from roc_tpu_torch.train.config import Config
    from roc_tpu_torch.train.frozen import load_frozen
    cfg = Config(dataset="roc-audit", layers=[8, 16, 4], dropout_rate=0.0,
                 aggregate_backend="binned", aggregate_precision="exact")
    ds = datasets.get(cfg.dataset)
    model = build_model(cfg.model, cfg.layers, cfg.dropout_rate)
    on_card = load_frozen(cfg, ds, model, device=dev)
    on_cpu = load_frozen(cfg, ds, model, device="cpu")
    err = row_rel_err(on_card.predict_logits().cpu(),
                      on_cpu.predict_logits())
    rec = {"phase": "small", "dataset": cfg.dataset, "layers": cfg.layers,
           "card_vs_cpu_row_rel_err": err, "tolerance": 1e-5}
    emit(rec)
    if err > 1e-5:
        raise AssertionError(f"card forward disagrees with CPU: {rec}")
    return rec


def _bound(nbytes: float, flops: float) -> dict:
    b, f = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return {"bound_bytes": nbytes, "bound_flops": flops,
            "bound_ms": max(b, f) * 1e3,
            "bound_by": "bytes" if b >= f else "operations"}


def _check_row(rec: dict, kern, plain, int_args, gauss_args, library,
               tol: float = 1e-5, timed=None, stage=None) -> dict:
    """Hold ``kern`` against ``plain`` (both return a tensor or a tuple of
    tensors): bitwise on ``int_args``, within ``tol`` of each row's
    max-abs on ``gauss_args``; then time the kernel (``timed`` when given:
    the launch alone, without what adapts its output for the check), the
    plain version and the library call (None where there is none) on the
    Gaussian inputs, a kernel under SMALL_KERNEL_MS over 100 launches
    (``retime_small``); ``stage``, when given, is the staging launch the
    kernel's time includes, timed alone as ``stage_ms``."""
    def parts(out):
        return out if isinstance(out, tuple) else (out,)

    k, p = parts(kern(*int_args)), parts(plain(*int_args))
    rec["int_bitwise"] = all(bool(torch.equal(a, b)) for a, b in zip(k, p))
    k, p = parts(kern(*gauss_args)), parts(plain(*gauss_args))
    torch.cuda.synchronize()
    rec["max_abs_err"] = max(float((a - b).abs().max()) for a, b in zip(k, p))
    rec["row_rel_err"] = max(row_rel_err(a, b) for a, b in zip(k, p))
    rec["tolerance"] = tol
    rec["finite"] = all(bool(torch.isfinite(a).all()) for a in k)
    del k, p
    rec["kernel_ms"] = time_ms(lambda: (timed or kern)(*gauss_args),
                               reps=20, warmup=3)
    rec["plain_ms"] = time_ms(lambda: plain(*gauss_args))
    rec["library_ms"] = None if library is None else time_ms(library)
    retime_small(rec, lambda: (timed or kern)(*gauss_args), library)
    if stage is not None:
        rec["stage_ms"] = per_launch_ms(lambda: stage(*gauss_args), 20, 3)
    emit(rec)
    if not (rec["finite"] and rec["int_bitwise"]
            and rec["row_rel_err"] <= tol and rec.get("checks_ok", True)):
        raise AssertionError(f"{rec['name']} disagrees with its plain "
                             f"version: {rec}")
    return rec


# The dropout function's instructions an element, whatever kernel computes
# it: threefry2x32-20's 20 funnel-shift rotates and 21 xors (20 rounds and
# the closing one) have no pipe but the INT32 one, 64 lanes an SM; its 32
# adds (20 rounds, 12 key injections) may go to the FMA pipe.  Issued, the
# element takes at least those 73 and 5 more: the uniform's shift, the
# compare, the scaling, the select and a share of the load and store.
DROPOUT_INT32_OPS = 41
DROPOUT_MIN_INSTRUCTIONS = 78
# 64 INT32 lanes an SM against the 128 fp32 ones whose rate counts an FMA as
# two operations; the issue rate is one warp instruction a clock in each of
# an SM's four partitions, 128 lanes
INT32_OPS_PER_S = FP32_FLOPS / 4
ISSUE_PER_S = FP32_FLOPS / 2


def dropout_bound(n: int, itemsize: int) -> dict:
    """The larger of the bytes bound (x read once, out written once) and
    the operations bound: the function's INT32-pipe instructions over the
    INT32 rate, or all its instructions over the issue rate, the larger."""
    b = n * 2 * itemsize / HBM_BYTES_PER_S
    f = n * max(DROPOUT_INT32_OPS / INT32_OPS_PER_S,
                DROPOUT_MIN_INSTRUCTIONS / ISSUE_PER_S)
    return {"bound_bytes": n * 2 * itemsize,
            "bound_int32_ops": n * DROPOUT_INT32_OPS,
            "bound_instructions": n * DROPOUT_MIN_INSTRUCTIONS,
            "bound_bytes_ms": b * 1e3, "bound_ops_ms": f * 1e3,
            "bound_ms": max(b, f) * 1e3,
            "bound_by": "bytes" if b >= f else "operations"}


# (dtype, H, rate) of the dropout rows: the GCN's two dropout widths, fp32
# as the unfused and -megafuse runs take them, bf16 as -bf16 takes the
# first, at the recipe's rate and at 0.1 (where a fp32 divisor would differ)
DROPOUT_ROWS = ((torch.float32, 602, 0.5), (torch.float32, 256, 0.5),
                (torch.bfloat16, 602, 0.5), (torch.bfloat16, 602, 0.1),
                (torch.bfloat16, 256, 0.5), (torch.bfloat16, 256, 0.1))


def phase_kernel_dropout(ds, dev) -> list:
    """The dropout kernel (jax.random's masks, csrc/dropout.cu) against its
    plain version on the Reddit graph, fp32 and bf16, forward and backward
    (the same launch on the cotangent), bitwise.  The operations bound
    is the function's INT32-pipe count over the INT32 rate."""
    from roc_tpu_torch.ops import prng
    from roc_tpu_torch.ops.kernels.dropout import (LIBRARY, dropout,
                                                   dropout_plain)
    n = ds.graph.num_nodes
    key = prng.fold_in(prng.fold_in(prng.prng_key(SEED), 3), 1)
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    rows = []
    for dtype, h, rate in DROPOUT_ROWS:
        x = torch.randn((n, h), generator=gen, device=dev).to(dtype)
        g = torch.randn((n, h), generator=gen, device=dev).to(dtype)
        ibits = torch.int16 if dtype == torch.bfloat16 else torch.int32

        def fwd_bwd(fn):
            xr = x.detach().requires_grad_(True)
            out = fn(xr, rate, key)
            out.backward(g)
            return out.detach().view(ibits), xr.grad.view(ibits)

        k, p = fwd_bwd(dropout), fwd_bwd(dropout_plain)
        torch.cuda.synchronize()
        rec = {"phase": "kernel", "name": "dropout", "H": h, "rate": rate,
               "dtype": str(dtype).split(".")[-1], "nodes": n,
               "forward_bitwise": bool(torch.equal(k[0], p[0])),
               "backward_bitwise": bool(torch.equal(k[1], p[1])),
               "kept_fraction": float((k[0] != 0).float().mean()),
               "max_abs_err": float((k[0].view(dtype).float()
                                     - p[0].view(dtype).float()).abs()
                                    .max()),
               **dropout_bound(n * h, x.element_size())}
        del k, p
        rec["kernel_ms"] = time_ms(lambda: dropout(x, rate, key), reps=20,
                                   warmup=3)
        rec["plain_ms"] = time_ms(lambda: dropout_plain(x, rate, key),
                                  reps=5, warmup=1)
        # no PyTorch call draws jax.random's masks; torch's own dropout
        # (other masks) is timed beside it as a yardstick
        rec["library_ms"] = None
        rec["torch_dropout_ms"] = time_ms(
            lambda: torch.nn.functional.dropout(x, rate, True))
        emit(rec)
        rows.append(rec)
        if not (rec["forward_bitwise"] and rec["backward_bitwise"]
                and abs(rec["kept_fraction"] - (1 - rate)) < 0.01):
            raise AssertionError(f"dropout disagrees with its plain "
                                 f"version: {rec}")
        del x, g
    return rows


def phase_kernel_train(ds, dev) -> list:
    """The training path's kernels on the Reddit graph, each against its
    plain version, with times, the library yardstick and the bound."""
    from roc_tpu_torch.ops import DeviceCsr
    from roc_tpu_torch.ops.kernels import aggregate_linear as KL
    from roc_tpu_torch.ops.kernels import aggregate_sum as KS
    from roc_tpu_torch.ops.kernels.aggregate_sum import (aggregate_sum,
                                                         aggregate_sum_plain,
                                                         stage_plain,
                                                         stage_plane)
    g = ds.graph
    n, e = g.num_nodes, g.num_edges
    csr = DeviceCsr.from_csr(g, dev)
    ptxas = ptxas_report(KL.LIBRARY.info.get("log", ""))
    csr_bytes = csr.row_ptr.numel() * 8 + csr.col_idx.numel() * 4

    def sparse(row_ptr, col_idx):
        return torch.sparse_csr_tensor(
            row_ptr, col_idx.to(torch.int64),
            torch.ones(e, dtype=torch.float32, device=dev), size=(n, n),
            check_invariants=False)

    fwd_mat, bwd_mat = sparse(csr.row_ptr, csr.col_idx), \
        sparse(csr.t_row_ptr, csr.t_col_idx)
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)

    def ints(shape, lo, hi):
        return torch.randint(lo, hi + 1, shape, generator=gen,
                             device=dev).to(torch.float32)

    def gauss(shape):
        return torch.randn(shape, generator=gen, device=dev)

    def mm(a, b):
        torch.backends.cuda.matmul.allow_tf32 = False
        return torch.matmul(a, b)

    rows = []
    # the staging of "fast": x (or the cotangent) once as a bf16 plane, at
    # the widths the sum and the megakernel forward stage on the main path
    for h in (602, 256, 41):
        ld = KS._ld(h, "fast")
        rec = {"phase": "kernel", "name": "stage_plane", "H": h, "ld": ld,
               "precision": "fast", "nodes": n,
               **_bound(n * h * 4 + n * ld * 2, n * h)}
        xg = gauss((n, h))
        # one call computes the plane where it needs no padding (a cast);
        # elsewhere the pad + cast composition is timed beside it
        lib = (lambda t=xg: t.to(torch.bfloat16)) if ld == h else None
        if lib is None:
            rec["composition_ms"] = time_ms(
                lambda t=xg, ld=ld, h=h: torch.nn.functional.pad(
                    t, (0, ld - h)).to(torch.bfloat16))
        rows.append(_check_row(
            rec, lambda x: stage_plane(x).float(),
            lambda x: stage_plain(x).float(), (ints((n, h), -300, 300),),
            (xg,), lib, timed=stage_plane))
        del xg
    for prec in ("fast", "exact"):
        stage = (lambda x, *_: stage_plane(x)) if prec == "fast" else None
        # the unfused backward: the sum over the transposed CSR
        for h in (256, 41):
            rec = {"phase": "kernel", "name": "aggregate_sum",
                   "csr": "transposed", "H": h, "precision": prec,
                   "nodes": n, "edges": e,
                   **_bound(2 * n * h * 4 + csr_bytes, e * h)}
            xg = gauss((n, h))
            rows.append(_check_row(
                rec,
                lambda x: aggregate_sum(x, csr.t_row_ptr, csr.t_col_idx,
                                        prec),
                lambda x: aggregate_sum_plain(x, csr.t_row_ptr,
                                              csr.t_col_idx, prec),
                (ints((n, h), 0, 1),), (xg,),
                lambda x=xg: bwd_mat @ x, stage=stage))
        for hi, ho, act in ((602, 256, "relu"), (256, 41, "none"),
                            (256, 256, "relu")):
            rec = {"phase": "kernel", "name": "aggregate_linear",
                   "H_in": hi, "H_out": ho, "activation": act,
                   "precision": prec, "nodes": n, "edges": e,
                   **_bound(n * hi * 4 + hi * ho * 4 + n * ho * 4
                            + csr_bytes, e * hi + 2 * n * hi * ho),
                   "ptxas": {k: v for k, v in ptxas.items()
                             if "mega_fwd" in k}}
            xg, wg = gauss((n, hi)), gauss((hi, ho))
            rows.append(_check_row(
                rec,
                lambda x, w: KL.aggregate_linear(x, w, csr.row_ptr,
                                                 csr.col_idx, prec, act),
                lambda x, w: KL.aggregate_linear_plain(
                    x, w, csr.row_ptr, csr.col_idx, prec, act),
                (ints((n, hi), 0, 1), ints((hi, ho), -2, 2)), (xg, wg),
                lambda x=xg, w=wg: torch.relu(mm(fwd_mat @ x, w))
                if act == "relu" else mm(fwd_mat @ x, w), stage=stage))
            del xg, wg
        # the backward's staging kernel alone: the masked, rounded
        # cotangent plane (bf16 in fast, fp32 in exact with relu)
        for ho, relu in ((256, True), (41, False)):
            if prec == "exact" and not relu:
                continue       # exact without relu gathers g itself
            plane = 2 if prec == "fast" else 4
            rec = {"phase": "kernel", "name": "stage_cotangent", "H": ho,
                   "relu": relu, "precision": prec, "nodes": n,
                   **_bound(n * ho * 4 * (2 if relu else 1)
                            + n * ho * plane, n * ho)}
            gg, yg = gauss((n, ho)), gauss((n, ho))

            def comp(g_=gg, y_=yg, relu=relu):
                gm = torch.where(y_ > 0, g_, torch.zeros_like(g_)) \
                    if relu else g_
                return gm.to(torch.bfloat16) if prec == "fast" else gm

            # no single library call computes it: the two-call
            # composition is timed beside it
            rec["composition_ms"] = time_ms(comp)
            rows.append(_check_row(
                rec,
                lambda g_, y_, relu=relu, ho=ho: KL.stage_cotangent(
                    g_, y_, prec, relu)[:, :ho].float(),
                lambda g_, y_, relu=relu: KL.stage_cotangent_plain(
                    g_, y_, prec, relu),
                (ints((n, ho), -3, 3), ints((n, ho), -1, 1)), (gg, yg),
                None, timed=lambda g_, y_, relu=relu: KL.stage_cotangent(
                    g_, y_, prec, relu)))
            del gg, yg
        # the backward as the megafuse path calls it: the first layer
        # (602 <- 256, relu) asks for u alone, its input taking no
        # gradient; its full function (with dx) is timed too, and so is
        # gcn-chain's interior layer (256 <- 256, relu, with dx)
        for hi, ho, relu, need_dx in ((602, 256, True, False),
                                      (602, 256, True, True),
                                      (256, 256, True, True),
                                      (256, 41, False, True)):
            nbytes = (n * ho * 4 * (2 if relu else 1) + hi * ho * 4
                      + n * ho * 4 + (n * hi * 4 if need_dx else 0)
                      + csr_bytes)
            rec = {"phase": "kernel", "name": "aggregate_linear_bwd",
                   "H_in": hi, "H_out": ho, "relu": relu, "dx": need_dx,
                   "precision": prec, "nodes": n, "edges": e,
                   **_bound(nbytes, e * ho
                            + (2 * n * hi * ho if need_dx else 0))}
            gg, yg, wg = gauss((n, ho)), gauss((n, ho)), gauss((hi, ho))
            # u is the sum over the transposed CSR of the staged plane:
            # aggregate_sum on that plane in fp32 gives it bit for bit (a
            # second bf16 rounding of a bf16 value is the identity, and
            # both sum in CSR order from 0)
            u = KL.aggregate_linear_bwd(gg, yg, wg, csr.t_row_ptr,
                                        csr.t_col_idx, prec, relu,
                                        need_dx)[0]
            staged = KL.stage_cotangent(gg, yg, prec, relu)[:, :ho] \
                .float().contiguous() if prec == "fast" or relu else gg
            rec["u_equals_sum_on_staged"] = bool(torch.equal(
                u, aggregate_sum(staged, csr.t_row_ptr, csr.t_col_idx,
                                 prec)))
            rec["checks_ok"] = rec["u_equals_sum_on_staged"]
            del u, staged

            def lib(g_=gg, y_=yg, w_=wg, relu=relu, need_dx=need_dx):
                gm = torch.where(y_ > 0, g_, torch.zeros_like(g_)) \
                    if relu else g_
                u = bwd_mat @ gm
                return u, (mm(u, w_.t()) if need_dx else None)

            rows.append(_check_row(
                rec,
                lambda g_, y_, w_, relu=relu, need_dx=need_dx: tuple(
                    t for t in KL.aggregate_linear_bwd(
                        g_, y_, w_, csr.t_row_ptr, csr.t_col_idx, prec,
                        relu, need_dx) if t is not None),
                lambda g_, y_, w_, relu=relu, need_dx=need_dx: tuple(
                    t for t in KL.aggregate_linear_bwd_plain(
                        g_, y_, w_, csr.t_row_ptr, csr.t_col_idx, prec,
                        relu, need_dx) if t is not None),
                (ints((n, ho), -3, 3), ints((n, ho), -1, 1),
                 ints((hi, ho), -2, 2)), (gg, yg, wg), lib))
            del gg, yg, wg
    return rows


def _gat_parts(out):
    return out if isinstance(out, tuple) else (out,)


def term_rel_err(got: torch.Tensor, want: torch.Tensor,
                 terms: torch.Tensor) -> float:
    """max over elements of |got - want| / (the sum of the absolute values
    of the element's terms); 0/0 counts as 0."""
    d = (got - want).abs()
    r = torch.where(d == 0, torch.zeros_like(d), d / terms)
    return float(r.max())


def _gat_errors(k, p, terms) -> dict:
    """The max abs error; the largest error of each row's max-abs over the
    outputs whose ``terms`` entry is None; the largest error of the terms'
    absolute sum over the others."""
    out = {"max_abs_err": 0.0, "row_rel_err": 0.0, "term_rel_err": 0.0}
    for a, b, t in zip(k, p, terms):
        out["max_abs_err"] = max(out["max_abs_err"],
                                 float((a - b).abs().max()))
        if t is None:
            out["row_rel_err"] = max(out["row_rel_err"], row_rel_err(a, b))
        else:
            out["term_rel_err"] = max(out["term_rel_err"],
                                      term_rel_err(a, b, t))
    return out


def _gat_inputs(n, k, f, gen, dev, integer=False) -> dict:
    """Seeded inputs of the four entry points at K heads of F on an
    n-row graph (table = destination rows, as on one device).  The integer
    fixture has a_src = 0 and a_dst, x >= 0, so every edge's e is exactly 1
    and lrelu' is 1, and integer du and dz: every output is exact."""
    from roc_tpu_torch.ops.kernels import gat as G
    h = k * f
    if integer:
        x = torch.randint(0, 8, (n, h), generator=gen, device=dev).float()
        a_src = torch.zeros((k, f), device=dev)
        a_dst = torch.randint(0, 3, (k, f), generator=gen,
                              device=dev).float()
        du = torch.randint(-4, 5, (n, h), generator=gen, device=dev).float()
        dz = torch.randint(-4, 5, (n, k), generator=gen, device=dev).float()
    else:
        x = torch.randn((n, h), generator=gen, device=dev)
        a_src = torch.randn((k, f), generator=gen, device=dev)
        a_dst = torch.randn((k, f), generator=gen, device=dev)
        du = torch.randn((n, h), generator=gen, device=dev)
        dz = torch.randn((n, k), generator=gen, device=dev)
    return {"x": x, "a_src": a_src, "as_": G.gat_score_plain(x, a_src),
            "ad": G.gat_score_plain(x, a_dst), "du": du, "dz": dz}


def _gat_calls(csr, prec: str) -> dict:
    """name -> (kernel call, plain call, terms call); each takes the inputs
    of :func:`_gat_inputs` and the forward's ``m``.  The terms call gives,
    per output, None where the output is gated on its row's max-abs, else
    the sum of the absolute values of each element's terms: the plain
    version on |x|, |a_src|, |du|, |dz| (as_, ad and m unchanged, so every
    e and lrelu'(q) is too, and both are positive).  gat_bwd_src's outputs
    are (dtable, dast, dq), against its plain twin (the function's plain
    dtable and dast, and dq in transposed order); gat_bwd_dst's kernel
    call is the composed backward, the src kernel then the dst kernel on
    its dq."""
    from roc_tpu_torch.ops.kernels import gat as G

    def absolute(i):
        return {**i, **{n: i[n].abs() for n in ("x", "a_src", "du", "dz")}}

    def score(fn):
        return lambda i: fn(i["x"], i["a_src"])

    def fwd(fn):
        return lambda i: fn(i["x"], i["as_"], i["ad"], csr.row_ptr,
                            csr.col_idx, 0.2, prec)

    def node(i):
        return i["x"], i["as_"], i["ad"], i["m"], i["du"], i["dz"]

    def dst_plain(i):
        return G.gat_bwd_dst_plain(*node(i), csr.row_ptr, csr.col_idx, 0.2)

    def src_kernel(i):
        return G.gat_bwd_src(*node(i), csr.t_row_ptr, csr.t_col_idx, 0.2,
                             prec)

    def src_plain(i):
        return G.gat_bwd_src_dq_plain(*node(i), csr.t_row_ptr,
                                      csr.t_col_idx, 0.2, prec)

    def composed(i):
        return G.gat_bwd_dst(src_kernel(i)[2], csr.t_pos, csr.row_ptr,
                             csr.col_idx)

    return {"gat_score": (score(G.gat_score), score(G.gat_score_plain),
                          lambda i: (score(G.gat_score_plain)(absolute(i)),)),
            "gat_forward": (fwd(G.gat_forward), fwd(G.gat_forward_plain),
                            lambda i: (None, None, None)),
            "gat_bwd_dst": (composed, dst_plain,
                            lambda i: (dst_plain(absolute(i)),)),
            "gat_bwd_src": (src_kernel, src_plain,
                            lambda i: (None, *src_plain(absolute(i))[1:]))}


GAT_BACKWARD = ("gat_bwd_dst", "gat_bwd_src")


def _gat_bound(name, n, e, k, f, csr_bytes) -> dict:
    """Compulsory bytes (each input read once, each output written once)
    and operations: 2 per multiply-add of the weighted sums and dots, and a
    few per edge and head for the score, its shift, exp and sums."""
    h = k * f
    nk, nh = n * k * 4, n * h * 4
    if name == "gat_score":
        return _bound(nh + h * 4 + nk, 2 * n * h)
    if name == "gat_forward":
        return _bound(nh + 2 * nk + nh + 2 * nk + csr_bytes,
                      2 * e * h + 4 * e * k)
    if name == "gat_bwd_dst":
        # the dst kernel's own work: dq and t_pos read, row_ptr, dadl, an
        # add per edge and head (the dots it sums are the src kernel's)
        return _bound(e * k * 4 + e * 4 + (n + 1) * 8 + nk, e * k)
    if name == "gat_bwd_pair":
        # the whole backward (dtable, dast, dadl): each edge's dot once
        return _bound(2 * nh + 4 * nk + nh + 2 * nk + csr_bytes,
                      4 * e * h + 9 * e * k)
    return _bound(2 * nh + 4 * nk + nh + nk + csr_bytes,
                  4 * e * h + 8 * e * k)


def _score_serial_equal(i) -> bool:
    """gat_score bitwise equal to the serial-order reference (products
    rounded, added in f order from 0), on x as given and on a copy of x
    that starts 4 bytes into its buffer (the kernel's unaligned copy)."""
    from roc_tpu_torch.ops.kernels import gat as G
    x, a = i["x"], i["a_src"]
    shifted = torch.empty(x.numel() + 1, device=x.device)[1:].view_as(x)
    shifted.copy_(x)
    return all(bool(torch.equal(G.gat_score(t, a), G.gat_score_serial(t, a)))
               for t in (x, shifted))


def _score_library(i) -> torch.Tensor:
    """The source score as one library call: torch.einsum (fp32, TF32
    off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    k, f = i["a_src"].shape
    return torch.einsum("tkf,kf->tk", i["x"].view(-1, k, f), i["a_src"])


def _gat_library(csr, n, dev):
    """The forward as library calls: a sparse [N, N] score matrix per head
    (COO in (row, column) order, parallel edges kept as separate entries),
    torch.sparse.softmax over its rows, then torch.sparse.mm."""
    dst = torch.repeat_interleave(torch.arange(n, device=dev),
                                  torch.diff(csr.row_ptr))
    src = csr.col_idx.long()
    order = torch.argsort(dst * n + src)
    idx = torch.stack([dst[order], src[order]])
    del dst, src, order

    def run(i):
        k = i["as_"].shape[1]
        f = i["x"].shape[1] // k
        s = torch.nn.functional.leaky_relu(i["ad"][idx[0]] + i["as_"][idx[1]],
                                           0.2)
        outs = []
        for hd in range(k):
            p = torch.sparse.softmax(torch.sparse_coo_tensor(
                idx, s[:, hd].contiguous(), (n, n), is_coalesced=True), 1)
            outs.append(torch.sparse.mm(p, i["x"][:, hd * f:(hd + 1) * f]))
        return torch.cat(outs, 1)
    return run


def _gat_bwd_library(csr, n, dev):
    """The backward as library calls in fp32 (the port never calls them):
    per head torch.sparse.sampled_addmm gives each edge's dot du[v] . x[u]
    over the CSR's pattern, elementwise ops dq, torch.segment_reduce dadl
    and index_add_ dast, and torch.sparse.mm of the transposed e-weighted
    matrix times du dtable.  Returns (dtable, dast, dadl)."""
    dst = torch.repeat_interleave(torch.arange(n, device=dev),
                                  torch.diff(csr.row_ptr))
    src = csr.col_idx.long()
    t_src = torch.repeat_interleave(torch.arange(n, device=dev),
                                    torch.diff(csr.t_row_ptr))
    t_dst = csr.t_col_idx.long()
    lengths = torch.diff(csr.row_ptr)

    def lrelu_e(q, m):
        return torch.exp(torch.nn.functional.leaky_relu(q, 0.2) - m)

    def run(i):
        torch.backends.cuda.matmul.allow_tf32 = False
        k = i["as_"].shape[1]
        f = i["x"].shape[1] // k
        x, du = i["x"], i["du"]
        q = i["ad"][dst] + i["as_"][src]
        e = lrelu_e(q, i["m"][dst])
        pattern = torch.sparse_csr_tensor(
            csr.row_ptr, src, torch.zeros(src.numel(), device=dev), (n, n))
        dots = torch.stack([torch.sparse.sampled_addmm(
            pattern, du[:, hd * f:(hd + 1) * f],
            x[:, hd * f:(hd + 1) * f].t(), beta=0.0).values()
            for hd in range(k)], 1)
        dq = e * (dots + i["dz"][dst]) * torch.where(q >= 0, 1.0, 0.2)
        dadl = torch.segment_reduce(dq, "sum", lengths=lengths, axis=0)
        dast = torch.zeros((n, k), device=dev).index_add_(0, src, dq)
        del pattern, dots, dq, e, q
        et = lrelu_e(i["ad"][t_dst] + i["as_"][t_src], i["m"][t_dst])
        dtable = torch.cat([torch.sparse.mm(torch.sparse_csr_tensor(
            csr.t_row_ptr, t_dst, et[:, hd].contiguous(), (n, n)),
            du[:, hd * f:(hd + 1) * f]) for hd in range(k)], 1)
        return dtable, dast, dadl
    return run


# (K, F): K*F not a multiple of 4 or 32, K above 32, H above one 256-column
# tile, H a multiple of 4 whose F is not (a 4-float pack would straddle two
# heads), the full-width model's two layers, and K = 16 and 12, which the dst
# kernel sums in two passes of head groups (8 + 8, 8 + 4)
GAT_SHAPES = ((3, 5), (8, 8), (40, 2), (2, 200), (4, 6), (2, 2), (1, 41),
              (4, 64), (16, 4), (12, 5))


def _same_bits(a, b) -> bool:
    return all(bool(torch.equal(x, y)) for x, y in zip(a, b))


def phase_kernel_gat_shapes(dev) -> dict:
    """The GAT kernels against their plain versions at ragged head shapes
    on a small graph: a hub row of 700 in-edges (many 32-edge batches), an
    isolated row, rows of every small degree.  Every output bitwise on the
    integer fixture; the backward's two runs give equal bits."""
    from roc_tpu_torch.graph.csr import from_edges
    from roc_tpu_torch.ops import DeviceCsr
    rng = np.random.default_rng(SEED + 5)
    n = 3000
    src = rng.integers(0, n, 30000)
    dst = rng.integers(0, n, 30000)
    dst[:700] = 17
    keep = dst != 29
    csr = DeviceCsr.from_csr(from_edges(n, src[keep], dst[keep]), dev,
                             edge_map=True)
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    worst = {}
    for k, f in GAT_SHAPES:
        for prec in ("fast", "exact"):
            calls = _gat_calls(csr, prec)
            for integer in (True, False):
                inp = _gat_inputs(n, k, f, gen, dev, integer)
                inp["m"] = calls["gat_forward"][1](inp)[1]
                for name, (kern, plain, terms) in calls.items():
                    kk = _gat_parts(kern(inp))
                    pp = _gat_parts(plain(inp))
                    torch.cuda.synchronize()
                    if name == "gat_score" and not _score_serial_equal(
                            inp):
                        raise AssertionError(
                            f"gat_score K={k} F={f}: not bitwise equal to "
                            f"the serial-order reference")
                    if name in GAT_BACKWARD and not _same_bits(
                            kk, _gat_parts(kern(inp))):
                        raise AssertionError(f"{name} K={k} F={f} {prec}: "
                                             f"two runs differ")
                    if integer:
                        if not _same_bits(kk, pp):
                            raise AssertionError(
                                f"{name} K={k} F={f} {prec}: not bitwise "
                                f"on the integer fixture")
                        continue
                    err = _gat_errors(kk, pp, terms(inp))
                    w = worst.setdefault(name, {"row_rel_err": 0.0,
                                                "term_rel_err": 0.0})
                    for key in w:
                        w[key] = max(w[key], err[key])
                    if max(err["row_rel_err"], err["term_rel_err"]) > 1e-5 \
                            or not all(bool(torch.isfinite(a).all())
                                       for a in kk):
                        raise AssertionError(f"{name} K={k} F={f} {prec}: "
                                             f"errors {err}")
                    if name == "gat_forward" and not (
                            bool((kk[0][29] == 0).all())
                            and bool((kk[2][29] == 0).all())
                            and bool((kk[1][29] == 0).all())):
                        raise AssertionError("gat_forward: the isolated row "
                                             "is not out = 0, m = 0, z = 0")
                    if name == "gat_bwd_dst" and not bool(
                            (kk[0][29] == 0).all()):
                        raise AssertionError("gat_bwd_dst: the isolated row "
                                             "is not dadl = 0")
    rec = {"phase": "kernel_gat_shapes", "nodes": n, "hub_in_degree":
           int(torch.diff(csr.row_ptr)[17]), "isolated_row": 29,
           "shapes": GAT_SHAPES,
           "worst_err": worst, "tolerance": 1e-5, "int_bitwise": True,
           "score_serial_bitwise": True, "backward_runs_bitwise": True,
           "forward": _gat_forward_shapes(dev)}
    emit(rec)
    return rec


def _forward_in_csr_order(inp, csr, prec: str):
    """gat_forward_plain's function and arithmetic with its sums in CSR
    order: m from the plain version on the card (a max takes no order);
    each edge's e = exp(lrelu(ad + as) - m) and term e x (rounded to bf16
    in fast) formed on the card as the plain version forms them; z and u
    summed on the CPU by index_add_, which adds in index order; out = u /
    max(z, 1e-15); returned on the CPU."""
    from roc_tpu_torch.ops.kernels import gat as G
    x, as_, ad = inp["x"], inp["as_"], inp["ad"]
    k, f = G._heads(x, as_)
    n, h = csr.row_ptr.numel() - 1, x.shape[1]
    m = G.gat_forward_plain(x, as_, ad, csr.row_ptr, csr.col_idx, 0.2,
                            prec)[1]
    rows = torch.repeat_interleave(torch.arange(n, device=x.device),
                                   torch.diff(csr.row_ptr))
    cols = csr.col_idx.long()
    e = torch.exp(G._lrelu(ad[rows] + as_[cols], 0.2) - m[rows])
    t = G._round((e[:, :, None] * x[cols].view(-1, k, f)).view(-1, h), prec)
    rows = rows.cpu()
    z = torch.zeros((n, k)).index_add_(0, rows, e.cpu())
    u = torch.zeros((n, h)).index_add_(0, rows, t.cpu())
    out = u.view(n, k, f) / torch.clamp_min(z, G.Z_GUARD)[:, :, None]
    return out.view(n, h), m.cpu(), z


def _gat_forward_shapes(dev) -> dict:
    """gat_forward at every GAT_SHAPES shape on a graph with a hub row of
    20,000 in-edges (625 to 2,500 edge batches) and an isolated row, both
    precisions, on x contiguous and on a column slice of a wider tensor
    (rows not 16-byte aligned): every output bitwise on the integer fixture
    and within 1e-5 of each row's max-abs on Gaussian data, against
    :func:`_forward_in_csr_order` (the plain version's arithmetic with its
    sums in CSR order: on the card index_add_'s atomics would reorder the
    hub's 20,000 terms, up to 1e-5 of a row at F = 5 in a CPU
    simulation); the slice bitwise equal to x itself; the isolated row all
    zero."""
    from roc_tpu_torch.graph.csr import from_edges
    from roc_tpu_torch.ops import DeviceCsr
    from roc_tpu_torch.ops.kernels import gat as G
    from roc_tpu_torch.ops.kernels.aggregate_sum import stage_plain
    rng = np.random.default_rng(SEED + 8)
    n, hub, iso = 2000, 17, 29
    src = rng.integers(0, n, 40000)
    dst = rng.integers(0, n, 40000)
    dst[:20000] = hub
    keep = dst != iso
    graph = from_edges(n, src[keep], dst[keep])
    csr = DeviceCsr.from_csr(graph, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    worst, geometry = 0.0, {}
    for k, f in GAT_SHAPES:
        h = k * f
        for integer in (True, False):
            inp = _gat_inputs(n, k, f, gen, dev, integer)
            wide = torch.zeros((n, h + 3), device=dev)
            wide[:, 1:1 + h] = inp["x"]
            xs = wide[:, 1:1 + h]
            ld = (h + 3) // 4 * 4
            for t in (inp["x"], xs):
                if k == 1 and not torch.equal(
                        G.gat_stage(t), stage_plain(t, precision="exact")):
                    raise AssertionError(f"gat_stage H={h}: not equal to "
                                         f"its plain version")
            for prec in ("fast", "exact"):
                args = (inp["as_"], inp["ad"], csr.row_ptr, csr.col_idx, 0.2,
                        prec)
                kk = G.gat_forward(inp["x"], *args)
                ks = G.gat_forward(xs, *args)
                pp = _forward_in_csr_order(inp, csr, prec)
                kk = tuple(t.cpu() for t in kk)
                tag = f"gat_forward K={k} F={f} {prec}"
                if not _same_bits(kk, tuple(t.cpu() for t in ks)):
                    raise AssertionError(f"{tag}: the column slice differs "
                                         f"from x itself")
                if not all(bool((t[iso] == 0).all()) for t in kk):
                    raise AssertionError(f"{tag}: the isolated row is not "
                                         f"out = 0, m = 0, z = 0")
                if integer:
                    if not _same_bits(kk, pp):
                        raise AssertionError(f"{tag}: not bitwise on the "
                                             f"integer fixture")
                    continue
                err = max(row_rel_err(a, b) for a, b in zip(kk, pp))
                worst = max(worst, err)
                if err > 1e-5 or not all(bool(torch.isfinite(a).all())
                                         for a in kk):
                    raise AssertionError(f"{tag}: row error {err}")
        geometry[f"K{k}_F{f}"] = {
            layout: G.forward_geometry(k, f, t.stride(0),
                                       t.data_ptr())._asdict()
            for layout, t in (("contiguous", inp["x"]), ("slice", xs))}
    return {"nodes": n, "hub_in_degree": int(torch.diff(csr.row_ptr)[hub]),
            "isolated_row": iso, "layouts": ["contiguous", "column_slice"],
            "int_bitwise": True, "slice_bitwise": True,
            "worst_row_rel_err": worst, "tolerance": 1e-5,
            "geometry": geometry}


def phase_kernel_gat(ds, dev) -> list:
    """The GAT kernels on the Reddit graph at the published GAT's layer 1
    (K=8, F=8: the dst kernel's 8-head pass), the full-width model's layer
    1 (K=4, F=64) and both models' layer 2 (K=1, F=41), both precisions,
    each against its plain version, with times and bounds.  gat_bwd_src's
    row holds dq against its plain twin; gat_bwd_dst's row checks the
    composed backward and times the dst kernel alone on the src kernel's
    dq, against its own bound and index_add_; both carry the
    build's ``ptxas`` and the pair's time (``pair_ms``, src + dst), its
    bound (the whole backward's, ``pair_bound_ms``) and its library
    composition's time (``pair_library_ms``, timed once per layer
    shape)."""
    from roc_tpu_torch.ops import DeviceCsr
    from roc_tpu_torch.ops.kernels import aggregate_sum as KS
    from roc_tpu_torch.ops.kernels import gat as G
    g = ds.graph
    n, e = g.num_nodes, g.num_edges
    csr = DeviceCsr.from_csr(g, dev, edge_map=True)
    csr_bytes = csr.row_ptr.numel() * 8 + csr.col_idx.numel() * 4
    library = _gat_library(csr, n, dev)
    bwd_library = _gat_bwd_library(csr, n, dev)
    ptxas = ptxas_report(G.LIBRARY.info.get("log", ""))
    stage_ptxas = {kn: v for kn, v in ptxas_report(
        KS.LIBRARY.info.get("log", "")).items() if "stage_kernel_f32" in kn}
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    rows = []
    for k, f in ((8, 8), (4, 64), (1, 41)):
        bwd_lib = {}
        for prec in ("fast", "exact"):
            calls = _gat_calls(csr, prec)
            ints = _gat_inputs(n, k, f, gen, dev, integer=True)
            gauss = _gat_inputs(n, k, f, gen, dev)
            for inp in (ints, gauss):
                inp["m"] = calls["gat_forward"][1](inp)[1]
            recs = []
            for name, (kern, plain, terms) in calls.items():
                rec = {"phase": "kernel", "name": name, "K": k, "F": f,
                       "precision": prec, "nodes": n, "edges": e,
                       **_gat_bound(name, n, e, k, f, csr_bytes)}
                rec["int_bitwise"] = _same_bits(_gat_parts(kern(ints)),
                                                _gat_parts(plain(ints)))
                kk, pp = _gat_parts(kern(gauss)), _gat_parts(plain(gauss))
                torch.cuda.synchronize()
                rec.update(_gat_errors(kk, pp, terms(gauss)))
                rec["tolerance"] = 1e-5
                rec["finite"] = all(bool(torch.isfinite(a).all())
                                    for a in kk)
                if name in GAT_BACKWARD:
                    rec["runs_bitwise"] = _same_bits(
                        kk, _gat_parts(kern(gauss)))
                    rec["ptxas"] = {kn: v for kn, v in ptxas.items()
                                    if name + "_rows" in kn}
                if name == "gat_forward":
                    geo = G.forward_geometry(k, f, gauss["x"].stride(0),
                                             gauss["x"].data_ptr())
                    rec["geometry"] = geo._asdict()
                    rec["ptxas"] = _fwd_ptxas(ptxas, geo, prec)
                    if geo.staged:  # the staging launch alone
                        rec["ptxas"].update(stage_ptxas)
                        rec["stage_ms"] = per_launch_ms(
                            lambda: G.gat_stage(gauss["x"]))
                del kk, pp
                timed = kern
                if name == "gat_bwd_dst":
                    # the dst kernel alone, on the src kernel's dq
                    dq = calls["gat_bwd_src"][0](gauss)[2]
                    rec["dq_bytes"] = dq.numel() * 4
                    timed = (lambda dq=dq: G.gat_bwd_dst(
                        dq, csr.t_pos, csr.row_ptr, csr.col_idx))
                rec["kernel_ms"] = time_ms(lambda: timed(gauss)
                                           if timed is kern else timed(),
                                           reps=20, warmup=3)
                # the function's plain version (without gat_dq_plain)
                plain_t = (plain if name != "gat_bwd_src" else
                           lambda i: G.gat_bwd_src_plain(
                               i["x"], i["as_"], i["ad"], i["m"], i["du"],
                               i["dz"], csr.t_row_ptr, csr.t_col_idx, 0.2,
                               prec))
                rec["plain_ms"] = time_ms(lambda: plain_t(gauss), reps=5,
                                          warmup=1)
                rec["library_ms"] = None
                if name == "gat_score":
                    rec["serial_bitwise"] = all(_score_serial_equal(i)
                                                for i in (ints, gauss))
                    lib = _score_library(gauss)
                    rec["library_term_rel_err"] = term_rel_err(
                        lib, plain(gauss), terms(gauss)[0])
                    del lib
                    rec["library_ms"] = time_ms(
                        lambda: _score_library(gauss), reps=20, warmup=3)
                    retime_small(rec, lambda: kern(gauss),
                                 lambda: _score_library(gauss))
                if name == "gat_bwd_dst":
                    rec.update(_time_dadl_library(dq, csr, plain(gauss)))
                    retime_small(rec, timed,
                                 lambda dq=dq: _dadl_library(dq, csr))
                    del dq
                if name == "gat_forward":
                    try:
                        lib = library(gauss)
                        rec["library_rel_err"] = row_rel_err(
                            lib, plain(gauss)[0])
                        del lib
                        rec["library_ms"] = time_ms(lambda: library(gauss),
                                                    reps=5, warmup=1)
                    except (RuntimeError, NotImplementedError) as err:
                        rec["library_error"] = str(err)[:300]
                if name in GAT_BACKWARD and not bwd_lib:
                    bwd_lib.update(_time_bwd_library(bwd_library, gauss,
                                                     csr))
                recs.append(rec)
            if k == 1 and prec == "fast":
                recs.append(_gat_stage_row(ints, gauss, n))
            pair = {"pair_ms": sum(r["kernel_ms"] for r in recs
                                   if r["name"] in GAT_BACKWARD),
                    **{"pair_" + key: v for key, v in _gat_bound(
                        "gat_bwd_pair", n, e, k, f, csr_bytes).items()},
                    **{"pair_" + key: v for key, v in bwd_lib.items()}}
            for rec in recs:
                if rec["name"] in GAT_BACKWARD:
                    rec.update(pair)
                emit(rec)
                rows.append(rec)
            for rec in recs:
                if not (rec["finite"] and rec["int_bitwise"]
                        and rec.get("gauss_bitwise", True)
                        and rec.get("runs_bitwise", True)
                        and rec.get("serial_bitwise", True)
                        and rec["row_rel_err"] <= 1e-5
                        and rec["term_rel_err"] <= 1e-5
                        and rec.get("library_term_rel_err", 0.0) <= 1e-5):
                    raise AssertionError(f"{rec['name']} (or its library "
                                         f"call) disagrees with its plain "
                                         f"version: {rec}")
            del ints, gauss
    return rows


def _gat_stage_row(ints, gauss, n) -> dict:
    """gat_stage (the forward's fp32 plane of a single head's 41 columns,
    16-byte rows of 44) against its plain version: a copy, so bitwise on
    both inputs; its time (per launch over 100), the plain version's and
    torch.nn.functional.pad's (one call of the same function); bound: x
    read and the plane written once."""
    from roc_tpu_torch.ops.kernels import gat as G
    from roc_tpu_torch.ops.kernels.aggregate_sum import stage_plain
    x = gauss["x"]
    h = x.shape[1]
    ld = (h + 3) // 4 * 4

    def kern():
        return G.gat_stage(x)

    def plain(t):
        return stage_plain(t, precision="exact")

    def library():
        return torch.nn.functional.pad(x, (0, ld - h))
    got, want = kern(), plain(x)
    rec = {"phase": "kernel", "name": "gat_stage", "K": 1, "F": h, "H": h,
           "ld": ld, "precision": "fast", "nodes": n,
           **_bound(n * h * 4 + n * ld * 4, 0),
           "int_bitwise": bool(torch.equal(G.gat_stage(ints["x"]),
                                           plain(ints["x"]))),
           "gauss_bitwise": bool(torch.equal(got, want)),
           "library_bitwise": bool(torch.equal(library(), want)),
           "max_abs_err": float((got - want).abs().max()),
           "row_rel_err": row_rel_err(got, want), "term_rel_err": 0.0,
           "tolerance": 0.0, "finite": bool(torch.isfinite(got).all()),
           "kernel_ms": time_ms(kern, reps=20, warmup=3),
           "plain_ms": time_ms(lambda: plain(x), reps=5, warmup=1),
           "library_ms": time_ms(library, reps=20, warmup=3)}
    retime_small(rec, kern, library)
    return rec


def _fwd_ptxas(ptxas: dict, geo, prec: str) -> dict:
    """The ptxas lines of the forward instantiation that ``geo`` launches
    (gat_fwd_rows<VEC, PACKS, LANES, ROUND>); every gat_fwd_rows line where
    the names are not demangled."""
    want = (f"gat_fwd_rows<{geo.vec}, {geo.packs}, {geo.lanes}, "
            f"{'true' if prec == 'fast' else 'false'}>")
    out = {kn: v for kn, v in ptxas.items() if want in kn}
    return out or {kn: v for kn, v in ptxas.items() if "gat_fwd_rows" in kn}


def _dadl_library(dq, csr) -> torch.Tensor:
    """dadl as one library call: index_add_ of dq (transposed edge order)
    over each transposed edge's destination, t_col_idx."""
    return torch.zeros((csr.row_ptr.numel() - 1, dq.shape[1]),
                       device=dq.device).index_add_(0, csr.t_col_idx, dq)


def _time_dadl_library(dq, csr, want) -> dict:
    """The dst kernel's library call on the src kernel's ``dq``: its time
    and its largest row error against the plain dadl."""
    err = row_rel_err(_dadl_library(dq, csr), want)
    return {"library_ms": time_ms(lambda: _dadl_library(dq, csr), reps=10),
            "library_rel_err": err}


def _time_bwd_library(library, i, csr) -> dict:
    """The backward's library composition on ``i``: its time and its
    largest row error against the plain fp32 versions (dtable, dast,
    dadl), or the error it raised."""
    from roc_tpu_torch.ops.kernels import gat as G
    node = (i["x"], i["as_"], i["ad"], i["m"], i["du"], i["dz"])
    try:
        lib = library(i)
        want = (*G.gat_bwd_src_plain(*node, csr.t_row_ptr, csr.t_col_idx,
                                     0.2, "exact"),
                G.gat_bwd_dst_plain(*node, csr.row_ptr, csr.col_idx, 0.2))
        err = {name: row_rel_err(a, b) for name, a, b in
               zip(("dtable", "dast", "dadl"), lib, want)}
        del lib, want
        return {"library_ms": time_ms(lambda: library(i), reps=5, warmup=1),
                "library_rel_err": err,
                "library_covers": "dtable, dast and dadl in one composition"}
    except (RuntimeError, NotImplementedError, TypeError) as err:
        return {"library_ms": None, "library_error": str(err)[:300]}


# the cross-layer path: gcn-chain at the canonical GCN's widths with three
# hidden layers; -fusion-depth 0 fuses the three hidden layers into one region
CHAIN = [602, 256, 256, 256, 41]
REGION = CHAIN[:4]
REGION_ACTS = ("relu", "relu", "relu")


def region_reference(x, ws, scale, csr, precision, acts, g,
                     absolute=False, need_dx=True):
    """The region's forward and backward in float64, where sums of the
    integer fixture are exact in any order, rounding each gathered element
    to bf16 in "fast" as the kernels do.  With ``absolute`` it runs on |x|,
    |W| and |g| with every relu open and no rounding, and gives per output
    element the sum of the absolute values of its terms (relu is
    1-Lipschitz, so this bounds what fp32 reassociation and a flipped
    rounding can move).  Returns (out, dx, dws)."""
    f64 = torch.float64

    def cast(t):
        return (t.abs() if absolute else t).to(f64)

    def agg(t, rp, ci):
        if precision == "fast" and not absolute:
            t = t.to(torch.bfloat16).to(f64)
        acc = torch.zeros((rp.numel() - 1, t.shape[1]), dtype=f64,
                          device=t.device)
        chunk = max((1 << 25) // t.shape[1], 1024)
        for lo in range(0, ci.numel(), chunk):
            hi = min(lo + chunk, ci.numel())
            e = torch.arange(lo, hi, dtype=rp.dtype, device=t.device)
            dst = torch.searchsorted(rp, e, right=True) - 1
            acc.index_add_(0, dst, t.index_select(0, ci[lo:hi]))
        return acc

    def relu_mask(t, l, keep):
        if acts[l] == "relu" and not absolute:
            return torch.where(keep, t, torch.zeros_like(t))
        return t

    depth = len(ws)
    s = None if scale is None else scale.to(f64)[:, None]
    w64 = [cast(w) for w in ws]
    h, planes, keep = cast(x), [], []
    for l in range(depth):
        t = agg(h, csr.row_ptr, csr.col_idx) @ w64[l]
        keep.append(t > 0)
        t = relu_mask(t, l, keep[l])
        if l + 1 < depth:
            if s is not None:
                t = (t * s) * s
            planes.append(t)
        h = t
    out, dws, c = h, [None] * depth, cast(g)
    for l in reversed(range(depth)):
        staged = c if l == depth - 1 or s is None else (c * s) * s
        u = agg(relu_mask(staged, l, keep[l]), csr.t_row_ptr, csr.t_col_idx)
        dws[l] = (cast(x) if l == 0 else planes[l - 1]).t() @ u
        c = u @ w64[l].t() if l > 0 or need_dx else None
    return out, c, tuple(dws)


def region_int_inputs(n, widths, gen, dev, seed_rows=None):
    """The integer fixture of a region: x in {0, 1} on ``seed_rows`` random
    rows (every row when None), each weight with one +-1 per column (3 in 4
    positive) on rows spread over its input width, so a GEMM selects and
    never sums; per-row scales 1 or 1/2; g in {-1, 0, 1}.  Sums stay exact
    in fp32, so the kernel and its plain version must agree bitwise (the
    float64 reference checks that the fixture is exact)."""
    x = torch.randint(0, 2, (n, widths[0]), generator=gen,
                      device=dev).to(torch.float32)
    if seed_rows is not None:
        keep = torch.zeros(n, dtype=torch.bool, device=dev)
        keep[torch.randperm(n, generator=gen, device=dev)[:seed_rows]] = True
        x = torch.where(keep[:, None], x, torch.zeros_like(x))
    ws = []
    for hi, ho in zip(widths, widths[1:]):
        rows = torch.randperm(hi, generator=gen, device=dev)[
            torch.arange(ho, device=dev) % hi]
        sign = torch.where(torch.rand(ho, generator=gen, device=dev) < 0.75,
                           1.0, -1.0)
        w = torch.zeros((hi, ho), device=dev)
        w[rows, torch.arange(ho, device=dev)] = sign
        ws.append(w)
    scale = torch.where(torch.rand(n, generator=gen, device=dev) < 0.25,
                        0.5, 1.0)
    g = torch.randint(-1, 2, (n, widths[-1]), generator=gen,
                      device=dev).to(torch.float32)
    return x, ws, scale, g


def region_gauss_inputs(n, widths, scale, gen, dev):
    """Gaussian x and g, Glorot-scaled Gaussian weights, the graph's own
    scales rsqrt(in_degree)."""
    x = torch.randn((n, widths[0]), generator=gen, device=dev)
    ws = [torch.randn((hi, ho), generator=gen, device=dev) / hi ** 0.5
          for hi, ho in zip(widths, widths[1:])]
    g = torch.randn((n, widths[-1]), generator=gen, device=dev)
    return x, ws, scale, g


def _region_calls(csr, prec, acts):
    """name -> (kernel call, plain call) of the two region entry points;
    each takes (x, ws, scale, g, y, need_dx) and returns a tuple of
    tensors: (out,) forward, (dx, dW_0, ..., dW_{D-1}) backward (dx left
    out without need_dx)."""
    from roc_tpu_torch.ops.kernels import xlayer as KX

    def fwd(fn):
        return lambda x, ws, s, g=None, y=None, need_dx=True: (
            fn(x, ws, s, csr.row_ptr, csr.col_idx, prec, acts),)

    def bwd(fn):
        def call(x, ws, s, g, y, need_dx=True):
            dx, dws = fn(g, y, x, ws, s, csr.row_ptr, csr.col_idx,
                         csr.t_row_ptr, csr.t_col_idx, prec, acts, need_dx)
            return (*(() if dx is None else (dx,)), *dws)
        return call

    return {"xlayer_fwd": (fwd(KX.xlayer_fwd), fwd(KX.xlayer_fwd_plain)),
            "xlayer_bwd": (bwd(KX.xlayer_bwd), bwd(KX.xlayer_bwd_plain))}


def _region_check(csr, prec, acts, ints, gauss, scaled=True) -> dict:
    """Hold both region kernels against their plain versions.  Integer
    fixture: bitwise, and the plain version equal to the float64 reference
    (the fixture is exact).  Gaussian: each output element within 1e-5 of
    the sum of the absolute values of its terms (the float64 reference on
    absolute values, every relu open), and the forward's out within 1e-5
    of each row's max-abs in exact.  The row error is reported for dx too
    but not gated: dx sums every path through three layers with random
    signs and cancels (on Reddit its terms reach ~3e5 times the row's
    max-abs), and in fast a last-bit difference in an interior plane can
    flip that element's bf16 rounding (2^-8 of one term).  Two backward
    calls must give the same bits."""
    calls = _region_calls(csr, prec, acts)
    res = {name: {"finite": True} for name in calls}
    for kind, (x, ws, s, g) in (("int", ints), ("gauss", gauss)):
        s = s if scaled else None
        y = calls["xlayer_fwd"][1](x, ws, s)[0]
        ref_out, ref_dx, ref_dws = region_reference(x, ws, s, csr, prec,
                                                    acts, g)
        refs = {"xlayer_fwd": (ref_out,), "xlayer_bwd": (ref_dx, *ref_dws)}
        terms = None
        if kind == "gauss":
            t_out, t_dx, t_dws = region_reference(x, ws, s, csr, prec, acts,
                                                  g, absolute=True)
            terms = {"xlayer_fwd": (t_out,), "xlayer_bwd": (t_dx, *t_dws)}
        del ref_out, ref_dx, ref_dws
        for name, (kern, plain) in calls.items():
            r = res[name]
            k, p = kern(x, ws, s, g, y), plain(x, ws, s, g, y)
            torch.cuda.synchronize()
            r["finite"] = r["finite"] and all(bool(torch.isfinite(a).all())
                                              for a in k)
            if kind == "int":
                r["int_bitwise"] = all(bool(torch.equal(a, b))
                                       for a, b in zip(k, p))
                r["fixture_exact"] = all(bool(torch.equal(a.double(), b))
                                         for a, b in zip(p, refs[name]))
                if name == "xlayer_bwd":
                    again = kern(x, ws, s, g, y)
                    r["deterministic"] = all(bool(torch.equal(a, b))
                                             for a, b in zip(k, again))
                    del again
                continue
            r["max_abs_err"] = max(float((a - b).abs().max())
                                   for a, b in zip(k, p))
            r["term_rel_err"] = max(term_rel_err(a.double(), b.double(), t)
                                    for a, b, t in zip(k, p, terms[name]))
            # out, or dx: the outputs held per row; dW is held per element
            r["row_rel_err"] = row_rel_err(k[0], p[0])
            del k, p
        del refs, terms, y
    for name, r in res.items():
        r["tolerance"] = 1e-5
        r["ok"] = (r["finite"] and r["int_bitwise"] and r["fixture_exact"]
                   and r.get("deterministic", True)
                   and r["term_rel_err"] <= 1e-5
                   and (prec == "fast" or name == "xlayer_bwd"
                        or r["row_rel_err"] <= 1e-5))
    return res


def _region_bound(n, e, widths, csr_bytes, backward, need_dx=True) -> dict:
    """Compulsory bytes (each input read once, each output written once)
    and operations: an add per gathered element, 2 per multiply-add."""
    depth = len(widths) - 1
    layers = list(zip(widths, widths[1:]))
    w_bytes = sum(a * b for a, b in layers) * 4
    agg = [e * a for a, _ in layers]
    gemm = [2 * n * a * b for a, b in layers]
    if not backward:
        return _bound(n * widths[0] * 4 + n * widths[-1] * 4 + w_bytes
                      + csr_bytes + n * 4, sum(agg) + sum(gemm))
    nbytes = (2 * n * widths[-1] * 4 + n * widths[0] * 4 + 2 * w_bytes
              + 2 * csr_bytes + n * 4 + (n * widths[0] * 4 if need_dx else 0))
    flops = (sum(agg[:-1]) + sum(gemm[:-1])                  # replay
             + sum(e * b for _, b in layers) + sum(gemm)      # u, dW
             + sum(gemm[0 if need_dx else 1:]))               # hand-offs
    return _bound(nbytes, flops)


def _region_library(csr, n, dev):
    """The region as library calls (fp32, TF32 off): per layer
    torch.sparse.mm over the CSR, torch.matmul and the epilogue forward;
    the backward replays the interior planes the same way, then per layer
    the masked cotangent, torch.sparse.mm over the transpose and two
    torch.matmul (dW and the hand-off)."""
    def sparse(rp, ci):
        return torch.sparse_csr_tensor(
            rp, ci.to(torch.int64), torch.ones(ci.numel(), device=dev),
            size=(n, n), check_invariants=False)

    fwd_mat = sparse(csr.row_ptr, csr.col_idx)
    bwd_mat = sparse(csr.t_row_ptr, csr.t_col_idx)

    def mm(a, b):
        torch.backends.cuda.matmul.allow_tf32 = False
        return torch.matmul(a, b)

    def planes(x, ws, s, upto):
        h, out = x, []
        for l in range(upto):
            h = torch.relu(mm(fwd_mat @ h, ws[l]))
            if l + 1 < len(ws):
                h = (h * s[:, None]) * s[:, None]
            out.append(h)
        return out

    def fwd(x, ws, s):
        return planes(x, ws, s, len(ws))[-1]

    def bwd(x, ws, s, g, y, need_dx=False):
        ps = planes(x, ws, s, len(ws) - 1)
        c, dws = g, []
        for l in reversed(range(len(ws))):
            last = l == len(ws) - 1
            st = c if last else (c * s[:, None]) * s[:, None]
            st = torch.where((y if last else ps[l]) > 0, st,
                             torch.zeros_like(st))
            u = bwd_mat @ st
            dws.append(mm((x if l == 0 else ps[l - 1]).t(), u))
            c = mm(u, ws[l].t()) if l > 0 or need_dx else None
        return c, dws

    return fwd, bwd


def phase_kernel_xlayer_shapes(dev) -> dict:
    """The region kernels against their plain versions on a small graph
    with a hub row of 700 in-edges and an isolated row: depth 2 (widths 37
    -> 64 -> 130, relu then none) and depth 3 (602 -> 300 -> 42 -> 256, relu,
    none, relu: every vector load width, an interior layer without relu,
    widths above one 256-column pass), with and without the norm pair, both
    precisions."""
    from roc_tpu_torch.graph.csr import from_edges
    from roc_tpu_torch.ops import DeviceCsr
    rng = np.random.default_rng(SEED + 8)
    n = 3000
    src = rng.integers(0, n, 30000)
    dst = rng.integers(0, n, 30000)
    dst[:700] = 17
    keep = dst != 29
    csr = DeviceCsr.from_csr(from_edges(n, src[keep], dst[keep]), dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    deg = torch.clamp_min(torch.diff(csr.row_ptr).float(), 1.0)
    worst, cases = {}, []
    for widths, acts in (((37, 64, 130), ("relu", "none")),
                         ((602, 300, 42, 256), ("relu", "none", "relu"))):
        for fold in (False, True):
            for prec in ("fast", "exact"):
                ints = region_int_inputs(n, widths, gen, dev)
                gauss = region_gauss_inputs(n, widths, torch.rsqrt(deg), gen,
                                            dev)
                res = _region_check(csr, prec, acts, ints, gauss, fold)
                out = _region_calls(csr, prec, acts)["xlayer_fwd"][0](
                    *gauss[:2], gauss[2] if fold else None)[0]
                iso = bool((out[29] == 0).all())
                cases.append({"widths": widths, "activations": acts,
                              "fold": fold, "precision": prec,
                              "isolated_row_zero": iso,
                              **{k: v["ok"] for k, v in res.items()}})
                for name, r in res.items():
                    w = worst.setdefault(name, {"row_rel_err": 0.0,
                                                "term_rel_err": 0.0})
                    for key in w:
                        w[key] = max(w[key], r[key])
                    if not r["ok"] or not iso:
                        emit({"phase": "kernel_xlayer_shapes", "failed": name,
                              "case": cases[-1], "result": r})
                        raise AssertionError(f"{name} {widths} fold={fold} "
                                             f"{prec}: {r}, isolated row "
                                             f"zero: {iso}")
    rec = {"phase": "kernel_xlayer_shapes", "nodes": n,
           "hub_in_degree": int(torch.diff(csr.row_ptr)[17]),
           "isolated_row": 29, "cases": cases, "worst_err": worst,
           "tolerance": 1e-5, "int_bitwise": True, "deterministic": True}
    emit(rec)
    return rec


def phase_kernel_xlayer(ds, dev) -> list:
    """The region kernels on the Reddit graph at the full-width path's
    region (depth 3, 602 -> 256 -> 256 -> 256, relu on every layer, the norm
    pair between layers), both precisions: the checks of _region_check on
    the integer fixture (x on 64 seed rows, so the dW sums over every node
    stay exact) and on Gaussian data; whether the region equals the chain
    of per-layer megakernels bitwise (forward, and dx of the backward); then
    the times of the kernel, the plain version and the library composition,
    and the bound.  The backward is timed as the path calls it (no dx: the
    region's input takes no gradient) and with dx."""
    from roc_tpu_torch.ops import DeviceCsr
    from roc_tpu_torch.ops.kernels import aggregate_linear as KL
    from roc_tpu_torch.ops.kernels import xlayer as KX
    g = ds.graph
    n, e = g.num_nodes, g.num_edges
    csr = DeviceCsr.from_csr(g, dev)
    csr_bytes = csr.row_ptr.numel() * 8 + csr.col_idx.numel() * 4
    scale = torch.rsqrt(torch.as_tensor(g.in_degrees, dtype=torch.float32,
                                        device=dev))
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    ints = region_int_inputs(n, REGION, gen, dev, seed_rows=64)
    gauss = region_gauss_inputs(n, REGION, scale, gen, dev)
    lib_fwd, lib_bwd = _region_library(csr, n, dev)
    ptxas = ptxas_report(KX.LIBRARY.info.get("log", ""))
    rows = []
    for prec in ("fast", "exact"):
        res = _region_check(csr, prec, REGION_ACTS, ints, gauss)
        calls = _region_calls(csr, prec, REGION_ACTS)
        x, ws, s, gg = gauss
        kf, pf = calls["xlayer_fwd"]
        kb, pb = calls["xlayer_bwd"]
        y = pf(x, ws, s)[0]
        # the chain of per-layer megakernels, as -fusion-depth 1 runs it
        h, chain_planes = x, []
        for l, w in enumerate(ws):
            chain_planes.append(h)
            h = KL.aggregate_linear(h, w, csr.row_ptr, csr.col_idx, prec,
                                    "relu")
            if l + 1 < len(ws):
                h = (h * s[:, None]) * s[:, None]
        chain_fwd_equal = bool(torch.equal(h, kf(x, ws, s)[0]))
        c, chain_out = gg, h
        for l in reversed(range(len(ws))):
            c = c if l == len(ws) - 1 else (c * s[:, None]) * s[:, None]
            yl = chain_out if l == len(ws) - 1 else chain_planes[l + 1]
            _, c = KL.aggregate_linear_bwd(c, yl, ws[l], csr.t_row_ptr,
                                           csr.t_col_idx, prec, True)
        chain_dx_equal = bool(torch.equal(c, kb(x, ws, s, gg, chain_out)[0]))
        del h, c, chain_planes, chain_out
        for name, need_dx in (("xlayer_fwd", None), ("xlayer_bwd", False),
                              ("xlayer_bwd", True)):
            kern, plain = calls[name]
            rec = {"phase": "kernel", "name": name, "widths": REGION,
                   "activations": REGION_ACTS, "fold": True,
                   "precision": prec, "nodes": n, "edges": e,
                   **res[name],
                   **_region_bound(n, e, REGION, csr_bytes,
                                   name == "xlayer_bwd", bool(need_dx))}
            if name == "xlayer_fwd":
                rec["per_layer_chain_bitwise"] = chain_fwd_equal
                rec["ok"] = rec["ok"] and chain_fwd_equal
                args = (x, ws, s)
                rec["phase_ms"] = region_phase_ms(
                    lambda st: KX.xlayer_fwd(x, ws, s, csr.row_ptr,
                                             csr.col_idx, prec, REGION_ACTS,
                                             stamps=st), len(ws), False,
                    prec)
                rec["kernel_ms"] = time_ms(lambda: kern(*args), reps=20,
                                           warmup=3)
                rec["plain_ms"] = time_ms(lambda: plain(*args), reps=5,
                                          warmup=1)
                rec["library_ms"] = time_ms(lambda: lib_fwd(*args), reps=10)
            else:
                rec["dx"] = need_dx
                rec["per_layer_chain_dx_bitwise"] = chain_dx_equal
                rec["ok"] = rec["ok"] and chain_dx_equal
                args = (x, ws, s, gg, y, need_dx)
                rec["phase_ms"] = region_phase_ms(
                    lambda st: KX.xlayer_bwd(
                        gg, y, x, ws, s, csr.row_ptr, csr.col_idx,
                        csr.t_row_ptr, csr.t_col_idx, prec, REGION_ACTS,
                        need_dx, stamps=st), len(ws), True, prec)
                rec["kernel_ms"] = time_ms(lambda: kern(*args),
                                           reps=20 if not need_dx else 10,
                                           warmup=3)
                rec["plain_ms"] = time_ms(lambda: plain(*args), reps=5,
                                          warmup=1)
                rec["library_ms"] = time_ms(lambda: lib_bwd(*args), reps=10)
                rec["grid"] = KX.xlayer_bwd.grid
            rec["ptxas"] = {k: v for k, v in ptxas.items() if name in k}
            emit(rec)
            rows.append(rec)
            if not rec["ok"]:
                raise AssertionError(f"{name} disagrees with its plain "
                                     f"version: {rec}")
        del y
    return rows


def ptxas_report(log: str) -> dict:
    """Registers and spill bytes per entry function from ``nvcc -Xptxas -v``
    output ({} when the build printed nothing, as a cached build does),
    keyed by the demangled name where ``c++filt`` is at hand."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            out[name] = {}
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name in out:
            out[name].update(spill_stores=int(m.group(1)),
                             spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name in out:
            out[name]["registers"] = int(m.group(1))
    try:
        names = subprocess.run(["c++filt"], input="\n".join(out),
                               capture_output=True, text=True, timeout=60,
                               check=True).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        names = list(out)
    if len(names) != len(out):
        names = list(out)
    return dict(zip(names, out.values()))


def region_phase_ms(launch, depth: int, backward: bool, precision: str,
                    reps: int = 5) -> list:
    """The phase split of a region kernel: ``launch(stamps)`` runs it once
    with a stamp buffer; per phase the median over ``reps`` launches (after
    one more) of the time between its two ``%globaltimer`` stamps, in
    ms."""
    from roc_tpu_torch.ops.kernels import xlayer as KX
    names = KX.phases(depth, backward, precision)
    buf = torch.zeros(len(names) + 1, dtype=torch.int64, device="cuda")
    runs = []
    for _ in range(reps + 1):
        launch(buf)
        torch.cuda.synchronize()
        t = buf.tolist()
        runs.append([(b - a) / 1e6 for a, b in zip(t, t[1:])])
    return [{"phase": name, "ms": statistics.median(r[i] for r in runs[1:])}
            for i, name in enumerate(names)]


def _trainer(ds, layers, dev, **kw):
    from roc_tpu_torch.models import build_model
    from roc_tpu_torch.train.config import Config
    from roc_tpu_torch.train.driver import Trainer
    cfg = Config(dataset=ds.name, layers=layers, seed=SEED,
                 device=str(dev), **kw)
    return Trainer(cfg, ds, build_model(cfg.model, layers, cfg.dropout_rate,
                                        cfg.aggr, heads=cfg.heads))


def _quiet(*a, **k):
    pass


# model -> (layers, {variant: trainer settings}) of the small card-vs-CPU runs
SMALL = {"gcn": ([64, 16, 8], {"unfused": {}, "megafuse": {"megafuse": True}}),
         "gat": ([64, 8, 8], {"unfused": {}}),
         "gcn-chain": ([64, 16, 16, 16, 8],
                       {"region": {"megafuse": True, "fusion_depth": 0}})}


def phase_train_small(dev, model: str = "gcn") -> dict:
    """The Trainer on mega-shard, card vs CPU: GCN 64-16-8 unfused and
    megafuse, GAT 64-8-8 with 2 heads, or gcn-chain 64-16-16-16-8 with its
    three hidden layers as one region (-megafuse -fusion-depth 0)."""
    from roc_tpu_torch.graph import datasets
    ds = datasets.get("mega-shard", seed=1)
    layers, variants = SMALL[model]
    kw = dict(num_epochs=3, learning_rate=0.01, weight_decay=5e-4,
              dropout_rate=0.0, eval_every=1000, aggregate_backend="binned",
              aggregate_precision="exact", model=model, heads=2)
    name = {"gcn": "train_small", "gat": "train_small_gat",
            "gcn-chain": "train_small_chain"}[model]
    rec = {"phase": name, "dataset": "mega-shard", "model": model,
           "layers": layers, "tolerance": 1e-5}
    for key, extra in variants.items():
        out = {}
        for where, d in (("card", dev), ("cpu", torch.device("cpu"))):
            tr = _trainer(ds, layers, d, **kw, **extra)
            reset_launches()
            loss = tr.train(print_fn=_quiet).final_loss
            out[where] = (loss, tr.predict_logits().cpu(), read_launches())
        rec[key] = {"card_loss": out["card"][0], "cpu_loss": out["cpu"][0],
                    "loss_rel_err": abs(out["card"][0] - out["cpu"][0])
                    / abs(out["cpu"][0]),
                    "logits_row_rel_err": row_rel_err(out["card"][1],
                                                      out["cpu"][1]),
                    "card_launches": out["card"][2]}
    emit(rec)
    for key in variants:
        r = rec[key]
        if not (r["loss_rel_err"] <= 1e-5
                and r["logits_row_rel_err"] <= 1e-5):
            raise AssertionError(f"card training disagrees with the CPU: "
                                 f"{rec}")
    if model == "gcn-chain" and not (
            rec["region"]["card_launches"]["xlayer_fwd"] > 0
            and rec["region"]["card_launches"]["xlayer_bwd"] > 0):
        raise AssertionError(f"the card's region run launched no region "
                             f"kernel: {rec}")
    return rec


_TRAIN_LOSS = re.compile(r"train_loss: ([0-9.naif+-]+)")
# the full-width models: GCN 602-256-41 and GAT 602-64-41 with 4 heads
LAYERS = {"gcn": [602, 256, 41], "gat": [602, 64, 41]}


def step_launches(model: str, megafuse: bool) -> dict:
    """Kernel launches of one training step of the full-width model, in
    fast: each sum aggregation and megakernel forward stages its input
    once (stage_plane)."""
    # two dropouts forward, and one backward: the first one's input is x,
    # which takes no gradient
    if model == "gat":
        # layer 2's single head of 41 columns is staged (gat_stage) first
        return launch_dict(gat_score=2, gat_stage=1, gat_forward=2,
                           gat_bwd_dst=2, gat_bwd_src=2, dropout=3)
    if megafuse:
        return launch_dict(aggregate_linear=2, stage_plane=2,
                           aggregate_linear_bwd=2, stage_cotangent=2,
                           dropout=3)
    return launch_dict(aggregate_sum=4, stage_plane=4, dropout=3)


def _recipe_trainer(ds, dev, megafuse: bool = False, epochs: int = 10,
                    model: str = "gcn", **kw):
    """GCN 602-256-41 (or GAT 602-64-41, 4 heads) as test.sh trains GCN:
    fast, -lr 0.01 -decay 0.0001 -dropout 0.5, eval every 5 epochs."""
    return _trainer(ds, LAYERS[model], dev, num_epochs=epochs,
                    learning_rate=0.01, weight_decay=0.0001,
                    dropout_rate=0.5, eval_every=5,
                    aggregate_precision="fast", megafuse=megafuse,
                    model=model, heads=4, **kw)


def _train_run(tr, dev) -> dict:
    """Train ``tr``, then one more step: synced epoch times (median of
    epochs 3-10), peak memory, the first and last train_loss and the
    launches of each kernel in the run (counts set to 0 just before, read
    just after) and in the step."""
    lines = []
    # what an earlier phase left for the collector would count in this
    # run's peak memory
    gc.collect()
    reset_launches()
    stats = tr.train(print_fn=lines.append)
    launches = read_launches()
    first = float(_TRAIN_LOSS.search(lines[0]).group(1))
    last = float(tr.evaluate().train_loss)
    reset_launches()
    tr.run_epoch()
    torch.cuda.synchronize(dev)
    per_step = read_launches()
    rec = {"epochs": tr.config.num_epochs,
           "epoch_ms": [t * 1e3 for t in stats.epoch_times],
           "median_epoch_ms_3_on": statistics.median(
               stats.epoch_times[2:]) * 1e3,
           "peak_mem_bytes": max(stats.peak_hbm_bytes, default=0),
           "first_train_loss": first, "last_train_loss": last,
           "final_step_loss": stats.final_loss, "metric_lines": lines,
           "launches": launches, "launches_per_step": per_step}
    return rec


def _check_train(rec: dict, expected: dict) -> None:
    """Fails unless the run launched exactly the kernels ``expected``
    names, its extra step launched ``expected``, and the loss is finite
    and falling."""
    launches, per_step = rec["launches"], rec["launches_per_step"]
    first, last = rec["first_train_loss"], rec["last_train_loss"]
    ran = {k: v > 0 for k, v in launches.items()}
    if ran != {k: v > 0 for k, v in expected.items()}:
        raise AssertionError(f"the training run launched {launches}")
    if per_step != expected:
        raise AssertionError(f"one training step launched {per_step}, "
                             f"expected {expected}")
    if not (np.isfinite(first) and np.isfinite(last) and last < first):
        raise AssertionError(f"train_loss did not fall: {first} -> {last}")


def phase_train(ds, dev, megafuse: bool, epochs: int = 10,
                model: str = "gcn") -> dict:
    """GCN 602-256-41 (or GAT 602-64-41, 4 heads) on the Reddit graph as
    test.sh trains GCN."""
    from roc_tpu_torch.train.graph_data import model_gat_dims
    tr = _recipe_trainer(ds, dev, megafuse, epochs, model)
    rec = {"phase": "train" if model == "gcn" else "train_gat",
           "model": model, "heads_head_dim": model_gat_dims(tr.model),
           "layers": LAYERS[model], "dataset": ds.name, "precision": "fast",
           "megafuse": megafuse}
    expected = step_launches(model, megafuse)
    rec.update(_train_run(tr, dev))
    emit(rec)
    _check_train(rec, expected)
    return rec


def chain_step_launches(depth: int) -> dict:
    """Kernel launches of one training step of gcn-chain 602-256-256-256-41
    under -megafuse -fusion-depth ``depth``, dropout 0: a region forward
    and backward per region, a megakernel forward and backward per layer
    outside one (the logits layer always), each megakernel staging its
    input and each backward its cotangent once (fast)."""
    regions, per_layer = {1: (0, 4), 2: (1, 2), 0: (1, 1)}[depth]
    return launch_dict(xlayer_fwd=regions, xlayer_bwd=regions,
                       aggregate_linear=per_layer, stage_plane=per_layer,
                       aggregate_linear_bwd=per_layer,
                       stage_cotangent=per_layer)


def phase_train_chain(ds, dev, depth: int, epochs: int = 10) -> dict:
    """gcn-chain 602-256-256-256-41 on the Reddit graph, fast, -lr 0.01
    -decay 0.0001 -dropout 0, -megafuse -fusion-depth ``depth``: synced
    epoch times (median of epochs 3-10), peak memory, the loss curve (the
    eval train_loss of every epoch) and each kernel's launches in the run
    and in one more step."""
    tr = _trainer(ds, CHAIN, dev, model="gcn-chain", num_epochs=epochs,
                  learning_rate=0.01, weight_decay=0.0001, dropout_rate=0.0,
                  eval_every=1, aggregate_precision="fast", megafuse=True,
                  fusion_depth=depth)
    lines = []
    # what an earlier phase left for the collector would count in this
    # run's peak memory
    gc.collect()
    reset_launches()
    stats = tr.train(print_fn=lines.append)
    launches = read_launches()
    curve = [float(_TRAIN_LOSS.search(ln).group(1)) for ln in lines]
    reset_launches()
    tr.run_epoch()
    torch.cuda.synchronize(dev)
    per_step = read_launches()
    expected = chain_step_launches(depth)
    rec = {"phase": "train_chain", "model": "gcn-chain", "layers": CHAIN,
           "dataset": ds.name, "precision": "fast", "megafuse": True,
           "fusion_depth": depth, "dropout": 0.0, "epochs": epochs,
           "epoch_ms": [t * 1e3 for t in stats.epoch_times],
           "median_epoch_ms_3_on": statistics.median(
               stats.epoch_times[2:]) * 1e3,
           "peak_mem_bytes": max(stats.peak_hbm_bytes, default=0),
           "peak_mem_by_epoch": stats.peak_hbm_bytes,
           "train_loss_curve": curve, "final_step_loss": stats.final_loss,
           "launches": launches, "launches_per_step": per_step}
    emit(rec)
    if per_step != expected:
        raise AssertionError(f"one -fusion-depth {depth} step launched "
                             f"{per_step}, expected {expected}")
    if {k: v > 0 for k, v in launches.items()} != \
            {k: v > 0 for k, v in expected.items()}:
        raise AssertionError(f"the -fusion-depth {depth} run launched "
                             f"{launches}")
    if not (all(np.isfinite(curve)) and curve[-1] < curve[0]):
        raise AssertionError(f"train_loss did not fall: {curve}")
    return rec


def phase_ab_chain(ds, dev, epochs: int = 3) -> dict:
    """gcn-chain at full width, exact, dropout 0, 3 epochs from the same
    params: -fusion-depth 0 (one region) vs 1 (per layer), both -megafuse:
    final loss within 1e-3 relative."""
    out = {}
    for depth in (1, 0):
        tr = _trainer(ds, CHAIN, dev, model="gcn-chain", num_epochs=epochs,
                      learning_rate=0.01, weight_decay=0.0001,
                      dropout_rate=0.0, eval_every=1000,
                      aggregate_precision="exact", megafuse=True,
                      fusion_depth=depth)
        loss = tr.train(print_fn=_quiet).final_loss
        out[depth] = (loss, tr.predict_logits())
        del tr
    rel = abs(out[0][0] - out[1][0]) / abs(out[1][0])
    rec = {"phase": "ab_chain", "precision": "exact", "epochs": epochs,
           "per_layer_loss": out[1][0], "region_loss": out[0][0],
           "loss_rel_err": rel, "tolerance": 1e-3,
           "logits_row_rel_err": row_rel_err(out[0][1], out[1][1])}
    emit(rec)
    if not (np.isfinite(rel) and rel <= 1e-3):
        raise AssertionError(f"-fusion-depth 0 and 1 training disagree: "
                             f"{rec}")
    return rec


def phase_train_bf16(ds, dev, megafuse: bool, fp32: dict) -> dict:
    """GCN 602-256-41 on the Reddit graph as ``train`` under -bf16: x in
    bf16, the bf16 dropout kernel on it, the bf16 first GEMM, then the fp32
    sums, stagings and megakernel rows as before (the norm promotes).  The
    launches per step are fp32's; the loss is held within 5e-2 relative of
    the fp32 run's (``fp32``, that phase's record): bf16 features and
    first GEMM, the same masks and init."""
    tr = _recipe_trainer(ds, dev, megafuse, use_bf16=True)
    rec = {"phase": "train_bf16", "model": "gcn", "layers": LAYERS["gcn"],
           "dataset": ds.name, "precision": "fast", "bf16": True,
           "megafuse": megafuse, "x_dtype": str(tr.x.dtype).split(".")[-1]}
    expected = step_launches("gcn", megafuse)
    rec.update(_train_run(tr, dev))
    del tr
    rec["fp32_median_epoch_ms_3_on"] = fp32["median_epoch_ms_3_on"]
    rec["fp32_peak_mem_bytes"] = fp32["peak_mem_bytes"]
    rec["fp32_last_train_loss"] = fp32["last_train_loss"]
    rec["last_loss_rel_gap_vs_fp32"] = abs(
        rec["last_train_loss"] - fp32["last_train_loss"]) \
        / abs(fp32["last_train_loss"])
    emit(rec)
    _check_train(rec, expected)
    if rec["x_dtype"] != "bfloat16" or \
            not rec["last_loss_rel_gap_vs_fp32"] <= 5e-2:
        raise AssertionError(f"-bf16 training is off: {rec}")
    return rec


def _kernel_group(name: str) -> str:
    """The part of the step a device kernel belongs to, by its name."""
    for key, group in (("dropout_kernel", "dropout"),
                       ("stage_kernel", "stage_plane"),
                       ("sum_rows", "aggregate_sum"), ("gemm", "gemm"),
                       ("xmma", "gemm"), ("cutlass", "gemm"),
                       ("reduce_kernel", "reduce"),
                       ("elementwise", "elementwise"),
                       ("CatArrayBatched", "elementwise")):
        if key in name:
            return group
    return "other"


def phase_profile_split(ds, dev) -> dict:
    """Where the unfused GCN step's device time goes (PERF.md section 5's
    unsplit GEMMs, elementwise passes and Adam): the Trainer as ``train``
    and as ``train_bf16`` under -profile for epochs 3-4 of 5, the trace's
    kernel events summed by kernel and by group, per step."""
    import os
    import tempfile
    rec = {"phase": "profile_split", "model": "gcn", "layers": LAYERS["gcn"],
           "window_epochs": [3, 4]}
    for name, kw in (("fp32", {}), ("bf16", {"use_bf16": True})):
        with tempfile.TemporaryDirectory(prefix="roc_prof_") as d:
            tr = _recipe_trainer(ds, dev, epochs=5, profile_dir=d,
                                 profile_epochs="3:2", **kw)
            tr.train(print_fn=_quiet)
            del tr
            with open(os.path.join(d, "trace.json")) as f:
                events = json.load(f)["traceEvents"]
        per = {}
        for ev in events:
            if ev.get("cat") == "kernel":
                per[ev["name"]] = per.get(ev["name"], 0.0) + ev["dur"]
        groups = {}
        for k, us in per.items():
            g = _kernel_group(k)
            groups[g] = groups.get(g, 0.0) + us / 2e3
        top = sorted(per.items(), key=lambda kv: -kv[1])[:12]
        rec[name] = {"device_ms_per_step": sum(per.values()) / 2e3,
                     "groups_ms_per_step": groups,
                     "top_kernels_ms_per_step": [[k[:160], us / 2e3]
                                                 for k, us in top]}
    emit(rec)
    for name in ("fp32", "bf16"):
        if not rec[name]["device_ms_per_step"] > 0:
            raise AssertionError(f"the profiler saw no device time: {rec}")
    return rec


def _small_control_trainer(dev, num_epochs, **kw):
    """GCN 8-4-3 on an 80-node synthetic graph (tests/test_fault.py's
    fixture), on the card."""
    from roc_tpu_torch.graph import datasets
    from roc_tpu_torch.models import build_gcn
    from roc_tpu_torch.train.config import Config
    from roc_tpu_torch.train.driver import Trainer
    ds = datasets.synthetic("t", 80, 3.0, 8, 3, n_train=20, n_val=20,
                            n_test=20, seed=13)
    kw.setdefault("eval_every", 10 ** 9)
    kw.setdefault("dropout_rate", 0.0)
    cfg = Config(layers=[8, 4, 3], num_epochs=num_epochs,
                 device=str(dev), **kw)
    return Trainer(cfg, ds, build_gcn(cfg.layers, cfg.dropout_rate))


def _control_nan(dev) -> dict:
    """A step.nan step is a bitwise no-op: 4 epochs with the first step's
    loss scaled by NaN equal 3 clean epochs (params, Adam m and v)."""
    from roc_tpu_torch.fault import inject
    tr_a = _small_control_trainer(dev, 4, fault="seed=3,step.nan=1")
    tr_a.train(print_fn=_quiet)
    inject.configure("")
    tr_b = _small_control_trainer(dev, 3)
    tr_b.train(print_fn=_quiet)
    same = all(torch.equal(tr_a.params[k], tr_b.params[k])
               and torch.equal(tr_a.opt_state.m[k], tr_b.opt_state.m[k])
               and torch.equal(tr_a.opt_state.v[k], tr_b.opt_state.v[k])
               for k in tr_b.params)
    return {"skipped": tr_a.nonfinite_skips, "bitwise_noop": bool(same),
            "ok": bool(same) and tr_a.nonfinite_skips == 1}


def _control_ladder(dev, tmp) -> dict:
    """The escalation ladder as tests/test_fault.py:204-233 drives it: 3
    skips turn -megafuse off (params kept), 3 more restore the checkpoint;
    without one, 6 skips leave the run at rung 2, still stepping."""
    import os
    path = os.path.join(tmp, "ladder.npz")
    tr = _small_control_trainer(dev, 4, checkpoint_path=path,
                                aggregate_backend="binned")
    tr.save_checkpoint(path)
    saved = tr.epoch
    tr.config.megafuse = True
    before = {k: v.clone() for k, v in tr.params.items()}
    tr._last_nonfinite = torch.tensor(True, device=dev)
    for _ in range(3):
        tr._check_nonfinite(1, _quiet)
    rung1 = (tr._nf_stage == 1 and tr.config.megafuse is False
             and all(torch.equal(before[k], tr.params[k]) for k in before))
    tr.epoch = 99
    for _ in range(3):
        tr._check_nonfinite(2, _quiet)
    rung2 = bool(tr._nf_stage == 2 and tr.epoch == saved)
    bare = _small_control_trainer(dev, 2)
    bare._last_nonfinite = torch.tensor(True, device=dev)
    for _ in range(6):
        bare._check_nonfinite(0, _quiet)
    bare._last_nonfinite = None
    loss = bare.train(print_fn=_quiet).final_loss
    no_ckpt = bool(bare._nf_stage == 2 and np.isfinite(loss))
    return {"rung1_unfuse": rung1, "rung2_restore": rung2,
            "rung2_without_checkpoint": no_ckpt,
            "ok": rung1 and rung2 and no_ckpt}


def _control_sigterm(tmp) -> dict:
    """SIGTERM sent to ``python -m roc_tpu_torch`` (on the card) after its
    first metric line: exit 0, and the final checkpoint holds the key."""
    import os
    import signal as _signal
    from roc_tpu_torch.train import checkpoint
    path = os.path.join(tmp, "sigterm.npz")
    proc = subprocess.Popen(
        [sys.executable, "-m", "roc_tpu_torch", "-dataset", "roc-audit",
         "-layers", "8-16-4", "-e", "100000", "-eval-every", "1", "-ckpt",
         path, "-seed", "5"], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        # the first metric line, or nothing within 300 s
        ready = select.select([proc.stdout], [], [], 300)[0]
        first = proc.stdout.readline() if ready else ""
        proc.send_signal(_signal.SIGTERM)
        out, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    meta = checkpoint._read_verified(path)[0] if os.path.exists(path) \
        else {}
    rec = {"first_line": first.strip(), "exit_code": proc.returncode,
           "said": "SIGTERM received" in out,
           "checkpoint_epoch": meta.get("epoch"),
           "rng_key": meta.get("extra", {}).get("rng_key")}
    rec["ok"] = ("[INFER][0]" in first and proc.returncode == 0
                 and rec["said"] and rec["rng_key"] == [0, 5])
    if not rec["ok"]:
        rec["stderr_tail"] = err[-2000:]
    return rec


def _control_obs(dev, tmp) -> dict:
    """-obs: trace.json passes validate_chrome_trace; one metrics record
    an epoch with roc_tpu's keys, on the card with mfu and roofline_frac
    (the peaks are the card's); the ledger pairs step_time and
    peak_memory (measured on the card)."""
    import os
    from roc_tpu_torch import obs
    from roc_tpu_torch.obs.ledger import calibration_report
    was = obs.enabled()
    d = os.path.join(tmp, "obs")
    tr = _small_control_trainer(dev, 4, obs=True, obs_dir=d, eval_every=2,
                                checkpoint_every=2,
                                checkpoint_path=os.path.join(tmp, "o.npz"))
    tr.train(print_fn=_quiet)
    obs.enable(was)
    with open(os.path.join(d, "trace.json")) as f:
        problems = obs.validate_chrome_trace(json.load(f))
    recs = obs.load_jsonl(os.path.join(d, "metrics.jsonl"))
    metrics = [r for r in recs if r["type"] == "metrics"]
    keys = {"epoch", "wall_s", "loss", "grad_norm", "param_norm",
            "wire_bytes", "edges_per_shard"}
    if dev.type == "cuda":
        keys |= {"mfu", "roofline_frac"}
    paired = calibration_report(recs)["models"]
    rec = {"trace_problems": problems,
           "span_types": sorted(obs.get_tracer().span_types()),
           "metrics_records": len(metrics),
           "keys_ok": all(set(r) == keys | {"type"} for r in metrics),
           "mfu": [r.get("mfu") for r in metrics],
           "ledger": {m: v["ratio_mean"] for m, v in paired.items()},
           "last": recs[-1]}
    rec["ok"] = problems == [] and len(metrics) == 4 and rec["keys_ok"] \
        and {"step_time", "peak_memory"} <= set(paired)
    return rec


def _control_profile(dev, tmp) -> dict:
    """-profile DIR -profile-epochs 1:2: a Chrome trace under DIR holding
    the card's kernel events (torch.profiler through CUPTI)."""
    import os
    d = os.path.join(tmp, "prof")
    lines = []
    tr = _small_control_trainer(dev, 4, profile_dir=d, profile_epochs="1:2",
                                aggregate_backend="binned")
    tr.train(print_fn=lines.append)
    with open(os.path.join(d, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    cats = {}
    for ev in events:
        cats[ev.get("cat", "")] = cats.get(ev.get("cat", ""), 0) + 1
    ours = sorted({ev["name"][:120] for ev in events
                   if ev.get("cat") == "kernel"
                   and "anonymous namespace" in ev["name"]
                   and "at::" not in ev["name"]})
    rec = {"said": any("profiler trace written" in ln for ln in lines),
           "events_by_category": cats, "device_kernel_events":
           cats.get("kernel", 0), "port_kernels_seen": ours}
    rec["ok"] = rec["said"] and rec["device_kernel_events"] > 0
    if not rec["device_kernel_events"]:
        rec["error"] = ("torch.profiler wrote a trace with no device kernel "
                        "events: the profiler cannot reach the card's "
                        "counters on this machine")
    return rec


def _control_resume(dev, tmp) -> dict:
    """Two epochs under -seed 1 and a checkpoint, two more resumed by a
    run started with -seed 2: the unbroken 4-epoch run's loss (the
    checkpoint's key decides the masks), dropout 0.5; with -seed 2's own
    masks it would be far off."""
    import os
    path = os.path.join(tmp, "resume.npz")
    kw = dict(dropout_rate=0.5, aggregate_backend="binned")
    straight = _small_control_trainer(dev, 4, seed=1, **kw)
    want = straight.train(print_fn=_quiet).final_loss
    first = _small_control_trainer(dev, 2, seed=1, checkpoint_path=path,
                                   **kw)
    first.train(print_fn=_quiet)
    resumed = _small_control_trainer(dev, 2, seed=2, **kw)
    resumed.restore(path)
    got = resumed.train(print_fn=_quiet).final_loss
    stray = _small_control_trainer(dev, 2, seed=2, **kw)
    stray.restore(path)
    stray.key = (0, 2)
    off = stray.train(print_fn=_quiet).final_loss
    rec = {"unbroken_loss": want, "resumed_loss": got,
           "rel_gap": abs(got - want) / abs(want), "tolerance": 1e-6,
           "with_seed2_masks_rel_gap": abs(off - want) / abs(want),
           "key_after_restore": list(resumed.key)}
    rec["ok"] = rec["rel_gap"] <= 1e-6 and \
        rec["with_seed2_masks_rel_gap"] > 1e-3
    return rec


def phase_run_controls(dev) -> dict:
    """The run controls on the card, on small graphs: step.nan, the ladder,
    SIGTERM to the CLI, -obs, -profile and the resume under another
    -seed; each leg's record carries its own ``ok``."""
    import tempfile
    with tempfile.TemporaryDirectory(prefix="roc_controls_") as tmp:
        rec = {"phase": "run_controls",
               "step_nan": _control_nan(dev),
               "ladder": _control_ladder(dev, tmp),
               "sigterm": _control_sigterm(tmp),
               "obs": _control_obs(dev, tmp),
               "profile": _control_profile(dev, tmp),
               "resume": _control_resume(dev, tmp)}
    emit(rec)
    bad = [k for k, v in rec.items() if isinstance(v, dict) and not v["ok"]]
    if bad:
        raise AssertionError(f"run controls failed: {bad}: {rec}")
    return rec


def phase_ab(ds, dev, epochs: int = 3) -> dict:
    """Megafuse vs unfused at full width, exact, from the same params."""
    out = {}
    for mf in (False, True):
        tr = _trainer(ds, [602, 256, 41], dev, num_epochs=epochs,
                      learning_rate=0.01, weight_decay=0.0001,
                      dropout_rate=0.0, eval_every=1000,
                      aggregate_precision="exact", megafuse=mf)
        loss = tr.train(print_fn=_quiet).final_loss
        out[mf] = (loss, tr.predict_logits())
        del tr
    rel = abs(out[True][0] - out[False][0]) / abs(out[False][0])
    rec = {"phase": "ab", "precision": "exact", "epochs": epochs,
           "unfused_loss": out[False][0], "megafuse_loss": out[True][0],
           "loss_rel_err": rel, "tolerance": 1e-3,
           "logits_row_rel_err": row_rel_err(out[True][1], out[False][1])}
    emit(rec)
    if not (np.isfinite(rel) and rel <= 1e-3):
        raise AssertionError(f"megafuse and unfused training disagree: "
                             f"{rec}")
    return rec


def _same_array_bits(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and bool(
        np.array_equal(a.view(np.uint8), b.view(np.uint8)))


def _read_back(prefix, want, lazy: bool) -> dict:
    """Read a written dataset through ``load_roc_dataset`` (what ``-file``
    calls) and hold every array against the in-memory one, bitwise."""
    from roc_tpu_torch.graph import datasets
    t0 = time.perf_counter()
    got = datasets.load_roc_dataset(prefix, want.in_dim, want.num_classes,
                                    lazy=lazy)
    read_s = time.perf_counter() - t0
    same = {"row_ptr": _same_array_bits(got.graph.row_ptr, want.graph.row_ptr),
            "col_idx": _same_array_bits(got.graph.col_idx, want.graph.col_idx),
            "features": _same_array_bits(got.features, want.features),
            "label_ids": _same_array_bits(got.label_ids, want.label_ids),
            "mask": _same_array_bits(got.mask, want.mask),
            "onehot_labels": _same_array_bits(got.onehot_labels(), want.labels)}
    rec = {"lazy": lazy, "read_s": read_s, "bitwise": same,
           "features_memmap": isinstance(got.features, np.memmap)}
    if not all(same.values()) or rec["features_memmap"] != lazy:
        raise AssertionError(f"the file read back differs: {rec}")
    return got, rec


def _write_files(ds, prefix) -> float:
    """The reference's files for ``ds`` with the port's lux writers: the
    graph, a binary-only feature file, the labels and the mask (no
    ``.feats.csv``: its text of 140 M floats would take minutes)."""
    from roc_tpu_torch.graph import lux
    t0 = time.perf_counter()
    lux.write_lux(prefix + lux.LUX_SUFFIX, ds.graph)
    lux.write_features_bin(prefix, ds.features)
    lux.write_labels(prefix, ds.label_ids)
    lux.write_mask(prefix, ds.mask)
    return time.perf_counter() - t0


def _sum_times(csr, n, dev) -> dict:
    """The sum kernel (fast, its staging included) over the CSR and its
    transpose at the unfused GCN's widths, CUDA events."""
    from roc_tpu_torch.ops.kernels.aggregate_sum import aggregate_sum
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    out = {}
    for h in (256, 41):
        x = torch.randn((n, h), generator=gen, device=dev)
        out[f"fwd_H{h}_ms"] = time_ms(
            lambda: aggregate_sum(x, csr.row_ptr, csr.col_idx, "fast"),
            reps=20, warmup=3)
        out[f"transposed_H{h}_ms"] = time_ms(
            lambda: aggregate_sum(x, csr.t_row_ptr, csr.t_col_idx, "fast"),
            reps=20, warmup=3)
    return out


def _train_file_graph(tag, ds, dev, order, **extra) -> dict:
    """GCN 602-256-41 on one graph read from a file, in the train phase's
    recipe (unfused, fast, kernel backend), with the occupancy statistic
    of -reorder auto (``padded_rows``) and the sum kernel's times."""
    from roc_tpu_torch.graph.reorder import padded_rows
    t0 = time.perf_counter()
    stat = padded_rows(ds.graph)
    stat_s = time.perf_counter() - t0
    tr = _recipe_trainer(ds, dev)
    rec = {"phase": "graph_file", "graph": tag, "order": order, **extra,
           "padded_rows": stat, "statistic_s": stat_s,
           "nodes": ds.graph.num_nodes, "edges": ds.graph.num_edges,
           "layers": LAYERS["gcn"], "precision": "fast",
           "features_memmap": isinstance(ds.features, np.memmap)}
    rec.update(_train_run(tr, dev))
    rec["sum_kernel"] = _sum_times(tr.gdata.csr, ds.graph.num_nodes, dev)
    emit(rec)
    _check_train(rec, step_launches("gcn", False))
    return rec


def _timed_reorder(ds, mode):
    """``maybe_reorder_dataset`` as the CLI calls it, with its seconds and
    those of the RCM order alone."""
    from roc_tpu_torch.graph.reorder import maybe_reorder_dataset, rcm_order
    t0 = time.perf_counter()
    rcm_order(ds.graph)
    rcm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out, applied, note = maybe_reorder_dataset(ds, mode)
    return out, applied, {"mode": mode, "note": note, "rcm_s": rcm_s,
                          "reorder_s": time.perf_counter() - t0}


def _isomorphic_losses(ds, dsr, dev, epochs: int = 3) -> dict:
    """The two orders in exact, dropout 0, from the same seeded params:
    final losses within 2e-4 relative (the graphs are isomorphic; the
    sums only reassociate)."""
    losses = []
    for d in (ds, dsr):
        tr = _trainer(d, LAYERS["gcn"], dev, num_epochs=epochs,
                      learning_rate=0.01, weight_decay=0.0001,
                      dropout_rate=0.0, eval_every=1000,
                      aggregate_precision="exact")
        losses.append(tr.train(print_fn=_quiet).final_loss)
        del tr
    rel = abs(losses[1] - losses[0]) / abs(losses[0])
    rec = {"phase": "graph_file_isomorphic", "precision": "exact",
           "epochs": epochs, "id_order_loss": losses[0],
           "rcm_order_loss": losses[1], "loss_rel_err": rel,
           "tolerance": 2e-4}
    emit(rec)
    if not (np.isfinite(rel) and rel <= 2e-4):
        raise AssertionError(f"training on the reordered graph is not "
                             f"isomorphic: {rec}")
    return rec


# docs/GOLDEN.md: name -> (layers, epochs); -lr 0.01 -decay 0.0005
# -dropout 0.5 at the default seed
GOLDEN = {"karate": ("34-16-2", 100), "davis": ("32-16-2", 100),
          "lesmis": ("77-16-5", 200)}


def _golden_run(prefix, layers, epochs, ckpt, extra=()) -> dict:
    """``python -m roc_tpu_torch -file PREFIX`` with the docs/GOLDEN.md
    recipe (``extra`` appended) and a checkpoint at the end, then the
    checkpoint's forward on the run's device: its metrics, the scored
    nodes it misses, its last metric line, its seconds and the kernel
    launches of the training run."""
    import contextlib
    import io
    from roc_tpu_torch.__main__ import main as train_main
    from roc_tpu_torch.graph import datasets
    from roc_tpu_torch.models import build_model
    from roc_tpu_torch.ops.softmax import perf_metrics
    from roc_tpu_torch.train.config import parse_args
    from roc_tpu_torch.train.frozen import load_frozen
    argv = ["-file", prefix, "-layers", layers, "-e", str(epochs), "-lr",
            "0.01", "-decay", "0.0005", "-dropout", "0.5", "-ckpt", ckpt,
            *extra]
    out, err = io.StringIO(), io.StringIO()
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = train_main(argv)
    train_s = time.perf_counter() - t0
    launches = read_launches()
    if rc != 0:
        raise AssertionError(f"{argv} exited {rc}: {err.getvalue()}")
    cfg = parse_args(argv)
    ds = datasets.load_roc_dataset(prefix, cfg.layers[0], cfg.layers[-1])
    b = load_frozen(cfg, ds, build_model(cfg.model, cfg.layers, 0.0),
                    device=cfg.device)
    logits = b.predict_logits()
    m = perf_metrics(logits, torch.as_tensor(ds.onehot_labels(),
                                             device=b.device),
                     torch.as_tensor(ds.mask, device=b.device))
    pred = logits.argmax(-1).cpu().numpy()
    scored = ds.mask != 3           # MASK_NONE: davis's event nodes
    return {"argv": argv[2:], "device": str(b.device), "train_s": train_s,
            "last_metric_line": out.getvalue().splitlines()[-1],
            "train_loss": float(m.train_loss),
            "val": [int(m.val_correct), int(m.val_all)],
            "test": [int(m.test_correct), int(m.test_all)],
            "misses": np.flatnonzero(scored & (pred != ds.label_ids))
            .tolist(), "pred": pred, "launches": launches}


def _golden(name, tmp) -> dict:
    """Convert a vendored graph with the converter CLI and train it through
    ``python -m roc_tpu_torch -file`` on the card (kernel backend, fast)
    with the docs/GOLDEN.md recipe; the pins, read from the final
    checkpoint's forward: karate test 31/32 with node 8 the sole miss,
    davis 15/16 with node 15 the sole miss, lesmis val >= 13/19, test >=
    43/48, train loss <= 1.0.  The same run on the CPU (the kernels'
    plain versions, fast; the same parameters and dropout masks, roc_tpu's
    random streams) must end within 1e-3 of the card's train loss; how
    many predictions agree is recorded."""
    import contextlib
    import io
    import os
    from roc_tpu_torch.graph.__main__ import main as convert_main
    prefix = os.path.join(tmp, name, name)
    with contextlib.redirect_stderr(io.StringIO()):
        if convert_main([name, "-o", prefix]) != 0:
            raise AssertionError(f"the converter failed on {name}")
    layers, epochs = GOLDEN[name]
    card = _golden_run(prefix, layers, epochs,
                       os.path.join(tmp, name + "_card.npz"))
    cpu = _golden_run(prefix, layers, epochs,
                      os.path.join(tmp, name + "_cpu.npz"),
                      ["-device", "cpu", "-aggr-backend", "binned"])
    rec = {"phase": "golden", "graph": name,
           **{k: v for k, v in card.items() if k != "pred"},
           "cpu": {k: cpu[k] for k in ("train_loss", "val", "test",
                                       "misses")},
           "cpu_loss_rel_err": abs(card["train_loss"] - cpu["train_loss"])
           / abs(cpu["train_loss"]),
           "cpu_predictions_equal": int((card["pred"] == cpu["pred"]).sum()),
           "nodes": int(card["pred"].size)}
    emit(rec)
    pins = {"karate": rec["test"] == [31, 32] and rec["misses"] == [8],
            "davis": rec["test"] == [15, 16] and rec["misses"] == [15],
            "lesmis": rec["val"][1] == 19 and rec["val"][0] >= 13
            and rec["test"][1] == 48 and rec["test"][0] >= 43
            and rec["train_loss"] <= 1.0}[name]
    if not pins or rec["launches"]["aggregate_sum"] == 0 \
            or rec["launches"]["dropout"] == 0:
        raise AssertionError(f"the {name} golden pins fail on the card: "
                             f"{rec}")
    if not rec["cpu_loss_rel_err"] <= 1e-3:
        raise AssertionError(f"the {name} golden run on the card and on "
                             f"the CPU disagree: {rec}")
    return rec


def phase_graph_file(ds, dev) -> dict:
    """The graph input layer on the card: Reddit written to the
    reference's files and read back (eager and -lazy) bitwise; GCN
    602-256-41 trained from the files in id order and in RCM order, on
    Reddit and on its ring-inter twin (-reorder auto must keep the order
    there); the two Reddit orders isomorphic in exact; the golden curves
    of the vendored graphs through the CLI.  Returns every kernel's
    launches over the phase's training runs."""
    import os
    import shutil
    import tempfile
    from roc_tpu_torch.graph import datasets
    total = dict.fromkeys(read_launches(), 0)

    def add(launches):
        for k, v in launches.items():
            total[k] += v

    with tempfile.TemporaryDirectory(prefix="roc_graph_file_") as tmp:
        prefix = os.path.join(tmp, "reddit", "reddit")
        os.makedirs(os.path.dirname(prefix))
        write_s = _write_files(ds, prefix)
        eager, eager_rec = _read_back(prefix, ds, lazy=False)
        _, lazy_rec = _read_back(prefix, ds, lazy=True)
        emit({"phase": "graph_file_io", "graph": "reddit",
              "bytes": {f: os.path.getsize(os.path.join(
                  os.path.dirname(prefix), f)) for f in sorted(
                      os.listdir(os.path.dirname(prefix)))},
              "write_s": write_s, "eager": eager_rec, "lazy": lazy_rec})
        shutil.rmtree(os.path.dirname(prefix))

        _, _, auto = _timed_reorder(eager, "auto")
        runs = [_train_file_graph("reddit", eager, dev, "id", auto=auto)]
        rcm, _, on = _timed_reorder(eager, "on")
        runs.append(_train_file_graph("reddit", rcm, dev, "rcm", on=on))
        iso = _isomorphic_losses(eager, rcm, dev)
        del eager, rcm

        n, deg, in_dim, classes, ntr, nva, nte = datasets._REGISTRY["reddit"]
        t0 = time.perf_counter()
        ring = datasets.synthetic("reddit-ring", n, deg, in_dim, classes,
                                  n_train=ntr, n_val=nva, n_test=nte,
                                  seed=1, inter_mode="ring")
        gen_s = time.perf_counter() - t0
        prefix = os.path.join(tmp, "ring", "ring")
        os.makedirs(os.path.dirname(prefix))
        ring_write_s = _write_files(ring, prefix)
        lazy_ring, ring_rec = _read_back(prefix, ring, lazy=True)
        emit({"phase": "graph_file_io", "graph": "reddit-ring",
              "host_gen_s": gen_s, "write_s": ring_write_s,
              "lazy": ring_rec})
        del ring
        kept, applied, auto = _timed_reorder(lazy_ring, "auto")
        if not (applied and "kept" in auto["note"]):
            raise AssertionError(f"-reorder auto did not keep the order on "
                                 f"the ring graph: {auto}")
        runs.append(_train_file_graph("reddit-ring", lazy_ring, dev, "id"))
        runs.append(_train_file_graph("reddit-ring", kept, dev, "rcm",
                                      auto=auto))
        del kept, lazy_ring
        shutil.rmtree(os.path.dirname(prefix))
        for r in runs:
            add(r["launches"])
        goldens = [_golden(name, tmp) for name in GOLDEN]
        for r in goldens:
            add(r["launches"])
    return {"launches": total, "runs": runs, "isomorphic": iso,
            "goldens": goldens}


def phase_serve(ds, dev, model_name: str = "gcn",
                n_requests: int = 120, megafuse: bool = False,
                bf16: bool = False) -> dict:
    """ServeEngine on the Reddit graph (GCN 602-256-41, or GAT 602-64-41
    with 4 heads), with -megafuse or -bf16 when asked; GCN's logits are
    also held against the plain fp32 aggregation at the same -bf16 (GAT's
    plain composition does not fit at this size)."""
    from roc_tpu_torch.models import build_model
    from roc_tpu_torch.serve import ServeEngine, max_ulp_diff, run_load
    from roc_tpu_torch.train.config import Config
    from roc_tpu_torch.train.frozen import load_frozen
    from roc_tpu_torch.train.graph_data import forward_launches
    cfg = Config(dataset="reddit", layers=LAYERS[model_name], seed=SEED,
                 aggregate_precision="fast", model=model_name, heads=4,
                 megafuse=megafuse, use_bf16=bf16)
    model = build_model(cfg.model, cfg.layers, cfg.dropout_rate,
                        heads=cfg.heads)
    per_forward = launch_dict(**forward_launches(
        model, megafuse, cfg.aggregate_precision))
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    eng = ServeEngine(cfg, ds, model, device=dev)
    try:
        eng.warmup()
        load = run_load(eng, n_requests=n_requests, qps=200.0,
                        sizes=(1, 2, 3, 5, 8, 13),
                        rng=np.random.default_rng(SEED))
        launches = read_launches()
        forwards = eng.forwards
        peak = torch.cuda.max_memory_allocated(dev)
        stats = eng.stats()

        ids = np.random.default_rng(SEED + 1).integers(
            0, ds.graph.num_nodes, 4096)
        served = eng.query(ids, timeout=600.0)
        logits = eng.bundle.predict_logits()
        ulps = max_ulp_diff(served, logits[torch.as_tensor(ids, device=dev)])
        plain_err = None
        if model_name == "gcn":
            plain_cfg = Config(dataset="reddit", layers=cfg.layers,
                               seed=SEED, aggregate_backend="xla",
                               use_bf16=bf16)
            plain = load_frozen(plain_cfg, ds, model, device=dev,
                                params=eng.bundle.params).predict_logits()
            plain_err = row_rel_err(logits, plain)
        finite = bool(torch.isfinite(logits).all())
        shape = list(logits.shape)
        x_dtype = str(eng.bundle.x.dtype).split(".")[-1]
    finally:
        eng.close()
    name = "serve_gat" if model_name == "gat" else \
        "serve_bf16" if bf16 else "serve_mega" if megafuse else "serve"
    rec = {"phase": name, "x_dtype": x_dtype,
           "model": model_name, "layers": cfg.layers, "megafuse": megafuse,
           "dataset": "reddit", "nodes": ds.graph.num_nodes,
           "edges": ds.graph.num_edges, "precision": cfg.aggregate_precision,
           "requests": load["n"], "windows": stats["windows"],
           "forwards": forwards, "dispatches": stats["dispatches"],
           "launches": launches,
           "cold_start_s": stats["cold_start"]["cold_start_s"],
           "p50_ms": load["p50_s"] * 1e3, "p99_ms": load["p99_s"] * 1e3,
           "mean_ms": load["mean_s"] * 1e3,
           "qps_offered": load["qps_offered"],
           "qps_achieved": load["qps_achieved"],
           "peak_mem_bytes": peak, "served_vs_eval_ulps": ulps,
           "vs_plain_fp32_row_rel_err": plain_err,
           "plain_tolerance": 5e-3, "logits_shape": shape,
           "finite": finite}
    emit(rec)
    want = {k: v * forwards for k, v in per_forward.items()}
    if launches != want or forwards < 1:
        raise AssertionError(f"the kernels ran {launches} times over "
                             f"{forwards} forwards; expected {want}")
    if ulps > 32 or (plain_err is not None and plain_err > 5e-3) \
            or not finite or shape != [ds.graph.num_nodes, cfg.layers[-1]] \
            or x_dtype != ("bfloat16" if bf16 else "float32"):
        raise AssertionError(f"served logits are wrong: {rec}")
    return rec


# -- the memory planner and the streaming executor ---------------------------

# gcn-chain unfused and GCN on the Reddit graph, fast, dropout 0.5
MEM_PLAN_MODELS = (("gcn-chain", [602, 256, 256, 256, 41]),
                   ("gcn", [602, 256, 41]))


def _plan_run(ds, dev, model, layers, plan, budget="", epochs=5) -> dict:
    """One planned training run: decisions, predicted and measured peak,
    ms a step (median of epochs 2 on), the losses, the parameters, and the
    kernels' launches in the run and in one more step."""
    gc.collect()
    torch.cuda.empty_cache()
    tr = _trainer(ds, layers, dev, num_epochs=epochs, learning_rate=0.01,
                  weight_decay=0.0001, dropout_rate=0.5, eval_every=10**9,
                  aggregate_precision="fast", model=model, mem_plan=plan,
                  mem_budget=budget)
    reset_launches()
    stats = tr.train(print_fn=_quiet)
    launches = read_launches()
    params = {k: v.detach().cpu() for k, v in tr.params.items()}
    reset_launches()
    tr.run_epoch()
    torch.cuda.synchronize(dev)
    per_step = read_launches()
    p = tr.mem_plan
    rec = {"plan": plan, "budget_bytes": p.budget_bytes,
           "decisions": list(p.decisions), "planner": p.planner,
           "predicted_peak_bytes": p.predicted_peak_bytes,
           "predicted_peak_with_crossing_bytes":
           p.predicted_peak_bytes + tr.mem_crossing_bytes,
           "crossing_bytes": tr.mem_crossing_bytes,
           "port_resident_bytes": tr.mem_port_bytes,
           "keep_peak_bytes": p.keep_peak_bytes,
           "remat_peak_bytes": p.remat_peak_bytes,
           "predicted_step_s": p.predicted_step_s,
           "measured_peak_bytes": max(stats.peak_hbm_bytes),
           "peak_hbm_source": stats.peak_hbm_source,
           "ms_per_step": statistics.median(stats.epoch_times[1:]) * 1e3,
           "epoch_ms": [t * 1e3 for t in stats.epoch_times],
           "final_loss": stats.final_loss, "launches": launches,
           "launches_per_step": per_step}
    del tr
    return rec, params


def phase_mem_plan(ds, dev) -> dict:
    """-mem-plan keep, remat and auto (its budget halfway between the
    plan's predicted keep and remat peaks) for gcn-chain 602-256-256-256-41
    unfused and GCN 602-256-41 on the Reddit graph, fast, dropout 0.5, 5
    epochs each: the final loss and every parameter bitwise equal to
    keep's, the measured peaks under remat and auto below keep's."""
    out = {}
    for model, layers in MEM_PLAN_MODELS:
        keep, kparams = _plan_run(ds, dev, model, layers, "keep")
        budget = str((keep["keep_peak_bytes"] + keep["remat_peak_bytes"])
                     // 2)
        runs = {"keep": keep}
        for plan, b in (("remat", ""), ("auto", budget)):
            rec, params = _plan_run(ds, dev, model, layers, plan, b)
            rec["params_differ"] = [k for k in kparams
                                    if not torch.equal(params[k],
                                                       kparams[k])]
            rec["loss_bitwise"] = rec["final_loss"] == keep["final_loss"]
            runs[plan] = rec
        rec = {"phase": "mem_plan", "model": model, "layers": layers,
               "dataset": ds.name, "precision": "fast", "dropout": 0.5,
               **runs}
        emit(rec)
        # a recompute re-runs at most one forward: its sums, stagings and
        # dropouts (train.graph_data.forward_launches counts no dropout)
        from roc_tpu_torch.models import build_model
        from roc_tpu_torch.train.graph_data import forward_launches
        fwd = launch_dict(**forward_launches(build_model(model, layers)),
                          dropout=len(layers) - 1)
        for plan in ("remat", "auto"):
            r = runs[plan]
            if r["params_differ"] or not r["loss_bitwise"]:
                raise AssertionError(f"-mem-plan {plan} is not keep's run: "
                                     f"params {r['params_differ']} differ, "
                                     f"loss {r['final_loss']} vs "
                                     f"{keep['final_loss']}")
            if not r["measured_peak_bytes"] < keep["measured_peak_bytes"]:
                raise AssertionError(f"-mem-plan {plan} peak "
                                     f"{r['measured_peak_bytes']} is not "
                                     f"below keep's "
                                     f"{keep['measured_peak_bytes']}")
            if not all(keep["launches_per_step"][k] <= v
                       <= keep["launches_per_step"][k] + fwd[k]
                       for k, v in r["launches_per_step"].items()):
                raise AssertionError(f"-mem-plan {plan} launched "
                                     f"{r['launches_per_step']} a step")
        if model == "gcn" and keep["launches_per_step"] != step_launches(
                "gcn", False):
            raise AssertionError(f"-mem-plan keep launched "
                                 f"{keep['launches_per_step']} a step")
        out[model] = runs
    return out


def _stream_config(ds, layers, dev, **kw):
    from roc_tpu_torch.train.config import Config
    base = dict(num_epochs=3, learning_rate=0.01, weight_decay=0.0001,
                dropout_rate=0.0, eval_every=10**9,
                aggregate_precision="fast", stream=True, num_parts=4,
                stream_slots=2, heads=4)
    base.update(kw)
    return Config(dataset=ds.name, layers=layers, seed=SEED,
                  device=str(dev), **base)


def _stream_trainer(ds, layers, dev, **kw):
    from roc_tpu_torch.train.driver import make_trainer
    cfg = _stream_config(ds, layers, dev, **kw)
    return make_trainer(cfg, ds, _spmd_model(cfg))


def _epochs(tr, dev, n=3) -> dict:
    """``n`` epochs from a fresh peak: each epoch's loss and synced
    seconds, the peak, and the launches in those epochs."""
    gc.collect()
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    losses, secs, stats = [], [], []
    for _ in range(n):
        t0 = time.perf_counter()
        losses.append(float(tr.run_epoch()))
        torch.cuda.synchronize(dev)
        secs.append(time.perf_counter() - t0)
        if hasattr(tr, "stream_stats"):
            stats.append(dict(tr._last_stream_stats))
    return {"losses": losses, "epoch_s": secs,
            "peak_bytes": torch.cuda.max_memory_allocated(dev),
            "launches": read_launches(), "stream": stats}


def _free() -> None:
    """Return what the trainers a phase dropped held, so the next run's
    peak counts its own tensors only."""
    gc.collect()
    torch.cuda.empty_cache()


def _rel(a, b) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def phase_stream(ds, dev) -> dict:
    """GCN 602-256-41 on the Reddit graph, -stream -parts 4 -stream-slots
    2, fast, dropout 0, 3 epochs, against the in-core trainer from the
    same seed: each epoch's loss within 1e-3 relative, the streamed peak
    below in-core's, pinned host stores with no fallback, the sum kernel
    launched by the streamed run.  Records seconds an epoch, bytes moved
    against predicted_epoch_bytes, the ring's overlap and the scatter's
    hidden share.  Then on reddit-small: -bf16-storage, -stream-spill (in a
    temporary directory the phase removes), a streamed GAT, and a served
    forward under -stream against the in-core eval."""
    import tempfile

    from roc_tpu_torch.graph import datasets
    from roc_tpu_torch.serve import ServeEngine
    from roc_tpu_torch.stream import host as stream_host
    layers = LAYERS["gcn"]
    inc = _trainer(ds, layers, dev, num_epochs=3, learning_rate=0.01,
                   weight_decay=0.0001, dropout_rate=0.0, eval_every=10**9,
                   aggregate_precision="fast")
    want = _epochs(inc, dev)
    del inc
    _free()
    stream_host.reset_stats()
    t0 = time.perf_counter()
    tr = _stream_trainer(ds, layers, dev)
    setup_s = time.perf_counter() - t0
    got = _epochs(tr, dev)
    host = stream_host.stats()
    pred = tr.predicted_epoch_xfer_bytes()
    tr.close()
    rec = {"phase": "stream", "model": "gcn", "layers": layers,
           "dataset": ds.name, "parts": 4, "slots": 2, "precision": "fast",
           "dropout": 0.0, "shard_nodes": tr._S, "shard_edges": tr._E,
           "halo_width": tr._K, "table_rows": tr._T,
           "slot_bytes": tr.slot_bytes(), "setup_s": setup_s,
           "incore": want, "streamed": got,
           "loss_rel_err": [_rel(a, b) for a, b in zip(got["losses"],
                                                      want["losses"])],
           "predicted_epoch_bytes": pred["roc_tpu"],
           "predicted_epoch_bytes_port": pred["port"],
           "host_stores": host}
    del tr
    _free()
    small = datasets.get("reddit-small", seed=SEED)
    sl = [602, 64, 41]
    legs = {}

    def leg(tr):
        out = _epochs(tr, dev)
        if hasattr(tr, "close"):
            tr.close()
        return out

    legs["fp32"] = leg(_stream_trainer(small, sl, dev))
    legs["bf16_storage"] = leg(_stream_trainer(small, sl, dev,
                                               bf16_storage=True))
    with tempfile.TemporaryDirectory(prefix="roc_spill_") as tmp:
        legs["spill"] = leg(_stream_trainer(small, sl, dev,
                                            stream_spill=tmp))
        legs["spill_files"] = len(os.listdir(tmp))
    legs["gat_incore"] = leg(_trainer(
        small, sl, dev, num_epochs=3, learning_rate=0.01,
        weight_decay=0.0001, dropout_rate=0.0, eval_every=10**9,
        aggregate_precision="fast", model="gat", heads=4))
    legs["gat"] = leg(_stream_trainer(small, sl, dev, model="gat"))
    _free()
    from roc_tpu_torch.models import build_model
    from roc_tpu_torch.train.config import Config
    from roc_tpu_torch.train.frozen import load_frozen
    # exact: fast rounds each GEMM output to bf16 once, and cuBLAS sums a
    # shard's [S, 602] product in another order than the whole graph's,
    # so one row's rounding may differ; in exact only that order differs
    scfg = dict(dataset="reddit-small", layers=sl, seed=SEED,
                aggregate_precision="exact")
    model = build_model("gcn", sl)
    oracle = load_frozen(Config(**scfg), small, model,
                         device=dev).predict_logits().cpu()
    reset_launches()
    eng = ServeEngine(Config(**scfg, stream=True, num_parts=4), small,
                      model, device=dev)
    try:
        ids = np.random.default_rng(SEED).integers(
            0, small.graph.num_nodes, 64)
        served = torch.as_tensor(eng.query(ids, timeout=300.0))
        legs["serve_launches"] = read_launches()
        legs["serve_forwards"] = eng.forwards
    finally:
        eng.close()
        eng.bundle.stream_trainer.close()
    legs["serve_row_rel_err"] = row_rel_err(served, oracle[ids])
    rec["small"] = {
        "dataset": "reddit-small", "layers": sl, **legs,
        "bf16_vs_fp32_rel_err": max(_rel(a, b) for a, b in zip(
            legs["bf16_storage"]["losses"], legs["fp32"]["losses"])),
        "spill_bitwise": legs["spill"]["losses"] == legs["fp32"]["losses"],
        "gat_rel_err": max(_rel(a, b) for a, b in zip(
            legs["gat"]["losses"], legs["gat_incore"]["losses"]))}
    emit(rec)
    sm = rec["small"]
    if not (max(rec["loss_rel_err"]) <= 1e-3
            and got["peak_bytes"] < want["peak_bytes"]
            and host["pinned_bytes"] > 0 and host["fallback_bytes"] == 0
            and got["launches"]["aggregate_sum"] > 0
            and got["launches"]["stage_plane"] > 0):
        raise AssertionError(f"the streamed Reddit run failed: {rec}")
    if not (sm["bf16_vs_fp32_rel_err"] <= 1e-3 and sm["spill_bitwise"]
            and sm["gat_rel_err"] <= 1e-3
            and legs["gat"]["launches"]["gat_forward"] > 0
            and legs["gat"]["launches"]["gat_bwd_src"] > 0
            and sm["serve_row_rel_err"] <= 1e-5
            and legs["serve_launches"]["aggregate_sum"] > 0):
        raise AssertionError(f"a reddit-small stream leg failed: {sm}")
    return rec


# -- serving deltas and the replicated fleet ---------------------------------

DELTA_BATCHES = 100
DELTA_EDGES = 32       # adds and retires a batch
DELTA_QPS = 200.0


def _delta_cfg(megafuse: bool = False):
    from roc_tpu_torch.train.config import Config
    return Config(dataset="reddit", layers=LAYERS["gcn"], seed=SEED,
                  aggregate_precision="fast", megafuse=megafuse)


def _delta_batches(ds, n_batches: int, rng) -> list:
    """``n_batches`` batches of DELTA_EDGES adds and DELTA_EDGES retires:
    up to half of each batch's retires take earlier batches' adds, the
    rest distinct base edges."""
    n = ds.graph.num_nodes
    col, dst = ds.graph.col_idx, ds.graph.dst_idx
    base = rng.choice(col.size, n_batches * DELTA_EDGES, replace=False)
    added, out = [], []
    for b in range(n_batches):
        adds = rng.integers(0, n, (DELTA_EDGES, 2))
        take = min(DELTA_EDGES // 2, len(added))
        earlier = [added.pop(int(rng.integers(0, len(added))))
                   for _ in range(take)]
        idx = base[b * DELTA_EDGES:(b + 1) * DELTA_EDGES - take]
        rets = np.concatenate([np.asarray(earlier, np.int64).reshape(-1, 2),
                               np.stack([col[idx], dst[idx]], 1)])
        added.extend(map(tuple, adds.tolist()))
        out.append((adds, rets))
    return out


class _PlainSpy:
    """Counts calls of the sum's, the staging's and the megakernel's plain
    versions while it is entered: on the card none may run."""

    def __enter__(self):
        from roc_tpu_torch.ops import aggregate as agg
        from roc_tpu_torch.ops.kernels import aggregate_linear as AL
        from roc_tpu_torch.ops.kernels import aggregate_sum as AS
        self.calls = 0
        self._saved = []
        for mod, name in ((AS, "aggregate_sum_plain"), (AS, "stage_plain"),
                          (AL, "aggregate_sum_plain"),
                          (AL, "aggregate_linear_plain"),
                          (agg, "aggregate_sum_plain")):
            fn = getattr(mod, name)

            def spy(*a, _fn=fn, **k):
                self.calls += 1
                return _fn(*a, **k)
            self._saved.append((mod, name, fn))
            setattr(mod, name, spy)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)
        return False


def _csr_is_live(eng, dev) -> bool:
    """The engine's device CSR and in-degrees are bitwise the placement of
    ``from_edges`` of its live edges."""
    from roc_tpu_torch.graph.csr import from_edges
    from roc_tpu_torch.ops import DeviceCsr
    live = eng.deltas._live_edges()
    want = DeviceCsr.from_csr(from_edges(eng.bundle.num_nodes, *live), dev,
                              transpose=False)
    g = eng.bundle.gdata
    return bool(torch.equal(g.csr.row_ptr, want.row_ptr)
                and torch.equal(g.csr.col_idx, want.col_idx)
                and torch.equal(g.in_degree,
                                torch.diff(want.row_ptr).float()))


def _rows_vs_fresh(eng, cfg, ds, model, dev) -> dict:
    """Every served row (the engine's forward under its plan lock) against
    a fresh engine's on the mutated graph with the same parameters, and
    4,096 rows through the queue against that forward."""
    import dataclasses

    from roc_tpu_torch.graph.csr import from_edges
    from roc_tpu_torch.serve import ServeEngine
    n = ds.graph.num_nodes
    with eng._plan_lock:
        got = eng.bundle.predict_logits()
    ds2 = dataclasses.replace(ds, graph=from_edges(
        n, *eng.deltas._live_edges()))
    fresh = ServeEngine(cfg, ds2, eng.model, device=dev, start_queue=False)
    try:
        same_params = all(torch.equal(fresh.bundle.params[k], v)
                          for k, v in eng.bundle.params.items())
        want = fresh.bundle.predict_logits()
        bitwise = bool(torch.equal(got, want))
    finally:
        fresh.close()
    ids = np.random.default_rng(SEED + 3).integers(0, n, 4096)
    served = eng.query(ids, timeout=600.0)
    queued = bool(np.array_equal(
        served, got[torch.as_tensor(ids, device=dev)].cpu().numpy()))
    del want
    return {"rows": n, "bitwise_vs_fresh": bitwise and same_params,
            "queued_rows_bitwise": queued}


def _pct(vals, q) -> float:
    from roc_tpu_torch.serve.loadgen import percentile
    return percentile(sorted(vals), q)


def phase_delta(ds, dev, serve: dict) -> dict:
    """ServeEngine(delta_journal=...) on the Reddit graph, GCN 602-256-41,
    fast: 100 batches of 32 adds and 32 retires under 200 QPS of open-loop
    queries; the patched CSR bitwise ``from_edges`` of the live edges and
    every served row bitwise a fresh engine's; no CSR rebuild, no kernel
    build and no new buffer on the patch path (the two col_idx buffers
    alternate); the sum and staging kernels ran, their plain versions
    never.  Then a batch past the headroom (mode "replanning", queries
    answered during the stalled replan, parity again after the swap), five
    more batches, a restart from the snapshot and journal to the same
    rows, and 20 batches under -megafuse against a fresh -megafuse
    engine.  A full host rebuild and copy of col_idx is timed once beside
    the patch."""
    import shutil
    import tempfile
    import threading
    import warnings

    from roc_tpu_torch.fault import inject
    from roc_tpu_torch.models import build_model
    from roc_tpu_torch.obs.ledger import get_ledger
    from roc_tpu_torch.ops.aggregate import csr_build_count
    from roc_tpu_torch.ops.kernels.build import build_count
    from roc_tpu_torch.serve import ServeEngine, run_load
    from roc_tpu_torch.serve.delta import HEADROOM_EDGES
    from roc_tpu_torch.train.graph_data import forward_launches
    cfg = _delta_cfg()
    model = build_model(cfg.model, cfg.layers, cfg.dropout_rate)
    n = ds.graph.num_nodes
    rng = np.random.default_rng(SEED + 13)
    batches = _delta_batches(ds, DELTA_BATCHES, rng)
    tmp = tempfile.mkdtemp(prefix="roc_delta_")
    jpath = os.path.join(tmp, "deltas.wal")
    led = get_ledger()
    ledger_recs: list = []
    rec = {"phase": "delta", "model": "gcn", "layers": cfg.layers,
           "dataset": "reddit", "nodes": n, "edges": ds.graph.num_edges,
           "precision": cfg.aggregate_precision, "batches": DELTA_BATCHES,
           "adds_per_batch": DELTA_EDGES, "retires_per_batch": DELTA_EDGES,
           "qps_offered": DELTA_QPS, "headroom_edges": HEADROOM_EDGES}
    try:
        t0 = time.perf_counter()
        eng = ServeEngine(cfg, ds, model, device=dev, delta_journal=jpath)
        rec["cold_start_s"] = round(time.perf_counter() - t0, 3)
        rec["cold_start"] = dict(eng.cold_start_stats)
        try:
            eng.warmup()
            per_forward = launch_dict(**forward_launches(
                model, False, cfg.aggregate_precision))
            builds0 = (csr_build_count(), build_count())
            ptrs, apply_ms, splits, nbytes, modes = set(), [], [], [], {}
            load: dict = {}

            def _load():
                load.update(run_load(
                    eng, n_requests=int(DELTA_QPS * 2.5), qps=DELTA_QPS,
                    sizes=(1, 2, 3, 5, 8, 13),
                    rng=np.random.default_rng(SEED)))
            led.attach(lambda kind, **f: ledger_recs.append(
                {"type": kind, **f}))
            reset_launches()
            fwd0 = eng.forwards
            with _PlainSpy() as spy, warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                th = threading.Thread(target=_load)
                th.start()
                t0 = time.perf_counter()
                for i, (a, r) in enumerate(batches):
                    delay = t0 + i * 0.02 - time.perf_counter()
                    if delay > 0:
                        time.sleep(delay)
                    s0 = time.perf_counter()
                    res = eng.apply_delta(a, r)
                    apply_ms.append((time.perf_counter() - s0) * 1e3)
                    modes[res["mode"]] = modes.get(res["mode"], 0) + 1
                    lp = eng.deltas.last_patch
                    splits.append((lp["classify_s"], lp["rewrite_s"],
                                   lp["install_s"], lp["journal_s"]))
                    nbytes.append(lp["bytes_to_device"])
                    ptrs.update(eng.deltas.buffer_ptrs())
                th.join()
                torch.cuda.synchronize(dev)
            led.detach()
            launches = read_launches()
            forwards = eng.forwards - fwd0
            patch_builds = (csr_build_count() - builds0[0],
                            build_count() - builds0[1])
            ratios = [r["ratio"] for r in ledger_recs
                      if r["type"] == "measurement"
                      and r["model"] == "delta-apply" and "ratio" in r]
            rec.update(
                modes=modes, launches=launches, forwards=forwards,
                plain_calls=spy.calls,
                patch_csr_builds=patch_builds[0],
                patch_kernel_builds=patch_builds[1],
                col_idx_buffers=len(ptrs),
                apply_ms_p50=_pct(apply_ms, 0.5),
                apply_ms_p99=_pct(apply_ms, 0.99),
                classify_ms_p50=_pct([t[0] for t in splits], 0.5) * 1e3,
                rewrite_ms_p50=_pct([t[1] for t in splits], 0.5) * 1e3,
                rewrite_ms_p99=_pct([t[1] for t in splits], 0.99) * 1e3,
                install_ms_p50=_pct([t[2] for t in splits], 0.5) * 1e3,
                install_ms_p99=_pct([t[2] for t in splits], 0.99) * 1e3,
                journal_ms_p50=_pct([t[3] for t in splits], 0.5) * 1e3,
                journal_ms_p99=_pct([t[3] for t in splits], 0.99) * 1e3,
                bytes_to_device_per_batch=int(np.mean(nbytes)),
                rows_patched=eng.delta_stats()["cells_patched"],
                served_p50_ms=load["p50_s"] * 1e3,
                served_p99_ms=load["p99_s"] * 1e3,
                qps_achieved=load["qps_achieved"],
                serve_phase_p50_ms=serve["p50_ms"],
                serve_phase_p99_ms=serve["p99_ms"],
                delta_apply_ledger_ratio_mean=(
                    float(np.mean(ratios)) if ratios else None),
                csr_is_live=_csr_is_live(eng, dev))
            rec["parity"] = _rows_vs_fresh(eng, cfg, ds, model, dev)
            # the alternative kept out: the whole live CSR rebuilt on the
            # host and copied into the idle buffer
            mgr = eng.deltas
            idle = mgr._bufs[1 - mgr._active]
            torch.cuda.synchronize(dev)
            s0 = time.perf_counter()
            rp, col = mgr._store.materialize()
            idle[1][:col.size].copy_(torch.from_numpy(col))
            idle[0].copy_(torch.from_numpy(rp))
            torch.cuda.synchronize(dev)
            rec["host_rebuild_copy_ms"] = (time.perf_counter() - s0) * 1e3
            del rp, col

            # the escalation ladder: one batch past the headroom
            # past the buffers' slack by a margin for the batch's no-ops
            slack = eng.deltas.capacity - eng.delta_stats()["live_edges"]
            big = rng.integers(0, n, (slack + 1024, 2))
            inject.configure("seed=1,slow_ms=1500,delta.replan.slow=1")
            try:
                s0 = time.perf_counter()
                res = eng.apply_delta(big, None)
                rec["replan_apply_ms"] = (time.perf_counter() - s0) * 1e3
                during = eng.query(np.arange(64), timeout=600.0)
                rec["replan_mode"] = res["mode"]
                rec["answered_during_replan"] = bool(
                    eng.delta_stats()["swaps"] == 0
                    and during.shape == (64, cfg.layers[-1]))
            finally:
                inject.configure("")
            res["ticket"].wait(600.0)
            rec["replan_total_s"] = time.perf_counter() - s0
            st = eng.delta_stats()
            rec.update(replan_swaps=st["swaps"], replan_rebuilt=st["rebuilt"],
                       capacity_after=eng.deltas.capacity,
                       replan_csr_is_live=_csr_is_live(eng, dev))
            rec["replan_parity"] = _rows_vs_fresh(eng, cfg, ds, model, dev)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                for a, r in _delta_batches(ds, 5, rng):
                    eng.apply_delta(a, r)
            with eng._plan_lock:
                before = eng.bundle.predict_logits().clone()
        finally:
            eng.close()
        t0 = time.perf_counter()
        eng = ServeEngine(cfg, ds, model, device=dev, delta_journal=jpath,
                          start_queue=False)
        try:
            rec["restart_s"] = time.perf_counter() - t0
            rec["restart_replayed"] = eng.delta_stats()["replayed"]
            rec["restart_bitwise"] = bool(torch.equal(
                eng.bundle.predict_logits(), before))
        finally:
            eng.close()
        del before

        # -megafuse: the megakernel reads the patched CSR
        mcfg = _delta_cfg(megafuse=True)
        eng = ServeEngine(mcfg, ds, model, device=dev, delta_journal="")
        try:
            eng.warmup()
            per_mega = launch_dict(**forward_launches(
                model, True, mcfg.aggregate_precision))
            reset_launches()
            fwd0 = eng.forwards
            with _PlainSpy() as spy, warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                for a, r in _delta_batches(ds, 20, rng):
                    eng.apply_delta(a, r)
                    eng.query(rng.integers(0, n, 8), timeout=600.0)
                torch.cuda.synchronize(dev)
            rec["mega_launches"] = read_launches()
            rec["mega_forwards"] = eng.forwards - fwd0
            rec["mega_plain_calls"] = spy.calls
            rec["mega_csr_is_live"] = _csr_is_live(eng, dev)
            rec["mega_parity"] = _rows_vs_fresh(eng, mcfg, ds, model, dev)
        finally:
            eng.close()
    finally:
        led.detach()
        shutil.rmtree(tmp, ignore_errors=True)
        _free()
    emit(rec)
    want = {k: v * rec["forwards"] for k, v in per_forward.items()}
    want_mega = {k: v * rec["mega_forwards"] for k, v in per_mega.items()}
    bad = []
    if rec["launches"] != want or rec["forwards"] < 1:
        bad.append(f"churn launches {rec['launches']}, expected {want}")
    if rec["mega_launches"] != want_mega:
        bad.append(f"-megafuse launches {rec['mega_launches']}, expected "
                   f"{want_mega}")
    if rec["plain_calls"] or rec["mega_plain_calls"]:
        bad.append("a plain version ran on the card")
    if rec["modes"] != {"applied": DELTA_BATCHES}:
        bad.append(f"modes {rec['modes']}")
    if rec["patch_csr_builds"] or rec["patch_kernel_builds"] \
            or rec["col_idx_buffers"] != 2:
        bad.append("the patch path rebuilt a CSR, built a kernel or "
                   "allocated a buffer")
    for key in ("csr_is_live", "replan_csr_is_live", "mega_csr_is_live",
                "answered_during_replan", "replan_rebuilt",
                "restart_bitwise"):
        if not rec[key]:
            bad.append(key)
    for key in ("parity", "replan_parity", "mega_parity"):
        if not (rec[key]["bitwise_vs_fresh"]
                and rec[key]["queued_rows_bitwise"]):
            bad.append(key)
    if rec["replan_mode"] != "replanning" or rec["replan_swaps"] != 1 \
            or rec["restart_replayed"] != 5:
        bad.append("the escalation ladder or the restart")
    if bad:
        raise AssertionError(f"delta phase: {bad}")
    return rec


def phase_fleet(ds, dev) -> dict:
    """A primary and two followers on one card over InProcTransport, GCN
    602-256-41 on Reddit: 50 batches through FleetRouter.apply_delta (each
    pumped) under 200 QPS of routed queries; every applied_seq equals the
    primary's, the three engines' forwards are bitwise equal, a late
    follower brought up by snapshot_blob / install_snapshot reaches the
    same bits, and the router sheds nothing."""
    import shutil
    import tempfile
    import threading
    import warnings

    from roc_tpu_torch.fleet import (FleetRouter, InProcTransport, Replica,
                                     ReplicationLog)
    from roc_tpu_torch.models import build_model
    from roc_tpu_torch.obs.watchdog import PerfWatchdog
    from roc_tpu_torch.serve import run_load
    from roc_tpu_torch.train.graph_data import forward_launches
    cfg = _delta_cfg()
    model = build_model(cfg.model, cfg.layers, cfg.dropout_rate)
    rng = np.random.default_rng(SEED + 17)
    batches = _delta_batches(ds, 50, rng)
    tmp = tempfile.mkdtemp(prefix="roc_fleet_")
    wd = PerfWatchdog()

    def mk(name):
        return Replica(name, cfg, ds, model, None,
                       os.path.join(tmp, f"{name}.wal"), watchdog=wd,
                       device=dev)

    router = None
    rec = {"phase": "fleet", "replicas": 3, "batches": len(batches),
           "transport": "InProcTransport", "qps_offered": DELTA_QPS}
    try:
        primary = mk("primary")
        followers = [mk("f1"), mk("f2")]
        replog = ReplicationLog(primary.engine)
        for f in followers:
            f.transport = replog.attach(InProcTransport())
        router = FleetRouter(primary, followers, replog, watchdog=wd)
        for rep in router.replicas:
            rep.engine.warmup()
        per_forward = launch_dict(**forward_launches(
            model, False, cfg.aggregate_precision))
        served0 = {r.name: r.engine.stats()["requests"]
                   for r in router.replicas}
        fwd0 = sum(r.engine.forwards for r in router.replicas)
        lags, load = [], {}

        def _load():
            load.update(run_load(router, n_requests=int(DELTA_QPS * 2),
                                 qps=DELTA_QPS, sizes=(1, 2, 3, 5, 8, 13),
                                 rng=np.random.default_rng(SEED)))
        reset_launches()
        with _PlainSpy() as spy, warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            th = threading.Thread(target=_load)
            th.start()
            t0 = time.perf_counter()
            for i, (a, r) in enumerate(batches):
                delay = t0 + i * 0.03 - time.perf_counter()
                if delay > 0:
                    time.sleep(delay)
                router.apply_delta(a, r)
                lags.append(max(f.last_lag_s for f in followers) * 1e3)
            th.join()
            torch.cuda.synchronize(dev)
        launches = read_launches()
        forwards = sum(r.engine.forwards for r in router.replicas) - fwd0
        seqs = {r.name: r.applied_seq for r in router.replicas}
        with primary.engine._plan_lock:
            want = primary.engine.bundle.predict_logits()
        bitwise = {}
        for rep in followers:
            with rep.engine._plan_lock:
                bitwise[rep.name] = bool(torch.equal(
                    rep.engine.bundle.predict_logits(), want))
        late = mk("late")
        late.catch_up(replog)
        bitwise["late"] = bool(torch.equal(
            late.engine.bundle.predict_logits(), want))
        late_seq = late.applied_seq
        late.close()
        st = router.stats()
        rec.update(
            launches=launches, forwards=forwards, plain_calls=spy.calls,
            applied_seq=seqs, late_seq=late_seq,
            bitwise_vs_primary=bitwise,
            lag_ms_p50=_pct(lags, 0.5), lag_ms_p99=_pct(lags, 0.99),
            lag_ms_max=max(lags),
            segments_shipped=st["replog"]["segments_shipped"],
            records_shipped=st["replog"]["records_shipped"],
            dispatches={r.name: r.engine.stats()["requests"] - served0[r.name]
                        for r in router.replicas},
            shed=st["shed"], sibling_retries=st["sibling_retries"],
            served_p50_ms=load["p50_s"] * 1e3,
            served_p99_ms=load["p99_s"] * 1e3,
            qps_achieved=load["qps_achieved"],
            fleet_lag_alerts=sum(1 for a in wd.alerts
                                 if a["kind"] == "fleet-lag"))
    finally:
        if router is not None:
            router.close()
        shutil.rmtree(tmp, ignore_errors=True)
        _free()
    emit(rec)
    head = rec["applied_seq"]["primary"]
    want_l = {k: v * rec["forwards"] for k, v in per_forward.items()}
    if set(rec["applied_seq"].values()) != {head} or rec["late_seq"] != head \
            or head != len(batches) or not all(rec["bitwise_vs_primary"]
                                               .values()) \
            or rec["shed"] or rec["launches"] != want_l \
            or rec["plain_calls"]:
        raise AssertionError(f"fleet phase: {rec}")
    return rec


# -- the vertex-sharded SPMD trainer -----------------------------------------

SPMD_PARTS = 4


class _SpmdSpy(_PlainSpy):
    """_PlainSpy, and the dropout's and the GAT kernels' plain versions."""

    EXTRA = (("dropout", "dropout_plain"), ("gat", "gat_score_plain"),
             ("gat", "gat_forward_plain"), ("gat", "gat_bwd_src_dq_plain"),
             ("gat", "gat_dadl_plain"), ("gat", "stage_plain"))

    def __enter__(self):
        import importlib
        super().__enter__()
        for mod_name, name in self.EXTRA:
            mod = importlib.import_module(
                f"roc_tpu_torch.ops.kernels.{mod_name}")
            fn = getattr(mod, name)

            def spy(*a, _fn=fn, **k):
                self.calls += 1
                return _fn(*a, **k)
            self._saved.append((mod, name, fn))
            setattr(mod, name, spy)
        return self


def _spmd_trainer(ds, layers, dev, devices=None, bounds=None, **kw):
    """-parts 4 on the card, fast, -lr 0.01 -decay 0.0001, dropout 0 and
    3 epochs unless ``kw`` says otherwise: through make_trainer (the CLI's
    path, the default mesh: k = 4) unless a mesh or a cut is given.
    Returns the trainer and its build seconds."""
    from roc_tpu_torch.models import build_model
    from roc_tpu_torch.parallel.spmd import SpmdTrainer
    from roc_tpu_torch.train.config import Config
    from roc_tpu_torch.train.driver import make_trainer
    base = dict(num_epochs=3, learning_rate=0.01, weight_decay=0.0001,
                dropout_rate=0.0, eval_every=10**9,
                aggregate_precision="fast", num_parts=SPMD_PARTS, heads=4)
    base.update(kw)
    cfg = Config(dataset=ds.name, layers=layers, seed=SEED,
                 device=str(dev), **base)
    model = build_model(cfg.model, layers, cfg.dropout_rate, cfg.aggr,
                        heads=cfg.heads)
    t0 = time.perf_counter()
    if devices is None and bounds is None:
        tr = make_trainer(cfg, ds, model)
    else:
        tr = SpmdTrainer(cfg, ds, model, devices=devices, bounds=bounds)
    torch.cuda.synchronize(dev)
    return tr, time.perf_counter() - t0


def _spmd_geometry(tr) -> dict:
    """The cut and the exchange of a built SPMD trainer."""
    gd = tr.gdata
    return {"k": tr.k, "exchange": gd.exchange, "wire": list(gd.xch),
            "overlap": gd.overlap, "shard_nodes": int(tr.part.shard_nodes),
            "halo_K": gd.K, "table_rows": gd.table_rows(),
            "halo_rows": (tr.halo.halo_rows_total if tr.halo is not None
                          else 0),
            "edges_per_part": [pg.edges for pg in gd.parts],
            "build_s": dict(tr.build_s), "wire_bytes": tr.wire_bytes()}


def _spmd_leg(tr, build_s, dev, n) -> dict:
    """``n`` epochs of a built trainer from a fresh peak (``_epochs``),
    with its geometry, build seconds and epoch ms."""
    out = _epochs(tr, dev, n)
    out.update(_spmd_geometry(tr), trainer_build_s=build_s,
               epoch_ms=[t * 1e3 for t in out["epoch_s"]])
    return out


def _skewed_bounds(n: int) -> np.ndarray:
    """A deliberately skewed cut of n vertices: 55 %, then 15 % each."""
    ends = [int(n * f) for f in (0.55, 0.70, 0.85)] + [n]
    lo = [0] + ends[:-1]
    return np.asarray([(a, b - 1) for a, b in zip(lo, ends)], np.int64)


def _max_rel(a, b) -> float:
    return max(_rel(x, y) for x, y in zip(a, b))


def phase_spmd(ds, dev, single5=None, single3=None, gat_single=None
               ) -> dict:
    """The vertex-sharded SPMD trainer, -parts 4 on the card.

    a. the CLI path: GCN 602-256-41, fast, dropout 0.5, 5 epochs, through
       make_trainer (the default mesh: k = 4, halo), beside the
       single-device trainer from the same seed and flags (``single5``:
       train's record, else run here);
    b. -check-sharding (rtol 1e-3, count_tol 1) at dropout 0, then 3
       epochs, each loss within 1e-3 relative of the single-device
       trainer's (``single3``: stream's in-core losses, else run here);
    c. -no-halo, and -bf16-storage with -bf16-exchange plain, compensated
       and -bf16-rounding stochastic, 3 epochs each: losses within 1e-3
       (no-halo, compensated) or 5e-2 (bf16) of b's;
    d. the k = 1 layout (mesh [cuda:0] * 4): halo overlap on and off
       within 1e-5 of each other; -balance-every 1 -e 6 from a skewed cut,
       at least one reshard, the loss within 1e-3 of the unbalanced run's;
       -perhost from reddit-small's .lux in a temporary directory the
       phase removes: CSRs, halo maps and node tensors bitwise the full
       build's, the first epoch's loss equal;
    e. GAT 602-64-41, 4 heads, -parts 4 on reddit-small, dropout 0, 3
       epochs, within 1e-3 relative of the single-device trainer's
       (``gat_single``: stream's in-core GAT losses, else run here).

    No plain version runs on the card in any leg; each leg's launches are
    counted from 0."""
    import shutil
    import tempfile

    from roc_tpu_torch.graph import datasets, lux
    from roc_tpu_torch.parallel.check import check_shard_consistency
    t_phase = time.perf_counter()
    layers = LAYERS["gcn"]
    rec = {"phase": "spmd", "dataset": ds.name, "parts": SPMD_PARTS,
           "layers": layers, "precision": "fast"}
    launches = {}
    with _SpmdSpy() as spy:
        # a. the CLI path
        if single5 is None:
            tr = _recipe_trainer(ds, dev, epochs=5)
            single5 = _train_run(tr, dev)
            del tr
            _free()
        tr, build_s = _spmd_trainer(ds, layers, dev, num_epochs=5,
                                    dropout_rate=0.5)
        a = _spmd_leg(tr, build_s, dev, 5)
        launches["spmd"] = a["launches"]
        reset_launches()
        tr.run_epoch()
        torch.cuda.synchronize(dev)
        a["launches_per_step"] = read_launches()
        a["single_device"] = {
            "epoch_ms": single5["epoch_ms"][:5],
            "peak_bytes": single5["peak_mem_bytes"]}
        rec["cli"] = a
        del tr
        _free()
        # b. -check-sharding, then the loss against one device's
        if single3 is None:
            inc = _trainer(ds, layers, dev, num_epochs=3,
                           learning_rate=0.01, weight_decay=0.0001,
                           dropout_rate=0.0, eval_every=10**9,
                           aggregate_precision="fast")
            single3 = _epochs(inc, dev)["losses"]
            del inc
            _free()
        tr, build_s = _spmd_trainer(ds, layers, dev, check_sharding=True)
        t0 = time.perf_counter()
        m1, mp = check_shard_consistency(tr.config, ds, tr.model,
                                         sharded_trainer=tr)
        check_s = time.perf_counter() - t0
        _free()
        b = _spmd_leg(tr, build_s, dev, 3)
        b.update(check_s=check_s, check={
            "single": [float(v) for v in m1], "sharded":
            [float(v) for v in mp]}, single_losses=list(single3),
            loss_rel_err=_max_rel(b["losses"], single3))
        rec["check"] = b
        launches["spmd_check"] = b["launches"]
        del tr
        _free()
        # c. the exchanges and the wire
        c = {}
        for name, kw in (
                ("allgather", {"halo": False}),
                ("bf16_plain", {"bf16_storage": True}),
                ("bf16_compensated", {"bf16_storage": True,
                                      "bf16_exchange": "compensated"}),
                ("bf16_stochastic", {"bf16_storage": True,
                                     "bf16_rounding": "stochastic"})):
            tr, build_s = _spmd_trainer(ds, layers, dev, **kw)
            c[name] = _spmd_leg(tr, build_s, dev, 3)
            c[name]["loss_rel_err"] = _max_rel(c[name]["losses"],
                                               b["losses"])
            del tr
            _free()
        from roc_tpu_torch.parallel import wire
        wire.clear_bits()
        rec["exchanges"] = c
        launches["spmd_exchanges"] = {
            k: sum(leg["launches"][k] for leg in c.values())
            for k in c["allgather"]["launches"]}
        # d. the k = 1 layout on the one card
        mesh = [dev] * SPMD_PARTS
        d = {}
        for name, kw in (("overlap", {}),
                         ("no_overlap", {"halo_overlap": False})):
            tr, build_s = _spmd_trainer(ds, layers, dev, devices=mesh, **kw)
            d[name] = _spmd_leg(tr, build_s, dev, 3)
            del tr
            _free()
        d["overlap_rel_err"] = _max_rel(d["overlap"]["losses"],
                                        d["no_overlap"]["losses"])
        skew = _skewed_bounds(ds.graph.num_nodes)
        for name, kw in (("unbalanced", {}), ("balanced",
                                              {"balance_every": 1})):
            tr, build_s = _spmd_trainer(ds, layers, dev, devices=mesh,
                                        bounds=skew, num_epochs=6,
                                        edge_shard="off", **kw)
            gc.collect()
            reset_launches()
            stats = tr.train(print_fn=_quiet)
            d[name] = {"epoch_ms": [t * 1e3 for t in stats.epoch_times],
                       "final_loss": stats.final_loss,
                       "launches": read_launches(),
                       "trainer_build_s": build_s,
                       "events": stats.rebalance_events,
                       "bounds_before": skew.tolist(),
                       "bounds_after": np.asarray(tr.part.bounds).tolist(),
                       "edges_per_part": [pg.edges
                                          for pg in tr.gdata.parts]}
            del tr
            _free()
        d["balance_loss_rel_err"] = _rel(d["balanced"]["final_loss"],
                                         d["unbalanced"]["final_loss"])
        small = datasets.get("reddit-small", seed=SEED)
        sl = [602, 64, 41]
        tmp = tempfile.mkdtemp(prefix="roc_perhost_")
        try:
            prefix = os.path.join(tmp, "reddit-small")
            lux.write_dataset(prefix, small.graph, small.features,
                              small.label_ids, small.mask)
            full, _ = _spmd_trainer(
                datasets.load_roc_dataset(prefix, 602, 41), sl, dev,
                devices=mesh, filename=prefix)
            t0 = time.perf_counter()
            per, _ = _spmd_trainer(
                datasets.load_roc_dataset(prefix, 602, 41, graph_stub=True),
                sl, dev, devices=mesh, filename=prefix, perhost_load=True)
            perhost_s = time.perf_counter() - t0
            same = (per.halo.K == full.halo.K
                    and np.array_equal(per.halo.send_idx,
                                       full.halo.send_idx)
                    and all(torch.equal(getattr(per, f), getattr(full, f))
                            for f in ("x", "labels", "mask")))
            for pa, pb in zip(per.gdata.parts, full.gdata.parts):
                for ca, cb in ((pa.csr, pb.csr), (pa.csr_local, pb.csr_local),
                               (pa.csr_remote, pb.csr_remote)):
                    same = same and (ca is None) == (cb is None)
                    if ca is not None:
                        same = same and all(
                            (x is None and y is None) or torch.equal(x, y)
                            for x, y in zip(ca, cb))
            reset_launches()
            lp, lf = float(per.run_epoch()), float(full.run_epoch())
            d["perhost"] = {"dataset": "reddit-small", "layers": sl,
                            "bitwise": bool(same), "loss": lp,
                            "full_loss": lf, "build_s": perhost_s,
                            "launches": read_launches()}
            del per, full
            _free()
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        rec["k1"] = d
        launches["spmd_k1"] = {
            k: (d["overlap"]["launches"][k] + d["no_overlap"]["launches"][k]
                + d["unbalanced"]["launches"][k]
                + d["balanced"]["launches"][k]
                + d["perhost"]["launches"][k])
            for k in d["overlap"]["launches"]}
        # e. GAT on reddit-small
        if gat_single is None:
            inc = _trainer(small, sl, dev, num_epochs=3, learning_rate=0.01,
                           weight_decay=0.0001, dropout_rate=0.0,
                           eval_every=10**9, aggregate_precision="fast",
                           model="gat", heads=4)
            gat_single = _epochs(inc, dev)["losses"]
            del inc
            _free()
        tr, build_s = _spmd_trainer(small, sl, dev, model="gat")
        e = _spmd_leg(tr, build_s, dev, 3)
        e.update(dataset="reddit-small", layers=sl, heads=4,
                 single_losses=list(gat_single),
                 loss_rel_err=_max_rel(e["losses"], gat_single))
        rec["gat"] = e
        launches["spmd_gat"] = e["launches"]
        del tr
        _free()
    rec["plain_calls"] = spy.calls
    rec["launches"] = launches
    rec["phase_s"] = time.perf_counter() - t_phase
    emit(rec)
    P = SPMD_PARTS
    want_step = launch_dict(aggregate_sum=4 * P, stage_plane=4 * P,
                            dropout=3)
    bal = d["balanced"]
    fails = []
    if spy.calls:
        fails.append(f"{spy.calls} plain-version calls on the card")
    if a["launches_per_step"] != want_step or a["k"] != P:
        fails.append(f"the CLI step launched {a['launches_per_step']}")
    if not all(np.isfinite(v) for v in a["losses"]):
        fails.append(f"the CLI path's losses {a['losses']}")
    if b["loss_rel_err"] > 1e-3:
        fails.append(f"sharded vs one device {b['loss_rel_err']}")
    if c["allgather"]["loss_rel_err"] > 1e-3 \
            or c["bf16_compensated"]["loss_rel_err"] > 1e-3 \
            or c["bf16_plain"]["loss_rel_err"] > 5e-2 \
            or c["bf16_stochastic"]["loss_rel_err"] > 5e-2:
        fails.append("an exchange leg left its bound: " + str(
            {k: v["loss_rel_err"] for k, v in c.items()}))
    if d["overlap_rel_err"] > 1e-5 or not d["overlap"]["overlap"]:
        fails.append(f"overlap on vs off {d['overlap_rel_err']}")
    if not any(ev["action"] == "reshard" for ev in bal["events"]) \
            or d["balance_loss_rel_err"] > 1e-3:
        fails.append(f"the balancer: {bal['events']}, "
                     f"{d['balance_loss_rel_err']}")
    if not (d["perhost"]["bitwise"]
            and d["perhost"]["loss"] == d["perhost"]["full_loss"]):
        fails.append(f"-perhost: {d['perhost']}")
    if e["loss_rel_err"] > 1e-3 or e["launches"]["gat_forward"] == 0:
        fails.append(f"the sharded GAT: {e['loss_rel_err']}")
    if fails:
        raise AssertionError("phase spmd failed: " + "; ".join(fails))
    return rec


def _retrain(tr, dropout: float) -> None:
    """A built SPMD trainer back to its init at another dropout rate: the
    model rebuilt, params, Adam state, rate and epoch reset; its graph
    data and node tensors kept (the build is the expensive part)."""
    import dataclasses

    from roc_tpu_torch.models import build_model
    cfg = tr.config = dataclasses.replace(tr.config, dropout_rate=dropout)
    tr.model = build_model(cfg.model, cfg.layers, dropout, cfg.aggr,
                           heads=cfg.heads)
    tr.params = tr.model.init_params(tr.key, device=tr.device)
    tr.opt_state = tr.optimizer.init(tr.params)
    tr.optimizer.alpha = cfg.learning_rate
    tr.epoch = 0
    tr._resolve_mem_plan()
    tr._loss = tr._loss_fn()


def _mode_geometry(tr) -> dict:
    """The ring's groups or the edge cut's blocks of a built trainer."""
    from roc_tpu_torch.parallel.spmd import padded_max_tax
    gd = tr.gdata
    out = {"mode": gd.mode, "build_s": dict(tr.build_s),
           "wire_bytes": tr.wire_bytes(),
           "shard_nodes": int(tr.part.shard_nodes),
           "padded_max_tax": float(padded_max_tax(tr.part))}
    if gd.mode == "ring":
        sizes = [int(c.col_idx.numel()) if c is not None else 0
                 for row in gd.ring for c in row]
        out.update(group_edges=sizes, groups=sum(1 for v in sizes if v),
                   ring_width=int(tr.ring_maps.ring_src.shape[-1]))
    elif gd.mode == "edge":
        eb = gd.edge
        out.update(block_edges=eb.block_edges, span_fwd=eb.span_fwd,
                   span_bwd=eb.span_bwd, edge_tax=tr.edge_tax(),
                   fwd_base=[int(b) for b in eb.fwd_base],
                   bwd_base=[int(b) for b in eb.bwd_base])
    return out


def _mode_leg(ds, layers, dev, mesh, n, **kw) -> tuple:
    """Build one SPMD trainer on the mesh and run ``n`` epochs: (trainer,
    the leg's record with its geometry and per-step launches)."""
    tr, build_s = _spmd_trainer(ds, layers, dev, devices=mesh, **kw)
    leg = _epochs(tr, dev, n)
    leg.update(_mode_geometry(tr), trainer_build_s=build_s,
               epoch_ms=[t * 1e3 for t in leg["epoch_s"]])
    return tr, leg


def _step_launches(tr, dev) -> dict:
    reset_launches()
    tr.run_epoch()
    torch.cuda.synchronize(dev)
    return read_launches()


def _hub_dataset(n: int, layers):
    """roc_tpu's hub recipe (tests/test_edge_shard.py:24) at n vertices:
    3n random edges and one hub with 12n in-edges (3x E/P at P = 4), self
    edges added; Gaussian features and random labels, half train."""
    from roc_tpu_torch.graph.csr import add_self_edges, from_edges
    from roc_tpu_torch.graph.datasets import Dataset
    from roc_tpu_torch.graph.lux import one_hot
    rng = np.random.default_rng(SEED)
    s = rng.integers(0, n, size=3 * n)
    d = rng.integers(0, n, size=3 * n)
    s = np.concatenate([s, rng.integers(0, n, size=12 * n)])
    d = np.concatenate([d, np.zeros(12 * n, np.int64)])
    keep = s != d
    g = add_self_edges(from_edges(n, s[keep], d[keep]))
    lab = rng.integers(0, layers[-1], size=n)
    mask = np.where(rng.random(n) < 0.5, 1, 2).astype(np.int32)
    feats = rng.standard_normal((n, layers[0]), dtype=np.float32)
    return Dataset("hub", g, feats, one_hot(lab, layers[-1]), lab, mask,
                   layers[0], layers[-1])


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _multihost_child(argv_json: str, out: str) -> None:
    """One -multihost process: the CLI's main under the plain spy; its
    exit code, kernel launches and collectives go to ``out``."""
    from roc_tpu_torch.__main__ import main as cli
    from roc_tpu_torch.parallel import collectives
    reset_launches()
    with _SpmdSpy() as spy:
        rc = cli(json.loads(argv_json))
    with open(out, "w") as f:
        json.dump({"rc": rc, "launches": read_launches(),
                   "collectives": collectives.launches(),
                   "plain_calls": spy.calls}, f)


def _multihost_run(argv, tmp) -> dict:
    """The CLI as a world of one (torchrun's variables, a free port) in a
    subprocess; a non-zero exit fails the phase."""
    out = os.path.join(tmp, "child.json")
    env = dict(os.environ, RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()))
    t0 = time.perf_counter()
    p = subprocess.run(
        [sys.executable, "-c", "import sys, chip_smoke as c; "
         "c._multihost_child(sys.argv[1], sys.argv[2])", json.dumps(argv),
         out], cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
        capture_output=True, text=True, timeout=600)
    if p.returncode != 0:
        raise AssertionError(f"the -multihost child exited "
                             f"{p.returncode}: {p.stderr[-3000:]}")
    with open(out) as f:
        rec = json.load(f)
    rec["wall_s"] = time.perf_counter() - t0
    rec["stderr_tail"] = p.stderr.splitlines()[-4:]
    return rec


def _add_launches(*legs) -> dict:
    return {k: sum(leg[k] for leg in legs) for k in legs[0]}


def phase_spmd_modes(ds, dev, single3=None) -> dict:
    """The ring exchange, edge sharding, per-host edge blocks and ring
    groups, the streamed graph stub with its reshard, and -multihost as a
    world of one over NCCL (legs a-f of the module docstring).  Each leg's
    launches are counted from 0; no plain version runs on the card."""
    import shutil
    import tempfile

    from roc_tpu_torch.graph import datasets, lux
    from roc_tpu_torch.stream.executor import StreamTrainer
    from roc_tpu_torch.train import checkpoint
    t_phase = time.perf_counter()
    layers, sl = LAYERS["gcn"], [602, 64, 41]
    mesh = [dev] * SPMD_PARTS
    rec = {"phase": "spmd_modes", "dataset": ds.name, "parts": SPMD_PARTS,
           "layers": layers, "precision": "fast", "mesh": "k=1"}
    small = datasets.get("reddit-small", seed=SEED)
    if single3 is None:
        inc = _trainer(ds, layers, dev, num_epochs=3, learning_rate=0.01,
                       weight_decay=0.0001, dropout_rate=0.0,
                       eval_every=10**9, aggregate_precision="fast")
        single3 = _epochs(inc, dev)["losses"]
        del inc
        _free()
    # ring and edge attention are plain fp32 (roc_tpu's are XLA): the
    # single-device reference runs the GAT kernels in exact
    gat_single = _epochs(_trainer(
        small, sl, dev, num_epochs=3, learning_rate=0.01,
        weight_decay=0.0001, dropout_rate=0.0, eval_every=10**9,
        aggregate_precision="exact", model="gat", heads=4), dev)["losses"]
    _free()
    sage_single = _epochs(_trainer(
        small, sl, dev, num_epochs=3, learning_rate=0.01,
        weight_decay=0.0001, dropout_rate=0.0, eval_every=10**9,
        aggregate_precision="fast", model="sage", aggr="max"), dev)["losses"]
    _free()
    launches = {}
    with _SpmdSpy() as spy:
        # a, b: ring and edge, GCN at full width
        for name, kw in (("ring", {"exchange": "ring"}),
                         ("edge", {"edge_shard": "on"})):
            tr, leg = _mode_leg(ds, layers, dev, mesh, 5, num_epochs=5,
                                dropout_rate=0.5, **kw)
            leg["launches_per_step"] = _step_launches(tr, dev)
            _retrain(tr, 0.0)
            d0 = _epochs(tr, dev, 3)
            leg["dropout0"] = {"losses": d0["losses"],
                               "epoch_ms": [t * 1e3 for t in d0["epoch_s"]],
                               "single_losses": list(single3),
                               "loss_rel_err": _max_rel(d0["losses"],
                                                        single3)}
            leg["launches"] = _add_launches(leg["launches"], d0["launches"])
            rec[name] = leg
            del tr
            _free()
        # a: SAGE max on reddit-small under the ring
        tr, sage = _mode_leg(small, sl, dev, mesh, 3, exchange="ring",
                             model="sage", aggr="max")
        sage.update(dataset="reddit-small", layers=sl, single_losses=list(
            sage_single), loss_rel_err=_max_rel(sage["losses"], sage_single))
        rec["ring_sage_max"] = sage
        del tr
        # b: the hub graph, auto against off
        hub = _hub_dataset(ds.graph.num_nodes, layers)
        t0 = time.perf_counter()
        hub_rec = {"nodes": hub.graph.num_nodes,
                   "edges": hub.graph.num_edges}
        for name, mode in (("auto", "auto"), ("off", "off")):
            tr, leg = _mode_leg(hub, layers, dev, mesh, 2, edge_shard=mode,
                                num_epochs=2)
            hub_rec[name] = leg
            del tr
            _free()
        hub_rec.update(build_and_run_s=time.perf_counter() - t0,
                       loss_rel_err=_max_rel(hub_rec["auto"]["losses"],
                                             hub_rec["off"]["losses"]))
        rec["hub"] = hub_rec
        del hub
        _free()
        # c: GAT on reddit-small, ring then edge
        gat = {}
        for name, kw in (("ring", {"exchange": "ring"}),
                         ("edge", {"edge_shard": "on"})):
            tr, leg = _mode_leg(small, sl, dev, mesh, 3, model="gat",
                                aggregate_precision="exact", **kw)
            leg["loss_rel_err"] = _max_rel(leg["losses"], gat_single)
            gat[name] = leg
            del tr
            _free()
        rec["gat"] = dict(gat, dataset="reddit-small", layers=sl, heads=4,
                          precision="exact",
                          single_losses=list(gat_single))
        # d: the bf16 wire under the ring
        tr, bf = _mode_leg(ds, layers, dev, mesh, 3, exchange="ring",
                           bf16_storage=True)
        bf["loss_rel_err"] = _max_rel(bf["losses"],
                                      rec["ring"]["dropout0"]["losses"])
        bf["wire"] = list(tr.gdata.xch)
        rec["ring_bf16"] = bf
        del tr
        _free()
        from roc_tpu_torch.parallel import wire
        wire.clear_bits()
        # e: per-host loading and the streamed stub
        tmp = tempfile.mkdtemp(prefix="roc_modes_")
        try:
            prefix = os.path.join(tmp, "reddit-small")
            lux.write_dataset(prefix, small.graph, small.features,
                              small.label_ids, small.mask)
            lux.write_transpose(prefix, small.graph)
            full_ds = datasets.load_roc_dataset(prefix, 602, 41)
            stub_ds = datasets.load_roc_dataset(prefix, 602, 41,
                                                graph_stub=True)
            e = {}
            for name, kw in (("edge", {"edge_shard": "on"}),
                             ("ring", {"exchange": "ring"})):
                full, _ = _spmd_trainer(full_ds, sl, dev, devices=mesh,
                                        filename=prefix, **kw)
                t0 = time.perf_counter()
                per, _ = _spmd_trainer(stub_ds, sl, dev, devices=mesh,
                                       filename=prefix, perhost_load=True,
                                       **kw)
                e[name] = {"perhost_build_s": time.perf_counter() - t0,
                           "bitwise": _same_mode_build(per, full)}
                reset_launches()
                e[name].update(loss=float(per.run_epoch()),
                               full_loss=float(full.run_epoch()),
                               launches=read_launches())
                del per, full
                _free()
            streams = {}
            for name, data in (("stub", stub_ds), ("full", full_ds)):
                st = _stream_trainer(data, sl, dev, filename=prefix,
                                     perhost_load=name == "stub")
                streams[name] = _epochs(st, dev, 3)
                st.close()
                del st
                _free()
            e["stub"] = {"losses": streams["stub"]["losses"],
                         "full_losses": streams["full"]["losses"],
                         "epoch_ms": [t * 1e3 for t in
                                      streams["stub"]["epoch_s"]],
                         "launches": _add_launches(
                             streams["stub"]["launches"],
                             streams["full"]["launches"])}
            skew = _skewed_bounds(small.graph.num_nodes)
            bal = {}
            for name, every in (("unbalanced", 0), ("balanced", 1)):
                cfg = _stream_config(small, sl, dev, num_epochs=3,
                                     balance_every=every)
                st = StreamTrainer(cfg, small, _spmd_model(cfg),
                                   bounds=skew)
                reset_launches()
                stats = st.train(print_fn=_quiet)
                bal[name] = {"final_loss": stats.final_loss,
                             "epoch_ms": [t * 1e3 for t in
                                          stats.epoch_times],
                             "events": stats.rebalance_events,
                             "bounds_after": np.asarray(
                                 st.part.bounds).tolist(),
                             "launches": read_launches()}
                st.close()
                del st
                _free()
            bal["reshard_s"] = [ev.get("reshard_cost_s") for ev in
                                bal["balanced"]["events"]
                                if ev["action"] == "reshard"]
            bal["loss_rel_err"] = _rel(bal["balanced"]["final_loss"],
                                       bal["unbalanced"]["final_loss"])
            e["stream_balance"] = bal
            rec["perhost"] = e
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        # f: -multihost, a world of one over NCCL
        tmp = tempfile.mkdtemp(prefix="roc_multihost_")
        try:
            f = {}
            for name, extra in (("halo", []), ("ring", ["-exchange",
                                                        "ring"])):
                d = os.path.join(tmp, name)
                argv = ["-dataset", "reddit-small", "-layers", "602-64-41",
                        "-e", "3", "-parts", str(SPMD_PARTS), "-lr", "0.01",
                        "-decay", "0.0001", "-dropout", "0",
                        "-aggr-precision", "fast", "-seed", str(SEED),
                        "-eval-every", "1000", "-multihost", "-v", "-obs",
                        "-obs-dir", d, "-ckpt", os.path.join(d, "ck.npz"),
                        *extra]
                child = _multihost_run(argv, tmp)
                ref, _ = _spmd_trainer(small, sl, dev, devices=mesh,
                                       **({"exchange": "ring"} if extra
                                          else {}))
                single = _epochs(ref, dev, 3)
                want = single["losses"]
                with open(os.path.join(d, "metrics.jsonl")) as fh:
                    recs = [r for r in map(json.loads, fh)
                            if r.get("type") == "metrics"]
                got = [r["loss"] for r in recs]
                params, _, epoch, _, _ = checkpoint.load(
                    os.path.join(d, "ck.npz"), ref.params, ref.opt_state)
                # the child's synced epoch seconds (its -obs records)
                # beside the single-process trainer's
                child.update(epoch_ms=[r["wall_s"] * 1e3 for r in recs],
                             single_epoch_ms=[t * 1e3 for t in
                                              single["epoch_s"]])
                child.update(losses=got, single_losses=want,
                             loss_rel_err=_max_rel(got, want),
                             ckpt_epoch=epoch, ckpt_rel_err=max(
                                 float(((params[k] - ref.params[k]).abs()
                                        .max() / ref.params[k].abs().max()))
                                 for k in ref.params))
                f[name] = child
                del ref
                _free()
            rec["multihost"] = f
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    launches["spmd_ring"] = _add_launches(
        rec["ring"]["launches"], sage["launches"], gat["ring"]["launches"],
        bf["launches"], e["ring"]["launches"])
    launches["spmd_edge"] = _add_launches(
        rec["edge"]["launches"], hub_rec["auto"]["launches"],
        hub_rec["off"]["launches"], gat["edge"]["launches"],
        e["edge"]["launches"])
    launches["spmd_stub"] = _add_launches(
        e["stub"]["launches"], bal["unbalanced"]["launches"],
        bal["balanced"]["launches"])
    launches["spmd_multihost"] = _add_launches(
        f["halo"]["launches"], f["ring"]["launches"])
    rec["plain_calls"] = spy.calls + sum(c["plain_calls"]
                                         for c in f.values())
    rec["launches"] = launches
    rec["phase_s"] = time.perf_counter() - t_phase
    emit(rec)
    fails = []
    if rec["plain_calls"]:
        fails.append(f"{rec['plain_calls']} plain-version calls on the card")
    for name in ("ring", "edge"):
        leg = rec[name]
        n = leg["groups"] if name == "ring" else SPMD_PARTS
        # one dropout mask a mesh position: 4 positions at k = 1
        want_step = launch_dict(aggregate_sum=4 * n, stage_plane=4 * n,
                                dropout=3 * SPMD_PARTS)
        if leg["launches_per_step"] != want_step:
            fails.append(f"{name} step launched {leg['launches_per_step']}")
        if leg["dropout0"]["loss_rel_err"] > 1e-3:
            fails.append(f"{name} vs one device "
                         f"{leg['dropout0']['loss_rel_err']}")
    if sage["loss_rel_err"] > 1e-3:
        fails.append(f"ring SAGE max {sage['loss_rel_err']}")
    if hub_rec["auto"]["mode"] != "edge" or hub_rec["off"]["mode"] != \
            "vertex" or hub_rec["loss_rel_err"] > 1e-3:
        fails.append(f"hub auto: {hub_rec['auto']['mode']}, "
                     f"{hub_rec['loss_rel_err']}")
    for name, leg in gat.items():
        if leg["loss_rel_err"] > 1e-3:
            fails.append(f"{name} GAT {leg['loss_rel_err']}")
    if bf["loss_rel_err"] > 5e-2:
        fails.append(f"ring bf16 wire {bf['loss_rel_err']}")
    for name in ("edge", "ring"):
        if not (e[name]["bitwise"] and e[name]["loss"] ==
                e[name]["full_loss"]):
            fails.append(f"-perhost {name}: {e[name]}")
    if e["stub"]["losses"] != e["stub"]["full_losses"]:
        fails.append(f"the streamed stub: {e['stub']}")
    if not bal["reshard_s"] or bal["loss_rel_err"] > 1e-3:
        fails.append(f"the streamed balancer: {bal['balanced']['events']}, "
                     f"{bal['loss_rel_err']}")
    for name, child in f.items():
        nccl = {k: v for k, v in child["collectives"].items()
                if k.startswith("nccl:")}
        hop = "nccl:ring_hop" if name == "ring" else "nccl:all_to_all"
        if not nccl.get(hop) or not nccl.get("nccl:all_reduce_sum"):
            fails.append(f"-multihost {name} collectives {nccl}")
        if child["loss_rel_err"] > 1e-5 or child["ckpt_rel_err"] > 1e-5 \
                or child["ckpt_epoch"] != 3:
            fails.append(f"-multihost {name}: {child['loss_rel_err']}, "
                         f"{child['ckpt_rel_err']}, {child['ckpt_epoch']}")
    if fails:
        raise AssertionError("phase spmd_modes failed: " + "; ".join(fails))
    return rec


def _spmd_model(cfg):
    from roc_tpu_torch.models import build_model
    return build_model(cfg.model, cfg.layers, cfg.dropout_rate, cfg.aggr,
                       heads=cfg.heads)


def _same_csrs(a, b) -> bool:
    if (a is None) != (b is None):
        return False
    return a is None or all((x is None and y is None) or torch.equal(x, y)
                            for x, y in zip(a, b))


def _same_mode_build(per, full) -> bool:
    """A -perhost trainer's blocks and windows (edge) or groups (ring),
    and its node tensors, bitwise the full build's."""
    same = all(torch.equal(getattr(per, t), getattr(full, t))
               for t in ("x", "labels", "mask"))
    same = same and torch.equal(per.gdata.in_degree, full.gdata.in_degree)
    if per.gdata.mode == "edge":
        a, b = per.gdata.edge, full.gdata.edge
        same = same and (a.span_fwd, a.span_bwd) == (b.span_fwd,
                                                     b.span_bwd)
        same = same and np.array_equal(a.fwd_base, b.fwd_base) and \
            np.array_equal(a.bwd_base, b.bwd_base)
        return same and all(_same_csrs(x, y) for x, y in
                            zip(a.fwd + a.bwd, b.fwd + b.bwd))
    same = same and all(np.array_equal(getattr(per.ring_maps, t),
                                       getattr(full.ring_maps, t))
                        for t in ("ring_src", "ring_dst"))
    return same and all(_same_csrs(x, y)
                        for ra, rb in zip(per.gdata.ring, full.gdata.ring)
                        for x, y in zip(ra, rb))


TUNE_SUM = ((256, "fast"), (256, "exact"), (41, "fast"))
TUNE_GAT = ((4, 64), (1, 41))
# kill switch -> (model, layers, trainer settings, kernels it turns off,
# kernels that must still run); GAT at 4 heads of 32: the plain attention
# gathers [E, K, F] and refuses 4 x 64 on reddit-small (ops/edge.py)
SWITCHES = {
    "ROC_NO_MEGAFUSE=1": ("gcn", [602, 256, 41], {"megafuse": True},
                          ("aggregate_linear", "aggregate_linear_bwd",
                           "stage_cotangent"), ("aggregate_sum",)),
    "ROC_MEGA_BWD=0": ("gcn", [602, 256, 41], {"megafuse": True},
                       ("aggregate_linear_bwd", "stage_cotangent"),
                       ("aggregate_linear", "aggregate_sum")),
    "ROC_XLAYER=0": ("gcn-chain", [602, 256, 256, 256, 41],
                     {"megafuse": True, "fusion_depth": 0},
                     ("xlayer_fwd", "xlayer_bwd"),
                     ("aggregate_linear", "aggregate_linear_bwd")),
    "ROC_NO_GATFUSE=1": ("gat", [602, 32, 41], {},
                         ("gat_score", "gat_stage", "gat_forward",
                          "gat_bwd_dst", "gat_bwd_src"), ()),
    "ROC_GAT_BWD=0": ("gat", [602, 32, 41], {},
                      ("gat_bwd_dst", "gat_bwd_src"),
                      ("gat_score", "gat_forward")),
}


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


def _tune_sum_candidates(csr, n, dev) -> list:
    """Every candidate of the sum's lattice, over the CSR and its
    transpose, at TUNE_SUM: bitwise the default launch on Gaussian data,
    bitwise the plain version on {0,1} data, timed beside the default."""
    from roc_tpu_torch.ops.kernels import aggregate_sum as KS
    from roc_tpu_torch.tune.lattice import candidate_lattice, default_config
    gen = torch.Generator(device=dev).manual_seed(SEED)
    out = []
    for h, prec in TUNE_SUM:
        x = torch.randn((n, h), generator=gen, device=dev)
        xi = torch.randint(0, 2, (n, h), generator=gen,
                           device=dev).to(torch.float32)
        base = default_config("sum", (h,), prec)
        for d, rp, ci in (("fwd", csr.row_ptr, csr.col_idx),
                          ("transposed", csr.t_row_ptr, csr.t_col_idx)):
            want = KS.aggregate_sum(x, rp, ci, prec)
            want_i = KS.aggregate_sum_plain(xi, rp, ci, prec)
            base_ms = time_ms(lambda: KS.aggregate_sum(x, rp, ci, prec),
                              reps=10, warmup=2)
            for cfg in candidate_lattice("sum", (h,), prec):
                got = KS.aggregate_sum(x, rp, ci, prec, cfg.launch)
                row = {"H": h, "precision": prec, "csr": d,
                       "launch": list(cfg.launch),
                       "default": cfg.launch == base.launch,
                       "gauss_bitwise_default": bool(torch.equal(
                           _bits(got), _bits(want))),
                       "int_bitwise_plain": bool(torch.equal(
                           KS.aggregate_sum(xi, rp, ci, prec, cfg.launch),
                           want_i)),
                       "ms": time_ms(lambda c=cfg: KS.aggregate_sum(
                           x, rp, ci, prec, c.launch), reps=10, warmup=2),
                       "default_ms": base_ms}
                out.append(row)
            del want, want_i
        del x, xi
    return out


def _tune_gat_candidates(csr, n, dev) -> list:
    """Every lane-group pair of the GAT forward's lattice at TUNE_GAT,
    fast: out, m and z bitwise the default launch on Gaussian data and the
    plain version on the integer fixture, timed beside the default."""
    from roc_tpu_torch.ops.kernels import gat as G
    from roc_tpu_torch.tune.lattice import candidate_lattice, default_config
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    out = []
    for k, f in TUNE_GAT:
        g = _gat_inputs(n, k, f, gen, dev)
        gi = _gat_inputs(n, k, f, gen, dev, integer=True)

        def call(i, pair):
            return G.gat_forward(i["x"], i["as_"], i["ad"], csr.row_ptr,
                                 csr.col_idx, 0.2, "fast",
                                 None if pair is None else (pair,))
        want = call(g, None)
        want_i = G.gat_forward_plain(gi["x"], gi["as_"], gi["ad"],
                                     csr.row_ptr, csr.col_idx, 0.2, "fast")
        base = default_config("gat", (k, f), "fast")
        base_ms = time_ms(lambda: call(g, None), reps=10, warmup=2)
        for cfg in candidate_lattice("gat", (k, f), "fast"):
            pair = tuple(cfg.launch)
            got, got_i = call(g, pair), call(gi, pair)
            out.append({
                "K": k, "F": f, "precision": "fast", "launch": list(pair),
                "default": pair == base.launch,
                "gauss_bitwise_default": all(
                    bool(torch.equal(_bits(a), _bits(b)))
                    for a, b in zip(got, want)),
                "int_bitwise_plain": all(
                    bool(torch.equal(a, b)) for a, b in zip(got_i, want_i)),
                "ms": time_ms(lambda p=pair: call(g, p), reps=10, warmup=2),
                "default_ms": base_ms})
        del g, gi, want, want_i
    return out


def _switch_step(ds, dev, switch: str) -> dict:
    """One training step under a kill switch (its variable set for the
    trainer's life): the kernels it turns off launch none, the ones that
    stay launch, the loss is finite."""
    var, value = switch.split("=")
    model, layers, extra, off, on = SWITCHES[switch]
    os.environ[var] = value
    try:
        tr = _trainer(ds, layers, dev, num_epochs=1, learning_rate=0.01,
                      weight_decay=0.0001, dropout_rate=0.0,
                      eval_every=1000, aggregate_precision="fast",
                      model=model, heads=4, **extra)
        reset_launches()
        loss = float(tr.run_epoch())
        torch.cuda.synchronize(dev)
        launches = read_launches()
    finally:
        os.environ.pop(var, None)
    ok = (np.isfinite(loss) and all(launches[k] == 0 for k in off)
          and all(launches[k] > 0 for k in on))
    return {"switch": switch, "model": model, "layers": layers,
            "loss": loss, "launches": launches, "off": list(off),
            "on": list(on), "ok": bool(ok)}


def phase_tune(ds, dev) -> dict:
    """The autotuner on the card (roc_tpu_torch/tune): (a) every sum and
    GAT forward candidate against the default launch and the plain
    version, timed; (b) ``autotune_graph`` over Reddit's CSR and its
    transpose into a temporary store; (c) GCN 602-256-41, fast, dropout
    0.5, 3 epochs, with -autotune and without, losses bitwise equal; (d)
    the refit rates with the card's name and power limit; (e) one step
    under each kill switch on reddit-small."""
    import tempfile
    from roc_tpu_torch.graph import datasets
    from roc_tpu_torch.ops import DeviceCsr
    from roc_tpu_torch.ops.kernels import aggregate_sum as KS
    from roc_tpu_torch.tune import refit, search, store
    t0 = time.perf_counter()
    g = ds.graph
    n = g.num_nodes
    csr = DeviceCsr.from_csr(g, dev)
    rec = {"phase": "tune", "dataset": ds.name, "nodes": n,
           "edges": g.num_edges, "leg_s": {}}
    rec["sum_candidates"] = _tune_sum_candidates(csr, n, dev)
    rec["gat_candidates"] = _tune_gat_candidates(csr, n, dev)
    rec["leg_s"]["candidates"] = time.perf_counter() - t0
    del csr
    _free()
    tmp = tempfile.mkdtemp(prefix="roc_tune_")
    env0 = {k: os.environ.get(k) for k in ("ROC_TUNED_PATH", "ROC_NO_TUNED")}
    os.environ["ROC_TUNED_PATH"] = os.path.join(tmp, "tuned_cuda.json")
    os.environ.pop("ROC_NO_TUNED", None)
    store.clear_cache()
    try:
        lines, trials = [], []
        t1 = time.perf_counter()
        table = search.autotune_graph(
            g.col_idx, g.dst_idx, n, n, storage_dtype="bf16", device=True,
            log=lines.append, cuda_device=dev, records=trials)
        entries = store.lookup(g.col_idx, g.dst_idx, n, n, "bf16") or {}
        back = store.lookup(g.dst_idx, g.col_idx, n, n, "bf16") or {}
        rec["autotune"] = {
            "seconds": time.perf_counter() - t1, "log": lines,
            "fwd": {k: {f: e[f] for f in ("launch", "trial_s",
                                          "default_s", "modeled_s")}
                    for k, e in entries.items()},
            "bwd": {k: {f: e[f] for f in ("launch", "trial_s",
                                          "default_s", "modeled_s")}
                    for k, e in back.items()},
            "table": None if table is None else table._asdict()}
        # (c) -autotune against an untuned run, both from a fresh store
        runs = {}
        for tuned in (False, True):
            if os.path.exists(os.environ["ROC_TUNED_PATH"]):
                os.remove(os.environ["ROC_TUNED_PATH"])
            store.clear_cache()
            tr = _recipe_trainer(ds, dev, epochs=3, autotune=tuned)
            KS.aggregate_sum.by_launch.clear()
            r = _train_run(tr, dev)
            r["by_launch"] = {f"{a}.{b}": c for (a, b), c in
                              KS.aggregate_sum.by_launch.items()}
            r["csr_launch"] = (None if tr.gdata.csr.launch is None
                               else tr.gdata.csr.launch._asdict())
            r.pop("metric_lines", None)
            runs["autotune" if tuned else "untuned"] = r
            del tr
            _free()
        rec["train"] = runs
        rec["leg_s"]["train"] = time.perf_counter() - t1 - \
            rec["autotune"]["seconds"]
        # (d) the refit rates from (b)'s trials
        name, limit = refit.card_identity()
        mtable = refit.to_measured_table(trials, interpret=False,
                                         name=name, power_limit=limit)
        refit.update(mtable, os.path.join(tmp, "measured_cuda.json"))
        rec["refit"] = {"rates": mtable["rates"], "n": mtable["n"],
                        "device": mtable["device"]}
    finally:
        for k, v in env0.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        store.clear_cache()
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)
    t1 = time.perf_counter()
    small = datasets.get("reddit-small", seed=SEED)
    rec["switches"] = [_switch_step(small, dev, s) for s in SWITCHES]
    rec["leg_s"]["switches"] = time.perf_counter() - t1
    rec["phase_s"] = time.perf_counter() - t0
    emit(rec)
    bad_sum = [r for r in rec["sum_candidates"]
               if not (r["gauss_bitwise_default"] and r["int_bitwise_plain"])]
    bad_gat = [r for r in rec["gat_candidates"]
               if not (r["gauss_bitwise_default"] and r["int_bitwise_plain"])]
    if bad_sum or bad_gat:
        raise AssertionError(f"a launch candidate changed bits: "
                             f"{bad_sum + bad_gat}")
    fwd, bwd = rec["autotune"]["fwd"], rec["autotune"]["bwd"]
    if not ({"sum/256", "sum/41", "gat/4x64", "gat/1x41"} <= set(fwd)
            and {"sum/256", "sum/41"} <= set(bwd)):
        raise AssertionError(f"the tuned store lacks a kernel: {fwd} {bwd}")
    un, tu = runs["untuned"], runs["autotune"]
    placed = tu["csr_launch"] or {"fwd": {}, "bwd": {}}
    tuned_pairs = {f"{a}.{b}" for d in ("fwd", "bwd")
                   for k, (a, b) in placed[d].items()
                   if k in ("sum/256", "sum/41")}
    if not (un["first_train_loss"] == tu["first_train_loss"]
            and un["last_train_loss"] == tu["last_train_loss"]
            and un["final_step_loss"] == tu["final_step_loss"]):
        raise AssertionError(f"-autotune changed the losses: {un} {tu}")
    if set(un["by_launch"]) != {"0.0"} or "0.0" in tu["by_launch"] or \
            set(tu["by_launch"]) != tuned_pairs:
        raise AssertionError(f"the tuned launches did not reach the kernel: "
                             f"{un['by_launch']} {tu['by_launch']} "
                             f"{tuned_pairs}")
    rates = rec["refit"]["rates"]
    if not (rates["byte_s"] is not None and rates["byte_s"] > 0
            and rates["row_s"] is not None and np.isfinite(rates["row_s"])):
        raise AssertionError(f"refit gave no rates: {rec['refit']}")
    if not all(s["ok"] for s in rec["switches"]):
        raise AssertionError(f"a kill switch step failed: "
                             f"{rec['switches']}")
    return rec


def _no_native():
    """``ROC_TPU_NO_NATIVE=1`` for a ``with`` body: the graph builders'
    NumPy paths."""
    from unittest import mock
    return mock.patch.dict(os.environ, {"ROC_TPU_NO_NATIVE": "1"})


def _same(a, b) -> bool:
    """Element-equal, dtype included, through tuples, lists, CSRs and halo
    maps."""
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if hasattr(a, "__dataclass_fields__"):
        return all(_same(getattr(a, f), getattr(b, f))
                   for f in a.__dataclass_fields__)
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.dtype == b.dtype and np.array_equal(a, b)
    return a == b


def _both_ways(name, fn, *args) -> tuple:
    """``fn(*args)`` twice each way, natively and under
    ROC_TPU_NO_NATIVE=1, in the order native, NumPy, NumPy, native, so
    that each way has a call that follows the other way's: its record
    (each way's faster call, and the four seconds in order; AssertionError
    unless every result is element-equal to the first) and the native
    result."""
    secs, results = [], []
    for way in ("native", "numpy", "numpy", "native"):
        with _no_native() if way == "numpy" else contextlib.nullcontext():
            t0 = time.perf_counter()
            results.append(fn(*args))
            secs.append(time.perf_counter() - t0)
    if not all(_same(results[0], r) for r in results[1:]):
        raise AssertionError(f"native {name} differs from its NumPy twin")
    return {"native_s": min(secs[0], secs[3]),
            "numpy_s": min(secs[1], secs[2]),
            "seconds_native_numpy_numpy_native": secs, "equal": True}, \
        results[0]


def _native_gcn(ds, dev) -> dict:
    """GCN 602-256-41 as test.sh trains it, 3 epochs, from the dataset:
    the seconds to the trainer and to the end of the first epoch, and the
    three losses."""
    _free()
    t0 = time.perf_counter()
    tr = _recipe_trainer(ds, dev, epochs=3)
    build_s = time.perf_counter() - t0
    losses = [float(tr.run_epoch())]
    torch.cuda.synchronize(dev)
    first_s = time.perf_counter() - t0
    losses += [float(tr.run_epoch()) for _ in range(2)]
    del tr
    _free()
    return {"build_s": build_s, "to_first_epoch_s": first_s,
            "losses": losses}


def phase_native(ds, dev) -> dict:
    """The host graph builders (roc_tpu_torch/native) on the card's host:
    the library's build, each builder against its NumPy twin on Reddit,
    a GCN placed both ways, -reorder on both ways, and the serve selftest
    with deltas on reddit-small under the armed lock-order witness."""
    import tempfile

    from roc_tpu_torch import native
    from roc_tpu_torch.analysis import witness
    from roc_tpu_torch.graph import lux
    from roc_tpu_torch.graph.partition import (bounds_from_row_ptr,
                                               partition_graph)
    from roc_tpu_torch.graph.reorder import rcm_order
    from roc_tpu_torch.parallel.halo import build_halo_maps
    from roc_tpu_torch.serve.__main__ import selftest
    t_phase = time.perf_counter()
    g = ds.graph
    native.lib()
    rec = {"phase": "native", "card": nvidia_smi(), "dataset": ds.name,
           "nodes": g.num_nodes, "edges": g.num_edges,
           "build_s": native.info["seconds"],
           "build_cached": native.info["cached"], "steps": {}}
    steps = rec["steps"]
    steps["transpose_edge_map"], _ = _both_ways(
        "transpose", g.transpose_with_order)
    steps["rcm"], _ = _both_ways("RCM", rcm_order, g)
    steps["bounds_p4"], _ = _both_ways("cut", bounds_from_row_ptr,
                                       g.row_ptr, 4)
    part = partition_graph(g, 4)
    steps["halo_maps_p4"], hm = _both_ways("halo maps", build_halo_maps,
                                           part)
    steps["halo_maps_p4"]["K"] = hm.K
    with tempfile.TemporaryDirectory(prefix="roc_native_") as tmp:
        path = os.path.join(tmp, "reddit" + lux.LUX_SUFFIX)
        lux.write_lux(path, g)
        steps["lux_header"], _ = _both_ways("header", lux.read_header, path)
        lo, hi = bounds_from_row_ptr(g.row_ptr, 4)[1]
        e0, e1 = int(g.row_ptr[lo]), int(g.row_ptr[hi + 1])
        steps["lux_rows_slice"], _ = _both_ways(
            "row slice", lux.read_rows_slice, path, lo, hi + 1)
        steps["lux_cols_slice"], _ = _both_ways(
            "col slice", lux.read_cols_slice, path, g.num_nodes, e0, e1)
        steps["lux_read"], back = _both_ways("read", lux.read_lux, path)
        if not _same((back.row_ptr, back.col_idx), (g.row_ptr, g.col_idx)):
            raise AssertionError("the .lux read back differs from Reddit")
        prefix = os.path.join(tmp, "feats")
        rows = ds.features[:20000]
        np.savetxt(prefix + ".feats.csv", rows, delimiter=",", fmt="%.9g")

        def parse():
            if os.path.exists(prefix + ".feats.bin"):
                os.remove(prefix + ".feats.bin")
            return lux.load_features(prefix, *rows.shape)
        steps["feats_csv_20000x602"], feats = _both_ways("CSV parse", parse)
        if not _same(feats, np.ascontiguousarray(rows, np.float32)):
            raise AssertionError("the parsed CSV differs from its rows")
    nat = _native_gcn(ds, dev)
    with _no_native():
        ref = _native_gcn(ds, dev)
    if nat["losses"] != ref["losses"] or not np.isfinite(
            nat["losses"]).all():
        raise AssertionError(f"GCN losses placed natively {nat['losses']} "
                             f"!= NumPy-placed {ref['losses']}")
    rec["gcn"] = {"native": nat, "numpy": ref, "losses_bitwise": True}
    dsr, _, on = _timed_reorder(ds, "on")
    with _no_native():
        dsr_np, _, off = _timed_reorder(ds, "on")
    if not _same((dsr.graph.row_ptr, dsr.graph.col_idx, dsr.features),
                 (dsr_np.graph.row_ptr, dsr_np.graph.col_idx,
                  dsr_np.features)):
        raise AssertionError("-reorder on differs natively")
    del dsr, dsr_np
    rec["reorder_on"] = {"native": on, "numpy": off}
    witness.reset()
    witness.arm(True)
    try:
        rc = selftest("cuda", serve_batch=64, dataset="reddit-small")
        pairs = witness.observed_pairs()
        violations = witness.validate()
    finally:
        witness.arm(False)
        witness.reset()
    rec["witness"] = {"selftest_rc": rc,
                      "pairs": [[a, b, n] for (a, b), n in
                                sorted(pairs.items())],
                      "violations": violations}
    rec["phase_s"] = time.perf_counter() - t_phase
    emit(rec)
    if rc != 0 or violations or not pairs:
        raise AssertionError(f"the armed serve selftest: rc {rc}, pairs "
                             f"{pairs}, violations {violations}")
    return rec


def _kernel_entry(name, source, replaces, launches, row, rows, keys):
    """One entry of the ``kernels`` line: the main row's numbers and every
    measured shape."""
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(launches.values()),
            "launches_by_path": launches,
            "max_abs_err": row["max_abs_err"], "ms": row["kernel_ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "at": {k: row[k] for k in keys if k in row},
            "shapes": [{k: r[k] for k in (*keys, "kernel_ms", "plain_ms",
                                          "library_ms", "bound_ms",
                                          "bound_by", "max_abs_err",
                                          "row_rel_err", "term_rel_err",
                                          "pair_ms", "pair_bound_ms",
                                          "pair_bound_by", "pair_library_ms",
                                          "dq_bytes", "stage_ms", "geometry",
                                          "ptxas")
                        if k in r}
                       for r in rows]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on an NVIDIA GPU", file=sys.stderr)
        return 2
    from roc_tpu_torch.graph import datasets

    dev = torch.device("cuda", 0)
    env = phase_env()
    t0 = time.perf_counter()
    ds = datasets.get("reddit", seed=SEED)
    emit({"phase": "graph", "dataset": "reddit",
          "nodes": ds.graph.num_nodes, "edges": ds.graph.num_edges,
          "host_gen_s": round(time.perf_counter() - t0, 3)})
    phase_native(ds, dev)
    phase_kernel_sum_shapes(dev)
    phase_kernel_xlayer_shapes(dev)
    rows = phase_kernel_xlayer(ds, dev)
    phase_train_small(dev, "gcn-chain")
    chain = {d: phase_train_chain(ds, dev, d) for d in (1, 2, 0)}
    phase_ab_chain(ds, dev)
    serve_mega = phase_serve(ds, dev, n_requests=40, megafuse=True)
    rows += phase_kernel(ds, dev)
    rows += phase_kernel_train(ds, dev)
    rows += phase_kernel_dropout(ds, dev)
    phase_kernel_gat_shapes(dev)
    rows += phase_kernel_gat(ds, dev)
    phase_small(dev)
    phase_train_small(dev)
    phase_train_small(dev, "gat")
    serve = phase_serve(ds, dev)
    serve_gat = phase_serve(ds, dev, "gat", n_requests=40)
    train = {mf: phase_train(ds, dev, mf) for mf in (False, True)}
    train_bf16 = {mf: phase_train_bf16(ds, dev, mf, train[mf])
                  for mf in (False, True)}
    phase_profile_split(ds, dev)
    serve_bf16 = phase_serve(ds, dev, n_requests=40, bf16=True)
    train_gat = phase_train(ds, dev, False, model="gat")
    phase_ab(ds, dev)
    tune = phase_tune(ds, dev)
    graph_file = phase_graph_file(ds, dev)
    phase_run_controls(dev)
    mem_plan = phase_mem_plan(ds, dev)
    stream = phase_stream(ds, dev)
    small = stream["small"]
    delta = phase_delta(ds, dev, serve)
    fleet = phase_fleet(ds, dev)
    spmd = phase_spmd(ds, dev, single5=train[False],
                      single3=stream["incore"]["losses"],
                      gat_single=small["gat_incore"]["losses"])
    modes = phase_spmd_modes(ds, dev, single3=stream["incore"]["losses"])

    def pick(name, **want):
        return next(r for r in rows if r["name"] == name and all(
            r.get(k) == v for k, v in want.items()))

    def named(name):
        return [r for r in rows if r["name"] == name]

    def chain_launches(name):
        return {f"train_chain_depth{d}": chain[d]["launches"][name]
                for d in (1, 2, 0) if chain[d]["launches"][name]}

    def planned(name):
        return {f"mem_plan_{m}": sum(r["launches"][name]
                                     for r in runs.values())
                for m, runs in mem_plan.items()}

    def streamed(name):
        return {"stream": stream["streamed"]["launches"][name],
                "stream_small": sum(small[k]["launches"][name] for k in (
                    "fp32", "bf16_storage", "spill", "gat")),
                "serve_stream": small["serve_launches"][name]}

    def sharded(name):
        return {leg: n[name] for rec in (spmd, modes)
                for leg, n in rec["launches"].items() if n[name]}

    src = "roc_tpu_torch/csrc/"
    pallas = "roc_tpu/ops/pallas/binned.py:"
    sum_entry = _kernel_entry(
        "aggregate_sum", src + "aggregate_sum.cu", pallas + "1885",
        {"serve": serve["launches"]["aggregate_sum"],
         "serve_bf16": serve_bf16["launches"]["aggregate_sum"],
         "train": train[False]["launches"]["aggregate_sum"],
         "train_bf16": train_bf16[False]["launches"]["aggregate_sum"],
         "tune_autotune":
         tune["train"]["autotune"]["launches"]["aggregate_sum"],
         "graph_file": graph_file["launches"]["aggregate_sum"],
         "delta": delta["launches"]["aggregate_sum"],
         "fleet": fleet["launches"]["aggregate_sum"],
         **planned("aggregate_sum"), **streamed("aggregate_sum"),
         **sharded("aggregate_sum")},
        pick("aggregate_sum", H=256, precision="fast", csr=None),
        named("aggregate_sum"), ("H", "precision", "csr"))
    sum_entry["also_replaces"] = [pallas + "1991", pallas + "2107",
                                  pallas + "2153"]
    stage_entry = _kernel_entry(
        "stage_plane", src + "aggregate_sum.cu", pallas + "1885",
        {"serve": serve["launches"]["stage_plane"],
         "serve_mega": serve_mega["launches"]["stage_plane"],
         "serve_bf16": serve_bf16["launches"]["stage_plane"],
         "train": train[False]["launches"]["stage_plane"],
         "train_megafuse": train[True]["launches"]["stage_plane"],
         "train_bf16": train_bf16[False]["launches"]["stage_plane"],
         "train_bf16_megafuse":
         train_bf16[True]["launches"]["stage_plane"],
         "tune_autotune":
         tune["train"]["autotune"]["launches"]["stage_plane"],
         "graph_file": graph_file["launches"]["stage_plane"],
         "delta": delta["launches"]["stage_plane"],
         "delta_mega": delta["mega_launches"]["stage_plane"],
         "fleet": fleet["launches"]["stage_plane"],
         **chain_launches("stage_plane"), **planned("stage_plane"),
         **streamed("stage_plane"), **sharded("stage_plane")},
        pick("stage_plane", H=256), named("stage_plane"), ("H", "ld"))
    stage_entry["also_replaces"] = [pallas + "1991", pallas + "2107",
                                    pallas + "2153", pallas + "2300"]
    emit({"kernels": [
        sum_entry,
        stage_entry,
        _kernel_entry(
            "aggregate_linear", src + "aggregate_linear.cu", pallas + "2300",
            {"train_megafuse": train[True]["launches"]["aggregate_linear"],
             "train_bf16_megafuse":
             train_bf16[True]["launches"]["aggregate_linear"],
             "serve_mega": serve_mega["launches"]["aggregate_linear"],
             "delta_mega": delta["mega_launches"]["aggregate_linear"],
             **chain_launches("aggregate_linear")},
            pick("aggregate_linear", H_in=602, precision="fast"),
            named("aggregate_linear"),
            ("H_in", "H_out", "activation", "precision")),
        _kernel_entry(
            "aggregate_linear_bwd", src + "aggregate_linear.cu",
            pallas + "2599",
            {"train_megafuse":
             train[True]["launches"]["aggregate_linear_bwd"],
             "train_bf16_megafuse":
             train_bf16[True]["launches"]["aggregate_linear_bwd"],
             **chain_launches("aggregate_linear_bwd")},
            pick("aggregate_linear_bwd", H_in=602, dx=False,
                 precision="fast"),
            named("aggregate_linear_bwd"),
            ("H_in", "H_out", "relu", "dx", "precision")),
        _kernel_entry(
            "stage_cotangent", src + "aggregate_linear.cu", pallas + "2599",
            {"train_megafuse": train[True]["launches"]["stage_cotangent"],
             "train_bf16_megafuse":
             train_bf16[True]["launches"]["stage_cotangent"],
             **chain_launches("stage_cotangent")},
            pick("stage_cotangent", H=256, precision="fast"),
            named("stage_cotangent"), ("H", "relu", "precision")),
        *(_kernel_entry(
            name, src + "gat.cu", "roc_tpu/ops/pallas/gat.py:" + line,
            {"serve_gat": serve_gat["launches"][name],
             "train_gat": train_gat["launches"][name],
             "stream_gat": small["gat"]["launches"][name],
             **sharded(name)},
            pick(name, K=4, precision="fast"), named(name),
            ("K", "F", "precision"))
          for name, line in (("gat_score", "310"), ("gat_forward", "328"),
                             ("gat_bwd_dst", "536"),
                             ("gat_bwd_src", "632"))),
        _kernel_entry(
            "gat_stage", src + "aggregate_sum.cu",
            "roc_tpu/ops/pallas/gat.py:428",
            {"serve_gat": serve_gat["launches"]["gat_stage"],
             "train_gat": train_gat["launches"]["gat_stage"],
             "stream_gat": small["gat"]["launches"]["gat_stage"],
             **sharded("gat_stage")},
            pick("gat_stage", K=1), named("gat_stage"), ("H", "ld")),
        {**_kernel_entry(
            "dropout", src + "dropout.cu", "roc_tpu/ops/dropout.py:21",
            {"train": train[False]["launches"]["dropout"],
             "train_megafuse": train[True]["launches"]["dropout"],
             "train_bf16": train_bf16[False]["launches"]["dropout"],
             "train_bf16_megafuse":
             train_bf16[True]["launches"]["dropout"],
             "train_gat": train_gat["launches"]["dropout"],
             "graph_file": graph_file["launches"]["dropout"],
             **planned("dropout"), **sharded("dropout")},
            pick("dropout", H=602, dtype="float32"), named("dropout"),
            ("H", "rate", "dtype")),
         "replaces_kind": "jax.random.bernoulli and jnp.where (XLA ops, "
                          "not a Pallas kernel)"},
        _kernel_entry(
            "xlayer_fwd", src + "xlayer.cu", pallas + "2949",
            chain_launches("xlayer_fwd"),
            pick("xlayer_fwd", precision="fast"), named("xlayer_fwd"),
            ("widths", "precision", "fold")),
        _kernel_entry(
            "xlayer_bwd", src + "xlayer.cu", pallas + "3226",
            chain_launches("xlayer_bwd"),
            pick("xlayer_bwd", precision="fast", dx=False),
            named("xlayer_bwd"), ("widths", "precision", "fold", "dx"))]})
    print(env["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
