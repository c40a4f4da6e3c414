#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: build, kernels, main path, parity.

    python3 chip_smoke.py

Phase 0  the card (nvidia-smi name and power limit), torch and CUDA versions; exits
         non-zero when no CUDA card is available.
Phase 1  builds the CUDA kernels from csrc/ with nvcc (sm_90a).
Phase 2  each kernel against its plain PyTorch version on the card, on seeded random
         inputs at the main path's shapes, at float32 and float64 (both fills
         bitwise, the others within the bands of tests/test_torch_cuda.py), with median
         kernel and plain times from CUDA events.
Phase 3  the main path: the Bickley jet on the 1/4-degree tripolar grid (1440 x 680,
         halo 5, float32, substeps=30), 20 steps at dt = 60 s through multi_step;
         checks the launch counts, finite fields and the tracer range; ms/step.
Phase 4  parity on the card: the 180 x 90 float64 Bickley jet, 20 steps through the
         kernels, against tests/data/bickley_oracle_180x90.npz with the tolerances
         of tests/test_parity.py.
Phase 5  the layered path: the baroclinic front on the 1/4-degree tripolar grid with
         10 layers (1440 x 680 x 10, float32, substeps=30), 10 steps at dt = 40 s
         after 3 warm-up steps through layered_multi_step; checks the launch counts
         per step and finite fields; ms/step and G grid-points/s.
Phase 6  layered parity on the card: the 120 x 60 x 4 float64 front, 15 steps
         through the kernels, against tests/data/front_oracle_120x60x4.npz with the
         tolerances of tests/test_parity.py:233-236.
Phase 7  the gyre: the wind-driven T/S gyre of bench_layered.py (1440 x 680 x 10,
         stretched layers, T and S with the linear EOS, Coriolis, wind, quadratic
         drag, nu_h = 5e3, kappa_h = 1e2, nu_v = 1e-3, kappa_v = 1e-5, float32,
         substeps=30), 10 steps at dt = 40 s after 3 warm-up steps; checks the launch
         counts per step and finite fields; ms/step and G grid-points/s.
Phase 8  gyre parity on the card: 3 float64 steps of the 48 x 32 x 3 check gyre
         (examples/wind_driven_ts_gyre_torch.py:build_check) through the kernels
         against the port's plain path on the CPU, rtol 1e-11.
Phase 9  the measurement probes (csrc/probes.cu): the barotropic substep probe, the
         WENO-5 probe and the stream and FMA ceiling kernels against their plain
         versions at float32 and float64; then the four ceilings measured through
         them (benchmarks/torch_roofline.py), each kernel's byte bound at the
         measured stream rate (the vertical kernel's linear-EOS mode, the gyre's,
         beside the front's), and the barotropic, momentum and tracer kernels'
         math and WENO bounds beside their phase-2 times.
Phase 10 the phase-7 gyre through utils.Simulation: 100 iterations with the wizard
         and the progress line every 10 and the default NaN checker. It fails if a
         step waits for the card: torch's sync debug mode must count no host
         synchronization at an iteration where no callback fires (and counts one at
         every iteration of a run that reads u after each step). ms/step against
         layered_multi_step, reported against the 3 % target, beside the same run
         with a NaN checker on u, v and c every 10 and the run that reads u after
         each step; the async surface writer and the checkpoint timed on their own;
         a pickup from the checkpoint at iteration 30, resumed to 60 at a fixed
         dt = 40 s, bitwise equal to the uninterrupted run.
Phase 11 the reference's run (BASELINE.md:13): the 180 x 90 float64 Bickley jet,
         50 days through Simulation with the CFL-0.3 wizard (max dt 3 h) and daily
         output; steps, wall time, final invariants, finite fields, the tracer
         range and its conservation.
Phase 12 the y-partitioned runs (parallel/distributed.py): (a) the shard-aware
         group fill, its pack and its restore against their plain versions, bitwise
         at float32 and float64, in the four roles of 4 ranks on the Bickley and the
         gyre groups at ny = 170 and ny = 22 (the extended halo); (b) phase 3's
         Bickley jet in 4 shards (ny = 170) through LocalExchange, 20 steps at
         dt = 60 s, bitwise equal to the serial multi_step from the same state, each
         shard launching barotropic, momentum and tracer_adv once a step, and no host
         synchronization; (c) phase 7's gyre in 4 shards, 3 steps at dt = 40 s,
         bitwise equal to serial; (d) a 1-rank NCCL process group through
         ProcessGroupExchange, bitwise equal to the serial step with no host
         synchronization. ms/step of (b) and (c) beside phases 3 and 7. The
         sharded steps run the overlap split (on by default): each shard wraps x
         locally, launches its bulk tendencies, exchanges, and recomputes two row
         strips, so the tendency kernels launch three times a step; the wrap
         kernel is held against its plain version and timed in (a).
Phase 13 the 2-D (x, y) runs (parallel/distributed2d.py) and the split: (a) the
         2-D route's launches (the pack of the rows and fold strip, the inner
         phase with its save, the pack of the columns, the outer phase, the
         restore) against their plain versions, bitwise at float32 and float64, in
         every block of a 2 x 2 (gather), a 4 x 1 (mirror) and a 3 x 1 mesh (its
         middle block, columns 480-959, straddles the fold's middle column), on the
         Bickley and gyre groups of 1/4-degree blocks and at ny = 22 (2 x 2: the
         top blocks' strips reach the blocks below) or 23 (one row of blocks); a
         top block's launches timed at float32 beside their plain versions and
         torch.cat; (b) phase 3's jet on 2 x 2 blocks (gather, by "auto") through
         LocalExchange, 20 steps at dt = 60 s, bitwise equal to the serial
         multi_step, each block's launches counted, no host synchronization; (c)
         the same on 4 x 1 blocks with fold_mode="mirror", bitwise equal to (b) and
         to serial; (d) phase 7's gyre on 2 x 2 blocks, 3 steps at dt = 40 s,
         bitwise equal to serial; (e) overlap=True against overlap=False, the jet
         (5 steps) and the gyre (3) on 4 y-shards and on 2 x 2, bitwise. ms/step,
         device busy and idle share of (b)-(e) beside phases 3, 7 and 12.
Phase 14 the model options on phase 3's grid: (a) the tracer kernel's column mode
         over P = 2 and 3 planes of (690, 1450), float32 and float64, with and
         without kappa_h and acc, against its plain version within the bands and
         each plane bitwise equal to a one-plane launch on it; the P-plane launch
         timed with the host ahead beside P one-plane launches, its plain version
         and the one-plane launch of the jet; (b) the jet with two tracers (phase
         3's c and a smooth field from the seed), 20 steps after 3 warm-up steps:
         ms/step, one tracer_adv_planes launch a step and no tracer_adv, u, v and
         eta bitwise equal to the single-tracer run and each plane bitwise equal to
         its own single-tracer run; (c) each other option (tracer_advection weno7,
         upwind3, centered, centered4; momentum_advection "vector_invariant"), 5
         steps: finite, the tracer in range, ms/step; then each at float64 on a
         48 x 40 grid, 3 steps on the card against the CPU plain path, rtol 1e-11;
         (d) WENO-7 on 4 y-shards and on 2 x 2 blocks through LocalExchange, 3
         steps, split and unsplit, bitwise equal to each other and to serial, and the
         two-tracer jet on 4 y-shards bitwise equal to serial.
Phase 15 ensembles (models/ensemble.py): (a) the barotropic kernel over B = 4
         members of (724, 1484) with the wrap on and off, and the tracer kernel's
         member mode over 4 members of one tracer and 2 of two on (690, 1450), with
         and without kappa_h and acc, at float32 and float64: within the bands of
         their plain versions, each member bitwise its one-member launch; timed at
         float32 with the host ahead beside 4 one-member launches; (b) phase 3's jet
         as 4 members (the base state times 0.5, 0.75, 1.0, 1.25), 20 steps after 3
         warm-up: the launches of one serial step a step (tracer_adv_members in place
         of tracer_adv), each member bitwise its serial run; ms/step as run and with
         the host ahead, device busy and idle share, beside the serial step and 4 x
         phase 3's; (c) two members of two tracers, one step apart, 3 steps, bitwise
         per plane.
Phase 16 the grid options: (a) the 1/4-degree grid built on the host with the
         numpy and the native backends and by "auto" (host seconds, the largest
         difference per array within tests/test_native.py's bands, "auto" through
         the native kernels); (b) the jet on the equatorially refined 1/4-degree grid
         (the law of tests/test_tripolar_grid.py:238 in torch, rows by the Newton
         solve), 10 steps through the kernels: finite, the extended grid carrying
         the law.
Phase 17 ensembles of the layered model (run after phase 13, while phase 7's gyre
         lives): (a) the four member launches at the gyre's shapes, B = 4 members of
         (10, 690, 1450), T and S, the linear EOS: the vertical kernel (nu_v,
         kappa_v), the corrector (per-member weights and crops of U_a, V_a), the
         momentum kernel over 40 layers with period 10 (closure planes, dG, the
         closing mask) and the layered tracer kernel over the members (kappa_h, dGc a
         view): within the bands of their plain versions at float32 and float64,
         each member bitwise its one-member launch, timed at float32 with the host
         ahead beside 4 one-member launches, with their byte and WENO bounds; (b)
         phase 7's gyre as 4 members (the base state times 0.5, 0.75, 1.0, 1.25),
         10 steps after 3 warm-up: one serial step's launches a step through the
         member launches, every member bitwise its serial run in every field; ms/step
         as run and with the host ahead, device busy and idle share, beside the
         serial step; (c) the f64 front oracle through member 0 of a 2-member
         ensemble (member 1 the state times 0.9, one step ahead), phase 6's
         tolerances.
Phase 18 ensembles of sharded runs (run after phase 17, while phase 7's gyre lives):
         (a) the member launches at a rank's and a strip's shapes (SHARD_PLANES: a
         y-shard of 170 rows, a 2 x 2 block, the split's 15-row and 15-column strips;
         SHARD_EXT: their extended planes), B = 4: the barotropic member axis, the
         jet's tracer_adv_members and momentum over the members (period 1), the
         gyre's vertical_members, momentum_members (period 10),
         tracer_adv_layered_members and, on a rank's plane, corrector_members, at
         float32 and float64: within the bands of their plain versions, each member
         bitwise its one-member launch at the same shape; timed at float32 with the
         host ahead beside 4 one-member launches, with the data-sheet, measured byte
         and WENO or substep bounds; (b) phase 3's jet as 4 members (phase 15b's
         scales) in 4 y-shards through LocalExchange, the split on, 20 steps at dt =
         60 s after 3 warm-up: every member bitwise its run in the serial ensemble
         from the same state, each shard launching phase 12b's kernels with the
         member launches in place, no host synchronization; (c) the same on 2 x 2
         blocks; (d) phase 7's gyre as 4 members, 3 steps at dt = 40 s after 3
         warm-up in 4 y-shards and on 2 x 2, bitwise the serial ensemble, and
         unsplit on 4 y-shards, bitwise the split; ms/step, device busy and idle
         share of (b)-(d) beside one member on the same ranks (phases 12-13) and
         the serial ensemble; (e) a
         2-member jet ensemble through a 1-rank NCCL ProcessGroupExchange, bitwise the
         serial ensemble, no host synchronization; (f) the float64 check gyre of phase
         8 with a forcing of T that reads t, 2 members one step apart, in 2 y-shards
         with the split, 3 steps through the kernels against the plain sharded
         ensemble on the CPU, rtol 1e-11.
Phase 19 checkpoint directories (utils/checkpoint.py through
         torch.distributed.checkpoint; run after phase 18, while phase 7's gyre
         lives): (a) phase 7's gyre through Simulation to iteration 60 with an npz
         and a directory Checkpointer every 30, then a pickup from the directory at
         30: every field bitwise the uninterrupted run, phase 10's launches, no host
         synchronization at an iteration without a callback; ms a checkpoint on the
         simulation thread and MB on disk of both routes; (b) phase 18's 4-member
         gyre in 4 y-shards and on 2 x 2 blocks: one directory saved after a step,
         3 more steps, loaded into zeroed rank states (each rank's tensors filled on
         the card from its own keys), 3 more steps, bitwise the uninterrupted run;
         save and load ms; (c) phase 18e's 2-member jet in a 1-rank NCCL group
         (ProcessGroupExchange) saved and loaded through the process-group route,
         bitwise.

Phase 20 the benchmark entry points (run after phase 19, while phase 7's gyre lives):
         one block of bench_torch.py and of bench_layered_torch.py, each 10 of its
         path's steps in launches; bench_torch.main on phase 3's jet with
         bench_layered_torch.run on phase 7's gyre: both lines finite, every launch
         of the run a block's, cuda-nccl-smoke ok; bench_scaling_torch through
         LocalExchange at N = 1, 2, 4 (1440 x 170 a shard, 30 substeps, dt = 60 s)
         and over NCCL on the cards present, every run's shards bitwise the serial
         run. The bench lines go on earlier lines of the output.
Phase 21 the compiled blocks (utils/graph.py; run after phase 20, while phase 7's gyre
         lives): phase 3's jet, phase 7's gyre and both as 4 members (phase 15b's
         scales), 20 steps through the captured CUDA graphs of the step (multi_step,
         layered_multi_step, ensemble_multi_step) against the eager loop of step or
         layered_step from the same state: bitwise in every field, a block's launches
         those of 20 eager steps and 20 times the captured step's record, no host
         synchronization in a replay; ms/step as run and host ahead on both routes
         (blocks of 10), their idle shares (1 - host ahead / as run), the capture's
         seconds and the pool's MB.

multi_step, layered_multi_step, ensemble_multi_step and Simulation replay the model's
captured CUDA graphs of its step on the card (utils/graph.py), so phases 3, 5, 7, 8,
10, 11, 14-17, 19, 20 and 21 run that route. A model's first block captures its step
after one eager warm-up step, whose launches count, so a phase that counts a new
model's launches runs a block first; the phases' warm-up blocks do that. The sharded
phases call step and layered_step, which stay eager.

Phase 2 holds the halo fills first: the group fill with save, the group fill without
save and the group restore against their plain versions, bitwise at float32 and
float64, on the Bickley group (u, v, c on (690, 1450); eta, U, V views of one
(3, 724, 1484) buffer; and its GU/GV group), the front's (u, v, c, b at Nz = 10) and
the gyre's (u, v at Nz = 10, T and S as 20 planes) with eta, U, V, and three fields on
planes no block divides; the restore gives every input back bitwise. Each launch is
timed beside its plain version and beside a clone of the group's bytes. The single
in-place fill (a group of one) and the out-of-place fill of the diagnostics are held
on every main-path plane.

Phase 2 holds the barotropic kernel, beside the main shape, on five planes from
(26, 28) (smaller than one tile) to (135, 171), none of which the tiles divide, at 7,
17, 21, 31 and 36 substeps (launches shorter than the others), with the wrap on and
off: within the band, finite everywhere, inputs unchanged, and each wrapped halo
column bitwise equal to the column it copies.

Phase 2 also holds the layered kernels against their plain versions: the vertical
kernel (its masks from a plane of wet-layer counts, the plain version on the mask
pack of the same counts) at (10, 690, 1450) in its three modes, at Nz = 50 and at
Nz = 4 on three planes no tile divides, with and without nu_v and kappa_v; the
layered momentum kernel at Nz = 10 without and with the front's acc (dGu, dGv) and
closing mask, the layered tracer kernel with 1 and 2 tracers (the front's call timed
on random and on all-zero c), and the halo fill on a 10-plane stack; and the gyre's
modes: momentum with the nu_h and drag planes on one layer and on 10 (with acc and
the closing mask, the gyre's call), tracer advection with kappa_h in column and
layered mode, and the corrector with and without b. Then the acc/mask_out operands
in every mode of the momentum kernel and every mode of the tracer kernel with and
without acc, at float32 and float64, on the main shape and on three planes the
tiles do not divide, from (7, 9) (smaller than one tile) to (135, 171): within the
band, finite, the edge cells 0, the inputs unchanged. The momentum rows of the
kernel table time the calls the main paths make: one masked layer (Bickley), Nz = 10
with acc and mask_out (front), and with the closure planes too (gyre); the layered
tracer rows the front's c and the gyre's T and S with acc (dGc); the vertical rows
the front's tracer_b and the gyre's linear EOS, both with nu_v and kappa_v. Phases 5
and 7 time the layered tracer call on the path's own fields (the front's all-zero c,
the gyre's land) beside random fields.

Prints the kernel table as one JSON line (with each kernel's bound: the larger of
its bytes, every input read once and every output written once, over 3.35 TB/s and
its operations over 67 TFLOP/s at float32, the data sheet's rates; phase 9 prints
the bounds at the measured rates), then the nvidia-smi line, then
``{"ok": true, "device": {...}}`` as the last line. Any failed check raises, and the
script exits non-zero.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from orthogonalsphericalshellgrids_tpu_torch.utils.profiling import (  # noqa: E402
    host_syncs, smi_line, time_ms)

FILL_SHAPES = {"base": (690, 1450), "ext": (724, 1484)}
# planes the tiles of the momentum, tracer and vertical kernels do not divide, from
# one smaller than any tile
ODD_PLANES = [(7, 9), (37, 131), (135, 171)]
BANDS = {"float32": 1e-5, "float64": 1e-12}
REPLACES = {
    "halo_fill": "orthogonalsphericalshellgrids_tpu/ops/pallas_fill.py:238",
    "halo_restore": "orthogonalsphericalshellgrids_tpu/ops/pallas_fill.py:292",
    # the same fill into a fresh buffer, for the diagnostics (phases 4 and 11)
    "halo_fill_copy": "orthogonalsphericalshellgrids_tpu/ops/pallas_fill.py:238",
    # the group fill in a shard's role, with the received rows (phase 12); the JAX
    # package's sharded step fills with XLA there (ops/spmd.py:50-111)
    "halo_fill_shard": "orthogonalsphericalshellgrids_tpu/ops/pallas_fill.py:238",
    # the send rows of a shard's group, the concatenations of ops/spmd.py:75-76 (XLA)
    "halo_pack": "orthogonalsphericalshellgrids_tpu/ops/spmd.py:75",
    # the local x-wrap the split's bulk pass reads on a y-partition (XLA, phase 12)
    "halo_wrap": "orthogonalsphericalshellgrids_tpu/models/hydrostatic.py:866",
    # the group fill of a block of a 2-D mesh, inner and outer phases (phase 13); the
    # JAX package's 2-D sharded step fills with XLA there (ops/spmd2d.py:106-199)
    "halo_fill_block": "orthogonalsphericalshellgrids_tpu/ops/pallas_fill.py:238",
    # a block's rows with its fold strip and its columns, the concatenations of
    # ops/spmd2d.py:126-127, 143-145 and 186-187 (XLA)
    "halo_pack_block": "orthogonalsphericalshellgrids_tpu/ops/spmd2d.py:126",
    "barotropic": "orthogonalsphericalshellgrids_tpu/ops/pallas_baro.py:242",
    "momentum": "orthogonalsphericalshellgrids_tpu/ops/pallas_mom.py:281",
    "tracer_adv": "orthogonalsphericalshellgrids_tpu/ops/pallas_adv.py:258",
    "vertical": "orthogonalsphericalshellgrids_tpu/ops/pallas_vert.py:309",
    "momentum_layered": "orthogonalsphericalshellgrids_tpu/ops/pallas_mom.py:281",
    "tracer_adv_layered": "orthogonalsphericalshellgrids_tpu/ops/pallas_adv.py:258",
    "momentum_closures": "orthogonalsphericalshellgrids_tpu/ops/pallas_mom.py:281",
    "tracer_adv_kappa": "orthogonalsphericalshellgrids_tpu/ops/pallas_adv.py:258",
    # the column mode over a stack of tracers (models/hydrostatic.py:689-696, phase 14)
    "tracer_adv_planes": "orthogonalsphericalshellgrids_tpu/ops/pallas_adv.py:258",
    # the column mode over the planes of an ensemble's members, each over its own
    # (u, v): the batching rule of pallas_call under jax.vmap(step) (phase 15)
    "tracer_adv_members": "orthogonalsphericalshellgrids_tpu/ops/pallas_adv.py:258",
    # the layered kernels over the members of a layered ensemble: the batching rule
    # of pallas_call under jax.vmap(layered_step) (phase 17)
    "vertical_members": "orthogonalsphericalshellgrids_tpu/ops/pallas_vert.py:309",
    "momentum_members": "orthogonalsphericalshellgrids_tpu/ops/pallas_mom.py:281",
    "tracer_adv_layered_members": "orthogonalsphericalshellgrids_tpu/ops/pallas_adv.py:258",
    "corrector_members": "orthogonalsphericalshellgrids_tpu/ops/pallas_corr.py:83",
    "corrector": "orthogonalsphericalshellgrids_tpu/ops/pallas_corr.py:83",
    "baro_substep_sol": "benchmarks/roofline.py:121",
    "weno_probe": "benchmarks/weno_sol.py:167",
    # the ceiling kernels stand for the XLA scan bodies of the JAX package's probes
    "stream_probe": "orthogonalsphericalshellgrids_tpu/utils/profiling.py:49",
    "fma_ceiling": "benchmarks/weno_sol.py:215",
}
SOURCE_FILE = {"halo_restore": "halo_fill", "halo_fill_copy": "halo_fill",
               "halo_fill_shard": "halo_fill", "halo_pack": "halo_fill",
               "halo_wrap": "halo_fill", "halo_fill_block": "halo_fill",
               "halo_pack_block": "halo_fill",
               "momentum_layered": "momentum", "tracer_adv_layered": "tracer_adv",
               "momentum_closures": "momentum", "tracer_adv_kappa": "tracer_adv",
               "tracer_adv_planes": "tracer_adv", "tracer_adv_members": "tracer_adv",
               "vertical_members": "vertical", "momentum_members": "momentum",
               "tracer_adv_layered_members": "tracer_adv", "corrector_members": "corrector",
               "baro_substep_sol": "probes", "weno_probe": "probes", "stream_probe": "probes",
               "fma_ceiling": "probes"}
SOURCES = {name: "orthogonalsphericalshellgrids_tpu_torch/csrc/{}.cu".format(
    SOURCE_FILE.get(name, name)) for name in REPLACES}
# the kernels each main path must launch: the Bickley jet (phase 3), the baroclinic
# front (phase 5) and the gyre (phase 7); the out-of-place fill of the diagnostics
# runs in the reference's 50-day run (phase 11)
BICKLEY = ("halo_fill", "halo_restore", "barotropic", "momentum", "tracer_adv")
FRONT = ("halo_fill", "halo_restore", "barotropic", "vertical", "momentum_layered",
         "tracer_adv_layered", "corrector")
GYRE = ("halo_fill", "halo_restore", "barotropic", "vertical", "momentum_closures",
        "tracer_adv_kappa", "corrector")
DIAGNOSTICS = ("halo_fill_copy",)
# the kernels each shard of the y-partitioned gyre launches once a step (phase 12)
GYRE_SHARD = ("barotropic", "vertical", "momentum_closures", "tracer_adv_kappa",
              "corrector")
# the kernels each shard of the y-partitioned Bickley jet launches (phase 12)
SHARDED = ("halo_pack", "halo_fill_shard", "halo_wrap", "halo_restore", "barotropic",
           "momentum", "tracer_adv")
# the kernels each block of the 2-D Bickley jet launches (phase 13)
BLOCKS = ("halo_pack_block", "halo_fill_block", "halo_restore", "barotropic", "momentum",
          "tracer_adv")
# the tendency kernels the overlap split launches on the bulk and on each strip
SPLIT_BICKLEY = ("momentum", "tracer_adv")
SPLIT_GYRE = ("vertical", "momentum_closures", "tracer_adv_kappa")
# the kernels the two-tracer Bickley jet launches (phase 14b)
PLANES = ("halo_fill", "halo_restore", "barotropic", "momentum", "tracer_adv_planes")
# the kernels an ensemble of the Bickley jet launches (phase 15), and its members
ENSEMBLE = ("halo_fill", "halo_restore", "barotropic", "momentum", "tracer_adv_members")
ENSEMBLE_SCALES = (0.5, 0.75, 1.0, 1.25)
# the kernels an ensemble of the gyre launches once a step (phase 17b), besides the
# two group fills
LAYERED_ENSEMBLE = ("halo_restore", "barotropic", "vertical_members", "momentum_members",
                    "tracer_adv_layered_members", "corrector_members")
# ensembles of sharded runs (phase 18): the kernels each y-shard of the jet's and of
# the gyre's 4-member ensemble launches, the tendency kernels the split runs on the
# bulk and each strip, and the planes of a rank and of the split's strips at 1/4
# degree (halo 5; 3 Hy rows or 3 Hx columns) with the ranks' extended planes (halo
# 22) and their Nx
SHARDED_ENSEMBLE = ("halo_pack", "halo_fill_shard", "halo_wrap", "halo_restore",
                    "barotropic", "momentum", "tracer_adv_members")
SHARDED_LAYERED_ENSEMBLE = ("halo_pack", "halo_fill_shard", "halo_wrap", "halo_restore",
                            "barotropic", "vertical_members", "momentum_members",
                            "tracer_adv_layered_members", "corrector_members")
SPLIT_ENSEMBLE = ("momentum", "tracer_adv_members")
SPLIT_LAYERED_ENSEMBLE = ("vertical_members", "momentum_members",
                          "tracer_adv_layered_members")
SHARD_PLANES = {"y-shard": (180, 1450), "y-shard row strip": (15, 1450),
                "2 x 2 block": (350, 730), "block row strip": (15, 730),
                "block column strip": (350, 15)}
SHARD_EXT = {"y-shard": (214, 1484, 1440), "2 x 2 block": (384, 764, 720)}
# the single-layer options that run outside the kernels (phase 14c), and the kernel
# each leaves in the step
OPTIONS = {"weno7": dict(tracer_advection="weno7"),
           "upwind3": dict(tracer_advection="upwind3"),
           "centered": dict(tracer_advection="centered"),
           "centered4": dict(tracer_advection="centered4"),
           "vector_invariant": dict(momentum_advection="vector_invariant")}
# the kernels the ceilings measurement must launch (phase 9)
PROBES = ("baro_substep_sol", "weno_probe", "stream_probe", "fma_ceiling")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
F32_FLOPS_PER_S = 67e12    # float32 outside the tensor cores


def check(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def log(msg):
    print(msg, flush=True)


def rel_err(got, want, sl):
    g, w = got[..., sl[0], sl[1]], want[..., sl[0], sl[1]]
    return float((g - w).abs().max()), float((g - w).abs().max() / w.abs().max())


def edge_zero(g, R):
    """All four strips of ``R`` cells at the plane's edge are 0."""
    return all(bool((strip == 0).all()) for strip in (
        g[..., :R, :], g[..., -R:, :], g[..., :R], g[..., -R:]))


def nbytes(*tensors):
    """Bytes of the tensors (None skipped): each read or written once."""
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(n_bytes, flops):
    """(least ms the card could take, what bounds it, the bytes): the larger of the
    bytes over the HBM rate and the operations over the float32 rate. Phase 9 puts
    the same bytes over the measured stream rate."""
    t_b, t_f = n_bytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS_PER_S * 1e3
    return (t_b, "bytes", n_bytes) if t_b >= t_f else (t_f, "operations", n_bytes)


# operations per output value, counted from each kernel's arithmetic: the fill's
# sign (the restore only moves data); per substep and cell the barotropic
# divergence, gradients and updates; momentum's vorticity, two WENO-5
# reconstructions and KE gradient (+40 with the closure planes); tracer advection's
# two face reconstructions a cell (each face once: one x face and one y face, 70
# operations each) and the flux divergence (+12 with kappa_h); the vertical pass per
# layer and tracer block; the corrector's AB2 update (+4 with acc and mask_out)
FLOPS = {"halo_fill": 1, "halo_restore": 0, "halo_fill_copy": 1, "halo_fill_shard": 1,
         "halo_pack": 0, "halo_wrap": 0, "halo_fill_block": 1, "halo_pack_block": 0,
         "barotropic": 30,
         "momentum": 300, "momentum_layered": 304, "momentum_closures": 344,
         "tracer_adv": 160, "tracer_adv_layered": 160, "tracer_adv_kappa": 172,
         "tracer_adv_planes": 160, "tracer_adv_members": 160,
         "vertical": 40, "corrector": 8, "vertical_members": 40, "momentum_members": 344,
         "tracer_adv_layered_members": 172, "corrector_members": 8}


def phase2_kernels(card):
    """Each kernel against its plain version at the main path's shapes; returns
    {name: (max_abs_err at float32, kernel ms, plain ms)}."""
    import numpy as np
    import torch

    from orthogonalsphericalshellgrids_tpu_torch.kernels import (barotropic, halo_fill,
                                                                 momentum, tracer_adv)
    from orthogonalsphericalshellgrids_tpu_torch.models.split_explicit import (
        averaging_weights)
    from orthogonalsphericalshellgrids_tpu_torch.ops.location import CC, CF, FC

    results = {}
    for name in ("float32", "float64"):
        dt = getattr(torch, name)
        rng = np.random.default_rng(2024)

        def rnd(shape, scale=1.0, lo=None):
            a = rng.random(shape) + lo if lo is not None else scale * rng.standard_normal(shape)
            return torch.as_tensor(a, dtype=dt, device="cuda")

        # halo fill: every (plane, location) of the main path, bitwise
        for plane, (Yb, Xb) in FILL_SHAPES.items():
            H = 5 if plane == "base" else 22
            Nx, Ny = Xb - 2 * H, Yb - 2 * H
            for loc, sign in ((CC, 1), (FC, -1), (CF, -1)):
                A = rnd((Yb, Xb))
                A0 = A.clone()
                want = halo_fill.fill_halos_plain(A.clone(), loc, sign, Nx, Ny, H, H)
                got = halo_fill.fill_halos(A.clone(), loc, sign, Nx, Ny, H, H)
                copy = halo_fill.fill_halos(A, loc, sign, Nx, Ny, H, H, inplace=False)
                torch.cuda.synchronize()
                check(torch.equal(got, want), f"fill {plane} {loc} {name} bitwise")
                check(torch.equal(copy, want) and torch.equal(A, A0),
                      f"out-of-place fill {plane} {loc} {name} bitwise, input kept")
        A = rnd(FILL_SHAPES["ext"])
        Nx, Ny = 1440, 680
        t_k = time_ms(lambda: halo_fill.fill_halos(A, FC, -1, Nx, Ny, 22, 22))
        t_p = time_ms(lambda: halo_fill.fill_halos_plain(A, FC, -1, Nx, Ny, 22, 22))
        t_kc = time_ms(lambda: halo_fill.fill_halos(A, FC, -1, Nx, Ny, 22, 22,
                                                    inplace=False))
        t_pc = time_ms(lambda: halo_fill.fill_halos_plain(A.clone(), FC, -1, Nx, Ny, 22,
                                                          22))
        log(f"phase 2: halo_fill {name}: in place and out of place bitwise equal on 6 "
            f"main-path planes; ext-plane (724, 1484) FC fill in place {t_k:.4f} ms "
            f"kernel, {t_p:.4f} ms plain; out of place {t_kc:.4f} ms kernel, "
            f"{t_pc:.4f} ms plain (clone + fill) [{card}]")
        if name == "float32":
            # out of place: the plane read and written
            results["halo_fill_copy"] = (0.0, t_kc, t_pc, bound(
                2 * nbytes(A), FLOPS["halo_fill_copy"] * A.numel()))

        # barotropic subcycle on the extended plane, 21 SM05 weights
        Ye, Xe = FILL_SHAPES["ext"]
        static = rnd((9, Ye, Xe), lo=0.5)
        static[7:] = (static[7:] > 0.6).to(dt)  # masks
        eta, U, V = (rnd((Ye, Xe), 0.01) for _ in range(3))
        GU, GV = (rnd((Ye, Xe), 1e-3) for _ in range(2))
        dtau = torch.tensor(0.01, dtype=dt, device="cuda")
        weights = torch.as_tensor(averaging_weights(30)[1], dtype=dt, device="cuda")
        I = (slice(22, Ye - 22), slice(22, Xe - 22))
        errs = []
        kept = [a.clone() for a in (static, eta, U, V, GU, GV)]
        for wrap in (False, True):
            args = (static, eta, U, V, GU, GV, dtau, weights, 1440, 22, wrap)
            for g, w in zip(barotropic.barotropic_substeps(*args),
                            barotropic.barotropic_substeps_plain(*args)):
                ea, er = rel_err(g, w, I)
                check(er <= BANDS[name] and bool(torch.isfinite(g).all()),
                      f"barotropic {name} wrap={wrap}: rel err {er:.3e}")
                errs.append((ea, er))
        check(all(torch.equal(a, b) for a, b in zip(kept, (static, eta, U, V, GU, GV))),
              f"barotropic {name}: inputs unchanged")
        # where the tiles do not fit the plane: a plane smaller than one tile, planes
        # no tile divides, and substep counts that leave a short last launch
        odd = []
        for substeps, Ny, Nx in ((10, 10, 12), (24, 53, 37), (30, 53, 37), (44, 61, 97),
                                 (50, 61, 97)):
            w_np = averaging_weights(substeps)[1]
            n, H = len(w_np), len(w_np) + 1
            sp = rnd((9, Ny + 2 * H, Nx + 2 * H), lo=0.5)
            sp[7:] = (sp[7:] > 0.6).to(dt)
            dyn = [rnd(sp.shape[1:], 0.01) for _ in range(3)] + [
                rnd(sp.shape[1:], 1e-3) for _ in range(2)]
            planes = [sp, *dyn]
            kept = [a.clone() for a in planes]
            for wrap in (False, True):
                args = (*planes, dtau, torch.as_tensor(w_np, dtype=dt, device="cuda"), Nx,
                        H, wrap)
                Iv = (slice(n, -n), slice(None) if wrap else slice(n, -n))
                for g, w in zip(barotropic.barotropic_substeps(*args),
                                barotropic.barotropic_substeps_plain(*args)):
                    er = rel_err(g, w, Iv)[1]
                    halo = not wrap or (torch.equal(g[:, :H], g[:, Nx:Nx + H]) and
                                        torch.equal(g[:, H + Nx:], g[:, H:2 * H]))
                    check(er <= BANDS[name] and bool(torch.isfinite(g).all()) and halo,
                          f"barotropic {name} {tuple(sp.shape[1:])} {n} substeps "
                          f"wrap={wrap}: rel err {er:.3e}, halo columns bitwise {halo}")
                    odd.append(er)
            check(all(torch.equal(a, b) for a, b in zip(kept, planes)),
                  f"barotropic {name} {tuple(sp.shape[1:])}: inputs unchanged")
        log(f"phase 2: barotropic {name} on five planes from (26, 28) to (135, 171) with "
            f"7, 17, 21, 31 and 36 substeps, wrap on and off: max rel err {max(odd):.3e} "
            f"(band {BANDS[name]:g}), finite, inputs unchanged, wrapped halo columns "
            f"bitwise [{card}]")
        args = (static, eta, U, V, GU, GV, dtau, weights, 1440, 22, False)
        t_k = time_ms(lambda: barotropic.barotropic_substeps(*args), n=10)
        t_p = time_ms(lambda: barotropic.barotropic_substeps_plain(*args), n=10)
        ea = max(e[0] for e in errs)
        log(f"phase 2: barotropic {name}: max abs err {ea:.3e}, max rel err "
            f"{max(e[1] for e in errs):.3e} (band {BANDS[name]:g}); 21 substeps on "
            f"(724, 1484) {t_k:.4f} ms kernel, {t_p:.4f} ms plain [{card}]")
        if name == "float32":
            results["barotropic"] = (ea, t_k, t_p, bound(
                nbytes(static, eta, U, V, GU, GV) + 3 * nbytes(eta),
                FLOPS["barotropic"] * weights.numel() * eta.numel()))

        # momentum and tracer advection on the base plane
        Yb, Xb = FILL_SHAPES["base"]
        u, v = rnd((Yb, Xb)), rnd((Yb, Xb))
        st = rnd((10, Yb, Xb), lo=1.0)
        st[3] = 0.1 * rnd((Yb, Xb))
        st[8:] = (st[8:] > 1.15).to(dt)
        R = momentum.REACH
        I = (slice(R, -R), slice(R, -R))
        errs = [rel_err(g, w, I) for g, w in zip(momentum.momentum(u, v, st),
                                                  momentum.momentum_plain(u, v, st))]
        er = max(e[1] for e in errs)
        check(er <= BANDS[name], f"momentum {name}: rel err {er:.3e}")
        t_k = time_ms(lambda: momentum.momentum(u, v, st))
        t_p = time_ms(lambda: momentum.momentum_plain(u, v, st))
        ea = max(e[0] for e in errs)
        log(f"phase 2: momentum {name}: max abs err {ea:.3e}, max rel err {er:.3e} "
            f"(band {BANDS[name]:g}); (690, 1450) {t_k:.4f} ms kernel, {t_p:.4f} ms "
            f"plain [{card}]")
        if name == "float32":
            results["momentum"] = (ea, t_k, t_p, bound(
                nbytes(u, v, st) + 2 * nbytes(u), FLOPS["momentum"] * u.numel()))

        c = rnd((Yb, Xb))
        sa = rnd((5, Yb, Xb), lo=1.0)
        R = tracer_adv.REACH
        ea, er = rel_err(tracer_adv.tracer_adv(c, u, v, sa),
                         tracer_adv.tracer_adv_plain(c, u, v, sa),
                         (slice(R, -R), slice(R, -R)))
        check(er <= BANDS[name], f"tracer_adv {name}: rel err {er:.3e}")
        t_k = time_ms(lambda: tracer_adv.tracer_adv(c, u, v, sa))
        t_p = time_ms(lambda: tracer_adv.tracer_adv_plain(c, u, v, sa))
        log(f"phase 2: tracer_adv {name}: max abs err {ea:.3e}, max rel err {er:.3e} "
            f"(band {BANDS[name]:g}); (690, 1450) {t_k:.4f} ms kernel, {t_p:.4f} ms "
            f"plain [{card}]")
        if name == "float32":
            results["tracer_adv"] = (ea, t_k, t_p, bound(
                nbytes(c, u, v, sa) + nbytes(c), FLOPS["tracer_adv"] * c.numel()))
    return results


def fill_groups(rnd):
    """The fill groups of the main paths at full width, η, U and V views of one
    (3, 724, 1484) buffer as the barotropic kernel returns them, and a group of three
    fields on planes no block of 256 threads divides: {name: (state group, the GU/GV
    group or None)}."""
    from orthogonalsphericalshellgrids_tpu_torch.ops.location import CC, CF, FC, FF

    (Yb, Xb), (Ye, Xe) = FILL_SHAPES["base"], FILL_SHAPES["ext"]

    def base(K, loc, sign):
        return (rnd((Yb, Xb) if K is None else (K, Yb, Xb)), loc, sign, 1440, 680, 5, 5)

    def ext():
        buf = rnd((3, Ye, Xe))
        return [(buf[0], CC, 1, 1440, 680, 22, 22), (buf[1], FC, -1, 1440, 680, 22, 22),
                (buf[2], CF, -1, 1440, 680, 22, 22)]

    forcing = [(rnd((Ye, Xe)), FC, -1, 1440, 680, 22, 22),
               (rnd((Ye, Xe)), CF, -1, 1440, 680, 22, 22)]
    uv = [(FC, -1), (CF, -1)]
    return {
        "Bickley": ([base(None, *a) for a in uv + [(CC, 1)]] + ext(), forcing),
        "front": ([base(10, *a) for a in uv + [(CC, 1), (CC, 1)]] + ext(), None),
        "gyre": ([base(10, *a) for a in uv] + [base(20, CC, 1)] + ext(), None),
        "odd": ([(rnd((3, 13 + 6, 18 + 8)), FC, -1, 18, 13, 4, 3),
                 (rnd((137 + 4, 172 + 6)), CF, -1, 172, 137, 3, 2),
                 (rnd((2, 9 + 2, 10 + 4)), FF, 1, 10, 9, 2, 1)], None),
    }


def fill_cells(fields):
    """(cells the group fill writes, distinct cells it reads): the written cells of the
    plan's packed order, and the sources of their values, found by filling a plane of
    distinct ids with the plain fill."""
    import torch

    from orthogonalsphericalshellgrids_tpu_torch.kernels import halo_fill

    written = read = 0
    for A, loc, sign, Nx, Ny, Hx, Hy in fields:
        K = A.shape[0] if A.dim() == 3 else 1
        Yb, Xb = A.shape[-2:]
        ids = torch.arange(1, Yb * Xb + 1, dtype=torch.float64).view(Yb, Xb)
        halo_fill.fill_halos_plain(ids, loc, sign, Nx, Ny, Hx, Hy)
        y, x = halo_fill.plane_cells(*halo_fill._geometry("fill", A, loc, Nx, Ny, Hx,
                                                          Hy)[1:])
        written += K * y.size
        read += K * int(ids[y, x].abs().unique().numel())
    return written, read


def phase2_fill_groups(card):
    """The group fill with save, the fill without save and the group restore against
    their plain versions, bitwise, on each main path's group and on the odd group, at
    float32 and float64; each launch timed beside its plain version. Returns the
    kernel-table rows (the Bickley group's state fill and restore) and the other
    groups' times."""
    import numpy as np
    import torch

    from orthogonalsphericalshellgrids_tpu_torch import kernels
    from orthogonalsphericalshellgrids_tpu_torch.kernels import halo_fill

    results, times = {}, {}
    for name in ("float32", "float64"):
        dt = getattr(torch, name)
        rng = np.random.default_rng(11)

        def rnd(shape):
            return torch.as_tensor(rng.standard_normal(shape), dtype=dt, device="cuda")

        for group, (fields, forcing) in fill_groups(rnd).items():
            before = [f[0].clone() for f in fields]
            plain = [(f[0].clone(),) + f[1:] for f in fields]
            want, want_saved = halo_fill.fill_halos_group_plain(plain, save=True)
            want = [w.clone() for w in want]  # plain's fields are restored below
            kernels.reset_launch_counts()
            got, saved = halo_fill.fill_halos_group(fields, save=True)
            torch.cuda.synchronize()
            check(all(torch.equal(g, w) for g, w in zip(got, want)) and
                  torch.equal(saved, want_saved),
                  f"group fill with save {group} {name}: fields and strips bitwise")
            halo_fill.restore_strips_group(fields, saved)
            halo_fill.restore_strips_group_plain(plain, want_saved)
            torch.cuda.synchronize()
            check(all(torch.equal(f[0], b) and torch.equal(p[0], b)
                      for f, p, b in zip(fields, plain, before)),
                  f"group restore {group} {name}: every field bitwise as before")
            got, none = halo_fill.fill_halos_group(fields)
            torch.cuda.synchronize()
            check(none is None and all(torch.equal(g, w) for g, w in zip(got, want)),
                  f"group fill without save {group} {name} bitwise")
            halo_fill.restore_strips_group(fields, saved)
            counts = kernels.launch_counts()
            check(counts["halo_fill"] == 2 and counts["halo_restore"] == 2 and
                  sum(counts.values()) == 4, f"group {group}: one launch a call, {counts}")
            if name == "float64":
                log(f"phase 2: fill group {group} {name} ({len(fields)} fields): fill "
                    f"with save, restore and fill without save bitwise, inputs restored "
                    f"[{card}]")
                continue
            # the kernels' device time: the host enqueues each window while the card
            # spins; the plain versions wait for the card (ops/zipper.py copies its
            # index vectors from the host), so they are timed as called
            runs = {"fill_save": lambda: halo_fill.fill_halos_group(fields, True),
                    "restore": lambda: halo_fill.restore_strips_group(fields, saved),
                    "clone": lambda: [f[0].clone() for f in fields]}
            plain_runs = {
                "fill_save_plain": lambda: halo_fill.fill_halos_group_plain(fields, True),
                "restore_plain": lambda: halo_fill.restore_strips_group_plain(fields, saved)}
            if forcing is not None:
                runs["fill"] = lambda: halo_fill.fill_halos_group(forcing)
                plain_runs["fill_plain"] = lambda: halo_fill.fill_halos_group_plain(forcing)
            t = {k: time_ms(fn, ahead=True) for k, fn in runs.items()}
            t.update({k: time_ms(fn) for k, fn in plain_runs.items()})
            t["fill_save_called"] = time_ms(runs["fill_save"])
            written, read = fill_cells(fields)
            size = fields[0][0].element_size()
            b_fill, b_restore = bound(size * (3 * written + read), written), bound(
                2 * size * written, 0)
            log(f"phase 2: fill group {group} {name} ({len(fields)} fields, "
                f"{sum(f[0].numel() for f in fields)} cells, {written} written, {read} "
                f"read): fill with save, restore and fill without save bitwise, inputs "
                f"restored; kernels' device time with the host ahead: fill with save "
                f"{t['fill_save']:.4f} ms kernel, {t['fill_save_plain']:.4f} ms plain "
                f"(bound {b_fill[0]:.5f} ms, {b_fill[2]} bytes); restore "
                f"{t['restore']:.4f} ms kernel, {t['restore_plain']:.4f} ms plain (bound "
                f"{b_restore[0]:.5f} ms, {b_restore[2]} bytes); clone of the group "
                f"{t['clone']:.4f} ms"
                + (f"; GU/GV fill {t['fill']:.4f} ms kernel, {t['fill_plain']:.4f} ms "
                   f"plain" if forcing is not None else "")
                + f"; fill with save as called {t['fill_save_called']:.4f} ms [{card}]")
            times[group] = dict(t, written=written, read=read)
            if group == "Bickley":
                results["halo_fill"] = (0.0, t["fill_save"], t["fill_save_plain"], b_fill)
                results["halo_restore"] = (0.0, t["restore"], t["restore_plain"],
                                           b_restore)
            del fields, forcing, plain, want, want_saved, saved
    return results, times


def phase2_layered(card):
    """The layered kernels against their plain versions at the front's shapes;
    returns {name: (max_abs_err at float32, kernel ms, plain ms)} for the front's
    own cases (vertical in tracer_b mode with c + b, S = 3; one tracer stack)."""
    import numpy as np
    import torch

    from orthogonalsphericalshellgrids_tpu_torch.kernels import (halo_fill, momentum,
                                                                 tracer_adv, vertical)
    from orthogonalsphericalshellgrids_tpu_torch.ops.location import CC, CF, FC

    results = {}
    Yb, Xb = FILL_SHAPES["base"]
    eos = (9.81, 1.67e-4, 7.8e-4, 10.0, 35.0)
    for name in ("float32", "float64"):
        dt = getattr(torch, name)
        rng = np.random.default_rng(7)

        def rnd(shape, scale=1.0, lo=None):
            a = rng.random(shape) + lo if lo is not None else scale * rng.standard_normal(shape)
            return torch.as_tensor(a, dtype=dt, device="cuda")

        def masks(shape):
            return torch.as_tensor(rng.random(shape) > 0.15, dtype=dt, device="cuda")

        # the halo fill on a 10-plane stack, bitwise, in place and out of place
        for loc, sign in ((CC, 1), (FC, -1), (CF, -1)):
            A = rnd((10, Yb, Xb))
            A0 = A.clone()
            want = halo_fill.fill_halos_plain(A.clone(), loc, sign, 1440, 680, 5, 5)
            got = halo_fill.fill_halos(A.clone(), loc, sign, 1440, 680, 5, 5)
            copy = halo_fill.fill_halos(A, loc, sign, 1440, 680, 5, 5, inplace=False)
            torch.cuda.synchronize()
            check(torch.equal(got, want) and torch.equal(copy, want) and torch.equal(A, A0),
                  f"10-plane fill {loc} {name} bitwise, input kept")
        t_k = time_ms(lambda: halo_fill.fill_halos(A, CC, 1, 1440, 680, 5, 5,
                                                   inplace=False))
        t_p = time_ms(lambda: halo_fill.fill_halos_plain(A.clone(), CC, 1, 1440, 680, 5, 5))
        log(f"phase 2: halo_fill {name} on (10, 690, 1450): bitwise in place and out "
            f"of place (CC, FC, CF); out of place {t_k:.4f} ms kernel, {t_p:.4f} ms "
            f"plain [{card}]")

        # the vertical kernel, its masks from wet-layer counts drawn from 0 to Nz a
        # column: three modes at the front's shape (tracer_b with nu_v and kappa_v, the
        # front's call; linear EOS with them, the gyre's), Nz = 50 (the interfaces in
        # chunks), and three planes no tile divides in every mode with and without
        # nu_v and kappa_v: within the band, finite, the edge cells 0, inputs unchanged
        cases = [("none", 10, (Yb, Xb), False, None),
                 ("tracer_b", 10, (Yb, Xb), True, "vertical"),
                 ("linear_eos", 10, (Yb, Xb), True, "vertical_linear_eos"),
                 ("linear_eos", 10, (Yb, Xb), False, None),
                 ("tracer_b", 50, (200, 300), True, None)]
        cases += [(mode, 4, shape, mixing, None) for shape in ODD_PLANES
                  for mode in vertical.MODES for mixing in (False, True)]
        odd = []
        for mode, nz, (ny, nx), mixing, row in cases:
            n_wet = torch.as_tensor(np.minimum(rng.integers(0, nz + 3, (ny, nx)), nz),
                                    dtype=torch.int32, device="cuda")
            _, mu, mv = vertical.wet_pack(n_wet, nz, 3, dt).reshape(
                nz, 3, ny, nx).transpose(0, 1)
            u, v = rnd((nz, ny, nx)) * mu, rnd((nz, ny, nx)) * mv
            n_c = 2 if mode == "linear_eos" else 1
            c = rnd((n_c * nz, ny, nx))
            if mode == "linear_eos":
                c[:nz] += 10.0
                c[nz:] = 35.0 + 0.1 * c[nz:]
            b = rnd((nz, ny, nx)) if mode == "tracer_b" else None
            g = rnd((5, ny, nx), lo=0.5)
            dzs = [100.0] * nz
            coef = torch.as_tensor(vertical.coefficients(
                dzs, dzs[1:], 1e-4 if mixing else 0.0, 1e-5 if mixing else 0.0),
                dtype=dt, device="cuda")
            kw = dict(mode=mode, eos=eos, it_T=0 if n_c == 2 else -1,
                      it_S=1 if n_c == 2 else -1, viscous=mixing, diffusive=mixing)
            args = (u, v, c, b, n_wet, g, coef)
            kept = [a.clone() for a in args if a is not None]
            s_pack = vertical.wet_pack(n_wet, nz, 3 if mixing else 1, dt)
            got = vertical.vertical(*args, **kw)
            want = vertical.vertical_plain(u, v, c, b, s_pack, g, coef, **kw)
            torch.cuda.synchronize()
            I = (slice(1, -1), slice(1, -1))
            errs = [rel_err(gk, wp, I) for gk, wp in zip(got, want)]
            ea, er = max(e[0] for e in errs), max(e[1] for e in errs)
            edge = all(edge_zero(gk, vertical.REACH) and bool(torch.isfinite(gk).all())
                       for gk in got)
            check(er <= BANDS[name] and edge and all(
                torch.equal(a, k) for a, k in zip((a for a in args if a is not None), kept)),
                f"vertical {mode} Nz={nz} ({ny}, {nx}) mixing={mixing} {name}: rel err "
                f"{er:.3e}, finite with the edge 0 {edge}, inputs unchanged")
            if (ny, nx) in ODD_PLANES:
                odd.append(er)
                continue
            t_k = time_ms(lambda: vertical.vertical(*args, **kw))
            t_p = time_ms(lambda: vertical.vertical_plain(u, v, c, b, s_pack, g, coef, **kw),
                          n=3, reps=3)
            log(f"phase 2: vertical {mode} {name} on ({nz}, {ny}, {nx}) with "
                f"{n_c + (b is not None)} tracer blocks{', nu_v and kappa_v' if mixing else ''}"
                f": max abs err {ea:.3e}, max rel err {er:.3e} (band {BANDS[name]:g}); "
                f"{t_k:.4f} ms kernel, {t_p:.4f} ms plain [{card}]")
            if name == "float32" and row is not None:
                # dGu, dGv and dGc have the shapes of u, v and c (+ b); the front's
                # mode is the table's row, the gyre's (linear EOS) has its bound in
                # phase 9
                n_out = c.numel() + (b.numel() if b is not None else 0)
                results[row] = (ea, t_k, t_p, bound(
                    nbytes(*args) + nbytes(u, v, c, b),
                    FLOPS["vertical"] * (u.numel() + n_out)))
        log(f"phase 2: vertical {name} on {', '.join(str(p) for p in ODD_PLANES)} at Nz "
            f"= 4, three modes with and without nu_v and kappa_v: max rel err "
            f"{max(odd):.3e} (band {BANDS[name]:g}), finite, edge cells 0, inputs "
            f"unchanged [{card}]")

        # layered momentum at Nz = 10 (8 shared planes, no masks), without operands
        # and with the front's: acc (dGu, dGv, O(1e-1..1) of G) and the closing mask
        u, v = rnd((10, Yb, Xb)), rnd((10, Yb, Xb))
        st = rnd((8, Yb, Xb), lo=1.0)
        st[3] = 0.1 * rnd((Yb, Xb))
        R = momentum.REACH
        I = (slice(R, -R), slice(R, -R))
        fold = dict(acc=(rnd((10, Yb, Xb), 0.5), rnd((10, Yb, Xb), 0.5)),
                    mask_out=(masks((10, Yb, Xb)), masks((10, Yb, Xb))))
        for label, kw in (("without operands", {}), ("with acc and mask_out", fold)):
            errs = [rel_err(gk, wp, I) for gk, wp in zip(
                momentum.momentum(u, v, st, has_mask=False, **kw),
                momentum.momentum_plain(u, v, st, has_mask=False, **kw))]
            ea, er = max(e[0] for e in errs), max(e[1] for e in errs)
            check(er <= BANDS[name], f"layered momentum {label} {name}: rel err {er:.3e}")
            t_k = time_ms(lambda: momentum.momentum(u, v, st, has_mask=False, **kw))
            t_p = time_ms(lambda: momentum.momentum_plain(u, v, st, has_mask=False, **kw),
                          n=5)
            log(f"phase 2: momentum_layered {name} on (10, 690, 1450) {label}: max abs "
                f"err {ea:.3e}, max rel err {er:.3e} (band {BANDS[name]:g}); {t_k:.4f} ms "
                f"kernel, {t_p:.4f} ms plain [{card}]")
        if name == "float32":  # the front's call: the operands' 4 stacks count
            results["momentum_layered"] = (ea, t_k, t_p, bound(
                nbytes(u, v, st, *fold["acc"], *fold["mask_out"]) + 2 * nbytes(u),
                FLOPS["momentum_layered"] * u.numel()))

        # layered tracer advection, one and two tracer stacks over masked velocities
        mask = masks((10, Yb, Xb))
        u, v = u * mask, v * mask
        iv = rnd((10, Yb, Xb), lo=0.5) * mask
        g2 = rnd((2, Yb, Xb), lo=0.5)
        dz = torch.full((10,), 100.0, dtype=dt, device="cuda")
        R = tracer_adv.REACH
        for n_tr in (1, 2):
            c = rnd((n_tr * 10, Yb, Xb))
            args = (c, u, v, iv, g2, dz)
            # the front's call adds dGc in the kernel (acc, O(1e-1..1) of G)
            kw = dict(acc=rnd(c.shape, 0.5)) if n_tr == 1 else {}
            ea, er = rel_err(tracer_adv.tracer_adv(*args, **kw),
                             tracer_adv.tracer_adv_plain(*args, **kw),
                             (slice(R, -R), slice(R, -R)))
            check(er <= BANDS[name], f"layered tracer_adv n_tr={n_tr} {name}: rel err "
                  f"{er:.3e}")
            t_k = time_ms(lambda: tracer_adv.tracer_adv(*args, **kw))
            t_p = time_ms(lambda: tracer_adv.tracer_adv_plain(*args, **kw), n=5)
            # the same call on an all-zero c (the front's own tracer): IEEE division's
            # slow path on zero dividends would show here
            zargs = (torch.zeros_like(c),) + args[1:]
            t_z = time_ms(lambda: tracer_adv.tracer_adv(*zargs, **kw))
            log(f"phase 2: tracer_adv_layered {name} with {n_tr} tracer stack(s) on "
                f"({10 * n_tr}, 690, 1450){' with acc' if kw else ''}: max abs err "
                f"{ea:.3e}, max rel err {er:.3e} (band {BANDS[name]:g}); {t_k:.4f} ms "
                f"kernel on random c, {t_z:.4f} ms on an all-zero c, {t_p:.4f} ms plain "
                f"[{card}]")
            if name == "float32" and n_tr == 1:
                results["tracer_adv_layered"] = (ea, t_k, t_p, bound(
                    nbytes(*args, kw["acc"]) + nbytes(c),
                    FLOPS["tracer_adv_layered"] * c.numel()))
    return results


def phase2_gyre(card):
    """The gyre's kernel modes against their plain versions at (10, 690, 1450):
    momentum with the nu_h and drag planes (one masked layer, 10 layers), tracer
    advection with kappa_h (column, and layered over T and S), the corrector with
    and without b. Returns {name: (max_abs_err at float32, kernel ms, plain ms,
    bound)} for the gyre's own cases."""
    import numpy as np
    import torch

    from orthogonalsphericalshellgrids_tpu_torch.kernels import (corrector, momentum,
                                                                 tracer_adv)

    results = {}
    Yb, Xb = FILL_SHAPES["base"]
    nz = 10
    for name in ("float32", "float64"):
        dt = getattr(torch, name)
        rng = np.random.default_rng(11)

        def rnd(shape, scale=1.0, lo=None):
            a = rng.random(shape) + lo if lo is not None else scale * rng.standard_normal(shape)
            return torch.as_tensor(a, dtype=dt, device="cuda")

        def masks(shape):
            return torch.as_tensor(rng.random(shape) > 0.15, dtype=dt, device="cuda")

        # momentum with 6 Laplacian and 2 drag planes a layer
        R = momentum.REACH
        I = (slice(R, -R), slice(R, -R))
        for layers in (1, nz):
            shape = (Yb, Xb) if layers == 1 else (layers, Yb, Xb)
            u, v = rnd(shape), rnd(shape)
            st = rnd((10 if layers == 1 else 8, Yb, Xb), lo=1.0)
            st[3] = 0.1 * rnd((Yb, Xb))
            if layers == 1:
                st[8:] = (st[8:] > 1.15).to(dt)
            # each fused term O(1e-1..1) of Gu, so that the float32 band sees it
            lay = rnd((layers, 8, Yb, Xb), lo=0.5)
            lay[:, 6:] *= 0.1
            lay = lay.reshape(8 * layers, Yb, Xb)
            kw = dict(has_mask=layers == 1, lay=lay, has_lap=True, has_drag=True)
            if layers == nz:  # the gyre's call: acc and the closing mask as well
                kw.update(acc=(rnd(shape, 0.5), rnd(shape, 0.5)),
                          mask_out=(masks(shape), masks(shape)))
            errs = [rel_err(gk, wp, I) for gk, wp in zip(momentum.momentum(u, v, st, **kw),
                                                         momentum.momentum_plain(u, v, st,
                                                                                 **kw))]
            ea, er = max(e[0] for e in errs), max(e[1] for e in errs)
            check(er <= BANDS[name], f"momentum closures Nz={layers} {name}: rel err {er:.3e}")
            t_k = time_ms(lambda: momentum.momentum(u, v, st, **kw))
            t_p = time_ms(lambda: momentum.momentum_plain(u, v, st, **kw), n=5)
            log(f"phase 2: momentum_closures {name} on {tuple(u.shape)} with nu_h and drag "
                f"planes{' and acc and mask_out' if 'acc' in kw else ''}: max abs err "
                f"{ea:.3e}, max rel err {er:.3e} (band {BANDS[name]:g}); {t_k:.4f} ms "
                f"kernel, {t_p:.4f} ms plain [{card}]")
            if name == "float32" and layers == nz:
                results["momentum_closures"] = (ea, t_k, t_p, bound(
                    nbytes(u, v, st, lay, *kw["acc"], *kw["mask_out"]) + 2 * nbytes(u),
                    FLOPS["momentum_closures"] * u.numel()))

        # tracer advection with kappa_h: column (8-plane pack) and layered (T and S,
        # S = 4 a layer) over masked velocities
        R = tracer_adv.REACH
        I = (slice(R, -R), slice(R, -R))
        c = rnd((Yb, Xb))
        u, v = rnd((Yb, Xb)), rnd((Yb, Xb))
        sa = rnd((8, Yb, Xb), lo=1.0)
        sa[7] *= 0.1  # k_c: the kappa_h term O(1e-1..1) of G
        cases = [("column", (c, u, v, sa))]
        mask = masks((nz, Yb, Xb))
        u3, v3 = rnd((nz, Yb, Xb)) * mask, rnd((nz, Yb, Xb)) * mask
        pack = (mask[:, None] * rnd((nz, 4, Yb, Xb), lo=0.5)).reshape(4 * nz, Yb, Xb)
        dz = torch.full((nz,), 100.0, dtype=dt, device="cuda")
        cases.append(("layered", (rnd((2 * nz, Yb, Xb)), u3, v3, pack,
                                  rnd((2, Yb, Xb), lo=0.5), dz)))
        for mode, args in cases:
            # the gyre's layered call adds dGc in the kernel (acc)
            kw = dict(acc=rnd(args[0].shape, 0.5)) if mode == "layered" else {}
            ea, er = rel_err(tracer_adv.tracer_adv(*args, **kw),
                             tracer_adv.tracer_adv_plain(*args, **kw), I)
            check(er <= BANDS[name], f"tracer_adv kappa {mode} {name}: rel err {er:.3e}")
            t_k = time_ms(lambda: tracer_adv.tracer_adv(*args, **kw))
            t_p = time_ms(lambda: tracer_adv.tracer_adv_plain(*args, **kw), n=5)
            log(f"phase 2: tracer_adv_kappa {mode} {name} on {tuple(args[0].shape)}"
                f"{' with acc' if kw else ''}: max abs err {ea:.3e}, max rel err {er:.3e} "
                f"(band {BANDS[name]:g}); {t_k:.4f} ms kernel, {t_p:.4f} ms plain [{card}]")
            if name == "float32" and mode == "layered":
                results["tracer_adv_kappa"] = (ea, t_k, t_p, bound(
                    nbytes(*args, kw["acc"]) + nbytes(args[0]),
                    FLOPS["tracer_adv_kappa"] * args[0].numel()))

        # the corrector: the gyre's T and S (P = 20, no b) and the front's c and b;
        # U_a and V_a cropped out of the widened free-surface plane
        Ye, Xe = FILL_SHAPES["ext"]
        dy, dx = (Ye - Yb) // 2, (Xe - Xb) // 2
        mu, mv, mc = masks((nz, Yb, Xb)), masks((nz, Yb, Xb)), masks((nz, Yb, Xb))
        dz3 = torch.as_tensor(np.linspace(10.0, 400.0, nz), dtype=dt,
                              device="cuda").view(-1, 1, 1)
        ext = rnd((2, Ye, Xe))
        for n_c, with_b in ((2, False), (1, True)):
            stacks = [rnd((nz, Yb, Xb)) for _ in range(6)]
            tracers = [rnd((n_c * nz, Yb, Xb)) for _ in range(3)]
            b = tuple(rnd((nz, Yb, Xb)) for _ in range(3)) if with_b else None
            args = (*stacks, *tracers, dz3 * mu, dz3 * mv, mc, rnd((Yb, Xb), lo=0.0),
                    rnd((Yb, Xb), lo=0.0), ext[0, dy:dy + Yb, dx:dx + Xb],
                    ext[1, dy:dy + Yb, dx:dx + Xb], *(torch.tensor(x, dtype=dt, device="cuda")
                                                      for x in (1.6, 0.6, 40.0)))
            got = corrector.corrector(*args, b=b)
            want = corrector.corrector_plain(*args, b=b)
            errs = [rel_err(g, w, (slice(None), slice(None)))
                    for g, w in zip(got, want) if w is not None]
            ea, er = max(e[0] for e in errs), max(e[1] for e in errs)
            label = "T and S" if n_c == 2 else "c and b"
            check(er <= BANDS[name], f"corrector {label} {name}: rel err {er:.3e}")
            t_k = time_ms(lambda: corrector.corrector(*args, b=b))
            t_p = time_ms(lambda: corrector.corrector_plain(*args, b=b), n=5)
            log(f"phase 2: corrector {name} on ({nz}, {Yb}, {Xb}) with {label} (20 tracer "
                f"planes): max abs err {ea:.3e}, max rel err {er:.3e} (band "
                f"{BANDS[name]:g}); {t_k:.4f} ms kernel, {t_p:.4f} ms plain [{card}]")
            if name == "float32" and n_c == 2:
                results["corrector"] = (ea, t_k, t_p, bound(
                    nbytes(*args) + nbytes(*got),
                    FLOPS["corrector"] * sum(g.numel() for g in got if g is not None)))
    return results


def phase2_operands(card):
    """acc/mask_out in every mode of the momentum kernel and every mode of the tracer
    kernel with and without acc, at float32 and float64, on the main shape and on
    three planes the tiles do not divide: within the band, finite, the edge cells 0,
    the inputs unchanged."""
    import numpy as np
    import torch

    from orthogonalsphericalshellgrids_tpu_torch.kernels import momentum, tracer_adv

    R = momentum.REACH
    shapes = [FILL_SHAPES["base"]] + ODD_PLANES
    # (layers, has_lap, has_drag, acc, mask_out); 1 is one masked layer
    modes = [(1, False, False, True, True), (1, True, True, True, False),
             (10, False, False, True, True), (10, False, False, False, True),
             (10, True, True, True, True), (10, False, True, True, False),
             (10, True, False, True, True)]
    worst = {}
    for name in ("float32", "float64"):
        dt = getattr(torch, name)
        rng = np.random.default_rng(19)

        def rnd(shape, scale=1.0, lo=None):
            a = rng.random(shape) + lo if lo is not None else scale * rng.standard_normal(shape)
            return torch.as_tensor(a, dtype=dt, device="cuda")

        def masks(shape):
            return torch.as_tensor(rng.random(shape) > 0.15, dtype=dt, device="cuda")

        errs = []
        for Yb, Xb in shapes:
            I = (slice(R, -R), slice(R, -R))
            for layers, lap, drag, acc, out in modes:
                shape = (Yb, Xb) if layers == 1 else (layers, Yb, Xb)
                u, v = rnd(shape), rnd(shape)
                st = rnd((10 if layers == 1 else 8, Yb, Xb), lo=1.0)
                st[3] = 0.1 * rnd((Yb, Xb))
                if layers == 1:
                    st[8:] = (st[8:] > 1.15).to(dt)
                L = 6 * lap + 2 * drag
                kw = dict(has_mask=layers == 1, has_lap=lap, has_drag=drag, lay=None)
                if L:
                    lay = rnd((layers, L, Yb, Xb), lo=0.5)
                    lay[:, 6 * lap:] *= 0.1
                    kw["lay"] = lay.reshape(layers * L, Yb, Xb)
                if acc:
                    kw["acc"] = (rnd(shape, 0.5), rnd(shape, 0.5))
                if out:
                    kw["mask_out"] = (masks(shape), masks(shape))
                kept = [a.clone() for a in (u, v, st)]
                got = momentum.momentum(u, v, st, **kw)
                want = momentum.momentum_plain(u, v, st, **kw)
                torch.cuda.synchronize()
                for g, w in zip(got, want):
                    edge = all(bool((strip == 0).all()) for strip in (
                        g[..., :R, :], g[..., -R:, :], g[..., :R], g[..., -R:]))
                    er = rel_err(g, w, I)[1] if min(Yb, Xb) > 2 * R + 1 else 0.0
                    check(er <= BANDS[name] and bool(torch.isfinite(g).all()) and edge and
                          all(torch.equal(a, b) for a, b in zip(kept, (u, v, st))),
                          f"momentum {name} {shape} lap={lap} drag={drag} acc={acc} "
                          f"mask_out={out}: rel err {er:.3e}, edge zeros {edge}")
                    errs.append(er)
        # the tracer kernel in every mode with and without acc: column (5 and 8
        # planes) and layered (1 and 2 tracer blocks, S = 1 and 4) over masked
        # velocities, 10 layers
        R = tracer_adv.REACH
        for Yb, Xb in shapes:
            I = (slice(R, -R), slice(R, -R))
            mask = masks((10, Yb, Xb))
            u3, v3 = rnd((10, Yb, Xb)) * mask, rnd((10, Yb, Xb)) * mask
            g2 = rnd((2, Yb, Xb), lo=0.5)
            dz = torch.full((10,), 100.0, dtype=dt, device="cuda")
            cases = [(rnd((Yb, Xb)), rnd((Yb, Xb)), rnd((Yb, Xb)), rnd((S, Yb, Xb), lo=1.0))
                     for S in (5, 8)]
            cases += [(rnd((n_tr * 10, Yb, Xb)), u3, v3,
                       (mask[:, None] * rnd((10, S, Yb, Xb), lo=0.5)).reshape(S * 10, Yb, Xb),
                       g2, dz) for n_tr in (1, 2) for S in (1, 4)]
            for args in cases:
                for a in (None, rnd(args[0].shape, 0.5)):
                    kept = [x.clone() for x in args]
                    g = tracer_adv.tracer_adv(*args, acc=a)
                    want = tracer_adv.tracer_adv_plain(*args, acc=a)
                    torch.cuda.synchronize()
                    er = rel_err(g, want, I)[1] if min(Yb, Xb) > 2 * R + 1 else 0.0
                    edge = edge_zero(g, R)
                    check(er <= BANDS[name] and bool(torch.isfinite(g).all()) and edge and
                          all(torch.equal(x, k) for x, k in zip(args, kept)),
                          f"tracer_adv {name} {tuple(args[0].shape)} pack "
                          f"{tuple(args[3].shape)} acc={a is not None}: rel err {er:.3e}, "
                          f"edge zeros {edge}")
                    errs.append(er)
        worst[name] = max(errs)
        log(f"phase 2: operands {name}: momentum with acc/mask_out in 7 modes and "
            f"tracer_adv with and without acc in column (5 and 8 planes) and layered "
            f"mode (1 and 2 tracers, S = 1 and 4) on {', '.join(str(sh) for sh in shapes)}"
            f": max rel err {worst[name]:.3e} (band {BANDS[name]:g}), finite, edge cells "
            f"0, inputs unchanged [{card}]")
    return worst


def phase3_main_path(card, n_steps=20, warm=3):
    """The 1/4-degree Bickley jet through the kernels; returns the launch counts,
    ms/step, and the model with its initial state for phase 12."""
    import torch

    from examples.bickley_jet_torch import build
    from orthogonalsphericalshellgrids_tpu_torch import kernels
    from orthogonalsphericalshellgrids_tpu_torch.models import multi_step

    t0 = time.perf_counter()
    model, state = build(1440, 680, dtype=torch.float32, substeps=30, device="cuda")
    state0 = state
    torch.cuda.synchronize()
    log(f"phase 3: built the 1440 x 680 model in {time.perf_counter() - t0:.1f} s "
        f"(base {tuple(state.u.shape)}, free surface {tuple(state.eta.shape)}, "
        f"{model.weights.shape[0]} substeps)")
    state = multi_step(model, state, 60.0, warm)
    torch.cuda.synchronize()

    kernels.reset_launch_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    state = multi_step(model, state, 60.0, n_steps)
    end.record()
    end.synchronize()
    counts = kernels.launch_counts()
    ms = start.elapsed_time(end) / n_steps
    expected = {k: 0 for k in counts}
    expected.update(halo_fill=2 * n_steps, halo_restore=n_steps, momentum=n_steps,
                    tracer_adv=n_steps, barotropic=n_steps)
    check(counts == expected, f"launch counts {counts} != {expected}")
    check(tuple(state.u.shape) == (690, 1450) and tuple(state.eta.shape) == (724, 1484),
          "state shapes")
    for name in ("u", "v", "c", "eta", "U", "V"):
        check(bool(torch.isfinite(getattr(state, name)).all()), f"{name} finite")
    cmin, cmax = float(state.c.min()), float(state.c.max())
    check(-1 - 1e-3 <= cmin and cmax <= 1 + 1e-3, f"c in [-1, 1]: [{cmin}, {cmax}]")
    umax = float(state.u.abs().max())
    log(f"phase 3: {n_steps} steps after {warm} warm-up: {ms:.4f} ms/step "
        f"({1440 * 680 / ms / 1e6:.4f} G grid-points/s), launches {counts}, "
        f"max|u| {umax:.4f}, c in [{cmin:.6f}, {cmax:.6f}] [{card}]")
    return counts, ms, model, state0


def phase4_parity(card):
    import numpy as np
    import torch

    from examples.bickley_jet_torch import build, diagnostics
    from orthogonalsphericalshellgrids_tpu_torch import kernels
    from orthogonalsphericalshellgrids_tpu_torch.models import step

    with np.load(os.path.join(ROOT, "tests", "data", "bickley_oracle_180x90.npz")) as d:
        nx, ny, dt, _, _ = d["meta"]
        ref = {k: d[k] for k in ("u.020", "v.020", "c.020", "eta.020")}
        curves = {k: d[k][:20] for k in ("ke", "ens", "cvar")}
    model, s = build(int(nx), int(ny), dtype=torch.float64, substeps=30, device="cuda")
    kernels.reset_launch_counts()
    got = {"ke": [], "ens": [], "cvar": []}
    for _ in range(20):
        s = step(model, s, float(dt))
        for k, val in zip(("ke", "ens", "cvar"), diagnostics(model, s)):
            got[k].append(val)
    check(kernels.launch_counts()["barotropic"] == 20, "parity run used the kernels")
    g, ge = model.grid, model.grid_ext
    fields = {"u": s.u.cpu().numpy()[g.interior2d], "v": s.v.cpu().numpy()[g.interior2d],
              "c": s.c.cpu().numpy()[g.interior2d],
              "eta": ge.interior(s.eta).cpu().numpy()}
    worst = []
    for name, a in fields.items():
        r = ref[f"{name}.020"]
        diff = float(np.abs(a - r).max())
        worst.append(f"{name} {diff:.3e}")
        check(np.allclose(a, r, rtol=1e-9, atol=1e-12), f"oracle {name}: max diff {diff}")
    for k, ref_curve in curves.items():
        rel = float(np.max(np.abs(np.asarray(got[k]) / ref_curve - 1.0)))
        worst.append(f"{k} rel {rel:.3e}")
        check(np.allclose(got[k], ref_curve, rtol=1e-10, atol=0), f"oracle {k}: rel {rel}")
    log(f"phase 4: 180 x 90 float64 oracle, 20 steps through the kernels: max |diff| "
        f"{', '.join(worst)} (rtol 1e-9, atol 1e-12; curves rtol 1e-10) [{card}]")


def phase5_layered_path(card, n_steps=10, warm=3):
    """The 1/4-degree x 10 baroclinic front through the kernels; returns the launch
    counts."""
    import torch

    from examples.baroclinic_front_torch import build
    from orthogonalsphericalshellgrids_tpu_torch import kernels
    from orthogonalsphericalshellgrids_tpu_torch.models import layered_multi_step

    t0 = time.perf_counter()
    model, state = build(1440, 680, 10, dtype=torch.float32, substeps=30, device="cuda")
    torch.cuda.synchronize()
    log(f"phase 5: built the 1440 x 680 x 10 front in {time.perf_counter() - t0:.1f} s "
        f"(stacks {tuple(state.u.shape)}, free surface {tuple(state.eta.shape)}, "
        f"{model.baro.weights.shape[0]} substeps)")
    dt = 40.0
    state = layered_multi_step(model, state, dt, warm)
    torch.cuda.synchronize()

    kernels.reset_launch_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    state = layered_multi_step(model, state, dt, n_steps)
    end.record()
    end.synchronize()
    counts = kernels.launch_counts()
    ms = start.elapsed_time(end) / n_steps
    expected = {k: 0 for k in counts}
    expected.update(halo_fill=2 * n_steps, halo_restore=n_steps, vertical=n_steps,
                    momentum_layered=n_steps, tracer_adv_layered=2 * n_steps,
                    barotropic=n_steps, corrector=n_steps)
    check(counts == expected, f"layered launch counts {counts} != {expected}")
    check(tuple(state.u.shape) == (10, 690, 1450) and tuple(state.eta.shape) == (724, 1484),
          "layered state shapes")
    for name in ("u", "v", "c", "b", "eta", "U", "V"):
        check(bool(torch.isfinite(getattr(state, name)).all()), f"front {name} finite")
    umax = float(state.u.abs().max())
    bmin, bmax = float(state.b.min()), float(state.b.max())
    pts = 1440 * 680 * 10
    log(f"phase 5: {n_steps} front steps after {warm} warm-up at dt = {dt:g} s: "
        f"{ms:.4f} ms/step ({pts / ms / 1e6:.4f} G grid-points/s), launches {counts}, "
        f"max|u| {umax:.6f}, b in [{bmin:.6e}, {bmax:.6e}] [{card}]")
    tracer_on_own_fields(card, "phase 5", model, state)
    return counts, ms


def tracer_on_own_fields(card, phase, model, state):
    """The layered tracer call on the path's own fields (the front's all-zero c and
    its b; the gyre's land-masked T and S) beside random fields of the same shape:
    the slow path of IEEE division on zero dividends would show as a gap."""
    from benchmarks.torch_profile_layered import tracer_operands

    for label, r in tracer_operands(model, state).items():
        log(f"{phase}: tracer_adv on {label}: {r['ms']:.4f} ms ({r['zero_share']:.1%} "
            f"exact zeros in c) [{card}]")


def phase6_layered_parity(card):
    import numpy as np
    import torch

    from examples.baroclinic_front_torch import build, kinetic_energy
    from orthogonalsphericalshellgrids_tpu_torch import kernels
    from orthogonalsphericalshellgrids_tpu_torch.models import layered_step

    with np.load(os.path.join(ROOT, "tests", "data", "front_oracle_120x60x4.npz")) as d:
        nx, ny, nz, dt, _, _ = d["meta"]
        ref = {k: d[k] for k in ("u.015", "v.015", "b.015")}
        ke_ref = d["ke"][:15]
    model, s = build(int(nx), int(ny), int(nz), dtype=torch.float64, device="cuda")
    kernels.reset_launch_counts()
    ke = []
    for _ in range(15):
        s = layered_step(model, s, float(dt))
        ke.append(kinetic_energy(model, s))
    counts = kernels.launch_counts()
    check(all(counts[k] == 15 for k in ("vertical", "momentum_layered", "barotropic")),
          f"layered parity run used the kernels: {counts}")
    I3 = (slice(None),) + model.grid.interior2d
    worst = []
    for name in ("u", "v", "b"):
        a = getattr(s, name).cpu().numpy()[I3]
        r = ref[f"{name}.015"]
        diff = float(np.abs(a - r).max())
        worst.append(f"{name} {diff:.3e}")
        check(np.allclose(a, r, rtol=1e-9, atol=1e-14), f"front oracle {name}: max diff "
              f"{diff}")
    rel = float(np.max(np.abs(np.asarray(ke) / ke_ref - 1.0)))
    worst.append(f"ke rel {rel:.3e}")
    check(np.allclose(ke, ke_ref, rtol=1e-10, atol=0), f"front oracle ke: rel {rel}")
    log(f"phase 6: 120 x 60 x 4 float64 front oracle, 15 steps through the kernels: max "
        f"|diff| {', '.join(worst)} (rtol 1e-9, atol 1e-14; ke rtol 1e-10) [{card}]")


def phase7_gyre_path(card, n_steps=10, warm=3):
    """The 1/4-degree x 10 wind-driven T/S gyre through the kernels; returns the
    launch counts, ms/step, and the model with its initial state for phase 10."""
    import torch

    from examples.wind_driven_ts_gyre_torch import build
    from orthogonalsphericalshellgrids_tpu_torch import kernels
    from orthogonalsphericalshellgrids_tpu_torch.models import layered_multi_step

    t0 = time.perf_counter()
    model, state = build(1440, 680, 10, dtype=torch.float32, substeps=30, device="cuda")
    state0 = state
    torch.cuda.synchronize()
    log(f"phase 7: built the 1440 x 680 x 10 gyre in {time.perf_counter() - t0:.1f} s "
        f"(stacks {tuple(state.u.shape)}, tracers {tuple(state.c.shape)}, layers "
        f"{', '.join(f'{d:.1f}' for d in model.dz)} m, {model.baro.weights.shape[0]} "
        f"substeps)")
    dt = 40.0
    state = layered_multi_step(model, state, dt, warm)
    torch.cuda.synchronize()

    kernels.reset_launch_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    state = layered_multi_step(model, state, dt, n_steps)
    end.record()
    end.synchronize()
    counts = kernels.launch_counts()
    ms = start.elapsed_time(end) / n_steps
    expected = {k: 0 for k in counts}
    expected.update(halo_fill=2 * n_steps, halo_restore=n_steps, vertical=n_steps,
                    momentum_closures=n_steps, tracer_adv_kappa=n_steps, corrector=n_steps,
                    barotropic=n_steps)
    check(counts == expected, f"gyre launch counts {counts} != {expected}")
    check(tuple(state.u.shape) == (10, 690, 1450) and tuple(state.c.shape) == (20, 690, 1450),
          "gyre state shapes")
    for name in ("u", "v", "c", "eta", "U", "V"):
        check(bool(torch.isfinite(getattr(state, name)).all()), f"gyre {name} finite")
    I3 = (slice(None),) + model.grid.interior2d
    wet = model.mask_c3[I3] > 0
    T, S = state.c[:10][I3][wet], state.c[10:][I3][wet]
    pts = 1440 * 680 * 10
    log(f"phase 7: {n_steps} gyre steps after {warm} warm-up at dt = {dt:g} s: "
        f"{ms:.4f} ms/step ({pts / ms / 1e6:.4f} G grid-points/s), launches {counts}, "
        f"max|u| {float(state.u.abs().max()):.6f}, T in [{float(T.min()):.4f}, "
        f"{float(T.max()):.4f}], S in [{float(S.min()):.4f}, {float(S.max()):.4f}] "
        f"[{card}]")
    tracer_on_own_fields(card, "phase 7", model, state)
    return counts, ms, model, state0


def phase8_gyre_parity(card, n_steps=3):
    """Three float64 steps of the small check gyre through the kernels against the
    port's plain path on the CPU."""
    import torch

    from examples.wind_driven_ts_gyre_torch import build_check
    from orthogonalsphericalshellgrids_tpu_torch import kernels
    from orthogonalsphericalshellgrids_tpu_torch.models import layered_multi_step

    cpu_m, cpu_s = build_check(device="cpu")
    gpu_m, gpu_s = build_check(device="cuda")
    layered_multi_step(gpu_m, gpu_s, 60.0, n_steps)  # captures the block
    kernels.reset_launch_counts()
    gpu_out = layered_multi_step(gpu_m, gpu_s, 60.0, n_steps)
    counts = kernels.launch_counts()
    check(all(counts[k] == n_steps for k in ("vertical", "momentum_closures",
                                              "tracer_adv_kappa", "corrector")),
          f"gyre parity run used the kernels: {counts}")
    cpu_out = layered_multi_step(cpu_m, cpu_s, 60.0, n_steps)
    I3 = (slice(None),) + cpu_m.grid.interior2d
    worst = []
    for name in ("u", "v", "c", "eta"):
        sl = cpu_m.grid_ext.interior2d if name == "eta" else I3
        w = getattr(cpu_out, name)[sl]
        rel = float((getattr(gpu_out, name).cpu()[sl] - w).abs().max() / w.abs().max())
        worst.append(f"{name} {rel:.3e}")
        check(rel <= 1e-11, f"gyre parity {name}: rel {rel:.3e}")
    log(f"phase 8: 48 x 32 x 3 float64 check gyre, {n_steps} steps through the kernels "
        f"against the CPU plain path: max rel diff {', '.join(worst)} (rtol 1e-11) [{card}]")


def phase9_probes(card, kres):
    """The two probes and the two ceiling kernels against their plain versions at the
    measurement's shapes (f32 and f64), then the four ceilings measured through them
    and the bounds they put on the kernels of phase 2. Returns ({name: (max_abs_err at
    f32, kernel ms, plain ms, bound, library ms)}, the measurement's launch counts, the
    ceilings)."""
    import torch

    from benchmarks import torch_roofline as roof
    from benchmarks.torch_weno_sol import (FLOPS_PER_RECONSTRUCTION, WENO_ITER,
                                           probe_input)
    from orthogonalsphericalshellgrids_tpu_torch import kernels
    from orthogonalsphericalshellgrids_tpu_torch.kernels import probes

    whole = (slice(None), slice(None))
    n_tiles = roof.baro_n_tiles()
    rows = {}
    for name in ("float32", "float64"):
        dt = getattr(torch, name)
        f32 = name == "float32"

        # the barotropic substep probe: every tile, all three accumulators, at the
        # measurement's length (the iterate is smooth, so the full length compares)
        spack, dpack, dtau = roof.baro_inputs(n_tiles, dtype=dt)
        got = probes.baro_substep_sol(spack, dpack, dtau, roof.BARO_ITER)
        want = probes.baro_substep_sol_plain(spack, dpack, dtau, roof.BARO_ITER)
        ea, er = rel_err(got, want, whole)
        check(er <= BANDS[name] and bool(torch.isfinite(got).all()),
              f"baro_substep_sol {name}: rel err {er:.3e}")
        t_p = time_ms(lambda: probes.baro_substep_sol_plain(spack, dpack, dtau,
                                                            roof.BARO_ITER), n=1, reps=1,
                      warm=0) if f32 else float("nan")
        log(f"phase 9: baro_substep_sol {name} on {tuple(spack.shape)}, {roof.BARO_ITER} "
            f"substeps: max abs err {ea:.3e}, max rel err {er:.3e} (band {BANDS[name]:g})"
            f"{f'; plain {t_p:.4f} ms' if f32 else ''} [{card}]")
        if f32:
            rows["baro_substep_sol"] = (ea, None, t_p, bound(
                nbytes(spack, dpack, dtau, got),
                probes.BARO_FLOPS * got[:, 0].numel() * roof.BARO_ITER), None)

        # the WENO-5 probe: the upwind select flips on a rounding difference near 0
        # and the flip spreads, so it compares at 1 and 4 iterations, and a point
        # outside the band may be at most 1e-4 of the points
        x = probe_input(dtype=dt)
        worst = []
        for n_iter in (1, 4):
            for upwind in (True, False):
                got = probes.weno_probe(x, n_iter, upwind)
                want = probes.weno_probe_plain(x, n_iter, upwind)
                diff = (got - want).abs()
                out_of_band = float((diff > BANDS[name] * want.abs().max()).double().mean())
                check(out_of_band < 1e-4 and bool(torch.isfinite(got).all()),
                      f"weno_probe {name} n_iter={n_iter} upwind={upwind}: {out_of_band:.2e} "
                      f"of the points outside the band")
                worst.append((float(diff.max()), float(diff.max() / want.abs().max()),
                              out_of_band))
        ea = max(w[0] for w in worst)
        t_p = time_ms(lambda: probes.weno_probe_plain(x, WENO_ITER), n=1, reps=1,
                      warm=0) if f32 else float("nan")
        log(f"phase 9: weno_probe {name} on {tuple(x.shape)}, 1 and 4 iterations, upwind "
            f"and left-biased: max abs err {ea:.3e}, max rel err "
            f"{max(w[1] for w in worst):.3e}, outside the band {max(w[2] for w in worst):.2e}"
            f" of the points (band {BANDS[name]:g})"
            f"{f'; plain at {WENO_ITER} iterations {t_p:.4f} ms' if f32 else ''} [{card}]")
        if f32:
            rows["weno_probe"] = (ea, None, t_p, bound(
                2 * nbytes(x), FLOPS_PER_RECONSTRUCTION * x.numel() * WENO_ITER), None)

        # the stream kernel, and the one PyTorch call that computes the same function
        xs = torch.arange(roof.STREAM_N, dtype=dt, device="cuda")
        ys = torch.empty_like(xs)
        want = probes.stream_probe_plain(xs)
        ea, er = rel_err(probes.stream_probe(xs, out=ys).view(1, -1), want.view(1, -1),
                         whole)
        check(er <= BANDS[name], f"stream_probe {name}: rel err {er:.3e}")
        half = torch.tensor(0.5, dtype=dt, device="cuda")
        lib = torch.add(half, xs, alpha=1.000001)
        check(rel_err(lib.view(1, -1), want.view(1, -1), whole)[1] <= BANDS[name],
              f"torch.add {name} as the stream")
        if f32:
            t_p = time_ms(lambda: probes.stream_probe_plain(xs), n=5)
            t_lib = time_ms(lambda: torch.add(half, xs, alpha=1.000001, out=ys), n=5)
            t_copy = time_ms(lambda: ys.copy_(xs), n=5)
            rows["stream_probe"] = (ea, None, t_p, bound(2 * nbytes(xs), 2 * xs.numel()),
                                    t_lib)
            log(f"phase 9: stream_probe {name} on {xs.numel()} elements: max abs err "
                f"{ea:.3e}, max rel err {er:.3e}; plain {t_p:.4f} ms, torch.add {t_lib:.4f}"
                f" ms, copy_ of the same bytes {t_copy:.4f} ms [{card}]")
        del xs, ys, lib, want

        # the FMA ceiling kernel
        xf = torch.full((roof.FMA_N,), 0.999, dtype=dt, device="cuda")
        ea, er = rel_err(probes.fma_ceiling(xf, roof.FMA_ITER).view(1, -1),
                         probes.fma_ceiling_plain(xf, roof.FMA_ITER).view(1, -1), whole)
        check(er <= BANDS[name], f"fma_ceiling {name}: rel err {er:.3e}")
        t_p = time_ms(lambda: probes.fma_ceiling_plain(xf, roof.FMA_ITER), n=1, reps=1,
                      warm=0) if f32 else float("nan")
        log(f"phase 9: fma_ceiling {name} on {xf.numel()} elements x {roof.FMA_ITER}: max "
            f"abs err {ea:.3e}, max rel err {er:.3e}{f'; plain {t_p:.4f} ms' if f32 else ''}"
            f" [{card}]")
        if f32:
            rows["fma_ceiling"] = (ea, None, t_p, bound(
                2 * nbytes(xf), probes.FMA_FLOPS * xf.numel() * roof.FMA_ITER), None)

    # the ceilings: the path that runs these four kernels
    kernels.reset_launch_counts()
    ceil = roof.measure()
    counts = kernels.launch_counts()
    check(all(counts[n] > 0 for n in PROBES) and
          all(c == 0 for n, c in counts.items() if n not in PROBES),
          f"the ceilings launched {counts}")
    # a reading above the data sheet means the timing window is broken
    check(ceil["stream_gbps"] <= 1.02 * HBM_BYTES_PER_S / 1e9,
          f"stream {ceil['stream_gbps']:.1f} GB/s above the data sheet")
    check(ceil["fma_tflops"] <= 1.02 * F32_FLOPS_PER_S / 1e12,
          f"FMA {ceil['fma_tflops']:.2f} TFLOP/s above the data sheet")
    for name, key in (("baro_substep_sol", "baro_ms"), ("weno_probe", "weno_ms"),
                      ("stream_probe", "stream_ms"), ("fma_ceiling", "fma_ms")):
        ea, _, t_p, b, t_lib = rows[name]
        rows[name] = (ea, ceil[key], t_p, b, t_lib)
        log(f"phase 9: {name} kernel {ceil[key]:.4f} ms, plain {t_p:.4f} ms, data-sheet "
            f"bound {b[0]:.5f} ms ({b[1]}) [{card}]")
    # each kernel's byte bound at the measured stream rate: the bytes of its phase-2
    # operands, the same count as its data-sheet bound
    roof.report(ceil, card, log=lambda m: log(f"phase 9: {m}"),
                kernel_ms={name: row[1] for name, row in kres.items()},
                kernel_bytes={name: row[3][2] for name, row in kres.items()})
    log(f"phase 9: launches {counts}")
    return rows, counts, ceil


class Timed:
    """A Simulation callback that times ``fn`` on the host, the card drained first."""

    def __init__(self, fn):
        self.fn, self.ms = fn, []

    def __call__(self, sim):
        import torch

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        self.fn(sim)
        self.ms.append((time.perf_counter() - t0) * 1e3)


def phase10_simulation(card, model, state0, n_iter=60, n_time=100, warm=3):
    """The 1/4-degree x 10 gyre through ``Simulation``: no host synchronization at an
    iteration where no callback fires (torch's sync debug mode); its cost over
    ``layered_multi_step`` over ``n_time`` iterations with the wizard and the progress
    line every 10 and the default NaN checker (u every 100 iterations), beside a run
    that reads u after every step; the async surface writer and the checkpoint timed
    on their own; and a pickup from the checkpoint at iteration 30, resumed to
    ``n_iter``, bitwise against the uninterrupted run at a fixed dt = 40 s (a
    checkpoint holds the state, not the wizard's dt). Returns the launch counts of
    one Simulation run."""
    import dataclasses
    import tempfile

    import torch

    from orthogonalsphericalshellgrids_tpu_torch import kernels
    from orthogonalsphericalshellgrids_tpu_torch.models import layered_multi_step
    from orthogonalsphericalshellgrids_tpu_torch.utils import (
        Checkpointer, FieldTimeSeries, IterationInterval, NaNChecker, OutputWriter,
        Simulation, TimeStepWizard, progress_callback)

    nz, dt = model.nz, 40.0
    progress = []
    warm_state = layered_multi_step(model, state0, dt, warm)
    torch.cuda.synchronize()

    def multi():
        return layered_multi_step(model, warm_state, dt, n_time)

    def driven(kind="sim", probe=None):
        """The wizard and the progress line every 10 iterations and the default NaN
        checker (``sim``); with a NaN checker on u, v and c every 10 iterations in
        place of the default one (``strict``); or ``sim`` plus a host read of one
        value of u after every step (``synced``), the wait the loop must not make.
        ``probe`` runs after every step, after the other callbacks."""
        sim = Simulation(model, warm_state, dt=dt, stop_iteration=warm + n_time,
                         nan_checker=kind != "strict")
        wizard = TimeStepWizard(cfl=0.25, max_change=1.1, max_dt=3600.0)
        sim.add_callback(lambda s: setattr(s, "dt", wizard.update(s.model, s.state, s.dt)),
                         IterationInterval(10))
        sim.add_callback(progress_callback(progress.append), IterationInterval(10))
        if kind == "strict":
            sim.add_callback(NaNChecker(("u", "v", "c")), IterationInterval(10))
        if kind == "synced":
            sim.add_callback(lambda s: float(s.state.u[0, 0, 0]), IterationInterval(1))
        if probe is not None:
            sim.add_callback(probe, IterationInterval(1))
        return sim.run()

    def syncs_per_iteration(kind):
        """{iteration: host synchronizations in its step and its callbacks}: torch's
        sync debug mode counts them, read by a probe after every step (the first
        iteration, which also holds the Simulation's construction, is left out)."""
        marks = []
        with host_syncs() as n_syncs:
            driven(kind, probe=lambda s: marks.append((s.iteration, n_syncs())))
        return {it: n - prev for (_, prev), (it, n) in zip(marks, marks[1:])}

    def wall_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n_time * 1e3

    driven("strict")  # the first launches of the callbacks' reductions load them
    syncs = {kind: syncs_per_iteration(kind) for kind in ("sim", "synced")}
    quiet = [it for it in syncs["sim"] if it % 10]  # no callback but the probe fires
    loud = sorted(set(syncs["sim"]) - set(quiet))
    check(len(quiet) >= n_time * 8 // 10 and all(syncs["synced"][it] >= 1 for it in quiet),
          f"the sync count sees a host read after every step: {syncs['synced']}")
    check(all(syncs["sim"][it] == 0 for it in quiet),
          f"Simulation waited for the card at an iteration without a callback: "
          f"{ {it: n for it, n in syncs['sim'].items() if n and it in quiet} }")
    times = {"multi": [], "sim": [], "strict": [], "synced": []}
    runs = {"multi": multi, "sim": driven, "strict": lambda: driven("strict"),
            "synced": lambda: driven("synced")}
    for which in ("multi", "sim", "strict", "synced", "synced", "strict", "sim", "multi",
                  "multi", "sim", "strict", "synced"):
        if which == "sim" and not times["sim"]:
            kernels.reset_launch_counts()
            times["sim"].append(wall_ms(driven))
            counts = kernels.launch_counts()
        else:
            times[which].append(wall_ms(runs[which]))
    expected = {k: 0 for k in counts}
    expected.update(halo_fill=2 * n_time, halo_restore=n_time, vertical=n_time,
                    momentum_closures=n_time, tracer_adv_kappa=n_time, corrector=n_time,
                    barotropic=n_time)
    check(counts == expected, f"Simulation launch counts {counts} != {expected}")
    best = {k: min(v) for k, v in times.items()}
    over = {k: best[k] / best["multi"] - 1.0 for k in ("sim", "strict", "synced")}
    log(f"phase 10: {n_time} gyre iterations: host synchronizations 0 at each of the "
        f"{len(quiet)} iterations without a callback, "
        f"{sum(syncs['sim'][it] for it in loud)} at the {len(loud)} with one; "
        f"{sum(syncs['synced'].values())} with a host read after every step [{card}]")
    log(f"phase 10: ms/step through Simulation (wizard and progress every 10, the "
        f"default NaN checker) {', '.join(f'{t:.4f}' for t in times['sim'])}; with a NaN "
        f"checker on u, v and c every 10 {', '.join(f'{t:.4f}' for t in times['strict'])}"
        f"; with a host read after every step "
        f"{', '.join(f'{t:.4f}' for t in times['synced'])}; layered_multi_step "
        f"{', '.join(f'{t:.4f}' for t in times['multi'])}; Simulation costs "
        f"{100 * over['sim']:+.2f} % ({100 * over['strict']:+.2f} % with the NaN checker "
        f"every 10, {100 * over['synced']:+.2f} % with a read after every step; best "
        f"against best; the target of at most 3 % "
        f"{'held' if over['sim'] <= 0.03 else 'missed'}); last progress line: "
        f"{progress[-1]} [{card}]")

    surface = {"T_surface": lambda s: s.state.c[0], "S_surface": lambda s: s.state.c[nz],
               "u_surface": lambda s: s.state.u[0]}
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = Checkpointer(os.path.join(tmp, "gyre"))
        paths = {k: os.path.join(tmp, f"surface_{k}.npz") for k in ("once", "resumed")}
        ends, drain_ms, write_ms = {}, {}, []
        for run in ("once", "resumed"):
            writer = OutputWriter(paths[run], surface, async_write=True)
            sim = Simulation(model, state0, dt=dt, stop_iteration=n_iter)
            sim.add_callback(progress_callback(progress.append), IterationInterval(10))
            timed_writer = Timed(writer)
            timed_writer.ms = write_ms
            sim.add_callback(timed_writer, IterationInterval(20))
            if run == "once":
                timed_ckpt = Timed(ckpt)
                sim.add_callback(timed_ckpt, IterationInterval(30))
            ends[run] = sim.run(pickup=ckpt.path_for(30) if run == "resumed" else None)
            t0 = time.perf_counter()
            writer.close()  # the Timed wrapper hides close() from the Simulation
            drain_ms[run] = (time.perf_counter() - t0) * 1e3
            check(sim.iteration == n_iter, f"{run} run ended at iteration {sim.iteration}")
        ckpt_mb = os.path.getsize(ckpt.path_for(30)) / 2**20
        for f in dataclasses.fields(ends["once"]):
            check(torch.equal(getattr(ends["resumed"], f.name), getattr(ends["once"], f.name)),
                  f"pickup at iteration 30: {f.name} not bitwise equal to the uninterrupted "
                  f"run")
        once = {k: FieldTimeSeries(paths["once"], k) for k in surface}
        resumed = {k: FieldTimeSeries(paths["resumed"], k) for k in surface}
        for k in surface:
            check(len(once[k]) == 3 and len(resumed[k]) == 2, f"{k} snapshots")
            check((resumed[k].data == once[k].data[1:]).all() and
                  (resumed[k].times == once[k].times[1:]).all(),
                  f"{k}: the resumed run's snapshots differ from the uninterrupted run's")
            check(bool((abs(once[k].data) < float("inf")).all()), f"{k} finite")
    log(f"phase 10: pickup at iteration 30 resumed to {n_iter} bitwise equal to the "
        f"uninterrupted run (every field, and the snapshots at 40 and 60) at dt = {dt:g} "
        f"s; async surface writer (T, S, u) {', '.join(f'{t:.2f}' for t in write_ms)}"
        f" ms a snapshot on the simulation thread, drain {drain_ms['resumed']:.2f} ms; "
        f"checkpoint {', '.join(f'{t:.1f}' for t in timed_ckpt.ms)} ms for {ckpt_mb:.1f} MB "
        f"[{card}]")
    return counts


def phase11_bickley_50_days(card, days=50.0):
    """The reference's run (BASELINE.md:13): the 180 x 90 Bickley jet through
    ``Simulation`` at float64, CFL-0.3 wizard with max dt 3 h from dt = 60 s, daily
    output of u, v, c and zeta; steps, wall time, final invariants, finite fields and
    phase 3's tracer range."""
    import tempfile

    import numpy as np
    import torch

    from examples.bickley_jet_torch import build, diagnostics, make_simulation
    from orthogonalsphericalshellgrids_tpu_torch import kernels
    from orthogonalsphericalshellgrids_tpu_torch.models import multi_step
    from orthogonalsphericalshellgrids_tpu_torch.models.diagnostics import (
        surface_volume, tracer_content)
    from orthogonalsphericalshellgrids_tpu_torch.utils import FieldTimeSeries

    model, state = build(180, 90, dtype=torch.float64, substeps=30, device="cuda")
    multi_step(model, state, 60.0, 1)  # captures the one-step block the run replays
    c0 = float(tracer_content(model, state))
    progress = []
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "bickley.npz")
        sim = make_simulation(model, state, days=days, dt=60.0, out=out,
                              log=progress.append)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        s = sim.run()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        zeta = FieldTimeSeries(out, "zeta")
        check(len(zeta) >= int(days) and bool(np.isfinite(zeta.data).all()),
              f"{len(zeta)} daily zeta snapshots, finite")
    check(abs(sim.time - days * 86400.0) < 1e-6, f"stopped at t = {sim.time}")
    check(all(counts[n] > 0 for n in BICKLEY) and counts["barotropic"] == sim.iteration,
          f"the 50-day run launched {counts} in {sim.iteration} iterations")
    for name in ("u", "v", "c", "eta", "U", "V"):
        check(bool(torch.isfinite(getattr(s, name)).all()), f"50-day {name} finite")
    cmin, cmax = float(s.c.min()), float(s.c.max())
    check(-1 - 1e-3 <= cmin and cmax <= 1 + 1e-3, f"c in [-1, 1]: [{cmin}, {cmax}]")
    ke, ens, cvar = diagnostics(model, s)
    c1 = float(tracer_content(model, s))
    # flux-form advection with the seam row half-weighted conserves it to round-off
    check(abs(c1 / c0 - 1.0) <= 1e-9, f"tracer content {c0} -> {c1}")
    log(f"phase 11: the 180 x 90 float64 Bickley jet, {days:g} days through Simulation: "
        f"{sim.iteration} steps in {wall:.1f} s ({wall / sim.iteration * 1e3:.3f} ms a "
        f"step with the callbacks), last dt {sim.dt:.1f} s, {len(zeta)} daily snapshots; "
        f"final ke {ke:.6e}, enstrophy {ens:.6e}, tracer variance {cvar:.6e}, tracer "
        f"content {c1:.12e} (relative change {c1 / c0 - 1:.2e}), surface volume "
        f"{float(surface_volume(model, s)):.6e}, c in [{cmin:.6f}, {cmax:.6f}], max|u| "
        f"{float(s.u.abs().max()):.4f}; {progress[-1]} [{card}]")
    return counts


def shard_groups(rnd, n, ny):
    """The Bickley and gyre fill groups of ``n`` ranks of ``ny`` rows at the
    1/4-degree width: {group: [the fields of rank k]}, each rank's fields the rows
    [k·ny, k·ny + ny + 2·H) of fields drawn over n·ny rows, its η, U, V views of one
    (3, ny + 44, 1484) buffer."""
    from orthogonalsphericalshellgrids_tpu_torch.ops.location import CC, CF, FC

    Nx, H, He = 1440, 5, 22
    out = {}
    for group, stacks in (("Bickley", [(None, FC, -1), (None, CF, -1), (None, CC, 1)]),
                          ("gyre", [(10, FC, -1), (10, CF, -1), (20, CC, 1)])):
        base = [(rnd(((K or 1), n * ny + 2 * H, Nx + 2 * H)), loc, sign)
                for K, loc, sign in stacks]
        ext = rnd((3, n * ny + 2 * He, Nx + 2 * He))
        ranks = []
        for k in range(n):
            fields = []
            for (A, loc, sign), (K, *_) in zip(base, stacks):
                rows = A[:, k * ny:k * ny + ny + 2 * H].clone()
                fields.append((rows if K else rows[0], loc, sign, Nx, ny, H, H))
            buf = ext[:, k * ny:k * ny + ny + 2 * He].clone()
            fields += [(buf[0], CC, 1, Nx, ny, He, He), (buf[1], FC, -1, Nx, ny, He, He),
                       (buf[2], CF, -1, Nx, ny, He, He)]
            ranks.append(fields)
        out[group] = ranks
    return out


def shard_fill_cells(fields, role):
    """(cells the shard fill writes, distinct cells it reads, of the fields and the
    received rows), found by filling planes of distinct ids with the plain fill."""
    import torch

    from orthogonalsphericalshellgrids_tpu_torch.kernels import halo_fill

    written = read = 0
    for A, loc, sign, Nx, Ny, Hx, Hy in fields:
        K = A.shape[0] if A.dim() == 3 else 1
        Yb, Xb = A.shape[-2:]
        ids = torch.arange(1, Yb * Xb + 1, dtype=torch.float64).view(Yb, Xb)
        has_s, has_n = halo_fill.receives(role)
        strip = Hy * Xb
        south = -torch.arange(1, strip + 1, dtype=torch.float64) if has_s else None
        north = -torch.arange(strip + 1, 2 * strip + 1, dtype=torch.float64) \
            if has_n else None
        geom = halo_fill._geometry("fill", A, loc, Nx, Ny, Hx, Hy, role)
        y, x = halo_fill.plane_cells(*geom[1:])
        halo_fill.fill_halos_group_plain([(ids, loc, sign, Nx, Ny, Hx, Hy)], role=role,
                                         south=south, north=north)
        written += K * y.size
        read += K * int(ids[y, x].abs().unique().numel())
    return written, read


def phase12a_shard_fills(card):
    """The shard-aware group fill with save, its pack and its restore against their
    plain versions, bitwise at float32 and float64, for every rank of 4 on the
    Bickley and gyre groups at ny = 170 and at ny = 22 (the extended halo): each
    rank's rows received from its neighbours' packs. The Bickley group's middle rank
    timed at float32, beside its plain versions. Returns the kernel-table rows."""
    import numpy as np
    import torch

    from orthogonalsphericalshellgrids_tpu_torch import kernels
    from orthogonalsphericalshellgrids_tpu_torch.kernels import halo_fill

    n, results = 4, {}
    for name in ("float32", "float64"):
        dt = getattr(torch, name)
        rng = np.random.default_rng(12)

        def rnd(shape):
            return torch.as_tensor(rng.standard_normal(shape), dtype=dt, device="cuda")

        for ny in (170, 22):
            for group, ranks in shard_groups(rnd, n, ny).items():
                roles = [halo_fill.role_of(k, n) for k in range(n)]
                before = [[f[0].clone() for f in fields] for fields in ranks]
                plain = [[(f[0].clone(),) + f[1:] for f in fields] for fields in ranks]
                kernels.reset_launch_counts()
                sends = [halo_fill.pack_strips(f, r) for f, r in zip(ranks, roles)]
                want_sends = [halo_fill.pack_strips_plain(f, r) for f, r in zip(plain, roles)]
                torch.cuda.synchronize()
                check(all(torch.equal(a, b) for a, b in zip(sends, want_sends)),
                      f"pack {group} ny={ny} {name} bitwise")
                part = sends[0].numel() // 2
                saved, want_saved = [], []
                for k, r in enumerate(roles):
                    rows = dict(south=sends[k - 1][:part] if k > 0 else None,
                                north=sends[k + 1][part:] if k + 1 < n else None)
                    saved.append(halo_fill.fill_halos_group(ranks[k], True, r, **rows)[1])
                    want_saved.append(halo_fill.fill_halos_group_plain(
                        plain[k], True, r, **{s: None if b is None else b.clone()
                                              for s, b in rows.items()})[1])
                torch.cuda.synchronize()
                check(all(torch.equal(f[0], p[0]) for fs, ps in zip(ranks, plain)
                          for f, p in zip(fs, ps)) and
                      all(torch.equal(a, b) for a, b in zip(saved, want_saved)),
                      f"shard fill with save {group} ny={ny} {name}: fields and strips "
                      "bitwise in every role")
                for k, r in enumerate(roles):
                    halo_fill.restore_strips_group(ranks[k], saved[k], r)
                    halo_fill.restore_strips_group_plain(plain[k], want_saved[k], r)
                torch.cuda.synchronize()
                check(all(torch.equal(f[0], b) and torch.equal(p[0], b)
                          for fs, ps, bs in zip(ranks, plain, before)
                          for f, p, b in zip(fs, ps, bs)),
                      f"shard restore {group} ny={ny} {name}: every field as before")
                counts = kernels.launch_counts()
                check(counts["halo_pack"] == n and counts["halo_fill_shard"] == n and
                      counts["halo_restore"] == n and sum(counts.values()) == 3 * n,
                      f"shard group {group}: one launch a call, {counts}")
                # the split's order: the local wrap, then the rest of the fill into
                # the same saved buffer, against the one-launch plain fill
                for k, r in enumerate(roles):
                    rows = dict(south=sends[k - 1][:part] if k > 0 else None,
                                north=sends[k + 1][part:] if k + 1 < n else None)
                    sv = halo_fill.wrap_halos_group(ranks[k], r)
                    halo_fill.fill_halos_group(ranks[k], True, r, phase=halo_fill.NO_WRAP,
                                               saved=sv, **rows)
                    _, want_sv = halo_fill.fill_halos_group_plain(plain[k], True, r, **rows)
                    torch.cuda.synchronize()
                    check(all(torch.equal(f[0], p[0]) for f, p in zip(ranks[k], plain[k]))
                          and torch.equal(sv, want_sv),
                          f"wrap then the rest, {group} ny={ny} {name} rank {k}: bitwise "
                          "the plain fill and its strips")
                    halo_fill.restore_strips_group(ranks[k], sv, r)
                    halo_fill.restore_strips_group_plain(plain[k], want_sv, r)
                torch.cuda.synchronize()
                check(all(torch.equal(f[0], b) and torch.equal(p[0], b)
                          for fs, ps, bs in zip(ranks, plain, before)
                          for f, p, b in zip(fs, ps, bs)),
                      f"wrap restore {group} ny={ny} {name}: every field as before")
                role_names = ", ".join(halo_fill.ROLE_NAMES[r] for r in roles)
                log(f"phase 12a: {group} group, 4 ranks of ny = {ny} ({role_names}), "
                    f"{name}: pack, fill with save and restore, and the split's wrap "
                    f"then the rest of the fill, bitwise their plain versions, inputs "
                    f"restored [{card}]")
                if name != "float32" or ny != 170 or group != "Bickley":
                    continue
                fields, role = ranks[1], roles[1]
                rows = dict(south=sends[0][:part], north=sends[2][part:])
                _, sv = halo_fill.fill_halos_group(fields, True, role, **rows)
                halo_fill.restore_strips_group(fields, sv, role)
                slices = [f[0][..., f[4]:f[4] + f[6], :] for f in fields] + \
                    [f[0][..., f[6]:2 * f[6], :] for f in fields]
                t = dict(
                    pack=time_ms(lambda: halo_fill.pack_strips(fields, role), ahead=True),
                    pack_plain=time_ms(lambda: halo_fill.pack_strips_plain(fields, role)),
                    cat=time_ms(lambda: torch.cat([x.reshape(-1) for x in slices])),
                    fill=time_ms(lambda: halo_fill.fill_halos_group(fields, True, role,
                                                                    **rows), ahead=True),
                    fill_plain=time_ms(lambda: halo_fill.fill_halos_group_plain(
                        fields, True, role, **rows)),
                    restore=time_ms(lambda: halo_fill.restore_strips_group(fields, sv, role),
                                    ahead=True))
                halo_fill.restore_strips_group(fields, sv, role)
                sv = halo_fill.wrap_halos_group(fields, role)  # saves the unwrapped cells
                t["wrap"] = time_ms(lambda: halo_fill.wrap_halos_group(fields, role),
                                    ahead=True)
                t["wrap_plain"] = time_ms(lambda: halo_fill.fill_halos_group_plain(
                    fields, True, role, phase=halo_fill.WRAP))
                halo_fill.restore_strips_group(fields, sv, role, phase=halo_fill.WRAP)
                # a middle rank wraps the x halos of all its Ny rows: each cell's old
                # value read and saved, its source read and its new value written
                wrapped = sum((f[0].shape[0] if f[0].dim() == 3 else 1) * f[4] * 2 * f[5]
                              for f in fields)
                written, read = shard_fill_cells(fields, role)
                size = fields[0][0].element_size()
                b_fill = bound(size * (3 * written + read), written)
                b_pack = bound(2 * 2 * part * size, 0)
                log(f"phase 12a: middle rank of the Bickley group (ny = 170), float32, "
                    f"device time with the host ahead: pack {t['pack']:.4f} ms kernel, "
                    f"{t['pack_plain']:.4f} ms plain, torch.cat {t['cat']:.4f} ms (bound "
                    f"{b_pack[0]:.5f} ms, {b_pack[2]} bytes); fill with save "
                    f"{t['fill']:.4f} ms kernel, {t['fill_plain']:.4f} ms plain ({written} "
                    f"written, {read} read; bound {b_fill[0]:.5f} ms, {b_fill[2]} bytes); "
                    f"restore {t['restore']:.4f} ms [{card}]")
                b_wrap = bound(size * 4 * wrapped, 0)
                log(f"phase 12a: the split's local wrap of the same rank: {t['wrap']:.4f} "
                    f"ms kernel, {t['wrap_plain']:.4f} ms plain ({wrapped} cells; bound "
                    f"{b_wrap[0]:.5f} ms, {b_wrap[2]} bytes) [{card}]")
                results["halo_fill_shard"] = (0.0, t["fill"], t["fill_plain"], b_fill)
                results["halo_pack"] = (0.0, t["pack"], t["pack_plain"], b_pack, t["cat"])
                results["halo_wrap"] = (0.0, t["wrap"], t["wrap_plain"], b_wrap)
            del ranks, plain, before
    return results


def device_busy(run, state, n):
    """(state after ``n`` calls of ``run`` under ``torch.profiler``, device operations
    a step, device busy ms a step: the union of device activity, the idle share of the
    window's span; the profiler slows the host, so the share is an upper bound)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            state = run(state)
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    check(bool(spans), "the profiler saw device activity")
    busy, (cur_s, cur_e) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    return state, len(spans) / n, busy / 1e3 / n, 1.0 - busy / (spans[-1][1] - spans[0][0])


def phase12_sharded(card, bickley, gyre, n=4):
    """Phase 3's Bickley jet (20 steps at dt = 60 s) and phase 7's gyre (3 steps at
    dt = 40 s) in ``n`` y-shards through LocalExchange, each gathered state bitwise
    equal to the serial run from the same state, each shard's launches counted, no
    host synchronization; then the serial step inside an initialized 1-rank NCCL
    group (with one rank the step takes the serial route, so ProcessGroupExchange
    makes no NCCL operation). Returns the Bickley run's launch counts and the two
    runs' ms/step."""
    import tempfile

    import torch
    import torch.distributed as dist

    from orthogonalsphericalshellgrids_tpu_torch import kernels, parallel
    from orthogonalsphericalshellgrids_tpu_torch.models import (layered_multi_step,
                                                                 layered_step, multi_step,
                                                                 step)

    def interiors_equal(model, got, want, names):
        for name in names:
            grid = model.grid_ext if name in ("eta", "U", "V") else model.grid
            check(torch.equal(grid.interior(getattr(got, name)),
                              grid.interior(getattr(want, name))),
                  f"sharded {name} bitwise equal to serial")

    results, shard_ms = {}, {}
    for path, (model, state0, serial_ms), n_steps, dt in (("Bickley", bickley, 20, 60.0),
                                                          ("gyre", gyre, 3, 40.0)):
        layered = path == "gyre"
        distribute = parallel.distribute_layered if layered else parallel.distribute
        make_fn = parallel.sharded_layered_step_fn if layered else parallel.sharded_step_fn
        mesh = parallel.make_mesh(n)
        dist_model, dist_state = distribute(model, state0, mesh)
        make_fn(mesh, dist_model)(dist_state, dt)  # loads the exchange's path
        torch.cuda.synchronize()
        fn = make_fn(mesh, dist_model)
        kernels.reset_launch_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        s = dist_state
        t0 = time.perf_counter()
        start.record()
        for _ in range(n_steps):
            s = fn(s, dt)
        end.record()
        end.synchronize()
        wall = (time.perf_counter() - t0) / n_steps * 1e3
        counts = kernels.launch_counts()
        per_shard = [dict(own) for own in fn.launches]
        ms = start.elapsed_time(end) / n_steps
        with host_syncs() as n_syncs:
            fn(s, dt)
            syncs = n_syncs()
        check(syncs == 0, f"sharded {path} step: {syncs} host synchronizations")
        serial_step = layered_step if layered else step
        _, ops, busy, idle = device_busy(lambda x: fn(x, dt), s, 5)
        _, s_ops, s_busy, s_idle = device_busy(lambda x: serial_step(model, x, dt),
                                               state0, 5)
        serial = (layered_multi_step if layered else multi_step)(model, state0, dt, n_steps)
        gathered = (parallel.gather_layered_state if layered else parallel.gather_state)(
            s, model, n)
        interiors_equal(model, gathered, serial,
                        ("u", "v", "c", "eta", "U", "V", "Gu", "Gv", "Gc"))
        each = GYRE_SHARD if layered else ("barotropic", "momentum", "tracer_adv")
        # the split (on by default): the tendency kernels on the bulk and two strips
        split = SPLIT_GYRE if layered else SPLIT_BICKLEY
        for i, own in enumerate(per_shard):
            check(all(own[k] == n_steps * (3 if k in split else 1) for k in each) and
                  own["halo_restore"] == own["halo_wrap"] == n_steps
                  and own["halo_pack"] == own["halo_fill_shard"] == 2 * n_steps
                  and own["halo_fill"] == 0, f"sharded {path} shard {i} launched {own}")
        fn.close()
        log(f"phase 12{'c' if layered else 'b'}: the 1/4-degree {path} in {n} y-shards "
            f"(rows {tuple(dist_state[0].u.shape)[-2:]} a shard) through LocalExchange, "
            f"{n_steps} steps at dt = {dt:g} s: gathered bitwise equal to the serial "
            f"run; {ms:.4f} ms/step on the card's clock ({wall:.4f} ms/step on the "
            f"host's), serial {serial_ms:.4f} ms/step (phase {7 if layered else 3}); "
            f"each shard launched {', '.join(k for k in each if k not in split)} once "
            f"and {', '.join(split)} three times a step (the split's bulk and two row "
            f"strips); exchange launches a step: {counts['halo_pack'] // n_steps} "
            f"packs, {counts['halo_wrap'] // n_steps} wraps, "
            f"{counts['halo_fill_shard'] // n_steps} shard fills, "
            f"{counts['halo_restore'] // n_steps} restores; host synchronizations 0; "
            f"profiler, 5 steps: {ops:.0f} device ops, {busy:.4f} ms device busy a step, "
            f"idle share {idle:.3f} (serial {s_ops:.0f} ops, {s_busy:.4f} ms, "
            f"{s_idle:.3f}); launches {counts} [{card}]")
        results[path] = counts
        shard_ms[path] = ms
        del dist_model, dist_state, s, serial, gathered

    # (d) one rank of an NCCL group: the step takes the serial route (ops/spmd._serial),
    # so this checks the serial step inside the group; no NCCL operation is made
    model, state0, _ = bickley
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", init_method="file://" + os.path.join(tmp, "store"),
                                rank=0, world_size=1)
        try:
            mesh = parallel.ProcessGroupExchange()
            dist_model, dist_state = parallel.distribute(model, state0, mesh)
            fn = parallel.sharded_step_fn(mesh, dist_model)
            s = fn(dist_state, 60.0)
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            with host_syncs() as n_syncs:
                for _ in range(3):
                    s = fn(s, 60.0)
                syncs = n_syncs()
            counts = kernels.launch_counts()
        finally:
            dist.destroy_process_group()
    serial = multi_step(model, state0, 60.0, 4)
    check(all(torch.equal(getattr(s[0], name), getattr(serial, name))
              for name in ("u", "v", "c", "eta", "U", "V", "Gu", "Gv", "Gc", "t")),
          "1-rank NCCL step bitwise equal to the serial step")
    check(syncs == 0, f"1-rank NCCL step: {syncs} host synchronizations")
    check(counts["halo_fill"] == 6 and counts["halo_restore"] == 3 and
          counts["halo_pack"] == 0 and counts["halo_fill_shard"] == 0,
          f"1-rank NCCL step launched {counts}")
    log(f"phase 12d: the sharded step of a 1-rank NCCL process group (ProcessGroupExchange"
        f"), 4 steps of the 1/4-degree Bickley jet: with one rank it takes the serial "
        f"route and makes no NCCL operation; bitwise equal to the serial step, the serial "
        f"launches ({counts['halo_fill'] // 3} fills and {counts['halo_restore'] // 3} "
        f"restore a step, no pack), host synchronizations 0 [{card}]")
    log("phase 12: not run on one card: ProcessGroupExchange's NCCL send and receive "
        "(NCCL refuses two ranks on one GPU; the exchange between ranks runs here through "
        "LocalExchange, with a card a rank in bench_scaling_torch.py --exchange nccl, "
        "phase 20 on the cards present, and on the CPU through gloo in "
        "tests/test_torch_distributed.py); not measured: the absence of host "
        "synchronization in an NCCL exchange")
    return results["Bickley"], shard_ms


def block_groups(rnd, n_x, n_y, ny):
    """The Bickley and gyre fill groups of the blocks of an (n_x, n_y) mesh of ``ny``
    rows at the 1/4-degree width: {group: {(ix, iy): the block's fields}}, each
    block's fields the rows [iy·ny, iy·ny + ny + 2·H) and columns [ix·nx, ix·nx + nx
    + 2·H) of fields drawn over the whole mesh, its η, U, V views of one buffer."""
    from orthogonalsphericalshellgrids_tpu_torch.ops.location import CC, CF, FC

    Nx, H, He = 1440, 5, 22
    nx = Nx // n_x
    out = {}
    for group, stacks in (("Bickley", [(None, FC, -1), (None, CF, -1), (None, CC, 1)]),
                          ("gyre", [(10, FC, -1), (10, CF, -1), (20, CC, 1)])):
        base = [(rnd(((K or 1), n_y * ny + 2 * H, Nx + 2 * H)), loc, sign)
                for K, loc, sign in stacks]
        ext = rnd((3, n_y * ny + 2 * He, Nx + 2 * He))
        blocks = {}
        for iy in range(n_y):
            for ix in range(n_x):
                fields = []
                for (A, loc, sign), (K, *_) in zip(base, stacks):
                    blk = A[:, iy * ny:iy * ny + ny + 2 * H,
                            ix * nx:ix * nx + nx + 2 * H].clone()
                    fields.append((blk if K else blk[0], loc, sign, nx, ny, H, H))
                buf = ext[:, iy * ny:iy * ny + ny + 2 * He,
                          ix * nx:ix * nx + nx + 2 * He].clone()
                fields += [(buf[0], CC, 1, nx, ny, He, He),
                           (buf[1], FC, -1, nx, ny, He, He),
                           (buf[2], CF, -1, nx, ny, He, He)]
                blocks[ix, iy] = fields
        out[group] = blocks
    return out


def block_fill_route(blocks, n_x, n_y, mode, what):
    """Every block's 2-D fill, launch by launch, each launch against its plain
    version on the same inputs, bitwise: the packs of the rows and fold strips, the
    inner phases with their save (reading the packs they receive), the packs of the
    columns, the outer phases saving into the same buffers, and the restores, which
    give every field back. Returns the launches held."""
    import torch

    from orthogonalsphericalshellgrids_tpu_torch.kernels import halo_fill
    from orthogonalsphericalshellgrids_tpu_torch.ops.spmd2d import Spmd2D
    from orthogonalsphericalshellgrids_tpu_torch.parallel.distributed import _rows2d

    nx_g = n_x * next(iter(blocks.values()))[0][3]
    sp = {k: Spmd2D(k[0], k[1], n_x, n_y, nx_g, None, mode) for k in blocks}
    before = {k: [f[0].clone() for f in fs] for k, fs in blocks.items()}
    plain = {k: [(f[0].clone(),) + f[1:] for f in fs] for k, fs in blocks.items()}
    plan = {k: halo_fill.group_plan(halo_fill.group_geometry(fs, sp[k].role))
            for k, fs in blocks.items()}
    held = 0

    def packs(kind):
        nonlocal held
        sent = {}
        for k, fs in blocks.items():
            got = halo_fill.pack_strips(fs, sp[k].role, kind)
            want = halo_fill.pack_strips_plain(plain[k], sp[k].role, kind)
            torch.cuda.synchronize()
            check(torch.equal(got, want), f"{what}: block {k} pack of "
                  f"{'columns' if kind else 'rows'} bitwise")
            sent[sp[k].rank] = got
            held += 1
        return sent

    lows = n_y > 1 and any(f[4] == f[6] for f in next(iter(blocks.values())))
    sent = packs(halo_fill.ROWS)
    saved = {}
    for k, fs in blocks.items():
        south, north, strips, below = _rows2d(sp[k], sent.__getitem__, plan[k].part_len,
                                              plan[k].fold_len, lows)
        kw = dict(save=True, role=sp[k].role, south=south, north=north,
                  phase=halo_fill.INNER, strips=strips, lows=below)
        saved[k] = (halo_fill.fill_halos_group(fs, **kw)[1],
                    halo_fill.fill_halos_group_plain(plain[k], **kw)[1])
        held += 1
    torch.cuda.synchronize()
    check(all(torch.equal(f[0], p[0]) for k, fs in blocks.items()
              for f, p in zip(fs, plain[k])), f"{what}: inner phases bitwise")
    sent = packs(halo_fill.COLUMNS)
    for k, fs in blocks.items():
        s, cl = sp[k], plan[k].col_len
        kw = dict(save=True, role=s.role, phase=halo_fill.OUTER,
                  west=sent[s.rank_of((s.ix - 1) % n_x, s.iy)][:cl],
                  east=sent[s.rank_of((s.ix + 1) % n_x, s.iy)][cl:])
        halo_fill.fill_halos_group(fs, saved=saved[k][0], **kw)
        halo_fill.fill_halos_group_plain(plain[k], saved=saved[k][1], **kw)
        held += 1
    torch.cuda.synchronize()
    check(all(torch.equal(f[0], p[0]) for k, fs in blocks.items()
              for f, p in zip(fs, plain[k])) and
          all(torch.equal(a, b) for a, b in saved.values()),
          f"{what}: outer phases and the saved strips bitwise")
    for k, fs in blocks.items():
        halo_fill.restore_strips_group(fs, saved[k][0], sp[k].role)
        halo_fill.restore_strips_group_plain(plain[k], saved[k][1], sp[k].role)
        held += 1
    torch.cuda.synchronize()
    check(all(torch.equal(f[0], b) and torch.equal(p[0], b) for k, fs in blocks.items()
              for f, p, b in zip(fs, plain[k], before[k])),
          f"{what}: the restores give every field back")
    return held


def phase13a_block_fills(card):
    """The 2-D route's launches against their plain versions, bitwise at float32
    and float64, in every block of 2 x 2 (gather), 4 x 1 (mirror) and 3 x 1 meshes
    on the Bickley and gyre groups, at the 1/4-degree blocks' rows and at the least
    rows the extended grid takes; then a top block of the 2 x 2 Bickley group timed
    at float32. Returns the kernel-table rows."""
    import numpy as np
    import torch

    from orthogonalsphericalshellgrids_tpu_torch import kernels
    from orthogonalsphericalshellgrids_tpu_torch.kernels import halo_fill
    from orthogonalsphericalshellgrids_tpu_torch.ops.spmd2d import Spmd2D
    from orthogonalsphericalshellgrids_tpu_torch.parallel.distributed import _rows2d

    results = {}
    for name in ("float32", "float64"):
        dt = getattr(torch, name)
        rng = np.random.default_rng(13)

        def rnd(shape):
            return torch.as_tensor(rng.standard_normal(shape), dtype=dt, device="cuda")

        for (n_x, n_y), mode in (((2, 2), "gather"), ((4, 1), "mirror"),
                                 ((3, 1), "gather")):
            for ny in (680 // n_y, 22 if n_y > 1 else 23):
                for group, blocks in block_groups(rnd, n_x, n_y, ny).items():
                    kernels.reset_launch_counts()
                    held = block_fill_route(blocks, n_x, n_y, mode,
                                            f"{group} {n_x} x {n_y} {mode} ny={ny} {name}")
                    counts = kernels.launch_counts()
                    check(counts["halo_pack_block"] == counts["halo_fill_block"] ==
                          2 * n_x * n_y and counts["halo_restore"] == n_x * n_y and
                          sum(counts.values()) == held,
                          f"block groups: one launch a call, {counts}")
                    log(f"phase 13a: {group} group, {n_x} x {n_y} blocks of {ny} x "
                        f"{1440 // n_x} ({mode}), {name}: {held} launches (packs of "
                        f"rows and columns, inner and outer phases with save, restores)"
                        f" bitwise their plain versions, inputs restored [{card}]")
                    del blocks
    # a top block of the 2 x 2 Bickley group at float32, with the host ahead
    rng = np.random.default_rng(14)
    blocks = block_groups(lambda shape: torch.as_tensor(
        rng.standard_normal(shape), dtype=torch.float32, device="cuda"), 2, 2, 340)["Bickley"]
    sp = {k: Spmd2D(k[0], k[1], 2, 2, 1440, None, "gather") for k in blocks}
    sent = {sp[k].rank: halo_fill.pack_strips(fs, sp[k].role) for k, fs in blocks.items()}
    k = (0, 1)
    fields, role = blocks[k], sp[k].role
    plan = halo_fill.group_plan(halo_fill.group_geometry(fields, role))
    south, north, strips, below = _rows2d(sp[k], sent.__getitem__, plan.part_len,
                                          plan.fold_len)
    inner = dict(south=south, north=north, phase=halo_fill.INNER, strips=strips)
    cols = halo_fill.pack_strips(fields, role, halo_fill.COLUMNS)
    outer = dict(phase=halo_fill.OUTER, west=cols[:plan.col_len], east=cols[plan.col_len:])
    _, sv = halo_fill.fill_halos_group(fields, True, role, **inner)
    halo_fill.fill_halos_group(fields, True, role, saved=sv, **outer)
    halo_fill.restore_strips_group(fields, sv, role)

    def fill_both():
        _, b = halo_fill.fill_halos_group(fields, True, role, **inner)
        halo_fill.fill_halos_group(fields, True, role, saved=b, **outer)

    def fill_both_plain():
        _, b = halo_fill.fill_halos_group_plain(fields, True, role, **inner)
        halo_fill.fill_halos_group_plain(fields, True, role, saved=b, **outer)

    rows_slices = ([f[0][..., f[4]:f[4] + f[6], :] for f in fields] +
                   [f[0][..., f[6]:2 * f[6], :] for f in fields] +
                   [f[0][..., f[4] - 1:f[4] + f[6], f[5]:f[5] + f[3]] for f in fields])
    col_slices = ([f[0][..., :, f[3]:f[3] + f[5]] for f in fields] +
                  [f[0][..., :, f[5]:2 * f[5]] for f in fields])
    t = dict(
        pack=time_ms(lambda: (halo_fill.pack_strips(fields, role),
                              halo_fill.pack_strips(fields, role, halo_fill.COLUMNS)),
                     ahead=True),
        pack_plain=time_ms(lambda: (halo_fill.pack_strips_plain(fields, role),
                                    halo_fill.pack_strips_plain(fields, role,
                                                                halo_fill.COLUMNS))),
        cat=time_ms(lambda: (torch.cat([x.reshape(-1) for x in rows_slices]),
                             torch.cat([x.reshape(-1) for x in col_slices]))),
        fill=time_ms(fill_both, ahead=True), fill_plain=time_ms(fill_both_plain))
    halo_fill.restore_strips_group(fields, sv, role)
    size = fields[0][0].element_size()
    written = plan.n_saved
    packed = 2 * plan.part_len + plan.fold_len + 2 * plan.col_len
    # each written cell's old value read and saved, its source read, its value written
    b_fill = bound(size * 4 * written, written)
    b_pack = bound(size * 2 * packed, 0)
    log(f"phase 13a: top block (0, 1) of the 2 x 2 Bickley group (340 x 720), float32, "
        f"device time with the host ahead, both phases or both packs: pack "
        f"{t['pack']:.4f} ms kernel, {t['pack_plain']:.4f} ms plain, torch.cat "
        f"{t['cat']:.4f} ms (bound {b_pack[0]:.5f} ms, {b_pack[2]} bytes); fill with save "
        f"{t['fill']:.4f} ms kernel, {t['fill_plain']:.4f} ms plain ({written} cells "
        f"written; bound {b_fill[0]:.5f} ms, {b_fill[2]} bytes) [{card}]")
    results["halo_fill_block"] = (0.0, t["fill"] / 2, t["fill_plain"] / 2,
                                  bound(size * 2 * written, written / 2))
    results["halo_pack_block"] = (0.0, t["pack"] / 2, t["pack_plain"] / 2,
                                  bound(size * packed, 0), t["cat"] / 2)
    del blocks, sent
    return results


def phase13_runs(card, bickley, gyre, shard_ms):
    """(b) phase 3's jet on 2 x 2 blocks (gather) and (c) on 4 x 1 (mirror), 20 steps
    at dt = 60 s, and (d) phase 7's gyre on 2 x 2, 3 steps at dt = 40 s, through
    LocalExchange: bitwise equal to serial (and (c) to (b)), each block's launches
    counted, no host synchronization; (e) overlap=True against overlap=False on 4
    y-shards and on 2 x 2, both models, bitwise. Returns the (b) run's launch
    counts and {run: ms/step} of (b)-(d)."""
    import torch

    from orthogonalsphericalshellgrids_tpu_torch import kernels, parallel
    from orthogonalsphericalshellgrids_tpu_torch.models import (layered_multi_step,
                                                                 layered_step, multi_step,
                                                                 step)

    names = ("u", "v", "c", "eta", "U", "V", "Gu", "Gv", "Gc")

    def interiors_equal(model, got, want, what):
        for name in names:
            grid = model.grid_ext if name in ("eta", "U", "V") else model.grid
            check(torch.equal(grid.interior(getattr(got, name)),
                              grid.interior(getattr(want, name))),
                  f"{what}: {name} bitwise")

    def run(model, state0, mesh, layered, n_steps, dt, overlap=None, mode="auto"):
        """(gathered state, ms/step on the card, per-block launches, all launches,
        the step function and the last sharded state)."""
        if isinstance(mesh, int):
            m = parallel.make_mesh(mesh)
            dm, ds = (parallel.distribute_layered if layered else parallel.distribute)(
                model, state0, m)
            fn = (parallel.sharded_layered_step_fn if layered else
                  parallel.sharded_step_fn)(m, dm, overlap=overlap)
            gather = lambda x: (parallel.gather_layered_state if layered else  # noqa
                                parallel.gather_state)(x, model, mesh)
        else:
            m = parallel.make_mesh2d(*mesh)
            dm, ds = (parallel.distribute_layered2d if layered else
                      parallel.distribute2d)(model, state0, m)
            fn = (parallel.sharded_layered_step_fn2d if layered else
                  parallel.sharded_step_fn2d)(m, dm, model.grid.Nx, overlap=overlap,
                                              fold_mode=mode)
            gather = lambda x: (parallel.gather_layered_state2d if layered else  # noqa
                                parallel.gather_state2d)(x, model, m)
        fn(ds, dt)  # loads the exchange's path
        torch.cuda.synchronize()
        fn.launches = [dict.fromkeys(kernels.LAUNCHES, 0) for _ in fn.launches]
        kernels.reset_launch_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        s = ds
        start.record()
        for _ in range(n_steps):
            s = fn(s, dt)
        end.record()
        end.synchronize()
        return (gather(s), start.elapsed_time(end) / n_steps,
                [dict(x) for x in fn.launches], kernels.launch_counts(), fn, s)

    bmodel, bstate, bickley_ms = bickley
    gmodel, gstate, gyre_ms = gyre
    serial_b = multi_step(bmodel, bstate, 60.0, 20)
    serial_g = layered_multi_step(gmodel, gstate, 40.0, 3)
    out = {}
    for tag, model, state0, layered, mesh, mode, n_steps, dt, serial, ref_ms, split in (
            ("b", bmodel, bstate, False, (2, 2), "auto", 20, 60.0, serial_b, bickley_ms,
             SPLIT_BICKLEY),
            ("c", bmodel, bstate, False, (4, 1), "mirror", 20, 60.0, serial_b,
             bickley_ms, SPLIT_BICKLEY),
            ("d", gmodel, gstate, True, (2, 2), "auto", 3, 40.0, serial_g, gyre_ms,
             SPLIT_GYRE)):
        got, ms, per_block, counts, fn, s = run(model, state0, mesh, layered, n_steps, dt,
                                                mode=mode)
        what = f"phase 13{tag}: {'gyre' if layered else 'Bickley'} on {mesh[0]} x {mesh[1]}"
        interiors_equal(model, got, serial, f"{what} against serial")
        if tag == "c":
            interiors_equal(model, got, out["b"][0], f"{what} (mirror) against (b)")
        each = GYRE_SHARD if layered else ("barotropic", "momentum", "tracer_adv")
        for i, own in enumerate(per_block):
            check(all(own[k] == n_steps * (5 if k in split else 1) for k in each) and
                  own["halo_restore"] == n_steps and
                  own["halo_pack_block"] == own["halo_fill_block"] == 4 * n_steps and
                  own["halo_fill"] == own["halo_pack"] == own["halo_wrap"] == 0,
                  f"{what}: block {i} launched {own}")
        with host_syncs() as n_syncs:
            fn(s, dt)
            syncs = n_syncs()
        check(syncs == 0, f"{what}: {syncs} host synchronizations")
        serial_step = layered_step if layered else step
        _, ops, busy, idle = device_busy(lambda x: fn(x, dt), s, 5)
        _, s_ops, s_busy, s_idle = device_busy(lambda x: serial_step(model, x, dt),
                                               state0, 5)
        fn.close()
        log(f"{what} blocks ({mode} fold: {fn.spmd_of(0).resolved_fold_mode}) through "
            f"LocalExchange, {n_steps} steps at dt = {dt:g} s: gathered bitwise equal to "
            f"the serial run{' and to (b)' if tag == 'c' else ''}; {ms:.4f} ms/step "
            f"(serial {ref_ms:.4f}, phase {7 if layered else 3}; 4 y-shards "
            f"{shard_ms['gyre' if layered else 'Bickley']:.4f}, phase 12); each block "
            f"launched {', '.join(k for k in each if k not in split)} once and "
            f"{', '.join(split)} five times a step (the split's bulk, two row and two "
            f"column strips), 4 block packs and 4 block fills (two groups, two phases "
            f"each) and 1 restore a step; host synchronizations 0; profiler, 5 steps: "
            f"{ops:.0f} device ops, {busy:.4f} ms device busy a step, idle share "
            f"{idle:.3f} (serial {s_ops:.0f} ops, {s_busy:.4f} ms, {s_idle:.3f}); "
            f"launches {counts} [{card}]")
        out[tag] = (got, counts, ms)
    # (e) the split against the unsplit step
    for path, model, state0, layered, n_steps, dt in (("Bickley", bmodel, bstate, False, 5,
                                                       60.0),
                                                      ("gyre", gmodel, gstate, True, 3,
                                                       40.0)):
        for mesh in (4, (2, 2)):
            res = {}
            for overlap in (True, False):
                got, ms, _, _, fn, s = run(model, state0, mesh, layered, n_steps, dt,
                                           overlap=overlap)
                _, ops, busy, idle = device_busy(lambda x: fn(x, dt), s, 5)
                fn.close()
                res[overlap] = (got, ms, ops, busy, idle)
            where = f"{mesh} y-shards" if isinstance(mesh, int) else \
                f"{mesh[0]} x {mesh[1]} blocks"
            interiors_equal(model, res[True][0], res[False][0],
                            f"phase 13e: {path} on {where}, split against unsplit")
            log(f"phase 13e: {path} on {where}, {n_steps} steps: overlap=True bitwise "
                f"equal to overlap=False; split {res[True][1]:.4f} ms/step "
                f"({res[True][2]:.0f} device ops, {res[True][3]:.4f} ms busy, idle "
                f"{res[True][4]:.3f}), unsplit {res[False][1]:.4f} ms/step "
                f"({res[False][2]:.0f} ops, {res[False][3]:.4f} ms, idle "
                f"{res[False][4]:.3f}) [{card}]")
    log("phase 13: not measured: the 2-D exchange across cards (one card; "
        "ProcessGroupExchange's NCCL sends, and the overlap the split is for, need two; "
        "the 2-D exchange between processes runs on the CPU through gloo in "
        "tests/test_torch_distributed2d.py)")
    return out["b"][1], {tag: run_[2] for tag, run_ in out.items()}

def model_variant(model, **options):
    """Phase 3's model with other ``OPTIONS`` metadata (the schemes change no array),
    built by the model's constructor from the same arrays, as a shard's model is."""
    from orthogonalsphericalshellgrids_tpu_torch.kernels import tracer_adv
    from orthogonalsphericalshellgrids_tpu_torch.models import hydrostatic as H

    n_static = len(tracer_adv.STATIC_PLANES)
    return H.HydrostaticModel(
        model.grid, model.grid_ext, model.ib, {n: getattr(model, n) for n in H.DERIVED},
        substeps=model.substeps, fractional_dt=model.fractional_dt, g=model.g,
        coriolis=model.coriolis,
        options=dict({n: getattr(model, n) for n in H.OPTIONS}, **options),
        mom_lay=model.mom_lay,
        kappa=list(model.adv_pack[n_static:]) if model.adv_pack.shape[0] > n_static else None)


def phase14a_planes(card):
    """The tracer kernel's column mode over P planes against its plain version and,
    plane by plane, bitwise against one-plane launches; timed at float32 with the
    host ahead. Returns the kernel-table row (P = 2 without kappa_h or acc, the
    two-tracer jet's call)."""
    import numpy as np
    import torch

    from orthogonalsphericalshellgrids_tpu_torch import kernels
    from orthogonalsphericalshellgrids_tpu_torch.kernels import tracer_adv

    Yb, Xb = FILL_SHAPES["base"]
    R = tracer_adv.REACH
    I = (slice(R, Yb - R), slice(R, Xb - R))
    row = None
    for name in ("float32", "float64"):
        dt = getattr(torch, name)
        rng = np.random.default_rng(1414)
        u, v = (torch.as_tensor(a, dtype=dt, device="cuda")
                for a in rng.standard_normal((2, Yb, Xb)))
        st = torch.as_tensor(1.0 + rng.random((8, Yb, Xb)), dtype=dt, device="cuda")
        st[7] *= 0.1
        for P in (2, 3):
            c = torch.as_tensor(rng.standard_normal((P, Yb, Xb)), dtype=dt, device="cuda")
            c[1:, : Yb // 3] = 0.0  # exact zeros, as on land
            acc = torch.as_tensor(0.5 * rng.standard_normal((P, Yb, Xb)), dtype=dt,
                                  device="cuda")
            for kappa in (False, True):
                pack = st if kappa else st[:5].contiguous()
                for a in (None, acc):
                    kernels.reset_launch_counts()
                    got = tracer_adv.tracer_adv(c, u, v, pack, acc=a)
                    counts = kernels.launch_counts()
                    check(counts["tracer_adv_planes"] == 1 and sum(counts.values()) == 1,
                          f"P-plane launch counted once: {counts}")
                    ea, er = rel_err(got, tracer_adv.tracer_adv_plain(c, u, v, pack, acc=a),
                                     I)
                    what = f"tracer_adv P={P} kappa={kappa} acc={a is not None} {name}"
                    check(er <= BANDS[name], f"{what}: rel err {er:.3e}")
                    check(bool(torch.isfinite(got).all()) and edge_zero(got, R),
                          f"{what}: finite, edge 0")
                    for p in range(P):
                        one = tracer_adv.tracer_adv(c[p], u, v, pack,
                                                    acc=None if a is None else a[p])
                        check(torch.equal(got[p], one), f"{what}: plane {p} bitwise a "
                              "one-plane launch")
                    if name == "float32" and not kappa and a is None:
                        t_k = time_ms(lambda: tracer_adv.tracer_adv(c, u, v, pack),
                                      ahead=True)
                        t_1 = time_ms(lambda: [tracer_adv.tracer_adv(c[p], u, v, pack)
                                               for p in range(P)], ahead=True)
                        t_one = time_ms(lambda: tracer_adv.tracer_adv(c[0], u, v, pack),
                                        ahead=True)
                        t_p = time_ms(lambda: tracer_adv.tracer_adv_plain(c, u, v, pack),
                                      n=5)
                        b = bound(nbytes(c, u, v, pack, c), FLOPS["tracer_adv_planes"]
                                  * c.numel())
                        log(f"phase 14a: tracer_adv_planes P={P} on {tuple(c.shape)} "
                            f"float32, host ahead: {t_k:.4f} ms; {P} one-plane launches "
                            f"{t_1:.4f} ms; one plane alone {t_one:.4f} ms; plain "
                            f"{t_p:.4f} ms; bound "
                            f"{b[0]:.4f} ms by {b[1]} ({b[2]} bytes) [{card}]")
                        if P == 2:
                            row = (ea, t_k, t_p, b)
        log(f"phase 14a: tracer_adv over P = 2 and 3 planes of ({Yb}, {Xb}), {name}, with "
            f"and without kappa_h and acc: within the band {BANDS[name]:g}, finite, edge "
            f"cells 0, every plane bitwise equal to a one-plane launch [{card}]")
    return {"tracer_adv_planes": row}


def smooth_field(model, seed=14):
    """A smooth tracer in [-1, 1] from ``seed``: a few random zonal and meridional
    modes on the cell centres, the interior only, masked (as ``initial_state`` sets
    a field)."""
    import numpy as np
    import torch

    g = model.grid
    lam = np.deg2rad(g.lam_cc.cpu().numpy().astype(np.float64))
    phi = np.deg2rad(g.phi_cc.cpu().numpy().astype(np.float64))
    rng = np.random.default_rng(seed)
    d = np.zeros(g.shape2d)
    for k in range(1, 4):
        for m in range(1, 4):
            a, p, q = rng.standard_normal(), rng.uniform(0, 2 * np.pi), rng.uniform(0, np.pi)
            d += a * np.cos(k * lam + p) * np.cos(m * phi + q)
    full = np.zeros(g.shape2d)
    full[g.interior2d] = d[g.interior2d] / np.abs(d[g.interior2d]).max()
    return torch.as_tensor(full).to(device=model.device, dtype=model.dtype) * model.ib.mask_c


def phase14_options(card, bmodel, bstate0, bickley_ms, n_steps=20, warm=3,
                    option_steps=5):
    """(b) the two-tracer jet, (c) the other options, (d) the splits; returns the
    two-tracer run's launch counts."""
    import dataclasses

    import torch

    from examples.bickley_jet_torch import bottom_height, build
    from orthogonalsphericalshellgrids_tpu_torch import kernels, parallel
    from orthogonalsphericalshellgrids_tpu_torch.models import (
        SplitExplicitFreeSurface, make_model, multi_step, step)
    from orthogonalsphericalshellgrids_tpu_torch.models import hydrostatic as H

    def timed(model, state, steps):
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state = multi_step(model, state, 60.0, steps)
        end.record()
        end.synchronize()
        return state, start.elapsed_time(end) / steps, kernels.launch_counts()

    def equal(model, a, b, names, what):
        for name in names:
            grid = model.grid_ext if name in ("eta", "U", "V") else model.grid
            check(torch.equal(grid.interior(getattr(a, name)),
                              grid.interior(getattr(b, name))), f"{what}: {name} bitwise")

    # (b) two tracers: phase 3's c and a smooth field, each also alone
    t0 = time.perf_counter()
    m2 = make_model(bmodel.grid, free_surface=SplitExplicitFreeSurface(substeps=30),
                    bottom_height=bottom_height(), tracers=("c", "d"), device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    d0 = smooth_field(bmodel)
    s2 = dataclasses.replace(bstate0, c=torch.stack([bstate0.c, d0]),
                             Gc=torch.zeros((2,) + bstate0.c.shape, dtype=bstate0.c.dtype,
                                            device="cuda"))
    s2 = multi_step(m2, s2, 60.0, warm)
    s2, ms2, counts = timed(m2, s2, n_steps)
    expected = {k: 0 for k in counts}
    expected.update(halo_fill=2 * n_steps, halo_restore=n_steps, momentum=n_steps,
                    tracer_adv_planes=n_steps, barotropic=n_steps)
    check(counts == expected, f"two-tracer launch counts {counts} != {expected}")
    one_c = multi_step(bmodel, bstate0, 60.0, warm + n_steps)
    one_d = multi_step(bmodel, dataclasses.replace(bstate0, c=d0), 60.0, warm + n_steps)
    equal(bmodel, s2, one_c, ("u", "v", "eta", "U", "V", "Gu", "Gv"),
          "phase 14b: two-tracer flow against the single-tracer run")
    for k, one in enumerate((one_c, one_d)):
        check(torch.equal(s2.c[k], one.c) and torch.equal(s2.Gc[k], one.Gc),
              f"phase 14b: tracer plane {k} bitwise its single-tracer run")
    check(all(bool(torch.isfinite(getattr(s2, n)).all()) for n in ("u", "v", "c", "eta")),
          "phase 14b: finite")
    log(f"phase 14b: the 1440 x 680 jet with two tracers (c and a smooth field from the "
        f"seed; model built on phase 3's grid in {build_s:.1f} s), {n_steps} steps after "
        f"{warm} warm-up: {ms2:.4f} ms/step (one tracer, phase 3: {bickley_ms:.4f}); "
        f"launches {counts}; u, v, eta, U, V bitwise the single-tracer run, each plane "
        f"(c and Gc) bitwise its own single-tracer run [{card}]")

    # (c) each other option on the 1/4-degree jet, then at float64 against the CPU
    for label, opts in OPTIONS.items():
        m = model_variant(bmodel, **opts)
        s = multi_step(m, bstate0, 60.0, 1)
        s, ms, cnt = timed(m, s, option_steps)
        mom = opts.get("momentum_advection", "weno_vector_invariant") != "vector_invariant"
        adv = opts.get("tracer_advection", "weno5") == "weno5"
        check(cnt["momentum"] == option_steps * mom and
              cnt["tracer_adv"] == option_steps * adv and
              cnt["barotropic"] == option_steps, f"phase 14c {label}: launches {cnt}")
        check(all(bool(torch.isfinite(getattr(s, n)).all())
                  for n in ("u", "v", "c", "eta", "U", "V")), f"phase 14c {label}: finite")
        cmin, cmax = float(s.c.min()), float(s.c.max())
        check(-1.5 < cmin and cmax < 1.5, f"phase 14c {label}: c in (-1.5, 1.5): "
              f"[{cmin}, {cmax}]")
        gpu_m, gpu_s = build(48, 40, dtype=torch.float64, device="cuda", **opts)
        cpu_m, cpu_s = build(48, 40, dtype=torch.float64, device="cpu", **opts)
        gpu_out = multi_step(gpu_m, gpu_s, 120.0, 3)
        cpu_out = multi_step(cpu_m, cpu_s, 120.0, 3)
        worst = []
        for name in ("u", "v", "c", "eta"):
            grid = cpu_m.grid_ext if name == "eta" else cpu_m.grid
            w = grid.interior(getattr(cpu_out, name))
            rel = float((grid.interior(getattr(gpu_out, name)).cpu() - w).abs().max()
                        / w.abs().max())
            worst.append(f"{name} {rel:.3e}")
            check(rel <= 1e-11, f"phase 14c {label} float64: {name} rel {rel:.3e}")
        log(f"phase 14c: {label}: {option_steps} steps of the 1440 x 680 jet at "
            f"{ms:.4f} ms/step (phase 3: {bickley_ms:.4f}), finite, c in [{cmin:.6f}, "
            f"{cmax:.6f}], launches momentum {cnt['momentum']}, tracer_adv "
            f"{cnt['tracer_adv']}; 48 x 40 float64, 3 steps on the card against the CPU: "
            f"max rel diff {', '.join(worst)} (rtol 1e-11) [{card}]")

    # (d) the split with WENO-7's radius, and the two-tracer jet sharded
    names = ("u", "v", "c", "eta", "U", "V", "Gu", "Gv", "Gc")
    m7 = model_variant(bmodel, tracer_advection="weno7")
    check(H.overlap_radius(m7) == 4 and H.overlap_radius(bmodel) == 3,
          "overlap radius of WENO-7 and WENO-5")

    def sharded(model, state0, mesh, overlap, steps=3):
        if isinstance(mesh, int):
            m = parallel.make_mesh(mesh)
            dm, ds = parallel.distribute(model, state0, m)
            fn = parallel.sharded_step_fn(m, dm, overlap=overlap)
            gather = lambda x: parallel.gather_state(x, model, mesh)  # noqa: E731
        else:
            m = parallel.make_mesh2d(*mesh)
            dm, ds = parallel.distribute2d(model, state0, m)
            fn = parallel.sharded_step_fn2d(m, dm, model.grid.Nx, overlap=overlap)
            gather = lambda x: parallel.gather_state2d(x, model, m)  # noqa: E731
        check(all(H.overlap_supported(model, x.grid) for x in dm),
              "the split is exact on every shard")
        for _ in range(steps):
            ds = fn(ds, 60.0)
        fn.close()
        return gather(ds)

    serial7 = multi_step(m7, bstate0, 60.0, 3)
    for mesh in (4, (2, 2)):
        split = sharded(m7, bstate0, mesh, True)
        unsplit = sharded(m7, bstate0, mesh, False)
        where = f"{mesh} y-shards" if isinstance(mesh, int) else f"{mesh[0]} x {mesh[1]}"
        equal(m7, split, unsplit, names, f"phase 14d: WENO-7 on {where}, split/unsplit")
        equal(m7, split, serial7, names, f"phase 14d: WENO-7 on {where} against serial")
        log(f"phase 14d: WENO-7 (radius 4, halo 5) on {where}, 3 steps through "
            f"LocalExchange: split bitwise equal to unsplit and to serial [{card}]")
    s2_0 = dataclasses.replace(bstate0, c=torch.stack([bstate0.c, d0]),
                               Gc=torch.zeros((2,) + bstate0.c.shape, dtype=bstate0.c.dtype,
                                              device="cuda"))
    equal(m2, sharded(m2, s2_0, 4, None), multi_step(m2, s2_0, 60.0, 3), names,
          "phase 14d: two-tracer jet on 4 y-shards against serial")
    log(f"phase 14d: the two-tracer jet on 4 y-shards (split), 3 steps: bitwise equal to "
        f"serial [{card}]")
    return counts


def scaled_state(state, s):
    """``state`` with every field times ``s`` (t and iteration kept), as
    tests/test_ensemble.py makes its members."""
    import dataclasses

    from orthogonalsphericalshellgrids_tpu_torch.models import State

    return State(**{f.name: getattr(state, f.name) * s
                    if f.name not in ("t", "iteration") else getattr(state, f.name)
                    for f in dataclasses.fields(State)})


def phase15a_members(card, B=4):
    """The barotropic kernel's member axis and the tracer kernel's member mode at the
    main path's shapes with B members: within the bands of their plain versions at
    float32 and float64, each member bitwise its one-member launch; timed at float32
    with the host ahead beside B one-member launches. Returns the kernel-table row of
    ``tracer_adv_members`` (B = 4, one tracer, the ensemble's call)."""
    import numpy as np
    import torch

    from orthogonalsphericalshellgrids_tpu_torch import kernels
    from orthogonalsphericalshellgrids_tpu_torch.kernels import barotropic, tracer_adv
    from orthogonalsphericalshellgrids_tpu_torch.models.split_explicit import (
        averaging_weights)

    row = None
    for name in ("float32", "float64"):
        dt = getattr(torch, name)
        rng = np.random.default_rng(1515)

        def rnd(shape, scale=1.0, lo=None):
            a = rng.random(shape) + lo if lo is not None else scale * rng.standard_normal(shape)
            return torch.as_tensor(a, dtype=dt, device="cuda")

        # barotropic: B members on the extended plane, 21 SM05 weights
        Ye, Xe = FILL_SHAPES["ext"]
        static = rnd((9, Ye, Xe), lo=0.5)
        static[7:] = (static[7:] > 0.6).to(dt)
        dyn = [rnd((B, Ye, Xe), 0.01) for _ in range(3)] + [rnd((B, Ye, Xe), 1e-3)
                                                            for _ in range(2)]
        tail = (torch.tensor(0.01, dtype=dt, device="cuda"),
                torch.as_tensor(averaging_weights(30)[1], dtype=dt, device="cuda"))
        I = (slice(22, Ye - 22), slice(22, Xe - 22))
        errs = []
        for wrap in (False, True):
            args = (static, *dyn, *tail, 1440, 22, wrap)
            kernels.reset_launch_counts()
            got = barotropic.barotropic_substeps(*args)
            check(kernels.launch_counts()["barotropic"] == 1, "one barotropic call")
            for g, w in zip(got, barotropic.barotropic_substeps_plain(*args)):
                ea, er = rel_err(g, w, I)
                check(er <= BANDS[name] and bool(torch.isfinite(g).all()),
                      f"barotropic members {name} wrap={wrap}: rel err {er:.3e}")
                errs.append((ea, er))
            for b in range(B):
                one = barotropic.barotropic_substeps(static, *(d[b] for d in dyn), *tail,
                                                     1440, 22, wrap)
                for comp, g, o in zip(("eta", "U", "V"), got, one):
                    check(torch.equal(g[b], o), f"barotropic members {name} wrap={wrap}: "
                          f"member {b} {comp} bitwise its one-member call")
        msg = (f"phase 15a: barotropic over B = {B} members of {(Ye, Xe)}, {name}, wrap "
               f"on and off: max rel err {max(e[1] for e in errs):.3e} (band "
               f"{BANDS[name]:g}), each member bitwise its one-member call")
        if name == "float32":
            args = (static, *dyn, *tail, 1440, 22, False)
            t_m = time_ms(lambda: barotropic.barotropic_substeps(*args), n=10, ahead=True)
            t_1 = time_ms(lambda: [barotropic.barotropic_substeps(
                static, *(d[b] for d in dyn), *tail, 1440, 22, False) for b in range(B)],
                n=10, ahead=True)
            t_p = time_ms(lambda: barotropic.barotropic_substeps_plain(*args), n=3)
            n_sub = tail[1].numel()
            b_ = bound(nbytes(static, *dyn) + 3 * nbytes(dyn[0]),
                       FLOPS["barotropic"] * n_sub * dyn[0].numel())
            msg += (f"; host ahead {t_m:.4f} ms, {B} one-member calls {t_1:.4f} ms, plain "
                    f"{t_p:.4f} ms; bound {b_[0]:.4f} ms by {b_[1]} ({b_[2]} bytes)")
        log(msg + f" [{card}]")

        # tracer advection: B members of n tracers on the base plane
        Yb, Xb = FILL_SHAPES["base"]
        R = tracer_adv.REACH
        I = (slice(R, Yb - R), slice(R, Xb - R))
        st = rnd((8, Yb, Xb), lo=1.0)
        st[7] *= 0.1
        for nb, n in ((B, 1), (2, 2)):
            u, v = rnd((nb, Yb, Xb)), rnd((nb, Yb, Xb))
            shape = (nb, Yb, Xb) if n == 1 else (nb, n, Yb, Xb)
            c = rnd(shape)
            c[1:, ..., : Yb // 3, :] = 0.0  # exact zeros, as on land
            acc = rnd(shape, 0.5)
            for kappa in (False, True):
                pack = st if kappa else st[:5].contiguous()
                for a in (None, acc):
                    kernels.reset_launch_counts()
                    got = tracer_adv.tracer_adv(c, u, v, pack, acc=a)
                    counts = kernels.launch_counts()
                    check(counts["tracer_adv_members"] == 1 and sum(counts.values()) == 1,
                          f"member launch counted once: {counts}")
                    ea, er = rel_err(got, tracer_adv.tracer_adv_plain(c, u, v, pack, acc=a),
                                     I)
                    what = (f"tracer_adv B={nb} n={n} kappa={kappa} acc={a is not None} "
                            f"{name}")
                    check(er <= BANDS[name], f"{what}: rel err {er:.3e}")
                    check(bool(torch.isfinite(got).all()) and edge_zero(got, R),
                          f"{what}: finite, edge 0")
                    g4 = got.reshape(nb, n, Yb, Xb)
                    c4 = c.reshape(nb, n, Yb, Xb)
                    a4 = None if a is None else a.reshape(nb, n, Yb, Xb)
                    for b in range(nb):
                        for t in range(n):
                            one = tracer_adv.tracer_adv(c4[b, t], u[b], v[b], pack,
                                                        acc=None if a4 is None else a4[b, t])
                            check(torch.equal(g4[b, t], one), f"{what}: member {b} plane "
                                  f"{t} bitwise a one-plane launch")
                    if name == "float32" and n == 1 and not kappa and a is None:
                        t_k = time_ms(lambda: tracer_adv.tracer_adv(c, u, v, pack),
                                      ahead=True)
                        t_1 = time_ms(lambda: [tracer_adv.tracer_adv(c[b], u[b], v[b], pack)
                                               for b in range(nb)], ahead=True)
                        t_p = time_ms(lambda: tracer_adv.tracer_adv_plain(c, u, v, pack),
                                      n=5)
                        b_ = bound(nbytes(c, u, v, pack, c),
                                   FLOPS["tracer_adv_members"] * c.numel())
                        log(f"phase 15a: tracer_adv_members B={nb} on {tuple(c.shape)} "
                            f"float32, host ahead: {t_k:.4f} ms; {nb} one-plane launches "
                            f"{t_1:.4f} ms; plain {t_p:.4f} ms; bound {b_[0]:.4f} ms by "
                            f"{b_[1]} ({b_[2]} bytes) [{card}]")
                        row = (ea, t_k, t_p, b_)
        log(f"phase 15a: tracer_adv over B = {B} members of one tracer and 2 members of "
            f"two, ({Yb}, {Xb}), {name}, with and without kappa_h and acc: within the band "
            f"{BANDS[name]:g}, finite, edge cells 0, every plane bitwise a one-plane launch "
            f"over its member's u and v [{card}]")
    return {"tracer_adv_members": row}


def phase15_ensemble(card, bmodel, bstate0, bickley_ms, n_steps=20, warm=3):
    """Phase 3's jet as an ensemble of 4 members (the base state times 0.5, 0.75, 1.0
    and 1.25), 20 steps after 3 warm-up through ensemble_multi_step: the launches of
    one serial step a step, each member bitwise its own serial run; ms/step as run and
    with the host ahead, device busy and idle share, beside the serial step; then a
    two-tracer ensemble of 2 members, bitwise per plane. Returns the launch counts."""
    import dataclasses

    import torch

    from examples.bickley_jet_torch import bottom_height
    from orthogonalsphericalshellgrids_tpu_torch import kernels
    from orthogonalsphericalshellgrids_tpu_torch.models import (
        SplitExplicitFreeSurface, ensemble, make_model, multi_step, step)

    B = len(ENSEMBLE_SCALES)
    serial0 = [scaled_state(bstate0, s) for s in ENSEMBLE_SCALES]
    batch = ensemble.stack_members(serial0)
    batch = ensemble.ensemble_multi_step(bmodel, batch, 60.0, warm)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    batch = ensemble.ensemble_multi_step(bmodel, batch, 60.0, n_steps)
    end.record()
    end.synchronize()
    counts = kernels.launch_counts()
    ms = start.elapsed_time(end) / n_steps
    expected = {k: 0 for k in counts}
    expected.update(halo_fill=2 * n_steps, halo_restore=n_steps, momentum=n_steps,
                    tracer_adv_members=n_steps, barotropic=n_steps)
    check(counts == expected, f"ensemble launch counts {counts} != {expected}")
    for i, s0 in enumerate(serial0):
        want = multi_step(bmodel, s0, 60.0, warm + n_steps)
        got = ensemble.member(batch, i)
        for name in ("u", "v", "eta", "U", "V", "c", "Gu", "Gv", "Gc", "t", "iteration"):
            check(torch.equal(getattr(got, name), getattr(want, name)),
                  f"phase 15b: member {i} {name} bitwise its serial run")
    check(all(bool(torch.isfinite(getattr(batch, n)).all()) for n in ("u", "v", "c", "eta")),
          "phase 15b: finite")
    ms_ahead = time_ms(lambda: ensemble.ensemble_step(bmodel, batch, 60.0), n=10,
                       ahead=True)
    serial_ahead = time_ms(lambda: step(bmodel, bstate0, 60.0), n=10, ahead=True)
    serial_ms = time_ms(lambda: step(bmodel, bstate0, 60.0), n=10)

    def run(s):
        return ensemble.ensemble_step(bmodel, s, 60.0)

    _, ops, busy, idle = device_busy(run, batch, 5)
    _, s_ops, s_busy, s_idle = device_busy(lambda s: step(bmodel, s, 60.0), bstate0, 5)
    log(f"phase 15b: the 1440 x 680 jet as an ensemble of {B} members (scales "
        f"{ENSEMBLE_SCALES}), {n_steps} steps after {warm} warm-up: {ms:.4f} ms/step as "
        f"run, {ms_ahead:.4f} with the host ahead; device busy {busy:.4f} ms a step in "
        f"{ops:.0f} device operations, idle share {idle:.3f}; the serial step in this "
        f"phase {serial_ms:.4f} as run, {serial_ahead:.4f} host ahead, busy {s_busy:.4f} "
        f"ms in {s_ops:.0f} operations, idle {s_idle:.3f}; phase 3 {bickley_ms:.4f} ms/step, "
        f"{B} x that {B * bickley_ms:.4f}; launches {counts}; every member bitwise its "
        f"serial run (u, v, eta, U, V, c, Gu, Gv, Gc, t, iteration) [{card}]")

    # two tracers, two members one step apart
    m2 = make_model(bmodel.grid, free_surface=SplitExplicitFreeSurface(substeps=30),
                    bottom_height=bottom_height(), tracers=("c", "d"), device="cuda")
    c2 = torch.stack([bstate0.c, bstate0.c * bstate0.c])
    base2 = dataclasses.replace(bstate0, c=c2, Gc=torch.zeros_like(c2))
    pair = [base2, step(m2, scaled_state(base2, 0.5), 60.0)]
    out = ensemble.ensemble_multi_step(m2, ensemble.stack_members(pair), 60.0, 3)
    for i, s0 in enumerate(pair):
        want = multi_step(m2, s0, 60.0, 3)
        got = ensemble.member(out, i)
        for name in ("u", "v", "eta", "U", "V", "Gu", "Gv", "t", "iteration"):
            check(torch.equal(getattr(got, name), getattr(want, name)),
                  f"phase 15c: two-tracer member {i} {name} bitwise")
        for k in range(2):
            check(torch.equal(got.c[k], want.c[k]) and torch.equal(got.Gc[k], want.Gc[k]),
                  f"phase 15c: two-tracer member {i} plane {k} bitwise")
    log(f"phase 15c: a two-tracer ensemble of 2 members (iterations 0 and 1), 3 steps: "
        f"each member's flow and each tracer plane bitwise its serial run [{card}]")
    return counts


def equatorial_law(p):
    """The equatorial refinement of tests/test_tripolar_grid.py:238, on tensors."""
    import torch

    return 1.0 - 0.5 * torch.exp(-((p / 15.0) ** 2))


def bickley_on(grid):
    """(model, state) of the Bickley jet of examples/bickley_jet_torch.py:build on
    ``grid`` (its bottom, substeps 30 and initial conditions)."""
    import numpy as np

    from examples.bickley_jet_torch import bottom_height
    from orthogonalsphericalshellgrids_tpu_torch.models import (
        SplitExplicitFreeSurface, initial_state, make_model)

    model = make_model(grid, free_surface=SplitExplicitFreeSurface(substeps=30),
                       bottom_height=bottom_height(), device=grid.device)
    eps, ell, k = 0.1, 0.5, 2.5

    def psit(x, y):
        return np.exp(-((y + ell / 10) ** 2) / (2 * ell**2)) * np.cos(k * x) * np.cos(k * y)

    def ui(lam, phi):
        x, y = np.deg2rad(lam) * 2, np.deg2rad(phi) * 8
        return 1.0 / np.cosh(y) ** 2 + eps * psit(x, y) * (k * np.tan(k * y) + y / ell**2)

    def vi(lam, phi):
        x, y = np.deg2rad(lam) * 2, np.deg2rad(phi) * 4
        return -eps * psit(x, y) * k * np.tan(k * x)

    def ci(lam, phi):
        return np.sin(2 * np.pi * np.deg2rad(phi) * 8 / 167.0)

    return model, initial_state(model, u=ui, v=vi, c=ci)


def phase16_grids(card, bmodel, n_steps=10):
    """The grid options at 1/4 degree: the numpy, native and "auto" builds (host
    seconds, largest difference per array, "auto" through the native kernels); the
    jet on the equatorially refined grid through the kernels, its extended grid
    carrying the law."""
    import numpy as np
    import torch

    from orthogonalsphericalshellgrids_tpu_torch import TripolarGrid, kernels
    from orthogonalsphericalshellgrids_tpu_torch.grids import native
    from orthogonalsphericalshellgrids_tpu_torch.grids import tripolar as tri
    from orthogonalsphericalshellgrids_tpu_torch.models import multi_step

    kw = dict(halo=(5, 5, 5), first_pole_longitude=45.0, north_poles_latitude=25.0)
    size = (1440, 680, 1)
    secs = {}
    raw = {}
    for backend in ("numpy", "native", "auto"):
        calls = dict(native.CALLS)
        t0 = time.perf_counter()
        raw[backend] = tri.build_tripolar_arrays(size, backend=backend, **kw)
        secs[backend] = time.perf_counter() - t0
        took = {k: native.CALLS[k] - calls[k] for k in calls}
        if backend == "numpy":
            check(took == {"murray_coords": 0, "metric_arcs": 0}, f"numpy build: {took}")
        else:
            check(took == {"murray_coords": 4, "metric_arcs": 1},
                  f"{backend} build took the native kernels: {took}")
    # the coordinates within tests/test_native.py's bands (absolute, degrees); the
    # metrics relative to the array's largest value: the spherical areas of 1/4-degree
    # cells lose digits to cancellation in both builds (the 48 x 24 band of
    # tests/test_native.py, 1e-12, is held on the CPU)
    worst = {}
    for name in tri.ARRAY_FIELDS:
        a, b = raw["numpy"][name], raw["native"][name]
        check(np.array_equal(raw["auto"][name], b), f"auto build {name} is the native one")
        d = float(np.abs(a - b).max())
        coord = name.startswith(("lam", "phi"))
        worst[name] = d if coord else d / float(np.abs(a).max())
        tol = 1e-9 if name.startswith("lam") else 1e-11 if name.startswith("phi") else 1e-10
        check(worst[name] <= tol, f"native {name} within {tol:.1e} of numpy: "
              f"{worst[name]:.3e}")
    del raw
    log(f"phase 16a: the 1440 x 680 grid on the host: numpy {secs['numpy']:.3f} s, native "
        f"{secs['native']:.3f} s, auto {secs['auto']:.3f} s (native kernels, bitwise the "
        f"native build); largest |numpy - native| per array (coordinates in degrees, "
        f"metrics relative to the array's largest value): "
        + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()) + f" [{card}]")

    t0 = time.perf_counter()
    rows = tri.newton_phi_nodes(-80.0, 680, equatorial_law)
    newton_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    model, state = bickley_on(TripolarGrid.make(size, dtype=torch.float32, device="cuda",
                                                phi_spacing=equatorial_law, **kw))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    g, ge = model.grid, model.grid_ext
    check(g.phi_spacing is equatorial_law and ge.phi_spacing is equatorial_law,
          "the grids carry the law")
    check(torch.equal(ge.interior(ge.phi_cc), g.interior(g.phi_cc)),
          "the extended grid's rows are the refined grid's")
    check(not torch.equal(g.interior(g.phi_cc), bmodel.grid.interior(bmodel.grid.phi_cc)),
          "the refined rows are not the uniform rows")
    d = np.diff(rows)
    ratio = float(d[np.abs(rows[:-1]).argmin()] / d[-1])
    check(abs(ratio - 0.5) < 0.01, f"equatorial spacing half the polar: {ratio}")
    kernels.reset_launch_counts()
    state = multi_step(model, state, 60.0, n_steps)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    check(all(counts[k] >= n_steps for k in BICKLEY), f"refined jet launches {counts}")
    check(all(bool(torch.isfinite(getattr(state, n)).all())
              for n in ("u", "v", "c", "eta", "U", "V")), "refined jet finite")
    log(f"phase 16b: the 1440 x 680 jet on the equatorially refined grid (rows by the "
        f"Newton solve, {newton_s:.3f} s alone; equatorial spacing {ratio:.4f} of the "
        f"polar; model built in {build_s:.1f} s), {n_steps} steps through the kernels: "
        f"finite, max|u| {float(state.u.abs().max()):.4f}; launches "
        f"{ {k: v for k, v in counts.items() if v} }; the extended grid carries the law "
        f"[{card}]")


def scaled_layered(state, s):
    """A layered ``state`` with every field times ``s`` (t and iteration kept)."""
    import dataclasses

    from orthogonalsphericalshellgrids_tpu_torch.models import LayeredState

    return LayeredState(**{f.name: getattr(state, f.name) * s
                           if f.name not in ("t", "iteration") else getattr(state, f.name)
                           for f in dataclasses.fields(LayeredState)})


def phase17a_layered_members(card, ceil, B=4):
    """The four member launches of a layered ensemble at the gyre's shapes (B members
    of (10, 690, 1450), T and S, the linear EOS, the closure planes): the vertical
    kernel (nu_v, kappa_v), the corrector (T and S, per-member weights, each member's
    crop of the widened U_a, V_a), the momentum kernel over B Nz layers with period
    Nz (closure pack, dG, the closing mask) and the layered tracer kernel over the
    members (kappa_h, dGc as a view of a larger stack). Each within the band of its
    plain version at float32 and float64 and each member bitwise its one-member
    launch; timed at float32 with the host ahead beside B one-member launches and the
    plain version, with the data-sheet and measured byte bounds (``ceil``: phase 9's
    stream and WENO-5 rates) and the WENO bound. Returns the kernel-table rows."""
    import numpy as np
    import torch

    from orthogonalsphericalshellgrids_tpu_torch import kernels
    from orthogonalsphericalshellgrids_tpu_torch.kernels import (corrector, momentum,
                                                                 tracer_adv, vertical)

    Yb, Xb = FILL_SHAPES["base"]
    Ye, Xe = FILL_SHAPES["ext"]
    nz = 10
    eos = (9.80665, 1.67e-4, 7.8e-4, 0.0, 35.0)
    rows = {}
    for name in ("float32", "float64"):
        dt = getattr(torch, name)
        rng = np.random.default_rng(1717)

        def rnd(shape, scale=1.0, lo=None):
            a = rng.random(shape) + lo if lo is not None else scale * rng.standard_normal(shape)
            return torch.as_tensor(a, dtype=dt, device="cuda")

        n_wet = torch.as_tensor(np.minimum(rng.integers(0, nz + 3, (Yb, Xb)), nz),
                                dtype=torch.int32, device="cuda")
        mc, mu, mv = (m.contiguous() for m in vertical.wet_pack(n_wet, nz, 3, dt).reshape(
            nz, 3, Yb, Xb).transpose(0, 1))
        u, v = rnd((B, nz, Yb, Xb)) * mu, rnd((B, nz, Yb, Xb)) * mv
        c = rnd((B, 2 * nz, Yb, Xb))
        c[:, :nz] += 10.0
        c[:, nz:] = 35.0 + 0.1 * c[:, nz:]
        dzs = [10.0 * 1.7 ** k for k in range(nz)]
        item = u.element_size()
        cases = {}
        # the vertical kernel in the gyre's mode
        vkw = dict(mode="linear_eos", eos=eos, it_T=0, it_S=1, viscous=True, diffusive=True)
        g5 = rnd((5, Yb, Xb), lo=0.5)
        coef = torch.as_tensor(vertical.coefficients(
            dzs, [0.5 * (dzs[k] + dzs[k + 1]) for k in range(nz - 1)], 1e-3, 1e-5),
            dtype=dt, device="cuda")
        s_pack = vertical.wet_pack(n_wet, nz, 3, dt)
        cases["vertical_members"] = dict(
            run=lambda: vertical.vertical(u, v, c, None, n_wet, g5, coef, **vkw),
            one=lambda m: vertical.vertical(u[m], v[m], c[m], None, n_wet, g5, coef, **vkw),
            plain=lambda: vertical.vertical_plain(u, v, c, None, s_pack, g5, coef, **vkw),
            I=(slice(1, -1), slice(1, -1)), weno=0,
            bytes=nbytes(u, v, c, n_wet, g5, coef) + nbytes(u, v, c),
            flops=FLOPS["vertical"] * (u.numel() + c.numel()))
        # the corrector: T and S, each member's weights (member 0 at its first step)
        # and crop of the widened U_a, V_a
        stacks = [rnd((B, nz, Yb, Xb)) for _ in range(6)]
        tracers = [rnd((B, 2 * nz, Yb, Xb)) for _ in range(3)]
        dz3 = torch.as_tensor(dzs, dtype=dt, device="cuda").view(-1, 1, 1)
        ext = rnd((2, B, Ye, Xe))
        dy, dx = (Ye - Yb) // 2, (Xe - Xb) // 2
        w1 = torch.tensor([1.0] + [1.6] * (B - 1), dtype=dt, device="cuda")
        w2 = torch.tensor([0.0] + [0.6] * (B - 1), dtype=dt, device="cuda")
        step_dt = torch.tensor(40.0, dtype=dt, device="cuda")
        shared = (dz3 * mu, dz3 * mv, mc, rnd((Yb, Xb), lo=0.0), rnd((Yb, Xb), lo=0.0))
        crops = (ext[0, :, dy:dy + Yb, dx:dx + Xb], ext[1, :, dy:dy + Yb, dx:dx + Xb])
        cases["corrector_members"] = dict(
            run=lambda: corrector.corrector(*stacks, *tracers, *shared, *crops, w1, w2,
                                            step_dt),
            one=lambda m: corrector.corrector(*(a[m] for a in stacks + tracers), *shared,
                                              crops[0][m], crops[1][m], w1[m], w2[m],
                                              step_dt),
            plain=lambda: corrector.corrector_plain(*stacks, *tracers, *shared, *crops, w1,
                                                    w2, step_dt),
            I=(slice(None), slice(None)), weno=0,
            bytes=nbytes(*stacks, *tracers, *shared, w1, w2, step_dt)
            + 2 * B * Yb * Xb * item + nbytes(u, v, c),
            flops=FLOPS["corrector"] * (2 * u.numel() + c.numel()))
        # momentum over B Nz layers, period Nz: the closure pack, dG, the closing mask
        ul, vl = u.reshape(B * nz, Yb, Xb), v.reshape(B * nz, Yb, Xb)
        st = rnd((8, Yb, Xb), lo=1.0)
        st[3] = 0.1 * rnd((Yb, Xb))
        lay = rnd((nz, 8, Yb, Xb), lo=0.5)
        lay[:, 6:] *= 0.1
        lay = lay.reshape(8 * nz, Yb, Xb)
        mkw = dict(has_mask=False, lay=lay, has_lap=True, has_drag=True,
                   acc=(rnd((B * nz, Yb, Xb), 0.5), rnd((B * nz, Yb, Xb), 0.5)),
                   mask_out=(mu, mv))

        def mom_one(m):
            layers = slice(m * nz, (m + 1) * nz)
            return momentum.momentum(ul[layers], vl[layers], st, **dict(
                mkw, acc=tuple(a[layers] for a in mkw["acc"])))

        cases["momentum_members"] = dict(
            run=lambda: momentum.momentum(ul, vl, st, period=nz, **mkw),
            one=mom_one,
            plain=lambda: momentum.momentum_plain(ul, vl, st, period=nz, **mkw),
            I=(slice(momentum.REACH, -momentum.REACH),) * 2, weno=2 * ul.numel(),
            bytes=nbytes(ul, vl, st, lay, *mkw["acc"], *mkw["mask_out"]) + 2 * nbytes(ul),
            flops=FLOPS["momentum_closures"] * ul.numel())
        # the layered tracer kernel over the members: T and S with kappa_h, dGc a view
        # of a stack that holds two more planes a member (as a b block would)
        pack = (mu[:, None] * rnd((nz, 4, Yb, Xb), lo=0.5)).reshape(4 * nz, Yb, Xb)
        g2 = rnd((2, Yb, Xb), lo=0.5)
        dz = torch.as_tensor(dzs, dtype=dt, device="cuda")
        acc = rnd((B, 2 * nz + 2, Yb, Xb), 0.5)[:, :2 * nz]
        cases["tracer_adv_layered_members"] = dict(
            run=lambda: tracer_adv.tracer_adv(c, u, v, pack, g2, dz, acc=acc),
            one=lambda m: tracer_adv.tracer_adv(c[m], u[m], v[m], pack, g2, dz, acc=acc[m]),
            plain=lambda: tracer_adv.tracer_adv_plain(c, u, v, pack, g2, dz, acc=acc),
            I=(slice(tracer_adv.REACH, -tracer_adv.REACH),) * 2, weno=2 * c.numel(),
            bytes=nbytes(c, u, v, pack, g2, dz) + c.numel() * item + nbytes(c),
            flops=FLOPS["tracer_adv_kappa"] * c.numel())

        def outputs(r):
            return [a for a in (r if isinstance(r, tuple) else (r,)) if a is not None]

        for kname, case in cases.items():
            kernels.reset_launch_counts()
            got = outputs(case["run"]())
            counts = {k: n for k, n in kernels.launch_counts().items() if n}
            check(counts == {kname: 1}, f"phase 17a: {kname} one launch: {counts}")
            want = outputs(case["plain"]())
            errs = [rel_err(g, w, case["I"]) for g, w in zip(got, want)]
            ea, er = max(e[0] for e in errs), max(e[1] for e in errs)
            check(er <= BANDS[name] and all(bool(torch.isfinite(g).all()) for g in got),
                  f"phase 17a: {kname} {name}: rel err {er:.3e}, finite")
            del want
            for m in range(B):
                part = slice(m * nz, (m + 1) * nz) if kname == "momentum_members" else m
                for g, o in zip(got, outputs(case["one"](m))):
                    check(torch.equal(g[part], o), f"phase 17a: {kname} {name}: member "
                          f"{m} bitwise its one-member launch")
            msg = (f"phase 17a: {kname} over B = {B} members of (10, {Yb}, {Xb}), {name}: "
                   f"max abs err {ea:.3e}, max rel err {er:.3e} (band {BANDS[name]:g}), "
                   f"finite, each member bitwise its one-member launch")
            if name == "float32":
                t_k = time_ms(case["run"], n=10, ahead=True)
                t_1 = time_ms(lambda: [case["one"](m) for m in range(B)], n=10, ahead=True)
                t_p = time_ms(case["plain"], n=2, reps=3, warm=1)
                b_ = bound(case["bytes"], case["flops"])
                t_meas = case["bytes"] / (ceil["stream_gbps"] * 1e9) * 1e3
                msg += (f"; host ahead {t_k:.4f} ms, {B} one-member launches {t_1:.4f} ms, "
                        f"plain {t_p:.4f} ms; data-sheet bound {b_[0]:.4f} ms by {b_[1]} "
                        f"({b_[2]} bytes), measured byte bound {t_meas:.4f} ms "
                        f"({ceil['stream_gbps']:.1f} GB/s)")
                if case["weno"]:
                    msg += (f", WENO bound {case['weno'] / ceil['weno_recon_per_s'] * 1e3:.4f}"
                            f" ms ({ceil['weno_recon_per_s'] / 1e9:.1f} G/s)")
                rows[kname] = (ea, t_k, t_p, b_, None)
            log(msg + f" [{card}]")
            del got
        del cases, stacks, tracers, u, v, c, ul, vl, mkw, acc
        torch.cuda.empty_cache()
    return rows


def phase17b_layered_ensemble(card, model, state0, gyre_ms, n_steps=10, warm=3, dt=40.0):
    """Phase 7's gyre as 4 members (the base state times 0.5, 0.75, 1.0, 1.25), 10
    steps after 3 warm-up through ensemble_multi_step: one serial layered step's
    launches a step, each through its member launch; every member bitwise its serial
    run in every field; ms/step as run and with the host ahead, device busy and idle
    share, beside the serial step. Returns the launch counts and ms/step."""
    import dataclasses

    import torch

    from orthogonalsphericalshellgrids_tpu_torch import kernels
    from orthogonalsphericalshellgrids_tpu_torch.models import (LayeredState, ensemble,
                                                                layered_multi_step,
                                                                layered_step)

    B = len(ENSEMBLE_SCALES)
    serial0 = [scaled_layered(state0, s) for s in ENSEMBLE_SCALES]
    batch = ensemble.ensemble_multi_step(model, ensemble.stack_members(serial0), dt, warm)
    kernels.reset_launch_counts()
    layered_step(model, state0, dt)
    serial_counts = kernels.launch_counts()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    batch = ensemble.ensemble_multi_step(model, batch, dt, n_steps)
    end.record()
    end.synchronize()
    counts = kernels.launch_counts()
    ms = start.elapsed_time(end) / n_steps
    expected = {k: 0 for k in counts}
    expected.update({k: n_steps for k in LAYERED_ENSEMBLE}, halo_fill=2 * n_steps)
    check(counts == expected, f"phase 17b: launch counts {counts} != {expected}")
    check(sum(counts.values()) == n_steps * sum(serial_counts.values()),
          f"phase 17b: a step launches as often as a serial step {serial_counts}")
    for i, s0 in enumerate(serial0):
        want = layered_multi_step(model, s0, dt, warm + n_steps)
        got = ensemble.member(batch, i)
        for f in dataclasses.fields(LayeredState):
            check(torch.equal(getattr(got, f.name), getattr(want, f.name)),
                  f"phase 17b: member {i} {f.name} bitwise its serial run")
        del want
    check(all(bool(torch.isfinite(getattr(batch, n)).all()) for n in ("u", "v", "c", "eta")),
          "phase 17b: finite")
    ms_ahead = time_ms(lambda: ensemble.ensemble_step(model, batch, dt), n=5, ahead=True)
    serial_ahead = time_ms(lambda: layered_step(model, state0, dt), n=10, ahead=True)
    serial_ms = time_ms(lambda: layered_step(model, state0, dt), n=10)
    _, ops, busy, idle = device_busy(lambda s: ensemble.ensemble_step(model, s, dt), batch, 5)
    _, s_ops, s_busy, s_idle = device_busy(lambda s: layered_step(model, s, dt), state0, 5)
    log(f"phase 17b: the 1440 x 680 x 10 gyre as an ensemble of {B} members (scales "
        f"{ENSEMBLE_SCALES}), {n_steps} steps after {warm} warm-up at dt = {dt:g} s: "
        f"{ms:.4f} ms/step as run, {ms_ahead:.4f} with the host ahead; device busy "
        f"{busy:.4f} ms a step in {ops:.0f} device operations, idle share {idle:.3f}; the "
        f"serial step in this phase {serial_ms:.4f} as run, {serial_ahead:.4f} host ahead, "
        f"busy {s_busy:.4f} ms in {s_ops:.0f} operations, idle {s_idle:.3f}; phase 7 "
        f"{gyre_ms:.4f} ms/step, {B} x that {B * gyre_ms:.4f}; launches "
        f"{ {k: v for k, v in counts.items() if v} }; every member bitwise its serial run "
        f"in every field [{card}]")
    return counts, ms


def phase17c_front_oracle_member(card):
    """The f64 front oracle through member 0 of a 2-member ensemble: member 0 the
    oracle's initial state, member 1 that state times 0.9 and one step ahead; 15
    ensemble steps through the member launches, member 0 within phase 6's
    tolerances."""
    import numpy as np
    import torch

    from examples.baroclinic_front_torch import build, kinetic_energy
    from orthogonalsphericalshellgrids_tpu_torch import kernels
    from orthogonalsphericalshellgrids_tpu_torch.models import ensemble, layered_step

    with np.load(os.path.join(ROOT, "tests", "data", "front_oracle_120x60x4.npz")) as d:
        nx, ny, nz, dt, _, _ = d["meta"]
        ref = {k: d[k] for k in ("u.015", "v.015", "b.015")}
        ke_ref = d["ke"][:15]
    model, s = build(int(nx), int(ny), int(nz), dtype=torch.float64, device="cuda")
    batch = ensemble.stack_members([s, layered_step(model, scaled_layered(s, 0.9),
                                                    float(dt))])
    kernels.reset_launch_counts()
    ke = []
    for _ in range(15):
        batch = ensemble.ensemble_step(model, batch, float(dt))
        ke.append(kinetic_energy(model, ensemble.member(batch, 0)))
    counts = kernels.launch_counts()
    check(all(counts[k] == 15 for k in ("vertical_members", "momentum_members",
                                         "corrector_members", "barotropic")) and
          counts["tracer_adv_layered_members"] == 30,
          f"phase 17c: the member launches ran: {counts}")
    m0 = ensemble.member(batch, 0)
    check(int(m0.iteration) == 15 and int(batch.iteration[1]) == 16, "phase 17c: iterations")
    I3 = (slice(None),) + model.grid.interior2d
    worst = []
    for name in ("u", "v", "b"):
        a = getattr(m0, name).cpu().numpy()[I3]
        r = ref[f"{name}.015"]
        diff = float(np.abs(a - r).max())
        worst.append(f"{name} {diff:.3e}")
        check(np.allclose(a, r, rtol=1e-9, atol=1e-14), f"phase 17c: front oracle {name}: "
              f"max diff {diff}")
    rel = float(np.max(np.abs(np.asarray(ke) / ke_ref - 1.0)))
    worst.append(f"ke rel {rel:.3e}")
    check(np.allclose(ke, ke_ref, rtol=1e-10, atol=0), f"phase 17c: front oracle ke: rel {rel}")
    log(f"phase 17c: 120 x 60 x 4 float64 front oracle through member 0 of a 2-member "
        f"ensemble (member 1 the state x 0.9, one step ahead), 15 steps through the member "
        f"launches: max |diff| {', '.join(worst)} (rtol 1e-9, atol 1e-14; ke rtol 1e-10) "
        f"[{card}]")



# --------------------------------------------------------------------------------------
# Phase 18: ensembles of sharded runs
# --------------------------------------------------------------------------------------

def sharded(model, state, mesh_kind, layered, overlap=None):
    """(step function, the ranks' states, gather) of ``state`` (one state or an
    ensemble's batch) on ``mesh_kind`` ranks through LocalExchange: a number of
    y-shards or an (n_x, n_y) mesh of blocks (gather fold)."""
    from orthogonalsphericalshellgrids_tpu_torch import parallel as P

    if isinstance(mesh_kind, int):
        mesh, extra, arg = P.make_mesh(mesh_kind), (), mesh_kind
        distribute, step_fn, gather = (
            (P.distribute_layered, P.sharded_layered_step_fn, P.gather_layered_state)
            if layered else (P.distribute, P.sharded_step_fn, P.gather_state))
    else:
        mesh = P.make_mesh2d(*mesh_kind)
        extra, arg = (model.grid.Nx,), mesh
        distribute, step_fn, gather = (
            (P.distribute_layered2d, P.sharded_layered_step_fn2d, P.gather_layered_state2d)
            if layered else (P.distribute2d, P.sharded_step_fn2d, P.gather_state2d))
    dm, ds = distribute(model, state, mesh)
    fn = step_fn(mesh, dm, *extra, overlap=overlap)
    return fn, ds, lambda s: gather(s, model, arg)


def members_equal(model, got, want, what, names):
    """Each member of the gathered batch ``got`` bitwise the serial ensemble's
    ``want`` on the interiors of ``names`` (the gathered halos are 0), and in t and
    iteration."""
    import torch

    for name in names:
        grid = model.grid_ext if name in ("eta", "U", "V") else model.grid
        check(torch.equal(grid.interior(getattr(got, name)),
                          grid.interior(getattr(want, name))),
              f"{what}: every member's {name} bitwise the serial ensemble's")
    check(torch.equal(got.t, want.t) and torch.equal(got.iteration, want.iteration),
          f"{what}: t and iteration")


def rank_launches(kind, layered, n_steps, split=True):
    """The launches of one rank of a sharded ensemble in ``n_steps`` steps: a y-shard
    (``kind`` 1) or a block of a 2-D mesh (2), the split's tendency kernels on the
    bulk and on two strips a direction, the member launches in place of the
    one-member ones."""
    tend = SPLIT_LAYERED_ENSEMBLE if layered else SPLIT_ENSEMBLE
    once = ("barotropic", "corrector_members") if layered else ("barotropic",)
    passes = 1 + 2 * kind if split else 1
    want = {k: n_steps * passes for k in tend}
    want.update({k: n_steps for k in once}, halo_restore=n_steps)
    if kind == 1:
        want.update(halo_pack=2 * n_steps, halo_fill_shard=2 * n_steps,
                    halo_wrap=n_steps if split else 0)
    else:
        want.update(halo_pack_block=4 * n_steps, halo_fill_block=4 * n_steps)
    return {k: n for k, n in want.items() if n}


def member_cases(rnd, dt, B, Yb, Xb, nz, bulk):
    """The member launches of the sharded ensembles on a (Yb, Xb) plane of a rank or
    of a split's strip, B members: the jet's (``tracer_adv_members``; ``momentum``
    over the B members as layers, period 1, the masked pack) and the gyre's
    (``vertical_members``, ``momentum_members`` over B·Nz layers with period Nz,
    ``tracer_adv_layered_members`` with dGc a view) at phase 17a's operands, and on a
    rank's plane (``bulk``) the corrector over the members. Each case: the member
    launch, member m's one-member launch and the slice of the outputs it gives, the
    plain version, the valid cells, WENO reconstructions, bytes and operations."""
    import numpy as np
    import torch

    from orthogonalsphericalshellgrids_tpu_torch.kernels import (corrector, momentum,
                                                                 tracer_adv, vertical)

    dev = "cuda"
    eos = (9.80665, 1.67e-4, 7.8e-4, 0.0, 35.0)
    R_adv = (slice(tracer_adv.REACH, Yb - tracer_adv.REACH),
             slice(tracer_adv.REACH, Xb - tracer_adv.REACH))
    R_mom = (slice(momentum.REACH, Yb - momentum.REACH),
             slice(momentum.REACH, Xb - momentum.REACH))
    cases = {}
    # the jet: B members of one tracer, the 5-plane pack; momentum masked, period 1
    uj, vj, cj = rnd((B, Yb, Xb)), rnd((B, Yb, Xb)), rnd((B, Yb, Xb))
    cj[1:, : Yb // 3] = 0.0  # exact zeros, as on land
    pack5 = rnd((5, Yb, Xb), lo=1.0)
    st10 = rnd((10, Yb, Xb), lo=1.0)
    st10[3] = 0.1 * rnd((Yb, Xb))
    st10[8:] = (st10[8:] > 1.15).to(dt)
    cases["tracer_adv_members"] = dict(
        run=lambda: tracer_adv.tracer_adv(cj, uj, vj, pack5),
        one=lambda m: tracer_adv.tracer_adv(cj[m], uj[m], vj[m], pack5), part=lambda m: m,
        plain=lambda: tracer_adv.tracer_adv_plain(cj, uj, vj, pack5), I=R_adv,
        weno=2 * cj.numel(), bytes=nbytes(cj, uj, vj, pack5, cj),
        flops=FLOPS["tracer_adv_members"] * cj.numel())
    cases["momentum"] = dict(
        run=lambda: momentum.momentum(uj, vj, st10, period=1),
        one=lambda m: momentum.momentum(uj[m], vj[m], st10), part=lambda m: m,
        plain=lambda: momentum.momentum_plain(uj, vj, st10, period=1), I=R_mom,
        weno=2 * uj.numel(), bytes=nbytes(uj, vj, st10) + 2 * nbytes(uj),
        flops=FLOPS["momentum"] * uj.numel())
    # the gyre: B members of (nz, Yb, Xb), T and S, the linear EOS, the closure planes
    n_wet = torch.as_tensor(np.minimum(np.random.default_rng(Yb * Xb).integers(
        0, nz + 3, (Yb, Xb)), nz), dtype=torch.int32, device=dev)
    mc, mu, mv = (m.contiguous() for m in vertical.wet_pack(n_wet, nz, 3, dt).reshape(
        nz, 3, Yb, Xb).transpose(0, 1))
    u, v = rnd((B, nz, Yb, Xb)) * mu, rnd((B, nz, Yb, Xb)) * mv
    c = rnd((B, 2 * nz, Yb, Xb))
    c[:, :nz] += 10.0
    c[:, nz:] = 35.0 + 0.1 * c[:, nz:]
    dzs = [10.0 * 1.7 ** k for k in range(nz)]
    item = u.element_size()
    vkw = dict(mode="linear_eos", eos=eos, it_T=0, it_S=1, viscous=True, diffusive=True)
    g5 = rnd((5, Yb, Xb), lo=0.5)
    coef = torch.as_tensor(vertical.coefficients(
        dzs, [0.5 * (dzs[k] + dzs[k + 1]) for k in range(nz - 1)], 1e-3, 1e-5),
        dtype=dt, device=dev)
    s_pack = vertical.wet_pack(n_wet, nz, 3, dt)
    cases["vertical_members"] = dict(
        run=lambda: vertical.vertical(u, v, c, None, n_wet, g5, coef, **vkw),
        one=lambda m: vertical.vertical(u[m], v[m], c[m], None, n_wet, g5, coef, **vkw),
        part=lambda m: m,
        plain=lambda: vertical.vertical_plain(u, v, c, None, s_pack, g5, coef, **vkw),
        I=(slice(1, Yb - 1), slice(1, Xb - 1)), weno=0,
        bytes=nbytes(u, v, c, n_wet, g5, coef) + nbytes(u, v, c),
        flops=FLOPS["vertical"] * (u.numel() + c.numel()))
    ul, vl = u.reshape(B * nz, Yb, Xb), v.reshape(B * nz, Yb, Xb)
    st8 = rnd((8, Yb, Xb), lo=1.0)
    st8[3] = 0.1 * rnd((Yb, Xb))
    lay = rnd((nz, 8, Yb, Xb), lo=0.5)
    lay[:, 6:] *= 0.1
    lay = lay.reshape(8 * nz, Yb, Xb)
    mkw = dict(has_mask=False, lay=lay, has_lap=True, has_drag=True,
               acc=(rnd((B * nz, Yb, Xb), 0.5), rnd((B * nz, Yb, Xb), 0.5)),
               mask_out=(mu, mv))

    def mom_one(m):
        layers = slice(m * nz, (m + 1) * nz)
        return momentum.momentum(ul[layers], vl[layers], st8, **dict(
            mkw, acc=tuple(a[layers] for a in mkw["acc"])))

    cases["momentum_members"] = dict(
        run=lambda: momentum.momentum(ul, vl, st8, period=nz, **mkw), one=mom_one,
        part=lambda m: slice(m * nz, (m + 1) * nz),
        plain=lambda: momentum.momentum_plain(ul, vl, st8, period=nz, **mkw), I=R_mom,
        weno=2 * ul.numel(),
        bytes=nbytes(ul, vl, st8, lay, *mkw["acc"], *mkw["mask_out"]) + 2 * nbytes(ul),
        flops=FLOPS["momentum_members"] * ul.numel())
    pack = (mu[:, None] * rnd((nz, 4, Yb, Xb), lo=0.5)).reshape(4 * nz, Yb, Xb)
    g2 = rnd((2, Yb, Xb), lo=0.5)
    dz = torch.as_tensor(dzs, dtype=dt, device=dev)
    acc = rnd((B, 2 * nz + 2, Yb, Xb), 0.5)[:, :2 * nz]
    cases["tracer_adv_layered_members"] = dict(
        run=lambda: tracer_adv.tracer_adv(c, u, v, pack, g2, dz, acc=acc),
        one=lambda m: tracer_adv.tracer_adv(c[m], u[m], v[m], pack, g2, dz, acc=acc[m]),
        part=lambda m: m,
        plain=lambda: tracer_adv.tracer_adv_plain(c, u, v, pack, g2, dz, acc=acc),
        I=R_adv, weno=2 * c.numel(),
        bytes=nbytes(c, u, v, pack, g2, dz) + c.numel() * item + nbytes(c),
        flops=FLOPS["tracer_adv_layered_members"] * c.numel())
    if bulk:
        # the corrector: each member's weights (member 0 at its first step) and its
        # crop of the rank's widened U_a, V_a (halo 22)
        stacks = [rnd((B, nz, Yb, Xb)) for _ in range(6)]
        tracers = [rnd((B, 2 * nz, Yb, Xb)) for _ in range(3)]
        dz3 = dz.view(-1, 1, 1)
        dy = dx = 22 - 5
        ext = rnd((2, B, Yb + 2 * dy, Xb + 2 * dx))
        w1 = torch.tensor([1.0] + [1.6] * (B - 1), dtype=dt, device=dev)
        w2 = torch.tensor([0.0] + [0.6] * (B - 1), dtype=dt, device=dev)
        step_dt = torch.tensor(40.0, dtype=dt, device=dev)
        shared = (dz3 * mu, dz3 * mv, mc, rnd((Yb, Xb), lo=0.0), rnd((Yb, Xb), lo=0.0))
        crops = (ext[0, :, dy:dy + Yb, dx:dx + Xb], ext[1, :, dy:dy + Yb, dx:dx + Xb])
        cases["corrector_members"] = dict(
            run=lambda: corrector.corrector(*stacks, *tracers, *shared, *crops, w1, w2,
                                            step_dt),
            one=lambda m: corrector.corrector(*(a[m] for a in stacks + tracers), *shared,
                                              crops[0][m], crops[1][m], w1[m], w2[m],
                                              step_dt),
            part=lambda m: m,
            plain=lambda: corrector.corrector_plain(*stacks, *tracers, *shared, *crops, w1,
                                                    w2, step_dt),
            I=(slice(None), slice(None)), weno=0,
            bytes=nbytes(*stacks, *tracers, *shared, w1, w2, step_dt)
            + 2 * B * Yb * Xb * item + nbytes(u, v, c),
            flops=FLOPS["corrector"] * (2 * u.numel() + c.numel()))
    return cases


def baro_member_case(rnd, dt, B, Ye, Xe, Nx):
    """The barotropic kernel's member axis on a rank's extended (Ye, Xe) plane (halo
    22, 21 SM05 weights, the wrap off as the sharded steps run it), as a case of
    ``member_cases``."""
    import torch

    from orthogonalsphericalshellgrids_tpu_torch.kernels import barotropic
    from orthogonalsphericalshellgrids_tpu_torch.models.split_explicit import (
        averaging_weights)

    static = rnd((9, Ye, Xe), lo=0.5)
    static[7:] = (static[7:] > 0.6).to(dt)
    dyn = [rnd((B, Ye, Xe), 0.01) for _ in range(3)] + [rnd((B, Ye, Xe), 1e-3)
                                                        for _ in range(2)]
    tail = (torch.tensor(0.01, dtype=dt, device="cuda"),
            torch.as_tensor(averaging_weights(30)[1], dtype=dt, device="cuda"))
    n_sub = tail[1].numel()
    return dict(
        run=lambda: barotropic.barotropic_substeps(static, *dyn, *tail, Nx, 22, False),
        one=lambda m: barotropic.barotropic_substeps(static, *(d[m] for d in dyn), *tail,
                                                     Nx, 22, False),
        part=lambda m: m,
        plain=lambda: barotropic.barotropic_substeps_plain(static, *dyn, *tail, Nx, 22,
                                                           False),
        I=(slice(22, Ye - 22), slice(22, Xe - 22)), weno=0,
        bytes=nbytes(static, *dyn) + 3 * nbytes(dyn[0]),
        flops=FLOPS["barotropic"] * n_sub * dyn[0].numel(), pts=n_sub * dyn[0].numel())


def phase18a_sharded_members(card, ceil, B=4):
    """The member launches of phase 18's sharded ensembles at a rank's and a strip's
    shapes (``SHARD_PLANES``, ``SHARD_EXT``), B members: within the bands of their
    plain versions at float32 and float64, each member bitwise its one-member launch
    at the same shape; timed at float32 with the host ahead beside B one-member
    launches and the plain version, with the data-sheet bound, the byte bound at
    phase 9's measured stream rate and the WENO-5 (or substep) bound."""
    import numpy as np
    import torch

    from orthogonalsphericalshellgrids_tpu_torch import kernels

    nz = 10

    def outputs(r):
        return [a for a in (r if isinstance(r, tuple) else (r,)) if a is not None]

    def hold(kname, case, where, shape, name):
        kernels.reset_launch_counts()
        got = outputs(case["run"]())
        counts = {k: n for k, n in kernels.launch_counts().items() if n}
        check(counts == {kname: 1}, f"phase 18a: {kname} on {where} one launch: {counts}")
        want = outputs(case["plain"]())
        errs = [rel_err(g, w, case["I"]) for g, w in zip(got, want)]
        ea, er = max(e[0] for e in errs), max(e[1] for e in errs)
        check(er <= BANDS[name] and all(bool(torch.isfinite(g).all()) for g in got),
              f"phase 18a: {kname} on {where} {name}: rel err {er:.3e}, finite")
        del want
        for m in range(B):
            for g, o in zip(got, outputs(case["one"](m))):
                check(torch.equal(g[case["part"](m)], o), f"phase 18a: {kname} on "
                      f"{where} {name}: member {m} bitwise its one-member launch")
        msg = (f"phase 18a: {kname} over B = {B} members on the {where} {shape}, {name}: "
               f"max abs err {ea:.3e}, max rel err {er:.3e} (band {BANDS[name]:g}), "
               f"finite, each member bitwise its one-member launch")
        if name == "float32":
            t_k = time_ms(case["run"], n=10, ahead=True)
            t_1 = time_ms(lambda: [case["one"](m) for m in range(B)], n=10, ahead=True)
            t_p = time_ms(case["plain"], n=2, reps=3, warm=1)
            b_ = bound(case["bytes"], case["flops"])
            t_meas = case["bytes"] / (ceil["stream_gbps"] * 1e9) * 1e3
            if "pts" in case:  # the substep ceiling: point-substeps
                t_w = case["pts"] / ceil["baro_pts_per_s"] * 1e3
                ceiling = f"substep bound {t_w:.4f} ms"
            else:
                t_w = case["weno"] / ceil["weno_recon_per_s"] * 1e3 if case["weno"] else None
                ceiling = "no WENO" if t_w is None else f"WENO bound {t_w:.4f} ms"
            msg += (f"; host ahead {t_k:.4f} ms, {B} one-member launches {t_1:.4f} ms, "
                    f"plain {t_p:.4f} ms; data-sheet bound {b_[0]:.4f} ms by {b_[1]} "
                    f"({b_[2]} bytes), measured byte bound {t_meas:.4f} ms "
                    f"({ceil['stream_gbps']:.1f} GB/s), {ceiling}")
        log(msg + f" [{card}]")
        del got

    for name in ("float32", "float64"):
        dt = getattr(torch, name)
        rng = np.random.default_rng(1818)

        def rnd(shape, scale=1.0, lo=None):
            a = rng.random(shape) + lo if lo is not None else scale * rng.standard_normal(shape)
            return torch.as_tensor(a, dtype=dt, device="cuda")

        for where, (Yb, Xb) in SHARD_PLANES.items():
            cases = member_cases(rnd, dt, B, Yb, Xb, nz, bulk="strip" not in where)
            for kname, case in cases.items():
                hold(kname, case, where, (Yb, Xb), name)
            del cases
        for where, (Ye, Xe, Nx) in SHARD_EXT.items():
            hold("barotropic", baro_member_case(rnd, dt, B, Ye, Xe, Nx), where, (Ye, Xe),
                 name)
        torch.cuda.empty_cache()


def phase18_sharded_ensembles(card, bickley, gyre, ref_ms, n_steps=20, warm=3):
    """(b) phase 3's jet as 4 members (phase 15b's scales) in 4 y-shards and (c) on 2
    x 2 blocks (gather) through LocalExchange, the split on, 20 steps at dt = 60 s
    after 3 warm-up: each member bitwise its run in the serial ensemble from the same
    state, each rank's launches those of phase 12b's shard or 13b's block with the
    member launches in place, no host synchronization; (d) phase 7's gyre as 4
    members, 3 steps at dt = 40 s after 3 warm-up in 4 y-shards and on 2 x 2 the
    same way, and unsplit on 4 y-shards, bitwise the split (a sharded batch's first
    steps run slower; phases 12c and 13d time 3 steps without warm-up); ms/step,
    device busy and idle share beside ``ref_ms`` (one member on the same ranks,
    phases 12b-c and 13b, 13d; the gyre's serial ensemble, phase 17b) and the
    serial ensemble step timed here; (e) a
    2-member jet ensemble through a 1-rank NCCL ProcessGroupExchange, bitwise the
    serial ensemble, no host synchronization. Returns the launch counts of the jet
    and of the gyre in 4 y-shards."""
    import tempfile

    import torch
    import torch.distributed as dist

    from orthogonalsphericalshellgrids_tpu_torch import kernels, parallel
    from orthogonalsphericalshellgrids_tpu_torch.models import ensemble, step

    B = len(ENSEMBLE_SCALES)
    names = ("u", "v", "c", "eta", "U", "V", "Gu", "Gv", "Gc")
    counts_of = {}
    for path, (model, state0), layered, dt, steps, pre, scale in (
            ("jet", bickley, False, 60.0, n_steps, warm, scaled_state),
            ("gyre", gyre, True, 40.0, 3, warm, scaled_layered)):
        batch0 = ensemble.stack_members([scale(state0, s) for s in ENSEMBLE_SCALES])
        want = ensemble.ensemble_multi_step(model, batch0, dt, pre + steps)
        ens_ms = time_ms(lambda: ensemble.ensemble_step(model, batch0, dt), n=5)
        split = None
        for mesh_kind, overlap in ((4, None), ((2, 2), None)) + (
                ((4, False),) if layered else ()):
            kind = 1 if isinstance(mesh_kind, int) else 2
            where = (f"{mesh_kind} y-shards" if kind == 1 else
                     f"{mesh_kind[0]} x {mesh_kind[1]} blocks")
            tag = "d" if layered else "b" if kind == 1 else "c"
            what = (f"phase 18{tag}: the {path} as {B} members on {where}"
                    f"{', unsplit' if overlap is False else ''}")
            fn, ds, gather = sharded(model, batch0, mesh_kind, layered, overlap)
            fn(ds, dt)  # loads the exchange's path; ds is left as it was
            for _ in range(pre):  # the first steps run slower
                ds = fn(ds, dt)
            torch.cuda.synchronize()
            fn.launches = [dict.fromkeys(kernels.LAUNCHES, 0) for _ in fn.launches]
            kernels.reset_launch_counts()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(steps):
                ds = fn(ds, dt)
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end) / steps
            counts = kernels.launch_counts()
            got = gather(ds)
            members_equal(model, got, want, what, names)
            if overlap is False:
                members_equal(model, got, split, f"{what} against the split", names)
            elif kind == 1:
                split = got
            expected = rank_launches(kind, layered, steps, split=overlap is not False)
            for i, own in enumerate(fn.launches):
                check({k: n for k, n in own.items() if n} == expected,
                      f"{what}: rank {i} launched {own}, expected {expected}")
            with host_syncs() as n_syncs:
                fn(ds, dt)
                syncs = n_syncs()
            check(syncs == 0, f"{what}: {syncs} host synchronizations")
            _, ops, busy, idle = device_busy(lambda x: fn(x, dt), ds, 5)
            fn.close()
            one_ms, one_phase = ref_ms[(path, kind)]
            ens_ref = ref_ms.get((path, "ensemble"))
            log(f"{what} through LocalExchange, {steps} steps at dt = {dt:g} s"
                f"{f' after {pre} warm-up' if pre else ''}: every member bitwise its run "
                f"in the serial ensemble from the same state (the interiors of "
                f"{', '.join(names)}; t, iteration)"
                f"{' and the split' if overlap is False else ''}; {ms:.4f} ms/step as run, "
                f"{B * 1e3 / ms:.1f} member-steps/s; one member on {where} {one_ms:.4f} "
                f"ms/step (phase {one_phase}), {1e3 / one_ms:.1f} member-steps/s; the "
                f"serial ensemble {ens_ms:.4f} ms/step in this phase"
                f"{f' (phase 17b {ens_ref:.4f})' if ens_ref else ''}; each rank launched "
                f"{expected} in {steps} steps; host synchronizations 0; profiler, 5 "
                f"steps: {ops:.0f} device ops, {busy:.4f} ms device busy a step, idle "
                f"share {idle:.3f}; launches {({k: n for k, n in counts.items() if n})} "
                f"[{card}]")
            if kind == 1 and overlap is None:
                counts_of[path] = counts
            del ds, got
        del batch0, want, split
        torch.cuda.empty_cache()

    # (e) one rank of an NCCL group stepping a 2-member jet ensemble: with one rank the
    # step takes the serial route (ops/spmd._serial), so no NCCL operation is made
    model, state0 = bickley
    pair = ensemble.stack_members([state0, step(model, scaled_state(state0, 0.5), 60.0)])
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", init_method="file://" + os.path.join(tmp, "store"),
                                rank=0, world_size=1)
        try:
            mesh = parallel.ProcessGroupExchange()
            dist_model, dist_state = parallel.distribute(model, pair, mesh)
            fn = parallel.sharded_step_fn(mesh, dist_model)
            s = fn(dist_state, 60.0)
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            with host_syncs() as n_syncs:
                for _ in range(3):
                    s = fn(s, 60.0)
                syncs = n_syncs()
            counts = kernels.launch_counts()
        finally:
            dist.destroy_process_group()
    want = ensemble.ensemble_multi_step(model, pair, 60.0, 4)
    check(all(torch.equal(getattr(s[0], name), getattr(want, name))
              for name in names + ("t", "iteration")),
          "phase 18e: 1-rank NCCL ensemble bitwise equal to the serial ensemble")
    check(syncs == 0, f"phase 18e: 1-rank NCCL ensemble: {syncs} host synchronizations")
    check(counts["halo_fill"] == 6 and counts["halo_restore"] == 3 and
          counts["tracer_adv_members"] == 3 and counts["barotropic"] == 3 and
          counts["halo_pack"] == 0, f"phase 18e: 1-rank NCCL ensemble launched {counts}")
    log(f"phase 18e: a 2-member jet ensemble (the base state and the state x 0.5 one step "
        f"ahead) through the sharded step of a 1-rank NCCL process group "
        f"(ProcessGroupExchange), 4 steps: with one rank the serial route, no NCCL "
        f"operation; bitwise equal to the serial ensemble with its launches (2 fills, 1 "
        f"restore, 1 tracer_adv_members a step, no pack), host synchronizations 0 "
        f"[{card}]")
    return counts_of["jet"], counts_of["gyre"]


def forcing_T(lam, phi, z, t, fields):
    """A forcing of T that reads the model time (phase 18f)."""
    import torch

    return 1e-7 * torch.sin(2e-4 * t) * torch.cos(torch.deg2rad(phi))


def phase18f_forcing_members(card, n_steps=3, n=2):
    """Phase 8's 48 x 32 x 3 float64 check gyre with a forcing of T that reads t, as 2
    members (the second the state x 0.9 one step ahead) in ``n`` y-shards with the
    split, ``n_steps`` steps through the kernels, against the port's plain sharded
    ensemble on the CPU, rtol 1e-11."""
    import dataclasses

    import torch

    from examples.wind_driven_ts_gyre_torch import (CHECK_INIT, CHECK_OPTIONS,
                                                    build_check, check_bottom)
    from orthogonalsphericalshellgrids_tpu_torch import kernels
    from orthogonalsphericalshellgrids_tpu_torch.models import (
        SplitExplicitFreeSurface, ensemble, layered_initial_state, layered_step,
        make_layered_model)

    def batch_on(dev):
        grid = build_check(device=dev)[0].grid
        model = make_layered_model(grid, free_surface=SplitExplicitFreeSurface(substeps=6),
                                   bottom_height=check_bottom, device=dev,
                                   forcing={"T": forcing_T}, **CHECK_OPTIONS)
        s = layered_initial_state(model, **CHECK_INIT)
        return model, s

    cpu_m, cpu_s = batch_on("cpu")
    pair = [cpu_s, layered_step(cpu_m, scaled_layered(cpu_s, 0.9), 60.0)]
    cpu_b = ensemble.stack_members(pair)
    gpu_m, _ = batch_on("cuda")
    gpu_b = type(cpu_b)(**{f.name: getattr(cpu_b, f.name).to("cuda")
                           for f in dataclasses.fields(cpu_b)})
    outs = {}
    for dev, model, batch in (("cuda", gpu_m, gpu_b), ("cpu", cpu_m, cpu_b)):
        fn, ds, gather = sharded(model, batch, n, True)
        kernels.reset_launch_counts()
        for _ in range(n_steps):
            ds = fn(ds, 60.0)
        counts = kernels.launch_counts()
        fn.close()
        outs[dev] = gather(ds)
        if dev == "cuda":
            check(all(counts[k] == 3 * n * n_steps for k in SPLIT_LAYERED_ENSEMBLE) and
                  counts["corrector_members"] == n * n_steps,
                  f"phase 18f: the member launches ran on every shard: {counts}")
        else:
            check(sum(counts.values()) == 0, f"phase 18f: the CPU run launched {counts}")
    I3 = (slice(None), slice(None)) + cpu_m.grid.interior2d
    worst = []
    for name in ("u", "v", "c", "eta", "Gc"):
        sl = (slice(None),) + cpu_m.grid_ext.interior2d if name == "eta" else I3
        w = getattr(outs["cpu"], name)[sl]
        rel = float((getattr(outs["cuda"], name).cpu()[sl] - w).abs().max() / w.abs().max())
        worst.append(f"{name} {rel:.3e}")
        check(rel <= 1e-11, f"phase 18f: {name} rel {rel:.3e}")
    check(torch.equal(outs["cuda"].t.cpu(), outs["cpu"].t), "phase 18f: t")
    log(f"phase 18f: 48 x 32 x 3 float64 check gyre with a forcing of T that reads t, 2 "
        f"members (iterations 0 and 1) in {n} y-shards with the split, {n_steps} steps "
        f"through the member launches against the plain sharded ensemble on the CPU: max "
        f"rel diff {', '.join(worst)} (rtol 1e-11) [{card}]")


# --------------------------------------------------------------------------------------
# Phase 19: checkpoint directories
# --------------------------------------------------------------------------------------

def dir_mb(path):
    """MB on disk of the files under ``path`` (a file or a directory)."""
    if os.path.isfile(path):
        return os.path.getsize(path) / 2**20
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files) / 2**20


def zeroed(state):
    """A state of ``state``'s class with every field zeros like its own."""
    import dataclasses

    import torch

    return type(state)(**{f.name: torch.zeros_like(getattr(state, f.name))
                          for f in dataclasses.fields(state)})


def states_equal(a, b, what):
    """Every field of ``a`` bitwise ``b``'s, on the same device, in the same dtype."""
    import dataclasses

    import torch

    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        check(x.device == y.device and x.dtype == y.dtype,
              f"{what}: {f.name} on {x.device} in {x.dtype}, expected {y.device}, {y.dtype}")
        check(torch.equal(x, y), f"{what}: {f.name} not bitwise equal")


class LoadSpy:
    """Records the {key: tensor} and the ``no_dist`` of every DCP load while
    installed, to show which tensors each key filled and over which route."""

    def __enter__(self):
        import torch.distributed.checkpoint as dcp

        self.calls, self.no_dist, self._dcp, self._load = [], [], dcp, dcp.load
        dcp.load = self
        return self

    def __call__(self, state_dict, **kwargs):
        self.calls.append(dict(state_dict))
        self.no_dist.append(kwargs.get("no_dist", False))
        return self._load(state_dict, **kwargs)

    def __exit__(self, *exc):
        self._dcp.load = self._load


def own_keys(keys, back, dist_model, what):
    """Each rank's returned tensors are the very tensors DCP filled from its own keys
    ``rank<k>/<field>``: no rank's state was assembled from another's or from a
    global copy."""
    import dataclasses

    for state, model in zip(back, dist_model):
        for f in dataclasses.fields(state):
            if f.name in ("t", "iteration"):
                continue
            key = f"rank{model.shard[0]}/{f.name}"
            x = getattr(state, f.name)
            check(key in keys and keys[key].data_ptr() == x.data_ptr() and x.is_cuda,
                  f"{what}: rank {model.shard[0]}'s {f.name} is not the card tensor "
                  f"DCP filled from {key}")


def phase19a_simulation(card, model, state0, n_iter=60, every=30, dt=40.0):
    """Phase 7's gyre through Simulation to ``n_iter`` with an npz and a directory
    Checkpointer every ``every`` iterations (each timed on the simulation thread),
    then resumed from the directory at ``every``: bitwise the uninterrupted run, its
    launches phase 10's, no host synchronization at an iteration without a
    callback."""
    import tempfile

    from orthogonalsphericalshellgrids_tpu_torch import kernels
    from orthogonalsphericalshellgrids_tpu_torch.utils import (
        Checkpointer, IterationInterval, Simulation)

    with tempfile.TemporaryDirectory() as tmp:
        npz = Checkpointer(os.path.join(tmp, "gyre"))
        t0 = time.perf_counter()
        directory = Checkpointer(os.path.join(tmp, "gyre"), npz=False)
        setup_ms = (time.perf_counter() - t0) * 1e3
        timed = {"npz": Timed(npz), "directory": Timed(directory)}
        sim = Simulation(model, state0, dt=dt, stop_iteration=n_iter)
        for fn in timed.values():
            sim.add_callback(fn, IterationInterval(every))
        marks = []
        kernels.reset_launch_counts()
        with host_syncs() as n_syncs:
            sim.add_callback(lambda s: marks.append((s.iteration, n_syncs())),
                             IterationInterval(1))
            once = sim.run()
        counts = kernels.launch_counts()
        syncs = {it: n - prev for (_, prev), (it, n) in zip(marks, marks[1:])}
        quiet = [it for it in syncs if it % every]
        check(len(quiet) == sum(1 for it in range(2, n_iter + 1) if it % every) and
              all(syncs[it] == 0 for it in quiet),
              f"phase 19a: Simulation waited for the card at an iteration without a "
              f"checkpoint: { {it: n for it, n in syncs.items() if n and it in quiet} }")
        expected = {k: 0 for k in counts}
        expected.update(halo_fill=2 * n_iter, halo_restore=n_iter, vertical=n_iter,
                        momentum_closures=n_iter, tracer_adv_kappa=n_iter,
                        corrector=n_iter, barotropic=n_iter)
        check(counts == expected, f"phase 19a: launch counts {counts} != {expected}")
        check(Checkpointer.latest(directory.prefix) in
              (npz.path_for(n_iter), directory.path_for(n_iter)), "phase 19a: latest")
        mb = {"npz": dir_mb(npz.path_for(every)),
              "directory": dir_mb(directory.path_for(every))}
        resumed = Simulation(model, state0, dt=dt, stop_iteration=n_iter)
        end = resumed.run(pickup=directory.path_for(every))
        check(resumed.iteration == n_iter, f"phase 19a: resumed to {resumed.iteration}")
        states_equal(end, once, f"phase 19a: pickup at iteration {every}")
    log(f"phase 19a: the gyre through Simulation to iteration {n_iter} at dt = {dt:g} s "
        f"with an npz and a directory Checkpointer every {every}; resumed from the "
        f"directory at {every}, every field bitwise the uninterrupted run; launches "
        f"phase 10's; host synchronizations 0 at each of the {len(quiet)} iterations "
        f"without a checkpoint; ms a checkpoint on the simulation thread: npz "
        f"{', '.join(f'{t:.1f}' for t in timed['npz'].ms)} for {mb['npz']:.1f} MB, "
        f"directory (DCP) {', '.join(f'{t:.1f}' for t in timed['directory'].ms)} for "
        f"{mb['directory']:.1f} MB (its Checkpointer made in {setup_ms:.1f} ms, "
        f"torch.distributed.checkpoint imported) [{card}]")


def phase19b_sharded(card, model, state0, steps=3, dt=40.0):
    """Phase 18's 4-member gyre in 4 y-shards and on 2 x 2 blocks: one directory
    saved after one step, ``steps`` more steps, loaded into zeroed rank states,
    ``steps`` more steps, bitwise the uninterrupted run."""
    import tempfile

    import torch

    from orthogonalsphericalshellgrids_tpu_torch.models import ensemble
    from orthogonalsphericalshellgrids_tpu_torch.utils import (
        load_sharded_checkpoint, save_sharded_checkpoint)

    batch0 = ensemble.stack_members([scaled_layered(state0, s) for s in ENSEMBLE_SCALES])
    for mesh_kind in (4, (2, 2)):
        where = (f"{mesh_kind} y-shards" if isinstance(mesh_kind, int) else
                 f"{mesh_kind[0]} x {mesh_kind[1]} blocks")
        what = f"phase 19b: the gyre as {len(ENSEMBLE_SCALES)} members on {where}"
        fn, ds, _ = sharded(model, batch0, mesh_kind, True)
        dm = fn.models
        ds = fn(ds, dt)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "ck")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            save_sharded_checkpoint(path, ds, dm)
            save_ms = (time.perf_counter() - t0) * 1e3
            mb = dir_mb(path)
            want = ds
            for _ in range(steps):
                want = fn(want, dt)
            like = [zeroed(s) for s in ds]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with LoadSpy() as spy:
                back = load_sharded_checkpoint(path, like, dm)
            torch.cuda.synchronize()
            load_ms = (time.perf_counter() - t0) * 1e3
        own_keys(spy.calls[-1], back, dm, what)
        check(spy.no_dist[-1] is True, f"{what}: the load was not one DCP call here")
        for k, (a, b) in enumerate(zip(back, ds)):
            states_equal(a, b, f"{what}: rank {k} read back")
        for _ in range(steps):
            back = fn(back, dt)
        for k, (a, b) in enumerate(zip(back, want)):
            states_equal(a, b, f"{what}: rank {k} resumed")
        fn.close()
        log(f"{what} through LocalExchange: one checkpoint directory of {mb:.1f} MB "
            f"saved in {save_ms:.1f} ms and loaded into zeroed rank states in "
            f"{load_ms:.1f} ms (each rank's tensors filled on the card from its own "
            f"keys); {steps} steps on from it bitwise the uninterrupted run in every "
            f"field of every rank [{card}]")
        del fn, ds, want, like, back
        torch.cuda.empty_cache()


def phase19c_group(card, model, state0, backend="nccl"):
    """Phase 18e's 2-member jet in a 1-rank ``backend`` group through
    ProcessGroupExchange: a directory saved and loaded through the process-group
    route, bitwise, and a step on from it bitwise."""
    import tempfile

    import torch
    import torch.distributed as dist

    from orthogonalsphericalshellgrids_tpu_torch import parallel
    from orthogonalsphericalshellgrids_tpu_torch.models import ensemble, step
    from orthogonalsphericalshellgrids_tpu_torch.utils import (
        load_sharded_checkpoint, save_sharded_checkpoint)

    pair = ensemble.stack_members([state0, step(model, scaled_state(state0, 0.5), 60.0)])
    what = f"phase 19c: a 2-member jet in a 1-rank {backend} group"
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.set_device(0)
        dist.init_process_group(backend, init_method="file://" + os.path.join(tmp, "store"),
                                rank=0, world_size=1)
        try:
            mesh = parallel.ProcessGroupExchange()
            dm, ds = parallel.distribute(model, pair, mesh)
            fn = parallel.sharded_step_fn(mesh, dm)
            s = fn(ds, 60.0)
            path = os.path.join(tmp, "ck")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            save_sharded_checkpoint(path, s, dm)
            save_ms = (time.perf_counter() - t0) * 1e3
            files = sorted(os.listdir(path))
            like = [zeroed(s[0])]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with LoadSpy() as spy:
                back = load_sharded_checkpoint(path, like, dm)
            torch.cuda.synchronize()
            load_ms = (time.perf_counter() - t0) * 1e3
            own_keys(spy.calls[-1], back, dm, what)
            check(spy.no_dist[-1] is False, f"{what}: the load did not go over the group")
            states_equal(back[0], s[0], f"{what}: read back")
            states_equal(fn(back, 60.0)[0], fn(s, 60.0)[0], f"{what}: a step on")
        finally:
            dist.destroy_process_group()
    check(files == [".metadata", "__0_0.distcp"], f"{what}: files {files}")
    log(f"{what} (ProcessGroupExchange): a checkpoint directory saved in {save_ms:.1f} "
        f"ms and loaded in {load_ms:.1f} ms through DCP over the group, bitwise, and a "
        f"step on from it bitwise [{card}]")


def phase20_benches(card, bickley, gyre):
    """The port's benchmark entry points on the card: one block of each bench against
    10 of its path's steps in launches; ``bench_torch.main`` on phase 3's jet with
    ``bench_layered_torch.run`` on phase 7's gyre (their lines, the NCCL collective
    smoke, every launch of the run a block's); ``bench_scaling_torch`` through
    LocalExchange at N = 1, 2, 4 (1440 x 170 a shard) and over NCCL on the cards
    present, each run's shards bitwise serial inside the bench. ``bickley`` and
    ``gyre`` are (model, state, launch counts, steps counted, ms/step) of phases 3 and
    7. Catches nothing."""
    import math

    import torch

    import bench_layered_torch
    import bench_scaling_torch
    import bench_torch
    from orthogonalsphericalshellgrids_tpu_torch import kernels

    t0 = time.perf_counter()
    blocks = {}
    for what, mod, (model, state0, counts, n, _) in (("jet", bench_torch, bickley),
                                                     ("gyre", bench_layered_torch, gyre)):
        check(all(v % n == 0 for v in counts.values()), f"{what} counts {counts} / {n}")
        want = {k: v // n * mod.BLOCK for k, v in counts.items()}
        kernels.reset_launch_counts()
        mod.block(model, state0)
        torch.cuda.synchronize()
        got = kernels.launch_counts()
        check(got == want, f"phase 20: one {what} bench block launched {got} != {want}")
        blocks[what] = want

    kernels.reset_launch_counts()
    head, lay, smoke = bench_torch.main(model_state=bickley[:2],
                                        layered=dict(model_state=gyre[:2]))
    counts = kernels.launch_counts()
    check(isinstance(lay, dict), f"phase 20: the layered bench {lay}")
    log(f"phase 20: bench_layered_torch line {json.dumps(lay)}")
    check(smoke == "ok", f"phase 20: cuda-nccl-smoke {smoke}")
    for line in (head, lay):
        check(math.isfinite(line["value"]) and line["value"] > 0 and
              line["unit"] == "grid-points/s/chip", f"phase 20: bench line {line}")
    want = {k: head["blocks"] * blocks["jet"][k] + lay["blocks"] * blocks["gyre"][k]
            for k in counts}
    check(counts["stream_probe"] > 0 and all(counts[k] == want[k] for k in counts
                                             if k != "stream_probe"),
          f"phase 20: the benches launched {counts}, {head['blocks']} jet and "
          f"{lay['blocks']} gyre blocks of {blocks}")
    t_bench = time.perf_counter() - t0

    lines = {}
    for exchange, sizes in (("local", ["--sizes", "1,2,4"]), ("nccl", [])):
        lines[exchange] = bench_scaling_torch.main(
            ["--exchange", exchange, "--nx", "1440", "--ny-per-dev", "170",
             "--substeps", "30", "--dt", "60"] + sizes)
        through = [x["devices"] for x in lines[exchange]
                   if x["metric"] == "weak-scaling grid-points/s"]
        eff = [x["devices"] for x in lines[exchange]
               if x["metric"] == "weak-scaling efficiency"]
        want_n = [1, 2, 4] if exchange == "local" else \
            [n for n in (1, 2, 4, 8) if n <= torch.cuda.device_count()]
        check(through == want_n and eff == want_n[1:] and
              all(math.isfinite(x["value"]) and x["value"] > 0 for x in lines[exchange]),
              f"phase 20: bench_scaling_torch --exchange {exchange}: {lines[exchange]}")
    local = ", ".join(f"N = {x['devices']} {x['ms_per_step']:.4f}" for x in lines["local"]
                      if x["metric"] == "weak-scaling grid-points/s")
    nccl = ", ".join(str(x["devices"]) for x in lines["nccl"]
                     if x["metric"] == "weak-scaling grid-points/s")
    log(f"phase 20: the benches launched {head['blocks']} jet and {lay['blocks']} gyre "
        f"blocks, each 10 steps' launches; headline {head['ms_per_step']:.4f} ms/step as "
        f"run ({head['value'] / 1e9:.4f} G grid-points/s), "
        f"{head['ms_per_step_host_ahead']:.4f} host ahead, phase 3 {bickley[4]:.4f} in "
        f"this call; gyre {lay['ms_per_step']:.4f} as run, "
        f"{lay['ms_per_step_host_ahead']:.4f} host ahead, phase 7 {gyre[4]:.4f}; weak "
        f"scaling through LocalExchange, ms/step: {local}, every run's shards bitwise "
        f"serial; NCCL on {torch.cuda.device_count()} card(s) at N = {nccl}; "
        f"cuda-nccl-smoke ok; benches {t_bench:.1f} s, the phase "
        f"{time.perf_counter() - t0:.1f} s [{card}]")


def phase21_graphs(card, bickley, gyre, n_steps=20, n_time=10, dt=40.0):
    """The compiled blocks (utils/graph.py): the 1/4-degree jet, the gyre and their
    4-member ensembles (ENSEMBLE_SCALES), each ``n_steps`` steps through the block's
    captured CUDA graph (multi_step, layered_multi_step, ensemble_multi_step) against
    the eager loop of step / layered_step from the same state in this call
    (``graph_path``). ``bickley`` and ``gyre`` are (model, initial state) of phases 3
    and 7."""
    import torch

    from orthogonalsphericalshellgrids_tpu_torch.models import (ensemble, layered_multi_step,
                                                                layered_step, multi_step,
                                                                step)

    (bmodel, bstate0), (gmodel, gstate0) = bickley, gyre
    graph_path(card, "jet", multi_step, step, bmodel, bstate0, 60.0, n_steps, n_time)
    graph_path(card, "gyre", layered_multi_step, layered_step, gmodel, gstate0, dt, n_steps,
               n_time)
    graph_path(card, "jet x 4", ensemble.ensemble_multi_step, step, bmodel,
               ensemble.stack_members([scaled_state(bstate0, f) for f in ENSEMBLE_SCALES]),
               60.0, n_steps, n_time)
    graph_path(card, "gyre x 4", ensemble.ensemble_multi_step, layered_step, gmodel,
               ensemble.stack_members([scaled_layered(gstate0, f) for f in ENSEMBLE_SCALES]),
               dt, n_steps, n_time)
    gib = 2**30
    log(f"phase 21: the card's memory after the phase: "
        f"{torch.cuda.memory_allocated() / gib:.2f} GiB allocated, "
        f"{torch.cuda.memory_reserved() / gib:.2f} GiB reserved, peak "
        f"{torch.cuda.max_memory_reserved() / gib:.2f} GiB reserved [{card}]")


def graph_path(card, what, block, step_fn, model, state0, dt, n_steps, n_time):
    """One path of phase 21: ``block(model, state0, dt, n_steps)`` (the graph's
    replay) bitwise the eager loop of ``step_fn`` in every field; a replay launches
    what ``n_steps`` eager steps launch, ``n_steps`` times the captured step's record,
    and makes no host synchronization; ms/step as run and with the host held ahead on both routes,
    timed on blocks of ``n_time`` steps (one block a window: with the card held, a
    longer window fills its launch queue and the host waits), each route's idle share
    (1 - host ahead / as run), the pair's capture seconds and its pool's MB."""
    import dataclasses

    import torch

    from orthogonalsphericalshellgrids_tpu_torch import kernels
    from orthogonalsphericalshellgrids_tpu_torch.utils import graph

    def eager(n=n_steps):
        state = state0
        for _ in range(n):
            state = step_fn(model, state, dt)
        return state

    def replay(n=n_steps):
        return block(model, state0, dt, n)

    kernels.reset_launch_counts()
    want = eager()
    eager_counts = kernels.launch_counts()
    replay()  # captures the block, unless an earlier phase did
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with host_syncs() as n_syncs:
        got = replay()
        waits = n_syncs()
    counts = kernels.launch_counts()
    torch.cuda.synchronize()
    for f in dataclasses.fields(want):
        check(torch.equal(getattr(got, f.name), getattr(want, f.name)),
              f"phase 21 {what}: {f.name} of the graph's {n_steps} steps bitwise the "
              f"eager loop")
    block_ = graph.blocks(model)[graph.layout(step_fn, state0)]
    recorded = {k: n_steps * v for k, v in block_.launches.items()}
    check(counts == eager_counts == recorded,
          f"phase 21 {what}: a replay launched {counts}, {n_steps} times the captured "
          f"step's record {recorded}, {n_steps} eager steps {eager_counts}")
    check(waits == 0, f"phase 21 {what}: a replay waited for the card {waits} times")
    del got, want
    ms = {(route, ahead): time_ms(lambda: fn(n_time), n=1, reps=5, warm=1,
                                  ahead=ahead) / n_time
          for route, fn in (("graph", replay), ("eager", eager)) for ahead in (False, True)}
    idle = {route: max(0.0, 1.0 - ms[route, True] / ms[route, False])
            for route in ("graph", "eager")}
    log(f"phase 21 {what}: {n_steps} steps through the CUDA graphs bitwise the "
        f"eager loop in every field; ms/step graph {ms['graph', False]:.4f} as run, "
        f"{ms['graph', True]:.4f} host ahead (idle share {idle['graph']:.3f}); eager "
        f"{ms['eager', False]:.4f} as run, {ms['eager', True]:.4f} host ahead (idle share "
        f"{idle['eager']:.3f}; blocks of {n_time}); the pair's capture (with its warm-up "
        f"step) {block_.capture_seconds:.3f} s, its pool {block_.pool_bytes / 2**20:.1f} "
        f"MB beside the two buffers' {2 * state_mb(state0):.1f} MB; a block launches "
        f"{ {k: v for k, v in counts.items() if v} } = {n_steps} captured steps' = "
        f"{n_steps} eager steps'; 0 host synchronizations in a replay [{card}]")


def state_mb(state):
    """The MB of a state's tensors."""
    import dataclasses

    return sum(getattr(state, f.name).nbytes for f in dataclasses.fields(state)) / 2**20


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available; this smoke runs only on a GPU",
              file=sys.stderr)
        return 1
    card = smi_line()
    log(f"phase 0: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from orthogonalsphericalshellgrids_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    _build.library()
    log(f"phase 1: kernels built in {_build.build_seconds():.1f} s (nvcc), loaded in "
        f"{time.perf_counter() - t0:.1f} s")

    kres = phase2_kernels(card)
    kres.update(phase2_fill_groups(card)[0])
    kres.update(phase2_layered(card))
    kres.update(phase2_gyre(card))
    phase2_operands(card)
    counts, bickley_ms, bickley_model, bickley_state0 = phase3_main_path(card)
    phase4_parity(card)
    front_counts, _ = phase5_layered_path(card)
    phase6_layered_parity(card)
    gyre_counts, gyre_ms, gyre_model, gyre_state0 = phase7_gyre_path(card)
    phase8_gyre_parity(card)
    probe_rows, probe_counts, ceil = phase9_probes(card, kres)
    kres.update(probe_rows)
    phase10_simulation(card, gyre_model, gyre_state0)
    diag_counts = phase11_bickley_50_days(card)
    kres.update(phase12a_shard_fills(card))
    shard_counts, shard_ms = phase12_sharded(
        card, (bickley_model, bickley_state0, bickley_ms), (gyre_model, gyre_state0, gyre_ms))
    kres.update(phase13a_block_fills(card))
    block_counts, block_ms = phase13_runs(card, (bickley_model, bickley_state0, bickley_ms),
                                          (gyre_model, gyre_state0, gyre_ms), shard_ms)
    # phase 17 while phase 7's gyre lives: the layered ensemble's member launches, the
    # gyre as 4 members, the front oracle through an ensemble member
    kres.update(phase17a_layered_members(card, ceil))
    layered_ensemble_counts, gyre_ensemble_ms = phase17b_layered_ensemble(
        card, gyre_model, gyre_state0, gyre_ms)
    phase17c_front_oracle_member(card)
    # phase 18 while phase 7's gyre lives: the member launches at a rank's and a
    # strip's shapes, the jet and the gyre as 4 members on 4 y-shards and 2 x 2 blocks,
    # a 1-rank NCCL ensemble, the f64 check gyre's forcing through the split
    phase18a_sharded_members(card, ceil)
    sharded_ensemble_counts, sharded_gyre_ensemble_counts = phase18_sharded_ensembles(
        card, (bickley_model, bickley_state0), (gyre_model, gyre_state0),
        {("jet", 1): (shard_ms["Bickley"], "12b"), ("jet", 2): (block_ms["b"], "13b"),
         ("gyre", 1): (shard_ms["gyre"], "12c"), ("gyre", 2): (block_ms["d"], "13d"),
         ("gyre", "ensemble"): gyre_ensemble_ms})
    phase18f_forcing_members(card)
    # phase 19 while phase 7's gyre lives: checkpoint directories through Simulation,
    # of the sharded 4-member gyre and through a 1-rank NCCL group
    phase19a_simulation(card, gyre_model, gyre_state0)
    phase19b_sharded(card, gyre_model, gyre_state0)
    phase19c_group(card, bickley_model, bickley_state0)
    # phase 20 while phase 7's gyre lives: the benchmark entry points
    phase20_benches(card, (bickley_model, bickley_state0, counts, 20, bickley_ms),
                    (gyre_model, gyre_state0, gyre_counts, 10, gyre_ms))
    # phase 21 while phase 7's gyre lives: the compiled blocks against the eager loop
    phase21_graphs(card, (bickley_model, bickley_state0), (gyre_model, gyre_state0))
    del gyre_model, gyre_state0
    kres.update(phase14a_planes(card))
    planes_counts = phase14_options(card, bickley_model, bickley_state0, bickley_ms)
    kres.update(phase15a_members(card))
    ensemble_counts = phase15_ensemble(card, bickley_model, bickley_state0, bickley_ms)
    phase16_grids(card, bickley_model)
    del bickley_model, bickley_state0

    # each path must have launched every kernel it runs; a row reports the count of
    # the last path that runs it (the gyre's for every kernel of the gyre; the
    # sharded Bickley jet's for the pack, the wrap and the shard fill; the 2 x 2
    # Bickley jet's for the block pack and the block fill; the two-tracer jet's for
    # the P-plane column mode; the ensembles' for the member modes; phase 18's sharded
    # ensembles are held to launching theirs and come first, so no row reports them)
    launches = {}
    for path, names, cnt in (("sharded jet ensemble", SHARDED_ENSEMBLE,
                              sharded_ensemble_counts),
                             ("sharded gyre ensemble", SHARDED_LAYERED_ENSEMBLE,
                              sharded_gyre_ensemble_counts),
                             ("2-D Bickley", BLOCKS, block_counts),
                             ("sharded Bickley", SHARDED, shard_counts),
                             ("two-tracer Bickley", PLANES, planes_counts),
                             ("Bickley ensemble", ENSEMBLE, ensemble_counts),
                             ("gyre ensemble", LAYERED_ENSEMBLE, layered_ensemble_counts),
                             ("Bickley", BICKLEY, counts), ("front", FRONT, front_counts),
                             ("gyre", GYRE, gyre_counts), ("ceilings", PROBES, probe_counts),
                             ("50-day run", DIAGNOSTICS, diag_counts)):
        check(all(cnt[n] > 0 for n in names), f"{path} path launched {cnt}")
        launches.update({n: cnt[n] for n in names})
    table = [{"name": name, "route": "cuda", "source": SOURCES[name],
              "replaces": REPLACES[name], "launches": launches[name],
              "max_abs_err": kres[name][0], "ms": kres[name][1], "plain_ms": kres[name][2],
              "bound_ms": kres[name][3][0], "bound_by": kres[name][3][1],
              "library_ms": kres[name][4] if len(kres[name]) > 4 else None}
             for name in REPLACES]
    print(json.dumps({"kernels": table}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def descendants():
    """(pid, command) of every process below this one, read from /proc."""
    parent = {}
    for d in os.listdir("/proc"):
        if d.isdigit():
            try:
                with open(f"/proc/{d}/stat") as f:
                    # the command may hold spaces and parentheses: the fields follow
                    # the last ')'
                    parent[int(d)] = int(f.read().rsplit(")", 1)[1].split()[1])
            except (OSError, IndexError, ValueError):
                pass
    found, todo = [], [os.getpid()]
    while todo:
        kids = [c for c, pp in parent.items() if pp == todo[-1]]
        todo.pop()
        found += kids
        todo += kids
    out = []
    for pid in found:
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                out.append((pid, f.read().replace(b"\0", b" ").decode(errors="replace")))
        except OSError:
            pass
    return out


def stop_processes():
    """Stops every process the run started and left behind, so none outlives the
    script: multiprocessing's resource tracker, which ``parallel.spawn``'s queue
    starts and which otherwise ends only after this process has ended and its pipe
    closed, then any other descendant, killed (named on stderr) and reaped."""
    import multiprocessing
    import signal
    from multiprocessing import resource_tracker

    tracker = resource_tracker._resource_tracker
    if getattr(tracker, "_pid", None) is not None:
        tracker._stop()  # closes the tracker's pipe and waits for it to exit
    for p in multiprocessing.active_children():
        p.kill()
        p.join()
    left = descendants()
    for pid, cmd in left:
        print(f"chip_smoke: stopping a process left running: {pid} {cmd}", file=sys.stderr)
        with contextlib.suppress(ProcessLookupError):
            os.kill(pid, signal.SIGKILL)
    for pid, _ in left:
        with contextlib.suppress(ChildProcessError):
            os.waitpid(pid, 0)


if __name__ == "__main__":
    try:
        rc = main()
    finally:
        stop_processes()
    sys.exit(rc)
