#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's main path once at a real size — the 21k-DOF band tier
(``sh_i`` strip, refine = 4, isotropic steel, AP1030, 512 frequencies over
40-600 Hz) through ``Problem(...).solveForward`` on ``cuda`` — and checks it:

1. a CUDA device is present; print the card's name and power limit;
2. build the hand-written band kernel (``csrc/band_mv.cu``) with nvcc;
3. hold the kernel, which reads the band's nonzero tiles packed once in
   ``getFRCore`` (``[pack]``), against its plain torch version on the same
   pack, at the slice's own shape (B = 128, 16 and 2) and at a synthetic
   b = 64 block size, to 1e-5 of max |y| (the f32 sums of a row run in
   another order); time both, the library call of the same product (one
   ``torch.matmul`` on the dense band, ``library_ms``) and the kernel with
   the L2 flushed, in turns, and state the kernel's bound (``[bound]``);
   hold its launches on the window packs of a dof rank's block rows (d =
   2 and 4, each pack from its block rows alone) against the plain
   version and the whole launch's rows, which they must match bit for bit
   (``[kernel] window``);
4. run the 512-point sweep, count the kernel's launches (must be > 0) and
   check that the FRF is finite;
5. hold the FRF against a host f64 sparse-LU oracle (``oracle.splu_frf``:
   an f64 LU solve refined with extended-precision residuals, the solution
   of the f64 system) at 4 points including the |FRF| peak, to 1e-6
   relative;
6. the inverse half on the same Problem, from theta_0 = truth x (1.05,
   1.02, 1.2) against the phase-4 FRF at the truth (``[adjoint]``,
   ``[jac]``, ``[gn]``): time ``ResidualFunction("log_afc").value_and_jac``
   (first and steady call) and count K1's launches in its primal and its
   adjoint sweep (both must be > 0); hold 2 J^T r / m against the
   MSE_LOG_AFC loss gradient (GRAD_TOL_21K; GRAD_TOL on the dense tier's
   n = 1466 in phase 7) and every column of J against a
   central difference of r (FD_STEPS, to FD_TOL of the column's max); run
   ``solveInverse(theta_0, "MSE_LOG_AFC", "gn", use_scaling=True,
   N_steps=GN_STEPS)``, print every iterate's loss and seconds, and
   require the loss to fall at every step and the result to reach the
   truth to 1e-4 relative (|beta|: the FRF magnitude is even in the loss
   factor, so -beta is an exact minimum too);
7. the dense-preconditioner tier (``[dense]``), where K1 must not run:
   (a) the bench configuration as ``bench.py`` builds it (``sh_i`` refine =
   1, n = 1466, ``precond`` and ``operator_layout`` left at "auto", which
   must resolve to the flat layout, the dense preconditioner and the
   port's f64 Krylov basis): a first and a steady 512-point sweep with peak
   memory, the FRF checksum sum |FRF| within 1e-6 of the JAX CPU run's
   (``BENCH_r05.json``) and the worst relative error against the host f64
   splu at bench.py's four points within 1e-6; one steady sweep with
   ``basis_f32=True`` (the JAX package's f32 basis) held to the same 1e-6;
   (b) phase 6's inverse half
   on that Problem; (c) the largest dense-tier plate (refine = 3, n =
   11910, "auto": the band layout with the dense preconditioner): its
   construction with the dense f64 inverse, a first and a steady sweep
   with peak memory, and the splu check at 4 points including the peak.
   K1's launch counter reads 0 over each of them.  At (a) and (c) the
   dense preconditioner's apply by fixed row blocks (``ops.dense.
   dense_apply``, a dof rank's GEMMs) is timed beside one DGEMM of the
   whole inverse (``[k5]``);
8. the material families and the pure-bending path (``[families]``), all
   sweeps 512 points over 40-600 Hz: (a) the multi-cut orthotropic
   identification of ``examples/joint_identification.py`` on the bench
   plate (n = 1466, dense tier): three SOL cuts at 0/90/45 degrees sharing
   theta = [E1, E2, G12, nu12, beta], synthetic FRFs from ``solveForward``
   at the truth, a ``JointResidual`` of theta-scaled ``log_afc`` residuals
   and 30 Gauss-Newton steps from s0, every iterate's loss and seconds
   printed, the loss falling at every step and the result within
   JOINT_TOL of the truth; and a non-palindromic SOL stack (0, 45), whose
   B is not zero, against f64 splu at 4 points incl. the peak; (b)
   ``OrthotropicD4`` (a loss factor per modulus, so K_im is a third
   operator) at refine = 4 (n = 20916, two-grid): construction, a first
   and a steady sweep with peak memory, splu at 4 points incl. the peak,
   K1 launches > 0; one ``ResidualFunction("log_afc").value_and_jac`` over
   the 8 parameters with K1 launches in both sweeps, 2 J^T r / m against
   the MSE_LOG_AFC gradient; (c) isotropic steel on the pure-bending path
   (``Problem(geom, mat, None)``) at refine = 1 (n = 956, dense) and 4 (n
   = 13862, two-grid): construction, first and steady sweep, splu at 4
   points incl. the peak of the complex FRF; at 13862 K1 launches > 0 and
   K1 against its plain version on that Problem's own pack (a Morley-only
   band);
9. the flat-pattern operator K3 (``csrc/csr_mv.cu``, built beside K1 in
   phase 2) and the rest of the public API (``[slice6]``): (a) K3 against
   its plain version (the ``index_add_`` scatter) on the card at the
   main path's shapes — S = 2 operators on the bench pattern (n = 1466)
   at L = 1024 and 16 lanes, S = 3 there, the 290,688- and 513,552-nnz
   patterns of n = 11910 and 20916 at L = 1024, the f32 variant, the
   panels' row sums (S = 32 on x = 1, L = 1) on the bench and 21k
   patterns and the vmap-folded residual-map stack (S = 24, L = 1024) on
   the 21k one — to CSR_TOL of max |y|, two launches bit for bit, with its
   time (the wrapper's whole call; the wide kernel also on x transposed
   by a copy, the copy timed), the plain version's, the time of
   one ``torch.sparse.mm`` on the same CSR (``library_ms``) and its bound
   (the plan's index bytes), and K3's launches by regime (one lane,
   narrow, wide) on the bench and 21k sweeps, r + J and the gradient;
   (b) two steady sweeps and two MSE_LOG_AFC gradients bit-identical at n
   = 1466 and on phase 6's 21k Problem; (c) the SOL 45 deg plate (n =
   1466) at s and s0 (theta / truth away from the build point): splu at 4
   points incl. the peak, and ``diagnoseSweep`` with every lane converged;
   (d) ``examples/tpu_benchmark.py``'s workflow: construction, a
   3000-point sweep first and steady, then ``solveInverse`` by gradient
   descent on 200 compressed points (as called there, and with
   ``use_scaling``) and by ``cd_mem`` with ``use_scaling`` for 5 cycles,
   every step's loss and seconds, each result within TPUB_TOL of the JAX
   package's CPU run of the same call (TPUB_JAX); (e)
   ``examples/edp_import.py``'s plate with a hole, built from its script
   text (``.edp``: clamped on label 2, read at its xtest/ytest, pure
   bending), its 121-point sweep against splu at 4 points incl. the peak;
10. the rest of the inverse API (``[slice8]``): (a) on phase 6's 21k
   Problem the forward-mode ``ResidualFunction("log_afc",
   jac_mode="fwd").value_and_jac`` (the lanes chunk policy), first and
   steady, with K1 and K3 launches and peak memory, against the adjoint r
   and J (FWD_R_TOL, FWD_R_CHUNK_TOL, FWD_J_RTOL / FWD_J_ATOL), two calls
   bit for bit, freq_chunk = 64 against the unchunked J, and
   ``kind="complex"`` against central differences of r; (b) the same
   over OrthotropicD4's 8 parameters on phase 8 (b)'s Problem; (c) on the
   bench plate the MSE_LOG_AFC Hessian (HESS_SYM_TOL, against central
   differences of the gradient), ``_data_grad`` timed beside K3 on its
   inputs, ``solveInverse`` by trust region, Newton and L-BFGS to SO_TOL
   of the truth and by Gauss-Newton on MSE to GN_MSE_FIT of its start's
   loss, ``de`` and ``shgo`` on a bounds box; (d) the ``getModePicture``
   field at the first resonance against the sweep's own w (MODE_TOL).

11. the modal and direct engines (``[engines]``), each on the card
   through K3 and torch.linalg: (a) the bench plate through
   ``engine="modal"`` and ``engine="direct"`` (chunk 16): construction, a
   first and a steady sweep with peak memory (the modal basis, eigh and
   Rayleigh polish, is built once per theta in the first), the checksum
   against BENCH_CHECKSUM and splu at bench.py's four points, two steady
   sweeps and gradients bit for bit, the direct sweep at chunk 3 bit for
   bit the chunk-16 one, K3 launches > 0 in the modal sweep;
   the engines' library calls (the generalized eigh, eigh, a chunk's
   complex128 LUs and solves) timed beside their bounds, and K3 at the
   polish's shape (L = n lanes) against its plain version and the library
   call; (b) from truth x START, each engine's MSE_LOG_AFC gradient
   against the mixed engine's (ENG_GRAD_RTOL / ENG_GRAD_ATOL; K3 launches
   > 0), ``ResidualFunction("log_afc")`` resolving to the forward mode
   with J against the mixed adjoint J (FWD_J_RTOL / FWD_J_ATOL) and
   ``jac_mode="adjoint"`` raising ValueError, the modal Hessian against
   the mixed one (HESS_SYM_TOL, HESS_FD_TOL of the column max) and
   Gauss-Newton through the modal engine to GN_TOL; (c) OrthotropicD4
   through the direct engine, splu at 4 points incl. the peak; (d) a
   frequency-dependent loss factor asked for with the modal engine: the
   RuntimeWarning, the direct engine, the per-frequency splu, and its
   sweep of three frequencies against Problems with beta pinned to
   beta(omega_i), each at its frequency (FD_PIN_TOL); (e) pure
   bending (n = 956) through both engines against splu; (f)
   ``examples/basics.py``'s workflow through the modal engine against the
   JAX package's CPU run (BASICS_JAX); (g) the modal engine at n = 11910:
   construction, the basis, the sweeps, splu at 4 points;
12. the LOBPCG basis, the flat multilevel and the sparse API
   (``[slice10]``): (a) ``basis="lobpcg"`` at n = 1466, 11910 and 20916:
   the basis seconds beside the ARPACK basis of the same pencil built in
   this call (phases 2 and 7), rounds and iterations, K3 > 0 in the flat
   build and K1 > 0 in the 21k one, the lowest eigenvalues against
   ARPACK's (LOB_EIG_TOL), the reduced Rayleigh-Ritz on the card against
   the host at 21k, a first and a steady sweep, splu at 4 points incl.
   the peak, a second fresh Problem's basis bit for bit; (b)
   ``precond="mg"`` on the flat layout at 1466 ("auto") and 20916
   (``operator_layout="flat"``): levels, sweeps, cycles, splu at 4 points,
   ``diagnoseSweep`` all converged, two sweeps bit for bit, K1 0 and K3 >
   0 on the rectangular P / P^T too; at 1466 one r + J (2 J^T r / m to
   GRAD_TOL) and one Gauss-Newton step; (c) the sparse API on the bench
   operator (SPARSE_FREQS, SPARSE_PEAK_HZ): ``spsolve`` against splu and
   the refined splu, its gradient against central differences, vmap
   against calls, ``matvec`` against the plain version, the LU's time
   beside its bound; (d) K3 against its plain version and the library
   call on the 21k chain's P and P^T at RECT_LANES lanes;
13. the diagnostics, K3's long rows and the compat layer
   (``[slice11]``): (a) K3 on a synthetic pattern whose rows reach
   300-3000 distinct columns (LONG_N rows, every LONG_EVERY-th a long row:
   the long-row kernel beside each tile kernel) against its plain version
   (LONG_TOL in f64, CSR_TOL in f32), two launches bit for bit, timed
   beside its bound and ``torch.sparse.mm``, its tiles' and long rows'
   launches also alone, and with ``--ab-csr`` an earlier kernel's (its
   bits on every row but the long ones); then the sparse API's ``matvec``
   on the same pattern through the long-row kernel (LONG_TOL, two calls
   bit for bit); (b) ``diagnostics.polish_peaks`` at the bench
   plate and on phase 2's 21k Problem at theta = truth x POLISH_SCALE: the
   peak against the refined splu before and after (ORACLE_TOL after), K3
   launches in both and K1 at 21k, and JAX tests/test_diagnostics.py's
   starved budget returned verbatim; (c) ``diagnostics.oracle_check`` of
   the bench and 21k sweeps (and in phase 9 (e) as
   ``examples/edp_import.py`` runs it) to ORACLE_TOL; (d)
   ``diagnostics.parity``'s expansion at the bench plate against its mixed
   sweep (EXP_TOL) with its checksum interval, and the reference's golden
   checksum inside the interval on tests/test_golden_parity.py's plate;
   (e) ``diagnostics.profile_call`` of one steady bench sweep: its Chrome
   trace names K3's kernels as often as the launch counter counts; (f)
   ``device_report`` and ``test_function`` on 5e7 f32 against numpy
   (``examples/test_device_lib.py``); (g) tests/test_compat.py's script
   on the card;
14. frequency sharding over torch.distributed (``[slice12]``), each rank a
   process forked from a forkserver (``parallel.ranks.spawn``): (a)
   the bench plate (n = 1466, 512 points) at one rank per card over NCCL
   — the sharded FRF against the unsharded sweep (its bits at world 1),
   the training step against ``LossFunction.value_and_grad`` (SHARD_TOL,
   SHARD_GRAD_TOL), the adjoint and forward-mode Gauss-Newton steps at
   truth x SHARD_THETA against ``ResidualFunction`` and the host normal
   equations (SHARD_TOL), each step timed beside its single-process
   counterpart; the regrouping witness (the step with its lanes in two
   batches, ``freq_chunk`` N_FREQ / 2) and the control (a pad lane left
   in) that bracket SHARD_REGROUP_TOL; (b) the same plate on two gloo
   ranks on the card, as a (freq 2, dof 1) and a (freq 1, dof 2) mesh
   (each dof rank owning its rows of ``invK64`` and ``W64``) against (a)
   (DOF_FRF_TOL for the dof mesh's FRF, SHARD_REGROUP_TOL for the
   Gauss-Newton updates) and the freq mesh's updates against the witness
   (SHARD_TOL), every rank and run the same bits; (c) the 13862-DOF
   pure-bending plate (band + two-grid) on the (freq 1, dof 2) mesh, each
   rank holding its share of every partitioned entry, its peak against
   the refined splu (ORACLE_TOL) and K1 on the window packs alone in
   every rank; (b) and (c) print, per rank, the
   bytes held of each partitioned entry and the device memory before and
   after placement; (e) the 11910-DOF dense-tier plate on the (freq 1,
   dof 2) mesh, in (b)'s spawn: each rank's allocated memory falls by at
   least 0.95 x the rows of ``invK64`` and ``W64`` it gave up, both ranks
   hold the FRF's bits, the FRF meets the unsharded sweep of this process
   (DOF_FRF_TOL) and the refined splu at 4 points incl. the peak
   (ORACLE_TOL), K3 and the row blocks' GEMMs ran in each rank (on two
   cards or more, the same run over NCCL is printed too); (f) the
   20916-DOF two-grid plate on the (freq 1, dof 2) mesh at DOF_TG_FREQ
   points, in (b)'s spawn: each rank holds its block rows of the band,
   its K1 window pack, P and the diagonal and its rows of the coarse
   inverse and W64, its allocated memory falls by at least 0.95 x what it
   gave up (printed with the card), the FRF meets the refined splu at 4
   points incl. the peak (ORACLE_TOL), one adjoint Gauss-Newton update
   the single-process one (SHARD_TOL), K1 ran on the window packs alone.
   Every dof-2 FRF of (b), (c), (e) and (f) must be the unsharded sweep's
   bits on both ranks (ref_: the counterparts a rank runs before its mesh
   places the Problem); (g) the bench plate's two-grid (``precond="mg"``,
   the band layout: 6 block-row groups) on DOF_WIDE gloo ranks of the
   card as (freq 1, dof DOF_WIDE), a dof axis wider than the band's
   groups: every rank keeps the band, P, the diagonal and the K1 pack
   whole (the JAX package's placement), its FRF at DOF_WIDE_FREQ points
   the unsharded sweep's bits, K1 on the whole pack in every rank; (d)
   ``python -m plate_inverse_problem_tpu_torch.parallel``'s workflow on
   the modal engine with device "cuda", in the NCCL rank (torchrun's
   path) and in this process (the plain run's), against the JAX
   package's CPU run of
   ``examples/multichip.py`` (MULTICHIP_JAX, MULTICHIP_TOL).  Each step
   prints its wall, its collectives' seconds and K1 / K3 per rank;
15. the scale tiers (``[slice17]``), 512 points over 40-600 Hz, tier
   "auto" (band + two-grid): (a) ``sh_i`` refine = 6 (n = 46432) and (b)
   refine = 9 (n = 103680), isotropic steel: construction with each host
   part's seconds, n_free and nnz against the JAX package's
   (TIER_COUNTS), K1's shared memory a block, a first and two steady
   sweeps (the two steady ones bit for bit, K1 > 0), the refined splu
   (refine 6: 4 points incl. the peak to ORACLE_TOL; refine 9: a point
   off the peak to ORACLE_TOL, the peak raw or after ``polish_peaks``),
   one adjoint r + J with its seconds and peak memory; at refine 9 K1 on
   the pack and K3 on the pattern at the sweep's chunk against their
   plain versions (KERNEL_TOL, CSR_TOL), timed beside bound and library
   call, and K3 with 24 operators at 1024 lanes (past 2^31 outputs)
   against the plain version where the offsets are largest; (c)
   OrthotropicD4 at refine 9: the adjoint r + J at 512 points against
   (b)'s FRF, its peak device memory at most RJ_MEM_GB, J at half the
   budget's block from the same sweeps with the same bits; on phase 8
   (b)'s 21k Problem the adjoint J at RJ_ALT_BLOCK frequencies a block
   with phase 8 (b)'s bits and within FWD_J_RTOL / FWD_J_ATOL of phase 10
   (b)'s forward-mode J;
16. the FGMRES cycle's Givens least squares (``[slice18]``), K7a
   ``givens_step`` and K7b ``backsub`` (``csrc/fgmres_lsq.cu``, built
   in phase 2): (a) every call of one steady bench (n = 1466) and one
   steady 21k sweep recorded (``k7_recorded``) and replayed through the
   kernel and the plain version on the card, and seeded sets (64 and 512
   lanes, k = 1, 3, 8, 16, 24 and 64: every width bucket of the kernels;
   every step; a = 0, b = 0, both zero, inactive and underflowing lanes):
   identical bits; each bucket's build report, no stack frame and no
   spills at k <= 16 (h, y and the rotations in registers); (b) each
   kernel's time at the 21k and bench sweeps' first call by CUDA events
   on the device and by the host clock on the host, with k and its
   bucket, the plain version's and the bound (bytes at 3.35 TB/s; the
   launch dominates), and for K7b one ``torch.linalg.solve_triangular``
   on the same inputs (no library call computes K7a's batched Givens
   update); (c) the two steady sweeps'
   seconds, K7a / K7b launches > 0 and no plain call on the card in them,
   in phase 4's sweep, in phases 6 and 7 (b)'s r + J and Gauss-Newton and
   in phase 13 (e)'s traced bench sweep, whose Chrome trace names both
   kernels as often as their counters count them; its kernel count and
   busy share printed.

Any failed phase raises and the script exits non-zero.  The last two lines
are the kernels' JSON record and ``{"ok": true, "device": {...}}``.

Run from the repository root:  python3 chip_smoke.py
(``--ab SOURCE``, repeatable, also builds another version of K1, with the
earlier dense-band or the packed C interface, and times it beside the
kernel in the tree, in turns; ``--ab-csr SOURCE`` does the same for K3
with the first cut's C interface, the tiled one before the long rows
(commit 499a5fc) or the one with the first long-row kernel (commit
6a96d88), at every phase 9 (a) and 13 (a) case, and requires its bits to
be the kernel's on every row but the long ones.)
"""
from __future__ import annotations

import contextlib
import functools
import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

N_FREQ = 512
KERNEL_TOL = 1e-5
SLEEP_CYCLES = 20_000_000   # ~10 ms of device sleep ahead of a timed run
ORACLE_TOL = 1e-6
START = (1.05, 1.02, 1.2)     # theta_0 / truth of phase 6
# 2 J^T r / m vs the loss gradient, relative to its max component.  The two
# share the primal sweep and differ in their adjoint sweeps (the adjoint
# right-hand sides differ), each solved to the FGMRES tolerance.  Every
# operator apply now runs K3, which sums in one fixed order, so each sweep
# gives the same bits in every run (phase 9 (b) checks it) and the
# deviation is the two adjoint solves' own: at n = 1466 the CPU test
# (tests/test_torch_inverse.py) and the card hold it to 1e-8 (7.8e-10 on
# an H100 at 700 W).  At 21k it is the two-grid tier's solve tolerance,
# which moves with the random ARPACK basis of the Problem: 9.9e-8 with the
# deterministic K3 (OrthotropicD4: 1.6e-9), 7.7e-8 to 2.4e-7 in earlier
# runs with the atomic scatter, on an H100 at 700 W; GRAD_TOL_21K rounds
# that up.
GRAD_TOL = 1e-8
GRAD_TOL_21K = 3e-7
# J column vs its central difference, of the column's max.  E and G at a
# relative step of 1e-4, where truncation sets the deviation (CPU, n = 1466,
# E column: 2.2e-5 at 1e-4, 2.2e-3 at 1e-3); beta at 1e-2, because its
# column is bound by the f64 noise of r over 2 h (CPU, 64 points: 1.4e-3 at
# 1e-5, 6.5e-5 at 1e-4, 5.7e-6 at 1e-3, 1.0e-5 at 1e-2; the 21k sweep on
# the card is noisier: 7.6e-4-1.9e-3 at 1e-4).  CPU numbers from
# .probes/torch_sweep_profile.py --fd-cpu.  The tolerance is the bound of
# 1e-3: the worst CPU deviation at these steps is 2.2e-5, the card's E and
# G columns at 1e-4 were 1.4e-4-1.5e-4 and 4.7e-5-7.5e-5 (an H100 at
# 700 W).
FD_STEPS = (1e-4, 1e-4, 1e-2)
FD_TOL = 1e-3
# Gauss-Newton steps: from theta_0 the iterates reach 1.7e-4 / 8.4e-4 (E, G)
# after 8 steps (iterate 8) and 1.0e-6 / 5.2e-6 after 10 on an H100 at
# 700 W; beta ends at -beta, its mirror image
GN_STEPS = 10
GN_TOL = 1e-4                 # relative distance of the GN result to truth
# sum |FRF| of the bench sweep (sh_i refine = 1, 512 points over 40-600 Hz)
# from the JAX package on the CPU (BENCH_r05.json), and its tolerance
BENCH_CHECKSUM = 1584.7714001606384
CHECKSUM_TOL = 1e-6
# phase 8 (a): examples/joint_identification.py on the bench plate —
# theta = [E1, E2, G12, nu12, beta] of a carbon-like sheet (density 1550),
# three SOL cuts, the start s0 = theta_0 / truth and the Gauss-Newton steps;
# the result's relative tolerance to the truth per parameter (|beta|: the
# FRF magnitude is even in the loss factor)
JOINT_TRUE = (120e9, 8.5e9, 4.5e9, 0.30, 0.006)
JOINT_ANGLES = (0.0, 90.0, 45.0)
JOINT_S0 = (1.35, 0.70, 1.40, 0.85, 1.50)
JOINT_STEPS = 30
JOINT_TOL = (1e-3, 1e-3, 1e-3, 1e-2, 1e-2)
# (the JAX package's own CPU run of this configuration,
# .probes/joint_identification_jax.py, meets JOINT_TOL: it stalls after 16
# steps at -7.6e-6, +2.7e-6, -1.1e-4, +2.7e-3, -5.6e-6)
# phase 8 (b): the per-modulus loss factors of tests/test_problem.py
D4 = dict(E1=210e9, E2=200e9, G12=75e9, nu12=0.33, b1=0.003, b2=0.003,
          b3=0.004, b4=0.0)
D4_START = (1.02, 0.98, 1.03, 0.97, 1.1, 0.9, 1.05, 1.0)   # theta_0 / truth
# phase 9 (a): K3 against its plain version, of max |y| (the f64 sums of a
# row run in another order and with FMAs; f32 as K1)
CSR_TOL = {"f64": 1e-12, "f32": 1e-5}
# H100 SXM rates the bound uses: memory, f64 and f32 FMAs on the CUDA cores
# (NVIDIA's data sheet; K3 uses no tensor cores)
HBM_BPS = 3.35e12
F64_FLOPS = 34e12
F32_FLOPS = 67e12
# phase 9 (c): theta / truth where ROADMAP's dense-tier fault showed
SOL45_S = (0.7, 1.3, 0.6, 1.15, 0.5)
# phase 9 (d): examples/tpu_benchmark.py's workflow, and the JAX package's
# own CPU run of the same calls (.probes/tpu_benchmark_jax.py, the
# package's default CPU engine: modal), (x, niter, status) per run
TPUB_N_FREQ = 3000
TPUB_N_COMP = 200
TPUB_START = (0.1, 0.1, 0.2)
TPUB_RUNS = {"gd": ("gd", 20, False), "gd_scaled": ("gd", 20, True),
             "cd_mem_scaled": ("cd_mem", 5, True)}
TPUB_JAX = {
    "gd": ((220000000000.00003, 82500000000.0, 0.054617256073671495), 19,
           "Running"),
    "gd_scaled": ((203958143447.65717, 92312934898.18619,
                   0.0043248574568596695), 19, "Running"),
    "cd_mem_scaled": ((229486910306.21732, 91518930001.49454,
                       0.004322571981818481), 4, "Running"),
}
TPUB_JAX_CHECKSUM = 9390.68402986405
TPUB_TOL = 1e-6
# phase 10 (a): the forward-mode Jacobian against the adjoint one: r to
# 1e-12 relative (the primal is solved as its own batch in both modes), J
# to 1e-6 relative + 1e-8 of its max (the JAX package's own bounds,
# tests/test_problem.py:326-352); the freq_chunk run regroups the lanes of
# the sweep; kind='complex' against central differences of r at FD_STEPS,
# to FD_TOL of the column max (phase 6's check of the adjoint J)
FWD_R_TOL = 1e-12
# with a freq_chunk each block's primal is a sweep of its own lanes (64 of
# the 512), whose batched products may round otherwise: two converged
# solves of one lane differ by at most twice the residual target, refine_tol
# = 3e-7 of the right-hand side, hence 1e-6 of max |r|
FWD_R_CHUNK_TOL = 1e-6
FWD_J_RTOL = 1e-6
FWD_J_ATOL = 1e-8
FWD_CHUNK = 64
# phase 10 (c): the bench Hessian (MSE_LOG_AFC, x = theta / theta_0 = 1).
# Asymmetry: the tangent and tangent-adjoint sweeps' own error.  Columns vs
# central differences of the port's gradient at step HESS_FD_STEP in x, to
# HESS_FD_TOL of the column max.  Truncation, h^2 / 6 x the third
# derivative: the E column's resonance makes it 1.6e-2 at h = 1e-3 and
# 1.4e-4 at 1e-4 (.probes/second_order_probe.py on an H100 at 700 W; G and
# beta <= 5.2e-6).  Solve error: each gradient's sweeps stop at the residual
# target refine_tol = 3e-7 (relative, amplification-weighted), so its
# error is up to ~3e-7 of its scale, but at x +- h the FGMRES runs the same
# steps, a polynomial in the operator, and the quotient sees only that
# error's smooth change; a change of step count between x - h and x + h
# would add up to refine_tol / h = 3e-3 of the gradient's scale and fail
# the check.
HESS_SYM_TOL = 1e-8
HESS_FD_STEP = 1e-4
HESS_FD_TOL = 1e-3
# step budgets from theta_0 and the distance to the truth trust region,
# Newton and L-BFGS must reach (18, 22-23 and 39-42 steps on an H100 at
# 700 W).
# Gauss-Newton on MSE fits the data but cannot reach the truth in any such
# budget: the absolute residual is the resonance peaks', which fix the
# plate's bending stiffness, a combination of E and G, so its normal
# matrix is near-singular along an E-G valley that the damped steps crawl
# down (30 steps end 1.1e-2 / 7.8e-2 off in E / G from theta_0, and 5.2e-3
# / 3.2e-2 from truth x (1.01, 1.005, 1.05), at a loss 1e-7 of the
# start's; .probes/second_order_probe.py, H100 at 700 W).  The JAX
# package's own CPU run of the call (exact LU) follows the same path: 15
# steps end at 2.56e-8 of the start's loss, 30 at +1.13e-2 / +7.77e-2 in
# E / G (.probes/second_order_jax_gn_mse.log).  Its check is the JAX
# package's GN test's: the loss falls at every step, to GN_MSE_FIT of its
# start (2.56e-8 after 15 steps on an H100 at 700 W, as in the JAX run; the
# 16th step reaches 2.8e-9).
SO_STEPS = {"tr": 30, "newton": 30, "lbfgs": 60, "gn": 15}
SO_TOL = 1e-4
GN_MSE_FIT = 1e-7
# (d) the getModePicture field against the sweep's own w DOFs
MODE_TOL = 1e-6
# phase 11: the modal and direct engines.  (b) the MSE_LOG_AFC gradient
# through each engine against the mixed engine's, entrywise: the JAX
# package's own bound for that comparison (tests/test_problem.py:221-236)
ENG_CHUNK = 16
ENG_CHUNK_ALT = 3      # (a) the direct sweep's bits at another chunk
ENG_GRAD_RTOL = 1e-5
ENG_GRAD_ATOL = 1e-13
# (d) tests/test_problem.py's frequency-dependent damping, beta0 (1 +
# omega / FD_OMEGA_REF) at beta0 = FD_BETA0, and its pinned-beta check
FD_OMEGA_REF = 2.0 * np.pi * 300.0
FD_BETA0 = 0.01
FD_PIN_FREQS = (80.0, 150.0, 300.0)
FD_PIN_TOL = 1e-9
# (f) examples/basics.py's four sums from the JAX package's own CPU run of
# the script (its default CPU engine, modal; the symm template's default
# mesh, n = 3150): JAX_PLATFORMS=cpu python3 .probes/basics_jax.py
BASICS_JAX = {"FR": 144.7110698446815, "Initial": 99.08788960014357,
              "After": 99.08834915978969, "F_hist": 0.15227839599368673}
BASICS_TOL = 1e-6
# the f64 tensor-core rate of an H100 SXM (NVIDIA's data sheet), the peak
# of the engines' library calls (LAPACK-style factorisations on the card)
F64_TC_FLOPS = 67e12
# phase 12 (a): the LOBPCG basis's lowest eigenvalues against ARPACK's on
# the same pencil (the JAX test's bound), relative
LOB_EIG_TOL = 1e-6
# phase 12 (c): the sparse API on the bench operator.  spsolve, refined
# against K3's exact product (SPARSE_REFINE rounds), against scipy's splu
# and the longdouble-refined splu at omega = 0 and three frequencies off
# the bench plate's one resonance in 40-600 Hz, and at the resonance
# (150.68 Hz) against the refined splu alone: there plain splu is itself
# the conditioning's kappa * eps off (2.3e-9 at 152 Hz on the CPU), and so
# is an unrefined LU (2.2e-10 off splu at 60 Hz on an NVIDIA H100 80GB
# HBM3 at 700 W); the gradient against central differences at a relative
# step of 1e-6, of its max; matvec against the plain version, relative
SPARSE_FREQS = (60.0, 300.0, 500.0)
SPARSE_PEAK_HZ = 150.68
SPARSE_REFINE = 2
SPARSE_TOL = 1e-10
SPARSE_GRAD_TOL = 1e-6
SPARSE_MV_TOL = 1e-14
# phase 12 (d): the lane counts of K3 on the 21k chain's P and P^T
RECT_LANES = (1, 16, 1024)
# phase 13 (a): the synthetic long-row pattern (rows, every how many rows a
# long one, its distinct columns), K3's bound against its plain version
# there, of max |y| (a long row's 300-3000 terms k ascending, or in
# segments of 128 below 32 lanes, against the scatter's order), and its
# cases (S, L, dtype, label)
LONG_N = 16384
LONG_EVERY = 64
LONG_COLS = (300, 3000)
LONG_TOL = 1e-14
LONG_CASES = ((2, 1024, "f64", "long rows S=2 L=1024 (wide + long)"),
              (2, 16, "f64", "long rows S=2 L=16 (narrow + long)"),
              (32, 1, "f64", "long rows S=32 L=1 (one lane + long)"),
              (1, 1024, "f32", "long rows f32 S=1 L=1024"))
# phase 13 (b): theta / truth of the polish (JAX tests/test_diagnostics.py)
POLISH_SCALE = (1.1, 0.9, 1.2)
# phase 13 (d): the expansion against the sweep (the JAX test's bound, 48
# modes at least) and the reference's golden checksum of the symm plate
EXP_TOL = 5e-6
GOLDEN = 341.9363
# phase 13 (f): 2x + sin(x) in f32 against numpy's, absolute (|y| < 13:
# a few f32 ulps)
DEVICE_LIB_TOL = 1e-5
# phase 14: theta / truth of the sharded steps (JAX tests/test_parallel.py),
# the bounds against the single-process port (the JAX parallel tests':
# FRF, loss and Gauss-Newton update relative, gradient of its max) and the
# dof mesh's FRF bound (the JAX dof test's)
SHARD_THETA = (1.02, 0.99, 1.05)
SHARD_TOL = 1e-9
SHARD_GRAD_TOL = 1e-8
DOF_FRF_TOL = 1e-7
# phase 14 (f): the points of the 21k two-grid plate's sweep on two gloo
# ranks of one card (fewer than N_FREQ: a dof rank's cycle gathers its
# rows through the host, PERF.md section 6)
DOF_TG_FREQ = 128
# phase 14 (g): a dof axis wider than the bench band's block-row groups (6
# at nb = 6: the two-grid stays whole on every rank), its ranks (gloo, one
# card) and points
DOF_WIDE = 8
DOF_WIDE_FREQ = 64
# phase 14 (b), and (a) on several cards: the Gauss-Newton update of lanes
# solved in other batches (the ranks' shares, or the dense preconditioner's
# GEMM in column blocks) against the whole batch's, relative.  The update
# is ill-conditioned in the E-G valley, and a batch's FGMRES stops on its
# own lanes: on an NVIDIA H100 80GB HBM3 at 700 W the single-process step
# with its 512 lanes in two batches of 256 (the witness, in (a)) moves G's
# update by 4.4e-8 (adjoint) / 6.7e-8 (fwd), the same figures as the two
# ranks of (b)'s freq mesh; the dof mesh moves it 3.8e-8, four cards
# 2.8e-8.  The control, one pad lane left in, moves it 3.0e-3: the bound
# sits between them, 15x above the largest sound reading
SHARD_REGROUP_TOL = 1e-6
REGROUP_STEPS = ("gn_chunk", "gn_fwd_chunk")
# phase 14 (d): the JAX package's own CPU run of examples/multichip.py
# (XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu
# python3 .probes/multichip_jax.py: the example's code, its numbers printed
# in full; modal engine, a (freq 4, dof 2) mesh of virtual devices), and
# the port's bound against it, relative
MULTICHIP_JAX = {"losses": [0.03031934638051415, 0.029388834416543528,
                            0.028150455103617637],
                 "final_rsq": 1.6832674222076234e-05}
MULTICHIP_TOL = 1e-6
# phase 15: the scale tiers' host counts (n_free, pattern entries) in the
# JAX package's runs (SCALE.md), the bound on OrthotropicD4's adjoint r + J
# at 104k (half an 80 GB card) and the second block size of its 21k check
TIER_COUNTS = {6.0: (46432, 1146820), 9.0: (103680, 2571222)}
RJ_MEM_GB = 40.0
RJ_ALT_BLOCK = 64
# phase 9 (e): the script of examples/edp_import.py
EDP_SCRIPT = """
// a plate with a circular hole, clamped on its RIGHT border (label 2 --
// note: not the templates' label 1; the on(...) clause below declares it)
real Lx = 90e-3; real Ly = 30e-3;
real r = 6e-3;
real xtest = 25e-3; real ytest = 5e-3;
int n = 8;
border Bl(t=0., 1){x=0;        y=Ly - t*Ly; label=0;}
border Bb(t=0., 1){x=Lx*t;     y=0;         label=0;}
border Br(t=0., 1){x=Lx;       y=t*Ly;      label=2;}
border Bt(t=0., 1){x=(1-t)*Lx; y=Ly;        label=0;}
border Hole(t=0., 2*pi){x=Lx/2 + r*cos(-t); y=Ly/2 + r*sin(-t); label=0;}
mesh Th = buildmesh(Bl(n) + Bb(3*n) + Br(n) + Bt(3*n) + Hole(2*n));
// the physics section is FreeFEM-specific and not interpreted -- but its
// on(...) labels ARE honored as the essential-BC location:
problem P(u, v) = ... + on(2, u=0, ux=0, uy=0);
"""


def card_info() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(report: str) -> list[str]:
    """One line per compiled kernel from ``nvcc -Xptxas -v``: its template
    arguments, registers, shared memory and spills."""
    out, name, spill = [], "kernel", ""
    for line in report.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"ILi(\d+)ELb(\d)E", line)
            k = re.search(r"(csr_mv_\w+?_kernel)I(\w)(?:Li(\d+)E)?"
                          r"(?:Li(\d+)E)?", line)
            k7 = re.search(r"(givens_step_kernel|backsub_kernel)ILi(\d+)E",
                           line)
            name = (f"<S={m[1]}, vec={m[2]}>" if m else
                    f"{k[1]}<" + ", ".join(a for a in k.groups()[1:] if a)
                    + ">" if k else f"{k7[1]}<{k7[2]}>" if k7 else
                    "kernel")
        elif "spill stores" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line:
            out.append(f"{name}: {line.split('info    :')[-1].strip()}; "
                       f"{spill}")
    return out


def time_ms(fn, reps: int = 20) -> tuple[float, float]:
    """(device ms, host ms) per call, after a warm-up.  A device-side sleep
    queued first lets the host enqueue every call before the first one
    runs, so the CUDA events around them time the device alone and the host
    clock times the enqueue alone."""
    import torch

    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = time.perf_counter() - t0
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, 1e3 * host / reps


def time_flushed_ms(fn, reps: int = 20) -> float:
    """Mean milliseconds per call with the 50 MB L2 flushed before each
    call by writing a 64 MiB buffer (CUDA events around the call alone)."""
    import torch

    flush = torch.empty(16 * 2**20, device="cuda")
    for _ in range(3):
        fn()
    marks = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    for start, end in marks:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in marks) / reps


def library_mv(band, layout):
    """The yardstick (``library_ms``; the port never calls it): one
    ``torch.matmul`` of an ``as_strided`` window view of the zero-padded x
    against band^T, (nb, B, 3b) @ (nb, 3b, b) -> (nb, B, b).  Returns
    (pad, run): ``pad`` makes the padded x and is not timed."""
    import torch

    nb, b, n = layout.nb, layout.b, layout.n
    band_t = band.transpose(-1, -2)

    def pad(x):
        xp = torch.zeros(x.shape[0], (nb + 2) * b, device=x.device)
        xp[:, b:b + n] = x
        return xp

    def run(xp):
        win = xp.as_strided((nb, xp.shape[0], 3 * b), (b, (nb + 2) * b, 1))
        return torch.matmul(win, band_t)

    return pad, run


def load_ab_kernel(source: str):
    """Build another version of K1 from ``source``, for an A/B beside the
    kernel in the tree (it is not part of the port), and return its
    launcher ``run(pack, band, x, layout) -> y``.  The C interface is the
    earlier dense-band ``band_mv_f32_launch(band, x, y, B, n, nb, b,
    stream)`` or, where the library exports ``band_mv_f32_tile``, the
    packed one of ``csrc/band_mv.cu`` (on a pack of the tile shape it was
    built for)."""
    import ctypes
    import os

    import torch
    from plate_inverse_problem_tpu_torch.ops import band_kernel

    name = os.path.splitext(os.path.basename(source))[0]
    lib_path = os.path.join(band_kernel.BUILD_DIR, f"libab_{name}.so")
    os.makedirs(band_kernel.BUILD_DIR, exist_ok=True)
    res = subprocess.run([band_kernel._nvcc(), *band_kernel.NVCC_FLAGS,
                          "-o", lib_path, source],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{res.stderr}")
    for line in ptxas_summary(res.stdout + res.stderr):
        print(f"[build] {name}: {line}", flush=True)
    lib = ctypes.CDLL(lib_path)
    packed = hasattr(lib, "band_mv_f32_tile")
    tile = divmod(lib.band_mv_f32_tile(), 1000) if packed else None
    repacked = {}
    lib.band_mv_f32_launch.argtypes = [ctypes.c_void_p] * (
        5 if packed else 3) + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.band_mv_f32_launch.restype = ctypes.c_int

    def run(pack, band, x, layout):
        y = torch.empty_like(x)
        stream = torch.cuda.current_stream().cuda_stream
        if packed and pack.tile != tile:
            if id(band) not in repacked:
                repacked.clear()
                repacked[id(band)] = band_kernel.pack_band_tiles(
                    band, layout, tile)
            pack = repacked[id(band)]
        if packed:
            rc = lib.band_mv_f32_launch(
                pack.vals.data_ptr(), pack.col0.data_ptr(),
                pack.row_ptr.data_ptr(), x.data_ptr(), y.data_ptr(),
                x.shape[0], layout.n, pack.n_row_tiles, pack.list_max,
                stream)
        else:
            rc = lib.band_mv_f32_launch(
                band.data_ptr(), x.data_ptr(), y.data_ptr(), x.shape[0],
                layout.n, layout.nb, layout.b, stream)
        if rc != 0:
            raise RuntimeError(f"{source}: cudaError {rc}")
        return y

    return name, run


def compare_kernel(pack, band, x, layout, label: str, ab=()) -> dict:
    """Kernel vs plain version on the same inputs (errors), and the device
    times of the kernel, the plain version, the library call and the A/B
    kernels ``ab`` ((name, run) pairs), in turns; the kernel also with the
    L2 flushed before each launch, and its host enqueue time."""
    import torch
    from plate_inverse_problem_tpu_torch.ops.band_kernel import (
        band_mv_f32_cuda, band_mv_f32_reference)

    y_ref = band_mv_f32_reference(pack, x, layout)
    y = band_mv_f32_cuda(pack, x, layout)
    pad, run = library_mv(band, layout)
    xp = pad(x)
    y_lib = run(xp).permute(1, 0, 2).reshape(x.shape[0], -1)[:, :layout.n]
    torch.cuda.synchronize()
    scale = max(float(y_ref.abs().max()), 1e-30)
    max_abs = float((y - y_ref).abs().max())
    rel = max_abs / scale
    errs = {"library": float((y_lib - y_ref).abs().max()) / scale}
    variants = {"ms": lambda: band_mv_f32_cuda(pack, x, layout),
                "plain_ms": lambda: band_mv_f32_reference(pack, x, layout),
                "library_ms": lambda: run(xp)}
    for name, fn in ab:
        errs[name] = float((fn(pack, band, x, layout) - y_ref).abs().max()
                           ) / scale
        variants[f"{name}_ms"] = (lambda fn=fn: fn(pack, band, x, layout))
    # in turns: a b c ..., ... c b a
    order = list(variants) + list(variants)[::-1]
    times = {k: [] for k in variants}
    for k in order:
        times[k].append(time_ms(variants[k]))
    rec = {k: float(np.mean([d for d, _ in v])) for k, v in times.items()}
    rec.update(max_abs_err=max_abs, rel_err=rel, B=x.shape[0],
               host_ms=float(np.mean([h for _, h in times["ms"]])),
               flushed_ms=time_flushed_ms(variants["ms"]),
               **{f"{k}_rel_err": e for k, e in errs.items()})
    others = "  ".join(f"{k[:-3]} {v:.4f} ms (rel {errs[k[:-3]]:.1e})"
                       for k, v in rec.items()
                       if k.endswith("_ms") and k[:-3] in errs)
    print(f"[kernel] {label}: B={x.shape[0]} nb={layout.nb} b={layout.b} "
          f"n={layout.n}  max|dy|={max_abs:.3e} rel={rel:.3e}  kernel "
          f"{rec['ms']:.4f} ms (L2 flushed {rec['flushed_ms']:.4f}; host "
          f"enqueue {rec['host_ms']:.4f})  plain {rec['plain_ms']:.4f} ms  "
          f"{others}", flush=True)
    if not rel <= KERNEL_TOL:
        raise AssertionError(f"band kernel disagrees at {label}: rel {rel:.3e}"
                             f" > {KERNEL_TOL}")
    for k, e in errs.items():
        if not e <= KERNEL_TOL:
            raise AssertionError(f"{k} disagrees at {label}: rel {e:.3e} > "
                                 f"{KERNEL_TOL}")
    return rec


def compare_windows(pack, band, x, layout) -> dict:
    """K1 on the window packs of a dof rank's block rows (what a rank of a
    (freq, dof d) mesh launches, d = 2 and 4; each pack from its block
    rows alone) against the plain version on the same window (KERNEL_TOL)
    and against the whole pack's launch: the rank's rows must be the whole
    apply's bits.  Times rank 0's window launch at d = 2 beside its plain
    version and the library call on the window (one ``torch.matmul``), in
    turns, with its byte bound."""
    import torch

    from plate_inverse_problem_tpu_torch.ops.band_kernel import (
        band_mv_f32_cuda, band_mv_f32_reference, pack_band_tiles)
    from plate_inverse_problem_tpu_torch.parallel.freq_shard import (
        band_range)

    y_whole = band_mv_f32_cuda(pack, x, layout)
    out, failed = {"ranks": []}, []
    for d in (2, 4):
        for i in range(d):
            q0, q1 = band_range(layout.nb, d, i)
            pk = pack_band_tiles(band[q0:q1], layout, pack.tile, q0=q0)
            (lo, hi), (xlo, xhi) = pk.rows, pk.cols
            xw = x[:, xlo:xhi].contiguous()
            y = band_mv_f32_cuda(pk, xw, layout)
            y_ref = band_mv_f32_reference(pk, xw, layout)
            scale = max(float(y_ref.abs().max()), 1e-30)
            rel = float((y - y_ref).abs().max()) / scale
            bits = bool(torch.equal(y, y_whole[:, lo:hi]))
            rec = {"d": d, "rank": i, "block_rows": (q0, q1),
                   "tiles": pk.vals.shape[0], "rel_err": rel,
                   "whole_bits": bits}
            if d == 2 and i == 0:
                # the library call on the window: one torch.matmul of the
                # rank's band rows on x's zero-padded window (the port
                # never calls it), held to the plain version, in turns
                nq, b, B = q1 - q0, layout.b, x.shape[0]
                xp = torch.zeros(B, (nq + 2) * b, device=x.device)
                xp[:, xlo - (q0 - 1) * b:xhi - (q0 - 1) * b] = xw
                band_t = band[q0:q1].transpose(-1, -2)

                def lib():
                    return torch.matmul(xp.as_strided(
                        (nq, B, 3 * b), (b, (nq + 2) * b, 1)), band_t)
                y_lib = lib().permute(1, 0, 2).reshape(B, -1)[:, :hi - lo]
                rec["library_rel_err"] = float(
                    (y_lib - y_ref).abs().max()) / scale
                if not rec["library_rel_err"] <= KERNEL_TOL:
                    failed.append(f"window d={d} rank {i}: the library "
                                  f"call's rel {rec['library_rel_err']:.3e}")
                fns = {"ms": lambda: band_mv_f32_cuda(pk, xw, layout),
                       "plain_ms": lambda: band_mv_f32_reference(
                           pk, xw, layout),
                       "library_ms": lib}
                times = {k: [] for k in fns}
                for k in list(fns) + list(fns)[::-1]:
                    times[k].append(time_ms(fns[k])[0])
                rec |= {k: float(np.mean(v)) for k, v in times.items()}
                # least time: the window's nonzeros with a 4-byte index
                # each, its x window read and its rows of y written once
                nz = int((pk.vals != 0).sum())
                t_bytes = (8.0 * nz + 4.0 * B * ((xhi - xlo) + (hi - lo))
                           ) / HBM_BPS
                t_ops = 2.0 * nz * B / F32_FLOPS
                rec["bound_ms"] = 1e3 * max(t_bytes, t_ops)
                rec["bound_by"] = ("bytes" if t_bytes >= t_ops
                                   else "operations")
            out["ranks"].append(rec)
            print(f"[kernel] window d={d} rank {i}: block rows [{q0}, {q1}) "
                  f"of {layout.nb}, rows [{lo}, {hi}), x [{xlo}, {xhi}), "
                  f"{rec['tiles']} tiles, B={x.shape[0]}: rel {rel:.3e} vs "
                  f"plain, the whole launch's bits {bits}"
                  + (f"; {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms,"
                     f" library (torch.matmul) {rec['library_ms']:.4f} ms "
                     f"(rel {rec['library_rel_err']:.1e}), bound "
                     f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}), kernel "
                     f"at {100 * rec['bound_ms'] / rec['ms']:.1f} % of it"
                     if "ms" in rec else ""), flush=True)
            if not rel <= KERNEL_TOL:
                failed.append(f"window d={d} rank {i}: rel {rel:.3e}")
            if not bits:
                failed.append(f"window d={d} rank {i}: not the whole "
                              "launch's bits")
    if failed:
        raise AssertionError("K1 window packs: " + "; ".join(failed))
    return out


def k5_blocked(p, label: str, lanes: int = 1024) -> dict:
    """The dense preconditioner's apply (K5) as the port runs it, one DGEMM
    a fixed row block of ``invK64`` (``ops.dense.dense_apply``), against
    one DGEMM of the whole inverse on the same (lanes, n) rows, in turns
    (CUDA events), with the bound of the work: the inverse read once and x
    and y at 3.35 TB/s against 2 n^2 lanes FLOP at 67 TFLOP/s (f64 tensor
    cores)."""
    import torch

    from plate_inverse_problem_tpu_torch.ops.dense import (
        dense_apply, fixed_blocks)

    inv = p.getFRCore()[1]["invK64"]
    n = inv.shape[0]
    x = torch.as_tensor(np.random.default_rng(5).standard_normal(
        (lanes, n)), device=inv.device)
    y_b, y_1 = dense_apply(inv, x), torch.matmul(x, inv.T)
    rel = float((y_b - y_1).abs().max() / y_1.abs().max())
    variants = {"blocked_ms": lambda: dense_apply(inv, x),
                "one_gemm_ms": lambda: torch.matmul(x, inv.T)}
    times = {k: [] for k in variants}
    for k in list(variants) + list(variants)[::-1]:
        times[k].append(time_ms(variants[k])[0])
    rec = {k: float(np.mean(v)) for k, v in times.items()}
    t_bytes = 8.0 * (n * n + 2 * lanes * n) / 3.35e12
    t_ops = 2.0 * n * n * lanes / 67e12
    rec |= {"n": n, "lanes": lanes, "blocks": len(fixed_blocks(n)) - 1,
            "rel_vs_one_gemm": rel,
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    rec["blocked_over_one"] = rec["blocked_ms"] / rec["one_gemm_ms"]
    print(f"[k5] {label} n={n}: dense_apply by {rec['blocks']} fixed row "
          f"blocks {rec['blocked_ms']:.4f} ms, one DGEMM "
          f"{rec['one_gemm_ms']:.4f} ms ({rec['blocked_over_one']:.3f}x), "
          f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}), {lanes} "
          f"lanes; the two differ by {rel:.1e} of max |y|", flush=True)
    return rec


def bound_ms(pack, B: int, n: int) -> tuple[float, str]:
    """Least time of the product on an H100 SXM: the band's nonzeros with a
    4-byte index each, x read once and y written once, at 3.35 TB/s,
    against 2 FLOP per nonzero and lane at 67 TFLOP/s (f32, CUDA cores)."""
    nnz = int((pack.vals != 0).sum())
    t_bytes = (8.0 * nnz + 2 * 4.0 * B * n) / 3.35e12
    t_ops = 2.0 * nnz * B / 67e12
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else \
        "operations"


def synthetic_b64(device):
    """The b = 64 narrow-band pattern of tests/test_band.py:203-213."""
    import torch
    from plate_inverse_problem_tpu_torch.ops.band import (
        build_band_layout, flat_to_band)
    from plate_inverse_problem_tpu_torch.ops.band_kernel import (
        pack_band_tiles)

    n, w = 400, 9
    rows = np.concatenate([np.full(min(n, i + w + 1) - max(0, i - w), i)
                           for i in range(n)])
    cols = np.concatenate([np.arange(max(0, i - w), min(n, i + w + 1))
                           for i in range(n)])
    layout = build_band_layout(rows, cols, n, block_multiple=64, min_block=64)
    rng = np.random.default_rng(7)
    vals = torch.as_tensor(rng.standard_normal(rows.size).astype(np.float32),
                           device=device)
    lin = torch.as_tensor(layout.lin, dtype=torch.int64, device=device)
    band = flat_to_band(vals, layout, lin)
    x = torch.as_tensor(rng.standard_normal((8, n)).astype(np.float32),
                        device=device)
    return pack_band_tiles(band, layout), band, x, layout


# ---------------------------------------------------------------------------
# phase 12: the LOBPCG band basis, the flat multilevel, the sparse API
# ---------------------------------------------------------------------------

def lobpcg_tier(dev, refine: float, label: str, arpack: dict,
                rr_ab: bool = False) -> dict:
    """Phase 12 (a) on one plate: ``Problem(basis="lobpcg")`` built on the
    card — the basis build's seconds beside the ARPACK basis's of the same
    pencil in this call (``arpack``: its eigenvalues and seconds), its
    rounds of m and LOBPCG iterations, K1 and K3 launches over the
    construction (the basis build is its only kernel work), peak memory —
    then a first and a steady 512-point sweep, the refined splu at four
    points incl. the peak, the lowest eigenvalues against ARPACK's to
    LOB_EIG_TOL, and a second fresh Problem's basis bit for bit.
    ``rr_ab``: also time the reduced Rayleigh-Ritz of every iteration on
    the host (numpy's LAPACK through ``_reduced_rr`` on CPU tensors, the
    copies both ways included) beside its device time."""
    import torch

    from plate_inverse_problem_tpu_torch.ops import (
        band_kernel, csr_kernel, lobpcg)

    tag = "[slice10] (a)"
    freqs = np.linspace(40.0, 600.0, N_FREQ)
    rr = {"calls": 0, "device_s": 0.0, "mats": []}
    rr_fn = lobpcg._reduced_rr

    def timed_rr(A, B, nx, drop_tol=1e-12):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = rr_fn(A, B, nx, drop_tol)
        torch.cuda.synchronize()
        rr["device_s"] += time.perf_counter() - t0
        rr["calls"] += 1
        if rr_ab:
            rr["mats"].append((A.clone(), B.clone(), nx))
        return out

    band_kernel.band_mv_f32_cuda.launches = 0
    csr_kernel.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    lobpcg._reduced_rr = timed_rr
    try:
        t0 = time.perf_counter()
        p = sh_i_problem(dev, refine, basis="lobpcg")
        od = p.getFRCore()[1]
        torch.cuda.synchronize()
        ctor_s = time.perf_counter() - t0
    finally:
        lobpcg._reduced_rr = rr_fn
    rec = {"n_free": p.n_free, "tier": list(p._tier), "ctor_s": ctor_s,
           "basis_s": p._band_basis_s, "arpack_basis_s": arpack["basis_s"],
           "rounds": [list(r) for r in lobpcg.band_basis_lobpcg.rounds],
           "m": int(od["W64"].shape[1]), "m_arpack": len(arpack["lam"]),
           "k1_basis": band_kernel.band_mv_f32_cuda.launches,
           "k3_basis": csr_kernel.csr_mv_cuda.launches,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "rr_calls": rr["calls"], "rr_device_s": rr["device_s"]}
    lam, lam_a = p._band_lam, arpack["lam"]
    m = min(len(lam), len(lam_a))
    rec["eig_rel"] = float((np.abs(lam[:m] - lam_a[:m]) / lam_a[:m]).max())
    print(f"{tag} {label}: n_free={p.n_free} tier {p._tier}; LOBPCG basis "
          f"{rec['basis_s']:.3f} s against ARPACK's (band_basis_host, same "
          f"pencil, this call) {rec['arpack_basis_s']:.3f} s; rounds (m, "
          f"block, iterations) {rec['rounds']}, m={rec['m']} (ARPACK "
          f"{rec['m_arpack']}); lowest {m} eigenvalues vs ARPACK max rel "
          f"{rec['eig_rel']:.3e} (tol {LOB_EIG_TOL}); construction "
          f"{ctor_s:.2f} s, K1 {rec['k1_basis']} and K3 {rec['k3_basis']} "
          f"launches in it, peak device memory {rec['peak_mem_gb']:.2f} GB; "
          f"reduced Rayleigh-Ritz on the device: {rr['calls']} calls, "
          f"{rr['device_s']:.4f} s", flush=True)
    if rr_ab:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for A, B, nx in rr["mats"]:
            lam_h, C = rr_fn(A.cpu(), B.cpu(), nx)
            C.to(A.device)
        torch.cuda.synchronize()
        rec["rr_host_s"] = time.perf_counter() - t0
        sizes = sorted({int(A.shape[0]) for A, _, _ in rr["mats"]})
        print(f"{tag} {label}: the same {rr['calls']} reduced Rayleigh-Ritz "
              f"problems (sizes {sizes}) on the host: {rec['rr_host_s']:.4f} "
              f"s (copies included) against {rr['device_s']:.4f} s on the "
              f"device", flush=True)
        del rr["mats"]
    sw = timed_sweeps(p, freqs, f"{label} sweep", tag=tag)
    fr = sw.pop("fr")
    rec |= sw
    failed = []
    try:
        rec["worst_rel_err"] = oracle_check(p, freqs, fr, peak_points(fr),
                                            label, tag=tag)
    except AssertionError as err:
        failed.append(str(err))
    q = sh_i_problem(dev, refine, basis="lobpcg")
    rec["bits_identical"] = bool(torch.equal(od["W64"],
                                             q.getFRCore()[1]["W64"]))
    del q
    print(f"{tag} {label}: a second fresh Problem's basis identical: "
          f"{rec['bits_identical']}", flush=True)
    if not rec["eig_rel"] <= LOB_EIG_TOL:
        failed.append(f"{label}: eigenvalues {rec['eig_rel']:.3e} from "
                      "ARPACK's")
    if not rec["bits_identical"]:
        failed.append(f"{label}: two fresh Problems' LOBPCG bases differ")
    if failed:
        raise AssertionError(" | ".join(failed))
    return rec


class RectCount:
    """Counts K3 calls on rectangular plans (the multilevel's P and P^T)
    while active: wraps ``csr_kernel.csr_mv``, which ops/mg.py looks up at
    each call."""

    def __init__(self):
        self.launches = 0

    def __enter__(self):
        from plate_inverse_problem_tpu_torch.ops import csr_kernel

        self.fn = csr_kernel.csr_mv

        def counted(data, x, csr, seg=None):
            if x.is_cuda and csr.n != csr.n_cols and x.numel():
                self.launches += 1
            return self.fn(data, x, csr, seg)

        csr_kernel.csr_mv = counted
        return self

    def __exit__(self, *exc):
        from plate_inverse_problem_tpu_torch.ops import csr_kernel

        csr_kernel.csr_mv = self.fn


def flat_mg(dev, refine: float, label: str, inverse: bool = False,
            **kw) -> tuple:
    """Phase 12 (b) on one plate: ``Problem(precond="mg")`` on the flat
    layout — levels and n per level, construction, a first and a steady
    512-point sweep with the multilevel cycles they ran (the FGMRES steps:
    each runs 1 + _MG_REFINE cycles), the refined splu at four points incl.
    the peak, ``diagnoseSweep``, two more steady sweeps bit for bit; K1 0,
    K3 > 0 with rectangular launches.  ``inverse``: also one adjoint r + J
    (2 J^T r / m against the loss gradient to GRAD_TOL) and one
    Gauss-Newton step.  Returns (Problem, record)."""
    import torch

    from plate_inverse_problem_tpu_torch.ops import mixed

    tag = "[slice10] (b)"
    freqs = np.linspace(40.0, 600.0, N_FREQ)
    t0 = time.perf_counter()
    p = sh_i_problem(dev, refine, precond="mg", **kw)
    p.getFRCore()
    torch.cuda.synchronize()
    ctor_s = time.perf_counter() - t0
    ns = [int(v) for v in p._mg_static["n"]]
    cycles = [0]
    ml_fn = mixed.multilevel_apply

    def counted(*a, **k):
        cycles[0] += 1
        return ml_fn(*a, **k)

    mixed.multilevel_apply = counted
    try:
        with RectCount() as rect:
            sw = timed_sweeps(p, freqs, f"{label} sweep", tag=tag)
    finally:
        mixed.multilevel_apply = ml_fn
    fr = sw.pop("fr")
    rec = {"n_free": p.n_free, "tier": list(p._tier), "ctor_s": ctor_s,
           "levels": len(ns), "n_per_level": ns, **sw,
           "cycles_2_sweeps": cycles[0],
           "fgmres_steps_2_sweeps": cycles[0] // (1 + mixed._MG_REFINE),
           "k3_rect": rect.launches}
    print(f"{tag} {label}: n_free={p.n_free} tier {p._tier}, {len(ns)} "
          f"levels, n per level {ns}; construction {ctor_s:.2f} s (basis "
          f"{p._band_basis_s:.3f} s); {cycles[0]} multilevel cycles = "
          f"{rec['fgmres_steps_2_sweeps']} FGMRES steps (every lane of a "
          f"chunk at once) over the two sweeps; K3 launches {rec['k3']} "
          f"({rect.launches} on the rectangular P / P^T), K1 {rec['k1']}",
          flush=True)
    failed = []
    try:
        rec["worst_rel_err"] = oracle_check(p, freqs, fr, peak_points(fr),
                                            label, tag=tag)
    except AssertionError as err:
        failed.append(str(err))
    diag = p.diagnoseSweep(freqs)
    rec["converged"] = int(np.sum(diag["converged"]))
    runs = [p.solveForward(freqs).cpu().numpy() for _ in range(2)]
    rec["sweeps_identical"] = bool(np.array_equal(*runs))
    print(f"{tag} {label}: diagnoseSweep converged lanes {rec['converged']}"
          f" of {N_FREQ}; two more steady sweeps identical "
          f"{rec['sweeps_identical']}", flush=True)
    if rec["converged"] != N_FREQ:
        failed.append(f"{label}: {N_FREQ - rec['converged']} lanes "
                      "unconverged")
    if not rec["sweeps_identical"]:
        failed.append(f"{label}: two steady sweeps differ")
    if rec["k1"] != 0 or rec["k3"] <= 0 or rect.launches <= 0:
        failed.append(f"{label}: launches K1 {rec['k1']}, K3 {rec['k3']}, "
                      f"rectangular {rect.launches}")
    if inverse:
        try:
            rec |= mg_inverse(p, freqs, fr, label)
        except AssertionError as err:
            failed.append(str(err))
    if failed:
        raise AssertionError(" | ".join(failed))
    return p, rec


def mg_inverse(p, freqs, fr_truth, label: str) -> dict:
    """Phase 12 (b)'s inverse half on the flat multilevel tier: one
    adjoint log_afc r + J at theta_0 = truth x START, 2 J^T r / m against
    the MSE_LOG_AFC gradient (GRAD_TOL, phase 6's check), and one
    Gauss-Newton step through ``solveInverse``."""
    import torch

    from plate_inverse_problem_tpu_torch.ops import csr_kernel

    tag = "[slice10] (b)"
    truth = np.asarray(p.parameters, np.float64)
    th0 = truth * np.asarray(START)
    rf = p.getResidualFunction(freqs, fr_truth, kind="log_afc")
    csr_kernel.reset_launches()
    with RectCount() as rect:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r, J = rf.value_and_jac(th0)
        torch.cuda.synchronize()
        rj_s = time.perf_counter() - t0
    k3_rj = csr_kernel.csr_mv_cuda.launches
    r, J = r.cpu().numpy(), J.cpu().numpy()
    g = p.getLossFunction(freqs, fr_truth, "MSE_LOG_AFC").grad(th0)
    g = g.cpu().numpy()
    rel = float(np.abs(2.0 * J.T @ r / r.size - g).max() / np.abs(g).max())
    t0 = time.perf_counter()
    res = p.solveInverse(th0, "MSE_LOG_AFC", "gn", ref_fr=(freqs, fr_truth),
                         use_scaling=True, N_steps=1, report=False,
                         log=False)
    torch.cuda.synchronize()
    gn_s = time.perf_counter() - t0
    err = (np.abs(np.asarray(res.x)) - truth) / truth
    print(f"{tag} {label}: log_afc r + J {rj_s:.3f} s (K3 {k3_rj}, "
          f"{rect.launches} rectangular); 2 J^T r / m vs the MSE_LOG_AFC "
          f"gradient max rel {rel:.3e} (tol {GRAD_TOL}); one Gauss-Newton "
          f"step {gn_s:.3f} s from loss {res.f_history[0]:.6e}, status "
          f"{res.status} (a step is taken only where the loss falls), rel "
          f"err after it {', '.join(f'{v:+.3e}' for v in err)}", flush=True)
    if not rel <= GRAD_TOL:
        raise AssertionError(f"{label}: 2 J^T r / m is {rel:.3e} from the "
                             "gradient")
    if res.status == "Stalled" or not np.all(np.isfinite(err)):
        raise AssertionError(f"{label}: the Gauss-Newton step found no "
                             f"lower loss: {res.status}, {res.x}")
    return {"rj_s": rj_s, "k3_rj": k3_rj, "jac_grad_rel": rel, "gn_s": gn_s,
            "gn_status": res.status, "gn_rel_err": [float(v) for v in err]}


def refined_splu(A, b):
    """scipy's splu solution of A x = b refined by 4 rounds whose residuals
    are computed in ``np.longdouble`` (the oracle's recipe, oracle.py): the
    solution to about f64 rounding, whatever the conditioning."""
    import scipy.sparse.linalg as spla

    lu = spla.splu(A.tocsc())
    wide = np.clongdouble if np.iscomplexobj(A.data) else np.longdouble
    Al = A.astype(wide).tocsr()
    x = lu.solve(b).astype(wide)
    for _ in range(4):
        x = x + lu.solve((b.astype(wide) - Al @ x).astype(b.dtype))
    return x.astype(b.dtype)


def sparse_api(dev) -> dict:
    """Phase 12 (c): the standalone sparse API on the bench operator A(omega)
    = K - omega^2 M + i K_im (n = 1466, the dense tier's equilibrated data
    from ``getFRCore``) at omega = 0 (K, f64) and SPARSE_FREQS (complex128):
    ``spsolve`` with SPARSE_REFINE rounds of refinement against scipy's
    splu and against the longdouble-refined splu (``refined_splu``), both
    to SPARSE_TOL (the unrefined solve's distance to splu printed: the
    card's LU is kappa * eps off); its gradient in ``data`` and ``b``
    against central differences (SPARSE_GRAD_TOL of its max);
    ``torch.func.vmap`` over 8 right-hand sides equal to 8 calls bit for
    bit; ``matvec`` and its transpose against the plain version
    (SPARSE_MV_TOL) and bit for bit in two calls.  At the resonance
    (SPARSE_PEAK_HZ) the refined solve is held to the refined splu only:
    plain splu is itself kappa * eps off there (printed).  Times the LU
    (the library call, CUDA events) beside its operation bound."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla
    import torch

    from plate_inverse_problem_tpu_torch.ops import csr_kernel
    from plate_inverse_problem_tpu_torch.ops import (
        create_symbolic, matvec, spsolve)
    from plate_inverse_problem_tpu_torch.ops.scatter import to_dense

    tag = "[slice10] (c)"
    p = sh_i_problem(dev, 1.0)
    od = p.getFRCore()[1]
    n = p.n_free
    Kr, Ki = flat_stiffness(p, od)
    rows, cols = od["rows"].cpu().numpy(), od["cols"].cpu().numpy()
    (cr, cc), pat = create_symbolic(n, np.stack([rows, cols], axis=1))
    key = cc.astype(np.int64) * n + cr
    to_canon = torch.as_tensor(
        np.argsort(np.searchsorted(key, cols.astype(np.int64) * n + rows)),
        device=dev)
    rng = np.random.default_rng(12)
    csr_kernel.reset_launches()
    out, failed = {}, []
    for f in (0.0,) + SPARSE_FREQS + (SPARSE_PEAK_HZ,):
        om2 = (2.0 * np.pi * f) ** 2
        d = Kr - om2 * od["MIn"]
        if f:
            d = torch.complex(d, Ki)
        d = d[to_canon].contiguous()
        dt = np.complex128 if f else np.float64
        A = sp.csc_matrix((d.cpu().numpy(), (cr, cc)), shape=(n, n))
        b = rng.standard_normal(n) + (1j * rng.standard_normal(n) if f else 0)
        bt = torch.as_tensor(b.astype(dt), device=dev)
        x0 = spsolve(pat, d, bt).cpu().numpy()
        x = spsolve(pat, d, bt, refine_steps=SPARSE_REFINE).cpu().numpy()
        x_ref = spla.splu(A).solve(b.astype(dt))
        x_true = refined_splu(A, b.astype(dt))

        def dist(u, v):
            return float(np.abs(u - v).max() / np.abs(v).max())

        rel, rel_true = dist(x, x_ref), dist(x, x_true)
        rec = {"solve_rel": rel, "solve_rel_refined_oracle": rel_true,
               "unrefined_rel": dist(x0, x_ref),
               "splu_rel_refined_oracle": dist(x_ref, x_true)}
        print(f"{tag} {f:g} Hz: spsolve (refine_steps={SPARSE_REFINE}) vs "
              f"splu {rel:.3e}, vs the refined splu {rel_true:.3e} (tol "
              f"{SPARSE_TOL}); unrefined vs splu {rec['unrefined_rel']:.3e}; "
              f"splu vs the refined splu {rec['splu_rel_refined_oracle']:.3e}",
              flush=True)
        if f == SPARSE_PEAK_HZ:
            out[f"{f:g}Hz"] = rec
            if not rel_true <= SPARSE_TOL:
                failed.append(f"sparse API at {f:g} Hz: {rec}")
            continue
        # the gradient of Re <w, x> in data and b vs central differences
        w = torch.as_tensor((rng.standard_normal(n)
                             + (1j * rng.standard_normal(n) if f else 0)
                             ).astype(dt), device=dev)

        def loss(dd, bb):
            return torch.real(torch.vdot(w, spsolve(pat, dd, bb)))

        dr = d.clone().requires_grad_(True)
        br = bt.clone().requires_grad_(True)
        gd, gb = torch.autograd.grad(loss(dr, br), (dr, br))
        fd_dev = []
        for arg, g, ks in ((0, gd, (0, d.numel() // 3, d.numel() - 1)),
                           (1, gb, (0, n // 2, n - 1))):
            base = (d, bt)[arg]
            for k in ks:
                for part in ((1.0, 1j) if f else (1.0,)):
                    h = 1e-6 * max(float(abs(base[k])), 1e-30)
                    e = torch.zeros_like(base)
                    e[k] = h * part
                    args_p = [d, bt]
                    args_m = [d, bt]
                    args_p[arg] = base + e
                    args_m[arg] = base - e
                    fd = (float(loss(*args_p))
                          - float(loss(*args_m))) / (2 * h)
                    gk = complex(g[k])
                    an = gk.real if part == 1.0 else gk.imag
                    fd_dev.append(abs(fd - an) / float(g.abs().max()))
        rec["grad_fd_dev"] = max(fd_dev)
        # vmap over 8 right-hand sides against 8 calls
        B8 = torch.as_tensor((rng.standard_normal((8, n))
                              + (1j * rng.standard_normal((8, n)) if f else 0)
                              ).astype(dt), device=dev)
        X8 = torch.func.vmap(lambda v: spsolve(pat, d, v))(B8)
        rec["vmap_identical"] = bool(torch.equal(
            X8, torch.stack([spsolve(pat, d, v) for v in B8])))
        # matvec and its transpose against the plain version, twice
        mv = []
        for tr in (False, True):
            y = matvec(pat, d, bt, transpose=tr)
            y_plain = matvec(pat, d.cpu(), bt.cpu(), transpose=tr)
            mv.append((float((y.cpu() - y_plain).abs().max()
                             / y_plain.abs().max()),
                       bool(torch.equal(y, matvec(pat, d, bt, transpose=tr)))))
        rec["matvec_rel"] = max(m_[0] for m_ in mv)
        rec["matvec_identical"] = all(m_[1] for m_ in mv)
        # the library call: the LU of one matrix, CUDA events
        Ad = to_dense(d, pat.plans(dev)[0].rows, pat.plans(dev)[0].cols, n)
        rec["lu_ms"] = cuda_event_ms(lambda: torch.linalg.lu_factor(Ad),
                                     reps=10)
        flops = (8.0 if f else 2.0) / 3.0 * n ** 3
        rec["lu_bound_ms"] = 1e3 * flops / F64_TC_FLOPS
        del Ad
        out[f"{f:g}Hz"] = rec
        print(f"{tag} {'K' if not f else f'{f:g} Hz'} "
              f"({'f64' if not f else 'complex128'}): gradient in data and "
              f"b vs central differences max dev / max |g| {rec['grad_fd_dev']:.3e}"
              f" (tol {SPARSE_GRAD_TOL}); vmap over 8 == 8 calls "
              f"{rec['vmap_identical']}; matvec and transpose vs plain "
              f"{rec['matvec_rel']:.3e} (tol {SPARSE_MV_TOL}), two calls "
              f"identical {rec['matvec_identical']}; LU (torch.linalg."
              f"lu_factor) {rec['lu_ms']:.3f} ms, bound "
              f"{rec['lu_bound_ms']:.3f} ms (operations: {'8' if f else '2'}/3 n^3 FLOP at 67 "
              f"TFLOP/s), {100 * rec['lu_bound_ms'] / rec['lu_ms']:.2f} % of "
              f"it", flush=True)
        if not (max(rel, rel_true) <= SPARSE_TOL
                and rec["grad_fd_dev"] <= SPARSE_GRAD_TOL
                and rec["vmap_identical"] and rec["matvec_identical"]
                and rec["matvec_rel"] <= SPARSE_MV_TOL):
            failed.append(f"sparse API at {f:g} Hz: {rec}")
    out["k3"] = csr_kernel.csr_mv_cuda.launches
    print(f"{tag} K3 launches over the sparse API's calls: {out['k3']}",
          flush=True)
    if out["k3"] <= 0:
        failed.append("the sparse API never launched K3")
    if failed:
        raise AssertionError(" | ".join(failed))
    return out


def slice10(dev, p21, arpack: dict) -> dict:
    """Phase 12 on ``dev``: (a) ``basis="lobpcg"`` at n = 1466, 11910 and
    20916 (``arpack``: the ARPACK eigenvalues and seconds of phase 7's
    plates by n; ``p21``: phase 2's 21k Problem, whose ARPACK basis is
    this call's at 20916), (b) the flat multilevel at 1466 (with the
    inverse half) and at 20916 with ``operator_layout="flat"``, (c) the
    sparse API, (d) K3 against its plain version on P and P^T of the
    20916 chain at RECT_LANES lanes (f32, as the cycle runs them).  Every
    part runs before a failed check raises."""
    import torch

    out, failed = {}, []
    arpack = dict(arpack)
    arpack[p21.n_free] = {"lam": p21._band_lam,
                          "basis_s": p21._band_basis_s}

    def run(key, fn, *args, **kw):
        try:
            out[key] = fn(*args, **kw)
        except AssertionError as err:
            failed.append(str(err))

    t0 = time.perf_counter()
    for refine, n, label in ((1.0, 1466, "n=1466 flat + dense"),
                             (3.0, 11910, "n=11910 band + dense"),
                             (4.0, 20916, "n=20916 band + two-grid")):
        run(f"lobpcg_{n}", lobpcg_tier, dev, refine, label, arpack[n],
            rr_ab=n == 20916)
        torch.cuda.empty_cache()
    out["a_s"] = time.perf_counter() - t0
    if "lobpcg_1466" in out and out["lobpcg_1466"]["k3_basis"] <= 0:
        failed.append("the flat LOBPCG basis build launched no K3")
    if "lobpcg_20916" in out and out["lobpcg_20916"]["k1_basis"] <= 0:
        failed.append("the two-grid LOBPCG basis build launched no K1")
    t0 = time.perf_counter()
    p21mg = None
    try:
        out["mg_1466"] = flat_mg(dev, 1.0, "n=1466 auto", inverse=True)[1]
    except AssertionError as err:
        failed.append(str(err))
    try:
        p21mg, out["mg_20916"] = flat_mg(dev, 4.0, "n=20916 flat",
                                         operator_layout="flat")
    except AssertionError as err:
        failed.append(str(err))
    out["b_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    run("sparse", sparse_api, dev)
    out["c_s"] = time.perf_counter() - t0
    if p21mg is None:
        p21mg = sh_i_problem(dev, 4.0, precond="mg", operator_layout="flat")
        p21mg.getFRCore()
    lv = p21mg._multilevel["levels"][0]
    rect = []
    for name, plan in (("P", lv["P_csr"]), ("P^T", lv["Pt_csr"])):
        for L in RECT_LANES:
            try:
                rect.append(compare_csr(plan, 1, L, "f32",
                                        f"21k chain {name} L={L}",
                                        seed=L, tag="[slice10] (d)"))
            except AssertionError as err:
                failed.append(str(err))
    out["rect"] = rect
    del p21mg
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError("phase 12 failed: " + " | ".join(failed))
    return out


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ab", metavar="SOURCE", action="append", default=[],
                    help="also build this version of K1 (the earlier "
                         "dense-band or the packed C interface) and time it "
                         "beside the kernel in the tree, in turns; may be "
                         "repeated")
    ap.add_argument("--ab-csr", metavar="SOURCE", action="append",
                    default=[],
                    help="also build this version of K3 (an earlier C "
                         "interface) and time it beside the kernel in the "
                         "tree at every phase 9 (a) and 13 (a) case, in "
                         "turns, requiring the same bits but on long rows; "
                         "may be repeated")
    args = ap.parse_args()

    # ---- 1. the card ------------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available()"
                         " is False); nothing was run.")
    card = card_info()
    print(card, flush=True)   # as nvidia-smi gives it: "<name>, <limit> W"
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    smoke(torch.device("cuda"), card, args.ab, args.ab_csr)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def smoke(dev, card: str, ab_sources=(), ab_csr_sources=()):
    """Phases 2-16 on ``dev``; prints the kernels' JSON record last.
    ``ab_sources`` / ``ab_csr_sources``: other versions of K1 / K3 to time
    beside them (A/B only)."""
    import torch

    from plate_inverse_problem_tpu_torch.ops import (band_kernel, csr_kernel,
                                                     fgmres_kernel)
    from plate_inverse_problem_tpu_torch.oracle import splu_frf

    # ---- 2. build the kernels, one nvcc each, all at once -----------------
    t_phases = t0 = time.perf_counter()
    with ThreadPoolExecutor(3 + len(ab_csr_sources)) as pool:
        builds = {name: pool.submit(fn) for name, fn in
                  (("band_mv.cu", band_kernel.build),
                   ("csr_mv.cu", csr_kernel.build),
                   ("fgmres_lsq.cu", fgmres_kernel.build))}
        ab_csr = [pool.submit(load_ab_csr, src) for src in ab_csr_sources]
        reports = {name: f.result() for name, f in builds.items()}
        ab_csr = [f.result() for f in ab_csr]
    print(f"[build] band_mv.cu, csr_mv.cu and fgmres_lsq.cu -> sm_90a in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for name, report in reports.items():
        for line in ptxas_summary(report):
            print(f"[build] {name}: {line}", flush=True)

    # ---- construct the 21k-DOF Problem on the card -------------------------
    t0 = time.perf_counter()
    p = sh_i_problem(dev, 4.0)
    core, od = p.getFRCore()
    torch.cuda.synchronize()
    ctor_s = time.perf_counter() - t0
    lay = p._band_layout
    print(f"[ctor] n_free={p.n_free} nnz={p.op.pattern.nnz} b={lay.b} "
          f"nb={lay.nb} bandwidth={lay.bandwidth} n_c={p._mg_rl.n_coarse} "
          f"m={od['W64'].shape[1]}  construction {ctor_s:.2f} s (host "
          "assembly, ARPACK basis, coarse splu, transfers; of which the "
          f"coarse level's host splu inverse {p._coarse_inv_s:.3f} s, the "
          f"ARPACK basis {p._band_basis_s:.3f} s)", flush=True)

    pack = p._band_pack
    nnz = int((pack.vals != 0).sum())
    pack_mb = sum(t.numel() * t.element_size()
                  for t in (pack.vals, pack.col0, pack.row_ptr)) / 1e6
    print(f"[pack] tile {pack.tile[0]}x{pack.tile[1]}: {pack.vals.shape[0]} "
          f"tiles of {pack.n_row_tiles} row tiles, {pack_mb:.2f} MB packed, "
          f"{nnz} numeric nonzeros; built once in getFRCore in "
          f"{1e3 * p._pack_build_s:.1f} ms (part of construction)", flush=True)
    print("[ctor] MB of the entries a dof mesh partitions (a rank holds its "
          "rows or block rows, about 1/d of each): "
          + ", ".join(f"{k} {od[k].numel() * od[k].element_size() / 1e6:.2f}"
                      for k in ("W64", "mg_band0", "mg_Pt", "mg_dinv",
                                "mg_Kcinv"))
          + f", the K1 pack {pack_mb:.2f}", flush=True)

    # ---- 3. kernel vs plain version on the card ----------------------------
    ab = [load_ab_kernel(src) for src in ab_sources]
    chunk = p._auto_freq_chunk() or N_FREQ
    rng = np.random.default_rng(0)
    x = torch.as_tensor(
        rng.standard_normal((chunk, 2, p.n_free)).astype(np.float32),
        device=dev).reshape(2 * chunk, p.n_free)
    recs = {B: compare_kernel(pack, od["mg_band0"], x[:B].contiguous(), lay,
                              "slice (21k K_ref band, f32)", ab)
            for B in (2 * chunk, 16, 2)}
    slice_rec = recs[2 * chunk]
    bound, bound_by = bound_ms(pack, 2 * chunk, p.n_free)
    print(f"[bound] slice B={2 * chunk}: {1e3 * bound:.2f} us ({bound_by}: "
          f"{nnz} nonzeros x 8 B + x + y at 3.35 TB/s, 2 FLOP a nonzero and "
          f"lane at 67 TFLOP/s); kernel at {100 * bound / slice_rec['ms']:.1f}"
          " % of it", flush=True)
    b64 = compare_kernel(*synthetic_b64(dev), "synthetic b=64", ab)
    windows = compare_windows(pack, od["mg_band0"], x[:2 * chunk].contiguous(),
                              lay)

    # ---- 4. the 512-point sweep through the main path ---------------------
    freqs = np.linspace(40.0, 600.0, N_FREQ)
    torch.cuda.reset_peak_memory_stats()
    band_kernel.band_mv_f32_cuda.launches = 0
    csr_kernel.reset_launches()
    fgmres_kernel.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fr = p.solveForward(freqs)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    launches = band_kernel.band_mv_f32_cuda.launches
    k7_sweep = k7_counts()
    k3_sweep = csr_kernel.csr_mv_cuda.launches
    k3_sweep_regimes = dict(csr_kernel.csr_mv_cuda.launches_by_regime)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # the same sweep again: what every later sweep of a process costs
    t0 = time.perf_counter()
    p.solveForward(freqs)
    torch.cuda.synchronize()
    steady_s = time.perf_counter() - t0
    fr = fr.cpu().numpy()
    print(f"[sweep] {N_FREQ} points over 40-600 Hz: first {sweep_s:.3f} s "
          f"({N_FREQ / sweep_s:.1f} solves/s), steady {steady_s:.3f} s "
          f"({N_FREQ / steady_s:.1f} solves/s); freq_chunk={chunk}, "
          f"band kernel launches={launches}, K3 {k3_sweep}, K7a / K7b "
          f"{k7_sweep['givens_step']} / {k7_sweep['backsub']}, peak device "
          f"memory {peak_gb:.2f} GB", flush=True)
    if launches <= 0:
        raise AssertionError("the sweep never launched the band kernel")
    if fault := k7_fault(k7_sweep, "the 21k sweep"):
        raise AssertionError(fault)
    if fr.shape != (N_FREQ,) or not np.all(np.isfinite(fr)):
        raise AssertionError(f"bad FRF: shape {fr.shape}, "
                             f"finite={np.all(np.isfinite(fr))}")

    # ---- 5. host f64 splu oracle at 4 points including the peak -----------
    idx = peak_points(fr)
    ipk = idx[1]
    ref = splu_frf(p, freqs[idx])
    rel = np.abs(fr[idx] - ref) / np.abs(ref)
    for i, r in zip(idx, rel):
        print(f"[oracle] f={freqs[i]:8.3f} Hz  rel err {r:.3e}"
              f"{'  <-- peak' if i == ipk else ''}", flush=True)
    worst = float(rel.max())
    print(f"[oracle] worst rel err vs f64 splu (4 pts incl. peak): "
          f"{worst:.3e}", flush=True)
    if not worst <= ORACLE_TOL:
        raise AssertionError(f"worst rel err {worst:.3e} > {ORACLE_TOL}")

    inv = inverse_half(p, freqs, fr, grad_tol=GRAD_TOL_21K)
    arpack = {}
    dense = dense_tier(dev, arpack)
    kept = {}
    fam = families(dev, kept)
    s6 = slice6(dev, p, freqs, fr, ab_csr)
    summary_s = time.perf_counter() - t_phases
    print(f"[time] phases 2-9 in {summary_s:.1f} s", flush=True)
    # phases 10 and 11 both run before a failed check of either raises
    failed = []
    try:
        s8 = slice8(dev, p, freqs, fr, kept["d4"])
        # phase 15 (c) holds the blocked adjoint J against this fwd J
        kept["d4_fwd"] = s8["fwd_d4"].pop("rj")
    except AssertionError as err:
        failed.append(str(err))
    t11 = time.perf_counter()
    try:
        eng = engines(dev)
    except AssertionError as err:
        failed.append(str(err))
    eng_s = time.perf_counter() - t11
    print(f"[time] phase 11 in {eng_s:.1f} s", flush=True)
    t12 = time.perf_counter()
    try:
        s10 = slice10(dev, p, arpack)
    except AssertionError as err:
        failed.append(str(err))
    s10_s = time.perf_counter() - t12
    print(f"[time] phase 12 in {s10_s:.1f} s", flush=True)
    t13 = time.perf_counter()
    try:
        s11 = slice11(dev, p, freqs, fr, ab_csr)
    except AssertionError as err:
        failed.append(str(err))
    s11_s = time.perf_counter() - t13
    print(f"[time] phase 13 in {s11_s:.1f} s", flush=True)
    if failed:
        raise AssertionError(" || ".join(failed))
    t14 = time.perf_counter()
    s12 = slice12(dev, p21=p)
    s12_s = time.perf_counter() - t14
    print(f"[time] phase 14 in {s12_s:.1f} s", flush=True)
    t15 = time.perf_counter()
    s17 = slice17(dev, kept)
    kept.clear()
    s17_s = time.perf_counter() - t15
    print(f"[time] phase 15 in {s17_s:.1f} s", flush=True)
    t16 = time.perf_counter()
    s18 = slice18(dev, p, s11["trace"], inv, dense["bench_inverse"])
    s18_s = time.perf_counter() - t16
    print(f"[time] phase 16 in {s18_s:.1f} s", flush=True)
    census = {"bench_sweep": dense["bench"]["k3_by_regime"],
              "sweep_21k": k3_sweep_regimes,
              "rj_21k": inv["k3_rj_by_regime"],
              "grad_21k": inv["k3_grad_by_regime"],
              "rj_1466": dense["bench_inverse"]["k3_rj_by_regime"],
              "grad_1466": dense["bench_inverse"]["k3_grad_by_regime"]}
    print("[k3] launches by regime (L1: one lane, narrow: 2-31 lanes, wide: "
          "32 or more): " + "; ".join(f"{k} {v}" for k, v in census.items()),
          flush=True)

    summary = {"card": card, "n_free": p.n_free, "ctor_s": ctor_s,
               "pack_build_ms": 1e3 * p._pack_build_s,
               "pack_tiles": pack.vals.shape[0], "pack_mb": pack_mb,
               "sweep_first_s": sweep_s, "sweep_steady_s": steady_s,
               "solves_per_s_steady": N_FREQ / steady_s,
               "peak_mem_gb": peak_gb, "worst_rel_err": worst,
               "f_peak": float(freqs[ipk]), "k1_by_B": recs, "k1_b64": b64,
               "k1_windows": windows,
               **inv, "dense": dense, "families": fam,
               "slice6": {k: v for k, v in s6.items() if k != "k3"},
               "slice8": {k: v for k, v in s8.items()
                          if k not in ("k1", "k3")},
               "engines": {k: v for k, v in eng.items() if k != "k3"},
               "slice10": s10,
               "slice11": {k: v for k, v in s11.items()
                           if k not in ("k1", "k3")},
               "slice12": {k: v for k, v in s12.items()
                           if k not in ("k1", "k3")},
               "slice17": {k: v for k, v in s17.items()
                           if k not in ("k1", "k3")},
               "slice18": s18}
    summary["phases_s"] = time.perf_counter() - t_phases
    summary["phases_2_9_s"] = summary_s
    summary["phase_11_s"] = eng_s
    summary["phase_12_s"] = s10_s
    summary["phase_13_s"] = s11_s
    summary["phase_14_s"] = s12_s
    summary["phase_15_s"] = s17_s
    summary["phase_16_s"] = s18_s
    s8_s = (summary["phases_s"] - summary_s - eng_s - s10_s - s11_s - s12_s
            - s17_s - s18_s)
    print(f"[time] phases 2-16 in {summary['phases_s']:.1f} s (phase 10: "
          f"{s8_s:.1f} s, phase 11: {eng_s:.1f} s, phase 12: {s10_s:.1f} s, "
          f"phase 13: {s11_s:.1f} s, phase 14: {s12_s:.1f} s, phase 15: "
          f"{s17_s:.1f} s, phase 16: {s18_s:.1f} s)", flush=True)
    k3_paths = {"sweep_21k": k3_sweep, "rj_21k": inv["k3_rj"],
                "grad_21k": inv["k3_grad"],
                "dense_sweep_1466": dense["bench"]["k3"],
                "rj_1466": dense["bench_inverse"]["k3_rj"],
                "grad_1466": dense["bench_inverse"]["k3_grad"],
                **s6["k3"]["by_path"], **s8["k3"], **eng["k3"],
                "lobpcg_basis_1466": s10["lobpcg_1466"]["k3_basis"],
                "mg_flat_sweeps_1466": s10["mg_1466"]["k3"],
                "mg_flat_rect_1466": s10["mg_1466"]["k3_rect"],
                "mg_flat_rj_1466": s10["mg_1466"]["k3_rj"],
                "mg_flat_sweeps_21k": s10["mg_20916"]["k3"],
                "mg_flat_rect_21k": s10["mg_20916"]["k3_rect"],
                "sparse_api": s10["sparse"]["k3"],
                **s11["k3"], **s12["k3"], **s17["k3"]}
    if not all(v > 0 for v in k3_paths.values()):
        raise AssertionError(f"K3 launched no time on a path: {k3_paths}")
    print(f"[summary] {json.dumps(summary)}", flush=True)
    print(json.dumps({"kernels": [{
        "name": "band_mv_f32",
        "route": "cuda",
        "source": "plate_inverse_problem_tpu_torch/csrc/band_mv.cu",
        "replaces": "plate_inverse_problem_tpu/ops/pallas_band.py:75",
        "launches": launches,
        "launches_by_path": {"sweep": launches,
                             "rj_primal": inv["k1_rj_primal"],
                             "rj_adjoint": inv["k1_rj_adjoint"],
                             "gn": inv["k1_gn"],
                             **dense["k1"], **fam["k1"], **s8["k1"],
                             "lobpcg_basis_21k":
                                 s10["lobpcg_20916"]["k1_basis"],
                             "mg_flat_sweeps_1466": s10["mg_1466"]["k1"],
                             "mg_flat_sweeps_21k": s10["mg_20916"]["k1"],
                             **s11["k1"], **s12["k1"], **s17["k1"]},
        "max_abs_err": slice_rec["max_abs_err"],
        "ms": slice_rec["ms"],
        "plain_ms": slice_rec["plain_ms"],
        "bound_ms": bound,
        "bound_by": bound_by,
        "library_ms": slice_rec["library_ms"],
        "scale_104k": {k: s17["b"]["k1_kernel"][k] for k in (
            "B", "max_abs_err", "ms", "flushed_ms", "plain_ms", "library_ms",
            "bound_ms", "bound_by")},
    }, {
        "name": "csr_mv",
        "route": "cuda",
        "source": "plate_inverse_problem_tpu_torch/csrc/csr_mv.cu",
        "replaces": "plate_inverse_problem_tpu/ops/mixed.py:651 (not Pallas)",
        "launches": s6["k3"]["launches"],
        "launches_by_path": k3_paths | {
            "direct_sweep_1466": eng["k3_direct_sweep_1466"]},
        "launches_by_regime": census,
        "data_grad": s8["data_grad"],
        "rectangular": [{k: r[k] for k in (
            "label", "n", "n_cols", "nnz", "L", "dtype", "max_abs_err", "ms",
            "flushed_ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}
            for r in s10["rect"]],
        "long_rows": [{k: r[k] for k in (
            "label", "n", "nnz", "n_long", "S", "L", "dtype", "max_abs_err",
            "rel_err", "ms", "flushed_ms", "plain_ms", "library_ms",
            "bound_ms", "bound_by", "long_launches")}
            for r in s11["long_rows"]["cases"]],
        "scale_104k": [{k: r[k] for k in (
            "label", "n", "nnz", "S", "L", "dtype", "max_abs_err", "ms",
            "flushed_ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}
            for r in (s17["b"]["k3_kernel"],)] + [s17["b"]["k3_wide"]],
        **{k: s6["k3"]["headline"][k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")},
    }] + [{
        "name": name,
        "route": "cuda",
        "source": K7_SOURCE,
        "replaces": K7_REPLACES[name],
        "launches": k7_sweep[name],
        "launches_by_path": {k: v[name] for k, v in s18["paths"].items()},
        "max_abs_err": max(b["max_abs_err"] for b in s18["bits"].values()),
        "calls_replayed": {k: b[name] for k, b in s18["bits"].items()},
        **{k: s18["kernels"][f"{name}_21k"][k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "L",
            "k", "bucket", "host_ms")},
        "bench": {k: s18["kernels"][f"{name}_bench"][k] for k in (
            "L", "k", "bucket", "ms", "host_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")},
        "build": {kp: s18["build"].get(f"{name}_kernel<{kp}>")
                  for kp in (8, 16, 32, 64)},
    } for name in ("givens_step", "backsub")]}), flush=True)


def sh_i_problem(dev, refine: float, mat=None, accel: bool = True, **kw):
    """``sh_i`` strip 100 x 20 x 2 mm, AP1030 (bench.py's plate at refine =
    1), on ``dev``: isotropic steel unless ``mat`` is given; ``accel=False``
    leaves the accelerometer out of the Problem (the pure-bending path of a
    mid-plane symmetric material)."""
    import plate_inverse_problem_tpu_torch as pt

    acc = pt.Accelerometer("AP1030")
    if mat is None:
        mat = pt.get_material(7920.0, "isotropic", E=200e9, G=75e9,
                              beta=0.003)
    geom = pt.Geometry("sh_i", acc,
                       pt.GeometryParams(100e-3, 20e-3, 2e-3, None, None),
                       refine=refine)
    return pt.Problem(geom, mat, acc if accel else None, device=dev, **kw)


def timed_sweeps(p, freqs, label: str, tag: str = "[dense]") -> dict:
    """A first and a steady sweep, synchronised, with the peak device memory
    of the first and K1's launches over both; prints one ``tag`` line."""
    import torch

    from plate_inverse_problem_tpu_torch.ops import band_kernel, csr_kernel

    band_kernel.band_mv_f32_cuda.launches = 0
    csr_kernel.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fr = p.solveForward(freqs)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if len(times) == 1:
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
    fr = fr.cpu().numpy()
    rec = {"sweep_first_s": times[0], "sweep_steady_s": times[1],
           "solves_per_s_steady": freqs.size / times[1],
           "peak_mem_gb": peak_gb,
           "k1": band_kernel.band_mv_f32_cuda.launches,
           "k3": csr_kernel.csr_mv_cuda.launches,
           "k3_by_regime": dict(csr_kernel.csr_mv_cuda.launches_by_regime)}
    print(f"{tag} {label}: {freqs.size} points over 40-600 Hz: first "
          f"{times[0]:.3f} s ({freqs.size / times[0]:.1f} solves/s), steady "
          f"{times[1]:.3f} s ({rec['solves_per_s_steady']:.1f} solves/s); "
          f"peak device memory {peak_gb:.2f} GB; K1 launches {rec['k1']}, "
          f"K3 {rec['k3']}", flush=True)
    if fr.shape != freqs.shape or not np.all(np.isfinite(fr)):
        raise AssertionError(f"{label}: bad FRF: shape {fr.shape}, "
                             f"finite={np.all(np.isfinite(fr))}")
    return rec | {"fr": fr}


def peak_points(fr) -> list[int]:
    """bench.py's four points of a 512-point sweep: 3, the |FRF| peak, 256
    and 511 (of F points: 3, the peak, F / 2, F - 1)."""
    F = np.asarray(fr).shape[0]
    return [3, int(np.argmax(np.abs(fr))), F // 2, F - 1]


def oracle_check(p, freqs, fr, idx, label: str, tag: str = "[dense]"
                 ) -> float:
    """Worst relative error of ``fr`` (real or complex) at ``idx`` against
    the host f64 splu oracle; prints it and raises above ORACLE_TOL."""
    from plate_inverse_problem_tpu_torch.oracle import splu_frf

    ref = splu_frf(p, freqs[idx])
    rel = np.abs(fr[idx] - ref) / np.abs(ref)
    worst = float(rel.max())
    print(f"{tag} {label}: rel err vs f64 splu at "
          + ", ".join(f"{freqs[i]:.3f} Hz {r:.3e}" for i, r in zip(idx, rel))
          + f"; worst {worst:.3e} (tol {ORACLE_TOL})", flush=True)
    if not worst <= ORACLE_TOL:
        raise AssertionError(f"{label}: worst rel err {worst:.3e} > "
                             f"{ORACLE_TOL}")
    return worst


def construct(dev, refine: float, label: str, tag: str = "[dense]", **kw):
    """Build a Problem (``sh_i_problem`` keywords) and its core on ``dev``;
    print its ctor line: the dense f64 inverse's build time, or the
    two-grid's coarse size and K1 pack, is part of the construction."""
    import torch

    t0 = time.perf_counter()
    p = sh_i_problem(dev, refine, **kw)
    od = p.getFRCore()[1]
    torch.cuda.synchronize()
    ctor_s = time.perf_counter() - t0
    lay = p._band_layout
    rec = {"n_free": p.n_free, "nnz": int(p.op.pattern.nnz),
           "tier": list(p._tier), "ctor_s": ctor_s,
           "basis_s": p._band_basis_s}
    if "invK64" in od:
        inv = od["invK64"]
        rec |= {"inv_build_s": p._inv_build_s,
                "inv_mb": inv.numel() * inv.element_size() / 1e6}
        part = (f"the dense f64 inverse (inv_refined, {rec['inv_mb']:.0f} "
                f"MB) {p._inv_build_s:.3f} s")
    else:
        rec |= {"n_c": p._mg_rl.n_coarse,
                "pack_tiles": p._band_pack.vals.shape[0],
                "pack_build_ms": 1e3 * p._pack_build_s,
                "coarse_inv_s": getattr(p, "_coarse_inv_s", None)}
        part = (f"the two-grid's coarse level n_c={rec['n_c']} (its host "
                f"splu inverse {rec['coarse_inv_s'] or 0.0:.3f} s) and the "
                f"K1 pack ({rec['pack_tiles']} tiles, "
                f"{rec['pack_build_ms']:.1f} ms)")
    rec["build_s"] = dict(p._build_s)
    print(f"{tag} {label}: n_free={p.n_free} nnz={p.op.pattern.nnz} "
          f"tier {p._tier} (layout, preconditioner, f32 Krylov basis)"
          + ("" if lay is None else f", b={lay.b} nb={lay.nb}")
          + f", m={od['W64'].shape[1]}; construction {ctor_s:.2f} s, of "
          f"which {part}, the {p._basis_resolved} basis "
          f"{p._band_basis_s:.3f} s; host parts (s): "
          + ", ".join(f"{k} {v:.3f}" for k, v in p._build_s.items()),
          flush=True)
    return p, rec


def dense_tier(dev, keep=None) -> dict:
    """Phase 7: the dense-preconditioner tier at n = 1466 (the bench
    configuration, forward and inverse) and n = 11910 (its largest plate).
    Returns the numbers for [summary], K1's zero counts under "k1";
    ``keep`` (a dict) receives each plate's ARPACK eigenvalues and basis
    seconds under its n, for phase 12 (a)."""
    import plate_inverse_problem_tpu_torch as pt

    freqs = np.linspace(40.0, 600.0, N_FREQ)
    out = {}
    # ---- (a) the bench configuration -------------------------------------
    p, rec = construct(dev, 1.0, "(a) bench sh_i refine=1")
    if keep is not None:
        keep[p.n_free] = {"lam": p._band_lam, "basis_s": p._band_basis_s}
    if p._tier != ("flat", "dense", False):
        raise AssertionError(f"'auto' at n={p.n_free} resolved to {p._tier},"
                             " not the flat layout, the dense "
                             "preconditioner and an f64 basis")
    rec |= timed_sweeps(p, freqs, "(a) bench sweep")
    fr = rec.pop("fr")
    checksum = float(np.abs(fr).sum())
    cs_rel = abs(checksum - BENCH_CHECKSUM) / BENCH_CHECKSUM
    print(f"[dense] (a) FRF checksum sum |FRF| = {checksum!r} against the JAX "
          f"CPU run's {BENCH_CHECKSUM!r}: rel {cs_rel:.3e} (tol "
          f"{CHECKSUM_TOL})", flush=True)
    if not cs_rel <= CHECKSUM_TOL:
        raise AssertionError(f"bench checksum {checksum} is {cs_rel:.3e} from"
                             f" {BENCH_CHECKSUM}")
    # bench.py's four points (bench.py:261)
    idx = peak_points(fr)
    rec["worst_rel_err"] = oracle_check(p, freqs, fr, idx,
                                        "(a) bench points")
    rec["checksum"] = checksum
    rec["k5"] = k5_blocked(p, "(a) bench")
    # the same Problem data with the JAX package's f32 Krylov basis
    q = pt.Problem(p.geometry, p.material, p.accelerometer, device=dev,
                   basis_f32=True, opdata=p.getFRCore()[1])
    f32 = timed_sweeps(q, freqs, "(a) bench sweep, basis_f32=True")
    rec["basis_f32"] = {k: f32[k] for k in ("sweep_steady_s",
                                           "solves_per_s_steady", "k1")}
    rec["basis_f32"]["worst_rel_err"] = oracle_check(
        q, freqs, f32["fr"], idx, "(a) bench points, basis_f32=True")
    del q
    out["bench"] = rec

    # ---- (b) the inverse half on the bench Problem ------------------------
    out["bench_inverse"] = inverse_half(p, freqs, fr, k1=False,
                                        tag="[dense] (b) ")
    del p

    # ---- (c) the largest dense-tier plate --------------------------------
    p, rec = construct(dev, 3.0, "(c) sh_i refine=3")
    if keep is not None:
        keep[p.n_free] = {"lam": p._band_lam, "basis_s": p._band_basis_s}
    if p._tier != ("band", "dense", False):
        raise AssertionError(f"'auto' at n={p.n_free} resolved to {p._tier},"
                             " not the band layout with the dense "
                             "preconditioner")
    rec |= timed_sweeps(p, freqs, "(c) sweep")
    fr = rec.pop("fr")
    idx = peak_points(fr)
    rec["worst_rel_err"] = oracle_check(p, freqs, fr, idx,
                                        "(c) 4 points incl. the peak")
    rec["f_peak"] = float(freqs[idx[1]])
    rec["k5"] = k5_blocked(p, "(c)")
    out["largest"] = rec
    del p

    inv = out["bench_inverse"]
    out["k1"] = {"dense_sweep_1466": out["bench"]["k1"],
                 "dense_sweep_1466_basis_f32": out["bench"]["basis_f32"]["k1"],
                 "dense_rj_primal_1466": inv["k1_rj_primal"],
                 "dense_rj_adjoint_1466": inv["k1_rj_adjoint"],
                 "dense_gn_1466": inv["k1_gn"],
                 "dense_sweep_11910": out["largest"]["k1"]}
    if any(out["k1"].values()):
        raise AssertionError(f"K1 launched on the dense tier: {out['k1']}")
    return out


def k7_counts() -> dict:
    """K7a's and K7b's launches since their counters were last reset, and
    their plain versions' calls on CUDA tensors (the main path makes
    none)."""
    from plate_inverse_problem_tpu_torch.ops import fgmres_kernel as fk

    return {"givens_step": fk.givens_step_cuda.launches,
            "backsub": fk.backsub_cuda.launches,
            "plain_on_cuda": (fk.givens_step_reference.cuda_calls
                              + fk.backsub_reference.cuda_calls)}


def k7_fault(counts: dict, what: str) -> str | None:
    """Why ``counts`` (``k7_counts``) fails the path ``what``: K7a or K7b
    never launched, or a plain version ran on the card; None if it holds."""
    if (counts["givens_step"] <= 0 or counts["backsub"] <= 0
            or counts["plain_on_cuda"] != 0):
        return f"{what}: K7a / K7b launches and plain calls {counts}"
    return None


def launch_counter(fn, counts, key):
    """``fn`` with K1's launches inside each call added to counts[key]."""
    from plate_inverse_problem_tpu_torch.ops import band_kernel

    def run(*a):
        n0 = band_kernel.band_mv_f32_cuda.launches
        out = fn(*a)
        counts[key] += band_kernel.band_mv_f32_cuda.launches - n0
        return out

    return run


def inverse_half(p, freqs, fr_truth, k1: bool = True, tag: str = "",
                 grad_tol: float = GRAD_TOL) -> dict:
    """Phase 6 on the Problem of phases 4-5 (and on the dense tier's in
    phase 7): the adjoint r + J, its checks and Gauss-Newton from theta_0.
    ``k1``: the tier runs the two-grid, so K1 must launch in both sweeps
    and in GN; else it must not launch at all.  ``tag`` prefixes the
    printed lines; ``grad_tol`` bounds 2 J^T r / m against the gradient.
    Returns the numbers for [summary]."""
    import torch

    from plate_inverse_problem_tpu_torch.ops import (band_kernel, csr_kernel,
                                                     fgmres_kernel)

    truth = np.asarray(p.parameters, np.float64)
    th0 = truth * np.asarray(START)
    core = p.getFRCore()[0]
    rf = p.getResidualFunction(freqs, fr_truth, kind="log_afc")

    # ---- [adjoint] one r + J, first and steady, K1 launches per sweep ----
    counts = {"primal": 0, "adjoint": 0}
    hooks = core.sweep_u, core.sweep_adj
    core.sweep_u = launch_counter(hooks[0], counts, "primal")
    core.sweep_adj = launch_counter(hooks[1], counts, "adjoint")
    times = []
    torch.cuda.reset_peak_memory_stats()
    try:
        for _ in range(2):
            counts.update(primal=0, adjoint=0)
            band_kernel.band_mv_f32_cuda.launches = 0
            csr_kernel.reset_launches()
            fgmres_kernel.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r, J = rf.value_and_jac(th0)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            total = band_kernel.band_mv_f32_cuda.launches
            k3_rj = csr_kernel.csr_mv_cuda.launches
            k3_rj_regimes = dict(csr_kernel.csr_mv_cuda.launches_by_regime)
            k7_rj = k7_counts()
    finally:
        core.sweep_u, core.sweep_adj = hooks
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    r, J = r.cpu().numpy(), J.cpu().numpy()
    print(f"{tag}[adjoint] log_afc r + J at theta_0 = truth x {START}, "
          f"{freqs.size} points: first {times[0]:.3f} s, steady "
          f"{times[1]:.3f} s; K1 launches {counts['primal']} in the primal "
          f"sweep, {counts['adjoint']} in the adjoint sweep ({total} in "
          f"all), K3 {k3_rj}, K7a / K7b {k7_rj['givens_step']} / "
          f"{k7_rj['backsub']}; peak device memory {peak_gb:.2f} GB",
          flush=True)
    # every check of the phase runs after all of its measurements
    failed = []
    if fault := k7_fault(k7_rj, "r + J"):
        failed.append(fault)
    if k1 and (counts["primal"] <= 0 or counts["adjoint"] <= 0):
        failed.append(f"K1 not launched in both sweeps: {counts}")
    if not k1 and total != 0:
        failed.append(f"K1 launched {total} times on a tier without it")
    if total != counts["primal"] + counts["adjoint"]:
        failed.append(f"K1 launched outside the sweeps: {total} vs {counts}")
    if k3_rj <= 0:
        failed.append("r + J never launched K3")
    if r.shape != (freqs.size,) or J.shape != (freqs.size, truth.size) \
            or not (np.all(np.isfinite(r)) and np.all(np.isfinite(J))):
        raise AssertionError(f"bad r {r.shape} or J {J.shape}")

    # ---- [jac] (a) against the loss gradient, (b) against differences ---
    loss = p.getLossFunction(freqs, fr_truth, "MSE_LOG_AFC")
    csr_kernel.reset_launches()
    t0 = time.perf_counter()
    g = loss.grad(th0).cpu().numpy()
    grad_s = time.perf_counter() - t0
    k3_grad = csr_kernel.csr_mv_cuda.launches
    k3_grad_regimes = dict(csr_kernel.csr_mv_cuda.launches_by_regime)
    g2 = loss.grad(th0).cpu().numpy()      # the same call again: its noise
    g_gn = 2.0 * J.T @ r / r.size
    grad_rel = float(np.abs(g_gn - g).max() / np.abs(g).max())
    grad_rerun = float(np.abs(g2 - g).max() / np.abs(g).max())
    print(f"{tag}[jac] (a) 2 J^T r / m vs MSE_LOG_AFC grad ({grad_s:.3f} s, "
          f"K3 {k3_grad}): max rel {grad_rel:.3e} (tol {grad_tol}); two grad "
          f"calls differ by {grad_rerun:.3e}", flush=True)

    def fd_dev(j, step):
        e = np.zeros(truth.size)
        e[j] = step * th0[j]
        fd = (rf(th0 + e) - rf(th0 - e)).cpu().numpy() / (2.0 * e[j])
        return float(np.abs(fd - J[:, j]).max() / np.abs(J[:, j]).max())

    fd_rel = [fd_dev(j, step) for j, step in enumerate(FD_STEPS)]
    fd_beta_1e4 = fd_dev(truth.size - 1, 1e-4)
    print(f"{tag}[jac] (b) J columns vs central differences at relative steps "
          f"{FD_STEPS}: max dev / column max "
          f"{', '.join(f'{x:.3e}' for x in fd_rel)} (tol {FD_TOL}); the beta "
          f"column at step 1e-4: {fd_beta_1e4:.3e}", flush=True)
    if not grad_rel <= grad_tol:
        failed.append(f"2 J^T r / m disagrees with the loss gradient: "
                      f"{grad_rel:.3e} > {grad_tol}")
    if k3_grad <= 0:
        failed.append("the loss gradient never launched K3")
    if not max(fd_rel) <= FD_TOL:
        failed.append(f"J disagrees with central differences: {fd_rel} > "
                      f"{FD_TOL}")
    # ---- [gn] Gauss-Newton through solveInverse --------------------------
    stamps = []
    make = p.getResidualFunction

    def timed_residuals(*a, **k):
        res_fn = make(*a, **k)
        vj = res_fn.value_and_jac

        def value_and_jac(x):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
            return vj(x)

        res_fn.value_and_jac = value_and_jac
        return res_fn

    p.getResidualFunction = timed_residuals
    band_kernel.band_mv_f32_cuda.launches = 0
    fgmres_kernel.reset_launches()
    try:
        res = p.solveInverse(th0, "MSE_LOG_AFC", "gn",
                             ref_fr=(freqs, fr_truth), use_scaling=True,
                             N_steps=GN_STEPS, report=False, log=False)
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
    finally:
        del p.getResidualFunction
    k1_gn = band_kernel.band_mv_f32_cuda.launches
    k7_gn = k7_counts()
    iter_s = list(np.diff(stamps))
    for k, (f, x, s) in enumerate(zip(res.f_history, res.x_history, iter_s)):
        x = np.asarray(x) * th0
        print(f"{tag}[gn] iterate {k}: loss {f:.6e}  {s:.3f} s  rel err "
              f"{', '.join(f'{v:+.3e}' for v in (x - truth) / truth)}",
              flush=True)
    err = (np.abs(res.x) - truth) / truth
    print(f"{tag}[gn] {len(res.f_history)} iterations in {sum(iter_s):.3f} s "
          f"({np.mean(iter_s):.3f} s/iter), status {res.status}, K1 "
          f"launches {k1_gn}, K7a / K7b {k7_gn['givens_step']} / "
          f"{k7_gn['backsub']}; result rel err (|beta|) "
          f"{', '.join(f'{v:+.3e}' for v in err)} (tol {GN_TOL})", flush=True)
    if k1 and k1_gn <= 0:
        failed.append("Gauss-Newton never launched the band kernel")
    if fault := k7_fault(k7_gn, "Gauss-Newton"):
        failed.append(fault)
    if not k1 and k1_gn != 0:
        failed.append(f"Gauss-Newton launched K1 {k1_gn} times on a tier "
                      "without it")
    if not np.all(np.diff(res.f_history) < 0):
        failed.append(f"loss did not fall at every step: {res.f_history}")
    if not np.all(np.abs(err) <= GN_TOL):
        failed.append(f"GN result {res.x} is not within {GN_TOL} of the "
                      f"truth {truth}")
    if failed:
        raise AssertionError(f"{tag or 'phase 6 '}failed: "
                             + "; ".join(failed))
    return {"rj_first_s": times[0], "rj_steady_s": times[1],
            "k1_rj_primal": counts["primal"],
            "k1_rj_adjoint": counts["adjoint"], "rj_peak_mem_gb": peak_gb,
            "k3_rj": k3_rj, "k3_grad": k3_grad,
            "k3_rj_by_regime": k3_rj_regimes,
            "k3_grad_by_regime": k3_grad_regimes,
            "grad_s": grad_s, "jac_grad_rel": grad_rel,
            "grad_rerun_rel": grad_rerun, "jac_fd_rel": fd_rel,
            "jac_fd_beta_step_1e-4": fd_beta_1e4,
            "gn_f_history": [float(f) for f in res.f_history],
            "gn_iter_s": iter_s, "gn_s_per_iter": float(np.mean(iter_s)),
            "gn_status": res.status, "gn_rel_err": [float(v) for v in err],
            "k1_gn": k1_gn, "k7_rj": k7_rj, "k7_gn": k7_gn}


def families(dev, keep=None) -> dict:
    """Phase 8: the material families and the pure-bending path, (a) the
    multi-cut orthotropic identification at n = 1466, (b) per-modulus loss
    factors at n = 20916, (c) the pure-bending path at n = 956 and 13862.
    Returns the numbers for [summary], K1's counts by path under "k1";
    ``keep`` (a dict) receives (b)'s Problem for phase 10."""
    out = {"joint": joint_identification(dev), "d4": per_modulus(dev, keep),
           "symm": pure_bending(dev)}
    d4, symm = out["d4"], out["symm"]
    out["k1"] = {"families_joint_gn": out["joint"]["k1"],
                 "families_sol_0_45_sweep": out["joint"]["sol_0_45"]["k1"],
                 f"families_d4_sweep_{d4['n_free']}": d4["k1"],
                 f"families_d4_rj_primal_{d4['n_free']}": d4["k1_rj_primal"],
                 f"families_d4_rj_adjoint_{d4['n_free']}":
                     d4["k1_rj_adjoint"],
                 **{f"families_symm_sweep_{r['n_free']}": r["k1"]
                    for r in symm.values()}}
    return out


def joint_identification(dev) -> dict:
    """Phase 8 (a): examples/joint_identification.py on the bench plate,
    then a non-palindromic SOL stack against splu."""
    import torch

    import plate_inverse_problem_tpu_torch as pt
    from plate_inverse_problem_tpu_torch.ops import band_kernel

    tag = "[families] (a)"
    freqs = np.linspace(40.0, 600.0, N_FREQ)
    truth = np.asarray(JOINT_TRUE)

    def sol(angles):
        return pt.get_material(1550.0, "sol", angles=angles, E1=truth[0],
                               E2=truth[1], G12=truth[2], nu12=truth[3],
                               beta=truth[4])

    band_kernel.band_mv_f32_cuda.launches = 0
    t0 = time.perf_counter()
    problems = [sh_i_problem(dev, 1.0, mat=sol((a,))) for a in JOINT_ANGLES]
    data = [p.solveForward(freqs, truth).cpu().numpy() for p in problems]
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    print(f"{tag} {len(problems)} SOL cuts at {JOINT_ANGLES} deg, n_free="
          f"{problems[0].n_free}, tier {problems[0]._tier}: Problems and "
          f"synthetic FRFs at the truth in {setup_s:.2f} s", flush=True)
    joint = pt.JointResidual([
        p.getResidualFunction(freqs, fr, "log_afc", scaling_params=truth)
        for p, fr in zip(problems, data)])
    stamps = []
    value_and_jac = joint.value_and_jac

    def timed(s):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        return value_and_jac(s)

    joint.value_and_jac = timed
    res = pt.optimize_gauss_newton(joint, np.asarray(JOINT_S0),
                                   N_steps=JOINT_STEPS)
    torch.cuda.synchronize()
    stamps.append(time.perf_counter())
    k1 = band_kernel.band_mv_f32_cuda.launches
    iter_s = list(np.diff(stamps))
    for k, (f, x, s) in enumerate(zip(res.f_history, res.x_history, iter_s)):
        print(f"{tag} [gn] iterate {k}: loss {f:.6e}  {s:.3f} s  rel err "
              f"{', '.join(f'{v:+.3e}' for v in np.asarray(x) - 1.0)}",
              flush=True)
    err = (np.abs(res.x * truth) - truth) / truth
    print(f"{tag} [gn] {len(res.f_history)} iterations in {sum(iter_s):.3f} "
          f"s ({np.mean(iter_s):.3f} s/iter), status {res.status}, K1 "
          f"launches {k1}; result rel err (|beta|) "
          f"{', '.join(f'{v:+.3e}' for v in err)} (tol {JOINT_TOL})",
          flush=True)
    failed = []
    if k1 != 0:
        failed.append(f"K1 launched {k1} times on the dense tier")
    if not np.all(np.diff(res.f_history) < 0):
        failed.append(f"loss did not fall at every step: {res.f_history}")
    if not np.all(np.abs(err) <= np.asarray(JOINT_TOL)):
        failed.append(f"result {res.x * truth} is not within {JOINT_TOL} of "
                      f"the truth {truth}")

    # a non-palindromic stack: the 3-field path with B != 0
    band_kernel.band_mv_f32_cuda.launches = 0
    p = sh_i_problem(dev, 1.0, mat=sol((0.0, 45.0)))
    rec = timed_sweeps(p, freqs, "SOL (0, 45) sweep", tag)
    fr = rec.pop("fr")
    rec["worst_rel_err"] = oracle_check(p, freqs, fr, peak_points(fr),
                                        "SOL (0, 45), 4 points incl. the "
                                        "peak", tag)
    rec["is_mps"] = bool(p.material.is_mps)
    if rec["k1"] != 0 or rec["is_mps"]:
        failed.append(f"SOL (0, 45): K1 {rec['k1']} (must be 0), is_mps "
                      f"{rec['is_mps']} (must be False)")
    if failed:
        raise AssertionError(f"{tag} failed: " + "; ".join(failed))
    return {"setup_s": setup_s, "f_history": [float(f) for f in
                                              res.f_history],
            "iter_s": iter_s, "s_per_iter": float(np.mean(iter_s)),
            "status": res.status, "s_final": [float(v) for v in res.x],
            "rel_err": [float(v) for v in err], "k1": k1, "sol_0_45": rec}


def per_modulus(dev, keep=None) -> dict:
    """Phase 8 (b): OrthotropicD4 on the two-grid tier (n = 20916): sweeps,
    splu, and the adjoint r + J over its 8 parameters.  ``keep`` (a dict)
    receives the Problem, its FRF at the truth, the parameter scale, the
    start and the adjoint r + J there under "d4"."""
    import torch

    import plate_inverse_problem_tpu_torch as pt
    from plate_inverse_problem_tpu_torch.ops import band_kernel

    tag = "[families] (b)"
    freqs = np.linspace(40.0, 600.0, N_FREQ)
    mat = pt.get_material(7920.0, "orthotropic_d4", **D4)
    p, rec = construct(dev, 4.0, "OrthotropicD4 sh_i refine=4", tag, mat=mat)
    if p._tier != ("band", "mg", False) or p.material.scalar_loss_factor:
        raise AssertionError(f"{tag}: tier {p._tier}, scalar loss factor "
                             f"{p.material.scalar_loss_factor}")
    rec |= timed_sweeps(p, freqs, "sweep", tag)
    fr = rec.pop("fr")
    idx = peak_points(fr)
    rec["worst_rel_err"] = oracle_check(p, freqs, fr, idx,
                                        "4 points incl. the peak", tag)
    rec["f_peak"] = float(freqs[idx[1]])

    # the adjoint r + J over the 8 parameters, in variables scaled to O(1)
    # (b4 = 0 is scaled by 1e-3), with K1 counted in each sweep
    truth = np.asarray(p.parameters, np.float64)
    scale = np.where(truth != 0.0, truth, 1e-3)
    x0 = truth * np.asarray(D4_START) / scale
    rf = p.getResidualFunction(freqs, fr, kind="log_afc",
                               scaling_params=scale)
    core = p.getFRCore()[0]
    counts = {"primal": 0, "adjoint": 0}
    hooks = core.sweep_u, core.sweep_adj
    core.sweep_u = launch_counter(hooks[0], counts, "primal")
    core.sweep_adj = launch_counter(hooks[1], counts, "adjoint")
    times = []
    torch.cuda.reset_peak_memory_stats()
    try:
        for _ in range(2):
            counts.update(primal=0, adjoint=0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r, J = rf.value_and_jac(x0)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    finally:
        core.sweep_u, core.sweep_adj = hooks
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    r, J = r.cpu().numpy(), J.cpu().numpy()
    loss = p.getLossFunction(freqs, fr, "MSE_LOG_AFC", scaling_params=scale)
    t0 = time.perf_counter()
    g = loss.grad(x0).cpu().numpy()
    grad_s = time.perf_counter() - t0
    g_gn = 2.0 * J.T @ r / r.size
    grad_rel = float(np.abs(g_gn - g).max() / np.abs(g).max())
    print(f"{tag} [adjoint] log_afc r + J over {truth.size} parameters at "
          f"theta_0 = truth x {D4_START}: first {times[0]:.3f} s, steady "
          f"{times[1]:.3f} s; K1 launches {counts['primal']} in the primal "
          f"sweep, {counts['adjoint']} in the adjoint sweep; peak device "
          f"memory {peak_gb:.2f} GB; 2 J^T r / m vs MSE_LOG_AFC grad "
          f"({grad_s:.3f} s): max rel {grad_rel:.3e} (tol {GRAD_TOL_21K})",
          flush=True)
    failed = []
    if rec["k1"] <= 0 or counts["primal"] <= 0 or counts["adjoint"] <= 0:
        failed.append(f"K1 not launched on every path: sweep {rec['k1']}, "
                      f"r + J {counts}")
    if J.shape != (freqs.size, truth.size) or not (
            np.all(np.isfinite(r)) and np.all(np.isfinite(J))):
        failed.append(f"bad r {r.shape} or J {J.shape}")
    if not grad_rel <= GRAD_TOL_21K:
        failed.append(f"2 J^T r / m disagrees with the loss gradient: "
                      f"{grad_rel:.3e} > {GRAD_TOL_21K}")
    if failed:
        raise AssertionError(f"{tag} failed: " + "; ".join(failed))
    if keep is not None:
        keep["d4"] = (p, fr, scale, x0, r, J)
    return rec | {"rj_first_s": times[0], "rj_steady_s": times[1],
                  "k1_rj_primal": counts["primal"],
                  "k1_rj_adjoint": counts["adjoint"],
                  "rj_peak_mem_gb": peak_gb, "grad_s": grad_s,
                  "jac_grad_rel": grad_rel}


def pure_bending(dev) -> dict:
    """Phase 8 (c): isotropic steel without an accelerometer, the
    pure-bending path, at n = 956 (dense tier) and 13862 (two-grid, with K1
    held against its plain version on the Problem's own pack)."""
    tag = "[families] (c)"
    freqs = np.linspace(40.0, 600.0, N_FREQ)
    out = {}
    for refine, tier in ((1.0, ("flat", "dense", False)),
                         (4.0, ("band", "mg", False))):
        p, rec = construct(dev, refine, f"pure bending sh_i refine="
                           f"{refine:g}", tag, accel=False)
        if not p.is_symmetric_path or p._tier != tier:
            raise AssertionError(f"{tag}: symmetric path "
                                 f"{p.is_symmetric_path}, tier {p._tier}")
        if tier[1] == "mg":
            # K1 at the path's own pack: the Morley-only band, all the
            # sweep's lanes (re and im rows) in one batch
            import torch

            chunk = p._auto_freq_chunk() or N_FREQ
            rng = np.random.default_rng(1)
            x = torch.as_tensor(rng.standard_normal(
                (2 * chunk, p.n_free)).astype(np.float32), device=dev)
            rec["k1_pack"] = compare_kernel(
                p._band_pack, p.getFRCore()[1]["mg_band0"], x,
                p._band_layout, f"pure-bending pack ({p.n_free} Morley band,"
                " f32)")
            bound, bound_by = bound_ms(p._band_pack, x.shape[0], p.n_free)
            rec["k1_pack"] |= {"bound_ms": bound, "bound_by": bound_by}
            print(f"[bound] pure-bending pack B={x.shape[0]}: "
                  f"{1e3 * bound:.2f} us ({bound_by}); kernel at "
                  f"{100 * bound / rec['k1_pack']['ms']:.1f} % of it",
                  flush=True)
        rec |= timed_sweeps(p, freqs, "sweep", tag)
        fr = rec.pop("fr")
        if not np.iscomplexobj(fr):
            raise AssertionError(f"{tag}: the pure-bending FRF is not complex")
        idx = peak_points(fr)
        rec["worst_rel_err"] = oracle_check(p, freqs, fr, idx,
                                            "4 points incl. the peak", tag)
        rec["f_peak"] = float(freqs[idx[1]])
        if (rec["k1"] > 0) != (tier[1] == "mg"):
            raise AssertionError(f"{tag}: K1 launched {rec['k1']} times at "
                                 f"n={p.n_free}, tier {p._tier}")
        out[tier[1]] = rec
        del p
    return out


# ---------------------------------------------------------------------------
# phase 9: K3 and the rest of the public API
# ---------------------------------------------------------------------------

def csr_bound_ms(csr, S: int, L: int, itemsize: int) -> tuple[float, str]:
    """Least time of S operators on the pattern applied to L lanes on an
    H100 SXM: the S x nnz values, the plan's index bytes (``plan_bytes``: a
    one-byte slot a nonzero, the tiles' row and column lists, ``rowptr``,
    ``perm``, a 4-byte column a long row's entry), x read once and
    y written once, at HBM_BPS, against 2 FLOP a nonzero, operator and lane
    at the CUDA cores' f64 (F64_FLOPS) or f32 (F32_FLOPS) rate.  x has
    ``csr.n_cols`` columns and y ``csr.n`` rows (a rectangular P or P^T
    of the multilevel cycle)."""
    n, nnz = csr.n, csr.nnz
    t_bytes = (S * nnz * itemsize + csr.plan_bytes
               + (csr.n_cols + S * n) * L * itemsize) / HBM_BPS
    t_ops = 2.0 * S * nnz * L / (F64_FLOPS if itemsize == 8 else F32_FLOPS)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def load_ab_csr(source: str):
    """Build another version of K3 from ``source``, for an A/B beside the
    kernel in the tree (it is not part of the port), and return (name,
    run), ``run(data, x, csr) -> y``.  Three C interfaces are taken: the
    first cut's ``csr_mv_f64_launch`` / ``csr_mv_f32_launch(data, rowptr,
    col, xt, y, S, L, n, nnz, stream)``, x transposed to (n, L) by a copy
    (commit 1a1f122); the tiled kernels' ``csr_mv_{l1,narrow,wide}_
    {f64,f32}`` on the plan as ``build_csr`` makes it, before the long
    rows' argument was added (commit 499a5fc; on a pattern without long
    rows only); and the same with that argument and the first long-row
    kernel, ``csr_mv_long_{f64,f32}(data, rowptr, col, perm, long_rows,
    n_long, x, sxl, sxc, y, S, L, n, nnz, stream)`` (commit 6a96d88), its
    one-lane kernel given the plan's staging bound of then (a block with a
    long row unstaged).  With long rows, ``run.parts(data, x, csr, y)``
    is [(part, launch)] of its tile and long-row launches, for timing
    each alone."""
    import ctypes

    import torch
    from plate_inverse_problem_tpu_torch.ops import band_kernel
    from plate_inverse_problem_tpu_torch.ops import csr_kernel as ck

    name = os.path.splitext(os.path.basename(source))[0]
    with open(source) as f:
        if "LongPlan" in f.read():
            raise ValueError(f"{source} has the tree's own interface")
    lib_path = os.path.join(band_kernel.BUILD_DIR, f"libab_csr_{name}.so")
    os.makedirs(band_kernel.BUILD_DIR, exist_ok=True)
    res = subprocess.run([band_kernel._nvcc(), *band_kernel.NVCC_FLAGS,
                          "-o", lib_path, source],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{res.stderr}")
    lib = ctypes.CDLL(lib_path)
    tiled = hasattr(lib, "csr_mv_wide_f64")
    with_long = hasattr(lib, "csr_mv_long_f64")
    fns = {}
    for dt, tdt in (("f64", torch.float64), ("f32", torch.float32)):
        if tiled:
            for regime in ("L1", "narrow", "wide"):
                fn = getattr(lib, f"csr_mv_{regime.lower()}_{dt}")
                fn.argtypes = [ctypes.c_void_p] * 11 \
                    + [ctypes.c_longlong] * 2 + [ctypes.c_void_p] \
                    + [ctypes.c_int] * 3 + [ctypes.c_longlong] \
                    + [ctypes.c_int] * (6 if with_long else 5) \
                    + [ctypes.c_void_p]
                fn.restype = ctypes.c_int
                fns[tdt, regime] = fn
            if with_long:
                fn = getattr(lib, f"csr_mv_long_{dt}")
                fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] \
                    + [ctypes.c_void_p] + [ctypes.c_longlong] * 2 \
                    + [ctypes.c_void_p] + [ctypes.c_int] * 3 \
                    + [ctypes.c_longlong, ctypes.c_void_p]
                fn.restype = ctypes.c_int
                fns[tdt, "long"] = fn
        else:
            fn = getattr(lib, f"csr_mv_{dt}_launch")
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
                ctypes.c_longlong, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            fns[tdt] = fn

    bounds = {}

    def old_block_nnz(csr):
        # the staging bound of the plan of then: blocks with a long row
        # left out (they read their entries from global memory); once a
        # plan, on its first call (outside the timed runs)
        if id(csr) not in bounds:
            rowptr = csr.rowptr.cpu().numpy().astype(np.int64)
            starts = np.arange(0, csr.n, ck.L1_ROWS)
            runs = (rowptr[np.minimum(starts + ck.L1_ROWS, csr.n)]
                    - rowptr[starts])
            runs[csr.long_rows.cpu().numpy() // ck.L1_ROWS] = 0
            bounds[id(csr)] = (csr, min(int(runs.max()) if csr.n else 0,
                                        232448 // 12))
        return bounds[id(csr)][1]

    def parts(data, x, csr, y):
        S, n = data.shape[0], csr.n
        L = x.numel() // csr.n_cols
        d = data.contiguous()
        x2 = x.reshape(L, csr.n_cols)
        perm = 0 if csr.perm is None else csr.perm.data_ptr()
        out = []
        if csr.n_tiles:
            fn = fns[x.dtype, ck.regime(L)]
            args = (d.data_ptr(), csr.tile_ptr.data_ptr(),
                    csr.tile_rows.data_ptr(), csr.col_ptr.data_ptr(),
                    csr.tile_cols.data_ptr(), csr.slot.data_ptr(),
                    csr.row_off.data_ptr(), csr.rowptr.data_ptr(),
                    csr.col.data_ptr(), perm, x2.data_ptr(), *x2.stride(),
                    y.data_ptr(), S, L, n, csr.nnz, csr.n_tiles,
                    csr.max_rows, csr.max_cols, csr.max_nnz,
                    old_block_nnz(csr) if with_long else csr.max_block_nnz,
                    *((csr.n_long,) if with_long else ()))
            out.append(("tile", fn, args))
        if csr.n_long:
            if not with_long:
                raise ValueError(f"{source} predates K3's long rows")
            args = (d.data_ptr(), csr.rowptr.data_ptr(), csr.col.data_ptr(),
                    perm, csr.long_rows.data_ptr(), csr.n_long,
                    x2.data_ptr(), *x2.stride(), y.data_ptr(), S, L, n,
                    csr.nnz)
            out.append(("long", fns[x.dtype, "long"], args))

        def call(fn, args, keep=(d, x2)):
            rc = fn(*args, torch.cuda.current_stream().cuda_stream)
            if rc < 0:
                raise RuntimeError(f"{source}: cudaError {-rc}")
        return [(part, functools.partial(call, fn, args))
                for part, fn, args in out]

    def run_tiled(data, x, csr):
        S, n = data.shape[0], csr.n
        L = x.numel() // csr.n_cols
        y = torch.empty((S, L, n), dtype=x.dtype, device=x.device)
        for _, launch in parts(data, x, csr, y):
            launch()
        return y

    def run(data, x, csr):
        S, n = data.shape[0], csr.n
        L = x.numel() // n
        y = torch.empty((S, L, n), dtype=x.dtype, device=x.device)
        d = (data if csr.perm is None else data[:, csr.perm]).contiguous()
        xt = x.reshape(L, n).t().contiguous()
        rc = fns[x.dtype](d.data_ptr(), csr.rowptr.data_ptr(),
                          csr.col.data_ptr(), xt.data_ptr(), y.data_ptr(),
                          S, L, n, csr.nnz,
                          torch.cuda.current_stream().cuda_stream)
        if rc < 0:
            raise RuntimeError(f"{source}: cudaError {-rc}")
        return y

    if tiled:
        run_tiled.parts = parts
        return name, run_tiled
    return name, run


def compare_csr(csr, S: int, L: int, dtype: str, label: str, seed: int,
                ab=(), ones: bool = False, tag: str = "[slice6] (a)",
                tol: float | None = None) -> dict:
    """K3 vs its plain version on random data (S, nnz) and x (L, n) from a
    numpy seed (x = 1 with ``ones``, the panels' row sums) on the pattern
    ``csr``; two launches must agree bit for bit, and so must the A/B
    kernels ``ab`` ((name, run) pairs, the first cut's) on every row but
    the long ones (an A/B kernel may sum those in another order: their
    largest difference is printed).  Device times of
    the kernel (the wrapper's whole call; for the wide kernel also on x
    transposed by a copy, ``nl_ms``, the copy included), the plain
    version, the library call (one
    ``torch.sparse.mm`` of the S operators stacked as one (S n, n) CSR
    matrix on x^T, given x^T) and the A/B kernels, in turns; the kernel
    also with the L2 flushed.  Where the plan has long rows, the tiles'
    launch and the long rows' launch are also timed alone (``tile_ms``,
    ``long_ms``; called directly, not counted), and so are an A/B
    kernel's where it has the parts.  ``tol``: the bound against the
    plain version, of max |y| (None: CSR_TOL)."""
    import torch

    from plate_inverse_problem_tpu_torch.ops import csr_kernel as ck

    tol = CSR_TOL[dtype] if tol is None else tol
    tdt = torch.float64 if dtype == "f64" else torch.float32
    dev = csr.col.device
    n, nnz, n_cols = csr.n, csr.nnz, csr.n_cols
    itemsize = 8 if dtype == "f64" else 4
    rng = np.random.default_rng(seed)
    data = torch.as_tensor(rng.standard_normal((S, nnz)), dtype=tdt,
                           device=dev)
    x = (torch.ones(L, n_cols, dtype=tdt, device=dev) if ones else
         torch.as_tensor(rng.standard_normal((L, n_cols)), dtype=tdt,
                         device=dev))
    # the plain version's (S, L, seg) contribution tensor stays under 2 GB
    seg = max(1024, min(nnz, 2**31 // (S * L * itemsize)))
    kind = ck.regime(L)

    y_ref = ck.csr_mv_reference(data, x, csr, seg)
    y = ck.csr_mv_cuda(data, x, csr)
    same = bool(torch.equal(y, ck.csr_mv_cuda(data, x, csr)))
    d = (data if csr.perm is None else data[:, csr.perm]).reshape(-1)
    crow = torch.cat([csr.rowptr[:-1].long() + s * nnz for s in range(S)]
                     + [torch.tensor([S * nnz], device=dev)])
    A = torch.sparse_csr_tensor(crow, csr.col.long().repeat(S), d,
                                size=(S * n, n_cols))
    xt = x.t().contiguous()
    y_lib = torch.sparse.mm(A, xt).reshape(S, n, L).transpose(1, 2)
    torch.cuda.synchronize()
    scale = max(float(y_ref.abs().max()), 1e-300)
    max_abs = float((y - y_ref).abs().max())
    lib_rel = float((y_lib - y_ref).abs().max()) / scale
    del y_lib
    variants = {"ms": lambda: ck.csr_mv_cuda(data, x, csr),
                "plain_ms": lambda: ck.csr_mv_reference(data, x, csr, seg),
                "library_ms": lambda: torch.sparse.mm(A, xt)}
    if kind == "wide":
        # the first cut's layout: x transposed to (n, L) by a copy (timed),
        # the kernel reading the (L, n) view of it by its strides
        variants["nl_ms"] = lambda: ck.csr_mv_cuda(
            data, x.t().contiguous().t(), csr)
        same = same and bool(torch.equal(y, variants["nl_ms"]()))
    ab_same, ab_long = {}, {}
    short = torch.ones(n, dtype=torch.bool, device=dev)
    short[csr.long_rows.long()] = False
    for name, fn in ab:
        y_ab = fn(data, x, csr)
        ab_same[name] = bool(torch.equal(y[..., short], y_ab[..., short]))
        if csr.n_long:
            ab_long[name] = float((y_ab - y).abs().max()) / scale
        variants[f"{name}_ms"] = (lambda fn=fn: fn(data, x, csr))
    if csr.n_long:
        # each launch alone, on the wrapper's arguments, into one y
        y_p = torch.empty_like(y)
        d_c = data.contiguous()
        x2 = x.reshape(L, n_cols)
        stream = torch.cuda.current_stream().cuda_stream
        for part, fn, args, keep in ck.launch_args(d_c, x2, y_p, csr):
            key = "long" if part == "long" else "tile"
            variants[f"{key}_ms"] = (lambda fn=fn, args=args, keep=keep:
                                     fn(*args, stream))
        for name, fn in ab:
            if hasattr(fn, "parts"):
                for part, launch in fn.parts(data, x, csr, y_p):
                    variants[f"{name}_{part}_ms"] = launch
    order = list(variants) + list(variants)[::-1]
    times = {k: [] for k in variants}
    for k in order:
        times[k].append(time_ms(variants[k], reps=10)[0])
    rec = {k: float(np.mean(v)) for k, v in times.items()}
    bound, bound_by = csr_bound_ms(csr, S, L, itemsize)
    rec.update(label=label, S=S, L=L, n=n, n_cols=n_cols, nnz=nnz,
               n_long=csr.n_long, dtype=dtype,
               regime=kind,
               max_abs_err=max_abs, rel_err=max_abs / scale,
               library_rel_err=lib_rel, deterministic=same,
               ab_identical=ab_same, ab_long_rel=ab_long,
               flushed_ms=time_flushed_ms(variants["ms"], reps=10),
               bound_ms=bound, bound_by=bound_by)
    others = "".join(f"  {k[:-3]} {v:.4f} ms" for k, v in rec.items()
                     if k.endswith("_ms") and k not in (
                         "ms", "plain_ms", "library_ms", "flushed_ms",
                         "bound_ms"))
    shape = f"n={n}" if n == n_cols else f"{n}x{n_cols}"
    print(f"{tag} K3 {label}: {dtype} S={S} L={L} {shape} nnz={nnz} "
          f"({kind})  max|dy|={max_abs:.3e} rel={rec['rel_err']:.3e} (tol "
          f"{tol}), two launches identical: {same}"
          + (f", A/B identical: {ab_same}" if ab else "")
          + (f" (long rows: rel {ab_long})" if ab_long else "")
          + f"  kernel {rec['ms']:.4f} ms (L2 flushed "
          f"{rec['flushed_ms']:.4f})  plain {rec['plain_ms']:.4f} ms  library"
          f" (torch.sparse.mm) {rec['library_ms']:.4f} ms (rel "
          f"{lib_rel:.1e}){others}  bound {bound:.4f} ms ({bound_by}), "
          f"kernel at {100 * bound / rec['ms']:.1f} % of it", flush=True)
    if not rec["rel_err"] <= tol or not same \
            or not all(ab_same.values()):
        raise AssertionError(f"K3 disagrees at {label}: rel "
                             f"{rec['rel_err']:.3e}, identical {same}, "
                             f"A/B identical {ab_same}")
    return rec


def k3_cases(p21, ab=()) -> dict:
    """Phase 9 (a): K3 at the main path's shapes on three patterns: the
    bench plate's (n = 1466), n = 11910's and the 21k plate's (phase 6's
    Problem, its flat pattern in the band layout's order); ``ab``: the
    A/B kernels of ``--ab-csr``."""
    import torch

    from plate_inverse_problem_tpu_torch.ops import csr_kernel as ck

    dev = torch.device("cuda")

    def pattern(p):
        rows = torch.as_tensor(p.op.pattern.rows, device=dev)
        cols = torch.as_tensor(p.op.pattern.cols, device=dev)
        return ck.build_csr(rows, cols, p.n_free)

    bench = pattern(sh_i_problem(dev, 1.0))
    mid = pattern(sh_i_problem(dev, 3.0))
    od = p21.getFRCore()[1]
    big = ck.build_csr(od["rows"], od["cols"], p21.n_free)
    for c in (bench, mid, big):
        print(f"[slice6] (a) K3 plan n={c.n}: {c.n_tiles} tiles of at most "
              f"{ck.TILE_ROWS} rows, {c.tile_cols.numel()} staged columns "
              f"(max {c.max_cols} a tile, {c.nnz / c.tile_cols.numel():.2f} "
              f"nonzeros each), {c.plan_bytes / 1e6:.3f} MB of index data; "
              f"build_csr {1e3 * c.plan_s:.1f} ms on the host", flush=True)
    cases = [(bench, 2, 1024, "f64", "bench S=2 L=1024"),
             (bench, 2, 16, "f64", "bench S=2 L=16 (Rayleigh-Ritz)"),
             (bench, 3, 1024, "f64", "bench S=3 (with K_im)"),
             (mid, 2, 1024, "f64", "n=11910 S=2"),
             (big, 2, 1024, "f64", "n=20916 S=2 (residual map)"),
             (bench, 1, 1024, "f32", "bench f32 S=1 (refinement)"),
             (bench, 32, 1, "f64", "bench S=32 L=1 (panel row sums)"),
             (big, 32, 1, "f64", "n=20916 S=32 L=1 (panel row sums)"),
             (big, 24, 1024, "f64", "n=20916 S=24 (folded tangents)")]
    recs = [compare_csr(c, S, L, dt, label, seed, ab, ones=L == 1)
            for seed, (c, S, L, dt, label) in enumerate(cases)]
    torch.cuda.empty_cache()
    return {"cases": recs, "headline": recs[0]}


def determinism(p, freqs, fr_ref, label: str,
                tag: str = "[slice6] (b)") -> dict:
    """Phase 9 (b): two steady sweeps and two MSE_LOG_AFC gradients (at
    theta_0 = truth x START against ``fr_ref``) on ``p`` are bit-identical."""
    th0 = np.asarray(p.parameters, np.float64) * np.asarray(START)
    sweeps = [p.solveForward(freqs).cpu().numpy() for _ in range(3)][1:]
    loss = p.getLossFunction(freqs, fr_ref, "MSE_LOG_AFC")
    grads = [loss.grad(th0).cpu().numpy() for _ in range(2)]
    rec = {"sweeps_identical": bool(np.array_equal(*sweeps)),
           "grads_identical": bool(np.array_equal(*grads)),
           "sweep_max_diff": float(np.abs(sweeps[0] - sweeps[1]).max()),
           "grad_max_diff": float(np.abs(grads[0] - grads[1]).max())}
    print(f"{tag} {label}: two steady sweeps identical "
          f"{rec['sweeps_identical']} (max diff {rec['sweep_max_diff']:.3e}),"
          f" two gradients identical {rec['grads_identical']} (max diff "
          f"{rec['grad_max_diff']:.3e})", flush=True)
    if not (rec["sweeps_identical"] and rec["grads_identical"]):
        raise AssertionError(f"{label}: the card is not bit-reproducible: "
                             f"{rec}")
    return rec


def steady_s(p, freqs, params=None) -> float:
    """One synchronised sweep's seconds."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p.solveForward(freqs, params)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def dense_fault(dev) -> dict:
    """Phase 9 (c): the dense tier away from the build point."""
    import plate_inverse_problem_tpu_torch as pt
    from plate_inverse_problem_tpu_torch.oracle import splu_frf

    freqs = np.linspace(40.0, 600.0, N_FREQ)
    truth = np.asarray(JOINT_TRUE)
    mat = pt.get_material(1550.0, "sol", angles=(45.0,), E1=truth[0],
                          E2=truth[1], G12=truth[2], nu12=truth[3],
                          beta=truth[4])
    p = sh_i_problem(dev, 1.0, mat=mat)
    out = {}
    for name, s in (("s", SOL45_S), ("s0", JOINT_S0)):
        th = truth * np.asarray(s)
        fr = p.solveForward(freqs, th).cpu().numpy()
        d = p.diagnoseSweep(freqs, th)
        idx = peak_points(fr)
        ref = splu_frf(p, freqs[idx], th)
        rel = np.abs(fr[idx] - ref) / np.abs(ref)
        rec = {"worst_rel_err": float(rel.max()),
               "f_peak": float(freqs[idx[1]]),
               "converged": int(d["converged"].sum()),
               "diag_fr_is_sweep": bool(np.array_equal(d["fr"], fr))}
        print(f"[slice6] (c) SOL 45 deg at {name} = {s} x truth, n="
              f"{p.n_free}, tier {p._tier}: rel err vs f64 splu at "
              + ", ".join(f"{freqs[i]:.3f} Hz {r:.3e}"
                          for i, r in zip(idx, rel))
              + f"; worst {rec['worst_rel_err']:.3e} (tol {ORACLE_TOL}); "
              f"diagnoseSweep: {rec['converged']} of {freqs.size} lanes "
              f"converged, its FRF is the sweep's: "
              f"{rec['diag_fr_is_sweep']}", flush=True)
        if not (rec["worst_rel_err"] <= ORACLE_TOL
                and rec["converged"] == freqs.size
                and rec["diag_fr_is_sweep"]):
            raise AssertionError(f"SOL 45 deg at {name}: {rec}")
        out[name] = rec
    return out


def tpu_benchmark(dev) -> dict:
    """Phase 9 (d): examples/tpu_benchmark.py's workflow through the port,
    held against the JAX package's CPU run of the same calls."""
    import torch

    from plate_inverse_problem_tpu_torch.io.compress import Compressor
    from plate_inverse_problem_tpu_torch.ops import band_kernel, csr_kernel

    tag = "[slice6] (d)"
    band_kernel.band_mv_f32_cuda.launches = 0
    csr_kernel.reset_launches()
    t0 = time.perf_counter()
    p = sh_i_problem(dev, 1.0)
    p.getFRCore()
    torch.cuda.synchronize()
    ctor_s = time.perf_counter() - t0
    freq = np.linspace(40.0, 600.0, TPUB_N_FREQ)
    sweep_s = [steady_s(p, freq) for _ in range(2)]
    fr = p.solveForward(freq).cpu().numpy()
    checksum = float(np.abs(fr).sum())
    cs_rel = abs(checksum - TPUB_JAX_CHECKSUM) / TPUB_JAX_CHECKSUM
    n_comp = Compressor(freq, fr, TPUB_N_COMP, 1)(TPUB_N_COMP)[0].size
    print(f"{tag} sh_i refine=1 n={p.n_free} tier {p._tier}: construction "
          f"{ctor_s:.3f} s; {TPUB_N_FREQ}-point sweep first {sweep_s[0]:.3f} "
          f"s, steady {sweep_s[1]:.3f} s; checksum {checksum!r} vs the JAX "
          f"CPU run's {TPUB_JAX_CHECKSUM!r}: rel {cs_rel:.3e}; compressed to "
          f"{n_comp} frequencies", flush=True)
    failed = [] if cs_rel <= CHECKSUM_TOL else [f"checksum rel {cs_rel:.3e}"]

    runs = {}
    make = p.getLossFunction
    for name, (opt, steps, scaled) in TPUB_RUNS.items():
        stamps = []

        def timed_loss(*a, **k):
            loss = make(*a, **k)
            vg = loss.value_and_grad

            def value_and_grad(x):
                torch.cuda.synchronize()
                stamps.append(time.perf_counter())
                return vg(x)

            loss.value_and_grad = value_and_grad
            return loss

        p.getLossFunction = timed_loss
        try:
            res = p.solveInverse(
                list(TPUB_START), "MSE_LOG_AFC", opt, ref_fr=[freq, fr],
                use_rel=True, use_scaling=scaled,
                compression=(True, TPUB_N_COMP), log=False, report=False,
                N_steps=steps, h=0.001, f_min=1e-10)
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
        finally:
            del p.getLossFunction
        step_s = list(np.diff(stamps))
        for k, (f, s) in enumerate(zip(res.f_history, step_s)):
            print(f"{tag} {name} step {k}: loss {f:.10e}  {s:.4f} s",
                  flush=True)
        x_jax, niter_jax, status_jax = TPUB_JAX[name]
        rel = np.abs(np.asarray(res.x) - x_jax) / np.abs(x_jax)
        print(f"{tag} {name}: {opt} use_scaling={scaled}, {len(step_s)} "
              f"steps in {sum(step_s):.3f} s ({np.mean(step_s):.4f} s/step), "
              f"niter {res.niter}, status {res.status}; x "
              f"{np.asarray(res.x)!r}, rel to the JAX CPU run "
              f"{', '.join(f'{v:.3e}' for v in rel)} (tol {TPUB_TOL})",
              flush=True)
        if not (np.all(rel <= TPUB_TOL) and res.niter == niter_jax
                and res.status == status_jax):
            failed.append(f"{name}: rel {rel}, niter {res.niter}, "
                          f"status {res.status}")
        runs[name] = {"x": [float(v) for v in res.x],
                      "f_history": [float(f) for f in res.f_history],
                      "step_s": step_s, "rel_to_jax": [float(v) for v in rel]}
    k1 = band_kernel.band_mv_f32_cuda.launches
    k3 = csr_kernel.csr_mv_cuda.launches
    print(f"{tag} K3 launches {k3}, K1 {k1} over the workflow", flush=True)
    if k3 <= 0 or k1 != 0:
        failed.append(f"K3 {k3} (must be > 0), K1 {k1} (must be 0)")
    if failed:
        raise AssertionError(f"{tag} failed: " + "; ".join(failed))
    return {"ctor_s": ctor_s, "sweep_first_s": sweep_s[0],
            "sweep_steady_s": sweep_s[1], "checksum": checksum,
            "n_comp": int(n_comp), "runs": runs, "k3": k3}


def edp_plate(dev) -> dict:
    """Phase 9 (e): examples/edp_import.py's plate through the port."""
    import warnings

    import plate_inverse_problem_tpu_torch as pt
    from plate_inverse_problem_tpu_torch.diagnostics import (
        oracle_check as oracle_check_diag)
    from plate_inverse_problem_tpu_torch.oracle import splu_frf

    tag = "[slice6] (e)"
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "smoke", "plate_with_hole.edp")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fh:
        fh.write(EDP_SCRIPT)
    with warnings.catch_warnings():
        # the script's FE section is named and skipped; the sweep leaves
        # the basis band (f_max 600 Hz), as in the example
        warnings.simplefilter("ignore", RuntimeWarning)
        geom = pt.Geometry(path, height=2e-3)
        mat = pt.get_material(7920.0, "isotropic", E=200e9, G=75e9,
                              beta=0.003)
        p = pt.Problem(geom, mat, None, device=dev)
        freqs = np.linspace(60.0, 900.0, 121)
        sweep_s = [steady_s(p, freqs) for _ in range(2)]
        fr = p.solveForward(freqs).cpu().numpy()
    idx = [3, int(np.argmax(np.abs(fr))), 60, 120]
    ref = splu_frf(p, freqs[idx])
    rel = np.abs(fr[idx] - ref) / np.abs(ref)
    # the script's own audit (examples/edp_import.py: oracle_check)
    example = oracle_check_diag(p, freqs, fr=fr)
    print(f"{tag} the script's oracle_check: engine '{example['engine']}' "
          f"worst rel err vs f64 splu oracle: {example['worst_rel_err']:.2e} "
          f"(at {example['at_hz']:.0f} Hz; tol {ORACLE_TOL})", flush=True)
    rec = {"n_free": p.n_free, "nnz": int(p.op.pattern.nnz),
           "oracle_check": example,
           "clamped_labels": list(geom.clamped_labels),
           "test_point": list(geom.test_point), "tier": list(p._tier),
           "sweep_first_s": sweep_s[0], "sweep_steady_s": sweep_s[1],
           "f_peak": float(freqs[idx[1]]), "worst_rel_err": float(rel.max())}
    print(f"{tag} plate with a hole from its .edp script: clamped labels "
          f"{geom.clamped_labels}, test point {geom.test_point}, n="
          f"{p.n_free} nnz={p.op.pattern.nnz}, tier {p._tier}, pure bending "
          f"{p.is_symmetric_path}; 121-point sweep first {sweep_s[0]:.3f} s,"
          f" steady {sweep_s[1]:.3f} s; rel err vs f64 splu at "
          + ", ".join(f"{freqs[i]:.1f} Hz {r:.3e}" for i, r in zip(idx, rel))
          + f"; worst {rec['worst_rel_err']:.3e} (tol {ORACLE_TOL})",
          flush=True)
    if not (rec["worst_rel_err"] <= ORACLE_TOL and p.is_symmetric_path
            and example["worst_rel_err"] <= ORACLE_TOL
            and tuple(geom.clamped_labels) == (2,)
            and np.iscomplexobj(fr)):
        raise AssertionError(f"{tag} failed: {rec}")
    return rec


def slice6(dev, p21, freqs, fr21, ab_csr=()) -> dict:
    """Phase 9 on ``dev``; ``p21``/``fr21``: phase 6's 21k Problem and its
    FRF at the truth; ``ab_csr``: the A/B kernels of ``--ab-csr``.  Returns
    the numbers for [summary] and K3's record for the kernels' line under
    "k3"."""
    from plate_inverse_problem_tpu_torch.ops import csr_kernel

    k3 = k3_cases(p21, ab_csr)
    bench = sh_i_problem(dev, 1.0)
    fr_bench = bench.solveForward(freqs).cpu().numpy()
    csr_kernel.reset_launches()
    det = {"bench_1466": determinism(bench, freqs, fr_bench, "n=1466"),
           "k3_1466": csr_kernel.csr_mv_cuda.launches}
    del bench
    csr_kernel.reset_launches()
    det["sh_i_21k"] = determinism(p21, freqs, fr21, f"n={p21.n_free}")
    det["k3_21k"] = csr_kernel.csr_mv_cuda.launches
    out = {"k3_cases": k3["cases"], "determinism": det,
           "dense_fault": dense_fault(dev), "tpu_benchmark": tpu_benchmark(dev),
           "edp": edp_plate(dev)}
    out["k3"] = {"headline": k3["headline"],
                 "launches": out["tpu_benchmark"]["k3"],
                 "by_path": {"tpu_benchmark_1466": out["tpu_benchmark"]["k3"],
                             "determinism_1466": det["k3_1466"],
                             "determinism_21k": det["k3_21k"]}}
    return out


# phase 10: the rest of the inverse API
def sync_times(fn, n: int = 2, reset: bool = True):
    """``n`` calls of ``fn`` on the card, each synchronised: (outputs,
    seconds each, peak device memory in GB over all of them, K1 and K3
    launches of the last call).  ``reset``: the peak counts from these
    calls alone (else it keeps the earlier peak)."""
    import torch

    from plate_inverse_problem_tpu_torch.ops import band_kernel, csr_kernel

    outs, times = [], []
    if reset:
        torch.cuda.reset_peak_memory_stats()
    for _ in range(n):
        band_kernel.band_mv_f32_cuda.launches = 0
        csr_kernel.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(fn())
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return (outs, times, torch.cuda.max_memory_allocated() / 1e9,
            band_kernel.band_mv_f32_cuda.launches,
            csr_kernel.csr_mv_cuda.launches)


def host(rj):
    """(r, J) tensors -> numpy."""
    return tuple(a.cpu().numpy() for a in rj)


def jac_dev(J, J_ref) -> float:
    """max |J - J_ref| / (1e-6 |J_ref| + 1e-8 max |J_ref|): at most 1
    where the JAX package's fwd-vs-adjoint tolerance holds."""
    return float((np.abs(J - J_ref) / (FWD_J_RTOL * np.abs(J_ref)
                                       + FWD_J_ATOL * np.abs(J_ref).max())
                  ).max())


def fwd_21k(p, freqs, fr_truth) -> dict:
    """Phase 10 (a): the forward-mode Jacobian on phase 6's 21k Problem."""
    import plate_inverse_problem_tpu_torch as pt

    tag = "[slice8] (a)"
    truth = np.asarray(p.parameters, np.float64)
    th0 = truth * np.asarray(START)
    core, od = p.getFRCore()
    (ra, Ja), = sync_times(lambda: host(p.getResidualFunction(
        freqs, fr_truth, kind="log_afc").value_and_jac(th0)), 1)[0]
    rf = p.getResidualFunction(freqs, fr_truth, kind="log_afc",
                               jac_mode="fwd")
    outs, times, peak_gb, k1, k3 = sync_times(
        lambda: host(rf.value_and_jac(th0)))
    (r, J), (r2, J2) = outs
    blocks = -(-freqs.size // (rf._chunk or freqs.size))
    print(f"{tag} fwd log_afc r + J at theta_0 = truth x {START}, "
          f"{freqs.size} points, freq_chunk {rf._chunk} (lanes policy, "
          f"{blocks} block(s)): first {times[0]:.3f} s, steady "
          f"{times[1]:.3f} s; K1 {k1}, K3 {k3} launches; peak device memory "
          f"{peak_gb:.2f} GB", flush=True)
    if blocks == 1:
        ru, Ju = r, J
    else:
        (ru, Ju), = sync_times(lambda: host(pt.ResidualFunction(
            core, od, freqs, fr_truth, kind="log_afc", jac_mode="fwd"
        ).value_and_jac(th0)), 1)[0]
    outs, t64, peak64, _, _ = sync_times(lambda: host(p.getResidualFunction(
        freqs, fr_truth, kind="log_afc", jac_mode="fwd",
        freq_chunk=FWD_CHUNK).value_and_jac(th0)), 1)
    (rc, Jc), = outs
    rfx = p.getResidualFunction(freqs, fr_truth.astype(complex),
                                kind="complex")
    outs, tx, peakx, _, _ = sync_times(lambda: host(rfx.value_and_jac(th0)),
                                       1)
    (rx, Jx), = outs

    def fd_col(j):
        e = np.zeros(truth.size)
        e[j] = FD_STEPS[j] * th0[j]
        fd = (rfx(th0 + e) - rfx(th0 - e)).cpu().numpy() / (2.0 * e[j])
        return float(np.abs(fd - Jx[:, j]).max() / np.abs(Jx[:, j]).max())

    fd = [fd_col(j) for j in range(truth.size)]
    r_rel = float(np.abs(r - ra).max() / np.abs(ra).max())
    rec = {"rj_fwd_first_s": times[0], "rj_fwd_steady_s": times[1],
           "rj_fwd_chunk": rf._chunk, "rj_fwd_blocks": blocks,
           "rj_fwd_peak_gb": peak_gb,
           "k1": k1, "k3": k3, "r_vs_adjoint_rel": r_rel,
           "chunk64_r_vs_adjoint_rel": float(
               np.abs(rc - ra).max() / np.abs(ra).max()),
           "J_vs_adjoint": jac_dev(J, Ja), "bits_equal": bool(
               np.array_equal(r, r2) and np.array_equal(J, J2)),
           "unchunked_r_vs_adjoint_rel": float(
               np.abs(ru - ra).max() / np.abs(ra).max()),
           "unchunked_vs_adjoint": jac_dev(Ju, Ja),
           "chunk64_s": t64[0], "chunk64_peak_gb": peak64,
           "chunk64_vs_unchunked": jac_dev(Jc, Ju),
           "complex_s": tx[0], "complex_peak_gb": peakx,
           "complex_fd_rel": fd}
    print(f"{tag} r vs the adjoint mode's: unchunked max rel "
          f"{rec['unchunked_r_vs_adjoint_rel']:.3e} (tol {FWD_R_TOL}), "
          f"freq_chunk {rf._chunk} / {FWD_CHUNK} {r_rel:.3e} / "
          f"{rec['chunk64_r_vs_adjoint_rel']:.3e} (tol {FWD_R_CHUNK_TOL}); "
          f"J vs the adjoint J: {rec['J_vs_adjoint']:.3e} of the tolerance "
          f"(1e-6 rel + 1e-8 of max; unchunked "
          f"{rec['unchunked_vs_adjoint']:.3e}); two calls bit-identical: "
          f"{rec['bits_equal']}", flush=True)
    print(f"{tag} freq_chunk={FWD_CHUNK}: {t64[0]:.3f} s, peak "
          f"{peak64:.2f} GB, J vs unchunked {rec['chunk64_vs_unchunked']:.3e}"
          f" of the tolerance; kind='complex' ({rfx.jac_mode}): {tx[0]:.3f} s,"
          f" peak {peakx:.2f} GB, J vs central differences of r at steps "
          f"{FD_STEPS}: {', '.join(f'{x:.3e}' for x in fd)} of the column "
          f"max (tol {FD_TOL})", flush=True)
    print(f"{tag} first-call cost of the forward mode: first "
          f"{times[0]:.3f} s vs steady {times[1]:.3f} s "
          f"({times[0] - times[1]:+.3f} s)", flush=True)
    failed = []
    if k1 <= 0 or k3 <= 0:
        failed.append(f"K1 {k1} / K3 {k3} launches in the fwd r + J")
    if not rec["unchunked_r_vs_adjoint_rel"] <= FWD_R_TOL:
        failed.append("unchunked r vs adjoint "
                      f"{rec['unchunked_r_vs_adjoint_rel']:.3e}")
    if not max(r_rel, rec["chunk64_r_vs_adjoint_rel"]) <= FWD_R_CHUNK_TOL:
        failed.append(f"chunked r vs adjoint {r_rel:.3e}")
    if not max(rec["J_vs_adjoint"], rec["unchunked_vs_adjoint"],
               rec["chunk64_vs_unchunked"]) <= 1.0:
        failed.append("J outside the 1e-6 / 1e-8 tolerance")
    if not rec["bits_equal"]:
        failed.append("two fwd r + J calls differ")
    if not max(fd) <= FD_TOL:
        failed.append(f"complex J vs differences {fd}")
    if failed:
        raise AssertionError(f"{tag} failed: " + "; ".join(failed))
    return rec


def fwd_d4(freqs, kept) -> dict:
    """Phase 10 (b): the forward-mode r + J of OrthotropicD4 at 21k over its
    8 parameters, with the lanes chunk policy, against the adjoint J of
    phase 8 (b)."""
    tag = "[slice8] (b)"
    p, fr, scale, x0, ra, Ja = kept
    rf = p.getResidualFunction(freqs, fr, kind="log_afc",
                               scaling_params=scale, jac_mode="fwd")
    outs, times, peak_gb, k1, k3 = sync_times(
        lambda: host(rf.value_and_jac(x0)), 1)
    (r, J), = outs
    r_rel = float(np.abs(r - ra).max() / np.abs(ra).max())
    dev = jac_dev(J, Ja)
    blocks = -(-freqs.size // (rf._chunk or freqs.size))
    print(f"{tag} OrthotropicD4 n={p.n_free}: fwd log_afc r + J over "
          f"{x0.size} parameters, freq_chunk {rf._chunk} (lanes policy, "
          f"{1 + x0.size} lanes a frequency, {blocks} block(s)): "
          f"{times[0]:.3f} s, peak device "
          f"memory {peak_gb:.2f} GB; K1 {k1}, K3 {k3}; r vs adjoint "
          f"{r_rel:.3e}, J vs adjoint {dev:.3e} of the tolerance", flush=True)
    if k1 <= 0 or k3 <= 0 or not dev <= 1.0 or not r_rel <= FWD_R_CHUNK_TOL:
        raise AssertionError(f"{tag} failed: K1 {k1}, K3 {k3}, r {r_rel}, "
                             f"J {dev}")
    return {"n_free": p.n_free, "chunk": rf._chunk, "blocks": blocks,
            "s": times[0],
            "peak_gb": peak_gb, "k1": k1, "k3": k3, "r_vs_adjoint_rel": r_rel,
            "J_vs_adjoint": dev, "rj": (r, J)}


def first_resonance(fr) -> int:
    """Index of the first local maximum of |FRF| in a sweep."""
    a = np.abs(fr)
    return int(np.flatnonzero((a[1:-1] > a[:-2]) & (a[1:-1] > a[2:]))[0] + 1)


def sweep_vertex_w(p, freq: float) -> np.ndarray:
    """|w| at the mesh vertices from the port's own sweep at one frequency:
    the sweep's (equilibrated, layout-ordered) solution mapped back to the
    free DOFs, then by ``Problem.vertex_w`` as ``mode_field``'s is."""
    import torch

    core, od = p.getFRCore()
    U_re, U_im = core.sweep_u(
        torch.tensor([freq], dtype=torch.float64, device=p.device),
        torch.as_tensor(np.asarray(p.parameters, np.float64),
                        device=p.device), od)
    u_s = U_re[0].cpu().numpy() + 1j * U_im[0].cpu().numpy()
    lay = p._band_layout
    perm = np.arange(p.n_free) if lay is None else lay.perm
    u = np.empty(p.n_free, complex)
    u[perm] = p._eq_scale[perm] * u_s
    return p.vertex_w(u)


def count_data_grad(csr_kernel, calls):
    """Wrap ``csr_kernel._data_grad`` (K3's reverse mode, plain torch) to
    count its calls (one ``None`` each in ``calls``) and keep its first
    inputs (the first entry); returns the original."""
    orig = csr_kernel._data_grad

    def counted(gy, x, csr, seg):
        if not calls:
            calls.append((gy.detach().clone(), x.detach().clone(), csr,
                          seg))
        calls.append(None)
        return orig(gy, x, csr, seg)

    csr_kernel._data_grad = counted
    return orig


def data_grad_bound_ms(gy, x, csr) -> tuple[float, str]:
    """Least time of ``_data_grad(gy, x, csr)`` (K3's reverse mode) on an
    H100 SXM: gy (S, ..., n) and x (..., n) read once, the pattern's row
    and column indices (int64) read once and the (S, nnz) result written
    once, at HBM_BPS, against 2 FLOP a nonzero, operator and lane at
    F64_FLOPS."""
    S, nnz = gy.shape[0], csr.nnz
    lanes = x.numel() // csr.n
    t_bytes = (gy.numel() * gy.element_size() + x.numel() * x.element_size()
               + 2 * nnz * 8 + S * nnz * gy.element_size()) / HBM_BPS
    t_ops = 2.0 * S * lanes * nnz / F64_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def cuda_event_ms(fn, reps: int = 20) -> float:
    """Mean time of ``fn`` on the card over ``reps`` calls, by CUDA events,
    after a warm-up call."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def second_order_1466(dev, freqs) -> dict:
    """Phase 10 (c) and (d) on the bench plate (n = 1466): the loss Hessian
    and its checks, trust region, Newton, L-BFGS and Gauss-Newton on MSE
    (the 'complex' residual) from theta_0, de and shgo on a bounds box, and
    the getModePicture field at the first resonance."""
    import torch

    from plate_inverse_problem_tpu_torch.ops import csr_kernel

    tag = "[slice8] (c)"
    p = sh_i_problem(dev, 1.0)
    truth = np.asarray(p.parameters, np.float64)
    th0 = truth * np.asarray(START)
    fr = p.solveForward(freqs).cpu().numpy()
    loss = p.getLossFunction(freqs, fr, "MSE_LOG_AFC", scaling_params=th0)
    x1 = np.ones(truth.size)
    calls = []
    orig = count_data_grad(csr_kernel, calls)
    try:
        outs, times, peak_gb, _, k3_h = sync_times(
            lambda: tuple(a.cpu().numpy()
                          for a in loss.value_grad_hessian(x1)))
    finally:
        csr_kernel._data_grad = orig
    (v, g, H), (v2, g2, H2) = outs
    n_dg = (len(calls) - 1) // 2     # per call; calls[0] holds the inputs
    gy, xg, csr, seg = calls[0]
    t_dg = cuda_event_ms(lambda: csr_kernel._data_grad(gy, xg, csr, seg))
    data = torch.ones((gy.shape[0], csr.nnz), dtype=gy.dtype,
                      device=gy.device)
    t_k3 = cuda_event_ms(lambda: csr_kernel.csr_mv(data, xg, csr, seg))
    dg_bound, dg_by = data_grad_bound_ms(gy, xg, csr)
    dg_rec = {"ms": t_dg, "k3_ms_same_shape": t_k3,
              "calls_per_hessian": n_dg, "gy_shape": list(gy.shape),
              "x_shape": list(xg.shape), "nnz": csr.nnz,
              "bound_ms": dg_bound, "bound_by": dg_by}
    sym = float(np.abs(H - H.T).max() / np.abs(H).max())

    def fd_col(j):
        e = np.zeros(truth.size)
        e[j] = HESS_FD_STEP
        return (loss.grad(x1 + e).cpu().numpy()
                - loss.grad(x1 - e).cpu().numpy()) / (2.0 * HESS_FD_STEP)

    Hfd = np.stack([fd_col(j) for j in range(truth.size)], axis=1)
    fd = [float(np.abs(Hfd[:, j] - H[:, j]).max() / np.abs(H[:, j]).max())
          for j in range(truth.size)]
    print(f"{tag} bench n={p.n_free}: MSE_LOG_AFC value, gradient and "
          f"Hessian at theta_0 (x = theta / theta_0 = 1): first "
          f"{times[0]:.3f} s, steady {times[1]:.3f} s, peak {peak_gb:.2f} GB,"
          f" K3 {k3_h}; asymmetry {sym:.3e} of max (tol {HESS_SYM_TOL}); "
          f"columns vs central differences of the gradient at step "
          f"{HESS_FD_STEP}: {', '.join(f'{x:.3e}' for x in fd)} of the "
          f"column max (tol {HESS_FD_TOL})", flush=True)
    print(f"{tag} _data_grad (K3's reverse mode, plain torch): "
          f"{n_dg} calls a Hessian, gy {dg_rec['gy_shape']}, x "
          f"{dg_rec['x_shape']}: {t_dg:.4f} ms each; K3 on the same shapes "
          f"(csr_mv of ones): {t_k3:.4f} ms; bound {dg_bound:.4f} ms "
          f"({dg_by})", flush=True)
    failed = []
    if not sym <= HESS_SYM_TOL:
        failed.append(f"Hessian asymmetry {sym:.3e}")
    if not max(fd) <= HESS_FD_TOL:
        failed.append(f"Hessian vs differences {fd}")
    if not (np.array_equal(H, H2) and v == v2):
        failed.append("two Hessian calls differ")
    rec = {"n_free": p.n_free, "hessian_first_s": times[0],
           "hessian_steady_s": times[1], "hessian_peak_gb": peak_gb,
           "hessian_asym": sym, "hessian_fd_rel": fd,
           "k3": {"hessian_1466": k3_h}}

    runs = {"tr": ("MSE_LOG_AFC", dict(N_steps=SO_STEPS["tr"],
                                       delta_max=0.5)),
            "newton": ("MSE_LOG_AFC", dict(N_steps=SO_STEPS["newton"])),
            "lbfgs": ("MSE_LOG_AFC", dict(N_steps=SO_STEPS["lbfgs"])),
            "gn": ("MSE", dict(N_steps=SO_STEPS["gn"]))}
    for name, (loss_type, kw) in runs.items():
        (res,), (s,), _, _, k3 = sync_times(lambda: p.solveInverse(
            th0, loss_type, name, ref_fr=(freqs, fr), use_scaling=True,
            report=False, log=False, **kw), 1)
        err = (np.abs(res.x) - truth) / truth
        it = max(len(res.f_history), 1)
        rec[name] = {"s": s, "iters": len(res.f_history), "s_per_iter":
                     s / it, "status": res.status, "f": float(res.f),
                     "rel_err": [float(e) for e in err]}
        rec["k3"][f"{name}_1466"] = k3
        f_hist = np.asarray(res.f_history, np.float64)
        fit = float(res.f) / f_hist[0]
        print(f"{tag} solveInverse {name!r} ({loss_type}) from theta_0: "
              f"{len(res.f_history)} iterations in {s:.3f} s "
              f"({s / it:.3f} s/iter), status {res.status}, loss "
              f"{float(res.f):.3e} ({fit:.3e} of the start's); rel err "
              f"(|beta|) {', '.join(f'{e:+.3e}' for e in err)} (tol "
              + (f"{SO_TOL}" if name != "gn" else
                 f"none: the loss to {GN_MSE_FIT} of the start's")
              + f"); K3 {k3}", flush=True)
        # (L-BFGS's approximate Wolfe test admits a rise of 1e-6 of the
        # loss in a step, optax's approx_dec_rtol)
        if name != "lbfgs" and not np.all(np.diff(f_hist) <= 0):
            failed.append(f"{name}: the loss rose {f_hist}")
        if name == "gn":
            if not fit <= GN_MSE_FIT:
                failed.append(f"gn (MSE) fits to {fit:.3e} of its start")
        elif not np.all(np.abs(err) <= SO_TOL):
            failed.append(f"{name} ends {err} from the truth")

    bounds = np.stack([truth * 0.8, truth * 1.2], axis=1)
    for name, kw in (("de", dict(maxiter=2, popsize=4, tol=10.0, seed=0,
                                 polish=False)),
                     ("shgo", dict(options={"maxiter": 2, "f_tol": 1.0}))):
        (res,), (s,), _, _, k3 = sync_times(lambda: p.solveInverse(
            bounds, "MSE_LOG_AFC", name, ref_fr=(freqs, fr),
            use_scaling=True, use_constraints=name == "shgo", report=False,
            log=False, **kw), 1)
        ok = bool(np.all(np.isfinite(res.x)) and np.isfinite(res.f))
        rec[name] = {"s": s, "niter": int(res.niter), "f": float(res.f),
                     "x": [float(x) for x in res.x]}
        rec["k3"][f"{name}_1466"] = k3
        print(f"{tag} solveInverse {name!r} on the box truth x [0.8, 1.2] "
              f"(the JAX test's budget): {s:.3f} s, niter {res.niter}, loss "
              f"{float(res.f):.3e}, x / truth "
              f"{', '.join(f'{x:.4f}' for x in res.x / truth)}; finite: {ok};"
              f" K3 {k3}", flush=True)
        if not ok:
            failed.append(f"{name} gave a non-finite result")

    # (d) the getModePicture field at the first resonance
    i = first_resonance(fr)
    t0 = time.perf_counter()
    w_mode = p.mode_field(float(freqs[i]))
    mode_s = time.perf_counter() - t0
    w_sweep = sweep_vertex_w(p, float(freqs[i]))
    mode_rel = float(np.abs(w_mode - w_sweep).max() / np.abs(w_sweep).max())
    print(f"[slice8] (d) getModePicture field at the first resonance "
          f"{freqs[i]:.3f} Hz: host splu {mode_s:.3f} s; vertex |w| vs the "
          f"sweep's own w DOFs: max rel {mode_rel:.3e} (tol {MODE_TOL})",
          flush=True)
    rec["mode"] = {"f_hz": float(freqs[i]), "s": mode_s, "rel": mode_rel}
    if not mode_rel <= MODE_TOL:
        failed.append(f"mode field {mode_rel:.3e} from the sweep's")
    if failed:
        raise AssertionError(f"{tag} failed: " + "; ".join(failed))
    return rec | {"data_grad": dg_rec}


def slice8(dev, p21, freqs, fr21, kept_d4) -> dict:
    """Phase 10 on ``dev``: (a) the forward-mode Jacobian on phase 6's 21k
    Problem, (b) on phase 8 (b)'s OrthotropicD4 Problem (``kept_d4``), (c)
    the loss Hessian and the second-order, quasi-Newton and global
    optimizers on the bench plate, (d) the getModePicture field.  Returns
    the numbers for [summary], K1's and K3's launches by path under "k1" /
    "k3" and _data_grad's time under "data_grad"."""
    # every part runs before a failed check of any of them raises
    failed = []

    def run(fn, *args):
        try:
            return fn(*args)
        except AssertionError as err:
            failed.append(str(err))
            return None

    a = run(fwd_21k, p21, freqs, fr21)
    b = run(fwd_d4, freqs, kept_d4)
    c = run(second_order_1466, dev, freqs)
    if failed:
        raise AssertionError("phase 10 failed: " + " | ".join(failed))
    k1 = {"rj_fwd_21k": a["k1"], f"rj_fwd_d4_{b['n_free']}": b["k1"]}
    k3 = {"rj_fwd_21k": a["k3"], f"rj_fwd_d4_{b['n_free']}": b["k3"],
          **c.pop("k3")}
    if not all(v > 0 for v in k1.values()):
        raise AssertionError(f"K1 launched no time on a 21k path: {k1}")
    return {"fwd_21k": a, "fwd_d4": b, "bench": c, "k1": k1, "k3": k3,
            "data_grad": c.pop("data_grad")}


# ---------------------------------------------------------------------------
# phase 11: the modal and direct engines
# ---------------------------------------------------------------------------

def freq_dep_material(beta0: float):
    """tests/test_problem.py's omega-dependent damping in the port: beta0 (1
    + omega / FD_OMEGA_REF) on isotropic steel, on both paths."""
    import torch

    import plate_inverse_problem_tpu_torch as pt

    class FreqDepIsotropic(pt.Isotropic):
        def abd_split(self, params, h, omega=0.0):
            b = params[2] * (1.0 + omega / FD_OMEGA_REF)
            return super().abd_split(torch.stack([params[0], params[1], b]),
                                     h)

        def d_split(self, params, h, omega=0.0):
            b = params[2] * (1.0 + omega / FD_OMEGA_REF)
            return super().d_split(torch.stack([params[0], params[1], b]), h)

    return FreqDepIsotropic(7920.0, E=200e9, G=75e9, beta=beta0)


def flat_stiffness(p, od):
    """(K_re, K_im) flat data of ``p`` at its own parameters, as its core
    forms them."""
    import torch

    th = torch.as_tensor(np.asarray(p.parameters, np.float64),
                         device=p.device)
    h = p.geometry.height
    if p.is_symmetric_path:
        re, im = p.material.d_split(th, h)
        return (torch.einsum("k,kn->n", re, od["Ks"]),
                torch.einsum("k,kn->n", im, od["Ks"]))
    (Ar, Ai), (Br, Bi), (Dr, Di) = p.material.abd_split(th, h)
    return (torch.einsum("mk,mkn->n", torch.stack([Ar, Br, Dr]), od["ABD"]),
            torch.einsum("mk,mkn->n", torch.stack([Ai, Bi, Di]), od["ABD"]))


def engine_ctor(dev, refine: float, engine: str, label: str, tag: str,
                **kw):
    """Build a Problem on the ``engine`` and its core; print the ctor
    line."""
    import torch

    t0 = time.perf_counter()
    p = sh_i_problem(dev, refine, engine=engine, **kw)
    core, od = p.getFRCore()
    torch.cuda.synchronize()
    ctor_s = time.perf_counter() - t0
    print(f"{tag} {label}: engine {core.engine}, n_free={p.n_free} nnz="
          f"{p.op.pattern.nnz}; construction {ctor_s:.3f} s (host assembly,"
          " transfers)", flush=True)
    return p, {"n_free": p.n_free, "nnz": int(p.op.pattern.nnz),
               "ctor_s": ctor_s}


def engine_library(p, freqs, tag: str, lu: bool = True,
                   reps: int = 3) -> dict:
    """The engines' library calls on ``p``'s data, by CUDA events, each with
    its bound: the generalized eigh (Cholesky, two triangular solves, eigh,
    one back solve; ops/spectral.py) and ``torch.linalg.eigh`` alone, and
    one chunk of ENG_CHUNK dense complex128 LUs and their solves, a matrix
    a call as ops/sweep.py runs them (and the LUs as one batched call
    beside; ``lu=False`` leaves the LU out: at n = 11910 a chunk
    of 16 dense complex matrices would take 36 GB).  ``reps`` timed calls
    after a warm-up one.  Operations (real FLOPs): eigh 4/3 n^3 (tridiagonal
    reduction) + 2 n^3 (back-transformation), Cholesky n^3 / 3, each
    triangular solve with n right-hand sides n^3; a complex LU 8/3 n^3, its
    solve 8 n^2 a right-hand side; all at F64_TC_FLOPS.  Bytes: inputs read
    and outputs written once at HBM_BPS."""
    import torch

    from plate_inverse_problem_tpu_torch.ops import spectral, sweep
    from plate_inverse_problem_tpu_torch.ops.scatter import to_dense

    od = p.getFRCore()[1]
    n = p.n_free
    K_re, K_im = flat_stiffness(p, od)
    Kd = to_dense(K_re, od["rows"], od["cols"], n)
    Md = to_dense(od["MIn"], od["rows"], od["cols"], n)
    Kd, Md = 0.5 * (Kd + Kd.T), 0.5 * (Md + Md.T)
    n3 = float(n) ** 3
    cases = {
        "generalized_eigh": (lambda: spectral.generalized_eigh(Kd, Md),
                             (4 / 3 + 2 + 1 / 3 + 3) * n3, 3 * n * n * 8),
        "eigh": (lambda: torch.linalg.eigh(Md), (4 / 3 + 2) * n3,
                 2 * n * n * 8),
    }
    if lu:
        om = 2.0 * np.pi * torch.as_tensor(freqs[:ENG_CHUNK],
                                           device=p.device)
        A = sweep.dense_operator(K_re, K_im, od["MIn"], om, od["rows"],
                                 od["cols"], n)
        b = torch.ones(ENG_CHUNK, n, 1, dtype=A.dtype, device=p.device)
        LU, piv = torch.linalg.lu_factor(A)
        one = range(ENG_CHUNK)
        cases |= {
            # as the engine calls them, a matrix at a time, and the same
            # LUs as one batched call (another routine on the card)
            "lu_factor_chunk": (lambda: [torch.linalg.lu_factor(
                A[i:i + 1]) for i in one], ENG_CHUNK * 8 / 3 * n3,
                2 * A.numel() * 16),
            "lu_factor_chunk_one_batch": (
                lambda: torch.linalg.lu_factor(A), ENG_CHUNK * 8 / 3 * n3,
                2 * A.numel() * 16),
            "lu_solve_chunk": (lambda: [torch.linalg.lu_solve(
                LU[i:i + 1], piv[i:i + 1], b[i:i + 1]) for i in one],
                ENG_CHUNK * 8.0 * n * n, (LU.numel() + 2 * b.numel()) * 16),
        }
    rec = {}
    for name, (fn, ops, nbytes) in cases.items():
        ms = cuda_event_ms(fn, reps=reps)
        t_ops, t_bytes = ops / F64_TC_FLOPS, nbytes / HBM_BPS
        bound = 1e3 * max(t_ops, t_bytes)
        rec[name] = {"ms": ms, "bound_ms": bound,
                     "bound_by": "operations" if t_ops >= t_bytes
                     else "bytes"}
        print(f"{tag} library call {name} at n={n}"
              + (f", chunk {ENG_CHUNK}" if "lu" in name else "")
              + f": {ms:.3f} ms (CUDA events), bound {bound:.4f} ms "
              f"({rec[name]['bound_by']}), at {100 * bound / ms:.2f} % of "
              "it", flush=True)
    return rec


def engine_bench(dev, freqs, engine: str, mixed: dict) -> dict:
    """Phase 11 (a) and (b) on the bench plate through ``engine``."""
    from plate_inverse_problem_tpu_torch.ops import csr_kernel

    tag = f"[engines] (a) {engine}"
    p, rec = engine_ctor(dev, 1.0, engine, "bench sh_i refine=1", tag,
                         chunk=ENG_CHUNK)
    failed = []
    rec |= timed_sweeps(p, freqs, "bench sweep", tag)
    fr = rec.pop("fr")
    if engine == "modal":
        rec["basis_build_s"] = p._basis_build_s
        print(f"{tag} the basis (eigh + Rayleigh polish, once per theta, in "
              f"the first sweep): {p._basis_build_s:.3f} s", flush=True)
    checksum = float(np.abs(fr).sum())
    cs_rel = abs(checksum - BENCH_CHECKSUM) / BENCH_CHECKSUM
    print(f"{tag} FRF checksum {checksum!r} against the JAX CPU run's "
          f"{BENCH_CHECKSUM!r} (its modal engine): rel {cs_rel:.3e} (tol "
          f"{CHECKSUM_TOL})", flush=True)
    if not cs_rel <= CHECKSUM_TOL:
        failed.append(f"checksum rel {cs_rel:.3e}")
    try:
        rec["worst_rel_err"] = oracle_check(p, freqs, fr, peak_points(fr),
                                            "bench points", tag)
    except AssertionError as err:
        failed.append(str(err))
    rec["checksum"] = checksum
    rec["determinism"] = det = determinism(p, freqs, mixed["fr"], "bench",
                                           tag)
    if not (det["sweeps_identical"] and det["grads_identical"]):
        failed.append("not bit-reproducible")
    if engine == "modal" and rec["k3"] <= 0:
        failed.append("K3 launched no time in the modal sweep")
    if engine == "direct":
        # a lane's bits do not depend on which frequencies share its chunk
        q = sh_i_problem(dev, 1.0, engine="direct", chunk=ENG_CHUNK_ALT,
                         opdata=p.getFRCore()[1])
        ok = bool(np.array_equal(q.solveForward(freqs).cpu().numpy(), fr))
        rec["chunk_independent"] = ok
        print(f"{tag} the sweep at chunk {ENG_CHUNK_ALT} against chunk "
              f"{ENG_CHUNK}: identical {ok}", flush=True)
        if not ok:
            failed.append("a lane's bits depend on its chunk")

    # ---- (b) the inverse API through the engine -----------------------
    tag = f"[engines] (b) {engine}"
    truth = np.asarray(p.parameters, np.float64)
    th0 = truth * np.asarray(START)
    csr_kernel.reset_launches()
    (g,), (g_s,), _, _, k3_g = sync_times(lambda: p.getLossFunction(
        freqs, mixed["fr"], "MSE_LOG_AFC").grad(th0).cpu().numpy(), 1)
    g_dev = float(np.max(np.abs(g - mixed["g"])
                         / (ENG_GRAD_RTOL * np.abs(mixed["g"])
                            + ENG_GRAD_ATOL)))
    rf = p.getResidualFunction(freqs, mixed["fr"], kind="log_afc")
    outs, rj_s, rj_gb, _, k3_rj = sync_times(lambda: host(
        rf.value_and_jac(th0)))
    r, J = outs[-1]
    J_dev = jac_dev(J, mixed["J"])
    r_dev = float(np.abs(r - mixed["r"]).max() / np.abs(mixed["r"]).max())
    try:
        p.getResidualFunction(freqs, mixed["fr"], kind="log_afc",
                              jac_mode="adjoint")
        adj_raises = False
    except ValueError:
        adj_raises = True
    rec |= {"grad_s": g_s, "grad_dev": g_dev, "k3_grad": k3_g,
            "rj_fwd_s": rj_s, "rj_fwd_peak_gb": rj_gb, "k3_rj": k3_rj,
            "jac_mode": rf.jac_mode, "J_dev": J_dev, "r_dev": r_dev,
            "adjoint_raises": adj_raises}
    print(f"{tag} MSE_LOG_AFC gradient at truth x {START} in {g_s:.3f} s, "
          f"K3 {k3_g}: against the mixed engine's {g_dev:.3e} of (rtol "
          f"{ENG_GRAD_RTOL}, atol {ENG_GRAD_ATOL}); ResidualFunction "
          f"log_afc jac_mode {rf.jac_mode!r}: r + J first {rj_s[0]:.3f} s, "
          f"steady {rj_s[1]:.3f} s, peak {rj_gb:.2f} GB, K3 {k3_rj}; J vs "
          f"the mixed adjoint J {J_dev:.3e} of the tolerance (FWD_J_RTOL / "
          f"FWD_J_ATOL), r {r_dev:.3e} of max |r|; jac_mode='adjoint' "
          f"raises ValueError: {adj_raises}", flush=True)
    if not g_dev <= 1.0:
        failed.append(f"gradient {g_dev:.3e} of the tolerance")
    if rf.jac_mode != "fwd" or not J_dev <= 1.0 or not adj_raises:
        failed.append(f"jac_mode {rf.jac_mode}, J {J_dev:.3e}, adjoint "
                      f"raises {adj_raises}")
    if k3_g <= 0:
        failed.append("K3 launched no time in the gradient")
    if engine == "modal":
        loss = p.getLossFunction(freqs, mixed["fr"], "MSE_LOG_AFC",
                                 scaling_params=th0)
        (H,), (h_s,), _, _, _ = sync_times(
            lambda: loss.hessian(np.ones(truth.size)).cpu().numpy(), 1)
        Hm = mixed["H"]
        cols = [float(np.abs(H[:, j] - Hm[:, j]).max()
                      / np.abs(Hm[:, j]).max()) for j in range(truth.size)]
        sym = float(np.abs(H - H.T).max() / np.abs(H).max())
        print(f"{tag} Hessian at x = theta / theta_0 = 1 in {h_s:.3f} s: "
              f"asymmetry {sym:.3e} of max (tol {HESS_SYM_TOL}); columns "
              f"vs the mixed engine's {', '.join(f'{c:.3e}' for c in cols)}"
              f" of the column max (tol {HESS_FD_TOL})", flush=True)
        rec |= {"hessian_s": h_s, "hessian_asym": sym,
                "hessian_vs_mixed": cols}
        if not (sym <= HESS_SYM_TOL and max(cols) <= HESS_FD_TOL):
            failed.append(f"Hessian asym {sym:.3e}, vs mixed {cols}")
        (res,), (s,), _, _, _ = sync_times(lambda: p.solveInverse(
            th0, "MSE_LOG_AFC", "gn", ref_fr=(freqs, fr),
            use_scaling=True, N_steps=GN_STEPS, report=False, log=False), 1)
        err = (np.abs(res.x) - truth) / truth
        it = max(len(res.f_history), 1)
        print(f"{tag} solveInverse 'gn' (MSE_LOG_AFC, its own FRF at the "
              f"truth) from truth x {START}: {len(res.f_history)} iterations "
              f"in {s:.3f} s ({s / it:.3f} s/iter), status {res.status}; rel "
              f"err (|beta|) {', '.join(f'{e:+.3e}' for e in err)} (tol "
              f"{GN_TOL}); basis builds so far {p._modal_builds}", flush=True)
        rec["gn"] = {"s": s, "iters": len(res.f_history), "s_per_iter":
                     s / it, "rel_err": [float(e) for e in err]}
        if not np.all(np.abs(err) <= GN_TOL):
            failed.append(f"gn ends {err} from the truth")
        rec["library"] = engine_library(p, freqs, "[engines] (a)")
        # K3 at the polish's shape: the two flat operators on the n basis
        # vectors as lanes
        csr = csr_kernel.build_csr(p.getFRCore()[1]["rows"],
                                   p.getFRCore()[1]["cols"], p.n_free)
        rec["k3_polish"] = compare_csr(csr, 2, p.n_free, "f64",
                                       "modal polish (L = n)", 11,
                                       tag="[engines] (a)")
    if failed:
        raise AssertionError(f"[engines] (a)-(b) {engine}: "
                             + "; ".join(failed))
    return rec


def engine_d4(dev, freqs) -> dict:
    """Phase 11 (c): OrthotropicD4 through the direct engine."""
    import plate_inverse_problem_tpu_torch as pt

    tag = "[engines] (c)"
    d4 = pt.get_material(7920.0, "orthotropic_d4", **D4)
    p, rec = engine_ctor(dev, 1.0, "direct", "OrthotropicD4 bench", tag,
                         mat=d4, chunk=ENG_CHUNK)
    rec |= timed_sweeps(p, freqs, "sweep", tag)
    fr = rec.pop("fr")
    rec["worst_rel_err"] = oracle_check(p, freqs, fr, peak_points(fr),
                                        "4 points incl. the peak", tag)
    return rec


def engine_freq_dep(dev, freqs) -> dict:
    """Phase 11 (d): a frequency-dependent material asked for with the
    modal engine: the warning, the direct engine, the per-frequency splu,
    and the JAX package's pinned-beta check: the three frequencies in one
    sweep against Problems with beta pinned to beta(omega_i), each at its
    frequency (tests/test_problem.py:485-507)."""
    import warnings

    import plate_inverse_problem_tpu_torch as pt

    tag = "[engines] (d)"
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        p, rec = engine_ctor(dev, 1.0, "modal", "beta0 (1 + omega / "
                             "omega_ref), asked for with engine='modal'",
                             tag, mat=freq_dep_material(FD_BETA0),
                             chunk=ENG_CHUNK)
    warned = [str(w.message) for w in caught
              if issubclass(w.category, RuntimeWarning)
              and "frequency-dependent" in str(w.message)]
    engine = p.getFRCore()[0].engine
    print(f"{tag} RuntimeWarning: {warned[0] if warned else None!r}; the "
          f"core's engine {engine!r}", flush=True)
    if not warned or engine != "direct":
        raise AssertionError(f"{tag}: warned {warned}, engine {engine}")
    rec |= timed_sweeps(p, freqs, "sweep", tag)
    fr = rec.pop("fr")
    rec["worst_rel_err"] = oracle_check(
        p, freqs, fr, peak_points(fr), "4 points incl. the peak (the "
        "transform at each frequency)", tag)
    y_fd = p.solveForward(np.asarray(FD_PIN_FREQS)).cpu().numpy()
    theta = np.asarray(p.parameters, np.float64)
    pins = []
    for i, f in enumerate(FD_PIN_FREQS):
        b_i = FD_BETA0 * (1.0 + 2.0 * np.pi * f / FD_OMEGA_REF)
        q = sh_i_problem(dev, 1.0, mat=pt.get_material(
            7920.0, "isotropic", E=200e9, G=75e9, beta=b_i),
            engine="direct", opdata=p.getFRCore()[1])
        y_i = q.solveForward([f], [theta[0], theta[1], b_i]).cpu().numpy()
        pins.append(float(abs(y_fd[i] - y_i[0]) / abs(y_i[0])))
    print(f"{tag} the sweep of {FD_PIN_FREQS} Hz against Problems with beta "
          f"pinned to beta(omega_i), each at its frequency: rel "
          f"{', '.join(f'{x:.3e}' for x in pins)} (tol {FD_PIN_TOL})",
          flush=True)
    rec["pinned_rel"] = pins
    if not max(pins) <= FD_PIN_TOL:
        raise AssertionError(f"{tag}: pinned-beta check {pins}")
    return rec


def engine_bending(dev, freqs) -> dict:
    """Phase 11 (e): the pure-bending path through both engines."""
    tag = "[engines] (e)"
    out = {}
    for engine in ("modal", "direct"):
        p, rec = engine_ctor(dev, 1.0, engine, "pure bending sh_i "
                             "refine=1", tag, accel=False, chunk=ENG_CHUNK)
        rec |= timed_sweeps(p, freqs, f"{engine} sweep", tag)
        fr = rec.pop("fr")
        if not (p.is_symmetric_path and np.iscomplexobj(fr)):
            raise AssertionError(f"{tag}: not the pure-bending path")
        rec["worst_rel_err"] = oracle_check(
            p, freqs, fr, peak_points(fr), f"{engine}, 4 points incl. the "
            "peak", tag)
        out[f"bending_{engine}"] = rec
        del p
    return out


def engine_basics(dev) -> dict:
    """Phase 11 (f): examples/basics.py's workflow through the port's modal
    engine, its four sums against the JAX package's CPU run (BASICS_JAX)."""
    import torch

    import plate_inverse_problem_tpu_torch as pt

    tag = "[engines] (f)"
    t0 = time.perf_counter()
    acc = pt.Accelerometer("AP1030")
    geom = pt.Geometry("symm", acc,
                       pt.GeometryParams(100e-3, 20e-3, 2e-3, 10e-3, None))
    mat = pt.get_material(7920.0, "isotropic", E=200 * 1e9, G=75 * 1e9,
                          beta=0.003)
    p = pt.Problem(geom, mat, acc, device=dev, engine="modal")
    N = 50
    freq = np.linspace(40, 600, N)
    fr = p.solveForward(freq).cpu().numpy()
    p0 = [0.1, 0.1, 0.2]
    res = p.solveInverseLocal(
        p0, "MSE_LOG_AFC", "grad_descent", ref_fr=[freq, fr],
        compression=(False, N), use_rel=True, report=False, log=False,
        N_steps=2, h=0.001, f_min=1e-5)
    r1 = p.solveForward(freq, (np.array(p0) + 1) * p.parameters)
    r2 = p.solveForward(freq, res.x)
    sums = {"FR": float(np.abs(fr).sum()),
            "Initial": float(np.abs(r1.cpu().numpy()).sum()),
            "After": float(np.abs(r2.cpu().numpy()).sum()),
            "F_hist": float(np.abs(res.f_history).sum())}
    torch.cuda.synchronize()
    s = time.perf_counter() - t0
    rel = {k: abs(v - BASICS_JAX[k]) / abs(BASICS_JAX[k])
           for k, v in sums.items()}
    print(f"{tag} examples/basics.py (symm, n={p.n_free}, modal) in {s:.3f}"
          " s: " + "; ".join(f"{k} {v!r} (rel {rel[k]:.3e} to the JAX CPU "
                             "run's)" for k, v in sums.items())
          + f" (tol {BASICS_TOL})", flush=True)
    if not max(rel.values()) <= BASICS_TOL:
        raise AssertionError(f"{tag}: sums {sums} vs {BASICS_JAX}")
    return {"n_free": p.n_free, "s": s, "sums": sums, "rel": rel}


def engine_scale(dev, freqs) -> dict:
    """Phase 11 (g): the modal engine at n = 11910: construction, the basis
    (eigh and polish) in the first sweep, a steady sweep, splu at 4
    points."""
    tag = "[engines] (g)"
    p, rec = engine_ctor(dev, 3.0, "modal", "sh_i refine=3", tag)
    rec |= timed_sweeps(p, freqs, "sweep", tag)
    fr = rec.pop("fr")
    rec["basis_build_s"] = p._basis_build_s
    print(f"{tag} the basis (eigh + Rayleigh polish) in the first sweep: "
          f"{p._basis_build_s:.3f} s", flush=True)
    rec["worst_rel_err"] = oracle_check(p, freqs, fr, peak_points(fr),
                                        "4 points incl. the peak", tag)
    rec["library"] = engine_library(p, freqs, tag, lu=False, reps=1)
    return rec


def engines(dev) -> dict:
    """Phase 11 on ``dev``: (a)-(b) the bench plate through the modal and
    the direct engine, forward and inverse, against the mixed engine's
    derivatives; (c)-(e) the other plates and materials; (f) the basics
    workflow; (g) the modal engine at n = 11910.  Every part runs before a
    failed check of any of them raises.  Returns the numbers for [summary]
    and K3's launches by path under "k3"."""
    freqs = np.linspace(40.0, 600.0, N_FREQ)
    p = sh_i_problem(dev, 1.0)
    truth = np.asarray(p.parameters, np.float64)
    th0 = truth * np.asarray(START)
    fr = p.solveForward(freqs).cpu().numpy()
    mixed = {"fr": fr,
             "g": p.getLossFunction(freqs, fr, "MSE_LOG_AFC").grad(
                 th0).cpu().numpy(),
             "H": p.getLossFunction(freqs, fr, "MSE_LOG_AFC",
                                    scaling_params=th0).hessian(
                 np.ones(truth.size)).cpu().numpy()}
    mixed["r"], mixed["J"] = host(p.getResidualFunction(
        freqs, fr, kind="log_afc").value_and_jac(th0))
    del p
    failed = []

    def run(fn, *args):
        try:
            return fn(*args)
        except AssertionError as err:
            failed.append(str(err))
            return None

    out = {"modal": run(engine_bench, dev, freqs, "modal", mixed),
           "direct": run(engine_bench, dev, freqs, "direct", mixed),
           "d4_direct": run(engine_d4, dev, freqs),
           "freq_dep": run(engine_freq_dep, dev, freqs),
           "bending": run(engine_bending, dev, freqs),
           "basics": run(engine_basics, dev),
           "scale": run(engine_scale, dev, freqs)}
    if failed:
        raise AssertionError("phase 11 failed: " + " | ".join(failed))
    out["k3"] = {"modal_sweep_1466": out["modal"]["k3"],
                 "modal_grad_1466": out["modal"]["k3_grad"],
                 "modal_rj_fwd_1466": out["modal"]["k3_rj"],
                 "direct_grad_1466": out["direct"]["k3_grad"],
                 "direct_rj_fwd_1466": out["direct"]["k3_rj"],
                 "modal_sweep_11910": out["scale"]["k3"]}
    out["k3_direct_sweep_1466"] = out["direct"]["k3"]
    return out


# ---------------------------------------------------------------------------
# phase 13: the diagnostics, K3's long rows, the compat layer
# ---------------------------------------------------------------------------

def long_row_pattern(dev, n: int = LONG_N, seed: int = 0):
    """Phase 13 (a)'s synthetic pattern (a dense row of a synthetic pencil
    or a coarse restriction at a large factor; no plate has one): n x n, a
    band of 25 columns a row (K3's tiles), and every LONG_EVERY-th row with
    LONG_COLS[0]-LONG_COLS[1] distinct random columns (K3's long rows), in
    a shuffled order (the data read through the plan's permutation), with
    its CSR copy on ``dev``."""
    import torch

    from plate_inverse_problem_tpu_torch.ops import csr_kernel as ck

    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for i in range(n):
        c = np.arange(max(0, i - 12), min(n, i + 13))
        if i % LONG_EVERY == 7:
            k = int(rng.integers(LONG_COLS[0], LONG_COLS[1] + 1))
            c = np.union1d(c, rng.choice(n, k, replace=False))
        rows.append(np.full(c.size, i))
        cols.append(c)
    r, c = np.concatenate(rows), np.concatenate(cols)
    perm = rng.permutation(r.size)
    return ck.build_csr(torch.as_tensor(r[perm], device=dev),
                        torch.as_tensor(c[perm], device=dev), n)


def long_rows(dev, ab=()) -> dict:
    """Phase 13 (a): K3 with long rows beside each tile kernel, against
    its plain version (LONG_TOL of max |y| in f64, CSR_TOL in f32), two
    launches bit for bit, timed beside its bound and torch.sparse.mm, the
    tiles' and the long rows' launches alone, and the A/B kernels ``ab``
    (``--ab-csr``: the parent's, its bits on the other rows); then the
    sparse API's ``matvec`` on the same pattern (its plan built by
    ``create_symbolic``) against the plain version, through the long-row
    kernel."""
    import torch

    from plate_inverse_problem_tpu_torch.ops import csr_kernel as ck
    from plate_inverse_problem_tpu_torch.ops import sparse_api

    csr = long_row_pattern(dev)
    lens = np.diff(csr.rowptr.cpu().numpy())[csr.long_rows.cpu().numpy()]
    print(f"[slice11] (a) K3 long rows: n={csr.n} nnz={csr.nnz}, "
          f"{csr.n_long} long rows of {lens.min()}-{lens.max()} entries "
          f"({lens.sum()} of the nonzeros) in {csr.n_groups} groups over "
          f"{csr.long_win.numel()} column windows (a group's most entries "
          f"in a stage of {ck.LONG_BATCHES} windows: {csr.long_stage_max}), "
          f"{csr.n_tiles} tiles for the rest; build_csr "
          f"{1e3 * csr.plan_s:.1f} ms on the host", flush=True)
    recs = []
    for seed, (S, L, dt, label) in enumerate(LONG_CASES):
        before = dict(ck.csr_mv_cuda.launches_by_regime)
        rec = compare_csr(csr, S, L, dt, label, seed, ab, ones=L == 1,
                          tag="[slice11] (a)",
                          tol=LONG_TOL if dt == "f64" else None)
        after = ck.csr_mv_cuda.launches_by_regime
        rec["long_launches"] = after["long"] - before["long"]
        if rec["long_launches"] <= 0:
            raise AssertionError(f"{label}: the long-row kernel never ran")
        print(f"[slice11] (a) {label}: tiles {rec['tile_ms']:.4f} ms + long "
              f"rows {rec['long_ms']:.4f} ms alone"
              + "".join(f"; {name}: tiles {rec[name + '_tile_ms']:.4f} + "
                        f"long rows {rec[name + '_long_ms']:.4f} ms, the "
                        f"whole call {rec[name + '_ms']:.4f}"
                        for name, _ in ab if name + "_long_ms" in rec)
              + f"; torch.sparse.mm {rec['library_ms']:.4f} ms, bound "
              f"{rec['bound_ms']:.4f} ms ({card_info()})", flush=True)
        recs.append(rec)
    # the sparse API's matvec on the pattern: 8 lanes, CSC data from a seed
    rows, cols = csr.rows.cpu().numpy(), csr.cols.cpu().numpy()
    (r, c), pat = sparse_api.create_symbolic(
        csr.n, np.stack([rows, cols], axis=1), np.float64)
    rng = np.random.default_rng(len(recs))
    data = torch.as_tensor(rng.standard_normal(r.size), device=dev)
    x = torch.as_tensor(rng.standard_normal((8, csr.n)), device=dev)
    before = dict(ck.csr_mv_cuda.launches_by_regime)
    y = sparse_api.matvec(pat, data, x)
    y2 = sparse_api.matvec(pat, data, x)
    torch.cuda.synchronize()
    launched = ck.csr_mv_cuda.launches_by_regime["long"] - before["long"]
    plan = pat.plans(data.device)[0]
    y_ref = ck.csr_mv_reference(data[None], x, plan)[0]
    rel = float((y - y_ref).abs().max()) / float(y_ref.abs().max())
    same = bool(torch.equal(y, y2))
    want = 2 * ck.long_kernels(8)
    print(f"[slice11] (a) sparse API matvec on the pattern ({plan.n_long} "
          f"long rows, 8 lanes): rel {rel:.3e} (tol {LONG_TOL}), two calls "
          f"identical: {same}, long-row kernels {launched} (want {want})",
          flush=True)
    if not (rel <= LONG_TOL and same and launched == want):
        raise AssertionError(f"the sparse API's matvec on the long-row "
                             f"pattern: rel {rel:.3e}, identical {same}, "
                             f"long-row kernels {launched}")
    return {"cases": recs, "matvec": {"rel_err": rel, "identical": same,
                                      "long_launches": launched}}


def polish_plate(p, freqs, label: str) -> dict:
    """Phase 13 (b) on ``p``: the sweep at theta = truth x POLISH_SCALE,
    then ``polish_peaks`` (one pass) with its K1 / K3 launches; the
    polished peaks against the refined splu before and after
    (ORACLE_TOL after)."""
    import torch

    from plate_inverse_problem_tpu_torch.diagnostics import polish_peaks
    from plate_inverse_problem_tpu_torch.ops import band_kernel, csr_kernel
    from plate_inverse_problem_tpu_torch.oracle import splu_frf

    th = np.asarray(p.parameters, np.float64) * np.asarray(POLISH_SCALE)
    fr = p.solveForward(freqs, th).cpu().numpy()
    band_kernel.band_mv_f32_cuda.launches = 0
    csr_kernel.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fr_pol, info = polish_peaks(p, freqs, fr=fr, params=th)
    torch.cuda.synchronize()
    pol_s = time.perf_counter() - t0
    rec = {"n_free": p.n_free, "polish_s": pol_s,
           "k1": band_kernel.band_mv_f32_cuda.launches,
           "k3": csr_kernel.csr_mv_cuda.launches, "mode": info["mode"],
           "f_hz": info["freqs_hz"]}
    i = info["indices"]
    ref = splu_frf(p, freqs[i], th)
    rec["before"] = (np.abs(fr[i] - ref) / np.abs(ref)).tolist()
    rec["after"] = (np.abs(fr_pol[i] - ref) / np.abs(ref)).tolist()
    mask = np.ones(freqs.size, bool)
    mask[i] = False
    rec["others_unchanged"] = bool(np.array_equal(fr_pol[mask], fr[mask]))
    print(f"[slice11] (b) polish_peaks {label} (n={p.n_free}, theta = truth "
          f"x {POLISH_SCALE}): peaks at {rec['f_hz']} Hz, rel err vs the "
          f"refined splu before {rec['before']}, after {rec['after']} (tol "
          f"{ORACLE_TOL}); {pol_s:.3f} s, K1 {rec['k1']}, K3 {rec['k3']} "
          f"launches; other points unchanged: {rec['others_unchanged']}",
          flush=True)
    if not (info["mode"] == "residual" and max(rec["after"]) <= ORACLE_TOL
            and rec["others_unchanged"] and rec["k3"] > 0):
        raise AssertionError(f"polish_peaks {label}: {rec}")
    return rec


def polish_starved(dev) -> dict:
    """Phase 13 (b): JAX tests/test_diagnostics.py's starved case on the
    card — a Krylov budget of one cycle far from the basis point makes the
    correction non-contracting, and the safeguard returns the sweep's
    value verbatim."""
    import plate_inverse_problem_tpu_torch as pt
    from plate_inverse_problem_tpu_torch.diagnostics import polish_peaks

    acc = pt.Accelerometer("AP1030")
    mat = pt.get_material(7920.0, "isotropic", E=200e9, G=75e9, beta=0.003)
    geom = pt.Geometry("symm", acc, pt.GeometryParams(100e-3, 20e-3, 2e-3,
                                                      10e-3, None), ny=1)
    p = pt.Problem(geom, mat, acc, device=dev, n_refine=1, refine_tol=1e-14)
    freqs = np.linspace(60.0, 400.0, 17)
    th = np.asarray(p.parameters) * np.array([1.35, 0.72, 1.6])
    fr = p.solveForward(freqs, th).cpu().numpy()
    fr_p, info = polish_peaks(p, freqs, fr=fr, params=th, passes=2)
    rec = {"improved": info["improved"],
           "verbatim": bool(np.array_equal(fr_p, fr))}
    print(f"[slice11] (b) starved budget (symm ny=1, n_refine=1): improved "
          f"{rec['improved']}, returned verbatim {rec['verbatim']}",
          flush=True)
    if rec["improved"] != [False] or not rec["verbatim"]:
        raise AssertionError(f"starved polish: {rec}")
    return rec


def audit(p, freqs, fr, label: str) -> dict:
    """Phase 13 (c): ``diagnostics.oracle_check`` of a sweep (plain splu at
    the peak and three points over the band), to ORACLE_TOL."""
    from plate_inverse_problem_tpu_torch.diagnostics import oracle_check

    t0 = time.perf_counter()
    rep = oracle_check(p, freqs, fr=fr)
    rep["s"] = time.perf_counter() - t0
    print(f"[slice11] (c) oracle_check {label}: engine {rep['engine']}, "
          f"worst rel err {rep['worst_rel_err']:.3e} at {rep['at_hz']:.2f} "
          f"Hz of {rep['checked_hz']} (tol {ORACLE_TOL}); {rep['s']:.2f} s",
          flush=True)
    if not rep["worst_rel_err"] <= ORACLE_TOL:
        raise AssertionError(f"oracle_check {label}: {rep}")
    return rep


def expansion(p, freqs, fr) -> dict:
    """Phase 13 (d): the mode-acceleration expansion at the bench plate
    against its mixed sweep (EXP_TOL), with its checksum interval; and on
    tests/test_golden_parity.py's plate (symm ny = 4) the reference's
    golden 341.9363 inside the interval of a 1 % resonance error bar, the
    port's own checksum near 147 (the JAX test's bounds)."""
    import plate_inverse_problem_tpu_torch as pt
    from plate_inverse_problem_tpu_torch.diagnostics import parity

    t0 = time.perf_counter()
    exp = parity.modal_frf_expansion(p, 600.0, n_modes_min=48)
    exp_s = time.perf_counter() - t0
    fe = parity.frf_from_expansion(exp, freqs)
    rel = float(np.max(np.abs(fe - fr) / np.abs(fr)))
    lo, hi = parity.checksum_interval(exp, freqs, [0.01], slack=1.0,
                                      n_samples=800)
    rec = {"n_free": p.n_free, "modes": int(exp["lam"].size),
           "expansion_s": exp_s, "rel_vs_sweep": rel,
           "checksum": float(fe.sum()), "interval": [lo, hi],
           "resonances_hz": parity.resonances_hz(exp, 600.0).tolist()}
    acc = pt.Accelerometer("AP1030")
    mat = pt.get_material(7920.0, "isotropic", E=200e9, G=75e9, beta=0.003)
    geom = pt.Geometry("symm", acc, pt.GeometryParams(100e-3, 20e-3, 2e-3,
                                                      10e-3, None), ny=4)
    q = pt.Problem(geom, mat, acc, device=p.device, engine="modal")
    t0 = time.perf_counter()
    eq = parity.modal_frf_expansion(q, 600.0, n_modes_min=48)
    rec["golden_expansion_s"] = time.perf_counter() - t0
    f50 = np.linspace(40.0, 600.0, 50)
    rec["golden_n_free"] = q.n_free
    rec["golden_ours"] = float(parity.frf_from_expansion(eq, f50).sum())
    rec["golden_interval"] = list(parity.checksum_interval(
        eq, f50, [0.01], slack=1.0, n_samples=800))
    print(f"[slice11] (d) modal_frf_expansion n={p.n_free}: {rec['modes']} "
          f"modes in {exp_s:.3f} s (generalized_eigh on the card), "
          f"resonances {rec['resonances_hz']} Hz, against the mixed sweep "
          f"{rel:.3e} (tol {EXP_TOL}); checksum {rec['checksum']:.6f} in "
          f"[{lo:.4f}, {hi:.4f}] at a 1 % eigenvalue bar; symm ny=4 (n="
          f"{q.n_free}, {rec['golden_expansion_s']:.3f} s): checksum "
          f"{rec['golden_ours']:.4f}, interval {rec['golden_interval']} "
          f"(the golden {GOLDEN} inside)", flush=True)
    glo, ghi = rec["golden_interval"]
    if not (rel <= EXP_TOL and lo <= rec["checksum"] <= hi
            and glo < GOLDEN < ghi and abs(rec["golden_ours"] - 147.0) < 6.0):
        raise AssertionError(f"modal expansion: {rec}")
    return rec


def traced_sweep(p, freqs) -> dict:
    """Phase 13 (e): ``diagnostics.profile_call`` of one steady bench
    sweep through the core: its Chrome trace names K3's, K7a's and K7b's
    kernels exactly as often as their launch counters count them, and the
    device's busy share of the call from the trace's kernel times (phase
    16 (c) reads it)."""
    import torch

    from plate_inverse_problem_tpu_torch.diagnostics import profile
    from plate_inverse_problem_tpu_torch.ops import csr_kernel, fgmres_kernel

    core, od = p.getFRCore()
    f_t = torch.as_tensor(freqs, device=p.device)
    th = torch.as_tensor(np.asarray(p.parameters, np.float64),
                         device=p.device)
    core(f_t, th, od)                      # steady: warm caches
    csr_kernel.reset_launches()
    fgmres_kernel.reset_launches()
    logdir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "build", "traces")
    _, run, wall = profile.profile_call(core, f_t, th, od,
                                        label="bench_sweep", logdir=logdir,
                                        warmup=False)
    counted = csr_kernel.csr_mv_cuda.launches
    k7 = k7_counts()
    with open(os.path.join(run, profile.TRACE_FILE)) as fh:
        events = json.load(fh)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    k3 = [e for e in kernels if "csr_mv_" in e.get("name", "")]
    k7_trace = {k: sum(f"{k}_kernel" in e.get("name", "") for e in kernels)
                for k in ("givens_step", "backsub")}
    busy_ms = sum(e.get("dur", 0.0) for e in kernels) / 1e3
    rec = {"trace": os.path.relpath(run), "wall_s": wall,
           "k3_counted": counted, "k3_in_trace": len(k3),
           "kernels_in_trace": len(kernels), "device_busy_ms": busy_ms,
           "busy_share": busy_ms / (1e3 * wall),
           "k3_ms": sum(e.get("dur", 0.0) for e in k3) / 1e3,
           "k7_counted": k7, "k7_in_trace": k7_trace}
    print(f"[slice11] (e) profile_call bench sweep: {wall:.4f} s wall, "
          f"{len(kernels)} kernels in the Chrome trace, device busy "
          f"{busy_ms:.2f} ms ({100 * rec['busy_share']:.1f} %), K3 "
          f"{len(k3)} in the trace ({rec['k3_ms']:.2f} ms) against "
          f"{counted} counted, K7a / K7b {k7_trace['givens_step']} / "
          f"{k7_trace['backsub']} against {k7['givens_step']} / "
          f"{k7['backsub']}; trace {rec['trace']}", flush=True)
    if (counted <= 0 or len(k3) != counted or k7_fault(k7, "traced sweep")
            or k7_trace != {k: k7[k] for k in k7_trace}):
        raise AssertionError(f"trace vs counter: {rec}")
    return rec



def device_lib() -> dict:
    """Phase 13 (f): examples/test_device_lib.py's flow on the port:
    ``device_report`` and ``test_function`` on 5e7 f32 against numpy."""
    import torch

    from plate_inverse_problem_tpu_torch.diagnostics import (
        device_report, test_function)

    rep = device_report()
    x = np.random.default_rng(0).standard_normal(5 * 10**7).astype(
        np.float32)
    t0 = time.perf_counter()
    y = test_function(x, device=torch.device("cuda"))
    dt = time.perf_counter() - t0
    err = float(np.abs(y - (2.0 * x + np.sin(x))).max())
    rec = {"report": rep, "s": dt, "max_abs_err": err}
    print(f"[slice11] (f) device_report {rep}; test_function on 5e7 f32 in "
          f"{dt:.3f} s (copies included), max |delta| vs numpy {err:.3e} "
          f"(tol {DEVICE_LIB_TOL})", flush=True)
    dev0 = rep["devices"][0]
    if not (rep["backend"] == "cuda"
            and rep["n_devices"] == torch.cuda.device_count()
            and dev0["name"] == torch.cuda.get_device_name(0)
            and dev0["power_limit"] is not None and y.dtype == np.float32
            and err <= DEVICE_LIB_TOL):
        raise AssertionError(f"device report / test_function: {rec}")
    return rec


def compat_script() -> dict:
    """Phase 13 (g): tests/test_compat.py's script, verbatim but for its
    import, on the card (the Problem's default device)."""
    import plate_inverse_problem_tpu_torch.compat as jp

    acc = jp.Accelerometer.Accelerometer("AP1030")
    geom = jp.Geometry.Geometry(
        "symm", acc, jp.Geometry.GeometryParams(100e-3, 20e-3, 2e-3, 10e-3,
                                                None),
        ny=1,
    )
    mat = jp.Material.get_material(7920.0, "isotropic", E=200e9, G=75e9,
                                   beta=0.003)
    p = jp.Problem.Problem(geom, mat, acc)
    fr = p.solveForward(np.linspace(40, 100, 3))
    ok = (fr.is_cuda and bool(np.all(np.isfinite(fr.cpu().numpy())))
          and hasattr(jp.Optimizers, "optimize_trust_region")
          and hasattr(jp.Input, "Compressor") and hasattr(jp.Utils, "plot_fr")
          and hasattr(jp.Sparse, "sweep_solve"))
    print(f"[slice11] (g) compat script on {fr.device}: FRF "
          f"{fr.cpu().numpy().tolist()}, surface complete: {ok}", flush=True)
    if not ok:
        raise AssertionError("the compat script failed on the card")
    return {"fr": fr.cpu().numpy().tolist()}


def slice11(dev, p21, freqs, fr21, ab_csr=()) -> dict:
    """Phase 13 on ``dev``; ``p21`` / ``fr21``: phase 2's 21k Problem and
    its FRF at the truth; ``ab_csr``: the A/B kernels of ``--ab-csr``.  Every part runs before a failed check raises.
    Returns the numbers for [summary], with K1's and K3's launches by
    path under "k1" / "k3"."""
    import torch

    out, failed = {}, []

    def run(key, fn, *args):
        try:
            out[key] = fn(*args)
        except AssertionError as err:
            failed.append(str(err))

    t0 = time.perf_counter()
    run("long_rows", long_rows, dev, ab_csr)
    torch.cuda.empty_cache()
    out["a_s"] = time.perf_counter() - t0
    bench = sh_i_problem(dev, 1.0)
    fr_bench = bench.solveForward(freqs).cpu().numpy()
    t0 = time.perf_counter()
    run("polish_1466", polish_plate, bench, freqs, "bench plate")
    run("polish_21k", polish_plate, p21, freqs, "21k plate (two-grid)")
    run("starved", polish_starved, dev)
    if "polish_21k" in out and out["polish_21k"]["k1"] <= 0:
        failed.append("the 21k polish launched no K1")
    out["b_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    run("audit_1466", audit, bench, freqs, fr_bench, "bench plate")
    run("audit_21k", audit, p21, freqs, fr21, "21k plate")
    out["c_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    run("expansion", expansion, bench, freqs, fr_bench)
    out["d_s"] = time.perf_counter() - t0
    run("trace", traced_sweep, bench, freqs)
    run("device_lib", device_lib)
    run("compat", compat_script)
    del bench
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError("phase 13 failed: " + " | ".join(failed))
    out["k1"] = {"polish_21k": out["polish_21k"]["k1"]}
    out["k3"] = {"polish_1466": out["polish_1466"]["k3"],
                 "polish_21k": out["polish_21k"]["k3"],
                 "traced_sweep_1466": out["trace"]["k3_counted"]}
    return out


# ---------------------------------------------------------------------------
# phase 14: frequency sharding over torch.distributed
# ---------------------------------------------------------------------------

def shard_workflow() -> dict:
    """The ``python -m plate_inverse_problem_tpu_torch.parallel`` workflow
    as the module runs it (device "cuda": this rank's card, or the current
    one without a process group), on the engine the JAX package's CPU run
    of it takes (modal: an exact f64 solve on both sides; the mixed
    engine's 1e-9-grade solves move the Gauss-Newton iterates in the E-G
    valley the run ends in by ~1e-4); with its seconds and K3 launches."""
    import torch

    from plate_inverse_problem_tpu_torch.ops import csr_kernel
    from plate_inverse_problem_tpu_torch.parallel.__main__ import workflow

    k3 = csr_kernel.csr_mv_cuda.launches
    t0 = time.perf_counter()
    out = workflow("cuda", engine="modal", echo=lambda *a: None)
    torch.cuda.synchronize()
    out["s"] = time.perf_counter() - t0
    out["k3"] = csr_kernel.csr_mv_cuda.launches - k3
    return out


def shard_rank_nccl(rank, dev, out_dir, spec, workflow_too=True):
    """Phase 14 (a) and (d) in one rank of the NCCL world: the sharded
    checks with the single-process references, then the workflow as
    torchrun's ranks run it."""
    import torch

    from plate_inverse_problem_tpu_torch.parallel import ranks

    ranks.sharded_checks(rank, dev, out_dir, spec)
    if workflow_too:
        torch.save(shard_workflow(),
                   os.path.join(out_dir, f"workflow{rank}.pt"))


def shard_rank_gloo(rank, dev, *parts):
    """Phase 14 (b), (c) and (e) in turn in one rank of the two-rank gloo
    world: ``parts`` is (out_dir, spec) pairs, flattened."""
    from plate_inverse_problem_tpu_torch.parallel import ranks

    for out_dir, spec in zip(parts[::2], parts[1::2]):
        ranks.sharded_checks(rank, dev, out_dir, spec)


def shard_bits(recs, failed: list,
               keys=("frf", "train", "gn_adjoint", "gn_fwd")) -> None:
    """Every rank's runs of each step give the first's bits (else a line in
    ``failed``)."""
    def raw(run):
        parts = run if isinstance(run, tuple) else (run,)
        return b"".join(np.atleast_1d(np.asarray(x)).tobytes()
                        for x in parts)

    for key in keys:
        if key in recs[0]:
            runs = [raw(run) for r in recs for run in r[key]]
            if any(b != runs[0] for b in runs):
                failed.append(f"[slice12] {key}: ranks or runs differ in "
                              "their bits")


def shard_report(label, recs, steps) -> dict:
    """Print each step's wall seconds (synchronised; the fastest of its
    steady runs, the second on, where it ran more than once), collective
    seconds and K1 / K3 launches per rank; returns them."""
    out = {}
    for step in steps:
        row = {"s": [min(r["s"][step][1:] or r["s"][step]) for r in recs],
               "collective_s": [min(r["collective_s"][step][1:]
                                    or r["collective_s"][step]) for r in recs],
               "k1": [r["k1"][step] for r in recs],
               "k3": [r["k3"][step] for r in recs],
               "k5": [r["k5"][step] for r in recs]}
        print(f"[slice12] {label} {step}: wall "
              + " / ".join(f"{x:.4f}" for x in row["s"]) + " s, collectives "
              + " / ".join(f"{x:.4f}" for x in row["collective_s"])
              + f" s, K1 {row['k1']}, K3 {row['k3']}, row-block GEMMs (K5) "
              f"{row['k5']} (per rank; the fastest steady run's seconds, "
              "every run's launches)", flush=True)
        out[step] = row
    return out


def shard_memory(label, recs, i: int = 0) -> list:
    """Print, per rank, the bytes its Problem holds of each dense inverse
    after mesh ``i`` placed it, the device memory allocated and reserved
    before and after the placement (reserved also after ``empty_cache``)
    and the build's peak; returns them."""
    out = []
    for r, rec in enumerate(recs):
        m = rec["meshes"][i]
        mem = m["memory"]
        drop = mem["before"]["allocated"] - mem["placed"]["allocated"]
        row = {"held": m["held"], "drop": drop, "build_peak":
               rec["build_peak"], **mem}
        print(f"[slice12] {label} rank {r} memory: holds "
              + (", ".join(f"{k} {v / 1e6:.1f} MB"
                           for k, v in m["held"].items()) or "no inverse")
              + f"; allocated {mem['before']['allocated'] / 1e9:.4f} -> "
              f"{mem['placed']['allocated'] / 1e9:.4f} GB (drop "
              f"{drop / 1e6:.1f} MB), reserved "
              f"{mem['before']['reserved'] / 1e9:.4f} -> "
              f"{mem['placed']['reserved'] / 1e9:.4f} -> "
              f"{mem['released']['reserved'] / 1e9:.4f} GB (after "
              f"empty_cache); build peak {rec['build_peak'] / 1e9:.4f} GB",
              flush=True)
        out.append(row)
    return out


def shard_close(name, x, ref, tol, failed: list, rel_max=False) -> float:
    """Print x's deviation from ref (relative, or of ref's max |entry|) and
    record it in ``failed`` when it exceeds tol."""
    x, ref = np.asarray(x), np.asarray(ref)
    dev = np.abs(x - ref) / (np.max(np.abs(ref)) if rel_max else np.abs(ref))
    err = float(np.max(dev))
    each = f" {np.array2string(dev, precision=2)}" if 1 < dev.size <= 8 else ""
    print(f"[slice12] {name}: {err:.3e}{each} (tol {tol:g})", flush=True)
    if not err <= tol:
        failed.append(f"[slice12] {name}: {err:.3e} > {tol:g}")
    return err


def slice12(dev, parts: str = "abcdfg", p21=None) -> dict:
    """Phase 14: the sharded sweep, training step and Gauss-Newton step,
    each rank a process forked from a forkserver (``ranks.spawn``).
    (a) the bench plate over NCCL, one rank per card, against the
    single-process port; (b) the same plate, two ranks on ``dev`` over
    gloo, as a (freq 2, dof 1) and a (freq 1, dof 2) mesh, against (a)
    (the dof mesh's FRF: the unsharded sweep's bits); (c) the 13862-DOF
    pure-bending plate (band + two-grid) on the (freq 1, dof 2) mesh, each
    rank holding its share of every partitioned entry, its FRF the
    unsharded sweep's bits; (d) the package's parallel workflow, in the
    NCCL world and in this process without a process group (the plain
    ``python -m`` run), against the JAX package's CPU run; (e) the
    11910-DOF dense-tier plate on (b)'s ranks as (freq 1, dof 2),
    ``invK64`` and ``W64`` row-owned (``dof_dense``); (f) the 20916-DOF
    plate (band + two-grid) on (b)'s ranks as (freq 1, dof 2)
    (``dof_twogrid``; ``p21``: a Problem of that plate in this process for
    the splu oracle, built here when None); (g) the bench plate's
    two-grid (``precond="mg"``, the band layout) on DOF_WIDE gloo ranks of
    the card as (freq 1, dof DOF_WIDE), wider than its band's groups
    (``dof_wide``).  ``parts``: which of them to run ((a) always: (b) is
    held against it; (f) and (g) with (b)).  A rank's exception raises
    here."""
    import torch

    from plate_inverse_problem_tpu_torch.parallel import ranks
    from plate_inverse_problem_tpu_torch.parallel.freq_shard import (
        row_range)

    world = torch.cuda.device_count()
    root = os.path.join("build", "parallel")
    dirs = {k: os.path.join(root, k)
            for k in ("a", "b", "c", "e", "e_nccl", "f", "f_nccl", "g")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    bench = {"geometry": "sh_i", "refine": 1.0}
    steps = ("train", "gn_adjoint", "gn_fwd")
    common = {"freqs": (40.0, 600.0, N_FREQ), "theta": SHARD_THETA,
              "repeats": 2, "steps": steps}
    out, failed = {}, []

    def done():
        if failed:
            raise AssertionError("phase 14 failed: " + " | ".join(failed))
        return out

    # ---- (a) + (d): NCCL, one rank per card -------------------------------
    t0 = time.perf_counter()
    ranks.spawn(shard_rank_nccl, world, dirs["a"],
                {"plate": bench, "meshes": [(world, 1)], "reference": True,
                 **common, "steps": steps + REGROUP_STEPS,
                 "chunk": N_FREQ // 2, "control": True},
                "d" in parts, device="cuda")
    out["a_s"] = time.perf_counter() - t0
    a = ranks.load(dirs["a"], world)
    ma = [r["meshes"][0] for r in a]
    ref = {k: ma[0]["ref_" + k][0]
           for k in ("frf", "train", "gn_adjoint", "gn_fwd")}
    print(f"[slice12] (a) bench plate n={a[0]['n_free']} tier {a[0]['tier']}"
          f", NCCL world {world} (freq {world}, dof 1), {N_FREQ} points: "
          f"{out['a_s']:.1f} s with the spawn and the rank's build "
          f"({a[0]['build_s']:.2f} s)", flush=True)
    if world == 1:
        if not np.array_equal(ma[0]["frf"][0], ref["frf"]):
            failed.append("[slice12] (a) the sharded FRF is not the "
                                 "unsharded sweep's bits at world 1")
        print("[slice12] (a) FRF: the unsharded sweep's bits", flush=True)
    for m in ma:
        shard_close("(a) FRF vs unsharded", m["frf"][0][:N_FREQ],
                    ref["frf"], SHARD_TOL, failed)
        shard_close("(a) loss vs LossFunction", m["train"][0][0],
                    ref["train"][0], SHARD_TOL, failed)
        shard_close("(a) grad vs LossFunction", m["train"][0][1],
                    ref["train"][1], SHARD_GRAD_TOL, failed, rel_max=True)
        for mode in ("adjoint", "fwd"):
            rsq, th = m[f"gn_{mode}"][0]
            shard_close(f"(a) GN {mode} |r|^2 vs host normal equations", rsq,
                        ref[f"gn_{mode}"][0], SHARD_TOL, failed)
            shard_close(f"(a) GN {mode} update vs host normal equations", th,
                        ref[f"gn_{mode}"][1],
                        SHARD_TOL if world == 1 else SHARD_REGROUP_TOL,
                        failed)
        # the regrouping witness: the same rank's step with its lanes in
        # two batches of N_FREQ / 2 (at world 1 the single-process port
        # batched as the (freq 2, dof 1) mesh of (b) batches it) against
        # the whole batch, and the control: a pad lane left in
        for mode, name in zip(("adjoint", "fwd"), REGROUP_STEPS):
            (rsq, th), (rsq_w, th_w) = m[f"gn_{mode}"][0], m[name][0]
            shard_close(f"(a) GN {mode} |r|^2, freq_chunk {N_FREQ // 2} vs "
                        "the whole batch", rsq_w, rsq, SHARD_TOL, failed)
            out.setdefault("witness", []).append(shard_close(
                f"(a) GN {mode} update, freq_chunk {N_FREQ // 2} vs the "
                "whole batch (witness)", th_w, th, SHARD_REGROUP_TOL,
                failed))
        ctrl = shard_close("(a) GN adjoint update, a pad lane left in vs "
                           "host normal equations (control: must exceed "
                           "the bound)", m["ctrl_pad"][0][1],
                           ref["gn_adjoint"][1], np.inf, failed)
        out.setdefault("control", []).append(ctrl)
        if not ctrl > SHARD_REGROUP_TOL:
            failed.append(f"[slice12] (a) the control's {ctrl:.3e} is "
                          f"within the regrouping bound {SHARD_REGROUP_TOL:g}"
                          ": the bound cannot see a pad lane left in")
    shard_bits(ma, failed)
    out["a"] = shard_report("(a)", ma, ("frf",) + steps + REGROUP_STEPS + (
        "ref_frf", "ref_train", "ref_gn_adjoint", "ref_gn_fwd", "ctrl_pad"))
    if min(sum(m["k3"].values()) for m in ma) <= 0:
        failed.append("[slice12] (a) a rank launched no K3")

    if "d" not in parts:
        return done()
    # (d) the workflow against the JAX package's CPU run: rank 0 of the
    # NCCL world (torchrun's path) and this process, no process group
    # (the plain run's path)
    wfs = {"NCCL rank 0": torch.load(os.path.join(dirs["a"], "workflow0.pt"),
                                     weights_only=False),
           "plain process": shard_workflow()}
    for label, wf in wfs.items():
        print(f"[slice12] (d) parallel workflow, {label} ({wf['s']:.2f} s, "
              f"K3 {wf['k3']}): FRF sum {wf['frf_sum']:.4f}, losses "
              f"{wf['losses']}, GN "
              f"{[(f'{x:.6e}', ok) for x, _, ok in wf['gn']]}, final "
              f"|r|^2 {wf['rsq']!r}", flush=True)
        shard_close(f"(d) {label} training losses vs JAX", wf["losses"],
                    MULTICHIP_JAX["losses"], MULTICHIP_TOL, failed)
        shard_close(f"(d) {label} final |r|^2 vs JAX", wf["rsq"],
                    MULTICHIP_JAX["final_rsq"], MULTICHIP_TOL, failed)
    out["d"] = {label: {k: w[k] for k in ("s", "k3", "frf_sum", "losses",
                                          "rsq")}
                for label, w in wfs.items()}
    if "b" not in parts:
        return done()

    # ---- (b), (c), (e) + (f): two gloo ranks on one card ----------------
    spec_e = {"plate": {"geometry": "sh_i", "refine": 3.0},
              "meshes": [(1, 2)], "freqs": (40.0, 600.0, N_FREQ),
              "theta": SHARD_THETA, "repeats": 2, "steps": (),
              "at_theta": True, "reference": "frf"}
    spec_f = {"plate": {"geometry": "sh_i", "refine": 4.0},
              "meshes": [(1, 2)], "freqs": (40.0, 600.0, DOF_TG_FREQ),
              "theta": SHARD_THETA, "repeats": 1, "steps": ("gn_adjoint",),
              "at_theta": True, "reference": True}
    t0 = time.perf_counter()
    ranks.spawn(shard_rank_gloo, 2, dirs["b"],
                {"plate": bench, "meshes": [(2, 1), (1, 2)], **common},
                dirs["c"],
                {"plate": {"geometry": "sh_i", "refine": 4.0,
                           "accel": False},
                 "meshes": [(1, 2)], "freqs": (40.0, 600.0, N_FREQ),
                 "theta": SHARD_THETA, "repeats": 1, "steps": (),
                 "oracle": True, "reference": True},
                dirs["e"], spec_e,
                *((dirs["f"], spec_f) if "f" in parts else ()),
                backend="gloo", device=f"cuda:{dev.index or 0}")
    out["bcef_s"] = time.perf_counter() - t0
    b = ranks.load(dirs["b"], 2)
    n = b[0]["n_free"]
    for i, label in enumerate(("(b) freq 2", "(b) dof 2")):
        mb = [r["meshes"][i] for r in b]
        shard_bits(mb, failed)
        frf_tol = SHARD_TOL if i == 0 else DOF_FRF_TOL
        shard_close(f"{label} FRF vs (a)", mb[0]["frf"][0][:N_FREQ],
                    ma[0]["frf"][0][:N_FREQ], frf_tol, failed)
        if i == 1:
            dof_bits(label, mb, ref["frf"], "(a)'s unsharded sweep", failed)
        shard_close(f"{label} loss vs (a)", mb[0]["train"][0][0],
                    ma[0]["train"][0][0], SHARD_TOL, failed)
        shard_close(f"{label} grad vs (a)", mb[0]["train"][0][1],
                    ma[0]["train"][0][1], SHARD_GRAD_TOL, failed,
                    rel_max=True)
        for mode in ("adjoint", "fwd"):
            (rsq, th), (rsq_a, th_a) = (mb[0][f"gn_{mode}"][0],
                                        ma[0][f"gn_{mode}"][0])
            shard_close(f"{label} GN {mode} |r|^2 vs (a)", rsq, rsq_a,
                        SHARD_TOL, failed)
            shard_close(f"{label} GN {mode} update vs (a)", th, th_a,
                        SHARD_REGROUP_TOL, failed)
            if i == 0 and world == 1:
                # two ranks of 256 lanes each: the witness's batches
                th_w = ma[0][REGROUP_STEPS[mode == "fwd"]][0][1]
                shard_close(f"{label} GN {mode} update vs (a)'s witness",
                            th, th_w, SHARD_TOL, failed)
        mw = mb[0]["held_whole"]["W64"] // (8 * n)
        for r, m in enumerate(mb):
            lo, hi = (0, n) if i == 0 else row_range(n, 2, r)
            want = {} if i == 0 else {"invK64": (hi - lo, n),
                                      "W64": (hi - lo, mw)}
            held = {"invK64": (hi - lo) * n * 8, "W64": (hi - lo) * mw * 8}
            if m["shards"] != want or m["held"] != held:
                failed.append(f"[slice12] {label} rank {r}: shards "
                              f"{m['shards']}, held {m['held']}, not "
                              f"{want}, {held}")
        out[f"b{i}_memory"] = shard_memory(label, b, i)
        if i == 1:
            owned_rows(label, mb, out[f"b{i}_memory"], failed)
        if min(sum(m["k3"].values()) for m in mb) <= 0:
            failed.append(f"[slice12] {label}: a rank launched no K3")
        out[f"b{i}"] = shard_report(label, mb, ("frf",) + steps)
    c = ranks.load(dirs["c"], 2)
    mc = [r["meshes"][0] for r in c]
    shard_bits(mc, failed)
    f_pk, err = mc[0]["peak"]
    print(f"[slice12] (c) two-grid plate n={c[0]['n_free']} tier "
          f"{c[0]['tier']} (build {c[0]['build_s']:.2f} s), 2 gloo ranks as "
          f"(freq 1, dof 2), shares {mc[0]['shards']} / {mc[1]['shards']}: "
          f"peak {f_pk:.2f} Hz vs the refined splu {err:.3e} (tol "
          f"{ORACLE_TOL:g}); {out['bcef_s']:.1f} s for (b), (c), (e) and "
          "(f) with the spawn", flush=True)
    if not err <= ORACLE_TOL:
        failed.append(f"[slice12] (c) peak {err:.3e} > {ORACLE_TOL}")
    dof_bits("(c)", mc, mc[0]["ref_frf"][0], "the unsharded sweep of the "
             "same plate", failed)
    out["c_memory"] = shard_memory("(c)", c)
    owned_rows("(c)", mc, out["c_memory"], failed)
    dof_shares("(c)", mc, failed)
    out["c"] = shard_report("(c)", mc, ("frf",))
    out["e"] = dof_dense(dev, dirs, spec_e, world, failed)
    out["k1"] = {f"slice12_twogrid_rank{r}": m["k1"]["frf"]
                 for r, m in enumerate(mc)}
    if "f" in parts:
        out["f"] = dof_twogrid(dev, dirs, spec_f, p21, failed)
        out["k1"] |= {f"slice15_twogrid21k_rank{r}": k
                      for r, k in enumerate(out["f"]["k1"])}
    if "g" in parts:
        out["g"] = dof_wide(dev, dirs["g"], failed)
        out["k1"] |= {f"slice16_wide_rank{r}": k
                      for r, k in enumerate(out["g"]["k1"])}
    out["k3"] = {**{f"slice12_nccl_rank{r}": sum(m["k3"].values())
                    for r, m in enumerate(ma)},
                 **{f"slice12_gloo_rank{r}": sum(
                     sum(r_["meshes"][i]["k3"].values()) for i in (0, 1))
                    for r, r_ in enumerate(b)},
                 **{f"slice12_twogrid_rank{r}": m["k3"]["frf"]
                    for r, m in enumerate(mc)},
                 **{f"slice12_dense_rank{r}": k
                    for r, k in enumerate(out["e"]["k3"])},
                 "slice12_workflow": wfs["NCCL rank 0"]["k3"],
                 "slice12_workflow_plain": wfs["plain process"]["k3"]}
    if "g" in parts:
        out["k3"] |= {f"slice16_wide_rank{r}": k
                      for r, k in enumerate(out["g"]["k3"])}
    return done()

def owned_rows(label, ms, memory, failed: list) -> None:
    """Each dof rank's placement gave up the rest of every partitioned
    entry (``held_whole`` less ``held``): its allocated memory fell by at
    least 0.95 x the bytes it no longer holds, and its owned rows' product
    has the bits of the views' before placement (else a line in
    ``failed``)."""
    from plate_inverse_problem_tpu_torch.parallel import ranks

    for r, (m, mem) in enumerate(zip(ms, memory)):
        want = sum(m["held_whole"].values()) - sum(m["held"].values())
        mem["gave_up"] = want
        if not mem["drop"] >= 0.95 * want:
            failed.append(f"[slice12] {label} rank {r}'s allocated memory "
                          f"fell by {mem['drop'] / 1e6:.1f} MB at placement,"
                          f" under 0.95 x {want / 1e6:.1f} MB")
        if not all(m["view_bits"].values()):
            failed.append(f"[slice12] {label} rank {r}: the owned rows' "
                          f"product against the view's {m['view_bits']}")
    print(f"[slice12] {label} owned rows' product vs the view's before "
          f"placement ({ranks.VIEW_LANES} lanes): "
          + ", ".join(str(m["view_bits"]) for m in ms), flush=True)


def dof_bits(label, ms, fr_ref, what: str, failed: list) -> bool:
    """Every dof rank's first FRF is ``fr_ref``'s bits (else a line in
    ``failed``); prints how far it is where it is not."""
    fr_ref = np.asarray(fr_ref)
    frs = [np.asarray(m["frf"][0][:fr_ref.size]) for m in ms]
    same = all(np.array_equal(f, fr_ref) for f in frs)
    dev = max(float(np.max(np.abs(f - fr_ref) / np.abs(fr_ref)))
              for f in frs)
    print(f"[slice12] {label} FRF vs {what}: "
          + ("the same bits on every rank" if same else
             f"NOT the same bits, {dev:.3e} relative"), flush=True)
    if not same:
        failed.append(f"[slice12] {label} FRF is not {what}'s bits "
                      f"({dev:.3e})")
    return same


def dof_shares(label, ms, failed: list) -> None:
    """A dof rank of the two-grid tier holds a share of every entry the dof
    axis partitions (``opdata_shardings``) and of the K1 pack, the ranks'
    shares of each entry add up to the whole, and K1 ran on the window
    packs alone (else a line in ``failed``)."""
    keys = {"mg_band0", "mg_pack", "mg_Pt", "mg_dinv", "mg_Kcinv", "W64"}
    for r, m in enumerate(ms):
        whole, held = m["held_whole"], m["held"]
        if set(held) != keys or set(whole) != keys or not all(
                0 < held[k] < whole[k] for k in keys):
            failed.append(f"[slice12] {label} rank {r} holds {held} of "
                          f"{whole}, not a share of each of {sorted(keys)}")
        # the sharded steps (the "ref_" ones ran on the whole Problem
        # before placement)
        steps = [k for k in m["k1"] if not k.startswith("ref_")]
        k1 = sum(m["k1"][k] for k in steps)
        if k1 <= 0 or sum(m["k1_window"][k] for k in steps) != k1:
            failed.append(f"[slice12] {label} rank {r}: K1 {m['k1']}, on "
                          f"the window packs {m['k1_window']}: the window "
                          "launch must be the rank's only K1 path")
    for k in keys - {"mg_pack"}:
        if sum(m["held"][k] for m in ms) != ms[0]["held_whole"][k]:
            failed.append(f"[slice12] {label} the ranks' shares of {k} "
                          f"{[m['held'][k] for m in ms]} do not add up to "
                          f"{ms[0]['held_whole'][k]}")
    print(f"[slice12] {label} K1 per rank {[m['k1'] for m in ms]}, on the "
          f"window packs {[m['k1_window'] for m in ms]} (ref_: the whole "
          "Problem before placement)", flush=True)


def dof_twogrid(dev, dirs, spec, p21, failed: list) -> dict:
    """Phase 14 (f): the 20916-DOF plate (band + two-grid, the main path's
    large tier) at truth x SHARD_THETA on the two gloo ranks' (freq 1, dof
    2) mesh (``spec``, run in (b)'s spawn), each rank holding its block
    rows of the band, its K1 window pack, P and the diagonal and its rows
    of the coarse inverse and W64: its memory drop at placement (0.95 x
    what it gave up, printed with the card), the FRF's bits on both ranks
    against the unsharded sweep of the same Problem before placement, the
    FRF against the refined splu at 4 points incl. the peak (ORACLE_TOL),
    one adjoint Gauss-Newton update against the single-process one
    (SHARD_TOL), K1 on the window packs alone in each rank.  On two cards
    or more the same run over NCCL, a rank a card as (freq 1, dof world),
    is printed beside it and gates nothing."""
    import torch

    from plate_inverse_problem_tpu_torch.oracle import splu_frf
    from plate_inverse_problem_tpu_torch.parallel import ranks

    t0 = time.perf_counter()
    f = ranks.load(dirs["f"], 2)
    mf = [r["meshes"][0] for r in f]
    n = f[0]["n_free"]
    print(f"[slice12] (f) two-grid plate n={n} tier {f[0]['tier']} (build "
          f"{f[0]['build_s']:.2f} s), 2 gloo ranks as (freq 1, dof 2), "
          f"{spec['freqs'][2]} points, shares {mf[0]['shards']} / "
          f"{mf[1]['shards']}", flush=True)
    shard_bits(mf, failed, ("frf", "gn_adjoint"))
    out = {"memory": shard_memory("(f)", f),
           "steps": shard_report("(f)", mf, ("frf", "gn_adjoint",
                                             "ref_frf", "ref_gn_adjoint")),
           "k1": [sum(m["k1"].values()) for m in mf]}
    owned_rows("(f)", mf, out["memory"], failed)
    card = card_info()
    for r, mem in enumerate(out["memory"]):
        print(f"[slice12] (f) rank {r}: memory_allocated fell by "
              f"{mem['drop'] / 1e6:.2f} MB at placement, of the "
              f"{mem['gave_up'] / 1e6:.2f} MB it gave up (gate 0.95 x); "
              f"{card}", flush=True)
    dof_shares("(f)", mf, failed)
    out["bits"] = dof_bits("(f)", mf, mf[0]["ref_frf"][0],
                           "the unsharded sweep of the same Problem",
                           failed)
    (rsq, th), (rsq_1, th_1) = mf[0]["gn_adjoint"][0], \
        mf[0]["ref_gn_adjoint"][0]
    out["gn_rsq"] = shard_close("(f) GN adjoint |r|^2 vs the single-process "
                                "step", rsq, rsq_1, SHARD_TOL, failed)
    out["gn_update"] = shard_close("(f) GN adjoint update vs the "
                                   "single-process step", th, th_1,
                                   SHARD_TOL, failed)
    freqs = np.linspace(*spec["freqs"])
    fr = mf[0]["frf"][0][:freqs.size]
    if p21 is None:
        p21 = sh_i_problem(dev, 4.0)
    idx = peak_points(fr)
    exact = splu_frf(p21, freqs[idx], f[0]["theta"])
    out["vs_splu"] = shard_close(
        f"(f) FRF vs the refined splu at {freqs[idx].round(3).tolist()} Hz "
        f"(peak {freqs[idx[1]]:.3f})", fr[idx], exact, ORACLE_TOL, failed)
    world = torch.cuda.device_count()
    if world >= 2:
        spec_n = {**spec, "meshes": [(1, world)]}
        t1 = time.perf_counter()
        ranks.spawn(ranks.sharded_checks, world, dirs["f_nccl"], spec_n,
                    device="cuda")
        fn = ranks.load(dirs["f_nccl"], world)
        mn = [r["meshes"][0] for r in fn]
        print(f"[slice12] (f) over NCCL, {world} cards as (freq 1, dof "
              f"{world}): {time.perf_counter() - t1:.1f} s with the spawn "
              "(printed, not gated)", flush=True)
        shard_memory("(f) NCCL", fn)
        shard_report("(f) NCCL", mn, ("frf", "gn_adjoint"))
        dof_bits("(f) NCCL", mn, mf[0]["ref_frf"][0], "the unsharded sweep "
                 "(printed, not gated)", [])
    out["s"] = time.perf_counter() - t0
    return out


def dof_wide(dev, out_dir: str, failed: list) -> dict:
    """Phase 14 (g): the bench plate (n = 1466) with the two-grid
    preconditioner on the band layout (nb = 6 block rows in 6 groups) on
    DOF_WIDE gloo ranks of ``dev`` as (freq 1, dof DOF_WIDE), at
    DOF_WIDE_FREQ points and truth x SHARD_THETA: every rank keeps the
    two-grid's band, P, diagonal and K1 pack whole (the JAX package's
    placement of an axis d does not divide) and owns its rows of
    ``mg_Kcinv`` and ``W64``; its FRF is the unsharded sweep's bits (each
    rank's own, before the mesh places its Problem), its adjoint
    Gauss-Newton update the single-process step's (``_host_gn`` on a
    Problem of the plate in this process, from the ranks' reference FRF;
    SHARD_TOL; every rank the same bits), and K1 ran on the whole pack (no
    window launch) in every rank."""
    from plate_inverse_problem_tpu_torch.parallel import ranks

    spec = {"plate": {"geometry": "sh_i", "refine": 1.0, "precond": "mg",
                      "operator_layout": "band"},
            "meshes": [(1, DOF_WIDE)], "freqs": (40.0, 600.0, DOF_WIDE_FREQ),
            "theta": SHARD_THETA, "repeats": 1, "steps": ("gn_adjoint",),
            "at_theta": True, "reference": "frf"}
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    ranks.spawn(ranks.sharded_checks, DOF_WIDE, out_dir, spec,
                backend="gloo", device=f"cuda:{dev.index or 0}")
    out = {"spawn_s": time.perf_counter() - t0}
    g = ranks.load(out_dir, DOF_WIDE)
    mg = [r["meshes"][0] for r in g]
    print(f"[slice12] (g) bench plate n={g[0]['n_free']} tier "
          f"{g[0]['tier']} (build {g[0]['build_s']:.2f} s), {DOF_WIDE} gloo "
          f"ranks as (freq 1, dof {DOF_WIDE}), {DOF_WIDE_FREQ} points: "
          f"{out['spawn_s']:.1f} s with the spawn; shares "
          + " / ".join(str(m["shards"]) for m in mg), flush=True)
    shard_bits(mg, failed, ("frf", "gn_adjoint"))
    out["bits"] = dof_bits("(g)", mg, mg[0]["ref_frf"][0],
                           "the unsharded sweep of the same Problem", failed)
    t1 = time.perf_counter()
    p = ranks.plate_problem(spec["plate"], dev)
    rsq_1, th_1 = ranks._host_gn(p, np.linspace(*spec["freqs"]), g[0]["ref"],
                                 g[0]["theta"], "adjoint")
    del p
    print(f"[slice12] (g) the single-process step in this process: "
          f"{time.perf_counter() - t1:.2f} s with the Problem's build",
          flush=True)
    rsq, th = mg[0]["gn_adjoint"][0]
    out["gn_rsq"] = shard_close("(g) GN adjoint |r|^2 vs the single-process "
                                "step", rsq, rsq_1, SHARD_TOL, failed)
    out["gn_update"] = shard_close("(g) GN adjoint update vs the "
                                   "single-process step", th, th_1,
                                   SHARD_TOL, failed)
    out["steps"] = shard_report("(g)", mg, ("frf", "gn_adjoint", "ref_frf"))
    out["k1"] = [m["k1"]["frf"] for m in mg]
    out["k3"] = [m["k3"]["frf"] for m in mg]
    for r, m in enumerate(mg):
        whole = {k: m["held"][k] == m["held_whole"][k]
                 for k in ("mg_band0", "mg_pack", "mg_Pt", "mg_dinv")}
        owned = set(m["shards"]) == {"mg_Kcinv", "W64"}
        if not (all(whole.values()) and owned):
            failed.append(f"[slice12] (g) rank {r} holds {m['held']} of "
                          f"{m['held_whole']}, shares {m['shards']}: the "
                          "two-grid must stay whole, mg_Kcinv and W64 owned")
        for step in ("frf", "gn_adjoint"):
            if m["k1"][step] <= 0 or m["k1_window"][step] != 0:
                failed.append(f"[slice12] (g) rank {r} {step}: K1 "
                              f"{m['k1'][step]}, on window packs "
                              f"{m['k1_window'][step]}: K1 must run on the "
                              "whole pack")
    print(f"[slice12] (g) K1 on the whole pack per rank, sweep "
          f"{out['k1']}, GN step {[m['k1']['gn_adjoint'] for m in mg]} "
          f"(window launches "
          f"{[m['k1_window']['frf'] + m['k1_window']['gn_adjoint'] for m in mg]}"
          "), the two-grid whole on every rank", flush=True)
    return out


def dof_dense(dev, dirs, spec, world: int, failed: list) -> dict:
    """Phase 14 (e): the n = 11910 dense-tier plate's FRF at truth x
    SHARD_THETA on the two gloo ranks' (freq 1, dof 2) mesh (``spec``,
    run in (b)'s spawn), each rank owning half the rows of ``invK64``:
    its memory drop at placement, the ranks' bits (each the unsharded
    sweep's of its own Problem, run before placement), the FRF against
    the unsharded sweep of the same plate and theta in this process
    (DOF_FRF_TOL) and against the refined splu at 4 points incl. the peak
    (ORACLE_TOL), K3 and the row blocks' GEMMs in each rank.  On two cards
    or more the same run over NCCL, a rank a card as (freq 1, dof world),
    is printed beside it and gates nothing."""
    import torch

    from plate_inverse_problem_tpu_torch.oracle import splu_frf
    from plate_inverse_problem_tpu_torch.parallel import ranks
    from plate_inverse_problem_tpu_torch.parallel.freq_shard import (
        row_range)

    t0 = time.perf_counter()
    e = ranks.load(dirs["e"], 2)
    me = [r["meshes"][0] for r in e]
    n = e[0]["n_free"]
    print(f"[slice12] (e) dense-tier plate n={n} tier {e[0]['tier']} "
          f"(build {e[0]['build_s']:.2f} s), 2 gloo ranks as (freq 1, dof "
          f"2), invK64 rows {me[0]['shards']}", flush=True)
    shard_bits(me, failed, ("frf",))
    out = {"memory": shard_memory("(e)", e),
           "frf": shard_report("(e)", me, ("frf",)),
           "k3": [m["k3"]["frf"] for m in me]}
    owned_rows("(e)", me, out["memory"], failed)
    mw = me[0]["held_whole"]["W64"] // (8 * n)
    for r, m in enumerate(me):
        lo, hi = row_range(n, 2, r)
        held = {"invK64": (hi - lo) * n * 8, "W64": (hi - lo) * mw * 8}
        if m["held"] != held:
            failed.append(f"[slice12] (e) rank {r} holds {m['held']}, not "
                          f"its {hi - lo} rows of invK64 and W64: {held}")
        if m["k3"]["frf"] <= 0 or m["k5"]["frf"] <= 0:
            failed.append(f"[slice12] (e) rank {r} launched K3 "
                          f"{m['k3']['frf']}, K5 {m['k5']['frf']} times")
    # the unsharded sweep of the same plate and theta in this process
    freqs = np.linspace(*spec["freqs"])
    theta = e[0]["theta"]
    t1 = time.perf_counter()
    p = sh_i_problem(dev, 3.0)
    p.getFRCore()
    torch.cuda.synchronize()
    out["unsharded_build_s"] = time.perf_counter() - t1
    fr_u = p.solveForward(freqs, theta).cpu().numpy()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    p.solveForward(freqs, theta)
    torch.cuda.synchronize()
    out["unsharded_s"] = time.perf_counter() - t1
    fr = me[0]["frf"][0][:freqs.size]
    out["vs_unsharded"] = shard_close(
        "(e) FRF vs the unsharded sweep of this process", fr, fr_u,
        DOF_FRF_TOL, failed)
    # the bits against each rank's own unsharded sweep: a rank's host
    # ARPACK basis runs one OpenBLAS thread (parallel.ranks), whose dot
    # products round otherwise than this process's at 11910 DOF
    out["bits"] = dof_bits("(e)", me, me[0]["ref_frf"][0], "the unsharded "
                           "sweep of the same Problem", failed)
    idx = peak_points(fr)
    exact = splu_frf(p, freqs[idx], theta)
    out["vs_splu"] = shard_close(
        f"(e) FRF vs the refined splu at {freqs[idx].round(3).tolist()} Hz "
        f"(peak {freqs[idx[1]]:.3f})", fr[idx], exact, ORACLE_TOL, failed)
    if world >= 2:
        spec_n = {**spec, "meshes": [(1, world)]}
        t1 = time.perf_counter()
        ranks.spawn(ranks.sharded_checks, world, dirs["e_nccl"], spec_n,
                    device="cuda")
        en = ranks.load(dirs["e_nccl"], world)
        mn = [r["meshes"][0] for r in en]
        print(f"[slice12] (e) over NCCL, {world} cards as (freq 1, dof "
              f"{world}): {time.perf_counter() - t1:.1f} s with the spawn "
              "(printed, not gated)", flush=True)
        shard_memory("(e) NCCL", en)
        shard_report("(e) NCCL", mn, ("frf",))
        shard_close("(e) NCCL FRF vs the unsharded sweep",
                    mn[0]["frf"][0][:freqs.size], fr_u, DOF_FRF_TOL, [])
        dof_bits("(e) NCCL", mn, fr_u, "the unsharded sweep (printed, not "
                 "gated)", [])
    del p
    torch.cuda.empty_cache()
    out["s"] = time.perf_counter() - t0
    print(f"[slice12] (e) in this process: the unsharded Problem's build "
          f"{out['unsharded_build_s']:.2f} s, its steady sweep "
          f"{out['unsharded_s']:.3f} s; (e)'s checks {out['s']:.1f} s after "
          "the spawn", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 15: the scale tiers
# ---------------------------------------------------------------------------

def k1_smem_bytes(pack) -> tuple[int, int]:
    """K1's shared memory a block at its widest lane tile (csrc/band_mv.cu:
    a ring of 5 stages of one 16 x 8 tile and 128 lanes' x slices, f32,
    and the row tile's list of first columns) and the 48 KB a launch may
    take without an opt-in."""
    return 4 * (5 * (16 * 8 + 128 * 8) + pack.list_max), 48 * 1024


def tier_sweeps(p, freqs, tag: str) -> dict:
    """A first and two steady sweeps, synchronised: seconds, the first's
    peak device memory, K1 / K3 launches a sweep, and whether the two
    steady sweeps have the same bits."""
    import torch

    from plate_inverse_problem_tpu_torch.ops import band_kernel, csr_kernel

    times, frs, k1, k3 = [], [], [], []
    torch.cuda.reset_peak_memory_stats()
    for i in range(3):
        band_kernel.band_mv_f32_cuda.launches = 0
        csr_kernel.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fr = p.solveForward(freqs)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if i == 0:
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
        frs.append(fr.cpu().numpy())
        k1.append(band_kernel.band_mv_f32_cuda.launches)
        k3.append(csr_kernel.csr_mv_cuda.launches)
    fr = frs[1]
    rec = {"sweep_first_s": times[0], "sweep_steady_s": times[1:],
           "solves_per_s_steady": freqs.size / times[1],
           "peak_mem_gb": peak_gb, "k1": k1, "k3": k3,
           "chunk": p._auto_freq_chunk(),
           "steady_bits_equal": bool(np.array_equal(frs[1], frs[2])),
           "first_bits_equal": bool(np.array_equal(frs[0], frs[1]))}
    print(f"{tag} {freqs.size} points over 40-600 Hz in chunks of "
          f"{rec['chunk']}: first {times[0]:.3f} s, steady {times[1]:.3f} / "
          f"{times[2]:.3f} s ({rec['solves_per_s_steady']:.1f} solves/s); "
          f"peak device memory {peak_gb:.2f} GB; K1 {k1}, K3 {k3} a sweep; "
          f"two steady sweeps bit-identical: {rec['steady_bits_equal']} (the "
          f"first too: {rec['first_bits_equal']})", flush=True)
    if fr.shape != freqs.shape or not np.all(np.isfinite(fr)):
        raise AssertionError(f"{tag} bad FRF: shape {fr.shape}")
    return rec | {"fr": fr}


def tier_rj(p, freqs, fr, x0, tag: str, scale=None) -> tuple:
    """One adjoint log_afc r + J at ``x0`` (``scale``: the solveInverse
    scaling) as ``value_and_jac`` runs it, its two sweeps
    (``_adjoint_state``) and then the tangent pass by the budget's blocks
    (``_adjoint_jac``), timed, with the peak device memory over the call
    (the Problem's own data included), K1 / K3 launches and the blocks;
    returns ((r, J) in numpy, the ResidualFunction, the sweeps' state, the
    record)."""
    from plate_inverse_problem_tpu_torch.models.problem import _as_tensor

    rf = p.getResidualFunction(freqs, fr, kind="log_afc",
                               scaling_params=scale)
    x = _as_tensor(x0, p.device)
    outs, times, peak_gb, k1, k3 = sync_times(
        lambda: rf._adjoint_state(x), 1)
    (r, state), = outs
    outs, t_jac, peak_jac, k1_jac, k3_jac = sync_times(
        lambda: rf._adjoint_jac(x, state), 1, reset=False)
    J, = outs
    r, J = host((r, J))
    rec = {"rj_s": times[0] + t_jac[0], "rj_jac_s": t_jac[0],
           "rj_peak_gb": max(peak_gb, peak_jac), "k1_rj": k1 + k1_jac,
           "k3_rj": k3 + k3_jac, "blocks": list(rf.blocks)}
    print(f"{tag} adjoint log_afc r + J over {x0.size} parameters at "
          f"{freqs.size} points: {rec['rj_s']:.3f} s (first call; the "
          f"tangent pass {t_jac[0]:.3f} s in {rf.blocks[1]} block(s) of "
          f"{rf.blocks[0]} frequencies), peak device memory "
          f"{rec['rj_peak_gb']:.2f} GB; K1 {rec['k1_rj']}, K3 "
          f"{rec['k3_rj']}", flush=True)
    if J.shape != (freqs.size, x0.size) or not (
            np.all(np.isfinite(r)) and np.all(np.isfinite(J))):
        raise AssertionError(f"{tag} bad r {r.shape} or J {J.shape}")
    if rec["k1_rj"] <= 0 or rec["k3_rj"] <= 0:
        raise AssertionError(f"{tag} r + J launched K1 {rec['k1_rj']}, K3 "
                             f"{rec['k3_rj']} times")
    return (r, J), rf, state, rec


def jac_at_block(rf, x, state, blk: int):
    """J of ``rf`` from its sweeps' ``state`` with the tangent pass in
    blocks of ``blk`` frequencies: (J in numpy, the blocks, seconds)."""
    from plate_inverse_problem_tpu_torch.models.problem import _as_tensor

    (J,), times, _, _, _ = sync_times(
        lambda: rf._adjoint_jac(_as_tensor(x, state[0].device), state,
                                block=blk), 1, reset=False)
    return J.cpu().numpy(), tuple(rf.blocks), times[0]


def tier_oracle(p, freqs, fr, idx, tag: str) -> tuple[np.ndarray, float]:
    """The refined host splu at ``idx``, timed: (FRF there, seconds)."""
    from plate_inverse_problem_tpu_torch.oracle import splu_frf

    t0 = time.perf_counter()
    ref = splu_frf(p, freqs[idx])
    s = time.perf_counter() - t0
    rel = np.abs(fr[idx] - ref) / np.abs(ref)
    print(f"{tag} vs the refined f64 splu ({s:.1f} s on the host, "
          f"{s / len(idx):.1f} s a point): "
          + ", ".join(f"{freqs[i]:.3f} Hz {e:.3e}" for i, e in zip(idx, rel)),
          flush=True)
    return ref, s


def scale_tier(dev, refine: float, tag: str, failed: list,
               kernels: bool = False, keep_fr: dict | None = None) -> dict:
    """Phase 15 (a) / (b): isotropic steel on ``sh_i`` at ``refine`` (6: n
    = 46432, 9: n = 103680), tier "auto" (band + two-grid), 512 points:
    construction with its parts, the host counts against the JAX
    package's (TIER_COUNTS), three sweeps (the steady two bit-identical,
    K1 > 0), the refined splu (refine 6: 4 points incl. the peak; 9: the
    peak and one point off it, the peak also after ``polish_peaks``), one
    adjoint r + J with its peak memory; with ``kernels``, K1 on the pack
    and K3 on the pattern at the sweep's chunk against their plain
    versions, timed beside bound and library call, and K3 on the 24
    folded tangents of 1024 lanes (2.55e9 outputs, past 32-bit offsets)
    against the plain version where the offsets are largest.  ``keep_fr``
    (a dict) receives the sweep's FRF under "fr"."""
    import torch

    from plate_inverse_problem_tpu_torch.diagnostics import polish_peaks
    from plate_inverse_problem_tpu_torch.ops import csr_kernel as ck

    freqs = np.linspace(40.0, 600.0, N_FREQ)
    t0 = time.perf_counter()
    p, rec = construct(dev, refine, f"sh_i refine={refine:g}", tag)
    n, nnz = TIER_COUNTS[refine]
    pack, lay = p._band_pack, p._band_layout
    smem, smem_max = k1_smem_bytes(pack)
    rec |= {"b": lay.b, "nb": lay.nb, "list_max": pack.list_max,
            "k1_smem": smem, "pack_mb": sum(
                t.numel() * t.element_size()
                for t in (pack.vals, pack.col0, pack.row_ptr)) / 1e6}
    print(f"{tag} host counts n_free={p.n_free} nnz={p.op.pattern.nnz} "
          f"(the JAX package's {n} / {nnz}); K1 pack {pack.vals.shape[0]} "
          f"tiles ({rec['pack_mb']:.1f} MB), list_max {pack.list_max}: "
          f"{smem} B of shared memory a block (<= {smem_max} without an "
          f"opt-in)", flush=True)
    if (p.n_free, p.op.pattern.nnz) != (n, nnz):
        failed.append(f"{tag} n_free / nnz {p.n_free} / {p.op.pattern.nnz}"
                      f" are not the JAX package's {n} / {nnz}")
    if p._tier != ("band", "mg", False) or smem > smem_max:
        failed.append(f"{tag} tier {p._tier}, K1 shared memory {smem} B")
    rec |= tier_sweeps(p, freqs, f"{tag} sweep")
    fr = rec.pop("fr")
    if not rec["steady_bits_equal"] or min(rec["k1"]) <= 0:
        failed.append(f"{tag} steady sweeps bit-identical "
                      f"{rec['steady_bits_equal']}, K1 {rec['k1']}")
    ipk = int(np.argmax(np.abs(fr)))
    rec["f_peak"] = float(freqs[ipk])
    if refine < 9.0:
        idx = peak_points(fr)
        ref, rec["oracle_s"] = tier_oracle(p, freqs, fr, idx, tag)
        rel = np.abs(fr[idx] - ref) / np.abs(ref)
        rec["worst_rel_err"] = float(rel.max())
        if not rec["worst_rel_err"] <= ORACLE_TOL:
            failed.append(f"{tag} worst rel err {rec['worst_rel_err']:.3e} "
                          f"> {ORACLE_TOL}")
    else:
        idx = [ipk, N_FREQ // 2]
        ref, rec["oracle_s"] = tier_oracle(p, freqs, fr, idx, tag)
        rel = np.abs(fr[idx] - ref) / np.abs(ref)
        t1 = time.perf_counter()
        fr_pol, _ = polish_peaks(p, freqs, fr=fr, peaks=[ipk])
        rec["polish_s"] = time.perf_counter() - t1
        rec |= {"peak_rel_err": float(rel[0]), "off_rel_err": float(rel[1]),
                "peak_polished_rel_err": float(
                    abs(fr_pol[ipk] - ref[0]) / abs(ref[0]))}
        print(f"{tag} the peak {freqs[ipk]:.3f} Hz: raw {rel[0]:.3e}, after "
              f"polish_peaks {rec['peak_polished_rel_err']:.3e} ("
              f"{rec['polish_s']:.1f} s); off the peak {freqs[idx[1]]:.3f} Hz"
              f" raw {rel[1]:.3e} (tol {ORACLE_TOL}; the JAX CPU path's "
              "1.0-1.5e-6 at this tier is against a plain f64 splu, this "
              "oracle refines the LU solve: not the same yardstick)",
              flush=True)
        if not (rec["off_rel_err"] <= ORACLE_TOL and min(
                rec["peak_rel_err"], rec["peak_polished_rel_err"])
                <= ORACLE_TOL):
            failed.append(f"{tag} splu: off the peak {rel[1]:.3e}, the peak "
                          f"raw {rel[0]:.3e} / polished "
                          f"{rec['peak_polished_rel_err']:.3e}")
    truth = np.asarray(p.parameters, np.float64)
    rec |= tier_rj(p, freqs, fr, truth * np.asarray(START), tag)[3]
    if keep_fr is not None:
        keep_fr["fr"] = fr
    if kernels:
        chunk = rec["chunk"] or N_FREQ
        od = p.getFRCore()[1]
        rng = np.random.default_rng(0)
        x = torch.as_tensor(rng.standard_normal((2 * chunk, p.n_free)).astype(
            np.float32), device=dev)
        k1 = compare_kernel(pack, od["mg_band0"], x, lay,
                            f"n={p.n_free} K_ref band, f32, the sweep's "
                            "chunk")
        k1["bound_ms"], k1["bound_by"] = bound_ms(pack, 2 * chunk, p.n_free)
        print(f"[bound] n={p.n_free} B={2 * chunk}: {k1['bound_ms']:.4f} ms "
              f"({k1['bound_by']}); kernel at "
              f"{100 * k1['bound_ms'] / k1['ms']:.1f} % of it", flush=True)
        del x
        csr = ck.build_csr(od["rows"], od["cols"], p.n_free)
        k3 = compare_csr(csr, 2, 2 * chunk, "f64",
                         f"n={p.n_free} S=2 L={2 * chunk} (the sweep's "
                         "chunk)", 15, tag=tag)
        rec |= {"k1_kernel": k1, "k3_kernel": k3,
                "k3_wide": far_offsets(csr, tag)}
    del p
    torch.cuda.empty_cache()
    rec["s"] = time.perf_counter() - t0
    print(f"{tag} in {rec['s']:.1f} s", flush=True)
    return rec


def far_offsets(csr, tag: str, S: int = 24, L: int = 1024) -> dict:
    """K3 with S x L x n outputs past 2^31 (the residual map's 24 folded
    tangents at 1024 lanes): the last operator's last 8 lanes and the first
    operator's first 8 against the plain version of those alone (CSR_TOL),
    the kernel's time beside its bound."""
    import torch

    from plate_inverse_problem_tpu_torch.ops import csr_kernel as ck

    dev = csr.col.device
    rng = np.random.default_rng(16)
    data = torch.as_tensor(rng.standard_normal((S, csr.nnz)), device=dev)
    x = torch.as_tensor(rng.standard_normal((L, csr.n)), device=dev)
    y = ck.csr_mv_cuda(data, x, csr)
    errs = []
    for s, lanes in ((S - 1, slice(L - 8, L)), (0, slice(0, 8))):
        y_ref = ck.csr_mv_reference(data[s:s + 1], x[lanes], csr)[0]
        errs.append(float((y[s, lanes] - y_ref).abs().max()
                          / y_ref.abs().max()))
    ms = time_ms(lambda: ck.csr_mv_cuda(data, x, csr), reps=3)[0]
    bound, by = csr_bound_ms(csr, S, L, 8)
    out = S * L * csr.n
    print(f"{tag} K3 f64 S={S} L={L} n={csr.n}: {out} outputs "
          f"({out / 2**31:.2f} x 2^31); the last operator's last 8 lanes / "
          f"the first's first 8 vs plain: rel {errs[0]:.3e} / {errs[1]:.3e} "
          f"(tol {CSR_TOL['f64']}); kernel {ms:.3f} ms, bound {bound:.3f} ms"
          f" ({by})", flush=True)
    del y, data, x
    torch.cuda.empty_cache()
    if not max(errs) <= CSR_TOL["f64"]:
        raise AssertionError(f"{tag} K3 past 2^31 outputs: rel {errs}")
    return {"S": S, "L": L, "outputs": out, "rel_err": errs, "ms": ms,
            "bound_ms": bound, "bound_by": by}


def tier_d4(dev, kept: dict, fr_ref, tag: str, failed: list) -> dict:
    """Phase 15 (c): OrthotropicD4 (p = 8) on ``sh_i`` refine = 9 (n =
    103680): the adjoint log_afc r + J at 512 points from truth x D4_START
    (phase 8 (b)'s scaling) against ``fr_ref`` ((b)'s isotropic FRF, the
    measurement the fit is made to): its peak device memory at most
    RJ_MEM_GB, and J at half the budget's block from the same sweeps the
    budget's bits.  Then on phase 8 (b)'s 21k Problem (``kept["d4"]``) the
    adjoint r + J at RJ_ALT_BLOCK frequencies a block: phase 8 (b)'s bits,
    and within FWD_J_RTOL / FWD_J_ATOL (r: FWD_R_CHUNK_TOL) of phase 10
    (b)'s forward-mode J (``kept["d4_fwd"]``)."""
    import torch

    import plate_inverse_problem_tpu_torch as pt
    from plate_inverse_problem_tpu_torch.models.problem import _as_tensor

    if fr_ref is None:
        raise AssertionError(f"{tag} has no FRF of (b) to fit")
    freqs = np.linspace(40.0, 600.0, N_FREQ)
    t0 = time.perf_counter()
    mat = pt.get_material(7920.0, "orthotropic_d4", **D4)
    p, rec = construct(dev, 9.0, "OrthotropicD4 sh_i refine=9", tag,
                       mat=mat)
    truth = np.asarray(p.parameters, np.float64)
    scale = np.where(truth != 0.0, truth, 1e-3)
    x0 = truth * np.asarray(D4_START) / scale
    (r, J), rf, state, rj = tier_rj(p, freqs, fr_ref, x0, tag, scale)
    rec |= rj
    J2, blocks2, s2 = jac_at_block(rf, x0, state, max(1, rf.blocks[0] // 2))
    rec |= {"alt_blocks": list(blocks2), "alt_jac_s": s2,
            "alt_bits_equal": bool(np.array_equal(J, J2))}
    print(f"{tag} J from the same sweeps in {blocks2[1]} blocks of "
          f"{blocks2[0]} ({s2:.3f} s): the budget's {rj['blocks'][1]} blocks'"
          f" bits {rec['alt_bits_equal']}; peak {rec['rj_peak_gb']:.2f} GB "
          f"(limit {RJ_MEM_GB} GB)", flush=True)
    if not rec["alt_bits_equal"] or not rec["rj_peak_gb"] <= RJ_MEM_GB:
        failed.append(f"{tag} 104k: bits at two blocks "
                      f"{rec['alt_bits_equal']}, peak {rec['rj_peak_gb']:.2f}"
                      f" GB (limit {RJ_MEM_GB})")
    del p, rf, state
    torch.cuda.empty_cache()
    # the forward mode at 21k (phase 10 (b)'s J): the adjoint J by blocks
    p21, fr21, scale21, x21, ra, Ja = kept["d4"]
    r_f, J_f = kept["d4_fwd"]
    rf21 = p21.getResidualFunction(freqs, fr21, kind="log_afc",
                                   scaling_params=scale21)
    x = _as_tensor(x21, p21.device)
    rb, st21 = rf21._adjoint_state(x)
    rb = rb.cpu().numpy()
    Jb, blocks21, s21 = jac_at_block(rf21, x21, st21, RJ_ALT_BLOCK)
    del st21
    rec |= {"d4_21k_blocks": list(blocks21), "d4_21k_jac_s": s21,
            "d4_21k_bits_equal": bool(np.array_equal(rb, ra)
                                      and np.array_equal(Jb, Ja)),
            "d4_21k_r_vs_fwd_rel": float(np.abs(rb - r_f).max()
                                         / np.abs(r_f).max()),
            "d4_21k_J_vs_fwd": jac_dev(Jb, J_f)}
    print(f"{tag} 21k OrthotropicD4 (phase 8 (b)'s Problem): the adjoint "
          f"J in {blocks21[1]} blocks of {blocks21[0]} ({s21:.3f} s): "
          f"phase 8 (b)'s bits {rec['d4_21k_bits_equal']}; vs phase 10 (b)'s"
          f" forward-mode r {rec['d4_21k_r_vs_fwd_rel']:.3e} (tol "
          f"{FWD_R_CHUNK_TOL}), J {rec['d4_21k_J_vs_fwd']:.3e} of the "
          f"tolerance ({FWD_J_RTOL:g} rel + {FWD_J_ATOL:g} of max)",
          flush=True)
    if not (rec["d4_21k_bits_equal"]
            and rec["d4_21k_r_vs_fwd_rel"] <= FWD_R_CHUNK_TOL
            and rec["d4_21k_J_vs_fwd"] <= 1.0):
        failed.append(f"{tag} 21k: bits {rec['d4_21k_bits_equal']}, r "
                      f"{rec['d4_21k_r_vs_fwd_rel']:.3e}, J "
                      f"{rec['d4_21k_J_vs_fwd']:.3e}")
    rec["s"] = time.perf_counter() - t0
    print(f"{tag} in {rec['s']:.1f} s", flush=True)
    return rec


def slice17(dev, kept: dict) -> dict:
    """Phase 15: the scale tiers on the card.  (a) refine 6 (n = 46432),
    (b) refine 9 (n = 103680) with K1 and K3 at their shapes, (c)
    OrthotropicD4 at refine 9, its adjoint r + J under the memory bound.
    Every part runs before a failed check raises; returns the numbers for
    [summary] and the K1 / K3 launches by path."""
    failed = []
    out = {}
    ref = {}
    for key, fn in (("a", lambda: scale_tier(dev, 6.0, "[slice17] (a)",
                                             failed)),
                    ("b", lambda: scale_tier(dev, 9.0, "[slice17] (b)",
                                             failed, kernels=True,
                                             keep_fr=ref)),
                    ("c", lambda: tier_d4(dev, kept, ref.get("fr"),
                                          "[slice17] (c)", failed))):
        try:
            out[key] = fn()
        except AssertionError as err:
            failed.append(str(err))
    if failed:
        raise AssertionError("phase 15 failed: " + " | ".join(failed))
    a, b, c = out["a"], out["b"], out["c"]
    out["k1"] = {"sweep_46k": a["k1"][1], "rj_46k": a["k1_rj"],
                 "sweep_104k": b["k1"][1], "rj_104k": b["k1_rj"],
                 "rj_d4_104k": c["k1_rj"]}
    out["k3"] = {"sweep_46k": a["k3"][1], "rj_46k": a["k3_rj"],
                 "sweep_104k": b["k3"][1], "rj_104k": b["k3_rj"],
                 "rj_d4_104k": c["k3_rj"]}
    return out



# ---------------------------------------------------------------------------
# phase 16: the FGMRES cycle's Givens least squares (K7a, K7b)
# ---------------------------------------------------------------------------

K7_SOURCE = "plate_inverse_problem_tpu_torch/csrc/fgmres_lsq.cu"
K7_REPLACES = {
    "givens_step": "plate_inverse_problem_tpu/ops/mixed.py:393-463 (not "
                   "Pallas: the rotations, g and target in the while_loop "
                   "body of _pgmres_cycle_body l.349, fused by XLA)",
    "backsub": "plate_inverse_problem_tpu/ops/mixed.py:479-496 (not Pallas: "
               "the back-substitution fori_loop of _pgmres_cycle_body)"}
# the H100's f64 rate outside the tensor cores (NVIDIA's data sheet, SXM)
FP64_FLOPS = 34e12
# phase 16 (a)'s synthetic cycles: a k in and between each of the kernels'
# width buckets (8, 16, 32, 64), at a two-grid chunk's lanes and a sweep's
K7_SYNTH_K = (1, 3, 8, 16, 24, 64)
K7_SYNTH_L = (64, 512)
# the instantiations whose build must show no stack frame and no spills
# (h, y and the rotations in registers)
K7_REGISTER_BUCKETS = (8, 16)


def k7_build(report: str) -> dict:
    """Each K7a / K7b instantiation's registers, stack frame and spills,
    by name (``givens_step_kernel<8>``, ...), from ``fgmres_lsq.cu``'s
    ``nvcc -Xptxas -v`` report."""
    out, name, entry, props = {}, None, None, None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"'(_Z\w*?(givens_step_kernel|backsub_kernel)"
                          r"ILi(\d+)E\w*)'", line)
            name, entry = (f"{m[2]}<{m[3]}>", m[1]) if m else (None, None)
        elif "Function properties for" in line:
            props = line.split("Function properties for")[-1].strip()
        elif name and props == entry and "bytes stack frame" in line:
            n = [int(v) for v in re.findall(r"(\d+) bytes", line)]
            out[name] = {"stack": n[0], "spill_stores": n[1],
                         "spill_loads": n[2]}
        elif name in out and "Used" in line and "registers" in line:
            out[name]["registers"] = int(
                re.search(r"Used (\d+) registers", line)[1])
    return out


def k7_build_fault(build: dict) -> str | None:
    """Why ``k7_build``'s record fails: an instantiation missing, or a
    register bucket's (``K7_REGISTER_BUCKETS``) stack frame or spills."""
    want = [f"{n}<{kp}>" for n in ("givens_step_kernel", "backsub_kernel")
            for kp in (8, 16, 32, 64)]
    if missing := [w for w in want if w not in build]:
        return f"no build report for {missing}"
    bad = [f"{n}<{kp}>: {build[f'{n}<{kp}>']}"
           for n in ("givens_step_kernel", "backsub_kernel")
           for kp in K7_REGISTER_BUCKETS
           if any(build[f"{n}<{kp}>"][key] for key in (
               "stack", "spill_stores", "spill_loads"))]
    return f"stack or spills in {bad}" if bad else None


def k7_work(name: str, args) -> tuple[int, int]:
    """(bytes, f64 operations) that one K7a / K7b call on ``args`` must
    move and do: each input read once, each output written once, on the
    lanes that work (K7a: the active ones)."""
    if name == "givens_step":
        hre, cs, active, anchor = args[0], args[3], args[11], args[13]
        k = cs.shape[1]
        la = int(active.sum())
        # reads: h (k+1 complex), hlast, cs, sn, g[j] (+ beta0, tol_rel);
        # writes: R's column j, cs[j], sn[j], g[j], g[j+1], rn2 (+ tol2)
        per_lane = 8 * (2 * (k + 1) + 1 + k + 2 * k + 2 + 2 * anchor
                        + 2 * k + 1 + 2 + 4 + 1 + anchor)
        return la * per_lane + active.numel(), la * (20 * k + 40)
    R = args[0]
    L, k = R.shape[:2]
    # reads R and g's first k rows and j_fin; writes y
    return L * 8 * (2 * k * k + 2 * k + 1 + 2 * k), L * k * (8 * k + 12)


def k7_time(name: str, args, reps: int = 100) -> dict:
    """One recorded call's kernel time on the device and the wrapper's on
    the host (``time_ms`` over ``reps`` launches on a copy of its
    arguments), the plain version's on the card (CUDA events around its
    calls: its launches are host-bound), the bound from ``k7_work``, and
    for K7b the library's time (``time_ms``): one
    ``torch.linalg.solve_triangular`` of the complex R against the masked
    g.  No PyTorch call computes K7a's batched Givens update."""
    import torch

    from plate_inverse_problem_tpu_torch.ops import fgmres_kernel as fk

    a = [x.clone() if hasattr(x, "clone") else x for x in args]
    kernel, plain = ((fk.givens_step_cuda, fk.givens_step_reference)
                     if name == "givens_step"
                     else (fk.backsub_cuda, fk.backsub_reference))
    nbytes, ops = k7_work(name, args)
    bound_bytes, bound_ops = 1e3 * nbytes / HBM_BPS, 1e3 * ops / FP64_FLOPS
    k = (args[3] if name == "givens_step" else args[0]).shape[1]
    ms, host_ms = time_ms(lambda: kernel(*a), reps)
    rec = {"L": int(args[0].shape[0]), "k": int(k), "bucket": fk.bucket(k),
           "ms": ms,
           "host_ms": host_ms,
           "plain_ms": cuda_event_ms(lambda: plain(*a), 10),
           "bound_ms": max(bound_bytes, bound_ops),
           "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
           "bytes": nbytes, "ops": ops, "library_ms": None}
    if name == "givens_step":
        rec["active"] = int(args[11].sum())
    else:
        R, g, j_fin = args
        rows_on = torch.arange(k, device=R.device)[None, :] < j_fin[:, None]
        g_c = torch.view_as_complex(
            torch.where(rows_on[..., None], g[:, :k], 0.0).contiguous())
        R_c = torch.view_as_complex(R)
        rec["library_ms"] = time_ms(lambda: torch.linalg.solve_triangular(
            R_c, g_c[..., None], upper=True), reps)[0]
    return rec


@contextlib.contextmanager
def k7_recorded():
    """Yields a list that records every K7a / K7b call made through the
    names ``ops/mixed.py`` calls (``mixed.givens_step``, ``mixed.backsub``)
    inside the block: (name, its arguments cloned before the call), for
    ``fgmres_kernel.compare``."""
    import torch

    from plate_inverse_problem_tpu_torch.ops import mixed

    calls, saved = [], (mixed.givens_step, mixed.backsub)

    def recorder(name, fn):
        def call(*args):
            calls.append((name, tuple(a.clone() if torch.is_tensor(a) else a
                                      for a in args)))
            return fn(*args)
        return call

    mixed.givens_step = recorder("givens_step", saved[0])
    mixed.backsub = recorder("backsub", saved[1])
    try:
        yield calls
    finally:
        mixed.givens_step, mixed.backsub = saved


def recorded_sweep(p, freqs) -> tuple[float, dict, list]:
    """One steady sweep of ``p`` timed with K7's counters reset before it
    (seconds, ``k7_counts``), then the same sweep again with every K7a /
    K7b call recorded (``k7_recorded``)."""
    import torch

    from plate_inverse_problem_tpu_torch.ops import fgmres_kernel as fk

    fk.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p.solveForward(freqs)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    counts = k7_counts()
    with k7_recorded() as calls:
        p.solveForward(freqs)
    torch.cuda.synchronize()
    return sweep_s, counts, calls


def synthetic_calls(dev, k: int, L: int = 512) -> list:
    """The K7a / K7b calls of ``fgmres_kernel.synthetic_cycle`` at ``L``
    lanes and ``k`` steps, recorded (``k7_recorded``) as the kernels run
    it through the names ``_pgmres_cycle`` calls."""
    import torch

    from plate_inverse_problem_tpu_torch.ops import fgmres_kernel as fk
    from plate_inverse_problem_tpu_torch.ops import mixed

    state, steps, _, _, j_fin = fk.synthetic_cycle(L, k, seed=k,
                                                   device=dev)
    with k7_recorded() as calls:
        for j, st in enumerate(steps):
            mixed.givens_step(st["hre"], st["him"], st["hlast"],
                              *(state[key] for key in fk.STATE_KEYS),
                              st["active"], j, j == 0)
        mixed.backsub(state["R"], state["g"],
                      torch.as_tensor(j_fin, device=dev))
    return calls


def slice18(dev, p21, trace: dict, inv21: dict, inv_bench: dict) -> dict:
    """Phase 16: K7a (``givens_step``) and K7b (``backsub``), the FGMRES
    cycle's Givens least squares, on the card.  (a) every call of one
    steady bench (n = 1466) and one steady 21k sweep (``p21``), recorded,
    and seeded synthetic sets (L in ``K7_SYNTH_L``, k in ``K7_SYNTH_K``:
    every width bucket; every step; a = 0, b = 0, both zero, inactive and
    underflowing lanes) replayed through the kernel and the plain
    version: identical bits; the build report of each bucket's
    instantiation, no stack frame and no spills at 8 and 16 (``k7_build``);
    (b) each kernel's time at the 21k and bench sweeps' first call, on the
    device and on the host, with k and its bucket, its plain version's,
    its bound; (c) the two steady sweeps' seconds and launches, the r + J
    and Gauss-Newton launches of phases 6 and 7 (b) (``inv21``,
    ``inv_bench``), and phase 13 (e)'s trace of a steady bench sweep
    (``trace``).  Every part runs before a failed check raises."""
    import torch

    from plate_inverse_problem_tpu_torch.ops import fgmres_kernel as fk

    failed = []
    out = {"sweeps": {}, "bits": {}, "build": k7_build(fk.build())}
    for name, b in out["build"].items():
        print(f"[slice18] (a) build {name}: {b.get('registers')} registers, "
              f"{b['stack']} B stack, {b['spill_stores']} / "
              f"{b['spill_loads']} B spill stores / loads", flush=True)
    if fault := k7_build_fault(out["build"]):
        failed.append(f"build: {fault}")
    freqs = np.linspace(40.0, 600.0, N_FREQ)
    bench = sh_i_problem(dev, 1.0)
    bench.solveForward(freqs)                          # first: warm
    calls = {}
    for label, p in (("bench", bench), ("21k", p21)):
        sweep_s, counts, calls[label] = recorded_sweep(p, freqs)
        out["sweeps"][label] = {"steady_s": sweep_s, "k7": counts}
        print(f"[slice18] (c) {label} steady sweep {sweep_s:.4f} s: K7a / "
              f"K7b {counts['givens_step']} / {counts['backsub']} launches, "
              f"plain versions on the card {counts['plain_on_cuda']}",
              flush=True)

    def replay(label, cl):
        differ, worst = fk.compare(cl)
        n_g = sum(name == "givens_step" for name, _ in cl)
        out["bits"][label] = {"givens_step": n_g, "backsub": len(cl) - n_g,
                              "differ": differ, "max_abs_err": worst}
        print(f"[slice18] (a) {label}: {n_g} K7a and {len(cl) - n_g} K7b "
              f"calls replayed, {differ} differ from the plain version in a "
              f"bit (max abs {worst:.3e})", flush=True)
        if differ or not cl:
            failed.append(f"{label}: {differ} of {len(cl)} K7 calls differ "
                          f"from the plain version (max abs {worst:.3e})")

    for label, cl in calls.items():
        replay(label, cl)
    for k in K7_SYNTH_K:             # each set recorded, replayed, let go
        for L in K7_SYNTH_L:
            replay(f"synthetic k={k} L={L}", synthetic_calls(dev, k, L))
    out["kernels"] = {}
    for name in ("givens_step", "backsub"):
        for label in ("21k", "bench"):
            first = next(a for n, a in calls[label] if n == name)
            rec = k7_time(name, first)
            out["kernels"][f"{name}_{label}"] = rec
            print(f"[slice18] (b) {name} at the {label} sweep's first call "
                  f"(L = {rec['L']}, k = {rec['k']}, bucket {rec['bucket']}"
                  + (f", {rec['active']} active" if "active" in rec else "")
                  + f"): {rec['ms']:.4f} ms on the device, "
                  f"{rec['host_ms']:.4f} ms a call on the host (the "
                  f"wrapper's checks and launch), plain "
                  f"{rec['plain_ms']:.4f} ms, bound "
                  f"{1e3 * rec['bound_ms']:.4f} us ({rec['bound_by']}: "
                  f"{rec['bytes']} B at 3.35 TB/s, {rec['ops']} f64 "
                  "operations at 34 TFLOP/s); the launch dominates; "
                  + ("library: none (no PyTorch call computes a batched "
                     "Givens update)" if rec["library_ms"] is None else
                     f"library (torch.linalg.solve_triangular) "
                     f"{rec['library_ms']:.4f} ms"), flush=True)
    paths = {"sweep_1466": out["sweeps"]["bench"]["k7"],
             "sweep_21k": out["sweeps"]["21k"]["k7"],
             "rj_1466": inv_bench["k7_rj"], "gn_1466": inv_bench["k7_gn"],
             "rj_21k": inv21["k7_rj"], "gn_21k": inv21["k7_gn"],
             "traced_sweep_1466": trace["k7_counted"]}
    for label, counts in paths.items():
        if fault := k7_fault(counts, label):
            failed.append(fault)
    out["paths"] = paths
    print(f"[slice18] (c) phase 13 (e)'s traced steady bench sweep: "
          f"{trace['kernels_in_trace']} kernels, device busy "
          f"{100 * trace['busy_share']:.1f} % of {trace['wall_s']:.4f} s "
          f"(PR 7's trace: idle 79.0 %); K7a / K7b launches by path: "
          + "; ".join(f"{k} {v['givens_step']} / {v['backsub']}"
                      for k, v in paths.items()), flush=True)
    del bench
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError("phase 16 failed: " + " | ".join(failed))
    return out


if __name__ == "__main__":
    sys.exit(main())
