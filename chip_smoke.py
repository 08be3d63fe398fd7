"""Smoke run of gpuintegration_torch on one NVIDIA card.

    python3 chip_smoke.py

Builds the CUDA kernels from the sources, holds each against its plain
PyTorch version, drives PAGANI's ``Workspace.integrate`` at 8D (a Genz
family through the fused rule kernel, a plain callable through the split
route), its ``integrate_to_convergence`` at 8D and 1e-5, the VEGAS
``mcubes.integrate`` at 6D and the differentiable estimates of
``gpuintegration_torch.diff`` at 6D through them, and times them.  Imports
no JAX.  Phases (any failure exits non-zero and prints no result line; each
prints its seconds):

The rule kernel, the sampler, the histogram, the bin resolve and the edge
lookup each have two routes, chosen by the shape: the one built for this
card ('tile', 'paired', 'grouped', 'sample', 'vector') and the generic one,
which is the earlier design.  The main paths must go through the first; the
generic routes are held against the first and the plain versions, and
timed beside the others in the same run.

1. the card's name and power limit; the nvcc builds (all sources started
   together), their seconds and ptxas's registers and spills; the
   instruction counts of the kernels' loops (tools/sass_report.py) where
   the toolkit has cuobjdump;
2. rule kernel vs plain version on the card
   (ops.kernel_check.check_against_plain, printed beside its limits):
   F1-F6 at 8D through the tile route, a pool of 2^16 regions (uniform
   split plus random sub-regions, blocked layout with padding slots), f64
   and f32, and the two routes against each other (split_dim EQUAL, each
   route twice the same bits); the generic route at 9D and 2D, which the
   tile route does not take, and at 10D, 12D and 16D (each of its classes
   of dimensions), every family, f64 and f32;
3. the PAGANI main path: ``Workspace(8).integrate(f4_gaussian(8),
   epsrel=1e-3)`` in f64 (status 0 and |est - truth|/truth <= 1e-3
   required, every launch through the tile route; the kernel's share of
   the wall from CUDA events), then the same in f32 (reported only), each
   final pool held against the plain version, and a 3D run on the card
   against the same run on the CPU; the last pool timed on both routes;
4. rule kernel time at 8D on 2^21 regions, both routes, f64 and f32, best
   of 5 (CUDA events), beside the plain version's; both routes at 3D to
   7D (F1-F6, f64 and f32, without and with the crease fraction, in
   turns); the generic route at the dimensions it serves
   (``tools/generic_times.py``'s ``SHAPES``: 2D, 10D, 12D and 16D pools
   of some milliseconds, F4 and F5, f64 and f32), each beside its bound
   (the parent tree's generic kernel is timed against this one by that
   tool run from both checkouts in one call);
5. the VEGAS kernels vs their plain versions on the card
   (mcubes.kernel_check, printed beside its limits) at the shapes of the
   6D ncall = 1e8 run, one chunk of 2^20 cubes: the sampler (paired
   route, and the two routes against each other: bin ids EQUAL) in emit and
   fused mode, with and without histogram, uniforms from a tensor and
   from the stream, on the lattice's last chunk (its last cubes beyond
   the lattice) and on the chunk at the volume's centre; the generator
   word for word on both routes; the paired kernel and the plain version
   against an f64 evaluation where f^2 and the sum of f2b are hardest to
   read; the generic route at 9D, degree 8, which the paired route does
   not take; histogram, bin resolve and edge lookup at 500 and 50 bins;
   both routes of the histogram (each against the plain version, twice
   the same bits, the accumulating form from bins near the cap) and of the
   bin resolve (rc, xo, ia EQUAL between the routes, drawing xn at the
   centre and at the lattice's end, and given xn over a ragged row) and of
   the edge lookup (EQUAL to the plain version and to each other, on
   random ids, on ids off a 16-byte boundary and on a chunk's stratified
   ids); the bin resolve's wide route at 9D, 12D and 16D on the chunks of
   the 1e9 runs and at 16D on chunks of about 2^21 samples, rows of a
   multiple of 4 and ragged ones (``WIDE_RESOLVE_SHAPES``): rc, xo, ia
   EQUAL to the generic route drawing xn at the centre and past the
   lattice's end and given xn over n and a ragged n - 3 samples, each
   route against the plain version, and a launch on a device counter
   replayed from a CUDA graph EQUAL to launches given the iteration;
6. the VEGAS main path, 6D Genz F4 (a = 25), epsabs 1e-40: (1) the
   default ``integrate(f, epsrel=1e-3, ncall=1e8)`` (f64, poly map,
   sampler 'hybrid'); (2) ``eval_dtype=float32, ncall=1e9, total_iters=10,
   adjust_iters=5`` (sampler 'fused'); (3) ``importance='grid',
   ncall=1e8``.  Each must end status 0 with |est - truth| <= 5 errorest
   and errorest/|est| <= epsrel, having launched its kernels (counts set
   to 0 before and read after each run), the sampler's all through the
   paired route, the histogram's through the grouped route, the bin
   resolve's through the sample route; run 1 repeated must give the same
   bits; run 3 repeated on the generic lookups says whether its estimate
   is the grouped run's and the one of the tree before the lookups' new
   routes (commit 756fd3a); run 2 repeated
   with CUDA events around every launch says what the events cost and what
   share of the wall the launches are; a 3D run on the card must agree with the same run on the
   CPU;
7. the VEGAS kernels' times at the main path's shapes, the sampler, the
   histogram (accumulating, as the main paths call it), the bin resolve
   (drawing xn, and given xn) and the edge lookup (a chunk's stratified ids
   and uniformly random ids) on both routes in turns, best of 5 series of
   launches back to back (``queued_ms``), beside the plain versions', a
   bound, and one PyTorch call computing the same function where there is
   one; the bin resolve's wide route against its generic route in turns at
   9D, 12D and 16D on the 1e9 runs' chunks and at 16D on about 2^21
   samples (rows of a multiple of 4 and ragged ones), drawing xn with ids
   out and without, and given xn, beside the bytes bound, the plain
   version and two ``torch.gather`` of the edges;
   the wide route's two instances' registers (no spill, no stack frame);
8. the diff path, 6D, 500 bins, gauss(x, a) = exp(-a sum (x - 1/2)^2) at
   a = 25: ``train_grid`` (ncall 1e7, 10 adjusting iterations, sampler and
   histogram by their card routes); ``frozen_grid_estimate`` on 2^24
   samples (within 5 errorests of the closed form), its ``torch.func.grad``
   (within 5 % of dI/da and 1e-5 of the common-random-number central
   difference), a ``vmap`` over 4 thetas (the loop's numbers within
   1e-12), the edge lookups counted (set to 0 before and read after; all
   by the vector route, one inside ``grad`` at least) and timed at this
   shape; ``fixed_mesh_integral`` on 6^6 regions (estimate within 1e-9 and
   gradient within 1e-7 of the closed forms: the JAX package reads
   2.0e-11 and 2.7e-9 there on the CPU); the checkpoint pipeline, a 3D
   ``Workspace`` run, ``make_checkpoint``, ``mesh_from_checkpoint``,
   ``fixed_mesh_integral``;
9. the rule's split route (any torch callable: the points kernel, the
   callable, the contraction kernel; csrc/rule_split.cu) against its plain
   version (ops.kernel_check.check_split_against_plain), every case with
   the contraction on each of its two routes, 'cluster' and 'generic'
   (forced by the wrapper's ``route=``): 8D pools of 2^16 regions, blocked
   with padding slots, f64 and f32, ``misc.sin_sum(8)``,
   ``misc.g_function(8)`` and Genz F4 as a plain batched and a per-axis
   callable; ``misc.gauss9d()`` at 9D and ``misc.diagonal_ridge_2d()`` in
   their volumes; ``sin_sum`` and a per-axis cos(sum x) at 12D on the
   Workspace's 1024-region chunks and at 16D on 256-region chunks, f64 and
   f32.  Points EQUAL (bits and strides), values EQUAL, est/err by
   kernel_check's limits, split_dim EQUAL in every region.  Then the
   contraction alone on values made directly: 16D at its 1024-region
   chunk (values as rows and as planes, f64; rows f32), odd counts at 12D
   (their segments off 16-byte units), values of neither layout (the
   generic route); each route twice the same bits.  A NaN region takes the
   widest axis; ``misc.oscillatory(8)`` on the split route against
   ``f1_oscillatory(8, ones)`` on the tile route within 1e-12;
10. the points kernel at the Workspace's 8D f64 chunk (4096 regions),
   best of 5 series back to back (``queued_ms``), beside its bytes bound,
   its plain version and ``torch.addcmul``; both contraction routes in
   turns at the Workspace's 8D (f64 and f32), 12D and 16D chunks, values
   as rows and as planes, beside the bytes bound, ``rule_outputs``,
   ``torch.matmul`` against the TPU kernel's column matrix (the rule sums
   only) and ``torch.sum`` of the values (the same bytes read); at the 8D
   chunk also with L2 flushed before each launch;
11. PAGANI's main path with Genz F4 as a plain callable
   (``Workspace(8).integrate(f4_plain, 1e-3)``, f64): status 0 within 1e-3
   of the truth, phase 3's iterations, regions and neval, every rule
   evaluation through the split kernels and every contraction on the route
   ``contract_route`` names for its values (the cluster route: counts set
   to 0 before and read after), with CUDA events around each launch and
   call for the shares of the points kernel, the callable, the contraction
   kernel and the rest; the same for ``misc.sin_sum(12)`` at
   ``SIN12_EPSREL``; then ``misc.sin_sum(8)`` at 1e-11;
12. the continuation, the reference's flagship:
   ``Workspace(8).integrate_to_convergence(f4_gaussian(8), 1e-5,
   max_wall_s=600)`` (status 0 within 1e-5 of the truth; wall, rounds,
   slices, stage times), which at the 16M-region pool budget certifies in
   round 1; the same at a budget of 2^22 regions (``CONT_POOL``), where
   round 1 walls and the partitioned continuation must carry the run; then
   that continuation stopped before its first slice, saved
   (``state_path``) and resumed from the file, which must give the
   uninterrupted run's estimate, errorest and neval;
   phase 9 also holds a vector integrand's two contraction routes
   (``cuda_rule.split_contract_components``: 'components_cluster' where
   the values lie component-minor, 'components' at any strides) against
   ``rule_eval.rule_outputs_vector`` at COMPONENT_CASES (8D and 12D at the
   Workspace's chunks, 3D odd counts, f64 and f32, 2, 3, 4 and 8
   components, values component-minor and component-major, a NaN region):
   contract_route's choice, est/err by kernel_check's limits, split_dim
   EQUAL, each component bit for bit the scalar route's on its plane (the
   cluster route's for 'components_cluster', the generic route's for
   'components'), two launches the same bits; phase 10 times both in turns
   at the 8D and 12D f64 chunks of four components beside their bound,
   rule_outputs_vector, torch.matmul (the sums only) and four cluster-route
   launches on a component-major copy;
13. PAGANI's vector main path: ``Workspace(8).integrate`` of the
   reference's four vector families as one callable (F1 with coefficients
   1/2, F2 and F4 at a = 5, F5; ``tools/vector_probe.py``) at
   ``VEC8_EPSREL`` (status 0, every component within epsrel and 5
   errorests of its closed form, every rule evaluation through the points
   kernel and the components cluster contraction, CUDA events for the
   shares), then the same run traced by torch.profiler once on each vector
   route (the contraction's device time a launch in situ, the device's
   idle share); [sin_sum(8), sin_sum(8)] at 1e-11 against the scalar run
   (the same decisions, both components equal, the estimate within 1e-12,
   the final pool's first chunk held by kernel_check through both
   contractions); [sin_sum(12)] x 4 at ``SIN12_EPSREL`` against phase 11's
   scalar run (the same iterations, regions and neval, every contraction on
   the components cluster route); the vector continuation at ``VCONT``
   (slices, status 0, and a stop-save-resume that must give the same
   bits);
14. vector VEGAS at run 1's settings on [F4 a=25, F4 a=20] (AUTO must take
   'hybrid'; B2 emit and B3 launched), the grid map (B4 and B3), and [g, g]
   against the scalar run of g: the same iterations, the final grid EQUAL,
   both components equal and within 1e-12 of the scalar estimate;
15. the split fraction (csrc/split_frac.cuh) in every kernel that
   computes it, against ``rule_eval.split_fraction``: the standalone
   kernel (``cuda_rule.split_frac``, csrc/split_frac.cu) on values with
   planted kinks and jumps and a NaN region
   (``kernel_check.crease_stencils``) at the Workspace's 8D f64 (4096 x
   1105), 12D f64 (1024 x 6745) and 8D f32 (8192 x 1105) chunks, as rows
   and as planes, EQUAL on the card and to a CPU copy, its time
   (``queued_ms``) beside its bytes bound and the plain version's; the
   cluster and generic contractions' folded form on the same values
   (``kernel_check.check_contract_frac``: EQUAL to the standalone kernel
   and the plain version, est/err the bits without the fraction), each
   timed with and without it in turns; the fused tile and generic
   kernels' folded form (``kernel_check.check_fused_frac``: EQUAL to the
   plain version on the collinear values the kernel writes out, those
   values the callable's at their rule points within
   ``kernel_check.ULPS['value']`` ulps of their roundoff scale, est/err
   the bits without it, padding 0.5) on F5 and F6 pools of the chunks'
   sizes, blocked with padding and a NaN region; each fused route with and
   without the fraction in turns (``time_ms``) at phase 4's pool (F4, F5)
   and the tile route at the main path's last pool; ptxas's registers and
   spills of every instance print in phase 1;
16. crease/jump-aware splits at full width: 8D ``f5_c0_continuous(8,
   a=10, b=0.37)`` at ``F5_CREASE_EPSREL`` and ``f6_discontinuous(8)`` at
   ``F6_CREASE_EPSREL`` (``tools/crease_probe.py`` finds the deepest each
   certifies within ~30 s), crease against midpoint splits, host loop and
   fused phase: status, iterations, regions, neval, wall (beside the
   split route's walls at commit fce39b8), true error, the launches; every crease run
   certifies within 3x its tolerance on the fused tile route with the
   fraction in every fused launch and no split or standalone launch, and
   the fused crease run takes the host loop's decisions; then the
   fraction's other kernels on a run each: 8D F5 as a plain callable (the
   split route, the fraction in every cluster contraction), 2D F5 at 1e-9
   (the fused generic route), 3D F5 as a per-axis callable (planes: the
   generic contraction);
17. the fused phase (``pagani/fused_loop.py``, CUDA graphs of one
   iteration a bucket capacity): phase 3's run with ``fused=True`` against
   the host loop in turns (the same status, iterations, regions and neval,
   the estimate within 1e-12), its bursts, captures, replays and packed
   reads, each traced once (``utils.profiling.trace``) for the device's
   idle share; phase 13's vector through the fused phase against that
   phase's host-loop run; phase 11's F4 callable cut to its first
   ``SPLIT_FUSED_ITERS`` iterations, fused against its host loop at the
   same cut;
18. VEGAS's device-resident phases (``mcubes/phases.py``): runs 1-3 of
   phase 6 with 3 adjusting iterations (``FROZEN_RUNS``) in the host loop,
   the form the frozen phase chooses and its CUDA graph (``FORMS``, pinned
   by ``phases.FORM``) in turns, then with a frozen phase of
   ``LONG_FROZEN`` iterations (``LONG_RUNS``) in the host loop, eager and
   replayed: every form the host loop's status, iterations, neval and
   estimate bits and its launch counts (counts set to 0 before and read
   after; a replay counts what its capture recorded), walls, replays,
   reads, the seconds of the first iteration, the capture and the rest,
   each form traced once for the device's idle share, and the iterations
   a capture takes to repay; then ``refine='device'`` (the adjustment
   phase: the histogram, the f32 rebin and the poly re-fit on the card) on
   runs 1-3 against ``refine='host'``: status 0, the truth within 5
   errorests, and replayed from a graph the eager run's bits.  Phase 5
   holds a launch of the sampler and of the bin resolve replayed from a
   graph on a device counter EQUAL to launches given the iteration, phase
   7 prints their registers;
19. PAGANI's ``vegas_assisted`` hybrid: the in-region sampling pass on
   the 8D initial pool on the card against the CPU, pass by pass
   (``ASSIST_RTOL``, ``ASSIST_EDGE``);
   ``Workspace(3)`` on F4 (a = 5) at 1e-2 (status 0, the truth within 5
   errorests and the tolerance); ``Workspace(8).integrate(f4_gaussian(8),
   ASSIST_EPSREL, vegas_assisted=True)`` for ``ASSIST_ITERS`` iterations,
   printed (it certifies at no tolerance within reach; every rule
   evaluation on the tile route), the share of the wall in the in-region
   sampling passes;
20. PAGANI's one-shot surface (``pagani/oneshot.py``,
   ``pagani/heuristics.py``): ``apply_cubature_rules`` on phase 4's 2^21
   random 8D sub-regions, F4 through the tile route and F4 as a plain
   callable through the split route, both held against
   ``apply_rule_plain`` on the card (``kernel_check.
   check_outputs_against_plain``); four Genz members as one vector through
   ``apply_cubature_rules_vector`` (the components contraction), each total
   against its member's; ``classify_with_heuristic`` for every policy id,
   the card EQUAL to the CPU; ``capture_func_evals`` on 1024 regions, points
   EQUAL to the CPU's; B1's launches by entry point (counts set to 0
   before, read after);
21. interpolation and the physics likelihood: ``Interp1D/2D/3D``
   (``ops/interp.py``) at 2^24 points, card against the CPU path within 1
   ulp; ``Workspace(6).integrate(ClusterLikelihood(), 3e-4, 1e-40)`` with
   the default ``fused=True`` (the callable captured; status 0), the host
   loop's run with CUDA events (the callable's share; the same
   decisions), the two loops' walls in turns, the f32 table within 1e-6,
   and the VEGAS cross-check
   (``mcubes.integrate`` at ``PHYSICS_VEGAS``, within 5 (err1 + err2); B2
   and B3 launched);
22. Suave (``pagani/suave.py``): the CLI's default case, 5D F4 (a = 25) at
   ``SUAVE_CLI`` (|est - truth| <= 5 errorest), one cycle on the card
   against the CPU on the same grids and draws, 3D F4 (a = 5) at
   ``SUAVE_HELD`` (status 0, the truth within 3 errorests);
23. 1-D quadrature (``ops/quad1d.py``): ``qng``, ``qag`` keys 1-6,
   ``cquad``, ``qawo`` and ``qawf`` on closed-form cases, card against CPU
   (the same neval and intervals, estimates within 1e-12);
24. the mesh (``gpuintegration_torch/parallel``, ranks started by
   ``parallel.launch.run_on_ranks``, their side ``tools/mesh_cases.py``):
   one rank under NCCL (a real communicator), whose main path
   (``Workspace(8, mesh=m)``, F4 at 1e-3, f64, fused) must give phase
   17's fused run bit for bit, every B1 launch tile, and whose VEGAS run 1
   phase 6's; then two ranks under gloo sharing the card: the main path
   (status 0 within 1e-3, phase 3's iterations, regions and neval, the
   estimate within 1e-12 and the errorest within 1e-9), ``sin_sum(8)`` at
   1e-11 (phase 11's decisions, the cluster contraction), ``[sin_sum(8)]
   x 2`` (the components cluster route, the scalar mesh run's decisions),
   8D F5 crease at 1e-2 (the fused tile kernel with the fraction), the
   continuation at ``CONT_POOL`` (certified, its rebalanced resumes
   counted), VEGAS runs 1 and 3 (within 5 combined errorests of phase
   6's); every rank the same bits, every launch on the card's route; each
   rank's wall (not compared), peak memory and free memory printed;
25. any scalar-per-axis callable inside the fused kernels
   (``ops/integrand_gen.py``, csrc/gen_integrand.cu): the generated
   libraries of ``f4_axes`` (8D) and cos(sum x) (12D), built in phase 1,
   and of the reference bench's ``g6`` (6D) and a 10D Gaussian, built here
   alone (a first call's seconds); each generated kernel against its plain
   version (the rule's tile route at 8D on phase 4's 2^21 pool, f64 and
   f32, and generic route at 12D; the sampler's paired route at 6D on a
   2^21-sample chunk and generic route at 6D and 10D) by kernel_check's
   readings; f4_axes on the generated tile kernel against the Genz F4 tile
   kernel and g6 on the generated sampler against the Genz F4 sampler, in
   turns; ``Workspace(8, rule_backend='fused').integrate(f4_axes, 1e-3)``
   in f64 with the fused phase (status 0 within 1e-3, every launch the
   generated tile kernel's, none on the split route; its wall beside
   phases 3, 17 and 11); the bench's frozen g6 case on sampler 'fused'
   against 'hybrid' in turns (each within 5 errorests), AUTO in f32
   ('fused', status 0); the recorder on the main path (a row an iteration,
   the fused phase off), ``cli.main`` for pagani, mcubes, ladder and
   profile (exit 0, the reference's headers) and the continuation log on a
   3D continuation; the generated generic kernel at 12D timed on 2^14 and
   2^18 regions; the emitted integrand alone (the check-only
   ``gen_values_kernel``) on a program of every division and power form
   (``rounding_forms``), EQUAL to the callable's PyTorch calls on the card
   in f64 and f32;
26. the rule kernel's generic route in situ: ``Workspace(10).integrate(
   f4_gaussian(10), 1e-3)`` in f64, host loop and fused phase (the same
   decisions), a 12D per-axis sin(x_1 + ... + x_12) under
   ``rule_backend='fused'`` at ``SIN12_EPSREL`` (against the closed form
   and phase 11's split-route run) and phase 16's 2D F5 crease run: each
   certified, every rule launch on the generic route (counts set to 0
   before and read after), the kernel's share of the wall by CUDA events
   (host loop) or torch.profiler (fused phase);
27. BASELINE's 9D VEGAS Gaussian (``misc.gauss9d``, 1e-3, ncall 1e9,
   'hybrid', the poly map) on the sampler's wide route and grouped
   histogram, and 9D Genz F4 (a = 10) on those and on both forced generic,
   in turns;
28. the same two on the grid map (``importance='grid'``, f64, the default
   sampler, ncall 1e9, 1e-3): F4 on the wide bin resolve and on its
   generic route in turns, the same bits required of the pair, the
   Gaussian on the wide route; every bin-resolve launch on the form's
   route (counts set to 0 before and read after), F4 certified within 5
   errorests of its closed form, the Gaussian's status printed as found;
   walls, iterations, neval and the bin resolve's share of each wall
   (launches times its time alone);
29. VEGAS past 16D: phase 5 holds, and phase 7 times, the sampler's wide
   route (NMAX 24 and 32) in its four modes, the grouped histogram (f^2 in
   f32 and f64) and the wide bin resolve (three forms) against their
   generic routes and plain versions at 17, 20, 24, 28D (ncall 1e9) and
   32D (1e10) on the chunks ``vegas`` takes there (HIGH_ROWS), the
   routes at 17D and 33D (the generic sampler above 32D), the edge lookup
   at 20D and 32D on the diff path's draws and a traced 20D per-axis
   callable in the fused sampler; phase 29 itself runs ``vegas(f,
   ndim=17)`` with the card's defaults, then Genz F4 at 1e-3 and ncall
   1e9: 20D (a = 5) on the poly map ('hybrid' f64 and 'fused' f32) and on
   the grid map, 28D (a = 3) on the poly map, each certified within 5
   errorests
   with every launch on the wide sampler (or bin resolve) and the grouped
   histogram (counts set to 0 before and read after); walls, iterations
   and each kernel's launches times its time alone against the wall;
30. the ``kernels`` JSON line, then the card line and the result line.

Phases 1-14 run PAGANI's host loop (``fused=False``, ``HOST``), as they
did before the fused phase became ``integrate``'s default.
"""
from __future__ import annotations

import contextlib
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from gpuintegration_torch import Workspace, cli, diff, mcubes
from gpuintegration_torch.mcubes import cuda_lookup, cuda_vegas
from gpuintegration_torch.mcubes import grid as vegas_grid
from gpuintegration_torch.mcubes import vegas as vegas_module
from gpuintegration_torch.mcubes import kernel_check as vegas_check
from gpuintegration_torch.mcubes import phases as vegas_phases
from gpuintegration_torch.models import genz, misc, physics
from gpuintegration_torch.ops import (cuda_build, cuda_rule, integrand_gen,
                                      interp, kernel_check, quad1d, rule_eval)
from gpuintegration_torch.parallel.launch import run_on_ranks
from gpuintegration_torch.pagani import (fused_loop, oneshot, region_pool,
                                         vegas_assisted)
from gpuintegration_torch.pagani import suave as suave_mod
from gpuintegration_torch.tools import (assisted_probe, mesh_cases,
                                        route_bits, sass_report,
                                        vector_probe)
from gpuintegration_torch.tools import generic_times as generic_tool
from gpuintegration_torch.types import Volume
from gpuintegration_torch.utils import recorder, timing
from gpuintegration_torch.utils.profiling import StageTimer

NDIM = 8
# Phases 1-14 drive PAGANI's host loop, as they did before the fused phase
# became the default; phases 16-17 run both.
HOST = {"fused": False}
# H100 SXM data sheet, dense, outside the tensor cores; HBM3 rate.
PEAK_OPS = {torch.float64: 34e12, torch.float32: 67e12}
PEAK_BYTES_PER_S = 3.35e12


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    raise SystemExit(1)


EPILOGUE_OPS = 250   # rule sums, fourth differences, error model, per region


# Operations of the Genz families' per-axis work, counted from
# csrc/genz.cuh: ``genz_pre`` (what depends on the coordinate alone: F2's
# subtract and multiply-add, F4's subtract and square, F5's subtract; |x|
# not counted) and ``genz_fold`` (what folds it into a point's state: one
# multiply-add, 2, for F1, F3, F4, F6; one multiply or add for F2, F5; a
# comparison not counted).
GENZ_PRE_OPS = {1: 0, 2: 3, 3: 0, 4: 2, 5: 1, 6: 0}
GENZ_FOLD_OPS = {1: 2, 2: 1, 3: 2, 4: 2, 5: 1, 6: 2}
COORD_OPS = 2        # x = c - g l, one multiply-add


def ops_per_point(kind: int, ndim: int) -> int:
    """Arithmetic operations per rule point that the function needs: a
    rule point's coordinates take only 11 values an axis in a region, so
    what depends on the coordinate alone is counted once a region
    (``ops_per_region``), and a point pays the fold of each axis, the
    family's finish and 1 to add the value into its orbit sum.  A
    transcendental (exp, cos) counts as ONE operation, so the bound built
    from this count is a lower bound."""
    e = ndim + 1
    finish = {1: 2, 2: 1, 3: 2 + e.bit_length() + bin(e).count("1"),
              4: 2, 5: 2, 6: 1}[kind]
    return ndim * GENZ_FOLD_OPS[kind] + finish + 1


def ops_per_region(kind: int, ndim: int) -> int:
    """Arithmetic operations a region needs besides its points': its 11
    coordinates an axis formed and put through ``genz_pre`` (11 ndim of
    each), and the epilogue (rule sums, fourth differences, error model)."""
    return 11 * ndim * (COORD_OPS + GENZ_PRE_OPS[kind]) + EPILOGUE_OPS


# Arithmetic operations of the split fraction, counted from
# csrc/split_frac.cuh axis_frac: on every axis 8 for the four secants and
# 12 for the jump gates; once a region, on its split axis only
# (``want_kink``), 14 for the two lines' intersections, 10 for the kink
# gates, 2 relative breaks and 2 for the cut.  Comparisons, |x| and
# selections are not counted and a division counts as ONE operation, so
# the bound built from these counts lies below the kernel's true least
# time.
FRAC_OPS_PER_AXIS = 20
FRAC_KINK_OPS = 28


def bound_ms(kind: int, ndim: int, n: int, dtype,
             frac: bool = False) -> tuple[float, str]:
    """The least time of a fused launch over ``n`` regions: its operations
    at the peak rate, or its bytes (the bounds read, est, err and split_dim
    written) at the memory rate, whichever is larger; with ``frac`` the
    split fraction's operations and the fraction written too."""
    feval = rule_eval.rule_tables(ndim).feval
    ops = n * (feval * ops_per_point(kind, ndim) + ops_per_region(kind, ndim)
               + (ndim * FRAC_OPS_PER_AXIS + FRAC_KINK_OPS if frac else 0))
    item = torch.finfo(dtype).bits // 8
    nbytes = n * (2 * ndim * item + (3 if frac else 2) * item + 4)
    t_ops, t_bytes = ops / PEAK_OPS[dtype], nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def f64_pipe_floor_ms(ndim: int, n: int, f64_per_point: float) -> float:
    """The least time the f64 pipe alone needs for a pool on the tile
    route, given the f64 instructions the machine code spends on a rule
    point (``tile_f64_per_point``): each occupies the pipe as a
    multiply-add does, two operations a lane at the peak rate that
    ``bound_ms`` uses.  The operation bound counts the exp as one operation
    and so lies below this floor."""
    feval = rule_eval.rule_tables(ndim).feval
    return 1e3 * n * feval * f64_per_point * 2 / PEAK_OPS[torch.float64]


TILE_POINTS_PER_PASS = 2     # rule_tile_kernel keeps two points in flight


def tile_f64_per_point(kernels) -> float | None:
    """f64 instructions per rule point in rule_tile_kernel<4, double, 8>,
    from this build's machine code (``sass_report.report``): those of its
    most deeply nested loop, the pass over two points of an orbit.  None
    where there is no report."""
    for name, _, found in kernels or ():
        if "rule_tile_kernel<4, double, 8>" in name and found:
            _, counts = max(found, key=lambda lc: lc[0])
            return counts["f64"] / TILE_POINTS_PER_PASS
    return None


def random_pool(ndim, cap, seed, dtype, dev):
    """``cap`` regions: random sub-boxes of the 2-per-axis uniform split."""
    parents_lo, parents_len, n0 = region_pool.uniform_split(
        ndim, 2, 2 ** ndim, torch.float64)
    rng = np.random.default_rng(seed)
    pick = np.arange(cap) % n0
    frac = rng.uniform(2.0 ** -6, 1.0, (ndim, cap))
    off = rng.uniform(0.0, 1.0, (ndim, cap)) * (1.0 - frac)
    plen = parents_len.numpy()[:, pick]
    lows = parents_lo.numpy()[:, pick] + off * plen
    return (torch.as_tensor(lows, dtype=dtype, device=dev).contiguous(),
            torch.as_tensor(frac * plen, dtype=dtype, device=dev).contiguous())


def time_ms(fn, reps: int = 3) -> float:
    """Best of ``reps`` single calls, CUDA events, after one warm call.
    The time from one event to the next holds the host's time to reach the
    launch: a kernel of less than a millisecond is timed by ``queued_ms``."""
    fn()
    torch.cuda.synchronize()
    best = math.inf
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def once_ms(fn) -> float:
    """One call by CUDA events, no warm call: for a plain version of
    seconds, which compiles nothing."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def ptxas_summary(log: str) -> str:
    """Registers and spill bytes per kernel from nvcc's -Xptxas -v report."""
    regs = [int(m) for m in re.findall(r"Used (\d+) registers", log)]
    spills = [int(a) + int(b) for a, b in re.findall(
        r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)]
    if not regs:
        return "ptxas reported no register counts"
    return (f"{len(regs)} kernels, {min(regs)}-{max(regs)} registers per "
            f"thread, at most {max(spills, default=0)} spill bytes")


def ptxas_by_kernel(log: str) -> dict[str, tuple[str, int, int]]:
    """Registers (a range over the Genz families, written as *), the most
    spill bytes and the largest stack frame of each kernel template
    instance of an nvcc report (``route_bits.ptxas_kernels``)."""
    groups: dict[str, list] = {}
    for name, rs in route_bits.ptxas_kernels(log).items():
        key = re.sub(r"^(rule_(?:tile_|generic_)?kernel<)\d", r"\1*", name)
        groups.setdefault(key, []).append(rs)
    out = {}
    for k, v in sorted(groups.items()):
        regs = sorted({r[0] for r in v})
        out[k] = (f"{regs[0]}-{regs[-1]}" if len(regs) > 1 else str(regs[0]),
                  max(r[1] for r in v), max(r[2] for r in v))
    return out


_blocker = []


def queued_ms(fn, reps: int, inner: int = 20) -> float:
    """Time of one call of ``fn`` on the device alone, for a kernel so
    short that the host takes longer to launch it than the card to run it:
    best of ``reps`` series of ``inner`` calls, CUDA events around a series.
    A matrix product of some milliseconds is enqueued first, so that the
    host has every call of the series in the queue before the card is free
    to begin, and the calls run back to back."""
    if not _blocker:
        _blocker.append(torch.zeros((6144, 6144), device="cuda"))
    fn()
    torch.cuda.synchronize()
    best = math.inf
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.mm(_blocker[0], _blocker[0])
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / inner)
    return best


def compare_routes(label, *args, **kw):
    """kernel_check.check_routes, printed on one line; a disagreement
    fails the run."""
    try:
        r = kernel_check.check_routes(*args, **kw)
    except AssertionError as e:
        fail(str(e))
    print(f"{label}: tile vs generic route, {r['slots']} slots: split_dim "
          f"EQUAL, each route twice the same bits; max|d est| "
          f"{r['est_rel']:.3g}, max|d err| {r['err_rel']:.3g} of the pool's "
          f"largest", flush=True)


def compare(label, *args, **kw):
    """kernel_check.check_against_plain, printed on one line; a
    disagreement fails the run."""
    try:
        r = kernel_check.check_against_plain(*args, **kw)
    except AssertionError as e:
        fail(str(e))
    ties = (f", tie gaps max {r['tie_ulps_max']:.3g} median "
            f"{r['tie_ulps_median']:.3g} ulps, {r['exact_ties']} exact"
            if r["mismatches"] else "")
    print(f"{label}: {r['regions']} regions, max|d est| "
          f"{r['max_abs_est']:.3e}; beyond rtol, in ulps of the roundoff "
          f"scale (limits {kernel_check.ULPS['est']:g}/"
          f"{kernel_check.ULPS['err']:g}): est {r['est_ulps']:.3g}, err "
          f"{r['err_ulps']:.3g} ({r['err_ulps_without_gate_ties']:.3g} "
          f"before {r['gate_ties']} gate ties); plain err median "
          f"{r['err_resolved_ulps_median']:.3g} ulps of its scale; "
          f"split_dim agree {r['agree']:.6f} ({r['mismatches']} near-ties"
          f"{ties})", flush=True)
    return r


# ---------------------------------------------------------------------------
# VEGAS (phases 5-7)

VEGAS_NDIM = 6
VEGAS_CHUNK = 1 << 20
# (ndim, ncall, chunk, degree) where phase 5 holds the sampler's routes
# redesigned for 1D, 2D and 9..16D: the 9D case the generic route took
# before them, and ncall 1e9 at each dimension on chunks of its run's shape
# (12D: npg 4; 16D: npg 23, 8 lanes a cube)
NEW_ROUTE_CASES = [(9, 4e6, 1 << 18, 8), (1, 1e9, 1 << 18, 14),
                   (2, 1e9, 1 << 18, 14), (9, 1e9, 1 << 18, 14),
                   (12, 1e9, 1 << 16, 14), (16, 1e9, 1 << 15, 14)]
# (ndim, cubes) of the bin resolve's wide route: the chunks a run at ncall
# 1e9 takes at 9D (2^20 cubes of 2 samples), 12D (2^18 of 4) and 16D (2^15
# of 23), and 16D on chunks of about 2^21 samples, rows of a multiple of 4
# samples (91,180 cubes) and ragged ones (91,181: no 16-byte words); phase
# 5 holds them all, phase 7 times them all
WIDE_RESOLVE_SHAPES = [(9, 1 << 20), (12, 1 << 18), (16, 1 << 15),
                       (16, 91180), (16, 91181)]
# VEGAS run 3's estimate as this script printed it on an NVIDIA H100 80GB
# HBM3 at commit 756fd3a, when the lookups had only their generic routes
GENERIC_RUN3_ESTIMATE = 1.2700805996066006e-07
GENZ_AXIS_OPS = {1: 2, 2: 4, 3: 2, 4: 4, 5: 3, 6: 3}


def sampler_bound_ms(kind: int, ndim: int, kp: int, kq: int, n: int,
                     with_hist: bool) -> tuple[float, str]:
    """Bound of one sampler launch over ``n`` samples; ``kind`` 0 is the
    emit mode, 1..6 the fused Genz family.  Operations per (sample,
    dimension), counted from csrc/vegas_sample.cu: the recurrence's
    multiply-adds (2 per term of P, 1 per term of q) at 2 operations each;
    10 for uniform, stratified position, t, clip, weight and bin id; 25 for
    the generator (10 rounds of 10 integer operations per 4 dimensions);
    the integrand's per-axis work.  exp and cos count as ONE operation, so
    this is a lower bound.  Bytes: what the mode writes."""
    per_dim = 2 * (2 * (kp - 2) + max(kq - 2, 0) + 2) + 10 + 25
    per_sample = ndim * (per_dim + GENZ_AXIS_OPS.get(kind, 0)) + 6
    per_sample_bytes = (4 * ndim if with_hist else 0) + (
        4 * (ndim + 1) if kind == 0 else (4 if with_hist else 0))
    t_ops = n * per_sample / PEAK_OPS[torch.float32]
    t_bytes = n * per_sample_bytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def bytes_bound_ms(nbytes: int) -> float:
    return 1e3 * nbytes / PEAK_BYTES_PER_S


def stratified_ids(nbins: int, dev):
    """The bin ids (C, npg, ndim) int32 of the chunk of 2^20 cubes around
    the centre of the 6D ncall = 1e8 lattice, as the grid map draws them."""
    case = vegas_check.sampler_case(VEGAS_NDIM, 1e8, VEGAS_CHUNK,
                                    position="middle", device=dev)
    c, npg = case["chunk_cubes"], case["npg"]
    xn, _ = cuda_lookup.stratified_xn_plain(
        VEGAS_NDIM, case["ng"], npg, nbins, c, case["cube0"], case["ncubes"],
        0, 1, dev)
    ids = torch.clamp(xn.to(torch.int32), 1, nbins)
    return ids.T.reshape(c, npg, VEGAS_NDIM).contiguous()


def vegas_checks(dev):
    """Phase 5; returns the largest absolute difference read per kernel."""
    g4 = genz.f4_gaussian(VEGAS_NDIM)
    err = {"vegas_sample": 0.0}
    for position in ("end", "middle"):
        case = vegas_check.sampler_case(VEGAS_NDIM, 1e8, VEGAS_CHUNK,
                                        position=position, device=dev)
        for with_hist in (False, True):
            for rng in ("input", "device"):
                for integrand in (None, g4):
                    try:
                        r = vegas_check.check_sampler(
                            case, integrand, with_hist=with_hist, rng=rng,
                            route="paired")
                        rr = vegas_check.check_sampler_routes(
                            case, integrand, with_hist=with_hist, rng=rng)
                    except AssertionError as e:
                        fail(str(e))
                    what = ("emit " if integrand is None else "fused F4 ")
                    readings = ", ".join(
                        f"{k[:-5]} {v:.3g} (limit "
                        f"{vegas_check.ULPS[k[:-5]]:g})"
                        for k, v in r.items() if k[:-5] in vegas_check.ULPS)
                    equal = ", ".join(k[:-6] for k in rr
                                      if k.endswith("_equal"))
                    sums = (f"; sums {rr['sums_ulps']:.3g} f64 ulps apart"
                            if "sums_ulps" in rr else "")
                    print(f"phase 5: sampler {what}hist={with_hist} rng={rng} "
                          f"chunk at the {position}: {r['samples']} samples"
                          f"{', bin ids equal' if with_hist else ''}; in ulps "
                          f"of the rounding scale: {readings}; paired vs "
                          f"generic route: {equal} EQUAL{sums}", flush=True)
                    err["vegas_sample"] = max(err["vegas_sample"],
                                              r.get("max_abs_x", 0.0))
        try:
            r = vegas_check.check_stream(case, route="paired")
            vegas_check.check_stream(case, route="generic")
        except AssertionError as e:
            fail(str(e))
        print(f"phase 5: generator, chunk at the {position}: "
              f"{r['uniforms']} uniforms equal to the plain generator's on "
              f"both routes", flush=True)
    # where f^2 and the sum of f2b are hardest to read: the paired kernel
    # and the plain version against an f64 evaluation (fx crossing zero
    # under F1; cubes at the variance floor under F3 and F5)
    for ndim, ncall, chunk, degree, position, g in (
            (6, 1e8, VEGAS_CHUNK, 14, "end", genz.f1_oscillatory(6)),
            (6, 1e8, 1 << 14, 14, "end", genz.f3_corner_peak(6)),
            (6, 1e8, 1 << 14, 14, "end", genz.f5_c0_continuous(6)),
            (8, 5.2e10, 4096, 8, "middle", genz.f3_corner_peak(8))):
        case = vegas_check.sampler_case(
            ndim, ncall, chunk, nbins=500 if degree == 14 else 100,
            degree=degree, position=position, device=dev)
        for rng in ("input", "device"):
            try:
                r = vegas_check.check_sampler(case, g, with_hist=True,
                                              rng=rng, route="paired")
            except AssertionError as e:
                fail(str(e))
            w = vegas_check.sampler_f64_witness(case, g, rng=rng,
                                                route="paired")
            print(f"phase 5: witness {ndim}D ncall {ncall:g} {g.name} "
                  f"rng={rng}, {r['samples']} samples: f2 {r['f2_ulps']:.3g} "
                  f"ulps kernel vs plain; vs the f64 evaluation kernel "
                  f"{w['kernel_f2_ulps']:.3g}, plain {w['plain_f2_ulps']:.3g}; "
                  f"sum f2b {r['sum_f2b']:.6e}: {r['f2b_ulps']:.3g} ulps after "
                  f"{r['f2b_floor_steps']} floors of {r['f2b_floor_ties']} "
                  f"tied cubes ({r['f2b_ulps_before_floor_ties']:.3g} before); "
                  f"above the f64 sum {w['sum_f2b_f64']:.6e} by TINY times "
                  f"kernel {w['kernel_f2b_floors']:.6f}, plain "
                  f"{w['plain_f2b_floors']:.6f}", flush=True)
            if not w["kernel_f2_ulps"] <= vegas_check.ULPS["f2"]:
                fail(f"witness: the kernel's f2 lies {w['kernel_f2_ulps']} "
                     "ulps from the f64 evaluation")
    # the routes redesigned for 1D, 2D and 9..16D, each against the plain
    # version and the generic route, and the generic route by name
    for ndim, ncall, chunk, degree in NEW_ROUTE_CASES:
        case = vegas_check.sampler_case(ndim, ncall, chunk, degree=degree,
                                        position="end", device=dev)
        pmap = case["pmap"]
        want = "paired" if ndim <= 2 else "wide"
        if cuda_vegas.sampler_route(ndim, pmap.kp, pmap.kq) != want:
            fail(f"a {ndim}D map should take the sampler's {want} route")
        for integrand in (None, genz.f4_gaussian(ndim)):
            # the weights held to their f64 evaluation: at 1D and 2D the
            # plain version's own roundings reach the limit (PERF.md)
            witness = {"weight_witness": True} if integrand is None else {}
            try:
                r = vegas_check.check_sampler(case, integrand, with_hist=True,
                                              rng="device", **witness)
                g = vegas_check.check_sampler(case, integrand, with_hist=True,
                                              rng="device", route="generic",
                                              **witness)
                rr = vegas_check.check_sampler_routes(
                    case, integrand, with_hist=True, rng="input")
            except AssertionError as e:
                fail(f"{ndim}D: {e}")
            readings = ", ".join(f"{k[:-5]} {v:.3g}" for k, v in r.items()
                                 if k.endswith("_ulps"))
            generic = ", ".join(f"{k[:-5]} {v:.3g}" for k, v in g.items()
                                if k.endswith("_ulps"))
            sums = (f"; sums {rr['sums_ulps']:.3g} f64 ulps apart"
                    if "sums_ulps" in rr else "")
            lanes = (cuda_vegas.wide_lanes(case["chunk_cubes"], case["npg"],
                                           integrand is None)
                     if want == "wide" else 1)
            print(f"phase 5: {want} route, {ndim}D ncall {ncall:g} degree "
                  f"{degree}, {case['chunk_cubes']} cubes of {case['npg']} "
                  f"(lanes {lanes}), "
                  f"{'emit' if integrand is None else 'fused F4'}, the chunk "
                  f"past the lattice's end: {r['samples']} samples, bin ids "
                  f"equal; ulps against the plain version: {readings} "
                  f"(generic route by name: {generic}); against the generic "
                  f"route coordinates, weights, bin ids and f^2 EQUAL{sums}",
                  flush=True)
            err["vegas_sample"] = max(err["vegas_sample"],
                                      r.get("max_abs_x", 0.0))
    n = VEGAS_CHUNK * 2
    for nbins in (500, 50):
        try:
            h = vegas_check.check_hist(VEGAS_NDIM, n, nbins, device=dev)
            b = vegas_check.check_bin_resolve(VEGAS_NDIM, n, nbins,
                                              device=dev)
            bs = vegas_check.check_bin_resolve_stratified(
                VEGAS_NDIM, 1e8, VEGAS_CHUNK, nbins, device=dev)
            # both edge-lookup routes: uniformly random ids, the same 1
            # element off a 16-byte boundary, a chunk's stratified ids
            e = [vegas_check.check_edge_routes(
                VEGAS_NDIM, VEGAS_CHUNK, 2, nbins, offset=offset, ia=ids,
                device=dev) for offset, ids in (
                    (0, None), (1, None), (0, stratified_ids(nbins, dev)))]
        except AssertionError as exc:
            fail(str(exc))
        if any(r["routes"] != ["vector", "generic"] for r in e):
            fail(f"nbins {nbins}: the edge lookup should take both routes, "
                 f"got {[r['routes'] for r in e]}")
        e = e[0]
        print(f"phase 5: nbins {nbins}, {n} samples: histogram max rel "
              f"{h['max_rel']:.3g} (limit {vegas_check.HIST_RTOL:g}), two "
              f"launches bitwise equal; bin resolve ia, xo equal, rc "
              f"{b['rc_ulps']} ulps given xn and {bs['rc_ulps']} drawing xn "
              f"(limit {vegas_check.RC_ULP}); edge lookup vector and generic "
              f"routes EQUAL to the plain version and to each other on "
              f"random ids, random ids 1 element off a 16-byte boundary and "
              f"the stratified ids of the chunk at the centre", flush=True)
        if nbins == 500:
            err.update(vegas_hist=h["max_abs"], vegas_bin_resolve=max(
                b["max_abs"], bs["max_abs"]), vegas_edge_lookup=e["max_abs"])
        # both routes of the histogram and the bin resolve
        try:
            hr = vegas_check.check_hist_routes(VEGAS_NDIM, n, nbins,
                                               device=dev)
            rr = vegas_check.check_resolve_routes(VEGAS_NDIM, 1e8,
                                                  VEGAS_CHUNK, nbins,
                                                  device=dev)
        except AssertionError as exc:
            fail(str(exc))
        if hr["routes"] != ["grouped", "generic"] or rr["routes"] != [
                "sample", "generic"]:
            fail(f"nbins {nbins}: the main path's shapes should take both "
                 f"routes, got {hr['routes']} and {rr['routes']}")
        print(f"phase 5: nbins {nbins}, {n} samples: histogram grouped "
              f"route max rel {hr['grouped']['max_rel']:.3g}, accumulating "
              f"from bins near the cap {hr['grouped']['accum_max_rel']:.3g}; "
              f"generic route {hr['generic']['max_rel']:.3g}, "
              f"{hr['generic']['accum_max_rel']:.3g} (limit "
              f"{vegas_check.HIST_RTOL:g}); between the routes "
              f"{hr['between_routes_max_rel']:.3g}; each route twice the "
              f"same bits, f2 in f64 as in f32, the accumulating form EQUAL "
              f"to min(d + its histogram, cap); bin resolve sample vs "
              f"generic route, drawing xn at the centre and the lattice's "
              f"end, given xn over {rr['samples']} and {rr['samples'] - 3} "
              f"samples: rc, xo, ia EQUAL, rc {rr['rc_ulps']} ulps from the "
              f"plain version", flush=True)
        if nbins == 500:
            err["vegas_hist"] = max(err["vegas_hist"],
                                    hr["grouped"]["max_abs"],
                                    hr["generic"]["max_abs"])
    # the grouped histogram at 9..16D
    for ndim in (9, 12, 16):
        try:
            hr = vegas_check.check_hist_routes(ndim, VEGAS_CHUNK * 2, 500,
                                               device=dev)
        except AssertionError as exc:
            fail(str(exc))
        if hr["routes"] != ["grouped", "generic"]:
            fail(f"{ndim}D, 500 bins: the histogram should take both routes, "
                 f"got {hr['routes']}")
        print(f"phase 5: histogram {ndim}D, 500 bins, {VEGAS_CHUNK * 2} "
              f"samples: grouped route max rel {hr['grouped']['max_rel']:.3g}"
              f", accumulating {hr['grouped']['accum_max_rel']:.3g}; generic "
              f"{hr['generic']['max_rel']:.3g}, "
              f"{hr['generic']['accum_max_rel']:.3g} (limit "
              f"{vegas_check.HIST_RTOL:g}); between the routes "
              f"{hr['between_routes_max_rel']:.3g}; each route twice the same "
              f"bits; {cuda_lookup.hist_plan(VEGAS_CHUNK * 2, ndim, 500)[1]} "
              f"clusters, the card holds "
              f"{cuda_lookup.hist_clusters_on_card(ndim, 500)}", flush=True)
        err["vegas_hist"] = max(err["vegas_hist"], hr["grouped"]["max_abs"])
    # the bin resolve's wide route at 9..16D on the chunks of the 1e9 runs
    # and on 16D chunks of about 2^21 samples: drawing xn at the centre and
    # past the lattice's end, given xn over n and a ragged n - 3 samples,
    # against the generic route and the plain version
    err["vegas_bin_resolve_wide"] = 0.0
    for ndim, cubes in WIDE_RESOLVE_SHAPES:
        try:
            rr = vegas_check.check_resolve_routes(ndim, 1e9, cubes, 500,
                                                  device=dev)
        except AssertionError as exc:
            fail(str(exc))
        if rr["routes"] != ["wide", "generic"]:
            fail(f"{ndim}D, 500 bins: the bin resolve should take the wide "
                 f"and the generic route, got {rr['routes']}")
        print(f"phase 5: bin resolve {ndim}D, {cubes} cubes ({rr['samples']} "
              f"samples), 500 bins: wide vs generic route, drawing xn at the "
              f"centre and past the lattice's end, given xn over "
              f"{rr['samples']} and {rr['samples'] - 3} samples: rc, xo, ia "
              f"EQUAL; rc {rr['rc_ulps']} ulps from the plain version (limit "
              f"{vegas_check.RC_ULP}), ia and xo EQUAL to it", flush=True)
        err["vegas_bin_resolve_wide"] = max(err["vegas_bin_resolve_wide"],
                                            rr["max_abs"])
    return err


class LaunchCounts:
    """The launch counts of the VEGAS wrappers for one run: set to 0 on
    entry, read on exit.  (The kernels are too short for events around each
    launch to time them: phase 7 times each alone, and reckons from the
    counts what the card was busy with.)"""

    def __enter__(self):
        cuda_vegas.reset_launches()
        cuda_lookup.reset_launches()
        return self

    def __exit__(self, *exc):
        self.sampler_routes = dict(cuda_vegas.route_launches)
        self.hist_routes = dict(cuda_lookup.hist_route_launches)
        self.resolve_routes = dict(cuda_lookup.resolve_route_launches)
        self.launches = {"vegas_sample": cuda_vegas.launches,
                         "vegas_hist": cuda_lookup.hist_launches,
                         "vegas_bin_resolve": cuda_lookup.bin_resolve_launches,
                         "vegas_edge_lookup": cuda_lookup.edge_lookup_launches}
        return False


class LaunchEvents:
    """CUDA events around every launch of the VEGAS wrappers while it is
    entered: ``seconds`` is then the time between the events of all
    launches, the host's time to launch included.  The events cost the host
    time of their own, so a run's wall is read without them and this only
    says what share of a wall the launches are."""
    NAMES = ((cuda_vegas, "sample_chunk"), (cuda_lookup, "hist_accum"),
             (cuda_lookup, "bin_resolve_stratified"))

    def __enter__(self):
        self.events, self.kept = [], []
        for module, name in self.NAMES:
            fn = getattr(module, name)
            self.kept.append((module, name, fn))
            setattr(module, name, self._timed(fn))
        return self

    def _timed(self, fn):
        def timed(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            end.record()
            self.events.append((start, end))
            return out
        return timed

    def __exit__(self, *exc):
        for module, name, fn in self.kept:
            setattr(module, name, fn)
        torch.cuda.synchronize()
        self.seconds = sum(s.elapsed_time(e) for s, e in self.events) / 1e3
        return False


class GenericLookups:
    """While entered, the histogram and the bin resolve take their generic
    routes (the first design's kernels, and around the histogram the
    first design's PyTorch steps) whatever the shape."""

    def __enter__(self):
        self.kept = (cuda_lookup.hist_route, cuda_lookup.resolve_route)
        cuda_lookup.hist_route = lambda *a: "generic"
        cuda_lookup.resolve_route = lambda *a: "generic"
        return self

    def __exit__(self, *exc):
        cuda_lookup.hist_route, cuda_lookup.resolve_route = self.kept
        return False


def vegas_run(label, g, expect, events=False, lookups="card", **kw):
    """One VEGAS run through the entry point; requires status 0, the truth
    within 5 errorest, errorest/|est| <= epsrel and a launch of every
    kernel in ``expect``, the sampler's all by the paired route and the
    lookups' all by the routes built for the card ('grouped', 'sample'),
    or with ``lookups='generic'`` all by their generic routes.  Returns
    (result, launches, wall seconds).  With ``events`` the launches run
    between CUDA events, and their share of that run's (longer) wall is
    printed."""
    torch.cuda.synchronize()
    with LaunchCounts() as clock, (GenericLookups() if lookups == "generic"
                                   else contextlib.nullcontext()):
        if events:
            with LaunchEvents() as between:
                t0 = time.perf_counter()
                res = mcubes.integrate(g, epsabs=1e-40, **kw)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            print(f"phase 6: {label}: {len(between.events)} launches between "
                  f"CUDA events take {between.seconds:.4f} s of this run's "
                  f"{wall:.3f} s wall = {100 * between.seconds / wall:.1f}%",
                  flush=True)
        else:
            t0 = time.perf_counter()
            res = mcubes.integrate(g, epsabs=1e-40, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    pull = abs(res.estimate - g.true_value) / res.errorest
    print(f"phase 6: {label}: status {res.status} estimate {res.estimate!r} "
          f"errorest {res.errorest!r} truth {g.true_value!r} pull "
          f"{pull:.3f} chi_sq {res.chi_sq:.4f} prob {res.prob:.4f} iters "
          f"{res.iters} neval {res.neval} wall {wall:.3f} s samples/s "
          f"{res.neval / wall:.4e} launches {clock.launches} (by route: "
          f"sampler {clock.sampler_routes}, histogram {clock.hist_routes}, "
          f"bin resolve {clock.resolve_routes})", flush=True)
    if res.status != 0 or not pull <= 5.0 or not (
            res.errorest / abs(res.estimate) <= kw["epsrel"]):
        fail(f"{label}: status {res.status}, pull {pull}, errorest "
             f"{res.errorest}")
    for name in clock.launches:
        if (clock.launches[name] > 0) != (name in expect):
            fail(f"{label}: {name} launched {clock.launches[name]} times; "
                 f"the run should go through {sorted(expect)} only")
    if clock.sampler_routes["paired"] != clock.launches["vegas_sample"]:
        fail(f"{label}: the sampler's launches by route are "
             f"{clock.sampler_routes}; all should take the paired route")
    hist_route, resolve_route = (("generic", "generic") if lookups == "generic"
                                 else ("grouped", "sample"))
    if (clock.hist_routes[hist_route] != clock.launches["vegas_hist"]
            or clock.resolve_routes[resolve_route]
            != clock.launches["vegas_bin_resolve"]):
        fail(f"{label}: the lookups' launches by route are histogram "
             f"{clock.hist_routes}, bin resolve {clock.resolve_routes}; all "
             f"should take the {hist_route} and the {resolve_route} route")
    return res, clock.launches, wall


def vegas_main_path(dev):
    """Phase 6; returns the launch counts and the walls of runs 1-3, and
    the results of runs 1 and 3."""
    g6 = genz.f4_gaussian(VEGAS_NDIM)
    sh = {"vegas_sample", "vegas_hist"}
    walls = {}
    r1, l1, walls["run1"] = vegas_run("run 1, f64 poly hybrid ncall 1e8", g6,
                                      sh, epsrel=1e-3, ncall=1e8)
    r1b, _, _ = vegas_run("run 1 again", g6, sh, epsrel=1e-3, ncall=1e8)
    if (r1.estimate, r1.errorest, r1.chi_sq) != (r1b.estimate, r1b.errorest,
                                                 r1b.chi_sq):
        fail("run 1 repeated with the same seed gives other bits")
    _, l2, walls["run2"] = vegas_run(
        "run 2, f32 poly fused ncall 1e9", g6, sh, epsrel=1e-3, ncall=1e9,
        eval_dtype=torch.float32, total_iters=10, adjust_iters=5)
    # the same run with events around each launch: what the events cost the
    # host, and the launches' share of a wall by measurement
    vegas_run("run 2 with an event pair around each launch", g6, sh,
              events=True, epsrel=1e-3, ncall=1e9, eval_dtype=torch.float32,
              total_iters=10, adjust_iters=5)
    r3, l3, walls["run3"] = vegas_run(
        "run 3, f64 grid ncall 1e8", g6, {"vegas_bin_resolve", "vegas_hist"},
        epsrel=1e-3, ncall=1e8, importance="grid")
    # the same run on the first design's lookups: the bin resolve's routes
    # agree bit for bit, so any other estimate comes from the histogram's
    # order of addition
    r3g, _, walls["run3_generic"] = vegas_run(
        "run 3 with both lookups forced to 'generic'", g6,
        {"vegas_bin_resolve", "vegas_hist"}, lookups="generic", epsrel=1e-3,
        ncall=1e8, importance="grid")
    same = (r3g.estimate, r3g.errorest) == (r3.estimate, r3.errorest)
    print(f"phase 6: run 3 on the generic lookups: estimate {r3g.estimate!r} "
          f"errorest {r3g.errorest!r}, {'EQUAL to' if same else 'not equal to'}"
          f" the grouped/sample run's; run 3 at commit 756fd3a (the same "
          f"generic lookups) gave {GENERIC_RUN3_ESTIMATE!r}: "
          f"{'equal' if r3g.estimate == GENERIC_RUN3_ESTIMATE else 'NOT equal'}",
          flush=True)

    g3 = genz.f4_gaussian(3, a=5.0)
    kw = dict(epsrel=1e-3, ncall=5e4, total_iters=10, adjust_iters=6, seed=2)
    for label, card_kw, cpu_kw in (
            ("poly hybrid", {}, {"sampler": "hybrid"}),
            ("poly fused", {"eval_dtype": torch.float32},
             {"eval_dtype": torch.float32, "sampler": "fused"}),
            ("grid", {"importance": "grid"}, {"importance": "grid"})):
        on_card = mcubes.integrate(g3, **kw, **card_kw)
        on_cpu = mcubes.integrate(g3, device="cpu", **kw, **cpu_kw)
        print(f"phase 6: 3D f4 {label} card vs cpu: {on_card.estimate!r} vs "
              f"{on_cpu.estimate!r}, iters {on_card.iters}/{on_cpu.iters}, "
              f"neval {on_card.neval}/{on_cpu.neval}", flush=True)
        if ((on_card.status, on_card.iters, on_card.neval)
                != (on_cpu.status, on_cpu.iters, on_cpu.neval)
                or not math.isclose(on_card.estimate, on_cpu.estimate,
                                    rel_tol=1e-6)):
            fail(f"3D {label} run on the card differs from the CPU's")
    return {"run1": l1, "run2": l2, "run3": l3}, walls, {"run1": r1,
                                                          "run3": r3}


def vegas_times(dev, err, launches, walls):
    """Phase 7; returns the VEGAS entries of the ``kernels`` line."""
    g4 = genz.f4_gaussian(VEGAS_NDIM)
    ndim, nbins = VEGAS_NDIM, 500
    case = vegas_check.sampler_case(ndim, 1e8, VEGAS_CHUNK,
                                    position="middle", device=dev)
    pmap, npg = case["pmap"], case["npg"]
    n = case["chunk_cubes"] * npg
    tail = (case["xjac"], case["cube0"], case["ncubes"], 0, 1)

    def sample(fn, integrand, with_hist):
        return lambda: fn(pmap, integrand, case["ng"], npg,
                          case["chunk_cubes"], nbins, with_hist, *tail,
                          emit_points=integrand is None)

    entries = []
    sampler_ms = {}
    for label, integrand, with_hist in (
            ("emit+hist (run 1, adjusting)", None, True),
            ("emit (run 1, frozen)", None, False),
            ("fused F4+hist (run 2, adjusting)", g4, True),
            ("fused F4 (run 2, frozen)", g4, False)):
        def routed(route):
            return lambda: cuda_vegas.sample_chunk(
                pmap, integrand, case["ng"], npg, case["chunk_cubes"], nbins,
                with_hist, *tail, emit_points=integrand is None, route=route)

        # paired, generic, generic, paired: the two within one call
        t = [queued_ms(routed(r), 5)
             for r in ("paired", "generic", "generic", "paired")]
        ms, generic = min(t[0], t[3]), min(t[1], t[2])
        single = time_ms(routed("paired"), 5)
        plain = time_ms(sample(cuda_vegas.sample_chunk_plain, integrand,
                               with_hist), 2)
        b, by = sampler_bound_ms(0 if integrand is None else 4, ndim,
                                 pmap.kp, pmap.kq, n, with_hist)
        sampler_ms[label] = (ms, plain, b, by, generic)
        print(f"phase 7: sampler {label}, {n} samples: paired route "
              f"{ms:.4f} ms = {n / ms * 1e3:.4e} samples/s (two series "
              f"{t[0]:.4f}, {t[3]:.4f}), generic route {generic:.4f} ms "
              f"({t[1]:.4f}, {t[2]:.4f}), plain {plain:.2f} ms, bound "
              f"{b:.4f} ms ({by}, {100 * b / ms:.1f}% of it); one launch "
              f"between two events, the host's time to launch included: "
              f"{single:.4f} ms", flush=True)
    ms, plain, b, by, generic = sampler_ms["emit+hist (run 1, adjusting)"]
    entries.append({
        "name": "vegas_sample", "route": "cuda",
        "source": "gpuintegration_torch/csrc/vegas_sample.cu",
        "replaces": "gpuintegration_tpu/mcubes/pallas_vegas.py:192",
        "launches": launches["run1"]["vegas_sample"],
        "launches_by_run": {r: c["vegas_sample"] for r, c in launches.items()},
        "max_abs_err": err["vegas_sample"], "ms": ms, "plain_ms": plain,
        "bound_ms": b, "bound_by": by, "library_ms": None,
        "generic_route_ms": generic,
        "modes_ms": {k: v[0] for k, v in sampler_ms.items()},
        "modes_generic_route_ms": {k: v[4] for k, v in sampler_ms.items()}})

    def both_routes(routed, first):
        """(first route's ms, generic route's ms, the four series): the two
        routes in turns, first, generic, generic, first, in this call."""
        t = [queued_ms(routed(r), 5)
             for r in (first, "generic", "generic", first)]
        return min(t[0], t[3]), min(t[1], t[2]), t

    # the histogram as the main path calls it: accumulating, on the ids and
    # f^2 the fused sampler emits (run 2), and on 1-based ids with f^2 in
    # f64 (runs 1 and 3 have f64 values; run 3 1-based ids)
    _, ia, f2 = cuda_vegas.sample_chunk(
        pmap, g4, case["ng"], npg, case["chunk_cubes"], nbins, True, *tail)
    ia1, f2_64 = ia + 1, f2.double()
    acc = torch.zeros((ndim, nbins), dtype=torch.float32, device=dev)
    hist_ms = {}
    for form, ids, vals, base in (("fused", ia, f2, 0),
                                  ("grid", ia1, f2_64, 1)):
        ms, generic, t = both_routes(
            lambda route: lambda: cuda_lookup.hist_accum(
                acc, ids, vals, nbins, base=base, route=route), "grouped")
        plain = time_ms(lambda: cuda_lookup.hist_accum_plain(
            acc, ids, vals, nbins, base=base), 2)
        ids64 = (ids - base).to(torch.int64)
        vals32 = vals.to(torch.float32)
        lib = queued_ms(lambda: torch.clamp(acc + torch.stack([
            torch.bincount(ids64[d], weights=vals32, minlength=nbins)
            for d in range(ndim)]), max=cuda_lookup.HIST_CAP), 5)
        b = bytes_bound_ms(n * (4 * ndim + vals.element_size())
                           + 2 * 4 * ndim * nbins)
        hist_ms[form] = (ms, generic, plain, lib, b)
        warps, clusters = cuda_lookup.hist_plan(n, ndim, nbins)
        print(f"phase 7: histogram accumulating, {form} form ({n} samples, "
              f"ids {base}-based, f2 {vals.dtype}): grouped route {ms:.4f} "
              f"ms (two series {t[0]:.4f}, {t[3]:.4f}), generic route "
              f"{generic:.4f} ms ({t[1]:.4f}, {t[2]:.4f}; its kernel, the sum "
              f"over blocks, the add and the clamp{', ids - 1 and f2 to f32' if base else ''}), "
              f"plain {plain:.3f} ms, torch.bincount per dimension + add + "
              f"clamp {lib:.4f} ms, bound {b:.4f} ms (bytes, "
              f"{100 * b / ms:.1f}% of it; generic {100 * b / generic:.1f}%); "
              f"grouped launch: {clusters} clusters of "
              f"{cuda_lookup.HIST_CLUSTER} blocks of {warps} warps",
              flush=True)
    # what a grouped launch costs whatever its size: zeroing the rows, the
    # reductions over warps, blocks and clusters
    small_ids, small_vals = ia[:, :4096].contiguous(), f2[:4096].contiguous()
    small = queued_ms(lambda: cuda_lookup.hist_accum(acc, small_ids,
                                                     small_vals, nbins), 5)
    print(f"phase 7: histogram accumulating, grouped route on 4096 samples "
          f"(a launch's cost whatever its size): {small:.4f} ms", flush=True)
    ms, generic, plain, lib, b = hist_ms["fused"]
    entries.append({
        "name": "vegas_hist", "route": "cuda",
        "source": "gpuintegration_torch/csrc/vegas_lookup.cu",
        "replaces": "gpuintegration_tpu/mcubes/pallas_lookup.py:223",
        "launches": launches["run1"]["vegas_hist"],
        "launches_by_run": {r: c["vegas_hist"] for r, c in launches.items()},
        "max_abs_err": err["vegas_hist"], "ms": ms, "plain_ms": plain,
        "bound_ms": b, "bound_by": "bytes", "library_ms": lib,
        "generic_route_ms": generic,
        "grid_form_ms": hist_ms["grid"][0],
        "grid_form_generic_route_ms": hist_ms["grid"][1],
        "launch_of_4096_samples_ms": small})

    # the bin resolve as run 3 launches it: xn drawn in the kernel, ids out;
    # and given xn
    xi32 = torch.as_tensor(vegas_check.random_grid(ndim, nbins, 0),
                           dtype=torch.float32, device=dev)
    rargs = (xi32, nbins, case["ng"], npg, case["chunk_cubes"],
             case["cube0"], case["ncubes"], 0, 1)
    ms, generic, t = both_routes(
        lambda route: lambda: cuda_lookup.bin_resolve_stratified(
            *rargs, with_ia=True, route=route), "sample")
    plain = time_ms(lambda: cuda_lookup.bin_resolve_stratified_plain(
        *rargs, with_ia=True), 2)
    xn, _ = cuda_lookup.stratified_xn_plain(
        ndim, case["ng"], npg, nbins, case["chunk_cubes"], case["cube0"],
        case["ncubes"], 0, 1, dev)
    xn = xn.contiguous()
    given, given_generic, tg = both_routes(
        lambda route: lambda: cuda_lookup.bin_resolve(
            xi32, xn, nbins, with_ia=True, route=route), "sample")
    idx = torch.clamp(xn.to(torch.int64), 1, nbins)
    idx_lo = idx - 1
    lib = queued_ms(lambda: (torch.gather(xi32, 1, idx_lo),
                             torch.gather(xi32, 1, idx)), 5)
    resolve_ms = ms
    edges = 4 * ndim * (nbins + 1)
    b = bytes_bound_ms(n * ndim * 12 + edges)
    b_given = bytes_bound_ms(n * ndim * 16 + edges)
    print(f"phase 7: bin resolve drawing xn, {n} samples x {ndim}: sample "
          f"route {ms:.4f} ms (two series {t[0]:.4f}, {t[3]:.4f}), generic "
          f"route {generic:.4f} ms ({t[1]:.4f}, {t[2]:.4f}), plain "
          f"{plain:.2f} ms, bound {b:.4f} ms (bytes, {100 * b / ms:.1f}% of "
          f"it; generic {100 * b / generic:.1f}%); given xn: sample route "
          f"{given:.4f} ms ({tg[0]:.4f}, {tg[3]:.4f}), generic route "
          f"{given_generic:.4f} ms ({tg[1]:.4f}, {tg[2]:.4f}), bound "
          f"{b_given:.4f} ms ({100 * b_given / given:.1f}%), two "
          f"torch.gather (the edges alone, no rc, xo or ia) {lib:.4f} ms",
          flush=True)
    entries.append({
        "name": "vegas_bin_resolve", "route": "cuda",
        "source": "gpuintegration_torch/csrc/vegas_lookup.cu",
        "replaces": "gpuintegration_tpu/mcubes/pallas_lookup.py:152",
        "launches": launches["run3"]["vegas_bin_resolve"],
        "launches_by_run": {r: c["vegas_bin_resolve"]
                            for r, c in launches.items()},
        "max_abs_err": err["vegas_bin_resolve"], "ms": ms, "plain_ms": plain,
        "bound_ms": b, "bound_by": "bytes", "library_ms": None,
        "generic_route_ms": generic,
        "given_xn_ms": given, "given_xn_generic_route_ms": given_generic,
        "given_xn_library_ms_edges_only": lib})

    # the edge lookup, both routes in turns, on the chunk's stratified ids
    # and on uniformly random ones (more bank conflicts in the pair table)
    ids = idx.T.reshape(case["chunk_cubes"], npg, ndim).to(
        torch.int32).contiguous()
    rand_ids = vegas_check.edge_ids(case["chunk_cubes"], npg, ndim, nbins,
                                    device=dev)
    edge = {}
    for label, e_ids in (("stratified", ids), ("random", rand_ids)):
        edge[label] = both_routes(
            lambda route: lambda: cuda_lookup.edge_lookup(
                xi32, e_ids, nbins, route=route), "vector")
    ms, generic, t = edge["stratified"]
    plain = time_ms(lambda: cuda_lookup.edge_lookup_plain(xi32, ids, nbins),
                    2)
    b = bytes_bound_ms(n * ndim * 12 + edges)
    r_ms, r_generic, rt = edge["random"]
    print(f"phase 7: edge lookup, {n} samples x {ndim}, stratified ids: "
          f"vector route {ms:.4f} ms (two series {t[0]:.4f}, {t[3]:.4f}), "
          f"generic route {generic:.4f} ms ({t[1]:.4f}, {t[2]:.4f}); "
          f"uniformly random ids: vector {r_ms:.4f} ms ({rt[0]:.4f}, "
          f"{rt[3]:.4f}), generic {r_generic:.4f} ms ({rt[1]:.4f}, "
          f"{rt[2]:.4f}); plain {plain:.3f} ms, two torch.gather {lib:.4f} "
          f"ms, bound {b:.4f} ms (bytes; vector {100 * b / ms:.1f}% of it, "
          f"{100 * b / r_ms:.1f}% on random ids; generic "
          f"{100 * b / generic:.1f}%)", flush=True)
    entries.append({
        "name": "vegas_edge_lookup", "route": "cuda",
        "source": "gpuintegration_torch/csrc/vegas_lookup.cu",
        "replaces": "gpuintegration_tpu/mcubes/pallas_lookup.py:86",
        "launches": None,     # set by the diff path's run (phase 8)
        "max_abs_err": err["vegas_edge_lookup"], "ms": ms, "plain_ms": plain,
        "bound_ms": b, "bound_by": "bytes", "library_ms": lib,
        "generic_route_ms": generic, "random_ids_ms": r_ms,
        "random_ids_generic_route_ms": r_generic})

    # what the card was busy with in each run: launches times the time of a
    # kernel alone, against the run's wall
    adj = {"run1": (sampler_ms["emit+hist (run 1, adjusting)"][0],
                    sampler_ms["emit (run 1, frozen)"][0], "grid"),
           "run2": (sampler_ms["fused F4+hist (run 2, adjusting)"][0],
                    sampler_ms["fused F4 (run 2, frozen)"][0], "fused"),
           "run3": (resolve_ms, resolve_ms, "grid")}
    for run, (with_hist_ms, bare_ms, form) in adj.items():
        c = launches[run]
        first = c["vegas_sample"] + c["vegas_bin_resolve"]
        busy = (c["vegas_hist"] * (with_hist_ms + hist_ms[form][0])
                + (first - c["vegas_hist"]) * bare_ms) / 1e3
        print(f"phase 7: {run}: its kernels alone would take {busy:.4f} s "
              f"({first} + {c['vegas_hist']} launches at the times above) of "
              f"the {walls[run]:.3f} s wall = {100 * busy / walls[run]:.1f}%",
              flush=True)
    return entries


# The shapes at which phase 7 times the sampler's routes redesigned for 1D,
# 2D and 9..16D, (ndim, cubes) at ncall 1e9: about 2^21 samples (phase 7's
# chunk) and, where it differs, the chunk a run at ncall 1e9 takes (12D:
# 2^18 cubes of 4 samples; 16D: 2^15 of 23)
NEW_ROUTE_TIMES = [(1, 1 << 20), (2, 1 << 20), (9, 1 << 20), (12, 1 << 19),
                   (12, 1 << 18), (16, 91181), (16, 1 << 15)]


def new_route_times(dev):
    """Phase 7 (2): the sampler's paired route at 1D and 2D and wide route
    at 9..16D, and the grouped histogram at 9..16D, each in turns with the
    generic route (new, generic, generic, new; best of 5 series), its
    plain version, its bound and, for the histogram, torch.bincount per
    dimension with the add and the clamp.  Returns {'sampler': rows,
    'hist': rows}."""
    out = {"sampler": [], "hist": []}
    nbins = 500
    for ndim, cubes in NEW_ROUTE_TIMES:
        case = vegas_check.sampler_case(ndim, 1e9, cubes, position="middle",
                                        device=dev)
        pmap, npg = case["pmap"], case["npg"]
        n = case["chunk_cubes"] * npg
        tail = (case["xjac"], case["cube0"], case["ncubes"], 0, 1)
        route = "paired" if ndim <= 2 else "wide"
        g4 = genz.f4_gaussian(ndim)
        for label, integrand, with_hist in (
                ("emit+ids", None, True), ("emit", None, False),
                ("fused F4+ids+f2", g4, True), ("fused F4", g4, False)):
            lanes = (cuda_vegas.wide_lanes(case["chunk_cubes"], npg,
                                           integrand is None and with_hist)
                     if route == "wide" else 1)
            def call(fn, **kw):
                return lambda: fn(pmap, integrand, case["ng"], npg,
                                  case["chunk_cubes"], nbins, with_hist,
                                  *tail, emit_points=integrand is None, **kw)

            t = [queued_ms(call(cuda_vegas.sample_chunk, route=r), 5)
                 for r in (route, "generic", "generic", route)]
            ms, generic = min(t[0], t[3]), min(t[1], t[2])
            plain = (time_ms(call(cuda_vegas.sample_chunk_plain), 1)
                     if with_hist else None)
            b, by = sampler_bound_ms(0 if integrand is None else 4, ndim,
                                     pmap.kp, pmap.kq, n, with_hist)
            out["sampler"].append({
                "ndim": ndim, "cubes": case["chunk_cubes"], "npg": npg,
                "samples": n, "mode": label, "route": route, "lanes": lanes,
                "ms": ms, "generic_route_ms": generic, "series": t,
                "plain_ms": plain, "bound_ms": b, "bound_by": by,
                "library_ms": None})
            print(f"phase 7: sampler {label} {ndim}D, {case['chunk_cubes']} "
                  f"cubes of {npg} ({n} samples): {route} route {ms:.4f} ms "
                  f"(two series {t[0]:.4f}, {t[3]:.4f}; lanes {lanes}), "
                  f"generic route {generic:.4f} ms ({t[1]:.4f}, {t[2]:.4f}; "
                  f"{generic / ms:.2f} times), plain "
                  + (f"{plain:.2f} ms" if plain is not None else "not timed")
                  + f", bound {b:.4f} ms ({by}; {100 * b / ms:.1f}% of it, "
                  f"generic {100 * b / generic:.1f}%)", flush=True)
        if ndim < 9 or cubes not in (1 << 20, 1 << 19, 91181):
            continue
        # the histogram on that chunk's ids and f^2: f2 in f32 (the fused
        # sampler's) and in f64 (the 'hybrid' run's), ids 0-based
        _, ia, f2 = cuda_vegas.sample_chunk(
            pmap, g4, case["ng"], npg, case["chunk_cubes"], nbins, True,
            *tail)
        acc = torch.zeros((ndim, nbins), dtype=torch.float32, device=dev)
        ids64 = ia.to(torch.int64)
        for form, vals in (("f2 f32", f2), ("f2 f64", f2.double())):
            t = [queued_ms(lambda r=r: cuda_lookup.hist_accum(
                acc, ia, vals, nbins, route=r), 5)
                 for r in ("grouped", "generic", "generic", "grouped")]
            ms, generic = min(t[0], t[3]), min(t[1], t[2])
            plain = time_ms(lambda: cuda_lookup.hist_accum_plain(
                acc, ia, vals, nbins), 1)
            vals32 = vals.to(torch.float32)
            lib = queued_ms(lambda: torch.clamp(acc + torch.stack([
                torch.bincount(ids64[d], weights=vals32, minlength=nbins)
                for d in range(ndim)]), max=cuda_lookup.HIST_CAP), 5)
            b = bytes_bound_ms(n * (4 * ndim + vals.element_size())
                               + 2 * 4 * ndim * nbins)
            warps, clusters = cuda_lookup.hist_plan(n, ndim, nbins)
            out["hist"].append({
                "ndim": ndim, "samples": n, "form": form, "ms": ms,
                "generic_route_ms": generic, "series": t, "plain_ms": plain,
                "library_ms": lib, "bound_ms": b, "bound_by": "bytes",
                "warps": warps, "clusters": clusters})
            print(f"phase 7: histogram accumulating {ndim}D, {n} samples, "
                  f"{form}: grouped route {ms:.4f} ms (two series "
                  f"{t[0]:.4f}, {t[3]:.4f}; {clusters} clusters of "
                  f"{cuda_lookup.HIST_CLUSTER} blocks of {warps} warps), "
                  f"generic route {generic:.4f} ms ({t[1]:.4f}, {t[2]:.4f}; "
                  f"{generic / ms:.2f} times), plain {plain:.3f} ms, "
                  f"torch.bincount per dimension + add + clamp {lib:.4f} ms, "
                  f"bound {b:.4f} ms (bytes; {100 * b / ms:.1f}% of it, "
                  f"generic {100 * b / generic:.1f}%)", flush=True)
        del ia, f2, ids64
    return out


# ---------------------------------------------------------------------------
# BASELINE's 9D VEGAS Gaussian (phase 27)

GAUSS9D = dict(epsrel=1e-3, ncall=1e9, sampler="hybrid")
# the forms in turns, for 9D F4: the routes the shapes take, and both
# kernels forced to their generic routes (one run each: a run takes 4-5 s,
# and on an H100 the forms' walls lay 15-20 % apart, a form's repeats within
# 4 %; PERF.md); the Gaussian runs on the routes the shapes take only
GAUSS9D_ORDER = ("new", "generic")
# a 9D Gaussian VEGAS finds on the same lattice (Genz F4 at a = 10: a
# peak of width 0.07 an axis, where gauss9d's is 0.005 of its axis)
F4_9D = dict(a=10.0)


class GenericSampling:
    """While entered, the sampler and the histogram take their generic
    routes (the first design's kernels, and around the histogram the first
    design's PyTorch steps) whatever the shape."""

    def __enter__(self):
        self.kept = (cuda_vegas.sampler_route, cuda_lookup.hist_route)
        cuda_vegas.sampler_route = lambda *a: "generic"
        cuda_lookup.hist_route = lambda *a: "generic"
        return self

    def __exit__(self, *exc):
        cuda_vegas.sampler_route, cuda_lookup.hist_route = self.kept
        return False


def nine_d_run(label, g, form, alone, **kw):
    """One 9D VEGAS run at GAUSS9D in ``form`` ('new' or 'generic'),
    timed; every sampler and histogram launch must take the form's routes.
    Returns its row (the kernels' share of the wall from ``alone``, each
    kernel's time alone at the run's shape)."""
    torch.cuda.synchronize()
    with LaunchCounts() as clock, (GenericSampling() if form == "generic"
                                   else contextlib.nullcontext()):
        t0 = time.perf_counter()
        res = mcubes.integrate(g, epsabs=1e-40, **GAUSS9D, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    pull = abs(res.estimate - g.true_value) / res.errorest
    sampler_ms, hist_ms = alone[form]
    busy = (clock.launches["vegas_sample"] * sampler_ms
            + clock.launches["vegas_hist"] * hist_ms) / 1e3
    print(f"phase 27: {label} ({form} routes): status {res.status} estimate "
          f"{res.estimate!r} errorest {res.errorest!r} truth "
          f"{g.true_value!r} pull {pull:.4g} chi_sq {res.chi_sq:.4f} iters "
          f"{res.iters} neval {res.neval} wall {wall:.3f} s samples/s "
          f"{res.neval / wall:.4e}; launches {clock.launches} (sampler by "
          f"route {clock.sampler_routes}, histogram {clock.hist_routes}); "
          f"the sampler and the histogram alone would take {busy:.4f} s = "
          f"{100 * busy / wall:.1f}% of the wall", flush=True)
    want_s, want_h = (("wide", "grouped") if form == "new"
                      else ("generic", "generic"))
    if (not (math.isfinite(res.estimate) and math.isfinite(res.errorest))
            or clock.launches["vegas_sample"] <= 0
            or clock.sampler_routes[want_s] != clock.launches["vegas_sample"]
            or clock.launches["vegas_hist"] <= 0
            or clock.hist_routes[want_h] != clock.launches["vegas_hist"]
            or clock.launches["vegas_bin_resolve"] != 0):
        fail(f"{label} ({form} routes): estimate {res.estimate}, errorest "
             f"{res.errorest}, launches {clock.launches}, sampler "
             f"{clock.sampler_routes}, histogram {clock.hist_routes}; all "
             f"should take the {want_s} and the {want_h} route")
    return {"label": label, "form": form, "status": res.status,
            "estimate": res.estimate, "errorest": res.errorest,
            "truth": g.true_value, "pull": pull, "iters": res.iters,
            "neval": res.neval, "wall_s": wall, "launches": clock.launches,
            "sampler_routes": clock.sampler_routes,
            "hist_routes": clock.hist_routes, "kernels_alone_s": busy,
            "kernels_share": busy / wall}


def gauss9d_path(dev, times):
    """Phase 27: ``mcubes.integrate`` of BASELINE.json's 9D Gaussian
    (``misc.gauss9d``: sigma 0.01 over [-1, 1]^9, truth erf(1/(0.01
    sqrt 2))^9) at epsrel 1e-3 and ncall 1e9, f64, 'hybrid', the poly map:
    370 chunks of 2^20 cubes an iteration, on the routes the shapes take
    (the sampler's wide route, the grouped histogram).  Whether it
    certifies, and how far it lies from the truth, is reported as found; it
    must give finite results.  Then Genz F4 at 9D (F4_9D) on the same
    lattice, on those routes and on both forced to their generic routes, in
    turns (GAUSS9D_ORDER): each must certify within 5 errorest of its
    closed form.  The kernels' share
    of a wall: launches times each kernel's time alone at the run's shape
    (phase 7: 9D, 2^20 cubes; the histogram on f^2 in f64).  Returns the
    rows."""
    alone = {}
    for form, key in (("new", "ms"), ("generic", "generic_route_ms")):
        row = next(r for r in times["sampler"] if r["ndim"] == 9
                   and r["mode"] == "emit+ids")
        hist = next(r for r in times["hist"] if r["ndim"] == 9
                    and r["form"] == "f2 f64")
        alone[form] = (row[key], hist[key])
    f, vol = misc.gauss9d()
    new = nine_d_run("9D Gaussian (BASELINE)", f, "new", alone, vol=vol)
    print(f"phase 27: 9D Gaussian (BASELINE): status {new['status']}, "
          f"{'certified' if new['status'] == 0 else 'not certified'} at "
          f"epsrel {GAUSS9D['epsrel']:g} after {new['iters']} iterations; "
          f"estimate {new['pull']:.4g} errorest from the truth; wall "
          f"{new['wall_s']:.3f} s", flush=True)
    rows = [new]
    g4 = genz.f4_gaussian(9, **F4_9D)
    for form in GAUSS9D_ORDER:
        r = nine_d_run(f"9D F4 a = {F4_9D['a']:g}", g4, form, alone)
        if r["status"] != 0 or not r["pull"] <= 5.0:
            fail(f"9D F4 ({form} routes): status {r['status']}, pull "
                 f"{r['pull']}")
        rows.append(r)
    return rows


# ---------------------------------------------------------------------------
# The bin resolve's wide route at 9..16D (phase 7) and BASELINE's 9D VEGAS
# on the grid map (phase 28)

def wide_resolve_times(dev, shapes=WIDE_RESOLVE_SHAPES, series=(5, 20)):
    """Phase 7 (3): the bin resolve's wide route against its generic route
    in turns (wide, generic, generic, wide; best of ``series`` (series,
    launches a series) back to back, ``queued_ms``) at ``shapes`` ((ndim,
    cubes[, ncall]); WIDE_RESOLVE_SHAPES), the chunk around the volume's
    centre of the ncall (1e9) lattice: drawing xn with ids out (as the grid map's
    adjusting iterations launch it) and without (its frozen ones), and
    given xn with ids out; each beside its bytes bound (rc, xo and ia
    written once, xn read once where given, the edges once), the plain
    version's time and two ``torch.gather`` of the edges (the edges alone,
    no rc, xo or ia).  Returns the rows."""
    rows = []
    nbins = 500
    for ndim, cubes, *rest in shapes:
        ncall = rest[0] if rest else 1e9
        ng, ncubes = vegas_module.compute_ncubes(ncall, ndim)
        npg = vegas_module.samples_per_cube(ncall, ncubes)
        cube0 = vegas_check._chunk_start(ng, ndim, ncubes, cubes, "middle")
        n = cubes * npg
        xi32 = torch.as_tensor(vegas_check.random_grid(ndim, nbins, 0),
                               dtype=torch.float32, device=dev)
        rargs = (xi32, nbins, ng, npg, cubes, cube0, ncubes, 0, 1)
        xn, _ = cuda_lookup.stratified_xn_plain(ndim, ng, npg, nbins, cubes,
                                                cube0, ncubes, 0, 1, dev)
        xn = xn.contiguous()
        forms = {
            "drawing xn, ids out": lambda route: lambda: (
                cuda_lookup.bin_resolve_stratified(*rargs, with_ia=True,
                                                   route=route)),
            "drawing xn, no ids": lambda route: lambda: (
                cuda_lookup.bin_resolve_stratified(*rargs, route=route)),
            "given xn, ids out": lambda route: lambda: cuda_lookup.bin_resolve(
                xi32, xn, nbins, with_ia=True, route=route)}
        edges = 4 * ndim * (nbins + 1)
        bounds = {"drawing xn, ids out": n * ndim * 12 + edges,
                  "drawing xn, no ids": n * ndim * 8 + edges,
                  "given xn, ids out": n * ndim * 16 + edges}
        row = {"ndim": ndim, "cubes": cubes, "npg": npg, "samples": n,
               "blocks_on_card": cuda_lookup._resident_blocks(
                   dev, "resolve wide drawing xn", ndim, nbins)}
        for form, routed in forms.items():
            t = [queued_ms(routed(r), *series)
                 for r in ("wide", "generic", "generic", "wide")]
            b = bytes_bound_ms(bounds[form])
            row[form] = {"ms": min(t[0], t[3]),
                         "generic_route_ms": min(t[1], t[2]), "series": t,
                         "bound_ms": b, "bound_by": "bytes"}
        row["plain_ms"] = time_ms(
            lambda: cuda_lookup.bin_resolve_stratified_plain(
                *rargs, with_ia=True), 1)
        row["given_xn_plain_ms"] = time_ms(
            lambda: cuda_lookup.bin_resolve_plain(xi32, xn, nbins,
                                                  with_ia=True), 1)
        idx = torch.clamp(xn.to(torch.int64), 1, nbins)
        idx_lo = idx - 1
        row["edges_only_two_gathers_ms"] = queued_ms(
            lambda: (torch.gather(xi32, 1, idx_lo),
                     torch.gather(xi32, 1, idx)), *series)
        del idx, idx_lo, xn
        rows.append(row)
        parts = "; ".join(
            f"{form}: wide route {v['ms']:.4f} ms (two series "
            f"{v['series'][0]:.4f}, {v['series'][3]:.4f}), generic route "
            f"{v['generic_route_ms']:.4f} ms ({v['series'][1]:.4f}, "
            f"{v['series'][2]:.4f}; {v['generic_route_ms'] / v['ms']:.2f} "
            f"times), bound {v['bound_ms']:.4f} ms (bytes; "
            f"{100 * v['bound_ms'] / v['ms']:.1f}% of it, generic "
            f"{100 * v['bound_ms'] / v['generic_route_ms']:.1f}%)"
            for form, v in row.items() if isinstance(v, dict))
        print(f"phase 7: bin resolve {ndim}D, {cubes} cubes of {npg} ({n} "
              f"samples), 500 bins, {row['blocks_on_card']} blocks: {parts}; "
              f"plain {row['plain_ms']:.2f} ms drawing, "
              f"{row['given_xn_plain_ms']:.2f} ms given xn; two torch.gather "
              f"(the edges alone) {row['edges_only_two_gathers_ms']:.4f} ms",
              flush=True)
    return rows


def wide_resolve_registers():
    """{kernel: (registers, spill bytes, stack frame bytes)} of the bin
    resolve's wide route's two instances, from nvcc's report (phase 1's
    build); fails where one spills."""
    log = cuda_build._target("vegas_lookup.cu").with_suffix(".log").read_text()
    got = {k: v for k, v in route_bits.ptxas_kernels(log).items()
           if k.startswith("resolve_wide_kernel")}
    if len(got) != 2 or any(spills or stack for _, spills, stack in
                            got.values()):
        fail(f"the wide bin resolve's instances: {got}; both should be "
             "built, with no spill and no stack frame")
    return got


# BASELINE's VEGAS configuration on the grid map (vegasT.cuh's): f64, the
# default sampler, ncall 1e9 at 1e-3; the forms in turns: the routes the
# shapes take, and the bin resolve alone forced to its generic route
GRID9D = dict(epsrel=1e-3, ncall=1e9, importance="grid")
GRID9D_ORDER = ("new", "generic")


class GenericResolve:
    """While entered, the bin resolve takes its generic route whatever the
    shape; the histogram keeps its own."""

    def __enter__(self):
        self.kept = cuda_lookup.resolve_route
        cuda_lookup.resolve_route = lambda *a: "generic"
        return self

    def __exit__(self, *exc):
        cuda_lookup.resolve_route = self.kept
        return False


def grid9d_run(label, g, form, alone, **kw):
    """One 9D grid-map run at GRID9D in ``form`` ('new' or 'generic'),
    timed; every bin-resolve launch must take the form's route ('wide' or
    'generic') and every histogram launch the grouped route, and the
    sampler must not launch.  Returns its row (the bin resolve's share of
    the wall: launches times ``alone[form]``, its time alone at the run's
    chunk drawing xn with ids out)."""
    torch.cuda.synchronize()
    with LaunchCounts() as clock, (GenericResolve() if form == "generic"
                                   else contextlib.nullcontext()):
        t0 = time.perf_counter()
        res = mcubes.integrate(g, epsabs=1e-40, **GRID9D, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    pull = abs(res.estimate - g.true_value) / res.errorest
    resolves = clock.launches["vegas_bin_resolve"]
    busy = resolves * alone[form] / 1e3
    want = "wide" if form == "new" else "generic"
    print(f"phase 28: {label} grid map ({form} form): status {res.status} "
          f"estimate {res.estimate!r} errorest {res.errorest!r} truth "
          f"{g.true_value!r} pull {pull:.4g} chi_sq {res.chi_sq:.4f} iters "
          f"{res.iters} neval {res.neval} wall {wall:.3f} s samples/s "
          f"{res.neval / wall:.4e}; launches {clock.launches} (bin resolve "
          f"by route {clock.resolve_routes}, histogram {clock.hist_routes}); "
          f"the bin resolve alone would take {busy:.4f} s = "
          f"{100 * busy / wall:.1f}% of the wall", flush=True)
    if (not (math.isfinite(res.estimate) and math.isfinite(res.errorest))
            or resolves <= 0 or clock.resolve_routes[want] != resolves
            or clock.launches["vegas_hist"] <= 0
            or clock.hist_routes["grouped"] != clock.launches["vegas_hist"]
            or clock.launches["vegas_sample"] != 0):
        fail(f"{label} grid map ({form} form): estimate {res.estimate}, "
             f"errorest {res.errorest}, launches {clock.launches}, bin "
             f"resolve {clock.resolve_routes}, histogram "
             f"{clock.hist_routes}; every bin resolve should take the {want} "
             f"route and every histogram the grouped one")
    return {"label": label, "form": form, "status": res.status,
            "estimate": res.estimate, "errorest": res.errorest,
            "truth": g.true_value, "pull": pull, "iters": res.iters,
            "neval": res.neval, "wall_s": wall, "launches": clock.launches,
            "resolve_routes": clock.resolve_routes,
            "hist_routes": clock.hist_routes, "resolve_alone_s": busy,
            "resolve_share": busy / wall}


def grid9d_path(dev, resolve_rows):
    """Phase 28: ``mcubes.integrate(..., importance='grid', ncall=1e9,
    epsrel=1e-3)`` in f64 at 9D (9^9 cubes of 2 samples, 370 chunks of
    2^20 cubes an iteration): Genz F4 (F4_9D) in turns on the wide bin
    resolve and on its generic route (GRID9D_ORDER), which must certify
    within 5 errorests of its closed form; the two routes compute every
    output alike, so the pair must give the same bits.  Then BASELINE's
    ``misc.gauss9d`` on the wide route, whose status is reported as found.
    Returns the rows."""
    row9 = next(r for r in resolve_rows if r["ndim"] == 9)
    drawn = row9["drawing xn, ids out"]
    alone = {"new": drawn["ms"], "generic": drawn["generic_route_ms"]}
    f, vol = misc.gauss9d()
    rows = []
    for label, g, kw, forms in (
            (f"9D F4 a = {F4_9D['a']:g}", genz.f4_gaussian(9, **F4_9D), {},
             GRID9D_ORDER),
            ("9D Gaussian (BASELINE)", f, {"vol": vol}, ("new",))):
        pair = [grid9d_run(label, g, form, alone, **kw) for form in forms]
        if len(pair) == 1:
            new = pair[0]
            print(f"phase 28: {label} grid map: wall {new['wall_s']:.3f} s; "
                  f"status {new['status']}, "
                  f"{'certified' if new['status'] == 0 else 'not certified'}"
                  f" at epsrel {GRID9D['epsrel']:g} after {new['iters']} "
                  f"iterations, {new['pull']:.4g} errorests from the truth",
                  flush=True)
            rows += pair
            continue
        new, gen = pair
        same = ((new["estimate"], new["errorest"], new["iters"])
                == (gen["estimate"], gen["errorest"], gen["iters"]))
        print(f"phase 28: {label} grid map: wide and generic bin resolve "
              f"{'the same bits' if same else 'NOT the same bits'}; walls "
              f"{new['wall_s']:.3f} s and {gen['wall_s']:.3f} s "
              f"({new['wall_s'] / gen['wall_s']:.3f} times); status "
              f"{new['status']}, "
              f"{'certified' if new['status'] == 0 else 'not certified'} at "
              f"epsrel {GRID9D['epsrel']:g} after {new['iters']} iterations, "
              f"{new['pull']:.4g} errorests from the truth", flush=True)
        if not same:
            fail(f"{label} grid map: the wide and the generic bin resolve "
                 "give other results; they compute every output alike")
        if g is not f and (new["status"] != 0 or not new["pull"] <= 5.0):
            fail(f"{label} grid map: status {new['status']}, pull "
                 f"{new['pull']}")
        rows += pair
    return rows


# ---------------------------------------------------------------------------
# VEGAS past 16D (phases 5, 7 and 29)

# (ndim, ncall) of the rows past 16D: the 1e9 lattices at 17..28D and 32D
# at 1e10 (2^32 cubes), each on the chunk vegas's own policy gives it in
# f64 (vegas.default_chunk_cubes): 17D 131072 cubes of 7, 20D 1024 of 953,
# 24D 8192 of 59, 28D 262144 of 3, 32D 262144 of 2
HIGH_ROWS = [(17, 1e9), (20, 1e9), (24, 1e9), (28, 1e9), (32, 1e10)]
HIGH_NBINS = 500
# the edge lookup on the diff path's draws (diff.frozen_draws): (ndim, ids
# a dimension)
HIGH_EDGE = ((20, 1 << 20), (32, 1 << 20))
# Genz F4 of the rows and of phase 29's runs: a = 5, b = 0.5
HIGH_F4 = dict(a=5.0, b=0.5)
# phase 29's runs: (label, ndim, F4's a, vegas keywords), epsrel 1e-3,
# ncall 1e9.  28D takes a = 3: at a = 5 a sample's share of the integral,
# fx ~ 2.4e-13 / 8e8, squares to ~1e-43, below f32's normal range, so the
# f32 f^2 histogram stops steering the map (15 iterations, no certificate,
# on an H100); at a = 3 fx^2 ~ 3e-32
HIGH_RUNS = (
    ("20D poly f64 'hybrid'", 20, 5.0, dict(sampler="hybrid")),
    ("20D poly f32 'fused'", 20, 5.0, dict(sampler="fused",
                                           eval_dtype=torch.float32)),
    ("20D grid f64", 20, 5.0, dict(importance="grid")),
    ("28D poly f64 'hybrid'", 28, 3.0, dict(sampler="hybrid")))
HIGH_EPSREL, HIGH_NCALL = 1e-3, 1e9
# the timed series of a kernel past 16D: the generic routes there take
# milliseconds a launch
HIGH_SERIES = (3, 10)


def gauss_axes(ndim: int, a: float):
    """exp(-a^2 sum (x_d - 1/2)^2) as a per-axis callable of ndim
    arguments: Genz F4's form, traced into the fused sampler."""
    names = [f"x{d}" for d in range(ndim)]
    body = " + ".join(f"({x} - 0.5) * ({x} - 0.5)" for x in names)
    return eval(f"lambda {', '.join(names)}: torch.exp(-{a * a!r} * ({body}))",
                {"torch": torch})


GEN_GAUSS20 = integrand_gen.traced(gauss_axes(20, HIGH_F4["a"]), 20,
                                   "gauss_axes20")


def high_case(ndim: int, ncall: float, position: str, dev):
    """sampler_case at the chunk vegas's policy gives a row in f64."""
    ng, ncubes = vegas_module.compute_ncubes(ncall, ndim)
    npg = vegas_module.samples_per_cube(ncall, ncubes)
    chunk = vegas_module.default_chunk_cubes(npg, ndim, torch.float64)
    return vegas_check.sampler_case(ndim, ncall, chunk, nbins=HIGH_NBINS,
                                    position=position, device=dev)


def high_dim_checks(dev):
    """Phase 5 (past 16D): at each row of HIGH_ROWS, on the chunk past the
    lattice's end, the sampler's wide route (NMAX 24 and 32) in emit mode
    and fused on Genz F4 against the plain version (kernel_check's limits)
    and the generic route (coordinates, weights, bin ids, f^2 EQUAL), the
    generator word for word on both routes; the grouped histogram against
    the plain version and the generic route on the row's sample count; the
    wide bin resolve against the generic route (rc, xo, ia EQUAL) and the
    plain version; the routes named at 17D and 33D, and the generic sampler
    at 33D (emit mode, the route above 32D) against the plain version and
    its words.  Returns the largest differences read, per kernel."""
    err = {"vegas_sample": 0.0, "vegas_hist": 0.0,
           "vegas_bin_resolve_wide": 0.0}
    for ndim, ncall in HIGH_ROWS:
        case = high_case(ndim, ncall, "end", dev)
        pmap, chunk, npg = case["pmap"], case["chunk_cubes"], case["npg"]
        n = chunk * npg
        routes = (cuda_vegas.sampler_route(ndim, pmap.kp, pmap.kq),
                  cuda_lookup.hist_route(ndim, HIGH_NBINS),
                  cuda_lookup.resolve_route(ndim, HIGH_NBINS, n))
        if routes != ("wide", "grouped", "wide"):
            fail(f"{ndim}D: routes {routes}; the wide sampler, the grouped "
                 "histogram and the wide bin resolve should take it")
        for integrand in (None, genz.f4_gaussian(ndim, **HIGH_F4)):
            witness = {"weight_witness": True} if integrand is None else {}
            try:
                r = vegas_check.check_sampler(case, integrand, with_hist=True,
                                              rng="device", route="wide",
                                              **witness)
                vegas_check.check_sampler(case, integrand, with_hist=True,
                                          rng="device", route="generic",
                                          **witness)
                rr = vegas_check.check_sampler_routes(
                    case, integrand, with_hist=True, rng="input")
            except AssertionError as e:
                fail(f"{ndim}D: {e}")
            readings = ", ".join(f"{k[:-5]} {v:.3g}" for k, v in r.items()
                                 if k.endswith("_ulps"))
            sums = (f"; sums {rr['sums_ulps']:.3g} f64 ulps apart"
                    if "sums_ulps" in rr else "")
            print(f"phase 5: wide route (NMAX "
                  f"{cuda_vegas.wide_class(ndim)}), {ndim}D ncall {ncall:g}, "
                  f"{chunk} cubes of {npg} (lanes "
                  f"{cuda_vegas.wide_lanes(chunk, npg, integrand is None)}), "
                  f"{'emit' if integrand is None else 'fused F4'}, the chunk "
                  f"past the lattice's end: {r['samples']} samples, bin ids "
                  f"equal; ulps against the plain version: {readings}; "
                  f"against the generic route coordinates, weights, bin ids "
                  f"and f^2 EQUAL{sums}", flush=True)
            err["vegas_sample"] = max(err["vegas_sample"],
                                      r.get("max_abs_x", 0.0))
        try:
            for route in ("wide", "generic"):
                vegas_check.check_stream(case, route=route)
            hr = vegas_check.check_hist_routes(ndim, n, HIGH_NBINS,
                                               device=dev)
            rr = vegas_check.check_resolve_routes(ndim, ncall, chunk,
                                                  HIGH_NBINS, device=dev)
        except AssertionError as e:
            fail(f"{ndim}D: {e}")
        if hr["routes"] != ["grouped", "generic"] or rr["routes"] != [
                "wide", "generic"]:
            fail(f"{ndim}D: histogram routes {hr['routes']}, bin resolve "
                 f"{rr['routes']}")
        print(f"phase 5: {ndim}D: the generator word for word on both "
              f"sampler routes; histogram, {n} samples, 500 bins: grouped "
              f"route max rel {hr['grouped']['max_rel']:.3g}, accumulating "
              f"{hr['grouped']['accum_max_rel']:.3g}; generic "
              f"{hr['generic']['max_rel']:.3g} (limit "
              f"{vegas_check.HIST_RTOL:g}); between the routes "
              f"{hr['between_routes_max_rel']:.3g}; each route twice the "
              f"same bits; {cuda_lookup.hist_plan(n, ndim, 500)[1]} clusters "
              f"of {cuda_lookup.hist_warps(ndim, 500)} warps, the card holds "
              f"{cuda_lookup.hist_clusters_on_card(ndim, 500)}; bin resolve "
              f"wide vs generic route, drawing xn at the centre and past the "
              f"lattice's end, given xn over {rr['samples']} and "
              f"{rr['samples'] - 3} samples: rc, xo, ia EQUAL; rc "
              f"{rr['rc_ulps']} ulps from the plain version (limit "
              f"{vegas_check.RC_ULP})", flush=True)
        err["vegas_hist"] = max(err["vegas_hist"], hr["grouped"]["max_abs"])
        err["vegas_bin_resolve_wide"] = max(err["vegas_bin_resolve_wide"],
                                            rr["max_abs"])
    # the routes at the edges of the range, and the generic sampler above it
    for ndim, want in ((17, ("wide", "grouped", "wide")),
                       (33, ("generic", "generic", "generic"))):
        ncall = 2.1 * 2 ** ndim                # ng 2, npg 2
        case = vegas_check.sampler_case(ndim, ncall, 4096, nbins=50,
                                        degree=8, device=dev)
        pmap = case["pmap"]
        got = (cuda_vegas.sampler_route(ndim, pmap.kp, pmap.kq),
               cuda_lookup.hist_route(ndim, 50),
               cuda_lookup.resolve_route(ndim, 50, 4096 * case["npg"]))
        if got != want:
            fail(f"{ndim}D routes {got}, not {want}")
        try:
            vegas_check.check_stream(case)
            r = vegas_check.check_sampler(case, None, with_hist=True,
                                          rng="device", weight_witness=True)
        except AssertionError as e:
            fail(f"{ndim}D: {e}")
        print(f"phase 5: {ndim}D routes {got}; the sampler's {got[0]} route "
              f"emitting {r['samples']} samples: the generator word for "
              f"word, " + ", ".join(f"{k[:-5]} {v:.3g}" for k, v in r.items()
                                    if k.endswith("_ulps"))
              + " ulps against the plain version", flush=True)
    try:
        vegas_check.check_sampler(case, genz.f4_gaussian(33), with_hist=False,
                                  rng="device")
        fail("the fused sampler took a 33D Genz family")
    except ValueError:
        pass
    return err


def high_sampler_rows(case, series=HIGH_SERIES):
    """Phase 7 (past 16D): the sampler on ``case``'s chunk in its four
    modes (emit with and without bin ids, fused Genz F4 with and without
    them), the wide route in turns with the generic one (wide, generic,
    generic, wide; best of ``series``), beside its plain version and its
    bound.  Prints and returns a row a mode."""
    reps, inner = series
    pmap, npg, chunk = case["pmap"], case["npg"], case["chunk_cubes"]
    ndim, n = pmap.ndim, chunk * npg
    tail = (case["xjac"], case["cube0"], case["ncubes"], 0, 1)
    g4 = genz.f4_gaussian(ndim, **HIGH_F4)
    rows = []
    for label, integrand, with_hist in (
            ("emit+ids", None, True), ("emit", None, False),
            ("fused F4+ids+f2", g4, True), ("fused F4", g4, False)):
        def call(fn, integrand=integrand, with_hist=with_hist, **kw):
            return lambda: fn(pmap, integrand, case["ng"], npg, chunk,
                              HIGH_NBINS, with_hist, *tail,
                              emit_points=integrand is None, **kw)
        t = [queued_ms(call(cuda_vegas.sample_chunk, route=r), reps,
                       inner)
             for r in ("wide", "generic", "generic", "wide")]
        ms, generic = min(t[0], t[3]), min(t[1], t[2])
        plain = (time_ms(call(cuda_vegas.sample_chunk_plain), 1)
                 if with_hist else None)
        b, by = sampler_bound_ms(0 if integrand is None else 4, ndim,
                                 pmap.kp, pmap.kq, n, with_hist)
        lanes = cuda_vegas.wide_lanes(chunk, npg,
                                      integrand is None and with_hist)
        rows.append({
            "ndim": ndim, "cubes": chunk, "npg": npg, "samples": n,
            "mode": label, "route": "wide",
            "nmax": cuda_vegas.wide_class(ndim), "lanes": lanes,
            "ms": ms, "generic_route_ms": generic, "series": t,
            "plain_ms": plain, "bound_ms": b, "bound_by": by,
            "library_ms": None,
            "ns_a_sample_dimension": 1e6 * ms / (n * ndim)})
        print(f"phase 7: sampler {label} {ndim}D (NMAX "
              f"{cuda_vegas.wide_class(ndim)}), {chunk} cubes of {npg} "
              f"({n} samples): wide route {ms:.4f} ms (two series "
              f"{t[0]:.4f}, {t[3]:.4f}; lanes {lanes}; "
              f"{1e6 * ms / (n * ndim):.4f} ns a sample and dimension), "
              f"generic route {generic:.4f} ms ({t[1]:.4f}, {t[2]:.4f}; "
              f"{generic / ms:.2f} times), plain "
              + (f"{plain:.2f} ms" if plain is not None else "not timed")
              + f", bound {b:.4f} ms ({by}; {100 * b / ms:.1f}% of it)",
              flush=True)
    return rows


def high_dim_times(dev):
    """Phase 7 (past 16D): at each row's chunk (around the volume's centre)
    the wide sampler in its four modes, the grouped histogram on the
    chunk's ids and f^2 in f32 and f64, and the wide bin resolve drawing xn
    with and without ids and given xn, each in turns with its generic
    route (new, generic, generic, new; best of HIGH_SERIES series), beside
    its plain version, its bound and the library call where one computes
    the function (bincount per dimension; two gathers); the edge lookup
    at 20D and 32D on the diff path's draws, EQUAL to its plain version on
    both routes and timed; a traced 20D per-axis callable in the fused
    sampler against its plain version, the generic route (EQUAL) and the
    Genz F4 wide kernel in turns.  Returns the rows by kernel."""
    reps, inner = HIGH_SERIES
    out = {"sampler": [], "hist": [], "resolve": [], "edge": []}
    for ndim, ncall in HIGH_ROWS:
        case = high_case(ndim, ncall, "middle", dev)
        pmap, npg, chunk = case["pmap"], case["npg"], case["chunk_cubes"]
        n = chunk * npg
        tail = (case["xjac"], case["cube0"], case["ncubes"], 0, 1)
        g4 = genz.f4_gaussian(ndim, **HIGH_F4)
        out["sampler"] += high_sampler_rows(case)
        # the histogram on the chunk's ids and f^2 (the fused sampler's)
        _, ia, f2 = cuda_vegas.sample_chunk(pmap, g4, case["ng"], npg, chunk,
                                            HIGH_NBINS, True, *tail)
        acc = torch.zeros((ndim, HIGH_NBINS), dtype=torch.float32, device=dev)
        ids64 = ia.to(torch.int64)
        for form, vals in (("f2 f32", f2), ("f2 f64", f2.double())):
            t = [queued_ms(lambda r=r: cuda_lookup.hist_accum(
                acc, ia, vals, HIGH_NBINS, route=r), reps, inner)
                 for r in ("grouped", "generic", "generic", "grouped")]
            ms, generic = min(t[0], t[3]), min(t[1], t[2])
            plain = time_ms(lambda: cuda_lookup.hist_accum_plain(
                acc, ia, vals, HIGH_NBINS), 1)
            vals32 = vals.to(torch.float32)
            lib = queued_ms(lambda: torch.clamp(acc + torch.stack([
                torch.bincount(ids64[d], weights=vals32,
                               minlength=HIGH_NBINS)
                for d in range(ndim)]), max=cuda_lookup.HIST_CAP), reps,
                inner)
            b = bytes_bound_ms(n * (4 * ndim + vals.element_size())
                               + 2 * 4 * ndim * HIGH_NBINS)
            warps, clusters = cuda_lookup.hist_plan(n, ndim, HIGH_NBINS)
            out["hist"].append({
                "ndim": ndim, "samples": n, "form": form, "ms": ms,
                "generic_route_ms": generic, "series": t, "plain_ms": plain,
                "library_ms": lib, "bound_ms": b, "bound_by": "bytes",
                "warps": warps, "clusters": clusters})
            print(f"phase 7: histogram accumulating {ndim}D, {n} samples, "
                  f"{form}: grouped route {ms:.4f} ms (two series "
                  f"{t[0]:.4f}, {t[3]:.4f}; {clusters} clusters of "
                  f"{cuda_lookup.HIST_CLUSTER} blocks of {warps} warps), "
                  f"generic route {generic:.4f} ms ({t[1]:.4f}, {t[2]:.4f}; "
                  f"{generic / ms:.2f} times), plain {plain:.3f} ms, "
                  f"torch.bincount per dimension + add + clamp {lib:.4f} ms, "
                  f"bound {b:.4f} ms (bytes; {100 * b / ms:.1f}% of it)",
                  flush=True)
        del ia, f2, ids64
        out["resolve"] += wide_resolve_times(dev, [(ndim, chunk, ncall)],
                                             series=HIGH_SERIES)
    for ndim, n in HIGH_EDGE:
        xi32 = torch.as_tensor(vegas_check.random_grid(ndim, HIGH_NBINS, 1),
                               dtype=torch.float32, device=dev)
        ia, _ = diff.frozen_draws(DIFF_SEED, n, ndim, HIGH_NBINS, dev)
        want = cuda_lookup.edge_lookup_plain(xi32, ia, HIGH_NBINS)
        for r in ("vector", "generic"):
            got = cuda_lookup.edge_lookup(xi32, ia, HIGH_NBINS, route=r)
            if not all(torch.equal(a, w) for a, w in zip(got, want)):
                fail(f"edge lookup {ndim}D, {r} route, on the diff path's "
                     "draws differs from the plain version")
        del got, want
        t = [queued_ms(lambda r=r: cuda_lookup.edge_lookup(
            xi32, ia, HIGH_NBINS, route=r), reps, inner)
             for r in ("vector", "generic", "generic", "vector")]
        ms, generic = min(t[0], t[3]), min(t[1], t[2])
        plain = time_ms(lambda: cuda_lookup.edge_lookup_plain(
            xi32, ia, HIGH_NBINS), 1)
        idx = torch.clamp(ia.to(torch.int64), 1, HIGH_NBINS).T.contiguous()
        idx_lo = idx - 1
        lib = queued_ms(lambda: (torch.gather(xi32, 1, idx_lo),
                                 torch.gather(xi32, 1, idx)), reps, inner)
        b = bytes_bound_ms(ia.numel() * 12 + 4 * ndim * (HIGH_NBINS + 1))
        out["edge"].append({
            "ndim": ndim, "samples": n, "ids": ia.numel(), "ms": ms,
            "generic_route_ms": generic, "series": t, "plain_ms": plain,
            "library_ms": lib, "bound_ms": b, "bound_by": "bytes",
            "route": cuda_lookup.edge_route(ndim, HIGH_NBINS)})
        print(f"phase 7: edge lookup {ndim}D on the diff path's draws "
              f"({ia.numel()} ids): vector and generic routes EQUAL to the "
              f"plain version; vector {ms:.4f} ms ({t[0]:.4f}, {t[3]:.4f}), "
              f"generic {generic:.4f} ms ({t[1]:.4f}, {t[2]:.4f}), plain "
              f"{plain:.3f} ms, two torch.gather {lib:.4f} ms, bound "
              f"{b:.4f} ms (bytes; {100 * b / ms:.1f}% of it)", flush=True)
        del ia, idx, idx_lo
    out["generated"] = generated_high(dev)
    return out


def generated_high(dev):
    """Phase 7 (past 16D): GEN_GAUSS20 (built in phase 1) in the fused
    sampler at the 20D row's chunk: against its plain version (kernel_check's
    limits), its generic route (EQUAL), and timed against the Genz F4 wide
    kernel in turns (F4, generated, generated, F4)."""
    reps, inner = HIGH_SERIES
    case = high_case(20, 1e9, "middle", dev)
    pmap, npg, chunk = case["pmap"], case["npg"], case["chunk_cubes"]
    n = chunk * npg
    try:
        r = vegas_check.check_sampler(case, GEN_GAUSS20, with_hist=True,
                                      rng="device")
        vegas_check.check_sampler_routes(case, GEN_GAUSS20, with_hist=True,
                                         rng="input")
    except AssertionError as e:
        fail(f"generated 20D sampler: {e}")
    tail = (case["xjac"], case["cube0"], case["ncubes"], 0, 1)

    def call(fn, g, **kw):
        return lambda: fn(pmap, g, case["ng"], npg, chunk, HIGH_NBINS, True,
                          *tail, **kw)
    k = call(cuda_vegas.sample_chunk, GEN_GAUSS20)()
    p = call(cuda_vegas.sample_chunk_plain, GEN_GAUSS20)()
    g4 = genz.f4_gaussian(20, **HIGH_F4)
    t = [queued_ms(call(cuda_vegas.sample_chunk, g, route="wide"), reps,
                   inner) for g in (g4, GEN_GAUSS20, GEN_GAUSS20, g4)]
    ms, genz_ms = min(t[1], t[2]), min(t[0], t[3])
    generic = queued_ms(call(cuda_vegas.sample_chunk, GEN_GAUSS20,
                             route="generic"), reps, inner)
    plain = time_ms(call(cuda_vegas.sample_chunk_plain, GEN_GAUSS20), 1)
    b, by = generated_sampler_bound_ms(GEN_GAUSS20.program, 20, pmap.kp,
                                       pmap.kq, n, True)
    row = {"ndim": 20, "cubes": chunk, "npg": npg, "samples": n, "ms": ms,
           "genz_f4_wide_ms": genz_ms, "series": t,
           "generic_route_ms": generic, "plain_ms": plain, "bound_ms": b,
           "bound_by": by, "library_ms": None,
           "max_abs_err": float((k[0] - p[0]).abs().max()),
           "ulps_against_plain": {kk: v for kk, v in r.items()
                                  if kk.endswith("_ulps")}}
    print(f"phase 7: generated sampler gauss_axes20 fused+ids+f2, {n} "
          f"samples: against the plain version "
          + ", ".join(f"{kk[:-5]} {v:.3g}" for kk, v in
                      row["ulps_against_plain"].items())
          + f" ulps; against the generic route coordinates, bin ids and f^2 "
          f"EQUAL; generated wide kernel {ms:.4f} ms ({t[1]:.4f}, "
          f"{t[2]:.4f}) against the Genz F4 wide kernel {genz_ms:.4f} ms "
          f"({t[0]:.4f}, {t[3]:.4f}); generated generic route "
          f"{generic:.4f} ms; plain {plain:.2f} ms; bound {b:.4f} ms ({by}, "
          f"{100 * b / ms:.1f}% of it)", flush=True)
    return row


def _pull(res, truth: float) -> float:
    """|estimate - truth| in errorests (inf at a zero errorest)."""
    err = abs(res.estimate - truth)
    return err / res.errorest if res.errorest > 0 else math.inf


def high_dim_run(label, ndim, a, kw, times):
    """One phase 29 run: Genz F4 (b = 0.5, ``a``) at ``ndim``, epsrel HIGH_EPSREL,
    ncall HIGH_NCALL, f64 unless ``kw`` says otherwise; the counts set to
    0 just before it and read just after.  It must certify within 5
    errorests of the closed form with every launch on the wide sampler,
    the grouped histogram and (grid map) the wide bin resolve.  Returns
    its row: wall, iterations, launches by route, and each kernel's
    launches times its time alone (phase 7, the row's chunk) against the
    wall."""
    g = genz.f4_gaussian(ndim, a=a, b=HIGH_F4["b"])
    torch.cuda.synchronize()
    with LaunchCounts() as clock:
        t0 = time.perf_counter()
        res = mcubes.integrate(g, epsrel=HIGH_EPSREL, epsabs=1e-40,
                               ncall=HIGH_NCALL, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    pull = _pull(res, g.true_value)
    grid = kw.get("importance") == "grid"
    fused = kw.get("sampler") == "fused"

    def alone(kernel, key):
        return next(r for r in times[kernel]
                    if r["ndim"] == ndim and key(r))
    c = clock.launches
    hist_ms = alone("hist", lambda r: r["form"] == (
        "f2 f32" if fused else "f2 f64"))["ms"]
    busy = {"vegas_hist": c["vegas_hist"] * hist_ms}
    if grid:
        rr = alone("resolve", lambda r: True)
        busy["vegas_bin_resolve"] = (
            c["vegas_hist"] * rr["drawing xn, ids out"]["ms"]
            + (c["vegas_bin_resolve"] - c["vegas_hist"])
            * rr["drawing xn, no ids"]["ms"])
    else:
        modes = (("fused F4+ids+f2", "fused F4") if fused
                 else ("emit+ids", "emit"))
        with_ids, bare = (alone("sampler", lambda r, m=m: r["mode"] == m)
                          ["ms"] for m in modes)
        busy["vegas_sample"] = (c["vegas_hist"] * with_ids
                                + (c["vegas_sample"] - c["vegas_hist"])
                                * bare)
    busy = {k: v / 1e3 for k, v in busy.items()}
    share = sum(busy.values()) / wall
    print(f"phase 29: {label}, Genz F4 a = {a:g}: status "
          f"{res.status} estimate {res.estimate!r} errorest "
          f"{res.errorest!r} truth {g.true_value!r} pull {pull:.4g} chi_sq "
          f"{res.chi_sq:.4f} iters {res.iters} neval {res.neval} wall "
          f"{wall:.3f} s samples/s {res.neval / wall:.4e}; launches "
          f"{clock.launches} (sampler by route {clock.sampler_routes}, "
          f"histogram {clock.hist_routes}, bin resolve "
          f"{clock.resolve_routes}); the kernels alone (launches x their "
          f"times in phase 7) "
          + ", ".join(f"{k} {v:.4f} s" for k, v in busy.items())
          + f" = {100 * share:.1f}% of the wall", flush=True)
    first = "vegas_bin_resolve" if grid else "vegas_sample"
    routes = clock.resolve_routes if grid else clock.sampler_routes
    if (res.status != 0 or not pull <= 5.0 or c[first] <= 0
            or routes["wide"] != c[first] or c["vegas_hist"] <= 0
            or clock.hist_routes["grouped"] != c["vegas_hist"]
            or c["vegas_sample" if grid else "vegas_bin_resolve"] != 0):
        fail(f"phase 29: {label}: status {res.status}, pull {pull}, launches "
             f"{c}, sampler {clock.sampler_routes}, histogram "
             f"{clock.hist_routes}, bin resolve {clock.resolve_routes}")
    return {"label": label, "ndim": ndim, "a": a, "status": res.status,
            "estimate": res.estimate, "errorest": res.errorest,
            "truth": g.true_value, "pull": pull, "iters": res.iters,
            "neval": res.neval, "wall_s": wall, "launches": c,
            "sampler_routes": clock.sampler_routes,
            "hist_routes": clock.hist_routes,
            "resolve_routes": clock.resolve_routes, "kernels_alone_s": busy,
            "kernels_share": share}


def high_dim_path(dev, times):
    """Phase 29: VEGAS past 16D on the card.  ``vegas(f, ndim=17)`` with
    the card's defaults (the poly map, 'hybrid', f64) at ncall 1e7, then
    HIGH_RUNS: Genz F4 at 20D (a = 5) on the poly map ('hybrid' f64,
    'fused' f32) and on the grid map, and at 28D (a = 3) on the poly map
    (the NMAX 32 instance in situ), each certified within 5 errorests.
    Returns the rows."""
    g17 = genz.f4_gaussian(17, **HIGH_F4)
    with LaunchCounts() as clock:
        t0 = time.perf_counter()
        r17 = mcubes.integrate(g17, epsrel=1e-2, epsabs=1e-40, ncall=1e7)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    pull = _pull(r17, g17.true_value)
    print(f"phase 29: vegas(f4_gaussian(17), ncall=1e7) with the card's "
          f"defaults: status {r17.status} estimate {r17.estimate!r} "
          f"errorest {r17.errorest!r} pull {pull:.4g} iters {r17.iters} wall "
          f"{wall:.3f} s; launches {clock.launches}, sampler by route "
          f"{clock.sampler_routes}", flush=True)
    if (not math.isfinite(r17.estimate) or clock.launches["vegas_sample"] <= 0
            or clock.sampler_routes["wide"]
            != clock.launches["vegas_sample"]):
        fail(f"phase 29: the 17D default run: {r17}, {clock.launches}")
    return [high_dim_run(label, ndim, a, kw, times)
            for label, ndim, a, kw in HIGH_RUNS]


# ---------------------------------------------------------------------------
# The diff path (phase 8)

DIFF_NDIM = 6
DIFF_A = 25.0            # gauss at a = 25 is Genz F4 at a = 5
DIFF_SEED = 7
DIFF_NCALL = 1 << 24


def gauss(x, a):
    """exp(-a sum((x - 1/2)^2)) on the unit cube."""
    return torch.exp(-a * torch.sum((x - 0.5) ** 2, dim=-1))


def gauss_truth(a: float, ndim: int) -> tuple[float, float]:
    """(I(a), dI/da) in closed form: I = c^ndim with
    c = sqrt(pi/a) erf(sqrt(a)/2), and dc/da = (exp(-a/4) - c) / (2a)."""
    c = math.sqrt(math.pi / a) * math.erf(math.sqrt(a) / 2.0)
    dc = (math.exp(-a / 4.0) - c) / (2 * a)
    return c ** ndim, ndim * c ** (ndim - 1) * dc


def timed(fn):
    """(fn's result, seconds of host clock until the card is done)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def diff_path(dev):
    """Phase 8: ``gpuintegration_torch.diff`` at full width on the card.
    Returns the edge lookup's launches and launches by route on the frozen
    estimate's run, its largest difference from the plain version on the
    path's ids, and its fields for the ``kernels`` line."""
    ndim, a0 = DIFF_NDIM, DIFF_A
    truth, dtruth = gauss_truth(a0, ndim)
    t_phase = time.perf_counter()

    # train the grid: VEGAS adjustment, the sampler in emit mode and the
    # histogram (no kernel twin for a callable: the 'hybrid' sampler)
    with LaunchCounts() as clock:
        xi, train_s = timed(lambda: diff.train_grid(
            gauss, ndim, theta=a0, ncall=1e7, adjust_iters=10))
    if (clock.launches["vegas_sample"] == 0 or clock.launches["vegas_hist"]
            == 0 or clock.sampler_routes["paired"]
            != clock.launches["vegas_sample"]
            or clock.hist_routes["grouped"] != clock.launches["vegas_hist"]):
        fail(f"train_grid: launches {clock.launches}, sampler by route "
             f"{clock.sampler_routes}, histogram {clock.hist_routes}; the "
             "sampler should take the paired route, the histogram the "
             "grouped one")
    print(f"phase 8: train_grid {ndim}D a={a0:g} ncall 1e7, 10 adjusting "
          f"iterations: {train_s:.3f} s, launches {clock.launches}",
          flush=True)

    est_fn = diff.frozen_grid_estimate(gauss, xi, ndim, ncall=DIFF_NCALL)
    a = torch.tensor(a0, dtype=torch.float64, device=dev)
    h = 1e-4
    thetas = torch.tensor([20.0, 25.0, 30.0, 35.0], dtype=torch.float64,
                          device=dev)
    # the first torch.func.grad of a process imports torch._dynamo and more:
    # taken once on a scalar, before anything is timed
    _, import_s = timed(lambda: torch.func.grad(lambda t: t * t)(a))
    cuda_lookup.reset_launches()
    t_path = time.perf_counter()
    (est, err), fwd_s = timed(lambda: est_fn(a, DIFF_SEED))
    counted = cuda_lookup.edge_route_launches["vector"]
    g, grad_s = timed(lambda: torch.func.grad(
        lambda t: est_fn(t, DIFF_SEED)[0])(a))
    in_grad = cuda_lookup.edge_route_launches["vector"] - counted
    fd = (float(est_fn(a + h, DIFF_SEED)[0])
          - float(est_fn(a - h, DIFF_SEED)[0])) / (2 * h)
    (scan, scan_err), scan_s = timed(lambda: torch.func.vmap(
        lambda t: est_fn(t, DIFF_SEED))(thetas))
    loop = [est_fn(t, DIFF_SEED) for t in thetas]
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t_path
    launches = cuda_lookup.edge_lookup_launches
    by_route = dict(cuda_lookup.edge_route_launches)
    est, err, g = float(est), float(err), float(g)
    pull = (est - truth) / err
    scan_rel = max(max(abs(float(scan[i]) / float(e) - 1),
                       abs(float(scan_err[i]) / float(r) - 1))
                   for i, (e, r) in enumerate(loop))
    print(f"phase 8: frozen_grid_estimate, {DIFF_NCALL} samples x {ndim}: "
          f"estimate {est!r} errorest {err!r} truth {truth!r} pull "
          f"{pull:.3f}; forward {fwd_s:.4f} s, torch.func.grad (forward and "
          f"backward) {grad_s:.4f} s (the first grad of the process, its "
          f"imports, took {import_s:.3f} s before): {g!r} against dI/da "
          f"{dtruth!r} "
          f"(rel {abs(g / dtruth - 1):.3e}, limit 0.05) and the common-"
          f"random-number central difference (h {h:g}) {fd!r} (rel "
          f"{abs(g / fd - 1):.3e}, limit 1e-5); vmap over {len(loop)} "
          f"thetas {scan_s:.4f} s, against the loop max rel {scan_rel:.3e} "
          f"(limit 1e-12); edge lookups {launches} (by route {by_route}), "
          f"{in_grad} inside torch.func.grad", flush=True)
    if abs(pull) > 5:
        fail(f"frozen estimate {est} is {pull:.2f} errorests from {truth}")
    if not abs(g / dtruth - 1) <= 0.05 or not abs(g / fd - 1) <= 1e-5:
        fail(f"frozen gradient {g}: dI/da {dtruth}, difference {fd}")
    if not scan_rel <= 1e-12:
        fail(f"vmap scan differs from the loop by {scan_rel}")
    if in_grad < 1 or by_route["vector"] != launches or launches < 1:
        fail(f"the edge lookup on the diff path: {launches} launches by "
             f"route {by_route}, {in_grad} inside torch.func.grad; all "
             "should take the vector route, one inside grad at least")

    # the draws alone, which the forward makes before the lookup: the same
    # seed, so the ids the path looked up; on them both routes EQUAL to the
    # plain version (launches after the counts were read, so uncounted),
    # then both alone in turns
    (ia, _), draws_s = timed(lambda: diff.frozen_draws(
        DIFF_SEED, DIFF_NCALL, ndim, xi.shape[1] - 1, dev))
    xi32 = xi.to(torch.float32).contiguous()
    nbins = xi.shape[1] - 1
    want = cuda_lookup.edge_lookup_plain(xi32, ia, nbins)
    path_err = 0.0
    for r in ("vector", "generic"):
        got = cuda_lookup.edge_lookup(xi32, ia, nbins, route=r)
        equal = all(torch.equal(g_, w_) for g_, w_ in zip(got, want))
        d = max(float((g_ - w_).abs().max()) for g_, w_ in zip(got, want))
        path_err = max(path_err, d)
        print(f"phase 8: edge lookup {r} route on the path's {ia.numel()} "
              f"ids against the plain version: "
              f"{'EQUAL' if equal else 'DIFFERENT'} (max abs {d!r})",
              flush=True)
        if not equal:
            fail(f"edge lookup, {r} route, on the diff path's ids differs "
                 f"from the plain version by up to {d!r}")
    del want, got
    t = [queued_ms(lambda r=r: cuda_lookup.edge_lookup(xi32, ia, nbins,
                                                       route=r), 3, 5)
         for r in ("vector", "generic", "generic", "vector")]
    ms, generic = min(t[0], t[3]), min(t[1], t[2])
    b = bytes_bound_ms(ia.numel() * 12 + 4 * ndim * (nbins + 1))
    print(f"phase 8: the draws alone (Philox4x32-10 in plain PyTorch, "
          f"diff.frozen_draws): {draws_s:.4f} s of the {fwd_s:.4f} s forward",
          flush=True)
    print(f"phase 8: edge lookup at this shape ({ia.numel()} ids): vector "
          f"route {ms:.4f} ms ({t[0]:.4f}, {t[3]:.4f}), generic "
          f"{generic:.4f} ms ({t[1]:.4f}, {t[2]:.4f}), bound {b:.4f} ms "
          f"(bytes, {100 * b / ms:.1f}% of it); its {launches} launches "
          f"{launches * ms / 1e3:.4f} s of the estimate's {path_s:.3f} s "
          f"(forward, gradient, difference, scan, loop) = "
          f"{100 * launches * ms / 1e3 / path_s:.2f}%", flush=True)
    del ia

    # the fixed mesh: 6 partitions a dimension, the plain rule
    fm = diff.fixed_mesh_integral(gauss, ndim, partitions_per_axis=6)
    (m_est, m_err), m_s = timed(lambda: fm(a))
    m_g, m_grad_s = timed(lambda: torch.func.grad(lambda t: fm(t)[0])(a))
    m_est, m_err, m_g = float(m_est), float(m_err), float(m_g)
    m_rel, m_grel = abs(m_est / truth - 1), abs(m_g / dtruth - 1)
    print(f"phase 8: fixed_mesh_integral {ndim}D, 6 partitions "
          f"({6 ** ndim} regions x {rule_eval.rule_tables(ndim).feval} "
          f"points): estimate {m_est!r} errorest {m_err!r} (rel "
          f"{m_rel:.3e}, limit 1e-9), {m_s:.4f} s; gradient {m_g!r} (rel "
          f"{m_grel:.3e}, limit 1e-7), {m_grad_s:.4f} s", flush=True)
    if not (m_rel <= 1e-9 and m_grel <= 1e-7 and math.isfinite(m_err)):
        fail(f"fixed mesh: estimate {m_est} against {truth}, gradient {m_g} "
             f"against {dtruth}")

    # the checkpoint pipeline (tests/test_diff.py's): tolerances out of
    # reach, so that the checkpoint is a complete partition
    ws = Workspace(3, chunk_size=1024)
    ws.integrate(genz.f4_gaussian(3, a=5.0), epsrel=1e-12, epsabs=1e-200,
                 max_iterations=6, **HOST)
    regions = diff.mesh_from_checkpoint(ws.make_checkpoint())
    fm3 = diff.fixed_mesh_integral(gauss, 3, regions=regions)
    c_est, c_err = (float(v) for v in fm3(a))
    c_g = float(torch.func.grad(lambda t: fm3(t)[0])(a))
    truth3, _ = gauss_truth(a0, 3)
    print(f"phase 8: checkpoint pipeline, 3D F4 a=5, 6 iterations -> "
          f"{regions[0].shape[0]} regions -> fixed_mesh_integral at a=25: "
          f"{c_est!r} errorest {c_err!r} truth {truth3!r}, gradient {c_g!r}",
          flush=True)
    if (abs(c_est - truth3) > max(3 * c_err, 1e-5 * truth3)
            or not math.isfinite(c_g)):
        fail(f"checkpoint mesh: {c_est} against {truth3}, gradient {c_g}")
    phase_s = time.perf_counter() - t_phase
    print(f"phase 8: the edge lookup's {launches} launches x {ms:.4f} ms = "
          f"{launches * ms / 1e3:.4f} s of this phase's {phase_s:.3f} s "
          f"({100 * launches * ms / 1e3 / phase_s:.3f}%; the first grad's "
          f"imports {import_s:.3f} s of it)", flush=True)
    return launches, by_route, path_err, {
        "diff_path_ms": ms, "diff_path_generic_route_ms": generic,
        "diff_path_bound_ms": b, "diff_path_max_abs_err": path_err}


# ---------------------------------------------------------------------------
# The rule's split route (phases 9-11) and the continuation (phase 12)

SPLIT_CHUNK = 4096        # Workspace(8)'s chunk in f64: 256 MB of points
SIN_SUM_EPSREL = 1e-11    # sin_sum(8) certifies there in 12 iterations


def f4_plain(x):
    """Genz F4 at 8D (a = 25, b = 1/2) as a plain batched callable: the
    expression of ``genz.f4_gaussian(8)`` without its family id, so it
    takes the split route."""
    return torch.exp(-torch.sum((25.0 * 25.0) * (x - 0.5) ** 2, dim=-1))


def f4_axes(x0, x1, x2, x3, x4, x5, x6, x7):
    """The same integrand in the scalar-per-axis form."""
    s = 0.0
    for u in (x0, x1, x2, x3, x4, x5, x6, x7):
        s = s + 625.0 * (u - 0.5) ** 2
    return torch.exp(-s)


def axes_callable(ndim):
    """cos(x_1 + ... + x_n) as a per-axis callable of n arguments: its
    values come back as planes (strides (1, C))."""
    names = ", ".join(f"x{d}" for d in range(ndim))
    return eval(f"lambda {names}: torch.cos({names.replace(', ', ' + ')})",
                {"torch": torch})


def sin_axes(ndim):
    """sin(x_1 + ... + x_n) as a per-axis callable of n arguments (the
    per-axis form of ``misc.sin_sum``)."""
    names = ", ".join(f"x{d}" for d in range(ndim))
    return eval(f"lambda {names}: torch.sin({names.replace(', ', ' + ')})",
                {"torch": torch})


def compare_split(label, *args, route, **kw):
    """kernel_check.check_split_against_plain with the contraction on
    ``route``, printed on one line; a disagreement, a split_dim that is not
    EQUAL in every region, or a launch on another route fails the run."""
    cuda_rule.reset_launches()
    try:
        r = kernel_check.check_split_against_plain(*args, route=route, **kw)
    except AssertionError as e:
        fail(str(e))
    launched = dict(cuda_rule.contract_route_launches)
    print(f"{label}, contraction {route}: {r['regions']} regions, points "
          f"EQUAL (bits and strides), values EQUAL; max|d est| "
          f"{r['max_abs_est']:.3e}; beyond rtol, in ulps of the roundoff "
          f"scale (limits {kernel_check.ULPS['est']:g}/"
          f"{kernel_check.ULPS['err']:g}): est {r['est_ulps']:.3g}, err "
          f"{r['err_ulps']:.3g} ({r['err_ulps_without_gate_ties']:.3g} "
          f"before {r['gate_ties']} gate ties); split_dim EQUAL in "
          f"{r['split_dim_equal']} of {r['regions']}; launches {launched}",
          flush=True)
    if r["split_dim_equal"] != r["regions"]:
        fail(f"{label}: split_dim differs from the plain version's")
    if not launched[route] or sum(launched.values()) != launched[route]:
        fail(f"{label}: contraction launches {launched}, all should be "
             f"{route}")
    return r


def direct_values(ndim, count, dtype, layout, dev, seed=6):
    """Values (count, feval) of a chunk made directly, on the grid k/8 in
    [0.5, 1.5): every partial sum of an orbit (at most 65,536 values) is
    exact in f32 and f64, so the orbit sums are the same in any order and
    both routes are held to the plain version's epilogue alone.  Laid out
    as 'rows' (strides (feval, 1): a callable that reduces over the axes),
    'planes' ((1, count): a per-axis callable) or 'strided' (every other
    element of a wider tensor: neither stride 1)."""
    feval = rule_eval.rule_tables(ndim).feval
    g = torch.Generator(device=dev).manual_seed(seed)
    v = torch.randint(4, 12, (count, feval), generator=g, device=dev).to(
        dtype) / 8
    if layout == "planes":
        return v.T.contiguous().T
    if layout == "strided":
        wide = torch.zeros((count, 2 * feval), dtype=dtype, device=dev)
        wide[:, ::2] = v
        return wide[:, ::2]
    return v


def contract_check(label, ndim, count, dtype, layout, dev):
    """The contraction alone on values made directly (``direct_values``),
    both routes against rule_eval.rule_outputs: est/err by kernel_check's
    limits (rounding scales from |values|: no coordinates are rounded; the
    orbit sums are exact), split_dim EQUAL; two launches of each route the same bits; the route
    that contract_route names is the one the wrapper takes.  Returns the
    largest |d est| and the chosen route."""
    tables = rule_eval.rule_tables(ndim, rule_eval.dtype_name(dtype))
    lows, lengths = random_pool(ndim, count, 7, dtype, dev)
    gl = torch.zeros(ndim, dtype=dtype, device=dev)
    gr = torch.full((ndim,), 1.25, dtype=dtype, device=dev)
    vals = direct_values(ndim, count, dtype, layout, dev)
    chosen = cuda_rule.contract_route(dtype, ndim, count, tables.feval,
                                      vals.stride())
    plain = rule_eval.rule_outputs(vals, tables, lengths, gr)
    routes = ("cluster", "generic") if chosen == "cluster" else ("generic",)
    worst = 0.0
    for route in routes:
        cuda_rule.reset_launches()
        a, b = (cuda_rule.split_contract(vals, tables, lows, lengths, gl, gr,
                                         0, route=route) for _ in range(2))
        torch.cuda.synchronize()
        same = all(torch.equal(x.view(torch.uint8), y.view(torch.uint8))
                   for x, y in zip(a, b))
        try:
            r = kernel_check.judge(kernel_check.region_readings(
                a, plain, vals, vals.abs(), tables, lengths, gr),
                name=label, dtype=dtype)
        except AssertionError as e:
            fail(str(e))
        equal = int((a[2] == plain[2]).sum())
        print(f"phase 9: {label} ({count} x {tables.feval}, {layout} "
              f"strides {tuple(vals.stride())}), contraction {route}: est "
              f"{r['est_ulps']:.3g}, err {r['err_ulps']:.3g} ulps beyond "
              f"rtol (limits 1/1); split_dim EQUAL in {equal} of {count}; "
              f"two launches the same bits: {same}; launches "
              f"{dict(cuda_rule.contract_route_launches)}", flush=True)
        if not same or equal != count or \
                cuda_rule.contract_route_launches[route] != 2:
            fail(f"{label}: contraction {route} disagrees")
        worst = max(worst, r["max_abs_est"])
    return worst, chosen


def split_checks(dev):
    """Phase 9: the split route against its plain version, its contraction
    on both routes.  Returns the largest |d est| read on each route."""
    cap = 1 << 16
    n = cap - (cap >> 3)           # blocked pool with padding slots
    worst = {r: 0.0 for r in cuda_rule.CONTRACT_ROUTES}
    for dtype in (torch.float64, torch.float32):
        tables = rule_eval.rule_tables(NDIM, rule_eval.dtype_name(dtype))
        lows, lengths = random_pool(NDIM, cap, 1, dtype, dev)
        gl = torch.zeros(NDIM, dtype=dtype, device=dev)
        gr = torch.ones(NDIM, dtype=dtype, device=dev)
        for label, f in (("sin_sum", misc.sin_sum(NDIM)),
                         ("g_function", misc.g_function(NDIM)),
                         ("F4 as a batched callable", f4_plain),
                         ("F4 as a per-axis callable", f4_axes)):
            for route in cuda_rule.CONTRACT_ROUTES:
                r = compare_split(f"phase 9: {NDIM}D {label} "
                                  f"{str(dtype)[6:]}", f, tables, lows,
                                  lengths, gl, gr, n=n, blocked=True,
                                  chunk_size=SPLIT_CHUNK, route=route)
                worst[route] = max(worst[route], r["max_abs_est"])
    # other dimensions, in their volumes: the 9D Gaussian, the 2D ridge;
    # 12D at its Workspace chunk (1024 regions), 16D on 256-region chunks
    # (a 1024-region chunk's points are 9.4 GB in f64, and the check holds
    # the plain version's and their gradients beside them)
    cases = [(g.name, g.ndim, g, vol, small_cap, SPLIT_CHUNK,
              (torch.float64,))
             for (g, vol), small_cap in ((misc.gauss9d(), 1 << 12),
                                         (misc.diagonal_ridge_2d(), 1 << 14))]
    for ndim, small_cap, chunk in ((12, 1 << 12, 1024), (16, 1 << 10, 256)):
        vol = Volume(lows=[0.0] * ndim, highs=[1.0] * ndim)
        for name, g in (("sin_sum", misc.sin_sum(ndim)),
                        ("cos_sum per axis", axes_callable(ndim))):
            cases.append((name, ndim, g, vol, small_cap, chunk,
                          (torch.float64, torch.float32)))
    for name, ndim, g, vol, small_cap, chunk, dtypes in cases:
        for dtype in dtypes:
            tables = rule_eval.rule_tables(ndim, rule_eval.dtype_name(dtype))
            lows, lengths = random_pool(ndim, small_cap, 3, dtype, dev)
            gl = torch.as_tensor(vol.lows, dtype=dtype, device=dev)
            gr = torch.as_tensor(np.asarray(vol.highs) - np.asarray(vol.lows),
                                 dtype=dtype, device=dev)
            for route in cuda_rule.CONTRACT_ROUTES:
                r = compare_split(f"phase 9: {ndim}D {name} "
                                  f"{str(dtype)[6:]} chunk {chunk}", g,
                                  tables, lows, lengths, gl, gr,
                                  n=small_cap - (small_cap >> 3),
                                  blocked=True, chunk_size=chunk, route=route)
                worst[route] = max(worst[route], r["max_abs_est"])
            del lows, lengths
            torch.cuda.empty_cache()

    # the contraction alone at 16D's Workspace chunk, on values made
    # directly; a ragged (odd) count; values of neither layout
    for label, ndim, count, dtype, layout in (
            ("16D f64", 16, 1024, torch.float64, "rows"),
            ("16D f64", 16, 1024, torch.float64, "planes"),
            ("16D f32", 16, 1024, torch.float32, "rows"),
            ("12D f64 odd count", 12, 1023, torch.float64, "rows"),
            ("12D f32 odd count", 12, 1021, torch.float32, "planes"),
            ("12D f64 strided", 12, 1024, torch.float64, "strided")):
        d, chosen = contract_check(label, ndim, count, dtype, layout, dev)
        want = "generic" if layout == "strided" else "cluster"
        if chosen != want:
            fail(f"{label}: contract_route names {chosen}, not {want}")
        worst[chosen] = max(worst[chosen], d)
        torch.cuda.empty_cache()

    # a NaN region takes the widest axis, as in the plain version
    tables = rule_eval.rule_tables(NDIM, "float64")
    lows, lengths = random_pool(NDIM, 256, 4, torch.float64, dev)
    gl = torch.zeros(NDIM, dtype=torch.float64, device=dev)
    gr = torch.ones(NDIM, dtype=torch.float64, device=dev)
    lows[2, 7] = float("nan")
    g = misc.sin_sum(NDIM)
    k = cuda_rule.cuda_apply_rule_split(g, tables, lows, lengths, gl, gr)
    p = rule_eval.apply_rule_plain(g, tables, lows, lengths, gl, gr)
    widest = int(torch.argmax(lengths[:, 7]))
    print(f"phase 9: NaN region: est {float(k[0][7])} (plain "
          f"{float(p[0][7])}), split_dim {int(k[2][7])} (plain "
          f"{int(p[2][7])}, widest axis {widest}); split_dim EQUAL in "
          f"{int((k[2] == p[2]).sum())} of 256", flush=True)
    if not (math.isnan(float(k[0][7])) and int(k[2][7]) == widest
            == int(p[2][7]) and torch.equal(k[2], p[2])):
        fail("the split route's NaN region does not take the widest axis")

    # cos(sum x): the split route against Genz F1 (unit coefficients) on
    # the tile route, the same rule to rounding
    lows, lengths = random_pool(NDIM, cap, 1, torch.float64, dev)
    split = cuda_rule.cuda_apply_rule_split(
        misc.oscillatory(NDIM), tables, lows, lengths, gl, gr, n=n,
        blocked=True, chunk_size=SPLIT_CHUNK)
    tile = cuda_rule.cuda_apply_rule(
        genz.f1_oscillatory(NDIM, np.ones(NDIM)), tables, lows, lengths, gl,
        gr, n=n, blocked=True)
    top = float(tile[0].abs().max())
    d_est = float((split[0] - tile[0]).abs().max()) / top
    d_err = float((split[1] - tile[1]).abs().max()) / top
    sd = int((split[2] == tile[2]).sum())
    print(f"phase 9: oscillatory(8) on the split route vs f1_oscillatory(8, "
          f"ones) on the tile route, {n} regions: max|d est| {d_est:.3g}, "
          f"max|d err| {d_err:.3g} of the largest |est| (limit 1e-12); "
          f"split_dim EQUAL in {sd}", flush=True)
    if not (d_est <= 1e-12 and d_err <= 1e-12):
        fail(f"oscillatory: split and tile routes differ by {d_est}, {d_err}")
    return worst


def column_matrix(tables):
    """The TPU kernel's (P, 6 + 2n) contraction matrix: the five rule
    weights, the centre, the single-axis pairs of orbits 1 and 2."""
    ndim, feval = tables.ndim, tables.feval
    m = np.zeros((feval, 6 + 2 * ndim))
    m[:, :5] = tables.wts[:feval, :5]
    m[0, 5] = 1.0
    for d in range(ndim):
        m[1 + 2 * d:3 + 2 * d, 6 + d] = 1.0
        m[1 + 2 * ndim + 2 * d:3 + 2 * ndim + 2 * d, 6 + ndim + d] = 1.0
    return m


def flushed_ms(fn, reps: int = 5, inner: int = 10) -> float:
    """Time of one call of ``fn`` with L2 emptied before it: a write of 128
    MB (more than the 50 MB L2) before each call, CUDA events around the
    call alone, the calls queued behind a blocker; the best of reps x
    inner calls."""
    if not _blocker:
        _blocker.append(torch.zeros((6144, 6144), device="cuda"))
    junk = torch.empty(1 << 27, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    best = math.inf
    for _ in range(reps):
        events = []
        torch.mm(_blocker[0], _blocker[0])
        for _ in range(inner):
            junk.fill_(1)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            events.append((start, end))
        torch.cuda.synchronize()
        best = min(best, min(s.elapsed_time(e) for s, e in events))
    return best


# The contraction's timed shapes: the Workspace's chunks (8D f64 4096
# regions, 12D and 16D 1024, 8D f32 8192), values as the callables return
# them: rows (a reduction over the axes; the split main path's), planes (a
# per-axis callable) at 8D, 12D and 16D f64.
CONTRACT_SHAPES = ((8, 4096, torch.float64, "rows"),
                   (8, 4096, torch.float64, "planes"),
                   (12, 1024, torch.float64, "rows"),
                   (12, 1024, torch.float64, "planes"),
                   (16, 1024, torch.float64, "rows"),
                   (16, 1024, torch.float64, "planes"),
                   (8, 8192, torch.float32, "rows"))


def contract_times(dev):
    """Both contraction routes at CONTRACT_SHAPES, in turns (cluster,
    generic, generic, cluster), best of 5 series back to back
    (``queued_ms``), beside the bytes bound, the plain rule_outputs and
    torch.matmul against the column matrix (the rule sums only, TF32 off);
    at the 8D f64 chunk, whose 36.6 MB fit in L2, also each route with L2
    flushed before each launch.  Returns one dict a shape."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = []
    for ndim, c, dtype, layout in CONTRACT_SHAPES:
        tables = rule_eval.rule_tables(ndim, rule_eval.dtype_name(dtype))
        lows, lengths = random_pool(ndim, c, 5, dtype, dev)
        gl = torch.zeros(ndim, dtype=dtype, device=dev)
        gr = torch.ones(ndim, dtype=dtype, device=dev)
        args = (tables, lows, lengths, gl, gr)
        vals = direct_values(ndim, c, dtype, layout, dev)
        out = cuda_rule.split_contract(vals, *args, 0)

        def routed(route):
            return lambda: cuda_rule.split_contract(vals, *args, 0, out=out,
                                                    route=route)

        t = [queued_ms(routed(r), 5) for r in
             ("cluster", "generic", "generic", "cluster")]
        item = torch.finfo(dtype).bits // 8
        nbytes = c * tables.feval * item + ndim * c * item + c * (2 * item + 4)
        mt = torch.as_tensor(column_matrix(tables), dtype=dtype, device=dev)
        k = cuda_rule.cluster_plan(dtype, ndim, c, tables.feval)[0]
        row = {"ndim": ndim, "count": c, "feval": tables.feval,
               "dtype": str(dtype)[6:], "layout": layout,
               "cluster": k, "ctas": -(-c // 32) * k,
               "co_resident_clusters": cuda_rule.cluster_occupancy(
                   dtype, layout == "rows", ndim, c, tables.feval),
               "cluster_ms": min(t[0], t[3]), "generic_ms": min(t[1], t[2]),
               "series_ms": t, "bytes": nbytes,
               "bound_ms": bytes_bound_ms(nbytes),
               "plain_ms": time_ms(lambda: rule_eval.rule_outputs(
                   vals, tables, lengths, gr), 3),
               "sums_only_matmul_ms": queued_ms(lambda: torch.matmul(vals, mt),
                                                5),
               "torch_sum_ms": queued_ms(lambda: vals.sum(), 5),
               "named": cuda_rule.contract_route(dtype, ndim, c, tables.feval,
                                                 vals.stride())}
        if (ndim, c, dtype, layout) == CONTRACT_SHAPES[0]:
            row["cluster_l2_flushed_ms"] = flushed_ms(routed("cluster"))
            row["generic_l2_flushed_ms"] = flushed_ms(routed("generic"))
        flushed = (f"; with L2 flushed: cluster "
                   f"{row['cluster_l2_flushed_ms']:.4f} ms, generic "
                   f"{row['generic_l2_flushed_ms']:.4f} ms"
                   if "cluster_l2_flushed_ms" in row else "")
        print(f"phase 10: contraction, {ndim}D {row['dtype']} {c} regions x "
              f"{tables.feval} points ({layout}, {nbytes / 1e6:.1f} MB; "
              f"clusters of {k}, {row['ctas']} CTAs, "
              f"{row['co_resident_clusters']} clusters co-resident): cluster "
              f"{row['cluster_ms']:.4f} ms "
              f"({100 * row['bound_ms'] / row['cluster_ms']:.1f}% of the "
              f"bound), generic {row['generic_ms']:.4f} ms "
              f"({100 * row['bound_ms'] / row['generic_ms']:.1f}%), series "
              f"{', '.join(f'{x:.4f}' for x in t)}; bound "
              f"{row['bound_ms']:.4f} ms (bytes); plain rule_outputs "
              f"{row['plain_ms']:.4f} ms; the sums alone by torch.matmul "
              f"against the ({tables.feval}, {6 + 2 * ndim}) column matrix "
              f"{row['sums_only_matmul_ms']:.4f} ms; torch.sum of the "
              f"values (the same bytes read) {row['torch_sum_ms']:.4f} ms; "
              f"contract_route names {row['named']}{flushed}", flush=True)
        rows.append(row)
        del vals, out, lows, lengths
        torch.cuda.empty_cache()
    return rows


def split_times(dev):
    """Phase 10: the points kernel at the Workspace's 8D f64 chunk, beside
    its bytes bound, its plain version and torch.addcmul, and the F4
    callable on those points; then both contraction routes
    (``contract_times``)."""
    ndim, c = NDIM, SPLIT_CHUNK
    tables = rule_eval.rule_tables(ndim, "float64")
    feval = tables.feval
    lows, lengths = random_pool(ndim, c, 5, torch.float64, dev)
    gl = torch.zeros(ndim, dtype=torch.float64, device=dev)
    gr = torch.ones(ndim, dtype=torch.float64, device=dev)
    args = (tables, lows, lengths, gl, gr)
    x = cuda_rule.split_points(*args, 0, c)
    t = {}
    t["points"] = queued_ms(lambda: cuda_rule.split_points(*args, 0, c), 5, 10)
    t["callable"] = queued_ms(lambda: f4_plain(x), 3, 5)
    t["plain_points"] = time_ms(lambda: rule_eval.rule_points(*args), 3)
    _, cen, ln = rule_eval.rule_points(*args)
    gen = rule_eval.device_tables(ndim, torch.float64, dev)[0]
    cen3, ln3 = cen.T[:, None, :], ln.T[:, None, :]
    t["addcmul"] = queued_ms(lambda: torch.addcmul(cen3, gen[None], ln3,
                                                   value=-1), 5, 10)
    item = 8
    points_bytes = c * feval * ndim * item + 2 * ndim * c * item \
        + feval * ndim * item + 2 * ndim * item
    b_points = bytes_bound_ms(points_bytes)
    print(f"phase 10: points kernel, {c} regions x {feval} points x {ndim} "
          f"(f64): {t['points']:.4f} ms, bound {b_points:.4f} ms "
          f"({points_bytes / 1e6:.1f} MB, bytes; "
          f"{100 * b_points / t['points']:.1f}"
          f"% of it); plain rule_points {t['plain_points']:.4f} ms; "
          f"torch.addcmul {t['addcmul']:.4f} ms; the F4 callable on the "
          f"chunk's points {t['callable']:.4f} ms (values strides "
          f"{tuple(f4_plain(x).stride())})", flush=True)
    del x, cen3, ln3
    return t, b_points, contract_times(dev)


class SplitEvents:
    """CUDA events around every launch of the two split kernels and every
    call of the integrand (``f``, the integrand wrapped) while entered:
    ``seconds``, the time between the events of each part."""

    def __init__(self, integrand):
        self.integrand = integrand
        self.events = {"points": [], "callable": [], "contract": []}
        # the route contract_route names for each contraction's values
        self.named = {r: 0 for r in cuda_rule.contract_route_launches}

    def _named(self, launch):
        def counted(lib, tables, vals, *rest, **kw):
            self.named[cuda_rule.contract_route(
                vals.dtype, tables.ndim, vals.shape[0], tables.feval,
                vals.stride(), vals.shape[2] if vals.dim() == 3 else 1)] += 1
            return launch(lib, tables, vals, *rest, **kw)
        return counted

    def _timed(self, what, fn):
        def timed(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            end.record()
            self.events[what].append((start, end))
            return out
        return timed

    def __enter__(self):
        self.kept = (cuda_rule._points_launch, cuda_rule._contract_launch,
                     cuda_rule._contract_comp_launch)
        cuda_rule._points_launch = self._timed("points", self.kept[0])
        cuda_rule._contract_launch = self._timed(
            "contract", self._named(self.kept[1]))
        cuda_rule._contract_comp_launch = self._timed(
            "contract", self._named(self.kept[2]))
        self.f = self._timed("callable", self.integrand)
        return self

    def __exit__(self, *exc):
        (cuda_rule._points_launch, cuda_rule._contract_launch,
         cuda_rule._contract_comp_launch) = self.kept
        torch.cuda.synchronize()
        self.seconds = {k: sum(s.elapsed_time(e) for s, e in v) / 1e3
                        for k, v in self.events.items()}
        return False


SPLIT_WALLS: dict[str, float] = {}   # events_run's walls, by label


def events_run(label, ws, f, epsrel, truth, phase="phase 11"):
    """``ws.integrate(f, epsrel, 1e-40)`` on the split route with CUDA
    events around each launch and call (``SplitEvents``), printed: the
    result, the wall and its shares.  Fails unless it certifies within
    epsrel of ``truth`` and every contraction took the route
    ``contract_route`` names for its values; for a vector integrand
    (``truth`` an array) every component within epsrel and within 5
    errorests of its truth.  Returns the result, the split kernels'
    launches and the contraction's by route."""
    torch.cuda.synchronize()
    cuda_rule.reset_launches()
    with SplitEvents(f) as ev:
        t0 = time.perf_counter()
        res = ws.integrate(ev.f, epsrel=epsrel, epsabs=1e-40, **HOST)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    SPLIT_WALLS[label] = wall
    launches = dict(cuda_rule.split_launches)
    routes = dict(cuda_rule.contract_route_launches)
    fused = cuda_rule.launches
    vector = np.ndim(truth) == 1
    est = res.estimates if vector else res.estimate
    err = res.errorests if vector else res.errorest
    rel = float(np.max(np.abs(est - truth) / np.abs(truth)))
    pull = float(np.max(np.abs(est - truth) / err)) if vector else 0.0
    parts = ev.seconds
    rest = wall - sum(parts.values())
    print(f"{phase}: {label}, epsrel {epsrel:g}: status {res.status} "
          f"estimate {est!r} errorest {err!r} truth "
          f"{truth!r} rel.err {rel:.3e}"
          f"{f' (largest), pull {pull:.3f} (largest)' if vector else ''} "
          f"iters {res.iters} nregions "
          f"{res.nregions} neval {res.neval} wall {wall:.3f} s evals/s "
          f"{res.neval / wall:.4e}; split kernels' launches {launches}, the "
          f"contraction's by route {routes} (contract_route named "
          f"{ev.named}), fused kernel's {fused}", flush=True)
    print(f"{phase}: {label}: the wall by CUDA events around each launch "
          f"and call (they cost host time of their own): points kernel "
          f"{parts['points']:.4f} s, the callable {parts['callable']:.4f} s, "
          f"contraction kernel {parts['contract']:.4f} s "
          f"({1e3 * parts['contract'] / max(launches['contract'], 1):.4f} ms "
          f"a launch), the rest (pool stages, host) {rest:.4f} s = "
          f"{100 * parts['points'] / wall:.1f} / "
          f"{100 * parts['callable'] / wall:.1f} / "
          f"{100 * parts['contract'] / wall:.1f} / {100 * rest / wall:.1f} %",
          flush=True)
    if res.status != 0 or not rel <= epsrel or not pull <= 5.0:
        fail(f"{label}: status {res.status}, rel.err {rel}, pull {pull}")
    if fused or not launches["points"] or \
            launches["points"] != launches["contract"]:
        fail(f"{label}: launches {launches}, fused {fused}; every rule "
             "evaluation should take the split route")
    if routes != ev.named:
        fail(f"{label}: contraction launches by route {routes}, but "
             f"contract_route named {ev.named}")
    return res, launches, routes


SIN12_EPSREL = 1e-8      # sin_sum(12) certifies there in ~2 s (1e-9 does not)


def split_main_path(dev, tile_run):
    """Phase 11: PAGANI's main path with its integrand as a plain callable,
    every rule evaluation through the split route, CUDA events around each
    kernel launch and each call of the callable, beside phase 3's run;
    then ``misc.sin_sum(12)`` the same way, and ``misc.sin_sum(8)`` at
    1e-11.  Returns the split kernels' launches on the first run, the
    contraction's by route, the 12D run's result and the sin_sum(8) run's
    result."""
    g4 = genz.f4_gaussian(NDIM)
    res, launches, routes = events_run(
        f"f64 {NDIM}D F4 as a plain callable", Workspace(NDIM), f4_plain,
        1e-3, g4.true_value)
    print(f"phase 11: phase 3 (tile route, the same integrand): iters "
          f"{tile_run.iters} nregions {tile_run.nregions} neval "
          f"{tile_run.neval}", flush=True)
    if (res.iters, res.nregions, res.neval) != (
            tile_run.iters, tile_run.nregions, tile_run.neval):
        fail("the split main path did not take phase 3's decisions")
    if routes["cluster"] != launches["contract"]:
        fail(f"split main path: contraction launches by route {routes}; all "
             "should take the cluster route")

    g12 = misc.sin_sum(12)
    sin12, _, _ = events_run("f64 12D sin_sum (models.misc)", Workspace(12),
                             g12, SIN12_EPSREL, g12.true_value)

    g = misc.sin_sum(NDIM)
    cuda_rule.reset_launches()
    t0 = time.perf_counter()
    res = Workspace(NDIM).integrate(g, epsrel=SIN_SUM_EPSREL, epsabs=1e-40,
                                    **HOST)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rel = abs(res.estimate - g.true_value) / abs(g.true_value)
    print(f"phase 11: f64 8D sin_sum (models.misc), epsrel "
          f"{SIN_SUM_EPSREL:g}: status {res.status} estimate "
          f"{res.estimate!r} truth {g.true_value!r} rel.err {rel:.3e} iters "
          f"{res.iters} nregions {res.nregions} neval {res.neval} wall "
          f"{wall:.3f} s; launches {dict(cuda_rule.split_launches)}, "
          f"contraction by route {dict(cuda_rule.contract_route_launches)}, "
          f"fused {cuda_rule.launches}", flush=True)
    if res.status != 0 or not rel <= SIN_SUM_EPSREL or cuda_rule.launches \
            or not cuda_rule.split_launches["points"]:
        fail(f"sin_sum main path: status {res.status}, rel.err {rel}")
    return launches, routes, sin12, res


CONT_POOL = 1 << 22      # a pool budget at which 8D F4's round 1 walls


def convergence_run(label, g, ws, **kw):
    """``ws.integrate_to_convergence(g, 1e-5, ...)`` with a stage timer and
    its ``integrate`` calls counted; printed, wall first.  Returns the
    result, its stages and its wall."""
    timer = StageTimer()
    runs = [0]
    integrate = ws.integrate

    def counted(*args, **kwargs):
        runs[0] += 1
        return integrate(*args, **kwargs)

    ws.integrate = counted
    cuda_rule.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = ws.integrate_to_convergence(g, epsrel=1e-5, epsabs=1e-40,
                                      max_wall_s=600, stage_timer=timer,
                                      **HOST, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rel = abs(res.estimate - g.true_value) / g.true_value
    rounds = sum(1 for k in timer.times if "round" in k)
    stages = ", ".join(f"{k} {v:.3f} s" for k, v in timer.report().items())
    stages += (f", outside the stages (checkpoints, slicing, the queue) "
               f"{wall - sum(timer.times.values()):.3f} s")
    print(f"phase 12: wall {wall:.3f} s: {label}: status {res.status} "
          f"estimate {res.estimate!r} errorest {res.errorest!r} truth "
          f"{g.true_value!r} rel.err {rel:.3e}; {rounds} rounds, "
          f"{runs[0] - rounds} slices; iters {res.iters} nregions "
          f"{res.nregions} neval {res.neval} evals/s {res.neval / wall:.4e}; "
          f"stages: {stages}; rule launches {dict(cuda_rule.route_launches)}",
          flush=True)
    if res.status != 0 or not rel <= 1e-5:
        fail(f"{label}: status {res.status}, rel.err {rel}")
    return res, timer.times, wall


def continuation_path(dev):
    """Phase 12: the reference's flagship, 8D Genz F4 at epsrel 1e-5, by
    ``integrate_to_convergence``, as it is (the 16M-region pool budget);
    then with the pool budget cut to CONT_POOL regions, where round 1 walls
    and the partitioned continuation must carry it; then that
    continuation stopped before its first slice (a passed deadline), saved,
    and resumed from the file."""
    g = genz.f4_gaussian(NDIM)
    ws = Workspace(NDIM)
    _, stages, wall = convergence_run(
        f"integrate_to_convergence, f64 8D f4_gaussian epsrel 1e-5, pool "
        f"budget {ws.max_pool_regions}", g, ws)
    engaged = ("engaged" if "slices" in stages
               else "did not engage: round 1 certified")
    print(f"phase 12: at the {ws.max_pool_regions}-region budget the "
          f"continuation {engaged}", flush=True)
    ws = Workspace(NDIM, max_pool_regions=CONT_POOL)
    res, stages, _ = convergence_run(
        f"the same, pool budget {CONT_POOL}", g, ws)
    if "slices" not in stages:
        fail(f"pool budget {CONT_POOL}: stages {sorted(stages)}; the "
             "partitioned continuation should engage")

    sp = cuda_build.BUILD_DIR / "continuation_state"
    ws2 = Workspace(NDIM, max_pool_regions=CONT_POOL)
    t0 = time.perf_counter()
    r1 = ws2.integrate(g, epsrel=1e-5, epsabs=1e-40, **HOST)
    ck = ws2.make_checkpoint()
    ws2.final_pool = ws2.final_pool_errors = None
    cut = ws2._partitioned_continuation(
        g, 1e-5, 1e-40, None, ck, r1, 15, deadline=time.monotonic() - 1.0,
        state_path=sp, **HOST)
    saved = (sp.parent / (sp.name + ".npz")).exists()
    resumed = Workspace(NDIM, max_pool_regions=CONT_POOL
                        ).integrate_to_convergence(
        g, epsrel=1e-5, epsabs=1e-40, max_wall_s=600, state_path=sp,
        **HOST)
    torch.cuda.synchronize()
    same = (resumed.estimate, resumed.errorest, resumed.neval,
            resumed.nregions) == (res.estimate, res.errorest, res.neval,
                                  res.nregions)
    print(f"phase 12: stopped before the first slice (status {cut.status}, "
          f"state saved: {saved}), resumed from the file: status "
          f"{resumed.status} estimate {resumed.estimate!r} errorest "
          f"{resumed.errorest!r} neval {resumed.neval}: "
          f"{'the same' if same else 'NOT the same'} as the uninterrupted "
          f"run; {time.perf_counter() - t0:.3f} s", flush=True)
    if not (saved and resumed.status == 0 and same):
        fail("the continuation resumed from its state file differs from the "
             "uninterrupted run")
    return wall


# ---------------------------------------------------------------------------
# Vector integrands: the components contraction (phases 9-10), the vector
# main paths (phases 13-14)

# (label, ndim, regions, type, components, layout): the Workspace's 8D and
# 12D f64 chunks, an odd count at 3D, f32; 2, 3, 4 and 8 components;
# values component-minor (torch.stack(..., -1)) and component-major
COMPONENT_CASES = (
    ("8D f64 Workspace chunk", 8, 4096, torch.float64, 4, "minor"),
    ("8D f64 Workspace chunk", 8, 4096, torch.float64, 4, "major"),
    ("12D f64 Workspace chunk", 12, 1024, torch.float64, 4, "minor"),
    ("12D f32", 12, 1024, torch.float32, 3, "major"),
    ("3D f64 odd count", 3, 4093, torch.float64, 2, "minor"),
    ("3D f32 odd count", 3, 4091, torch.float32, 8, "major"),
    ("8D f32 Workspace chunk", 8, 8192, torch.float32, 8, "minor"),
)


def vector_values(ndim, count, dtype, ncomp, layout, dev, seed=8):
    """A vector integrand's values (count, feval, ncomp) made directly, on
    the grid k/8 in [0.5, 1.5) (``direct_values``: every orbit sum exact in
    any order), component-minor (strides (feval ncomp, ncomp, 1), what
    torch.stack(..., -1) gives) or component-major (a (ncomp, count,
    feval) tensor with its axis moved)."""
    feval = rule_eval.rule_tables(ndim).feval
    g = torch.Generator(device=dev).manual_seed(seed)
    shape = (count, feval, ncomp) if layout == "minor" else (ncomp, count,
                                                              feval)
    v = torch.randint(4, 12, shape, generator=g, device=dev).to(dtype) / 8
    return v if layout == "minor" else v.movedim(0, -1)


# The scalar route whose bits each component of a vector's route keeps on
# the component's contiguous plane.
PLANE_ROUTE = {cuda_rule.COMPONENTS_CLUSTER: "cluster",
               cuda_rule.COMPONENTS: "generic"}


def components_check(label, ndim, count, dtype, ncomp, layout, dev,
                     nan=False):
    """A vector's contractions alone on ``vector_values``: contract_route
    names 'components_cluster' for component-minor values and 'components'
    for component-major ones; each route that takes the values (both,
    component-minor) against rule_eval.rule_outputs_vector
    (kernel_check.check_components: est/err of each component by
    kernel_check's limits, split_dim EQUAL), each component bit for bit
    the scalar route's on its contiguous plane (PLANE_ROUTE), two launches
    the same bits, counted on that route.  With ``nan`` one component of
    region 7 holds a NaN, which must make the widest axis its split axis.
    Returns the largest |d est| by route."""
    tables = rule_eval.rule_tables(ndim, rule_eval.dtype_name(dtype))
    lows, lengths = random_pool(ndim, count, 9, dtype, dev)
    gl = torch.zeros(ndim, dtype=dtype, device=dev)
    gr = torch.full((ndim,), 1.25, dtype=dtype, device=dev)
    vals = vector_values(ndim, count, dtype, ncomp, layout, dev)
    if nan:
        vals[7, 2 + 2 * ndim, ncomp - 1] = float("nan")
    named = cuda_rule.contract_route(dtype, ndim, count, tables.feval,
                                     vals.stride(), ncomp)
    want = (cuda_rule.COMPONENTS_CLUSTER if layout == "minor"
            else cuda_rule.COMPONENTS)
    if named != want:
        fail(f"components {label}: contract_route names {named}, not {want}")
    plain = rule_eval.rule_outputs_vector(vals, tables, lengths, gr)
    planes = [vals[..., k].contiguous() for k in range(ncomp)]
    worst = {}
    for route in cuda_rule.VECTOR_ROUTES[cuda_rule.VECTOR_ROUTES.index(
            named):]:
        cuda_rule.reset_launches()
        a, b = (cuda_rule.split_contract_components(
            vals, tables, lows, lengths, gl, gr, 0, route=route)
            for _ in range(2))
        torch.cuda.synchronize()
        launched = dict(cuda_rule.contract_route_launches)
        same = all(torch.equal(x.view(torch.uint8), y.view(torch.uint8))
                   for x, y in zip(a, b))
        try:
            r = kernel_check.check_components(a, plain, vals, vals.abs(),
                                              tables, lengths, gr,
                                              name=f"{label} ({route})")
        except AssertionError as e:
            fail(str(e))
        plane_bits = True
        for k in range(ncomp):
            e, rr, _ = cuda_rule.split_contract(planes[k], tables, lows,
                                                lengths, gl, gr, 0,
                                                route=PLANE_ROUTE[route])
            plane_bits &= (torch.equal(a[0][k].view(torch.uint8),
                                       e.view(torch.uint8))
                           and torch.equal(a[1][k].view(torch.uint8),
                                           rr.view(torch.uint8)))
        widest = int(torch.argmax(lengths[:, 7]))
        nan_note = (f"; NaN region: est {float(a[0][ncomp - 1][7])}, "
                    f"split_dim {int(a[2][7])} (plain {int(plain[2][7])}, "
                    f"widest axis {widest})" if nan else "")
        print(f"phase 9: {route} {label}, {count} x {tables.feval} x "
              f"{ncomp} ({layout}, strides {tuple(vals.stride())}): est "
              f"{r['est_ulps']:.3g}, err {r['err_ulps']:.3g} ulps beyond rtol"
              f" (limits {kernel_check.ULPS['est']:g}/"
              f"{kernel_check.ULPS['err']:g}; {r['gate_ties']} gate ties); "
              f"split_dim EQUAL in {r['split_dim_equal']} of {count}; each "
              f"component bit for bit the {PLANE_ROUTE[route]} scalar "
              f"route's on its plane: {plane_bits}; two launches the same "
              f"bits: {same}; contract_route names {named}; launches "
              f"{launched}{nan_note}", flush=True)
        counted = {key: 2 if key == route else 0 for key in launched}
        if not (same and plane_bits and launched == counted):
            fail(f"{route} {label}: disagrees")
        if nan and not (int(a[2][7]) == int(plain[2][7]) == widest
                        and math.isnan(float(a[0][ncomp - 1][7]))):
            fail(f"{route} {label}: the NaN region does not take the widest "
                 "axis")
        worst[route] = r["max_abs_est"]
    return worst


def components_checks(dev):
    """Phase 9 (extended): ``components_check`` at COMPONENT_CASES and a
    NaN region.  Returns the largest |d est| by route."""
    worst = {r: 0.0 for r in cuda_rule.VECTOR_ROUTES}
    for case in COMPONENT_CASES:
        for route, d in components_check(*case, dev).items():
            worst[route] = max(worst[route], d)
        torch.cuda.empty_cache()
    components_check("8D f64 NaN region", 8, 256, torch.float64, 3, "minor",
                     dev, nan=True)
    return worst


def components_times(dev):
    """Phase 10 (extended): a vector's two contraction routes at the
    Workspace's 8D f64 chunk (4096 x 1105 x 4) and 12D f64 chunk (1024 x
    6745 x 4), values component-minor, in turns (components_cluster,
    components, components, components_cluster), and the alternative of
    ncomp launches of the scalar cluster route on a component-major copy
    (the copy's time included), best of 5 series back to back
    (``queued_ms``); beside the bytes bound, the plain
    rule_outputs_vector and torch.matmul of the (C ncomp, feval) values
    against the column matrix (the rule sums only, TF32 off).  Returns one
    dict a shape."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = []
    for ndim, c in ((8, 4096), (12, 1024)):
        dtype, ncomp = torch.float64, 4
        tables = rule_eval.rule_tables(ndim, "float64")
        lows, lengths = random_pool(ndim, c, 5, dtype, dev)
        gl = torch.zeros(ndim, dtype=dtype, device=dev)
        gr = torch.ones(ndim, dtype=dtype, device=dev)
        args = (tables, lows, lengths, gl, gr, 0)
        vals = vector_values(ndim, c, dtype, ncomp, "minor", dev)
        out = cuda_rule.split_contract_components(vals, *args)
        outs = [cuda_rule.split_contract(vals[..., k].contiguous(), *args)
                for k in range(ncomp)]

        def routed(route):
            return lambda: cuda_rule.split_contract_components(
                vals, *args, out=out, route=route)

        def cluster_each():
            planes = vals.movedim(-1, 0).contiguous()
            for k in range(ncomp):
                cuda_rule.split_contract(planes[k], *args, out=outs[k],
                                         route="cluster")

        cc, comp = (routed(r) for r in cuda_rule.VECTOR_ROUTES)
        t = [queued_ms(fn, 5, 10) for fn in (cc, comp, comp, cc)]
        each = [queued_ms(cluster_each, 5, 10) for _ in range(2)]
        item = 8
        nbytes = (c * tables.feval * ncomp * item + ndim * c * item
                  + c * (2 * ncomp * item + 4))
        vm = vals.movedim(-1, 0).reshape(ncomp * c, tables.feval).contiguous()
        mt = torch.as_tensor(column_matrix(tables), dtype=dtype, device=dev)
        k = cuda_rule.comp_cluster_plan(dtype, ndim, c, tables.feval,
                                        ncomp)[0]
        row = {"ndim": ndim, "count": c, "feval": tables.feval,
               "ncomp": ncomp, "components_cluster_ms": min(t[0], t[3]),
               "components_ms": min(t[1], t[2]),
               "cluster_each_ms": min(each), "series_ms": t,
               "cluster": k, "ctas": -(-c // 32) * k,
               "co_resident_clusters": cuda_rule.comp_cluster_occupancy(
                   dtype, ndim, c, tables.feval, ncomp),
               "smem_bytes": cuda_rule.comp_cluster_smem(
                   dtype, ndim, ncomp, *cuda_rule.comp_cluster_plan(
                       dtype, ndim, c, tables.feval, ncomp)[2:]),
               "bytes": nbytes, "bound_ms": bytes_bound_ms(nbytes),
               "plain_ms": time_ms(lambda: rule_eval.rule_outputs_vector(
                   vals, tables, lengths, gr), 3),
               "sums_only_matmul_ms": queued_ms(
                   lambda: torch.matmul(vm, mt), 5)}
        b = row["bound_ms"]
        print(f"phase 10: a vector's contraction, {ndim}D f64 {c} regions x "
              f"{tables.feval} points x {ncomp} components (component-minor, "
              f"{nbytes / 1e6:.1f} MB): components_cluster "
              f"{row['components_cluster_ms']:.4f} ms "
              f"({100 * b / row['components_cluster_ms']:.1f}% of the bound; "
              f"clusters of {k}, {row['ctas']} CTAs of "
              f"{row['smem_bytes']} bytes of shared memory, "
              f"{row['co_resident_clusters']} clusters co-resident), "
              f"components {row['components_ms']:.4f} ms "
              f"({100 * b / row['components_ms']:.1f}%), series "
              f"{', '.join(f'{x:.4f}' for x in t)}; bound {b:.4f} ms "
              f"(bytes); {ncomp} cluster-route launches on a component-major "
              f"copy, the copy included, {row['cluster_each_ms']:.4f} ms; "
              f"plain rule_outputs_vector {row['plain_ms']:.4f} ms; the sums "
              f"alone by torch.matmul of the ({ncomp * c}, {tables.feval}) "
              f"values against the column matrix "
              f"{row['sums_only_matmul_ms']:.4f} ms", flush=True)
        rows.append(row)
        del vals, vm, out, outs, lows, lengths
        torch.cuda.empty_cache()
    return rows


# The vector Workspace(8) run's tolerance: the first of 1e-3, 3e-3 and
# 1e-2 at which tools/vector_probe.py's members certify within 90 s on the
# card (its 'moderate' set at 1e-3; the reference's own members at their
# default parameters certify at none: F2 at a = 50 walls the pool, PERF.md)
VEC8_EPSREL = 1e-3


class SweepRecorder:
    """Every sweep of a Workspace's host loop while entered: (pool size,
    layout, lows, lengths, split_dim), for a run whose discrete outcomes
    are to be held against another's."""

    def __init__(self, ws):
        self.ws, self.sweeps = ws, []

    def __enter__(self):
        evaluate = self.ws._eval_pool

        def recorded(integrand, tables, lows, lengths, gl, gr, n, blocked,
                     *rest):
            out = evaluate(integrand, tables, lows, lengths, gl, gr, n,
                           blocked, *rest)
            self.sweeps.append((n, blocked, lows, lengths, out[2]))
            return out

        self.ws._eval_pool = recorded
        return self

    def __exit__(self, *exc):
        del self.ws._eval_pool
        return False


def first_divergence(a, b, g):
    """The first sweep where two recorded runs (``SweepRecorder``) part:
    the iteration, the first region whose split axis differs and how near
    a tie its two axes' fourth differences are, in ulps of the largest of
    its 4n+1 values (kernel_check.TIE is the near-tie limit)."""
    for it, (sa, sb) in enumerate(zip(a.sweeps, b.sweeps)):
        if sa[0] != sb[0]:
            return f"iteration {it}: {sa[0]} regions against {sb[0]}"
        mask = region_pool.block_mask(sa[2].shape[1], sa[0], sa[1],
                                      sa[2].device)
        differ = torch.nonzero(mask & (sa[4] != sb[4]))[:, 0]
        if differ.numel():
            r = int(differ[0])
            tables = rule_eval.rule_tables(sa[2].shape[0])
            dev = sa[2].device
            gl = torch.zeros(tables.ndim, dtype=torch.float64, device=dev)
            gr = torch.ones(tables.ndim, dtype=torch.float64, device=dev)
            v = rule_eval.rule_values(g, tables, sa[2][:, r:r + 1],
                                      sa[3][:, r:r + 1], gl, gr)
            fd = rule_eval.fourth_differences(v, tables.ndim, tables.ratio)[0]
            da, db = int(sa[4][r]), int(sb[4][r])
            top = float(v[0, :4 * tables.ndim + 1].abs().max())
            gap = float((fd[da] - fd[db]).abs()) / (
                torch.finfo(torch.float64).eps * top)
            tie = "a near-tie" if gap <= kernel_check.TIE else "NOT a near-tie"
            return (f"iteration {it}, slot {r}: split axes {da} and {db}, "
                    f"their fourth differences {gap:.3g} ulps of the values "
                    f"apart ({tie})")
    return "no sweep differs"


def identity_check(dev):
    """Phase 13.2: [sin_sum(8), sin_sum(8)] as one vector at
    SIN_SUM_EPSREL against the scalar sin_sum(8) (phase 11's run): the same
    iterations, regions and neval; both components bit for bit equal; the
    estimate within kernel_check's rtol of the scalar run's (and whether
    bit for bit); and the final pool's first chunk through both
    contractions (the scalar's cluster route, the components cluster
    route) held to the plain version by kernel_check's limits."""
    g = misc.sin_sum(NDIM)

    def gg(x):
        return torch.stack([g(x), g(x)], dim=-1)

    gg.ndim = NDIM
    ws_s, ws_v = Workspace(NDIM), Workspace(NDIM)
    with SweepRecorder(ws_s) as rec_s:
        rs = ws_s.integrate(g, epsrel=SIN_SUM_EPSREL, epsabs=1e-40, **HOST)
    cuda_rule.reset_launches()
    t0 = time.perf_counter()
    with SweepRecorder(ws_v) as rec_v:
        rv = ws_v.integrate(gg, epsrel=SIN_SUM_EPSREL, epsabs=1e-40,
                            **HOST)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    routes = dict(cuda_rule.contract_route_launches)
    rtol = kernel_check.RTOL[torch.float64]
    d_est = abs(rv.estimates[0] - rs.estimate) / abs(rs.estimate)
    d_err = abs(rv.errorests[0] - rs.errorest) / rs.errorest
    same_run = (rv.status, rv.iters, rv.nregions, rv.neval) == (
        rs.status, rs.iters, rs.nregions, rs.neval)
    print(f"phase 13: [sin_sum(8), sin_sum(8)] at epsrel {SIN_SUM_EPSREL:g}: "
          f"status {rv.status} estimates {rv.estimates!r} errorests "
          f"{rv.errorests!r} iters {rv.iters} nregions {rv.nregions} neval "
          f"{rv.neval} wall {wall:.3f} s; the scalar sin_sum(8): status "
          f"{rs.status} estimate {rs.estimate!r} errorest {rs.errorest!r} "
          f"iters {rs.iters} nregions {rs.nregions} neval {rs.neval}; "
          f"estimate {d_est:.3g}, errorest {d_err:.3g} relative apart (bit "
          f"for bit: {rv.estimates[0] == rs.estimate}, "
          f"{rv.errorests[0] == rs.errorest}); contraction launches "
          f"{routes}", flush=True)
    if not same_run:
        print(f"phase 13: the runs part at "
              f"{first_divergence(rec_s, rec_v, g)}", flush=True)
        fail("[sin_sum(8), sin_sum(8)] does not take the scalar run's "
             "decisions")
    if not (rv.estimates[0] == rv.estimates[1]
            and rv.errorests[0] == rv.errorests[1]):
        fail("the two equal components differ")
    if not d_est <= rtol or routes[cuda_rule.COMPONENTS_CLUSTER] == 0 or \
            routes["cluster"] or routes[cuda_rule.COMPONENTS]:
        fail(f"[sin_sum(8), sin_sum(8)]: estimate {d_est} apart, launches "
             f"{routes}")

    # the final pool's first chunk through both routes, each held to the
    # plain version on the same values by kernel_check's limits
    lows, lengths, n, blocked = ws_v.final_pool
    tables = rule_eval.rule_tables(NDIM, "float64")
    count = min(SPLIT_CHUNK, n)
    slots = torch.as_tensor(cuda_rule.split_slots(lows.shape[1], n, blocked, 0,
                                                  count), device=dev)
    lo, ln = lows[:, slots].contiguous(), lengths[:, slots].contiguous()
    gl = torch.zeros(NDIM, dtype=torch.float64, device=dev)
    gr = torch.ones(NDIM, dtype=torch.float64, device=dev)
    ks = cuda_rule.cuda_apply_rule_split(g, tables, lo, ln, gl, gr)
    kv = cuda_rule.cuda_apply_rule_split(gg, tables, lo, ln, gl, gr, ncomp=2)
    vals, u = kernel_check.value_scales(g, tables, lo, ln, gl, gr)
    try:
        rsc = kernel_check.judge(kernel_check.region_readings(
            ks, rule_eval.rule_outputs(vals, tables, ln, gr), vals, u, tables,
            ln, gr), name="sin_sum", dtype=torch.float64)
        v2, u2 = torch.stack([vals, vals], -1), torch.stack([u, u], -1)
        rvc = kernel_check.check_components(
            kv, rule_eval.rule_outputs_vector(v2, tables, ln, gr), v2, u2,
            tables, ln, gr, name="[sin_sum, sin_sum]")
    except AssertionError as e:
        fail(str(e))
    print(f"phase 13: the final pool's first {count} regions: the scalar "
          f"cluster route est {rsc['est_ulps']:.3g}, err {rsc['err_ulps']:.3g}"
          f" ulps beyond rtol; the components cluster route est "
          f"{rvc['est_ulps']:.3g}, err {rvc['err_ulps']:.3g} (limits 1/1; "
          f"split_dim EQUAL in {rvc['split_dim_equal']} of {count})",
          flush=True)


VCONT = dict(ndim=3, epsrel=1e-9, chunk_size=1024, max_pool_regions=1 << 14,
             finish_epsrel_scale=0.4)


def vector_continuation(dev):
    """Phase 13.3: ``integrate_to_convergence`` of [f4_gaussian(3, a=8),
    f2_product_peak(3)] at VCONT (the pool budget cut to 2^14 regions, so
    round 1 walls and the partitioned continuation carries the run): status
    0, every component within epsrel of its closed form, two slices or
    more; then the same stopped before its first slice, saved
    (``state_path``) and resumed, which must give the uninterrupted run's
    estimates, errorests and neval bit for bit.  Returns the wall."""
    nd, eps = VCONT["ndim"], VCONT["epsrel"]
    f, truths = vector_probe.vector([genz.f4_gaussian(nd, a=8.0),
                                     genz.f2_product_peak(nd)])
    ws_kw = dict(chunk_size=VCONT["chunk_size"],
                 max_pool_regions=VCONT["max_pool_regions"])
    kw = dict(finish_epsrel_scale=VCONT["finish_epsrel_scale"], **HOST)
    ws = Workspace(nd, **ws_kw)
    timer, runs, integrate = StageTimer(), [0], ws.integrate

    def counted(*args, **kwargs):
        runs[0] += 1
        return integrate(*args, **kwargs)

    ws.integrate = counted
    cuda_rule.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = ws.integrate_to_convergence(f, epsrel=eps, epsabs=1e-40,
                                      max_rounds=40, stage_timer=timer, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rounds = sum(1 for k in timer.times if "round" in k)
    rel = np.abs(res.estimates - truths) / np.abs(truths)
    print(f"phase 13: wall {wall:.3f} s: vector integrate_to_convergence, "
          f"[f4_gaussian(3, a=8), f2_product_peak(3)] epsrel {eps:g}, pool "
          f"budget {VCONT['max_pool_regions']}, chunk {VCONT['chunk_size']}: "
          f"status {res.status} estimates {res.estimates!r} errorests "
          f"{res.errorests!r} rel.err {rel}; {rounds} rounds, "
          f"{runs[0] - rounds} slices; iters {res.iters} nregions "
          f"{res.nregions} neval {res.neval}; contraction launches "
          f"{dict(cuda_rule.contract_route_launches)}", flush=True)
    if res.status != 0 or not np.all(rel <= eps) or runs[0] - rounds < 2:
        fail(f"vector continuation: status {res.status}, rel.err {rel}, "
             f"{runs[0] - rounds} slices")

    sp = cuda_build.BUILD_DIR / "vector_continuation_state"
    ws2 = Workspace(nd, **ws_kw)
    r1 = ws2.integrate(f, epsrel=eps, epsabs=1e-40, **kw)
    ck = ws2.make_checkpoint()
    ws2.final_pool = ws2.final_pool_errors = None
    cut = ws2._partitioned_continuation(
        f, eps, 1e-40, None, ck, r1, 39, deadline=time.monotonic() - 1.0,
        state_path=sp, **kw)
    saved = (sp.parent / (sp.name + ".npz")).exists()
    resumed = Workspace(nd, **ws_kw).integrate_to_convergence(
        f, epsrel=eps, epsabs=1e-40, max_rounds=40, state_path=sp, **kw)
    same = (list(resumed.estimates) == list(res.estimates)
            and list(resumed.errorests) == list(res.errorests)
            and resumed.neval == res.neval)
    print(f"phase 13: stopped before the first slice (status {cut.status}, "
          f"state saved: {saved}), resumed from the file: status "
          f"{resumed.status} estimates {resumed.estimates!r} errorests "
          f"{resumed.errorests!r} neval {resumed.neval}: "
          f"{'the same' if same else 'NOT the same'} as the uninterrupted "
          f"run", flush=True)
    if not (saved and resumed.status == 0 and same):
        fail("the vector continuation resumed from its state file differs "
             "from the uninterrupted run")
    return wall


# A vector contraction kernel's name in the profiler's trace, by route.
ROUTE_KERNEL = {cuda_rule.COMPONENTS_CLUSTER: "rule_contract_comp_cluster_kernel",
                cuda_rule.COMPONENTS: "rule_contract_comp_kernel"}


def in_situ(label, f, ndim, epsrel, route):
    """``Workspace(ndim).integrate(f, epsrel)`` traced by
    ``utils.profiling.trace`` (torch.profiler) with every vector
    contraction forced onto ``route``: the contraction kernel's launches
    and mean device duration as the trace reads them, the device's busy
    time (its kernels', copies' and memsets' self time) and idle share of
    the wall.  Returns {launches, ms, wall_s, busy_s, idle}."""
    from torch.autograd import DeviceType

    from gpuintegration_torch.utils.profiling import trace
    kept = cuda_rule._contract_comp_launch

    def forced(*args, **kw):
        return kept(*args, **dict(kw, route=route))

    cuda_rule._contract_comp_launch = forced
    try:
        with tempfile.TemporaryDirectory() as log_dir:
            with trace(log_dir) as prof:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = Workspace(ndim).integrate(f, epsrel=epsrel,
                                                epsabs=1e-40, **HOST)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            events = [e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and not e.is_user_annotation]
    finally:
        cuda_rule._contract_comp_launch = kept
    busy = sum(e.self_device_time_total for e in events) / 1e6
    mine = [e for e in events if ROUTE_KERNEL[route] in e.key]
    n = sum(e.count for e in mine)
    ms = sum(e.device_time_total for e in mine) / 1e3 / max(n, 1)
    out = {"launches": n, "ms": ms, "wall_s": wall, "busy_s": busy,
           "idle": 1 - busy / wall, "status": res.status, "iters": res.iters}
    print(f"phase 13: in situ, {label}, every contraction on {route} "
          f"(torch.profiler): status {res.status} iters {res.iters}, wall "
          f"{wall:.3f} s traced; {n} launches of {ROUTE_KERNEL[route]}, "
          f"{ms:.4f} ms a launch on the device ({n * ms / 1e3:.4f} s); the "
          f"device busy {busy:.3f} s (self time of its kernels, copies and "
          f"memsets), idle {100 * out['idle']:.1f} % of the wall", flush=True)
    if res.status != 0 or not n:
        fail(f"in situ {label} on {route}: status {res.status}, {n} launches")
    return out


def sin12_vector(scalar):
    """Phase 13.4: [sin_sum(12)] x 4 as one vector at SIN12_EPSREL on the
    Workspace's 1024-region chunks, every contraction on the components
    cluster route, against phase 11's scalar sin_sum(12) run (``scalar``):
    the same iterations, regions and neval; the four components equal;
    each within kernel_check's rtol of the scalar run's estimate (and
    whether bit for bit, estimate and errorest).  Returns the launches by
    route and the wall."""
    g = misc.sin_sum(12)
    f, truths = vector_probe.vector([g] * 4)
    t0 = time.perf_counter()
    rv, launches, routes = events_run(
        "f64 12D [sin_sum(12)] x 4 as one vector", Workspace(12), f,
        SIN12_EPSREL, truths, phase="phase 13")
    wall = time.perf_counter() - t0
    d_est = float(np.max(np.abs(rv.estimates - scalar.estimate))
                  / abs(scalar.estimate))
    print(f"phase 13: [sin_sum(12)] x 4 against the scalar run (status "
          f"{scalar.status}, iters {scalar.iters}, nregions "
          f"{scalar.nregions}, neval {scalar.neval}, estimate "
          f"{scalar.estimate!r}, errorest {scalar.errorest!r}): estimates "
          f"{d_est:.3g} relative apart; each estimate bit for bit: "
          f"{bool(np.all(rv.estimates == scalar.estimate))}, each errorest: "
          f"{bool(np.all(rv.errorests == scalar.errorest))}", flush=True)
    if (rv.iters, rv.nregions, rv.neval) != (scalar.iters, scalar.nregions,
                                             scalar.neval):
        fail("[sin_sum(12)] x 4 does not take the scalar run's decisions")
    if not (np.all(rv.estimates == rv.estimates[0])
            and np.all(rv.errorests == rv.errorests[0])
            and d_est <= kernel_check.RTOL[torch.float64]):
        fail(f"[sin_sum(12)] x 4: the components differ, or {d_est} from "
             "the scalar estimate")
    if not routes[cuda_rule.COMPONENTS_CLUSTER] == launches["contract"]:
        fail(f"[sin_sum(12)] x 4: contraction launches by route {routes}; "
             "all should take the components cluster route")
    return routes, wall


def vector_main_path(dev, sin12):
    """Phase 13: PAGANI's vector main path at full width: Workspace(8) on
    four Genz members as one vector (tools/vector_probe.py's 'moderate'
    set: the reference's vector families, F1 with coefficients 1/2 and F2
    at a = 5) at VEC8_EPSREL (every rule
    evaluation through the points kernel and the components cluster
    contraction, CUDA events around each launch and call); the same run
    traced (``in_situ``) once on each vector route; the identity check;
    [sin_sum(12)] x 4 against phase 11's scalar run (``sin12``); the
    vector continuation.  Returns the split kernels' launches of the first
    run, the contraction's by route, the in-situ readings, the walls and the
    first run's (result, wall)."""
    f, truths = vector_probe.vector(vector_probe.members("moderate"))
    label = ("f64 8D [F1 (coefficients 1/2), F2 (a=5), F4 (a=5), F5] as one "
             "vector")
    t0 = time.perf_counter()
    vec_res, launches, routes = events_run(label, Workspace(NDIM), f,
                                           VEC8_EPSREL, truths,
                                           phase="phase 13")
    walls = {"vec8": time.perf_counter() - t0}
    if not (routes[cuda_rule.COMPONENTS_CLUSTER] == launches["contract"]
            == launches["points"] and routes["cluster"] == routes["generic"]
            == routes[cuda_rule.COMPONENTS] == 0):
        fail(f"vector main path: launches {launches}, contraction by route "
             f"{routes}; every chunk should take the components cluster "
             "route")
    situ = {route: in_situ(label, f, NDIM, VEC8_EPSREL, route)
            for route in cuda_rule.VECTOR_ROUTES}
    identity_check(dev)
    routes["sin12x4"], walls["sin12x4"] = sin12_vector(sin12)
    walls["continuation"] = vector_continuation(dev)
    return launches, routes, situ, walls, (vec_res, walls["vec8"])


VVEGAS = dict(epsrel=1e-3, ncall=1e8)   # VEGAS run 1's settings, 6D f64


def vector_vegas_run(label, f, truths, expect, state=None, **kw):
    """One vector VEGAS run through the entry point (``LaunchCounts``):
    status 0, every component within 5 errorests of its truth, a launch
    of every kernel in ``expect`` and of no other.  Returns the result,
    the launches and the wall."""
    torch.cuda.synchronize()
    with LaunchCounts() as clock:
        t0 = time.perf_counter()
        res = mcubes.integrate(f, epsabs=1e-40, state=state, **VVEGAS, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    pull = np.abs(res.estimates - truths) / res.errorests
    print(f"phase 14: {label}: status {res.status} estimates "
          f"{res.estimates!r} errorests {res.errorests!r} truths "
          f"{truths!r} pulls {pull} probs {res.probs} prob {res.prob:.4f} "
          f"chi_sq {res.chi_sq:.4f} iters {res.iters} neval {res.neval} "
          f"wall {wall:.3f} s samples/s {res.neval / wall:.4e} launches "
          f"{clock.launches}", flush=True)
    if res.status != 0 or not np.all(pull <= 5.0):
        fail(f"{label}: status {res.status}, pulls {pull}")
    for name in clock.launches:
        if (clock.launches[name] > 0) != (name in expect):
            fail(f"{label}: {name} launched {clock.launches[name]} times; "
                 f"the run should go through {sorted(expect)} only")
    return res, clock.launches, wall


def vector_vegas(dev):
    """Phase 14: vector VEGAS at run 1's settings (6D, ncall 1e8, f64, the
    poly map, the AUTO sampler, which must take 'hybrid') on
    [f4_gaussian(6, a=25), f4_gaussian(6, a=20)]; the same with the grid
    map (run 3's settings); and [g, g] against the scalar run of g through
    'hybrid': the same iterations, the final grid EQUAL, both components
    bit for bit equal and within 1e-12 of the scalar estimate.  The
    histogram adapts to component 0: its launches are the scalar run's.
    Returns the launches and walls."""
    g25 = genz.f4_gaussian(VEGAS_NDIM, a=25.0)
    f, truths = vector_probe.vector([g25,
                                     genz.f4_gaussian(VEGAS_NDIM, a=20.0)])
    picked = vegas_module._resolve_sampler(None, "poly", "cuda",
                                           torch.float64, f, 2)
    if picked != "hybrid":
        fail(f"AUTO picks {picked!r} for a vector integrand on the card")
    out = {}
    _, out["poly"], w_poly = vector_vegas_run(
        "[f4 a=25, f4 a=20] f64 poly AUTO ('hybrid') ncall 1e8", f, truths,
        {"vegas_sample", "vegas_hist"})
    _, out["grid"], w_grid = vector_vegas_run(
        "[f4 a=25, f4 a=20] f64 grid ncall 1e8", f, truths,
        {"vegas_bin_resolve", "vegas_hist"}, importance="grid")

    gg, _ = vector_probe.vector([g25, g25])
    st_s = mcubes.VegasState(xi=vegas_grid.uniform_grid(
        VEGAS_NDIM, vegas_grid.NDMX, torch.float64, dev))
    st_v = mcubes.VegasState(xi=st_s.xi.clone())
    with LaunchCounts() as cs:
        rs = mcubes.integrate(g25, epsabs=1e-40, state=st_s,
                              sampler="hybrid", **VVEGAS)
    rv, out["identity"], _ = vector_vegas_run(
        "[g, g], g = f4 a=25", gg, np.array([g25.true_value] * 2),
        {"vegas_sample", "vegas_hist"}, state=st_v)
    d = abs(rv.estimates[0] - rs.estimate) / abs(rs.estimate)
    same_grid = torch.equal(st_s.xi, st_v.xi)
    print(f"phase 14: [g, g] against the scalar run of g ('hybrid'): iters "
          f"{rv.iters}/{rs.iters}, final grid EQUAL: {same_grid}, components "
          f"bit for bit equal: {rv.estimates[0] == rv.estimates[1]}, "
          f"estimate {d:.3g} relative from the scalar's {rs.estimate!r}; "
          f"histogram launches {out['identity']['vegas_hist']} (scalar run "
          f"{cs.launches['vegas_hist']})", flush=True)
    if not (rv.iters == rs.iters and same_grid and d <= 1e-12
            and rv.estimates[0] == rv.estimates[1]
            and rv.errorests[0] == rv.errorests[1]
            and out["identity"]["vegas_hist"] == cs.launches["vegas_hist"]):
        fail("[g, g] does not reproduce the scalar VEGAS run")
    return out, {"poly": w_poly, "grid": w_grid}


# ---------------------------------------------------------------------------
# Crease/jump-aware splits and the fused phase (phases 15-17)

# (label, ndim, regions, type): the Workspace's 8D f64 and f32 chunks and
# its 12D f64 chunk
SPLIT_FRAC_CASES = (("8D f64 Workspace chunk", 8, 4096, "float64"),
                    ("12D f64 Workspace chunk", 12, 1024, "float64"),
                    ("8D f32 Workspace chunk", 8, 8192, "float32"))
# The deepest tolerances of tools/crease_probe.py's ladder at which 8D F5
# (a=10, b=0.37) and F6 certify with crease/jump-aware splits within 30 s
# on an NVIDIA H100 80GB HBM3 at 700 W (F5 3e-3 and F6 1e-4 do not;
# PERF.md)
F5_CREASE_EPSREL = 1e-2
F6_CREASE_EPSREL = 3e-4


# The walls of phase 16's crease runs at commit fce39b8, when every crease
# run took the split route (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md),
# printed beside this run's: (host, fused)
SPLIT_ROUTE_CREASE_WALLS = {"f5_c0": (17.593, 17.647),
                     "f6_discontinuous": (11.466, 13.903)}


def in_turns(without, with_frac, timer):
    """Each of two calls timed in turns (without, with, with, without) by
    ``timer``: (best without, best with, the four series)."""
    t = [timer(without), timer(with_frac), timer(with_frac), timer(without)]
    return min(t[0], t[3]), min(t[1], t[2]), t


def stencil_pool(ndim, count, dtype, dev):
    """A pool of ``count`` regions for the contraction (every slot real)."""
    lows, lengths = random_pool(ndim, count, 5, getattr(torch, dtype), dev)
    gl = torch.zeros(ndim, dtype=lows.dtype, device=dev)
    gr = torch.ones(ndim, dtype=lows.dtype, device=dev)
    return lows, lengths, gl, gr


def split_frac_checks(dev, main_args, main_kw):
    """Phase 15: the split fraction in each kernel that computes it.
    The standalone ``rule_split_frac_kernel`` (``cuda_rule.split_frac``)
    against ``rule_eval.split_fraction`` at SPLIT_FRAC_CASES, values as
    rows and as planes with planted kinks and jumps
    (``kernel_check.crease_stencils``, a NaN region among them): EQUAL on
    the card and to a CPU copy, its time (``queued_ms``) beside its bytes
    bound and the plain version's.  The two scalar contractions' folded
    form at the same chunks, rows and planes (``check_contract_frac``:
    EQUAL to the standalone kernel and the plain version), each timed with
    and without the fraction in turns.  The fused kernels' folded form
    (``check_fused_frac``) on pools of the same sizes, F5 and F6, blocked
    with padding and a NaN region: tile and generic at 8D (f64, f32),
    generic at 12D; then each timed with and without the fraction in turns
    at phase 4's pool (8D, 2^21 regions, F4 and F5, f64), the tile route
    also at the main path's last pool (``main_args``, F4).  Returns the
    rows by kernel."""
    out = {"standalone": [], "contract": [], "fused_checks": [],
           "fused_times": []}
    for label, ndim, count, dtype in SPLIT_FRAC_CASES:
        vals, sd = kernel_check.crease_stencils(ndim, count, dtype,
                                                seed=15 + ndim)
        vals[3, :] = np.nan
        sd = torch.as_tensor(sd, device=dev)
        item = np.dtype(dtype).itemsize
        feval = rule_eval.rule_tables(ndim).feval
        # each region's 4 ndim + 1 stencil values and split axis read, its
        # fraction and split axis written
        nbytes = count * ((4 * ndim + 1) * item + 4 + item + 4)
        pool = stencil_pool(ndim, count, dtype, dev)
        tables = rule_eval.rule_tables(ndim, dtype)
        for layout in ("rows", "planes"):
            v = torch.as_tensor(vals, device=dev)
            if layout == "planes":
                v = v.T.contiguous().T
            try:
                r = kernel_check.check_split_frac(v, sd, ndim)
            except AssertionError as e:
                fail(f"phase 15: {label} {layout}: {e}")
            ms = queued_ms(lambda: cuda_rule.split_frac(v, sd, ndim), 5)
            plain = time_ms(lambda: rule_eval.split_fraction(v, sd, ndim), 3)
            shape = f"{label} {count} x {feval} {layout}"
            row = dict(shape=shape, ms=ms, plain_ms=plain,
                       bound_ms=bytes_bound_ms(nbytes), **r)
            out["standalone"].append(row)
            print(f"phase 15: split fraction kernel, {shape}: EQUAL "
                  f"to the plain version (card and CPU), {r['cut']} of "
                  f"{r['regions']} regions cut off the midpoint, "
                  f"{r['overrides']} split axes overridden by a jump; "
                  f"{ms:.4f} ms (queued), bound {row['bound_ms']:.4f} ms "
                  f"(bytes, {nbytes / 1e6:.3f} MB; "
                  f"{100 * row['bound_ms'] / ms:.1f} % of it), plain "
                  f"{plain:.3f} ms", flush=True)
            # the contraction reads every value and the lengths, writes
            # est, err, split_dim and the fraction
            cbytes = (count * feval * item + ndim * count * item
                      + count * (3 * item + 4))
            plain_c = time_ms(lambda: rule_eval.rule_outputs(
                v, tables, pool[1], pool[3], with_split_frac=True), 3)
            for route in cuda_rule.CONTRACT_ROUTES:
                try:
                    rc = kernel_check.check_contract_frac(v, tables, *pool,
                                                          route=route)
                except AssertionError as e:
                    fail(f"phase 15: {label} {layout} {route}: {e}")
                outs = cuda_rule.split_contract(v, tables, *pool, 0,
                                                route=route)
                outs_f = cuda_rule.split_contract(v, tables, *pool, 0,
                                                  route=route,
                                                  with_split_frac=True)
                without, with_frac, series = in_turns(
                    lambda: cuda_rule.split_contract(
                        v, tables, *pool, 0, route=route, out=outs),
                    lambda: cuda_rule.split_contract(
                        v, tables, *pool, 0, route=route, out=outs_f,
                        with_split_frac=True),
                    lambda fn: queued_ms(fn, 5))
                crow = dict(shape=shape, route=route, ms=with_frac,
                            without_ms=without, series_ms=series,
                            plain_ms=plain_c,
                            bound_ms=bytes_bound_ms(cbytes), **rc)
                out["contract"].append(crow)
                print(f"phase 15: {route} contraction with the fraction, "
                      f"{shape}: EQUAL to the standalone kernel and the "
                      f"plain version ({rc['cut']} cut, {rc['overrides']} "
                      f"overridden), est/err the bits without it; "
                      f"{with_frac:.4f} ms with, {without:.4f} ms without "
                      f"(series {', '.join(f'{x:.4f}' for x in series)}); "
                      f"bound {crow['bound_ms']:.4f} ms (bytes); plain "
                      f"rule_outputs with the fraction {plain_c:.3f} ms",
                      flush=True)
        del pool
    # the fused kernels' folded form on pools of the same sizes
    for label, ndim, count, dtype in SPLIT_FRAC_CASES:
        tdtype = getattr(torch, dtype)
        tables = rule_eval.rule_tables(ndim, dtype)
        lows, lengths = random_pool(ndim, count, 7, tdtype, dev)
        lows[:, 5] = float("nan")
        gl = torch.zeros(ndim, dtype=tdtype, device=dev)
        gr = torch.ones(ndim, dtype=tdtype, device=dev)
        routes = [r for r in cuda_rule.ROUTES
                  if r == "generic" or ndim in cuda_rule.TILE_NDIMS]
        for g in (genz.f5_c0_continuous(ndim, a=10.0, b=0.37),
                  genz.f6_discontinuous(ndim)):
            for route in routes:
                try:
                    r = kernel_check.check_fused_frac(
                        g, tables, lows, lengths, gl, gr,
                        n=count - count // 8, blocked=True, route=route)
                except AssertionError as e:
                    fail(f"phase 15: {label} {g.name} {route}: {e}")
                out["fused_checks"].append(dict(shape=label, name=g.name,
                                                route=route, **r))
                print(f"phase 15: {route} route with the fraction, {label} "
                      f"pool ({count} slots, blocked, padding, a NaN "
                      f"region), {g.name} {dtype}: fraction and split_dim "
                      f"EQUAL to the plain version on the kernel's own "
                      f"values ({r['cut']} of {r['regions']} cut, "
                      f"{r['overrides']} overridden), est/err the bits "
                      f"without it, padding 0.5; the {r['values']} kept "
                      f"values within {r['value_ulps']:.3g} ulps of their "
                      f"roundoff scale beyond rtol of the callable's (limit "
                      f"{kernel_check.ULPS['value']:g}; largest relative "
                      f"difference {r['value_rel']:.3g}), "
                      f"{r['discontinuities']} across a discontinuity "
                      "within roundoff", flush=True)
        del lows, lengths
    # the fused kernels with and without the fraction, in turns
    big = 1 << 21
    tables = rule_eval.rule_tables(NDIM, "float64")
    lows, lengths = random_pool(NDIM, big, 2, torch.float64, dev)
    gl = torch.zeros(NDIM, dtype=torch.float64, device=dev)
    gr = torch.ones(NDIM, dtype=torch.float64, device=dev)
    shapes = [(f"phase 4's pool ({big} regions)", g,
               (g, tables, lows, lengths, gl, gr), {})
              for g in (genz.f4_gaussian(NDIM),
                        genz.f5_c0_continuous(NDIM, a=10.0, b=0.37))]
    shapes.append((f"the main path's last pool ({main_kw['n']} regions)",
                   main_args[0], main_args, main_kw))
    for label, g, args, kw in shapes:
        n = kw.get("n", big)
        routes = (("tile",) if "main path" in label
                  else cuda_rule.ROUTES)
        for route in routes:
            without, with_frac, series = in_turns(
                lambda: cuda_rule.cuda_apply_rule(*args, **kw, route=route),
                lambda: cuda_rule.cuda_apply_rule(*args, **kw, route=route,
                                                  with_split_frac=True),
                lambda fn: time_ms(fn, 5 if route == "tile" else 3))
            b, by = bound_ms(g.kind, NDIM, n, torch.float64, frac=True)
            row = dict(shape=label, name=g.name, route=route, ms=with_frac,
                       without_ms=without, series_ms=series, bound_ms=b,
                       bound_by=by)
            if g.kind == 5 and route == "tile":
                row["plain_ms"] = time_ms(lambda: rule_eval.apply_rule_plain(
                    *args, chunk_size=4096, with_split_frac=True, **kw), 1)
            out["fused_times"].append(row)
            plain = (f", plain apply_rule_plain with the fraction "
                     f"{row['plain_ms']:.1f} ms" if "plain_ms" in row else "")
            print(f"phase 15: {route} route, {label}, {g.name} f64: with "
                  f"the fraction {with_frac:.3f} ms, without {without:.3f} "
                  f"ms ({100 * (with_frac / without - 1):+.2f} %; series "
                  f"{', '.join(f'{x:.3f}' for x in series)}); bound with "
                  f"the fraction {b:.3f} ms ({by}, "
                  f"{100 * b / with_frac:.1f} % of it){plain}", flush=True)
    del lows, lengths
    torch.cuda.empty_cache()
    return out


def crease_run(label, g, eps, crease, fused, ndim=NDIM, truth=None):
    """One ``Workspace(ndim).integrate(g, eps, crease_split=crease,
    fused=fused)`` with the launch counts set to 0 before and read after;
    printed.  ``truth`` None: ``g.true_value``.  Returns the result, the
    wall, the launches and the relative error."""
    truth = g.true_value if truth is None else truth
    cuda_rule.reset_launches()
    fused_loop.reset_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = Workspace(ndim).integrate(g, eps, 1e-40, crease_split=crease,
                                    fused=fused)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fused_kernel=cuda_rule.launches,
                    fused_by_route=dict(cuda_rule.route_launches),
                    fraction_by_kernel=dict(cuda_rule.frac_route_launches),
                    split_frac=cuda_rule.split_frac_launches,
                    **cuda_rule.split_launches)
    rel = abs(res.estimate - truth) / abs(truth)
    print(f"phase 16: {label} {ndim}D epsrel {eps:g}, "
          f"{'crease' if crease else 'midpoint'} splits, "
          f"{'fused' if fused else 'host loop'}: status {res.status} "
          f"estimate {res.estimate!r} truth {truth!r} rel.err "
          f"{rel:.3e} errorest/truth {res.errorest / abs(truth):.3e} "
          f"iters {res.iters} nregions {res.nregions} neval {res.neval} wall "
          f"{wall:.3f} s; launches {launches}; bursts "
          f"{dict(fused_loop.stats)}", flush=True)
    return res, wall, launches, rel


def expect_fraction_in(label, launches, kernel, eps, res, rel):
    """A crease run must certify within 3x its tolerance with every
    fraction computed by ``kernel`` (a FRAC_ROUTES name): on the fused
    route every fused launch carried it and nothing of the split route
    ran; on the split route every contraction carried it and nothing fused
    ran; never the standalone kernel."""
    if res.status != 0 or not rel <= 3 * eps:
        fail(f"{label} crease run: status {res.status}, rel.err {rel}")
    by = launches["fraction_by_kernel"]
    others = sum(v for k, v in by.items() if k != kernel)
    if kernel in cuda_rule.ROUTES:
        every = launches["fused_kernel"]
        stray = launches["points"] + launches["contract"]
    else:
        every = launches["contract"]
        stray = launches["fused_kernel"]
    if not by[kernel] or by[kernel] != every or others or stray \
            or launches["split_frac"]:
        fail(f"{label} crease run: launches {launches}; every fraction "
             f"should come from the {kernel} kernel")


def f5_axes3(x0, x1, x2):
    """Genz F5 at 3D (a = 10, b = 0.37) as a scalar-per-axis callable: its
    values come back as planes, which the generic contraction takes."""
    return torch.exp(-10.0 * (torch.abs(x0 - 0.37) + torch.abs(x1 - 0.37)
                              + torch.abs(x2 - 0.37)))


def crease_path(dev):
    """Phase 16: 8D ``f5_c0_continuous(8, a=10, b=0.37)`` (an off-grid
    kink) at F5_CREASE_EPSREL and ``f6_discontinuous(8)`` (jumps, bounds
    0.2-0.9) at F6_CREASE_EPSREL, crease against midpoint splits, the host
    loop and the fused phase.  Every crease run must certify within 3x its
    tolerance of the closed form on the fused tile route, the fraction in
    every fused launch, no split and no standalone launch; the fused
    crease run must take the host loop's decisions; its walls beside the
    split route's at commit fce39b8.  Then the fraction's other kernels on their
    paths: 8D F5 as a plain callable (the split route, the fraction in
    every cluster contraction), 2D F5 at 1e-9 (the fused generic route),
    3D F5 as a per-axis callable at 1e-8 (planes: the generic
    contraction).  Returns the fraction's launches by kernel on each
    kernel's run and the rows."""
    rows, frac_launches = [], {}
    for g, eps in ((genz.f5_c0_continuous(NDIM, a=10.0, b=0.37),
                    F5_CREASE_EPSREL),
                   (genz.f6_discontinuous(NDIM), F6_CREASE_EPSREL)):
        runs = {}
        for crease, fused in ((True, False), (True, True), (False, False),
                              (False, True)):
            runs[crease, fused] = crease_run(g.name, g, eps, crease, fused)
            res, wall, launches, rel = runs[crease, fused]
            rows.append(dict(name=g.name, ndim=NDIM, epsrel=eps,
                             crease=crease, fused=fused, status=res.status,
                             iters=res.iters, nregions=res.nregions,
                             neval=res.neval, wall_s=wall, rel_err=rel,
                             launches=launches))
            if crease:
                expect_fraction_in(f"{g.name} {'fused' if fused else 'host'}",
                                   launches, "tile", eps, res, rel)
            if crease and not fused and "tile" not in frac_launches:
                frac_launches["tile"] = launches["fraction_by_kernel"]["tile"]
        host, fusd = runs[True, False][0], runs[True, True][0]
        same = (host.status, host.iters, host.nregions, host.neval) == (
            fusd.status, fusd.iters, fusd.nregions, fusd.neval)
        mid = runs[False, False][0]
        before = SPLIT_ROUTE_CREASE_WALLS[g.name]
        print(f"phase 16: {g.name}: fused crease run "
              f"{'takes' if same else 'does NOT take'} the host loop's "
              f"decisions; crease neval {host.neval} against midpoint "
              f"{mid.neval} (status {mid.status}): "
              f"{host.neval / max(mid.neval, 1):.3f} of it; crease walls on "
              f"the fused tile route {runs[True, False][1]:.3f} s host, "
              f"{runs[True, True][1]:.3f} s fused, against the split "
              f"route's {before[0]} s and {before[1]} s at commit fce39b8 "
              f"(NVIDIA H100 80GB HBM3, 700.00 W); midpoint {runs[False, False][1]:.3f} s and "
              f"{runs[False, True][1]:.3f} s", flush=True)
        if not same:
            fail(f"{g.name}: the fused crease run differs from the host "
                 "loop's")
    g5 = genz.f5_c0_continuous(NDIM, a=10.0, b=0.37)
    g2 = genz.f5_c0_continuous(2, a=10.0, b=0.37)
    g3 = genz.f5_c0_continuous(3, a=10.0, b=0.37)
    for label, f, truth, eps, ndim, kernel in (
            ("f5_c0 as a plain callable", lambda x: g5(x), g5,
             F5_CREASE_EPSREL, NDIM, "cluster"),
            ("f5_c0", g2, g2, 1e-9, 2, "generic"),
            ("f5_c0 as a per-axis callable", f5_axes3, g3, 1e-8, 3,
             "contract_generic")):
        res, wall, launches, rel = crease_run(label, f, eps, True, False,
                                              ndim, truth.true_value)
        rows.append(dict(name=label, ndim=ndim, epsrel=eps, crease=True,
                         fused=False, status=res.status, iters=res.iters,
                         nregions=res.nregions, neval=res.neval, wall_s=wall,
                         rel_err=rel, launches=launches))
        expect_fraction_in(f"{ndim}D {label}", launches, kernel, eps, res,
                           rel)
        frac_launches[kernel] = launches["fraction_by_kernel"][kernel]
    return frac_launches, rows


def traced_run(label, g, eps, fused):
    """One ``Workspace(8).integrate`` traced by ``utils.profiling.trace``:
    its wall and the device's busy time (its kernels', copies' and
    memsets' self time) and idle share of the wall."""
    from torch.autograd import DeviceType

    from gpuintegration_torch.utils.profiling import trace
    with tempfile.TemporaryDirectory() as log_dir:
        with trace(log_dir) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = Workspace(NDIM).integrate(g, eps, 1e-40, fused=fused)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and not e.is_user_annotation]
    busy = sum(e.self_device_time_total for e in events) / 1e6
    print(f"phase 17: traced, {label}, {'fused' if fused else 'host loop'}: "
          f"status {res.status} iters {res.iters}, wall {wall:.3f} s traced, "
          f"the device busy {busy:.3f} s, idle {100 * (1 - busy / wall):.1f} "
          f"% of the wall", flush=True)
    return {"wall_s": wall, "busy_s": busy, "idle": 1 - busy / wall}


def fused_vs_host(label, run_fused, host, host_wall, rtol):
    """A fused run (``run_fused()``, counts set to 0 before) against a
    host-loop result: the same status, iterations, regions and neval;
    estimates within ``rtol``.  Returns the result, wall and phase
    stats."""
    cuda_rule.reset_launches()
    fused_loop.reset_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_fused()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = dict(fused_loop.stats)
    exits = list(fused_loop.exits)
    est = np.atleast_1d(res.estimates if res.estimates is not None
                        else res.estimate)
    ref = np.atleast_1d(host.estimates if host.estimates is not None
                        else host.estimate)
    same = (res.status, res.iters, res.nregions, res.neval) == (
        host.status, host.iters, host.nregions, host.neval)
    drift = float(np.max(np.abs(est - ref) / np.abs(ref)))
    print(f"phase 17: {label}: fused status {res.status} iters {res.iters} "
          f"nregions {res.nregions} neval {res.neval} wall {wall:.3f} s; "
          f"host loop status {host.status} iters {host.iters} nregions "
          f"{host.nregions} neval {host.neval} wall {host_wall:.3f} s; "
          f"{'the same decisions' if same else 'DIFFERENT decisions'}, "
          f"estimates {drift:.3e} apart (relative); bursts {st['bursts']}, "
          f"eager iterations {st['eager']}, graph captures "
          f"{st['captures']}, replays {st['replays']}, packed reads "
          f"{st['reads']}, exits {exits}; wrapper launches: rule kernel "
          f"{cuda_rule.launches}, split {dict(cuda_rule.split_launches)} "
          f"(a replay relaunches what its capture recorded)", flush=True)
    if not same or not drift <= rtol or st["bursts"] == 0:
        fail(f"{label}: the fused run differs from the host loop's "
             f"(same decisions {same}, drift {drift}, stats {st})")
    return res, wall, st


# phase 17 runs phase 11's split-route path to this depth only (the whole
# run, 30 iterations, is phase 11's; its last 13 iterations classify pools
# of 9-15M regions through the callable, most of its 50 s): the fused
# phase's bursts and gate crossing lie before it
SPLIT_FUSED_ITERS = 16


def fused_main_path(dev, tile_run, vec_run):
    """Phase 17: phase 3's main path (8D F4 at 1e-3, f64) with the fused
    phase against the host loop, in turns (host, fused, fused, host), each
    fused run's bursts, captures, replays and packed reads, and one run of
    each traced for the device's idle share; then phase 13's 8D vector
    through the fused phase against that phase's host-loop run
    (``vec_run``: (result, wall)), and phase 11's F4 callable (the split
    route) cut to its first SPLIT_FUSED_ITERS iterations, fused against
    its host loop at the same cut."""
    g4 = genz.f4_gaussian(NDIM)
    walls = {"host": [], "fused": []}
    stats = fused_run = None
    for fused in (False, True, True, False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if fused:
            res, wall, stats = fused_vs_host(
                f"f64 {NDIM}D F4 at 1e-3 (phase 3)",
                lambda: Workspace(NDIM).integrate(g4, 1e-3, 1e-40),
                tile_run, min(walls["host"]), 1e-12)
            fused_run = fused_run or res
        else:
            res = Workspace(NDIM).integrate(g4, 1e-3, 1e-40, **HOST)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        walls["fused" if fused else "host"].append(wall)
    print(f"phase 17: F4 8D at 1e-3 walls in turns: host "
          f"{walls['host'][0]:.3f} s, fused {walls['fused'][0]:.3f} s, fused "
          f"{walls['fused'][1]:.3f} s, host {walls['host'][1]:.3f} s",
          flush=True)
    idle = {mode: traced_run("F4 8D at 1e-3", g4, 1e-3, mode == "fused")
            for mode in ("host", "fused")}
    f, _ = vector_probe.vector(vector_probe.members("moderate"))
    _, vec_wall, vec_stats = fused_vs_host(
        "f64 8D vector of four Genz members (phase 13)",
        lambda: Workspace(NDIM).integrate(f, VEC8_EPSREL, 1e-40),
        *vec_run, 1e-10)
    cut = {"max_iterations": SPLIT_FUSED_ITERS}
    t0 = time.perf_counter()
    split_host = Workspace(NDIM).integrate(f4_plain, 1e-3, 1e-40, **cut,
                                           **HOST)
    torch.cuda.synchronize()
    _, split_wall, split_stats = fused_vs_host(
        f"f64 8D F4 as a plain callable (phase 11, the split route), its "
        f"first {SPLIT_FUSED_ITERS} iterations",
        lambda: Workspace(NDIM).integrate(f4_plain, 1e-3, 1e-40, **cut),
        split_host, time.perf_counter() - t0, 1e-10)
    return {"f4_walls_s": walls, "f4_stats": stats, "idle": idle,
            "f4_fused_run": fused_run,
            "vector_fused_wall_s": vec_wall, "vector_stats": vec_stats,
            "split_fused_wall_s": split_wall, "split_stats": split_stats}


def folded_fraction_kernels(frac_rows, frac_launches, crease_rows,
                            fused_rows):
    """The kernels line's entries of the split fraction's folded forms:
    the fused tile and generic kernels with the fraction (timed at phase
    4's pool, F5 f64), the cluster and generic contractions with it (timed
    at the Workspace's 8D f64 chunk, values as rows and as planes: the
    layouts that take each route on a run); launches on each kernel's
    phase 16 run."""
    fused = {r["route"]: r for r in frac_rows["fused_times"]
             if r["name"] == "f5_c0" and "main path" not in r["shape"]}
    contract = {r["route"]: r for r in frac_rows["contract"]
                if r["shape"].startswith("8D f64")
                and r["shape"].endswith("rows" if r["route"] == "cluster"
                                        else "planes")}
    plain = fused["tile"]["plain_ms"]
    entries = []
    for kernel, route, source, row, held in (
            ("rule_tile_kernel+split_fraction", "tile", "rule_eval.cu",
             fused["tile"], "check_fused_frac"),
            ("rule_generic_kernel+split_fraction", "generic", "rule_eval.cu",
             fused["generic"], "check_fused_frac"),
            ("rule_contract_cluster_kernel+split_fraction", "cluster",
             "rule_split.cu", contract["cluster"], "check_contract_frac"),
            ("rule_contract_kernel+split_fraction", "contract_generic",
             "rule_split.cu", contract["generic"], "check_contract_frac")):
        entries.append({
            "name": kernel,
            "route": "cuda",
            "source": f"gpuintegration_torch/csrc/{source} with "
                      "gpuintegration_torch/csrc/split_frac.cuh",
            "replaces": "gpuintegration_tpu/ops/pallas_rule.py:86",
            "counterpart_of": "gpuintegration_tpu/ops/rule_eval.py:184 "
                              "(_split_fraction, XLA in the reference)",
            "held_against_plain_in": f"phase 15 (kernel_check.{held}: "
                                     "EQUAL to rule_eval.split_fraction on "
                                     "the kernel's values)",
            "launches": frac_launches[route],
            "max_abs_err": 0.0,
            "ms": row["ms"],
            "without_fraction_ms": row["without_ms"],
            "series_ms": row["series_ms"],
            "plain_ms": row.get("plain_ms", plain),
            "bound_ms": row["bound_ms"],
            "bound_by": row.get("bound_by", "bytes"),
            "library_ms": None,
            "shape": f"{row['shape']} {row.get('name', '')}".strip(),
        })
    entries[0]["crease_runs"] = crease_rows
    entries[0]["main_path_pool"] = [r for r in frac_rows["fused_times"]
                                    if "main path" in r["shape"]]
    entries[0]["fused_phase"] = fused_rows
    return entries

# ---------------------------------------------------------------------------
# VEGAS's device-resident phases and vegas_assisted (phases 18-19)

# VEGAS runs 1-3 of phase 6 (6D Genz F4, a = 25, epsabs 1e-40)
VEGAS_RUNS = {
    "run1": dict(epsrel=1e-3, ncall=1e8),
    "run2": dict(epsrel=1e-3, ncall=1e9, eval_dtype=torch.float32,
                 total_iters=10, adjust_iters=5),
    "run3": dict(epsrel=1e-3, ncall=1e8, importance="grid"),
}
# the same with 3 adjusting iterations: at the default of 15, runs 1 and 3
# converge while adjusting, and with run 2's 5 every run converges in the
# first frozen iteration (iteration 6, the first that may), before any
# replay
FROZEN_RUNS = {run: dict(kw, adjust_iters=3) for run, kw in VEGAS_RUNS.items()}
# the same with a long frozen phase that runs to its end (the length
# simple_integrate's escalations reach): where a graph may pay
LONG_FROZEN = 30
LONG_RUNS = {run: dict(kw, epsrel=1e-9, adjust_iters=3,
                       total_iters=3 + LONG_FROZEN)
             for run, kw in VEGAS_RUNS.items()}
# phases.FORM of each form measured: the host loop, the phase as it
# chooses, eager and replayed
FORMS = {"host": "host", "auto": None, "eager": "eager", "graph": "graph"}
# 8D vegas_assisted (F4, a = 25) certifies at none of 1e-1 .. 1e-3 within
# 60 s on an H100 (tools/assisted_probe.py): its errorest stays near the
# truth, so a statistical hold there holds nothing.  The 8D run is printed
# at 1e-2 for an iteration budget; the hold is the card's sampling pass
# against the CPU's on its pool, and the statistics are held on 3D F4 at
# a = 5 and 1e-2, which certifies.
ASSIST_EPSREL = 1e-2
ASSIST_ITERS = 11
ASSIST_REGIONS = 256          # the 8D initial pool, held card against CPU
# the sampling pass's weighted values, relative: exp's f64 roundoff at
# arguments up to 1250 is 3e-13
ASSIST_RTOL = 1e-12
# its refined edges: the cumulative sums' f32 roundoff, which the rebin
# scales by total / r_k (3.0e-5 the most on an H100)
ASSIST_EDGE = 1e-4
ASSIST_HELD = dict(ndim=3, a=5.0, epsrel=1e-2)


def counter_checks(dev):
    """Phase 5: the sampler and the bin resolve reading the iteration word
    from a device counter as a replayed graph does: one launch on a counter
    captured in a CUDA graph, replayed at two iterations, EQUAL
    (torch.equal) to launches given them as host integers: the sampler at
    phase 5's chunks (6D, 2^20 cubes, the lattice's end and the centre;
    emit and fused F4, with and without the histogram, paired route) and at
    9D (generic route); the bin resolve at phase 7's chunk on the sample
    route and on the generic route."""
    g4 = genz.f4_gaussian(VEGAS_NDIM)
    n = 0
    try:
        for position in ("end", "middle"):
            case = vegas_check.sampler_case(VEGAS_NDIM, 1e8, VEGAS_CHUNK,
                                            position=position, device=dev)
            for with_hist in (False, True):
                for integrand in (None, g4):
                    n += vegas_check.check_sampler_counter(
                        case, integrand, with_hist=with_hist,
                        route="paired")["samples"]
            vegas_check.check_resolve_counter(VEGAS_NDIM, 1e8, VEGAS_CHUNK,
                                              500, position=position)
        case9 = vegas_check.sampler_case(9, 1e6, 4096, nbins=50, degree=8,
                                         device=dev)
        vegas_check.check_sampler_counter(case9, None, with_hist=True,
                                          route="generic")
        vegas_check.check_resolve_counter(VEGAS_NDIM, 1e8, 1 << 16, 500,
                                          route="generic")
        for ndim, cubes in WIDE_RESOLVE_SHAPES[:3]:
            vegas_check.check_resolve_counter(ndim, 1e9, cubes, 500,
                                              route="wide")
    except AssertionError as e:
        fail(str(e))
    print(f"phase 5: device counter: the sampler (paired, {n} samples; "
          f"generic at 9D) and the bin resolve (sample and generic at 6D, "
          f"wide at 9, 12 and 16D on the 1e9 runs' chunks past the "
          f"lattice's end) replayed from a graph at two iterations EQUAL to "
          f"launches given them as host integers", flush=True)


def vegas_registers() -> dict[str, int]:
    """{'kernel<template arguments>': registers} of vegas_sample.cu's and
    vegas_lookup.cu's kernels from nvcc's report
    (``route_bits.ptxas_kernels``)."""
    regs = {}
    for source in ("vegas_sample.cu", "vegas_lookup.cu"):
        log = cuda_build._target(source).with_suffix(".log").read_text()
        regs.update({name: r for name, (r, _, _) in
                     route_bits.ptxas_kernels(log).items()})
    return regs


def vegas_traced(label, kw, form):
    """One VEGAS run in ``form`` traced by ``utils.profiling.trace``: its
    wall, the device's busy time (kernels', copies' and memsets' self time)
    and idle share of the wall."""
    from torch.autograd import DeviceType

    from gpuintegration_torch.utils.profiling import trace
    g6 = genz.f4_gaussian(VEGAS_NDIM)
    vegas_phases.FORM = FORMS[form]
    try:
        with tempfile.TemporaryDirectory() as log_dir:
            with trace(log_dir) as prof:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                mcubes.integrate(g6, epsabs=1e-40, **kw)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            events = [e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and not e.is_user_annotation]
    finally:
        vegas_phases.FORM = None
    busy = sum(e.self_device_time_total for e in events) / 1e6
    print(f"phase 18: traced, {label}: wall {wall:.4f} s traced, the device "
          f"busy {busy:.4f} s, idle {100 * (1 - busy / wall):.1f} % of the "
          f"wall", flush=True)
    return {"wall_s": wall, "busy_s": busy, "idle": 1 - busy / wall}


def vegas_phase_run(kw, form=None):
    """One VEGAS run (6D F4, a = 25) in ``form`` (``FORMS``) with the
    launch counts set to 0 before and read after, and the phases' stats:
    (result, wall, counts, stats)."""
    g6 = genz.f4_gaussian(VEGAS_NDIM)
    vegas_phases.reset_stats()
    vegas_phases.FORM = FORMS[form or "auto"]
    torch.cuda.synchronize()
    try:
        with LaunchCounts() as clock:
            t0 = time.perf_counter()
            res = mcubes.integrate(g6, epsabs=1e-40, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        vegas_phases.FORM = None
    return res, wall, clock, dict(vegas_phases.stats)


def _bits(r):
    return (r.status, r.iters, r.neval, r.estimate, r.errorest, r.chi_sq)


def vegas_forms(run, kw, captures, order, traced=()):
    """``run`` in each form of ``captures`` ({form: the captures it must
    make}) in turns (``order``, each form twice): every form the host
    loop's status, iterations, neval, estimate, errorest and chi^2 bits and
    launch counts (a capture counts nothing, a replay what it recorded);
    walls; the phases' stats; the forms of ``traced`` traced once for the
    device's idle share.  Returns the row."""
    forms = tuple(captures)
    walls = {f: [] for f in forms}
    got = {}
    for form in order:
        res, wall, clock, st = vegas_phase_run(kw, form)
        walls[form].append(wall)
        got[form] = (res, clock.launches, st)
    host, host_launches, _ = got["host"]
    row = {"iters": host.iters, "launches": host_launches, "forms": {}}
    for form in forms:
        res, launches, st = got[form]
        same = _bits(res) == _bits(host) and launches == host_launches
        print(f"phase 18: {run} {form}: status {res.status} iters "
              f"{res.iters} neval {res.neval} estimate {res.estimate!r}: "
              f"{'the host loop bits and launches' if same else 'DIFFERENT'}"
              f" (launches {launches}, host {host_launches}); walls "
              f"{', '.join(f'{w:.4f}' for w in walls[form])} s; phase "
              f"captures {st['captures']}, replays {st['replays']}, eager "
              f"{st['eager']}, reads {st['reads']}; seconds: first iteration "
              f"{st['first_s']:.4f}, capture {st['capture_s']:.4f}, the rest "
              f"{st['rest_s']:.4f}", flush=True)
        if not same or st["captures"] != captures[form]:
            fail(f"{run} {form}: differs from the host loop or made "
                 f"{st['captures']} captures, not {captures[form]} "
                 f"({_bits(res)} against {_bits(host)}, launches "
                 f"{launches} against {host_launches}, stats {st})")
        row["forms"][form] = {"walls_s": walls[form], "stats": st}
        if form in traced:
            row["forms"][form]["idle"] = vegas_traced(f"{run} {form}", kw,
                                                      form)
    return row


def vegas_device_phases(dev):
    """Phase 18: VEGAS runs 1-3 with 3 adjusting iterations
    (``FROZEN_RUNS``; a frozen phase of a few iterations) in the host loop,
    the form the phase chooses (eager: no capture) and the graph in turns
    (host, auto, graph, graph, auto, host; the host loop and the choice
    traced), then with a frozen phase of ``LONG_FROZEN`` iterations
    (``LONG_RUNS``) in the host loop, eager and as the phase chooses (the
    graph: one capture; run 1's traced): every form the host loop's bits
    and launch counts, walls, stats, the seconds a replay saves against an
    eager iteration and the iterations that repay a capture.  Then ``refine='device'`` (the form it
    chooses) against ``refine='host'`` in turns on runs 1-3: status 0, the
    truth within 5 errorests, errorest/|est| <= epsrel; and once replayed,
    the eager run's bits.  Returns the rows."""
    g6 = genz.f4_gaussian(VEGAS_NDIM)
    rows = {}
    for run, kw in FROZEN_RUNS.items():
        rows[run] = {"short": vegas_forms(
            run, kw, {"host": 0, "auto": 0, "graph": 1},
            ("host", "auto", "graph", "graph", "auto", "host"),
            traced=("host", "auto"))}
    for run, kw in LONG_RUNS.items():
        row = vegas_forms(f"{run} long", kw, {"host": 0, "eager": 0, "auto": 1},
                          ("host", "eager", "auto", "auto", "eager", "host"),
                          traced=("host", "eager", "auto") if run == "run1"
                          else ())
        eager, graph = row["forms"]["eager"], row["forms"]["auto"]
        per_eager = eager["stats"]["rest_s"] / (LONG_FROZEN - 1)
        per_replay = graph["stats"]["rest_s"] / (LONG_FROZEN - 1)
        capture = graph["stats"]["capture_s"]
        saved = per_eager - per_replay
        repay = capture / saved if saved > 0 else math.inf
        best = {f: min(v["walls_s"]) for f, v in row["forms"].items()}
        print(f"phase 18: {run} long: an iteration after the first "
              f"{per_eager:.5f} s eager, {per_replay:.5f} s replayed, saved "
              f"{saved:.5f} s; capture {capture:.4f} s = "
              f"{repay:.1f} replays (phases.GRAPH_MIN_ITERS "
              f"{vegas_phases.GRAPH_MIN_ITERS}); best walls host "
              f"{best['host']:.4f}, eager {best['eager']:.4f}, graph (auto) "
              f"{best['auto']:.4f} s", flush=True)
        row.update(per_eager_s=per_eager, per_replay_s=per_replay,
                   capture_s=capture, repay_iters=repay, best_walls_s=best)
        rows[run]["long"] = row
    for run, kw in VEGAS_RUNS.items():
        walls = {"host": [], "device": []}
        got = {}
        for refine in ("host", "device", "device", "host"):
            res, wall, clock, st = vegas_phase_run(dict(kw, refine=refine))
            walls[refine].append(wall)
            got[refine] = (res, clock, st)
        replayed, wall_g, _, st_g = vegas_phase_run(dict(kw, refine="device"),
                                                    "graph")
        for refine in ("device", "host"):
            res, clock, st = got[refine]
            pull = abs(res.estimate - g6.true_value) / res.errorest
            rel = res.errorest / abs(res.estimate)
            print(f"phase 18: {run} refine={refine!r}: status {res.status} "
                  f"estimate {res.estimate!r} errorest {res.errorest!r} pull "
                  f"{pull:.3f} errorest/|est| {rel:.3e} iters {res.iters} "
                  f"neval {res.neval} walls {walls[refine][0]:.4f}, "
                  f"{walls[refine][1]:.4f} s; phases {st}; launches "
                  f"{clock.launches}", flush=True)
            if refine == "device" and (res.status != 0 or not pull <= 5.0
                                       or not rel <= kw["epsrel"]):
                fail(f"{run} refine='device': status {res.status}, pull "
                     f"{pull}, errorest/|est| {rel}, stats {st}")
        same = _bits(replayed) == _bits(got["device"][0])
        print(f"phase 18: {run} refine='device' replayed: "
              f"{'the eager bits' if same else 'DIFFERENT'}, wall "
              f"{wall_g:.4f} s, phases {st_g}", flush=True)
        if not same or st_g["captures"] < 1:
            fail(f"{run} refine='device' replayed: {_bits(replayed)} "
                 f"against {_bits(got['device'][0])}, stats {st_g}")
        rows[run]["refine"] = {
            "walls_s": walls, "replayed_wall_s": wall_g,
            "device": {"status": got["device"][0].status,
                       "iters": got["device"][0].iters,
                       "estimate": got["device"][0].estimate,
                       "errorest": got["device"][0].errorest}}
    return rows


def assisted_slice(dev):
    """Phase 19: the in-region sampling pass on the card against the CPU
    on the 8D initial pool (``ASSIST_REGIONS`` regions), each of one
    iteration's 10 passes given the same grids (the CPU's, carried from
    pass to pass) and the same draws (bitwise the same on both): the
    sample points EQUAL, the weighted values within ``ASSIST_RTOL``
    relative, the refined edges within ``ASSIST_EDGE``.  Whole passes
    chained on each side are not comparable: on this peaked integrand the
    adaptation is chaotic, and a one-ulp change of the edges grows to
    whole bins within four passes."""
    from gpuintegration_torch.pagani import vegas_assisted as assisted
    g8 = genz.f4_gaussian(NDIM)
    lows, lengths, _ = region_pool.uniform_split(NDIM, 2, ASSIST_REGIONS)
    ids = torch.arange(ASSIST_REGIONS)
    f64 = torch.float64
    lo_hi = (torch.zeros(NDIM, dtype=f64), torch.ones(NDIM, dtype=f64))
    grids = assisted.uniform_grids(ASSIST_REGIONS, NDIM, assisted.NBINS,
                                   "cpu")
    worst = {"wf": 0.0, "edge": 0.0, "points_equal": True}
    for p in range(10):
        draws = assisted.region_draws(0, 1, p, ids, 320, NDIM)
        u, wf, new = assisted._sample_regions_pass(
            g8, draws, grids, lows, lengths, *lo_hi, assisted.NBINS, f64)
        on_card = assisted._sample_regions_pass(
            g8, assisted.region_draws(0, 1, p, ids.to(dev), 320, NDIM),
            grids.to(dev), lows.to(dev), lengths.to(dev),
            *(t.to(dev) for t in lo_hi), assisted.NBINS, f64)
        uc, wfc, newc = (t.cpu() for t in on_card)
        worst["points_equal"] &= torch.equal(u, uc)
        worst["wf"] = max(worst["wf"], float(torch.max(
            torch.abs(wfc - wf) / torch.clamp(torch.abs(wf), min=1e-300))))
        worst["edge"] = max(worst["edge"], float(torch.max(
            torch.abs(newc - new))))
        grids = new
    print(f"phase 19: the sampling pass, 10 passes of one iteration on the "
          f"8D initial pool ({ASSIST_REGIONS} regions, 320 samples), card "
          f"against CPU on the same grids and draws: points "
          f"{'EQUAL' if worst['points_equal'] else 'DIFFERENT'}, weighted "
          f"values within {worst['wf']:.3e} relative (held to "
          f"{ASSIST_RTOL:g}), refined edges within {worst['edge']:.3e} (held "
          f"to {ASSIST_EDGE:g})", flush=True)
    if (not worst["points_equal"] or not worst["wf"] <= ASSIST_RTOL
            or not worst["edge"] <= ASSIST_EDGE):
        fail(f"the sampling pass: card and CPU differ ({worst})")
    return worst


def assisted_path(dev):
    """Phase 19: the sampling pass on the card against the CPU on the 8D
    pool (``assisted_slice``); ``Workspace(3).integrate(f4_gaussian(3,
    a=5), 1e-2, vegas_assisted=True)``: status 0, the truth within 5
    errorests and within the tolerance; then 8D at ``ASSIST_EPSREL`` for
    ``ASSIST_ITERS`` iterations, printed (it certifies at no tolerance
    within reach), with every rule evaluation through the tile route (the
    rule keeps the split axes; counts set to 0 before, read after) and the
    share of the wall in the in-region sampling passes (synchronised around
    each call)."""
    row = {"slice": assisted_slice(dev)}
    g4 = genz.f4_gaussian(ASSIST_HELD["ndim"], a=ASSIST_HELD["a"])
    t0 = time.perf_counter()
    r4 = Workspace(ASSIST_HELD["ndim"]).integrate(
        g4, ASSIST_HELD["epsrel"], 1e-40, vegas_assisted=True)
    wall4 = time.perf_counter() - t0
    pull4 = abs(r4.estimate - g4.true_value) / r4.errorest
    rel4 = abs(r4.estimate - g4.true_value) / g4.true_value
    print(f"phase 19: f64 {ASSIST_HELD['ndim']}D f4_gaussian vegas_assisted "
          f"(a = {ASSIST_HELD['a']:g}) at {ASSIST_HELD['epsrel']:g}: status "
          f"{r4.status} estimate "
          f"{r4.estimate!r} errorest {r4.errorest!r} (errorest/truth "
          f"{r4.errorest / g4.true_value:.3e}) rel.err {rel4:.3e} pull "
          f"{pull4:.3f} iters {r4.iters} nregions {r4.nregions} wall "
          f"{wall4:.3f} s", flush=True)
    if (r4.status != 0 or not pull4 <= 5.0
            or not rel4 <= ASSIST_HELD["epsrel"]):
        fail(f"vegas_assisted {ASSIST_HELD['ndim']}D: status {r4.status}, "
             f"pull {pull4}, rel.err {rel4}")
    row["held"] = {"ndim": ASSIST_HELD["ndim"], "status": r4.status,
                   "pull": pull4, "rel_err": rel4, "iters": r4.iters,
                   "wall_s": wall4}
    g8 = genz.f4_gaussian(NDIM)
    cuda_rule.reset_launches()
    res, wall, sampling, calls = assisted_probe.run(
        g8, ASSIST_EPSREL, max_iterations=ASSIST_ITERS)
    rel = abs(res.estimate - g8.true_value) / g8.true_value
    share = sampling / wall
    routes = dict(cuda_rule.route_launches)
    print(f"phase 19: f64 8D f4_gaussian vegas_assisted at {ASSIST_EPSREL:g}, "
          f"{ASSIST_ITERS} iterations at most: status {res.status} estimate "
          f"{res.estimate!r} errorest {res.errorest!r} (errorest/truth "
          f"{res.errorest / g8.true_value:.3e}) truth {g8.true_value!r} "
          f"rel.err {rel:.3e} iters {res.iters} nregions {res.nregions} "
          f"neval {res.neval} wall {wall:.3f} s, the sampling passes "
          f"{sampling:.3f} s = {100 * share:.1f}% of it over {calls} "
          f"iterations; rule kernel launches {cuda_rule.launches} (by route "
          f"{routes})", flush=True)
    if (not math.isfinite(res.estimate) or not math.isfinite(res.errorest)
            or cuda_rule.launches == 0
            or routes["tile"] != cuda_rule.launches):
        fail(f"vegas_assisted 8D: estimate {res.estimate}, errorest "
             f"{res.errorest}, rule launches {cuda_rule.launches} by route "
             f"{routes}")
    row.update(status=res.status, iters=res.iters,
               errorest_over_truth=res.errorest / g8.true_value,
               rel_err=rel, nregions=res.nregions, wall_s=wall,
               sampling_share=share, rule_launches=cuda_rule.launches)
    return row


# ---------------------------------------------------------------------------
# The rest of the PAGANI surface, interpolation, 1-D quadrature (20-23)

ONESHOT_REGIONS = 1 << 21        # phase 4's pool
CAPTURE_REGIONS = 1024           # capture_func_evals' cap
HEURISTIC_IDS = (0, 1, 2, 4, 7, 8, 9, 10)
VECTOR_TOTAL_RTOL = 1e-10        # a component's total against its scalar run


def b1_counts() -> dict:
    """B1's launches since the last reset: the fused kernels by route, the
    split route's points and contractions, the contractions by route."""
    return {"fused": cuda_rule.launches,
            "fused_by_route": dict(cuda_rule.route_launches),
            "split": dict(cuda_rule.split_launches),
            "contract_by_route": {k: v for k, v in
                                  cuda_rule.contract_route_launches.items()
                                  if v}}


def oneshot_path(dev):
    """Phase 20: ``oneshot.apply_cubature_rules`` on phase 4's 2^21 random
    8D sub-regions, F4 (a Genz family: the tile route) and F4 as a plain
    callable (the split route), both held against ``apply_rule_plain`` on
    the card (``kernel_check.check_outputs_against_plain``); a four-member
    vector through ``apply_cubature_rules_vector`` (the components
    contraction), each component's total against its member's tile-route
    one-shot total; ``classify_with_heuristic`` for every policy id, the
    card EQUAL to the CPU on the same est/err; ``capture_func_evals`` on
    1024 regions, points EQUAL to the CPU's.  Counts set to 0 before and
    read after each entry point.  Returns B1's launches by entry point."""
    f64 = torch.float64
    g4 = genz.f4_gaussian(NDIM)
    tables = rule_eval.rule_tables(NDIM, "float64")
    lows, lengths = random_pool(NDIM, ONESHOT_REGIONS, 2, f64, dev)
    gl = torch.zeros(NDIM, dtype=f64, device=dev)
    gr = torch.ones(NDIM, dtype=f64, device=dev)
    counts, outs, walls = {}, {}, {}
    # the split route twice: its first run in a process pays set-up costs
    # of its own (PERF.md section 7), the second is the warm wall
    for label, f in (("tile", g4), ("split", f4_plain),
                     ("split again", f4_plain)):
        torch.cuda.synchronize()
        cuda_rule.reset_launches()
        t0 = time.perf_counter()
        res, est, err, sdim = oneshot.apply_cubature_rules(
            f, lows, lengths, ndim=NDIM, device=dev)
        torch.cuda.synchronize()
        walls[label] = time.perf_counter() - t0
        counts[label] = b1_counts()
        outs[label] = (res, (est, err, sdim))
        print(f"phase 20: apply_cubature_rules, F4 {NDIM}D "
              f"{'(a Genz family)' if label == 'tile' else 'as a plain callable'}"
              f"{', again' if label == 'split again' else ''}"
              f", {ONESHOT_REGIONS} regions: estimate {res.estimate!r} "
              f"errorest {res.errorest!r} neval {res.neval} wall "
              f"{walls[label]:.3f} s; B1 launches {counts[label]}",
              flush=True)
    tile_c, split_c = counts["tile"], counts["split"]
    if (tile_c["fused"] == 0 or tile_c["fused_by_route"]["tile"]
            != tile_c["fused"] or tile_c["split"]["points"]):
        fail(f"phase 20: the Genz one-shot should take the tile route only "
             f"({tile_c})")
    if (split_c["fused"] or split_c["split"]["points"] == 0
            or split_c["split"]["points"] != split_c["split"]["contract"]):
        fail(f"phase 20: the callable's one-shot should take the split route "
             f"only ({split_c})")
    t0 = time.perf_counter()
    try:
        held = kernel_check.check_outputs_against_plain(
            {k: outs[k][1] for k in ("tile", "split")}, g4, tables, lows,
            lengths, gl, gr)
    except AssertionError as e:
        fail(f"phase 20: {e}")
    for label, r in held.items():
        print(f"phase 20: {label} route's one-shot against apply_rule_plain "
              f"on the card ({r['regions']} regions): est {r['est_ulps']:.3g}"
              f", err {r['err_ulps']:.3g} ulps beyond rtol (limits "
              f"{kernel_check.ULPS['est']:g}/{kernel_check.ULPS['err']:g}), "
              f"split_dim agree {r['agree']:.6f} ({r['mismatches']} "
              f"near-ties); held in {time.perf_counter() - t0:.1f} s",
              flush=True)
    rel_ts = abs(outs["split"][0].estimate - outs["tile"][0].estimate) / abs(
        outs["tile"][0].estimate)
    again = outs["split again"][1]
    same = all(torch.equal(a, b) for a, b in zip(again, outs["split"][1]))
    print(f"phase 20: the two routes' totals differ by {rel_ts:.3e} "
          f"relative; the split route again: the same bits "
          f"{'yes' if same else 'NO'}", flush=True)
    del outs["split again"]
    if not rel_ts <= 1e-12 or not same:
        fail(f"phase 20: tile and split totals differ by {rel_ts}, or the "
             f"split route repeated gave other bits")

    members = vector_probe.members("moderate")
    fv, _ = vector_probe.vector(members)
    torch.cuda.synchronize()
    cuda_rule.reset_launches()
    t0 = time.perf_counter()
    totals, per = oneshot.apply_cubature_rules_vector(
        fv, lows, lengths, ndim=NDIM, ncomp=len(members), device=dev)
    walls["vector"] = time.perf_counter() - t0
    counts["vector"] = vec_c = b1_counts()
    comp = sum(vec_c["contract_by_route"].get(r, 0)
               for r in cuda_rule.VECTOR_ROUTES)
    if (vec_c["fused"] or vec_c["split"]["points"] == 0
            or comp != vec_c["split"]["points"]):
        fail(f"phase 20: the vector one-shot should take the components "
             f"contraction ({vec_c})")
    worst = 0.0
    for k, m in enumerate(members):
        r = oneshot.apply_cubature_rules(m, lows, lengths, device=dev)[0]
        worst = max(worst, abs(totals[k] - r.estimate) / abs(r.estimate))
    print(f"phase 20: apply_cubature_rules_vector, 4 members (F1 1/2, F2 a=5,"
          f" F4 a=5, F5) at {NDIM}D on the same pool: totals {totals!r}, per "
          f"region {per.shape}, wall {walls['vector']:.3f} s; against each "
          f"member's tile-route total: {worst:.3e} relative at most (held to "
          f"{VECTOR_TOTAL_RTOL:g}); B1 launches {vec_c}", flush=True)
    if not worst <= VECTOR_TOTAL_RTOL:
        fail(f"phase 20: the vector's totals differ by {worst}")

    est, err = outs["tile"][1][0], outs["tile"][1][1]
    est_h, err_h = est.cpu(), err.cpu()
    verdicts = {}
    t0 = time.perf_counter()
    for hid in HEURISTIC_IDS:
        card = oneshot.classify_with_heuristic(hid, est, err, 1e-3, depth=3)
        host = oneshot.classify_with_heuristic(hid, est_h, err_h, 1e-3,
                                               depth=3)
        verdicts[hid] = (int(host.sum()), torch.equal(card.cpu(), host))
    print(f"phase 20: classify_with_heuristic on the {ONESHOT_REGIONS} "
          f"regions, epsrel 1e-3, depth 3, card against CPU: (finished, "
          f"EQUAL) by policy id {verdicts} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    if not all(eq for _, eq in verdicts.values()):
        fail(f"phase 20: heuristic verdicts differ on the card ({verdicts})")

    lo = lows[:, :CAPTURE_REGIONS].T.cpu().numpy()
    ln = lengths[:, :CAPTURE_REGIONS].T.cpu().numpy()
    t0 = time.perf_counter()
    cap_card = oneshot.capture_func_evals(g4, lo, ln, device=dev)
    walls["capture"] = time.perf_counter() - t0
    cap_host = oneshot.capture_func_evals(g4, lo, ln, device="cpu")
    vrel = float(np.max(np.abs(cap_card.values - cap_host.values)
                        / np.maximum(np.abs(cap_host.values), 1e-300)))
    csv = io.StringIO()
    oneshot.FuncEvals(cap_card.points[:2], cap_card.values[:2],
                      cap_card.region_lows[:2],
                      cap_card.region_lengths[:2]).to_csv(csv)
    lines = csv.getvalue().splitlines()
    print(f"phase 20: capture_func_evals on {CAPTURE_REGIONS} regions: points"
          f" {cap_card.points.shape} "
          f"{'EQUAL' if np.array_equal(cap_card.points, cap_host.points) else 'DIFFERENT'}"
          f" to the CPU's, values within {vrel:.3e} relative, wall "
          f"{walls['capture']:.3f} s; to_csv of two regions: {len(lines)} "
          f"lines", flush=True)
    if (not np.array_equal(cap_card.points, cap_host.points)
            or not vrel <= 1e-12 or len(lines) != 1 + 2 * tables.feval):
        fail("phase 20: capture_func_evals differs between card and CPU")
    return counts, walls


INTERP_POINTS = 1 << 24
PHYSICS_EPSREL = 3e-4
PHYSICS_VEGAS = dict(epsrel=2e-3, ncall=2e5, total_iters=12, adjust_iters=8,
                     seed=5)
F32_TABLE_RTOL = 1e-6


def interp_tables(rng):
    """A 1D table of 4096 knots, the physics HMF table (64 x 32) and a 3D
    table of 64 x 48 x 32, uneven knots, smooth sign-changing values."""
    def knots(n, lo, hi):
        s = rng.uniform(0.2, 1.8, n - 1)
        return lo + (hi - lo) * np.concatenate([[0.0], np.cumsum(s)]) / s.sum()

    xs1 = knots(4096, -1.0, 2.0)
    one = (xs1, np.sin(3.0 * xs1))
    h = physics.make_hmf_table(device="cpu")
    two = (h.xs.numpy(), h.ys.numpy(), h.zs.numpy())
    ax = [knots(64, 0.0, 1.0), knots(48, -1.0, 1.0), knots(32, 2.0, 3.0)]
    z, y, x = np.meshgrid(ax[2], ax[1], ax[0], indexing="ij")
    three = (*ax, np.cos(2.0 * x + y) * np.exp(-z))
    return {"Interp1D": one, "Interp2D": two, "Interp3D": three}


def interp_checks(dev):
    """Phase 21: each interpolator at 2^24 random points (inside and beyond
    the domain) on the card against the port's CPU path on the same
    queries: within 1 ulp of max|z| (read in ulps), and its time a call."""
    rng = np.random.default_rng(21)
    rows = {}
    for name, arrays in interp_tables(rng).items():
        cls = getattr(interp, name)
        card, host = cls(*arrays, device=dev), cls(*arrays, device="cpu")
        q = [torch.as_tensor(rng.uniform(k[0] - 0.1, k[-1] + 0.1,
                                         INTERP_POINTS))
             for k in (ax.knots.numpy() for ax in host.axes)]
        qd = [t.to(dev) for t in q]
        out = card(*qd)
        torch.cuda.synchronize()
        ref = host(*q)
        ulp = float(np.spacing(np.abs(arrays[-1]).max()))
        d = float(torch.max(torch.abs(out.cpu() - ref))) / ulp
        ms = time_ms(lambda: card(*qd), 3)
        rows[name] = {"max_ulps": d, "ms": ms}
        print(f"phase 21: {name} at {INTERP_POINTS} points, card against the"
              f" CPU path: {d:.3g} ulps of max|z| at most (held to 1); "
              f"{ms:.3f} ms a call on the card", flush=True)
        if not d <= 1.0:
            fail(f"phase 21: {name} differs between card and CPU by {d} ulps")
    return rows


def physics_path(dev):
    """Phase 21: ``Workspace(6).integrate(ClusterLikelihood(),
    PHYSICS_EPSREL, 1e-40)`` with the default ``fused=True`` (the callable
    captured in the fused phase's graphs) to status 0; the same on the
    host loop with CUDA events around each split launch and each call (the
    callable's share), which must take the fused run's decisions; the
    ``interp_precision="f32"`` run within F32_TABLE_RTOL of it; the VEGAS
    cross-check (``mcubes.integrate`` at PHYSICS_VEGAS, the reference's
    hybrid.cu check) within 5 (err1 + err2).  Counts set to 0 before and
    read after each run.  Returns the launches and walls."""
    model = physics.ClusterLikelihood(device=dev)
    out = {"interp": interp_checks(dev)}
    torch.cuda.synchronize()
    cuda_rule.reset_launches()
    fused_loop.reset_stats()
    t0 = time.perf_counter()
    res = Workspace(model.ndim).integrate(model, PHYSICS_EPSREL, 1e-40)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fused_c, fstats = b1_counts(), dict(fused_loop.stats)
    print(f"phase 21: f64 6D ClusterLikelihood, Workspace.integrate epsrel "
          f"{PHYSICS_EPSREL:g}, fused=True: status {res.status} estimate "
          f"{res.estimate!r} errorest {res.errorest!r} iters {res.iters} "
          f"nregions {res.nregions} neval {res.neval} wall {wall:.3f} s; "
          f"fused phase {fstats}; B1 launches (a capture's counted once, "
          f"its replays not) {fused_c}", flush=True)
    if (res.status != 0 or fused_c["fused"]
            or fused_c["split"]["points"] == 0):
        fail(f"phase 21: the physics run: status {res.status}, launches "
             f"{fused_c}")
    torch.cuda.synchronize()
    cuda_rule.reset_launches()
    with SplitEvents(model) as ev:
        t0 = time.perf_counter()
        host = Workspace(model.ndim).integrate(ev.f, PHYSICS_EPSREL, 1e-40,
                                               **HOST)
        torch.cuda.synchronize()
        wall_h = time.perf_counter() - t0
    host_c = b1_counts()
    parts = ev.seconds
    print(f"phase 21: the same on the host loop: iters {host.iters} nregions "
          f"{host.nregions} neval {host.neval} estimate {host.estimate!r} "
          f"wall {wall_h:.3f} s (with CUDA events around each launch and "
          f"call): points kernel {parts['points']:.4f} s, the callable "
          f"{parts['callable']:.4f} s ({100 * parts['callable'] / wall_h:.1f}"
          f"% of the wall), contraction {parts['contract']:.4f} s; B1 "
          f"launches {host_c}", flush=True)
    if ((host.status, host.iters, host.nregions, host.neval)
            != (res.status, res.iters, res.nregions, res.neval)
            or not math.isclose(host.estimate, res.estimate, rel_tol=1e-12)):
        fail("phase 21: the fused physics run did not take the host loop's "
             "decisions")
    m32 = physics.ClusterLikelihood(interp_precision="f32", device=dev)
    r32 = Workspace(model.ndim).integrate(m32, PHYSICS_EPSREL, 1e-40)
    rel32 = abs(r32.estimate - res.estimate) / abs(res.estimate)
    print(f"phase 21: interp_precision='f32': status {r32.status} estimate "
          f"{r32.estimate!r}, {rel32:.3e} relative from the f64 table's "
          f"(held to {F32_TABLE_RTOL:g})", flush=True)
    if not rel32 <= F32_TABLE_RTOL:
        fail(f"phase 21: the f32 table's estimate is {rel32} off")
    torch.cuda.synchronize()
    cuda_vegas.reset_launches()
    cuda_lookup.reset_launches()
    t0 = time.perf_counter()
    rv = mcubes.integrate(model, **PHYSICS_VEGAS)
    torch.cuda.synchronize()
    wall_v = time.perf_counter() - t0
    b2, b3 = cuda_vegas.launches, cuda_lookup.hist_launches
    gap = abs(rv.estimate - res.estimate)
    tol = 5 * (rv.errorest + res.errorest)
    print(f"phase 21: VEGAS cross-check {PHYSICS_VEGAS}: status {rv.status} "
          f"estimate {rv.estimate!r} errorest {rv.errorest!r} iters "
          f"{rv.iters} wall {wall_v:.3f} s; |VEGAS - PAGANI| {gap:.3e} "
          f"(held to 5 (err1 + err2) = {tol:.3e}); B2 launches {b2} (by "
          f"route {dict(cuda_vegas.route_launches)}), B3 {b3}", flush=True)
    if rv.status != 0 or not gap <= tol or not b2 or not b3:
        fail(f"phase 21: VEGAS cross-check: status {rv.status}, gap {gap}, "
             f"B2 {b2}, B3 {b3}")
    # the two loops' walls in turns, without events
    turns = {"host": [], "fused": []}
    for form in ("host", "fused", "fused", "host"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        Workspace(model.ndim).integrate(model, PHYSICS_EPSREL, 1e-40,
                                        **(HOST if form == "host" else {}))
        torch.cuda.synchronize()
        turns[form].append(time.perf_counter() - t0)
    print(f"phase 21: ClusterLikelihood walls in turns (host, fused, fused, "
          f"host): host {turns['host']}, fused {turns['fused']} s",
          flush=True)
    out.update(fused=fused_c, host=host_c, fused_stats=fstats, wall_s=wall,
               walls_in_turns_s=turns,
               host_wall_s=wall_h, callable_share=parts["callable"] / wall_h,
               vegas_b2=b2, vegas_b3=b3, vegas_wall_s=wall_v,
               status=res.status, iters=res.iters, neval=res.neval)
    return out


SUAVE_CLI = dict(epsrel=1e-3, epsabs=1e-40, nnew=2048, nmin=2,
                 flatness=50.0, max_regions=1024, max_cycles=64, seed=0)
SUAVE_HELD = dict(ndim=3, a=5.0, epsrel=2e-3, nnew=512)
SUAVE_CYCLE_REGIONS = 1024


def suave_cycle_check(dev):
    """Phase 22: one Suave cycle (one pass) on 1024 random 5D regions with
    the same grids and draws on the card and the CPU: I, var, flu and the
    masses within 1e-12 of each output's largest magnitude, the refined
    grids' edges within 1e-5 (the f32 rebin's sums)."""
    ndim, nnew, nbins = 5, SUAVE_CLI["nnew"], 64
    g = genz.f4_gaussian(ndim)
    lows, lengths = random_pool(ndim, SUAVE_CYCLE_REGIONS, 22, torch.float64,
                                "cpu")
    grids = suave_mod.uniform_edges(nbins).expand(
        SUAVE_CYCLE_REGIONS, ndim, nbins + 1).contiguous()
    lo_hi = (torch.zeros(ndim, dtype=torch.float64),
             torch.ones(ndim, dtype=torch.float64))

    def run(device):
        ids = torch.arange(SUAVE_CYCLE_REGIONS, device=device)
        return suave_mod._suave_cycle(
            g, ndim, 1, nnew, nbins, torch.float64, 16.0,
            lambda i: vegas_assisted.region_draws(
                0, 0, i, ids, nnew, ndim,
                stream_base=suave_mod.SUAVE_STREAM),
            lows.to(device), lengths.to(device), grids.to(device),
            *(t.to(device) for t in lo_hi))

    card = [t.cpu() for t in run(dev)]
    host = run("cpu")
    names = ("grids", "I", "var", "flu", "mass_lo", "mass", "mass_abs")
    reads = {}
    for name, c, h in zip(names, card, host):
        scale = float(torch.max(torch.abs(h))) or 1.0
        reads[name] = float(torch.max(torch.abs(c - h))) / (
            1.0 if name == "grids" else scale)
    print(f"phase 22: one Suave cycle on {SUAVE_CYCLE_REGIONS} random 5D "
          f"regions x {nnew} samples, card against CPU on the same grids and "
          f"draws (grids: max |d edge|; the rest: max |d| over the largest "
          f"|value|): {reads}", flush=True)
    if not (reads["grids"] <= 1e-5 and all(
            v <= 1e-12 for k, v in reads.items() if k != "grids")):
        fail(f"phase 22: a Suave cycle differs between card and CPU ({reads})")
    return reads


def suave_path(dev):
    """Phase 22: Suave at the CLI's default case (5D Genz F4, a = 25, at
    SUAVE_CLI): status, cycles, regions, neval, wall, and |est - truth| <=
    5 errorest; one cycle card against CPU; 3D F4 (a = 5) at SUAVE_HELD
    certifies with the truth within 3 errorests."""
    g5 = genz.f4_gaussian(5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = suave_mod.suave(g5, **SUAVE_CLI, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    pull = abs(r.estimate - g5.true_value) / r.errorest
    print(f"phase 22: Suave 5D f4_gaussian (a = 25) {SUAVE_CLI}: status "
          f"{r.status} estimate {r.estimate!r} errorest {r.errorest!r} truth "
          f"{g5.true_value!r} pull {pull:.3f} cycles {r.iters} nregions "
          f"{r.nregions} neval {r.neval} prob {r.prob:.4f} wall {wall:.3f} s",
          flush=True)
    if not pull <= 5.0:
        fail(f"phase 22: Suave 5D: the truth is {pull} errorests away")
    reads = suave_cycle_check(dev)
    g3 = genz.f4_gaussian(SUAVE_HELD["ndim"], a=SUAVE_HELD["a"])
    t0 = time.perf_counter()
    r3 = suave_mod.suave(g3, SUAVE_HELD["epsrel"], 1e-40,
                         nnew=SUAVE_HELD["nnew"], device=dev)
    wall3 = time.perf_counter() - t0
    pull3 = abs(r3.estimate - g3.true_value) / r3.errorest
    print(f"phase 22: Suave 3D f4_gaussian (a = 5) at {SUAVE_HELD['epsrel']:g}"
          f", nnew {SUAVE_HELD['nnew']}: status {r3.status} estimate "
          f"{r3.estimate!r} errorest {r3.errorest!r} pull {pull3:.3f} cycles "
          f"{r3.iters} nregions {r3.nregions} neval {r3.neval} wall "
          f"{wall3:.3f} s", flush=True)
    if r3.status != 0 or not pull3 <= 3.0:
        fail(f"phase 22: Suave 3D: status {r3.status}, pull {pull3}")
    return {"cli": {"status": r.status, "cycles": r.iters,
                    "nregions": r.nregions, "neval": r.neval, "pull": pull,
                    "wall_s": wall},
            "held": {"status": r3.status, "pull": pull3, "wall_s": wall3},
            "cycle": reads}


QUAD_CASES = [
    ("qng e^x", "qng", lambda x: torch.exp(x), (0.0, 1.0),
     dict(epsrel=1e-10), math.e - 1.0),
] + [(f"qag key {k} cos 50x", "qag", lambda x: torch.cos(50 * x), (0.0, 1.0),
      dict(epsrel=1e-10, key=k), math.sin(50.0) / 50.0) for k in range(1, 7)
     ] + [
    ("qag kink", "qag", lambda x: torch.exp(-200.0 * torch.abs(x - 0.37)),
     (0.0, 1.0), dict(epsrel=1e-10, max_intervals=4096),
     (2 - math.exp(-200.0 * 0.37) - math.exp(-200.0 * 0.63)) / 200.0),
    ("cquad 1/(1e-2 + x^2)", "cquad", lambda x: 1.0 / (1e-2 + x ** 2),
     (-1.0, 1.0), dict(epsrel=1e-9), 2.0 * math.atan(10.0) / 0.1),
    ("qawo x sin(10 pi x)", "qawo", lambda x: x, (0.0, 1.0, 10.0 * math.pi),
     dict(sin_or_cos="sin", epsrel=1e-10),
     -math.cos(10.0 * math.pi) / (10.0 * math.pi)),
    ("qawf e^-x sin 2x", "qawf", lambda x: torch.exp(-x), (0.0, 2.0),
     dict(sin_or_cos="sin", epsabs=1e-10), 2.0 / 5.0),
    ("qawf cos x / (1 + x^2)", "qawf", lambda x: 1.0 / (1.0 + x * x),
     (0.0, 1.0), dict(sin_or_cos="cos", epsabs=1e-8),
     math.pi / (2.0 * math.e)),
]


def quad1d_path(dev):
    """Phase 23: 1-D quadrature on the reference's closed-form cases
    (tests/test_quad1d_gsl.py), each on the card and on the CPU: status 0
    on both, the same neval and intervals, the estimates within 1e-12
    relative (plus 1e-15) of each other and the truth within 10 times the
    tolerance or errorest."""
    rows = []
    for label, method, f, args, kw, truth in QUAD_CASES:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card = getattr(quad1d, method)(f, *args, **kw, device=dev)
        wall = time.perf_counter() - t0
        host = getattr(quad1d, method)(f, *args, **kw, device="cpu")
        d = abs(card.estimate - host.estimate)
        err = abs(card.estimate - truth)
        tol = 10 * (kw.get("epsrel", 0.0) * abs(truth) + card.errorest)
        print(f"phase 23: {label}: card status {card.status} estimate "
              f"{card.estimate!r} errorest {card.errorest:.3e} neval "
              f"{card.neval} intervals {card.nregions} wall {wall:.3f} s; CPU "
              f"neval {host.neval} intervals {host.nregions}, |card - CPU| "
              f"{d:.3e}, |card - truth| {err:.3e}", flush=True)
        if ((card.status, card.neval, card.nregions) != (0, host.neval,
                                                          host.nregions)
                or host.status != 0
                or not d <= 1e-12 * abs(host.estimate) + 1e-15
                or not err <= max(tol, 1e-13)):
            fail(f"phase 23: {label}: card and CPU part or miss the truth")
        rows.append({"case": label, "neval": card.neval,
                     "intervals": card.nregions, "wall_s": wall})
    return rows


# ---------------------------------------------------------------------------
# The mesh (phase 24): parallel.launch.run_on_ranks, tools/mesh_cases.py

MESH_F4 = ("genz", "f4_gaussian", NDIM, {})
MESH_G6 = ("genz", "f4_gaussian", VEGAS_NDIM, {})
MESH_SIN8 = ("misc", "sin_sum", NDIM, {})
MESH_VEGAS = dict(epsrel=1e-3, epsabs=1e-40, ncall=1e8)
MESH_MAIN = dict(what="pagani", integrand=MESH_F4, ndim=NDIM,
                 kw=dict(epsrel=1e-3, epsabs=1e-40), trace_classifier=True)
# D = 1 under NCCL: phase 3's main path (its fused run, phase 17) and VEGAS
# run 1 (phase 6)
MESH_D1 = {"main": MESH_MAIN,
           "vegas_run1": dict(what="vegas", integrand=MESH_G6,
                              kw=MESH_VEGAS)}
# D = 2 under gloo, two ranks on the one card
MESH_D2 = {
    "main": MESH_MAIN,
    "sin_sum": dict(what="pagani", integrand=MESH_SIN8, ndim=NDIM,
                    kw=dict(epsrel=SIN_SUM_EPSREL, epsabs=1e-40, **HOST)),
    "vector": dict(what="pagani", integrand=("vector", [MESH_SIN8] * 2),
                   ndim=NDIM,
                   kw=dict(epsrel=SIN_SUM_EPSREL, epsabs=1e-40, **HOST)),
    "crease": dict(what="pagani",
                   integrand=("genz", "f5_c0_continuous", NDIM,
                              {"a": 10.0, "b": 0.37}),
                   ndim=NDIM, kw=dict(epsrel=F5_CREASE_EPSREL, epsabs=1e-40,
                                      crease_split=True)),
    "continuation": dict(what="convergence", integrand=MESH_F4, ndim=NDIM,
                         ws=dict(max_pool_regions=CONT_POOL),
                         kw=dict(epsrel=1e-5, epsabs=1e-40, max_wall_s=600,
                                 **HOST)),
    "vegas_run1": dict(what="vegas", integrand=MESH_G6, kw=MESH_VEGAS),
    "vegas_run3": dict(what="vegas", integrand=MESH_G6,
                       kw=dict(MESH_VEGAS, importance="grid")),
}
# the kernels each case's launches must all take, by route: (counter, key,
# total counter) per kernel
MESH_ROUTES = {
    "main": [("rule", "tile", "rule_total")],
    "sin_sum": [("contract", "cluster", ("split", "contract"))],
    "vector": [("contract", cuda_rule.COMPONENTS_CLUSTER,
                ("split", "contract"))],
    "crease": [("rule", "tile", "rule_total"),
               ("frac", "tile", "rule_total")],
    "continuation": [("rule", "tile", "rule_total")],
    "vegas_run1": [("sampler", "paired", "sampler_total"),
                   ("hist", "grouped", None)],
    "vegas_run3": [("resolve", "sample", None), ("hist", "grouped", None)],
}


def _mesh_launches_ok(name, launches):
    """Every launch of the case's kernels on the card's own route; returns
    the route counts."""
    counts = {}
    for counter, route, total in MESH_ROUTES[name]:
        n = launches[counter][route]
        if total is None:
            whole = sum(launches[counter].values())
        elif isinstance(total, tuple):
            whole = launches[total[0]][total[1]]
        else:
            whole = launches[total]
        counts[f"{counter}/{route}"] = n
        if n <= 0 or n != whole:
            fail(f"phase 24: {name}: {n} of {whole} {counter} launches on "
                 f"the {route} route; all should take it ({launches})")
    if name in ("sin_sum", "vector") and launches["rule_total"]:
        fail(f"phase 24: {name}: {launches['rule_total']} fused rule "
             "launches; a callable takes the split route only")
    if name == "crease" and (launches["split"]["points"]
                             or launches["split"]["contract"]):
        fail("phase 24: the crease run left the fused tile route")
    return counts


def _mesh_ranks(label, backend, d, cases):
    """The cases on ``d`` ranks of ``backend``; every rank the same result
    bits; prints each case's walls, memory and launches.  Returns the
    ranks' outcomes."""
    t0 = time.perf_counter()
    ranks = run_on_ranks(mesh_cases.run_cases, d, backend=backend,
                         device_type="cuda",
                         args=(cases, "cuda", None, False), timeout=900)
    print(f"phase 24: {label}: {d} rank(s) under {backend} took "
          f"{time.perf_counter() - t0:.1f} s with the spawn", flush=True)
    for name in cases:
        first = ranks[0][name]["result"]
        for r in ranks[1:]:
            if any(not np.array_equal(np.asarray(r[name]["result"][k]),
                                      np.asarray(v))
                   for k, v in first.items()):
                fail(f"phase 24: {label} {name}: the ranks' results differ")
        for k, r in enumerate(ranks):
            out = r[name]
            res = out["result"]
            print(f"phase 24: {label} {name} rank {k}: status "
                  f"{res['status']} estimate {res['estimate']!r} errorest "
                  f"{res['errorest']!r} iters {res['iters']} nregions "
                  f"{res['nregions']} neval {res['neval']} wall "
                  f"{out['wall_s']:.3f} s (not compared: the ranks share "
                  f"the card), peak {out['peak_gib']:.2f} GiB, free after "
                  f"{out['free_gib']:.2f} GiB; fused_loop.stats "
                  f"{out['fused_stats']}, phases.stats {out['vegas_stats']}"
                  f", launches by route "
                  f"{_mesh_launches_ok(name, out['launches'])}"
                  + (f", rebalanced resumes {out['rebalances']}, stages "
                     f"{out['stages']}" if "stages" in out else ""),
                  flush=True)
    return ranks


def _same_bits(a, b) -> bool:
    return (a.status, a.iters, a.nregions, a.neval, a.estimate,
            a.errorest) == (b["status"], b["iters"], b["nregions"],
                            b["neval"], b["estimate"], b["errorest"])


def mesh_path(dev, tile_run, fused_run, vegas_runs, sin8):
    """Phase 24: PAGANI and VEGAS on a ``torch.distributed`` mesh on the one
    card.  D = 1 under NCCL (a real communicator): phase 3's main path
    with the mesh must give phase 17's fused run of it (``fused_run``) bit
    for bit, every B1 launch on the tile route, and VEGAS run 1 phase 6's
    (``vegas_runs``) bit for bit.  D = 2 under gloo, two processes on the
    card: the main path to status 0 within 1e-3 with phase 3's
    (``tile_run``) iterations, regions and neval, the estimate within 1e-12
    and the errorest within 1e-9; ``sin_sum(8)`` at 1e-11 on the split
    route (phase 11's run, ``sin8``, its decisions), [sin_sum(8)] x 2 on
    'components_cluster' (the scalar mesh run's decisions, its components
    equal), 8D F5 crease at 1e-2 on the fused tile route with the
    fraction, the continuation at CONT_POOL certifying, VEGAS runs 1 and 3
    (status 0, the truth within 5 errorests, within 5 sqrt(e1^2 + e2^2) of
    phase 6's).  Every rank the same bits, every launch on the card's
    route.  Returns {case: launches a rank} for the kernels line."""
    t_phase = time.perf_counter()
    d1 = _mesh_ranks("D = 1", "nccl", 1, MESH_D1)[0]
    main = d1["main"]["result"]
    if not _same_bits(fused_run, main):
        fail(f"phase 24: D = 1 under NCCL: {main} is not phase 17's fused "
             f"run of phase 3 bit for bit ({fused_run})")
    r1 = vegas_runs["run1"]
    v1 = d1["vegas_run1"]["result"]
    if (r1.estimate, r1.errorest, r1.chi_sq, r1.iters) != (
            v1["estimate"], v1["errorest"], v1["chi_sq"], v1["iters"]):
        fail(f"phase 24: D = 1 VEGAS run 1 {v1} is not phase 6's bit for "
             f"bit ({r1.estimate!r}, {r1.errorest!r})")
    print(f"phase 24: D = 1 under NCCL gives phase 17's fused main path and "
          f"phase 6's run 1 bit for bit; graphs: fused_loop.stats "
          f"{d1['main']['fused_stats']}, phases.stats "
          f"{d1['vegas_run1']['vegas_stats']}", flush=True)

    ranks = _mesh_ranks("D = 2", "gloo", 2, MESH_D2)
    out = ranks[0]
    main = out["main"]["result"]
    g4 = genz.f4_gaussian(NDIM)
    rel = abs(main["estimate"] - g4.true_value) / g4.true_value
    same = (main["iters"], main["nregions"], main["neval"]) == (
        tile_run.iters, tile_run.nregions, tile_run.neval)
    d_est = abs(main["estimate"] - tile_run.estimate) / tile_run.estimate
    d_err = abs(main["errorest"] - tile_run.errorest) / tile_run.errorest
    print(f"phase 24: D = 2 main path against phase 3: "
          f"{'the same' if same else 'OTHER'} iterations, regions and neval; "
          f"estimate {d_est:.3g}, errorest {d_err:.3g} apart (relative); "
          f"rel.err {rel:.3e}; classifier calls (regions, verdict, "
          f"threshold, survivors) {out['main']['classifier']}", flush=True)
    if not same:
        calls = []
        with mesh_cases._traced_classifier(calls):
            Workspace(NDIM).integrate(g4, 1e-3, 1e-40, **HOST)
        print(f"phase 24: phase 3's classifier calls {calls}", flush=True)
    if (main["status"] != 0 or not rel <= 1e-3 or not same
            or not d_est <= 1e-12 or not d_err <= 1e-9):
        fail("phase 24: the D = 2 main path parts from phase 3")
    s = out["sin_sum"]["result"]
    if (s["status"], s["iters"], s["nregions"], s["neval"]) != (
            sin8.status, sin8.iters, sin8.nregions, sin8.neval):
        fail(f"phase 24: sin_sum(8) on the mesh {s} does not take phase "
             f"11's decisions ({sin8})")
    v = out["vector"]["result"]
    if (v["status"], v["iters"], v["nregions"], v["neval"]) != (
            s["status"], s["iters"], s["nregions"], s["neval"]) or not (
            v["estimates"][0] == v["estimates"][1]) or not abs(
            v["estimates"][0] - s["estimate"]) <= kernel_check.RTOL[
                torch.float64] * abs(s["estimate"]):
        fail(f"phase 24: [sin_sum(8)] x 2 {v} against the scalar {s}")
    c = out["crease"]["result"]
    g5 = genz.f5_c0_continuous(NDIM, a=10.0, b=0.37)
    if c["status"] != 0 or not abs(c["estimate"] - g5.true_value) <= (
            3 * F5_CREASE_EPSREL * g5.true_value):
        fail(f"phase 24: the crease run {c}")
    cont = out["continuation"]
    rel = abs(cont["result"]["estimate"] - g4.true_value) / g4.true_value
    if cont["result"]["status"] != 0 or not rel <= 1e-5 \
            or cont["rebalances"] == 0:
        fail(f"phase 24: the continuation at {CONT_POOL} regions: "
             f"{cont['result']}, rebalanced resumes {cont['rebalances']}")
    g6 = genz.f4_gaussian(VEGAS_NDIM)
    for run in ("run1", "run3"):
        r = out["vegas_" + run]["result"]
        one = vegas_runs[run]
        pull = abs(r["estimate"] - g6.true_value) / r["errorest"]
        apart = abs(r["estimate"] - one.estimate) / math.hypot(
            r["errorest"], one.errorest)
        print(f"phase 24: D = 2 VEGAS {run}: {r['iters']} iterations against "
              f"phase 6's {one.iters}; pull {pull:.3f}; "
              f"{apart:.3f} combined errorests from phase 6's estimate",
              flush=True)
        if r["status"] != 0 or not pull <= 5 or not apart <= 5:
            fail(f"phase 24: D = 2 VEGAS {run}: {r}")
    print(f"phase 24 (the mesh) took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return {name: [_launch_totals(r[name]["launches"]) for r in ranks]
            for name in MESH_D2}

# ---------------------------------------------------------------------------
# Any scalar-per-axis callable inside the fused kernels (phase 25)

def g6(x0, x1, x2, x3, x4, x5):
    """The reference bench's 6D per-axis Gaussian (bench.py:205-225)."""
    s = 0.0
    for x in (x0, x1, x2, x3, x4, x5):
        s = s + (x - 0.5) ** 2
    return torch.exp(-25.0 * s)


def g10(x0, x1, x2, x3, x4, x5, x6, x7, x8, x9):
    """A 10D per-axis Gaussian: the sampler's wide route."""
    s = 0.0
    for x in (x0, x1, x2, x3, x4, x5, x6, x7, x8, x9):
        s = s + (x - 0.5) ** 2
    return torch.exp(-4.0 * s)


# The callables of phase 25: f4_axes (8D, the rule's tile route), cos of
# the sum at 12D (its generic route) and g10 (the sampler's wide route)
# built with the other sources in phase 1, with phase 26's sin of the sum; the reference bench's g6 (6D)
# built alone in phase 25, as a user's first call builds its library.
GEN_F4 = integrand_gen.traced(f4_axes, NDIM)
GEN_COS12 = integrand_gen.traced(axes_callable(12), 12, "cos_sum12")
GEN_G10 = integrand_gen.traced(g10, 10)
# phase 26's 12D callable, traced as Workspace(rule_backend='fused') traces
# it (the same header, so the same library)
GEN_SIN12 = integrand_gen.traced(sin_axes(12), 12)
GEN_PHASE1 = (GEN_F4, GEN_COS12, GEN_G10, GEN_SIN12)
G6_TRUTH = (math.sqrt(math.pi / 25.0) * math.erf(2.5)) ** VEGAS_NDIM
G6_FROZEN = dict(ncall=1e9, iters=10)     # the reference bench's frozen case


def generated_bound_ms(program, ndim: int, n: int,
                       dtype) -> tuple[float, str]:
    """``bound_ms`` of a traced callable's fused rule launch: per rule point
    the program's steps (integrand_gen.program_ops: a transcendental as
    ONE) and 1 for the orbit sum; per region its 11 coordinates an axis
    (the point's coordinates are among them) and the epilogue."""
    feval = rule_eval.rule_tables(ndim).feval
    per_point = integrand_gen.program_ops(program) + 1
    ops = n * (feval * per_point + 11 * ndim * COORD_OPS + EPILOGUE_OPS)
    item = torch.finfo(dtype).bits // 8
    nbytes = n * (2 * ndim * item + 2 * item + 4)
    t_ops, t_bytes = ops / PEAK_OPS[dtype], nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def generated_sampler_bound_ms(program, ndim: int, kp: int, kq: int, n: int,
                               with_hist: bool) -> tuple[float, str]:
    """``sampler_bound_ms`` of the fused sampler on a traced callable: the
    program's steps in place of a Genz family's per-axis work."""
    per_dim = 2 * (2 * (kp - 2) + max(kq - 2, 0) + 2) + 10 + 25
    per_sample = ndim * per_dim + integrand_gen.program_ops(program) + 6
    t_ops = n * per_sample / PEAK_OPS[torch.float32]
    t_bytes = n * (8 * ndim if with_hist else 0) / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def generated_checks(dev):
    """Phase 25 (1-2): g6's library built alone, its first build's
    seconds; each generated kernel held against its plain version by
    ``kernel_check`` (rule) and ``mcubes.kernel_check`` (sampler), in ulps
    of each output's rounding scale; f4_axes on the generated tile kernel
    timed against the Genz F4 tile kernel on phase 4's pool.  Returns the
    numbers of the kernels line."""
    gen_g6, gen_g10 = integrand_gen.traced(g6, VEGAS_NDIM), GEN_G10
    for t in GEN_PHASE1:
        lib = cuda_build._target(cuda_build.GEN_SOURCE,
                                 integrand_gen.header(t.program))
        print(f"phase 25: {t.name} {t.ndim}D: library {lib.name} built in "
              f"phase 1 with the other sources in "
              f"{cuda_build.generated_builds.get(lib.name, math.nan):.2f} s",
              flush=True)
    t0 = time.perf_counter()
    g6_lib = cuda_build.build_generated(integrand_gen.header(gen_g6.program))
    g6_build = time.perf_counter() - t0
    regs = route_bits.ptxas_kernels(g6_lib.with_suffix(".log").read_text())
    print(f"phase 25: g6 6D: its library {g6_lib.name} built alone, as a "
          f"user's first call builds it: {g6_build:.2f} s; its kernels' "
          f"(registers, spill bytes, stack bytes): {regs}", flush=True)
    out = {"build_s": {"g6_alone": g6_build, "phase1_together": {
        t.name: cuda_build.generated_builds.get(cuda_build._target(
            cuda_build.GEN_SOURCE, integrand_gen.header(t.program)).name)
        for t in GEN_PHASE1}}}
    big = 1 << 21
    errs = {"rule": 0.0, "sampler": 0.0}
    for dtype in (torch.float64, torch.float32):
        tables = rule_eval.rule_tables(NDIM, rule_eval.dtype_name(dtype))
        lows, lengths = random_pool(NDIM, big, 2, dtype, dev)
        gl = torch.zeros(NDIM, dtype=dtype, device=dev)
        gr = torch.ones(NDIM, dtype=dtype, device=dev)
        r = compare(f"phase 25: f4_axes {str(dtype)[6:]} generated tile "
                    f"kernel, phase 4's 2^21 pool", GEN_F4, tables, lows,
                    lengths, gl, gr, route="tile")
        errs["rule"] = max(errs["rule"], r["max_abs_est"])
        if dtype != torch.float64:
            continue
        g4 = genz.f4_gaussian(NDIM)

        def launch(f, route="tile"):
            return lambda: cuda_rule.cuda_apply_rule(
                f, tables, lows, lengths, gl, gr, route=route)

        # Genz F4, generated, generated, Genz: the two within one call
        t = [time_ms(launch(g4), 5), time_ms(launch(GEN_F4), 5),
             time_ms(launch(GEN_F4), 5), time_ms(launch(g4), 5)]
        gen_ms, genz_ms = min(t[1], t[2]), min(t[0], t[3])
        generic = time_ms(launch(GEN_F4, "generic"), 3)
        plain = time_ms(lambda: rule_eval.apply_rule_plain(
            GEN_F4, tables, lows, lengths, gl, gr, chunk_size=4096), 1)
        b, by = generated_bound_ms(GEN_F4.program, NDIM, big, dtype)
        out["rule"] = {"ms": gen_ms, "genz_f4_tile_ms": genz_ms,
                       "generic_route_ms": generic, "plain_ms": plain,
                       "bound_ms": b, "bound_by": by}
        print(f"phase 25: f4_axes f64 2^21 regions: generated tile kernel "
              f"{gen_ms:.3f} ms ({t[1]:.3f}, {t[2]:.3f}) against the Genz F4 "
              f"tile kernel {genz_ms:.3f} ms ({t[0]:.3f}, {t[3]:.3f}): "
              f"{gen_ms / genz_ms:.3f} times; generated generic route "
              f"{generic:.3f} ms; plain {plain:.1f} ms; bound {b:.3f} ms "
              f"({by}, {100 * b / gen_ms:.1f}% of it; "
              f"{integrand_gen.program_ops(GEN_F4.program)} operations a "
              f"value from the program's {len(GEN_F4.program.steps)} steps)",
              flush=True)
        del lows, lengths
        torch.cuda.empty_cache()
    tables = rule_eval.rule_tables(12, "float64")
    lows, lengths = random_pool(12, 1 << 14, 3, torch.float64, dev)
    gl = torch.zeros(12, dtype=torch.float64, device=dev)
    gr = torch.ones(12, dtype=torch.float64, device=dev)
    r = compare("phase 25: cos(sum x) 12D f64 generated generic kernel, "
                "2^14 regions", GEN_COS12, tables, lows, lengths, gl, gr)
    errs["rule"] = max(errs["rule"], r["max_abs_est"])
    out["generic12"] = generic_tool.generated(
        sys.modules[__name__], dev, prefix="phase 25: generated generic "
                                           "kernel, ")
    del lows, lengths
    out["values"] = rounding_check(dev)

    # the sampler: paired at 6D on one 2^21-sample chunk, wide and generic
    # at 10D
    case = vegas_check.sampler_case(VEGAS_NDIM, 1e7, VEGAS_CHUNK,
                                    position="middle", device=dev)
    case10 = vegas_check.sampler_case(10, 1e6, 1 << 16, device=dev)
    for label, c, g, route in (("g6 6D paired", case, gen_g6, "paired"),
                               ("g6 6D generic", case, gen_g6, "generic"),
                               ("g10 10D wide", case10, gen_g10, "wide"),
                               ("g10 10D generic", case10, gen_g10,
                                "generic")):
        for with_hist in (True, False):
            try:
                r = vegas_check.check_sampler(c, g, with_hist=with_hist,
                                              rng="device", route=route)
            except AssertionError as e:
                fail(f"phase 25: {label}: {e}")
            print(f"phase 25: sampler {label} hist={with_hist}, "
                  f"{r['samples']} samples, against the plain version "
                  f"(limits {vegas_check.ULPS}): "
                  + ", ".join(f"{k} {v:.3g}" if isinstance(v, float)
                              else f"{k} {v}" for k, v in r.items()),
                  flush=True)
    pmap, npg = case["pmap"], case["npg"]
    n = case["chunk_cubes"] * npg
    tail = (case["xjac"], case["cube0"], case["ncubes"], 0, 1)

    def sample(fn, route=None, with_hist=True, g=gen_g6):
        kw = {} if route is None else {"route": route}
        return lambda: fn(pmap, g, case["ng"], npg, case["chunk_cubes"],
                          500, with_hist, *tail, **kw)

    k = sample(cuda_vegas.sample_chunk)()
    p = sample(cuda_vegas.sample_chunk_plain)()
    errs["sampler"] = float((k[0] - p[0]).abs().max())
    g4 = genz.f4_gaussian(VEGAS_NDIM)
    t = [queued_ms(sample(cuda_vegas.sample_chunk, "paired", g=gen), 5)
         for gen in (g4, gen_g6, gen_g6, g4)]
    ms, genz_ms = min(t[1], t[2]), min(t[0], t[3])
    generic = queued_ms(sample(cuda_vegas.sample_chunk, "generic"), 5)
    plain = time_ms(sample(cuda_vegas.sample_chunk_plain), 2)
    b, by = generated_sampler_bound_ms(gen_g6.program, VEGAS_NDIM, pmap.kp,
                                       pmap.kq, n, True)
    out["sampler"] = {"ms": ms, "genz_f4_paired_ms": genz_ms,
                      "generic_route_ms": generic, "plain_ms": plain,
                      "bound_ms": b, "bound_by": by}
    print(f"phase 25: sampler g6 fused+hist, {n} samples: generated paired "
          f"kernel {ms:.4f} ms ({t[1]:.4f}, {t[2]:.4f}) against the Genz F4 "
          f"paired kernel {genz_ms:.4f} ms ({t[0]:.4f}, {t[3]:.4f}); "
          f"generated generic route {generic:.4f} ms; plain {plain:.2f} ms; "
          f"bound {b:.4f} ms ({by}, {100 * b / ms:.1f}% of it)", flush=True)
    # g10 on its chunk, the wide and the generic route in turns
    def sample10(route):
        return lambda: cuda_vegas.sample_chunk(
            case10["pmap"], gen_g10, case10["ng"], case10["npg"],
            case10["chunk_cubes"], 500, True, case10["xjac"],
            case10["cube0"], case10["ncubes"], 0, 1, route=route)

    t = [queued_ms(sample10(r), 5) for r in ("wide", "generic", "generic",
                                              "wide")]
    out["sampler"]["g10_wide_ms"] = min(t[0], t[3])
    out["sampler"]["g10_generic_route_ms"] = min(t[1], t[2])
    print(f"phase 25: sampler g10 fused+hist, {case10['chunk_cubes']} cubes "
          f"of {case10['npg']}: generated wide kernel {min(t[0], t[3]):.4f} "
          f"ms ({t[0]:.4f}, {t[3]:.4f}; lanes "
          f"{cuda_vegas.wide_lanes(case10['chunk_cubes'], case10['npg'])}), "
          f"generated generic route {min(t[1], t[2]):.4f} ms ({t[1]:.4f}, "
          f"{t[2]:.4f})", flush=True)
    out["max_abs_err"] = errs
    return out


def generated_pagani(dev, walls):
    """Phase 25 (3): ``Workspace(8, rule_backend='fused').integrate(f4_axes,
    1e-3)`` in f64 with the fused phase, at full width: status 0 within
    1e-3 of the truth, every launch on the generated tile kernel, none on
    the split route; its captures and replays; its wall beside phase 3's
    (Genz F4, host loop), phase 17's (Genz F4, fused) and phase 11's (F4 as
    a plain callable, the split route).  Returns (launches by route, the
    result, the wall, the fused phase's stats, the check-only values
    kernel's launches in the timed run)."""
    truth = genz.f4_gaussian(NDIM).true_value
    rows = []
    for run in range(2):        # the first builds nothing: phase 1 did
        fused_loop.reset_stats()
        cuda_rule.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = Workspace(NDIM, rule_backend="fused").integrate(
            f4_axes, epsrel=1e-3, epsabs=1e-40)
        torch.cuda.synchronize()
        rows.append((time.perf_counter() - t0, res,
                     dict(cuda_rule.generated_launches), cuda_rule.launches,
                     dict(cuda_rule.split_launches), dict(fused_loop.stats),
                     cuda_rule.generated_value_launches))
    wall, res, gen, total, split, stats, value_launches = rows[0]
    rel = abs(res.estimate - truth) / truth
    print(f"phase 25: f64 8D f4_axes, Workspace(8, rule_backend='fused'), "
          f"epsrel 1e-3, fused phase: status {res.status} estimate "
          f"{res.estimate!r} truth {truth!r} rel.err {rel:.3e} iters "
          f"{res.iters} nregions {res.nregions} neval {res.neval} walls "
          f"{rows[0][0]:.3f} s, {rows[1][0]:.3f} s; launches {total}, the "
          f"generated kernel's by route {gen}, split route {split}; fused "
          f"phase {stats}", flush=True)
    print(f"phase 25: beside it, 8D F4: phase 3 (Genz family, tile route, "
          f"host loop) {walls['phase3']:.3f} s, phase 17 (Genz family, "
          f"fused phase) {min(walls['phase17']):.3f} s, phase 11 (a plain "
          f"callable, the split route, host loop) {walls['phase11']:.3f} s",
          flush=True)
    if res.status != 0 or not rel <= 1e-3:
        fail(f"phase 25: the fused backend's main path: status {res.status}, "
             f"rel.err {rel}")
    if total <= 0 or gen["tile"] != total or any(split.values()):
        fail(f"phase 25: launches {total}, generated {gen}, split {split}: "
             "every one should take the generated tile kernel")
    return gen, res, min(r[0] for r in rows), stats, value_launches


def _vegas_wall(g, **kw):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = mcubes.integrate(g, **kw)
    torch.cuda.synchronize()
    return r, time.perf_counter() - t0


def generated_vegas(dev):
    """Phase 25 (4): the reference bench's frozen case (bench.py:194-225):
    g6, 6D, 500 bins, 8 adjusting iterations at ncall 1e7, then
    G6_FROZEN's frozen iterations from that grid, sampler 'fused', each
    within 5 errorests of the truth; against 'hybrid' in turns (fused,
    hybrid, hybrid, fused); then AUTO with eval_dtype float32, which must
    take 'fused' and certify at 1e-3.  Returns (the frozen run's launches
    of the generated sampler, walls)."""
    picked = vegas_module._resolve_sampler(None, "poly", "cuda",
                                           torch.float32, g6)
    if picked != "fused":
        fail(f"phase 25: AUTO picks {picked!r} for g6 in f32")
    st = mcubes.VegasState(xi=vegas_grid.uniform_grid(VEGAS_NDIM, 500,
                                                      torch.float64, dev))
    cuda_vegas.reset_launches()
    adj, adj_wall = _vegas_wall(g6, epsrel=1e-9, ncall=1e7, total_iters=8,
                                adjust_iters=8, seed=1, sampler="fused",
                                state=st)
    adj_launches = dict(cuda_vegas.generated_launches)
    walls = {"fused": [], "hybrid": []}
    launches = None
    for sampler in ("fused", "hybrid", "hybrid", "fused"):
        vegas_phases.reset_stats()
        cuda_vegas.reset_launches()
        r, w = _vegas_wall(
            g6, epsrel=1e-12, epsabs=0.0, ncall=G6_FROZEN["ncall"],
            total_iters=G6_FROZEN["iters"], adjust_iters=0, seed=3,
            sampler=sampler, state=mcubes.VegasState(xi=st.xi))
        walls[sampler].append(w)
        pull = abs(r.estimate - G6_TRUTH) / r.errorest
        print(f"phase 25: g6 frozen, ncall {G6_FROZEN['ncall']:g} x "
              f"{G6_FROZEN['iters']} iterations, sampler {sampler!r}: "
              f"estimate {r.estimate!r} errorest {r.errorest!r} truth "
              f"{G6_TRUTH!r} pull {pull:.3f} iters {r.iters} neval "
              f"{r.neval} wall {w:.3f} s = {r.neval / w:.4e} samples/s; "
              f"sampler launches {dict(cuda_vegas.route_launches)} "
              f"(generated {dict(cuda_vegas.generated_launches)}); phases "
              f"{dict(vegas_phases.stats)}", flush=True)
        if not pull <= 5.0 or r.iters != G6_FROZEN["iters"]:
            fail(f"phase 25: g6 frozen {sampler}: pull {pull}, iters "
                 f"{r.iters}")
        if sampler == "fused":
            gen = dict(cuda_vegas.generated_launches)
            if gen["paired"] <= 0 or gen["paired"] != cuda_vegas.launches:
                fail(f"phase 25: the fused frozen run's sampler launches "
                     f"{gen} of {cuda_vegas.launches}")
            launches = launches or gen
    print(f"phase 25: g6 adjusting (ncall 1e7, 8 iterations, 'fused'): "
          f"estimate {adj.estimate!r} errorest {adj.errorest!r} wall "
          f"{adj_wall:.3f} s, generated sampler launches {adj_launches}; "
          f"frozen walls in turns: fused {walls['fused'][0]:.3f} s, hybrid "
          f"{walls['hybrid'][0]:.3f} s, hybrid {walls['hybrid'][1]:.3f} s, "
          f"fused {walls['fused'][1]:.3f} s", flush=True)
    cuda_vegas.reset_launches()
    auto, auto_wall = _vegas_wall(g6, epsrel=1e-3, ncall=1e7,
                                  eval_dtype=torch.float32)
    pull = abs(auto.estimate - G6_TRUTH) / auto.errorest
    print(f"phase 25: vegas(g6, eval_dtype=float32) under AUTO: status "
          f"{auto.status} estimate {auto.estimate!r} errorest "
          f"{auto.errorest!r} pull {pull:.3f} iters {auto.iters} wall "
          f"{auto_wall:.3f} s; generated sampler launches "
          f"{dict(cuda_vegas.generated_launches)}", flush=True)
    if auto.status != 0 or not pull <= 5.0 or \
            cuda_vegas.generated_launches["paired"] != cuda_vegas.launches:
        fail("phase 25: AUTO on g6 in f32 did not certify on the generated "
             "sampler")
    walls["adjust"] = adj_wall
    walls["auto"] = auto_wall
    return launches, walls


def _cli(argv):
    """``cli.main(argv)`` in this process: (exit code, its stdout lines)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue().splitlines()


def a17_on_card(dev, fused_run):
    """Phase 25 (5): the main path with a recorder (one row an iteration,
    the fused phase off, ``fused_run``'s decisions); ``cli.main`` for
    pagani, mcubes, ladder and profile (exit code 0, the reference's CSV
    headers); the continuation log on a 3D continuation."""
    rec = recorder.IterationRecorder()
    fused_loop.reset_stats()
    res = Workspace(NDIM, rule_backend="fused").integrate(
        f4_axes, epsrel=1e-3, epsabs=1e-40, recorder=rec)
    rows = rec.rows
    print(f"phase 25: the fused backend's main path with a recorder: "
          f"{len(rows)} rows for {res.iters} iterations, fused bursts "
          f"{fused_loop.stats['bursts']}; last row {rows[-1] if rows else None}",
          flush=True)
    if (len(rows) != res.iters or fused_loop.stats["bursts"]
            or (res.status, res.iters, res.nregions, res.neval)
            != (fused_run.status, fused_run.iters, fused_run.nregions,
                fused_run.neval)
            or [r["it"] for r in rows] != list(range(res.iters))):
        fail("phase 25: the recorder's rows or the host loop's decisions")
    for name, argv, header in (
            ("pagani", ["pagani", "--integrand", "f4_gaussian", "--ndim",
                        str(NDIM), "--epsrel", "1e-3"],
             timing.PAGANI_CSV_HEADER),
            ("mcubes", ["mcubes", "--integrand", "f4_gaussian", "--ndim",
                        str(VEGAS_NDIM), "--ncall", "1e8"],
             timing.MCUBES_CSV_HEADER),
            ("ladder", ["ladder", "--integrand", "f4_gaussian", "--ndim",
                        "3", "--epsrel", "1e-3", "--floor", "1e-6"],
             timing.PAGANI_CSV_HEADER),
            ("profile", ["profile", "--integrand", "f4_gaussian", "--ndim",
                         str(NDIM), "--splits", "5:8", "--repeats", "3"],
             timing.RULES_CSV_HEADER)):
        t0 = time.perf_counter()
        rc, lines = _cli(argv)
        print(f"phase 25: python -m gpuintegration_torch.cli "
              f"{' '.join(argv)}: exit {rc} in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        for line in lines:
            print(f"phase 25:   {line}", flush=True)
        if rc != 0 or not lines or lines[0] != header:
            fail(f"phase 25: cli {name}: exit {rc}, header "
                 f"{lines[0] if lines else None!r}")
    err = io.StringIO()
    old = os.environ.get("GPUINT_TPU_CONTINUATION_LOG")
    os.environ["GPUINT_TPU_CONTINUATION_LOG"] = "1"
    try:
        with contextlib.redirect_stderr(err):
            r = Workspace(3, max_pool_regions=1024,
                          chunk_size=128).integrate_to_convergence(
                genz.f4_gaussian(3, a=15.0, b=0.3), epsrel=1e-9,
                epsabs=1e-40, fused=False)
    finally:
        if old is None:
            del os.environ["GPUINT_TPU_CONTINUATION_LOG"]
        else:
            os.environ["GPUINT_TPU_CONTINUATION_LOG"] = old
    log = [ln for ln in err.getvalue().splitlines()
           if ln.startswith("[continuation]")]
    print(f"phase 25: a 3D continuation with GPUINT_TPU_CONTINUATION_LOG "
          f"set: status {r.status}, {len(log)} slice lines:", flush=True)
    for ln in log:
        print(f"phase 25:   {ln}", flush=True)
    if not log:
        fail("phase 25: the continuation printed no log line")


C0D = torch.tensor(0.75, dtype=torch.float64)     # a host scalar
VALUES_POINTS = 1 << 20


def rounding_forms(c_card):
    """A per-axis program of every division and power form the emitter
    spells out as PyTorch's CUDA kernels compute it (ops/integrand_gen.py):
    x ** -0.5 (rsqrt), 0.5, -1, -2, 3; torch.div(c, x),
    torch.true_divide(c, x) and a 0-d tensor numerator (true divisions);
    Python's number / x (reciprocal times the number); a number and a CPU
    0-d tensor divisor (a host scalar's reciprocal); ``c_card``, a 0-d
    tensor on the card, as a divisor (a division)."""
    def f(x, y, z):
        return (x ** -0.5 + torch.div(3.0, y) + torch.true_divide(3.0, z)
                + C0D / x + 3.0 / y + z / 7.0 + x / C0D + y / c_card
                + z ** 0.5 + x ** -1 + y ** -2 + z ** 3)
    return f


def rounding_check(dev):
    """Phase 25 (3): the emitted integrand alone (the check-only
    ``gen_values_kernel`` of csrc/gen_values.cu, ``cuda_rule.
    generated_values``) on
    ``rounding_forms`` at 2^20 points of (0.05, 2)^3, EQUAL to the
    callable's own PyTorch calls on the card (``integrand_gen.evaluate``)
    in f64 and f32; its time (``queued_ms``) beside its bound and the plain
    version's.  Returns the numbers of the kernels line."""
    c_card = torch.tensor(1.3, dtype=torch.float64, device=dev)
    t = integrand_gen.traced(rounding_forms(c_card), 3, "rounding_forms")
    g = torch.Generator(device="cpu").manual_seed(5)
    x64 = (0.05 + 1.95 * torch.rand((3, VALUES_POINTS), generator=g,
                                    dtype=torch.float64)).to(dev)
    err = 0.0
    for dtype in (torch.float64, torch.float32):
        x = x64.to(dtype)
        got = cuda_rule.generated_values(t, x)
        want = integrand_gen.evaluate(t.program, x.unbind(0))
        err = max(err, float((got - want).abs().max()))
        if not kernel_check.same_bits(got, want):
            bad = int((got != want).sum())
            fail(f"phase 25: the emitted rounding forms differ from the "
                 f"callable's own calls in {bad} of {got.numel()} values "
                 f"({dtype}; max |difference| {err!r})")
    print(f"phase 25: emitted division and power forms (rsqrt, true "
          f"divisions, a card 0-d divisor, reciprocals): "
          f"{VALUES_POINTS} values EQUAL to the callable's PyTorch calls "
          f"on the card in f64 and f32 (max |difference| {err!r})",
          flush=True)
    ms = queued_ms(lambda: cuda_rule.generated_values(t, x64), 5)
    plain = time_ms(lambda: integrand_gen.evaluate(t.program,
                                                   x64.unbind(0)), 3)
    t_ops = VALUES_POINTS * integrand_gen.program_ops(t.program) \
        / PEAK_OPS[torch.float64]
    t_bytes = VALUES_POINTS * 4 * 8 / PEAK_BYTES_PER_S
    b = 1e3 * max(t_ops, t_bytes)
    by = "operations" if t_ops >= t_bytes else "bytes"
    print(f"phase 25: the generated values kernel, {VALUES_POINTS} f64 "
          f"points: {ms:.4f} ms, plain {plain:.3f} ms, bound {b:.4f} ms "
          f"({by}, {100 * b / ms:.1f}% of it)", flush=True)
    return {"ms": ms, "plain_ms": plain, "bound_ms": b, "bound_by": by,
            "max_abs_err": err}


def generated_kernels(checks, pagani_launches, vegas_launches, walls,
                      value_launches):
    """The ``kernels`` line's entries of the generated family;
    ``value_launches`` the check-only values kernel's on the fused-backend
    main path."""
    rule, smp, vals = checks["rule"], checks["sampler"], checks["values"]
    return [{
        "name": "rule_eval_generated",
        "route": "cuda",
        "source": "gpuintegration_torch/csrc/gen_integrand.cu",
        "replaces": "gpuintegration_tpu/ops/pallas_rule.py:86",
        "held_against_plain_in": "phase 25 (f4_axes 8D tile f64 and f32 on "
                                 "2^21 regions, cos(sum x) 12D generic)",
        "launches": sum(pagani_launches.values()),
        "launches_by_route": pagani_launches,
        "max_abs_err": checks["max_abs_err"]["rule"],
        "ms": rule["ms"], "generic_route_ms": rule["generic_route_ms"],
        "genz_f4_tile_ms": rule["genz_f4_tile_ms"],
        "plain_ms": rule["plain_ms"], "bound_ms": rule["bound_ms"],
        "bound_by": rule["bound_by"], "library_ms": None,
        "generic_route_12d": checks["generic12"],
        "build_s": checks["build_s"], "walls_s": walls,
    }, {
        "name": "vegas_sample_generated",
        "route": "cuda",
        "source": "gpuintegration_torch/csrc/gen_integrand.cu",
        "replaces": "gpuintegration_tpu/mcubes/pallas_vegas.py:192",
        "held_against_plain_in": "phase 25 (g6 6D paired and generic on "
                                 "2^21 samples, g10 10D wide and "
                                 "generic)",
        "launches": sum(vegas_launches.values()),
        "launches_by_route": vegas_launches,
        "max_abs_err": checks["max_abs_err"]["sampler"],
        "ms": smp["ms"], "generic_route_ms": smp["generic_route_ms"],
        "genz_f4_paired_ms": smp["genz_f4_paired_ms"],
        "g10_wide_ms": smp["g10_wide_ms"],
        "g10_generic_route_ms": smp["g10_generic_route_ms"],
        "plain_ms": smp["plain_ms"], "bound_ms": smp["bound_ms"],
        "bound_by": smp["bound_by"], "library_ms": None,
    }, {
        # the check of the emitted integrand alone: no path launches it
        "name": "gen_values",
        "route": "cuda",
        "source": "gpuintegration_torch/csrc/gen_values.cu",
        "replaces": "gpuintegration_tpu/ops/pallas_rule.py:86",
        "counterpart_of": "the user's f_axes traced into the Pallas "
                          "kernels' bodies (the check of that part alone)",
        "held_against_plain_in": "phase 25 (integrand_gen.evaluate, EQUAL, "
                                 "f64 and f32, every division and power "
                                 "form)",
        "launches": value_launches,
        "max_abs_err": vals["max_abs_err"],
        "ms": vals["ms"], "plain_ms": vals["plain_ms"],
        "bound_ms": vals["bound_ms"], "bound_by": vals["bound_by"],
        "library_ms": None,
    }]


# ---------------------------------------------------------------------------
# The rule kernel's generic route in situ (phase 26)

GENERIC_NDIM = 10
GENERIC_EPSREL = 1e-3     # Workspace(10) on F4 at the main path's tolerance
def generic_times(dev):
    """Phase 4 (2): the generic route at the dimensions it serves, pools
    that give it some milliseconds (``tools/generic_times.py``'s
    ``SHAPES``: 2D, 10D, 12D, 16D), F4 and F5, f64 and f32: best of 3
    launches by CUDA events beside the bound, and the plain version once
    (``once_ms``) on F4 f64.  Returns the rows."""
    return generic_tool.other_dims(sys.modules[__name__], dev, plain=True,
                                   prefix="phase 4: generic route, ")


TILE_NDIMS = (3, 4, 5, 6, 7)


def tile_against_generic(dev):
    """Phase 4 (1b): the two routes where both run, 3D to 7D (8D above),
    on 2^21 random sub-regions, F1-F6, f64 and f32, without and with the
    crease fraction: tile, generic, generic, tile, each series the best of
    2 launches by CUDA events.  Returns the rows, the generic route's time
    over the tile route's in each."""
    big = 1 << 21
    rows = []
    for ndim in TILE_NDIMS:
        for dtype in (torch.float64, torch.float32):
            name = rule_eval.dtype_name(dtype)
            tables = rule_eval.rule_tables(ndim, name)
            lows, lengths = random_pool(ndim, big, 2, dtype, dev)
            gl = torch.zeros(ndim, dtype=dtype, device=dev)
            gr = torch.ones(ndim, dtype=dtype, device=dev)
            for g in genz.genz_suite(ndim):
                for frac in (False, True):
                    def run(route):
                        return time_ms(lambda: cuda_rule.cuda_apply_rule(
                            g, tables, lows, lengths, gl, gr, route=route,
                            with_split_frac=frac), 2)
                    t = [run("tile"), run("generic"), run("generic"),
                         run("tile")]
                    tile, generic = min(t[0], t[3]), min(t[1], t[2])
                    rows.append({"ndim": ndim, "dtype": name,
                                 "family": g.name, "frac": frac,
                                 "tile_ms": tile, "generic_ms": generic,
                                 "generic_over_tile": generic / tile})
                    print(f"phase 4: {ndim}D {g.name} {name} 2^21 regions"
                          f"{' with the fraction' if frac else ''}: tile "
                          f"route {tile:.3f} ms, generic route "
                          f"{generic:.3f} ms ({generic / tile:.3f} of the "
                          f"tile route's)", flush=True)
            del lows, lengths
            torch.cuda.empty_cache()
    ratios = [r["generic_over_tile"] for r in rows]
    print(f"phase 4: tile against generic, 3D-7D, {len(rows)} shapes: the "
          f"generic route faster in {sum(x < 1 for x in ratios)}, its time "
          f"over the tile route's {min(ratios):.3f} to {max(ratios):.3f}",
          flush=True)
    return rows


def generic_run(label, run, truth, eps, fused):
    """One run of the generic route's paths, counts set to 0 before: the
    host loop with CUDA events around each fused launch, the fused phase
    traced once more by torch.profiler for the kernel's device time (a
    replayed graph has no events of its own).  The result must certify
    (status 0, within ``eps`` of ``truth``) with every fused launch on the
    generic route and nothing on the split route.  Returns the row."""
    from torch.autograd import DeviceType

    from gpuintegration_torch.utils.profiling import trace
    events = []
    launch = cuda_rule.cuda_apply_rule

    def timed_launch(*args, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = launch(*args, **kw)
        end.record()
        events.append((start, end))
        return out

    cuda_rule.reset_launches()
    fused_loop.reset_stats()
    torch.cuda.synchronize()
    if not fused:
        cuda_rule.cuda_apply_rule = timed_launch
    t0 = time.perf_counter()
    try:
        res = run()
        torch.cuda.synchronize()
    finally:
        cuda_rule.cuda_apply_rule = launch
    wall = time.perf_counter() - t0
    launches = {"fused_kernel": cuda_rule.launches,
                "by_route": dict(cuda_rule.route_launches),
                "generated_by_route": dict(cuda_rule.generated_launches),
                "fraction_by_kernel": dict(cuda_rule.frac_route_launches),
                **cuda_rule.split_launches}
    stats = dict(fused_loop.stats)
    if fused:
        with tempfile.TemporaryDirectory() as log_dir:
            with trace(log_dir) as prof:
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                traced = run()
                torch.cuda.synchronize()
                traced_wall = time.perf_counter() - t1
            device = [e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and not e.is_user_annotation]
        kernel_s = sum(e.self_device_time_total for e in device
                       if "rule_generic_kernel" in e.key) / 1e6
        busy = sum(e.self_device_time_total for e in device) / 1e6
        share = f"{100 * kernel_s / traced_wall:.1f}% of the traced wall " \
                f"{traced_wall:.3f} s (torch.profiler; the device idle " \
                f"{100 * (1 - busy / traced_wall):.1f}%)"
        if traced.estimate != res.estimate:
            fail(f"{label}: the traced rerun differs from the run")
    else:
        kernel_s = sum(a.elapsed_time(b) for a, b in events) / 1e3
        traced_wall = None
        share = f"{100 * kernel_s / wall:.1f}% of the wall (CUDA events)"
    rel = abs(res.estimate - truth) / abs(truth)
    print(f"phase 26: {label}, {'fused' if fused else 'host loop'}: status "
          f"{res.status} estimate {res.estimate!r} truth {truth!r} rel.err "
          f"{rel:.3e} iters {res.iters} nregions {res.nregions} neval "
          f"{res.neval} wall {wall:.3f} s; launches {launches}; bursts "
          f"{stats}; the generic kernel {kernel_s:.4f} s, {share}",
          flush=True)
    generic = launches["by_route"]["generic"]
    if res.status != 0 or not rel <= eps or generic <= 0 \
            or generic != launches["fused_kernel"] \
            or launches["points"] or launches["contract"]:
        fail(f"{label}: status {res.status}, rel.err {rel}, launches "
             f"{launches}; every launch should take the generic route")
    return {"run": label, "fused": fused, "status": res.status,
            "estimate": res.estimate, "rel_err": rel, "iters": res.iters,
            "nregions": res.nregions, "neval": res.neval, "wall_s": wall,
            "launches": launches, "kernel_s": kernel_s,
            "traced_wall_s": traced_wall, "result": res}


def generic_in_situ(dev, sin12):
    """Phase 26: the main path's entry point at the dimensions the generic
    route serves, no cut: ``Workspace(10).integrate(f4_gaussian(10),
    GENERIC_EPSREL)`` in f64 in the host loop and the fused phase (the
    same decisions); a 12D per-axis sin(x_1 + ... + x_12) under
    ``rule_backend='fused'`` at ``SIN12_EPSREL`` (the generated generic
    kernel), held to the closed form and to phase 11's split-route run
    ``sin12``; phase 16's 2D F5 crease run at 1e-9 (the generic kernel with
    the fraction).  Returns the rows."""
    g10 = genz.f4_gaussian(GENERIC_NDIM)
    rows = []
    for fused in (False, True):
        rows.append(generic_run(
            f"f64 {GENERIC_NDIM}D f4_gaussian epsrel {GENERIC_EPSREL:g}",
            lambda: Workspace(GENERIC_NDIM).integrate(
                g10, GENERIC_EPSREL, 1e-40, fused=fused),
            g10.true_value, GENERIC_EPSREL, fused))
    host, fusd = rows[0]["result"], rows[1]["result"]
    if (host.status, host.iters, host.nregions, host.neval) != (
            fusd.status, fusd.iters, fusd.nregions, fusd.neval):
        fail("phase 26: the fused 10D run differs from the host loop's")
    g12, f12 = misc.sin_sum(12), sin_axes(12)
    row = generic_run(
        f"f64 12D sin(x_1 + ... + x_12) per-axis, rule_backend='fused', "
        f"epsrel {SIN12_EPSREL:g}",
        lambda: Workspace(12, rule_backend="fused").integrate(
            f12, SIN12_EPSREL, 1e-40), g12.true_value, SIN12_EPSREL, True)
    rows.append(row)
    apart = abs(row["estimate"] - sin12.estimate) / abs(g12.true_value)
    print(f"phase 26: the fused backend's 12D run against phase 11's split "
          f"route: estimates {row['estimate']!r} and {sin12.estimate!r}, "
          f"{apart:.3e} of the truth apart; iters {row['iters']} / "
          f"{sin12.iters}, nregions {row['nregions']} / {sin12.nregions}, "
          f"generated launches {row['launches']['generated_by_route']}",
          flush=True)
    if not apart <= SIN12_EPSREL or \
            row["launches"]["generated_by_route"]["generic"] \
            != row["launches"]["fused_kernel"]:
        fail("phase 26: the fused backend's 12D run is not phase 11's or "
             "not all on the generated generic kernel")
    g2 = genz.f5_c0_continuous(2, a=10.0, b=0.37)
    row = generic_run("f64 2D f5_c0 crease epsrel 1e-9",
                      lambda: Workspace(2).integrate(
                          g2, 1e-9, 1e-40, crease_split=True, fused=False),
                      g2.true_value, 3e-9, False)
    if row["launches"]["fraction_by_kernel"]["generic"] \
            != row["launches"]["fused_kernel"]:
        fail("phase 26: the 2D crease run's fractions not all on the "
             "generic kernel")
    rows.append(row)
    for r in rows:
        del r["result"]
    return rows


def _launch_totals(launches) -> dict:
    """A case's launches on a rank by the kernels line's names."""
    return {"rule_eval": launches["rule_total"],
            "rule_split_points": launches["split"]["points"],
            "rule_split_contract": launches["split"]["contract"],
            "rule_contract_components": launches["split"]["contract"],
            "vegas_sample": launches["sampler_total"],
            "vegas_hist": sum(launches["hist"].values()),
            "vegas_bin_resolve": sum(launches["resolve"].values())}


def main() -> int:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no CUDA card")
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    # -- phase 1: build ------------------------------------------------------
    phase_t0 = t0 = time.perf_counter()
    sources = ["rule_eval.cu", "vegas_sample.cu", "vegas_lookup.cu",
               "rule_split.cu", "split_frac.cu"]
    # and phase 25's generated libraries of f4_axes and cos(sum x) at 12D,
    # and phase 7's 20D one
    libs = cuda_build.build_many(sources, [
        integrand_gen.header(t.program) for t in GEN_PHASE1 + (GEN_GAUSS20,)])
    print(f"phase 1: built {len(libs)} libraries with nvcc in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for lib in libs:
        log = lib.with_suffix(".log").read_text()
        print(f"phase 1: {lib.name}: ptxas: {ptxas_summary(log)}; "
              f"{log.strip().splitlines()[-1]}", flush=True)
        if lib.name.startswith(("librule_eval", "librule_split",
                                "libsplit_frac", "libgen_integrand")):
            for name, (regs, spills, stack) in ptxas_by_kernel(log).items():
                print(f"phase 1: ptxas: {name}: {regs} registers, {spills} "
                      f"spill bytes, {stack} bytes stack frame", flush=True)

    try:
        sass = sass_report.report()
        sass_report.show(sass)
    except (RuntimeError, OSError, subprocess.CalledProcessError) as e:
        sass = None
        print(f"phase 1: no SASS report ({e})", flush=True)

    def phase_done(name):
        nonlocal phase_t0
        now = time.perf_counter()
        print(f"{name} took {now - phase_t0:.1f} s", flush=True)
        phase_t0 = now

    phase_done("phase 1")

    # -- phase 2: kernel vs plain version ------------------------------------
    cap = 1 << 16
    n = cap - (cap >> 3)           # blocked pool with padding slots
    for dtype in (torch.float64, torch.float32):
        tables = rule_eval.rule_tables(NDIM, rule_eval.dtype_name(dtype))
        lows, lengths = random_pool(NDIM, cap, 1, dtype, dev)
        gl = torch.zeros(NDIM, dtype=dtype, device=dev)
        gr = torch.ones(NDIM, dtype=dtype, device=dev)
        for g in genz.genz_suite(NDIM):
            compare(f"phase 2: {g.name} {str(dtype)[6:]}", g, tables, lows,
                    lengths, gl, gr, n=n, blocked=True, route="tile")
            compare_routes(f"phase 2: {g.name} {str(dtype)[6:]}", g, tables,
                           lows, lengths, gl, gr, n=n, blocked=True)
    # the generic route at shapes the tile route does not take: each of
    # its classes of dimensions, every family at 10D, 12D and 16D
    generic_err = 0.0
    for ndim, small_cap, suite in ((9, 1 << 12, False), (2, 1 << 14, False),
                                   (10, 1 << 11, True), (12, 1 << 10, True),
                                   (16, 1 << 7, True)):
        if cuda_rule.rule_route(ndim) != "generic":
            fail(f"a {ndim}D pool should take the rule kernel's generic route")
        for dtype in (torch.float64, torch.float32):
            if dtype == torch.float32 and not suite:
                continue
            tables = rule_eval.rule_tables(ndim, rule_eval.dtype_name(dtype))
            lows, lengths = random_pool(ndim, small_cap, 3, dtype, dev)
            gl = torch.zeros(ndim, dtype=dtype, device=dev)
            gr = torch.ones(ndim, dtype=dtype, device=dev)
            for g in (genz.genz_suite(ndim) if suite else (
                    genz.f4_gaussian(ndim), genz.f1_oscillatory(ndim))):
                r = compare(f"phase 2: generic route {ndim}D {g.name} "
                            f"{str(dtype)[6:]}", g, tables, lows, lengths,
                            gl, gr, n=small_cap - (small_cap >> 3),
                            blocked=True)
                generic_err = max(generic_err, r["max_abs_est"])

    phase_done("phase 2")

    # -- phase 3: the main path ----------------------------------------------
    # CUDA events around each launch give the kernel's share of the wall.
    kernel_events = []
    launch = cuda_rule.cuda_apply_rule

    def timed_launch(*args, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = launch(*args, **kw)
        end.record()
        kernel_events.append((start, end))
        return out

    g4 = genz.f4_gaussian(NDIM)
    ws = Workspace(NDIM)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    cuda_rule.cuda_apply_rule = timed_launch
    cuda_rule.reset_launches()
    t0 = time.perf_counter()
    try:
        res = ws.integrate(g4, epsrel=1e-3, epsabs=1e-40, **HOST)
        torch.cuda.synchronize()
    finally:
        cuda_rule.cuda_apply_rule = launch
    wall = time.perf_counter() - t0
    main_launches = cuda_rule.launches
    main_routes = dict(cuda_rule.route_launches)
    kernel_s = sum(s.elapsed_time(e) for s, e in kernel_events) / 1e3
    rel = abs(res.estimate - g4.true_value) / g4.true_value
    print(f"phase 3: f64 8D f4_gaussian epsrel 1e-3: status {res.status} "
          f"estimate {res.estimate!r} errorest {res.errorest!r} truth "
          f"{g4.true_value!r} rel.err {rel:.3e} iters {res.iters} nregions "
          f"{res.nregions} neval {res.neval} wall {wall:.3f} s evals/s "
          f"{res.neval / wall:.4e} peak capacity {ws.peak_capacity} peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"kernel launches {main_launches} (by route {main_routes}), "
          f"kernel time {kernel_s:.4f} s "
          f"({100 * kernel_s / wall:.1f}% of the wall, CUDA events)",
          flush=True)
    if res.status != 0 or not rel <= 1e-3:
        fail(f"main path: status {res.status}, rel.err {rel}")
    if main_launches <= 0 or main_routes["tile"] != main_launches:
        fail(f"main path: {main_launches} launches of the CUDA rule kernel, "
             f"by route {main_routes}; all should take the tile route")
    final_lows, final_lengths, final_n, final_blocked = ws.final_pool

    ws32 = Workspace(NDIM, dtype=torch.float32)
    t0 = time.perf_counter()
    r32 = ws32.integrate(g4, epsrel=1e-3, epsabs=1e-40, **HOST)
    torch.cuda.synchronize()
    rel32 = abs(r32.estimate - g4.true_value) / g4.true_value
    print(f"phase 3: f32 8D f4_gaussian epsrel 1e-3: status {r32.status} "
          f"rel.err {rel32:.3e} iters {r32.iters} nregions {r32.nregions} "
          f"wall {time.perf_counter() - t0:.3f} s", flush=True)
    lo32, len32, n32, blocked32 = ws32.final_pool
    compare(f"f32 main-path pool ({n32} regions)", g4,
            rule_eval.rule_tables(NDIM, "float32"), lo32, len32,
            torch.zeros(NDIM, dtype=torch.float32, device=dev),
            torch.ones(NDIM, dtype=torch.float32, device=dev),
            n=n32, blocked=blocked32, min_agree=0.0)
    del ws32, lo32, len32

    g3 = genz.f4_gaussian(3, a=5.0)
    on_card = Workspace(3, chunk_size=1024).integrate(g3, 1e-5, 1e-40,
                                                      **HOST)
    on_cpu = Workspace(3, chunk_size=1024, device="cpu").integrate(
        g3, 1e-5, 1e-40, **HOST)
    same = ((on_card.status, on_card.iters, on_card.nregions, on_card.neval)
            == (on_cpu.status, on_cpu.iters, on_cpu.nregions, on_cpu.neval)
            and math.isclose(on_card.estimate, on_cpu.estimate,
                             rel_tol=1e-10))
    print(f"phase 3: 3D f4 card vs cpu: {on_card.estimate!r} vs "
          f"{on_cpu.estimate!r}, iters {on_card.iters}/{on_cpu.iters}, "
          f"nregions {on_card.nregions}/{on_cpu.nregions}", flush=True)
    if not same:
        fail("3D run on the card differs from the same run on the CPU")

    # -- the kernel at the main path's shapes: its last pool, f64 F4 ---------
    tables64 = rule_eval.rule_tables(NDIM, "float64")
    gl = torch.zeros(NDIM, dtype=torch.float64, device=dev)
    gr = torch.ones(NDIM, dtype=torch.float64, device=dev)
    main_args = (g4, tables64, final_lows, final_lengths, gl, gr)
    main_kw = {"n": final_n, "blocked": final_blocked}
    d_main = compare(f"f64 main-path pool ({final_n} regions, capacity "
                     f"{final_lows.shape[1]})", *main_args, **main_kw,
                     min_agree=0.0)["max_abs_est"]
    compare_routes("f64 main-path pool", *main_args, **main_kw)

    def routed(route):
        return lambda: cuda_rule.cuda_apply_rule(*main_args, **main_kw,
                                                 route=route)

    # tile, generic, generic, tile: the two within one call
    t = [time_ms(routed("tile"), 5), time_ms(routed("generic"), 2),
         time_ms(routed("generic"), 2), time_ms(routed("tile"), 5)]
    ms_main, generic_main = min(t[0], t[3]), min(t[1], t[2])
    plain_main = time_ms(lambda: rule_eval.apply_rule_plain(
        *main_args, chunk_size=ws.chunk_size, **main_kw), 2)
    b_main, by_main = bound_ms(4, NDIM, final_n, torch.float64)
    f64_per_point = tile_f64_per_point(sass)
    floor = "not measured (no SASS report)"
    if f64_per_point is not None:
        floor_ms = f64_pipe_floor_ms(NDIM, final_n, f64_per_point)
        floor = (
             f"{floor_ms:.3f} ms ({ms_main / floor_ms:.2f} times it; "
             f"{f64_per_point:g} f64 instructions a point in this "
             f"build's machine code, {NDIM + 1} of them the axes' and the "
             f"sum's, the rest the exp's; at the bound's "
             f"{PEAK_OPS[torch.float64] / 1e12:g} TFLOP/s)")
    print(f"main-path pool: tile route {ms_main:.4f} ms (two series "
          f"{t[0]:.4f}, {t[3]:.4f}), generic route {generic_main:.4f} ms "
          f"({t[1]:.4f}, {t[2]:.4f}), plain {plain_main:.3f} ms, bound "
          f"{b_main:.4f} ms ({by_main}, {100 * b_main / ms_main:.1f}% of it), "
          f"f64 pipe floor {floor}", flush=True)

    phase_done("phase 3")

    # -- phase 4: kernel time on 2^21 regions --------------------------------
    big = 1 << 21
    for dtype in (torch.float64, torch.float32):
        tables = rule_eval.rule_tables(NDIM, rule_eval.dtype_name(dtype))
        lows, lengths = random_pool(NDIM, big, 2, dtype, dev)
        gl = torch.zeros(NDIM, dtype=dtype, device=dev)
        gr = torch.ones(NDIM, dtype=dtype, device=dev)
        for g in genz.genz_suite(NDIM):
            ms, generic = (time_ms(lambda: cuda_rule.cuda_apply_rule(
                g, tables, lows, lengths, gl, gr, route=route), reps)
                for route, reps in (("tile", 5), ("generic", 3)))
            b, by = bound_ms(g.kind, NDIM, big, dtype)
            line = (f"phase 4: {g.name} {str(dtype)[6:]} 2^21 regions: tile "
                    f"route {ms:.3f} ms = "
                    f"{big * tables.feval / ms * 1e3:.4e} evals/s, generic "
                    f"route {generic:.3f} ms, bound {b:.3f} ms ({by}, "
                    f"{100 * b / ms:.1f}% of it)")
            if g.kind == 4:
                plain = time_ms(lambda: rule_eval.apply_rule_plain(
                    g, tables, lows, lengths, gl, gr, chunk_size=4096), 2)
                line += f", plain {plain:.1f} ms"
            print(line, flush=True)
        del lows, lengths
        torch.cuda.empty_cache()

    tile_rows = tile_against_generic(dev)
    generic_rows = generic_times(dev)

    phase_done("phase 4")

    # -- phases 5-7: VEGAS ---------------------------------------------------
    vegas_err = vegas_checks(dev)
    counter_checks(dev)
    high_err = high_dim_checks(dev)
    phase_done("phase 5")
    vegas_launches, vegas_walls, vegas_runs = vegas_main_path(dev)
    phase_done("phase 6")
    vegas_kernels = vegas_times(dev, vegas_err, vegas_launches, vegas_walls)
    new_times = new_route_times(dev)
    resolve_rows = wide_resolve_times(dev)
    high_times = high_dim_times(dev)
    wide_regs = wide_resolve_registers()
    print(f"phase 7: the wide bin resolve's instances (registers, spill "
          f"bytes, stack frame bytes): {wide_regs}", flush=True)
    regs = vegas_registers()
    # hist_max_clusters counts the run-time 17..32D histogram's registers
    hist_regs = {t: regs.get(f"hist_grouped_kernel<0, {t}>")
                 for t in ("float", "double")}
    print(f"phase 7: registers of the run-time histogram instances: "
          f"{hist_regs} (hist_max_clusters counts "
          f"{cuda_lookup.HIST_RUNTIME_REGISTERS})", flush=True)
    if not all(r is not None and r <= cuda_lookup.HIST_RUNTIME_REGISTERS
               for r in hist_regs.values()):
        fail(f"the run-time histogram takes {hist_regs} registers, more than "
             f"cuda_lookup.HIST_RUNTIME_REGISTERS "
             f"({cuda_lookup.HIST_RUNTIME_REGISTERS}) that its clusters "
             "are counted with")
    path_regs = {k: regs.get(k) for k in (
        f"sample_pair_kernel<0, {VEGAS_NDIM}>",
        f"sample_pair_kernel<4, {VEGAS_NDIM}>",
        f"resolve_sample_kernel<{VEGAS_NDIM}, true>")}
    print(f"phase 7: registers of the path's VEGAS kernels (each reads the "
          f"iteration word from a device counter): {path_regs}", flush=True)
    for entry in vegas_kernels:
        entry["registers"] = path_regs
    phase_done("phase 7")

    # -- phase 8: the diff path ----------------------------------------------
    edge_launches, edge_routes, edge_err, edge_fields = diff_path(dev)
    for entry in vegas_kernels:
        if entry["name"] == "vegas_edge_lookup":
            entry.update(launches=edge_launches,
                         launches_by_route=edge_routes,
                         max_abs_err=max(entry["max_abs_err"], edge_err),
                         **edge_fields)
    phase_done("phase 8")

    # -- phases 9-12: the split route, the continuation ----------------------
    split_err = split_checks(dev)
    comp_err = components_checks(dev)
    phase_done("phase 9")
    split_ms, b_points, contract_rows = split_times(dev)
    comp_rows = components_times(dev)
    phase_done("phase 10")
    split_launches, contract_routes, sin12, sin8 = split_main_path(dev, res)
    phase_done("phase 11")
    continuation_path(dev)
    phase_done("phase 12")

    # -- phases 13-14: vector integrands ------------------------------------
    vec_launches, vec_routes, vec_situ, vec_walls, vec_run = \
        vector_main_path(dev, sin12)
    phase_done("phase 13")
    vegas_vec_launches, vegas_vec_walls = vector_vegas(dev)
    print(f"phase 14: walls: poly {vegas_vec_walls['poly']:.3f} s, grid "
          f"{vegas_vec_walls['grid']:.3f} s", flush=True)
    phase_done("phase 14")

    # -- phases 15-17: crease/jump-aware splits, the fused phase ------------
    frac_rows = split_frac_checks(dev, main_args, main_kw)
    phase_done("phase 15")
    frac_launches, crease_rows = crease_path(dev)
    phase_done("phase 16")
    fused_rows = fused_main_path(dev, res, vec_run)
    phase_done("phase 17")

    # -- phases 18-19: VEGAS's device-resident phases, vegas_assisted -------
    phase_rows = vegas_device_phases(dev)
    phase_done("phase 18")
    assisted_row = assisted_path(dev)
    phase_done("phase 19")

    # -- phases 20-23: one-shot, heuristics, interpolation and the physics
    # likelihood, Suave, 1-D quadrature -------------------------------------
    slice_t0 = time.perf_counter()
    oneshot_counts, oneshot_walls = oneshot_path(dev)
    phase_done("phase 20")
    physics_row = physics_path(dev)
    phase_done("phase 21")
    suave_row = suave_path(dev)
    phase_done("phase 22")
    quad_rows = quad1d_path(dev)
    phase_done("phase 23")
    print(f"phases 20-23 took {time.perf_counter() - slice_t0:.1f} s",
          flush=True)

    # -- phase 24: the mesh (parallel/, tools/mesh_cases.py) ----------------
    mesh_launches = mesh_path(dev, res, fused_rows.pop("f4_fused_run"),
                              vegas_runs, sin8)
    phase_done("phase 24")

    # -- phase 25: any scalar-per-axis callable inside the fused kernels,
    # and the recorder, the CLI and the continuation log on the card ------
    gen_checks = generated_checks(dev)
    gen_walls = {"phase3": wall, "phase17": fused_rows["f4_walls_s"]["fused"],
                 "phase11": SPLIT_WALLS[f"f64 {NDIM}D F4 as a plain callable"]}
    gen_launches, gen_res, gen_wall, gen_stats, gen_value_launches = \
        generated_pagani(dev, gen_walls)
    gen_vegas_launches, gen_vegas_walls = generated_vegas(dev)
    a17_on_card(dev, gen_res)
    phase_done("phase 25")

    # -- phase 26: the generic route in situ --------------------------------
    situ_rows = generic_in_situ(dev, sin12)
    phase_done("phase 26")

    # -- phase 27: BASELINE's 9D VEGAS Gaussian -----------------------------
    gauss9d_rows = gauss9d_path(dev, new_times)
    phase_done("phase 27")

    # -- phase 28: BASELINE's 9D VEGAS on the grid map ----------------------
    grid9d_rows = grid9d_path(dev, resolve_rows)
    phase_done("phase 28")

    # -- phase 29: VEGAS past 16D -------------------------------------------
    high_rows = high_dim_path(dev, high_times)
    phase_done("phase 29")

    # -- phase 30: the kernels line, the card line, the result line ---------
    kernels = [{
        "name": "rule_eval",
        "route": "cuda",
        "source": "gpuintegration_torch/csrc/rule_eval.cu",
        "replaces": "gpuintegration_tpu/ops/pallas_rule.py:86",
        "held_against_plain_in": "phase 2 (F1-F6 8D, f64 and f32) and the "
                                 "main-path pool",
        "launches": main_launches,
        "launches_by_route": main_routes,
        "max_abs_err": d_main,
        "ms": ms_main,
        "generic_route_ms": generic_main,
        "generic_route": {
            "max_abs_err": generic_err,
            "shapes": generic_rows,
            "tile_against_generic_3d_7d": tile_rows,
            "in_situ": situ_rows},
        "plain_ms": plain_main,
        "bound_ms": b_main,
        "bound_by": by_main,
        "library_ms": None,
    }] + vegas_kernels + [{
        "name": "rule_split_points",
        "route": "cuda",
        "source": "gpuintegration_torch/csrc/rule_split.cu",
        "replaces": "gpuintegration_tpu/ops/pallas_rule.py:86",
        "held_against_plain_in": "phase 9 (EQUAL to rule_eval.rule_points)",
        "launches": split_launches["points"],
        "max_abs_err": 0.0,
        "ms": split_ms["points"],
        "plain_ms": split_ms["plain_points"],
        "bound_ms": b_points,
        "bound_by": "bytes",
        "library_ms": split_ms["addcmul"],
    }, {
        # one kernel, two routes (the house pattern of rule_eval above): the
        # numbers at the split main path's shape, the 8D f64 chunk with its
        # values as rows, and each route's at every timed shape
        "name": "rule_split_contract",
        "route": "cuda",
        "source": "gpuintegration_torch/csrc/rule_split.cu",
        "replaces": "gpuintegration_tpu/ops/pallas_rule.py:86",
        "held_against_plain_in": "phase 9 (rule_eval.rule_outputs; both "
                                 "routes, 2D-16D, f64 and f32)",
        "launches": split_launches["contract"],
        "launches_by_route": contract_routes,
        "max_abs_err": max(split_err.values()),
        "ms": contract_rows[0]["cluster_ms"],
        "generic_route_ms": contract_rows[0]["generic_ms"],
        "l2_flushed_ms": contract_rows[0]["cluster_l2_flushed_ms"],
        "generic_route_l2_flushed_ms":
            contract_rows[0]["generic_l2_flushed_ms"],
        "plain_ms": contract_rows[0]["plain_ms"],
        "bound_ms": contract_rows[0]["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "sums_only_matmul_ms": contract_rows[0]["sums_only_matmul_ms"],
        "by_route": {
            route: {"launches": contract_routes[route],
                    "max_abs_err": split_err[route],
                    "shapes": [{
                        "shape": f"{r['ndim']}D {r['dtype']} {r['count']} x "
                                 f"{r['feval']} {r['layout']}",
                        "ms": r[f"{route}_ms"], "bound_ms": r["bound_ms"],
                        "plain_ms": r["plain_ms"],
                        "sums_only_matmul_ms": r["sums_only_matmul_ms"]}
                        for r in contract_rows]}
            for route in cuda_rule.CONTRACT_ROUTES},
    }, {
        # a vector integrand's contraction, two routes (the house pattern
        # of rule_split_contract above): the numbers at phase 13's shape,
        # the 8D f64 chunk of four components, component-minor, on the
        # route the path takes, and each route's at every timed shape
        "name": "rule_contract_components",
        "route": "cuda",
        "source": "gpuintegration_torch/csrc/rule_split.cu",
        "replaces": "gpuintegration_tpu/ops/pallas_rule.py:86",
        "counterpart_of": "gpuintegration_tpu/ops/rule_eval.py:386 "
                          "(_eval_chunk_vector, XLA in the reference)",
        "held_against_plain_in": "phase 9 (rule_eval.rule_outputs_vector; "
                                 "3D, 8D, 12D, f64 and f32, 2-8 components; "
                                 "both routes)",
        "launches": sum(vec_routes[r] for r in cuda_rule.VECTOR_ROUTES),
        "launches_by_route": {r: vec_routes[r]
                              for r in cuda_rule.VECTOR_ROUTES},
        "max_abs_err": max(comp_err.values()),
        "ms": comp_rows[0]["components_cluster_ms"],
        "components_route_ms": comp_rows[0]["components_ms"],
        "plain_ms": comp_rows[0]["plain_ms"],
        "bound_ms": comp_rows[0]["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "sums_only_matmul_ms": comp_rows[0]["sums_only_matmul_ms"],
        "cluster_route_each_component_ms": comp_rows[0]["cluster_each_ms"],
        "in_situ_by_route": vec_situ,
        "by_route": {
            route: {"launches": vec_routes[route],
                    "max_abs_err": comp_err[route],
                    "in_situ_ms": vec_situ[route]["ms"],
                    "shapes": [{
                        "shape": f"{r['ndim']}D float64 {r['count']} x "
                                 f"{r['feval']} x {r['ncomp']} "
                                 "component-minor",
                        "ms": r[f"{route}_ms"], "bound_ms": r["bound_ms"],
                        "plain_ms": r["plain_ms"],
                        "sums_only_matmul_ms": r["sums_only_matmul_ms"]}
                        for r in comp_rows]}
            for route in cuda_rule.VECTOR_ROUTES},
        "vector_paths": {"pagani_split_launches": vec_launches,
                         "pagani_walls_s": vec_walls,
                         "vegas_launches": vegas_vec_launches,
                         "vegas_walls_s": vegas_vec_walls},
    }, {
        # the standalone split fraction kernel: the check of the folded
        # forms below; no crease run launches it (phase 16 counts it). The
        # numbers at the Workspace's 8D f64 chunk, values as rows
        "name": "rule_split_fraction",
        "route": "cuda",
        "source": "gpuintegration_torch/csrc/split_frac.cu",
        "replaces": "gpuintegration_tpu/ops/pallas_rule.py:86",
        "counterpart_of": "gpuintegration_tpu/ops/rule_eval.py:184 "
                          "(_split_fraction, XLA in the reference)",
        "held_against_plain_in": "phase 15 (rule_eval.split_fraction; 8D "
                                 "and 12D f64, 8D f32, rows and planes, a "
                                 "NaN region: EQUAL)",
        "launches": sum(r["launches"]["split_frac"] for r in crease_rows),
        "max_abs_err": max(r["max_abs_err"] for r in frac_rows["standalone"]),
        "ms": frac_rows["standalone"][0]["ms"],
        "plain_ms": frac_rows["standalone"][0]["plain_ms"],
        "bound_ms": frac_rows["standalone"][0]["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "shapes": frac_rows["standalone"],
    }] + folded_fraction_kernels(frac_rows, frac_launches, crease_rows,
                                 fused_rows)
    # the bin resolve's wide route (9..16D): the numbers at the 9D chunk of
    # the grid map's 1e9 run, drawing xn with ids out, as its adjusting
    # iterations launch it; launches of phase 28's 9D F4 run on it
    row9 = resolve_rows[0]
    d9 = row9["drawing xn, ids out"]
    kernels.append({
        "name": "vegas_bin_resolve_wide",
        "route": "cuda",
        "source": "gpuintegration_torch/csrc/vegas_lookup.cu",
        "replaces": "gpuintegration_tpu/mcubes/pallas_lookup.py:152",
        "held_against_plain_in": "phase 5 (9D, 12D and 16D on the 1e9 "
                                 "runs' chunks, drawing xn and given xn, "
                                 "past the lattice's end and ragged: rc, "
                                 "xo, ia EQUAL to the generic route; ia, xo "
                                 "EQUAL to the plain version, rc within "
                                 f"{vegas_check.RC_ULP} ulps)",
        "launches": grid9d_rows[0]["launches"]["vegas_bin_resolve"],
        "launches_by_run": {f"{r['label']} ({r['form']} form)":
                            r["resolve_routes"] for r in grid9d_rows},
        "max_abs_err": vegas_err["vegas_bin_resolve_wide"],
        "ms": d9["ms"],
        "generic_route_ms": d9["generic_route_ms"],
        "plain_ms": row9["plain_ms"],
        "bound_ms": d9["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "edges_only_two_gathers_ms": row9["edges_only_two_gathers_ms"],
        "registers": wide_regs,
        "shapes": resolve_rows,
        "grid_map_9d_runs": grid9d_rows})
    vegas_kernels[0]["vegas_phases"] = phase_rows
    # the routes redesigned for 1D, 2D and 9..16D: times (phase 7) and the
    # launches of phase 27's 9D runs
    for entry, key, name, routes in (
            (vegas_kernels[0], "sampler", "vegas_sample", "sampler_routes"),
            (vegas_kernels[1], "hist", "vegas_hist", "hist_routes")):
        entry["new_routes"] = new_times[key]
        entry["launches_phase_27_9d"] = [
            {"run": r["label"], "form": r["form"],
             "launches": r["launches"][name], "by_route": r[routes],
             "status": r["status"], "wall_s": r["wall_s"],
             "kernels_share": r["kernels_share"]} for r in gauss9d_rows]
    kernels[0]["vegas_assisted_run"] = assisted_row
    # the launches of phases 20-21's paths, each counted from 0 over its run
    phys_fused, phys_host = physics_row["fused"], physics_row["host"]
    by_name = {k["name"]: k for k in kernels}
    by_name["rule_eval"]["launches_phases_20_21"] = {
        "phase 20 apply_cubature_rules F4 (tile)":
            oneshot_counts["tile"]["fused"]}
    for name, key in (("rule_split_points", "points"),
                      ("rule_split_contract", "contract")):
        by_name[name]["launches_phases_20_21"] = {
            "phase 20 apply_cubature_rules F4 as a callable":
                oneshot_counts["split"]["split"][key],
            "phase 21 ClusterLikelihood fused=True (captures counted once)":
                phys_fused["split"][key],
            "phase 21 ClusterLikelihood host loop": phys_host["split"][key]}
    by_name["rule_split_points"]["launches_phases_20_21"][
        "phase 20 apply_cubature_rules_vector"] = \
        oneshot_counts["vector"]["split"]["points"]
    by_name["rule_contract_components"]["launches_phases_20_21"] = {
        "phase 20 apply_cubature_rules_vector":
            oneshot_counts["vector"]["split"]["contract"]}
    by_name["vegas_sample"]["launches_phase_21"] = {
        "phase 21 VEGAS cross-check": physics_row["vegas_b2"]}
    by_name["vegas_hist"]["launches_phase_21"] = {
        "phase 21 VEGAS cross-check": physics_row["vegas_b3"]}
    # each rank's launches on phase 24's D = 2 mesh, by case
    for name, case in (("rule_eval", "main"), ("rule_split_points", "sin_sum"),
                       ("rule_split_contract", "sin_sum"),
                       ("rule_contract_components", "vector"),
                       ("vegas_sample", "vegas_run1"),
                       ("vegas_hist", "vegas_run1"),
                       ("vegas_bin_resolve", "vegas_run3")):
        by_name[name]["launches_phase_24_mesh_d2_a_rank"] = {
            case: [t[name] for t in mesh_launches[case]]}
    kernels[0]["slice_13_paths"] = {
        "oneshot_walls_s": oneshot_walls, "physics": physics_row,
        "suave": suave_row, "quad1d": quad_rows}
    kernels += generated_kernels(
        gen_checks, gen_launches, gen_vegas_launches,
        {"pagani_fused_backend": gen_wall, "pagani_fused_stats": gen_stats,
         "vegas": gen_vegas_walls}, gen_value_launches)
    # VEGAS past 16D: each kernel's rows at the chunks of phase 29's
    # lattices (phase 7), its largest difference read (phase 5) and its
    # launches in phase 29's runs, each counted from 0 over its run
    by_name = {k["name"]: k for k in kernels}
    for name, key, launched in (
            ("vegas_sample", "sampler", "vegas_sample"),
            ("vegas_hist", "hist", "vegas_hist"),
            ("vegas_bin_resolve_wide", "resolve", "vegas_bin_resolve"),
            ("vegas_edge_lookup", "edge", None)):
        by_name[name]["past_16d"] = {
            "shapes": high_times[key],
            "max_abs_err": high_err.get(name, 0.0),
            "launches_phase_29": {r["label"]: r["launches"][launched]
                                  for r in high_rows} if launched else None}
    by_name["vegas_sample_generated"]["past_16d"] = high_times["generated"]
    by_name["vegas_sample"]["phase_29_runs"] = [
        {k: r[k] for k in ("label", "ndim", "a", "status", "pull", "iters",
                           "wall_s", "launches", "sampler_routes",
                           "hist_routes", "resolve_routes",
                           "kernels_alone_s", "kernels_share")}
        for r in high_rows]
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
