#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (fourc_tpu_torch) on one NVIDIA GPU.

Usage, from the repository root on a machine with a CUDA device and nvcc:

    python3 chip_smoke.py

Phases (each prints its lines, and ``[phase] <name>: start`` before them;
a phase that raises prints ``[phase] <name>: FAILED ...`` with the
exception, and the exit code is 1; run without the repository around it,
the script prints ``[phase] import: FAILED ...`` and exits 1 before any
phase):

1. environment: GPU name and power limit, torch/CUDA versions, nvcc, triton;
2. build: compiles both sources of fourc_tpu_torch/csrc with nvcc for
   sm_90a, one nvcc process each, started together;
3. kernels: each CUDA kernel against its plain PyTorch twin on the card, at
   n=16 and at its path's full size (B5's linear mode also on the coarse
   GMG levels of the jittered path, n=36, 18 and 9), in float64 (max
   relative error <= 1e-10) and float32 (<= 1e-4), plus kernel and twin
   times at full size in float32.  A kernel's ``ms`` is its device time
   per call from a CUDA graph of 20 calls; ``loop_ms`` is a plain loop of
   20 wrapper calls, which reads the host's time per call where that is
   longer (twins: a plain loop).  B1-B3 run on the uniform box and B4-B5 on the jittered box
   (n=72), B6-B7 on element batches of the permuted box (n=56);
4. correctness: two gen-alpha steps at n=6 in float64 on the GPU (kernels)
   against the same steps on the CPU (twins, which tests/port holds to the
   JAX package), max relative error <= 1e-9, for the flagship, the jittered
   box and the permuted box;
5. flagship path: the flagship problem of bench.py at n=72 (1,167,051
   dofs) in float32 through SolidField / make_step: 1 warm-up and 5 timed
   steps, every step converged, B1-B3 launched;
6. jittered path: bench.py's ``unstructured_1M`` problem (the same box,
   interior nodes jittered by up to +-0.175 h, no generator provenance) the
   same way, B4-B5 launched;
7. permuted path: bench.py's ``permuted_500k`` problem (the jittered box at
   n=56, 555,579 dofs, with its nodes renumbered at random: general
   topology, flat dof vectors, gather and incidence assembly, SA-AMG with
   its setup timed stage by stage) the same way, B6-B7 launched and none of
   B1-B5;
8. decks, through the deck-driven entry points (fourc_tpu_torch.app.main and
   physics/driver.py):
   (a) the two gate decks, decks/solid_genalpha_lattice.yaml and
       decks/solid_unstructured_amg.yaml, in float64 on the card through
       ``app.main.main``: every RESULT DESCRIPTION anchor passes (1/1, 6/6);
   (b) those two and a jittered variant of the lattice deck (B4-B5) through
       ``driver.run`` on the card and on the CPU (twins): final d, v, a
       agree to STEP_TOL, each deck launching its path's kernels on the card;
   (c) ``--ngroup 2`` on the AMG deck on the card: bitwise-identical runs;
   (d) the flagship problem of phase 5 as a deck dict (n=72, float32, 6
       steps) through ``driver.run``: the same Newton and CG counts in every
       step as phase 5's warm-up and timed steps, B1-B3 launched and none of
       B4-B7, its ms/step printed beside phase 5's;
9. the element route (tet4, wedge6, ElastHyper: plain PyTorch, no kernel)
   and the direct solve:
   (a) the converted 4C decks solid_ele_hex8_standard_dynamic.yaml and
       solid_ele_wedge6_standard_dynamic.yaml and decks/
       solid_tet4_unstructured.yaml through ``app.main.main`` on the card
       in float64: every anchor passes (12/12, 12/12, 6/6);
   (b) the same three decks through ``driver.run`` on the card and on the
       CPU: final d, v, a agree to STEP_TOL; the hex8 deck (ElastHyper on
       the element route) launches B6 for its mass only, and none of B1-B5
       or B7; the wedge6 and tet4 decks launch none of B1-B7;
   (c) tet4 path: bench.py's problem with BENCH_CELL=tet4,
       BENCH_MESH=permuted at n=56 (1,053,696 tet4 elements, 555,579
       dofs; the jittered, permuted box split 6 tets per hex) the same way
       as phases 5-7, none of B1-B7 launched, with the element route's
       force and tangent timed at full size;
10. the other integrators, lumped mass, Rayleigh damping, kinem linear,
   block-Jacobi and Zienkiewicz-Xie adaptivity:
   (a) decks/solid_rayleigh_lumped_wide.yaml, solid_ost_vibration.yaml,
       solid_explicit_wave.yaml and solid_timada_pulse.yaml through
       ``app.main.main`` on the card in float64 (6/6 each), then through
       ``driver.run`` on the card and on the CPU: d, v, a after every
       step agree to 1e-11 of their largest entry over the run, each
       deck's Newton/CG counts and B1-B7 launches printed and checked, the
       timada deck's accepted dt sequence the CPU's;
   (b) ``rayleigh_wide``: bench.py's BENCH_RAYLEIGH=1 problem (the
       flagship with m_damp 0.3, k_damp 0.002 and lumped mass) at n=32
       (1 warm-up, 5 timed steps) and n=72 (1 + 2), B1-B3 launched, with
       the damping force (B2, mcoef 0) and D^2f timed by CUDA events;
   (c) the flagship box at n=72 under statics (2 load steps) and
       one-step-theta (theta 0.66, 1 + 2 steps), B1-B3 launched;
   (d) the flagship box at n=72 under explicit central differences with
       lumped mass, dt a quarter of the CFL limit, 100 steps with one B1
       launch each and every entry finite;
11. the element technologies F-bar and EAS, GMRES and BiCGStab, the fibre
   and log-Neo-Hooke summands, the body force and nodal stresses:
   (a) decks/solid_eas_bending.yaml, solid_fbar_compression.yaml,
       solid_goh_artery_strip.yaml and the 4C-converted
       ref_converted/solid_ele_hex8_standard_fbar.yaml (4C's displacements
       and nodal stresses at 1e-12) through ``app.main.main`` on the card
       in float64 (3/3, 3/3, 3/3, 22/22), then GPU against CPU through
       ``driver.run`` as phase 10 (a), none of B1-B7 launched;
   (b) ``fbar_permuted``: phase 7's problem (bench.py's permuted box at
       n=56, Neo-Hooke, gen-alpha, consistent mass, float32) with tech
       fbar under GMRES(50) and SA-AMG (phase 7's hierarchy, shared):
       1 warm-up and 2 timed steps, every step converged, B6 launched (the
       mass, mass-only) and none of B1-B5 or B7, the F-bar force and
       tangent timed by CUDA events;
   (c) ``eas_permuted``: the same with tech eas_mild under CG, 1 + 1
       steps (cut in depth from 1 + 2 to make room for phase 14);
   (d) one step of (b) under BiCGStab;
12. Gauss-point history, the Ogden and Sussman-Bathe summands,
   spring-dashpots and the volume constraint:
   (a) decks/solid_ogden_uniaxial.yaml, volume_constraint.yaml,
       viscoelastic_relaxation.yaml, solid_j2_cyclic.yaml,
       plasticity_lognh_torsion.yaml and spring_dashpot_settling.yaml with
       its viscosity zeroed (written under build/) through ``app.main.main``
       on the card in float64 (3/3 each, 6/6), then GPU against CPU through
       ``driver.run`` as phase 10 (a), the history of every block compared
       after every step too; the spring deck as written is refused, naming
       the dashpot;
   (b) ``visco_permuted``: phase 7's problem (bench.py's permuted box at
       n=56) with its Neo-Hooke wrapped in viscoelasthyper (taus [1.0],
       betas [0.5]), gen-alpha, CG with phase 7's SA-AMG (shared), float32,
       1 warm-up and 2 timed steps, B6 launched (the mass, mass-only) and
       none of B1-B5 or B7, the force and tangent timed by CUDA events and
       the history's bytes printed;
   (c) ``j2_permuted``: the same box under kinem linear and
       plasticlinelast (isohard 500, kinhard 300), its yield stress half
       the largest von Mises stress of an elastic first step (printed),
       CG, Newton with line search and up to 25 iterations, 1 + 2 steps,
       the share of Gauss points with kappa > 0 strictly between 0 and
       100%;
   (d) ``lognh_permuted``: the same under plasticnlnlogneohooke (isohard
       500, the yield stress chosen alike), GMRES(50), the same Newton,
       1 + 1 steps;
13. the other plasticity laws:
   (a) decks/druckerprager_shear.yaml, gtn_voided_tension.yaml,
       lemaitre_damage_bar.yaml, robinson_relaxation.yaml,
       sma_superelastic_cycle.yaml and crystal_plasticity_shear.yaml
       through ``app.main.main`` on the card in float64 (3/3 each; the GTN
       and Lemaitre decks hold no rotation about z, and their rotated
       anchor pair is met as its rotation-free sum, ROTATION_FREE), then
       GPU against CPU through ``driver.run`` as phase 12 (a), with the
       reference's Newton iterations and substeps on both devices;
   (b) ``gtn_permuted``: phase 7's problem under kinem linear and
       plasticgtn (E 1e4, nu 0.3, isohard 400, the GTN deck's f0, fn, en,
       sn), the yield stress half the largest von Mises stress of an
       elastic first step, GMRES(50) with phase 7's SA-AMG, line search
       and up to 25 Newton iterations, 1 + 2 steps, the share of Gauss
       points with ebar > 0 strictly between 0 and 100%;
   (c) ``crystal_permuted``: the same box under crystal_plasticity (fcc,
       nsub 10, gdot0 1e-2, rate_m 0.2), g0 half the largest resolved
       shear of an elastic first step, h0 2.5 g0, g_sat 3 g0, 1 + 1
       steps, the share with g > g0 strictly between 0 and 100%.
   (b) and (c) time the law's linearization (once per Newton iterate)
   beside the force and the tangent;
14. the growth, mixture and muscle laws:
   (a) decks/muscle_active_twitch.yaml, muscle_blemker_contraction.yaml,
       cardiac_active_stress_twitch.yaml, growth_remodel_strip.yaml and
       mixture_gr_artery_strip.yaml through ``app.main.main`` on the card
       in float64 (3/3 each), then GPU against CPU through ``driver.run``
       as phase 12 (a), with the reference's Newton iterations and one
       substep per step on both devices;
   (b) ``growthremodel_permuted``: phase 7's problem under
       growthremodel_cm (the gate deck's ratios to E scaled to E 1e4:
       k_fiber 5e3, sigma_h 625; its rates per step at dt 0.02:
       k_sigma = k_remodel = 10; prestretch 1.05, fibres along x and y),
       GMRES(50) with phase 7's SA-AMG (built for the elastin's E 1e4,
       nu 0.3) and line search, 1 + 2 steps;
   (c) ``mixture_permuted``: the same under mixture_rule growthremodel
       (couplogneohooke elastin, frac 0.4, prestretch [1.05, 1, 1]; two
       remodel fibres of frac 0.3, k1 3333.3, k2 1.5, a [1, +-0.3, 0],
       lambda_pre 1.08, k_sig 12.5, decay_time 0.16, impl), CG with line
       search and up to 25 Newton iterations (the prestressed tissue
       contracts at once, and a full Newton step of its second step
       inverted elements), 1 + 2;
   (d) ``blemker_permuted``: the same under muscle_blemker (g1 = g2 = 25,
       sigma_max 2000, beta 33.3, the deck's p1, p2, lambda_ofl,
       lambda_star; Neo-Hooke matrix E 1e4, nu 0.3), CG, 1 + 2;
   (b)-(d) print the law's mean state change (growth of rho or g from its
   start, the activation) beside the times of phases 12 and 13;
15. thermo, scalar transport, TSI and MULF prestress:
   (a) the seven decks decks/ref_converted/thermo_bar_dbc_genalpha.yaml,
       thermo_fin_cooling.yaml, ref_converted/
       scatra_3d_straight_convection.yaml, tsi_heated_bar.yaml,
       tsi_partitioned_bar.yaml, ref_converted/
       solid_ele_hex8_standard_mulf.yaml and mulf_prestress.yaml through
       ``app.main.main`` on the card in float64 (3/3, 2/2, 2/2, 3/3, 3/3,
       12/12 at 4C's values; the self-anchored MULF deck 0/3, its
       prestressed mesh balancing its load as on the CPU), the CLI's run
       keeping the card's states, then through ``driver.run`` on the CPU:
       every tensor of the
       state (d, v, a, T, Tdot, phi, phidot, the MULF prestretch) after
       every step within DECK_TOL of its largest entry over the run, the
       reference CLI's Newton iterations (4C's form's for MULF) on both;
       none launches B1-B7 but the TSI decks' and MULF decks' none either
       (statics, the element route);
   (b) ``tsi_permuted``: phase 7's permuted box at n=56 (555,579
       structure dofs, 185,193 temperatures) of thermostvenantkirchhoff
       (E 1e4, nu 0.3, tsi_heated_bar's thexpans 1e-3 and, scaled with E,
       conductivity 50 and capacity 10; T0 293), clamped at zmin, phase
       7's traction on zmax and zmax's temperature ramped from T0 to
       T0 + 20 over the run; structure one-step-theta (theta 0.66),
       thermo one-step-theta (theta 1), dt 0.02; the monolithic Newton
       with GMRES(50), SA-AMG on the structure block built by the field
       from the law's youngs and nue, Jacobi on the temperatures; float32,
       1 warm-up and 2 timed steps, every step converged, B6 launched
       (the mass, mass-only) and none of B1-B5 or B7, the coupled
       residual and Jacobian action timed by CUDA events and the largest
       temperature rise printed;
   (c) ``mulf_permuted``: phase 7's box under MULF around its Neo-Hooke,
       statics, CG with SA-AMG: one prestress step under phase 7's
       traction, then 1 + 1 steps (cut from 1 + 2 for phase 15's time),
       none of B1-B7 launched, the largest |F0 - I| after the prestress
       phase printed.
16. fluid and ALE (none launches B1-B7):
   (a) the nine decks decks/fluid_cavity_stationary.yaml,
       fluid_poiseuille_ost.yaml, fluid_smagorinsky_decay.yaml,
       fluid_mfs_decay.yaml, windkessel_channel.yaml,
       ale_patch_motion.yaml, scatra_supg_skewflow.yaml,
       scatra_gaussian_diffusion.yaml and scatra_anisotropic_diffusion.yaml
       as phase 15 (a), every state tensor (x, xdot, x_nm1, pwk, phi, the
       mesh d, v) within DECK_TOL, FLUID_DECKS' Newton iterations on both;
   (b) ``cavity3d_ost``: the 3D lid-driven cavity at Re 100 on a hex8 box
       at n=64 (1,098,500 unknowns [u, v, w, p]), one-step-theta, SUPG,
       PSPG and grad-div, GMRES(150) with the field's Jacobi; float32,
       1 warm-up and 2 timed steps from rest, every step converged and no
       GMRES solve at maxiter, the first residual and Jacobian action
       finite, the residual, linearization and Jacobian action timed by
       CUDA events, the largest |u| and the discrete divergence printed;
   (c) ``ale_box``: ale_patch_motion's ramp u_x = 0.1 t x on every face
       of a hex8 box at n=64, ``laplace``, float32, 1 + 2 solves, each
       meeting the patch test to 1e-5 of its largest displacement.

The nodal stresses of a deck with ``stress_*`` anchors (the converted
F-bar deck of phase 11) are compared GPU against CPU after every step like
d, v and a; an anchor at float64's noise floor that the card misses must
lie within its tolerance + NOISE_BOUND of 4C's value.

Each path's launch counts are set to 0 just before it and read just after.
The last three lines are a JSON object with per-kernel results (launches on
its path, errors, times, the bound and what sets it), the ``nvidia-smi``
name/power-limit line and ``{"ok": true, "device": ...}``.
"""

import contextlib
import io
import json
import pathlib
import re
import shutil
import subprocess
import sys
import time
import warnings

import numpy as np
import torch
import yaml

try:
    from fourc_tpu_torch import materials
    from fourc_tpu_torch.app import main as app_main
    from fourc_tpu_torch.core import cells, conditions, functions, gridgen
    from fourc_tpu_torch.io.result_test import read_node_lines
    from fourc_tpu_torch.materials.elastic import lame
    from fourc_tpu_torch.ops import common as gm
    from fourc_tpu_torch.ops import cuda_build
    from fourc_tpu_torch.ops import lattice as lat
    from fourc_tpu_torch.ops import lattice_kernels as lk
    from fourc_tpu_torch.ops import solid as sops
    from fourc_tpu_torch.ops import solid_kernels as sk
    from fourc_tpu_torch.physics import driver
    from fourc_tpu_torch.physics import solid as ps
    from tools.rigid_rotation_anchors import ROTATION_FREE
except ImportError as exc:  # the script without the repository around it
    print(f"[phase] import: FAILED: {type(exc).__name__}: {exc} (run "
          f"chip_smoke.py from the root of a checkout)", flush=True)
    sys.exit(1)

F64_TOL, F32_TOL, STEP_TOL = 1e-10, 1e-4, 1e-9
# kernel -> (number, JSON name, source, TPU kernel it replaces, its path)
KERNELS = {
    "stencil": ("B3", "lattice_stencil", lk.SOURCE,
                "fourc_tpu/ops/lattice_pallas.py:90", "flagship"),
    "force": ("B1", "lattice_force", lk.SOURCE,
              "fourc_tpu/ops/lattice_pallas.py:164", "flagship"),
    "tangent": ("B2", "lattice_tangent", lk.SOURCE,
                "fourc_tpu/ops/lattice_pallas.py:189", "flagship"),
    "force_gen": ("B4", "lattice_force_gen", lk.SOURCE,
                  "fourc_tpu/ops/lattice_pallas.py:285", "jittered"),
    "tangent_gen": ("B5", "lattice_tangent_gen", lk.SOURCE,
                    "fourc_tpu/ops/lattice_pallas.py:331", "jittered"),
    "solid_force": ("B6", "solid_force", sk.SOURCE,
                    "fourc_tpu/ops/solid_pallas.py:173", "permuted"),
    "solid_tangent": ("B7", "solid_tangent", sk.SOURCE,
                      "fourc_tpu/ops/solid_pallas.py:184", "permuted"),
}
FULL_N = {"flagship": 72, "jittered": 72, "permuted": 56}  # elements per axis
# H100 SXM peaks (NVIDIA data sheet, at the full 700 W): float32 outside
# the tensor cores, HBM3 bandwidth
PEAK_F32_FLOPS, PEAK_BYTES = 67e12, 3.35e12
# Flops of one element of the element kernels, counted from the kernel
# code with an FMA as 2 and log1p or a division as 1.  The lattice kernels'
# gather pass adds 24 adds per element; the element-batch kernels B6/B7
# have no such pass.
# B1 works by the 12 edges of an element (force_elem_kernel): per Gauss
# point H by grad_edges 72 (4 FMAs per entry) and accum_edges with the
# weight 81 (the weight 9, 36 FMAs); then P: Neo-Hooke in
# deformation-gradient form 130 (stress_neohooke_F, as B4 below), or SVK
# 127 (strain_A 63, stress 16, F 3, F S 45).  Per element the edge
# differences 36, edges_to_nodes 72 and the gather's 24.  No code in the
# repo computes this operator with less, so it bounds B1's first pass too
# (counted as the dense form: per Gauss point grad 144, strain_A 63, the
# stress 139 or 16, F 3, F S 45 and the dense accumulation 168; 4,520 flops
# per element Neo-Hooke and 3,536 SVK with the gather).
_B1_GP = 72 + 81
# B2 works by the 12 edges of an element (tangent_elem_kernel): per Gauss
# point grad_edges 2 x 72 (4 FMAs per entry), the Neo-Hooke tangent in
# deformation-gradient form 234 (tr H 2, tr H^2 18, det3 14, delta 5, lnJ
# 4, F 3, cof3 27, 1 / det F 2, K : Hd 18, two mm 90, coefficients 6, Pd
# 45) and accum_edges 81 (the weight 9, 36 FMAs); per element the edge
# differences 2 x 36, edges_to_nodes 72, the gather's 24 and, with the
# mass, 192 FMAs against the element mass.  No code in the repo computes
# this operator with less, so it bounds B2's first element pass too.
_B2_GP = 144 + 234 + 81
# B5 works by the 12 edges of an element too (tangent_gen_edge_kernel): per
# Gauss point the Jacobian J by grad_edges 72, K = cof(J) 27, det J from K's
# first row 5, 1 / det J 1, Hhat(v) by grad_edges 72, Hd' = Hhat K^T 45,
# Q = Pd K 45, its weight w / det J 10 and accum_edges 72 (349 in all); then
# the tangent: linear 16 (lam tr, 2 mu, 3 diagonal FMAs, 3 symmetric pairs),
# or Neo-Hooke Hhat(u) 72, H = Hhat K^T / det J 54 and tangent_neohooke_F
# 234 (360).  Per element the edge differences 36 per field (x, v and u),
# edges_to_nodes 72, the gather's 24 and, with the mass, 106 per Gauss point
# after the loop (mcoef w det J 2, N . v 48, c N 8, 24 FMAs 48).  No code in
# the repo computes this operator with less, so it bounds B5's first element
# pass too (counted as the dense form: 12,936 flops with the mass, 5,008
# linear).
_B5_GP = 72 + 27 + 5 + 1 + 72 + 45 + 45 + 10 + 72
_B5_LIN, _B5_NEO = _B5_GP + 16, _B5_GP + 72 + 54 + 234
# SVK's tangent_stress: strain_A 63, its dual 117, two SVK stresses 32, F 3,
# Hd S and F Sd 90, the sum 9
_B5_SVK = _B5_GP + 72 + 54 + 63 + 117 + 2 * 16 + 3 + 2 * 45 + 9
# B4 works by the 12 edges too (force_gen_edge_kernel): per Gauss point J
# by grad_edges 72, K = cof(J) 27, det J from K's first row 5, 1 / det J 1,
# Hhat(u) by grad_edges 72, H = Hhat K^T / det J 54, Q = P K 45 and
# accum_edges with the weight 81 (357 in all); then P: Neo-Hooke in
# deformation-gradient form 130 (stress_neohooke_F: cof(H) 27, tr H 2, d2 8,
# delta 1, lnJ 4, 1 / det F 2, lam lnJ 1, K_F 19, the d2 I + H^T - cof H
# entries 12, 6 per entry of P), or SVK 127 (strain_A 63, stress 16, F 3,
# F S 45).  Per element the edge differences 36 per field (x and u),
# edges_to_nodes 72, the gather's 24 and, with the mass, 106 per Gauss point
# after the loop.  The mass-only mode needs per Gauss point J 72 and det3 14,
# and x's edge differences alone.  No code in the repo computes this
# operator with less, so it bounds B4's first pass and B6 too (848 flops per
# Gauss point and 6,808 per element in B4's first, dense count).
_B4_GP = 72 + 27 + 5 + 1 + 72 + 54 + 45 + 81
_B4_NEO, _B4_SVK = _B4_GP + 130, _B4_GP + 127
ELEM_FLOPS = {
    ("force", "neohooke"): 8 * (_B1_GP + 130) + 36 + 72 + 24,
    ("force", "svk"): 8 * (_B1_GP + 127) + 36 + 72 + 24,
    ("tangent", "neohooke"): 8 * _B2_GP + 72 + 72 + 24,
    ("tangent", "neohooke+mass"): 8 * _B2_GP + 72 + 72 + 384 + 24,
    ("force_gen", "neohooke"): 8 * _B4_NEO + 2 * 36 + 72 + 24,
    ("force_gen", "svk"): 8 * _B4_SVK + 2 * 36 + 72 + 24,
    ("force_gen", "mass-only"): 8 * (72 + 14 + 106) + 36 + 24,
    ("force_gen", "neohooke+mass"): 8 * (_B4_NEO + 106) + 2 * 36 + 72 + 24,
    ("tangent_gen", "neohooke"): 8 * _B5_NEO + 3 * 36 + 72 + 24,
    ("tangent_gen", "neohooke+mass"): 8 * (_B5_NEO + 106) + 3 * 36 + 72 + 24,
    ("tangent_gen", "linear (u=0)"): 8 * _B5_LIN + 2 * 36 + 72 + 24,
}
# B6/B7: B4's and B5's edge passes on an element batch, without the gather
# pass
for _kind in ("neohooke", "svk", "mass-only", "neohooke+mass"):
    ELEM_FLOPS[("solid_force", _kind)] = ELEM_FLOPS[("force_gen", _kind)] - 24
for _kind, _gp in (("svk", _B5_SVK), ("svk+mass", _B5_SVK + 106)):
    ELEM_FLOPS[("tangent_gen", _kind)] = 8 * _gp + 3 * 36 + 72 + 24
for _kind in ("neohooke", "neohooke+mass", "svk", "svk+mass"):
    ELEM_FLOPS[("solid_tangent", _kind)] = \
        ELEM_FLOPS[("tangent_gen", _kind)] - 24


def launches():
    return {**lk.launches, "solid_force": sk.launches["force"],
            "solid_tangent": sk.launches["tangent"]}


def reset_launches():
    lk.reset_launches()
    sk.reset_launches()


def _check_launched(label, path, counts, kernels=None):
    """The kernels of ``path`` (or the set ``kernels``) were launched, no
    other kernel was."""
    for k, (num, *_, kpath) in KERNELS.items():
        want = kpath == path if kernels is None else k in kernels
        if want != (counts[k] > 0):
            raise RuntimeError(f"{label}: kernel {num} {k} was launched "
                               f"{counts[k]} times")


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def _smi():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def phase_environment():
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: this smoke "
                           "run needs a CUDA GPU")
    smi_line = _smi()
    log("env", f"nvidia-smi: {smi_line}")
    log("env", f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
               f"device {torch.cuda.get_device_name(0)}, "
               f"count {torch.cuda.device_count()}")
    log("env", f"nvcc: {shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'}")
    try:
        import triton  # noqa: F401

        log("env", f"triton {triton.__version__} imports")
    except ImportError as e:
        log("env", f"triton does not import ({e})")
    # Krylov sees every operator: keep TF32 off everywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi_line


def phase_build():
    """Build the kernels; print each kernel's ptxas registers and spills."""
    t0 = time.perf_counter()
    paths = cuda_build.build_all()
    log("build", f"{', '.join(p.name for p in paths.values())} in "
                 f"{time.perf_counter() - t0:.1f} s")
    for path in paths.values():
        name = "?"
        for line in path.with_suffix(".log").read_text().splitlines():
            m = re.search(r"Compiling entry function '_ZN5fourc\d+"
                          r"(\w+?_kernel)I([fd])((?:L[bi]\d+E)*)", line)
            if m:
                args = re.findall(r"L[bi](\d+)E", m.group(3))
                flag = ""
                if "tangent" in m.group(1) and args:  # model[, mass]
                    flag = ", " + ("Neo-Hooke", "SVK", "linear")[int(args[0])]
                    if len(args) > 1:
                        flag += ", mass" if args[1] == "1" else ""
                elif re.search("force_gen|solid_force", m.group(1)) and args:
                    # model, stiff, mass
                    flag = (", " + ("Neo-Hooke", "SVK")[int(args[0])]
                            + ", mass" * (args[2] == "1")
                            if args[1] == "1" else ", mass-only")
                elif "force" in m.group(1) and args:  # model
                    flag = ", " + ("Neo-Hooke", "SVK")[int(args[0])]
                name = (f"{m.group(1)}<"
                        f"{'float' if m.group(2) == 'f' else 'double'}{flag}>")
            elif "spill stores" in line:
                spills = line.strip()
            elif "registers" in line:
                regs = re.search(r"Used (\d+) registers", line).group(1)
                log("build", f"{name}: {regs} registers, {spills}")


def _time(fn, reps=20):
    for _ in range(3):
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


def _time_graph(fn, reps=20, replays=5):
    """Device time (ms) per call: ``reps`` calls captured in one CUDA graph,
    replayed.  A plain loop of wrapper calls reads the host's rate instead
    when the kernel takes less than the wrapper's host time (about 40 us
    per call on the H100 machine)."""
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
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def _flops(key, case, n):
    """Flops of one call on a box of n^3 elements.  The stencil: what
    y = A v needs, one 3x3 block (9 FMAs) for each pair of nodes that share
    an element, 3n + 1 such pairs per axis (27 blocks per interior node,
    fewer at the boundary); the element kernels: ELEM_FLOPS per element."""
    if key == "stencil":
        return 18 * (3 * n + 1) ** 3
    return ELEM_FLOPS[(key, case)] * n ** 3


def _bound(key, case, n, tensors):
    """Least time (ms) the card could take: the larger of the bytes that
    must move (each input read once, the output written once) over HBM
    bandwidth and the flops over the float32 peak."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    flops = _flops(key, case, n)
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_F32_FLOPS
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def jitter(disc, n):
    """bench.py's unstructured mesh: interior nodes moved by up to
    +-0.175 h (np.random.RandomState(0)), no generator provenance."""
    X = np.array(disc.coords)
    rng = np.random.RandomState(0)
    interior = np.all((X > 1e-12) & (X < 1.0 - 1e-12), axis=1)
    X[interior] += (rng.rand(int(interior.sum()), 3) - 0.5) * (0.35 / n)
    disc.coords = X
    disc.structured_shape = None
    return disc


def permute(disc):
    """bench.py's permuted mesh: the nodes renumbered at random
    (np.random.RandomState(1)) in coordinates, connectivity, node sets and
    face sets, so that no lattice survives in the connectivity."""
    rng = np.random.RandomState(1)
    perm = rng.permutation(disc.n_nodes).astype(np.int32)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(disc.n_nodes, dtype=np.int32)
    disc.coords = np.array(disc.coords)[perm]
    for blk in disc.blocks.values():
        blk.conn = inv[blk.conn]
    for nm in disc.node_sets:
        disc.node_sets[nm] = inv[disc.node_sets[nm]]
    for fbs in disc.face_sets.values():
        for fb in fbs:
            fb.conn = inv[fb.conn]
    return disc


def make_mesh(n, mesh, cell="hex8"):
    """The n^3 box of a path: flagship, jittered or permuted (jittered,
    then renumbered), of hex8 cells or each hex split into 6 tet4."""
    disc = gridgen.box(n, n, n, cell=cell)
    if mesh in ("jittered", "permuted"):
        jitter(disc, n)
    if mesh == "permuted":
        permute(disc)
    return disc


def _solid_cases(n, dtype, rng, lam, mu, mcoef):
    """(key, case, kernel, twin, inputs) for B6 and B7 on the element batch
    of the permuted n^3 box."""
    disc = make_mesh(n, "permuted")
    conn = disc.blocks["hex8"].conn

    def batch(nodal):  # (n_nodes, 3) -> (24, E) on the card
        return torch.as_tensor(nodal[conn].reshape(-1, 24).T, dtype=dtype,
                               device="cuda").contiguous()

    X = batch(disc.coords)
    u = batch(rng.normal(size=disc.coords.shape) * 5e-2 / n)
    v = batch(rng.normal(size=disc.coords.shape) / n)
    cases = []
    for case, model, mc, stiff in (("neohooke", "neohooke", 0.0, True),
                                   ("svk", "svk", 0.0, True),
                                   ("mass-only", "svk", 1.0, False),
                                   ("neohooke+mass", "neohooke", mcoef,
                                    True)):
        cases.append((
            "solid_force", case,
            lambda m=model, c=mc, s=stiff: sk.hex8_force(X, u, lam, mu, m,
                                                         c, s),
            lambda m=model, c=mc, s=stiff: sops.hex8_force_ref(X, u, lam, mu,
                                                               m, c, s),
            (X, u)))
    for case, model, mc in (("neohooke", "neohooke", 0.0),
                            ("neohooke+mass", "neohooke", mcoef),
                            ("svk", "svk", 0.0),
                            ("svk+mass", "svk", mcoef)):
        cases.append((
            "solid_tangent", case,
            lambda m=model, c=mc: sk.hex8_tangent(X, u, v, lam, mu, m, c),
            lambda m=model, c=mc: sops.hex8_tangent_ref(X, u, v, lam, mu, m,
                                                        c),
            (X, u, v)))
    return cases


def _kernel_cases(n, dtype, rng, cell, lam, mu, mcoef):
    """(key, case, kernel, twin, inputs) for every kernel at size n: B1-B3
    on the uniform box, B4-B5 on the jittered box; the first case of each
    kernel is the one its JSON entry reports."""
    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=dtype,
                               device="cuda").contiguous()

    spec = lat.LatticeSpec(pshape=(n + 1,) * 3, h=(1.0 / n,) * 3)
    G, wdet = lat.uniform_geometry(cell, spec)
    B = rng.normal(size=(24, 24))
    K = lat.collapse_stencil(B + B.T)
    # displacements with gradients of order 5e-2
    u = rng.normal(size=spec.ndof) * 5e-2 / n
    v = rng.normal(size=spec.ndof) / n
    ul, vl = lat.to_lattice(t(u), spec), lat.to_lattice(t(v), spec)
    Kt, Gt, wt, Nt = t(K), t(G), t(wdet), t(cell.N)
    cases = [("stencil", "random K", lambda: lk.stencil_matvec(Kt, vl),
              lambda: lat.stencil_matvec_ref(Kt, vl), (Kt, vl))]
    for model in ("neohooke", "svk"):
        cases.append((
            "force", model,
            lambda m=model: lk.neo_force(ul, Gt, wt, lam, mu, m),
            lambda m=model: lat.neo_force_ref(ul, Gt, wt, lam, mu, m),
            (ul,)))
    for case, mc in (("neohooke", 0.0), ("neohooke+mass", mcoef)):
        cases.append((
            "tangent", case,
            lambda c=mc: lk.neo_tangent(ul, vl, Gt, wt, Nt, lam, mu,
                                        "neohooke", c),
            lambda c=mc: lat.neo_jvp_ref(ul, vl, Gt, wt, lam, mu, "neohooke",
                                         N=Nt, mcoef=c),
            (ul, vl)))
    disc = make_mesh(n, "jittered")
    x = lat.coord_lattice(disc.coords, spec, dtype, "cuda")
    tab = (t(cell.dN), t(cell.gauss_weights), Nt)
    for case, model, mc, stiff in (("neohooke", "neohooke", 0.0, True),
                                   ("svk", "svk", 0.0, True),
                                   ("mass-only", "svk", 1.0, False),
                                   ("neohooke+mass", "neohooke", mcoef,
                                    True)):
        cases.append((
            "force_gen", case,
            lambda m=model, c=mc, s=stiff: lk.neo_force_gen(
                x, ul, *tab, lam, mu, m, mcoef=c, stiff=s),
            lambda m=model, c=mc, s=stiff: lat.neo_force_gen_ref(
                x, ul, *tab, lam, mu, m, mcoef=c, stiff=s),
            (x, ul)))
    for case, uu, model, mc in (("neohooke", ul, "neohooke", 0.0),
                                ("neohooke+mass", ul, "neohooke", mcoef),
                                ("linear (u=0)", None, "svk", 0.0)):
        cases.append((
            "tangent_gen", case,
            lambda a=uu, m=model, c=mc: lk.neo_tangent_gen(
                x, a, vl, *tab, lam, mu, m, mcoef=c),
            lambda a=uu, m=model, c=mc: lat.neo_jvp_gen_ref(
                x, a, vl, *tab, lam, mu, m, mcoef=c),
            (x, vl) if uu is None else (x, ul, vl)))
    return cases


def _level_cases(dtype, rng, cell, lam, mu):
    """(n, kernel, twin, inputs) for B5's linear mode on the coarse GMG
    levels of the jittered path, n = 36, 18 and 9: every second node of the
    level above, coordinates included, as linalg/gmg.py coarsens them.  The
    launcher picks its mapping from the element count, so these are the
    shapes at which each mapping runs on that path."""
    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=dtype,
                               device="cuda").contiguous()

    full = FULL_N["jittered"]
    coords = np.asarray(make_mesh(full, "jittered").coords).reshape(
        (full + 1,) * 3 + (3,))
    tab = (t(cell.dN), t(cell.gauss_weights), t(cell.N))
    cases = []
    for step in (2, 4, 8):
        n = full // step
        spec = lat.LatticeSpec(pshape=(n + 1,) * 3, h=None)
        x = lat.coord_lattice(coords[::step, ::step, ::step].reshape(-1, 3),
                              spec, dtype, "cuda")
        vl = lat.to_lattice(t(rng.normal(size=spec.ndof) / n), spec)
        cases.append((
            n,
            lambda x=x, vl=vl: lk.neo_tangent_gen(x, None, vl, *tab, lam, mu,
                                                  "svk", mcoef=0.0),
            lambda x=x, vl=vl: lat.neo_jvp_gen_ref(x, None, vl, *tab, lam, mu,
                                                   "svk", mcoef=0.0),
            (x, vl)))
    return cases


def _check(label, n, dtype, tol, kern, twin):
    """Runs a kernel and its twin; raises unless both are finite and agree
    to ``tol`` (max relative error); returns (kernel output, max abs
    error)."""
    got, want = kern(), twin()
    torch.cuda.synchronize()
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise RuntimeError(f"{label} n={n}: non-finite output")
    abs_err = float((got - want).abs().max())
    rel = abs_err / float(want.abs().max())
    log("kernels", f"{label:22s} n={n:2d} {str(dtype)[6:]}: "
                   f"max rel err {rel:.3e} (tol {tol:g})")
    if not rel <= tol:
        raise RuntimeError(f"{label} n={n} {dtype}: rel err "
                           f"{rel:.3e} > {tol:g}")
    return got, abs_err


def phase_kernels():
    """Each kernel against its twin; returns per-kernel float32 results at
    the full size of the kernel's path (times and bound of the first case of
    each kernel, the largest error over its cases)."""
    results = {k: {"max_abs_err": 0.0} for k in KERNELS}
    cell = cells.get_cell("hex8")
    lam, mu = lame(1.0e4, 0.3)
    mcoef = 9930.0  # rho (1-am) / ((1-af) beta dt^2) at dt=0.02, rho_inf 0.9
    sizes = ((16, "lattice"), (16, "solid"), (FULL_N["flagship"], "lattice"),
             (FULL_N["permuted"], "solid"))
    for n, group in sizes:
        rng = np.random.default_rng(n)
        for dtype, tol in ((torch.float64, F64_TOL), (torch.float32, F32_TOL)):
            cases = (_kernel_cases(n, dtype, rng, cell, lam, mu, mcoef)
                     if group == "lattice"
                     else _solid_cases(n, dtype, rng, lam, mu, mcoef))
            for key, case, kern, twin, ins in cases:
                label = f"{KERNELS[key][0]} {case}"
                got, abs_err = _check(label, n, dtype, tol, kern, twin)
                if n == 16 or dtype != torch.float32:
                    continue
                r = results[key]
                r["max_abs_err"] = max(r["max_abs_err"], abs_err)
                ms, loop_ms = _time_graph(kern), _time(kern)
                bound, by = _bound(key, case, n, ins + (got,))
                msg = (f"{label:22s} n={n} float32: kernel {ms:.4f} ms "
                       f"(loop {loop_ms:.4f} ms), bound {bound:.4f} ms "
                       f"({by}), roofline share {bound / ms:.1%}")
                if "ms" not in r:
                    r.update(ms=ms, loop_ms=loop_ms,
                             plain_ms=_time(twin, reps=5),
                             bound_ms=bound, bound_by=by,
                             library_ms=None)  # no PyTorch call is exact
                    msg += f", twin {r['plain_ms']:.3f} ms"
                log("kernels", msg)
    rng = np.random.default_rng(FULL_N["jittered"] + 1)
    for dtype, tol in ((torch.float64, F64_TOL), (torch.float32, F32_TOL)):
        for n, kern, twin, ins in _level_cases(dtype, rng, cell, lam, mu):
            label = "B5 linear (u=0), GMG"
            got, abs_err = _check(label, n, dtype, tol, kern, twin)
            if dtype != torch.float32:
                continue
            r = results["tangent_gen"]
            r["max_abs_err"] = max(r["max_abs_err"], abs_err)
            bound, by = _bound("tangent_gen", "linear (u=0)", n, ins + (got,))
            log("kernels", f"{label:22s} n={n} float32: kernel "
                           f"{_time_graph(kern):.4f} ms, bound {bound:.5f} ms "
                           f"({by})")
    return results


NEOHOOKE = {"type": "neohooke", "youngs": 1.0e4, "nue": 0.3, "density": 1.0}


def bench_newton(ndof, dtype):
    """bench.py's Newton settings for a system of ndof unknowns: float64
    to 1e-8 absolute, float32 to the rounding of its norms."""
    from fourc_tpu_torch.physics.newton import NewtonParams

    nw = NewtonParams()
    if dtype == torch.float64:
        nw.tol_res, nw.tol_res_rel, nw.tol_disp, nw.combine = \
            1e-8, 0.0, 1e30, "and"
    else:
        nw.tol_res = 1.5e-4 * ndof ** 0.5
        nw.tol_res_rel = 1e-4
        nw.tol_disp = 1e-7 * ndof ** 0.5
        nw.combine = "or"
    nw.max_iter, nw.stag_tol = 12, 0.0
    nw.lin_maxiter, nw.lin_rtol = 1000, 1e-4
    return nw


def build_problem(n, device, dtype, mesh="flagship", cell="hex8",
                  changes=None, newton=None, material=None):
    """bench.py's problem (f32 Newton settings for float32) on one of its
    meshes: ``flagship`` (the uniform box), ``jittered`` (its
    ``unstructured_1M`` variant) or ``permuted`` (``permuted_500k``, whose
    ``gmg`` falls back to SA-AMG), of hex8 or (BENCH_CELL=tet4) tet4
    cells; ``changes`` sets SolidParams fields (e.g. RAYLEIGH, bench.py's
    BENCH_RAYLEIGH=1, another integrator or a tech), ``newton`` its
    NewtonParams fields (e.g. the linear solver), ``material`` the law's
    deck spec in place of bench.py's Neo-Hooke."""
    disc = make_mesh(n, mesh, cell)
    mat = materials.make_material(dict(material or NEOHOOKE))
    params = ps.SolidParams(kinem="nonlinear", dyntype="genalpha",
                            genalpha=ps.GenAlphaParams(rho_inf=0.9),
                            precond="gmg", predictor="constdis")
    nw = params.newton = bench_newton(disc.n_nodes * 3, dtype)
    for key, val in (changes or {}).items():
        setattr(params, key, val)
    for key, val in (newton or {}).items():
        setattr(nw, key, val)
    fm = functions.FunctionManager()
    fm.add(1, "sin(50.0*t)*(1-exp(-t/0.06))")
    dbc = [conditions.DirichletBC(disc.node_sets["zmin"], [1, 1, 1],
                                  [0, 0, 0])]
    neu = [conditions.NeumannBC(disc.face_sets["zmax"], [1, 0, 0],
                                [400.0, 0, 0], funct=[1, 0, 0])]
    return ps.SolidField(disc, {1: mat}, params, dirichlet=dbc, neumann=neu,
                         functions=fm, device=device, dtype=dtype)


def make_step(f, name):
    """ps.make_step; on general topology (the permuted boxes) the ``gmg``
    request must warn that it falls back to SA-AMG, on the others nothing
    may warn."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        step = ps.make_step(f, dt=0.02)
    msgs = [str(w.message) for w in caught]
    if (f.lattice is None) != any("SA-AMG" in m for m in msgs):
        raise RuntimeError(f"{name}: unexpected warnings {msgs}")
    return step


def phase_correctness():
    for name in FULL_N:
        out = {}
        for device in ("cuda", "cpu"):
            f = build_problem(6, device, torch.float64, name)
            state = ps.compute_initial_state(f, ps.init_state(f))
            step = make_step(f, name)
            for _ in range(2):
                state, stats = step(state)
                if not stats["converged"]:
                    raise RuntimeError(f"{name} n=6 {device} step did not "
                                       f"converge")
            out[device] = state
        for k in ("d", "v", "a"):
            got, want = out["cuda"][k].cpu(), out["cpu"][k]
            rel = float((got - want).abs().max() / want.abs().max())
            log("check", f"{name} n=6 float64 two steps, GPU kernels vs CPU "
                         f"twins: {k} max rel err {rel:.3e} "
                         f"(tol {STEP_TOL:g})")
            if not rel <= STEP_TOL:
                raise RuntimeError(f"{name}: GPU step disagrees with the CPU "
                                   f"step on {k}")


def _log_amg(name, M):
    """SA-AMG setup by stage, the levels and the dense coarse factor."""
    log(name, "AMG setup seconds by stage: " + ", ".join(
        f"{k} {v:.2f}" for k, v in M.timings.items()))
    info = M.describe()
    for i, lev in enumerate(info["levels"]):
        log(name, f"AMG level {i}: {lev['nodes']} nodes, ELL widths "
                  + ", ".join(f"{k} {v}" for k, v in lev.items()
                              if k != "nodes"))
    log(name, f"AMG dense coarse factor: {info['coarse_dofs']} dofs, "
              f"{info['coarse_bytes'] / 2**30:.3f} GiB")


# SA-AMG hierarchies of the general-topology paths, by (n, mesh, cell):
# (node coordinates, free mask, the field's hierarchies by mass shift); a
# later path on the same mesh, laws of the same youngs and nue and the
# same constraints reuses them (phase 11 (b)-(d) phase 7's)
SHARED_AMG = {}


def _share_amg(f, key):
    """Give field ``f`` the hierarchies of an earlier field on the same
    mesh, constraints and linear-elastic operator, if there was one; then
    record its own."""
    mat = f.block_mat[next(iter(f.block_mat))]
    ident = (f.disc.coords, f.dbc.free_mask, *materials.elastic_moduli(mat))
    old = SHARED_AMG.get(key)
    if old is not None and all(np.array_equal(a, b) if isinstance(
            a, np.ndarray) else a == b for a, b in zip(old[0], ident)):
        f._amg_cache.update(old[1])
        return True
    SHARED_AMG[key] = (ident, f._amg_cache)
    return False


def phase_main_path(name, n_steps=5, mesh=None, cell="hex8", n=None,
                    after=None, changes=None, path=None, newton=None,
                    kernels=None, material=None, prepare=None):
    """One path at full size (phases 5-7; the tet4 path of phase 9 (c) is
    ``name`` "tet4" on the ``permuted`` mesh, phase 10's are the flagship
    box with ``changes`` to its SolidParams, phase 11's the permuted box
    with a tech and ``newton`` changes); returns the launches of its run
    and what the deck phase compares with: (Newton, Krylov) of every step,
    max|d|, ms/step.  The kernels of ``path`` (default ``name``), or the
    set ``kernels``, must be launched and no other.  ``after(f, state)``
    runs after the launches are read.  With ``n_steps`` 0 only the
    warm-up step runs.  ``material`` is the law's spec (build_problem);
    ``prepare(f)`` runs on the built field before the launches are counted
    (phase 12's elastic step that sets the yield stress)."""
    n = n or FULL_N[name]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    f = build_problem(n, "cuda", torch.float32, mesh or name, cell, changes,
                      newton, material)
    torch.cuda.synchronize()
    kind = ("general topology" if f.lattice is None else
            "general geometry" if f.x is not None else "uniform geometry")
    log(name, f"n={n}: {f.ndof} dofs, {kind}, field built in "
              f"{time.perf_counter() - t0:.1f} s")
    if prepare is not None:
        _share_amg(f, (n, mesh or name, cell))
        prepare(f)
    reset_launches()
    t0 = time.perf_counter()
    state = ps.compute_initial_state(f, ps.init_state(f))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    shared = f.lattice is None and _share_amg(f, (n, mesh or name, cell))
    step = make_step(f, name)
    torch.cuda.synchronize()
    log(name, f"initial state {t1 - t0:.2f} s, "
              f"{'SA-AMG' if f.lattice is None else 'GMG'} setup "
              f"{time.perf_counter() - t1:.2f} s"
              + (" (the hierarchy of an earlier path on this mesh)"
                 if shared else ""))
    if f.lattice is None and not shared:
        _log_amg(name, step.precond)
    t0 = time.perf_counter()
    state, stats = step(state)
    torch.cuda.synchronize()
    log(name, f"warm-up step {1e3 * (time.perf_counter() - t0):.1f} ms: "
              f"{stats}")
    all_stats = [stats]
    t0 = time.perf_counter()
    timed = []
    for _ in range(n_steps):
        state, stats = step(state)
        timed.append(stats)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / max(n_steps, 1)
    all_stats += timed
    counts = launches()
    krylov = f.params.newton.lin_method
    for i, st in enumerate(all_stats):
        log(name, f"step {i}: newton {st['iters']}, {krylov} "
                  f"{st['lin_iters']}, resnorm {st['resnorm']:.4e}, "
                  f"converged {st['converged']}")
        if not (st["converged"] and np.isfinite(st["resnorm"])):
            raise RuntimeError(f"{name} step {i} did not converge")
    d = state["d"]
    shape = (f.ndof,) if f.lattice is None else f.lattice.lshape
    if tuple(d.shape) != shape or not torch.isfinite(d).all():
        raise RuntimeError(f"{name} displacement has a wrong shape or "
                           f"non-finite values")
    its = sum(st["iters"] for st in timed)
    lin = sum(st["lin_iters"] for st in timed)
    log(name, (f"{ms:.1f} ms/step over {n_steps} timed steps ({its} "
               f"Newton, {lin} {krylov} iterations in total)" if n_steps
               else "no timed step")
              + f", max|d| {float(d.abs().max()):.4e}, peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(name, f"launches {counts}")
    _check_launched(f"the {name} path", path or name, counts, kernels)
    if after is not None:
        after(f, state)
    return counts, {"steps": [(st["iters"], st["lin_iters"])
                              for st in all_stats],
                    "max_d": float(d.abs().max()), "ms": ms}


GATE_DECKS = {"decks/solid_genalpha_lattice.yaml": ("flagship", 1),
              "decks/solid_unstructured_amg.yaml": ("permuted", 6)}


def _cli(args):
    """``app.main.main(args)``, its output printed; returns rc and output."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = app_main.main(args)
    out = buf.getvalue()
    for line in out.splitlines():
        log("deck", line)
    return rc, out


def jittered_deck():
    """The lattice gate deck with its interior nodes jittered (general
    geometry on the lattice: B4-B5 and GMG), 2 steps."""
    with open("decks/solid_genalpha_lattice.yaml") as fh:
        data = yaml.safe_load(fh)
    data["geometry"]["generator"]["jitter"] = 0.3
    data["structural_dynamic"]["numstep"] = 2
    return data


def flagship_deck(n, n_steps):
    """build_problem's flagship problem (float32 Newton settings) as a
    deck."""
    ndof = 3 * (n + 1) ** 3
    return {
        "problem": {"type": "structure", "dtype": "float32"},
        "structural_dynamic": {
            "dynamictype": "genalpha", "kinem": "nonlinear", "rho_inf": 0.9,
            "timestep": 0.02, "numstep": n_steps, "maxiter": 12,
            "tolres": 1.5e-4 * ndof ** 0.5, "tolres_rel": 1e-4,
            "toldisp": 1e-7 * ndof ** 0.5, "normcombi": "or"},
        "solver": {"method": "cg", "precond": "gmg", "maxiter": 1000,
                   "rtol": 1e-4},
        "materials": {1: {"type": "neohooke", "youngs": 1.0e4, "nue": 0.3,
                          "density": 1.0}},
        "functions": {1: "sin(50.0*t)*(1-exp(-t/0.06))"},
        "geometry": {"generator": {"kind": "box", "nx": n, "ny": n, "nz": n,
                                   "cell": "hex8", "mat": 1}},
        "conditions": {
            "dirichlet": [{"nodes": "zmin", "onoff": [1, 1, 1],
                           "val": [0, 0, 0]}],
            "neumann": [{"faces": "zmax", "onoff": [1, 0, 0],
                         "val": [400.0, 0, 0], "funct": [1, 0, 0]}]},
    }


def phase_decks(flagship):
    """The deck-driven entry points; ``flagship`` is phase 5's record."""
    # (a) the gate decks through the CLI on the card
    for path, (_, n_tests) in GATE_DECKS.items():
        rc, out = _cli([path, "--device", "cuda"])
        if rc != 0 or f"result tests: {n_tests}/{n_tests} passed" not in out:
            raise RuntimeError(f"{path}: rc {rc}, RESULT DESCRIPTION not met "
                               f"on the card")
    # (b) GPU kernels against CPU twins through driver.run, float64
    decks = {path: (path, kpath) for path, (kpath, _) in GATE_DECKS.items()}
    decks["jittered lattice deck"] = (jittered_deck(), "jittered")
    for label, (src, kpath) in decks.items():
        states = {}
        for device in ("cuda", "cpu"):
            reset_launches()
            res = driver.run(src, device=device)
            view = res.fields["structure"]
            states[device] = view.flat_state(res.states["structure"])
            if device == "cuda":
                _check_launched(label, kpath, launches())
        for k in ("d", "v", "a"):
            got, want = states["cuda"][k].cpu(), states["cpu"][k]
            rel = float((got - want).abs().max() / want.abs().max())
            log("deck", f"{label} float64, GPU kernels vs CPU twins: {k} max "
                        f"rel err {rel:.3e} (tol {STEP_TOL:g})")
            if not rel <= STEP_TOL:
                raise RuntimeError(f"{label}: GPU run disagrees with the CPU "
                                   f"run on {k}")
    # (c) determinism on the card
    rc, out = _cli(["decks/solid_unstructured_amg.yaml", "--device", "cuda",
                    "--ngroup", "2"])
    if rc != 0 or "diffgroup: 2 groups bitwise identical" not in out:
        raise RuntimeError("--ngroup 2: the two runs on the card differ")
    # (d) the flagship problem as a deck, at full width
    n, steps = FULL_N["flagship"], len(flagship["steps"])
    marks, totals = [], [(0, 0)]

    def record(name, state, agg):  # after each step: time, running counts
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        totals.append((agg["newton_iters"], agg["lin_iters"]))

    reset_launches()
    t0 = time.perf_counter()
    res = driver.run(flagship_deck(n, steps), device="cuda",
                     callbacks=[record])
    torch.cuda.synchronize()
    counts = launches()
    log("deck", f"flagship deck n={n}: run {time.perf_counter() - t0:.1f} s "
                f"(deck, field, initial state, GMG and {steps} steps)")
    _check_launched("flagship deck", "flagship", counts)
    per_step = [(a[0] - b[0], a[1] - b[1])
                for a, b in zip(totals[1:], totals[:-1])]
    for i, (got, want) in enumerate(zip(per_step, flagship["steps"])):
        log("deck", f"flagship deck step {i}: newton {got[0]}, cg {got[1]} "
                    f"(phase 5: newton {want[0]}, cg {want[1]})")
    if per_step != flagship["steps"]:
        raise RuntimeError("flagship deck: Newton/CG counts differ from "
                           "phase 5's")
    d = res.states["structure"]["d"]
    if not torch.isfinite(d).all():
        raise RuntimeError("flagship deck: non-finite displacement")
    t = res.timers
    loop_ms = 1e3 * (t.total["step"] - t.total["make_step"]) / steps
    ms = 1e3 * (marks[-1] - marks[0]) / (steps - 1)
    log("deck", f"flagship deck: {ms:.1f} ms/step over steps 1-{steps - 1} "
                f"(phase 5: {flagship['ms']:.1f} ms/step over its timed "
                f"steps); time_loop {loop_ms:.1f} ms/step over all {steps} "
                f"without the GMG setup; max|d| {float(d.abs().max()):.4e} "
                f"(phase 5: {flagship['max_d']:.4e})")
    log("deck", f"launches {counts}")


ELEMENT_DECKS = {
    "decks/ref_converted/solid_ele_hex8_standard_dynamic.yaml": 12,
    "decks/ref_converted/solid_ele_wedge6_standard_dynamic.yaml": 12,
    "decks/solid_tet4_unstructured.yaml": 6}


def _time_element_route(f, state):
    """Device ms per call (CUDA events, 10 calls) of the element route's
    force, tangent and mass at the state's displacement, on every block
    of the field, with the gathers and the assembly around them."""
    u = state["d"]
    v = torch.randn_like(u)
    out = {}
    for label, fn in (("force", lambda: f.internal_force(u)),
                      ("tangent with the mass",
                       lambda: f.tangent(u, v, 9930.0)),
                      ("mass", lambda: f.mass_matvec(v))):
        out[label] = _time(fn, reps=10)
    blk = f.blocks[0]
    ue, ve = f.dofmap.gather(u, blk.key), f.dofmap.gather(v, blk.key)
    out["element tangent alone"] = _time(
        lambda: blk.tangent(ue, ve, 9930.0), reps=10)
    out["gather"] = _time(lambda: f.dofmap.gather(u, blk.key), reps=10)
    te = blk.tangent(ue, ve, 9930.0)
    out["assembly"] = _time(lambda: f.dofmap.scatter_add({blk.key: te}),
                            reps=10)
    return out


def phase_elements():
    """Phase 9: the element route and the direct solve."""
    # (a) anchors through the CLI on the card, float64
    for path, n_tests in ELEMENT_DECKS.items():
        rc, out = _cli([path, "--device", "cuda"])
        if rc != 0 or f"result tests: {n_tests}/{n_tests} passed" not in out:
            raise RuntimeError(f"{path}: rc {rc}, RESULT DESCRIPTION not met "
                               f"on the card")
    # (b) GPU against CPU through driver.run, float64, and the launches
    for path in ELEMENT_DECKS:
        states = {}
        for device in ("cuda", "cpu"):
            reset_launches()
            res = driver.run(path, device=device)
            states[device] = res.fields["structure"].flat_state(
                res.states["structure"])
            if device == "cuda":
                counts = launches()
        hex8 = "hex8" in path
        others = {k: c for k, c in counts.items()
                  if not (hex8 and k == "solid_force")}
        if any(others.values()) or hex8 != (counts["solid_force"] > 0):
            raise RuntimeError(f"{path}: launches {counts}")
        errs = []
        for k in ("d", "v", "a"):
            got, want = states["cuda"][k].cpu(), states["cpu"][k]
            errs.append(float((got - want).abs().max() / want.abs().max()))
        log("elements", f"{path} float64, GPU vs CPU: d / v / a max rel "
                        f"err {errs[0]:.3e} / {errs[1]:.3e} / {errs[2]:.3e} "
                        f"(tol {STEP_TOL:g}); launches "
                        + (f"B6 mass-only {counts['solid_force']}, none of "
                           f"B1-B5 or B7" if hex8 else "none of B1-B7"))
        if not max(errs) <= STEP_TOL:
            raise RuntimeError(f"{path}: GPU run disagrees with the CPU run")
    # (c) bench.py's tet4 permuted box at n=56
    def after(f, state):
        blocks = [(b.key, b.cell.name, b.X.shape[1], b.model)
                  for b in f.blocks]
        log("tet4", f"blocks (key, cell, elements, kernel model): {blocks}")
        times = _time_element_route(f, state)
        log("tet4", "element route ms per call (device, CUDA events, "
                    "float32): " + ", ".join(f"{k} {v:.3f}"
                                             for k, v in times.items()))

    phase_main_path("tet4", mesh="permuted", cell="tet4",
                    n=FULL_N["permuted"], after=after)


INTEGRATOR_DECKS = {  # deck -> the kernels its run launches on the card
    "decks/solid_rayleigh_lumped_wide.yaml": ("stencil", "force", "tangent"),
    "decks/solid_ost_vibration.yaml": ("stencil", "force", "tangent",
                                       "solid_tangent"),
    "decks/solid_explicit_wave.yaml": (),
    "decks/solid_timada_pulse.yaml": ("solid_force",),
}
# phase 10: GPU against CPU, float64: d, v and a after every step, the
# largest difference over the run relative to the largest entry over the run
# (a final state may lie near a zero crossing, as the timada deck's d does)
DECK_TOL = 1e-11
# bench.py's BENCH_RAYLEIGH=1 variant of the flagship problem
RAYLEIGH = {"rayleigh_alpha": 0.3, "rayleigh_beta": 0.002, "mass": "lumped"}
# (elements per axis, timed steps): the reference's n=32 and the flagship's
RAYLEIGH_SIZES = ((32, 5), (72, 2))


def _time_damping(f, state):
    """Device ms per call (CUDA events, 10 calls) of the two damping terms
    of the Rayleigh step at the state: the damping force K(d) v (B2 with
    mcoef = 0) and D^2f(d)[v, .] applied (its per-iterate set-up timed
    apart)."""
    u = state["d"]
    v = torch.where(f.free, torch.randn_like(u), 0.0) * 1e-2
    apply = f.force_hessian_at(u, v)
    return {"damping force (B2, mcoef 0)": _time(lambda: f.tangent(u, v),
                                                 reps=10),
            "D2f set-up": _time(lambda: f.force_hessian_at(u, v), reps=10),
            "D2f apply": _time(lambda: apply(v), reps=10)}


def explicit_problem(n):
    """The flagship box at n, float32, under explicit central differences
    with lumped mass and dt a quarter of the CFL limit
    h / sqrt((lambda + 2 mu) / rho): (field, step, CFL limit, dt)."""
    f = build_problem(n, "cuda", torch.float32, "flagship",
                      changes={"dyntype": "explicit", "mass": "lumped"})
    h = min(f.lattice.h)
    cfl = h / ((f.lam + 2 * f.mu) / f.block_mat[f.key].density) ** 0.5
    dt = 0.25 * cfl
    return f, ps.make_step(f, dt=dt), cfl, dt


def phase_integrators():
    """Phase 10: statics, one-step-theta, explicit, lumped mass, Rayleigh
    damping, kinem linear, block-Jacobi and Zienkiewicz-Xie adaptivity."""
    # (a) the four gate decks: anchors through the CLI on the card, float64;
    # GPU against CPU through driver.run, the launches, the timada deck's
    # accepted dt sequence
    _decks_on_the_card("integrators", {path: (kernels, 6) for path, kernels
                                       in INTEGRATOR_DECKS.items()})

    # (b) rayleigh_wide at the reference's size and at the flagship's
    def after(f, state):
        times = _time_damping(f, state)
        log("rayleigh", f"n={f.lattice.nshape[0]}: ms per call (device, "
                        "CUDA events, float32): " + ", ".join(
                            f"{k} {v:.3f}" for k, v in times.items()))

    for n, steps in RAYLEIGH_SIZES:
        phase_main_path("rayleigh_wide", n_steps=steps, mesh="flagship",
                        n=n, changes=RAYLEIGH, path="flagship", after=after)
    # (c) the flagship box under statics (2 load steps) and one-step-theta
    n = FULL_N["flagship"]
    phase_main_path("statics", n_steps=1, mesh="flagship", n=n,
                    changes={"dyntype": "statics"}, path="flagship")
    phase_main_path("onesteptheta", n_steps=2, mesh="flagship", n=n,
                    changes={"dyntype": "onesteptheta", "theta": 0.66},
                    path="flagship")
    # (d) explicit central differences, lumped mass, below the CFL limit
    f, step, cfl, dt = explicit_problem(n)
    state = ps.compute_initial_state(f, ps.init_state(f))
    state, _ = step(state)  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    for _ in range(100):
        state, stats = step(state)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / 100
    counts = launches()
    finite = all(bool(torch.isfinite(state[k]).all())
                 for k in ("d", "v", "a"))
    log("explicit", f"n={n}: {f.ndof} dofs, CFL limit h / c = {cfl:.4e}, dt "
                    f"{dt:.4e}; 100 steps {ms:.2f} ms/step, max|d| "
                    f"{float(state['d'].abs().max()):.4e}, every entry "
                    f"finite: {finite}; launches {counts}")
    if not finite or counts != {**{k: 0 for k in counts}, "force": 100}:
        raise RuntimeError("explicit: non-finite state or launches other "
                           "than one B1 per step")


# anchors at float64's noise floor (the converted F-bar deck's nodal
# stresses): one that the card misses must lie within its tolerance plus
# this of 4C's value.  tools/fbar_anchor_noise.py spreads the CPU's
# stress_xx of node 4 around +1.08e-12 from 4C with std 9.2e-14 under half
# an ulp of noise in the internal force; the card landed +1.07e-12.
NOISE_BOUND = 1e-12
_ANCHOR = re.compile(r"^\[FAIL\] \S+ node \d+ (\S+): actual=(\S+) "
                     r"expected=(\S+) tol=(\S+)$")


def _anchors_missed_within_noise(path, out, prefix):
    """The lines of the anchors the card missed, if each is a ``prefix``
    quantity within its tolerance + NOISE_BOUND of 4C's value; else
    raise."""
    missed = [line for line in out.splitlines() if line.startswith("[FAIL]")]
    for line in missed:
        m = _ANCHOR.match(line)
        if not (m and m.group(1).startswith(prefix)):
            raise RuntimeError(f"{path}: anchor missed on the card: {line}")
        actual, expected, tol = (float(m.group(k)) for k in (2, 3, 4))
        if not abs(actual - expected) <= tol + NOISE_BOUND:
            raise RuntimeError(f"{path}: {line} lies beyond the tolerance + "
                               f"{NOISE_BOUND:g}")
    return missed


def _deck_path(src, label):
    """A deck dict written under build/ (git-ignored) for the CLI; a path as
    it is."""
    if isinstance(src, str):
        return src
    out = pathlib.Path("build") / "decks" / f"{label}.yaml"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(yaml.safe_dump(src))
    return str(out)


def _decks_on_the_card(label, decks):
    """``decks``: path (or label of a deck dict, ``(dict, kernels,
    anchors)``) -> (the kernels its run launches on the card, its number of
    anchors[, the prefix of quantities whose anchors sit at float64's noise
    floor]).  Each deck through the CLI on the card in float64 (every
    anchor met), then through ``driver.run`` on the card and on the CPU:
    d, v and a after every step within DECK_TOL of their largest entry
    over the run, and so the history of every block and, for a deck with
    ``stress_*`` anchors, the nodal stresses; the counts and launches
    printed and checked, an adaptive deck's accepted dt sequence the
    CPU's.

    A deck with a noise-floor prefix may miss anchors of those quantities
    on the card, and only those, if the CLI on the CPU meets every anchor
    and each miss lies within its tolerance + NOISE_BOUND of 4C's value:
    the 4C-converted F-bar deck's nodal stresses (1e-12 absolute on 24.66)
    move by about 1e-13 for half an ulp of rounding in the internal force
    (tools/fbar_anchor_noise.py: mean 1.08e-12 from 4C, 3 of 12 perturbed
    CPU runs within the tolerance), which is what a card's rounding
    differs by.  Each such miss is printed.  A deck of ROTATION_FREE is
    held to its anchors' rotation-free part (``_rotation_free_anchors``).
    Returns deck -> device -> the run's aggregate counts."""
    aggs = {}
    for path, spec in decks.items():
        src = path
        if isinstance(spec[0], dict):
            src, spec = spec[0], spec[1:]
        kernels, n_tests, *noisy = spec
        deck_file = _deck_path(src, path)
        reset_launches()
        rc, out = _cli([deck_file, "--device", "cuda"])
        counts = launches()
        if path in ROTATION_FREE:
            _rotation_free_anchors(label, path, out, n_tests)
        elif (rc != 0
              or f"result tests: {n_tests}/{n_tests} passed" not in out):
            if not noisy:
                raise RuntimeError(f"{path}: rc {rc}, RESULT DESCRIPTION "
                                   f"not met on the card")
            missed = _anchors_missed_within_noise(path, out, noisy[0])
            rc_cpu, out_cpu = _cli([deck_file, "--device", "cpu"])
            if (rc_cpu != 0 or f"result tests: {n_tests}/{n_tests} passed"
                    not in out_cpu):
                raise RuntimeError(f"{path}: RESULT DESCRIPTION not met on "
                                   f"the card nor on the CPU")
            log(label, f"{path}: on the card {len(missed)} of {n_tests} "
                       f"anchors missed, all {noisy[0]}* at float64's noise "
                       f"floor, each within its tolerance + "
                       f"{NOISE_BOUND:g}; the CPU meets all {n_tests}: "
                       + "; ".join(missed))
        runs, agg, fields = {}, {}, {}
        aggs[path] = agg
        for device in ("cuda", "cpu"):
            runs[device] = states = []
            res = driver.run(src, device=device, callbacks=[
                lambda _, st, __, out=states: out.append(
                    {**{k: st[k].cpu().clone() for k in ("d", "v", "a")},
                     **{f"hist {key}": h.cpu().clone()
                        for key, h in st.get("hist", {}).items()}})])
            agg[device] = res.stats["structure"]
            fields[device] = res.fields["structure"].f
        if len(runs["cuda"]) != len(runs["cpu"]):
            raise RuntimeError(f"{path}: {len(runs['cuda'])} steps on the "
                               f"card, {len(runs['cpu'])} on the CPU")
        if any(str(t.get("quantity", "")).startswith("stress_")
               for t in res.deck.result_tests):
            for device, f in fields.items():
                for st in runs[device]:
                    st["stress"] = f.nodal_stresses(
                        st["d"].to(f.device)).cpu()
        errs = {}
        for k in runs["cpu"][0]:  # v = a = 0 under statics: absolute
            diff = max(float((g[k] - c[k]).abs().max())
                       for g, c in zip(runs["cuda"], runs["cpu"]))
            scale = max(float(c[k].abs().max()) for c in runs["cpu"])
            errs[k] = diff / scale if scale else diff
        launched = {KERNELS[k][0]: c for k, c in counts.items() if c}
        log(label, f"{path} float64: newton "
                   f"{agg['cuda']['newton_iters']}, linear solver "
                   f"{agg['cuda']['lin_iters']} on the card "
                   f"(CPU: {agg['cpu']['newton_iters']}, "
                   f"{agg['cpu']['lin_iters']}); GPU vs CPU over "
                   f"{len(runs['cpu'])} steps, max rel err "
                   + ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
                   + f" (tol {DECK_TOL:g}); launches "
                   f"{launched or 'none of B1-B7'}")
        if not max(errs.values()) <= DECK_TOL:
            raise RuntimeError(f"{path}: GPU run disagrees with the CPU run")
        if {k for k, c in counts.items() if c} != set(kernels):
            raise RuntimeError(f"{path}: launches {counts}")
        if "dt_history" in agg["cuda"]:
            hist = agg["cuda"]["dt_history"]
            log(label, f"{path}: {len(hist)} accepted steps, dt levels "
                       f"{agg['cuda']['dt_levels']}, "
                       f"{agg['cuda']['rejections']} rejections, the same "
                       f"sequence on the CPU: "
                       f"{hist == agg['cpu']['dt_history']}")
            if hist != agg["cpu"]["dt_history"]:
                raise RuntimeError(f"{path}: the accepted dt sequence differs "
                                   f"from the CPU's")
    return aggs


# deck -> (the kernels its run launches, its anchors[, the noise-floor
# quantities of _decks_on_the_card])
TECH_DECKS = {
    "decks/solid_eas_bending.yaml": ((), 3),
    "decks/solid_fbar_compression.yaml": ((), 3),
    "decks/solid_goh_artery_strip.yaml": ((), 3),
    "decks/ref_converted/solid_ele_hex8_standard_fbar.yaml": ((), 22,
                                                              "stress_"),
}
# phase 11 (b)-(d): the permuted box of phase 7 under a tech, B6 launched
# for the mass alone
TECH_PATHS = (("fbar_permuted", {"tech": "fbar"},
               {"lin_method": "gmres", "gmres_restart": 50}, 2),
              ("eas_permuted", {"tech": "eas_mild"}, {"lin_method": "cg"},
               1),
              ("fbar_bicgstab", {"tech": "fbar"},
               {"lin_method": "bicgstab"}, 0))


def _time_tech(f, state):
    """Device ms per call (CUDA events, 5 calls) of the tech's force and
    tangent with the mass at the state's displacement, on the field and on
    its block alone (without the gathers and the assembly)."""
    u = state["d"]
    v = torch.where(f.free, torch.randn_like(u), 0.0) * 1e-2
    blk = f.blocks[0]
    ue, ve = f.dofmap.gather(u, blk.key), f.dofmap.gather(v, blk.key)
    return {"force": _time(lambda: f.internal_force(u), reps=5),
            "tangent with the mass": _time(lambda: f.tangent(u, v, 9930.0),
                                           reps=5),
            "element force alone": _time(lambda: blk.force(ue), reps=5),
            "element tangent alone": _time(
                lambda: blk.tangent(ue, ve, 9930.0), reps=5)}


def phase_techs():
    """Phase 11: F-bar, EAS, GMRES, BiCGStab, the fibre summands, the body
    force and nodal stresses."""
    # (a) the four decks: anchors on the card, GPU against CPU
    _decks_on_the_card("techs", TECH_DECKS)
    tech_paths()


def tech_paths():
    """Phase 11 (b)-(d): the permuted box at n=56 under F-bar and EAS."""
    def after(f, state):
        blocks = [(b.key, b.tech, b.X.shape[1], b.model) for b in f.blocks]
        log(f.params.tech, f"blocks (key, tech, elements, kernel model): "
                           f"{blocks}")
        log(f.params.tech, "ms per call (device, CUDA events, float32): "
            + ", ".join(f"{k} {v:.3f}" for k, v in _time_tech(f, state)
                        .items()))

    for name, changes, newton, steps in TECH_PATHS:
        phase_main_path(name, n_steps=steps, mesh="permuted",
                        n=FULL_N["permuted"], changes=changes, newton=newton,
                        kernels={"solid_force"},
                        after=after if steps else None)


# phase 12 (a): deck -> (the kernels its run launches on the card, its
# anchors); the spring deck with its viscosity zeroed is a dict
HISTORY_DECKS = {
    "decks/solid_ogden_uniaxial.yaml": ((), 3),
    "decks/volume_constraint.yaml": (("force", "tangent"), 3),
    "decks/viscoelastic_relaxation.yaml": ((), 3),
    "decks/solid_j2_cyclic.yaml": ((), 3),
    "decks/plasticity_lognh_torsion.yaml": ((), 3),
}
SPRING_DECK = "decks/spring_dashpot_settling.yaml"
# phase 12 (b)-(d): bench.py's permuted box under a law with history
VISCO = {"type": "viscoelasthyper", "taus": [1.0], "betas": [0.5],
         "material": NEOHOOKE}
J2 = {"type": "plasticlinelast", "youngs": 1.0e4, "nue": 0.3,
      "yield_stress": None, "isohard": 500.0, "kinhard": 300.0,
      "density": 1.0}
LOGNH = {"type": "plasticnlnlogneohooke", "youngs": 1.0e4, "nue": 0.3,
         "yield_stress": None, "isohard": 500.0, "density": 1.0}
# (name, law, SolidParams changes, Newton changes, timed steps); the
# plastic paths with line search and up to 25 Newton iterations, as the
# plasticity gate decks (maxiter 50 and 40): plain Newton oscillates once
# the plastic zone spreads (12 iterations of the third J2 step left the
# residual at 3.8)
PLASTIC_NEWTON = {"line_search": True, "max_iter": 25}
HISTORY_PATHS = (("visco_permuted", VISCO, {}, {"lin_method": "cg"}, 2),
                 ("j2_permuted", J2, {"kinem": "linear"},
                  {"lin_method": "cg", **PLASTIC_NEWTON}, 2),
                 ("lognh_permuted", LOGNH, {},
                  {"lin_method": "gmres", "gmres_restart": 50,
                   **PLASTIC_NEWTON}, 1))


def spring_deck_without_dashpot():
    """The spring-dashpot deck with its viscosity zeroed: the reference
    drops the dashpot under one-step-theta, so its anchors are
    spring-only."""
    with open(SPRING_DECK) as fh:
        data = yaml.safe_load(fh)
    for sp in data["conditions"]["spring_dashpot"]:
        sp["viscosity"] = [0.0] * len(sp["viscosity"])
    return data


def _von_mises(f, state, dt):
    """The von Mises stress of the law's stress at every Gauss point of
    every block, (g, E) each, at the state's displacement and history."""
    out = []
    for b in f.blocks:
        ue = f.dofmap.gather(state["d"], b.key)
        H = sops._grad(ue.reshape(b.cell.nen, 3, -1), b.G)
        S, _ = sops._stress(b.material, H, b.kinem,
                            state["hist"].get(b.key), dt)
        dev = S - gm.tr3l(S) / 3.0 * gm.eye3l(S)
        out.append(torch.sqrt(1.5 * (dev * dev).sum(dim=(0, 1))))
    return out


def _set_yield(name):
    """prepare(f) of phase 12 (c), (d): one elastic step (the yield stress
    out of reach), then the yield stress half the largest von Mises stress
    at its Gauss points."""
    def prepare(f):
        mat = f.blocks[0].material
        mat.yield_stress = 1e30
        state = ps.compute_initial_state(f, ps.init_state(f))
        state, stats = make_step(f, name)(state)
        if not stats["converged"]:
            raise RuntimeError(f"{name}: the elastic step did not converge")
        vm = max(float(v.max()) for v in _von_mises(f, state, 0.02))
        mat.yield_stress = 0.5 * vm
        log(name, f"elastic first step: {stats['iters']} Newton, "
                  f"{stats['lin_iters']} Krylov; largest von Mises stress "
                  f"{vm:.6g}, yield stress set to {mat.yield_stress:.6g}")
    return prepare


def _time_history(f, state):
    """Device ms per call (CUDA events, 5 calls, 3 for the
    linearization) of the force, the law's linearization (once per Newton
    iterate: its derivatives along six strain directions) and the tangent
    with the mass at the state's displacement and history (the Krylov
    apply: the field's reuses its iterate's linearization), on the field
    and on its block alone."""
    u, hist, dt = state["d"], state["hist"], 0.02
    v = torch.where(f.free, torch.randn_like(u), 0.0) * 1e-2
    blk = f.blocks[0]
    ue, ve = f.dofmap.gather(u, blk.key), f.dofmap.gather(v, blk.key)
    h = hist[blk.key]
    mod = blk.moduli(ue, h, dt)
    return {"force": _time(lambda: f.internal_force(u, hist, dt), reps=5),
            "linearization": _time(lambda: blk.moduli(ue, h, dt), reps=3),
            "tangent with the mass": _time(
                lambda: f.tangent(u, v, 9930.0, hist, dt), reps=5),
            "element force and history alone": _time(
                lambda: blk.force(ue, h, dt, with_history=True), reps=5),
            "element tangent alone": _time(
                lambda: blk.tangent(ue, ve, 9930.0, h=h, dt=dt, moduli=mod),
                reps=5)}


def phase_history():
    """Phase 12: Gauss-point history, the Ogden and Sussman-Bathe summands,
    spring-dashpots and the volume constraint."""
    # (a) the decks: anchors on the card, GPU against CPU with the history
    try:
        _cli([SPRING_DECK, "--device", "cuda"])
    except NotImplementedError as exc:
        if "drops the dashpot" not in str(exc):
            raise
        log("history", f"{SPRING_DECK} as written is refused: {exc}")
    else:
        raise RuntimeError(f"{SPRING_DECK}: the dashpot under one-step-theta "
                           f"was not refused")
    _decks_on_the_card("history", {
        **HISTORY_DECKS, "spring_dashpot_settling_no_dashpot": (
            spring_deck_without_dashpot(), ("stencil", "force", "tangent"),
            6)})
    history_paths()


# law -> (its history entry that grows where it yields, that entry's name,
# its value before the first step: the yielded share of phases 12 and 13)
YIELDED = {"plasticlinelast": (18, "kappa", lambda m: 0.0),
           "plasticnlnlogneohooke": (6, "alpha", lambda m: 0.0),
           "plasticgtn": (9, "ebar", lambda m: 0.0),
           "crystal_plasticity": (9, "g", lambda m: m.g0)}


def prepare_for(name, law):
    """The ``prepare`` of a path of phase 12 or 13 under ``law``: the
    elastic first step that sets the yield stress or the slip resistance,
    or None."""
    if "yield_stress" in law:
        return _set_yield(name)
    if law["type"] == "crystal_plasticity":
        return _set_slip_resistance(name)
    return None


def _mean_activation(m, h):
    """Blemker's f_t at the history's time: sigma_max f_t / sigma_max."""
    return float(m.activation(h[..., 0]).double().mean()) / m.sigma_max


# law of phase 14 -> (its state change, measured on the history (E, g,
# nh) after the steps: nonzero where the law did work)
GROWN = {"growthremodel_cm": (
             "mean relative growth of the fibre mass rho from rho0",
             lambda m, h: float(h[..., [0, 2]].double().mean()) / m.rho0
             - 1.0),
         "mixture_rule": (
             "mean growth of the fibres' g from 1",
             lambda m, h: float(h[..., 0::2].double().mean()) - 1.0),
         "muscle_blemker": ("mean activation f_t", _mean_activation)}


def history_paths(paths=None):
    """Phase 12 (b)-(d): the permuted box at n=56 under the three history
    laws (phase 13 (b), (c): ``paths`` PLASTICITY_PATHS)."""
    def after(f, state):
        blk = f.blocks[0]
        law, h = blk.material.deck_name, state["hist"][blk.key]
        blocks = [(b.key, b.X.shape[1], b.model) for b in f.blocks]
        log(law, f"blocks (key, elements, kernel model): {blocks}; history "
                 f"{tuple(h.shape)} {h.dtype}, {h.numel() * h.element_size()}"
                 f" bytes")
        if law in YIELDED:
            k, what, start = YIELDED[law]
            h0 = start(blk.material)
            share = float((h[..., k] > h0).double().mean())
            log(law, f"Gauss points with {what} > {h0:.6g} after the steps: "
                     f"{100 * share:.2f}% of {h.shape[0] * h.shape[1]}")
            if not 0.0 < share < 1.0:
                raise RuntimeError(f"{law}: yielded share {share} not "
                                   f"strictly between 0 and 1")
        if law in GROWN:
            what, measure = GROWN[law]
            value = measure(blk.material, h)
            log(law, f"{what} after the steps, mean over "
                     f"{h.shape[0] * h.shape[1]} Gauss points: {value:.6g}")
            if not (np.isfinite(value) and value != 0.0):
                raise RuntimeError(f"{law}: {what} {value}: the law did no "
                                   f"work")
            log(law, f"nvidia-smi: {_smi()}")
        log(law, "ms per call (device, CUDA events, float32): " + ", ".join(
            f"{k} {v:.3f}" for k, v in _time_history(f, state).items()))

    for name, law, changes, newton, steps in paths or HISTORY_PATHS:
        phase_main_path(name, n_steps=steps, mesh="permuted",
                        n=FULL_N["permuted"], changes=changes, newton=newton,
                        material={k: (1e30 if v is None else v)
                                  for k, v in law.items()},
                        kernels={"solid_force"}, after=after,
                        prepare=prepare_for(name, law))


# phase 13 (a): deck -> the Newton iterations and substeps of the
# reference's run (python -m fourc_tpu.app.main <deck>); each has 3
# anchors and launches none of B1-B7
PLASTICITY_DECKS = {"decks/druckerprager_shear.yaml": (16, 4),
                    "decks/gtn_voided_tension.yaml": (27, 8),
                    "decks/lemaitre_damage_bar.yaml": (29, 8),
                    "decks/robinson_relaxation.yaml": (8, 10),
                    "decks/sma_superelastic_cycle.yaml": (95, 15),
                    "decks/crystal_plasticity_shear.yaml": (24, 6)}
# phase 13 (b), (c): bench.py's permuted box under GTN (the gate deck's f0,
# fn, en, sn; isohard its ratio to E) and crystal plasticity (the gate
# deck's gdot0, rate_m and nsub; g0 set from an elastic step, h0 and g_sat
# its ratios to g0)
GTN_LAW = {"type": "plasticgtn", "youngs": 1.0e4, "nue": 0.3,
           "yield_stress": None, "isohard": 400.0, "f0": 0.02, "fn": 0.04,
           "en": 0.1, "sn": 0.05, "density": 1.0}
CRYSTAL_LAW = {"type": "crystal_plasticity", "youngs": 1.0e4, "nue": 0.3,
               "g0": None, "gdot0": 1e-2, "rate_m": 0.2, "h0": None,
               "g_sat": None, "nsub": 10, "density": 1.0}
PLASTICITY_PATHS = (("gtn_permuted", GTN_LAW, {"kinem": "linear"},
                     {"lin_method": "gmres", "gmres_restart": 50,
                      **PLASTIC_NEWTON}, 2),
                    ("crystal_permuted", CRYSTAL_LAW, {},
                     {"lin_method": "gmres", "gmres_restart": 50,
                      **PLASTIC_NEWTON}, 1))


def _rotation_free_anchors(label, path, out, n_tests):
    """The card's CLI run of a ROTATION_FREE deck: every anchor but the
    rotated pair met, and the pair's sum within the sum of their
    tolerances of the anchors' sum."""
    lines = read_node_lines(out)
    pair = ROTATION_FREE[path]
    if len(lines) != n_tests:
        raise RuntimeError(f"{path}: {len(lines)} anchors read, not "
                           f"{n_tests}")
    for key, (actual, expected, tol) in lines.items():
        if key not in pair and not abs(actual - expected) <= tol:
            raise RuntimeError(f"{path}: anchor {key} missed on the card")
    got = sum(lines[k][0] for k in pair)
    want = sum(lines[k][1] for k in pair)
    tol = sum(lines[k][2] for k in pair)
    log(label, f"{path}: {n_tests - len(pair)} of {n_tests} anchors met; "
               f"the rigid rotation about z is free: {pair[0]} + {pair[1]} "
               f"= {got!r} against the anchors' {want!r} (tol {tol:g}), "
               f"each alone {[lines[k][0] for k in pair]} against "
               f"{[lines[k][1] for k in pair]}")
    if not abs(got - want) <= tol:
        raise RuntimeError(f"{path}: the rotation-free sum {got!r} misses "
                           f"the anchors' {want!r}")


def _set_slip_resistance(name):
    """prepare(f) of phase 13 (c): one elastic step (g0 out of reach),
    then g0 half the largest resolved shear |tau_a| at its Gauss points,
    h0 = 2.5 g0 and g_sat = 3 g0 (the crystal deck's ratios)."""
    def prepare(f):
        blk = f.blocks[0]
        mat = blk.material
        mat.g0 = mat.h0 = mat.g_sat = 1e30
        state = ps.compute_initial_state(f, ps.init_state(f))
        state, stats = make_step(f, name)(state)
        if not stats["converged"]:
            raise RuntimeError(f"{name}: the elastic step did not converge")
        ue = f.dofmap.gather(state["d"], blk.key)
        H = sops._grad(ue.reshape(blk.cell.nen, 3, -1), blk.G)
        E = sops._green_lagrange(H)
        tau = mat.resolved_shears(2.0 * E + gm.eye3l(E),
                                  gm.eye3l(E).expand_as(E))
        tmax = float(tau.abs().max())
        mat.g0 = 0.5 * tmax
        mat.h0, mat.g_sat = 2.5 * mat.g0, 3.0 * mat.g0
        log(name, f"elastic first step: {stats['iters']} Newton, "
                  f"{stats['lin_iters']} Krylov; largest resolved shear "
                  f"{tmax:.6g}, g0 set to {mat.g0:.6g}, h0 {mat.h0:.6g}, "
                  f"g_sat {mat.g_sat:.6g}")
    return prepare


def phase_plasticity():
    """Phase 13: the other plasticity laws."""
    # (a) the six decks: anchors on the card, GPU against CPU with the
    # history, the reference's Newton iterations and substeps
    aggs = _decks_on_the_card("plasticity", {
        path: ((), 3) for path in PLASTICITY_DECKS})
    for path, (newton, substeps) in PLASTICITY_DECKS.items():
        for device, agg in aggs[path].items():
            got = (agg["newton_iters"], agg["substeps"])
            log("plasticity", f"{path} on {device}: {got[0]} Newton, "
                              f"{got[1]} substeps, {agg['lin_iters']} "
                              f"Krylov (the reference: {newton}, "
                              f"{substeps})")
            if got != (newton, substeps):
                raise RuntimeError(f"{path}: {got} Newton iterations and "
                                   f"substeps on {device}, the reference "
                                   f"takes {(newton, substeps)}")
    history_paths(PLASTICITY_PATHS)


# phase 14 (a): deck -> (the Newton iterations of the reference's run,
# python -m fourc_tpu.app.main <deck>; its steps, one substep each); each
# has 3 anchors and launches none of B1-B7
BIOLOGY_DECKS = {"decks/muscle_active_twitch.yaml": (12, 4),
                 "decks/muscle_blemker_contraction.yaml": (13, 4),
                 "decks/cardiac_active_stress_twitch.yaml": (24, 8),
                 "decks/growth_remodel_strip.yaml": (14, 6),
                 "decks/mixture_gr_artery_strip.yaml": (19, 6)}
# phase 14 (b)-(d): bench.py's permuted box under the gate decks' laws,
# their parameters at the decks' ratios to E scaled to E 1e4 and their
# rates per step at dt 0.02
GROWTHREMODEL_LAW = {"type": "growthremodel_cm", "youngs_elastin": 1.0e4,
                     "nue": 0.3, "k_fiber": 5.0e3, "sigma_h": 625.0,
                     "k_sigma": 10.0, "k_remodel": 10.0, "prestretch": 1.05,
                     "a1": [1.0, 0.0, 0.0], "a2": [0.0, 1.0, 0.0],
                     "density": 1.0}
MIXTURE_LAW = {"type": "mixture_rule", "rule": "growthremodel",
               "density": 1.0, "constituents": [
                   {"kind": "solid", "frac": 0.4,
                    "material": {"type": "elasthyper", "summands": [
                        {"type": "couplogneohooke", "youngs": 1.0e4,
                         "nue": 0.3}]},
                    "prestretch": [1.05, 1.0, 1.0]},
                   *({"kind": "remodelfiber", "frac": 0.3, "k1": 3333.3,
                      "k2": 1.5, "a": [1.0, sign * 0.3, 0.0],
                      "lambda_pre": 1.08, "k_sig": 12.5, "decay_time": 0.16,
                      "impl": True} for sign in (1.0, -1.0))]}
BLEMKER_LAW = {"type": "muscle_blemker", "g1": 25.0, "g2": 25.0, "p1": 0.05,
               "p2": 6.6, "sigma_max": 2000.0, "lambda_ofl": 1.2,
               "lambda_star": 1.4, "alpha": 1.0, "beta": 33.3,
               "youngs": 1.0e4, "nue": 0.3, "density": 1.0}
BIOLOGY_PATHS = (("growthremodel_permuted", GROWTHREMODEL_LAW, {},
                  {"lin_method": "gmres", "gmres_restart": 50,
                   "line_search": True}, 2),
                 ("mixture_permuted", MIXTURE_LAW, {},
                  {"lin_method": "cg", **PLASTIC_NEWTON}, 2),
                 ("blemker_permuted", BLEMKER_LAW, {}, {"lin_method": "cg"},
                  2))


def phase_biology():
    """Phase 14: the growth, mixture and muscle laws."""
    # (a) the five decks: anchors on the card, GPU against CPU with the
    # history, the reference's Newton iterations, one substep per step
    aggs = _decks_on_the_card("biology", {
        path: ((), 3) for path in BIOLOGY_DECKS})
    for path, (newton, steps) in BIOLOGY_DECKS.items():
        for device, agg in aggs[path].items():
            got = (agg["newton_iters"], agg["substeps"])
            log("biology", f"{path} on {device}: {got[0]} Newton, {got[1]} "
                           f"substeps, {agg['lin_iters']} Krylov (the "
                           f"reference: {newton}, {steps})")
            if got != (newton, steps):
                raise RuntimeError(f"{path}: {got} Newton iterations and "
                                   f"substeps on {device}, the reference "
                                   f"takes {(newton, steps)}")
    history_paths(BIOLOGY_PATHS)


# phase 15 (a): deck -> (anchors met, anchors, the reference CLI's Newton
# iterations; 4C's form's for the two MULF decks, tests/port)
FIELD_DECKS = {"decks/ref_converted/thermo_bar_dbc_genalpha.yaml": (3, 3, 100),
               "decks/thermo_fin_cooling.yaml": (2, 2, 97),
               "decks/ref_converted/scatra_3d_straight_convection.yaml":
                   (2, 2, 1),
               "decks/tsi_heated_bar.yaml": (3, 3, 70),
               "decks/tsi_partitioned_bar.yaml": (3, 3, 2044),
               "decks/ref_converted/solid_ele_hex8_standard_mulf.yaml":
                   (12, 12, 42),
               "decks/mulf_prestress.yaml": (0, 3, 0)}


def _state_tensors(st):
    """Every tensor of a state (the history's by block), on the host."""
    out = {}
    for k, v in st.items():
        if torch.is_tensor(v):
            out[k] = v.detach().cpu().clone()
        elif isinstance(v, dict):
            out.update({f"{k} {kk}": vv.detach().cpu().clone()
                        for kk, vv in v.items()})
    return out


@contextlib.contextmanager
def _recording(states):
    """``driver.run`` keeps every state's tensors in ``states`` after every
    step while the block runs (the CLI's own run on the card), and leaves
    its result in ``recorded.result``."""
    run = driver.run

    def recorded(src, callbacks=None, device="cuda"):
        recorded.result = run(src, device=device, callbacks=[
            *(callbacks or ()),
            lambda _, st, __: states.append(_state_tensors(st))])
        return recorded.result

    driver.run = recorded
    try:
        yield recorded
    finally:
        driver.run = run


def _field_decks_on_the_card(decks=None, label="fields"):
    """Phase 15 (a) and 16 (a): each deck through the CLI on the card (its
    anchors as FIELD_DECKS or FLUID_DECKS says; the CLI's own
    ``driver.run`` keeps the card's states), then through ``driver.run`` on
    the CPU: every state tensor after every step within DECK_TOL of its
    largest entry over the run, the recorded Newton iterations on both."""
    for path, (met, n_tests, newton) in (decks or FIELD_DECKS).items():
        t0 = time.perf_counter()
        reset_launches()
        runs, aggs = {"cuda": [], "cpu": []}, {}
        with _recording(runs["cuda"]) as card:
            rc, out = _cli([path, "--device", "cuda"])
        counts = launches()
        if (f"result tests: {met}/{n_tests} passed" not in out
                or rc != (0 if met == n_tests else 1)):
            raise RuntimeError(f"{path}: rc {rc}, not {met}/{n_tests} "
                               f"anchors met on the card")
        t_cli = time.perf_counter() - t0
        aggs["cuda"] = card.result.stats[next(iter(card.result.stats))]
        res = driver.run(path, device="cpu", callbacks=[
            lambda _, st, __: runs["cpu"].append(_state_tensors(st))])
        aggs["cpu"] = res.stats[next(iter(res.stats))]
        if len(runs["cuda"]) != len(runs["cpu"]):
            raise RuntimeError(f"{path}: {len(runs['cuda'])} steps on the "
                               f"card, {len(runs['cpu'])} on the CPU")
        errs = {}
        for k in runs["cpu"][0]:
            diff = max(float((g[k] - c[k]).abs().max())
                       for g, c in zip(runs["cuda"], runs["cpu"]))
            scale = max(float(c[k].abs().max()) for c in runs["cpu"])
            errs[k] = diff / scale if scale else diff
        got = {d: a["newton_iters"] for d, a in aggs.items()}
        log(label, f"{path} float64: {met}/{n_tests} anchors on the card "
                      f"(CLI {t_cli:.1f} s); newton {got['cuda']}, linear "
                      f"solver {aggs['cuda']['lin_iters']} on the card (CPU: "
                      f"{got['cpu']}, {aggs['cpu']['lin_iters']}; "
                      f"recorded: {newton}); GPU vs CPU over "
                      f"{len(runs['cpu'])} steps, max rel err "
                      + ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
                      + f" (tol {DECK_TOL:g}); card ms/step "
                      f"{1e3 * aggs['cuda']['walltime'] / aggs['cuda']['steps']:.1f}"
                      f"; launches {({k: c for k, c in counts.items() if c}) or 'none of B1-B7'}")
        if not max(errs.values()) <= DECK_TOL:
            raise RuntimeError(f"{path}: GPU run disagrees with the CPU run")
        if set(got.values()) != {newton}:
            raise RuntimeError(f"{path}: {got} Newton iterations, "
                               f"{newton} recorded")
        if any(counts.values()):
            raise RuntimeError(f"{path}: launches {counts}")


# phase 15 (b): tsi_heated_bar's law at phase 7's E and nu (conductivity
# and capacity scaled with E, so the diffusivity k / (rho c) stays 5)
TSI_LAW = {"type": "thermostvenantkirchhoff", "youngs": 1.0e4, "nue": 0.3,
           "thexpans": 1e-3, "inittemp": 293.0, "conductivity": 50.0,
           "capacity": 10.0, "density": 1.0}
TSI_STEPS, TSI_DT, TSI_RISE = 3, 0.02, 20.0


def tsi_problem(n, device, dtype, n_steps=TSI_STEPS, dt=TSI_DT):
    """``tsi_permuted``: the permuted box of phase 7 as a monolithic TSI
    field (TSI_LAW; one-step-theta 0.66 / 1.0; zmin clamped, phase 7's
    traction on zmax, zmax's temperature T0 + TSI_RISE t / (n_steps dt));
    bench.py's float32 Newton settings with GMRES(50), SA-AMG (``amg``) on
    the structure and Jacobi on the temperatures."""
    from fourc_tpu_torch.physics import scalar_transport as st
    from fourc_tpu_torch.physics import tsi

    disc = make_mesh(n, "permuted")
    mat = materials.make_material(dict(TSI_LAW))
    nw = bench_newton(4 * disc.n_nodes, dtype)  # the coupled system's size
    nw.lin_method, nw.gmres_restart = "gmres", 50
    params = ps.SolidParams(kinem="nonlinear", dyntype="onesteptheta",
                            theta=0.66, precond="amg", predictor="constdis",
                            newton=nw)
    fm = functions.FunctionManager()
    fm.add(1, "sin(50.0*t)*(1-exp(-t/0.06))")
    T0 = TSI_LAW["inittemp"]
    fm.add(2, f"{T0!r}+{TSI_RISE!r}*t/{n_steps * dt!r}")
    solid = ps.SolidField(
        disc, {1: mat}, params,
        dirichlet=[conditions.DirichletBC(disc.node_sets["zmin"], [1, 1, 1],
                                          [0, 0, 0])],
        neumann=[conditions.NeumannBC(disc.face_sets["zmax"], [1, 0, 0],
                                      [400.0, 0, 0], funct=[1, 0, 0])],
        functions=fm, device=device, dtype=dtype, general=True)
    thermo = st.ScalarField(
        disc, {1: mat}, st.ScalarParams(dyntype="onesteptheta", theta=1.0,
                                        dt=dt, newton=nw),
        dirichlet=[conditions.DirichletBC(disc.node_sets["zmax"], [1], [1.0],
                                          [2])],
        functions=fm, device=device, dtype=dtype)
    return tsi.TsiField(solid, thermo, tsi.TsiParams(dt=dt))


def _fields_path(name, f, state, step, n_steps, kernels, after):
    """Warm-up and ``n_steps`` timed steps of a phase 15 path (the launches
    counted from the warm-up on), every step converged, then ``after``."""
    reset_launches()
    t0 = time.perf_counter()
    state, stats = step(state)
    torch.cuda.synchronize()
    log(name, f"warm-up step {1e3 * (time.perf_counter() - t0):.1f} ms: "
              f"{stats}")
    timed = []
    t0 = time.perf_counter()
    for _ in range(n_steps):
        state, st_ = step(state)
        timed.append(st_)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / n_steps
    counts = launches()
    for i, st_ in enumerate([stats] + timed):
        log(name, f"step {i}: newton {st_['iters']}, linear solver "
                  f"{st_['lin_iters']}, resnorm {st_['resnorm']:.4e}, "
                  f"converged {st_['converged']}")
        if not (st_["converged"] and np.isfinite(st_["resnorm"])):
            raise RuntimeError(f"{name} step {i} did not converge")
    log(name, f"{ms:.1f} ms/step over {n_steps} timed steps "
              f"({sum(s['iters'] for s in timed)} Newton, "
              f"{sum(s['lin_iters'] for s in timed)} linear solver "
              f"iterations in total), peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
              f"launches {counts}")
    _check_launched(f"the {name} path", None, counts, kernels)
    after(state)
    return state


def phase_fields(tsi_steps=TSI_STEPS - 1, mulf_steps=1):
    """Phase 15: thermo, scalar transport, TSI and MULF prestress."""
    from fourc_tpu_torch.physics import tsi_driver as td

    _field_decks_on_the_card()
    # (b) tsi_permuted
    n = FULL_N["permuted"]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    f = tsi_problem(n, "cuda", torch.float32)
    state = td.init_state(f)
    step = td.make_step(f, TSI_DT)
    torch.cuda.synchronize()
    log("tsi_permuted", f"n={n}: {f.nd} structure dofs, {f.nt} "
                        f"temperatures, field and initial state "
                        f"{time.perf_counter() - t0:.1f} s; "
                        f"nvidia-smi: {_smi()}")

    def after_tsi(st):
        c = td.CoupledStep(f, st, TSI_DT)
        y = f.join(st["d"], st["T"])
        v = torch.randn_like(y) * 1e-2
        rise = float((st["T"] - TSI_LAW["inittemp"]).abs().max())
        log("tsi_permuted", f"largest temperature rise {rise:.4f} K "
                            f"(zmax at {TSI_RISE * (tsi_steps + 1) / TSI_STEPS:.4f});"
                            f" max|d| {float(st['d'].abs().max()):.4e}")
        if not (torch.isfinite(y).all() and rise > 0):
            raise RuntimeError("tsi_permuted: non-finite state or no "
                               "heating")
        log("tsi_permuted", "ms per call (device, CUDA events, float32): "
            f"coupled residual {_time(lambda: c.residual(y), reps=5):.3f}, "
            f"Jacobian action {_time(lambda: c.jacobian(y, v), reps=5):.3f},"
            f" structure mass (B6) {_time(lambda: f.solid.mass_matvec(st['d']), reps=5):.3f}")
        # the law's strain derivative by forward mode instead of its
        # pk2_from_E at the increment (Material.affine_in_strain)
        law = type(f.solid.block_mat[next(iter(f.solid.block_mat))])
        law.affine_in_strain = False
        try:
            fwd = _time(lambda: c.jacobian(y, v), reps=5)
        finally:
            law.affine_in_strain = True
        log("tsi_permuted", "ms per call, Jacobian action with the law's "
            f"strain derivative by forward mode {fwd:.3f}")
        # the thermo rows' derivative: its linear part (the port's) against
        # forward mode through the residual (the reference's jax.jvp)
        d, T = f.split(y)
        vd, vT = f.split(v)
        log("tsi_permuted", "ms per call, thermo rows' derivative: linear "
            f"part {_time(lambda: c.thermo_tangent(vd, vT), reps=5):.3f}, "
            "forward mode "
            f"{_time(lambda: torch.func.jvp(c.thermo, (d, T), (vd, vT)), reps=5):.3f}")

    t0 = time.perf_counter()
    M = f.block_precond(state["d"], TSI_DT, td._mass_shift(f, TSI_DT),
                        td._thermo_factor(f, TSI_DT))  # builds, keeps SA-AMG
    torch.cuda.synchronize()
    log("tsi_permuted", f"SA-AMG setup {time.perf_counter() - t0:.2f} s")
    del M
    _fields_path("tsi_permuted", f, state, step, tsi_steps, {"solid_force"},
                 after_tsi)
    # (c) mulf_permuted
    del f, state, step
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    f = build_problem(n, "cuda", torch.float32, "permuted",
                      changes={"dyntype": "statics", "precond": "amg"},
                      newton={"lin_method": "cg"},
                      material={"type": "mulf",
                                "material": dict(NEOHOOKE)})
    state = ps.compute_initial_state(f, ps.init_state(f))
    step = ps.make_step(f, dt=0.02)
    torch.cuda.synchronize()
    log("mulf_permuted", f"n={n}: {f.ndof} dofs, field, initial state and "
                         f"SA-AMG {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    state, stats = step(state)
    state = ps.update_prestress(f, state)
    torch.cuda.synchronize()
    key = f.blocks[0].key
    F0 = state["hist"][key]
    dev = float((F0 - torch.eye(3, device=F0.device,
                                dtype=F0.dtype).reshape(9)).abs().max())
    log("mulf_permuted", f"prestress step {1e3 * (time.perf_counter() - t0):.1f}"
                         f" ms: newton {stats['iters']}, cg "
                         f"{stats['lin_iters']}, converged "
                         f"{stats['converged']}; largest |F0 - I| {dev:.4e}")
    if not (stats["converged"] and 0.0 < dev < 1.0):
        raise RuntimeError(f"mulf_permuted: prestress step {stats}, "
                           f"|F0 - I| {dev}")

    def after_mulf(st):
        d = st["d"]
        log("mulf_permuted", f"max|d| after the prestress "
                             f"{float(d.abs().max()):.4e}")
        if not torch.isfinite(d).all():
            raise RuntimeError("mulf_permuted: non-finite d")

    _fields_path("mulf_permuted", f, state, step, mulf_steps, set(),
                 after_mulf)


# phase 16 (a): the nine decks of slice 6a -> (anchors met, anchors, Newton
# iterations: the reference CLI's, the port's on the Poiseuille and
# Windkessel decks, whose last residual of a step lands within 10% of
# tolres on either side in the two packages; tests/port/test_torch_deck.py)
FLUID_DECKS = {"decks/fluid_cavity_stationary.yaml": (3, 3, 12),
               "decks/fluid_poiseuille_ost.yaml": (3, 3, 134),
               "decks/fluid_smagorinsky_decay.yaml": (3, 3, 18),
               "decks/fluid_mfs_decay.yaml": (3, 3, 33),
               "decks/windkessel_channel.yaml": (2, 2, 144),
               "decks/ale_patch_motion.yaml": (3, 3, 0),
               "decks/scatra_supg_skewflow.yaml": (2, 2, 6),
               "decks/scatra_gaussian_diffusion.yaml": (2, 2, 48),
               "decks/scatra_anisotropic_diffusion.yaml": (1, 1, 30)}
CAVITY_N, CAVITY_DT = 64, 0.01  # phase 16 (b)
ALE_N, ALE_DT = 64, 0.2  # phase 16 (c)


def cavity3d_problem(n, device, dtype):
    """``cavity3d_ost``: the 3D lid-driven cavity at Re 100 on a box of
    n^3 hex8 cells, [u, v, w, p] per node: newtonianfluid (mu 0.01,
    rho 1); the lid zmax moves at (1, 0, 0), the other five faces hold no
    slip and come after the lid (its edges take the walls' zero, as the 2D
    deck orders them), the pressure is pinned at node 0; one-step-theta
    (theta 1, dt 0.01) with SUPG, PSPG and grad-div, GMRES(150) with the
    field's Jacobi (maxiter 4000, as fluid_cavity_stationary), Newton to a
    relative residual of 1e-5 or an increment at float32's rounding."""
    from fourc_tpu_torch.materials.fluid import NewtonianFluid
    from fourc_tpu_torch.physics import fluid as pf
    from fourc_tpu_torch.physics.newton import NewtonParams

    disc = gridgen.box(n, n, n, name="fluid")
    ns = disc.node_sets
    dbc = [conditions.DirichletBC(ns["zmax"], [1, 1, 1, 0], [1.0, 0, 0, 0])]
    dbc += [conditions.DirichletBC(ns[s], [1, 1, 1, 0], [0, 0, 0, 0])
            for s in ("zmin", "xmin", "xmax", "ymin", "ymax")]
    dbc.append(conditions.DirichletBC([0], [0, 0, 0, 1], [0, 0, 0, 0]))
    ndof = 4 * disc.n_nodes
    nw = NewtonParams(max_iter=12, tol_res=0.0, tol_res_rel=1e-5,
                      tol_disp=1e-6 * ndof ** 0.5, combine="or",
                      lin_method="gmres", gmres_restart=150,
                      lin_maxiter=4000, lin_rtol=1e-4)
    params = pf.FluidParams(dyntype="onesteptheta", theta=1.0, dt=CAVITY_DT,
                            newton=nw)
    return pf.FluidField(disc, {1: NewtonianFluid(viscosity=0.01,
                                                  density=1.0)},
                         params, dirichlet=dbc, device=device, dtype=dtype)


def discrete_divergence(f, x):
    """The Galerkin continuity residual int N_a div u dOmega at every node
    (the discrete divergence of the velocity), (n_nodes,)."""
    from fourc_tpu_torch.ops import fluid as fops
    from fourc_tpu_torch.ops.scalar import _test

    dm = f.disc.dofmap(1, lattice=False)
    per_block = {}
    for key, (G, wdet, N) in f.geometry.items():
        nen = f.cells[key].nen
        xe = f.dofmap.gather(x, key).reshape(nen, f.ndpn, -1)
        divu = fops._fields(G, N, xe[:, :f.dim], xe[:, f.dim])[2]
        per_block[key] = _test(N, wdet * divu)
    return dm.scatter_add(per_block)


@contextlib.contextmanager
def _gmres_calls(calls):
    """Every GMRES solve's (iterations, converged) appended to ``calls``
    while the block runs."""
    from fourc_tpu_torch.linalg import solvers

    gmres = solvers.SOLVERS["gmres"]

    def recorded(*args, **kwargs):
        res = gmres(*args, **kwargs)
        calls.append((res.iters, res.converged))
        return res

    solvers.SOLVERS["gmres"] = recorded
    try:
        yield
    finally:
        solvers.SOLVERS["gmres"] = gmres


def ale_box_problem(n, device, dtype):
    """``ale_box``: ale_patch_motion's ramp u_x = 0.1 t x on every face of
    a box of n^3 hex8 cells, ``laplace``: (AleField, the Dirichlet
    handler, the moving nodes)."""
    from fourc_tpu_torch.physics.ale import AleField
    from fourc_tpu_torch.physics.ale_driver import moving_nodes

    disc = gridgen.box(n, n, n, name="ale")
    fm = functions.FunctionManager()
    fm.add(1, "0.1*t*x")
    dbcs = [conditions.DirichletBC(disc.node_sets[s], [1, 1, 1], [1, 0, 0],
                                   [1, 0, 0])
            for s in ("xmin", "xmax", "ymin", "ymax", "zmin", "zmax")]
    handler, moving = moving_nodes(dbcs, disc, fm)
    return (AleField(disc, moving, (), "laplace", device=device,
                     dtype=dtype), handler, moving)


def phase_fluid(cavity_steps=2, ale_steps=2):
    """Phase 16: the fluid field and ALE mesh motion."""
    from fourc_tpu_torch.physics import fluid as pf

    _field_decks_on_the_card(FLUID_DECKS, "fluid")
    # (b) cavity3d_ost
    n = CAVITY_N
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    f = cavity3d_problem(n, "cuda", torch.float32)
    state = pf.init_state(f)
    step = pf.make_step(f, CAVITY_DT)
    torch.cuda.synchronize()
    log("cavity3d_ost", f"n={n}: {f.disc.n_nodes} nodes, {f.ndof} unknowns "
                        f"[u, v, w, p], field and initial state "
                        f"{time.perf_counter() - t0:.1f} s; nvidia-smi: "
                        f"{_smi()}")
    x0 = f.dbc.apply(state["x"], CAVITY_DT)
    r0, apply0 = f.linearize(x0, torch.zeros_like(x0), CAVITY_DT,
                             dt=CAVITY_DT)
    v0 = torch.randn_like(x0)
    jv0 = apply0(v0, pf.zero_pressure_rate(f, v0 * (1.0 / CAVITY_DT)))
    log("cavity3d_ost", f"first residual finite "
                        f"{bool(torch.isfinite(r0).all())}, first "
                        f"Jacobian action finite "
                        f"{bool(torch.isfinite(jv0).all())} (||J v|| "
                        f"{float(jv0.norm()):.4e})")
    if not (torch.isfinite(r0).all() and torch.isfinite(jv0).all()):
        raise RuntimeError("cavity3d_ost: non-finite first residual or "
                           "Jacobian action")
    del r0, apply0, jv0
    calls = []

    def after_cavity(st):
        x = st["x"]
        u, p = f.split(x)
        div = discrete_divergence(f, x)
        umax = float(u.abs().max())
        log("cavity3d_ost", f"GMRES solves (iterations, converged): {calls}")
        log("cavity3d_ost", f"largest |u| {umax:.6f}, L2 norm of the "
                            f"discrete divergence {float(div.norm()):.4e} "
                            f"(of int N |div u|: "
                            f"{float(div.abs().sum()):.4e}), pressure in "
                            f"[{float(p.min()):.4f}, {float(p.max()):.4f}]")
        if not (torch.isfinite(x).all() and 0.0 < umax < 1.5):
            raise RuntimeError(f"cavity3d_ost: max|u| {umax}")
        bad = [c for c in calls if c[0] >= f.params.newton.lin_maxiter]
        if bad:
            raise RuntimeError(f"cavity3d_ost: GMRES at maxiter {bad}")
        xdot, t = st["xdot"], st["t"]
        ms_res = _time(lambda: f.residual_transient(x, xdot, t, dt=CAVITY_DT),
                       reps=5)
        ms_lin = _time(lambda: f.linearize(x, xdot, t, dt=CAVITY_DT), reps=5)
        log("cavity3d_ost", "ms per call (device, CUDA events, float32): "
                            f"residual {ms_res:.3f}, linearization "
                            f"{ms_lin:.3f}")
        _, apply = f.linearize(x, xdot, t, dt=CAVITY_DT)
        v = torch.randn_like(x)
        dv = pf.zero_pressure_rate(f, v * (1.0 / CAVITY_DT))
        log("cavity3d_ost", "ms per call, Jacobian action "
            f"{_time(lambda: apply(v, dv), reps=10):.3f}")

    with _gmres_calls(calls):
        _fields_path("cavity3d_ost", f, state, step, cavity_steps, set(),
                     after_cavity)
    del f, state, step
    # (c) ale_box
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ale, handler, moving = ale_box_problem(ALE_N, "cuda", torch.float32)
    X = torch.as_tensor(ale.disc.coords, device=ale.device,
                        dtype=torch.float32)
    torch.cuda.synchronize()
    log("ale_box", f"n={ALE_N}: {ale.disc.n_nodes} nodes, "
                   f"{3 * ale.disc.n_nodes} unknowns, field "
                   f"{time.perf_counter() - t0:.1f} s")
    reset_launches()
    times = []
    for k in range(1 + ale_steps):
        t = ALE_DT * (k + 1)
        uD = torch.as_tensor(handler.values(t).reshape(-1, 3)[moving],
                             dtype=torch.float32, device=ale.device)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        d = ale.solve(uD, tol=1e-7, maxiter=3000)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
        want = 0.1 * t * X[:, 0]
        err = float(torch.maximum((d[:, 0] - want).abs().max(),
                                  d[:, 1:].abs().max()))
        scale = float(want.abs().max())
        log("ale_box", f"solve {k} (t={t:.1f}): CG {ale.last_iters} (the "
                       f"three components' solves together), "
                       f"{1e3 * times[-1]:.1f} ms; patch test: max error "
                       f"{err:.3e} of max|d| {scale:.4f} (rel "
                       f"{err / scale:.3e}, tol 1e-5)")
        if not err <= 1e-5 * scale:
            raise RuntimeError(f"ale_box: patch test missed by {err}")
    log("ale_box", f"{1e3 * sum(times[1:]) / ale_steps:.1f} ms per solve "
                   f"over {ale_steps} timed solves, peak memory "
                   f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    _check_launched("the ale_box path", None, launches(), set())


def _phase(name, fn, *args):
    """Run one phase, its name printed as it starts; a phase that raises is
    named with its exception, and the exception goes on (exit code 1)."""
    log("phase", f"{name}: start")
    t0 = time.perf_counter()
    try:
        out = fn(*args)
    except BaseException as exc:
        log("phase", f"{name}: FAILED after {time.perf_counter() - t0:.1f} "
                     f"s: {type(exc).__name__}: {exc}")
        raise
    log("phase", f"{name}: done in {time.perf_counter() - t0:.1f} s")
    return out


def main():
    smi_line = _phase("1 environment", phase_environment)
    _phase("2 build", phase_build)
    results = _phase("3 kernels", phase_kernels)
    _phase("4 correctness", phase_correctness)
    runs = {name: _phase(f"{5 + i} {name} path", phase_main_path, name)
            for i, name in enumerate(FULL_N)}
    counts = {name: run[0] for name, run in runs.items()}
    _phase("8 decks", phase_decks, runs["flagship"][1])
    _phase("9 element route", phase_elements)
    _phase("10 integrators", phase_integrators)
    _phase("11 element technologies", phase_techs)
    _phase("12 history, summands, springs, constraint", phase_history)
    _phase("13 plasticity laws", phase_plasticity)
    _phase("14 growth, mixture and muscle laws", phase_biology)
    _phase("15 thermo, TSI and MULF", phase_fields)
    _phase("16 fluid and ALE", phase_fluid)
    kernels = [{"name": name, "route": "cuda",
                "source": f"fourc_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": counts[path][k],
                **{f: results[k][f] for f in (
                    "max_abs_err", "ms", "loop_ms", "plain_ms", "bound_ms",
                    "bound_by", "library_ms")}}
               for k, (_, name, source, replaces, path) in KERNELS.items()]
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
