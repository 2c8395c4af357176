#!/usr/bin/env python3
"""GPU smoke check of the PyTorch port (``diffusion_model_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and ``nvidia-smi``; imports nothing of JAX.
Phases, each printed as one JSON line:

  1. toolchain: the card (``nvidia-smi``), CUDA, nvcc, and the build of the
     seven kernels from ``diffusion_model_tpu_torch/csrc/`` (both EGCL
     kernels, the four probes and the fused bias-SiLU; one nvcc each,
     started together), with the tensor-core instructions of each product
     library's SASS (``cuobjdump``): those six on warpgroup MMA (HGMMA /
     IGMMA) and none on HMMA / IMMA;
  2. the pair kernel (K1) against its plain version at flagship width
     (F1=1024, Fm=256) on the inputs the main path gives it (B x N = 80 x 16
     and 1 x 192), float32 variant and bfloat16 variant, padded rows inert,
     and timed, with the tile rows the kernel computed (held to its
     schedule, ``edge_tiles``), the live edges and the rate over them;
  2b. bias_silu (``ops/activations.py``, ``csrc/bias_silu.cu``: a bf16
     bias add and SiLU rounded op by op as the JAX package rounds them, F12
     in ``ROADMAP.md`` §3) against its op-by-op statement, bit for bit, at
     the node side's shapes (``FUSED_SHAPES``), timed beside the statement
     and torch's one-op ``F.silu`` (which rounds once), by CUDA events and
     by the card's own kernel time; under autograd one launch, the output
     and both gradients bit for bit the statement's; phase 4 counts its
     launches (one a layer a denoiser call in bf16), phase 27 its node in
     each served program's call, phase 32 its launches in bf16 training
     (the virtual-node channel's three a layer a step), and
     ``flagship_routes`` holds a denoiser call to at most
     ``PARENT_CALL_LAUNCHES`` + L runtime launches;
  3. the flagship denoiser on the card against the JAX goldens of
     ``tests/fixtures/torch_port/flagship.npz``;
  0b. data: the port's ``data.synthetic`` + ``data.split`` rebuild the
     flagship's 27 test conditions, bit for bit the fixture's ``cond_*``
     arrays, on this machine's numpy; phases 4, 4d and 9 sample them;
  4. generation through ``api.generate`` from ``artifacts/q_predef_r5.npz``
     on the 27 flagship test conditions, 5 samples each, 1000 steps, bf16,
     with the kernels' launch counts taken over exactly that run, scored by
     ``evals.restore_check.score`` (rdf_cos mean and median, CN2 angle R²)
     beside the JAX record and held to its gates (``QUALITY``);
 4b. the evaluators on the card against the CPU on phase 4's samples: RDF
     curves rtol 1e-5 / atol 1e-6 of their max, scores within 1e-6;
     evaluate_flagship: ``api.evaluate``'s numbers (sorted Kabsch RMSD, O
     density accuracy) on the same samples, card against CPU (RMSDs rtol
     1e-5, accuracy exact), beside the JAX record and held to the gates of
     ``evals.retrain_check.GATE``; predict_sizes: a seeded ``CNPredictor``
     on the card against the CPU, then one chunk generated through
     ``api.generate(size_predictor=...)``, every sample finite;
 4c. ``evals.restore_check`` on ``artifacts/q_learned_r5_s2025.npz``: the
     learned schedule's own gamma table, bf16, dense route, 27 x 5, 1000
     steps; 135 of 135 accepted, K1 10010 times and the plain route never,
     scores held to the learned record's gates (the angle R²'s is logged
     beside F4, ``LEARNED_R2_FAULT``, and not enforced);
 4d. one chunk through ``api.generate(return_trajectory=True)`` at 50 snr
     steps, a frame every 10: 5 frames, frame 0 the CoM-free pure noise, the
     final samples bit for bit those of the run without the trajectory;
  5. seconds per structure at the headline shape (192 atoms, B=1, 1000 and
     250 strided steps), kernel path and plain path on the same card;
  6. the kNN kernel (K2) against its plain version at flagship width
     (H=36), float32 and bfloat16, on the kNN route's inputs: 80 x 16 at
     K=15 (every layer), 2 x 512 and 1 x 2048 amorphous cells at K=32
     (layer 0); padded targets inert; timed, rows as in phase 2;
  7. K2 over ``knn_edges(., K=N-1)`` against K1 over the dense pair grid on
     the same layer inputs (80 x 16, every layer): the same edges;
  8. the flagship denoiser over ``knn_edges(., 6)`` against the JAX kNN
     goldens of the fixture file;
  9. generation as in phase 4 with ``neighbor_k=15``, scored and gated as
     phase 4: every EGCL through K2 and none through K1 (phases 4, 4c, 4d,
     5, 9 and 10 never leave their kernel: ``plain_edge_calls`` stays 0, and
     K1 and K2 launch 10010 times each in the served runs);
 10. the large cell, speed only: the 512-atom model class's flags
     (``neighbor_k=32``, ``virtual_node``, ``h_residual``) at full width on
     ``amorphous_cell(seed=0, num_atoms=2048)``, B=1, with the flagship's
     EGCL weights and seeded virtual-node weights: seconds per structure at
     1000 and 250 strided steps through K2, 250 through the plain version,
     and ms per denoiser call of both routes at 2 x 512;
 10b. the plain route: a model at ``configs/tiny.yaml``'s widths (dense)
     and a kNN model with an uncompressed spectrum (node width 204), whose
     widths no kernel takes (``nn.egnn.edge_route``), run a few denoiser
     calls on the card through the plain route in chunks, held against the
     same calls on the CPU (float32, rtol 2e-4 / atol 2e-5 of the output
     scale), with no kernel launched; and the kernels a flagship denoiser
     call launches, counted by ``torch.profiler`` on its first call (which
     casts the weights to bf16) and on the next (which finds them cast);
 11-14. the hardware probes ported from ``benchmarks/probe_*.py``, each
     held against its plain version at the TPU probe's shapes and then
     driven as its ``main()`` drives it (launches counted over that run
     only), with the cuBLAS yardstick where there is one: P2 the chained
     int8/bf16 products (``probes.matmul_rate``: cluster-wide chains on
     wgmma, with the cluster and slice each launch used, its time over the
     cuBLAS chain's and over the bound, and a link's phases), P4 tensor-core
     and SFU work at once on the same SMs (``probes.overlap``: P2's int8
     chain with a y warpgroup; its mxu mode bit for bit P2's block chain,
     its times beside that chain's and beside the SFU's time on the SMs the
     plan holds, the overlap fraction at M=512 and 4224), P3 SiLU(a @ w)
     with and without an overlapped epilogue (``probes.pipeline``: TMA-fed
     wgmma, cooperative and ping-pong, beside ``F.silu(a @ w)``), P1 the
     int8 EGCL edge tile in stages at N=192 (``probes.kernel_stages``:
     TMA-fed wgmma in clusters of two sharing W by multicast; every mode
     twice bit for bit, padded targets inert, each mode beside the product
     alone through ``torch._int_mm`` / ``q @ w``);
 15. train_grad: the edge functions' gradients on the card (K1 or K2
     forward, autograd of a plain statement backward, ``ops.edge_grad``:
     the float32 one in float32, the compute-dtype one in bfloat16, F11)
     against autograd of that statement whole, K1 at 64 x 16 and K2 at 64 x
     16 K=15 and 2 x 512 K=32 on the flagship's layer-0 inputs, float32
     (rtol 5e-3) and bfloat16 (relative L2 2e-2), forward, backward and
     plain forward timed;
 16. train_parity: one ``Trainer`` step on the card from the flagship's
     weights on 16 train graphs with the JAX draws of
     ``tests/fixtures/torch_port/train.npz``: loss, ``sum_sq``, per-leaf
     gradient and update norms against the JAX package's (float32 loss rtol
     1e-3, norms 5e-3; bfloat16 2e-2, 5e-2), K1 5 times a forward;
 17. train_flagship: ``api.train`` with the flagship's recipe from a fresh
     init on its 256 graphs, 2 epochs (and 1 epoch on the kNN-15 route):
     losses, ms a train step, peak memory, launches (5 a forward), wall s;
     the written npz generates one chunk through ``api.generate`` (one
     round, no NaN retries: a model 8 steps from its init);
 18. train_learned: the learned recipe's 6000-step gamma fit on the card
     from JAX's initial parameters, within 1e-3 of JAX's alpha table, then
     one epoch with the gamma boundary term (gamma gradients nonzero);
 19. checkpoint_resume: the flagship's recipe from a fresh init with
     ``checkpoint_every=1`` through ``api.train``: 4 epochs twice, and 2
     epochs then ``resume=True`` to 4, the resumed run held to the
     uninterrupted one bit for bit (or, on a card that is not
     deterministic, within the gap between the two uninterrupted runs);
     3 steps kept, K1 5 times a forward; the checkpoint's save and restore
     timed and its bytes; ``init_params_from`` and ``load_trained`` (A's
     chunk sampled in one round, no NaN retries); a checkpoint of the
     flagship's weights reloaded and sampled;
 20. heads: the x0 and v coordinate heads (``x_parameterization``), each:
     the flagship's weights read as that head, one bf16 denoiser call
     through K1 against the plain statement at t = 1, 10, 500, 1000 (raw
     output relative L2 1e-2; the converted output's gap beside alpha /
     sigma); the flagship's recipe with the head from a fresh init, 20
     epochs through K1 (finite, falling loss), then 27 x 5 sampled at 250
     strided and at 1000 steps through K1 (one round, scores logged, no
     gate; the eps recipe's epoch timed beside, 20 epochs); and the large
     cell's configuration (phase 10) with the head, and with eps beside it,
     from a fresh init: one train step (finite loss) and one 250-step
     sample through K2 (its finiteness recorded: no weights of that
     configuration are trained);
 21. strided_scores: both snapshots, bf16, K1, 27 x 5 at 250 uniform
     strided steps at the seeds of the JAX package's 250-step run
     (``tests/fixtures/torch_port/jax_strided_250.json``), each mean
     rdf_cos within 3 sqrt(2) x 0.0105 of JAX's mean from the same npz;
     the 1000-step scores at the same seeds beside them;
 22. variants: the h_residual + virtual_node + edge_rbf8 arm of
     ``docs/quality/size192net_lever_sweep.json`` and the same recipe with
     ``global_radius_feature`` in place of the RBF (``VARIANTS``: kNN-32,
     L=5, 1024 / 256, bf16; the flagship's EGCL weights and seeded non-zero
     arrays for what each adds, so speed and routes only), each: the
     denoiser on 2 x 192 kNN-32 cells and on 80 x 16 dense graphs (the rbf
     model's plain route on the card against the CPU; the radius model's
     K1 / K2 against their plain statements), 250 strided steps of one
     192-atom cell (s per structure; an rbf model's every EGCL through the
     plain statement and none through K1 / K2, a radius model's through
     K2), and three train steps at batch 32 of 160-192-atom network cells
     (``amorphous_network_cell``, the sweep's data; ms, the device's idle
     share from one more profiled step, peak memory);
 23. network_recipe: the large-cell recipe of
     ``examples/size_generalization.py`` as ``evals.size_gen_check``
     builds it (kNN-32, ``h_residual``, ``virtual_node``, ``h_init_scale``
     1e-3, L=5, 1024 / 256, bf16, lr 2e-4, clip 1) from a fresh init:
     three train steps at batch 32 of 448-512-atom network cells with
     ``remat_egcl`` off and on (ms, peak memory, K2 5 and 10 launches a
     step, the idle share of a profiled step; the first step's gradients
     equal bit for bit), the ``edge_rbf=8`` arm on the plain route with
     remat at batch 32 and without at batch 8, one 512-atom cell at 250
     uniform steps through K2 (1,255 launches), and ``compat_scalar_norm``
     on the flagship (80 x 16 dense, the card's plain route against the
     CPU at phase 10b's gate, then one bf16 train step);
 24. kabsch_finetune: the Kabsch coordinate loss from the flagship's
     weights (``Trainer.init_state(params=...)``, bf16, batch 64 of its
     train split, dense K1): one train step through the full 1000-step
     reverse chain under autograd (each denoiser call checkpointed: K1
     5 + 1001 x 5 x 2 = 10,015 times, the plain route never; loss and
     ``grad_norm`` finite; ms, peak memory), one step at 250 strided
     steps, one float32 125-step step at batch 1 on the card against the
     CPU from the same draws (loss and every gradient leaf), and the
     250-step step on kNN-15 through K2;
 25. polymorph_pipeline: the SiO2 polymorph corpus (46 samples) through
     the port's CASTEP and OptaDOS readers, ``build_dataset`` at 2NN and
     1NN with the native shell builder compiled here (g++) against the
     numpy route, the dataset files, the flagship generating 5 samples for
     each 2NN condition at 1000 steps through K1 (accepted of attempted,
     the Si-O bond median against the corpus's within 0.1 A), and
     ``template_match`` with the histogram descriptor on the card against
     the CPU (the same rankings; descriptors equal but at bin-edge ties);
 26. cli_drivers: the drivers through their CLIs at the flagship's width,
     from a run directory holding the snapshot's weights: ``main
     generate_only`` on 160 synthetic graphs (16 test conditions x 5,
     1000 steps, K1, one chunk), its ``generated.npz`` bit for bit
     ``api.generate`` called directly, every chain finite;
     ``evaluate_only`` and the evaluator CLIs with ``--device cuda``
     against ``--device cpu``; ``make_dataset`` and ``template_matching``
     on the polymorph corpus; ``train_only`` 2 epochs of the flagship's
     recipe on kNN-15 (K2), its ``profile.json`` counted as the JAX
     package's loop counts; ``generate_amorphous`` on two
     192-atom network cells with ``--panel`` (K1) and ``device_trace``
     around 3 reverse steps, the trace naming K1 and the annotated region
     (both without redraws: such chains leave the finite range); each
     driver's seconds and launches. Where matplotlib is missing, the
     drivers that draw are listed and their numbers held card against CPU
     through the functions they call.
 27. served_export: the flagship's run directory exported through
     ``cli.export.main --calibrate 2`` (dense, 250 strided deterministic
     steps, 16 conditions) and through ``serve.export_sampler`` on kNN-15,
     with 2 retry rounds and stochastic (a draw at every step): each
     artifact (three ``torch.export`` programs) loaded and called twice in
     a child process whose meta-path finder refuses the model code, the
     JAX package and JAX; each call bit for bit the live ``sample`` at the
     same seed, 1,255 launches of K1 (or K2) a call counted by the op
     modules there, the retry export equal to the retry-free one on the
     rows it accepts, a step of each program no more device kernels than
     the live sampler's (``torch.profiler``); ms a call beside the live
     call's, the artifacts' bytes, the exports' seconds;
 28. distill: ``api.distill`` from the flagship's weights, one halving
     1000 -> 500, 2 epochs at batch 64 (K1 15 times a step; ms a step,
     the median after the first; losses finite), the student sampled at 500 deterministic steps on 16
     conditions (finite count read), and one float32 ``distill_loss`` at
     batch 2 on the card against the CPU (loss rel 1e-3, leaves 2e-2);
 29. spectrum_latent: ``pretrain_autoencoder`` (500 steps, latent 32) on
     the flagship data's 200-wide spectra, ``encode_dataset`` card against
     CPU, a fresh latent-conditioned model at the flagship's widths trained
     2 epochs on K1 and sampled on 16 conditions at 250 strided steps with
     no redraw (finite count read, not gated);
 30. data_parallel, in an NCCL world of one in this process
     (``parallel.init_single``): ``api.train`` on the flagship's recipe
     with ``mesh_shape=(1,)`` for 2 epochs against the same run without a
     mesh, ``metrics.jsonl`` and the final state bit for bit (within the
     card's own spread where a second run without a mesh differs), K1 50
     times as in phase 17, ms an epoch beside phase 17's;
 31. ring, in the same world: the flagship's weights on a 256-atom
     ``amorphous_cell``, dense topology, one graph: ``ring_denoise_fn``
     against the dense denoiser (K1) in float32 (rtol 2e-4 / atol 2e-5 of
     the output's scale; bf16 read), ``api.generate_ring`` at 250 strided
     steps beside ``api.generate`` on the same cell (ms a denoiser call, s
     a structure), and one ``ring_train_step_fn`` step against the dense
     step from the same state and draws in float32 (loss rtol 1e-4, leaves
     rtol 2e-3 / atol 2e-6; peak memory). The ring's edge work is the plain
     PyTorch statement, as the JAX package's ring is plain ``jnp``: it
     launches no kernel, and ``parallel.ring.ring_edge_calls`` counts it
     apart from ``plain_edge_calls``;
 32. f9_replay: the first ``F9_STEPS`` steps of F9's full-width training
     replay (``tests/torch_replay_training_full.py``: the large-cell
     recipe at 12.5 M parameters on 160-192-atom network cells, kNN-32,
     batch 4, from the numpy start on the recorded batches and draws) in
     float32 and bfloat16 through K2 (the bfloat16 backward through the
     compute-dtype statement since F11's repair; ``bias_silu`` three
     times a layer a bf16 step), held to JAX's tracks
     (``tests/fixtures/torch_port/train_replay_full_hres_vn.*``): at step
     1 the one-step tolerances (loss rtol 1e-5, gradient norm 5e-3 in
     float32, 5e-2 in bfloat16), at step 10 F9's rule (``verdict``: the
     float32 drift bound, and the bfloat16 gap within 1.5x JAX's own
     bfloat16-to-float32 gap); K2 5 launches a step (the forward's; the
     repaired backward launches none), the plain route never.

Any failed check raises, and the script exits non-zero without its result
line. Before the last lines, a ``timeline`` record gives the seconds from
the start at which each phase logged its last record. The last lines are
the kernel table (with each kernel's bound: its
operations at the published dense peak, or its bytes at 3.35 TB/s, the
larger), the card's name and power limit, and ``{"ok": true, "device":
{...}}``.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FIXTURE = ROOT / "tests" / "fixtures" / "torch_port" / "flagship.npz"
SNAPSHOT = ROOT / "artifacts" / "q_predef_r5.npz"
LEARNED = ROOT / "artifacts" / "q_learned_r5_s2025.npz"
GEN_PER_CONDITION = 5
GEN_BATCH = 16         # conditions per chunk: 16 x 5 = 80 graphs of 16 nodes
SI_O_TOLERANCE = 0.1   # A, generated against conditioning median Si-O
SERVED_K = 15          # kNN route of the served shape: K = N-1, all pairs
GOLDEN_K = 6           # neighbours of the fixture's kNN goldens
LARGE_K = 32           # the 512-atom model class's neighbor_k
LARGE_ATOMS = 2048
MID_ATOMS = 512
SERVED_LAUNCHES = 10010   # 2 chunks x 1001 denoiser calls x 5 layers
# runtime launches of a flagship bf16 denoiser call after its first, before
# F12's repair (phase flagship_routes, PR 20-21)
PARENT_CALL_LAUNCHES = 103
PLAIN_ROUTE_T = (0.2, 0.5, 0.9)   # t/T of the plain-route phase's calls
# bias_silu's shapes, [rows, F]: the flagship's node MLP on the served 80 x
# 16 chunk (the timed one), the F9 arm's (4 x 192 nodes) node MLP and
# virtual-node pooling, and an odd width (the one-element path)
FUSED_SHAPES = ((80 * 16, 1024), (4 * 192, 1024), (4, 256), (111, 1001))
NUM_GRAPHS = 256       # dataset size both snapshots were trained on
SHELLS = 2
# The JAX package's scores of the two snapshots (rdf_cos mean, median, CN2
# angle R^2; docs/quality/predef_r5_summary.json, learned_r5_summary.json)
# and the gates the port's scores are held to: 3 sqrt(2) sigma around the
# record, sigma the recorded spread of the mean / median over sampling seeds
# (docs/quality/seed_variance.json; the port's run and the record are two
# independent draws), and a floor of record - 0.05 on the R^2, which has no
# recorded spread.
QUALITY = {
    "q_predef_r5": {
        "record": {"rdf_cos_mean": 0.8962191085880955,
                   "rdf_cos_median": 0.9317090191130563,
                   "cn2_angle_r2": 0.9766619012625823},
        "gate": {"rdf_cos_mean": 0.045, "rdf_cos_median": 0.027,
                 "cn2_angle_r2_min": 0.927}},
    "q_learned_r5_s2025": {
        "record": {"rdf_cos_mean": 0.7842053112561355,
                   "rdf_cos_median": 0.866554920102145,
                   "cn2_angle_r2": 0.9624684292118079},
        "gate": {"rdf_cos_mean": 0.059, "rdf_cos_median": 0.032,
                 "cn2_angle_r2_min": 0.912}},
}
# The learned snapshot's angle R^2 falls below its gate on the card (0.589
# at the config's seed): F4 of ROADMAP.md section 3, closed as no fault of
# the port. The R^2 stands on 4-5 CN2 conditions and spreads over sampling
# draws in both packages; from the JAX package's draws the port's chains
# end on JAX's structures (tests/fixtures/torch_port/
# replay_q_learned_r5_s2025_2025.json). Logged, not enforced.
LEARNED_R2_FAULT = "F4 (ROADMAP.md section 3), closed: no fault of the port"
# The flagship's atom_type_accuracy reads above the JAX record by more than
# its gate on the card (0.9926 against 0.9704, gate 0.0162 at seed 2024):
# F7 of ROADMAP.md section 3, closed as no fault of the port. From the JAX
# package's draws the port's chains, on the CPU and on the card, end on
# JAX's species (tests/fixtures/torch_port/replay_q_predef_r5_2024.json).
# Logged, not enforced.
EVALUATE_FAULT = {"atom_type_accuracy":
                  "F7 (ROADMAP.md section 3), closed: no fault of the port"}
TRAJECTORY_STEPS = 50
TRAJECTORY_EVERY = 10
TRAIN_FIXTURE = ROOT / "tests" / "fixtures" / "torch_port" / "train.npz"
TRAIN_RUN = ROOT / "build" / "chip_smoke_train"
TRAIN_B = 64           # the flagship recipe's batch
TRAIN_EPOCHS = 2       # of api.train at the flagship recipe
TRAIN_STEP_REPS = 5    # timed train steps after the first
# the card's Function gradients against autograd of its backward's statement
GRAD_F32_RTOL = 5e-3
GRAD_BF16_REL_L2 = 2e-2
# the training step against the JAX fixture: (loss rtol, norm rtol)
TRAIN_TOL = {"float32": (1e-3, 5e-3), "bfloat16": (2e-2, 5e-2)}
GAMMA_FIT_ATOL = 1e-3
RESUME_EPOCHS = 4      # of the checkpoint_resume phase's runs
# a resumed run on a card that is not deterministic is held to this many
# times the gap between two uninterrupted runs, leaf for leaf
RESUME_SPREAD = 3.0
HEAD_MODES = ("x0", "v")
HEAD_T = (1, 10, 500, 1000)   # timesteps of the heads' K1-vs-plain call
HEAD_EPOCHS = 20       # of the flagship's recipe with each head
HEAD_BASELINE_EPOCHS = 20   # of the eps recipe, timed beside the heads
STRIDED_FIXTURE = ROOT / "tests" / "fixtures" / "torch_port" / \
    "jax_strided_250.json"
# a 250-step mean rdf_cos is held to 3 sqrt(2) sigma around the JAX
# package's 250-step mean from the same npz, sigma the recorded spread of
# the mean over sampling seeds (docs/quality/seed_variance.json)
STRIDED_SIGMA = 0.0105
STRIDED_GATE = 3 * 2 ** 0.5 * STRIDED_SIGMA
# the variants phase: the h_residual + virtual_node + edge_rbf8 arm of
# docs/quality/size192net_lever_sweep.json (examples/size_generalization.py
# --edge_rbf 8, lr 2e-4, clip 1), and the same recipe with --global_radius
VARIANTS = {"rbf": dict(edge_rbf=8, edge_rbf_rmax=8.0),
            "radius": dict(global_radius_feature=True)}
VARIANT_ATOMS = 192
VARIANT_TRAIN_ATOMS = (160, 192)   # the sweep's train cells
VARIANT_TRAIN_B = 32
VARIANT_TRAIN_STEPS = 3
VARIANT_STEPS = 250
NETWORK_ATOMS = (448, 512)    # the 512-atom recipe's train cells
NETWORK_B = 32
NETWORK_STEPS = 3             # timed train steps of each arm
RBF_BATCH = {True: 32, False: 8}   # the rbf arm's batch, with / without remat
KABSCH_B = 64              # the flagship recipe's batch
# strided steps of the shorter Kabsch chains: one chain that leaves the
# finite range makes the loss NaN. Replayed from this phase's own batch and
# draws (tests/kabsch_chain_replay.py), 31 of 64 chains leave it at 50
# uniform steps and 1 of 64 at 100 (draw 2 of 3), in float32 on the CPU as
# in bf16 on the card; the JAX package's chains do so too at 50 and 100
# (tests/jax_finite_chains.py). At 250 all stay finite.
KABSCH_SHORT = 250
KABSCH_SHORT_STEPS = 1     # steps of KABSCH_SHORT strided steps
KABSCH_F32_B = 1           # graphs of the float32 card-against-CPU step
# strided steps of that step (its chain stays finite at 125 on this phase's
# graph and draws); the CPU's side of a 250-step step took ~1 min on the
# card's slower hosts
KABSCH_F32_STEPS = 125
KABSCH_F32_LOSS_RTOL = 1e-3
# the largest worst-leaf relative L2 seen was 6.2e-4 (batch 4)
KABSCH_F32_GRAD_REL = 2e-2
CLI_RUN = ROOT / "build" / "chip_smoke_cli"
CLI_SYNTHETIC = 160        # graphs of the driver phase: a test split of 16
CLI_TRAIN_EPOCHS = 2
CLI_AMORPHOUS = ["--amorphous", "2", "--generator", "network",
                 "--num_atoms", "192", "--gen_num_per_spectrum", "2",
                 "--panel"]
CLI_TRACE_STEPS = 3        # strided reverse steps under device_trace
PARAMETERS_JSON = ROOT / "tests" / "fixtures" / "torch_port" / \
    "parameters.json"
SERVE_RUN = ROOT / "build" / "chip_smoke_serve"
SERVE_B = 16               # conditions of a served call
SERVE_STEPS = 250          # strided deterministic steps of the exports
SERVE_SEED = 7
DISTILL_STEPS = 500        # the student's steps: one halving of 1000
DISTILL_EPOCHS = 2
DISTILL_LR = 5e-5          # examples/distill_eval.py's
DISTILL_F32_B = 2          # graphs of the float32 card-against-CPU loss
DISTILL_F32_RTOL = 1e-3
LATENT_DIM = 32
LATENT_AE_STEPS = 500      # nn/spectrum_latent.py's default
LATENT_ENCODE_REL = 1e-5   # float32 encoder, card against CPU
LATENT_EPOCHS = 2
LATENT_STEPS = 250
RING_ATOMS = 256           # the ring phase's cell (amorphous_cell, seed 0)
RING_STEPS = 250           # strided steps of its generation
RING_REPS = 3              # timed forwards of each route
RING_NOISE_SEED = 11       # TrainNoise of its train steps
# the ring phase scales the flagship's coordinate head (mlp_x_dense2) by
# this: unscaled, a model trained on <= 16-atom environments moves a
# 256-atom cell's coordinates out of the finite range in 5 layers (|eps_x|
# 4.9e26 on the card; on the CPU in float32 4.9e26 at 1, 5.2e10 at 0.1, 47.8
# at 0.01, 2.6 at 1e-3), and a comparison of infinities holds nothing
RING_X_SCALE = 1e-3
# phase f9_replay: steps of each track of F9's full-width replay it runs
# (the rule is read at the record after step 10)
F9_STEPS = 10


# seconds from the script's start at which each phase's last record was
# logged (the "timeline" record): where an earlier phase's depth is cut
LOGGED_AT = {}
T_START = time.perf_counter()


def log(record: dict) -> None:
    if "phase" in record:
        LOGGED_AT[record["phase"]] = round(time.perf_counter() - T_START, 1)
    print(json.dumps(record), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def device_ms(fn, reps: int) -> dict:
    """The card's own milliseconds a call of ``fn()`` over ``reps`` calls
    under ``torch.profiler`` (one untimed call first): the sum of its
    kernels' device spans a call, whatever paces the host, and the
    kernels a call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    spans = [e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == cuda
             and not e.name.startswith(("Memcpy", "Memset"))]
    return {"device_ms": 1e-3 * sum(spans) / reps,
            "kernels_a_call": len(spans) / reps}


def rel_l2(a, b) -> float:
    return float((a - b).float().norm() / b.float().norm())


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` on the card over ``reps`` calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def sass_counts(source: str) -> dict:
    """Tensor-core instructions per kernel of the library built from
    ``csrc/<source>``, from ``cuobjdump -sass``: function -> counts of
    HGMMA, IGMMA (warpgroup MMA, bf16 / int8), HMMA and IMMA (warp MMA)."""
    from diffusion_model_tpu_torch.ops import _build

    tool = Path(_build.find_nvcc()).parent / "cuobjdump"
    out = subprocess.run([str(tool), "-sass", str(_build.library_path(source))],
                         capture_output=True, text=True, check=True,
                         timeout=300).stdout
    counts, function = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            function = line.split("Function :")[1].strip()
            counts[function] = dict.fromkeys(("HGMMA", "IGMMA", "HMMA",
                                              "IMMA"), 0)
        elif function is not None:
            for tag in re.findall(r"\b(HGMMA|IGMMA|HMMA|IMMA)\b", line):
                counts[function][tag] += 1
    return {f: c for f, c in counts.items() if any(c.values())}


def check_sass(sources) -> dict:
    """Every tensor-core kernel of these libraries on warpgroup MMA and
    none on warp MMA; returns the counts."""
    report = {}
    for source in sources:
        counts = sass_counts(source)
        warpgroup = sum(c["HGMMA"] + c["IGMMA"] for c in counts.values())
        warp = sum(c["HMMA"] + c["IMMA"] for c in counts.values())
        if warpgroup == 0 or warp != 0:
            raise AssertionError(f"{source}: SASS has {warpgroup} HGMMA/IGMMA "
                                 f"and {warp} HMMA/IMMA: {counts}")
        report[source] = counts
    return report


def load_fixture(device):
    import numpy as np
    import torch

    with np.load(FIXTURE) as z:
        fx = {k: z[k] for k in z.files}
    tensors = {k: torch.from_numpy(v).to(device) for k, v in fx.items()
               if v.dtype == np.float32}
    cell = {k: fx[f"cell_{k}"] for k in ("pos", "species", "spectrum", "exo")}
    cell["id"] = "amorphous_0"
    return tensors, cell


def kernel_table():
    """name -> (kernel, plain version, index of x among the arguments,
    padded-target rows of the arguments)."""
    from diffusion_model_tpu_torch.ops.egcl_knn import (
        egcl_knn_edges,
        egcl_knn_edges_reference,
    )
    from diffusion_model_tpu_torch.ops.egcl_pair import (
        egcl_pair_edges,
        egcl_pair_edges_reference,
    )

    return {
        "egcl_pair": (egcl_pair_edges, egcl_pair_edges_reference, 4,
                      lambda a: a[5][..., 0] == 0),
        "egcl_knn": (egcl_knn_edges, egcl_knn_edges_reference, 3,
                     lambda a: a[5].sum(dim=-1) == 0),
    }


def recording_model(model_cfg, params, device):
    """(denoiser, calls): the denoiser's edge functions run the plain
    versions and append their arguments to ``calls[kernel name]``."""
    from diffusion_model_tpu_torch.api import denoiser_from_params

    table = kernel_table()
    calls = {name: [] for name in table}

    def recorder(name):
        def record(*args):
            calls[name].append(tuple(a.clone() for a in args))
            return table[name][1](*args)
        return record

    model = denoiser_from_params(model_cfg, params, device,
                                 edge_fn=recorder("egcl_pair"),
                                 knn_edge_fn=recorder("egcl_knn"))
    return model, calls


def capture_edge_inputs(model_cfg, params, device, species_t, pos_t,
                        spectrum, exo, t_norm, mask, k: int = 0):
    """The arguments the denoiser hands its edge function, layer by layer:
    over the dense pair grid, or over ``knn_edges(pos_t, mask, k)``."""
    from diffusion_model_tpu_torch.ops.edges import knn_edges

    model, calls = recording_model(model_cfg, params, device)
    edges = knn_edges(pos_t, mask, k) if k else None
    model(species_t, pos_t, spectrum, exo, t_norm, mask, edges)
    return calls["egcl_knn" if k else "egcl_pair"]


def check_kernel(name: str, args, dtype_name: str) -> dict:
    """A kernel against its plain version on one set of edge inputs."""
    import torch

    kernel, plain, xi, padded = kernel_table()[name]
    got_m, got_x = kernel(*args)
    want_m, want_x = plain(*args)
    torch.cuda.synchronize()
    err = max(float((got_m - want_m).abs().max()),
              float((got_x - want_x).abs().max()))
    rec = {"kernel": name, "dtype": dtype_name,
           "shape": list(args[0].shape[:2]), "max_abs_err": err}
    if name == "egcl_knn":
        rec["k"] = int(args[4].shape[-1])
    if dtype_name == "float32":
        for got, want, what in ((got_m, want_m, "m_sum"),
                                (got_x, want_x, "x_out")):
            torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-5,
                                       msg=lambda m: f"{name} {what}: {m}")
        rec["tolerance"] = "rtol 2e-4 / atol 2e-5"
    else:
        rec["rel_l2_m_sum"] = rel_l2(got_m, want_m)
        rec["rel_l2_x_update"] = rel_l2(got_x - args[xi], want_x - args[xi])
        if not max(rec["rel_l2_m_sum"], rec["rel_l2_x_update"]) <= 1e-2:
            raise AssertionError(f"bf16 kernel off the plain version: {rec}")
        rec["tolerance"] = "relative L2 1e-2"
    # padded targets: no message, coordinates unchanged, exactly
    pad = padded(args)
    if bool((got_m[pad] != 0).any()) or bool(
            (got_x[pad] != args[xi][pad]).any()):
        raise AssertionError(f"padded rows of {name}'s output are not inert")
    rec["padded_rows_checked"] = int(pad.sum())
    return rec


def served_inputs(fx):
    """The generation chunk (16 conditions x 5 copies, 80 x 16) noised at
    t/T = 0.5 (the fixture's middle input)."""
    k = 1
    tile = lambda a: a[:GEN_BATCH].repeat_interleave(GEN_PER_CONDITION, 0)
    return (tile(fx["in_species_t"][k]), tile(fx["in_pos_t"][k]),
            tile(fx["cond_spectrum"]), tile(fx["cond_exo"]),
            tile(fx["in_t_norm"][k]), tile(fx["cond_mask"]))


def cell_inputs(cells, device, seed=0):
    """A batch of cells noised as 0.7 * a + 0.7 * N(0, 1), at t/T = 0.5."""
    import torch

    from diffusion_model_tpu_torch.data.batch import collate

    n = max(len(c["pos"]) for c in cells)
    batch = collate(cells, n, device)
    g = torch.Generator(device=device).manual_seed(seed)
    noisy = lambda a: (0.7 * a + 0.7 * torch.randn(
        a.shape, generator=g, device=device))
    return (noisy(batch.species), noisy(batch.pos), batch.spectrum,
            batch.exo, torch.full((len(cells), n, 1), 0.5, device=device),
            batch.mask)


def time_kernel(name: str, args) -> dict:
    kernel, plain = kernel_table()[name][:2]
    return {"kernel_ms": cuda_ms(lambda: kernel(*args), 20),
            "plain_ms": cuda_ms(lambda: plain(*args), 5)}


def row_count(name: str, args) -> dict:
    """Tile rows the kernel computed on these inputs, against the rows its
    schedule (``edge_tiles``) says the bf16 kernel computes."""
    import torch

    from diffusion_model_tpu_torch.ops import egcl_knn, egcl_pair

    kernel_table()[name][0](*args)
    torch.cuda.synchronize()
    if name == "egcl_pair":
        got, sched = int(egcl_pair.last_rows), egcl_pair.edge_tiles(args[5])
    else:
        got = int(egcl_knn.last_rows)
        sched = egcl_knn.edge_tiles(args[4], args[5])
    if args[0].dtype == torch.bfloat16 and got != sched.rows:
        raise AssertionError(f"{name} computed {got} tile rows, its schedule "
                             f"says {sched.rows}")
    return {"rows_computed": got, "rows_per_live_edge":
            got / max(sched.live_edges, 1)}


def host_us(fn, reps: int = 50) -> float:
    """Host microseconds to enqueue one ``fn()`` (checks, tensor maps and
    the launch), with the card busy behind it."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    took = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * took / reps


def timed(name: str, args, bound: dict) -> dict:
    """Kernel and plain times, the bound, the row count, the rate over the
    live edges and the host time of a launch."""
    kernel = kernel_table()[name][0]
    rec = time_kernel(name, args) | bound | row_count(name, args)
    rec["live_tflops"] = rec["flops"] / (rec["kernel_ms"] * 1e9)
    rec["host_us_per_launch"] = host_us(lambda: kernel(*args))
    return rec


def phase_kernels(cfg, params, fx, cell, device) -> dict:
    # 80 x 16: every layer's inputs; 1 x 192: the headline cell, first layer
    # only: the flagship was trained on graphs of at most 16 atoms, and over
    # 192 atoms its coordinates grow to ~1e9 by the last layer, where no
    # comparison means anything
    small = served_inputs(fx)
    big = cell_inputs([cell], device)
    checks, timings = [], {}
    for dtype_name in ("float32", "bfloat16"):
        dcfg = cfg.replace(compute_dtype=dtype_name)
        for name, inputs, layers in (("80x16", small, range(cfg.L)),
                                     ("1x192", big, [0])):
            calls = capture_edge_inputs(dcfg, params, device, *inputs)
            for layer in layers:
                rec = check_kernel("egcl_pair", calls[layer], dtype_name)
                rec["layer"] = layer
                checks.append(rec)
            timings[f"{name}_{dtype_name}"] = timed(
                "egcl_pair", calls[0], pair_bound(calls[0]))
    main = timings["80x16_bfloat16"]
    main_err = max(r["max_abs_err"] for r in checks
                   if r["dtype"] == "bfloat16" and r["shape"] == [80, 16])
    log({"phase": "kernel_vs_plain", "checks": checks, "timings": timings})
    return {"max_abs_err": main_err, "ms": main["kernel_ms"],
            "plain_ms": main["plain_ms"], "library_ms": None,
            **{k: main[k] for k in ("bound_ms", "bound_by", "bound_kind",
                                    "live_edges", "rows_computed",
                                    "live_tflops")}}


def phase_bias_silu(device) -> dict:
    """The fused bias-SiLU kernel (``ops/activations.py``) against its
    op-by-op statement on the card, bit for bit, at ``FUSED_SHAPES`` (a
    normal draw, and a row swept over [-120, 120] where exp overflows);
    timed at the first shape beside the statement, torch's one-op
    ``F.silu`` of the sum (which rounds once: not the port's rounding) and
    the form before F12, ``F.silu(v + b)``, each by CUDA events over calls
    back to back (host-paced: the op's dispatch) and by the card's own
    kernel time (``device_ms``); the bound is bytes. Under autograd, at
    the arm's node shape: one launch for the forward, and the output and
    both gradients bit for bit the statement's."""
    import torch
    import torch.nn.functional as F

    from diffusion_model_tpu_torch.ops import activations
    from diffusion_model_tpu_torch.probes._common import bound, nbytes

    g = torch.Generator(device=device).manual_seed(22)
    checks, timing = [], {}
    with torch.no_grad():
        for rows, f in FUSED_SHAPES:
            v = (3 * torch.randn(rows, f, generator=g, device=device)).to(
                torch.bfloat16)
            v[0] = torch.linspace(-120, 120, f, device=device)
            b = torch.randn(f, generator=g, device=device).to(torch.bfloat16)
            got = activations.bias_silu_op(v, b)
            want = activations.bias_silu_reference(v, b)
            torch.cuda.synchronize()
            differ = int((got.view(torch.int16)
                          != want.view(torch.int16)).sum())
            checks.append({"shape": [rows, f], "bits_differing": differ,
                           "max_abs_err": float((got.float() - want.float())
                                                .abs().max())})
            if differ:
                raise AssertionError(f"bias_silu is not its statement bit "
                                     f"for bit: {checks[-1]}")
            if not timing:
                t = v + b
                dev = {name: device_ms(fn, 50) for name, fn in (
                    ("kernel", lambda: activations.bias_silu_op(v, b)),
                    ("statement",
                     lambda: activations.bias_silu_reference(v, b)),
                    ("f_silu", lambda: F.silu(t)))}
                timing = {
                    "shape": [rows, f],
                    "ms": cuda_ms(lambda: activations.bias_silu_op(v, b),
                                  50),
                    "plain_ms": cuda_ms(
                        lambda: activations.bias_silu_reference(v, b), 50),
                    "library_ms": cuda_ms(lambda: F.silu(t), 50),
                    "library_call": "F.silu(t) of t = v + b added before: "
                                    "one op that rounds once, not JAX's "
                                    "rounding",
                    "f_silu_of_sum_ms": cuda_ms(lambda: F.silu(v + b), 50),
                    "device_ms": dev["kernel"]["device_ms"],
                    "plain_device_ms": dev["statement"]["device_ms"],
                    "library_device_ms": dev["f_silu"]["device_ms"],
                    "device": dev,
                    **bound(nbytes(v, b, got))}
    rows, f = FUSED_SHAPES[1]
    v, b, cot = ((3 * torch.randn(n, generator=g, device=device)).to(
        torch.bfloat16) for n in ((rows, f), (f,), (rows, f)))
    outs = []
    for fn in (activations.bias_silu, activations.bias_silu_reference):
        vv, bb = v.clone().requires_grad_(), b.clone().requires_grad_()
        before = activations.bias_silu_launches
        y = fn(vv, bb)
        outs.append((y, *torch.autograd.grad(y, (vv, bb), cot),
                     activations.bias_silu_launches - before))
    torch.cuda.synchronize()
    grad = {"shape": [rows, f], "launches": [o[-1] for o in outs],
            "bits_differing": [int((a.view(torch.int16)
                                    != w.view(torch.int16)).sum())
                               for a, w in zip(outs[0][:3], outs[1][:3])]}
    if grad["launches"] != [1, 0] or any(grad["bits_differing"]):
        raise AssertionError(f"bias_silu under autograd: {grad} (want one "
                             f"launch, y, dv and db bit for bit)")
    rec = {"phase": "bias_silu_vs_statement", "checks": checks, **timing,
           "under_autograd": grad, "tolerance": "bit for bit"}
    log(rec)
    return {"max_abs_err": max(c["max_abs_err"] for c in checks),
            **{k: timing[k] for k in ("ms", "plain_ms", "library_ms",
                                      "library_call", "f_silu_of_sum_ms",
                                      "device_ms", "plain_device_ms",
                                      "library_device_ms", "bound_ms",
                                      "bound_by", "bound_kind", "shape")}}


def phase_knn_kernel(cfg, params, fx, device) -> dict:
    from diffusion_model_tpu_torch.data.synthetic import amorphous_cell

    # 80 x 16 at K = N-1: the kNN route's inputs, every layer; 2 x 512 and
    # 1 x 2048 amorphous cells at the 512-atom class's K=32, layer 0 (the
    # flagship never saw such cells; see phase_kernels)
    mids = [amorphous_cell(seed=s, num_atoms=MID_ATOMS) for s in (0, 1)]
    shapes = (
        ("80x16_k15", served_inputs(fx), SERVED_K, range(cfg.L)),
        ("2x512_k32", cell_inputs(mids, device), LARGE_K, [0]),
        ("1x2048_k32", cell_inputs(
            [amorphous_cell(seed=0, num_atoms=LARGE_ATOMS)], device),
         LARGE_K, [0]),
    )
    checks, timings = [], {}
    for dtype_name in ("float32", "bfloat16"):
        for name, inputs, k, layers in shapes:
            calls = capture_edge_inputs(cfg.replace(compute_dtype=dtype_name),
                                        params, device, *inputs, k=k)
            for layer in layers:
                rec = check_kernel("egcl_knn", calls[layer], dtype_name)
                rec["layer"] = layer
                checks.append(rec)
            timings[f"{name}_{dtype_name}"] = timed(
                "egcl_knn", calls[0], knn_bound(calls[0]))
    main = timings["80x16_k15_bfloat16"]
    main_err = max(r["max_abs_err"] for r in checks
                   if r["dtype"] == "bfloat16" and r["shape"] == [80, 16])
    log({"phase": "knn_kernel_vs_plain", "checks": checks,
         "timings": timings})
    return {"max_abs_err": main_err, "ms": main["kernel_ms"],
            "plain_ms": main["plain_ms"], "library_ms": None,
            **{k: main[k] for k in ("bound_ms", "bound_by", "bound_kind",
                                    "live_edges", "rows_computed",
                                    "live_tflops")}}


def phase_knn_is_dense(cfg, params, fx, device) -> None:
    """K2 over K = N-1 lists and K1 over the pair grid, on the arguments
    each route builds from the same layer input of a dense-route run."""
    import torch

    from diffusion_model_tpu_torch.ops.edges import knn_edges

    table = kernel_table()
    rec = {"phase": "knn_k_n_minus_1_vs_pair"}
    for dtype_name in ("float32", "bfloat16"):
        model, calls = recording_model(cfg.replace(compute_dtype=dtype_name),
                                       params, device)
        layer_inputs = []
        hooks = [getattr(model.egnn, f"egcl_{l}").register_forward_pre_hook(
            lambda mod, args: layer_inputs.append((mod, args[:3])))
            for l in range(cfg.L)]
        model(*served_inputs(fx))
        for hook in hooks:
            hook.remove()
        for mod, (h, x, mask) in layer_inputs:
            mod(h, x, mask, knn_edges(x, mask, SERVED_K))
        worst = 0.0
        for layer, (pair_args, knn_args) in enumerate(
                zip(calls["egcl_pair"], calls["egcl_knn"], strict=True)):
            want_m, want_x = table["egcl_pair"][0](*pair_args)
            got_m, got_x = table["egcl_knn"][0](*knn_args)
            torch.cuda.synchronize()
            if dtype_name == "float32":
                torch.testing.assert_close(got_m, want_m, rtol=2e-4,
                                           atol=2e-5)
                torch.testing.assert_close(got_x, want_x, rtol=2e-4,
                                           atol=2e-5)
                err = max(float((got_m - want_m).abs().max()),
                          float((got_x - want_x).abs().max()))
            else:
                x = pair_args[4]
                err = max(rel_l2(got_m, want_m),
                          rel_l2(got_x - x, want_x - x))
                if not err <= 1e-2:
                    raise AssertionError(
                        f"K2 at K=N-1 off K1 at layer {layer}: {err}")
            worst = max(worst, err)
        rec[dtype_name] = {
            "layers": cfg.L, "worst": worst,
            "measure": ("max abs err (rtol 2e-4 / atol 2e-5 held)"
                        if dtype_name == "float32"
                        else "relative L2 (limit 1e-2)")}
    log(rec)


def phase_denoiser(cfg, params, fx, device, k: int = 0) -> None:
    from diffusion_model_tpu_torch.api import denoiser_from_params
    from diffusion_model_tpu_torch.ops.edges import knn_edges

    prefix = f"knn{k}_" if k else ""
    rec = {"phase": f"{prefix}denoiser_vs_jax_golden"}
    for dtype_name in ("float32", "bfloat16"):
        model = denoiser_from_params(cfg.replace(compute_dtype=dtype_name),
                                     params, device)
        worst = 0.0
        for t in range(fx["t_frac"].shape[0]):
            pos = fx["in_pos_t"][t]
            edges = knn_edges(pos, fx["cond_mask"], k) if k else None
            eps_x, eps_h = model(fx["in_species_t"][t], pos,
                                 fx["cond_spectrum"], fx["cond_exo"],
                                 fx["in_t_norm"][t], fx["cond_mask"], edges)
            gold_x = fx[f"{prefix}eps_x_{dtype_name}"][t]
            gold_h = fx[f"{prefix}eps_h_{dtype_name}"][t]
            if dtype_name == "float32":
                scale = max(float(gold_x.abs().max()),
                            float(gold_h.abs().max()))
                err = max(float((eps_x - gold_x).abs().max()),
                          float((eps_h - gold_h).abs().max())) / scale
                limit = 1e-3
            else:
                err = max(rel_l2(eps_x, gold_x), rel_l2(eps_h, gold_h))
                limit = 2e-2
            worst = max(worst, err)
            if not err <= limit:
                raise AssertionError(
                    f"{prefix}{dtype_name} denoiser off the JAX golden at "
                    f"t/T={float(fx['t_frac'][t])}: {err} > {limit}")
        rec[dtype_name] = {"worst": worst,
                           "measure": ("max abs err / output scale"
                                       if dtype_name == "float32"
                                       else "relative L2")}
    log(rec)


def median_si_o(pos, species, mask) -> float:
    """Median over accepted samples of each Si atom's nearest-O distance."""
    import numpy as np

    dists = []
    for p, s, m in zip(pos, species, mask):
        real = m > 0
        p, s = p[real], s[real].argmax(-1)
        si, ox = p[s == 1], p[s == 0]
        if len(si) and len(ox):
            d = np.linalg.norm(si[:, None, :] - ox[None, :, :], axis=-1)
            dists.append(d.min(axis=1))
    return float(np.median(np.concatenate(dists)))


def held_to_record(snapshot: str, scores: dict) -> dict:
    """The port's scores beside the JAX record and the gates."""
    q = QUALITY[snapshot]
    gate = q["gate"]
    record = q["record"]
    within = {
        k: abs(scores[k] - record[k]) <= gate[k]
        for k in ("rdf_cos_mean", "rdf_cos_median")}
    within["cn2_angle_r2"] = (scores["cn2_angle_r2"] is not None
                              and scores["cn2_angle_r2"]
                              >= gate["cn2_angle_r2_min"])
    return {"snapshot": snapshot, "port": scores, "jax_record": record,
            "gate": gate, "within_gate": within}


def check_gates(quality: dict, open_fault: tuple = ()) -> None:
    """Raise when a score is outside its gate, but for the scores of
    ``open_fault``: a gate that fails on the card is kept as stated and
    recorded in ROADMAP.md §3 (F4, F7: closed as no fault of the port, whose
    chains end on the JAX package's structures from the same draws); it is
    logged with that entry's name and not enforced."""
    failed = [k for k, ok in quality["within_gate"].items() if not ok]
    if any(k not in open_fault for k in failed):
        raise AssertionError(f"{quality['snapshot']}: the port's score is "
                             f"outside its gate: {quality}")


def phase_data() -> list:
    """The port's data module rebuilds the flagship's 27 test conditions
    (``synthetic_sio2_dataset`` + ``split_dataset``, numpy on this machine)
    and they equal the fixture's ``cond_*`` arrays bit for bit; phases 4
    and 9 generate for them."""
    import numpy as np

    from diffusion_model_tpu_torch.data.batch import collate
    from diffusion_model_tpu_torch.evals.restore_check import (
        held_out_conditions,
    )
    from diffusion_model_tpu_torch.train.checkpoint import load_config_npz

    cfg = load_config_npz(str(SNAPSHOT))
    graphs = held_out_conditions(cfg, NUM_GRAPHS, SHELLS)
    batch = collate(graphs, cfg.n_max, "cpu")
    with np.load(FIXTURE) as z:
        for field in ("pos", "species", "spectrum", "exo", "mask"):
            if not np.array_equal(getattr(batch, field).numpy(),
                                  z[f"cond_{field}"]):
                raise AssertionError(f"the port's test split differs from "
                                     f"the fixture in {field}")
        if [g["id"] for g in graphs] != list(z["cond_id"]):
            raise AssertionError("the port's test split has other ids")
    log({"phase": "data", "conditions": len(graphs), "numpy": np.__version__,
         "equal_to_fixture": "bit for bit"})
    return graphs


def phase_score_devices(out: dict, device) -> None:
    """Phase 4's result scored with the curves on the card and on the CPU:
    RDF curves rtol 1e-5 / atol 1e-6 of their max, every score within
    1e-6."""
    import numpy as np

    from diffusion_model_tpu_torch.evals.rdf import evaluate_rdf_lists
    from diffusion_model_tpu_torch.evals.restore_check import score

    keep = np.nonzero(out["accepted"])[0]
    args = (out["original_pos"][keep], out["mask"][keep],
            out["generated_pos"][keep], out["mask"][keep])
    card = evaluate_rdf_lists(*args, device=device)
    host = evaluate_rdf_lists(*args, device="cpu")
    worst = 0.0
    for c, h in zip(card, host, strict=True):
        for k in ("rdf_original", "rdf_generated"):
            scale = float(np.abs(h[k]).max())
            if not np.allclose(c[k], h[k], rtol=1e-5, atol=1e-6 * scale):
                raise AssertionError(f"{k} on the card is off the CPU's")
            err = float(np.abs(c[k] - h[k]).max())
            worst = max(worst, err / scale if scale else err)
    on_card = score(out, GEN_PER_CONDITION, device)
    on_host = score(out, GEN_PER_CONDITION, "cpu")
    diff = {k: (abs(on_card[k] - on_host[k])
                if None not in (on_card[k], on_host[k])
                else 0.0 if on_card[k] is on_host[k] else float("inf"))
            for k in on_card}
    log({"phase": "score_devices", "curves": len(card),
         "worst_curve_err_over_max": worst, "score_diff": diff,
         "scores": on_card,
         "tolerance": "curves rtol 1e-5 / atol 1e-6 of max; scores 1e-6"})
    if not max(diff.values()) <= 1e-6:
        raise AssertionError(f"scores differ between card and CPU: {diff}")


def phase_generate_learned(device, card: str) -> None:
    """``restore_check`` on the learned-schedule snapshot: its own gamma
    table, bf16, dense route, 27 x 5, 1000 steps; every EGCL through K1."""
    import torch

    from diffusion_model_tpu_torch.evals.restore_check import restore_check
    from diffusion_model_tpu_torch.ops import egcl_knn, egcl_pair

    egcl_pair.egcl_pair_launches = 0
    egcl_knn.egcl_knn_launches = 0
    summary = restore_check(str(LEARNED), device, NUM_GRAPHS, SHELLS)
    torch.cuda.synchronize()
    launches = {"egcl_pair": egcl_pair.egcl_pair_launches,
                "egcl_knn": egcl_knn.egcl_knn_launches}
    scores = {k: summary[k] for k in (
        "finite_fraction", "accepted_fraction", "rdf_cos_mean",
        "rdf_cos_median", "cn2_angle_r2", "cn2_angle_conditions")}
    rec = {"phase": "generate_learned", "card": card,
           "summary": summary, **{f"{k}_launches": v
                                  for k, v in launches.items()},
           "jax_record_accepted": "135 of 135",
           "quality": held_to_record("q_learned_r5_s2025", scores)}
    if not rec["quality"]["within_gate"]["cn2_angle_r2"]:
        rec["quality"]["open_fault"] = {"cn2_angle_r2": LEARNED_R2_FAULT}
    log(rec)
    if summary["compute_dtype"] != "bfloat16" or summary["neighbor_k"]:
        raise AssertionError(f"not the bf16 dense route: {summary}")
    if summary["samples"] != 135 or summary["accepted"] != 135:
        raise AssertionError(f"learned snapshot: {summary['accepted']} of "
                             f"{summary['samples']} accepted")
    if launches != {"egcl_pair": SERVED_LAUNCHES, "egcl_knn": 0}:
        raise AssertionError(f"learned snapshot launches: {launches}")
    check_gates(rec["quality"], open_fault=("cn2_angle_r2",))


def phase_trajectory(cfg, params, graphs, device) -> None:
    """One chunk through ``api.generate(return_trajectory=True)`` (50 snr
    steps, a frame every 10): 5 frames of the chunk's samples, frame 0 the
    pure noise (CoM-free over the real rows), and the final positions bit
    for bit those of the same seed's run without the trajectory."""
    import numpy as np
    import torch

    from diffusion_model_tpu_torch import api

    cfg = cfg.replace(sample_steps=TRAJECTORY_STEPS, sample_grid="snr",
                      snapshot_every=TRAJECTORY_EVERY)
    model = api.denoiser_from_params(cfg, params, device)
    chunk = graphs[:GEN_BATCH]
    runs = [api.generate(cfg, model, chunk,
                         torch.Generator(device=device).manual_seed(cfg.seed),
                         gen_num_per_spectrum=GEN_PER_CONDITION,
                         batch_size=GEN_BATCH, return_trajectory=trajectory)
            for trajectory in (True, False)]
    with_t, without = runs
    n = GEN_BATCH * GEN_PER_CONDITION
    frames = TRAJECTORY_STEPS // TRAJECTORY_EVERY
    shapes = {k: with_t[k].shape for k in ("trajectory_pos", "trajectory_h")}
    mask = with_t["mask"][..., None]
    com = (with_t["trajectory_pos"][0] * mask).sum(1) / mask.sum(1)
    equal = all(np.array_equal(with_t[k], without[k], equal_nan=True)
                for k in ("generated_pos", "generated_species",
                          "generated_h", "finite", "accepted"))
    rec = {"phase": "trajectory", "steps": TRAJECTORY_STEPS,
           "snapshot_every": TRAJECTORY_EVERY,
           "shapes": {k: list(v) for k, v in shapes.items()},
           "frame0_max_abs_com": float(np.abs(com).max()),
           "final_equal_without_trajectory": equal,
           "accepted": int(with_t["accepted"].sum())}
    log(rec)
    if shapes != {"trajectory_pos": (frames, n, cfg.n_max, 3),
                  "trajectory_h": (frames, n, cfg.n_max,
                                   cfg.atom_type_size)}:
        raise AssertionError(f"trajectory shapes: {rec}")
    if not rec["frame0_max_abs_com"] <= 1e-5:
        raise AssertionError(f"frame 0 is not CoM-free: {rec}")
    if not equal or "trajectory_pos" in without:
        raise AssertionError(f"the trajectory changed the samples: {rec}")


def phase_generate(cfg, params, graphs, device):
    """Served generation; every EGCL must go through the kernel of the
    config's route (K2 with ``neighbor_k``, else K1) and none through the
    other, and in bf16 the node MLP's first Dense through ``bias_silu``
    once a layer; the samples are scored against the JAX record. Returns
    the kernels' launch counts over exactly the run, and the result."""
    import torch

    from diffusion_model_tpu_torch import api
    from diffusion_model_tpu_torch.evals.restore_check import score
    from diffusion_model_tpu_torch.ops import activations, egcl_knn, egcl_pair

    model = api.denoiser_from_params(cfg, params, device)
    calls = [0]
    model.register_forward_pre_hook(lambda *_: calls.__setitem__(
        0, calls[0] + 1))
    generator = torch.Generator(device=device).manual_seed(cfg.seed)
    egcl_pair.egcl_pair_launches = 0
    egcl_knn.egcl_knn_launches = 0
    activations.bias_silu_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = api.generate(cfg, model, graphs, generator,
                       gen_num_per_spectrum=GEN_PER_CONDITION,
                       batch_size=GEN_BATCH)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"egcl_pair": egcl_pair.egcl_pair_launches,
                "egcl_knn": egcl_knn.egcl_knn_launches,
                "bias_silu": activations.bias_silu_launches}
    route, other = (("egcl_knn", "egcl_pair") if cfg.neighbor_k
                    else ("egcl_pair", "egcl_knn"))

    n = len(graphs) * GEN_PER_CONDITION
    keep = out["accepted"]
    rec = {"phase": "generate_knn" if cfg.neighbor_k else "generate",
           "neighbor_k": cfg.neighbor_k, "samples": n,
           "finite": int(out["finite"].sum()), "accepted": int(keep.sum()),
           "jax_record_accepted": "135 of 135",
           **{f"{k}_launches": v for k, v in launches.items()},
           "denoiser_calls": calls[0], "wall_s": wall}
    if out["generated_pos"].shape != (n, cfg.n_max, 3) or len(out["ids"]) != n:
        raise AssertionError(f"generate returned wrong shapes: {rec}")
    if not keep.all():
        raise AssertionError(f"not every sample accepted: {rec}")
    if launches[route] != cfg.L * calls[0] or launches[route] != \
            SERVED_LAUNCHES:
        raise AssertionError(
            f"{route} launches {launches[route]} != L x denoiser calls = "
            f"{SERVED_LAUNCHES}: {rec}")
    if launches[other] != 0:
        raise AssertionError(f"{other} launched on the {route} route: {rec}")
    # the node MLP's first Dense and its SiLU, once a layer in bf16
    want_fused = SERVED_LAUNCHES if cfg.compute_dtype == "bfloat16" else 0
    if launches["bias_silu"] != want_fused:
        raise AssertionError(f"bias_silu launches {launches['bias_silu']} "
                             f"!= {want_fused}: {rec}")
    si_o = median_si_o(out["generated_pos"], out["generated_species"],
                       out["mask"])
    si_o_ref = median_si_o(out["original_pos"], out["original_species"],
                           out["mask"])
    rec["median_nearest_si_o_A"] = si_o
    rec["conditions_median_nearest_si_o_A"] = si_o_ref
    rec["jax_record_si_o_A"] = "~1.6"
    scores = score(out, GEN_PER_CONDITION, device)
    rec["quality"] = held_to_record("q_predef_r5", scores)
    log(rec)
    if not abs(si_o - si_o_ref) <= SI_O_TOLERANCE:
        raise AssertionError(
            f"median nearest Si-O {si_o} A is off the conditions' "
            f"{si_o_ref} A by more than {SI_O_TOLERANCE} A")
    check_gates(rec["quality"])
    return launches, out


def time_sample(model, schedule, cfg, cond, steps: int, seed: int = 0):
    """(seconds, all finite) of one ``sample`` of ``steps`` strided steps."""
    import torch

    from diffusion_model_tpu_torch.diffusion.sampler import sample

    gen = torch.Generator(device=cond.device).manual_seed(seed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = sample(model, schedule, cfg.replace(sample_steps=steps), gen, cond)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, bool(res.finite.all())


def phase_headline(cfg, params, cell, device, card: str) -> None:
    from diffusion_model_tpu_torch.api import denoiser_from_params
    from diffusion_model_tpu_torch.data.batch import collate
    from diffusion_model_tpu_torch.diffusion.process import (
        predefined_schedule,
    )

    n_atoms = 192
    cfg = cfg.replace(n_max=n_atoms)
    cond = collate([cell], n_atoms, device)
    schedule = predefined_schedule(cfg, device=device)
    rec = {"phase": "headline_192_atoms", "card": card, "dtype":
           cfg.compute_dtype, "batch": 1}
    table = kernel_table()
    for route, edge_fn in (("kernel", table["egcl_pair"][0]),
                           ("plain", table["egcl_pair"][1])):
        model = denoiser_from_params(cfg, params, device, edge_fn=edge_fn)
        time_sample(model, schedule, cfg, cond, 2)
        for steps in (1000, 250):
            sec, finite = time_sample(model, schedule, cfg, cond, steps)
            rec[f"{route}_{steps}"] = {
                "s_per_structure": sec,
                "atoms_steps_per_s": n_atoms * steps / sec,
                # not required: see phase_kernels on 192-atom inputs
                "finite": finite,
            }
    log(rec)


def with_vnode_params(params: dict, cfg, seed: int = 0) -> dict:
    """The flax tree with virtual-node arrays added to every EGCL, drawn at
    std 1/sqrt(fan_in) from a numpy seed (heads included, so the channel
    does work; the layout of ``diffusion_model_tpu/nn/egnn.py``)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    h, mh, m, xh = (cfg.h_size, cfg.m_hidden_size, cfg.m_size,
                    cfg.x_hidden_size)
    shapes = {"vnode_in": (h + 1, mh), "vnode_pool": (mh, m),
              "vnode_out": (h + m + 1, m), "vnode_x": (h + m + 1, xh),
              "vnode_x_head": (xh, 1)}
    egnn = dict(params["denoiser"]["params"]["egnn"])
    for l in range(cfg.L):
        layer = dict(egnn[f"egcl_{l}"])
        for name, (fan_in, out) in shapes.items():
            std = fan_in ** -0.5
            layer[name] = {
                "kernel": (rng.normal(size=(fan_in, out)) * std
                           ).astype(np.float32),
                "bias": (rng.normal(size=(out,)) * std).astype(np.float32)}
        egnn[f"egcl_{l}"] = layer
    den = dict(params["denoiser"]["params"], egnn=egnn)
    return dict(params, denoiser={"params": den})


def phase_large_cell(cfg, params, device, card: str) -> None:
    import torch

    from diffusion_model_tpu_torch.api import denoiser_from_params
    from diffusion_model_tpu_torch.data.batch import collate
    from diffusion_model_tpu_torch.data.synthetic import amorphous_cell
    from diffusion_model_tpu_torch.diffusion.process import (
        predefined_schedule,
    )
    from diffusion_model_tpu_torch.ops import egcl_knn

    table = kernel_table()
    cfg = cfg.replace(neighbor_k=LARGE_K, virtual_node=True, h_residual=True,
                      n_max=LARGE_ATOMS)
    params = with_vnode_params(params, cfg)
    schedule = predefined_schedule(cfg, device=device)
    big = collate([amorphous_cell(seed=0, num_atoms=LARGE_ATOMS)],
                  LARGE_ATOMS, device)
    mid = collate([amorphous_cell(seed=s, num_atoms=MID_ATOMS)
                   for s in (0, 1)], MID_ATOMS, device)
    rec = {"phase": "large_cell_2048_atoms", "card": card,
           "dtype": cfg.compute_dtype, "batch": 1, "neighbor_k": LARGE_K,
           "virtual_node": True, "h_residual": True, "L": cfg.L,
           "weights": "flagship EGCL + seeded virtual node (speed only)"}
    calls = [0]
    egcl_knn.egcl_knn_launches = 0
    for route, steps_list in (("kernel", (1000, 250)), ("plain", (250,))):
        model = denoiser_from_params(cfg, params, device,
                                     knn_edge_fn=table["egcl_knn"][
                                         0 if route == "kernel" else 1])
        if route == "kernel":
            model.register_forward_pre_hook(lambda *_: calls.__setitem__(
                0, calls[0] + 1))
        time_sample(model, schedule, cfg, big, 2)
        for steps in steps_list:
            sec, finite = time_sample(model, schedule, cfg, big, steps)
            rec[f"{route}_{steps}"] = {
                "s_per_structure": sec,
                "atoms_steps_per_s": LARGE_ATOMS * steps / sec,
                "finite": finite,   # reported, not required
            }
        mid_cfg = cfg.replace(n_max=MID_ATOMS)
        steps = 50
        time_sample(model, schedule, mid_cfg, mid, 2)
        sec, finite = time_sample(model, schedule, mid_cfg, mid, steps)
        rec[f"{route}_2x512_ms_per_call"] = 1000 * sec / (steps + 1)
    torch.cuda.synchronize()
    launches = egcl_knn.egcl_knn_launches
    rec["egcl_knn_launches"] = launches
    rec["kernel_route_denoiser_calls"] = calls[0]
    log(rec)
    if launches == 0 or launches != cfg.L * calls[0]:
        raise AssertionError(
            f"large cell: {launches} K2 launches != L x {calls[0]} "
            f"kernel-route denoiser calls")


def seeded_inputs(cfg, b: int, t: float, seed: int = 0):
    """Denoiser inputs of ``b`` graphs of ``cfg.n_max`` nodes (6 to n_max
    real) from a numpy seed: noisy species and positions, a spectrum per
    node, the excited atom first, ``t/T = t``; float32 on the CPU."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    n = cfg.n_max
    real = rng.integers(6, n + 1, size=b)
    mask = (np.arange(n)[None] < real[:, None]).astype(np.float32)
    m3 = mask[..., None]
    exo = np.zeros((b, n, 1), np.float32)
    exo[:, 0] = 1.0
    arrays = (rng.normal(size=(b, n, cfg.atom_type_size)) * m3,
              rng.normal(size=(b, n, 3)) * 1.5 * m3,
              rng.random((b, n, cfg.spectrum_size)), exo * m3, t * m3, mask)
    return [torch.from_numpy(np.asarray(a, np.float32)) for a in arrays]


def phase_plain_route(device) -> None:
    """Models whose widths the kernels do not take, on the card through the
    plain route, held against the same calls on the CPU."""
    import torch

    from diffusion_model_tpu_torch.config import Config
    from diffusion_model_tpu_torch.nn import egnn
    from diffusion_model_tpu_torch.nn.denoiser import DiffusionDenoiser
    from diffusion_model_tpu_torch.ops import egcl_knn, egcl_pair
    from diffusion_model_tpu_torch.ops.edges import knn_edges

    models = {
        "tiny_dense": Config(L=2, m_hidden_size=32, m_size=16,
                             h_hidden_size=32, x_hidden_size=32,
                             compressed_spectrum_size=8,
                             compressor_hidden_dim=(16,), n_max=16),
        "h204_knn": Config(L=2, to_compress_spectrum=False,
                           neighbor_k=SERVED_K, n_max=16),
    }
    rec = {"phase": "plain_route", "budget_elements":
           egnn.PLAIN_EDGE_ELEMENTS, "batch": GEN_BATCH * GEN_PER_CONDITION,
           "tolerance": "float32 rtol 2e-4 / atol 2e-5 of the output scale"}
    for name, cfg in models.items():
        k = cfg.neighbor_k
        route = egnn.edge_route(cfg.m_hidden_size, cfg.x_hidden_size,
                                cfg.m_size, cfg.torch_dtype,
                                cfg.h_size if k else None)
        if route != "plain":
            raise AssertionError(f"{name}: edge_route says {route}")
        torch.manual_seed(0)
        cpu_model = DiffusionDenoiser(cfg)
        card_model = DiffusionDenoiser(cfg, device=device)
        card_model.load_state_dict(cpu_model.state_dict())
        launches = (egcl_pair.egcl_pair_launches, egcl_knn.egcl_knn_launches)
        calls, worst = 0, 0.0
        for i, t in enumerate(PLAIN_ROUTE_T):
            inputs = seeded_inputs(cfg, GEN_BATCH * GEN_PER_CONDITION, t, i)
            card_in = [a.to(device) for a in inputs]
            before = egnn.plain_edge_calls
            got = card_model(*card_in, knn_edges(card_in[1], card_in[5], k)
                             if k else None)
            torch.cuda.synchronize()
            calls += egnn.plain_edge_calls - before
            want = cpu_model(*inputs, knn_edges(inputs[1], inputs[5], k)
                             if k else None)
            scale = max(float(w.abs().max()) for w in want)
            for g, w in zip(got, want):
                torch.testing.assert_close(g.cpu(), w, rtol=2e-4,
                                           atol=2e-5 * scale)
                worst = max(worst, float((g.cpu() - w).abs().max()) / scale)
        if calls != cfg.L * len(PLAIN_ROUTE_T):
            raise AssertionError(f"{name}: {calls} plain-route calls on the "
                                 f"card, want L x calls")
        if (egcl_pair.egcl_pair_launches,
                egcl_knn.egcl_knn_launches) != launches:
            raise AssertionError(f"{name}: a kernel was launched on the "
                                 f"plain route")
        rec[name] = {"h_size": cfg.h_size, "f1": cfg.m_hidden_size,
                     "fm": cfg.m_size, "neighbor_k": k, "route": route,
                     "plain_edge_calls_on_card": calls,
                     "worst_abs_err_over_scale": worst}
    log(rec)


def launches_per_call(cfg, params, fx, device) -> dict:
    """Kernels one flagship denoiser call launches (bf16, the served 80 x
    16 chunk, dense route), by ``torch.profiler``: the first call of a
    fresh model casts its weights, the next finds them cast."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from diffusion_model_tpu_torch.api import denoiser_from_params

    model = denoiser_from_params(cfg, params, device)
    inputs = served_inputs(fx)

    def kernels() -> dict:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            model(*inputs)
            torch.cuda.synchronize()
        events = prof.events()
        device_kernels = [e for e in events
                          if e.device_type == torch.autograd.DeviceType.CUDA
                          and not e.name.startswith(("Memcpy", "Memset"))]
        runtime = [e for e in events if e.name.startswith(
            ("cudaLaunchKernel", "cuLaunchKernel"))]
        return {"device_kernels": len(device_kernels),
                "runtime_launches": len(runtime)}

    rec = {"first_call": kernels(), "next_call": kernels(),
           "parent_next_call_runtime_launches": PARENT_CALL_LAUNCHES}
    if not (rec["first_call"]["device_kernels"]
            > rec["next_call"]["device_kernels"] > 0):
        raise AssertionError(f"launches per denoiser call: {rec}")
    # F12's bias adds after the node MLP's second product: at most one
    # more launch a layer than before the repair
    if rec["next_call"]["runtime_launches"] > PARENT_CALL_LAUNCHES + cfg.L:
        raise AssertionError(f"a denoiser call launches more than "
                             f"{PARENT_CALL_LAUNCHES} + L: {rec}")
    return rec


def grad_check(name: str, label: str, args, dtype_name: str) -> dict:
    """The edge function's gradients on the card (kernel forward, backward
    autograd of the statement ``ops.edge_grad`` differentiates: the plain
    float32 statement in float32, the compute-dtype statement in bfloat16,
    F11) against autograd of that whole statement on the same inputs and a
    seeded random cotangent, and both timed (CUDA events)."""
    import torch

    from diffusion_model_tpu_torch.ops import egcl_knn, egcl_pair

    kernel, plain = kernel_table()[name][:2]
    compute = (egcl_pair.egcl_pair_edges_compute if name == "egcl_pair"
               else egcl_knn.egcl_knn_edges_compute)
    data = {5} if name == "egcl_pair" else {4, 5}
    leaves = [a.detach().clone().requires_grad_(i not in data)
              for i, a in enumerate(args)]
    diff = [a for i, a in enumerate(leaves) if i not in data]
    counter = egcl_pair if name == "egcl_pair" else egcl_knn
    attr = f"{name}_launches"
    before = getattr(counter, attr)
    out = kernel(*leaves)
    launched = getattr(counter, attr) - before
    g = torch.Generator(device=args[0].device).manual_seed(7)
    cot = tuple(torch.randn(o.shape, generator=g, device=o.device)
                for o in out)
    got = torch.autograd.grad(out, diff, cot, retain_graph=True)
    want_out = plain(*leaves)
    back = want_out if dtype_name == "float32" else compute(*leaves)
    back_cot = tuple(c.to(b.dtype) for c, b in zip(cot, back))
    want = torch.autograd.grad(back, diff, back_cot, retain_graph=True)
    torch.cuda.synchronize()
    if launched != 1 or not out[0].requires_grad:
        raise AssertionError(f"{name} {label}: {launched} launches, grad "
                             f"{out[0].requires_grad}")
    worst = 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        if dtype_name == "float32":
            torch.testing.assert_close(
                a, b, rtol=GRAD_F32_RTOL,
                atol=GRAD_F32_RTOL * 1e-2 * float(b.abs().max()),
                msg=lambda m: f"{name} {label} grad {i}: {m}")
            worst = max(worst, float((a - b).abs().max() / b.abs().max()))
        else:
            err = rel_l2(a, b)
            worst = max(worst, err)
            if not err <= GRAD_BF16_REL_L2:
                raise AssertionError(f"{name} {label} bf16 grad {i}: "
                                     f"relative L2 {err}")
    rec = {"kernel": name, "shape": label, "dtype": dtype_name,
           "grads_checked": len(got),
           ("worst_err_over_scale" if dtype_name == "float32"
            else "worst_rel_l2"): worst,
           "forward_max_abs_err": max(float((o - w).abs().max())
                                      for o, w in zip(out, want_out)),
           "tolerance": (f"rtol {GRAD_F32_RTOL}" if dtype_name == "float32"
                         else f"relative L2 {GRAD_BF16_REL_L2}"),
           "forward_ms": cuda_ms(lambda: kernel(*leaves), 10),
           "backward_ms": cuda_ms(lambda: torch.autograd.grad(
               out, diff, cot, retain_graph=True), 5),
           "plain_forward_ms": cuda_ms(lambda: plain(*args), 5),
           "plain_backward_ms": cuda_ms(lambda: torch.autograd.grad(
               back, diff, back_cot, retain_graph=True), 3)}
    return rec


def phase_train_grad(cfg, params, fx, device, card: str) -> dict:
    """K1 at 64 x 16 and K2 at 64 x 16 K=15 and 2 x 512 K=32, on the
    flagship's layer-0 edge inputs, float32 and bfloat16: ``grad_check``."""
    from diffusion_model_tpu_torch.data.synthetic import amorphous_cell

    served = tuple(a[:TRAIN_B] for a in served_inputs(fx))
    mids = [amorphous_cell(seed=s, num_atoms=MID_ATOMS) for s in (0, 1)]
    shapes = (("egcl_pair", "64x16", served, 0),
              ("egcl_knn", "64x16_k15", served, SERVED_K),
              ("egcl_knn", "2x512_k32", cell_inputs(mids, device), LARGE_K))
    rows = []
    for dtype_name in ("float32", "bfloat16"):
        dcfg = cfg.replace(compute_dtype=dtype_name)
        for name, label, inputs, k in shapes:
            args = capture_edge_inputs(dcfg, params, device, *inputs, k=k)[0]
            rows.append(grad_check(name, label, args, dtype_name))
    log({"phase": "train_grad", "card": card, "checks": rows})
    return {f"{r['kernel']}_{r['shape']}_{r['dtype']}": r for r in rows}


def flagship_graphs(cfg) -> list:
    """The 256 synthetic graphs a snapshot was trained on (its seed)."""
    from diffusion_model_tpu_torch.data.synthetic import (
        synthetic_sio2_dataset,
    )

    return synthetic_sio2_dataset(cfg.seed, NUM_GRAPHS, cfg.n_max,
                                  spectrum_size=cfg.spectrum_size,
                                  shells=SHELLS)


def phase_train_parity(device, card: str) -> None:
    """From the flagship's weights, on the first 16 train graphs and the
    fixture's JAX draws, through ``Trainer`` on the card (K1 forward, its
    plain backward): the loss, ``sum_sq``, the per-leaf gradient norms and
    the per-leaf update norms of one ``RAdamScheduleFree`` step against the
    JAX package's (``tests/fixtures/torch_port/train.npz``), float32 and
    bfloat16; K1 launched 5 times a forward, the plain route never."""
    import numpy as np
    import torch

    from diffusion_model_tpu_torch.data.batch import collate
    from diffusion_model_tpu_torch.data.split import split_dataset
    from diffusion_model_tpu_torch.nn import egnn
    from diffusion_model_tpu_torch.ops import egcl_knn, egcl_pair
    from diffusion_model_tpu_torch.train.checkpoint import (
        load_config_npz,
        load_params_npz,
        port_name,
        save_params_npz,
    )
    from diffusion_model_tpu_torch.train.trainer import Trainer, params_tree

    sys.path.insert(0, str(ROOT / "tests"))
    from torch_port_fixtures import ReplayDraws

    with np.load(TRAIN_FIXTURE) as z:
        fx = {k: z[k] for k in z.files}
    draws = {k[len("draw_"):]: [v] for k, v in fx.items()
             if k.startswith("draw_")}
    cfg = load_config_npz(str(SNAPSHOT))
    params = load_params_npz(str(SNAPSHOT))
    train = split_dataset(flagship_graphs(cfg), cfg.seed)[0]
    batch = collate(train[:len(fx["draw_t"])], cfg.n_max, device)
    if not np.array_equal(batch.pos.cpu().numpy(), fx["train_pos"]):
        raise AssertionError("the port's train batch differs from the "
                             "fixture's")
    names = ["denoiser." + port_name(n.split("/", 2)[2])
             for n in fx["leaf_names"]]
    rec = {"phase": "train_parity", "card": card,
           "graphs": int(batch.batch_size)}
    for dt, (loss_rtol, norm_rtol) in TRAIN_TOL.items():
        trainer = Trainer(cfg.replace(compute_dtype=dt), device=device)
        state = trainer.init_state(cfg.seed, params=params)
        egcl_pair.egcl_pair_launches = egcl_knn.egcl_knn_launches = 0
        egnn.plain_edge_calls = 0
        loss, sum_sq, _, grads = trainer.loss_and_grads(
            state, ReplayDraws(draws, device), batch)
        old = {k: p.detach().clone() for k, p in state.params.items()}
        state, _ = trainer.train_step(state, ReplayDraws(draws, device),
                                      batch)
        torch.cuda.synchronize()
        counts = (egcl_pair.egcl_pair_launches, egcl_knn.egcl_knn_launches,
                  egnn.plain_edge_calls)
        if counts != (2 * cfg.L, 0, 0):
            raise AssertionError(f"{dt}: (K1, K2, plain) = {counts} over two "
                                 f"forwards")
        got = {
            "loss": float(loss), "sum_sq": float(sum_sq),
            "grad_norm": np.array([float(grads[k].norm()) for k in names]),
            "update_norm": np.array([float((state.params[k].detach()
                                            - old[k]).norm())
                                     for k in names])}
        worst = {}
        for key, value in got.items():
            want = fx[f"{key}_{dt}"]
            err = np.abs(value - want) / np.abs(want)
            tol = loss_rtol if key in ("loss", "sum_sq") else norm_rtol
            if np.ndim(err):
                # a leaf whose gradient JAX's own bf16 moves from its f32
                # (sums over many edges in bf16) is held to twice that move
                f32 = fx[f"{key}_float32"]
                tol = np.maximum(tol, 2 * np.abs(want - f32) / np.abs(f32))
            worst[key] = float(np.max(err / tol))
            if not np.all(err <= tol):
                i = int(np.argmax(err / tol)) if np.ndim(err) else 0
                raise AssertionError(
                    f"train step {dt}: {key} off JAX's by {np.max(err)} "
                    f"at {names[i] if np.ndim(err) else key}")
        if dt == "bfloat16":
            # the port-trained weights through save_params_npz and back
            # generate, every sample finite
            npz = str(TRAIN_RUN / "parity_step.npz")
            save_params_npz(params_tree(state.eval_params(trainer.cfg)), npz,
                            cfg=trainer.cfg)
            gen = generated_chunk(load_config_npz(npz), load_params_npz(npz),
                                  train, device)
            if gen["finite"] != gen["samples"]:
                raise AssertionError(f"the port-trained npz: {gen}")
            rec["generated_from_port_npz"] = gen
        rec[dt] = {"loss": got["loss"], "jax_loss": float(fx[f"loss_{dt}"]),
                   "sum_sq": got["sum_sq"],
                   "worst_err_over_tolerance": worst,
                   "k1_launches_per_forward":
                   counts[0] / 2, "plain_edge_calls": counts[2],
                   "tolerance": {"loss": loss_rtol, "norms": norm_rtol,
                                 "norms_of_leaves_jax_bf16_moves": "twice "
                                 "JAX's bf16-f32 difference"}}
    log(rec)


def phase_train_flagship(device, card: str, k: int = 0,
                         epochs: int = TRAIN_EPOCHS) -> dict:
    """``api.train`` with the flagship's recipe (``q_predef_r5``'s config:
    bf16, batch 64, RAdamScheduleFree, lr 2e-4, predefined schedule) from a
    fresh init on its 256 graphs, on the dense route (``k`` 0, K1) or the
    kNN route (K2): losses a epoch, ms a train step (CUDA events over
    ``TRAIN_STEP_REPS`` steps after the first), peak memory, launches
    (5 a forward) and wall s; the dense run's npz then generates one
    chunk."""
    import json
    import shutil

    import numpy as np
    import torch

    from diffusion_model_tpu_torch import api
    from diffusion_model_tpu_torch.data.batch import collate
    from diffusion_model_tpu_torch.data.split import device_batch_iterator
    from diffusion_model_tpu_torch.nn.denoiser import DiffusionDenoiser
    from diffusion_model_tpu_torch.ops import egcl_knn, egcl_pair
    from diffusion_model_tpu_torch.train.checkpoint import (
        load_config_npz,
        load_params_npz,
    )
    from diffusion_model_tpu_torch.train.loss import TrainNoise

    cfg = load_config_npz(str(SNAPSHOT)).replace(neighbor_k=k)
    run_dir = TRAIN_RUN / ("knn" if k else "dense")
    shutil.rmtree(run_dir, ignore_errors=True)
    forwards = []
    hook = torch.nn.modules.module.register_module_forward_hook(
        lambda m, i, o: forwards.append(1)
        if isinstance(m, DiffusionDenoiser) else None)
    egcl_pair.egcl_pair_launches = egcl_knn.egcl_knn_launches = 0
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    try:
        trainer, state, (train, _, test) = api.train(
            cfg, flagship_graphs(cfg), str(run_dir), num_epochs=epochs,
            device=device)
        torch.cuda.synchronize()
    finally:
        hook.remove()
    wall = time.perf_counter() - t0
    launches = {"egcl_pair": egcl_pair.egcl_pair_launches,
                "egcl_knn": egcl_knn.egcl_knn_launches}
    want = {"egcl_pair": 0, "egcl_knn": 0,
            "egcl_knn" if k else "egcl_pair": cfg.L * len(forwards)}
    if launches != want:
        raise AssertionError(f"training launches {launches}, want {want} "
                             f"over {len(forwards)} forwards")
    lines = [json.loads(x) for x in open(run_dir / "metrics.jsonl")]
    losses = [(r["train_loss"], r["eval_loss"]) for r in lines
              if "train_loss" in r]
    if len(losses) != epochs or not np.isfinite(losses).all():
        raise AssertionError(f"training losses: {lines}")
    peak = torch.cuda.max_memory_allocated(device)
    batch = next(device_batch_iterator(collate(train, cfg.n_max, device),
                                       cfg.batch_size, seed=0))
    noise = TrainNoise((cfg.seed, 99, 0), device)
    model = (trainer.model, trainer.gamma)
    split = {
        "forward_ms": cuda_ms(lambda: trainer._loss(*model, noise, batch),
                              TRAIN_STEP_REPS),
        "forward_backward_ms": cuda_ms(lambda: trainer.loss_and_grads(
            state, noise, batch), TRAIN_STEP_REPS),
        "step_host_ms": host_us(lambda: trainer.train_step(
            state, noise, batch), TRAIN_STEP_REPS) / 1e3}
    step_ms = cuda_ms(lambda: trainer.train_step(state, noise, batch),
                      TRAIN_STEP_REPS)
    rec = {"phase": "train_flagship_knn" if k else "train_flagship",
           "card": card, "neighbor_k": k, "batch": cfg.batch_size,
           "compute_dtype": cfg.compute_dtype, "optimizer": cfg.optimizer,
           "train_graphs": len(train), "epochs": losses,
           "steps": state.step, "forwards": len(forwards),
           "launches": launches, "ms_per_train_step": step_ms,
           "step_split": split,
           "max_memory_allocated_bytes": peak, "wall_s": wall}
    if not k:
        # a model 8 steps from its init is not a sampler yet: its chain
        # may leave the finite range, so the samples' finite share is
        # read, not gated (phase train_parity gates a trained model's),
        # from one round without NaN retries (ten rounds took ~50 s)
        npz = str(run_dir / "params.npz")
        if load_config_npz(npz) != cfg:
            raise AssertionError("the npz's config is not the run's")
        rec["generated"] = generated_chunk(cfg, load_params_npz(npz), test,
                                           device, retries=0)
    log(rec)
    return rec


def state_leaves(state) -> dict:
    """A ``TrainState``'s parameters, optimizer-state leaves and step, keyed
    by field path, as its checkpoint holds them."""
    import torch

    from diffusion_model_tpu_torch.train import checkpoint

    out = checkpoint._flatten_state(state.params, "params", {})
    checkpoint._flatten_state(state.opt_state, "opt_state", out)
    out["step"] = torch.tensor(state.step)
    return out


def leaf_gap(a, b) -> dict:
    """Per leaf of two states, the largest absolute difference."""
    la, lb = state_leaves(a), state_leaves(b)
    if sorted(la) != sorted(lb):
        raise AssertionError("the two states have other leaves")
    return {k: float((la[k].double() - lb[k].double()).abs().max())
            if la[k].numel() else 0.0 for k in la}


def phase_checkpoint_resume(device, card: str) -> dict:
    """The flagship's recipe (bf16, dense K1, batch 64) from a fresh init,
    ``checkpoint_every=1``, through ``api.train``: run A 4 epochs, run A'
    the same again (is the card itself deterministic?), run B 2 epochs then
    ``resume=True`` to 4. B is held to A bit for bit where A equals A' bit
    for bit, else within ``RESUME_SPREAD`` times the A-A' gap, leaf for
    leaf. 3 step directories kept, K1 5 times a forward, the plain route
    never. Then the save and restore of A's state timed and its bytes;
    ``init_params_from`` A for one epoch starts at A's eval parameters;
    ``load_trained`` on A gives A's eval parameters and generates one chunk
    (its finite share read: a model 16 steps from its init; one round,
    without NaN retries); and a
    checkpoint holding the flagship's weights, reloaded by
    ``load_trained``, generates one chunk, every sample finite."""
    import os
    import shutil

    import torch

    from diffusion_model_tpu_torch import api
    from diffusion_model_tpu_torch.data.split import split_dataset
    from diffusion_model_tpu_torch.nn import egnn
    from diffusion_model_tpu_torch.nn.denoiser import DiffusionDenoiser
    from diffusion_model_tpu_torch.ops import egcl_knn, egcl_pair
    from diffusion_model_tpu_torch.train import checkpoint
    from diffusion_model_tpu_torch.train.checkpoint import (
        load_config_npz,
        load_params_npz,
    )
    from diffusion_model_tpu_torch.train.trainer import Trainer, params_tree

    cfg = load_config_npz(str(SNAPSHOT)).replace(checkpoint_every=1)
    graphs = flagship_graphs(cfg)
    test = split_dataset(graphs, cfg.seed)[2]
    root = TRAIN_RUN / "resume"
    shutil.rmtree(root, ignore_errors=True)

    def train(name, epochs, **kw):
        return api.train(cfg, graphs, str(root / name), num_epochs=epochs,
                         device=device, **kw)[1]

    forwards = []
    hook = torch.nn.modules.module.register_module_forward_hook(
        lambda m, i, o: forwards.append(1)
        if isinstance(m, DiffusionDenoiser) else None)
    egcl_pair.egcl_pair_launches = egcl_knn.egcl_knn_launches = 0
    egnn.plain_edge_calls = 0
    t0 = time.perf_counter()
    try:
        run_a = train("a", RESUME_EPOCHS)
        run_a2 = train("a2", RESUME_EPOCHS)
        train("b", RESUME_EPOCHS // 2)
        run_b = train("b", RESUME_EPOCHS, resume=True)
        torch.cuda.synchronize()
    finally:
        hook.remove()
    wall = time.perf_counter() - t0
    launches = {"egcl_pair": egcl_pair.egcl_pair_launches,
                "egcl_knn": egcl_knn.egcl_knn_launches,
                "plain_edge_calls": egnn.plain_edge_calls}
    want = {"egcl_pair": cfg.L * len(forwards), "egcl_knn": 0,
            "plain_edge_calls": 0}
    if launches != want or not forwards:
        raise AssertionError(f"resume runs: launches {launches}, want "
                             f"{want} over {len(forwards)} forwards")
    card_gap = leaf_gap(run_a, run_a2)
    resume_gap = leaf_gap(run_b, run_a)
    deterministic = max(card_gap.values()) == 0.0
    if deterministic:
        off = [k for k, v in resume_gap.items() if v != 0.0]
    else:
        off = [k for k, v in resume_gap.items()
               if v > RESUME_SPREAD * card_gap[k]]
    kept = sorted(os.listdir(root / "a" / "checkpoints"))

    # save and restore of A's full state, timed on the host clock
    timing = str(root / "timing")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    checkpoint.save_checkpoint(timing, run_a, cfg, step=RESUME_EPOCHS)
    save_ms = (time.perf_counter() - t0) * 1e3
    step_dir = os.path.join(timing, str(RESUME_EPOCHS))
    nbytes = sum(os.path.getsize(os.path.join(step_dir, f))
                 for f in os.listdir(step_dir))
    t0 = time.perf_counter()
    restored, _ = checkpoint.restore_checkpoint(
        timing, Trainer(cfg, device=device))
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    if max(leaf_gap(restored, run_a).values()) != 0.0:
        raise AssertionError("the restored state is not the saved one")

    # init_params_from A: the first epoch starts at A's eval parameters
    from diffusion_model_tpu_torch.train import trainer as trainer_module

    first = {}
    epoch_fn = trainer_module.Trainer.train_epoch

    def recording(self, state, noise, batches, mesh=None):
        first.setdefault("params", {k: p.detach().clone()
                                    for k, p in state.params.items()})
        first.setdefault("step", state.step)
        return epoch_fn(self, state, noise, batches, mesh)

    trainer_module.Trainer.train_epoch = recording
    try:
        train("c", 1, init_params_from=str(root / "a"))
    finally:
        trainer_module.Trainer.train_epoch = epoch_fn
    want_params = run_a.eval_params(cfg)
    init_equal = first["step"] == 0 and all(
        torch.equal(first["params"][k], want_params[k]) for k in want_params)

    # load_trained on A, and on a checkpoint of the flagship's weights
    _, loaded = api.load_trained(str(root / "a"), cfg, device)
    loaded_params = loaded.eval_params(cfg)
    load_equal = all(torch.equal(loaded_params[k], want_params[k])
                     for k in want_params)
    # a model 16 steps from its init: one round, no NaN retries
    gen_a = generated_chunk(cfg, params_tree(loaded_params), test, device,
                            retries=0)
    flagship_trainer = Trainer(cfg, device=device)
    flagship_state = flagship_trainer.init_state(
        cfg.seed, params=load_params_npz(str(SNAPSHOT)), skip_gamma_fit=True)
    checkpoint.save_checkpoint(str(root / "flagship" / "checkpoints"),
                               flagship_state, cfg, step=0)
    _, flagship_loaded = api.load_trained(str(root / "flagship"), cfg, device)
    gen_flagship = generated_chunk(
        cfg, params_tree(flagship_loaded.eval_params(cfg)), test, device)

    rec = {"phase": "checkpoint_resume", "card": card,
           "epochs": RESUME_EPOCHS, "steps": run_a.step,
           "forwards": len(forwards), "launches": launches,
           "card_deterministic": deterministic,
           "a_vs_a2_max_leaf_gap": max(card_gap.values()),
           "b_vs_a_max_leaf_gap": max(resume_gap.values()),
           "resume_held_to": "bit for bit" if deterministic else
           f"{RESUME_SPREAD} x the A-A' gap of each leaf",
           "leaves_off": off[:5], "kept_steps": kept,
           "checkpoint_bytes": nbytes, "save_ms": save_ms,
           "restore_ms": restore_ms, "runs_wall_s": wall,
           "init_params_from_starts_at_eval_params": init_equal,
           "load_trained_equals_eval_params": load_equal,
           "generated_from_a": gen_a,
           "generated_from_flagship_checkpoint": gen_flagship}
    log(rec)
    if off:
        raise AssertionError(f"the resumed run is off the uninterrupted "
                             f"one at {off[:5]}")
    if kept != [str(s) for s in range(RESUME_EPOCHS - 2, RESUME_EPOCHS + 1)]:
        raise AssertionError(f"kept steps {kept}")
    if not (init_equal and load_equal):
        raise AssertionError(f"init_params_from / load_trained: {rec}")
    if gen_flagship["finite"] != gen_flagship["samples"] or \
            gen_a["samples"] != GEN_BATCH * GEN_PER_CONDITION:
        raise AssertionError(f"generation from a checkpoint: {rec}")
    return rec


def phase_evaluate_flagship(out: dict, device, card: str) -> dict:
    """``api.evaluate``'s numbers on phase 4's samples (q_predef_r5, 27 x
    5) on the card against the CPU (RMSDs rtol 1e-5, accuracy exact),
    beside the JAX record, gated where the gate has a measured spread
    (``evals.retrain_check.GATE``)."""
    import numpy as np
    import torch

    from diffusion_model_tpu_torch import api
    from diffusion_model_tpu_torch.evals import retrain_check

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    on_card = api.evaluate_numbers(out, device)
    card_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    on_host = api.evaluate_numbers(out, "cpu")
    host_ms = (time.perf_counter() - t0) * 1e3
    keys = ("rmsd_best", "rmsd_median", "rmsd_worst", "atom_type_accuracy",
            "num_accepted")
    numbers = {k: on_card[k] for k in keys}
    card_rmsd = np.asarray([r[1] for r in on_card["sorted_rmsd"]])
    host_rmsd = np.asarray([r[1] for r in on_host["sorted_rmsd"]])
    err = float(np.max(np.abs(card_rmsd - host_rmsd) / host_rmsd))
    gate = retrain_check.within_gate("q_predef_r5", numbers)
    rec = {"phase": "evaluate_flagship", "card": card, "numbers": numbers,
           "cpu_numbers": {k: on_host[k] for k in keys},
           "sorted_rmsd_max_rel_err_card_vs_cpu": err,
           "jax_record": {k: retrain_check.RECORD["q_predef_r5"][k]
                          for k in keys if k in
                          retrain_check.RECORD["q_predef_r5"]},
           "gate": {k: retrain_check.GATE["q_predef_r5"].get(k)
                    for k in ("rmsd_median", "atom_type_accuracy")},
           "within_gate": gate,
           "open_fault": {k: v for k, v in EVALUATE_FAULT.items()
                          if not gate.get(k, True)},
           "card_ms": card_ms, "cpu_ms": host_ms,
           "tolerance": "card vs CPU: RMSDs rtol 1e-5, accuracy exact"}
    log(rec)
    if not err <= 1e-5 or any(
            not np.isclose(on_card[k], on_host[k], rtol=1e-5, atol=0)
            for k in ("rmsd_best", "rmsd_median", "rmsd_worst")):
        raise AssertionError(f"evaluate on the card is off the CPU: {rec}")
    if on_card["atom_type_accuracy"] != on_host["atom_type_accuracy"] or \
            on_card["num_accepted"] != on_host["num_accepted"]:
        raise AssertionError(f"evaluate's accuracy differs: {rec}")
    check_gates({"snapshot": "q_predef_r5", "within_gate": gate},
                open_fault=tuple(EVALUATE_FAULT))
    return rec


def phase_predict_sizes(cfg, params: dict, graphs: list, device,
                        card: str) -> None:
    """A seeded ``CNPredictor`` (its output bias at the conditions' mean
    atom count) on the card against the CPU on the test conditions
    (predictions rtol 1e-5, sizes equal), then one chunk through
    ``api.generate(size_predictor=...)``: every sample finite, K1 only."""
    import copy

    import numpy as np
    import torch

    from diffusion_model_tpu_torch import api
    from diffusion_model_tpu_torch.nn.cn_mlp import CNPredictor
    from diffusion_model_tpu_torch.ops import egcl_knn, egcl_pair

    torch.manual_seed(cfg.seed)
    host = CNPredictor(spectrum_size=cfg.spectrum_size)
    sizes = [len(g["pos"]) for g in graphs]
    with torch.no_grad():
        host.dense_out.bias.fill_(float(np.mean(sizes)))
    on_card = copy.deepcopy(host).to(device)
    spectra = np.stack([np.asarray(g["spectrum"][0], np.float32)
                        for g in graphs])
    with torch.no_grad():
        want = host(torch.from_numpy(spectra)).numpy()
        got = on_card(torch.from_numpy(spectra).to(device)).cpu().numpy()
    card_sizes = [len(g["pos"]) for g in api.predict_sizes(
        cfg, (on_card, None), graphs)]
    host_sizes = [len(g["pos"]) for g in api.predict_sizes(
        cfg, (host, None), graphs)]
    chunk = graphs[:GEN_BATCH]
    egcl_pair.egcl_pair_launches = egcl_knn.egcl_knn_launches = 0
    out = api.generate(cfg, params, chunk, device=device,
                       size_predictor=(on_card, None))
    torch.cuda.synchronize()
    launches = (egcl_pair.egcl_pair_launches, egcl_knn.egcl_knn_launches)
    rows = np.isfinite(out["generated_pos"]).all(axis=(1, 2))
    rec = {"phase": "predict_sizes", "card": card,
           "max_rel_err_card_vs_cpu": float(np.max(np.abs(got - want)
                                                   / np.abs(want))),
           "true_sizes": sizes[:GEN_BATCH], "predicted_sizes":
           card_sizes[:GEN_BATCH], "samples": int(len(rows)),
           "finite": int(rows.sum()), "accepted": int(out["accepted"].sum()),
           "k1_launches": launches[0], "k2_launches": launches[1],
           "tolerance": "predictions rtol 1e-5, sizes equal"}
    log(rec)
    if not np.allclose(got, want, rtol=1e-5, atol=0) or \
            card_sizes != host_sizes:
        raise AssertionError(f"CNPredictor on the card: {rec}")
    if card_sizes == sizes:
        raise AssertionError("the predictor changed no size")
    expected = [n for n in card_sizes[:GEN_BATCH]
                for _ in range(GEN_PER_CONDITION)]
    if list(out["mask"].sum(axis=1).astype(int)) != expected:
        raise AssertionError("generated sizes are not the predicted ones")
    if rec["finite"] != rec["samples"] or launches[1] or not launches[0] \
            or launches[0] % cfg.L:
        raise AssertionError(f"generation through size_predictor: {rec}")


def generated_chunk(cfg, params: dict, graphs: list, device,
                    retries: int | None = None) -> dict:
    """One chunk of ``api.generate`` (``GEN_BATCH`` conditions x
    ``GEN_PER_CONDITION``, 1000 steps; ``retries`` NaN-retry rounds in
    place of the config's): its samples, finite rows as the sampler flags
    them and as numpy reads them, accepted, K1 launches."""
    import numpy as np

    from diffusion_model_tpu_torch import api
    from diffusion_model_tpu_torch.ops import egcl_pair

    if retries is not None:
        cfg = cfg.replace(max_nan_retries=retries)
    before = egcl_pair.egcl_pair_launches
    out = api.generate(cfg, params, graphs[:GEN_BATCH], device=device)
    rows = np.isfinite(out["generated_pos"]).all(axis=(1, 2))
    rec = {"samples": len(out["ids"]), "finite": int(rows.sum()),
           "flagged_finite": int(out["finite"].sum()),
           "accepted": int(out["accepted"].sum()),
           "k1_launches": egcl_pair.egcl_pair_launches - before}
    if not np.array_equal(rows, out["finite"]):
        raise AssertionError(f"the sampler's finite flags are wrong: {rec}")
    return rec


def phase_train_learned(device, card: str) -> None:
    """The learned recipe (``q_learned_r5_s2025``'s config): the gamma
    network fitted to the polynomial table over 6000 steps on the card from
    JAX's initial parameters (the fixture), its alpha table within
    ``GAMMA_FIT_ATOL`` of JAX's fit; then one epoch with the gamma boundary
    term from a fresh denoiser: gamma gradients nonzero, loss finite."""
    import numpy as np
    import torch

    from diffusion_model_tpu_torch.data.batch import collate
    from diffusion_model_tpu_torch.data.split import (
        device_batch_iterator,
        split_dataset,
    )
    from diffusion_model_tpu_torch.diffusion.process import (
        learned_schedule,
        predefined_schedule,
    )
    from diffusion_model_tpu_torch.nn.gamma import (
        GammaNetwork,
        fit_gamma_to_schedule,
    )
    from diffusion_model_tpu_torch.train.checkpoint import load_config_npz
    from diffusion_model_tpu_torch.train.loss import TrainNoise
    from diffusion_model_tpu_torch.train.trainer import Trainer, TrainState

    with np.load(TRAIN_FIXTURE) as z:
        fx = {k: z[k] for k in z.files}
    cfg = load_config_npz(str(LEARNED))
    gamma = GammaNetwork(device=device)
    gamma.load_state_dict({
        k[len("gamma_init_"):].replace("/", "."): torch.from_numpy(v)
        for k, v in fx.items() if k.startswith("gamma_init_")})
    t0 = time.perf_counter()
    fit_err = fit_gamma_to_schedule(gamma, predefined_schedule(
        cfg, device=device).alphas)
    fit_s = time.perf_counter() - t0
    with torch.no_grad():
        alphas = learned_schedule(gamma, cfg.num_diffusion_timestep).alphas
    off = float(np.abs(alphas.cpu().numpy() - fx["gamma_fit_alphas"]).max())
    if not off <= GAMMA_FIT_ATOL:
        raise AssertionError(f"gamma fit off JAX's by {off}")
    trainer = Trainer(cfg, device=device)
    state = trainer.init_state(cfg.seed, skip_gamma_fit=True)
    with torch.no_grad():
        for name, p in trainer.gamma.named_parameters():
            p.copy_(dict(gamma.named_parameters())[name])
    state = TrainState(state.params, trainer.optimizer.init(state.params))
    train = split_dataset(flagship_graphs(cfg), cfg.seed)[0]
    data = collate(train, cfg.n_max, device)
    noise = TrainNoise((cfg.seed, 0, 0), device)
    batch = next(device_batch_iterator(data, cfg.batch_size, seed=cfg.seed))
    loss, _, _, grads = trainer.loss_and_grads(state, noise, batch)
    gamma_grads = {k: float(g.norm()) for k, g in grads.items()
                   if k.startswith("gamma.")}
    state, train_loss = trainer.train_epoch(
        state, noise, device_batch_iterator(data, cfg.batch_size,
                                            seed=cfg.seed))
    rec = {"phase": "train_learned", "card": card, "fit_steps": 6000,
           "fit_s": fit_s, "fit_max_alpha2_err": fit_err,
           "alpha_off_jax_fit": off, "tolerance": GAMMA_FIT_ATOL,
           "first_loss": float(loss), "gamma_grad_norms": gamma_grads,
           "epoch_train_loss": train_loss, "steps": state.step}
    log(rec)
    if not (sum(gamma_grads.values()) > 0 and np.isfinite(float(loss))
            and np.isfinite(train_loss)):
        raise AssertionError(f"learned recipe: {rec}")


def counting_model(cfg, params: dict, device):
    """(denoiser, calls): a model holding ``params`` whose forward calls
    are counted in ``calls[0]``."""
    from diffusion_model_tpu_torch import api

    model = api.denoiser_from_params(cfg, params, device)
    calls = [0]
    model.register_forward_pre_hook(lambda *_: calls.__setitem__(
        0, calls[0] + 1))
    return model, calls


def reset_counts() -> None:
    from diffusion_model_tpu_torch.nn import egnn
    from diffusion_model_tpu_torch.ops import egcl_knn, egcl_pair

    egcl_pair.egcl_pair_launches = egcl_knn.egcl_knn_launches = 0
    egnn.plain_edge_calls = 0


def read_counts() -> dict:
    import torch

    from diffusion_model_tpu_torch.nn import egnn
    from diffusion_model_tpu_torch.ops import egcl_knn, egcl_pair

    torch.cuda.synchronize()
    return {"egcl_pair": egcl_pair.egcl_pair_launches,
            "egcl_knn": egcl_knn.egcl_knn_launches,
            "plain_edge_calls": egnn.plain_edge_calls}


def phase_heads_output(cfg, params, fx, device, mode: str) -> dict:
    """The flagship's weights read as an ``mode`` head, bf16, dense: one
    denoiser call through K1 against the same call through the plain
    statement, at t in ``HEAD_T``: the raw output held to K1's bf16
    tolerance (relative L2 1e-2), the converted output's gap printed
    beside alpha/sigma at that t."""
    from diffusion_model_tpu_torch import api
    from diffusion_model_tpu_torch.diffusion.process import (
        head_out_to_eps,
        predefined_schedule,
    )

    cfg = cfg.replace(x_parameterization=mode)
    plain_fn = kernel_table()["egcl_pair"][1]
    kernel = api.denoiser_from_params(cfg, params, device)
    plain = api.denoiser_from_params(cfg, params, device, edge_fn=plain_fn)
    schedule = predefined_schedule(cfg, device=device)
    species, pos, spectrum, exo, _, mask = served_inputs(fx)
    rows = {}
    for t in HEAD_T:
        t_norm = mask.unsqueeze(-1) * (t / cfg.num_diffusion_timestep)
        args = (species, pos, spectrum, exo, t_norm, mask, None)
        reset_counts()
        kx, kh = kernel(*args)
        k1 = read_counts()
        px, ph = plain(*args)
        raw = max(rel_l2(kx, px), rel_l2(kh, ph))
        conv = rel_l2(head_out_to_eps(cfg, schedule, t, pos, kx),
                      head_out_to_eps(cfg, schedule, t, pos, px))
        alpha, sigma = float(schedule.alpha(t)), float(schedule.sigma(t))
        rows[str(t)] = {"raw_rel_l2": raw, "converted_rel_l2": conv,
                        "alpha_over_sigma": alpha / sigma,
                        "egcl_pair_launches": k1["egcl_pair"]}
        if not raw <= 1e-2:
            raise AssertionError(f"{mode} head, t={t}: K1's output off the "
                                 f"plain statement's: {rows[str(t)]}")
        if k1 != {"egcl_pair": cfg.L, "egcl_knn": 0, "plain_edge_calls": 0}:
            raise AssertionError(f"{mode} head, t={t}: counts {k1}")
    return {"tolerance": "raw output relative L2 1e-2", "t": rows}


def scored(out: dict, device) -> dict:
    """``restore_check.score`` of a result with accepted samples, and its
    finite fraction."""
    from diffusion_model_tpu_torch.evals.restore_check import score

    if not out["accepted"].any():
        return {"finite_fraction": float(out["finite"].mean()),
                "accepted": 0}
    return score(out, GEN_PER_CONDITION, device) | {
        "accepted": int(out["accepted"].sum())}


def phase_heads_train(device, graphs: list, mode: str,
                      epochs: int = HEAD_EPOCHS, sampled: bool = True) -> dict:
    """The flagship's recipe with an ``mode`` head through ``api.train``
    from a fresh init, bf16, dense K1, ``epochs`` epochs: a finite loss
    that falls (the last 10 epochs' mean under the first 10's); then, if
    ``sampled``, the 27 test conditions x 5 sampled at 250 strided and at
    1000 steps through K1 (one round, no retry), scored; no gate on the
    scores (the repo holds no record of this recipe with a head)."""
    import json
    import shutil

    import numpy as np
    import torch

    from diffusion_model_tpu_torch import api
    from diffusion_model_tpu_torch.train.checkpoint import load_config_npz
    from diffusion_model_tpu_torch.train.trainer import params_tree

    cfg = load_config_npz(str(SNAPSHOT)).replace(x_parameterization=mode)
    run_dir = TRAIN_RUN / f"head_{mode}"
    shutil.rmtree(run_dir, ignore_errors=True)
    reset_counts()
    t0 = time.perf_counter()
    _, state, _ = api.train(cfg, flagship_graphs(cfg), str(run_dir),
                            num_epochs=epochs, device=device)
    counts = read_counts()
    wall = time.perf_counter() - t0
    lines = [json.loads(x) for x in open(run_dir / "metrics.jsonl")]
    loss = [r["train_loss"] for r in lines if "train_loss" in r]
    epoch_s = [r["epoch_s"] for r in lines if "epoch_s" in r]
    rec = {"mode": mode, "epochs": len(loss),
           "loss_at": {str(e): loss[e] for e in (0, 50, 100, epochs - 1)
                       if e < len(loss)},
           "loss_first10_mean": float(np.mean(loss[:10])),
           "loss_last10_mean": float(np.mean(loss[-10:])),
           "train_counts": counts, "train_wall_s": wall,
           "epoch_s_median": (float(np.median(epoch_s)) if epoch_s
                              else None)}
    if len(loss) != epochs or not np.isfinite(loss).all():
        raise AssertionError(f"{mode} head training: {rec}")
    if not rec["loss_last10_mean"] < rec["loss_first10_mean"]:
        raise AssertionError(f"{mode} head: the loss did not fall: {rec}")
    if counts["egcl_knn"] or counts["plain_edge_calls"] or \
            not counts["egcl_pair"]:
        raise AssertionError(f"{mode} head training counts: {counts}")
    if not sampled:
        return rec
    params = params_tree(state.eval_params(cfg))
    for steps in (250, 1000):
        scfg = cfg.replace(max_nan_retries=0, sample_steps=(
            0 if steps == cfg.num_diffusion_timestep else steps))
        model, calls = counting_model(scfg, params, device)
        reset_counts()
        t0 = time.perf_counter()
        out = api.generate(scfg, model, graphs,
                           torch.Generator(device=device).manual_seed(
                               cfg.seed),
                           gen_num_per_spectrum=GEN_PER_CONDITION,
                           batch_size=GEN_BATCH)
        counts = read_counts()
        rec[f"sample_{steps}"] = {
            "wall_s": time.perf_counter() - t0,
            **scored(out, device), **counts, "denoiser_calls": calls[0]}
        if counts != {"egcl_pair": cfg.L * calls[0], "egcl_knn": 0,
                      "plain_edge_calls": 0} or \
                calls[0] != 2 * (steps + 1):
            raise AssertionError(f"{mode} head sampling counts: {rec}")
    return rec


def phase_heads_large_cell(cfg, device, mode: str) -> dict:
    """The large cell's configuration (``phase_large_cell``: kNN-32,
    virtual node, residual update, 2048 atoms) with an ``mode`` head, from
    a fresh init of the flagship's recipe: one train step (finite loss) and
    one 250-step strided sample from the stepped weights, every EGCL
    through K2. The sample's finiteness is recorded, not required: no
    weights of this configuration are trained, and its chains leave the
    finite range within 25 steps for every head, eps included, from a
    fresh init or from the flagship's weights alike (PERF.md section 6)."""
    import torch

    from diffusion_model_tpu_torch import api
    from diffusion_model_tpu_torch.data.batch import collate
    from diffusion_model_tpu_torch.data.synthetic import amorphous_cell
    from diffusion_model_tpu_torch.diffusion.process import (
        predefined_schedule,
    )
    from diffusion_model_tpu_torch.diffusion.sampler import sample
    from diffusion_model_tpu_torch.train.loss import TrainNoise
    from diffusion_model_tpu_torch.train.trainer import Trainer, params_tree

    cfg = cfg.replace(neighbor_k=LARGE_K, virtual_node=True, h_residual=True,
                      n_max=LARGE_ATOMS, x_parameterization=mode,
                      batch_size=1)
    cell = collate([amorphous_cell(seed=0, num_atoms=LARGE_ATOMS)],
                   LARGE_ATOMS, device)
    trainer = Trainer(cfg, device=device)
    state = trainer.init_state(cfg.seed)
    reset_counts()
    state, m = trainer.train_step(state, TrainNoise((cfg.seed, 12), device),
                                  cell)
    train = read_counts()
    model, calls = counting_model(cfg, params_tree(state.eval_params(cfg)),
                                  device)
    reset_counts()
    t0 = time.perf_counter()
    res = sample(model, predefined_schedule(cfg, device=device),
                 cfg.replace(sample_steps=250),
                 torch.Generator(device=device).manual_seed(0), cell)
    counts = read_counts()
    rec = {"mode": mode, "loss": float(m["loss"]),
           "grad_norm": float(m["grad_norm"]), "train_counts": train,
           "sample_250_s": time.perf_counter() - t0,
           "sample_finite": bool(res.finite.all()),
           "sample_max_abs_pos": float(res.pos.abs().max()),
           "sample_counts": counts,
           "denoiser_calls": calls[0]}
    if not torch.isfinite(m["loss"]):
        raise AssertionError(f"{mode} head, large cell: {rec}")
    if train != {"egcl_pair": 0, "egcl_knn": cfg.L, "plain_edge_calls": 0} \
            or counts != {"egcl_pair": 0, "egcl_knn": cfg.L * 251,
                          "plain_edge_calls": 0}:
        raise AssertionError(f"{mode} head, large cell counts: {rec}")
    return rec


def phase_heads(cfg, params, fx, graphs, device, card: str) -> dict:
    """The x0 and v coordinate heads on the card: the converted output
    through K1 against the plain statement, the flagship's recipe trained
    and sampled with each head, and the large cell's kNN route through K2.
    Returns the K1 and K2 launches of the phase."""
    # the eps recipe's epoch on the same card, beside the heads'
    base = phase_heads_train(device, graphs, "eps", HEAD_BASELINE_EPOCHS,
                             sampled=False)
    log({"phase": "heads_eps_train_baseline", "card": card, **base})
    large = phase_heads_large_cell(cfg, device, "eps")
    log({"phase": "heads_eps_large_cell_baseline", "card": card, **large})
    launches = {"egcl_pair": base["train_counts"]["egcl_pair"],
                "egcl_knn": large["train_counts"]["egcl_knn"]
                + large["sample_counts"]["egcl_knn"]}
    for mode in HEAD_MODES:
        rec = {}
        for part, run in (
                ("output", lambda: phase_heads_output(cfg, params, fx,
                                                      device, mode)),
                ("train", lambda: phase_heads_train(device, graphs, mode)),
                ("large_cell", lambda: phase_heads_large_cell(cfg, device,
                                                              mode))):
            rec[part] = run()
            log({"phase": f"heads_{mode}_{part}", "card": card,
                 **rec[part]})
        for part in (rec["train"]["train_counts"],
                     rec["train"]["sample_250"], rec["train"]["sample_1000"],
                     rec["large_cell"]["train_counts"],
                     rec["large_cell"]["sample_counts"]):
            for k in launches:
                launches[k] += part[k]
        launches["egcl_pair"] += cfg.L * len(HEAD_T)
    log({"phase": "heads", "card": card, "launches": launches})
    return launches


def variant_cfg(cfg, name: str):
    """The flagship's config as the sweep's arm ``name``: kNN-32, virtual
    node, residual update, cells of up to 192 atoms, and the variant."""
    return cfg.replace(neighbor_k=LARGE_K, virtual_node=True, h_residual=True,
                       n_max=VARIANT_ATOMS, **VARIANTS[name])


def variant_params(params: dict, cfg, seed: int = 0) -> dict:
    """The flagship's EGCL weights with seeded arrays for what the variant
    adds, every one non-zero (zero, either feature is an exact no-op): a
    radius row in each first layer's i- and j-blocks and in ``mlp_h_dense0``,
    a radius output channel of ``mlp_h_dense1`` (the column after exO), and
    the gate; ``rbf_m`` / ``rbf_x``; the virtual node's arrays
    (``with_vnode_params``). Speed and routes only: no weights of either
    variant are trained."""
    import numpy as np

    rng = np.random.default_rng(seed)
    den = dict(params["denoiser"]["params"])
    egnn = dict(den["egnn"])
    if cfg.global_radius_feature:
        h = cfg.h_size - 1                   # the flagship's node width
        col = h - cfg.t_size                 # the radius sits before t/T

        def row(width, fan_in):
            return rng.normal(size=width) * fan_in ** -0.5

        for l in range(cfg.L):
            layer = {k: dict(v) for k, v in egnn[f"egcl_{l}"].items()}
            for name in ("mlp_m_dense0", "mlp_x_dense0"):
                k = layer[name]["kernel"]
                f, fan = k.shape[1], k.shape[0]
                layer[name]["kernel"] = np.concatenate([
                    np.insert(k[:h], col, row(f, fan), axis=0),
                    np.insert(k[h:2 * h], col, row(f, fan), axis=0),
                    k[2 * h:]]).astype(np.float32)
            k = layer["mlp_h_dense0"]["kernel"]
            layer["mlp_h_dense0"]["kernel"] = np.insert(
                k, col, row(k.shape[1], k.shape[0]), axis=0).astype(
                    np.float32)
            k = layer["mlp_h_dense1"]["kernel"]
            layer["mlp_h_dense1"]["kernel"] = np.insert(
                k, col, row(k.shape[0], k.shape[0]), axis=1).astype(
                    np.float32)
            layer["mlp_h_dense1"]["bias"] = np.insert(
                layer["mlp_h_dense1"]["bias"], col, 0.0).astype(np.float32)
            egnn[f"egcl_{l}"] = layer
        den["radius_feature_gate"] = rng.uniform(0.5, 1.0, 1).astype(
            np.float32)
    if cfg.edge_rbf:
        for l in range(cfg.L):
            layer = dict(egnn[f"egcl_{l}"])
            for name, width in (("rbf_m", cfg.m_hidden_size),
                                ("rbf_x", cfg.x_hidden_size)):
                layer[name] = {"kernel": (rng.normal(
                    size=(cfg.edge_rbf, width)) * cfg.edge_rbf ** -0.5
                ).astype(np.float32)}
            egnn[f"egcl_{l}"] = layer
    den["egnn"] = egnn
    return with_vnode_params(dict(params, denoiser={"params": den}), cfg,
                             seed + 1)


def network_cells(cfg, count: int, atoms: tuple, seed: int = 100) -> list:
    """``count`` network cells (``amorphous_network_cell``, the lever
    sweep's data) of ``atoms[0]``-``atoms[1]`` atoms, sizes from the
    config's seed."""
    import numpy as np

    from diffusion_model_tpu_torch.data.synthetic import (
        amorphous_network_cell,
    )

    sizes = np.random.default_rng(cfg.seed).integers(
        atoms[0], atoms[1] + 1, size=count)
    return [amorphous_network_cell(seed=seed + i, num_atoms=int(n),
                                   spectrum_size=cfg.spectrum_size)
            for i, n in enumerate(sizes)]


def variant_forward(name: str, cfg, params, device) -> dict:
    """The model's denoiser on 2 x 192 kNN-32 cells and on 80 x 16 dense
    graphs. An rbf model on the card (its plain route) against the port on
    the CPU, float32, at phase 10b's tolerance. A radius model: its K1 / K2
    call of layer 0 (node width 37, the radius column in h) against the
    plain statement on the same inputs at the kernel gates, float32 and
    bf16, as phase 6 holds the large cells; the deeper layers' errors
    reported beside their m_sum scale (with the flagship's weights on these
    graphs the deeper layers gate their messages off, m_sum falling to
    1e-5-1e-2 of the layer before, and a relative gate there reads the
    rounding of the inputs: the bf16 tile's SiLU errs by ~2.5e-4 |v| where
    silu(v) is ~0); and one bf16 call of the model through the kernels
    beside the call through the plain statement (relative L2 of each
    output, reported: it compounds those deeper layers). Returns the record and the kernels' launches in the model's own calls
    (the per-layer comparisons excluded)."""
    import torch

    from diffusion_model_tpu_torch import api
    from diffusion_model_tpu_torch.data.synthetic import amorphous_cell
    from diffusion_model_tpu_torch.ops.edges import knn_edges

    cells = [amorphous_cell(seed=s, num_atoms=VARIANT_ATOMS,
                            spectrum_size=cfg.spectrum_size) for s in (0, 1)]
    shapes = {"2x192_knn32": (cfg, cell_inputs(cells, device)),
              "80x16_dense": (cfg.replace(neighbor_k=0, n_max=16), [
                  a.to(device) for a in seeded_inputs(
                      cfg.replace(n_max=16), GEN_BATCH * GEN_PER_CONDITION,
                      0.5)])}
    rec, launches = {}, {"egcl_pair": 0, "egcl_knn": 0}
    for shape, (scfg, inputs) in shapes.items():
        k = scfg.neighbor_k
        edges = knn_edges(inputs[1], inputs[5], k) if k else None
        kernel = "egcl_knn" if k else "egcl_pair"
        row = {}
        if name == "rbf":
            f32 = scfg.replace(compute_dtype="float32")
            card = api.denoiser_from_params(f32, params, device)
            cpu = api.denoiser_from_params(f32, params, "cpu")
            reset_counts()
            got = card(*inputs, edges)
            counts = read_counts()
            want = cpu(*(a.cpu() for a in inputs),
                       None if edges is None else tuple(
                           e.cpu() for e in edges))
            scale = max(float(w.abs().max()) for w in want)
            for g, w in zip(got, want):
                torch.testing.assert_close(g.cpu(), w, rtol=2e-4,
                                           atol=2e-5 * scale)
            row = {"card_vs_cpu_max_abs_err_over_scale": max(
                float((g.cpu() - w).abs().max()) / scale
                for g, w in zip(got, want)), "counts": counts,
                "tolerance": "float32 rtol 2e-4 / atol 2e-5 of the scale"}
            if counts != {"egcl_pair": 0, "egcl_knn": 0,
                          "plain_edge_calls": cfg.L}:
                raise AssertionError(f"rbf {shape}: counts {counts}")
        else:
            for dt in ("float32", "bfloat16"):
                args = capture_edge_inputs(scfg.replace(compute_dtype=dt),
                                           params, device, *inputs, k)
                layers = []
                for l, a in enumerate(args):
                    err = (check_kernel(kernel, a, dt) if l == 0 else
                           {"gated": False, **ungated_error(kernel, a)})
                    err["m_sum_scale"] = float(kernel_table()[kernel][1](
                        *a)[0].abs().max())
                    layers.append({key: err[key] for key in err if key in (
                        "max_abs_err", "rel_l2_m_sum", "rel_l2_x_update",
                        "m_sum_scale", "gated")})
                row[dt] = layers
            fast = api.denoiser_from_params(scfg, params, device)
            plain = api.denoiser_from_params(
                scfg, params, device, edge_fn=kernel_table()["egcl_pair"][1],
                knn_edge_fn=kernel_table()["egcl_knn"][1])
            reset_counts()
            got = fast(*inputs, edges)
            counts = read_counts()
            want = plain(*inputs, edges)
            # reported: the whole model compounds the deeper layers' input
            # rounding through the node MLPs (above)
            row["model_rel_l2"] = {"eps_x": rel_l2(got[0], want[0]),
                                   "eps_h": rel_l2(got[1], want[1])}
            row["counts"] = counts
            if counts != {"egcl_pair": 0, "egcl_knn": 0, kernel: cfg.L,
                          "plain_edge_calls": 0}:
                raise AssertionError(f"radius {shape}: counts {counts}")
            launches[kernel] += counts[kernel]
        rec[shape] = row
    if name == "radius":
        rec["tolerance"] = ("layer 0 at the kernel gates: float32 rtol 2e-4 "
                            "/ atol 2e-5, bf16 relative L2 1e-2 (m_sum, x "
                            "update)")
    return rec, launches


def ungated_error(name: str, args) -> dict:
    """``check_kernel``'s numbers without its gates."""
    kernel, plain, xi, _ = kernel_table()[name]
    got_m, got_x = kernel(*args)
    want_m, want_x = plain(*args)
    return {"max_abs_err": max(float((got_m - want_m).abs().max()),
                               float((got_x - want_x).abs().max())),
            "rel_l2_m_sum": rel_l2(got_m, want_m),
            "rel_l2_x_update": rel_l2(got_x - args[xi], want_x - args[xi])}


def variant_sampling(name: str, cfg, params, device) -> dict:
    """One 192-atom cell, B=1, ``VARIANT_STEPS`` uniform strided steps: s
    per structure, atoms x steps / s, finiteness (reported, not required),
    and the routes: an rbf model's every EGCL through the plain statement,
    a radius model's through K2."""
    from diffusion_model_tpu_torch.data.batch import collate
    from diffusion_model_tpu_torch.data.synthetic import amorphous_cell
    from diffusion_model_tpu_torch.diffusion.process import (
        predefined_schedule,
    )

    cond = collate([amorphous_cell(seed=0, num_atoms=VARIANT_ATOMS,
                                   spectrum_size=cfg.spectrum_size)],
                   VARIANT_ATOMS, device)
    model, calls = counting_model(cfg, params, device)
    schedule = predefined_schedule(cfg, device=device)
    time_sample(model, schedule, cfg, cond, 2)
    reset_counts()
    calls[0] = 0
    sec, finite = time_sample(model, schedule, cfg, cond, VARIANT_STEPS)
    counts = read_counts()
    want = ({"egcl_pair": 0, "egcl_knn": 0, "plain_edge_calls":
             cfg.L * calls[0]} if name == "rbf" else
            {"egcl_pair": 0, "egcl_knn": cfg.L * calls[0],
             "plain_edge_calls": 0})
    rec = {"steps": VARIANT_STEPS, "grid": "uniform", "s_per_structure": sec,
           "atoms_steps_per_s": VARIANT_ATOMS * VARIANT_STEPS / sec,
           "finite": finite, "denoiser_calls": calls[0], "counts": counts}
    if calls[0] != VARIANT_STEPS + 1 or counts != want:
        raise AssertionError(f"{name} sampling: {rec}, want {want}")
    return rec


def variant_training(name: str, cfg, params, device) -> dict:
    """``VARIANT_TRAIN_STEPS`` train steps of the recipe from ``params`` on
    ``VARIANT_TRAIN_B`` cells of 160-192 atoms, the batch halved until it
    fits the card and the cut recorded: each loss finite; ms a step (CUDA
    events) and the host's time in the call, peak memory; one more step
    under ``torch.profiler`` for the device's busy time, against the
    steady steps' ms (the device's idle share); the routes (rbf: the plain
    statement under autograd; radius: ``EdgeFunction`` over K2)."""
    import torch

    cfg = cfg.replace(lr=2e-4, max_grad_norm=1.0)
    batch = VARIANT_TRAIN_B
    while True:
        try:
            rec = variant_steps(name, cfg.replace(batch_size=batch), params,
                                device)
            rec["batch"] = batch
            rec["batch_cut_from"] = (VARIANT_TRAIN_B if batch < VARIANT_TRAIN_B
                                     else None)
            return rec
        except torch.cuda.OutOfMemoryError:
            if batch == 1:
                raise
            torch.cuda.empty_cache()
            batch //= 2


def timed_steps(trainer, state, cells, device, count: int) -> dict:
    """``count`` train steps of ``trainer`` from ``state`` on the batch
    ``cells``: each loss and gradient norm, ms (CUDA events) and the host's
    time in the call; peak memory; one more step under ``torch.profiler``
    for the device's busy time, against the steady steps' ms (the device's
    idle share); the kernel counts over all ``count + 1`` steps."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from diffusion_model_tpu_torch.train.loss import TrainNoise

    cfg = trainer.cfg
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    reset_counts()
    steps = []
    for i in range(count):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        state, m = trainer.train_step(
            state, TrainNoise((cfg.seed, 13, i), device), cells)
        host = time.perf_counter() - t0
        stop.record()
        torch.cuda.synchronize()
        steps.append({"loss": float(m["loss"]),
                      "grad_norm": float(m["grad_norm"]),
                      "ms": start.elapsed_time(stop),
                      "host_enqueue_ms": 1e3 * host})
    # one more step under the profiler: the device's busy time in a step
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        trainer.train_step(state, TrainNoise((cfg.seed, 13, count), device),
                           cells)
        torch.cuda.synchronize()
    busy = 1e-3 * sum(e.time_range.elapsed_us() for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA)
    steady = sum(x["ms"] for x in steps[1:]) / max(len(steps) - 1, 1)
    return {"steps": steps, "counts": read_counts(),
            "profiled_step_device_busy_ms": busy,
            "device_idle_share": max(0.0, 1.0 - busy / steady),
            "max_memory_allocated_bytes":
                torch.cuda.max_memory_allocated(device),
            "optimizer": cfg.optimizer, "lr": cfg.lr,
            "max_grad_norm": cfg.max_grad_norm}


def variant_steps(name: str, cfg, params, device) -> dict:
    from diffusion_model_tpu_torch.data.batch import collate
    from diffusion_model_tpu_torch.train.trainer import Trainer

    cells = collate(network_cells(cfg, cfg.batch_size, VARIANT_TRAIN_ATOMS),
                    cfg.n_max, device)
    trainer = Trainer(cfg, device=device)
    state = trainer.init_state(cfg.seed, params=params)
    rec = timed_steps(trainer, state, cells, device, VARIANT_TRAIN_STEPS)
    counts, steps = rec["counts"], rec["steps"]
    n = (VARIANT_TRAIN_STEPS + 1) * cfg.L
    want = ({"egcl_pair": 0, "egcl_knn": 0, "plain_edge_calls": n}
            if name == "rbf" else
            {"egcl_pair": 0, "egcl_knn": n, "plain_edge_calls": 0})
    if counts != want or not all(math.isfinite(x["loss"]) for x in steps):
        raise AssertionError(f"{name} training: {rec}, want {want}")
    return rec


def phase_variants(cfg, params, device, card: str) -> dict:
    """The radial-basis edge features and the global radius feature on the
    card at the recorded arm's full width (``VARIANTS``): for each model
    the forward checks (``variant_forward``), 250-step sampling of one
    192-atom cell and three train steps at batch 32. Returns the launches
    of K1 and K2 in the models' own calls."""
    launches = {"egcl_pair": 0, "egcl_knn": 0}
    for name in VARIANTS:
        vcfg = variant_cfg(cfg, name)
        vparams = variant_params(params, vcfg)
        forward, used = variant_forward(name, vcfg, vparams, device)
        sampling = variant_sampling(name, vcfg, vparams, device)
        training = variant_training(name, vcfg, vparams, device)
        for rec in (sampling, training):
            for kernel in launches:
                launches[kernel] += rec["counts"][kernel]
        for kernel in launches:
            launches[kernel] += used[kernel]
        log({"phase": f"variants_{name}", "card": card,
             "config": {**VARIANTS[name], "neighbor_k": vcfg.neighbor_k,
                        "virtual_node": True, "h_residual": True,
                        "h_size": vcfg.h_size, "L": vcfg.L,
                        "compute_dtype": vcfg.compute_dtype},
             "weights": "flagship EGCL + seeded non-zero variant arrays "
                        "(speed and routes only)",
             "forward": forward, "sampling": sampling, "training": training})
    return launches


def network_recipe(**kw):
    """The large-cell recipe as ``evals.size_gen_check`` builds it for
    ``examples/size_generalization.py``'s 512-atom network run: kNN-32,
    ``h_residual``, ``virtual_node``, ``h_init_scale`` 1e-3, L=5, 1024 /
    256, bf16, lr 2e-4, clip 1, batch 32 of 448-512 atoms; ``kw`` on top."""
    from diffusion_model_tpu_torch.evals import size_gen_check

    args = size_gen_check.parser().parse_args([
        "--generator", "network", "--train_min", str(NETWORK_ATOMS[0]),
        "--train_max", str(NETWORK_ATOMS[1]), "--neighbor_k", str(LARGE_K),
        "--batch_size", str(NETWORK_B), "--lr", "2e-4", "--max_grad_norm",
        "1", "--h_init_scale", "1e-3", "--h_residual", "--virtual_node"])
    return size_gen_check.recipe(args).replace(**kw)


def network_train(cfg, device, cells) -> tuple:
    """``NETWORK_STEPS`` timed train steps of ``cfg`` from a fresh init
    (``timed_steps``), with K1 / K2 launches and plain-route calls a step,
    and the gradients of the first step at the fresh init."""
    from diffusion_model_tpu_torch.train.loss import TrainNoise
    from diffusion_model_tpu_torch.train.trainer import Trainer

    trainer = Trainer(cfg, device=device)
    state = trainer.init_state(cfg.seed)
    loss, _, _, grads = trainer.loss_and_grads(
        state, TrainNoise((cfg.seed, 17), device), cells)
    grads = (loss, grads)
    rec = timed_steps(trainer, state, cells, device, NETWORK_STEPS)
    rec["per_step"] = {k: v / (NETWORK_STEPS + 1)
                       for k, v in rec["counts"].items()}
    rec["remat_egcl"] = cfg.remat_egcl
    rec["batch"] = cfg.batch_size
    if not all(math.isfinite(x["loss"]) for x in rec["steps"]):
        raise AssertionError(f"network recipe training: {rec}")
    return rec, grads


def phase_network_recipe(cfg, params, device, card: str) -> dict:
    """The network-cell recipe at full width on the card (``network_recipe``;
    fresh init, so speed, memory and routes only):

    (i) 32 ``amorphous_network_cell``s of 448-512 atoms, three train steps
    with ``remat_egcl`` off and three with it on (``timed_steps``): K2
    5 launches a step off, 10 on (the recompute relaunches it); the first
    step's loss and gradients equal bit for bit with and without remat;
    (ii) the ``edge_rbf=8`` arm on the plain route: with remat at batch 32
    and without at batch 8 (no configuration the reckoning puts over 70
    GB): plain calls 10 a step with remat, 5 without, K1 / K2 never;
    (iii) one 512-atom network cell at 250 uniform steps on K2 (1,255
    launches), s per structure;
    (iv) ``compat_scalar_norm`` with the flagship's weights (``cfg``,
    ``params``), dense, 80 x 16: the card's plain route against the CPU in
    float32 at phase 10b's gate, ``plain_edge_calls`` L a call and K1 never;
    one bf16 train step at batch 64 (ms, finite loss)."""
    import torch

    from diffusion_model_tpu_torch import api
    from diffusion_model_tpu_torch.data.batch import collate
    from diffusion_model_tpu_torch.data.synthetic import (
        amorphous_network_cell,
    )
    from diffusion_model_tpu_torch.diffusion.process import (
        predefined_schedule,
    )
    from diffusion_model_tpu_torch.train.trainer import Trainer, params_tree

    base = network_recipe()
    rec = {"phase": "network_recipe", "card": card,
           "config": {k: getattr(base, k) for k in (
               "L", "m_hidden_size", "m_size", "neighbor_k", "h_residual",
               "virtual_node", "h_init_scale", "compute_dtype", "lr",
               "max_grad_norm", "batch_size", "n_max", "h_size")},
           "weights": "fresh init (i-iii); flagship (iv)"}
    t0 = time.perf_counter()
    cells = network_cells(base, NETWORK_B, NETWORK_ATOMS, seed=300)
    rec["cells_s"] = time.perf_counter() - t0
    rec["atoms"] = [int(len(c["pos"])) for c in cells]
    batch = collate(cells, base.n_max, device)

    # (i) the recipe with and without remat
    arms, grads = {}, {}
    for remat in (False, True):
        name = "remat" if remat else "no_remat"
        arms[name], grads[name] = network_train(
            base.replace(remat_egcl=remat), device, batch)
        want = {"egcl_pair": 0, "egcl_knn": base.L * (2 if remat else 1),
                "plain_edge_calls": 0}
        if arms[name]["per_step"] != want:
            raise AssertionError(f"network recipe {name}: "
                                 f"{arms[name]['per_step']}, want {want}")
    (loss, g), (r_loss, r_g) = grads["no_remat"], grads["remat"]
    differ = [k for k in g if not torch.equal(g[k], r_g[k])]
    rec["remat_first_step"] = {"loss": float(loss), "loss_equal": bool(
        torch.equal(loss, r_loss)), "leaves": len(g), "leaves_differ": differ}
    if differ or not torch.equal(loss, r_loss):
        raise AssertionError(f"remat changed the first step: {differ}")
    del grads, g, r_g
    rec["recipe_512"] = arms

    # (ii) the rbf arm on the plain route
    rbf = {}
    for remat, b in RBF_BATCH.items():
        rcfg = base.replace(edge_rbf=8, edge_rbf_rmax=8.0, remat_egcl=remat,
                            batch_size=b)
        sub = collate(cells[:b], base.n_max, device)
        rbf[f"remat_b{b}" if remat else f"no_remat_b{b}"] = arm = \
            network_train(rcfg, device, sub)[0]
        want = {"egcl_pair": 0, "egcl_knn": 0,
                "plain_edge_calls": base.L * (2 if remat else 1)}
        if arm["per_step"] != want:
            raise AssertionError(f"rbf arm: {arm['per_step']}, want {want}")
    rec["rbf_plain_route"] = rbf
    torch.cuda.empty_cache()

    # (iii) sampling one 512-atom network cell at 250 steps
    scfg = base.replace(n_max=NETWORK_ATOMS[1])
    trainer = Trainer(scfg, device=device)
    fresh = params_tree(trainer.init_state(scfg.seed).eval_params(scfg))
    model, calls = counting_model(scfg, fresh, device)
    cond = collate([amorphous_network_cell(
        seed=0, num_atoms=NETWORK_ATOMS[1],
        spectrum_size=scfg.spectrum_size)], NETWORK_ATOMS[1], device)
    schedule = predefined_schedule(scfg, device=device)
    time_sample(model, schedule, scfg, cond, 2)
    reset_counts()
    calls[0] = 0
    sec, finite = time_sample(model, schedule, scfg, cond, VARIANT_STEPS)
    counts = read_counts()
    rec["sampling_512"] = {"steps": VARIANT_STEPS, "grid": "uniform",
                           "s_per_structure": sec,
                           "atoms_steps_per_s":
                               NETWORK_ATOMS[1] * VARIANT_STEPS / sec,
                           "finite": finite, "denoiser_calls": calls[0],
                           "counts": counts}
    want = {"egcl_pair": 0, "egcl_knn": scfg.L * (VARIANT_STEPS + 1),
            "plain_edge_calls": 0}
    if counts != want or calls[0] != VARIANT_STEPS + 1:
        raise AssertionError(f"network sampling: {counts}, want {want}")
    del model, trainer

    # (iv) compat_scalar_norm on the flagship, dense
    ccfg = cfg.replace(compat_scalar_norm=True)
    f32 = ccfg.replace(compute_dtype="float32")
    card_model = api.denoiser_from_params(f32, params, device)
    cpu_model = api.denoiser_from_params(f32, params, "cpu")
    worst, per_call = 0.0, []
    for i, t in enumerate(PLAIN_ROUTE_T):
        inputs = seeded_inputs(f32, GEN_BATCH * GEN_PER_CONDITION, t, i)
        reset_counts()
        got = card_model(*(a.to(device) for a in inputs), None)
        per_call.append(read_counts())
        want = cpu_model(*inputs, None)
        scale = max(float(w.abs().max()) for w in want)
        for g_, w in zip(got, want):
            torch.testing.assert_close(g_.cpu(), w, rtol=2e-4,
                                       atol=2e-5 * scale)
            worst = max(worst, float((g_.cpu() - w).abs().max()) / scale)
    if any(c != {"egcl_pair": 0, "egcl_knn": 0, "plain_edge_calls": cfg.L}
           for c in per_call):
        raise AssertionError(f"compat forward: counts {per_call}")
    trainer = Trainer(ccfg, device=device)
    state = trainer.init_state(ccfg.seed, params=params)
    graphs = collate(flagship_graphs(ccfg)[:TRAIN_B], ccfg.n_max, device)
    steps = timed_steps(trainer, state, graphs, device, 2)
    if steps["counts"]["egcl_pair"] or not all(
            math.isfinite(x["loss"]) for x in steps["steps"]):
        raise AssertionError(f"compat train step: {steps}")
    rec["compat_scalar_norm"] = {
        "batch": GEN_BATCH * GEN_PER_CONDITION, "n_max": cfg.n_max,
        "card_vs_cpu_max_abs_err_over_scale": worst,
        "tolerance": "float32 rtol 2e-4 / atol 2e-5 of the output scale",
        "counts_per_call": per_call[0],
        "train_batch": TRAIN_B, "train": steps}
    log(rec)


def phase_strided_scores(device, card: str) -> int:
    """Both snapshots, bf16, dense K1, 27 x 5 at 250 uniform strided steps,
    at the seeds of the JAX package's 250-step run
    (``tests/fixtures/torch_port/jax_strided_250.json``): each mean rdf_cos
    within 3 sqrt(2) sigma of JAX's mean over its keys from the same npz
    (sigma ``STRIDED_SIGMA``); the angle R^2 (beside F4) and the
    atom_type_accuracy (beside F7) logged, not gated; the 1000-step scores
    at the same seeds printed beside them. Returns the K1 launches of the
    250-step runs."""
    import json

    import numpy as np

    from diffusion_model_tpu_torch.evals.restore_check import restore_check

    fx = json.loads(STRIDED_FIXTURE.read_text())
    rows = {}
    launches = 0
    for jrow in fx["rows"]:
        npz, seed = jrow["npz"], jrow["seed"]
        jax_mean = float(np.mean([r["rdf_cos_mean"] for r in fx["rows"]
                                  if r["npz"] == npz]))
        reset_counts()
        got = restore_check(str(ROOT / npz), device, NUM_GRAPHS, SHELLS,
                            seed=seed, sample_steps=fx["sample_steps"],
                            sample_grid=fx["sample_grid"])
        counts = read_counts()
        launches += counts["egcl_pair"]
        full = restore_check(str(ROOT / npz), device, NUM_GRAPHS, SHELLS,
                             seed=seed)
        keys = ("accepted", "rdf_cos_mean", "rdf_cos_median",
                "cn2_angle_r2", "atom_type_accuracy", "gen_seconds")
        row = {"port_250": {k: got[k] for k in keys}, "counts_250": counts,
               "port_1000": {k: full[k] for k in keys},
               "jax_250": {k: jrow[k] for k in keys[:-1]},
               "jax_250_mean_rdf_cos_over_keys": jax_mean,
               "gap": got["rdf_cos_mean"] - jax_mean,
               "gate": STRIDED_GATE,
               "notes": {"cn2_angle_r2": LEARNED_R2_FAULT
                         if "learned" in npz else "logged",
                         "atom_type_accuracy": EVALUATE_FAULT[
                             "atom_type_accuracy"]}}
        rows[f"{Path(npz).stem}@{seed}"] = row
        if got["sample_steps"] != 250 or got["compute_dtype"] != "bfloat16":
            raise AssertionError(f"strided scoring ran {got}")
        if counts["egcl_knn"] or counts["plain_edge_calls"] or \
                counts["egcl_pair"] < 2 * 251 * 5:
            raise AssertionError(f"strided scoring counts: {counts}")
        if not abs(row["gap"]) <= STRIDED_GATE:
            raise AssertionError(f"{npz} at seed {seed}: 250-step rdf_cos "
                                 f"off JAX's 250-step mean: {row}")
    log({"phase": "strided_scores", "card": card, "steps": 250,
         "grid": fx["sample_grid"], "rows": rows,
         "jax_fixture": str(STRIDED_FIXTURE.relative_to(ROOT))})
    return launches


class CpuDraws:
    """A training noise source whose draws are ``TrainNoise(seed, "cpu")``'s,
    moved to ``device``: the same draws on the card and on the CPU."""

    def __init__(self, seed, device):
        from diffusion_model_tpu_torch.train.loss import TrainNoise

        self.src, self.device = TrainNoise(seed, "cpu"), device

    def randint(self, stream, low, high, shape):
        return self.src.randint(stream, low, high, shape).to(self.device)

    def normal(self, stream, shape):
        return self.src.normal(stream, shape).to(self.device)

    def bernoulli(self, stream, p, shape):
        return self.src.bernoulli(stream, p, shape).to(self.device)


def kabsch_step(cfg, params, batch, noise, device) -> dict:
    """One ``Trainer.train_step`` with the Kabsch loss from the flagship's
    weights: loss, ``grad_norm``, ms (CUDA events), peak memory and the
    launches of exactly that step, with the trainer and its gradients."""
    import torch

    from diffusion_model_tpu_torch.train.trainer import Trainer

    trainer = Trainer(cfg, device=device)
    state = trainer.init_state(cfg.seed, params=params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    reset_counts()
    start.record()
    state, m = trainer.train_step(state, noise, batch)
    stop.record()
    counts = read_counts()
    rec = {"kabsch_loss_steps": cfg.kabsch_loss_steps
           or cfg.num_diffusion_timestep,
           "neighbor_k": cfg.neighbor_k, "compute_dtype": cfg.compute_dtype,
           "batch": int(batch.mask.shape[0]), "loss": float(m["loss"]),
           "grad_norm": float(m["grad_norm"]),
           "ms": start.elapsed_time(stop), "launches": counts,
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(
               device),
           "memory_before_step_bytes": base}
    if not (math.isfinite(rec["loss"]) and math.isfinite(rec["grad_norm"])):
        raise AssertionError(f"the Kabsch step is not finite: {rec}")
    steps = rec["kabsch_loss_steps"]
    kernel = "egcl_knn" if cfg.neighbor_k else "egcl_pair"
    # the eps loss's forward, then each of the chain's steps + 1 calls
    # twice: the forward and the checkpoint's recompute
    want = {"egcl_pair": 0, "egcl_knn": 0, "plain_edge_calls": 0,
            kernel: cfg.L * (1 + 2 * (steps + 1))}
    if counts != want:
        raise AssertionError(f"Kabsch step launches {counts}, want {want}")
    return rec


def phase_kabsch_finetune(device, card: str) -> dict:
    """The Kabsch coordinate loss on the card from the flagship's trained
    weights (``artifacts/q_predef_r5.npz``: L=5, 1024 / 256, n_max 16, bf16,
    RAdamScheduleFree) loaded through ``Trainer.init_state(params=...)``, on
    ``KABSCH_B`` graphs of its train split, dense route (K1): one step over
    the full T=1000 chain (``kabsch_loss_steps`` 0), ``KABSCH_SHORT_STEPS``
    steps at ``KABSCH_SHORT`` strided steps, one float32 step of
    ``KABSCH_F32_STEPS`` on the card against the CPU from the same draws
    (``KABSCH_F32_B`` graphs), and the strided step on kNN-15 through K2."""
    import numpy as np
    import torch

    from diffusion_model_tpu_torch.data.batch import collate
    from diffusion_model_tpu_torch.data.split import (
        device_batch_iterator,
        split_dataset,
    )
    from diffusion_model_tpu_torch.train.checkpoint import (
        load_config_npz,
        load_params_npz,
    )
    from diffusion_model_tpu_torch.train.loss import TrainNoise
    from diffusion_model_tpu_torch.train.trainer import Trainer

    base = load_config_npz(str(SNAPSHOT)).replace(kabsch_loss=True)
    params = load_params_npz(str(SNAPSHOT))
    train = split_dataset(flagship_graphs(base), base.seed)[0]
    batch = next(device_batch_iterator(collate(train, base.n_max, device),
                                       KABSCH_B, seed=0))
    t0 = time.perf_counter()
    full = kabsch_step(base.replace(kabsch_loss_steps=0), params, batch,
                       TrainNoise((base.seed, 15, 0), device), device)
    full["wall_s"] = time.perf_counter() - t0
    short_cfg = base.replace(kabsch_loss_steps=KABSCH_SHORT)
    short = [kabsch_step(short_cfg, params, batch,
                         TrainNoise((base.seed, 15, i + 1), device), device)
             for i in range(KABSCH_SHORT_STEPS)]

    # float32, the card against the CPU from the same draws and weights
    f32 = base.replace(kabsch_loss_steps=KABSCH_F32_STEPS,
                       compute_dtype="float32")
    sides = []
    for dev in (device, torch.device("cpu")):
        trainer = Trainer(f32, device=dev)
        state = trainer.init_state(f32.seed, params=params)
        small = collate(train[:KABSCH_F32_B], base.n_max, dev)
        reset_counts()
        t0 = time.perf_counter()
        loss, _, _, grads = trainer.loss_and_grads(
            state, CpuDraws((base.seed, 16, 0), dev), small)
        counts = read_counts()
        sides.append((float(loss), grads, time.perf_counter() - t0, counts))
    (loss_card, g_card, card_s, counts), (loss_cpu, g_cpu, cpu_s, _) = sides
    want = {"egcl_pair": base.L * (1 + 2 * (KABSCH_F32_STEPS + 1)),
            "egcl_knn": 0, "plain_edge_calls": 0}
    if counts != want:
        raise AssertionError(f"float32 Kabsch launches {counts}, want "
                             f"{want}")
    leaf_gap = {k: rel_l2(g_card[k].cpu(), g)
                for k, g in g_cpu.items() if float(g.norm()) > 0}
    worst = max(leaf_gap, key=leaf_gap.get)
    parity = {"batch": KABSCH_F32_B, "loss_card": loss_card,
              "loss_cpu": loss_cpu,
              "loss_rel_gap": abs(loss_card - loss_cpu) / abs(loss_cpu),
              "largest_leaf_rel_l2": leaf_gap[worst], "largest_leaf": worst,
              "card_s": card_s, "cpu_s": cpu_s, "launches": counts}
    if not (math.isfinite(loss_card)
            and parity["loss_rel_gap"] <= KABSCH_F32_LOSS_RTOL
            and parity["largest_leaf_rel_l2"] <= KABSCH_F32_GRAD_REL):
        raise AssertionError(f"the float32 Kabsch step on the card parts "
                             f"from the CPU's: {parity}")

    knn = kabsch_step(short_cfg.replace(neighbor_k=SERVED_K), params, batch,
                      TrainNoise((base.seed, 15, 9), device), device)
    rec = {"phase": "kabsch_finetune", "card": card, "full_chain": full,
           "strided": short, "float32_strided": parity,
           "knn_strided": knn,
           "launches": {
               "egcl_pair": full["launches"]["egcl_pair"]
               + sum(s["launches"]["egcl_pair"] for s in short)
               + counts["egcl_pair"],
               "egcl_knn": knn["launches"]["egcl_knn"]}}
    log(rec)
    return rec


def phase_polymorph_pipeline(device, card: str) -> dict:
    """The real-data path on the card's machine: the SiO2 polymorph corpus
    (``write_corpus(seed=0)``, 46 samples), ``build_dataset`` at 2NN and 1NN
    with the native library built here from ``native/graphbuild.cpp`` (a
    fresh build directory) against the numpy route (the same sites in the
    same order, positions to 1e-6 A), the flagship generating
    ``GEN_PER_CONDITION`` samples for each 2NN condition at 1000 steps
    through K1 (accepted of attempted; the Si-O bond median against the
    corpus's), and ``template_match`` with the histogram descriptor on the
    card against the CPU."""
    import tempfile

    import numpy as np
    import torch

    from diffusion_model_tpu_torch import api
    from diffusion_model_tpu_torch.data import native, polymorphs
    from diffusion_model_tpu_torch.data.io import load_dataset, save_dataset
    from diffusion_model_tpu_torch.data.shells import build_dataset
    from diffusion_model_tpu_torch.evals import template
    from diffusion_model_tpu_torch.train.checkpoint import (
        load_config_npz,
        load_params_npz,
    )

    rec = {"phase": "polymorph_pipeline", "card": card}
    with tempfile.TemporaryDirectory() as tmp:
        corpus = os.path.join(tmp, "corpus")
        manifest = polymorphs.write_corpus(corpus, seed=0)
        if len(manifest) != 46:
            raise AssertionError(f"corpus of {len(manifest)} samples, "
                                 "want 46")
        # built here, in a fresh directory, not read from a checkout's cache
        build_dir = Path(tmp) / "native"
        t0 = time.perf_counter()
        native.require_library(build_dir=build_dir)
        rec["native_build_s"] = time.perf_counter() - t0
        rec["native_library"] = native.library_path(build_dir).name
        routes = {}
        for nn_range in ("2NN", "1NN"):
            nat = build_dataset(corpus, nn_range, use_native=True)
            ref = build_dataset(corpus, nn_range, use_native=False)
            gap = 0.0
            for a, b in zip(nat, ref):
                for k in ("species", "spectrum", "exo"):
                    if not np.array_equal(a[k], b[k]) or a["id"] != b["id"]:
                        raise AssertionError(
                            f"{nn_range} {b['id']}: the native route's "
                            f"{k} differs from numpy's")
                gap = max(gap, float(np.abs(a["pos"] - b["pos"]).max()))
            if len(nat) != len(ref) or gap > 1e-6:
                raise AssertionError(f"{nn_range}: native and numpy shells "
                                     f"part ({len(nat)}, {len(ref)}, {gap})")
            routes[nn_range] = {"graphs": len(nat), "atoms": sorted(
                {len(g["pos"]) for g in nat}), "max_pos_gap_A": gap}
            path = os.path.join(tmp, f"{nn_range}.npz")
            save_dataset(ref, path)
            routes[nn_range]["reloaded"] = len(load_dataset(path))
        rec["shells"] = routes
        graphs = load_dataset(os.path.join(tmp, "2NN.npz"))

    cfg = load_config_npz(str(SNAPSHOT))
    params = load_params_npz(str(SNAPSHOT))
    graphs = api.prepare_dataset(graphs, cfg)
    generator = torch.Generator(device=device).manual_seed(cfg.seed)
    t0 = time.perf_counter()
    reset_counts()
    out = api.generate(cfg, params, graphs, generator, device=device)
    counts = read_counts()
    gen_s = time.perf_counter() - t0
    chunks = -(-len(graphs) // GEN_BATCH)
    want = {"egcl_pair": chunks * 1001 * cfg.L, "egcl_knn": 0,
            "plain_edge_calls": 0}
    if counts != want:
        raise AssertionError(f"polymorph generation launches {counts}, "
                             f"want {want}")
    keep = out["accepted"]
    if not keep.any():
        raise AssertionError("no accepted polymorph sample")
    si_o = median_si_o(out["generated_pos"][keep],
                       out["generated_species"][keep], out["mask"][keep])
    si_o_corpus = median_si_o(out["original_pos"], out["original_species"],
                              out["mask"])
    rec["generate"] = {
        "conditions": len(graphs), "samples": int(len(keep)),
        "finite": int(out["finite"].sum()), "accepted": int(keep.sum()),
        "launches": counts, "wall_s": gen_s,
        "si_o_median_A": si_o, "si_o_median_corpus_A": si_o_corpus}
    if abs(si_o - si_o_corpus) > SI_O_TOLERANCE:
        raise AssertionError(f"generated Si-O median {si_o} A against the "
                             f"corpus's {si_o_corpus} A")

    match = []
    for dev in (device, torch.device("cpu")):
        t0 = time.perf_counter()
        match.append((template.template_match(graphs, graphs,
                                              descriptor="histogram",
                                              device=dev),
                      time.perf_counter() - t0))
    (card_match, card_s), (cpu_match, cpu_s) = match
    if [[list(d) for d in v] for v in card_match.values()] != \
            [[list(d) for d in v] for v in cpu_match.values()]:
        raise AssertionError("template_match ranks differently on the card")
    desc_gap, ties = 0.0, 0
    for g in graphs:
        args = [torch.as_tensor(g[k]) for k in ("pos", "species")]
        d_cpu = template.local_descriptor(*args).numpy()
        d_card = template.local_descriptor(
            *(a.to(device) for a in args)).cpu().numpy()
        desc_gap = max(desc_gap, float(np.abs(d_card[:64] - d_cpu[:64]).max()
                                       / max(np.abs(d_cpu).max(), 1e-30)))
        if not np.array_equal(d_card[64:], d_cpu[64:]):
            ties += 1
            if not angle_on_bin_edge(g["pos"]):
                raise AssertionError(f"{g['id']}: the angle histogram on "
                                     "the card differs with no bin-edge tie")
    sim_gap = max(abs(a[1] - b[1])
                  for t in cpu_match
                  for x, y in zip(card_match[t], cpu_match[t])
                  for a, b in zip(x.values(), y.values()))
    rec["template_match"] = {"targets": len(graphs), "card_s": card_s,
                             "cpu_s": cpu_s, "radial_rel_gap": desc_gap,
                             "histogram_ties": ties,
                             "similarity_gap": sim_gap}
    if desc_gap > 1e-5:
        raise AssertionError(f"descriptors part on the card: {rec}")
    log(rec)
    return rec


def phase_cli_drivers(device, card: str) -> dict:
    """The drivers through their CLIs (``diffusion_model_tpu_torch.cli``) at
    the flagship's full width: a run directory holding the snapshot's
    weights (``RunLogger``'s ``config.json`` and a checkpoint of a state
    carrying them); ``main --mode generate_only`` on ``CLI_SYNTHETIC``
    synthetic graphs (their test split, 1000 steps, K1), its
    ``generated.npz`` bit for bit ``api.generate`` called directly with the
    run's weights, config, seed and test split, every chain finite;
    ``evaluate_only`` and the evaluator CLIs on it with ``--device cuda`` and
    ``--device cpu``, their numbers held to each other (RMSDs rtol 1e-5, RDF
    and angle scores within 1e-6, the rest equal); ``make_dataset`` and
    ``template_matching`` on the polymorph corpus, card against CPU;
    ``train_only`` for ``CLI_TRAIN_EPOCHS`` epochs of the flagship's recipe
    on kNN-15 (K2 forward, ``ops.edge_grad``), its ``profile.json`` counted
    as the JAX package's loop counts; ``generate_amorphous`` on two 192-atom
    network cells with ``--panel`` (K1; the panel read, not gated) and
    ``device_trace`` around ``CLI_TRACE_STEPS`` reverse steps, its Chrome
    trace naming the K1 kernel and the ``annotate`` region, both with
    ``max_nan_retries`` 0 (the flagship's chains on 192-atom cells, and
    chains of 3 steps, leave the finite range: a redraw would repeat the
    chain ten times). Each driver's launches are counted over its own run;
    ``plain_edge_calls`` stays 0.

    Without matplotlib the drivers that draw a figure raise an
    ``ImportError`` naming it: each is listed, and its numbers are held card
    against CPU through the ported functions it calls instead."""
    import importlib.util
    import shutil

    import numpy as np
    import torch

    from diffusion_model_tpu_torch import api
    from diffusion_model_tpu_torch.cli import (
        create_xyz,
        evaluate_cn2,
        evaluate_fingerprint,
        evaluate_rdf,
        evaluate_rmsd,
        evaluate_si_o_si,
        generate_amorphous,
        main,
        make_dataset,
        template_matching,
    )
    from diffusion_model_tpu_torch.config import load_config
    from diffusion_model_tpu_torch.data import polymorphs
    from diffusion_model_tpu_torch.data.split import split_dataset
    from diffusion_model_tpu_torch.data.synthetic import (
        synthetic_sio2_dataset,
    )
    from diffusion_model_tpu_torch.evals.density import (
        density_accuracy,
        o_density,
    )
    from diffusion_model_tpu_torch.train.checkpoint import (
        load_config_npz,
        load_params_npz,
        save_checkpoint,
    )
    from diffusion_model_tpu_torch.train.trainer import Trainer, params_tree
    from diffusion_model_tpu_torch.utils.logging import RunLogger
    from diffusion_model_tpu_torch.utils.profiling import (
        annotate,
        device_trace,
    )

    t_phase = time.perf_counter()
    try:
        import matplotlib  # noqa: F401
        have_mpl = True
    except ImportError:
        have_mpl = False
    twin = load_config(str(PARAMETERS_JSON))
    log({"phase": "cli_drivers_setup", "card": card,
         "matplotlib": have_mpl,
         "pyyaml": importlib.util.find_spec("yaml") is not None,
         "parameters_json_widths": [twin.L, twin.m_hidden_size, twin.m_size]})
    shutil.rmtree(CLI_RUN, ignore_errors=True)
    cfg = load_config_npz(str(SNAPSHOT))
    rec = {"phase": "cli_drivers", "card": card, "matplotlib": have_mpl,
           "seconds": {}, "launches": {}}
    not_run = []

    def drive(name, module, argv, pair=0, knn=0, figure=False) -> bool:
        """``module.main(argv)``, timed, its launches counted and held to
        ``pair`` / ``knn`` (a count, or "some": more than none) and
        ``plain_edge_calls`` 0. Where matplotlib is missing, a driver that
        draws may end in the ImportError naming it: then False."""
        reset_counts()
        t0 = time.perf_counter()
        ran = True
        try:
            module.main([str(a) for a in argv])
        except ImportError as e:
            if have_mpl or not figure or "matplotlib" not in str(e):
                raise
            not_run.append({"driver": name, "error": str(e)})
            ran = False
        rec["seconds"][name] = time.perf_counter() - t0
        counts = rec["launches"][name] = read_counts()

        def ok(got, want):
            return got > 0 if want == "some" else got == want

        if counts["plain_edge_calls"] or not ok(counts["egcl_pair"], pair) \
                or not ok(counts["egcl_knn"], knn):
            raise AssertionError(f"{name}: launches {counts}, want K1 "
                                 f"{pair}, K2 {knn}")
        return ran

    # the run directory of the snapshot's weights
    run = CLI_RUN / "flagship"
    RunLogger(str(run), cfg)
    trainer = Trainer(cfg, device=device)
    state = trainer.init_state(cfg.seed,
                               params=load_params_npz(str(SNAPSHOT)),
                               skip_gamma_fit=True)
    save_checkpoint(str(run / "checkpoints"), state, cfg, step=0)
    del trainer, state

    # generate_only, then the same generation called directly
    card_args = ["--device", str(device)]
    synthetic = ["--synthetic", CLI_SYNTHETIC]
    graphs = api.prepare_dataset(synthetic_sio2_dataset(
        cfg.seed, CLI_SYNTHETIC, cfg.n_max, spectrum_size=cfg.spectrum_size,
        shells=2), cfg)
    test = split_dataset(graphs, cfg.seed)[2]
    chunks = -(-len(test) // GEN_BATCH)
    ran = drive("generate_only", main,
                ["--mode", "generate_only", "--run_dir", run, *synthetic,
                 *card_args], pair="some", figure=True)
    if not ran and not (run / "generated.npz").exists():
        raise AssertionError("generate_only wrote no generated.npz")
    _, loaded = api.load_trained(str(run), cfg, device)
    direct = api.generate(cfg, params_tree(loaded.eval_params(cfg)), test,
                          device=device)
    written = np.load(run / "generated.npz")
    off = [k for k in written.files if not np.array_equal(
        written[k], np.asarray(direct[k]),
        equal_nan=written[k].dtype.kind == "f")]
    rec["generate_only"] = {
        "conditions": len(test), "samples": int(len(direct["ids"])),
        "launches_without_retry": chunks * 1001 * cfg.L,
        "finite": int(direct["finite"].sum()),
        "accepted": int(direct["accepted"].sum()),
        "bit_for_bit_direct": not off, "keys_off": off}
    if off or sorted(written.files) != sorted(direct):
        raise AssertionError(f"generate_only's generated.npz is not "
                             f"api.generate's: {off}")
    if not direct["finite"].all():
        raise AssertionError(f"generate_only: {rec['generate_only']}")
    results = {k: written[k] for k in written.files}
    results["ids"] = [str(i) for i in written["ids"]]

    # the evaluators, card against CPU on copies of the run directory
    devices = {"card": str(device), "cpu": "cpu"}
    copies = {}
    for where in devices:
        d = CLI_RUN / f"eval_{where}"
        shutil.copytree(run, d, ignore=shutil.ignore_patterns("checkpoints"))
        os.symlink(run / "checkpoints", d / "checkpoints")
        RunLogger(str(d)).register_artifact("generated_graph_save_path",
                                            str(d / "generated.npz"))
        copies[where] = d
    readings, group = {}, cfg.gen_num_per_spectrum
    for name, module, argv, figure in (
            ("evaluate_only", main, ["--mode", "evaluate_only", *synthetic],
             True),
            ("evaluate_rdf", evaluate_rdf, [], True),
            ("evaluate_rmsd", evaluate_rmsd, [], True),
            ("evaluate_si_o_si", evaluate_si_o_si, [], True),
            ("create_xyz", create_xyz, [], False)):
        for where, d in copies.items():
            ran = drive(f"{name}_{where}", module,
                        [*argv, "--run_dir", d, "--device", devices[where]],
                        figure=figure)
            readings.setdefault(name, {})[where] = (
                driver_reading(name, d) if ran else figure_free_numbers(
                    name, results, torch.device(devices[where]), group))
        readings[name]["max_gap"] = same_numbers(
            readings[name]["card"], readings[name]["cpu"], name)
    for name, module in (("evaluate_cn2", evaluate_cn2),
                         ("evaluate_fingerprint", evaluate_fingerprint)):
        # numpy on the host: once, on this machine's CPU
        if drive(name, module, ["--run_dir", copies["card"]], figure=True):
            readings[name] = driver_reading(name, copies["card"])
        else:
            readings[name] = figure_free_numbers(name, results, None, group)
    rec["evaluators"] = readings

    # make_dataset and template_matching on the polymorph corpus
    corpus = CLI_RUN / "corpus"
    polymorphs.write_corpus(str(corpus), seed=0)
    drive("make_dataset", make_dataset,
          ["--range", "2NN", "--cell_dir_path", corpus, "--save_dir_path",
           CLI_RUN / "dataset"])
    matches = {}
    dataset = CLI_RUN / "dataset" / "dataset.npz"
    for where, dev in devices.items():
        out = CLI_RUN / f"template_{where}"
        drive(f"template_matching_{where}", template_matching,
              ["--reference_dataset_path", dataset, "--target_dataset_path",
               dataset, "--save_dir", out, "--device", dev])
        with open(out / "template_matching_result.json") as f:
            matches[where] = json.load(f)
    ranks = {w: [[list(r) for r in rows] for rows in m.values()]
             for w, m in matches.items()}
    mse = {w: [[list(r.values())[0][0] for r in rows]
               for rows in m.values()] for w, m in matches.items()}
    sim_gap = max(abs(list(a.values())[0][1] - list(b.values())[0][1])
                  for t in matches["cpu"]
                  for a, b in zip(matches["card"][t], matches["cpu"][t]))
    rec["template_matching"] = {"targets": len(matches["cpu"]),
                                "similarity_gap": sim_gap}
    if ranks["card"] != ranks["cpu"] or mse["card"] != mse["cpu"]:
        raise AssertionError("template_matching ranks differently on the "
                             "card")

    # train_only on kNN-15: K2 forward, the plain statement's autograd back
    train_cfg = CLI_RUN / "flagship_knn15.json"
    with open(train_cfg, "w") as f:
        json.dump(cfg.replace(neighbor_k=SERVED_K).to_dict(), f)
    train_run = CLI_RUN / "train_knn15"
    drive("train_only", main,
          ["--mode", "train_only", "--run_dir", train_run, "--config",
           train_cfg, "--synthetic", NUM_GRAPHS, "--num_epochs",
           CLI_TRAIN_EPOCHS, *card_args], knn="some")
    with open(train_run / "profile.json") as f:
        profile = json.load(f)
    with open(train_run / "metrics.jsonl") as f:
        epochs = [json.loads(x) for x in f]
    kept = [r for r in epochs if "train_loss" in r]
    every = cfg.checkpoint_every
    want = {"train_epoch": len(kept) + sum("nan_recovery" in r
                                           for r in epochs),
            "eval_epoch": len(kept),
            "checkpoint": 1 + sum(1 for r in kept if every
                                  and (r["step"] + 1) % every == 0)}
    got = {k: v["count"] for k, v in profile.items()}
    rec["train_only"] = {"profile": profile, "jax_loop_counts": want,
                         "losses": [[r["train_loss"], r["eval_loss"]]
                                    for r in kept]}
    if got != want or len(kept) != CLI_TRAIN_EPOCHS or not all(
            math.isfinite(r["train_loss"]) for r in kept):
        raise AssertionError(f"train_only: {rec['train_only']}")
    if rec["launches"]["train_only"]["egcl_knn"] % cfg.L:
        raise AssertionError(f"train_only: {rec['launches']}")

    # generate_amorphous on network cells, through K1, from the same
    # weights with no redraw: on 192 atoms the flagship's chains leave the
    # finite range, and each of ten redraws would cost a whole chain
    once = CLI_RUN / "flagship_no_retry"
    once.mkdir()
    os.symlink(run / "checkpoints", once / "checkpoints")
    RunLogger(str(once), cfg.replace(max_nan_retries=0))
    ran = drive("generate_amorphous", generate_amorphous,
                ["--run_dir", once, *CLI_AMORPHOUS, *card_args],
                pair="some", figure=True)
    if ran:
        amorphous = np.load(once / "generated_amorphous.npz")
        with open(once / "amorphous_panel.json") as f:
            panel = json.load(f)
    else:
        amorphous, panel = amorphous_without_figures(
            cfg.replace(max_nan_retries=0), once, device)
    rec["generate_amorphous"] = {
        "samples": int(len(amorphous["ids"])),
        "finite": int(np.asarray(amorphous["finite"]).sum()),
        "o_density_accuracy": density_accuracy(
            o_density(amorphous["original_species"], amorphous["mask"]),
            o_density(amorphous["generated_species"], amorphous["mask"])),
        "panel": panel}

    # device_trace around a few reverse steps of the same sampler
    model = api.denoiser_from_params(cfg, load_params_npz(str(SNAPSHOT)),
                                     device)
    trace_dir = CLI_RUN / "trace"
    reset_counts()
    with device_trace(str(trace_dir)) as prof:
        with annotate("cli_drivers.reverse_steps"):
            api.generate(cfg.replace(sample_steps=CLI_TRACE_STEPS,
                                     max_nan_retries=0), model,
                         test[:1], gen_num_per_spectrum=1, device=device)
    trace_counts = rec["launches"]["device_trace"] = read_counts()
    trace, = trace_dir.glob("*.pt.trace.json")
    with open(trace) as f:
        names = [e.get("name", "") for e in json.load(f)["traceEvents"]]
    k1 = sorted({n for n in names if "edge_kernel" in n and "PairOp" in n})
    rec["device_trace"] = {
        "file": trace.name, "events": len(names), "k1_kernel_names": k1,
        "k1_events": sum(n in k1 for n in names),
        "annotation": "cli_drivers.reverse_steps" in names,
        "launches": trace_counts,
        "device_ms": sum(getattr(e, "self_device_time_total", 0)
                         for e in prof.key_averages()) / 1e3}
    if not k1 or not rec["device_trace"]["annotation"] or \
            not trace_counts["egcl_pair"] or trace_counts["plain_edge_calls"]:
        raise AssertionError(f"device_trace: {rec['device_trace']}")

    rec["not_run_without_matplotlib"] = not_run
    rec["phase_s"] = time.perf_counter() - t_phase
    rec["k1_launches"] = sum(c["egcl_pair"] for c in rec["launches"].values())
    rec["k2_launches"] = sum(c["egcl_knn"] for c in rec["launches"].values())
    if not_run:
        log({"phase": "cli_drivers_without_matplotlib", "not_run": not_run})
    log(rec)
    return rec


def driver_reading(name: str, run_dir) -> dict:
    """What a driver that ran wrote: the numbers of its last
    ``metrics.jsonl`` line (``evaluate_rmsd``: its sorted RMSDs; ``create_xyz``:
    the RMSDs and coordinates of its xyz pairs)."""
    import numpy as np

    run_dir = Path(run_dir)
    if name == "evaluate_rmsd":
        z = np.load(run_dir / "rmsd_xyz" / "sorted_id_rmsd.npz")
        return {"ids": [str(i) for i in z["ids"]],
                "rmsd": [float(v) for v in z["rmsd"]]}
    if name == "create_xyz":
        out = {}
        for path in sorted((run_dir / "xyz_pairs").rglob("*.xyz")):
            lines = path.read_text().split("\n")
            rows = [ln.split() for ln in lines[2:] if ln]
            out[str(path.relative_to(run_dir))] = {
                "rmsd": float(lines[1].rsplit(" ", 1)[1]),
                "elements": [r[0] for r in rows],
                "xyz": [float(v) for r in rows for v in r[1:]]}
        return out
    with open(run_dir / "metrics.jsonl") as f:
        last = json.loads(f.read().splitlines()[-1])
    last.pop("time", None)
    return last


def figure_free_numbers(name: str, results: dict, device,
                        group: int) -> dict:
    """The numbers a driver that draws logs, through the ported functions
    it calls, for a machine without matplotlib (``group``: samples a
    condition)."""
    import numpy as np

    from diffusion_model_tpu_torch import api
    from diffusion_model_tpu_torch.evals import cn2, fingerprint, rdf, rmsd

    keep = np.nonzero(results["accepted"])[0]
    acc = {k: np.asarray(v)[keep] for k, v in results.items() if k != "ids"}
    ids = [results["ids"][i] for i in keep]

    def trim(key, i):
        return acc[key][i][:int(acc["mask"][i].sum())]

    if name == "evaluate_only":
        num = api.evaluate_numbers(results, device)
        if not num["num_accepted"]:
            return {"num_accepted": 0}
        return {k: num[k] for k in ("rmsd_best", "rmsd_median", "rmsd_worst",
                                    "atom_type_accuracy", "num_accepted")}
    if name == "evaluate_rdf":
        v = np.asarray([r["cos"] for r in rdf.evaluate_rdf_lists(
            acc["original_pos"], acc["mask"], acc["generated_pos"],
            acc["mask"], device=device)])
        return {"rdf_cos_mean": float(v.mean()), "rdf_cos_std": float(v.std())}
    if name == "evaluate_rmsd":
        rows = sorted((ids[i], rmsd.permutation_min_rmsd(
            trim("original_pos", i), trim("generated_pos", i),
            device=device)[0]) for i in range(len(keep)))
        rows.sort(key=lambda r: r[1])
        return {"ids": [r[0] for r in rows], "rmsd": [r[1] for r in rows]}
    if name == "evaluate_si_o_si":
        keep_o, trip_o = cn2.filter_si_o_si(
            acc["original_pos"], acc["original_species"], acc["mask"])
        keep_g, trip_g = cn2.filter_si_o_si(
            acc["generated_pos"], acc["generated_species"], acc["mask"])
        both = sorted(set(keep_o) & set(keep_g))
        if not both:
            return {"si_o_si_count": 0}
        angles = [cn2.cn2_statistics(t[[k.index(i) for i in both]],
                                     device=device)["angle_deg"]
                  for k, t in ((keep_o, trip_o), (keep_g, trip_g))]
        return {"si_o_si_angle_r2": cn2.r2score(*angles),
                "si_o_si_count": len(both)}
    if name == "evaluate_cn2":
        geo = cn2._cn2_sample_geometry(results)
        return {"cn2_angle_r2": cn2.r2score(*cn2.conditional_angle_parity(
                    results, group, geo=geo)),
                "cn2_bond_r2": cn2.r2score(*cn2.conditional_bond_parity(
                    results, group, geo=geo))}
    if name == "evaluate_fingerprint":
        symbols = ("O", "Si")

        def sym(key, i):
            return [symbols[int(np.argmax(s))] for s in trim(key, i)]

        sims = [fingerprint.fingerprint_similarity(
            trim("original_pos", i), sym("original_species", i),
            trim("generated_pos", i), sym("generated_species", i))
            for i in range(len(keep))]
        return {"fingerprint_similarity_mean": float(np.mean(sims))}
    raise ValueError(name)


def amorphous_without_figures(cfg, run, device):
    """``generate_amorphous``'s generation and panel without its figure:
    the same conditions, weights and calls."""
    from diffusion_model_tpu_torch import api
    from diffusion_model_tpu_torch.cli import generate_amorphous
    from diffusion_model_tpu_torch.data.synthetic import (
        amorphous_network_cell,
    )
    from diffusion_model_tpu_torch.train.trainer import params_tree

    args = generate_amorphous.parser().parse_args(
        ["--run_dir", str(run), *CLI_AMORPHOUS])

    def make_cell(seed):
        return amorphous_network_cell(seed=seed, num_atoms=args.num_atoms,
                                      spectrum_size=cfg.spectrum_size)

    graphs = api.prepare_dataset([make_cell(cfg.seed + 10_000 + i)
                                  for i in range(args.amorphous)], cfg)
    big = cfg.replace(n_max=max(cfg.n_max, args.num_atoms))
    _, state = api.load_trained(str(run), big, device)
    reset_counts()
    out = api.generate(big, params_tree(state.eval_params(big)), graphs,
                       gen_num_per_spectrum=args.gen_num_per_spectrum,
                       device=device)
    counts = read_counts()
    if not counts["egcl_pair"] or counts["plain_edge_calls"]:
        raise AssertionError(f"amorphous generation: {counts}")
    return out, generate_amorphous.amorphous_panel(out, make_cell, device)


def same_numbers(card, cpu, what: str) -> float:
    """A driver's readings on the card and on the CPU: floats of an RMSD
    (``rmsd*``, and create_xyz's coordinates) at rtol 1e-5 (with a floor
    of 1e-5 of the set's scale for coordinates), RDF and angle scores
    within 1e-6, everything else equal. Returns the largest gap."""
    import numpy as np

    worst = 0.0

    def close(a, b, key):
        nonlocal worst
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        if key.startswith(("rdf_", "si_o_si_angle")):
            ok = np.allclose(a, b, rtol=0, atol=1e-6, equal_nan=True)
        elif key.startswith("rmsd") or key == "xyz":
            scale = float(np.abs(b).max()) if b.size else 0.0
            ok = np.allclose(a, b, rtol=1e-5,
                             atol=1e-5 * scale if key == "xyz" else 0.0,
                             equal_nan=True)
        else:
            ok = np.array_equal(a, b, equal_nan=True)
        if not ok:
            raise AssertionError(f"{what}: {key} on the card {a} against "
                                 f"{b} on the CPU")
        gap = np.abs(a - b)
        gap = gap[np.isfinite(gap)]
        if gap.size:
            worst = max(worst, float(gap.max()))

    def walk(a, b, key):
        if isinstance(b, dict):
            if sorted(a) != sorted(b):
                raise AssertionError(f"{what}: keys {sorted(a)} against "
                                     f"{sorted(b)}")
            for k in b:
                walk(a[k], b[k], k)
        elif isinstance(b, (float, int)) or (
                isinstance(b, list) and b and isinstance(b[0], float)):
            close(a, b, key)
        elif a != b:
            raise AssertionError(f"{what}: {key} {a} against {b}")

    walk(card, cpu, what)
    return worst


def angle_on_bin_edge(pos, tol_deg: float = 1e-3) -> bool:
    """Whether an angle at exO between neighbours within 2.5 A lies within
    ``tol_deg`` of a 10-degree histogram bin edge."""
    import numpy as np

    rel = np.asarray(pos, np.float64)[1:] - np.asarray(pos, np.float64)[0]
    d = np.linalg.norm(rel, axis=-1)
    near = rel[(d < 2.5) & (d > 0)]
    unit = near / np.linalg.norm(near, axis=-1, keepdims=True)
    ang = np.degrees(np.arccos(np.clip(unit @ unit.T, -1, 1)))
    return bool((np.abs(ang - 10.0 * np.round(ang / 10.0)) < tol_deg).any())


# The served calls of phase served_export, run in a child process whose
# meta-path finder refuses the model code, the JAX package and JAX: the
# artifact alone, with the two op modules, must serve. It imports while the
# parent exports (``serving_child``), then runs ``serve_job`` on the JSON
# job it reads from stdin; its last stdout line is the job's record.
SERVE_CHILD = r"""
import importlib.abc
import json
import sys

REFUSED = tuple("diffusion_model_tpu_torch." + m for m in (
    "api", "config", "data", "diffusion", "nn", "train", "evals", "cli",
    "parallel")) + ("diffusion_model_tpu", "jax")


def refused(name):
    return any(name == r or name.startswith(r + ".") for r in REFUSED)


class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if refused(name):
            raise ImportError(f"{name} is refused in the serving process")
        return None


sys.meta_path.insert(0, Refuse())
import torch
import torch.export.pt2_archive  # the reader, imported while waiting

import chip_smoke
from diffusion_model_tpu_torch import serve  # noqa: F401, as the reader

rec = chip_smoke.serve_job(json.loads(sys.stdin.read()))
rec["refused_loaded"] = sorted(m for m in sys.modules if refused(m))
print(json.dumps(rec))
"""


def program_step_kernels(served, seed: int) -> int:
    """Device kernels of one step of ``served``'s step program at the top
    of its grid, by ``torch.profiler`` as ``launches_per_call`` counts
    them, after each program has run once (its code is generated at its
    first call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    meta, layout, programs = served.meta, served.layout, served.programs
    b, n = meta["batch_size"], meta["n_max"]
    device = served.device
    cond = (torch.zeros((b, n, meta["spectrum_size"]), device=device),
            torch.zeros((b, n, 1), device=device),
            torch.ones((b, n), device=device),
            torch.zeros((b, n, meta["atom_type_size"]), device=device))
    gen = torch.Generator(device=device).manual_seed(seed)

    def draws(piece):
        got = [torch.randn(s, generator=gen, device=device)
               for s in layout["draws"][piece]]
        return got + [None] * (2 - len(got))

    pos, h = programs["start"](cond, *draws("start"))
    t, noise = torch.tensor(layout["steps"]), draws("step")
    programs["step"](cond, pos, h, t, *noise)
    programs["epilogue"](cond, pos, h, *noise)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        programs["step"](cond, pos, h, t, *noise)
        torch.cuda.synchronize()
    return len([e for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and not e.name.startswith(("Memcpy", "Memset"))])


def serve_job(job: dict) -> dict:
    """The serving process's work (``SERVE_CHILD``): each artifact of
    ``job`` loaded with ``serve.ServedSampler`` and called ``job["calls"]
    [name]`` times at ``job["seed"]`` on the inputs' spectra, each call's
    outputs saved to ``job["out"]``; its load seconds, each call's ms and
    K1 / K2 / ``bias_silu`` launches (the op modules' counts), and one
    step's device kernels. Imports only ``serve`` and the op modules of the
    port."""
    import numpy as np
    import torch

    from diffusion_model_tpu_torch import serve
    from diffusion_model_tpu_torch.ops import activations, egcl_knn, egcl_pair

    with np.load(job["inputs"]) as f:
        args = [f[k] for k in ("spectrum", "exo", "mask")]
    out = {}
    for name, path in job["artifacts"].items():
        t0 = time.perf_counter()
        served = serve.ServedSampler(path)
        rec = {"load_s": time.perf_counter() - t0,
               "step_device_kernels": program_step_kernels(served,
                                                           job["seed"]),
               "calls": []}
        for i in range(job["calls"][name]):
            egcl_pair.egcl_pair_launches = egcl_knn.egcl_knn_launches = 0
            activations.bias_silu_launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pos, species, accepted = served(job["seed"], *args)
            torch.cuda.synchronize()
            rec["calls"].append({
                "ms": (time.perf_counter() - t0) * 1e3,
                "egcl_pair": egcl_pair.egcl_pair_launches,
                "egcl_knn": egcl_knn.egcl_knn_launches,
                "bias_silu": activations.bias_silu_launches})
            np.savez(f"{job['out']}/{name}_{i}.npz", pos=pos,
                     species=species, accepted=accepted)
        out[name] = rec
    return {"artifacts": out}


def same_bits(a, b) -> bool:
    """Two sequences of numpy arrays equal bit for bit (a NaN equals the
    same NaN)."""
    return all(x.dtype == y.dtype and x.shape == y.shape
               and x.tobytes() == y.tobytes() for x, y in zip(a, b))


def serving_child() -> subprocess.Popen:
    """``SERVE_CHILD`` started: it imports, then waits for its job."""
    return subprocess.Popen([sys.executable, "-c", SERVE_CHILD], cwd=ROOT,
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def served_in_child(child: subprocess.Popen, artifacts: dict, calls: dict,
                    cond, out_dir: Path) -> dict:
    """``child`` (``serving_child``) on ``artifacts`` (name -> path),
    ``calls[name]`` calls each at ``SERVE_SEED`` over ``cond``'s spectra:
    its record, each call's outputs read back as
    ``rec["artifacts"][name]["outputs"]`` (numpy (pos, species, accepted)
    a call) and the seconds from the job to the record."""
    import numpy as np

    out_dir.mkdir(parents=True, exist_ok=True)
    np.savez(out_dir / "inputs.npz", spectrum=cond.spectrum.cpu().numpy(),
             exo=cond.exo.cpu().numpy(), mask=cond.mask.cpu().numpy())
    job = {"artifacts": {k: str(v) for k, v in artifacts.items()},
           "calls": calls, "seed": SERVE_SEED,
           "inputs": str(out_dir / "inputs.npz"), "out": str(out_dir)}
    t0 = time.perf_counter()
    stdout, stderr = child.communicate(json.dumps(job), timeout=600)
    wall = time.perf_counter() - t0
    if child.returncode != 0:
        raise AssertionError(f"the serving process failed (exit "
                             f"{child.returncode}):\n{stderr[-4000:]}")
    rec = json.loads(stdout.strip().splitlines()[-1])
    rec["job_s"] = wall
    for name, row in rec["artifacts"].items():
        row["outputs"] = []
        for i in range(calls[name]):
            with np.load(out_dir / f"{name}_{i}.npz") as f:
                row["outputs"].append((f["pos"], f["species"],
                                       f["accepted"]))
    return rec


def live_reading(cfg, params: dict, cond, seed: int, device) -> tuple:
    """``diffusion.sampler.sample`` of a model holding ``params`` with a
    generator seeded ``seed`` on ``cond``: (pos, species, accepted as
    numpy, launches, ms on the host clock, device kernels of one step at
    the top of the grid after a warm one, by ``torch.profiler`` as
    ``launches_per_call`` counts them)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from diffusion_model_tpu_torch import api
    from diffusion_model_tpu_torch.diffusion.sampler import (
        ReverseChain,
        sample,
    )

    model = api.denoiser_from_params(cfg, params, device)
    schedule = api.schedule_for(cfg, params, device)
    reset_counts()
    t0 = time.perf_counter()
    res = sample(model, schedule, cfg,
                 torch.Generator(device=device).manual_seed(seed), cond)
    counts = read_counts()
    ms = (time.perf_counter() - t0) * 1e3
    chain = ReverseChain(model, schedule, cfg, cond)
    gen = torch.Generator(device=device).manual_seed(seed)

    def noise(shape):
        return torch.randn(tuple(shape), generator=gen, device=device)

    with torch.no_grad():
        pos, h = chain.start(*chain.draws(noise, chain.start_shapes()))
        draws = chain.draws(noise, chain.step_shapes())
        chain.step(pos, h, chain.steps, *draws)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            chain.step(pos, h, chain.steps, *draws)
            torch.cuda.synchronize()
    kernels = len([e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.name.startswith(("Memcpy", "Memset"))])
    return ((res.pos.cpu().numpy(), res.species.cpu().numpy(),
             res.accepted.cpu().numpy()), counts, ms, kernels)


def phase_served_export(graphs: list, device, card: str) -> dict:
    """The serving export at the flagship's width: a run directory holding
    the snapshot's weights (as phase cli_drivers makes it), exported through
    ``cli.export.main`` at ``SERVE_STEPS`` strided deterministic steps for
    ``SERVE_B`` conditions with ``--calibrate 2`` (dense, K1), and through
    ``serve.export_sampler`` with ``neighbor_k=15`` (K2), with
    ``retry_rounds`` 2, and stochastic (a draw at every step). Every
    artifact is loaded and called in a child process that cannot import
    the model code (``SERVE_CHILD``, started first so that it imports while
    the exports run); each call on the first ``SERVE_B`` test conditions is
    bit for bit the live ``sample`` with a generator of the same seed at
    the run's eval parameters (the live calls run before the child's, on
    an idle card), launching its kernel L (steps + 1) times and the other
    none (counted by the op modules in the child); the dense call twice
    equal; the retry export equal to the retry-free one where the first
    draw accepts. A step of each program launches no more device kernels
    than the live sampler's step (``torch.profiler``). Logged: ms a call
    (host clock, each program run once before) beside the live call's, the
    artifacts' bytes, the exports' seconds, the launches of the phase."""
    t_phase = time.perf_counter()
    child = serving_child()
    try:
        rec = served_export_calls(child, graphs, device, card)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    rec["s"] = time.perf_counter() - t_phase
    log(rec)
    return rec


def served_export_calls(child, graphs: list, device, card: str) -> dict:
    """Phase served_export's work, with ``child`` its serving process."""
    import shutil

    import numpy as np
    import torch

    from diffusion_model_tpu_torch import api, serve
    from diffusion_model_tpu_torch.cli import export
    from diffusion_model_tpu_torch.data.batch import collate
    from diffusion_model_tpu_torch.train.checkpoint import (
        load_config_npz,
        load_params_npz,
        save_checkpoint,
    )
    from diffusion_model_tpu_torch.train.trainer import Trainer, params_tree
    from diffusion_model_tpu_torch.utils.logging import RunLogger

    shutil.rmtree(SERVE_RUN, ignore_errors=True)
    cfg = load_config_npz(str(SNAPSHOT))
    run = SERVE_RUN / "flagship"
    RunLogger(str(run), cfg)
    trainer = Trainer(cfg, device=device)
    state = trainer.init_state(cfg.seed,
                               params=load_params_npz(str(SNAPSHOT)),
                               skip_gamma_fit=True)
    save_checkpoint(str(run / "checkpoints"), state, cfg, step=0)
    del trainer, state
    cond = collate(graphs[:SERVE_B], cfg.n_max, device)
    served_cfg = cfg.replace(sample_steps=SERVE_STEPS,
                             deterministic_sampling=True)
    per_call = cfg.L * (SERVE_STEPS + 1)
    rec = {"phase": "served_export", "card": card, "batch": SERVE_B,
           "sample_steps": SERVE_STEPS, "launches_per_call": per_call}

    dense = SERVE_RUN / "dense.pt2"
    reset_counts()
    t0 = time.perf_counter()
    export.main([str(a) for a in (
        "--run_dir", run, "--out", dense, "--batch_size", SERVE_B,
        "--sample_steps", SERVE_STEPS, "--deterministic", "--calibrate", 2,
        "--device", device)])
    rec["cli_export"] = {"s": time.perf_counter() - t0,
                         "launches": read_counts()}
    total = {"egcl_pair": 0, "egcl_knn": 0}   # every launch of the phase

    def add(counts):
        for k in total:
            total[k] += counts[k]
        return counts

    add(rec["cli_export"]["launches"])
    want = {"egcl_pair": 2 * per_call, "egcl_knn": 0, "plain_edge_calls": 0}
    if rec["cli_export"]["launches"] != want:
        raise AssertionError(f"cli.export --calibrate 2: {rec['cli_export']}"
                             f", want {want}")
    trainer, state = api.load_trained(str(run), served_cfg, device)
    params = params_tree(state.eval_params(served_cfg))
    exports = {"dense": (dense, served_cfg, rec["cli_export"]["s"])}
    for name, c, rounds in (
            ("knn15", served_cfg.replace(neighbor_k=SERVED_K), 0),
            ("dense_retry2", served_cfg, 2),
            ("stochastic", served_cfg.replace(deterministic_sampling=False),
             0)):
        path = SERVE_RUN / f"{name}.pt2"
        t0 = time.perf_counter()
        serve.export_sampler(c, trainer, state, str(path), SERVE_B,
                             retry_rounds=rounds)
        exports[name] = (path, c, time.perf_counter() - t0)
    del trainer, state
    live = {}
    for name, (_, c, _) in exports.items():
        if name != "dense_retry2":
            live[name] = live_reading(c, params, cond, SERVE_SEED, device)
            add(live[name][1])
    torch.cuda.empty_cache()
    calls = {name: 2 if name == "dense" else 1 for name in exports}
    served = served_in_child(child, {k: v[0] for k, v in exports.items()},
                             calls, cond, SERVE_RUN / "calls")
    if served["refused_loaded"]:
        raise AssertionError(f"the serving process loaded model code: "
                             f"{served['refused_loaded']}")
    rec["child_job_s"] = served["job_s"]
    outputs = {}
    for name, (path, c, export_s) in exports.items():
        got = served["artifacts"][name]
        kernel = "egcl_knn" if c.neighbor_k else "egcl_pair"
        want = {"egcl_pair": 0, "egcl_knn": 0, kernel: per_call}
        # the program's bias-SiLU node, once a layer in bf16 (F12)
        want_fused = per_call if c.compute_dtype == "bfloat16" else 0
        first = got["outputs"][0]
        row = {"bytes": path.stat().st_size, "export_s": export_s,
               "load_s": got["load_s"], "calls": got["calls"],
               "ms_per_call": got["calls"][-1]["ms"],
               "accepted": int(first[2].sum()),
               "finite": int(np.isfinite(first[0]).all(axis=(1, 2)).sum()),
               "sidecar": json.loads(Path(f"{path}.json").read_text()),
               "step_device_kernels": got["step_device_kernels"]}
        for call in got["calls"]:
            add(call)
            if ((name != "dense_retry2" or first[2].all())
                    and ({k: call[k] for k in want} != want
                         or call["bias_silu"] != want_fused)):
                raise AssertionError(f"{name}: launches {call}, want "
                                     f"{want} and bias_silu {want_fused}")
        if name == "dense":
            row["repeat_equal"] = same_bits(*got["outputs"])
            if not row["repeat_equal"]:
                raise AssertionError("dense: the same call twice differs")
        if name in live:
            outs, counts, ms, kernels = live[name]
            # the program's step counted in this process too, beside the
            # live step: a process's history can change the kernels a
            # step launches (PERF.md section 7)
            here = program_step_kernels(
                serve.ServedSampler(str(path), device), SERVE_SEED)
            row.update(live_ms_per_call=ms, live_step_device_kernels=kernels,
                       step_device_kernels_here=here)
            if not same_bits(first, outs) or counts != {
                    **want, "plain_edge_calls": 0}:
                raise AssertionError(f"{name}: the served call is not the "
                                     f"live sampler's ({counts})")
            if here > kernels:
                raise AssertionError(
                    f"{name}: a step of the program launches {here} device "
                    f"kernels, the live sampler's {kernels}")
        outputs[name] = first
        rec[name] = row
    raw, retry = outputs["dense"], outputs["dense_retry2"]
    acc = raw[2]
    same = same_bits([a[acc] for a in raw], [b[acc] for b in retry])
    rec["dense_retry2"]["equal_to_retry_free_on_accepted_rows"] = same
    if not same or (acc.all() and not same_bits(raw, retry)):
        raise AssertionError("the retry export parts from the retry-free "
                             "one on the rows its first draw accepts")
    rec["bit_for_bit_live"] = sorted(live)
    rec["launches"] = total
    return rec


def phase_distill(graphs: list, device, card: str) -> dict:
    """Progressive distillation from the flagship's weights (bf16, batch
    64 of its train split, the teacher its eval parameters through
    ``evals.distill_check.snapshot_state``): one halving 1000 -> 500 for
    ``DISTILL_EPOCHS`` epochs through ``api.distill`` (every logged loss
    finite; K1 3 L times a step: the teacher's two calls and the student's
    forward, whose backward is ``ops.edge_grad``'s; ms a step: the median
    after the first, each on the host clock from a synchronized start);
    the student sampled on ``SERVE_B`` test
    conditions at its 500 deterministic steps (finite count read, not
    gated); one float32 ``distill_loss`` at batch ``DISTILL_F32_B`` on the
    card against the CPU from the same weights and draws (loss rel
    ``DISTILL_F32_RTOL``, every gradient leaf's relative L2 within
    ``KABSCH_F32_GRAD_REL``)."""
    import numpy as np
    import torch

    from diffusion_model_tpu_torch import api
    from diffusion_model_tpu_torch.data.batch import collate
    from diffusion_model_tpu_torch.data.split import split_dataset
    from diffusion_model_tpu_torch.diffusion.sampler import sample
    from diffusion_model_tpu_torch.evals.distill_check import snapshot_state
    from diffusion_model_tpu_torch.train import distill
    from diffusion_model_tpu_torch.train.checkpoint import (
        load_config_npz,
        load_params_npz,
    )
    from diffusion_model_tpu_torch.train.trainer import params_tree

    t_phase = time.perf_counter()
    base = load_config_npz(str(SNAPSHOT))
    params = load_params_npz(str(SNAPSHOT))
    train = split_dataset(flagship_graphs(base), base.seed)[0]
    cfg, trainer, state = snapshot_state(base, params, device)
    losses, stamps = [], []
    gen = torch.Generator(device=device).manual_seed(cfg.seed + 17)

    def noise(student_steps, batch):
        # api.distill's default draws, each step's start on the host clock
        # after the card has finished the step before
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        return distill.draw(gen, student_steps, batch, cfg.diffuse_species)

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    student_cfg, student = api.distill(
        cfg, trainer, state, train, final_steps=DISTILL_STEPS,
        epochs_per_phase=DISTILL_EPOCHS, lr=DISTILL_LR,
        log_fn=lambda line: losses.append(float(line.split()[-1])),
        noise=noise)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    step_ms = np.diff(stamps + [time.perf_counter()]) * 1e3
    counts = read_counts()
    steps = DISTILL_EPOCHS * -(-len(train) // cfg.batch_size)
    want = {"egcl_pair": 3 * cfg.L * steps, "egcl_knn": 0,
            "plain_edge_calls": 0}
    if counts != want or len(losses) != DISTILL_EPOCHS \
            or not np.isfinite(losses).all():
        raise AssertionError(f"distill: launches {counts} (want {want}), "
                             f"losses {losses}")
    cond = collate(graphs[:SERVE_B], cfg.n_max, device)
    model = api.denoiser_from_params(
        student_cfg, params_tree(student.eval_params(student_cfg)), device)
    reset_counts()
    t0 = time.perf_counter()
    res = sample(model, api.schedule_for(student_cfg, {}, device),
                 student_cfg, torch.Generator(device=device).manual_seed(0),
                 cond)
    torch.cuda.synchronize()
    sampled = {"steps": student_cfg.sample_steps,
               "deterministic": student_cfg.deterministic_sampling,
               "s": time.perf_counter() - t0, "launches": read_counts(),
               "finite": int(res.finite.sum()),
               "accepted": int(res.accepted.sum()), "samples": SERVE_B}

    # float32, the card against the CPU from the same weights and draws
    f32 = base.replace(compute_dtype="float32")
    small = train[:DISTILL_F32_B]
    drawn = None
    sides = []
    for dev in (device, torch.device("cpu")):
        teacher = api.denoiser_from_params(f32, params, dev)
        pupil = distill.fresh_copy(teacher, trainable=True)
        full = distill.full_phase(api.schedule_for(f32, params, dev))
        batch = collate(small, f32.n_max, dev)
        if drawn is None:
            drawn = distill.draw(torch.Generator().manual_seed(3),
                                 full.num_steps // 2, batch.map(
                                     lambda a: a.cpu()), True)
        draws = distill.DistillDraws(
            *(d.to(dev) for d in (drawn.j, drawn.pos, drawn.h)))
        reset_counts()
        t0 = time.perf_counter()
        loss = distill.distill_loss(pupil, teacher, f32, full, full.halve(),
                                    batch, draws=draws)
        names = dict(pupil.named_parameters())
        parts = torch.autograd.grad(loss, list(names.values()),
                                    allow_unused=True)
        grads = {k: g.cpu() for k, g in zip(names, parts) if g is not None}
        sides.append((float(loss.detach()), grads,
                      time.perf_counter() - t0, read_counts()))
    (l_card, g_card, card_s, f32_counts), (l_cpu, g_cpu, cpu_s, _) = sides
    gap = {k: rel_l2(g_card[k], g) for k, g in g_cpu.items()
           if float(g.norm()) > 0}
    worst = max(gap, key=gap.get)
    parity = {"batch": DISTILL_F32_B, "loss_card": l_card, "loss_cpu": l_cpu,
              "loss_rel_gap": abs(l_card - l_cpu) / abs(l_cpu),
              "largest_leaf_rel_l2": gap[worst], "largest_leaf": worst,
              "leaves": len(gap), "card_s": card_s, "cpu_s": cpu_s,
              "launches": f32_counts}
    if not (math.isfinite(l_card)
            and parity["loss_rel_gap"] <= DISTILL_F32_RTOL
            and parity["largest_leaf_rel_l2"] <= KABSCH_F32_GRAD_REL
            and f32_counts["egcl_pair"] == 3 * f32.L):
        raise AssertionError(f"the float32 distillation loss on the card "
                             f"parts from the CPU's: {parity}")
    rec = {"phase": "distill", "card": card, "teacher": str(
        SNAPSHOT.relative_to(ROOT)), "halving": [1000, DISTILL_STEPS],
        "epochs": DISTILL_EPOCHS, "batch": cfg.batch_size,
        "compute_dtype": cfg.compute_dtype, "lr": DISTILL_LR,
        "train_graphs": len(train), "steps": steps, "losses": losses,
        "launches": counts, "k1_launches_per_step": counts["egcl_pair"]
        / steps, "wall_s": wall, "first_step_ms": float(step_ms[0]),
        "ms_per_step": float(np.median(step_ms[1:])),
        "student_sampled": sampled, "float32": parity,
        "s": time.perf_counter() - t_phase}
    log(rec)
    return rec


def phase_spectrum_latent(device, card: str) -> dict:
    """The spectrum-latent conditioning path on the flagship's data (its
    256 graphs' 200-wide spectra): ``pretrain_autoencoder`` for
    ``LATENT_AE_STEPS`` full-batch steps at latent ``LATENT_DIM`` on the
    card (ms, final MSE against the spectra's variance); ``encode_dataset``
    on the card against the same encoder on the CPU (relative L2
    ``LATENT_ENCODE_REL``); a fresh latent-conditioned model at the
    flagship's widths (``spectrum_to_latent``, no compressor, node width
    36) trained ``LATENT_EPOCHS`` epochs through ``api.train`` on K1 (5
    launches a forward, losses finite), then ``SERVE_B`` of its test
    conditions sampled at ``LATENT_STEPS`` strided steps with no redraw
    (finite count read, not gated: a model 2 epochs from init samples no
    finite chain, C1)."""
    import copy
    import shutil

    import numpy as np
    import torch

    from diffusion_model_tpu_torch import api
    from diffusion_model_tpu_torch.data.batch import collate
    from diffusion_model_tpu_torch.diffusion.sampler import sample
    from diffusion_model_tpu_torch.nn.denoiser import DiffusionDenoiser
    from diffusion_model_tpu_torch.nn.spectrum_latent import (
        encode_dataset,
        pretrain_autoencoder,
    )
    from diffusion_model_tpu_torch.train.checkpoint import load_config_npz
    from diffusion_model_tpu_torch.train.trainer import params_tree

    t_phase = time.perf_counter()
    base = load_config_npz(str(SNAPSHOT))
    graphs = flagship_graphs(base)
    spectra = np.stack([g["spectrum"][0] for g in graphs])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    enc, _, mse = pretrain_autoencoder(spectra, LATENT_DIM,
                                       steps=LATENT_AE_STEPS, seed=base.seed,
                                       device=device)
    torch.cuda.synchronize()
    ae = {"steps": LATENT_AE_STEPS, "latent_dim": LATENT_DIM,
          "spectra": list(spectra.shape), "final_mse": mse,
          "spectra_var": float(spectra.var()),
          "ms_per_step": (time.perf_counter() - t0) * 1e3 / LATENT_AE_STEPS}
    if not (math.isfinite(mse) and mse < ae["spectra_var"]):
        raise AssertionError(f"the autoencoder did not train: {ae}")
    encoded = encode_dataset(graphs, enc)
    on_cpu = encode_dataset(graphs, copy.deepcopy(enc).cpu())
    card_lat = torch.as_tensor(np.concatenate([g["spectrum"]
                                               for g in encoded]))
    cpu_lat = torch.as_tensor(np.concatenate([g["spectrum"]
                                              for g in on_cpu]))
    ae["encode_rel_l2_card_cpu"] = rel_l2(card_lat, cpu_lat)
    off_node0 = max(float(np.abs(g["spectrum"][1:]).max(initial=0.0))
                    for g in encoded)
    if ae["encode_rel_l2_card_cpu"] > LATENT_ENCODE_REL or off_node0:
        raise AssertionError(f"encode_dataset on the card: {ae}")

    cfg = base.replace(spectrum_to_latent=True, to_compress_spectrum=False,
                       latent_dim=LATENT_DIM)
    run_dir = SERVE_RUN / "latent"
    shutil.rmtree(run_dir, ignore_errors=True)
    forwards = []
    hook = torch.nn.modules.module.register_module_forward_hook(
        lambda m, i, o: forwards.append(1)
        if isinstance(m, DiffusionDenoiser) else None)
    reset_counts()
    t0 = time.perf_counter()
    try:
        trainer, state, (_, _, test) = api.train(
            cfg, encoded, str(run_dir), num_epochs=LATENT_EPOCHS,
            device=device)
        torch.cuda.synchronize()
    finally:
        hook.remove()
    train_s = time.perf_counter() - t0
    counts = read_counts()
    lines = [json.loads(x) for x in open(run_dir / "metrics.jsonl")]
    losses = [r["train_loss"] for r in lines if "train_loss" in r]
    want = {"egcl_pair": cfg.L * len(forwards), "egcl_knn": 0,
            "plain_edge_calls": 0}
    if counts != want or len(losses) != LATENT_EPOCHS \
            or not np.isfinite(losses).all():
        raise AssertionError(f"latent training: launches {counts} (want "
                             f"{want}), losses {losses}")
    s_cfg = cfg.replace(sample_steps=LATENT_STEPS)
    model = api.denoiser_from_params(
        s_cfg, params_tree(state.eval_params(cfg)), device)
    cond = collate(test[:SERVE_B], cfg.n_max, device)
    reset_counts()
    t0 = time.perf_counter()
    res = sample(model, api.schedule_for(s_cfg, {}, device), s_cfg,
                 torch.Generator(device=device).manual_seed(0), cond)
    torch.cuda.synchronize()
    sampled = {"steps": LATENT_STEPS, "s": time.perf_counter() - t0,
               "launches": read_counts(), "finite": int(res.finite.sum()),
               "accepted": int(res.accepted.sum()), "samples": SERVE_B}
    if sampled["launches"]["egcl_pair"] != cfg.L * (LATENT_STEPS + 1):
        raise AssertionError(f"latent sampling launches: {sampled}")
    rec = {"phase": "spectrum_latent", "card": card, "autoencoder": ae,
           "h_size": cfg.h_size, "train": {
               "epochs": LATENT_EPOCHS, "losses": losses, "s": train_s,
               "forwards": len(forwards), "launches": counts,
               "steps": state.step},
           "sampled": sampled,
           "launches": {"egcl_pair": counts["egcl_pair"]
                        + sampled["launches"]["egcl_pair"]},
           "s": time.perf_counter() - t_phase}
    log(rec)
    return rec


def phase_f9_replay(device, card: str) -> dict:
    """Phase 32 (above): the first ``F9_STEPS`` steps of both tracks of
    F9's full-width replay, against the JAX package's record."""
    import torch

    from diffusion_model_tpu_torch.ops import activations, egcl_knn

    sys.path.insert(0, str(ROOT / "tests"))
    import torch_replay_training_full as full

    t0 = time.perf_counter()
    meta, npz = full.load_fixture()
    start = full.port_leaves(full.numpy_start(meta["start"]["spec"],
                                              meta["start"]["seed"]))
    sketch = full.Sketch(start, meta["sketch"]["seed"], meta["sketch"]["k"],
                         device=device)
    full.check_inputs(meta, npz, sketch)
    setup_s = time.perf_counter() - t0
    egcl_knn.egcl_knn_launches = activations.bias_silu_launches = 0
    port = {t: full.replay_track(meta, npz, t, F9_STEPS, device, sketch)
            for t in full.TRACKS}
    launches = egcl_knn.egcl_knn_launches
    fused = activations.bias_silu_launches
    verdict = full.verdict(meta, port, F9_STEPS)
    first = {}
    for t, grad_rtol in (("float32", full.GRAD_RTOL),
                         ("bfloat16", full.BF16_GRAD_RTOL)):
        want = meta["tracks"][t]
        first[t] = {
            "loss": port[t]["loss"][0], "jax_loss": want["loss"][0],
            "grad_norm": port[t]["grad_norm"][0],
            "jax_grad_norm": want["grad_norm"][0],
            "grad_norm_within": math.isclose(
                port[t]["grad_norm"][0], want["grad_norm"][0],
                rel_tol=grad_rtol)}
    first["float32"]["loss_within"] = math.isclose(
        port["float32"]["loss"][0], meta["tracks"]["float32"]["loss"][0],
        rel_tol=full.LOSS_RTOL)
    rec = {"phase": "f9_replay", "card": card, "steps": F9_STEPS,
           "first_step": first, "verdict": verdict,
           "gaps_at_10": {t: port[t]["records"][-1]["gap"]["tree"]
                          for t in full.TRACKS},
           "jax_bf16_f32_gap_at_10": next(
               r["exact"]["tree"] for r in meta["jax_gap"]
               if r["step"] == F9_STEPS),
           "egcl_knn_launches": launches, "bias_silu_launches": fused,
           "ms_a_step": {t: 1e3 * port[t]["seconds"] / F9_STEPS
                         for t in full.TRACKS},
           "setup_s": setup_s, "peak_gb": torch.cuda.max_memory_allocated(
               device) / 1e9, "s": time.perf_counter() - t0}
    log(rec)
    # the repaired route (F11): K2 once a layer in each step's forward,
    # none in its backward (autograd of a plain statement)
    want_launches = len(full.TRACKS) * F9_STEPS * meta["L"]
    if launches != want_launches:
        raise AssertionError(f"f9_replay launched K2 {launches} times, "
                             f"not {want_launches}")
    # bias_silu: the bf16 track's virtual-node channel, three a layer a
    # step (the node MLP keeps torch's form under autograd, F12)
    if fused != F9_STEPS * meta["L"] * 3:
        raise AssertionError(f"f9_replay launched bias_silu {fused} times, "
                             f"not {F9_STEPS * meta['L'] * 3}")
    if not all(f["grad_norm_within"] for f in first.values()) \
            or not first["float32"]["loss_within"]:
        raise AssertionError(f"f9_replay: step 1 off JAX's: {first}")
    if verdict["outcome"] != "i":
        raise AssertionError(f"f9_replay: F9's rule refuses the first "
                             f"{F9_STEPS} steps: {verdict}")
    del sketch
    torch.cuda.empty_cache()
    return rec


def phase_data_parallel(device, card: str, phase17: dict) -> dict:
    """``api.train`` with the flagship's recipe (bf16, dense K1, batch 64)
    from a fresh init for ``TRAIN_EPOCHS`` epochs with ``mesh_shape=(1,)``
    in this process's NCCL world of one, against the same run without a
    mesh: ``metrics.jsonl`` (but its clock) and the final state bit for bit
    (a sum over one rank is the identity), or, where the card itself is not
    deterministic (a second run without a mesh differs), within
    ``RESUME_SPREAD`` times that gap, leaf for leaf. K1 launched 5 times a
    forward, as phase 17's run (50); ms an epoch beside phase 17's."""
    import json
    import shutil

    import torch

    from diffusion_model_tpu_torch import api
    from diffusion_model_tpu_torch.ops import egcl_pair
    from diffusion_model_tpu_torch.train.checkpoint import load_config_npz

    cfg = load_config_npz(str(SNAPSHOT))
    graphs = flagship_graphs(cfg)
    root = TRAIN_RUN / "data_parallel"
    shutil.rmtree(root, ignore_errors=True)

    def run(name, run_cfg):
        egcl_pair.egcl_pair_launches = 0
        t0 = time.perf_counter()
        _, state, _ = api.train(run_cfg, graphs, str(root / name),
                                num_epochs=TRAIN_EPOCHS, device=device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        lines = [json.loads(x) for x in open(root / name / "metrics.jsonl")]
        epoch_ms = [1e3 * r.pop("epoch_s") for r in lines if "epoch_s" in r]
        for r in lines:
            r.pop("time", None)
        return {"state": state, "lines": lines, "wall_s": wall,
                "ms_per_epoch": epoch_ms,
                "egcl_pair": egcl_pair.egcl_pair_launches}

    plain = run("plain", cfg)
    mesh = run("mesh", cfg.replace(mesh_shape=(1,)))
    gap = leaf_gap(mesh["state"], plain["state"])
    rec = {"phase": "data_parallel", "card": card, "world_size": 1,
           "backend": "nccl", "epochs": TRAIN_EPOCHS,
           "launches": {"egcl_pair": mesh["egcl_pair"]},
           "launches_without_mesh": plain["egcl_pair"],
           "launches_phase_17": phase17["launches"]["egcl_pair"],
           "metrics_equal": mesh["lines"] == plain["lines"],
           "max_leaf_gap": max(gap.values()),
           "ms_per_epoch": mesh["ms_per_epoch"],
           "ms_per_epoch_without_mesh": plain["ms_per_epoch"],
           "ms_per_epoch_phase_17": [
               1e3 * json.loads(x)["epoch_s"]
               for x in open(TRAIN_RUN / "dense" / "metrics.jsonl")
               if "epoch_s" in x],
           "wall_s": mesh["wall_s"], "wall_s_without_mesh": plain["wall_s"]}
    off = [k for k, v in gap.items() if v != 0.0]
    if off or not rec["metrics_equal"]:
        again = run("plain_again", cfg)
        card_gap = leaf_gap(again["state"], plain["state"])
        rec["card_deterministic"] = max(card_gap.values()) == 0.0
        rec["plain_vs_plain_max_leaf_gap"] = max(card_gap.values())
        off = [k for k, v in gap.items() if v > RESUME_SPREAD * card_gap[k]]
        if rec["card_deterministic"] and not rec["metrics_equal"]:
            off.append("metrics.jsonl")
    else:
        rec["card_deterministic"] = None
    log(rec)
    if off:
        raise AssertionError(f"the run on a mesh of one is off the run "
                             f"without one at {off[:5]}")
    want = phase17["launches"]["egcl_pair"]
    if not mesh["egcl_pair"] == plain["egcl_pair"] == want:
        raise AssertionError(f"K1 launches {mesh['egcl_pair']} (without "
                             f"the mesh {plain['egcl_pair']}), want {want}")
    return rec


def ring_cell(cfg, device, seed: int = 0):
    """The flagship's inputs on ``amorphous_cell(seed, RING_ATOMS)`` at
    ``n_max`` ``RING_ATOMS``, one graph: noised species and positions from a
    numpy seed, t/T 0.5; float32 on ``device``."""
    import numpy as np
    import torch

    from diffusion_model_tpu_torch.data.batch import collate
    from diffusion_model_tpu_torch.data.synthetic import amorphous_cell

    cell = amorphous_cell(seed=seed, num_atoms=RING_ATOMS,
                          spectrum_size=cfg.spectrum_size)
    batch = collate([cell], RING_ATOMS, device)
    rng = np.random.default_rng(seed)
    m3 = batch.mask.unsqueeze(-1)
    noise = torch.from_numpy(rng.normal(size=(1, RING_ATOMS, 3)).astype(
        np.float32)).to(device)
    species = batch.species + 0.5 * torch.from_numpy(rng.normal(
        size=batch.species.shape).astype(np.float32)).to(device)
    return cell, batch, (species * m3, (batch.pos + 0.3 * noise) * m3,
                         batch.spectrum, batch.exo, 0.5 * m3, batch.mask)


def ring_params(params: dict) -> dict:
    """The flagship's parameter tree with each layer's coordinate head
    (``mlp_x_dense2``) scaled by ``RING_X_SCALE``."""
    import copy

    out = copy.deepcopy(params)
    for layer in out["denoiser"]["params"]["egnn"].values():
        for k in ("kernel", "bias"):
            layer["mlp_x_dense2"][k] = layer["mlp_x_dense2"][k] * RING_X_SCALE
    return out


def phase_ring(params: dict, device, card: str) -> dict:
    """The ring (``parallel.ring``) in this process's NCCL world of one at
    the flagship's width on ``amorphous_cell(seed=0, num_atoms=256)``,
    ``n_max`` 256, one graph, dense topology, the flagship's weights with
    the coordinate head scaled (``ring_params``): (a) ``ring_denoise_fn``
    against the dense denoiser (K1) in float32, rtol 2e-4 / atol 2e-5 of
    the output's scale, and in bf16 (read); (b) ``api.generate_ring``, one
    condition x 1 at 250 strided steps, ms a denoiser call and s a
    structure, beside ``api.generate`` on the dense route on the same cell
    (no redraws: a timed path draws once);
    (c) one ``ring_train_step_fn`` step against the dense train step from
    the flagship's state on the same draws, float32: loss rtol 1e-4, every
    leaf rtol 2e-3 / atol 2e-6, with peak memory. The ring launches no
    kernel; its plain edge calls are counted in ``ring.ring_edge_calls``."""
    import numpy as np
    import torch

    from diffusion_model_tpu_torch import api, parallel
    from diffusion_model_tpu_torch.nn import egnn
    from diffusion_model_tpu_torch.ops import egcl_pair
    from diffusion_model_tpu_torch.parallel import ring
    from diffusion_model_tpu_torch.train.checkpoint import load_config_npz
    from diffusion_model_tpu_torch.train.loss import TrainNoise
    from diffusion_model_tpu_torch.train.trainer import Trainer

    base = load_config_npz(str(SNAPSHOT)).replace(n_max=RING_ATOMS,
                                                  max_nan_retries=0)
    params = ring_params(params)
    mesh = parallel.make_mesh()
    rec = {"phase": "ring", "card": card, "world_size": mesh.size,
           "atoms": RING_ATOMS, "n_max": RING_ATOMS,
           "coordinate_head_scale": RING_X_SCALE}
    t_start = time.perf_counter()

    # (a) the forward, float32 and bf16
    forward = {}
    for dtype in ("float32", "bfloat16"):
        cfg = base.replace(compute_dtype=dtype)
        model = api.denoiser_from_params(cfg, params, device)
        _, _, args = ring_cell(cfg, device)
        fn = ring.ring_denoise_fn(cfg, model, mesh)
        with torch.no_grad():
            dense = [o[0] for o in model(*args)]
            ring.ring_edge_calls = 0
            got = fn(*(a[0] for a in args))
            torch.cuda.synchronize()
        row = {"ring_edge_calls": ring.ring_edge_calls}
        for name, g, d in zip(("eps_x", "eps_h"), got, dense):
            scale = float(d.abs().max())
            row[name] = {"max_abs_err": float((g - d).abs().max()),
                         "scale": scale, "rel_l2": rel_l2(g, d),
                         "within": math.isfinite(scale) and bool(
                             ((g - d).abs() <= 2e-5 * scale
                              + 2e-4 * d.abs()).all())}
        row["ring_ms"] = cuda_ms(lambda: fn(*(a[0] for a in args)),
                                 RING_REPS)
        row["dense_ms"] = cuda_ms(lambda: model(*args), RING_REPS)
        forward[dtype] = row
    rec["forward"] = forward

    # (b) generation through the ring and on the dense route
    cfg = base.replace(sample_steps=RING_STEPS)
    cell, _, _ = ring_cell(cfg, device)
    generated = {}
    for route in ("ring", "dense"):
        model, calls = counting_model(cfg, params, device)
        egcl_pair.egcl_pair_launches = 0
        ring.ring_edge_calls = 0
        gen = torch.Generator(device=device).manual_seed(cfg.seed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if route == "ring":
            out = api.generate_ring(cfg, model, [dict(cell, id="cell")],
                                    generator=gen, gen_num_per_spectrum=1,
                                    mesh=mesh)
        else:
            out = api.generate(cfg, model, [dict(cell, id="cell")],
                               generator=gen, gen_num_per_spectrum=1,
                               batch_size=1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        # the ring reads the model's parameters and never calls it
        n_calls = (ring.ring_edge_calls // cfg.L if route == "ring"
                   else calls[0])
        generated[route] = {
            "s_per_structure": wall, "denoiser_calls": n_calls,
            "ms_per_denoiser_call": 1e3 * wall / max(n_calls, 1),
            "egcl_pair_launches": egcl_pair.egcl_pair_launches,
            "ring_edge_calls": ring.ring_edge_calls,
            "finite": int(np.asarray(out["finite"]).sum()),
            "shape": list(out["generated_pos"].shape)}
    rec["generate"] = generated

    # (c) one train step through the ring against the dense one, float32
    cfg = base.replace(compute_dtype="float32", batch_size=1)
    _, batch, _ = ring_cell(cfg, device)
    steps = {}
    for route in ("ring", "dense"):
        trainer = Trainer(cfg, device=device)
        state = trainer.init_state(cfg.seed, params=params,
                                   skip_gamma_fit=True)
        step = (trainer.ring_train_step_fn(mesh) if route == "ring"
                else trainer.train_step)
        egcl_pair.egcl_pair_launches = 0
        ring.ring_edge_calls = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        state, m = step(state, TrainNoise(RING_NOISE_SEED, device), batch)
        torch.cuda.synchronize()
        steps[route] = {"state": state, "loss": float(m["loss"]),
                        "ms": 1e3 * (time.perf_counter() - t0),
                        "max_memory_allocated_bytes":
                            torch.cuda.max_memory_allocated(device),
                        "egcl_pair_launches": egcl_pair.egcl_pair_launches,
                        "ring_edge_calls": ring.ring_edge_calls}
    off = []
    worst = 0.0
    for k, want in steps["dense"]["state"].params.items():
        got = steps["ring"]["state"].params[k].detach()
        want = want.detach()
        err = (got - want).abs()
        if not bool((err <= 2e-6 + 2e-3 * want.abs()).all()):
            off.append(k)
        worst = max(worst, float((err / (2e-6 + 2e-3 * want.abs())).max()))
    loss_rel = abs(steps["ring"]["loss"] - steps["dense"]["loss"]) / abs(
        steps["dense"]["loss"])
    rec["train_step"] = {
        route: {k: v for k, v in s.items() if k != "state"}
        for route, s in steps.items()}
    rec["train_step"].update({"loss_rel_err": loss_rel,
                              "worst_leaf_over_tolerance": worst,
                              "leaves_off": off[:5]})
    rec["ring_edge_calls_in_plain_edge_calls"] = egnn.plain_edge_calls
    rec["wall_s"] = time.perf_counter() - t_start
    log(rec)

    bad = [d for d, r in forward.items() if d == "float32"
           and not (r["eps_x"]["within"] and r["eps_h"]["within"])]
    if bad:
        raise AssertionError(f"the ring's float32 forward is off the dense "
                             f"one: {forward['float32']}")
    for route, row in generated.items():
        kernel = row["egcl_pair_launches"] if route == "dense" else \
            row["ring_edge_calls"]
        if (row["denoiser_calls"] != RING_STEPS + 1
                or kernel != base.L * (RING_STEPS + 1)
                or row["shape"] != [1, RING_ATOMS, 3]
                or (route == "ring" and row["egcl_pair_launches"])):
            raise AssertionError(f"{route} generation: {row}")
    if not (math.isfinite(steps["dense"]["loss"]) and loss_rel <= 1e-4) \
            or off:
        raise AssertionError(f"the ring's train step is off the dense one: "
                             f"{rec['train_step']}")
    if steps["ring"]["egcl_pair_launches"] or \
            steps["ring"]["ring_edge_calls"] != base.L:
        raise AssertionError(f"the ring's train step: {rec['train_step']}")
    return rec


def edge_flops(f1: int, fm: int, h: int = 0) -> int:
    """Tensor-core FLOPs of one live edge: both second-layer products, and
    for K2 the j-side first layer (4 H F1)."""
    return 2 * f1 * fm + 2 * f1 * f1 + 4 * h * f1


def peak_kind(t) -> str:
    """The peak an EGCL kernel's products run at: bf16 tensor cores, or
    float32 FMAs for the float32 variant."""
    return "f32" if t.element_size() == 4 else "bf16"


def pair_bound(args) -> dict:
    """K1 at these inputs: live ordered pairs i != j of real atoms; bytes of
    every argument and of m_sum and x_out."""
    from diffusion_model_tpu_torch.probes._common import bound, nbytes

    real = args[5][..., 0].sum(dim=1)
    pairs = float((real * (real - 1)).sum())
    f1, fm = args[8].shape                  # w2m
    b, n = args[0].shape[:2]
    flops = pairs * edge_flops(f1, fm)
    return {"live_edges": pairs, "flops": flops, **bound(
        nbytes(*args) + b * n * (fm + 3) * 4, **{peak_kind(args[0]): flops})}


def knn_bound(args) -> dict:
    """K2 at these inputs: live kNN slots."""
    from diffusion_model_tpu_torch.probes._common import bound, nbytes

    h, f1 = args[6].shape                   # wm_j
    fm = args[10].shape[-1]                 # w2m
    b, n = args[0].shape[:2]
    edges = float(args[5].sum())
    flops = edges * edge_flops(f1, fm, h)
    return {"live_edges": edges, "flops": flops, **bound(
        nbytes(*args) + b * n * (fm + 3) * 4, **{peak_kind(args[0]): flops})}


def probe_kernel(name: str, source: str, replaces: str, launches: int,
                 **numbers) -> dict:
    if launches == 0:
        raise AssertionError(f"{name} was never launched on its probe's path")
    return {"name": name, "route": "cuda",
            "source": f"diffusion_model_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": launches, **numbers}


def phase_matmul_rate(device, card: str) -> dict:
    """P2: the chain kernel against its plain version at M = 512 and at the
    card-filling M, so at every cluster shape the timings run (int8 bit for
    bit), then the probe's timings at both M, each with the cluster and
    column slice its launch used and its time over the eager cuBLAS chain's
    and over the bound, and where a link's cycles go."""
    import torch

    from diffusion_model_tpu_torch.probes import matmul_rate as mr

    checks = mr.check_on_card(device)
    plain_ms = {}
    for dtype in (torch.int8, torch.bfloat16):
        a, w = mr.make_inputs(mr.M, mr.N, dtype, device)
        plain_ms[str(dtype)[6:]] = cuda_ms(
            lambda: mr.chain_reference(a, w), 3)
    mr.probe_matmul_rate_launches = 0
    timings = mr.measure(device)
    phases = mr.measure_phases(device)
    launches = mr.probe_matmul_rate_launches
    log({"phase": "probe_matmul_rate", "card": card, "checks": checks,
         "timings": timings, "link_phases": phases,
         "plain_ms_m512": plain_ms, "launches": launches,
         "library": "torch.matmul / torch._int_mm chains (cuBLAS), eager "
                    "(library_*) and replayed from a CUDA graph "
                    "(library_graph_*)"})
    held = {(f"{r['schedule']}_{'int8' if r['dtype'] == 'int8' else 'bf16'}",
             r["m"], r["cluster"], r["ns"]) for r in checks}
    for r in timings:
        if "plan" in r and (r["variant"], r["m"], r["cluster"],
                            r["ns"]) not in held:
            raise AssertionError(
                f"{r['variant']} at M = {r['m']} was timed with a cluster "
                f"of {r['cluster']} and slices of {r['ns']} columns, which "
                f"no check held against the plain version")
    for r in timings:
        if r["shape"] == "tpu" and "over_library" in r \
                and r["over_library"] > 1:
            raise AssertionError(
                f"{r['variant']} at M = {r['m']} takes {r['ms']:.3f} ms, "
                f"{r['over_library']:.2f}x the eager cuBLAS chain")
    main = next(r for r in timings
                if (r["variant"], r["shape"]) == ("block_int8", "tpu"))
    library = next(r for r in timings
                   if (r["variant"], r["shape"]) == ("library_int8", "tpu"))
    return probe_kernel(
        "probe_matmul_rate", "probe_matmul_rate.cu",
        "benchmarks/probe_matmul_rate.py:45", launches,
        max_abs_err=max(r["max_abs_err"] for r in checks
                        if r["dtype"] == "int8"),
        ms=main["ms"], plain_ms=plain_ms["int8"], library_ms=library["ms"],
        **{k: main[k] for k in ("bound_ms", "bound_by", "bound_kind",
                                "bound_ms_by")})


def phase_overlap(device, card: str, p2_int8_block_ms: float) -> dict:
    """P4: the three modes against the plain version at M = 512 and 4224,
    its mxu mode against P2's int8 block chain bit for bit, then the
    probe's t_mxu, t_vpu, t_both and overlap fraction at both M, each mode
    beside the SFU's time on the SMs the plan holds, and at M = 512 mxu
    over P2's int8 block chain of this run."""
    import torch

    from diffusion_model_tpu_torch.probes import matmul_rate as mr
    from diffusion_model_tpu_torch.probes import overlap as ov

    checks = ov.check_on_card(device)
    a, w, y = ov.make_inputs(ov.M, ov.N, device)
    x_p4 = ov.overlap(a, w, y, ov.STEPS, "mxu")[0]
    x_p2 = mr.chain(a, w, ov.STEPS, "block")
    torch.cuda.synchronize()
    if not torch.equal(x_p4, x_p2):
        raise AssertionError(f"P4's mxu chain differs from P2's int8 block "
                             f"chain in {int((x_p4 != x_p2).sum())} values")
    plain_ms = cuda_ms(lambda: ov.overlap_reference(a, w, y), 3)
    ov.probe_overlap_launches = 0
    timings = ov.measure(device, reps=10)
    launches = ov.probe_overlap_launches
    main = timings[0]                        # M = 512, mode "both"
    main["mxu_over_p2_int8_block"] = main["mxu_ms"] / p2_int8_block_ms
    log({"phase": "probe_overlap", "card": card, "checks": checks,
         "mxu_equals_p2_block_chain": True, "timings": timings,
         "p2_int8_block_ms": p2_int8_block_ms, "launches": launches,
         "targets_m512": {
             "both_ms <= 1.5": main["both_ms"] <= 1.5,
             "mxu <= 1.15 x P2 int8 block": main["mxu_over_p2_int8_block"]
             <= 1.15,
             "vpu <= 2 x SFU on the plan's SMs":
             main["vpu_over_sfu_on_plan_sms"] <= 2.0}})
    return probe_kernel(
        "probe_overlap", "probe_overlap.cu",
        "benchmarks/probe_overlap.py:45", launches,
        max_abs_err=max(r["max_abs_err"] for r in checks
                        if r["steps"] != ov.STEPS),
        ms=main["both_ms"], plain_ms=plain_ms, library_ms=None,
        **{k: main[k] for k in ("bound_ms", "bound_by", "bound_kind",
                                "bound_ms_by", "overlap_fraction")})


def phase_pipeline(device, card: str) -> dict:
    """P3: both schedules against the plain version at the probe's shape,
    then ms per call beside F.silu(a @ w) through cuBLAS, and the verdict."""
    from diffusion_model_tpu_torch.probes import pipeline as pl

    checks = pl.check_on_card(device)
    a, w = pl.make_inputs(pl.ROWS, pl.K, pl.N, device)
    plain_ms = cuda_ms(lambda: pl.silu_product_reference(a, w), 3)
    pl.probe_pipeline_launches = 0
    timings = pl.measure(device)
    launches = pl.probe_pipeline_launches
    log({"phase": "probe_pipeline", "card": card, "checks": checks,
         "timings": timings, "launches": launches,
         "targets": {
             "pipelined < 0.9 x library": timings["pipelined_ms"]
             < 0.9 * timings["library_ms"],
             "seq <= library": timings["seq_ms"] <= timings["library_ms"],
             "pipelined <= 2 x bound": timings["pipelined_ms"]
             <= 2 * timings["bound_ms"]}})
    return probe_kernel(
        "probe_pipeline", "probe_pipeline.cu",
        "benchmarks/probe_pipeline.py:66", launches,
        max_abs_err=max(r["max_abs_err"] for r in checks),
        ms=timings["pipelined_ms"], plain_ms=plain_ms,
        library_ms=timings["library_ms"], seq_ms=timings["seq_ms"],
        **{k: timings[k] for k in ("bound_ms", "bound_by", "bound_kind",
                                   "bound_ms_by", "mufu_ops")})


def phase_kernel_stages(device, card: str) -> dict:
    """P1: every stage and x-branch variant against its plain version at
    N = 192 (int32 products bit for bit through the checksum, each mode
    twice bit for bit), padded targets inert, then ms per layer call of
    each beside the product alone through one PyTorch call, and the
    targets the redesign was held to (logged, not asserted)."""
    from diffusion_model_tpu_torch.probes import kernel_stages as ks

    table = ks.variants(device)
    checks = ks.check_on_card(table)
    padded = ks.check_padded(device)
    plain_ms = {name: cuda_ms(calls["plain"], 3)
                for name, calls in table.items()}
    ks.probe_kernel_stages_launches = 0
    timings = ks.measure(table, reps=20)
    launches = ks.probe_kernel_stages_launches
    ms = {r["mode"]: r["ms_per_layer_call"] for r in timings}
    library = {r["mode"]: r["library_ms"] for r in timings}
    log({"phase": "probe_kernel_stages", "card": card, "n": ks.N,
         "tile_rows": ks.TILE_ROWS, "cluster": ks.CLUSTER,
         "blocks": ks.grid(1, ks.N, ks.active_clusters(0, 0, True, ks.F1)),
         "checks": checks, "padded": padded, "timings": timings,
         "plain_ms": plain_ms, "launches": launches,
         "library": "the product alone: torch._int_mm (int8, both products "
                    "for the stages) or q @ w (bf16), no epilogue",
         "epilogue_share_of_mm_post": 1 - ms["mm"] / ms["mm_post"],
         "build_share_of_full_serial": 1 - ms["mm_post"] / ms["full_serial"],
         "int8_over_bf16_x": ms["x8"] / ms["xbf"],
         "targets": {
             "mm <= 0.15 ms": ms["mm"] <= 0.15,
             "x8 <= 0.12 ms": ms["x8"] <= 0.12,
             "xbf <= 0.16 ms": ms["xbf"] <= 0.16,
             "x8 / xbf <= 0.7": ms["x8"] / ms["xbf"] <= 0.7,
             "mm <= 1.25 x library": ms["mm"] <= 1.25 * library["mm"],
             "x8 <= 1.25 x library": ms["x8"] <= 1.25 * library["x8"],
             "xbf <= 1.25 x library": ms["xbf"] <= 1.25 * library["xbf"]}})
    return probe_kernel(
        "probe_kernel_stages", "probe_kernel_stages.cu",
        "benchmarks/probe_kernel_stages.py:126", launches,
        max_abs_err=max(r["max_abs_err"] for r in checks),
        ms=ms["mm"], plain_ms=plain_ms["mm"], library_ms=library["mm"],
        stages_ms=ms, stages_library_ms=library, **table["mm"]["bound"])


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "diffusion_model_tpu_torch").is_dir():
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from diffusion_model_tpu_torch.nn import egnn
    from diffusion_model_tpu_torch.ops import (
        _build,
        activations,
        egcl_knn,
        egcl_pair,
    )
    from diffusion_model_tpu_torch.probes import (
        kernel_stages,
        matmul_rate,
        overlap,
        pipeline,
    )
    from diffusion_model_tpu_torch.train.checkpoint import (
        load_config_npz,
        load_params_npz,
    )

    device = torch.device("cuda", 0)
    card = card_line()
    t0 = time.perf_counter()
    tensor_core = (egcl_pair, egcl_knn, matmul_rate, overlap, pipeline,
                   kernel_stages)
    modules = tensor_core + (activations,)
    _build.build_all([m._SOURCE for m in modules])
    for m in modules:
        m.build()
    build_s = time.perf_counter() - t0
    log({"phase": "toolchain", "nvidia_smi": card,
         "torch": torch.__version__, "torch_cuda": torch.version.cuda,
         "nvcc": _build.find_nvcc(), "kernel_build_s": build_s,
         "sass": check_sass([m._SOURCE for m in tensor_core])})

    cfg = load_config_npz(str(SNAPSHOT))
    params = load_params_npz(str(SNAPSHOT))
    graphs = phase_data()
    fx, cell = load_fixture(device)
    plain_calls = {}

    def kernels_only(name, phase, *args):
        """``phase(*args)``, which must never take the plain route."""
        egnn.plain_edge_calls = 0
        out = phase(*args)
        plain_calls[name] = egnn.plain_edge_calls
        if egnn.plain_edge_calls:
            raise AssertionError(f"{name} took the plain route "
                                 f"{egnn.plain_edge_calls} times")
        return out

    pair = phase_kernels(cfg, params, fx, cell, device)
    fused = phase_bias_silu(device)
    phase_denoiser(cfg, params, fx, device)
    served_counts, served = kernels_only("generate", phase_generate, cfg,
                                         params, graphs, device)
    pair_launches = served_counts["egcl_pair"]
    phase_score_devices(served, device)
    phase_evaluate_flagship(served, device, card)
    kernels_only("predict_sizes", phase_predict_sizes, cfg, params, graphs,
                 device, card)
    kernels_only("generate_learned", phase_generate_learned, device, card)
    kernels_only("trajectory", phase_trajectory, cfg, params, graphs, device)
    kernels_only("headline", phase_headline, cfg, params, cell, device, card)
    knn = phase_knn_kernel(cfg, params, fx, device)
    phase_knn_is_dense(cfg, params, fx, device)
    phase_denoiser(cfg, params, fx, device, k=GOLDEN_K)
    knn_counts, _ = kernels_only("generate_knn", phase_generate,
                                 cfg.replace(neighbor_k=SERVED_K), params,
                                 graphs, device)
    knn_launches = knn_counts["egcl_knn"]
    kernels_only("large_cell", phase_large_cell, cfg, params, device, card)
    grads = phase_train_grad(cfg, params, fx, device, card)
    kernels_only("train_parity", phase_train_parity, device, card)
    dense_train = kernels_only("train_flagship", phase_train_flagship, device,
                               card)
    knn_train = kernels_only("train_flagship_knn", phase_train_flagship,
                             device, card, SERVED_K, 1)
    kernels_only("train_learned", phase_train_learned, device, card)
    resume = kernels_only("checkpoint_resume", phase_checkpoint_resume,
                          device, card)
    heads = kernels_only("heads", phase_heads, cfg, params, fx, graphs,
                         device, card)
    strided = kernels_only("strided_scores", phase_strided_scores, device,
                           card)
    variants = phase_variants(cfg, params, device, card)
    phase_network_recipe(cfg, params, device, card)
    kabsch = kernels_only("kabsch_finetune", phase_kabsch_finetune, device,
                          card)
    polymorph = kernels_only("polymorph_pipeline", phase_polymorph_pipeline,
                             device, card)
    drivers = kernels_only("cli_drivers", phase_cli_drivers, device, card)
    served_export = kernels_only("served_export", phase_served_export,
                                 graphs, device, card)
    distilled = kernels_only("distill", phase_distill, graphs, device, card)
    latent = kernels_only("spectrum_latent", phase_spectrum_latent, device,
                          card)
    f9 = kernels_only("f9_replay", phase_f9_replay, device, card)
    from diffusion_model_tpu_torch import parallel

    parallel.init_single("nccl")
    try:
        data_parallel = kernels_only("data_parallel", phase_data_parallel,
                                     device, card, dense_train)
        kernels_only("ring", phase_ring, params, device, card)
    finally:
        torch.distributed.destroy_process_group()
    log({"phase": "flagship_routes", "plain_edge_calls": plain_calls,
         "egcl_pair_launches_served": pair_launches,
         "egcl_knn_launches_served": knn_launches,
         "bias_silu_launches_served": served_counts["bias_silu"],
         "launches_per_denoiser_call": launches_per_call(
             cfg.replace(compute_dtype="bfloat16"), params, fx, device)})
    phase_plain_route(device)
    p2 = phase_matmul_rate(device, card)
    probes = [p2, phase_overlap(device, card, p2["ms"]),
              phase_pipeline(device, card),
              phase_kernel_stages(device, card)]

    log({"phase": "timeline", "logged_at_s": dict(LOGGED_AT)})
    log({"kernels": [
        {"name": "egcl_pair", "route": "cuda",
         "source": "diffusion_model_tpu_torch/csrc/egcl_pair.cu",
         "replaces": "diffusion_model_tpu/ops/egcl_pallas.py:171",
         "launches": pair_launches, **pair,
         "train_launches": dense_train["launches"]["egcl_pair"],
         "resume_launches": resume["launches"]["egcl_pair"],
         "heads_launches": heads["egcl_pair"],
         "strided_launches": strided,
         "variants_launches": variants["egcl_pair"],
         "kabsch_launches": kabsch["launches"]["egcl_pair"],
         "polymorph_launches": polymorph["generate"]["launches"][
             "egcl_pair"],
         "cli_drivers_launches": drivers["k1_launches"],
         "served_launches": served_export["launches"]["egcl_pair"],
         "distill_launches": distilled["launches"]["egcl_pair"]
         + distilled["student_sampled"]["launches"]["egcl_pair"]
         + distilled["float32"]["launches"]["egcl_pair"],
         "latent_launches": latent["launches"]["egcl_pair"],
         "data_parallel_launches": data_parallel["launches"]["egcl_pair"],
         "train_grad": grads["egcl_pair_64x16_bfloat16"]},
        {"name": "egcl_knn", "route": "cuda",
         "source": "diffusion_model_tpu_torch/csrc/egcl_knn.cu",
         "replaces": "diffusion_model_tpu/ops/egcl_pallas_sparse.py:177",
         "launches": knn_launches, **knn,
         "train_launches": knn_train["launches"]["egcl_knn"],
         "heads_launches": heads["egcl_knn"],
         "variants_launches": variants["egcl_knn"],
         "kabsch_launches": kabsch["launches"]["egcl_knn"],
         "cli_drivers_launches": drivers["k2_launches"],
         "served_launches": served_export["launches"]["egcl_knn"],
         "train_grad": grads["egcl_knn_64x16_k15_bfloat16"]},
        {"name": "bias_silu", "route": "cuda",
         "source": "diffusion_model_tpu_torch/csrc/bias_silu.cu",
         "replaces": "none (no Pallas kernel): flax Dense bias + nn.silu, "
                     "diffusion_model_tpu/nn/egnn.py:388, fused by XLA",
         "launches": served_counts["bias_silu"], **fused,
         "knn_served_launches": knn_counts["bias_silu"],
         "f9_train_launches": f9["bias_silu_launches"]},
        *probes,
    ]})
    print(card_line(), flush=True)
    log({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
