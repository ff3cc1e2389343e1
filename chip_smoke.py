#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (prmers_tpu_torch) on one card.

Run from the repository root with no arguments: python3 chip_smoke.py
(one card; `python3 chip_smoke.py --mesh-only` runs phases 1 and 6b alone,
at every world size the machine's cards allow, beside the single card's
PRP iter/s at 136279841 and 332192831; `--tools-only` phases 1
and 7; `--anysize-only` phases 1 and 8; `--fft3161-only` phases 1 and 10;
`--modes-only` phases 1 and 9,
and with `--pm1-full` also M1362763's P-1 over its whole stage-2 range,
timed; `--ecm-goldens` (alone, or after `--modes-only`'s phase 9) the
reference's slow ECM goldens, M701 (Edwards) and M67 (both families), on
the batched path, then each once on the classic loop and M701 under
-arith fft3161, each timed; `--ecm-kernel-plan` 16 curves of ECM stage 1
as one batch against 16 classic curves at M756839 (n = 2^15), where the
classic loop runs FourStepEngine's kernels, timed; `python3
chip_smoke.py --mm31` runs phase 1 and the engine at MM31, p = 2^31 - 1, n = 5 * 2^25: two squarings of a dense value against
GMP, with the host table build's time and peak memory, then P-1 of MM31
(-b1 100 -b2 5000 -pm1-ultralowmem -nogcd-stage1, ~7,400 squarings and
one gcd of 2^31-bit numbers) through the CLI's entry, which must find
295257526626031).

It drives eight paths of the port: the n = 2^23 path (K1, K2, K3 with
whole-row carries), the C = 8192 big-shape path of n = 2^25 and 2^26
(K1 and K3 with T = 2 carry units per row, K5, K6 "fwd", K6b, K5), the
chain path of n = 2^15 ... 2^19 (K9, the whole squaring chain in one
persistent launch; K1-K3 for the multiplicand, mul and LL steps), the
block-carry path (Pipeline(rowcarry=False), PRMERS_NO_ROWCARRY: K4, the
C-transform, K4 inverse, K7) with its canonical-digit hybrid
(Pipeline(xla_carry=True), PRMERS_XLA_CARRY: carry_full in place of K7),
the radix-5 path of n = 5 * 2^k (the r2 factor L2 = 5 * 2^b a
natural-order DFT: K1, K2, K3 up to n = 5 * 2^22, the 100M-digit class
p = 332192831 at (64, 320, 1024); K1, K5, K6, K5, K3 from 5 * 2^23; the r2
launches of K2 and K5 in the 5 x 2^b split form), and the mesh
(parallel/: one process per card over torch.distributed with NCCL; the
row-carry MeshEngine runs K1, K5, K6, K5, K3 per rank, the block-carry
ShardedStep K4, K5, K6, K5, K4, K8, with all-to-alls between), the
tools (prmers_tpu_torch/tools/: the pass profiler's unfolded r passes K4u
and K5u, the microbenchmarks and the probes), the any-size engine
(engine/torch_engine.py: ops/ntt.py's transform in torch ops, no kernel of
its own, for every plan the four-step kernels do not take), and the
second arithmetic (engine/engine3161.py: fft3161 on K10-K12, one launch
per transform stage).
Phases; any failure raises and the script exits non-zero with no result:
  1. the card (nvidia-smi name and power limit) and the kernel build
     (one nvcc per prmers_tpu_torch/csrc/*.cu, all at once, timed);
  2. every kernel wrapper (K1; K2 and K6 in modes sqr/fwd/mul; K5 P2 and
     P6; K6b with head op sqr/mul/none on K6 "fwd"'s output; K3 with a =
     1, a = 3 and sub2; at a power-of-two length K1, K5, K2's r2
     launches, K3's first launch and both K4 launches run
     csrc/axis_fft.cuh's shift butterflies, their plain versions the
     dense matrices) against its plain torch version on the
     same inputs on the card, at n = 2^15, 2^18, 2^23, 2^25 (p = 600000001) and 2^26
     (p = 1000000007), at two forced pipelines (T = 4 carry units at
     n = 2^16; the split C-transform with T = 2 at 2^18), and at the
     radix-5 n = 5 * 2^16 (L2 = 5), 5 * 2^17, 2^18, 2^19, 2^20, 2^21 (L2 =
     10, 20, 40, 80, 160), 5 * 2^22 (L2 = 320, p = 332192831) and 5 * 2^23
     (p = 700000001, K5 at L2 = 320, K6 at ca = 16), K2 and K5 there (the
     r2 DFT in the split form, csrc/r2_split.cuh) as k2_fused_c[r5] and
     k5_axis1[r5]. K3 takes the C-transform's lazy output, as on the
     main path. Tolerance:
     none. The arithmetic is exact mod P: K1/K2/K5/K6/K6b outputs are
     compared after canon, K3's digits and unit carries bit for bit. The
     host table build time and peak memory are logged at every size. K9
     at n = 2^15, 2^16, 2^17, 2^18 and 2^19: a = [3, 1, 3] from random
     digits and random carries, then a chain of 2 that consumes the
     carries; digits and carries bit for bit against its plain version
     and against as many steps of the CUDA three-kernel path. At each
     size K4 forward (without and with (R1, 1) block carries; mod P) and
     inverse (on K3's input; bit for bit), and K7 with a = 1 and a = 3 on
     K4 inverse's output (digits and block carries bit for bit). At n =
     2^15 the four unfolded passes (K4u and K5u: forward_r with a scalar
     carry, inverse_r) in the matrix and the shift form, mod P;
  3. each path through create_engine and the Engine API the PRP/LL
     modes call, at p = 136279841, at p = 600000001, (the chain path)
     at p = 9999991 (n = 2^19), (the block-carry path) at p = 136279841,
     600000001 and 756839 (n = 2^15), (the hybrid) at p = 136279841 and
     (radix 5) at p = 332192831 on the row and the block carry, p =
     6972593 (n = 5 * 2^16, a Mersenne prime) and p = 700000001 (n =
     5 * 2^23, K5 + K6 + K5; no K9 on any radix-5 path): squarings and
     a x3 of a sparse value 3 * 2^s (its exact value is cheap), a dense x3
     squaring, set_multiplicand + mul and an LL sub2 step of dense random
     values, all checked against GMP big-int. The wrapper call counts (one
     per call that launched a kernel) are reset just before each path and
     read just after; every kernel of the path must be > 0, on the
     chain path K1-K3 run only for set_multiplicand, mul and the LL step,
     and on the block-carry and hybrid paths K1, K3 and K9 never run (nor
     K7 on the hybrid);
  4. the timed PRP chain (iter/s) at p = 136279841, 600000001,
     1000000007, 332192831 (row and block carry) and 700000001, and at
     p = 756839 and 9999991 through K9 and through the three-kernel step
     (Pipeline(chain=False)); at p = 136279841 the row carry, the block
     carry and the hybrid in turns; K9 against the three-kernel step,
     its move-only body (kernels.square_chain_part "move": the same grid,
     loads, stores and grid barriers, no products) and the plain chain,
     ms per squaring, at each n from 2^15 to 2^19; each
     kernel's time against its plain version at n = 2^23 (K1-K3, K4, K7),
     2^25 (the big-shape kernels, K4 and K7 again), 2^26 (K5 at L2 =
     128, its launches counted over the timed chain at p = 1000000007),
     2^19 (K9), 5 * 2^22 (K2 at L2 = 320) and 5 * 2^23 (K5 at L2 = 320),
     by CUDA events
     around each launch, queued behind a device sleep so that they time
     the device and not the host's enqueue,
     beside its bound: the larger of its bytes (each input read once, each
     output written once) over 3.35 TB/s and its mod-P products, 64 int8
     MACs = 128 int8 operations each in the JAX package's limb-plane form,
     over 1,979 TOP/s. No PyTorch call computes a Goldilocks product, so
     library_ms is null but for probe_shapes, each of whose cases has a
     one-call twin (torch._int_mm for the int8 dots b, e and n, a copy,
     concatenation, slice, sum or add for the others; phase 7);
  5. the PRP/LL driver in this process on the CLI's engine (K9), stopped
     (its Ctrl-C path) 20000 squarings before the end, leaves a
     checkpoint; then `python -m prmers_tpu_torch 756839 -proofverify`
     in a subprocess, the whole PRP of M756839 (n = 2^15, through K9),
     must report prime and write its proof (power best_power(p) = 6),
     which must verify, with the power and the file's md5 in the result
     JSON: its squarings run beside the same CLI with
     PRMERS_NO_ROWCARRY=1 (the block-carry path), which resumes from the
     checkpoint and must report prime, and its proof's host big-int build
     and check beside phases 6-8 (its result is read after phase 8);
  6. the mesh at p = 136279841 and at the 100M-digit p = 332192831 (n =
     5 * 2^22, (64, 320, 1024)): (a) on this card, the shard-local kernel
     forms of rank 0 and the last rank of s = 2 and 4 at both (K1, K3
     with a = 1, 3 and sub2 with the rank's amount, K4 both ways on the
     r2-sharded view; K5 (the radix-5 split at L2 = 320, on the r1 view's
     whole split tables), K6, K6b and K8 on the r1-sharded view), each
     against its plain version (exact as in phase 2), and K8 at the shard
     shapes of s = 1, 2, 4 at both sizes, K5's split at the radix-5 ones
     (with a = 1 and 3, or P2 and P6, against its plain version on the
     input it is then timed on), each time beside its bound (K8 20 bytes
     per digit, as K7);
     (b) for every s in {1, 2, 4} that torch.cuda.device_count() allows,
     s rank processes of this script (NCCL, one card each): ShardedStep
     on the block carry (three steps, K8) and MeshEngine (the phase-3
     ops, plus a sparse sub through the ring's lookahead) at both p (at
     s = 1 the radix-5 and XLA-form paths run in this process, whose
     radix-5 tables phase 2 built, unless --mesh-only), and
     the XLA-form ShardedEngine (PRMERS_SHARDED_IMPL=xla: the any-size
     engine's transform sharded, no kernel of its own) at 136279841 (x3
     and x1 squarings, digits and psum_res64), each against GMP on every
     rank, with each rank's wrapper counts (reset just before each path,
     read just after: every kernel of the path > 0, K2, K7 and K9 at 0),
     PRP iter/s through MeshEngine (192 squarings; 64 at 332192831),
     through the block carry (32) and through ShardedEngine (4), beside
     the single card's, and each collective's ms per squaring (CUDA
     events on the stream, the wait for the other ranks included); at
     s >= 2 M756839 through the CLI under torchrun with -backend sharded,
     where R2 = 1 leaves the mesh step no shape, so the fallback
     ShardedEngine resumes it 2000 squarings from its end and must report
     prime; at the largest such s M9941 under -backend sharded with
     PRMERS_PROOF_SHARDED=1 (the golden proof hashes, residues as rank
     shards);
     (c) `python -m torch.distributed.run --nproc_per_node=1 -m
     prmers_tpu_torch 756839 -noproof -backend sharded` resumes from the
     same checkpoint and must report prime; (d) M9941 through the CLI
     under -backend sharded with PRMERS_PROOF_SHARDED=1 on one rank
     (ShardedEngine in CUDA graphs), run beside phase 8's goldens:
     prime, the golden proof hashes, each residue as shard files;
     (e) prmers_tpu_torch/graft_entry.entry():
     one any-size squaring at p = 9941 on the card, 3 -> 9. A failure in
     any rank fails the run;
  7. the tools at full width: the pass profiler (tools/profile_passes) at
     p = 136279841, n = 2^23: K4 forward, K2, K4 inverse, and the unfolded
     passes K4u forward (with a scalar carry), K5u forward, K5u inverse,
     K4u inverse in the matrix and the shift form; the axis DFTs of
     csrc/axis_fft.cuh (profile_passes --axis: K1, K3a (launched as K4
     inverse) and K4 forward with block carries at 2^23 and 2^25, K5's P2
     and P6 at 2^23, 2^25 and 2^26, each beside its move-only body);
     the microbenchmarks
     (tools/microbench: the library's serial int8/bf16 products, probe_vpu
     and probe_mulmod with their rates; tools/microbench_fields:
     probe_fields for gl64, GF(M31^2) and GF(M61^2) mul/sqr and the fft3161
     ratio) and the probes (tools/probe_shapes: cases a-n;
     tools/probe_bitcast: the byte order), each time the median of its
     event pairs (mean and largest beside it; outputs allocated before
     the timing), beside an empty launch timed the same way (the floor of
     the method); the rep probes priced by the integer instructions of
     their compiled loops (tools/sass.py, cuobjdump), as slots of the
     busier of the SM's two integer pipes, over a pipe's rate (SMs x 64
     lanes x nvidia-smi's clocks.max.sm). The wrapper
     counts are reset just before and read just after, and every kernel
     of the phase must be > 0; then each timed launch's output is held
     against its plain version on the same inputs (exact mod P for
     K4u/K5u and the field ops after canon, bit for bit for the rest),
     and each time stands beside its bound and the card; the shape cases
     slower than their one-call twin (by median) are listed;
  8. the any-size engine (engine/torch_engine.TorchEngine, what
     create_engine gives where the four-step engine does not take the
     plan, and for every p under PRMERS_NO_PALLAS): the table build time
     (numpy on the host, then to the card) and PRP iter/s with each
     squaring a CUDA graph and eager, in turns, with the CUDA launches of
     one eager squaring, at n = 512 (p = 9941), 4096 (100003) and 81920
     (1600003); at p = 1600003 (n = 5 * 2^14, the widest plan only this
     engine takes, through create_engine) 64 squarings with a = [3, 1], a
     multiplicand, mul, sub, add_small and addsub against GMP; the
     reference goldens through the CLI in subprocesses, side by side on
     the card while this process builds the 2^23 tables: M127 -ll and
     -llsafe prime, M2699 with its 5 known factors PRP and with 4
     composite, M9941's proof hashes (tests/test_proof.py) and the proof
     verified, M11213's res64 every 1000 iterations and its final res64 1
     (tests/test_prp_ll.py:127-149) in one chain, phase 6's (d) in the
     other (M100003's res64 and res2048, :106-124, are phase 10's, under
     -arith fft3161: its gl64 run, 194-214 s, the smoke's long pole, made
     room for phase 6's mesh checks); then at p = 136279841
     under PRMERS_NO_PALLAS (n = 2^23)
     8 squarings of a dense value against GMP and FourStepEngine, with
     the table build time and iter/s;
  9. the modes (modes/pm1.py, ecm.py, ecm_edwards.py, memtest.py,
     bench.py, app.py's worktodo loop and -filemers, engine/paged.py),
     against the reference's goldens. Through the CLI in two chains of
     subprocesses, started beside phase 8's goldens, on the any-size
     engine: P-1 of M541 (-b1 899: 4312790327) with -resume, whose
     stage-1 residue, written as a .mers, -filemers turns into the .save
     the reference's interop writes (sha256 below); M367 (-b1 11981 -b2
     38971) on V-trace (stage 1 646300400639, stage 2
     50500996776315830904406967), on ultralowmem, and paged onto 4 device
     slots (PRMERS_MAX_DEVICE_REGS=4, the [ALLOC] line); ECM of M29 and
     M37, Edwards and -montgomery, at the reference tests' bounds and
     seeds, each with the factor, curve and stage of the reference's
     numpy run; a worktodo file of a Pminus1 line for M541 and a PRP line
     for M9941, both results in -results and their JSON files, the file
     left empty. In this process, through app.main (the CLI's entry) so
     the wrapper counts show (reset just before, read just after; K9, K1,
     K2, K3 each > 0): P-1 on the kernel engine of M544139 (-b1 3 -b2 7:
     22853839 in both stages) and of M1362763 (-b1 29 -b2 6910159, known
     factors 46333943 and 282345414919, -b2start 6900000:
     28401397572100073); one Edwards curve's stage 1 (B1 = 50) at p =
     544139 on FourStepEngine, whose point must equal the any-size
     engine's; memtest at p = 136279841 (0 errors); -bench over (9941,
     756839) with its PRMERS_SCORE line; and each engine's device bytes
     per word beside its registers (tables, an op's temporaries) against
     engine/paged.OVERHEAD_BYTES, what the paging budget charges. The
     CLI chains above run their ECM goldens under PRMERS_ECM_NO_BATCH=1
     (the reference's numpy runs were the classic loop); a third chain
     runs the validation matrix's quick profile
     (tools/validation_matrix.py: numpy/gl64, jax/gl64 on the card,
     numpy/fft3161 and pallas/gl64 where the four-step engine takes the
     plan, which no quick case's is), which must exit 0: every column
     agrees on every case. After the chains,
     in this process: batched ECM (engine/batch.py) at M37 in both
     families against the classic loop (PRMERS_ECM_NO_BATCH=1): the same
     factor, for Montgomery also the same curve and stage, and the
     batched line logged; the rate, 16 curves of stage 1 (B1 = 40, no
     factor: every curve runs to its end) as 16 lanes of one batch
     against 16 classic curves, in curves per second, with each run's
     peak device bytes and kernel wrapper counts, at M9941 (n = 512) and
     at M544139 (n = 2^15, where the classic loop runs the kernel
     engine, whose kernels it must launch); the CUDA launches of one eager
     batched squaring beside a single lane's; -gui on M127 on a free port, whose
     /api/state must answer while the run makes its engine.

 10. the second arithmetic (fft3161, engine/engine3161.py: the paired
     GF(M31^2) x GF(M61^2) NTT on K10 f3_fwd_stage, K11 f3_inv_stage and
     K12 f3_pointwise, csrc/f3_ntt.cu): (a) each kernel against its plain
     version (ops/ntt2.py) on random digits at n = 8, 288 (9 * 2^5), 3072
     (3 * 2^10), 98304 (3 * 2^15) and 2^22 (p = 127, 11213, 100003,
     3021377, 136279841), every forward stage from the digits, K12
     squaring and times a multiplicand, every inverse stage to the CRT's
     (lo, hi), exact (canonical words; tolerance none), with the host
     table build's time; at 2^22 each launch timed (CUDA events behind a
     device sleep, the better of two runs of 5) beside its plain version
     and its bound (bytes: both
     planes read and written once, the stage's twiddles, the digits and
     weights or unweights and (lo, hi) at the ends, over 3.35 TB/s;
     base-field products priced as the Goldilocks ones, 8 x 8 int8 limb
     MACs for M61 and 4 x 4 for M31, over 1,979 TOP/s); (b) Engine3161
     through create_engine(arith="fft3161") against GMP at those five
     sizes (8 squarings with a = 3 and 1, set_multiplicand + mul x 3,
     add, sub_reg, sub) and 64 squarings (a = 1, 3 in turn) at
     136279841, each op a CUDA graph, the wrapper counts reset just
     before and read just after (a replay counts what its capture
     recorded; K10-K12 each > 0); (c) PRP iter/s of Engine3161 beside
     the gl64 engine at p = 100003, 3021377 and 136279841 (n = 3072 vs
     4096, 98304 vs 163840, 2^22 vs 2^23), in turns; (d), checked before
     (a) so that no other process shares the card with the timings: the
     reference goldens under -arith fft3161 through the CLI (started
     beside phase 8's, or at the phase's start): M127 -ll and M1279 PRP
     prime, M9941's proof hashes equal to phase 8's and the proof
     verified, the M11213 res64 stream and final res64, M100003's res64
     and res2048; (e) -tune capped at 756839 (the
     ladder 127 ... 756839, both arithmetics, the one-rank mesh where it
     takes the shape) into its own save dir, and the decide_arith
     decision those rates give at each ladder p, with its reason; (f)
     one -profile run (M9941) with its report.

The last lines of standard output are the smoke's total seconds, the
per-kernel JSON object (k8_local's launches from the s = 1 ranks' drive,
its time at the s = 1 shape; k4u_pass and k5u_pass the mean of their
forward and inverse pass at n = 2^23, in each form; probe_fields and
probe_shapes the sums over their ops and cases), the card's name and power limit, and {"ok":
true, "device": {...}}.
"""

import atexit
import hashlib
import json
import math
import os
import random
import shutil
import socket
import subprocess
import sys
import threading
import time
import tracemalloc
from concurrent.futures import ThreadPoolExecutor

P_MAIN = 136279841      # n = 2^23
P_BIG = 600000001       # n = 2^25
P_HUGE = 1000000007     # n = 2^26
P_CHAIN = 9999991       # n = 2^19, the top of K9's range (L2 = 8)
P_GOLDEN = 756839       # n = 2^15, K9's smallest shape
P_R5 = 332192831        # n = 5 * 2^22, (64, 320, 1024): 100M digits
P_R5_SMALL = 6972593    # n = 5 * 2^16, (64, 5, 1024); M6972593 is prime
P_R5_BIG = 700000001    # n = 5 * 2^23, (64, 320, 2048): K5 + K6 + K5
P_MM31 = 2147483647     # n = 5 * 2^25, (64, 320, 8192), T = 2 (--mm31)
MM31_PM1_FACTOR = 295257526626031   # P-1 -b1 100 -b2 5000 (BASELINE.md)
GOLDEN_TAIL = 20000     # squarings the resumed CLI runs of M756839 take
DRIVE_K = 8             # the sparse chain's squarings in a phase-3 drive
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15
OPS_PER_PRODUCT = 128   # 64 int8 MACs per mod-P product (limb planes)

# (name in the JSON line, wrapper counter, the path whose counts it
# reports); K10-K12 (the fft3161 path, phase 10) the mean of their
# launches in one squaring at n = 2^22 (every forward stage, every
# inverse stage, the square); the main path's kernels are timed at n =
# 2^23, the big path's
# at 2^25, K9 at 2^19 (per squaring), the block path's K4 and K7 at 2^23
# (the block path's p = 136279841), K2 at L2 = 320 at n = 5 * 2^22, K5
# at L2 = 320 at 5 * 2^23, and K5 at L2 = 128 at 2^26 (its launches from
# phase 4's timed PRP chain at p = 1000000007, the "huge" path)
ENTRIES = [
    ("k1_p1c", "k1_p1c", "main"),
    ("k2_fused_c", "k2_fused_c", "main"),
    ("k3_p7c", "k3_p7c", "main"),
    ("k1_p1c[T>1]", "k1_p1c", "big"),
    ("k3_p7c[T>1]", "k3_p7c", "big"),
    ("k5_axis1", "k5_axis1", "big"),
    ("k5_axis1[L2=128]", "k5_axis1", "huge"),
    ("k6_fused_c", "k6_fused_c", "big"),
    ("k6b_fused_c_invh", "k6b_fused_c_invh", "big"),
    ("k9_chain", "k9_chain", "chain"),
    ("k4_axis0", "k4_axis0", "block"),
    ("k7_block_carry", "k7_block_carry", "block"),
    ("k8_local", "k8_local", "mesh"),
    ("k2_fused_c[r5]", "k2_fused_c", "r5"),
    ("k5_axis1[r5]", "k5_axis1", "r5 big"),
    ("k4u_pass", "k4u_pass", "tools"),
    ("k4u_pass[shift]", "k4u_pass", "tools"),
    ("k5u_pass", "k5u_pass", "tools"),
    ("k5u_pass[shift]", "k5u_pass", "tools"),
    ("probe_vpu", "probe_vpu", "tools"),
    ("probe_mulmod", "probe_mulmod", "tools"),
    ("probe_fields", "probe_fields", "tools"),
    ("probe_bitcast", "probe_bitcast", "tools"),
    ("probe_shapes", "probe_shapes", "tools"),
    ("f3_fwd_stage", "f3_fwd_stage", "fft3161"),
    ("f3_inv_stage", "f3_inv_stage", "fft3161"),
    ("f3_pointwise", "f3_pointwise", "fft3161"),
]
MESH_KERNELS = ("k1_p1c", "k3_p7c", "k4_axis0", "k5_axis1", "k6_fused_c",
                "k8_local")
MESH_OFF = ("k2_fused_c", "k7_block_carry", "k9_chain")


def log(*args):
    print(*args, flush=True)


def timed(fn, reps):
    """ms per call of fn, CUDA events around reps calls back to back."""
    import torch
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def device_timed(fn, reps):
    """ms per call of fn on the device: CUDA events around each call,
    each pair queued behind a device sleep (~1 ms) so that the host
    has enqueued the call before the device reaches the first event;
    back-to-back calls would time the host's enqueue wherever it is
    slower than the kernel."""
    import torch
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        torch.cuda._sleep(2_000_000)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        pairs.append((e0, e1))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / reps


def drive_values(p: int):
    """The values a phase-3 drive at p sets, from random.Random(p), and
    what GMP says its ops must give, as digit vectors of p's plan: (v, w,
    s, (the sparse chain (3 * 2^s)^(2^DRIVE_K) ^2 * 3, v^2 * 3 * w,
    w^2 - 2)). The GMP products release the GIL, so the smoke computes
    these on threads while the card works, and the drive compares digits
    (a vector compare) instead of rebuilding big ints from the card's."""
    from prmers_tpu_torch.core.plan import cached_plan
    from prmers_tpu_torch.utils import digits as dg
    from prmers_tpu_torch.utils import gmp
    mp = (1 << p) - 1
    rnd = random.Random(p)
    v, w = rnd.getrandbits(p - 1), rnd.getrandbits(p - 1)
    s = rnd.randrange(p // 2, p)
    c, e = 3, s                             # value c * 2^e mod M_p
    for _ in range(DRIVE_K + 1):
        c, e = c * c, 2 * e % p
    vv = gmp.mersenne_mod(gmp.mul(v, v) * 3, p)
    want = (gmp.mersenne_mod(c * 3 << e, p),
            gmp.mersenne_mod(gmp.mul(vv, w), p),
            (gmp.mersenne_mod(gmp.mul(w, w), p) - 2) % mp)
    widths = cached_plan(p).widths
    return v, w, s, tuple(dg.int_to_digits(x, widths) for x in want)


def golden_checkpoint(root: str, dev, tail: int, phase: int = 5) -> str:
    """The PRP/LL driver in this process, on the engine the CLI takes
    (K9), stopped through its Ctrl-C path before the chunk that would pass
    `tail` squarings from the end of M756839; returns the checkpoint it
    writes there."""
    from prmers_tpu_torch.core import checkpoints as ck
    from prmers_tpu_torch.engine.factory import create_engine
    from prmers_tpu_torch.io.cli import parse_args
    from prmers_tpu_torch.modes.prp_ll import R0, run_prp_or_ll
    ck_dir = os.path.join(root, "build", f"smoke_ckpt_{tail}")
    shutil.rmtree(ck_dir, ignore_errors=True)
    opts = parse_args([str(P_GOLDEN), "-noproof", "-save-dir", ck_dir])
    eng = create_engine(P_GOLDEN, 8, device=dev)
    seq, done = eng.square_mul_seq, [0]

    def stop_near_end(src, a_vec):
        if src == R0:
            if done[0] + len(a_vec) > P_GOLDEN - tail:
                raise KeyboardInterrupt
            done[0] += len(a_vec)
        seq(src, a_vec)

    eng.square_mul_seq = stop_near_end
    t1 = time.perf_counter()
    r = run_prp_or_ll(opts, eng=eng, log=lambda *a, **k: None)
    path = ck.ckpt_filename(P_GOLDEN, "prp", False, ck_dir)
    log(f"[{phase}] M{P_GOLDEN} PRP in this process stopped at iteration "
        f"{r.iteration} of {P_GOLDEN} in {time.perf_counter() - t1:.3f} "
        f"s; checkpoint {path}")
    if not r.interrupted or r.iteration < P_GOLDEN - 2 * tail \
            or not os.path.exists(path):
        raise AssertionError("no checkpoint near the end of M756839")
    return path


def torchrun_cli(root: str, s: int, tag: str, args, env=None,
                 resume=None, timeout=900, phase=6):
    """`python -m torch.distributed.run --standalone --nproc_per_node=s -m
    prmers_tpu_torch <args>` with its own save dir (from the checkpoint
    resume, if given); returns (rc, its output, seconds, the result JSON
    or {})."""
    d = os.path.join(root, "build", "smoke_mesh_cli", tag)
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    if resume is not None:
        shutil.copy(resume, d)
    env = dict(os.environ, PYTHONUNBUFFERED="1", **(env or {}))
    env.setdefault("NCCL_SOCKET_IFNAME", "lo")
    t1 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc_per_node={s}", "-m", "prmers_tpu_torch", *args,
         "-save-dir", d], cwd=root, capture_output=True, text=True,
        timeout=timeout, env=env)
    dt = time.perf_counter() - t1
    tail = r.stdout.strip().splitlines()[-1] if r.stdout.strip() else ""
    log(f"[{phase}] torchrun s={s} {' '.join(args)}: rc={r.returncode} in "
        f"{dt:.3f} s: {tail[:200]}")
    try:
        doc = json.loads(tail)
    except ValueError:
        doc = {}
    return r.returncode, r.stdout + r.stderr, dt, doc


def check_fallback_run(s, rc, out, doc) -> None:
    """M756839 resumed through -backend sharded at s ranks: the fallback
    engine ran and the run reports prime."""
    if rc != 0 or doc.get("status") != "P" or \
            "using ShardedEngine" not in out or \
            "Resuming from a checkpoint." not in out:
        raise AssertionError(f"M{P_GOLDEN} on the fallback at s={s} did "
                             f"not report prime:\n{out[-3000:]}")


def check_sharded_proof(s, rc, out, doc, d=None, phase=6) -> None:
    """M9941 through -backend sharded under PRMERS_PROOF_SHARDED=1: the
    fallback engine, prime, the golden hashes, and residues as shards."""
    lines = [ln.strip() for ln in out.splitlines()
             if ln.strip().startswith("proof [")]
    if rc != 0 or doc.get("status") != "P" or lines != GOLDEN_9941 or \
            "using ShardedEngine" not in out:
        raise AssertionError(f"M9941's sharded proof at s={s} is wrong "
                             f"({lines}):\n{out[-3000:]}")
    if d is not None:
        pd = os.path.join(d, "9941", "proof")
        names = os.listdir(pd)
        if not names or not all(x.endswith(".shards") for x in names):
            raise AssertionError(f"no sharded residues in {pd}: {names}")
    log(f"[{phase}] M9941 at s={s} under -backend sharded with "
        f"PRMERS_PROOF_SHARDED=1: {lines[0]} (golden)")


def mesh_rank(out_dir: str) -> int:
    """One rank of phase 6b (run as `chip_smoke.py --mesh-rank OUT_DIR`
    with RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT set):
    the block-carry ShardedStep and MeshEngine at p = 136279841 against
    GMP, the wrapper counts, PRP iter/s and the collectives' ms; the same
    at the radix-5 p = 332192831 (mesh_rank_r5); the XLA-form
    ShardedEngine at 136279841 (mesh_rank_xla); writes
    OUT_DIR/<rank>.json."""
    import torch
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from prmers_tpu_torch.engine.factory import create_engine
    from prmers_tpu_torch.ops import fourstep as tfs
    from prmers_tpu_torch.ops import kernels as tk
    from prmers_tpu_torch.parallel import dist
    from prmers_tpu_torch.parallel.sharded_kernels import ShardedStep
    from prmers_tpu_torch.utils import digits as dg
    from prmers_tpu_torch.utils import gmp

    dist.init_from_env()
    s, rank = dist.process_count(), dist.rank()
    p = P_MAIN
    mp = (1 << p) - 1
    v = random.Random(p).getrandbits(p - 1)       # drive_values' v
    res = {"s": s, "rank": rank, "device": str(dist.device())}

    def sqr(x, a=1):
        return gmp.mersenne_mod(gmp.mul(x, x) * a, p)

    # the GMP side, on threads while the card works
    pool = ThreadPoolExecutor(max_workers=3)
    expected = pool.submit(drive_values, p)
    block_want = pool.submit(lambda: sqr(sqr(sqr(v)), 3))

    # the block carry: ShardedStep, K8 at the end of each step
    t0 = time.perf_counter()
    st = ShardedStep(p, pipe=tfs.Pipeline(rowcarry=False))
    res["tables_s"] = time.perf_counter() - t0
    st.set_digits(dg.int_to_digits(v, st.plan.widths))
    torch.cuda.synchronize()
    dist.barrier()
    tk.reset_calls()
    st.step(2)
    st.step(1, 3)
    torch.cuda.synchronize()
    res["block_calls"] = dict(tk.calls)
    res["block_ok"] = st.get_int() == block_want.result()
    st.step(4)
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    st.step(32)
    torch.cuda.synchronize()
    res["block_ips"] = 32 / (time.perf_counter() - t0)
    del st

    # the row carry: MeshEngine through create_engine, phase 3's ops
    eng = create_engine(p, 6, backend="sharded")
    v, w, sh, want = expected.result()
    eng.set(0, 3 << sh)
    eng.set(1, v)
    eng.set(2, w)
    eng.copy(4, 2)
    eng.set(5, 81)
    eng.sync()
    dist.barrier()
    tk.reset_calls()
    c0 = dict(dist.counts)
    t0 = time.perf_counter()
    res["engine_ok"] = engine_ops(eng, want, sh, v, w, mp)
    res["engine_s"] = time.perf_counter() - t0
    res["engine_calls"] = dict(tk.calls)
    res["collectives"] = {k: n - c0[k] for k, n in dist.counts.items()}

    # PRP iter/s, then each collective's ms per squaring
    eng.set(0, 3)
    eng.square_mul_seq(0, [1] * 16)
    eng.sync()
    dist.barrier()
    t0 = time.perf_counter()
    eng.square_mul_seq(0, [1] * 192)
    eng.sync()
    res["ips"] = 192 / (time.perf_counter() - t0)
    dist.time_collectives(True)
    eng.square_mul_seq(0, [1] * 32)
    res["collective_ms"] = {k: ms / 32
                            for k, ms in dist.collective_ms().items()}
    dist.time_collectives(False)
    del eng
    torch.cuda.empty_cache()
    if os.environ.get("SMOKE_MESH_EXTRAS") == "1":
        # their GMP values on threads from here: none runs beside a timing
        v5, jobs = extras_jobs(pool)
        res.update(mesh_rank_r5(jobs[0], jobs[1], v5,
                                lambda: [j.result() for j in jobs]))
        res.update(mesh_rank_xla(jobs[2], v))
    pool.shutdown()
    with open(os.path.join(out_dir, f"{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.shutdown()
    return 0


def engine_ops(eng, want, sh, v, w, mp) -> list:
    """Phase 3's ops on a mesh engine whose registers 0-5 hold 3 * 2^sh, v,
    w, -, w and 81 (drive_values' values): the sparse chain and x3, v^2
    x3 x w through a multiplicand, the LL step, a sparse sub through the
    ring's lookahead and one through zero; each against GMP."""
    import numpy as np
    eng.square_mul_seq(0, [1] * DRIVE_K)    # (3 * 2^sh)^(2^K)
    eng.square_mul(0, 3)                    # ^2 * 3
    eng.square_mul(1, 3)                    # v^2 * 3
    eng.set_multiplicand(3, 2)
    eng.mul(1, 3)                           # v^2 * 3 * w
    eng.square_sub2_seq(4, 1)               # w^2 - 2
    eng.sub(5, 2)                           # a sparse sub: the lookahead
    eng.sub(5, 100)                         # through zero
    eng.sync()
    ok = [bool(np.array_equal(eng.get_digits(r), want[i]))
          for i, r in enumerate((0, 1, 4))]
    return ok + [eng.get_int(5) == (79 - 100) % mp]


def extras_jobs(pool, drive5=None):
    """The GMP side of the radix-5 and XLA-form mesh checks on pool's
    threads: (v5, [drive_values(P_R5) (drive5, where a caller has it),
    v5's three squarings then x3 (the block steps), P_MAIN's v squared x3
    then squared (ShardedEngine)])."""
    from prmers_tpu_torch.utils import gmp

    def sqr(x, a, q):
        return gmp.mersenne_mod(gmp.mul(x, x) * a, q)

    v5 = random.Random(P_R5).getrandbits(P_R5 - 1)    # drive_values' v
    v = random.Random(P_MAIN).getrandbits(P_MAIN - 1)
    return v5, [drive5 or pool.submit(drive_values, P_R5),
                pool.submit(lambda: sqr(sqr(sqr(v5, 1, P_R5), 1, P_R5), 3,
                                        P_R5)),
                pool.submit(lambda: sqr(sqr(v, 3, P_MAIN), 1, P_MAIN))]


def mesh_rank_r5(expected5, block_want5, v5, settle) -> dict:
    """The radix-5 mesh at p = 332192831, n = 5 * 2^22, (64, 320, 1024),
    on this rank of the group: the block-carry ShardedStep (three steps,
    K8) and MeshEngine (phase 3's ops) against GMP, each path's wrapper
    counts (reset just before, read just after) and PRP iter/s through
    MeshEngine (64 squarings), timed once settle() has waited for every
    GMP thread."""
    import torch
    from prmers_tpu_torch.engine.factory import create_engine
    from prmers_tpu_torch.ops import fourstep as tfs
    from prmers_tpu_torch.ops import kernels as tk
    from prmers_tpu_torch.parallel import dist
    from prmers_tpu_torch.parallel.mesh_engine import MeshEngine
    from prmers_tpu_torch.parallel.sharded_kernels import ShardedStep
    from prmers_tpu_torch.utils import digits as dg
    res = {}
    t0 = time.perf_counter()
    st = ShardedStep(P_R5, pipe=tfs.Pipeline(rowcarry=False))
    res["r5_tables_s"] = time.perf_counter() - t0
    res["r5_shape"] = list(st.tables.shape)
    st.set_digits(dg.int_to_digits(v5, st.plan.widths))
    torch.cuda.synchronize()
    dist.barrier()
    tk.reset_calls()
    st.step(2)
    st.step(1, 3)
    torch.cuda.synchronize()
    res["r5_block_calls"] = dict(tk.calls)
    res["r5_block_ok"] = st.get_int() == block_want5.result()
    del st
    eng = create_engine(P_R5, 6, backend="sharded")
    if type(eng) is not MeshEngine:
        raise AssertionError(f"-backend sharded gave {type(eng).__name__} "
                             f"at p={P_R5}")
    v, w, sh, want = expected5.result()
    for r, x in enumerate((3 << sh, v, w, 0, w, 81)):
        eng.set(r, x)
    eng.sync()
    dist.barrier()
    tk.reset_calls()
    t0 = time.perf_counter()
    res["r5_engine_ok"] = engine_ops(eng, want, sh, v, w, (1 << P_R5) - 1)
    res["r5_engine_s"] = time.perf_counter() - t0
    res["r5_engine_calls"] = dict(tk.calls)
    settle()
    eng.set(0, 3)
    eng.square_mul_seq(0, [1] * 8)
    eng.sync()
    dist.barrier()
    t0 = time.perf_counter()
    eng.square_mul_seq(0, [1] * 64)
    eng.sync()
    res["r5_ips"] = 64 / (time.perf_counter() - t0)
    del eng
    torch.cuda.empty_cache()
    return res


def mesh_rank_xla(xla_want, v) -> dict:
    """The XLA-form ShardedEngine (PRMERS_SHARDED_IMPL=xla) at p =
    136279841, n = 2^23, on this rank of the group: its table build, x3
    then x1 squarings of v against GMP (digits and psum_res64), PRP
    iter/s over 4 squarings."""
    import numpy as np
    import torch
    from prmers_tpu_torch.engine.factory import create_engine
    from prmers_tpu_torch.parallel import dist
    from prmers_tpu_torch.parallel.sharded import ShardedEngine, psum_res64
    from prmers_tpu_torch.utils import digits as dg
    res = {}
    os.environ["PRMERS_SHARDED_IMPL"] = "xla"
    try:
        t0 = time.perf_counter()
        eng = create_engine(P_MAIN, 2, backend="sharded")
        res["xla_tables_s"] = time.perf_counter() - t0
    finally:
        del os.environ["PRMERS_SHARDED_IMPL"]
    if type(eng) is not ShardedEngine:
        raise AssertionError(f"PRMERS_SHARDED_IMPL=xla gave "
                             f"{type(eng).__name__}")
    res["xla_graphs"] = eng.graphs
    eng.set(0, v)
    eng.square_mul(0, 3)
    eng.square_mul(0, 1)
    want = xla_want.result()
    wd = dg.int_to_digits(want, eng.widths)
    res["xla_ok"] = [bool(np.array_equal(eng.get_digits(0), wd)),
                     psum_res64(eng.tables, eng.regs[0]) ==
                     want & ((1 << 64) - 1)]
    eng.sync()
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(4):
        eng.square_mul(0, 1)
    eng.sync()
    res["xla_ips"] = 4 / (time.perf_counter() - t0)
    del eng
    torch.cuda.empty_cache()
    return res


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


MESH_R5_ROW = ("k1_p1c", "k3_p7c", "k5_axis1", "k6_fused_c")
MESH_R5_BLOCK = ("k4_axis0", "k5_axis1", "k6_fused_c", "k8_local")
FALLBACK_TAIL = 2000    # squarings M756839 resumes on the XLA-form engine


def mesh_drive(root: str, card: str, dev=None, single=None,
               extras_at_1=False) -> dict:
    """Phase 6b: the ranks at every s in {1, 2, 4} the cards allow, each
    checked; at s >= 2 (and at s = 1 with extras_at_1) the radix-5 and
    XLA-form paths too (mesh_rank_r5, mesh_rank_xla; check_extras), and
    M756839 through the CLI under -backend sharded on s ranks (R2 = 1:
    the fallback ShardedEngine), resumed FALLBACK_TAIL squarings from its
    end; at the largest s M9941's proof with PRMERS_PROOF_SHARDED=1.
    single: the one-card PRP iter/s at P_MAIN and P_R5 to log beside the
    mesh's. Returns {s: [each rank's result]}."""
    import torch
    out = {}
    cards = torch.cuda.device_count()
    fallback_ckpt = None
    for s in (1, 2, 4):
        if s > cards:
            break
        run_dir = os.path.join(root, "build", "smoke_mesh", str(s))
        shutil.rmtree(run_dir, ignore_errors=True)
        os.makedirs(run_dir)
        env = dict(os.environ, WORLD_SIZE=str(s), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(_free_port()),
                   SMOKE_MESH_EXTRAS="1" if s > 1 or extras_at_1 else "0")
        env.setdefault("NCCL_SOCKET_IFNAME", "lo")
        t1 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--mesh-rank",
             run_dir], cwd=root, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
            env=dict(env, RANK=str(r), LOCAL_RANK=str(r)))
            for r in range(s)]
        try:
            texts = [pr.communicate(timeout=600)[0] for pr in procs]
        finally:
            for pr in procs:
                if pr.poll() is None:
                    pr.kill()
                    pr.wait()
        for r, (pr, text) in enumerate(zip(procs, texts)):
            if pr.returncode != 0:
                raise AssertionError(f"mesh rank {r} of {s} failed "
                                     f"({pr.returncode}):\n{text[-3000:]}")
        ranks = []
        for r in range(s):
            with open(os.path.join(run_dir, f"{r}.json")) as f:
                ranks.append(json.load(f))
        log(f"[6] s={s}: {s} ranks in {time.perf_counter() - t1:.3f} s")
        for res in ranks:
            calls = {k: res["block_calls"][k] + res["engine_calls"][k]
                     for k in res["block_calls"]}
            log(f"[6]   rank {res['rank']} ({res['device']}): tables "
                f"{res['tables_s']:.3f} s; block step vs GMP "
                f"{res['block_ok']}, calls {res['block_calls']}; engine "
                f"ops in {res['engine_s']:.3f} s vs GMP (sparse chain, x3 + "
                f"mul, sub2, sparse sub) {res['engine_ok']}, calls "
                f"{res['engine_calls']}, collectives {res['collectives']}")
            if not res["block_ok"] or not all(res["engine_ok"]):
                raise AssertionError(f"the mesh at s={s} disagrees with GMP "
                                     f"on rank {res['rank']}")
            missing = [k for k in MESH_KERNELS if calls[k] <= 0]
            ran_off = [k for k in MESH_OFF if calls[k]]
            if missing or ran_off or res["block_calls"]["k8_local"] <= 0:
                raise AssertionError(f"mesh rank {res['rank']} at s={s}: "
                                     f"not launched {missing}, launched "
                                     f"{ran_off}: {calls}")
        r0 = ranks[0]
        log(f"[6] PRP {r0['ips']:.6f} iter/s @ p={P_MAIN} through the mesh "
            f"at s={s} (rank 0; ranks {[r['ips'] for r in ranks]}), "
            f"{r0['block_ips']:.6f} through its block carry (K8); "
            f"collective ms per squaring {r0['collective_ms']} ({card})")
        if "r5_ips" in r0:
            check_extras(ranks, s, card, single)
        if s >= 2:
            if fallback_ckpt is None:
                fallback_ckpt = golden_checkpoint(root, dev, FALLBACK_TAIL,
                                                  phase=6)
            rc, text, _dt, doc = torchrun_cli(
                root, s, f"fallback{s}",
                (str(P_GOLDEN), "-noproof", "-backend", "sharded"),
                resume=fallback_ckpt)
            check_fallback_run(s, rc, text, doc)
        if s >= 2 and 2 * s > cards:
            rc, text, _dt, doc = torchrun_cli(
                root, s, f"proof{s}", ("9941", "-backend", "sharded"),
                env={"PRMERS_PROOF_SHARDED": "1"})
            check_sharded_proof(s, rc, text, doc, os.path.join(
                root, "build", "smoke_mesh_cli", f"proof{s}"))
        out[s] = ranks
    return out


def check_extras(ranks, s, card, single=None) -> None:
    """The radix-5 and XLA-form results of each rank of s (mesh_rank_r5,
    mesh_rank_xla): each against GMP, every kernel of each radix-5 path
    launched (its counts reset just before, read just after) and none off
    it; their PRP iter/s beside the single card's."""
    for res in ranks:
        log(f"[6]   rank {res['rank']} radix 5 p={P_R5} "
            f"{res['r5_shape']}: tables {res['r5_tables_s']:.3f} s; "
            f"block step vs GMP {res['r5_block_ok']}, calls "
            f"{res['r5_block_calls']}; engine ops in "
            f"{res['r5_engine_s']:.3f} s vs GMP {res['r5_engine_ok']}, "
            f"calls {res['r5_engine_calls']}")
        log(f"[6]   rank {res['rank']} ShardedEngine "
            f"(PRMERS_SHARDED_IMPL=xla) p={P_MAIN}: tables "
            f"{res['xla_tables_s']:.3f} s, graphs {res['xla_graphs']}, "
            f"x3 and x1 squarings vs GMP (digits, psum_res64) "
            f"{res['xla_ok']}")
        if not (res["r5_block_ok"] and all(res["r5_engine_ok"]) and
                all(res["xla_ok"])):
            raise AssertionError(f"the radix-5 or XLA-form mesh at s={s} "
                                 f"disagrees with GMP on rank {res['rank']}")
        missing = [f"row {k}" for k in MESH_R5_ROW
                   if res["r5_engine_calls"][k] <= 0]
        missing += [f"block {k}" for k in MESH_R5_BLOCK
                    if res["r5_block_calls"][k] <= 0]
        ran_off = [k for k in MESH_OFF if res["r5_engine_calls"][k]
                   or res["r5_block_calls"][k]]
        if missing or ran_off:
            raise AssertionError(f"radix-5 mesh rank {res['rank']} at s={s}:"
                                 f" not launched {missing}, launched "
                                 f"{ran_off}")
    r0 = ranks[0]
    single = single or {}
    log(f"[6] PRP {r0['r5_ips']:.6f} iter/s @ p={P_R5} through the mesh "
        f"at s={s} (rank 0; ranks {[r['r5_ips'] for r in ranks]}) "
        f"against {single.get(P_R5, 'not measured')} through the "
        f"single-card row carry ({card})")
    log(f"[6] PRP {r0['xla_ips']:.6f} iter/s @ p={P_MAIN} through "
        f"ShardedEngine at s={s} (rank 0; ranks "
        f"{[r['xla_ips'] for r in ranks]}; graphs {r0['xla_graphs']}) "
        f"against {single.get(P_MAIN, 'not measured')} through the "
        f"single-card row carry ({card})")


def tools_drive(dev, card):
    """Phase 7: the tools' kernels at full width (the pass profiler at p =
    136279841, the microbenchmarks, the probes), the wrapper counts of
    their run (reset just before, read just after; each > 0), then every
    timed launch held against its plain version; returns (the checked
    Timed, the counts, the pair times of each shape case's one-call
    PyTorch twin: torch._int_mm on the dots b, e and n)."""
    import torch
    from prmers_tpu_torch import tools
    from prmers_tpu_torch.ops import kernels as tk
    from prmers_tpu_torch.ops import probes as pr
    from prmers_tpu_torch.tools import (microbench, microbench_fields,
                                        probe_bitcast, probe_shapes,
                                        profile_passes, sass)
    t1 = time.perf_counter()
    tk.reset_calls()
    pr.reset_calls()
    secs = {}

    def run(name, fn):
        t = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        secs[name] = round(time.perf_counter() - t, 3)
        return r

    t7, passes = run("passes", lambda: profile_passes.measure(P_MAIN,
                                                              reps=10))
    s8b = profile_passes.s8_bytes(t7)
    del t7
    _t, axis, moves = run("axis", lambda: profile_passes.measure_axis(
        reps=10))
    mm = run("matmul", lambda: microbench.matmul_rates(dev))
    mb, rates = run("microbench", microbench.measure)
    mf, per_el = run("fields", microbench_fields.measure)
    ps, library = run("shapes", probe_shapes.measure)
    pb, order, col = run("bitcast", probe_bitcast.measure)
    floor = run("floor", tools.empty_launch_ms)
    log(f"[7] seconds by tool: {secs}")
    calls = {**tk.calls, **pr.calls}
    log(f"[7] tools' run in {time.perf_counter() - t1:.3f} s; wrapper calls "
        f"{calls}")
    missing = [k for k in ("k4u_pass", "k5u_pass", "k4_axis0", "k2_fused_c",
                           "k1_p1c", "k5_axis1") + pr.KERNELS
               if calls[k] <= 0]
    if missing:
        raise AssertionError(f"not launched in phase 7: {missing}")
    t = time.perf_counter()
    timed7 = tools.check(passes + axis + mb + mf + ps + [pb])
    log(f"[7] the plain versions and checks in "
        f"{time.perf_counter() - t:.3f} s")
    for r in moves:
        log(f"[7]   move-only body {r['what']}: {r['ms']:.6f} ms, bound "
            f"{r['bound_ms']:.6f} ms ({r['bound_by']}) ({card})")
    log(f"[7] empty launch (the floor of the timing method): median "
        f"{floor.median:.6f} ms, mean {floor.mean:.6f}, max "
        f"{floor.max:.6f}, pairs {[round(v, 6) for v in floor.pairs]} "
        f"({card})")
    for e in timed7:
        log(f"[7]   {e.kernel} {e.what}: kernel {e.ms:.6f} ms (median; "
            f"mean {e.times.mean:.6f}, max {e.times.max:.6f}), plain "
            f"{e.plain_ms:.6f} ms, bound {e.bound_ms:.6f} ms "
            f"({e.bound_by}), max_abs_err {e.max_abs_err} ({card})")
    for r in mm:
        log(f"[7] library {r['kind']} product {r['shape']} serial: "
            f"{r['ms']:.6f} ms, {r['rate_T']:.3f} T/s ({card})")
    log(f"[7] integer pipe: {tools.int_pipe_rate():.6e} slots/s "
        f"({torch.cuda.get_device_properties(0).multi_processor_count} SMs "
        f"x {tools.INT_LANES_PER_SM} lanes x {tools.sm_clock_hz() / 1e6} "
        f"MHz clocks.max.sm) ({card})")
    counts = sass.library_counts()
    for op, c in counts.items():
        log(f"[7] rep loop {op} (SASS, per rep): ALU {c['alu_per_rep']}, "
            f"FMA {c['fma_per_rep']}, either {c['either_per_rep']}, issued "
            f"{c['issued_per_rep']}: {c['slots_per_rep']} pipe slots; "
            f"opcodes per {c['unroll']} reps {c['opcodes']}")
    for name, r in list(rates.items()) + list(per_el.items()):
        log(f"[7] {name} rate from the slope: {r['ns_per_el']:.6f} ns per "
            f"rep and element, {r['rate_G_per_s']} G/s; the loop's issue "
            f"bound {r['bound_G_per_s']:.3f} G/s at {r['slots_per_rep']} "
            f"pipe slots a rep (SASS): "
            f"{r['rate_G_per_s'] / r['bound_G_per_s']:.1%} of it; its "
            f"products alone {r['products_G_per_s']:.3f} G/s at "
            f"{r['product_slots']} FMA slots: "
            f"{r['rate_G_per_s'] / r['products_G_per_s']:.1%} ({card})")
    log(f"[7] fft3161 word vs two gl64 words: "
        f"{microbench_fields.ratios(per_el)} ({card})")
    log(f"[7] bitcast order {order} {col} ({card})")
    log(f"[7] K4u/K5u matrix form's int8 tables, bytes: {s8b} ({card})")
    slow = []
    for e in timed7:
        if e.kernel in ("probe_shapes", "probe_bitcast"):
            floor_note = ", at the launch floor" if e.ms <= floor.max else ""
        if e.kernel == "probe_shapes":
            case = e.what.split()[0]
            lib = "torch._int_mm" if case in "ben" else "one-call twin"
            if library[case].median < e.ms:
                slow.append(case)
            log(f"[7] probe_shapes {case}: kernel {e.ms:.6f} ms, {lib} "
                f"{library[case].median:.6f} ms (medians), bound "
                f"{e.bound_ms:.6f} ms ({e.bound_by}){floor_note} ({card})")
        elif e.kernel == "probe_bitcast":
            log(f"[7] probe_bitcast: {e.ms:.6f} ms, the empty launch "
                f"{floor.median:.6f} (max {floor.max:.6f}){floor_note} "
                f"({card})")
    log(f"[7] shape cases slower than their one-call twin (medians): "
        f"{slow or 'none'} ({card})")
    log(f"[7] phase 7 in {time.perf_counter() - t1:.3f} s")
    return timed7, calls, library


def mm31(dev, card) -> None:
    """The engine at MM31 (p = 2^31 - 1, n = 5 * 2^25, (64, 320, 8192)
    with T = 2: K1, K5, K6 "fwd", K6b, K5, K3): the host table build's
    time and peak memory, then two squarings of a dense value against
    GMP, with the wrapper counts of the squarings."""
    import torch
    from prmers_tpu_torch.engine.factory import create_engine
    from prmers_tpu_torch.ops import fourstep as tfs
    from prmers_tpu_torch.ops import kernels as tk
    from prmers_tpu_torch.utils import gmp
    p = P_MM31
    t0 = time.perf_counter()
    tracemalloc.start()
    eng = create_engine(p, 2, device=dev)
    peak = tracemalloc.get_traced_memory()[1]
    tracemalloc.stop()
    fp = eng.t.fp
    log(f"[mm31] p={p} n={fp.n} (R1, R2, C)={fp.shape} carry_ct "
        f"{tfs.carry_ct(fp)}: engine and tables in "
        f"{time.perf_counter() - t0:.3f} s, host peak {peak / 2**30:.3f} GiB")
    v = random.Random(p).getrandbits(p - 1)
    eng.set(0, v)
    eng.sync()
    tk.reset_calls()
    t0 = time.perf_counter()
    eng.square_mul_seq(0, [1, 1])
    eng.sync()
    calls = dict(tk.calls)
    log(f"[mm31] two squarings in {time.perf_counter() - t0:.3f} s; "
        f"wrapper calls {calls} ({card})")
    t0 = time.perf_counter()
    want = gmp.mersenne_mod(gmp.mul(v, v), p)
    want = gmp.mersenne_mod(gmp.mul(want, want), p)
    ok = eng.get_int(0) == want
    log(f"[mm31] against GMP in {time.perf_counter() - t0:.3f} s: {ok}")
    need = ("k1_p1c", "k3_p7c", "k5_axis1", "k6_fused_c", "k6b_fused_c_invh")
    if not ok or any(calls[k] <= 0 for k in need) or calls["k9_chain"]:
        raise AssertionError(f"MM31: GMP {ok}, wrapper calls {calls}")
    del eng
    torch.cuda.empty_cache()
    # P-1 on MM31 through the CLI's entry, in this process (the tables
    # stay built): ultralowmem's stage 2 recomputes 3^(E * 2p * Q), whose
    # gcd covers both stages. -nogcd-stage1 skips stage 1's own gcd, ~20
    # min of host GMP at 2^31 bits, which cannot find this factor: q - 1
    # = 2 * p * 3 * 5 * 4583 has its large prime in stage 2's range
    import contextlib
    import io
    from prmers_tpu_torch import app
    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                     "smoke_mm31")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    buf = io.StringIO()
    tk.reset_calls()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = app.main([str(p), "-pm1", "-b1", "100", "-b2", "5000",
                       "-pm1-ultralowmem", "-nogcd-stage1", "-save-dir", d,
                       "-results", os.path.join(d, "results.txt")])
    dt = time.perf_counter() - t0
    calls = dict(tk.calls)
    out = buf.getvalue()
    j = json.loads(out.strip().splitlines()[-1])
    squarings = [ln for ln in out.splitlines() if "exponent bits" in ln]
    log(f"[mm31] P-1 -b1 100 -b2 5000 -pm1-ultralowmem: rc={rc} in "
        f"{dt:.3f} s ({card}); factors {j.get('factors')}; {squarings}; "
        f"wrapper calls {calls}")
    if rc != 0 or j.get("factors") != [str(MM31_PM1_FACTOR)] or \
            any(calls[k] <= 0 for k in need):
        raise AssertionError(f"MM31 P-1: {out[-2000:]}")


# phase 8: the any-size engine (engine/torch_engine.py) and the reference
# goldens it opens (tests/test_prp_ll.py, test_proof.py,
# test_llsafe_cofactor.py; the reference's unit_tests.sh)
P_ANY_WIDE = 1600003    # n = 81920 = 5 * 2^14: the widest plan only it takes
ANY_RATES = ((9941, 512), (100003, 256), (P_ANY_WIDE, 64))
GOLDEN_9941 = [
    "proof [0] : M 87f3d3eabe4d6049, h 4526397be82cea45",
    "proof [1] : M d6a355de518574d7, h 7faf92dd48dc2013",
    "proof [2] : M 5aac235405ca84c7, h 934611f5f1192dd0",
]
GOLDEN_11213 = {
    1000: "FBA631FBCB73A011", 2000: "F01283650C4A1491",
    3000: "7E79193B757010B7", 4000: "31482E4D80FE99BB",
    5000: "973B76BACF73BBEF", 6000: "8CFFB332495FC320",
    7000: "98080C76DF068843", 8000: "8FDA516F885D3FEE",
    9000: "2AADBC4F1E318E92", 10000: "0A4AAF339C8B290C",
    11000: "A1F26F470CFE412D",
}
RES2048_100003 = (
    "af262d00ed00a05d53e99d0e0e451b12405ddabe139fe8396a4c520b505bb65b"
    "ed1609d3c8ef23bbb1d0f8140a6bcdd2c67f9c8aa3bd0e6eeb3e8e79db904810"
    "c88de09820557176b389290f84f18424efa6a59fb9f132a74f53a83ba6e2f508"
    "c617a5e1451c3ee08d179e6614026f973d1900602f2068a08894cd81ed5035de"
    "9ded85909b1ee6ff4dc723118b79d3f940272ae1066aebe27c86338ad7edf70e"
    "76c0e8abf3e985b73db2a06f1b742a9a908728be2bd4b7daa2d6aafc11bacaaa"
    "40944e9a66b039cb0deaaa8e5e357cd54b81b3ec6661d55e48bacb994bfd3cbb"
    "33f3f01d82347fa00578ec86c4cd7eb568a1463cf3e38dae1cf45e9503c71fd6")
F2699 = ("5399", "307687", "1187561", "7570504839257", "1987104667810711")
NO_PALLAS_K = 8         # squarings of the p = 136279841 check


def expect_goldens(expect, r9941, r11213, r100003=None) -> None:
    """The goldens phases 8 and 10 share, each run (rc, output, seconds,
    result JSON): M9941 prime with the reference's proof hashes
    (tests/test_proof.py) and the proof verified, M11213's res64 every
    1000 iterations and final res64 1 (tests/test_prp_ll.py:127-149),
    and (phase 10) M100003's res64 and res2048 (:106-124)."""
    rc, out, _dt, j = r9941[:4]
    lines = [ln.strip() for ln in out.splitlines()
             if ln.strip().startswith("proof [")]
    expect("M9941 prime", rc == 0 and j["status"] == "P")
    expect("M9941 proof hashes equal GOLDEN_9941", lines == GOLDEN_9941)
    expect("M9941 proof verifies", "Verification result: SUCCESS" in out)
    rc, out, _dt, j = r11213[:4]
    seen = {}
    for ln in out.splitlines():
        if "Res64:" in ln and "Iter:" in ln:
            it = int(ln.split("Iter:")[1].split("|")[0].strip())
            seen[it] = ln.split("Res64:")[1].strip()
    expect("M11213 res64 stream equals the golden's",
           all(seen.get(k) == v for k, v in GOLDEN_11213.items()))
    expect("M11213 final res64 0000000000000001",
           rc == 0 and j["res64"] == "0000000000000001")
    if r100003 is None:
        return
    j = r100003[3]
    expect("M100003 res64 1CF45E9503C71FD6",
           j["status"] == "C" and j["res64"] == "1CF45E9503C71FD6")
    expect("M100003 res2048 equals the golden's",
           j["res2048"].lower() == RES2048_100003)


def cli_run(root: str, tag: str, args, timeout=900, phase=8, env=None,
            fresh=True, result=True):
    """`python -m prmers_tpu_torch <args>` in a subprocess with its own
    save dir (build/smoke_any/<tag>; emptied first unless fresh=False);
    returns (rc, stdout and stderr, seconds, the result JSON, the save
    dir). The result JSON is the last line of stdout."""
    d = os.path.join(root, "build", "smoke_any", tag)
    if fresh:
        shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d, exist_ok=True)
    t1 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "prmers_tpu_torch", *args,
                        "-save-dir", d], cwd=root, capture_output=True,
                       text=True, timeout=timeout,
                       env=dict(os.environ, **(env or {})))
    dt = time.perf_counter() - t1
    tail = r.stdout.strip().splitlines()[-1] if r.stdout.strip() else ""
    log(f"[{phase}] CLI {' '.join(args)}: rc={r.returncode} in {dt:.3f} s: "
        f"{tail[:300]}")
    if not result:
        return r.returncode, r.stdout + r.stderr, dt, None, d
    if not tail.startswith("{"):
        raise AssertionError(f"CLI {args} printed no result:\n"
                             f"{r.stdout[-2000:]}\n{r.stderr[-2000:]}")
    return r.returncode, r.stdout + r.stderr, dt, json.loads(tail), d


def launches(eng, phase) -> str:
    """The CUDA kernels of one eager squaring of eng (graphs=False), after
    one warm-up, as torch.profiler sees them: their count, how many are
    GEMMs (gl64's limb fold is a float64 torch.mm) and how many copies or
    sets; each kernel's name and count go to a line of their own. "not
    measured" where the profiler sees no device."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile
    eng.set(0, 3)
    eng.square_mul(0)
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            eng.square_mul(0)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    except (RuntimeError, AttributeError) as e:
        log(f"[{phase}] torch.profiler: {e}")
        names = []
    if not names:
        return "not measured"
    by = collections.Counter(names)
    log(f"[{phase}] the kernels of one eager squaring of "
        f"{type(eng).__name__} at n={eng.plan.n}: "
        f"{sorted((k, n[:60]) for n, k in by.items())}")
    gemm = sum(k for n, k in by.items() if "gemm" in n.lower())
    mem = sum(k for n, k in by.items() if n.startswith(("Memcpy", "Memset")))
    return f"{len(names)} ({gemm} GEMMs, {mem} copies or sets)"


def anysize_drive(root: str, dev, card: str, beside=None) -> None:
    """Phase 8: the any-size engine on the card. Table builds and iter/s
    (CUDA graphs against eager, in turns) with the launches of one eager
    squaring; the widest plan only it takes against GMP; the reference
    goldens through the CLI (two chains of subprocesses, beside the host
    build of the 2^23 tables); then the main exponent under
    PRMERS_NO_PALLAS against GMP and FourStepEngine. `beside` is called
    just before the goldens start (the full smoke starts phase 9's CLI
    chains there). Any mismatch raises."""
    import torch

    from prmers_tpu_torch.core.plan import cached_plan
    from prmers_tpu_torch.engine import torch_engine as te
    from prmers_tpu_torch.engine.factory import create_engine
    from prmers_tpu_torch.engine.fourstep_engine import FourStepEngine
    from prmers_tpu_torch.utils import gmp

    t0 = time.perf_counter()
    pool = ThreadPoolExecutor(max_workers=2)
    rnd = random.Random(P_MAIN)
    v_main = rnd.getrandbits(P_MAIN - 1)
    want_main = pool.submit(gmp.powmod, v_main, 1 << NO_PALLAS_K,
                            (1 << P_MAIN) - 1)

    def tables(plan):
        t1 = time.perf_counter()
        te.get_tables(plan, dev)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t1
        log(f"[8] n={plan.n} p={plan.p}: tables (numpy host build, to the "
            f"card, lifted) in {dt:.3f} s")

    def rate(p, graphs, iters):
        eng = te.TorchEngine(p, 2, device=dev, graphs=graphs)
        eng.set(0, 3)
        eng.square_mul_seq(0, [1] * 8)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        eng.square_mul_seq(0, [1] * iters)
        torch.cuda.synchronize()
        return iters / (time.perf_counter() - t1)

    for p, iters in ANY_RATES:
        tables(cached_plan(p))
        got = {True: [], False: []}
        for graphs in (True, False, False, True):
            got[graphs].append(rate(p, graphs, iters))
        log(f"[8] any-size PRP @ p={p} (n={cached_plan(p).n}): CUDA graph "
            f"{sum(got[True]) / 2:.3f} iter/s (runs {got[True][0]:.3f}, "
            f"{got[True][1]:.3f}), eager {sum(got[False]) / 2:.3f} iter/s "
            f"(runs {got[False][0]:.3f}, {got[False][1]:.3f}); "
            f"{launches(te.TorchEngine(p, 2, device=dev, graphs=False), 8)}"
            f" CUDA launches per eager squaring ({card})")

    # the widest plan only the any-size engine takes, through create_engine
    p = P_ANY_WIDE
    mp = (1 << p) - 1
    eng = create_engine(p, 6, device=dev)
    if type(eng) is not te.TorchEngine:
        raise AssertionError(f"auto gave {type(eng).__name__} at p={p}")
    rnd = random.Random(p)
    v, w = rnd.getrandbits(p - 1), rnd.getrandbits(p - 1)
    eng.set(0, v)
    eng.set(1, w)
    a_vec = [3, 1] * 32
    eng.square_mul_seq(0, a_vec)
    eng.set_multiplicand(2, 1)
    eng.mul(0, 2, 3)
    eng.sub(0, 5)
    eng.add_small(0, 11)
    eng.addsub(3, 4, 0, 1)
    x = v
    for a in a_vec:
        x = gmp.mersenne_mod(gmp.mul(x, x) * a, p)
    x = (gmp.mersenne_mod(gmp.mul(x, w) * 3, p) + 6) % mp
    ok = (eng.get_int(0) == x, eng.get_int(3) == (x + w) % mp,
          eng.get_int(4) == (x - w) % mp)
    log(f"[8] p={p} (n={eng.get_size()}, auto: {type(eng).__name__}): 64 "
        f"squarings with a = [3, 1], mul, sub, add_small, addsub vs GMP: "
        f"{ok}")
    if not all(ok):
        raise AssertionError(f"the any-size engine disagrees with GMP at "
                             f"p={p}")
    del eng
    torch.cuda.empty_cache()

    # the goldens through the CLI, two chains of subprocesses side by side
    # (the card time-slices them), while this process builds the 2^23
    # tables on the host
    if beside is not None:
        beside()
    goldens = ThreadPoolExecutor(max_workers=2)
    # phase 6's (d): the XLA-form mesh engine on one rank (n = 512 is
    # below the four-step engine) with its residues as rank shards
    mesh_chain = goldens.submit(
        cli_run, root, "9941-sharded", ["9941", "-backend", "sharded"],
        env={"PRMERS_PROOF_SHARDED": "1"})
    short_chain = goldens.submit(lambda: [
        cli_run(root, "127-ll", ["127", "-ll"]),
        cli_run(root, "127-llsafe", ["127", "-llsafe"]),
        cli_run(root, "2699-5", ["2699", "-noproof", "-factors",
                                 ",".join(F2699)]),
        cli_run(root, "2699-4", ["2699", "-noproof", "-factors",
                                 ",".join(F2699[:4])]),
        cli_run(root, "9941", ["9941", "-proofverify"]),
        cli_run(root, "11213", ["11213", "-noproof",
                                "-res64_display_interval", "1000"])])
    plan = cached_plan(P_MAIN)
    tables(plan)
    from prmers_tpu_torch.engine.fourstep_engine import host_tables
    from prmers_tpu_torch.ops import fourstep as tfs
    host_tables(tfs.FourStepPlan.from_plan(plan))
    t1 = time.perf_counter()
    short = [c[:4] for c in short_chain.result()]
    rc, out, _dt, doc, d = mesh_chain.result()
    check_sharded_proof(1, rc, out, doc, d, phase=8)
    goldens.shutdown()
    log(f"[8] waited {time.perf_counter() - t1:.3f} s for the CLI goldens")

    def expect(what, cond):
        log(f"[8]   {what}: {cond}")
        if not cond:
            raise AssertionError(f"golden failed: {what}")

    (rc, _o, _d, j), (rc2, _o, _d, j2) = short[0], short[1]
    expect("M127 -ll prime", rc == 0 and j["status"] == "P")
    expect("M127 -llsafe prime", rc2 == 0 and j2["status"] == "P")
    (rc, _o, _d, j), (rc2, _o, _d, j2) = short[2], short[3]
    expect("M2699 cofactor with 5 known factors PRP",
           rc == 0 and j["status"] == "PRP")
    expect("M2699 cofactor with 4 known factors composite",
           rc2 == 1 and j2["status"] == "C")
    expect_goldens(expect, short[4], short[5])

    # the main exponent through the any-size engine (PRMERS_NO_PALLAS)
    os.environ["PRMERS_NO_PALLAS"] = "1"
    try:
        eng = create_engine(P_MAIN, 2, device=dev)
    finally:
        del os.environ["PRMERS_NO_PALLAS"]
    if type(eng) is not te.TorchEngine:
        raise AssertionError("PRMERS_NO_PALLAS did not give TorchEngine")
    eng.set(0, v_main)
    eng.sync()
    t1 = time.perf_counter()
    eng.square_mul_seq(0, [1] * NO_PALLAS_K)
    eng.sync()
    dt = time.perf_counter() - t1
    got = eng.get_digits(0)
    del eng
    torch.cuda.empty_cache()
    ref = create_engine(P_MAIN, 2, device=dev)
    if type(ref) is not FourStepEngine:
        raise AssertionError("auto did not give FourStepEngine at 2^23")
    ref.set(0, v_main)
    ref.square_mul_seq(0, [1] * NO_PALLAS_K)
    same = bool((ref.get_digits(0) == got).all())
    from prmers_tpu_torch.utils import digits as dg
    gmp_ok = dg.digits_to_int(got, plan.widths) == want_main.result()
    log(f"[8] p={P_MAIN} (n=2^23) under PRMERS_NO_PALLAS: "
        f"{NO_PALLAS_K} squarings at {NO_PALLAS_K / dt:.3f} iter/s (eager, "
        f"{card}); equal to GMP {gmp_ok}, to FourStepEngine {same}")
    if not (gmp_ok and same):
        raise AssertionError("the any-size engine disagrees at 2^23")
    del ref
    pool.shutdown()
    torch.cuda.empty_cache()
    log(f"[8] phase 8 in {time.perf_counter() - t0:.3f} s")


# phase 9: the modes (modes/pm1.py, ecm.py, ecm_edwards.py, memtest.py,
# bench.py; app.py's worktodo loop and -filemers; engine/paged.py) with
# the reference's goldens (tests/test_pm1.py, test_ecm.py,
# test_ecm_edwards.py; BASELINE.md)
M367 = ["367", "-pm1", "-b1", "11981", "-b2", "38971"]
M367_S1, M367_S2 = 646300400639, 50500996776315830904406967
P_PM1_K9 = 544139           # n = 2^15: P-1 (3, 7) in both stages
PM1_K9_FACTOR = 22853839
M1362763 = ["1362763", "-pm1", "-b1", "29", "-b2", "6910159",
            "-factors", "46333943,282345414919", "-nogcd-stage1"]
M1362763_FACTOR = 28401397572100073
# (argv, (factor, curve, stage)) of the reference's numpy run of the same
# command line (prmers_tpu's app.run_once, -backend numpy,
# PRMERS_ECM_NO_BATCH=1)
ECM_GOLDENS = [
    (["29", "-ecm", "-b1", "300", "-K", "3", "-curve-seed", "7"],
     (233, 0, 1)),
    (["37", "-ecm", "-b1", "20", "-b2", "400", "-K", "6", "-curve-seed",
      "3"], (223, 0, 2)),
    (["29", "-ecm", "-b1", "300", "-K", "2", "-curve-seed", "7",
      "-montgomery"], (1103, 0, 1)),
    (["37", "-ecm", "-b1", "20", "-b2", "400", "-K", "4", "-curve-seed",
      "3", "-montgomery"], (223, 0, 1)),
]
# sha256 of the .save prmers_tpu's io/interop.write_ecm_resume writes for
# M541's stage-1 residue 3^(E(899) * 2 * 541) at B1 = 899
SAVE_541_SHA256 = \
    "0253c81ad4026567c922e72fdce4f766717be8690a2f71811e2023a1aa0fbb33"
BENCH_LADDER = [9941, 756839]
MODES_KERNELS = ("k9_chain", "k1_p1c", "k2_fused_c", "k3_p7c")
ECM_K9_B1 = 50
# batched ECM (engine/batch.py): the reference's test_batched_matches_
# classic settings (tests/test_ecm.py:62, tests/test_ecm_edwards.py:123),
# each run batched (backend auto) and under PRMERS_ECM_NO_BATCH=1
ECM_M37 = {
    "montgomery": ["37", "-ecm", "-b1", "20", "-b2", "400", "-K", "4",
                   "-curve-seed", "3", "-montgomery"],
    "edwards": ["37", "-ecm", "-b1", "20", "-b2", "400", "-K", "6",
                "-curve-seed", "3"]}
# the rate: K curves of stage 1 on M9941 (prime, so every curve runs to
# its end) as K lanes against K classic curves; B1 = 40 (a 53-bit ladder)
# keeps the classic run near 20 s on an H100 (B1 = 100 took 46 s)
ECM_RATE_P, ECM_RATE_K, ECM_RATE_B1 = 9941, 16, 40
# --ecm-kernel-plan: the same at the smallest plan the kernel engine takes
# (n = 2^15, M756839 prime), where the classic loop runs FourStepEngine's
# kernels and the batch the any-size engine's torch ops
ECM_KERNEL_P = P_GOLDEN
# --ecm-goldens: the reference's slow goldens (tests/test_ecm_edwards.py:
# 92-121, tests/test_ecm.py:54-60), seed 1: (name, argv, factor, stage
# or 0 for any; the reference holds Edwards to the factor alone, and its
# batch, every lane's stage 1 first, finds M67's on curve 1 in stage 1)
ECM_SLOW_GOLDENS = [
    ("M701 Edwards", ["701", "-ecm", "-b1", "6000", "-b2", "33333", "-K",
                      "8", "-curve-seed", "1"], 68453816366333403527, 0),
    ("M67 Edwards", ["67", "-ecm", "-b1", "2000", "-b2", "50000", "-K",
                     "12", "-curve-seed", "1"], 193707721, 0),
    ("M67 Montgomery", ["67", "-ecm", "-b1", "2000", "-b2", "50000", "-K",
                        "12", "-curve-seed", "1", "-montgomery"], 193707721,
     2),
]
NO_BATCH = {"PRMERS_ECM_NO_BATCH": "1"}


def pm1_found(out: str) -> tuple:
    """(stage-1 factor, stage-2 factor) from a P-1 run's log, 0 where the
    stage reported none."""
    s1 = [int(ln.rsplit(":", 1)[1]) for ln in out.splitlines()
          if "P-1 factor stage 1 found:" in ln]
    s2 = [int(ln.rsplit(":", 1)[1]) for ln in out.splitlines()
          if "Factor P-1 (stage 2) found" in ln]
    return (s1[-1] if s1 else 0, s2[-1] if s2 else 0)


def ecm_found(out: str):
    """(factor, curve, stage) of the first factor an ECM run's log
    reports."""
    import re
    for ln in out.splitlines():
        m = re.search(r"curve (\d+)\b.*?stage (\d) factor (\d+)", ln)
        if m:
            return int(m.group(3)), int(m.group(1)), int(m.group(2))
    return None


def modes_chains(root: str):
    """Phase 9's CLI runs on the any-size engine, two chains of
    subprocesses: P-1 (M541 with its resume files, the .mers of its
    stage-1 residue through -filemers, M367 on V-trace and ultralowmem,
    M367 paged onto 4 device slots) and ECM (M29 and M37, Edwards and
    Montgomery, on the classic loop) with the worktodo loop; and a third,
    the validation matrix's quick profile. Returns the running
    futures."""
    from prmers_tpu_torch.core.plan import cached_plan
    from prmers_tpu_torch.io import interop
    from prmers_tpu_torch.utils import digits as dg

    def pm1_chain():
        out = {"541": cli_run(root, "pm1-541", ["541", "-pm1", "-b1", "899",
                                                 "-resume"], phase=9)}
        d = out["541"][4]
        b1, p, x = interop.read_ecm_resume(
            os.path.join(d, "resume_p541_B1_899.save"))
        mers = os.path.join(d, f"{p}pm{b1}.mers")
        dg.int_to_digits(x, cached_plan(p).widths).astype("<u8").tofile(mers)
        out["filemers"] = cli_run(root, "pm1-541", ["-filemers", mers],
                                  phase=9, fresh=False, result=False)
        with open(os.path.join(d, f"{p}pm{b1}.save"), "rb") as f:
            out["filemers_sha256"] = hashlib.sha256(f.read()).hexdigest()
        out["367"] = cli_run(root, "pm1-367", M367, phase=9)
        out["367-ulm"] = cli_run(root, "pm1-367-ulm",
                                 M367 + ["-pm1-ultralowmem"], phase=9)
        out["367-paged"] = cli_run(root, "pm1-367-paged", M367, phase=9,
                                   env={"PRMERS_MAX_DEVICE_REGS": "4",
                                        "PRMERS_GPU_ALLOC_DIAG": "1"})
        return out

    def ecm_chain():
        out = [cli_run(root, f"ecm-{i}", argv, phase=9,
                       env={"PRMERS_ECM_NO_BATCH": "1"})
               for i, (argv, _want) in enumerate(ECM_GOLDENS)]
        d = os.path.join(root, "build", "smoke_any", "worktodo")
        shutil.rmtree(d, ignore_errors=True)
        os.makedirs(d)
        wt = os.path.join(d, "worktodo.txt")
        with open(wt, "w") as f:
            f.write("Pminus1=1,2,541,-1,899,0\nPRP=1,2,9941,-1\n")
        res = os.path.join(d, "results.txt")
        out.append(cli_run(root, "worktodo", ["-noproof", "-worktodo", wt,
                                              "-results", res], phase=9,
                           fresh=False))
        return out

    def matrix_chain():
        d = os.path.join(root, "build", "smoke_any", "matrix")
        shutil.rmtree(d, ignore_errors=True)
        os.makedirs(d)
        tsv = os.path.join(d, "quick.tsv")
        t1 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m",
                            "prmers_tpu_torch.tools.validation_matrix",
                            "quick", tsv], cwd=d, capture_output=True,
                           text=True, timeout=900,
                           env=dict(os.environ, PYTHONPATH=root))
        return r.returncode, r.stdout + r.stderr, \
            time.perf_counter() - t1, tsv

    pool = ThreadPoolExecutor(max_workers=3)
    chains = (pool.submit(pm1_chain), pool.submit(ecm_chain),
              pool.submit(matrix_chain))
    pool.shutdown(wait=False)
    return chains


def check_chains(chains) -> None:
    """Wait for phase 9's CLI chains (modes_chains) and hold their results
    to the goldens; any mismatch raises."""
    def expect(what, cond):
        log(f"[9]   {what}: {cond}")
        if not cond:
            raise AssertionError(f"phase 9 failed: {what}")

    t1 = time.perf_counter()
    pm1_out, ecm_out = chains[0].result(), chains[1].result()
    matrix = chains[2].result()
    log(f"[9] waited {time.perf_counter() - t1:.3f} s for the CLI chains")
    rc, out, _dt, j, _d = pm1_out["541"]
    expect("M541 -pm1 -b1 899: stage-1 factor 4312790327",
           rc == 0 and j["factors"] == ["4312790327"]
           and pm1_found(out)[0] == 4312790327)
    expect(".save from -filemers on M541's .mers equals the reference's",
           pm1_out["filemers"][0] == 0 and
           pm1_out["filemers_sha256"] == SAVE_541_SHA256)
    rc, out, _dt, j, _d = pm1_out["367"]
    expect(f"M367 V-trace: stage 1 {M367_S1}, stage 2 {M367_S2}",
           rc == 0 and pm1_found(out) == (M367_S1, M367_S2)
           and j["factors"] == [str(M367_S2)])
    rc, out, _dt, j, _d = pm1_out["367-ulm"]
    expect(f"M367 ultralowmem: stage 2 {M367_S2}",
           rc == 0 and pm1_found(out)[1] == M367_S2)
    rc, out, _dt, j, _d = pm1_out["367-paged"]
    alloc = [ln for ln in out.splitlines() if ln.startswith("[ALLOC]")]
    for ln in alloc:
        log(f"[9]   {ln}")
    expect(f"M367 V-trace on 4 device slots (PagedEngine): stage 2 "
           f"{M367_S2}", rc == 0 and pm1_found(out)[1] == M367_S2
           and any("host-paged LRU" in ln for ln in alloc))
    for (argv, want), (rc, out, _dt, j, _d) in zip(ECM_GOLDENS, ecm_out):
        got = ecm_found(out)
        expect(f"ECM {' '.join(argv)}: (factor, curve, stage) {got}, the "
               f"reference's {want}", got == want
               and j["factors"] == [str(want[0])] and rc == 0)
    rc, out, _dt, j, d = ecm_out[-1]
    with open(os.path.join(d, "results.txt")) as f:
        res = [json.loads(ln) for ln in f if ln.strip()]
    with open(os.path.join(d, "worktodo.txt")) as f:
        left = f.read().strip()
    expect("worktodo: M541 P-1 and M9941 PRP in -results, their JSON "
           "files, the worktodo file empty",
           rc == 0 and [(e["exponent"], e["status"]) for e in res] ==
           [(541, "F"), (9941, "P")] and left == "" and
           os.path.exists(os.path.join(d, "541_pm1_result.json")) and
           os.path.exists(os.path.join(d, "9941_prp_result.json")))
    check_matrix(*matrix, expect)


def check_matrix(rc, out, dt, tsv, expect) -> None:
    """The validation matrix's quick profile (tools/validation_matrix.py,
    run by modes_chains): exit code 0, every case's numpy/gl64, jax/gl64
    (the card; ECM batched) and numpy/fft3161 outcomes agree and none
    raised; the pallas column (the four-step engine) agrees where it ran,
    and its skips of the plans it does not take are logged."""
    log(f"[9] validation matrix quick: rc={rc} in {dt:.3f} s; "
        f"{out.strip().splitlines()[-1] if out.strip() else ''}")
    for ln in out.splitlines():
        if "skipped" in ln:
            log(f"[9]   matrix {ln}")
    if not os.path.exists(tsv):
        raise AssertionError(f"phase 9 failed: the matrix wrote no TSV:\n"
                             f"{out[-3000:]}")
    with open(tsv) as f:
        rows = [ln.rstrip("\n").split("\t") for ln in f][1:]
    cases = {}
    for case, col, outcome, sec in rows:
        log(f"[9]   matrix {case} {col}: {outcome} in {sec} s")
        cases.setdefault(case, {})[col] = outcome
    expect("matrix quick: exit code 0, the cases prp, llsafe, pm1_s1, "
           "ecm_edwards", rc == 0 and
           sorted(cases) == ["ecm_edwards", "llsafe", "pm1_s1", "prp"])
    for case, cols in sorted(cases.items()):
        want = {"numpy/gl64", "jax/gl64"} | (
            set() if case.startswith("ecm") else {"numpy/fft3161"})
        outcomes = set(cols.values())
        expect(f"matrix {case}: {', '.join(sorted(cols))} agree: "
               f"{sorted(outcomes)}", want <= set(cols)
               and len(outcomes) == 1 and
               not outcomes.pop().startswith("ERROR"))


def app_main_here(root: str, card: str, tag: str, args, env=None,
                  phase="9"):
    """app.main(args) in this process, with `env` set around it and its
    own save dir (build/smoke_modes/<tag>); returns (rc, log, result,
    seconds)."""
    import contextlib
    import io

    from prmers_tpu_torch import app
    d = os.path.join(root, "build", "smoke_modes", tag)
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    buf = io.StringIO()
    saved = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    t1 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            rc = app.main(args + ["-save-dir", d, "-results",
                                  os.path.join(d, "results.txt")])
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    out = buf.getvalue()
    dt = time.perf_counter() - t1
    j = json.loads(out.strip().splitlines()[-1])
    log(f"[{phase}] app.main {' '.join(args)}"
        f"{''.join(f' {k}={v}' for k, v in (env or {}).items())}: rc={rc} "
        f"in {dt:.3f} s: factors {j.get('factors')} ({card})")
    return rc, out, j, dt


def modes_drive(root: str, dev, card: str, chains=None,
                full=False) -> dict:
    """Phase 9: the modes on the card. The CLI chains (modes_chains;
    started here unless the caller started them beside phase 8) hold the
    any-size engine's goldens; in this process, through app.main (the
    CLI's entry) and the mode drivers, the kernel engine's: P-1 at
    p = 544139 and M1362763 (K9 for stage 1, K1-K3 for stage 2's
    products, the wrapper counts reset just before and read just after),
    one Edwards curve's stage 1 at p = 544139 on FourStepEngine against
    the any-size engine, memtest at p = 136279841, the -bench ladder over
    two exponents, and the bytes each engine holds beside its registers
    against engine/paged.OVERHEAD_BYTES; after the chains (and the
    validation matrix) batched ECM (ecm_batch_drive) and -gui
    (gui_drive). With `full`, M1362763's P-1 over the whole stage-2
    range, timed. Returns the wrapper counts of the kernel-engine P-1
    runs."""
    import gc

    import torch

    from prmers_tpu_torch import app
    from prmers_tpu_torch.engine import fourstep_engine as fse
    from prmers_tpu_torch.engine import paged
    from prmers_tpu_torch.engine import torch_engine as te
    from prmers_tpu_torch.engine.factory import create_engine
    from prmers_tpu_torch.io.cli import parse_args
    from prmers_tpu_torch.modes import bench as mbench
    from prmers_tpu_torch.modes import ecm_edwards as ed
    from prmers_tpu_torch.ops import kernels as tk

    t0 = time.perf_counter()
    if chains is None:
        chains = modes_chains(root)

    def expect(what, cond):
        log(f"[9]   {what}: {cond}")
        if not cond:
            raise AssertionError(f"phase 9 failed: {what}")

    # P-1 on the kernel engine (K9; K1-K3), through the CLI's entry here
    tk.reset_calls()
    rc, out, j, _dt = app_main_here(root, card, "pm1-k9",
                                    [str(P_PM1_K9), "-pm1", "-b1", "3",
                                     "-b2", "7"])
    expect(f"M{P_PM1_K9} P-1 (3, 7): {PM1_K9_FACTOR} in both stages",
           rc == 0 and pm1_found(out) == (PM1_K9_FACTOR, PM1_K9_FACTOR))
    rc, out, j, dt = app_main_here(root, card, "pm1-1362763",
                                   M1362763 + ["-b2start", "6900000"])
    expect(f"M1362763 P-1 -b2start 6900000, known factors divided out: "
           f"{M1362763_FACTOR}", rc == 0 and j.get("factors") ==
           [str(M1362763_FACTOR)])
    counts = dict(tk.calls)
    log(f"[9] kernel-engine P-1 wrapper calls {counts}")
    for name in MODES_KERNELS:
        if counts[name] <= 0:
            raise AssertionError(f"{name} was not launched by P-1")
    if full:
        rc, out, j, dt = app_main_here(root, card, "pm1-1362763-full",
                                       M1362763)
        expect(f"M1362763 P-1 over all of (29, 6910159] in {dt:.3f} s "
               f"({card}): {M1362763_FACTOR}", rc == 0 and
               j.get("factors") == [str(M1362763_FACTOR)])

    # one Edwards curve's stage 1 on the kernel engine and the any-size one
    p = P_PM1_K9
    n = (1 << p) - 1
    x0, y0, d = ed.edwards_curve(ed.splitmix64(0x5EED), n)
    points = []
    for cls in (fse.FourStepEngine, te.TorchEngine):
        eng = cls(p, ed.ED_BASE_REGS, device=dev)
        tk.reset_calls()
        t1 = time.perf_counter()
        ed._stage1(ed.EdOps(eng, n, d), x0, y0, ECM_K9_B1, 0, log)
        eng.sync()
        dt = time.perf_counter() - t1
        points.append([eng.get_int(r) for r in (ed.EX, ed.EY, ed.EZ,
                                                 ed.ET)])
        log(f"[9] Edwards stage 1 (B1={ECM_K9_B1}) at p={p} on "
            f"{cls.__name__} in {dt:.3f} s; wrapper calls "
            f"{ {k: v for k, v in tk.calls.items() if v} } ({card})")
        del eng
    expect(f"Edwards stage 1 at p={p}: FourStepEngine's point equals the "
           "any-size engine's", points[0] == points[1])

    # memtest at the main exponent on the kernel engine
    lines = []
    tk.reset_calls()
    r, _j = app.run(parse_args([str(P_MAIN), "-memtest", "-iters", "2"]),
                    device=dev, log=lines.append)
    expect(f"memtest p={P_MAIN}: {r.passes} passes, 0 errors, "
           f"{r.ips:.3f} iter/s ({card})", r.errors == 0 and
           r.roundtrip_errors == 0 and r.passes == 2
           and tk.calls["k2_fused_c"] > 0)

    # the -bench ladder over two of its exponents
    lines = []
    ladder, mbench.BENCH_EXPONENTS = mbench.BENCH_EXPONENTS, BENCH_LADDER
    try:
        r, _j = app.run(parse_args(["-bench", "-iters", "256"]), device=dev,
                        log=lines.append)
    finally:
        mbench.BENCH_EXPONENTS = ladder
    for ln in lines:
        log(f"[9] -bench: {ln} ({card})")
    expect("-bench: both rows and a PRMERS_SCORE line",
           [row[0] for row in r.rows] == BENCH_LADDER and r.score > 0
           and any("PRMERS_SCORE" in str(ln) for ln in lines))

    # the bytes each engine holds beside its registers, per word
    for backend, p in (("pallas", P_MAIN), ("jax", P_ANY_WIDE)):
        te._TABLES_CACHE.clear()
        fse._DEV_TABLES.clear()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        eng = create_engine(p, 3, device=dev, backend=backend)
        rnd = random.Random(p)
        eng.set(0, rnd.getrandbits(p - 1))
        eng.set(1, rnd.getrandbits(p - 1))
        eng.square_mul(0, 3)
        eng.set_multiplicand(2, 1)
        eng.mul(0, 2, 3)
        eng.add(0, 1)
        eng.sub_reg(0, 1)
        eng.sub(0, 2)
        eng.square_mul(0, 3)
        torch.cuda.synchronize()
        m = eng.get_size()
        extra = (torch.cuda.max_memory_allocated() - base
                 - 3 * paged.register_bytes(m, backend)) / m
        expect(f"{type(eng).__name__} at n={m}: {extra:.1f} bytes per word "
               f"beside its registers, charged "
               f"{paged.OVERHEAD_BYTES[backend]}",
               extra <= paged.OVERHEAD_BYTES[backend])
        del eng
    te._TABLES_CACHE.clear()
    gc.collect()
    torch.cuda.empty_cache()

    check_chains(chains)
    ecm_batch_drive(root, dev, card, expect)
    gui_drive(root, card, expect)
    log(f"[9] phase 9 in {time.perf_counter() - t0:.3f} s")
    return counts


def ecm_batch_drive(root: str, dev, card: str, expect) -> None:
    """Batched ECM (engine/batch.BatchTorchEngine under modes/ecm.py's and
    ecm_edwards.py's batched drivers) in this process through app.main:
    M37 in both families batched (the reference's log line) and under
    PRMERS_ECM_NO_BATCH=1, the same factor in both and for Montgomery the
    same curve and stage; then the rate at p = ECM_RATE_P (ecm_rate); and
    the CUDA launches of one eager batched squaring beside a single-lane
    one."""
    import torch

    from prmers_tpu_torch.engine import torch_engine as te
    from prmers_tpu_torch.engine.batch import BatchTorchEngine

    def run(tag, argv, env=None):
        return app_main_here(root, card, tag, argv, env=env)

    for family, argv in ECM_M37.items():
        rc, out, j, dt = run(f"ecm37-{family}", argv)
        said = [ln for ln in out.splitlines() if "batched: " in ln]
        got = ecm_found(out)
        rc_c, out_c, j_c, dt_c = run(f"ecm37-{family}-classic", argv,
                                     NO_BATCH)
        want = ecm_found(out_c)
        log(f"[9] M37 {family}: batched {got} in {dt:.3f} s, classic "
            f"{want} in {dt_c:.3f} s; {said} ({card})")
        same = got is not None and want is not None and (
            got == want if family == "montgomery" else got[0] == want[0])
        expect(f"M37 {family} batched against classic: "
               f"{'factor, curve, stage' if family == 'montgomery' else 'factor'}"
               f" equal, the batched line logged", rc == 0 and rc_c == 0
               and same and len(said) == 1 and got[0] == 223
               and not any("batched" in ln for ln in out_c.splitlines()))

    ecm_rate(root, card, ECM_RATE_P, expect, "9")

    b = BatchTorchEngine(ECM_RATE_P, 2, ECM_RATE_K, device=dev,
                         graphs=False)
    one = te.TorchEngine(ECM_RATE_P, 2, device=dev, graphs=False)
    log(f"[9] CUDA launches of one eager squaring at n=512: "
        f"{launches(b, 9)} batched (B={ECM_RATE_K}), {launches(one, 9)} "
        f"single ({card})")
    del b, one
    te._TABLES_CACHE.clear()
    torch.cuda.empty_cache()


def ecm_rate(root: str, card: str, p: int, expect, phase: str) -> None:
    """ECM_RATE_K curves of stage 1 (B1 = ECM_RATE_B1) on M_p, prime, so
    every curve runs to its end, through app.main in both families: one
    batch (the batched line logged) against as many classic curves
    (PRMERS_ECM_NO_BATCH=1), in curves per second, with each run's peak
    device bytes and kernel wrapper counts (reset just before, read just
    after): the classic loop must launch the kernel engine's kernels
    where it takes the plan, and nothing else any."""
    import torch

    from prmers_tpu_torch.core.plan import cached_plan
    from prmers_tpu_torch.engine import fourstep_engine as fse
    from prmers_tpu_torch.engine import torch_engine as te
    from prmers_tpu_torch.ops import kernels as tk

    n = cached_plan(p).n
    kernels = fse.covers(cached_plan(p))
    for family in ("montgomery", "edwards"):
        argv = [str(p), "-ecm", "-b1", str(ECM_RATE_B1), "-b2", "0", "-K",
                str(ECM_RATE_K), "-curve-seed", "1"] + (
            ["-montgomery"] if family == "montgomery" else [])
        rates = {}
        for batched in (True, False):
            te._TABLES_CACHE.clear()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            tk.reset_calls()
            form = "batched" if batched else "classic"
            rc, out, j, dt = app_main_here(
                root, card, f"ecm-rate-{p}-{family}-{form}", argv,
                env=None if batched else NO_BATCH, phase=phase)
            peak = torch.cuda.max_memory_allocated() - base
            calls = {k: v for k, v in tk.calls.items() if v}
            said = [ln for ln in out.splitlines() if "batched: " in ln]
            rates[batched] = ECM_RATE_K / dt
            log(f"[{phase}] M{p} (n={n}) {family} stage 1 (B1={ECM_RATE_B1}, "
                f"K={ECM_RATE_K}) {form}: {rates[batched]:.3f} curves/s in "
                f"{dt:.3f} s, peak {peak} device bytes, kernel wrapper calls "
                f"{calls} ({card})")
            expect(f"M{p} {family} {form}: no factor, the batched line only "
                   "where batched, kernels launched only by the classic "
                   "loop on the kernel engine",
                   rc == 1 and j["status"] == "NF" and
                   len(said) == (1 if batched else 0) and
                   (not batched or f"{ECM_RATE_K} curves per dispatch x 1 "
                    "batches" in said[0]) and
                   (sum(calls.get(k, 0) for k in MODES_KERNELS) > 0
                    if kernels and not batched else not calls))
        log(f"[{phase}] batched/classic curves per second, {family}: "
            f"{rates[True] / rates[False]:.3f} at B={ECM_RATE_K}, n={n} "
            f"({card})")


def ecm_kernel_plan(root: str, card: str) -> None:
    """--ecm-kernel-plan: ecm_rate at ECM_KERNEL_P (n = 2^15), where the
    classic loop runs FourStepEngine's kernels and the batch the any-size
    engine's torch ops."""
    t0 = time.perf_counter()

    def expect(what, cond):
        log(f"[9k]   {what}: {cond}")
        if not cond:
            raise AssertionError(f"--ecm-kernel-plan failed: {what}")

    ecm_rate(root, card, ECM_KERNEL_P, expect, "9k")
    log(f"[9k] --ecm-kernel-plan in {time.perf_counter() - t0:.3f} s")


def gui_drive(root: str, card: str, expect) -> None:
    """-gui on M127 through app.main on a free port: /api/state, asked
    while the run makes its engine, answers with the exponent and the
    arithmetic; the run ends rc 0 and the server is down after."""
    import urllib.request

    from prmers_tpu_torch import app
    port = _free_port()
    url = f"http://127.0.0.1:{port}/api/state"
    states = []
    real = app.create_engine

    def probe(*a, **k):
        with urllib.request.urlopen(url, timeout=10) as r:
            states.append(json.loads(r.read()))
        return real(*a, **k)
    app.create_engine = probe
    try:
        rc, out, j, dt = app_main_here(root, card, "gui-127",
                                       ["127", "-gui", "-gui-port",
                                        str(port)])
    finally:
        app.create_engine = real
    try:
        urllib.request.urlopen(url, timeout=5)
        down = False
    except OSError:
        down = True
    log(f"[9] -gui M127: /api/state during the run {states}")
    expect(f"-gui on M127 (port {port}): rc 0, /api/state answered during "
           "the run, the server down after", rc == 0 and j["status"] == "P"
           and len(states) == 1 and states[0]["exponent"] == 127 and
           states[0]["backend"] == "gl64" and down and
           f"web GUI on http://localhost:{port}" in out)


def ecm_goldens(root: str, dev, card: str) -> None:
    """--ecm-goldens: the reference's slow ECM goldens (ECM_SLOW_GOLDENS)
    on the batched path through app.main, each timed and held to its
    factor (and stage); then each once on the classic loop
    (PRMERS_ECM_NO_BATCH=1, the any-size engine) and M701 under -arith
    fft3161, timed, with the same factor."""
    t0 = time.perf_counter()

    def expect(what, cond):
        log(f"[9g]   {what}: {cond}")
        if not cond:
            raise AssertionError(f"--ecm-goldens failed: {what}")

    def found(out):
        return [ln for ln in out.splitlines() if "batched: " in ln]

    for name, argv, factor, stage in ECM_SLOW_GOLDENS:
        tag = name.replace(" ", "-")
        rc, out, j, dt = app_main_here(root, card, tag, argv, phase="9g")
        got = ecm_found(out)
        log(f"[9g] {name} batched: (factor, curve, stage) {got} in "
            f"{dt:.3f} s; {found(out)} ({card})")
        expect(f"{name} batched: {factor}"
               f"{f' in stage {stage}' if stage else ''}", rc == 0 and
               got is not None and got[0] == factor and
               (not stage or got[2] == stage) and len(found(out)) == 1)
    for name, argv, factor, stage in ECM_SLOW_GOLDENS:
        tag = name.replace(" ", "-")
        forms = [("classic", argv, NO_BATCH)]
        if name.startswith("M701"):
            forms.append(("fft3161", argv + ["-arith", "fft3161"], None))
        for form, args, env in forms:
            rc, out, j, dt = app_main_here(root, card, f"{tag}-{form}",
                                           args, env=env, phase="9g")
            got = ecm_found(out)
            log(f"[9g] {name} {form} loop: (factor, curve, stage) {got} in "
                f"{dt:.3f} s ({card})")
            expect(f"{name} {form} loop: {factor}", rc == 0 and
                   got is not None and got[0] == factor and not found(out))
    log(f"[9g] --ecm-goldens in {time.perf_counter() - t0:.3f} s")


# phase 10: the second arithmetic (fft3161): K10-K12 (csrc/f3_ntt.cu) and
# Engine3161 (engine/engine3161.py), the reference goldens under -arith
# fft3161, -tune and -profile
F3_CHECK = (127, 11213, 100003, 3021377, P_MAIN)  # n = 8, 288, 3072,
#                                                    98304, 2^22
F3_A = (3, 1, 1, 3, 1, 3, 1, 1)     # the drive's squarings
F3_CHAIN = 64                       # the a = 1, 3 chain at p = 136279841
F3_RATES = ((100003, 512), (3021377, 256), (P_MAIN, 64))
F3_TUNE_CAP = 756839
F3_TUNE_LADDER = (127, 9941, 216091, 756839)
F3_KERNELS = ("f3_fwd_stage", "f3_inv_stage", "f3_pointwise")
# ops per base-field product in the JAX package's limb-plane pricing: a
# 61 x 61-bit product 8 x 8 int8 limb MACs (as Goldilocks), 31 x 31 4 x 4
F3_OPS_31, F3_OPS_61 = 32, 128


def f3_widths(p: int):
    from prmers_tpu_torch.core.plan import digit_widths
    from prmers_tpu_torch.ops.ntt2 import transform_size_3161
    return digit_widths(p, transform_size_3161(p))


def f3_drive_values(p: int):
    """GMP's side of phase 10's Engine3161 drive at p: (v, w, the digits
    of x and y), for x = v after the F3_A chain, x = x w 3 + w, y = w - x,
    x = x - 5 (square_mul_seq, set_multiplicand + mul, add, sub_reg,
    sub)."""
    from prmers_tpu_torch.utils import digits as dg
    from prmers_tpu_torch.utils import gmp
    mp = (1 << p) - 1
    rnd = random.Random(p + 3161)
    v, w = rnd.getrandbits(p - 1), rnd.getrandbits(p - 1)
    x = v
    for a in F3_A:
        x = gmp.mersenne_mod(gmp.mul(x, x) * a, p)
    x = (gmp.mersenne_mod(gmp.mul(x, w) * 3, p) + w) % mp
    y = (w - x) % mp
    x = (x - 5) % mp
    widths = f3_widths(p)
    return v, w, (dg.int_to_digits(x, widths), dg.int_to_digits(y, widths))


def f3_chain_values():
    """GMP's side of the F3_CHAIN squarings (a = 1, 3 in turn) at
    p = 136279841: (v, the digits of the result)."""
    from prmers_tpu_torch.utils import digits as dg
    from prmers_tpu_torch.utils import gmp
    p = P_MAIN
    v = random.Random(p + 64).getrandbits(p - 1)
    x = v
    for a in (1, 3) * (F3_CHAIN // 2):
        x = gmp.mersenne_mod(gmp.mul(x, x) * a, p)
    return v, dg.int_to_digits(x, f3_widths(p))


def f3_gmp_jobs():
    """Phase 10's GMP work on two threads from the smoke's start (the
    chain at 2^22 words takes ~1.5 s a squaring)."""
    pool = ThreadPoolExecutor(max_workers=2)
    jobs = {"chain": pool.submit(f3_chain_values)}
    for p in F3_CHECK:
        jobs[p] = pool.submit(f3_drive_values, p)
    pool.shutdown(wait=False)
    return jobs


def fft3161_chains(root: str):
    """Phase 10's goldens through the CLI under -arith fft3161, in two
    chains of subprocesses: M100003 in one, the rest in the other."""
    fft = ["-arith", "fft3161"]
    pool = ThreadPoolExecutor(max_workers=2)
    long_chain = pool.submit(lambda: [cli_run(
        root, "f3-100003", ["100003", "-noproof", *fft], phase=10)])
    short_chain = pool.submit(lambda: [
        cli_run(root, "f3-127-ll", ["127", "-ll", *fft], phase=10),
        cli_run(root, "f3-1279", ["1279", "-noproof", *fft], phase=10),
        cli_run(root, "f3-9941", ["9941", "-proofverify", *fft], phase=10),
        cli_run(root, "f3-11213", ["11213", "-noproof", *fft,
                                   "-res64_display_interval", "1000"],
                phase=10)])
    pool.shutdown(wait=False)
    return long_chain, short_chain


def check_fft3161_chains(chains) -> None:
    """Wait for fft3161_chains and hold them to the goldens (the same as
    phase 8's on gl64); any mismatch raises."""
    def expect(what, cond):
        log(f"[10]   {what}: {cond}")
        if not cond:
            raise AssertionError(f"fft3161 golden failed: {what}")

    t1 = time.perf_counter()
    (r100003,), short = chains[0].result(), chains[1].result()
    log(f"[10] waited {time.perf_counter() - t1:.3f} s for the CLI goldens")
    for _rc, out, _dt, _j, _d in [r100003] + short:
        expect("the run took Engine3161",
               "using Engine3161" in out and
               "Arithmetic path: fft3161 (forced by -arith)" in out)
    rc, _o, _dt, j, _d = short[0]
    expect("M127 -ll prime on fft3161", rc == 0 and j["status"] == "P")
    rc, _o, _dt, j, _d = short[1]
    expect("M1279 PRP prime on fft3161", rc == 0 and j["status"] == "P")
    expect_goldens(expect, short[2], short[3], r100003)
    log(f"[10] M100003 PRP on fft3161 in {r100003[2]:.3f} s through the "
        f"CLI")


def f3_bound(t, i: int, which: str) -> tuple:
    """The least time for stage i of K10 ("fwd") or K11 ("inv"), or K12
    ("sqr"): bytes (each plane (2, n) u32 + u64 read and written once,
    the stage's twiddle rows 1..r-1, the digits and weights in the first
    forward stage, the unweights and (lo, hi) in the last inverse one)
    against the base-field products per word (F3_OPS_31/61 each)."""
    n = t.n
    plane = 24 * n                      # (2, n) u32 and (2, n) u64
    if which == "sqr":
        moved, prods = 2 * plane, 3
    else:
        st = t.stages[i]
        moved = 2 * plane + 24 * (st.r - 1) * st.m
        # the twiddle products (4 per complex product), radix 3's w3 one
        prods = 4 * (st.r - 1) / st.r + (4 / 3 if st.r == 3 else 0)
        if i == 0 and which == "fwd":
            moved += 8 * n              # digits, and the weights (a plane)
            prods += 2
        if i == 0 and which == "inv":
            moved += plane - 8 * n      # unweights in, (lo, hi) out
            prods += 2.5                # the real part, the CRT's product
    ops = n * prods * (F3_OPS_31 + F3_OPS_61)
    ops_ms = ops / INT8_OPS_PER_S * 1e3
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else \
        (bytes_ms, "bytes")


def fft3161_drive(root: str, dev, card: str, chains=None, jobs=None):
    """Phase 10 on the card; returns ({entry: max_abs_err}, {entry: (ms,
    plain ms)}, {entry: (bound ms, by)}, the wrapper counts of the
    Engine3161 drive). chains: the CLI goldens (fft3161_chains) if the
    caller started them; jobs: the GMP work (f3_gmp_jobs)."""
    import numpy as np
    import torch

    from prmers_tpu_torch.core import tune
    from prmers_tpu_torch.engine import engine3161 as e3
    from prmers_tpu_torch.engine.factory import create_engine
    from prmers_tpu_torch.engine.policy import decide_arith
    from prmers_tpu_torch.ops import kernels as tk
    from prmers_tpu_torch.ops import ntt2

    t0 = time.perf_counter()
    if chains is None:
        chains = fft3161_chains(root)
    if jobs is None:
        jobs = f3_gmp_jobs()
    errs = {k: 0.0 for k in F3_KERNELS}
    rows = {k: [] for k in F3_KERNELS}  # (ms, plain ms, bound ms, by)

    def err(a, b) -> float:
        if torch.equal(a, b):
            return 0.0
        a = a.long().cpu().numpy().view(np.uint64).reshape(-1)
        b = b.long().cpu().numpy().view(np.uint64).reshape(-1)
        bad = np.nonzero(a != b)[0][:4096]
        return float(max(abs(int(a[i]) - int(b[i])) for i in bad))

    def record(name, what, got, want):
        torch.cuda.synchronize()
        e = max(err(g, w) for g, w in zip(got, want))
        errs[name] = max(errs[name], e)
        if e != 0.0:
            raise AssertionError(f"{name} {what} disagrees with its plain "
                                 f"version (max_abs_err {e})")

    def timing(name, i, which, kern, plain, reps):
        # the better of two runs: one host stall past the device sleep
        # (PR 15's first call read one launch at 3.3 ms, the rest < 0.13)
        # would otherwise dominate the mean
        k = min(device_timed(kern, reps), device_timed(kern, reps))
        pl = timed(plain, 2)
        rows[name].append((k, pl) + f3_bound(t, i, which))

    # (d) first: the goldens run on this card in other processes, and the
    # times below must not share it with them
    check_fft3161_chains(chains)

    # (a) K10-K12 against their plain versions, exact (canonical words and
    # the CRT's (lo, hi)); timed at 2^22 words
    for p in F3_CHECK:
        t1 = time.perf_counter()
        t = e3.get_tables(p, None, dev)
        torch.cuda.synchronize()
        n, radices = t.n, [s.r for s in t.stages]
        log(f"[10] p={p} n={n} radices {radices}: tables (numpy host "
            f"build, to the card) in {time.perf_counter() - t1:.3f} s")
        rng = np.random.default_rng(p)
        d = torch.from_numpy(rng.integers(0, 1 << 62, n, dtype=np.int64))
        d = d.to(dev) & t.masks
        x31 = torch.zeros((2, n), dtype=torch.int32, device=dev)
        x61 = torch.zeros((2, n), dtype=torch.int64, device=dev)
        timed_here = p == P_MAIN
        for i in range(len(t.stages)):
            di = d if i == 0 else None
            want = ntt2.fwd_stage_plain(t, i, x31, x61, di)
            if timed_here:
                s31, s61 = x31.clone(), x61.clone()
                timing("f3_fwd_stage", i, "fwd",
                       lambda: tk.f3_fwd_stage(t, i, s31, s61, di),
                       lambda: ntt2.fwd_stage_plain(t, i, x31, x61, di), 5)
            tk.f3_fwd_stage(t, i, x31, x61, di)
            record("f3_fwd_stage", f"n={n} stage {i}", (x31, x61), want)
        m31, m61 = x31.clone(), x61.clone()
        for m in ((m31, m61), (None, None)):
            want = ntt2.pointwise_plain(x31, x61, *m)
            if timed_here and m[0] is None:
                s31, s61 = x31.clone(), x61.clone()
                timing("f3_pointwise", 0, "sqr",
                       lambda: tk.f3_pointwise(t, s31, s61),
                       lambda: ntt2.pointwise_plain(x31, x61), 5)
            tk.f3_pointwise(t, x31, x61, *m)
            record("f3_pointwise", f"n={n}", (x31, x61), want)
        lo = torch.empty(n, dtype=torch.int64, device=dev)
        hi = torch.empty_like(lo)
        for i in range(len(t.stages) - 1, -1, -1):
            out = (lo, hi) if i == 0 else ()
            want = ntt2.inv_stage_plain(t, i, x31, x61)
            if timed_here:
                s31, s61 = x31.clone(), x61.clone()
                so = tuple(torch.empty_like(lo) for _ in out)
                timing("f3_inv_stage", i, "inv",
                       lambda: tk.f3_inv_stage(t, i, s31, s61, *so),
                       lambda: ntt2.inv_stage_plain(t, i, x31, x61), 5)
            tk.f3_inv_stage(t, i, x31, x61, *out)
            record("f3_inv_stage", f"n={n} stage {i}",
                   out if i == 0 else (x31, x61), want)
        log(f"[10]   n={n}: K10 x {len(radices)}, K12 sqr and mul, K11 x "
            f"{len(radices)} to (lo, hi) equal their plain versions")
    ms, bounds = {}, {}
    for name in F3_KERNELS:
        r = rows[name]
        for i, (k, pl, b, by) in enumerate(r):
            log(f"[10] {name} n=2^22 launch {i}: kernel {k:.6f} ms, plain "
                f"{pl:.6f} ms, bound {b:.6f} ms ({by}) ({card})")
        ms[name] = (sum(x[0] for x in r) / len(r),
                    sum(x[1] for x in r) / len(r))
        bounds[name] = (sum(x[2] for x in r) / len(r),
                        max(r, key=lambda x: x[2])[3])
        log(f"[10] {name} n=2^22 mean of {len(r)} launches: kernel "
            f"{ms[name][0]:.6f} ms, plain {ms[name][1]:.6f} ms, bound "
            f"{bounds[name][0]:.6f} ms ({card})")
    torch.cuda.empty_cache()

    # (b) Engine3161 through create_engine against GMP at each size, then
    # the F3_CHAIN squarings at 2^22; wrapper counts reset just before and
    # read just after (a graph's replays count what its capture recorded)
    tk.reset_calls()
    for p in F3_CHECK:
        eng = create_engine(p, 6, device=dev, arith="fft3161")
        if type(eng) is not e3.Engine3161:
            raise AssertionError(f"arith fft3161 gave {type(eng).__name__}")
        t1 = time.perf_counter()
        v, w, want = jobs[p].result()
        wait = time.perf_counter() - t1
        t1 = time.perf_counter()
        eng.set(0, v)
        eng.set(1, w)
        eng.square_mul_seq(0, F3_A)
        eng.set_multiplicand(2, 1)
        eng.mul(0, 2, 3)
        eng.add(0, 1)
        eng.sub_reg(1, 0)
        eng.sub(0, 5)
        eng.sync()
        dt = time.perf_counter() - t1
        ok = (np.array_equal(eng.get_digits(0), want[0]),
              np.array_equal(eng.get_digits(1), want[1]))
        log(f"[10] Engine3161 p={p} (n={eng.get_size()}): {len(F3_A)} "
            f"squarings with a = 3, 1, mul x 3, add, sub_reg, sub in "
            f"{dt:.3f} s (GMP waited {wait:.3f} s): equal to GMP {ok}")
        if not all(ok):
            raise AssertionError(f"Engine3161 disagrees with GMP at p={p}")
        del eng
    eng = create_engine(P_MAIN, 2, device=dev, arith="fft3161")
    v, want = jobs["chain"].result()
    eng.set(0, v)
    t1 = time.perf_counter()
    eng.square_mul_seq(0, (1, 3) * (F3_CHAIN // 2))
    eng.sync()
    dt = time.perf_counter() - t1
    ok = np.array_equal(eng.get_digits(0), want)
    log(f"[10] Engine3161 p={P_MAIN} (n=2^22): {F3_CHAIN} squarings, a = "
        f"1, 3 in turn, in {dt:.3f} s (graphs captured on the way): equal "
        f"to GMP {ok}")
    if not ok:
        raise AssertionError("Engine3161 disagrees with GMP at 2^22")
    del eng
    counts = dict(tk.calls)
    log(f"[10] Engine3161 drive wrapper calls {counts}")
    for name in F3_KERNELS:
        if counts[name] <= 0:
            raise AssertionError(f"{name} was not launched on the fft3161 "
                                 "path")
    torch.cuda.empty_cache()

    # (c) iter/s against gl64 at the same p, in turns
    for p, iters in F3_RATES:
        got = {"fft3161": [], "gl64": []}
        names = {}
        for arith in ("fft3161", "gl64", "gl64", "fft3161"):
            eng = create_engine(p, 2, device=dev, arith=arith)
            names[arith] = f"{type(eng).__name__} n={eng.get_size()}"
            got[arith].append(tune.measure_ips(eng, iters=iters))
            del eng
            torch.cuda.empty_cache()
        log(f"[10] PRP @ p={p}: fft3161 ({names['fft3161']}) "
            f"{sum(got['fft3161']) / 2:.6f} iter/s (runs "
            f"{got['fft3161'][0]:.6f}, {got['fft3161'][1]:.6f}), gl64 "
            f"({names['gl64']}) {sum(got['gl64']) / 2:.6f} iter/s (runs "
            f"{got['gl64'][0]:.6f}, {got['gl64'][1]:.6f}); {iters} "
            f"squarings a run ({card})")

    # (e) -tune capped at F3_TUNE_CAP in its own save dir and the
    # decisions it then gives, (f) one -profile run
    rc, out, dt, _j, d = cli_run(root, "f3-tune", [str(F3_TUNE_CAP),
                                                   "-tune"],
                                 phase=10, result=False)
    for ln in out.splitlines():
        if ln.startswith("tune:"):
            log(f"[10]   {ln}")
    data = tune.load(d)
    log(f"[10] -tune (rc={rc}, {dt:.3f} s) wrote {tune.tune_path(d)}: "
        f"{json.dumps(data, sort_keys=True)} ({card})")
    measured = {(p, a) for ln in out.splitlines() if ln.startswith("tune:")
                for p, a in [(int(ln.split("p=")[1].split()[0]),
                              ln.split()[2])]}
    want = {(p, a) for p in F3_TUNE_LADDER for a in ("gl64", "fft3161")}
    if rc != 0 or not want <= measured:
        raise AssertionError(f"-tune measured {sorted(measured)}")
    for p in F3_TUNE_LADDER:
        dec = decide_arith(p, "prp", d)
        log(f"[10] decide_arith({p}, prp) on these rates: {dec.arith} "
            f"({dec.reason}; n_gl64={dec.n_gl64} {dec.ips_gl64:.3f} "
            f"iter/s, n_3161={dec.n_3161} {dec.ips_3161:.3f} iter/s)")
    rc, out, dt, j, _d = cli_run(root, "f3-profile", ["9941", "-profile",
                                                      "-noproof"], phase=10)
    report = [ln for ln in out.splitlines() if ln.startswith("[profile]")]
    for ln in report:
        log(f"[10]   {ln}")
    if rc != 0 or j["status"] != "P" or \
            not any(ln.startswith("[profile] engine p=9941") for ln in
                    report):
        raise AssertionError("-profile printed no report")
    log(f"[10] phase 10 in {time.perf_counter() - t0:.3f} s")
    return errs, ms, bounds, counts


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    import numpy as np

    from prmers_tpu_torch import bench
    from prmers_tpu_torch.core.plan import build_plan, cached_plan
    from prmers_tpu_torch.engine.factory import create_engine
    from prmers_tpu_torch.engine.fourstep_engine import (four_step_plan,
                                                         get_tables,
                                                         host_tables)
    from prmers_tpu_torch.ops import build
    from prmers_tpu_torch.ops import fourstep as tfs
    from prmers_tpu_torch.ops import gl64 as gl
    from prmers_tpu_torch.ops import kernels as tk
    from prmers_tpu_torch.ops import probes as pr
    from prmers_tpu_torch.tools import profile_passes
    from prmers_tpu_torch.utils import digits as dg
    from prmers_tpu_torch.utils import gmp

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = bench.card()

    def mark(phase):
        log(f"[smoke] phase {phase} from {time.perf_counter() - t_start:.3f}"
            " s")
    log(f"[1] card: {card}")
    log(f"[1] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    # the full smoke's five largest kernel plans: their host tables build on
    # a thread from here, beside nvcc and phase 2's smaller sizes (phase 2
    # waits for each before it uses it)
    prebuilt = {}
    if not any(a.startswith("--") for a in argv):
        prebuild = ThreadPoolExecutor(max_workers=1)
        for p, n in ((P_MAIN, 1 << 23), (P_BIG, cached_plan(P_BIG).n),
                     (P_HUGE, cached_plan(P_HUGE).n), (P_R5, 5 << 22),
                     (P_R5_BIG, 5 << 23)):
            prebuilt[p] = prebuild.submit(
                lambda p=p, n=n: host_tables(
                    four_step_plan(build_plan(p, n=n), tfs.Pipeline())))
        prebuild.shutdown(wait=False)
    t0 = time.perf_counter()
    built = not os.path.exists(build.library_path())
    build.lib()
    log(f"[1] kernels {'built' if built else 'reused'} in "
        f"{time.perf_counter() - t0:.3f} s ({build.library_path()})")
    if "--mm31" in argv:
        mm31(dev, card)
        print(card)
        return 0
    if "--tools-only" in argv:
        timed7, calls, library = tools_drive(dev, card)
        print(json.dumps({"tools": [e.row() for e in timed7],
                          "calls": calls,
                          "library": {k: v.row()
                                      for k, v in library.items()}}))
        print(card)
        return 0
    if "--anysize-only" in argv:
        anysize_drive(root, dev, card)
        print(card)
        return 0
    if "--fft3161-only" in argv:
        fft3161_drive(root, dev, card)
        print(card)
        return 0
    if "--modes-only" in argv:
        modes_drive(root, dev, card, full="--pm1-full" in argv)
    if "--ecm-goldens" in argv:
        ecm_goldens(root, dev, card)
    if "--ecm-kernel-plan" in argv:
        ecm_kernel_plan(root, card)
    if any(a in argv for a in ("--modes-only", "--ecm-goldens",
                               "--ecm-kernel-plan")):
        print(card)
        return 0
    if "--mesh-only" in argv:
        single = {p: bench.measure(p, warm=4, iters=48)
                  for p in (P_MAIN, P_R5)}
        torch.cuda.empty_cache()
        mesh = mesh_drive(root, card, dev, single, extras_at_1=True)
        print(json.dumps({"single": single, "mesh": {s: {
            "ips": [r["ips"] for r in ranks],
            "block_ips": [r["block_ips"] for r in ranks],
            "r5_ips": [r["r5_ips"] for r in ranks],
            "xla_ips": [r["xla_ips"] for r in ranks],
            "collective_ms": ranks[0]["collective_ms"]}
            for s, ranks in mesh.items()}}))
        print(card)
        return 0

    # the GMP side of phase 3, on threads from here on
    log(f"[1] HAVE_GMP {gmp.HAVE_GMP}")
    if not gmp.HAVE_GMP:
        raise RuntimeError("libgmp is needed for the big-int checks")
    f3_jobs = f3_gmp_jobs()
    pool = ThreadPoolExecutor(max_workers=4)
    expected = {p: pool.submit(drive_values, p) for p in (
        P_R5_BIG, P_BIG, P_R5, P_MAIN, P_CHAIN, P_R5_SMALL, P_GOLDEN)}
    # phase 6's radix-5 and XLA-form mesh checks: their GMP values too
    extras_pool = ThreadPoolExecutor(max_workers=2)
    v5, extras = extras_jobs(extras_pool, expected[P_R5])

    mark(2)
    # ---- 2: every kernel against its plain version -----------------------
    errs = {e[0]: 0.0 for e in ENTRIES}

    def max_abs_err(a, b) -> float:
        a = gl.to_numpy_u64(a).reshape(-1)
        b = gl.to_numpy_u64(b).reshape(-1)
        bad = np.nonzero(a != b)[0]
        if bad.size == 0:
            return 0.0
        return float(max(abs(int(a[i]) - int(b[i])) for i in bad[:4096]))

    def record(entry, what, got, want, canon=True, phase=2):
        torch.cuda.synchronize()
        if canon:
            got, want = gl.canon64(got), gl.canon64(want)
        e = max_abs_err(got, want)
        errs[entry] = max(errs[entry], e)
        log(f"[{phase}]   {entry} {what}: max_abs_err {e}")
        if e != 0.0:
            raise AssertionError(f"{entry} {what} disagrees with its plain "
                                 f"version (max_abs_err {e})")

    def tables(p, n, pipe=tfs.Pipeline()):
        plan = build_plan(p, n=n)
        if p in prebuilt and pipe == tfs.Pipeline():
            t1 = time.perf_counter()
            prebuilt.pop(p).result()
            log(f"[2] p={p}: waited {time.perf_counter() - t1:.3f} s for "
                "its host tables (built on a thread since phase 1)")
        t1 = time.perf_counter()
        tracemalloc.start()
        t = get_tables(plan, dev, pipe)
        peak = tracemalloc.get_traced_memory()[1]
        tracemalloc.stop()
        log(f"[2] n=2^{n.bit_length() - 1} p={p} {pipe}: (R1, R2, C)="
            f"{t.shape}, carry units {t.carry_shape}, ct {t.ct}; tables "
            f"{time.perf_counter() - t1:.3f} s, host peak "
            f"{peak / 2**30:.3f} GiB")
        return plan, t

    def case(label, p, n, pipe=tfs.Pipeline()):
        plan, t = tables(p, n, pipe)
        big = t.ct < t.shape[2]
        k1, k3 = ("k1_p1c[T>1]", "k3_p7c[T>1]") if big else \
            ("k1_p1c", "k3_p7c")
        # the radix-5 r2 DFT's forms are entries of their own
        r5 = "[r5]" if n % 5 == 0 else ""
        rng = np.random.default_rng(n.bit_length())
        # random digits, each below 2^width: a register of the plan
        wid = plan.widths.astype(np.uint64)
        x = gl.from_numpy_u64(
            rng.integers(0, 1 << 32, size=n, dtype=np.uint64)
            & ((np.uint64(1) << wid) - np.uint64(1)), dev).reshape(t.shape)
        co = torch.from_numpy(rng.integers(0, 1 << 40, size=t.carry_shape,
                                           dtype=np.int64)).to(dev)
        sp = tk.p1_carry_plain(t, x, co)
        record(k1, label, tk.p1_carry_pass(t, x, co), sp)
        k5 = "k5_axis1" + r5 + ("[L2=128]" if t.shape[1] == 128 else "")
        for which in ("p2", "p6"):
            record(k5, f"{label} {which}",
                   tk.axis1_pass(t, sp, which), tk.axis1_plain(t, sp, which))
        u = gl.canon64(tk.fused_c_plain(t, sp, "fwd"))
        for r2fold, entry in ((True, "k2_fused_c" + r5),
                              (False, "k6_fused_c")):
            for mode in ("sqr", "fwd", "mul"):
                um = u if mode == "mul" else None
                got = tk.fused_c_pass(t, sp, mode, u=um, r2fold=r2fold)
                record(entry, f"{label} {mode}", got,
                       tk.fused_c_plain(t, sp, mode, um, r2fold))
                if mode == "fwd" and not r2fold:
                    spec = got
        for op in ("sqr", "mul", ""):
            um = u if op == "mul" else None
            record("k6b_fused_c_invh", f"{label} op={op!r}",
                   tk.fused_c_invh_pass(t, spec, op, u=um),
                   tk.fused_c_invh_plain(t, spec, op, um))
        z = tk.fused_mid(t, sp.clone(), "sqr")   # lazy, as K3 gets it
        for a, sub2 in ((1, False), (3, False), (1, True)):
            d, c = tk.p7_carry_pass(t, z, a=a, sub2=sub2)
            dw, cw = tk.p7_carry_plain(t, z, a, sub2)
            what = f"{label} a={a} sub2={sub2}"
            record(k3, what + " digits", d, dw, canon=False)
            record(k3, what + " carries", c, cw, canon=False)
        # the block-carry kernels on the same tables: K4 forward on the
        # digits with and without (R1, 1) carries, K4 inverse on K3's
        # input, K7 on K4 inverse's output
        bco = torch.from_numpy(rng.integers(0, 1 << 45,
                                            size=t.block_carry_shape,
                                            dtype=np.int64)).to(dev)
        for c, what in ((None, "fwd"), (bco, "fwd+carries")):
            record("k4_axis0", f"{label} {what}",
                   tk.axis0_pass(t, x, False, co=c),
                   tk.axis0_plain(t, x, False, co=c))
        y = tk.axis0_pass(t, z, True)
        record("k4_axis0", f"{label} inverse", y, tk.axis0_plain(t, z, True),
               canon=False)
        for a in (1, 3):
            d, c = tk.block_carry_pass(t, y, a)
            dw, cw = tk.block_carry_plain(t, y, a)
            record("k7_block_carry", f"{label} a={a} digits", d, dw,
                   canon=False)
            record("k7_block_carry", f"{label} a={a} carries", c, cw,
                   canon=False)
        return t, x, co, sp, spec, z, bco, y

    def unfolded_case(label, t, x):
        """K4u and K5u: the four passes of forward_r (with a scalar carry)
        and inverse_r in each form, against their plain versions, mod P."""
        tu = tk.with_unfolded(t)
        z = gl.from_numpy_u64(np.random.default_rng(t.fp.n).integers(
            0, gl.P, size=t.shape, dtype=np.uint64), dev)
        for shift in (False, True):
            ps = tk.r_passes(tu, shift, profile_passes.CIN)
            for name in tk.R_PASSES:
                axis, inverse, kw = ps[name]
                v = x if name.endswith("fwd") else z
                record(("k4u_pass" if axis == 0 else "k5u_pass")
                       + ("[shift]" if shift else ""), f"{label} {name}",
                       tk.axis_pass(v, axis, inverse, **kw),
                       tk.axis_pass_plain(v, axis, inverse, **kw))

    for logn in (15, 18):
        n = 1 << logn
        got = case(f"n=2^{logn}", int(n * 16.5) | 1, n)
        if logn == 15:
            unfolded_case("n=2^15", got[0], got[1])
    case("n=2^16 T=4", int((1 << 16) * 16.5) | 1, 1 << 16,
         tfs.Pipeline(carry_max=16384))
    case("n=2^18 split T=2", int((1 << 18) * 16.5) | 1, 1 << 18,
         tfs.Pipeline(r2fold_max=2048, carry_max=1 << 17, fc_split=True))
    main_in = case("n=2^23", P_MAIN, 1 << 23)
    big_in = case("n=2^25", P_BIG, cached_plan(P_BIG).n)
    huge_in = case("n=2^26", P_HUGE, cached_plan(P_HUGE).n)
    torch.cuda.empty_cache()
    case("n=5*2^16", P_R5_SMALL, 5 << 16)
    for logn in (17, 18, 19, 20, 21):
        case(f"n=5*2^{logn}", int((5 << logn) * 16.5) | 1, 5 << logn)
    r5_in = case("n=5*2^22", P_R5, 5 << 22)
    r5_big_in = case("n=5*2^23", P_R5_BIG, 5 << 23)
    torch.cuda.empty_cache()

    def chain_case(logn):
        """K9 from random digits and carries, a = [3, 1, 3], then a chain
        of 2 on its carries: bit for bit against the plain chain and the
        CUDA three-kernel steps."""
        n = 1 << logn
        p = P_CHAIN if logn == 19 else int(n * 16.5) | 1
        plan, t = tables(p, n)
        if not tfs.chain_ok(t.fp):
            raise AssertionError(f"K9 does not take n=2^{logn}")
        rng = np.random.default_rng(100 + logn)
        v = int.from_bytes(rng.bytes(p // 8 + 1), "little") % ((1 << p) - 1)
        x0 = gl.from_numpy_u64(dg.int_to_digits(v, plan.widths),
                               dev).reshape(t.shape)
        co0 = torch.from_numpy(rng.integers(0, 1 << 40, size=t.carry_shape,
                                            dtype=np.int64)).to(dev)
        x, co = x0, co0
        for a in ([3, 1, 3], [1, 3]):
            d, c = tk.square_chain(t, x, co, a)
            dw, cw = tk.square_chain_plain(t, x, co, a, len(a))
            what = f"n=2^{logn} a={a}"
            record("k9_chain", what + " digits", d, dw, canon=False)
            record("k9_chain", what + " carries", c, cw, canon=False)
            sx, sc = x, co
            for ak in a:
                sx, sc = tk.square_step(t, sx, sc, a=ak)
            record("k9_chain", what + " digits vs 3-kernel steps", d, sx,
                   canon=False)
            record("k9_chain", what + " carries vs 3-kernel steps", c, sc,
                   canon=False)
            x, co = d, c
        return t, x0, co0

    chain_in = {logn: chain_case(logn) for logn in range(15, 20)}

    mark(3)
    # ---- 3: both paths through the Engine API, against GMP ----------------
    counts = {}

    def drive(p, path, kernels, pipe=None):
        """The ops of a PRP/LL run on one engine (create_engine's pipeline,
        or pipe); returns the call counts of the driven ops (reset just
        before, read just after)."""
        eng = create_engine(p, 6, device=dev, pipe=pipe)
        t1 = time.perf_counter()
        v, w, s, want = expected[p].result()
        log(f"[3] {path} path p={p}: waited {time.perf_counter() - t1:.3f} "
            f"s for GMP")
        eng.set(0, 3 << s)
        eng.set(1, v)
        eng.set(2, w)
        eng.copy(4, 2)
        eng.sync()
        tk.reset_calls()
        t1 = time.perf_counter()
        eng.square_mul_seq(0, [1] * DRIVE_K)    # (3 * 2^s)^(2^K)
        eng.square_mul(0, 3)                    # ^2 * 3
        eng.square_mul(1, 3)                    # v^2 * 3
        eng.set_multiplicand(3, 2)
        eng.mul(1, 3)                           # v^2 * 3 * w
        eng.square_sub2_seq(4, 1)               # w^2 - 2
        eng.sync()
        got = dict(tk.calls)
        log(f"[3] {path} path p={p} (n={eng.get_size()}): {DRIVE_K + 5} "
            f"steps in {time.perf_counter() - t1:.3f} s; wrapper calls {got}")
        for name in kernels:
            if got[name] <= 0:
                raise AssertionError(f"{name} was not launched on the {path}"
                                     " path")
        t1 = time.perf_counter()
        ok = [bool(np.array_equal(eng.get_digits(r), want[i]))
              for i, r in enumerate((0, 1, 4))]
        log(f"[3] {path} path big-int check (digits) in "
            f"{time.perf_counter() - t1:.3f} s: sparse chain {ok[0]}, "
            f"x3 + mul {ok[1]}, sub2 {ok[2]}")
        if not all(ok):
            raise AssertionError(f"the {path} path disagrees with GMP")
        return got

    counts["main"] = drive(P_MAIN, "main", ("k1_p1c", "k2_fused_c",
                                            "k3_p7c"))
    counts["big"] = drive(P_BIG, "big", ("k1_p1c", "k3_p7c", "k5_axis1",
                                         "k6_fused_c", "k6b_fused_c_invh"))
    torch.cuda.empty_cache()
    counts["chain"] = drive(P_CHAIN, "chain", ("k9_chain",))
    # on the chain path K1-K3 serve set_multiplicand (K1, K2 "fwd"), mul
    # and the LL sub2 step (K1, K2, K3 each), and nothing else
    want = {name: 0 for name in tk.KERNELS}
    want.update(k1_p1c=3, k2_fused_c=3, k3_p7c=2,
                k9_chain=counts["chain"]["k9_chain"])
    if counts["chain"] != want:
        raise AssertionError(f"chain path wrapper calls {counts['chain']}, "
                             f"expected {want}")
    # the block-carry path at the main, big and smallest shapes, and the
    # hybrid at the main one: no row-carry kernel and no K9 (no K7 in the
    # hybrid, whose carry is carry_full)
    block, hybrid = tfs.Pipeline(rowcarry=False), tfs.Pipeline(xla_carry=True)
    for key, p, path, kernels, pipe in (
            ("block", P_MAIN, "block", ("k4_axis0", "k2_fused_c",
                                        "k7_block_carry"), block),
            ("block big", P_BIG, "block big", (
                "k4_axis0", "k5_axis1", "k6_fused_c", "k6b_fused_c_invh",
                "k7_block_carry"), block),
            ("block small", P_GOLDEN, "block small", (
                "k4_axis0", "k2_fused_c", "k7_block_carry"), block),
            ("hybrid", P_MAIN, "hybrid", ("k4_axis0", "k2_fused_c"),
             hybrid)):
        counts[key] = drive(p, path, kernels, pipe)
        off = ("k1_p1c", "k3_p7c", "k9_chain") + \
            (("k7_block_carry",) if pipe is hybrid else ())
        if any(counts[key][name] for name in off):
            raise AssertionError(f"{path} path ran {off}: {counts[key]}")
        torch.cuda.empty_cache()
    # radix 5: K2 up to n = 5 * 2^22, K5 + K6 + K5 from 5 * 2^23; K9
    # never (chain_ok needs a power-of-two L2), and no row-carry kernel
    # on the block carry
    for key, p, kernels, pipe in (
            ("r5", P_R5, ("k1_p1c", "k2_fused_c", "k3_p7c"), None),
            ("r5 block", P_R5, ("k4_axis0", "k2_fused_c", "k7_block_carry"),
             block),
            ("r5 small", P_R5_SMALL, ("k1_p1c", "k2_fused_c", "k3_p7c"),
             None),
            ("r5 big", P_R5_BIG, ("k1_p1c", "k3_p7c", "k5_axis1",
                                  "k6_fused_c"), None)):
        counts[key] = drive(p, key, kernels, pipe)
        off = ("k9_chain",) + (("k1_p1c", "k3_p7c") if pipe else ())
        if any(counts[key][name] for name in off):
            raise AssertionError(f"{key} path ran {off}: {counts[key]}")
        torch.cuda.empty_cache()
    pool.shutdown()
    del expected

    mark(4)
    # ---- 4: timings -------------------------------------------------------
    ips4 = {}
    for p, warm, iters in ((P_MAIN, 16, 192), (P_BIG, 4, 48),
                           (P_HUGE, 4, 24), (P_R5, 4, 48), (P_R5_BIG, 4, 24)):
        tk.reset_calls()
        ips = ips4[p] = bench.measure(p, warm=warm, iters=iters)
        if p == P_HUGE:
            # the 2^26 path (K5 at L2 = 128): this chain's wrapper counts
            counts["huge"] = dict(tk.calls)
            log(f"[4] p={p} chain wrapper calls {counts['huge']}")
            if counts["huge"]["k5_axis1"] <= 0:
                raise AssertionError("k5_axis1 was not launched at 2^26")
        log(f"[4] PRP {ips:.6f} iter/s @ p={p} ({card})")
        torch.cuda.empty_cache()
    ips = bench.measure(P_R5, warm=4, iters=48, pipe=block)
    log(f"[4] PRP {ips:.6f} iter/s @ p={P_R5} through the block carry "
        f"({card})")
    got = {"row carry": [], "block carry": [], "hybrid": []}
    pipes = {"row carry": tfs.Pipeline(), "block carry": block,
             "hybrid": hybrid}
    for label in ("row carry", "block carry", "hybrid", "hybrid",
                  "block carry", "row carry"):
        got[label].append(bench.measure(P_MAIN, warm=16, iters=192,
                                        pipe=pipes[label]))
    for label, v in got.items():
        log(f"[4] PRP {sum(v) / 2:.6f} iter/s @ p={P_MAIN} through the "
            f"{label} (runs {v[0]:.6f}, {v[1]:.6f}; {card})")
    row_ips = sum(got["row carry"]) / 2
    torch.cuda.empty_cache()
    no_chain = tfs.Pipeline(chain=False)
    for p, iters in ((P_GOLDEN, 4096), (P_CHAIN, 1024)):
        got = {"K9": [], "3-kernel": []}
        for label in ("K9", "3-kernel", "3-kernel", "K9"):
            pipe = None if label == "K9" else no_chain
            got[label].append(bench.measure(p, warm=64, iters=iters,
                                            pipe=pipe))
        for label, v in got.items():
            log(f"[4] PRP {sum(v) / 2:.6f} iter/s @ p={p} through {label} "
                f"(runs {v[0]:.6f}, {v[1]:.6f}; {card})")

    ms = {}

    def compare(entry, at, what, kern, plain, reps, phase=4):
        p0 = timed(plain, 3)
        k0 = device_timed(kern, reps)
        k1 = device_timed(kern, reps)
        p1 = timed(plain, 3)
        got = ((k0 + k1) / 2, (p0 + p1) / 2)
        log(f"[{phase}] {entry} {what} {at}: kernel {got[0]:.6f} ms, "
            f"plain {got[1]:.6f} ms ({card})")
        return got

    def block_kernels(at, reps, inputs):
        """K4 (the mean of forward with carries and inverse) and K7 (a = 1)
        as the block path runs them."""
        t, x, _co, _sp, _spec, z, bco, y = inputs
        f = compare("k4_axis0", at, "fwd+carries",
                    lambda: tk.axis0_pass(t, x, False, co=bco),
                    lambda: tk.axis0_plain(t, x, False, co=bco), reps)
        i = compare("k4_axis0", at, "inverse",
                    lambda: tk.axis0_pass(t, z, True),
                    lambda: tk.axis0_plain(t, z, True), reps)
        k7 = compare("k7_block_carry", at, "a=1",
                     lambda: tk.block_carry_pass(t, y),
                     lambda: tk.block_carry_plain(t, y), reps)
        return ((f[0] + i[0]) / 2, (f[1] + i[1]) / 2), k7

    ms["k4_axis0"], ms["k7_block_carry"] = block_kernels("n=2^23", 20,
                                                         main_in)
    block_kernels("n=2^25", 10, big_in)
    t, x, co, sp, spec, z, _bco, _y = main_in
    ms["k1_p1c"] = compare("k1_p1c", "n=2^23", "",
                           lambda: tk.p1_carry_pass(t, x, co),
                           lambda: tk.p1_carry_plain(t, x, co), 20)
    ms["k2_fused_c"] = compare(
        "k2_fused_c", "n=2^23", "sqr", lambda: tk.fused_c_pass(t, sp, "sqr"),
        lambda: tk.fused_c_plain(t, sp, "sqr"), 20)
    ms["k3_p7c"] = compare("k3_p7c", "n=2^23", "a=1",
                           lambda: tk.p7_carry_pass(t, z),
                           lambda: tk.p7_carry_plain(t, z), 20)
    t, x, co, sp, spec, z, _bco, _y = big_in
    ms["k1_p1c[T>1]"] = compare(
        "k1_p1c[T>1]", "n=2^25", "", lambda: tk.p1_carry_pass(t, x, co),
        lambda: tk.p1_carry_plain(t, x, co), 10)
    ms["k3_p7c[T>1]"] = compare(
        "k3_p7c[T>1]", "n=2^25", "a=1", lambda: tk.p7_carry_pass(t, z),
        lambda: tk.p7_carry_plain(t, z), 10)

    def k5_mean(entry, at, t, sp, reps):
        """K5: the mean of P2 and P6."""
        p2 = compare(entry, at, "p2", lambda: tk.axis1_pass(t, sp, "p2"),
                     lambda: tk.axis1_plain(t, sp, "p2"), reps)
        p6 = compare(entry, at, "p6", lambda: tk.axis1_pass(t, sp, "p6"),
                     lambda: tk.axis1_plain(t, sp, "p6"), reps)
        return (p2[0] + p6[0]) / 2, (p2[1] + p6[1]) / 2

    ms["k5_axis1"] = k5_mean("k5_axis1", "n=2^25", t, sp, 10)
    ms["k5_axis1[L2=128]"] = k5_mean("k5_axis1[L2=128]", "n=2^26",
                                     huge_in[0], huge_in[3], 10)
    ms["k6_fused_c"] = compare(
        "k6_fused_c", "n=2^25", "fwd",
        lambda: tk.fused_c_pass(t, sp, "fwd", r2fold=False),
        lambda: tk.fused_c_plain(t, sp, "fwd", r2fold=False), 10)
    ms["k6b_fused_c_invh"] = compare(
        "k6b_fused_c_invh", "n=2^25", "sqr",
        lambda: tk.fused_c_invh_pass(t, spec, "sqr"),
        lambda: tk.fused_c_invh_plain(t, spec, "sqr"), 10)
    t, x, co, sp, spec, z, _bco, _y = r5_in
    ms["k2_fused_c[r5]"] = compare(
        "k2_fused_c[r5]", "n=5*2^22", "sqr",
        lambda: tk.fused_c_pass(t, sp, "sqr"),
        lambda: tk.fused_c_plain(t, sp, "sqr"), 5)
    ms["k5_axis1[r5]"] = k5_mean("k5_axis1[r5]", "n=5*2^23", r5_big_in[0],
                                 r5_big_in[3], 5)
    # the least time the card could take for each timed call
    def nbytes(*tensors):
        return sum(a.numel() * a.element_size() for a in tensors)

    def bound(products, moved):
        ops_ms = products * OPS_PER_PRODUCT / INT8_OPS_PER_S * 1e3
        bytes_ms = moved / HBM_BYTES_PER_S * 1e3
        return ((ops_ms, "operations") if ops_ms >= bytes_ms
                else (bytes_ms, "bytes"))

    def shape_of(t):
        R1, R2, C = t.shape
        return R1, R2, C // 128, t.mf.numel(), t.carry_shape

    K9_STEPS = profile_passes.K9_STEPS
    for logn, (t, x, co) in chain_in.items():
        ones = tk.chain_multipliers([1] * tk.CHAIN_K, dev)
        xk, ck = x.clone(), co.clone()

        def k9():
            tk.square_chain(t, xk, ck, ones, count=K9_STEPS, out=xk,
                            co_out=ck)

        def steps():
            for _ in range(K9_STEPS):
                tk.square_step(t, xk, ck, out=xk, co_out=ck)

        def move():
            # the cut-down body: K9's grid, loads, stores and barriers
            tk.square_chain_part(t, xm, cm, ones, K9_STEPS, "move")

        def plain():
            tk.square_chain_plain(t, x, co, [1, 1], 2)

        xm, cm = x.clone(), co.clone()
        k0, s0, m0 = timed(k9, 3), timed(steps, 3), timed(move, 3)
        m1, s1, k1 = timed(move, 3), timed(steps, 3), timed(k9, 3)
        kms = (k0 + k1) / 2 / K9_STEPS
        sms = (s0 + s1) / 2 / K9_STEPS
        mms = (m0 + m1) / 2 / K9_STEPS
        pms = timed(plain, 2) / 2
        bms, by = profile_passes.k9_bound(t, co, K9_STEPS)
        log(f"[4] k9_chain n=2^{logn}: K9 {kms:.6f} ms per squaring "
            f"(runs {k0 / K9_STEPS:.6f}, {k1 / K9_STEPS:.6f}), three-kernel "
            f"step {sms:.6f} ({s0 / K9_STEPS:.6f}, {s1 / K9_STEPS:.6f}), "
            f"move-only body {mms:.6f} ({m0 / K9_STEPS:.6f}, "
            f"{m1 / K9_STEPS:.6f}), plain {pms:.6f}, bound {bms:.6f} "
            f"({by}) ({card})")
        if logn == 19:
            ms["k9_chain"] = (kms, pms)

    def k5_bound(t):
        """K5 in the shift form (profile_passes.axis_bound), the mean of
        P2 and P6, as its time is."""
        b = [profile_passes.axis_bound(t, w) for w in ("p2", "p6")]
        return ((b[0][0] + b[1][0]) / 2,
                max(b, key=lambda v: v[0])[1])

    # K1, K3 and K5 at the fewest products their function needs
    # (profile_passes.axis_bound: the shift butterflies' log2(L) / 2 per
    # digit and the scales) against the register and the tables they read
    # (the scales, not k1_mats, k3_mats or g2; K3 also K3b's widths and
    # carries): by bytes
    bounds = {}
    for (t, co), pre in ((main_in[:3:2], ""), (big_in[:3:2], "[T>1]")):
        L1, L2, ca, n, _ = shape_of(t)
        bounds["k1_p1c" + pre] = profile_passes.axis_bound(t, "k1", co)
        bounds["k3_p7c" + pre] = bound((1 + math.log2(L1) / 2) * n,
                                       16 * n + nbytes(co, t.widths, t.k3_rs,
                                                       t.er, t.ec))
        if pre == "":
            bounds["k2_fused_c"] = profile_passes.span_bound(t)
        else:
            bounds["k5_axis1"] = k5_bound(t)
            bounds["k6_fused_c"] = profile_passes.row_bound(t, "fwd")
            bounds["k6b_fused_c_invh"] = profile_passes.row_bound(t, "inv")
    bounds["k5_axis1[L2=128]"] = k5_bound(huge_in[0])
    t, x, co = chain_in[19]
    bounds["k9_chain"] = profile_passes.k9_bound(t, co, K9_STEPS)

    def block_bounds(t, bco):
        """K4: the mean of forward with carries and inverse as shift
        butterflies (profile_passes.axis_bound "k4f" and "k3": the scales,
        the carries and spread tables, not k1_mats or k3_mats); K7 with a =
        1: y and widths in, digits and carries out, no products."""
        n = shape_of(t)[3]
        b = [profile_passes.axis_bound(t, "k4f", bco),
             profile_passes.axis_bound(t, "k3")]
        return (((b[0][0] + b[1][0]) / 2, max(b, key=lambda v: v[0])[1]),
                bound(0, 20 * n + 8 * t.block_carry_shape[0]))

    # K2, K6 and K6b at the fewest products their function needs
    # (tools/profile_passes.span_bound, row_bound): the r2 passes as shift
    # butterflies or the radix-5 split (fourstep.r2_split_products), the
    # C-transform factored (fourstep.c_fft_products per half), the weights
    # and the square, against the bytes of the register and the tables
    # the kernels read: ~24 products per digit at most, so the bytes bound
    # them. K5 with L2 = 320 at 5 * 2^23, the mean of P2 (x mf) and P6 (x
    # mi, x t_r_inv), the register and mf or mi once
    bounds["k2_fused_c[r5]"] = profile_passes.span_bound(r5_in[0])
    t = r5_big_in[0]
    L1, L2, ca, n, _ = shape_of(t)
    bounds["k5_axis1[r5]"] = bound(
        (tfs.r2_split_products(L2) + 1.5) * n, 16 * n + (
            nbytes(t.mf, t.dft5_f, t.tw_f, t.sh_exp) +
            nbytes(t.mi, t.dft5_i, t.tw_i, t.sh_exp, t.t_r_inv)) / 2)
    bounds["k4_axis0"], bounds["k7_block_carry"] = block_bounds(
        main_in[0], main_in[6])
    for entry, b in zip(("k4_axis0", "k7_block_carry"),
                        block_bounds(big_in[0], big_in[6])):
        log(f"[4] {entry} bound at n=2^25 {b[0]:.6f} ms ({b[1]})")
    for entry, (b, by) in bounds.items():
        log(f"[4] {entry} bound {b:.6f} ms ({by}); kernel "
            f"{ms[entry][0]:.6f} ms")
    del main_in, big_in, huge_in, chain_in, r5_in, r5_big_in, t, x, co, sp
    del spec, z
    torch.cuda.empty_cache()

    mark(5)
    # ---- 5: M756839 through the CLI: whole on K9 with its proof, resumed on
    # the block carry
    def cli_start(tag, launcher=(), env=None, args=(), resume=None,
                  proof=False):
        """The CLI's PRP of M756839 in a subprocess with its own save dir,
        from the start or (with resume) from that checkpoint; returns the
        running job. Its output is read as it comes, and `squared` is set
        at its first proof line (the squarings are over) or at its end."""
        d = os.path.join(root, "build", "smoke_run", tag)
        shutil.rmtree(d, ignore_errors=True)
        os.makedirs(d)
        if resume is not None:
            shutil.copy(resume, d)
        job = {"dir": d, "t1": time.perf_counter(), "out": [], "err": [],
               "squared": threading.Event(), "resume": resume,
               "proof": proof}
        job["proc"] = subprocess.Popen(
            [sys.executable, "-m", *launcher, "prmers_tpu_torch",
             str(P_GOLDEN), "-proofverify" if proof else "-noproof",
             "-save-dir", d, *args], cwd=root, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True,
            env=dict(os.environ, PYTHONUNBUFFERED="1", **(env or {})))
        # a failing phase must not leave the run behind
        atexit.register(lambda: job["proc"].poll() is None and
                        job["proc"].kill())

        def pump(stream, lines, watch):
            for ln in stream:
                lines.append(ln)
                if watch and "proof [" in ln:
                    job["squared"].set()
            if watch:
                job["squared"].set()

        job["pumps"] = [threading.Thread(target=pump, args=a, daemon=True)
                        for a in ((job["proc"].stdout, job["out"], True),
                                  (job["proc"].stderr, job["err"], False))]
        for t in job["pumps"]:
            t.start()
        return job

    def cli_finish(phase, label, job):
        """Wait for a cli_start job; it must report prime (resumed: from
        the checkpoint). With its proof, the proof must verify and the
        result JSON carry its power (best_power(p)) and the file's md5."""
        from prmers_tpu_torch.core.proof import best_power
        rc = job["proc"].wait(timeout=400)
        for t in job["pumps"]:
            t.join(timeout=60)
        dt = time.perf_counter() - job["t1"]
        out, err = "".join(job["out"]), "".join(job["err"])
        tail = out.strip().splitlines()[-1] if out.strip() else ""
        how = "resumed" if job["resume"] else "whole"
        log(f"[{phase}] M{P_GOLDEN} PRP ({how}) through the {label} "
            f"rc={rc} in {dt:.3f} s: {tail}")
        if rc != 0 or '"status":"P"' not in tail.replace(" ", "") \
                or (job["resume"] and "Resuming from a checkpoint." not in
                    out):
            raise AssertionError(f"M{P_GOLDEN} was not reported prime ({how}):"
                                 f"\n{out[-2000:]}\n{err[-2000:]}")
        if job["proof"]:
            power = best_power(P_GOLDEN)
            path = os.path.join(job["dir"], f"m{P_GOLDEN}-{power}.proof")
            with open(path, "rb") as f:
                md5 = hashlib.md5(f.read()).hexdigest()
            got = json.loads(tail).get("proof", {})
            ok = (got.get("power") == power and got.get("md5") == md5
                  and "Verification result: SUCCESS" in out)
            log(f"[{phase}] M{P_GOLDEN} proof: power {got.get('power')} "
                f"(best_power {power}), md5 {got.get('md5')} (file {md5}), "
                f"verified {'Verification result: SUCCESS' in out}")
            if not ok:
                raise AssertionError(f"M{P_GOLDEN}'s proof is wrong:\n"
                                     f"{out[-2000:]}")

    def cli_prime(phase, label, tag, **kw):
        cli_finish(phase, label, cli_start(tag, **kw))

    # K9 in one process at a time: the checkpoint first, then the whole run
    # with its proof, whose proof build and check (host big-int, minutes)
    # go on beside phases 6-8 once its squarings are over
    golden = golden_checkpoint(root, dev, GOLDEN_TAIL)
    proof_job = cli_start("k9-proof", proof=True)
    cli_prime(5, "block carry", "block", env={"PRMERS_NO_ROWCARRY": "1"},
              resume=golden)
    t1 = time.perf_counter()
    proof_job["squared"].wait(timeout=400)
    log(f"[5] waited {time.perf_counter() - t1:.3f} s for the squarings of "
        f"the run with its proof")

    mark(6)
    # ---- 6: the mesh ------------------------------------------------------
    t6 = time.perf_counter()
    # (a) the shard-local kernel forms on this card, s = 2 and 4, at n =
    # 2^23 and at the radix-5 5 * 2^22 (K5 in the split form on the r1
    # view's whole split tables)
    rng = np.random.default_rng(6)

    def residues(shape):
        return gl.from_numpy_u64(rng.integers(0, gl.P, size=shape,
                                              dtype=np.uint64), dev)

    def mesh_tables(p, n):
        """The host tables of the mesh's plan at p (the single-card
        engine's, built once per carry unit: phase 2's) and a value's
        digits."""
        plan = build_plan(p, n=n)
        fp = four_step_plan(plan, tfs.Pipeline(r2fold_max=0))
        v = int.from_bytes(rng.bytes(p // 8 + 1), "little") % ((1 << p) - 1)
        return host_tables(fp), dg.int_to_digits(v, plan.widths).reshape(
            fp.shape)

    def views(kt, s, rank):
        return tuple(tk.DevTables.from_host(kt, dev, view, rank, s)
                     for view in (tk.R2_VIEW, tk.R1_VIEW))

    def check_views(kt, xm, s, rank, at, k5):
        """Each kernel on rank's views of s against its plain version on
        the same inputs, exact (phase 2's record)."""
        t2, t1 = views(kt, s, rank)
        label = f"mesh {at} s={s} rank={rank}"
        m = kt.widths.shape[1] // s
        x2 = gl.from_numpy_u64(np.ascontiguousarray(
            xm[:, rank * m:(rank + 1) * m]), dev)
        co = torch.from_numpy(rng.integers(
            0, 1 << 40, size=t2.row_carry_shape, dtype=np.int64)).to(dev)
        sp = tk.p1_carry_plain(t2, x2, co)
        record("k1_p1c", label, tk.p1_carry_pass(t2, x2, co), sp, phase=6)
        record("k4_axis0", f"{label} fwd", tk.axis0_pass(t2, x2, False),
               tk.axis0_plain(t2, x2, False), phase=6)
        record("k4_axis0", f"{label} inverse", tk.axis0_pass(t2, sp, True),
               tk.axis0_plain(t2, sp, True), canon=False, phase=6)
        amt = 2 if rank == 0 else 0
        for a, sub2 in ((1, False), (3, False), (1, True)):
            d, c = tk.p7_carry_pass(t2, sp, a=a, sub2=sub2, s2=amt)
            dw, cw = tk.p7_carry_plain(t2, sp, a, sub2, amt)
            what = f"{label} a={a} sub2={sub2}"
            record("k3_p7c", what + " digits", d, dw, canon=False, phase=6)
            record("k3_p7c", what + " carries", c, cw, canon=False, phase=6)
        y = residues(t1.shape)
        for which in ("p2", "p6"):
            record(k5, f"{label} {which}", tk.axis1_pass(t1, y, which),
                   tk.axis1_plain(t1, y, which), phase=6)
        for mode in ("sqr", "fwd", "mul"):
            um = y if mode == "mul" else None
            record("k6_fused_c", f"{label} {mode}",
                   tk.fused_c_pass(t1, y, mode, u=um, r2fold=False),
                   tk.fused_c_plain(t1, y, mode, um, r2fold=False), phase=6)
        for op in ("sqr", ""):
            record("k6b_fused_c_invh", f"{label} op={op!r}",
                   tk.fused_c_invh_pass(t1, y, op),
                   tk.fused_c_invh_plain(t1, y, op), phase=6)
        z = gl.canon64(y)
        for a in (1, 3):
            d, c = tk.block_carry_local(t1, z, a)
            dw, cw = tk.block_carry_plain(t1, z, a, t1.k8_rounds)
            record("k8_local", f"{label} a={a} digits", d, dw, canon=False,
                   phase=6)
            record("k8_local", f"{label} a={a} carries", c, cw, canon=False,
                   phase=6)

    kt, xm = mesh_tables(P_MAIN, 1 << 23)
    kt5, xm5 = mesh_tables(P_R5, 5 << 22)
    for s in (2, 4):
        for rank in (0, s - 1):
            check_views(kt, xm, s, rank, "n=2^23", "k5_axis1")
            check_views(kt5, xm5, s, rank, "n=5*2^22", "k5_axis1[r5]")
    torch.cuda.empty_cache()
    log(f"[6] (a) views in {time.perf_counter() - t6:.3f} s")
    # K8 at the shard shapes of s = 1, 2, 4 (rank 0's r1 blocks) at 2^23
    # and 5 * 2^22, and K5's split at the radix-5 ones (the mean of P2 and
    # P6): each held against its plain version on the timed input, then
    # timed beside its bound (K8 20 bytes per digit, as K7; K5 as phase 4
    # prices it at 5 * 2^23)
    for at, table in (("n=2^23", kt), ("n=5*2^22", kt5)):
        for s in (1, 2, 4):
            t1 = views(table, s, 0)[1]
            z = gl.canon64(residues(t1.shape))
            for a in (1, 3):
                d, c = tk.block_carry_local(t1, z, a)
                dw, cw = tk.block_carry_plain(t1, z, a, t1.k8_rounds)
                what = f"timed {at} s={s} {t1.shape} a={a}"
                record("k8_local", what + " digits", d, dw, canon=False,
                       phase=6)
                record("k8_local", what + " carries", c, cw, canon=False,
                       phase=6)
            got = compare("k8_local", at, f"s={s} {t1.shape} a=1",
                          lambda: tk.block_carry_local(t1, z),
                          lambda: tk.block_carry_plain(t1, z, 1,
                                                       t1.k8_rounds),
                          20, phase=6)
            b = bound(0, 20 * z.numel() + 8 * t1.block_carry_shape[0])
            log(f"[6] k8_local bound at {at} s={s} {b[0]:.6f} ms ({b[1]}); "
                f"kernel {got[0]:.6f} ms ({card})")
            if s == 1 and at == "n=2^23":
                ms["k8_local"], bounds["k8_local"] = got, b
            if at == "n=2^23":
                continue
            y = z
            k5 = [compare("k5_axis1[r5]", at, f"s={s} {t1.shape} {w}",
                          lambda w=w: tk.axis1_pass(t1, y, w),
                          lambda w=w: tk.axis1_plain(t1, y, w), 10,
                          phase=6) for w in ("p2", "p6")]
            for w in ("p2", "p6"):
                record("k5_axis1[r5]", f"timed {at} s={s} {w}",
                       tk.axis1_pass(t1, y, w), tk.axis1_plain(t1, y, w),
                       phase=6)
            n1 = y.numel()
            L2 = t1.shape[1]
            b = bound((tfs.r2_split_products(L2) + 1.5) * n1, 16 * n1 + (
                nbytes(t1.mf, t1.dft5_f, t1.tw_f, t1.sh_exp) +
                nbytes(t1.mi, t1.dft5_i, t1.tw_i, t1.sh_exp,
                       t1.t_r_inv)) / 2)
            log(f"[6] k5_axis1[r5] at {at} s={s} {t1.shape}: kernel "
                f"{(k5[0][0] + k5[1][0]) / 2:.6f} ms (P2 {k5[0][0]:.6f}, P6 "
                f"{k5[1][0]:.6f}), plain {(k5[0][1] + k5[1][1]) / 2:.6f} "
                f"ms, bound {b[0]:.6f} ms ({b[1]}) ({card})")
    del kt, kt5, xm, xm5, t1, y, z, d, c, dw, cw
    torch.cuda.empty_cache()
    log(f"[6] (a) in {time.perf_counter() - t6:.3f} s")

    # (b) the ranks, at every s the cards allow
    mesh = mesh_drive(root, card, dev,
                      single={**ips4, P_MAIN: row_ips})
    r0 = mesh[1][0]
    counts["mesh"] = {k: r0["block_calls"][k] + r0["engine_calls"][k]
                      for k in r0["block_calls"]}
    for s, ranks in mesh.items():
        log(f"[6] PRP {ranks[0]['ips']:.6f} iter/s @ p={P_MAIN} through the "
            f"mesh at s={s} against {row_ips:.6f} through the single-card "
            f"row carry ({card})")
    # the radix-5 and XLA-form paths at s = 1, in this process (no group:
    # no collective, as on one rank), where phase 2 built the radix-5 host
    # tables and phase 3's GMP values wait
    ext = {"rank": 0, **mesh_rank_r5(extras[0], extras[1], v5,
                                     lambda: [j.result() for j in extras])}
    ext.update(mesh_rank_xla(extras[2], random.Random(P_MAIN).getrandbits(
        P_MAIN - 1)))
    extras_pool.shutdown()
    check_extras([ext], 1, card, {**ips4, P_MAIN: row_ips})
    log(f"[6] (b) in {time.perf_counter() - t6:.3f} s")
    del extras, ext

    # (c) M756839 through the CLI on the mesh, one rank, resumed
    cli_prime(6, "mesh (-backend sharded, torchrun, 1 rank)", "mesh",
              launcher=("torch.distributed.run", "--standalone",
                        "--nproc_per_node=1", "-m"),
              env={"NCCL_SOCKET_IFNAME": os.environ.get(
                  "NCCL_SOCKET_IFNAME", "lo")},
              args=("-backend", "sharded"), resume=golden)
    log(f"[6] (c) in {time.perf_counter() - t6:.3f} s")
    # (d) M9941 under -backend sharded with PRMERS_PROOF_SHARDED=1 runs
    # beside phase 8's goldens; (e) the __graft_entry__ twin's compile
    # check on this card
    from prmers_tpu_torch import graft_entry
    fn, args = graft_entry.entry()
    got = dg.digits_to_int(gl.to_numpy_u64(fn(*args)[0]),
                           cached_plan(graft_entry.P_ENTRY).widths)
    log(f"[6] graft_entry.entry(): one any-size squaring of 3 at "
        f"p={graft_entry.P_ENTRY} on {args[0].device} gives {got}")
    if got != 9:
        raise AssertionError(f"graft_entry.entry() gave {got}, not 9")

    mark(7)
    # ---- 7: the tools: the pass profiler, microbenchmarks, probes ---------
    timed7, counts["tools"], library7 = tools_drive(dev, card)

    def fold(entry, sel, how):
        """A row from phase 7's Timed: mean (or sum) of the selected."""
        es = [e for e in timed7 if sel(e)]
        f = (lambda v: sum(v) / len(v)) if how == "mean" else sum
        ms[entry] = (f([e.ms for e in es]), f([e.plain_ms for e in es]))
        top = max(es, key=lambda e: e.bound_ms)
        bounds[entry] = (f([e.bound_ms for e in es]), top.bound_by)
        errs[entry] = max([errs[entry]] + [e.max_abs_err for e in es])

    for kern in ("k4u_pass", "k5u_pass"):
        for form in ("matrix", "shift"):
            fold(kern + ("[shift]" if form == "shift" else ""),
                 lambda e, kern=kern, form=form: e.kernel == kern
                 and e.what.endswith(form), "mean")
    for kern in pr.KERNELS:
        fold(kern, lambda e, kern=kern: e.kernel == kern, "sum")

    mark(8)
    # ---- 8: the any-size engine and the reference goldens ------------------
    chains9, chains10 = [], []

    def beside():
        chains9.append(modes_chains(root))
        chains10.append(fft3161_chains(root))
    anysize_drive(root, dev, card, beside=beside)
    cli_finish(5, "K9 with its proof (-proofverify)", proof_job)

    # ---- 9: the modes ------------------------------------------------------
    mark(9)
    counts["modes"] = modes_drive(root, dev, card, chains=chains9[0])

    # ---- 10: the second arithmetic (fft3161) --------------------------------
    mark(10)
    errs10, ms10, bounds10, counts["fft3161"] = fft3161_drive(
        root, dev, card, chains=chains10[0], jobs=f3_jobs)
    errs.update(errs10)
    ms.update(ms10)
    bounds.update(bounds10)

    sources = {**tk.SOURCES, **pr.SOURCES}
    replaces = {**tk.REPLACES, **pr.REPLACES}
    kernels = [{"name": entry, "route": "cuda",
                "source": sources.get(entry, sources[name]),
                "replaces": replaces[name],
                "launches": counts[path][name], "max_abs_err": errs[entry],
                "ms": ms[entry][0], "plain_ms": ms[entry][1],
                "bound_ms": bounds[entry][0], "bound_by": bounds[entry][1],
                # the shape cases' one-call twins' medians, summed as their
                # kernels' are (torch._int_mm for the dots, n's product
                # alone);
                # no PyTorch call computes a Goldilocks product, this
                # carry or a GF(q^2) stage
                "library_ms": (sum(v.median for v in library7.values())
                               if entry == "probe_shapes" else None)}
               for entry, name, path in ENTRIES]
    log(f"[smoke] total {time.perf_counter() - t_start:.3f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-rank"]:
        sys.exit(mesh_rank(sys.argv[2]))
    sys.exit(main(sys.argv[1:]))
