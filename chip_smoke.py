#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (prmers_tpu_torch) on one card.

Run from the repository root with no arguments: python3 chip_smoke.py
(one card; `python3 chip_smoke.py --mesh-only` runs phases 1 and 6 alone,
at every world size the machine's cards allow; `--tools-only` phases 1
and 7; `--anysize-only` phases 1 and 8; `python3 chip_smoke.py
--mm31` runs phase 1 and the engine at MM31, p = 2^31 - 1, n = 5 * 2^25:
two squarings of a dense value against GMP, with the host table build's
time and peak memory).

It drives seven paths of the port: the n = 2^23 path (K1, K2, K3 with
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
and K5u, the microbenchmarks and the probes), and the any-size engine
(engine/torch_engine.py: ops/ntt.py's transform in torch ops, no kernel of
its own, for every plan the four-step kernels do not take).
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
     library_ms is null;
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
  6. the mesh at p = 136279841: (a) on this card, the shard-local kernel
     forms of rank 0 and the last rank of s = 2 and 4 (K1, K3 with a = 1,
     3 and sub2 with the rank's amount, K4 both ways on the r2-sharded
     view; K5, K6, K6b and K8 on the r1-sharded view), each against its
     plain version (exact as in phase 2), and K8 at the shard shapes of
     s = 1, 2, 4 (with a = 1 and 3 against its plain version on the input
     it is then timed on) with its time beside its bound (20 bytes per
     digit, as K7);
     (b) for every s in {1, 2, 4} that torch.cuda.device_count() allows,
     s rank processes of this script (NCCL, one card each): ShardedStep
     on the block carry (three steps, K8) and MeshEngine (the phase-3
     ops, plus a sparse sub through the ring's lookahead), each against
     GMP on every rank, with each rank's wrapper counts (reset just
     before, read just after: every kernel of the path > 0, K2, K7 and
     K9 at 0), PRP iter/s through MeshEngine (192 squarings) and through
     the block carry (32), and each collective's ms per squaring (CUDA
     events on the stream, the wait for the other ranks included);
     (c) `python -m torch.distributed.run --nproc_per_node=1 -m
     prmers_tpu_torch 756839 -noproof -backend sharded` resumes from the
     same checkpoint and must report prime. A failure in any rank fails
     the run;
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
     tools/probe_bitcast: the byte order). The wrapper counts are reset
     just before and read just after, and every kernel of the phase must
     be > 0; then each timed launch's output is held against its plain
     version on the same inputs (exact mod P for K4u/K5u and the field
     ops after canon, bit for bit for the rest), and each time stands
     beside its bound and the card;
  8. the any-size engine (engine/torch_engine.TorchEngine, what
     create_engine gives where the four-step engine does not take the
     plan, and for every p under PRMERS_NO_PALLAS): the table build time
     (numpy on the host, then to the card) and PRP iter/s with each
     squaring a CUDA graph and eager, in turns, with the CUDA launches of
     one eager squaring, at n = 512 (p = 9941), 4096 (100003) and 81920
     (1600003); at p = 1600003 (n = 5 * 2^14, the widest plan only this
     engine takes, through create_engine) 64 squarings with a = [3, 1], a
     multiplicand, mul, sub, add_small and addsub against GMP; the
     reference goldens through the CLI in subprocesses, M100003 in one
     chain and the rest in another, side by side on the card while this
     process builds the 2^23 tables: M127 -ll and -llsafe prime, M2699
     with its 5 known factors PRP and with 4 composite, M9941's proof
     hashes (tests/test_proof.py) and the proof verified, M11213's res64
     every 1000 iterations and its final res64 1
     (tests/test_prp_ll.py:127-149), M100003's res64 and res2048
     (:106-124); then at p = 136279841 under PRMERS_NO_PALLAS (n = 2^23)
     8 squarings of a dense value against GMP and FourStepEngine, with
     the table build time and iter/s.

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
GOLDEN_TAIL = 20000     # squarings the resumed CLI runs of M756839 take
DRIVE_K = 8             # the sparse chain's squarings in a phase-3 drive
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15
OPS_PER_PRODUCT = 128   # 64 int8 MACs per mod-P product (limb planes)

# (name in the JSON line, wrapper counter, the path whose counts it
# reports); the main path's kernels are timed at n = 2^23, the big path's
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
]
MESH_KERNELS = ("k1_p1c", "k3_p7c", "k4_axis0", "k5_axis1", "k6_fused_c",
                "k8_local")
MESH_OFF = ("k2_fused_c", "k7_block_carry", "k9_chain")


def log(*args):
    print(*args, flush=True)


def drive_values(p: int):
    """The values a phase-3 drive at p sets, from random.Random(p), and
    what GMP says its ops must give: (v, w, s, (the sparse chain
    (3 * 2^s)^(2^DRIVE_K) ^2 * 3, v^2 * 3 * w, w^2 - 2)). The GMP products
    release the GIL, so the smoke computes these on threads while the card
    works."""
    from prmers_tpu_torch.utils import gmp
    mp = (1 << p) - 1
    rnd = random.Random(p)
    v, w = rnd.getrandbits(p - 1), rnd.getrandbits(p - 1)
    s = rnd.randrange(p // 2, p)
    c, e = 3, s                             # value c * 2^e mod M_p
    for _ in range(DRIVE_K + 1):
        c, e = c * c, 2 * e % p
    vv = gmp.mersenne_mod(gmp.mul(v, v) * 3, p)
    return v, w, s, (gmp.mersenne_mod(c * 3 << e, p),
                     gmp.mersenne_mod(gmp.mul(vv, w), p),
                     (gmp.mersenne_mod(gmp.mul(w, w), p) - 2) % mp)


def mesh_rank(out_dir: str) -> int:
    """One rank of phase 6b (run as `chip_smoke.py --mesh-rank OUT_DIR`
    with RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT set):
    the block-carry ShardedStep and MeshEngine at p = 136279841 against
    GMP, the wrapper counts, PRP iter/s and the collectives' ms; writes
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
    pool = ThreadPoolExecutor(max_workers=2)
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
    pool.shutdown()
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
    eng.square_mul_seq(0, [1] * DRIVE_K)    # (3 * 2^sh)^(2^K)
    eng.square_mul(0, 3)                    # ^2 * 3
    eng.square_mul(1, 3)                    # v^2 * 3
    eng.set_multiplicand(3, 2)
    eng.mul(1, 3)                           # v^2 * 3 * w
    eng.square_sub2_seq(4, 1)               # w^2 - 2
    eng.sub(5, 2)                           # a sparse sub: the lookahead
    eng.sub(5, 100)                         # through zero
    eng.sync()
    res["engine_s"] = time.perf_counter() - t0
    res["engine_calls"] = dict(tk.calls)
    res["collectives"] = {k: n - c0[k] for k, n in dist.counts.items()}
    res["engine_ok"] = [eng.get_int(r) == want[i]
                        for i, r in enumerate((0, 1, 4))]
    res["engine_ok"].append(eng.get_int(5) == (79 - 100) % mp)

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
    with open(os.path.join(out_dir, f"{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.shutdown()
    return 0


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def mesh_drive(root: str, card: str) -> dict:
    """Phase 6b: the ranks at every s in {1, 2, 4} the cards allow, each
    checked; returns {s: [each rank's result]}."""
    import torch
    out = {}
    for s in (1, 2, 4):
        if s > torch.cuda.device_count():
            break
        run_dir = os.path.join(root, "build", "smoke_mesh", str(s))
        shutil.rmtree(run_dir, ignore_errors=True)
        os.makedirs(run_dir)
        env = dict(os.environ, WORLD_SIZE=str(s), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(_free_port()))
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
        out[s] = ranks
    return out


def tools_drive(dev, card):
    """Phase 7: the tools' kernels at full width (the pass profiler at p =
    136279841, the microbenchmarks, the probes), the wrapper counts of
    their run (reset just before, read just after; each > 0), then every
    timed launch held against its plain version; returns (the checked
    Timed, the counts)."""
    import torch
    from prmers_tpu_torch import tools
    from prmers_tpu_torch.ops import kernels as tk
    from prmers_tpu_torch.ops import probes as pr
    from prmers_tpu_torch.tools import (microbench, microbench_fields,
                                        probe_bitcast, probe_shapes,
                                        profile_passes)
    t1 = time.perf_counter()
    tk.reset_calls()
    pr.reset_calls()
    _t, passes = profile_passes.measure(P_MAIN, reps=10)
    _t, axis, moves = profile_passes.measure_axis(reps=10)
    mm = microbench.matmul_rates(dev)
    mb, rates = microbench.measure()
    mf, per_el = microbench_fields.measure()
    ps, int_mm = probe_shapes.measure()
    pb, order, col = probe_bitcast.measure()
    torch.cuda.synchronize()
    calls = {**tk.calls, **pr.calls}
    log(f"[7] tools' run in {time.perf_counter() - t1:.3f} s; wrapper calls "
        f"{calls}")
    missing = [k for k in ("k4u_pass", "k5u_pass", "k4_axis0", "k2_fused_c",
                           "k1_p1c", "k5_axis1") + pr.KERNELS
               if calls[k] <= 0]
    if missing:
        raise AssertionError(f"not launched in phase 7: {missing}")
    timed7 = tools.check(passes + axis + mb + mf + ps + [pb])
    for r in moves:
        log(f"[7]   move-only body {r['what']}: {r['ms']:.6f} ms, bound "
            f"{r['bound_ms']:.6f} ms ({r['bound_by']}) ({card})")
    for e in timed7:
        log(f"[7]   {e.kernel} {e.what}: kernel {e.ms:.6f} ms, plain "
            f"{e.plain_ms:.6f} ms, bound {e.bound_ms:.6f} ms "
            f"({e.bound_by}), max_abs_err {e.max_abs_err} ({card})")
    for r in mm:
        log(f"[7] library {r['kind']} product {r['shape']} serial: "
            f"{r['ms']:.6f} ms, {r['rate_T']:.3f} T/s ({card})")
    for name, r in list(rates.items()) + list(per_el.items()):
        log(f"[7] {name} rate from the slope: {r['ns_per_el']:.6f} ns per "
            f"rep and element, {r['rate_G_per_s']} G/s ({card})")
    log(f"[7] fft3161 word vs two gl64 words: "
        f"{microbench_fields.ratios(per_el)} ({card})")
    log(f"[7] torch._int_mm on cases b, e: {int_mm} ms; bitcast order "
        f"{order} {col} ({card})")
    log(f"[7] phase 7 in {time.perf_counter() - t1:.3f} s")
    return timed7, calls


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


def cli_run(root: str, tag: str, args, timeout=900):
    """`python -m prmers_tpu_torch <args>` in a subprocess with its own
    save dir; returns (rc, stdout, seconds). The result JSON is the last
    line."""
    d = os.path.join(root, "build", "smoke_any", tag)
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    t1 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "prmers_tpu_torch", *args,
                        "-save-dir", d], cwd=root, capture_output=True,
                       text=True, timeout=timeout)
    dt = time.perf_counter() - t1
    tail = r.stdout.strip().splitlines()[-1] if r.stdout.strip() else ""
    log(f"[8] CLI {' '.join(args)}: rc={r.returncode} in {dt:.3f} s: {tail}")
    if not tail.startswith("{"):
        raise AssertionError(f"CLI {args} printed no result:\n"
                             f"{r.stdout[-2000:]}\n{r.stderr[-2000:]}")
    return r.returncode, r.stdout, dt, json.loads(tail)


def anysize_drive(root: str, dev, card: str) -> None:
    """Phase 8: the any-size engine on the card. Table builds and iter/s
    (CUDA graphs against eager, in turns) with the launches of one eager
    squaring; the widest plan only it takes against GMP; the reference
    goldens through the CLI (two chains of subprocesses, beside the host
    build of the 2^23 tables); then the main exponent under
    PRMERS_NO_PALLAS against GMP and FourStepEngine. Any mismatch
    raises."""
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

    def launches(p):
        """CUDA kernels of one eager squaring (torch.profiler; "not
        measured" where the profiler sees no device)."""
        from torch.profiler import ProfilerActivity, profile
        eng = te.TorchEngine(p, 2, device=dev, graphs=False)
        eng.set(0, 3)
        eng.square_mul(0)
        torch.cuda.synchronize()
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                eng.square_mul(0)
                torch.cuda.synchronize()
            k = sum(1 for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
        except (RuntimeError, AttributeError) as e:
            log(f"[8] torch.profiler: {e}")
            k = 0
        return k if k else "not measured"

    for p, iters in ANY_RATES:
        tables(cached_plan(p))
        got = {True: [], False: []}
        for graphs in (True, False, False, True):
            got[graphs].append(rate(p, graphs, iters))
        log(f"[8] any-size PRP @ p={p} (n={cached_plan(p).n}): CUDA graph "
            f"{sum(got[True]) / 2:.3f} iter/s (runs {got[True][0]:.3f}, "
            f"{got[True][1]:.3f}), eager {sum(got[False]) / 2:.3f} iter/s "
            f"(runs {got[False][0]:.3f}, {got[False][1]:.3f}); "
            f"{launches(p)} CUDA launches per eager squaring ({card})")

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
    goldens = ThreadPoolExecutor(max_workers=2)
    long_chain = goldens.submit(lambda: [
        cli_run(root, "100003", ["100003", "-noproof"])])
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
    (r100003,), short = long_chain.result(), short_chain.result()
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
    rc, out, _d, j = short[4]
    lines = [ln.strip() for ln in out.splitlines()
             if ln.strip().startswith("proof [")]
    expect("M9941 prime", rc == 0 and j["status"] == "P")
    expect("M9941 proof hashes equal GOLDEN_9941", lines == GOLDEN_9941)
    expect("M9941 proof verifies", "Verification result: SUCCESS" in out)
    rc, out, _d, j = short[5]
    seen = {}
    for ln in out.splitlines():
        if "Res64:" in ln and "Iter:" in ln:
            it = int(ln.split("Iter:")[1].split("|")[0].strip())
            seen[it] = ln.split("Res64:")[1].strip()
    expect("M11213 res64 stream equals the golden's",
           all(seen.get(k) == v for k, v in GOLDEN_11213.items()))
    expect("M11213 final res64 0000000000000001",
           rc == 0 and j["res64"] == "0000000000000001")
    rc, _o, dt, j = r100003
    expect("M100003 res64 1CF45E9503C71FD6",
           j["status"] == "C" and j["res64"] == "1CF45E9503C71FD6")
    expect("M100003 res2048 equals the golden's",
           j["res2048"].lower() == RES2048_100003)
    log(f"[8] M100003 PRP in {dt:.3f} s through the CLI, beside the other "
        f"goldens ({card})")

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
    from prmers_tpu_torch.engine.fourstep_engine import (get_tables,
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
    log(f"[1] card: {card}")
    log(f"[1] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
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
        timed7, calls = tools_drive(dev, card)
        print(json.dumps({"tools": [e.row() for e in timed7],
                          "calls": calls}))
        print(card)
        return 0
    if "--anysize-only" in argv:
        anysize_drive(root, dev, card)
        print(card)
        return 0
    if "--mesh-only" in argv:
        mesh = mesh_drive(root, card)
        print(json.dumps({"mesh": {s: {
            "ips": [r["ips"] for r in ranks],
            "block_ips": [r["block_ips"] for r in ranks],
            "collective_ms": ranks[0]["collective_ms"]}
            for s, ranks in mesh.items()}}))
        print(card)
        return 0

    # the GMP side of phase 3, on threads from here on
    log(f"[1] HAVE_GMP {gmp.HAVE_GMP}")
    if not gmp.HAVE_GMP:
        raise RuntimeError("libgmp is needed for the big-int checks")
    pool = ThreadPoolExecutor(max_workers=4)
    expected = {p: pool.submit(drive_values, p) for p in (
        P_R5_BIG, P_BIG, P_R5, P_MAIN, P_CHAIN, P_R5_SMALL, P_GOLDEN)}

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
        ok = [eng.get_int(r) == want[i] for i, r in enumerate((0, 1, 4))]
        log(f"[3] {path} path big-int check in "
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

    # ---- 4: timings -------------------------------------------------------
    for p, warm, iters in ((P_MAIN, 16, 192), (P_BIG, 4, 48),
                           (P_HUGE, 4, 24), (P_R5, 4, 48), (P_R5_BIG, 4, 24)):
        tk.reset_calls()
        ips = bench.measure(p, warm=warm, iters=iters)
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

    def timed(fn, reps):
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

    ms = {}

    def device_timed(fn, reps):
        """ms per call of fn on the device: CUDA events around each call,
        each pair queued behind a device sleep (~1 ms) so that the host
        has enqueued the call before the device reaches the first event;
        back-to-back calls would time the host's enqueue wherever it is
        slower than the kernel."""
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

    def golden_checkpoint() -> str:
        """The PRP/LL driver in this process, on the engine the CLI takes
        (K9), stopped through its Ctrl-C path before the chunk that would
        pass GOLDEN_TAIL squarings from the end; returns the checkpoint it
        writes there."""
        from prmers_tpu_torch.core import checkpoints as ck
        from prmers_tpu_torch.io.cli import parse_args
        from prmers_tpu_torch.modes.prp_ll import R0, run_prp_or_ll
        ck_dir = os.path.join(root, "build", "smoke_ckpt")
        shutil.rmtree(ck_dir, ignore_errors=True)
        opts = parse_args([str(P_GOLDEN), "-noproof", "-save-dir", ck_dir])
        eng = create_engine(P_GOLDEN, 8, device=dev)
        seq, done = eng.square_mul_seq, [0]

        def stop_near_end(src, a_vec):
            if src == R0:
                if done[0] + len(a_vec) > P_GOLDEN - GOLDEN_TAIL:
                    raise KeyboardInterrupt
                done[0] += len(a_vec)
            seq(src, a_vec)

        eng.square_mul_seq = stop_near_end
        t1 = time.perf_counter()
        r = run_prp_or_ll(opts, eng=eng, log=lambda *a, **k: None)
        path = ck.ckpt_filename(P_GOLDEN, "prp", False, ck_dir)
        log(f"[5] M{P_GOLDEN} PRP in this process stopped at iteration "
            f"{r.iteration} of {P_GOLDEN} in {time.perf_counter() - t1:.3f} "
            f"s; checkpoint {path}")
        if not r.interrupted or r.iteration < P_GOLDEN - 2 * GOLDEN_TAIL \
                or not os.path.exists(path):
            raise AssertionError("no checkpoint near the end of M756839")
        return path

    # K9 in one process at a time: the checkpoint first, then the whole run
    # with its proof, whose proof build and check (host big-int, minutes)
    # go on beside phases 6-8 once its squarings are over
    golden = golden_checkpoint()
    proof_job = cli_start("k9-proof", proof=True)
    cli_prime(5, "block carry", "block", env={"PRMERS_NO_ROWCARRY": "1"},
              resume=golden)
    t1 = time.perf_counter()
    proof_job["squared"].wait(timeout=400)
    log(f"[5] waited {time.perf_counter() - t1:.3f} s for the squarings of "
        f"the run with its proof")

    # ---- 6: the mesh ------------------------------------------------------
    # (a) the shard-local kernel forms on this card, s = 2 and 4
    fpm = tfs.FourStepPlan.from_plan(cached_plan(P_MAIN))
    kt = host_tables(fpm)
    R1, R2, C = fpm.shape
    rng = np.random.default_rng(6)
    v = int.from_bytes(rng.bytes(P_MAIN // 8 + 1), "little") % \
        ((1 << P_MAIN) - 1)
    xm = dg.int_to_digits(v, cached_plan(P_MAIN).widths).reshape(R1, R2, C)

    def residues(shape):
        return gl.from_numpy_u64(rng.integers(0, gl.P, size=shape,
                                              dtype=np.uint64), dev)

    def views(s, rank):
        return tuple(tk.DevTables.from_host(kt, dev, view, rank, s)
                     for view in (tk.R2_VIEW, tk.R1_VIEW))

    for s in (2, 4):
        for rank in (0, s - 1):
            t2, t1 = views(s, rank)
            label = f"mesh s={s} rank={rank}"
            m = R2 // s
            x2 = gl.from_numpy_u64(np.ascontiguousarray(
                xm[:, rank * m:(rank + 1) * m]), dev)
            co = torch.from_numpy(rng.integers(
                0, 1 << 40, size=t2.row_carry_shape, dtype=np.int64)).to(dev)
            sp = tk.p1_carry_plain(t2, x2, co)
            record("k1_p1c", label, tk.p1_carry_pass(t2, x2, co), sp,
                   phase=6)
            record("k4_axis0", f"{label} fwd", tk.axis0_pass(t2, x2, False),
                   tk.axis0_plain(t2, x2, False), phase=6)
            record("k4_axis0", f"{label} inverse", tk.axis0_pass(t2, sp, True),
                   tk.axis0_plain(t2, sp, True), canon=False, phase=6)
            amt = 2 if rank == 0 else 0
            for a, sub2 in ((1, False), (3, False), (1, True)):
                d, c = tk.p7_carry_pass(t2, sp, a=a, sub2=sub2, s2=amt)
                dw, cw = tk.p7_carry_plain(t2, sp, a, sub2, amt)
                what = f"{label} a={a} sub2={sub2}"
                record("k3_p7c", what + " digits", d, dw, canon=False,
                       phase=6)
                record("k3_p7c", what + " carries", c, cw, canon=False,
                       phase=6)
            y = residues(t1.shape)
            for which in ("p2", "p6"):
                record("k5_axis1", f"{label} {which}",
                       tk.axis1_pass(t1, y, which),
                       tk.axis1_plain(t1, y, which), phase=6)
            for mode in ("sqr", "fwd", "mul"):
                um = y if mode == "mul" else None
                record("k6_fused_c", f"{label} {mode}",
                       tk.fused_c_pass(t1, y, mode, u=um, r2fold=False),
                       tk.fused_c_plain(t1, y, mode, um, r2fold=False),
                       phase=6)
            for op in ("sqr", ""):
                record("k6b_fused_c_invh", f"{label} op={op!r}",
                       tk.fused_c_invh_pass(t1, y, op),
                       tk.fused_c_invh_plain(t1, y, op), phase=6)
            z = gl.canon64(y)
            for a in (1, 3):
                d, c = tk.block_carry_local(t1, z, a)
                dw, cw = tk.block_carry_plain(t1, z, a, t1.k8_rounds)
                record("k8_local", f"{label} a={a} digits", d, dw,
                       canon=False, phase=6)
                record("k8_local", f"{label} a={a} carries", c, cw,
                       canon=False, phase=6)
    # K8 at the shard shapes of s = 1, 2, 4 (rank 0's r1 blocks): held
    # against its plain version on the timed input, then timed
    for s in (1, 2, 4):
        t1 = views(s, 0)[1]
        z = gl.canon64(residues(t1.shape))
        for a in (1, 3):
            d, c = tk.block_carry_local(t1, z, a)
            dw, cw = tk.block_carry_plain(t1, z, a, t1.k8_rounds)
            what = f"timed s={s} {t1.shape} a={a}"
            record("k8_local", what + " digits", d, dw, canon=False, phase=6)
            record("k8_local", what + " carries", c, cw, canon=False,
                   phase=6)
        got = compare("k8_local", "n=2^23", f"s={s} {t1.shape} a=1",
                      lambda: tk.block_carry_local(t1, z),
                      lambda: tk.block_carry_plain(t1, z, 1, t1.k8_rounds),
                      20, phase=6)
        b = bound(0, 20 * z.numel() + 8 * t1.block_carry_shape[0])
        log(f"[6] k8_local bound at s={s} {b[0]:.6f} ms ({b[1]}); kernel "
            f"{got[0]:.6f} ms ({card})")
        if s == 1:
            ms["k8_local"], bounds["k8_local"] = got, b
    del t1, t2, x2, co, sp, y, z, d, c, dw, cw
    torch.cuda.empty_cache()

    # (b) the ranks, at every s the cards allow
    mesh = mesh_drive(root, card)
    r0 = mesh[1][0]
    counts["mesh"] = {k: r0["block_calls"][k] + r0["engine_calls"][k]
                      for k in r0["block_calls"]}
    for s, ranks in mesh.items():
        log(f"[6] PRP {ranks[0]['ips']:.6f} iter/s @ p={P_MAIN} through the "
            f"mesh at s={s} against {row_ips:.6f} through the single-card "
            f"row carry ({card})")

    # (c) M756839 through the CLI on the mesh, one rank, resumed
    cli_prime(6, "mesh (-backend sharded, torchrun, 1 rank)", "mesh",
              launcher=("torch.distributed.run", "--standalone",
                        "--nproc_per_node=1", "-m"),
              env={"NCCL_SOCKET_IFNAME": os.environ.get(
                  "NCCL_SOCKET_IFNAME", "lo")},
              args=("-backend", "sharded"), resume=golden)

    # ---- 7: the tools: the pass profiler, microbenchmarks, probes ---------
    timed7, counts["tools"] = tools_drive(dev, card)

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

    # ---- 8: the any-size engine and the reference goldens ------------------
    anysize_drive(root, dev, card)
    cli_finish(5, "K9 with its proof (-proofverify)", proof_job)

    sources = {**tk.SOURCES, **pr.SOURCES}
    replaces = {**tk.REPLACES, **pr.REPLACES}
    kernels = [{"name": entry, "route": "cuda",
                "source": sources.get(entry, sources[name]),
                "replaces": replaces[name],
                "launches": counts[path][name], "max_abs_err": errs[entry],
                "ms": ms[entry][0], "plain_ms": ms[entry][1],
                "bound_ms": bounds[entry][0], "bound_by": bounds[entry][1],
                "library_ms": None}
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
