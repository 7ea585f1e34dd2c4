#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (gridgcn_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Phases, in order; any failure raises and the script exits non-zero:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build the CUDA kernels from the checkout's sources (nvcc), print the
     registers and spills of each, and require no spills in the two main
     kernels and the draw kernel (csrc/rng.cu);
  3. kernel phase: each flash-kNN kernel (and knn3_mxu's support pack)
     against its plain version on the main path's four decoder calls (the
     served model's encoder output on an 81920-point scene), the four of
     one scannet_seg crop (128x32 to 8192x2048, CAS encoder), two ragged,
     masked shapes and one on a 2^-6 grid where knn3_mxu must be bit
     exact, with CUDA-event times of kernel, plain version and a library
     yardstick, and the host cost of one small call;
  4. correctness: the served forward on the card against the same forward
     on the CPU (plain versions), at full width on a small scene (f32) and
     on the full 81920-point scene (bf16, the preset's dtype);
  5. serving: scannet_whole_scene at full width with seeded random weights,
     3 requests and one predict_scene(votes=2) on 81920-point scenes, on
     the main path (the default Predictor: a signature's first call eager,
     its second captured, every later call a replay); the kernel launch
     counters are read over the capture that these forwards replay
     (knn3_mxu 4 launches, the draw kernel 8 a forward), and stay still
     over the replays;
  6. the other presets' paths, each served forward on the card against the
     same forward on the CPU (f32 and bf16 gates, and the share of CAGQ
     center voxels the two devices chose alike): modelnet40_cas (16 clouds
     of 1024 points), synthetic_scene_seg (dense decoder, 4 scenes of
     4096) and its method="grid" override; then scannet_seg (CAS,
     knn3_mxu decoder, 2 scenes of 8192): the served forward, and the
     decoder on the CPU's encoder levels after each layer's CAGQ is held
     bit for bit against the CPU on the same input;
  7. classifier serving: modelnet40_full and modelnet40_cas at full width,
     16 clouds of 1024 points per request, in bf16 (eval_dtype);
  8. CAS segmentation serving: scannet_seg at full width, 8 scenes of 8192
     points per request, CAS with 3 rounds, replayed; its capture launches
     knn3_mxu 4 times per scene (once per decoder stage and cloud), the
     draw kernel 23 times; then the CUDA-graph replay (the default
     Predictor on one card) against the eager forward (graphs=False, the
     bit-for-bit reference) for scannet_whole_scene (4 x 81920),
     scannet_seg (8 x 8192) and modelnet40_cas (16 x 1024): logits bit for
     bit under two keys, one capture, the replays counted, the capture's
     host counters an eager forward's and still over the replays, and a
     trace of one replay holding the kernels the capture launched;
  9. training draws: jaxrng.normal (10^6 draws) and xla_math.erf_inv the
     same bits on the card as on the CPU; the draw kernel's device and
     host µs a launch by epilogue beside its plain version's;
 10. training correctness: one synthetic_scene_seg train step (f32,
     method="pallas", 4 scenes of 4096) on the card against the same step
     on the CPU: loss, gradients, updated parameters and BatchNorm
     statistics, and the share of CAGQ center voxels chosen alike;
 11. training: scannet_seg as the trainer runs it (CAS x3, bf16 with f32
     BatchNorm, augmentation, dropout 0.5, Adam with the cosine schedule)
     on a Dataset of 32 labelled 8192-point crops, batch 8: 3 warm-up
     steps, then 30 timed steps (knn3_mxu exactly 32 launches each), the
     loss falling, every BatchNorm statistic moved; then one eval pass
     over 2 held-out batches;
 12. the trainer and evaluator CLIs: scannet_seg trained through
     train.train() for 2 epochs of 8 steps on the hermetic fallback split
     (64 train and 32 test crops of 8192 points), eval every epoch; the
     JSONL records in order, knn3_mxu exactly 32 launches per step and 4
     per cloud of each eval batch, each eval counting every scored point;
     the step-16 checkpoint restored bit for bit; a run resumed from step
     8 within Adam's bound of the uninterrupted one; evaluate --latency,
     the whole-scene eval (2 votes), the evaluator CLI and `train --mesh
     1` (one NCCL rank) in subprocesses, and load_predictor bit for bit
     against a Predictor on the live weights;
 13. the full-size JAX reference (gridgcn_torch/testdata/fullsize_ref.npz):
     the numpy-seeded weights' SHA-256, each encoder layer's CAGQ on the
     reference's level bit for bit, the served bf16 logits within 10% of
     the range and argmax >= 0.98, knn3_mxu's top-1 agreement with the
     exact 3-NN printed;
 14. TF32 scope: a caller's TF32 flags survive a Predictor call, whose
     logits are those of a call with TF32 off;
 15. FPS + ball query against layer-0 CAGQ at [1, 81920] -> 8192 centers;
 16. export: scannet_whole_scene's folded forward at [1, 81920] through
     torch.export, loaded and run in a fresh process under two keys
     against the live Predictor, knn3_mxu 4 launches per call inside;
 17. trace and cost: 10 whole-scene requests (phase 13's Predictor and
     scene) under utils.profiling.trace, read by utils.traceview (kernels
     by exclusive time, busy ms, idle share against a CUDA-events
     latency), and phase 16's artifact priced by utils.hlocost (touched
     bytes, gather rows, flops, the bytes floor and floor / busy); gates:
     device events, 40 knn3_mxu launches and its kernel in the report,
     busy within 2% of the profiler's device self time, 4 knn3_mxu
     custom-call rows, 0 < floor / busy <= 1, no outer-dim scan kernel;
     then trace repeat: in one process of its own, 3 traces of 10
     whole-scene requests and 6 of a two-kernel call, each read only when
     complete (the device records it lost and the profiler's
     out-of-range count printed), then the two-kernel call traced in 3
     fresh processes, each holding its 3 kernels;
 18. data parallelism: a world-1 NCCL mesh train step bit for bit the
     single-device step; a world-2 gloo mesh with both ranks on cuda:0
     (train step against the single-device step, mesh serving, tier-1
     whole-scene slabs);
 19. the resident tiers: scannet_whole_scene through tiers 2 and 3 on a
     world-2 gloo mesh on cuda:0 against the JAX package's tiers
     (gridgcn_torch/testdata/resident_ref.npz: each layer's per-shard
     CAGQ bit for bit, bf16 logits within 10% of the range, argmax >=
     0.98, no ghost overflow, 4 knn3_mxu launches per rank per vote);
     predict_scenes on a 2 x 2 mesh of 4 gloo ranks against each scene's
     1-D tier 3; both tiers' scannet_seg train step (f32, one whole
     8192-point scene, world 2) on the card against the same step on the
     CPU, the CPU's CAGQ and 3-NN choices pinned, and with knn3_mxu live
     against the CPU on the card's 3-NN outputs; both kernels against
     their plain versions on every decoder call of these tiers; tier 3 at
     world 1 (NCCL): ms per scene beside the single device, ms per train
     step, train_spatial for 2 epochs of 4 scenes;
 20. the tier studies, each script in its own process:
     scripts/study_tier2_compute_torch.py (tier 2's replicated share R/C
     of the whole-scene forward from traced busy time) and
     scripts/study_tier3_fixed_overhead_torch.py (tier 3 at world 1
     against the unsharded forward, per-kernel differences); gates: every
     trace holds device events, 0 < R/C < 1, C >= E0 + R - 5%, knn3_mxu 4
     launches per full forward; then the mesh-1 study
     (scripts/study_mesh1_overhead_torch.py, eval and --train, both with
     --ghost-sweep, on scannet_whole_scene; the variants traced in
     fresh processes, a few a process): the plain forward's and train
     step's busy ms, tier 3 at one rank at 4 ghost caps and its affine
     fit in each mode, tier 2 at one rank; gates: every reading from a
     complete trace, 4 points a fit, no ghost overflow, knn3_mxu 4
     launches per call, the share/8 overhead within 0.05 of the tier-3
     fixed-overhead study's +9.2% and the full share's no lower;
 21. the communication audit: each rank's ring-shift bytes in the
     world-2 tier-3 forward of phase 19 equal to the audit's; its
     projections at 2, 4 and 8 ranks from the card's anchors, all busy
     time but the kNN (phase 20's plain forward, plain train step and
     ghost-tax fits, the tax taken at each rank count; the kernel phase's
     knn3_mxu ms on the four decoder calls; phase 20's R/C, the byte
     model's share printed beside it);
 22. the multi-device dry run (gridgcn_torch.dryrun) on 4 gloo ranks
     sharing cuda:0, with its reference-format lines and phase 21's
     anchors at every ghost-cap setting;
 23. CAGQ's coord_match and coord_payload gathers on each of the whole
     scene's four layers: every field bit for bit the packed path's, and
     layer 0 against the CPU;
 24. one JSON line of kernels, the card line, and the final JSON line.
Each phase prints its seconds.
The kernel phase also holds both kernels against their plain versions on
the four decoder calls of one augmented training batch, and at the list
lengths k = 1, 8 and 16 (the register kernels, built once per k used)
and k = 32 and 128 (the list kernels, one build for 17..128) on the main
path's four decoder calls; these builds start side by side.
--profile adds torch.profiler tables of one whole-scene request, of one
classifier request and of one training step, with their CUDA launch counts
and their busy time read from each one's trace by utils.traceview.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import re
import statistics
import subprocess
import sys
import time

# published H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, and
# the kNN kernels' operations per pair with the peak each runs at (bf16
# tensor cores, fp32 CUDA cores)
from gridgcn_torch.utils.hlocost import KNN_OPS, PEAK_OPS_PER_S
from gridgcn_torch.utils.hw import HBM_BYTES_PER_S
# the kNN list lengths other than the decoder's 3 that the kernel phase
# holds (any_k_phase): the register kernels' shortest, a middle and their
# longest, then two of the list kernels' (up to the reference's 128),
# timed on the main path's calls; the list kernels are also held at two
# lengths that are not multiples of 32
ANY_K = (1, 8, 16)
LONG_K = (32, 128)
LIST_K = (17, 32, 100, 128)
LIST_THREADS = 256   # threads a block of knn.cu's list kernels


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def cuda_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call over `iters` calls, CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_us(torch, fn, calls: int = 200, reps: int = 5) -> list[float]:
    """Host microseconds per call over `calls` calls with no sync between
    them, then one: what a small call costs the caller; `reps` times."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) / calls * 1e6)
    return out


def spills(log: str) -> dict[str, tuple[int, int]]:
    """{kernel: (spill store bytes, spill load bytes)} from nvcc's
    `-Xptxas -v` report."""
    out, name = {}, None
    for line in log.splitlines():
        if "Function properties for" in line:
            name = line.split("Function properties for")[1].strip()
        elif "spill stores" in line and name is not None:
            words = line.replace(",", " ").split()
            out[name] = (int(words[words.index("spill") - 2]),
                         int(words[words.index("loads") - 3]))
    return out


def kernel_resources(log: str) -> dict[str, tuple[int, int]]:
    """{kernel: (registers a thread, static shared bytes a block)} from
    nvcc's `-Xptxas -v` report."""
    out, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "registers" in line and name is not None:
            words = line.replace(",", " ").split()
            smem = int(words[words.index("smem") - 2]) if "smem" in words \
                else 0
            out[name] = (int(words[words.index("registers") - 1]), smem)
    return out


def resident_warps(registers: int, shared: int, threads: int) -> int:
    """Warps of a kernel that an H100 SM holds at once: 65536 registers,
    given a warp at a time in units of 256; 228 KB of shared memory, 1 KB
    of it reserved a block; at most 64 warps and 32 blocks."""
    warps = threads // 32
    warp_regs = -(-registers * 32 // 256) * 256
    blocks = min(65536 // (warp_regs * warps), 233472 // (shared + 1024),
                 64 // warps, 32)
    return blocks * warps


def decoder_inputs(torch, cfg, sd, xyz, jaxrng, fold_inference,
                   build_model):
    """The four decoder kNN calls of the first cloud of a request (xyz
    [N, 3] or [B, N, 3]), as the served model's encoder produces them:
    (queries, query mask, supports, support mask) per stage, coarsest
    first; (512x128, ..., 81920x8192) on a whole scene."""
    fcfg, folded = fold_inference(cfg, sd)
    model = build_model(fcfg.model)
    model.load_state_dict(folded)
    model = model.to("cuda").eval()
    x = torch.as_tensor(xyz, device="cuda")
    x = x[None] if x.dim() == 2 else x
    feat, mask = x, torch.ones(x.shape[:2], dtype=torch.bool, device="cuda")
    key = jaxrng.PRNGKey(0)
    levels = [(x, mask)]
    with torch.no_grad():
        for i in range(len(fcfg.model.layers)):
            x, feat, mask = model.encode_layer(
                i, x, feat, mask,
                jaxrng.flax_make_rng(key, (f"gridconv{i}",), 1))
            levels.append((x, mask))
    return [(levels[-2 - i][0][0].contiguous(), levels[-2 - i][1][0],
             levels[-1 - i][0][0].contiguous(), levels[-1 - i][1][0])
            for i in range(len(levels) - 1)]


def ragged_inputs(torch, nq, ns, ns_valid, seed):
    """test_pallas-style uniform clouds: the last tenth of the queries and
    all supports from ns_valid on are masked."""
    g = torch.Generator().manual_seed(seed)
    q = (torch.rand((nq, 3), generator=g) * 13 - 4).cuda()
    s = (torch.rand((ns, 3), generator=g) * 13 - 4).cuda()
    qm = (torch.arange(nq) < nq - nq // 10).cuda()
    sm = (torch.arange(ns) < ns_valid).cuda()
    return q, qm, s, sm


def grid_inputs(torch, nq, ns, seed):
    """Queries and supports on the 2^-6 grid in [0, 1), every support
    valid, the last tenth of the queries masked. Centered, each coordinate
    is a multiple of 2^-7 below 1, so its bf16 split is exact, and every
    product and partial sum of knn3_mxu's 16 terms is a multiple of 2^-14
    below 16: exact in f32 in any order. knn3_mxu must then equal its
    plain version bit for bit, exact ties included."""
    g = torch.Generator().manual_seed(seed)
    q = (torch.randint(0, 64, (nq, 3), generator=g) / 64.0).cuda()
    s = (torch.randint(0, 64, (ns, 3), generator=g) / 64.0).cuda()
    qm = (torch.arange(nq) < nq - nq // 10).cuda()
    sm = torch.ones(ns, dtype=torch.bool, device="cuda")
    return q, qm, s, sm


def kernel_phase(torch, knn, cases):
    """Each kernel against its plain version on the card, on each
    (args, kind) case, kind "main" (one of the main path's decoder calls),
    "crop" (one of a scannet_seg crop's decoder calls), "train" (one of an
    augmented training batch's), "ragged" or "grid" (knn3_mxu bit exact),
    or a resident tier's call (resident_phase); the tighter gates hold at
    the largest case; returns per-kernel totals over the main cases (one
    whole-scene forward's four decoder calls), with each main call's ms
    in `stage_ms` (coarsest first)."""
    tot = {k: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                   max_abs_err=0.0, bytes_ms=0.0, ops_ms=0.0, stage_ms=[])
           for k in ("knn3_mxu", "knn3_exact")}
    largest = max(a[0].shape[0] * a[2].shape[0] for a, _ in cases)
    for args, kind in cases:
        q, qm, s, sm = args
        nq, ns = q.shape[0], s.shape[0]
        de, ie, ve = knn.knn3_exact(*args)
        dx, ix, vx = knn.knn3_exact_ref(*args)
        dm, im, vm = knn.knn3_mxu(*args)
        dr, ir, vr = knn.knn3_mxu_ref(*args)
        pk, pr = knn.mxu_pack_support(s, sm), knn.mxu_pack_support_ref(s, sm)
        torch.cuda.synchronize()
        assert torch.equal(pk, pr), \
            f"mxu pack differs from its plain version at Ns {ns}"
        if kind == "grid":
            assert torch.equal(dm.view(torch.int32), dr.view(torch.int32)) \
                and torch.equal(im, ir) and torch.equal(vm, vr), \
                f"knn3_mxu not bit exact on the grid case {nq}x{ns}"
        # knn3_exact: bit for bit
        assert torch.equal(de.view(torch.int32), dx.view(torch.int32)), \
            f"knn3_exact d2 differs from its plain version at {nq}x{ns}"
        assert torch.equal(ie, ix) and torch.equal(ve, vx), \
            f"knn3_exact idx/valid differ at {nq}x{ns}"
        # knn3_mxu vs its plain version: only the f32 sum order differs
        assert torch.equal(vm, vr), f"knn3_mxu valid differs at {nq}x{ns}"
        same = (im == ir) & vm
        agree = same.sum().item() / max(vm.sum().item(), 1)
        err_plain = (dm - dr).abs()[same].max().item() if same.any() else 0.0
        assert agree >= 0.999 and err_plain <= 1e-3, \
            f"knn3_mxu vs plain at {nq}x{ns}: agree {agree} err {err_plain}"
        # knn3_mxu vs knn3_exact: the test_pallas gates
        assert torch.equal(vm, ve), f"knn3_mxu valid != exact at {nq}x{ns}"
        rows = qm.nonzero()[:, 0]
        hit = (im[rows][:, :, None] == ie[rows][:, None, :]).any(-1)
        recall = hit[ve[rows]].float().mean().item()
        top1 = (im[rows, 0] == ie[rows, 0]).float().mean().item()
        match = (im == ie) & vm
        err_exact = (dm - de).abs()[match].max().item() if match.any() else 0.0
        assert recall >= 0.97 and top1 >= 0.99 and err_exact < 2e-2, \
            (f"knn3_mxu vs exact at {nq}x{ns}: recall {recall} top1 {top1} "
             f"err {err_exact}")
        if nq * ns == largest:
            assert recall >= 0.997 and top1 >= 0.995 and err_exact <= 1e-3, \
                (f"knn3_mxu vs exact at {nq}x{ns}: recall {recall} top1 "
                 f"{top1} err {err_exact}")

        pairs = nq * ns
        io_bytes = nq * (12 + 1) + ns * (12 + 1) + nq * 3 * (4 + 4 + 1)
        iters = 5 if pairs > 1e8 else 20
        times = {
            "knn3_mxu": cuda_ms(torch, lambda: knn.knn3_mxu(*args), iters),
            "knn3_exact": cuda_ms(torch, lambda: knn.knn3_exact(*args),
                                  iters),
        }
        plain = {
            "knn3_mxu": cuda_ms(torch, lambda: knn.knn3_mxu_ref(*args), 3, 1),
            "knn3_exact": cuda_ms(torch, lambda: knn.knn3_exact_ref(*args),
                                  3, 1),
        }
        pack_ms = cuda_ms(torch, lambda: knn.mxu_pack_support(s, sm), 20)
        pack_plain = cuda_ms(torch, lambda: knn.mxu_pack_support_ref(s, sm),
                             3, 1)
        library = cuda_ms(torch, lambda: torch.topk(
            torch.cdist(q, s), 3, dim=-1, largest=False), 3, 1)
        # bytes: inputs read once, outputs written once; operations: each
        # kernel's per pair (hlocost.KNN_OPS)
        bytes_ms = io_bytes / HBM_BYTES_PER_S * 1e3
        ops_ms = {name: pairs * per_pair / PEAK_OPS_PER_S[peak] * 1e3
                  for name, (per_pair, peak) in KNN_OPS.items()}
        bounds = {k: max(bytes_ms, ops_ms[k]) for k in ops_ms}
        errs = {"knn3_mxu": err_plain,
                "knn3_exact": (de - dx).abs().max().item()}
        for k in tot:
            print(f"kernel {k} {nq}x{ns} {kind}: "
                  f"ms {times[k]:.4f} plain_ms {plain[k]:.4f} "
                  f"library_ms {library:.4f} bound_ms {bounds[k]:.5f} "
                  f"max_abs_err {errs[k]:.3g}")
            tot[k]["max_abs_err"] = max(tot[k]["max_abs_err"], errs[k])
            if kind == "main":
                tot[k]["stage_ms"].append(times[k])
                tot[k]["ms"] += times[k]
                tot[k]["plain_ms"] += plain[k]
                tot[k]["library_ms"] += library
                tot[k]["bound_ms"] += bounds[k]
                tot[k]["bytes_ms"] += bytes_ms
                tot[k]["ops_ms"] += ops_ms[k]
        print(f"  mxu: recall {recall:.5f} top1 {top1:.5f} vs-exact err "
              f"{err_exact:.3g}; vs-plain agree {agree:.6f}; its support "
              f"pack alone ms {pack_ms:.4f} (plain {pack_plain:.4f}), bit "
              f"exact")
    main = [a for a, kind in cases if kind == "main"]
    for k, args in ((k, main[0]) for k in tot if main):
        fn = getattr(knn, k)
        us = host_us(torch, lambda: fn(*args))
        print(f"host cost of one {k} call at {args[0].shape[0]}x"
              f"{args[2].shape[0]}: median {statistics.median(us):.2f} us, "
              f"min {min(us):.2f} us (5 x 200 calls, no sync between them)")
    return tot


def _compare(np, tag, a, b):
    d = np.abs(a - b)
    scale = float(np.abs(b).max())
    agree = float((a.argmax(-1) == b.argmax(-1)).mean())
    q = np.quantile(d, [0.5, 0.99, 0.999])
    print(f"check {tag} cuda vs cpu: |d| median {q[0]:.3g} p99 {q[1]:.3g} "
          f"p99.9 {q[2]:.3g} max {d.max():.3g} (logit range {scale:.3g}), "
          f"argmax agree {agree:.5f}")
    return scale, agree, float(q[2]), float(d.max())


def correctness_phase(torch, np, Predictor, cfg, sd, scene_fn, jaxrng):
    """The served forward on the card against the same forward on the CPU
    (every kernel replaced by its plain version), same weights and key.
    The CAGQ indices are the same on both; what differs is f32 summation
    order (barycenters, matmuls, the 16-term distance sum), which can swap
    a near-tied 3rd and 4th neighbor and so move a few interpolated
    points."""
    key = jaxrng.PRNGKey(1)
    # full width, f32, a small scene: all but a few points within 1e-3
    cfg32 = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, dtype="float32"))
    xyz = scene_fn(8192, seed=3)
    a = Predictor(cfg32, sd, device="cuda")(xyz, rng=key)
    b = Predictor(cfg32, sd, device="cpu")(xyz, rng=key)
    s32, agree32, q32, max32 = _compare(np, "f32 8192 pts", a, b)
    # the preset as served (bf16), full scene: the bf16 fidelity gate
    xyz = scene_fn(81920, seed=7)
    t0 = time.perf_counter()
    b = Predictor(cfg, sd, device="cpu")(xyz, rng=key)
    cpu_s = time.perf_counter() - t0
    a = Predictor(cfg, sd, device="cuda")(xyz, rng=key)
    print(f"cpu forward of the full scene: {cpu_s:.1f} s")
    s16, agree16, _, max16 = _compare(np, "bf16 81920 pts", a, b)
    assert a.shape == (81920, cfg.model.num_classes) and np.isfinite(a).all()
    assert agree32 >= 0.999 and q32 <= 1e-3 * s32 and max32 <= 0.05 * s32
    assert agree16 >= 0.98 and max16 <= 0.1 * s16


def kernel_counters(knn, jaxrng):
    """The kernels' host counters: knn3_mxu's and knn3_exact's launches by
    list length, the support pack's, the draw kernel's by epilogue."""
    return {"knn3_mxu": dict(knn.knn3_mxu.launches_by_k),
            "knn3_exact": dict(knn.knn3_exact.launches_by_k),
            "mxu_pack_support": knn.mxu_pack_support.launches,
            "draws": dict(jaxrng.launches)}


def zero_kernel_counters(knn, jaxrng):
    knn.knn3_mxu.launches = 0
    knn.knn3_exact.launches = 0
    knn.knn3_mxu.launches_by_k.clear()
    knn.knn3_exact.launches_by_k.clear()
    knn.mxu_pack_support.launches = 0
    for k in jaxrng.launches:
        jaxrng.launches[k] = 0


def captured_counters(torch, knn, jaxrng, pred, *args):
    """The kernels' host counters over the capture of pred(*args): pred's
    signature is called once (eagerly), the counters zeroed, then called
    again, which captures the forward that every later call replays. The
    capture launches each kernel once a launch of the forward, so these
    are the main path's launches a forward."""
    captures = pred.captures
    pred(*args)
    torch.cuda.synchronize()
    zero_kernel_counters(knn, jaxrng)
    pred(*args)
    assert pred.captures == captures + 1, "the second call did not capture"
    return kernel_counters(knn, jaxrng)


def serving_phase(torch, np, knn, pred, scenes, jaxrng):
    """3 requests and one predict_scene(votes=2) on the main path, the
    default Predictor: a signature's first call eager, its second
    captured, every later call a replay. The kernels' host counters are
    read over the capture, which every replay runs (knn3_mxu and its
    support pack 4 launches a forward, the draw kernel 8), and stay still
    over the 5 replayed forwards. Returns the launches of the 5 forwards
    (the capture's a forward, 5 times) and the median latency."""
    got = captured_counters(torch, knn, jaxrng, pred, scenes[0])
    per = {"knn3_mxu": got["knn3_mxu"], "knn3_exact": got["knn3_exact"]}
    assert per == {"knn3_mxu": {3: 4}, "knn3_exact": {}}, got
    assert got["mxu_pack_support"] == 4, got
    # one draw kernel a draw: each of the 4 layers' voxel build (bits) and
    # threshold RVS (uniform)
    assert got["draws"] == {"bits": 4, "uniform": 4, "gumbel": 0}, got
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    replays = pred.replays
    lat, wall = [], []
    for xyz in scenes:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = pred(xyz)
        end.record()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        lat.append(start.elapsed_time(end))
        assert out.shape == (81920, 21) and out.dtype == np.float32
        assert np.isfinite(out).all()
    voted = pred.predict_scene(scenes[0], votes=2,
                               rng=jaxrng.PRNGKey(0))
    assert voted.shape == (81920, 21) and np.isfinite(voted).all()
    forwards = len(scenes) + 2
    assert pred.replays - replays == forwards
    assert kernel_counters(knn, jaxrng) == got, "a replay launched a kernel"
    launches = {n: {k: v * forwards for k, v in d.items()}
                for n, d in per.items()}
    peak = torch.cuda.max_memory_allocated()
    print(f"serving: {forwards} replayed forwards of one capture, launches "
          f"{launches} (the capture's {per} a forward), draw kernels "
          f"{got['draws']} a forward; per-scene "
          f"latency median {statistics.median(lat):.3f} ms (CUDA events; "
          f"{[round(x, 3) for x in lat]}), host wall median "
          f"{statistics.median(wall):.3f} ms; peak memory "
          f"{peak / 2 ** 20:.1f} MiB")
    steady = [cuda_ms(torch, lambda: pred(x), 5, 0) for x in scenes]
    print(f"serving steady: {[round(x, 3) for x in steady]} ms per request "
          f"(5 back-to-back requests per scene, CUDA events)")
    return launches, statistics.median(lat)


def _record_center_vids(run):
    """run() with every CAGQ call's center_vids recorded, in call order."""
    import gridgcn_torch.models.gridconv as gridconv

    seen, real = [], gridconv.cagq

    def recording(*args, **kw):
        out = real(*args, **kw)
        seen.append(out.groups.center_vids.cpu())
        return out

    gridconv.cagq = recording
    try:
        return run(), seen
    finally:
        gridconv.cagq = real


def paths_correctness_phase(torch, np, Predictor, presets, init_model,
                            scene_fn, jaxrng):
    """modelnet40_cas, synthetic_scene_seg (dense decoder) and its grid
    override, each at full width: the served forward on the card against
    the same forward on the CPU, same weights and key. f32: argmax
    agreement ≥ 0.999 (the classifier: every cloud) and p99.9 |Δ| ≤ 1e-3
    of the logit range; bf16 (the preset's serving dtype): |Δ| ≤ 10% of
    the range. The share of center voxels chosen alike is printed, not
    gated: the Gumbel draws are the same bits on both devices, but the
    deeper levels' centers come from barycenters summed in another order."""
    key = jaxrng.PRNGKey(2)
    cls_x = classifier_clouds(np, 16, 1024, seed=100)
    scenes = np.stack([scene_fn(4096, seed=20 + i) for i in range(4)])
    seg = presets.get("synthetic_scene_seg")
    grid = dataclasses.replace(seg, model=dataclasses.replace(
        seg.model, up_layers=tuple(dataclasses.replace(u, method="grid")
                                   for u in seg.model.up_layers)))
    cases = [("modelnet40_cas", presets.get("modelnet40_cas"), cls_x),
             ("synthetic_scene_seg", seg, scenes),
             ("synthetic_scene_seg grid", grid, scenes)]
    for tag, cfg, x in cases:
        _, sd = init_model(cfg.model, torch.Generator().manual_seed(0))
        for dtype in ("float32", "bfloat16"):
            c = dataclasses.replace(cfg, model=dataclasses.replace(
                cfg.model, dtype=dtype, eval_dtype=""))
            a, va = _record_center_vids(
                lambda: Predictor(c, sd, device="cuda")(x, rng=key))
            b, vb = _record_center_vids(
                lambda: Predictor(c, sd, device="cpu")(x, rng=key))
            assert a.shape == b.shape and np.isfinite(a).all(), tag
            same = [float((u == v).float().mean()) for u, v in zip(va, vb)]
            scale, agree, q999, dmax = _compare(np, f"{tag} {dtype}", a, b)
            print(f"  center_vids alike per CAGQ layer: "
                  f"{[round(v, 5) for v in same]}")
            if dtype == "float32":
                assert agree >= (1.0 if a.ndim == 2 else 0.999), tag
                assert q999 <= 1e-3 * scale, tag
            else:
                assert dmax <= 0.1 * scale, tag


def cas_seg_correctness_phase(torch, np, Predictor, cfg, sd, x, jaxrng,
                              build_model, fold_inference):
    """scannet_seg (CAS encoder, knn3_mxu decoder) on the crops x, at full
    width, the card against the CPU with the same weights and key:

    1. the served forward, f32 and bf16: |Δ| ≤ 10% of the logit range, f32
       argmax agreement ≥ 0.99. Not the f32 gate of the other paths: the
       barycenters come from f32 prefix sums, which the two devices add in
       another order (a few ulps apart); a point that lands across a voxel
       face of the next layer's grid changes that layer's coverage, and CAS
       then picks other centers from there on.
    2. f32 on the CPU's encoder levels: each layer's CAGQ on the card
       against the CPU on the same input (center voxels, validity and
       neighbors bit for bit), then the decoder (four knn3_mxu calls per
       cloud) and head on both devices: argmax ≥ 0.999, p99.9 |Δ| ≤ 1e-3
       of the range."""
    from gridgcn_torch.ops.cagq import cagq

    key = jaxrng.PRNGKey(2)
    for dtype in ("float32", "bfloat16"):
        c = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, dtype=dtype, eval_dtype=""))
        a, va = _record_center_vids(
            lambda: Predictor(c, sd, device="cuda")(x, rng=key))
        b, vb = _record_center_vids(
            lambda: Predictor(c, sd, device="cpu")(x, rng=key))
        assert a.shape == b.shape == x.shape[:2] + (21,)
        assert np.isfinite(a).all()
        same = [float((u == v).float().mean()) for u, v in zip(va, vb)]
        scale, agree, _, dmax = _compare(np, f"scannet_seg served {dtype}",
                                         a, b)
        print(f"  center_vids alike per CAGQ layer: "
              f"{[round(v, 5) for v in same]}")
        assert dmax <= 0.1 * scale
        if dtype == "float32":
            assert agree >= 0.99

    c32 = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, dtype="float32", eval_dtype=""))
    fcfg, folded = fold_inference(c32, sd)
    assert all(u.method == "pallas" for u in fcfg.model.up_layers)
    models = {}
    for dev in ("cpu", "cuda"):
        models[dev] = build_model(fcfg.model)
        models[dev].load_state_dict(folded)
        models[dev] = models[dev].to(dev).eval()
    xyz = torch.as_tensor(x)
    levels = [(xyz, xyz if fcfg.model.use_xyz_feature else None,
               torch.ones(xyz.shape[:2], dtype=torch.bool))]
    logits = {}
    with torch.no_grad():
        for i, spec in enumerate(fcfg.model.layers):
            k = jaxrng.flax_make_rng(key, (f"gridconv{i}",), 1)
            p, _, m = levels[-1]
            gc = cagq(p, m, spec, k).groups
            gg = cagq(p.cuda(), m.cuda(), spec, k).groups
            for f in ("center_vids", "center_valid", "neighbor_idx",
                      "neighbor_mask"):
                assert torch.equal(getattr(gg, f).cpu(), getattr(gc, f)), \
                    f"scannet_seg layer {i} CAGQ {f} differs on the card"
            levels.append(models["cpu"].encode_layer(i, *levels[-1], k))
        for dev, model in models.items():
            lv = [tuple(None if t is None else t.to(dev) for t in level)
                  for level in levels]
            c_xyz, c_feat, c_mask = lv[-1]
            for i in range(len(fcfg.model.up_layers)):
                d_xyz, d_feat, d_mask = lv[-2 - i]
                c_feat = model.decode_stage(i, c_xyz, c_feat, c_mask,
                                            d_xyz, d_feat, d_mask)
                c_xyz, c_mask = d_xyz, d_mask
            logits[dev] = model.head_logits(c_feat).float().cpu().numpy()
    scale, agree, q999, _ = _compare(
        np, "scannet_seg f32 decoder on the CPU's encoder levels",
        logits["cuda"], logits["cpu"])
    assert agree >= 0.999 and q999 <= 1e-3 * scale


def classifier_clouds(np, B, N, seed):
    """B seeded clouds of N points on the surfaces of random boxes, spheres
    and cylinders (a stand-in for ModelNet40 shapes), each in [-1, 1]³."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(B):
        kind = rng.integers(3)
        u = rng.normal(size=(N, 3))
        if kind == 0:      # box: push each point to its largest axis
            u = u / np.abs(u).max(1, keepdims=True)
        elif kind == 1:    # sphere
            u = u / np.linalg.norm(u, axis=1, keepdims=True)
        else:              # cylinder about z
            u[:, :2] /= np.linalg.norm(u[:, :2], axis=1, keepdims=True)
            u[:, 2] = rng.uniform(-1, 1, N)
        u = u * rng.uniform(0.4, 1.0, 3)
        out.append(u / np.abs(u).max())
    return np.stack(out).astype(np.float32)


def crop_batch(np, scene_fn, B, seed):
    """B seeded 8192-point scenes, a scannet_seg request."""
    return np.stack([scene_fn(8192, seed=seed + i) for i in range(B)])


def timed_requests(torch, pred, batches, check):
    """Two warm-up requests, then one per batch: (CUDA-event ms list, host
    wall ms list, peak MiB). check(out) asserts on each answer."""
    for _ in range(2):
        check(pred(batches[0]))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lat, wall = [], []
    for x in batches:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = pred(x)
        end.record()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        lat.append(start.elapsed_time(end))
        check(out)
    return lat, wall, torch.cuda.max_memory_allocated() / 2 ** 20


def classifier_serving_phase(torch, np, Predictor, presets, init_model):
    """modelnet40_full and modelnet40_cas, full width, served in bf16 (their
    eval_dtype), 16 clouds of 1024 points per request, 7 requests after
    warm-up. Returns the served modelnet40_full predictor."""
    batches = [classifier_clouds(np, 16, 1024, seed=i) for i in range(7)]
    preds, medians = {}, {}
    for name in ("modelnet40_full", "modelnet40_cas"):
        cfg = presets.get(name)
        _, sd = init_model(cfg.model, torch.Generator().manual_seed(0))
        pred = preds[name] = Predictor(cfg, sd, device="cuda")

        def check(out):
            assert out.shape == (16, 40) and out.dtype == np.float32
            assert np.isfinite(out).all()

        lat, wall, peak = timed_requests(torch, pred, batches, check)
        medians[name] = statistics.median(lat)
        print(f"classifier {name} (bf16, 16 x 1024 pts): per-batch latency "
              f"median {statistics.median(lat):.3f} ms (CUDA events; "
              f"{[round(x, 3) for x in lat]}), host wall median "
              f"{statistics.median(wall):.3f} ms; peak memory {peak:.1f} MiB")
    return preds["modelnet40_full"], medians["modelnet40_full"]


def cas_seg_serving_phase(torch, np, knn, Predictor, cfg, sd, batches,
                          jaxrng):
    """scannet_seg (CAS, 3 rounds, bf16 with f32 BatchNorm) at full width,
    8 scenes of 8192 points per request, 5 requests after warm-up, on the
    main path (the default Predictor, replayed); its capture launches
    knn3_mxu once per decoder stage and cloud, and the draw kernel 23
    times: 4 voxel builds and 9 permutation rounds (bits), 10 Gumbel
    top-k's (CAS's starts and challengers, layers 2-3's RVS); the replays
    launch none from the host."""
    assert all(l.cas_iters == 3 for l in cfg.model.layers
               if l.sampler == "cas")
    pred = Predictor(cfg, sd, device="cuda")

    def check(out):
        assert out.shape == (8, 8192, 21) and out.dtype == np.float32
        assert np.isfinite(out).all()

    # the main path's launches a forward, counted over the capture that
    # every later call replays
    got = captured_counters(torch, knn, jaxrng, pred, batches[0])
    assert got["knn3_mxu"] == {3: 4 * 8}, got
    draws = got["draws"]
    assert draws == {"bits": 13, "uniform": 0, "gumbel": 10}, draws
    replays = pred.replays
    lat, wall, peak = timed_requests(torch, pred, batches, check)
    assert pred.replays - replays == 2 + len(batches)
    assert kernel_counters(knn, jaxrng) == got, "a replay launched a kernel"
    print(f"scannet_seg (CAS x3, bf16, 8 x 8192 pts): per-batch latency "
          f"median {statistics.median(lat):.3f} ms (CUDA events; "
          f"{[round(x, 3) for x in lat]}), host wall median "
          f"{statistics.median(wall):.3f} ms; peak memory {peak:.1f} MiB; "
          f"knn3_mxu launches per forward {4 * 8}, draw kernels {draws}")


def graphs_phase(torch, np, Predictor, presets, init_model, knn, jaxrng,
                 scene_fn):
    """The served forward replayed from CUDA graphs (the default Predictor
    on one card) against the eager forward (graphs=False, the bit-for-bit
    reference) for the benchmark's three configurations at their cells'
    shapes, seeded weights: scannet_whole_scene 4 x 81920, scannet_seg 8 x
    8192, modelnet40_cas 16 x 1024. Gates: the first call (eager), the
    capture and the replays bit for bit the eager logits under two keys;
    one capture; the replays counted; the capture's host counters those
    of an eager forward (knn3_mxu 16 / 32 / 0, the draw kernel 8 / 23 / 18)
    and still over the replays; a trace of one replay holding as many
    knn3_mxu and draw kernels as the capture launched; no two answers
    sharing memory. Printed: host wall ms per request, median of 5, eager
    and replayed."""
    import os
    import shutil

    from gridgcn_torch.utils import profiling, traceview

    cases = {
        "scannet_whole_scene": np.stack([scene_fn(81920, seed=7 + i)
                                         for i in range(4)]),
        "scannet_seg": crop_batch(np, scene_fn, 8, seed=40),
        "modelnet40_cas": classifier_clouds(np, 16, 1024, seed=0)}
    expect = {"scannet_whole_scene": (16, 8), "scannet_seg": (32, 23),
              "modelnet40_cas": (0, 18)}    # knn3_mxu, draws a forward
    k2 = jaxrng.fold_in(jaxrng.PRNGKey(9), 3)

    def bits(a):
        return np.ascontiguousarray(a, np.float32).view(np.int32)

    def wall_ms(fn):
        t = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn()
            t.append((time.perf_counter() - t0) * 1e3)
        return round(statistics.median(t), 3)

    for name, xyz in cases.items():
        cfg = presets.get(name)
        _, sd = init_model(cfg.model, torch.Generator().manual_seed(0))
        eager = Predictor(cfg, sd, device="cuda", graphs=False)
        graphed = Predictor(cfg, sd, device="cuda")
        eager(xyz)
        zero_kernel_counters(knn, jaxrng)
        want = eager(xyz)
        per = kernel_counters(knn, jaxrng)
        want2 = eager(xyz, rng=k2)
        got = [graphed(xyz)]                     # eager
        zero_kernel_counters(knn, jaxrng)
        got.append(graphed(xyz))                 # captured and replayed
        captured = kernel_counters(knn, jaxrng)
        got += [graphed(xyz), graphed(xyz, rng=k2)]
        still = kernel_counters(knn, jaxrng) == captured
        replays = graphed.replays
        logdir = os.path.join("build", "chip_smoke_graphs", name)
        shutil.rmtree(logdir, ignore_errors=True)
        with profiling.trace(logdir, cpu=False):
            graphed(xyz)
        names = [n for ev in traceview.load_events(logdir).values()
                 for _, _, n in ev]
        traced = (sum("knn3_mxu_kernel" in n for n in names),
                  sum("draw_kernel" in n for n in names))
        lost = traceview.lost_records(logdir)
        ms = (wall_ms(lambda: eager(xyz)), wall_ms(lambda: graphed(xyz)))
        same = all(np.array_equal(bits(g), bits(w))
                   for g, w in zip(got, [want] * 3 + [want2]))
        launched = (sum(captured["knn3_mxu"].values()),
                    sum(captured["draws"].values()))
        print(f"graphs {name} {list(xyz.shape)}: eager call, capture and "
              f"replays bit for bit the eager logits under 2 keys {same}; "
              f"captures {graphed.captures}, replays {graphed.replays}; "
              f"the capture's host counters {captured} (an eager forward's "
              f"{per}), still over the replays {still}; one replay's trace: "
              f"knn3_mxu and draw kernels {traced}, device events "
              f"{len(names)}, launches without a record {lost}; host wall "
              f"ms a request eager / replayed {ms[0]} / {ms[1]}")
        assert same and still
        assert captured == per and launched == expect[name], (captured,
                                                              per)
        assert lost[0] == 0 and traced == launched, (traced, lost)
        assert graphed.captures == 1 and replays == 2
        assert graphed.replays == 3 + 5
        assert not np.shares_memory(got[2], got[3])


def profiled(torch, name, fn):
    """Run fn() once under utils.profiling.trace (the trace written to
    build/chip_smoke_profile/<name>/) and print the profiler's table:
    (key_averages, host wall ms, device busy ms read from the trace by
    utils.traceview, device launches)."""
    import os

    from torch.autograd import DeviceType

    from gridgcn_torch.utils import profiling

    logdir = os.path.join("build", "chip_smoke_profile", name)
    with profiling.trace(logdir) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    print(events.table(sort_by="self_cuda_time_total", row_limit=25))
    busy = profiling.busy_ms_per_iter(logdir, 1)
    assert busy is not None, f"the {name} trace holds no device events"
    # device-side events only (kernels, copies): the aten rows repeat them,
    # and the program's spans' device-side copies (user annotations) are
    # not launches
    kernels = sum(e.count for e in events
                  if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False))
    return events, wall, busy, kernels


def profile_phase(torch, pred, xyz, latency_ms, name):
    events, wall, busy, kernels = profiled(torch, name, lambda: pred(xyz))
    aten = sorted(((e.count, e.key) for e in events
                   if e.key.startswith("aten::")), reverse=True)
    print(f"profile: one request {wall:.3f} ms wall under the profiler, "
          f"device busy {busy:.3f} ms; idle share {1 - busy / latency_ms:.3f}"
          f" of the unprofiled {latency_ms:.3f} ms request; "
          f"{kernels} device launches; most frequent host ops: "
          f"{[(k, c) for c, k in aten[:10]]}")


def rng_phase(torch, jaxrng, xla_math):
    """jaxrng.normal over 10^6 draws and xla_math.erf_inv over a grid of
    [-1, 1]: the same bits on the card as on the CPU (the CPU's are
    jax.random.normal's, tests/test_torch_augment.py)."""
    key = jaxrng.fold_in(jaxrng.PRNGKey(3), 5)
    a = jaxrng.normal(key, (1_000_000,)).view(torch.int32)
    b = jaxrng.normal(key, (1_000_000,), "cuda").cpu().view(torch.int32)
    x = torch.linspace(-1, 1, 1_000_001)
    e = xla_math.erf_inv(x).view(torch.int32)
    f = xla_math.erf_inv(x.cuda()).cpu().view(torch.int32)
    differ = int((a != b).sum()), int((e != f).sum())
    print(f"rng: jaxrng.normal 10^6 draws, {differ[0]} differ between "
          f"card and CPU; erf_inv on 10^6+1 grid points, {differ[1]} differ")
    assert differ == (0, 0), differ
    draw_kernel_times(torch, jaxrng)


def queued_us(torch, fn, reps: int, hold_cycles: int = 2_000_000_000):
    """Device µs a call of fn over `reps` calls enqueued behind a spin of
    `hold_cycles` clocks (~1 s, `torch.cuda._sleep`): the calls then run
    back to back on the device, whatever the host's pace (launch gaps
    included). The calls' launches must fit CUDA's launch queue (~1000)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(hold_cycles)
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    assert enqueue_s < 0.5, f"the host took {enqueue_s:.3f} s to enqueue"
    return start.elapsed_time(end) * 1e3 / reps


def draw_kernel_times(torch, jaxrng, n=81920):
    """The draw kernel by epilogue at a whole scene's n values under one
    numpy key: its device µs a draw (the key's copy and the launch) and
    the host's µs a call (`host_us`), beside the plain version's device
    µs a draw on the card (the int64 torch path)."""
    from gridgcn_torch.kernels import rng

    key = jaxrng.PRNGKey(0)
    for ep in rng.EPILOGUES:
        lo = jaxrng.xla_math.TINY if ep == "gumbel" else 0.0
        kernel = lambda: rng.draw(key, (n,), "cuda", 0, ep, lo, 1.0)
        plain = lambda: rng.draw_ref(int(key[0]), int(key[1]), (n,), 0, ep,
                                     lo, 1.0, "cuda")
        assert torch.equal(kernel(), plain())
        host = statistics.median(host_us(torch, kernel))
        print(f"rng kernel {ep}: {queued_us(torch, kernel, 200):.3f} us a "
              f"draw on the device, {host:.1f} us a call on the host "
              f"({n} values)")
        print(f"rng plain {ep}: {queued_us(torch, plain, 3):.1f} us of "
              f"device time a draw")


@contextlib.contextmanager
def cagq_record(torch, record, pinned=None):
    """Within the block, every GridConv's CAGQ appends its groups (the
    `GroupedNodes`) to `record`, on the CPU. Given `pinned` (such a
    record), the i-th CAGQ returns the i-th pinned groups instead, on its
    input's device."""
    import gridgcn_torch.models.gridconv as gridconv

    real = gridconv.cagq

    def move(groups, dev):
        return dataclasses.replace(groups, **{
            f.name: getattr(groups, f.name).to(dev)
            for f in dataclasses.fields(groups)
            if torch.is_tensor(getattr(groups, f.name))})

    def recording(xyz, *args, **kw):
        out = real(xyz, *args, **kw)
        if pinned is not None:
            out = dataclasses.replace(
                out, groups=move(pinned[len(record)], xyz.device))
        record.append(move(out.groups, "cpu"))
        return out

    gridconv.cagq = recording
    try:
        yield
    finally:
        gridconv.cagq = real


@contextlib.contextmanager
def three_nn_record(record, pinned=None, inputs=None):
    """Within the block, every decoder 3-NN query of the segmentation
    model (`flash_three_nn`) appends its outputs (idx, weights, found) to
    `record`, on the CPU. Given `pinned` (such a record), the i-th query
    returns the i-th pinned outputs instead, on the query's device, and
    its kernel does not run. Given `inputs` (a list), each kernel call
    that runs appends its arguments (q_xyz, q_mask, s_xyz, s_mask), one
    tuple per cloud of the batch, on the CPU."""
    import gridgcn_torch.models.segmentation as segmentation

    real = segmentation.flash_three_nn

    def three_nn(q_xyz, q_mask, s_xyz, s_mask, k=3):
        if pinned is None:
            if inputs is not None:
                inputs.extend(tuple(t[b].cpu() for t in (q_xyz, q_mask,
                                                         s_xyz, s_mask))
                              for b in range(q_xyz.shape[0]))
            out = real(q_xyz, q_mask, s_xyz, s_mask, k=k)
        else:
            out = tuple(t.to(q_xyz.device) for t in pinned[len(record)])
        record.append(tuple(t.cpu() for t in out))
        return out

    segmentation.flash_three_nn = three_nn
    try:
        yield
    finally:
        segmentation.flash_three_nn = real


@contextlib.contextmanager
def pool_record(torch, record):
    """Within the block, every GCA max-pool over the K nodes of a center
    (`amax` over dim -2 of [B, M, K, C]) appends, on the CPU, the gap
    between each output's two largest nodes relative to the largest (inf
    where the largest is not above 0): an output whose gap is a few ulps
    may send its gradient to another node on another device."""
    real = torch.Tensor.amax

    def amax(self, dim=None, keepdim=False):
        if dim == -2 and self.dim() == 4 and not keepdim \
                and self.shape[-2] > 1:
            v = torch.topk(self.detach().float(), 2, dim=-2).values
            record.append(torch.where(
                v[..., 0, :] > 0, (v[..., 0, :] - v[..., 1, :])
                / v[..., 0, :], float("inf")).cpu())
        return real(self, dim=dim, keepdim=keepdim)

    torch.Tensor.amax = amax
    try:
        yield
    finally:
        torch.Tensor.amax = real


@contextlib.contextmanager
def float64_batchnorm(torch):
    """Within the block, a batch-statistics BatchNorm computes in its
    input's dtype (float64 in a float64 model) instead of float32."""
    from gridgcn_torch.models.layers import BN_EPS, BatchNorm

    def forward(self, x):
        axes = tuple(range(x.dim() - 1))
        mean = x.mean(axes)
        var = torch.clamp_min((x * x).mean(axes) - mean * mean, 0.0)
        return (x - mean) * (torch.rsqrt(var + BN_EPS) * self.weight) \
            + self.bias

    real = BatchNorm.forward
    BatchNorm.forward = forward
    try:
        yield
    finally:
        BatchNorm.forward = real


def one_train_step(torch, steps, cfg, model, sd, batch, key, dev,
                   pin_cagq=None, pin_three_nn=None, mesh=None):
    """One train step of cfg on dev from the state_dict sd, with the CAGQ
    groups and the 3-NN outputs of another run pinned where given (see
    `cagq_record`, `three_nn_record`); with a mesh, the data-parallel step
    on this rank's rows of the global batch. Returns, on the CPU: the
    metrics, {name: gradient}, the state_dict after the step, and the
    CAGQ, 3-NN and max-pool records."""
    state = steps.create_train_state(cfg, model, sd, 4, device=dev)
    grads, update = [], state.tx.update
    state.tx.update = lambda g, norm: (grads.extend(x.cpu() for x in g),
                                       update(g, norm))[1]
    groups, nns, pools = [], [], []
    if mesh is not None:
        from gridgcn_torch.parallel.mesh import shard_batch
        batch = shard_batch(batch, mesh)
    with cagq_record(torch, groups, pin_cagq), \
            three_nn_record(nns, pin_three_nn), pool_record(torch, pools):
        _, m = steps.make_train_step(cfg, mesh=mesh)(state, batch, key)
    names = [n for n, _ in state.model.named_parameters()]
    return dict(metrics={k: float(v) for k, v in m.items()},
                grads=dict(zip(names, grads)),
                state={k: v.cpu() for k, v in state.model.state_dict().items()},
                cagq=groups, three_nn=nns, pools=pools)


def float64_gradients(torch, steps, jaxrng, cfg, model, sd, batch, key,
                      pinned):
    """The loss and gradients of the step `one_train_step` takes (no
    augmentation), computed on the CPU in float64 (BatchNorm included)
    with the CAGQ groups and 3-NN outputs of the run `pinned`: the exact
    answer for that run's discrete choices."""
    assert not cfg.data.augment and cfg.model.dropout == 0.0
    model.load_state_dict(sd)
    model.double().train()
    for mod in model.modules():
        for a in ("dtype", "att_dtype", "interp_dtype"):
            if isinstance(getattr(mod, a, None), torch.dtype):
                setattr(mod, a, torch.float64)
    _, k_cagq, k_drop = jaxrng.split(jaxrng.fold_in(key, 0), 3)
    b = {k: torch.as_tensor(v) for k, v in batch.items()}
    with cagq_record(torch, [], pinned["cagq"]), \
            three_nn_record([], pinned["three_nn"]), float64_batchnorm(torch):
        logits = model(b["xyz"].double(), None, b["mask"], k_cagq, k_drop)
        loss, _ = steps._loss_and_logits(cfg, logits, {
            "label": b["label"].long(), "mask": b["mask"]})
    params = list(model.parameters())
    grads = [torch.zeros_like(p) if g is None else g for g, p in zip(
        torch.autograd.grad(loss, params, allow_unused=True), params)]
    return dict(metrics={"loss": float(loss.detach()),
                         "grad_norm": float(steps.global_norm(grads))},
                grads={n: g.detach() for (n, _), g in zip(
                    model.named_parameters(), grads)})


def train_gaps(torch, steps, cfg, got, want, exact=None):
    """How far the step `got` (from `one_train_step`) is from the step
    `want`, its loss and gradients from `exact` where given (from
    `float64_gradients`): relative |Δ| of loss and grad_norm; the largest
    per-tensor gradient error ‖Δg‖ / max(‖g‖, 1e-3·‖g‖ of the whole
    model) over the parameters whose gradient is not rounding noise
    (`steps.noise_gradient_params`), and the largest noise gradient in
    units of the largest gradient element; the largest BatchNorm
    statistic error in units of its tensor's scale; the largest updated
    parameter error in units of its tensor's scale, over the elements
    whose two gradients agree to 1e-3 (a determined update); the share of
    elements that are not determined, each of which Adam's first step
    moves by up to lr either way; and the largest parameter error in lr.
    A tensor that is 0 in `want` (a zero-initialised bias whose gradient
    rounded to exactly 0, so Adam left it) has no scale: it is held to 0
    exactly."""
    ref = exact or want
    gg, gr, gc = got["grads"], ref["grads"], want["grads"]
    rel = {k: abs(got["metrics"][k] - ref["metrics"][k])
           / abs(ref["metrics"][k]) for k in ("loss", "grad_norm")}
    noise = steps.noise_gradient_params(cfg, gr)
    gmax = max(float(g.abs().max()) for g in gr.values())
    floor = 1e-3 * ref["metrics"]["grad_norm"]
    out = dict(rel, grad=0.0, worst="", noise=0.0, param=0.0, stat=0.0,
               undetermined=0.0, lr_moves=0.0)

    def of_scale(err, scale):
        return err / scale if scale else (float("inf") if err else 0.0)

    for k, w in want["state"].items():
        d, scale = (got["state"][k] - w).abs(), float(w.abs().max())
        if k not in gc:
            out["stat"] = max(out["stat"], of_scale(float(d.max()), scale))
            continue
        if k in noise:
            out["noise"] = max(out["noise"], float(max(
                gg[k].abs().max(), gr[k].abs().max())) / gmax)
        else:
            r = float((gg[k] - gr[k]).norm()) / max(float(gr[k].norm()),
                                                   floor)
            if r > out["grad"]:
                out["grad"], out["worst"] = r, k
        det = (gg[k] - gc[k]).abs() <= 1e-3 * gc[k].abs()
        out["undetermined"] += float((~det).sum())
        if det.any():
            e = of_scale(float(d[det].max()), scale)
            if e > out["param"]:
                i = int(torch.where(det, d, -1.0).argmax())
                out["param"], out["param_at"] = e, (
                    k, i, float(gg[k].reshape(-1)[i]),
                    float(gc[k].reshape(-1)[i]), scale)
        out["lr_moves"] = max(out["lr_moves"], float(d.max()) / cfg.train.lr)
    out["undetermined"] /= sum(g.numel() for g in gc.values())
    return out


def train_gap_line(g):
    return (f"loss rel {g['loss']:.3g}, grad_norm rel {g['grad_norm']:.3g}, "
            f"max gradient err {g['grad']:.3g} ({g['worst']}), noise "
            f"gradients {g['noise']:.3g} of the largest, BatchNorm statistics "
            f"{g['stat']:.3g} of scale, parameters {g['param']:.3g} of scale "
            f"where determined, undetermined share {g['undetermined']:.4f} "
            f"(largest move {g['lr_moves']:.3g} lr)")


def three_nn_line(torch, i, got, want):
    """One decoder stage's 3-NN on two devices: index agreement and the
    largest weight difference, overall and over the queries whose nearest
    support does not take 0.99 of the weight (no support within a few
    ulps of the query, where d² + 1e-8 amplifies the distances' rounding)."""
    (ig, wg, _), (ic, wc, _) = got, want
    dw = (wg - wc).abs().amax(-1)
    near = wc.amax(-1) >= 0.99
    far = dw[~near].max() if (~near).any() else torch.zeros(())
    return (f"  decoder stage {i} 3-NN: indices alike "
            f"{float((ig == ic).float().mean()):.6f}; weights max |diff| "
            f"{float(dw.max()):.3g}; queries with a support at d² ~ 0 "
            f"{float(near.float().mean()):.4f} of all, max |diff| over the "
            f"others {float(far):.3g}")


def train_correctness_phase(torch, np, presets, init_model, build_model,
                            steps, scene_fn, jaxrng):
    """One synthetic_scene_seg train step (f32, method="pallas": knn3_mxu
    on the card, its plain version on the CPU; no augmentation or dropout
    in this preset), 4 scenes of 4096 points, from the same weights and
    key (`train_gaps` defines each number):

    1. exact: the card's step with the CPU's CAGQ groups and decoder 3-NN
       outputs pinned (every op still runs on the card) against the same
       step in float64 on the CPU (`float64_gradients`): loss and gradient
       norm within 1e-5 relative, every gradient within 1e-4, noise
       gradients within 2e-4 of the largest; against the CPU's f32 step:
       BatchNorm statistics and determined parameters within 1e-5 of
       scale, at most 15% of the elements undetermined.
    2. as trained: the card's step against the CPU's. The two devices'
       discrete choices differ: knn3_mxu and its plain version add the 16
       terms of d² + 1 in another order, a few ulps of 1 apart, and where
       a query coincides with a support (a CAGQ center is one of the finer
       level's points) its weights 1/(d² + 1e-8) differ by up to 10x; the
       CAGQ barycenters are f32 prefix-sum differences, summed in another
       order on each device. Gated a few times above the gap measured on
       the H100 (PERF.md): loss 1e-5, gradient norm 1e-4, gradients 1e-2,
       BatchNorm statistics 3e-5, determined parameters 1e-5, at most 70%
       of the elements undetermined.
    In both, no parameter is more than 2 lr off. Printed beside them: the
    card with only the 3-NN pinned; the CPU's f32 step against float64,
    repeated, and with its own CAGQ and 3-NN outputs pinned; each CAGQ
    layer's and decoder stage's agreement; each GCA layer's near-tied
    max-pool outputs."""
    cfg = presets.get("synthetic_scene_seg")
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, up_layers=tuple(dataclasses.replace(u, method="pallas")
                                   for u in cfg.model.up_layers)))
    assert cfg.model.dtype == "float32" and not cfg.data.augment
    assert cfg.model.dropout == 0.0
    scenes = [scene_fn(4096, seed=60 + i, return_labels=True)
              for i in range(4)]
    batch = {"xyz": np.stack([x for x, _ in scenes]),
             "mask": np.ones((4, 4096), bool),
             "label": np.stack([lab for _, lab in scenes])}
    _, sd = init_model(cfg.model, torch.Generator().manual_seed(0))
    key = jaxrng.PRNGKey(4)

    def run(dev, **pins):
        return one_train_step(torch, steps, cfg, build_model(cfg.model), sd,
                              batch, key, dev, **pins)

    cpu = run("cpu")
    exact = float64_gradients(torch, steps, jaxrng, cfg,
                              build_model(cfg.model), sd, batch, key, cpu)
    card = run("cuda")
    checks = {
        "exact: cpu's CAGQ and 3-NN pinned, vs float64": (
            run("cuda", pin_cagq=cpu["cagq"], pin_three_nn=cpu["three_nn"]),
            exact),
        "as trained": (card, None),
        "3-NN pinned": (run("cuda", pin_three_nn=cpu["three_nn"]), None),
        "the cpu's own step vs float64": (cpu, exact),
        "the cpu's step again": (run("cpu"), None),
        "the cpu's step with its own CAGQ and 3-NN pinned": (
            run("cpu", pin_cagq=cpu["cagq"], pin_three_nn=cpu["three_nn"]),
            None)}
    gaps = {}
    for name, (r, ref) in checks.items():
        gaps[name] = train_gaps(torch, steps, cfg, r, cpu, ref)
        print(f"train check synthetic_scene_seg (f32, pallas, 4 x 4096), "
              f"{name}: loss {r['metrics']['loss']:.7g} vs "
              f"{(ref or cpu)['metrics']['loss']:.7g}; "
              f"{train_gap_line(gaps[name])}")
        assert len(r["three_nn"]) == 2 and gaps[name]["lr_moves"] <= 2
    for i, (g, c) in enumerate(zip(card["cagq"], cpu["cagq"])):
        alike = {f: round(float((getattr(g, f) == getattr(c, f))
                                .float().mean()), 6)
                 for f in ("center_vids", "center_valid", "neighbor_idx",
                           "neighbor_mask", "node_coverage", "center_xyz",
                           "node_xyz")}
        print(f"  CAGQ layer {i} on the card vs the cpu, share alike: "
              f"{alike}; center_xyz max |diff| "
              f"{float((g.center_xyz - c.center_xyz).abs().max()):.3g}")
        assert all(alike[f] == 1.0 for f in ("center_vids", "neighbor_idx",
                                             "neighbor_mask")), alike
    for i, (g, c) in enumerate(zip(card["three_nn"], cpu["three_nn"])):
        print(three_nn_line(torch, i, g, c))
    for i, gap in enumerate(cpu["pools"]):
        pos = gap[torch.isfinite(gap)]
        print(f"  GCA layer {i} max-pool on the cpu: {pos.numel()} outputs "
              f"above 0; two largest nodes exactly tied "
              f"{int((pos == 0).sum())}, within 1e-6 relative "
              f"{int(((pos > 0) & (pos <= 1e-6)).sum())}, within 1e-5 "
              f"{int(((pos > 0) & (pos <= 1e-5)).sum())}")
    ge = gaps["exact: cpu's CAGQ and 3-NN pinned, vs float64"]
    ga = gaps["as trained"]
    assert ge["loss"] <= 1e-5 and ge["grad_norm"] <= 1e-5, ge
    assert ge["grad"] <= 1e-4 and ge["noise"] <= 2e-4, ge
    assert ge["param"] <= 1e-5 and ge["stat"] <= 1e-5, ge
    assert ge["undetermined"] <= 0.15, ge
    assert ga["loss"] <= 1e-5 and ga["grad_norm"] <= 1e-4, ga
    assert ga["grad"] <= 1e-2 and ga["noise"] <= 2e-4, ga
    assert ga["param"] <= 1e-5 and ga["stat"] <= 3e-5, ga
    assert ga["undetermined"] <= 0.7, ga


def scannet_train_config(presets):
    """scannet_seg as the trainer runs it on surface-scene labels: the
    ignore label off (scripts/convergence.py does the same)."""
    cfg = presets.get("scannet_seg")
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, ignore_label=None))


def train_crops(np, Dataset, scene_fn, n, seed):
    """A Dataset of n labelled 8192-point synthetic surface crops."""
    crops = [scene_fn(8192, seed=seed + i, return_labels=True)
             for i in range(n)]
    return Dataset(np.stack([x for x, _ in crops]),
                   np.stack([lab for _, lab in crops]), task="seg",
                   num_classes=21)


def first_train_batch(torch, cfg, ds, jaxrng, augment_batch):
    """The first training batch of the training phase, augmented with the
    first step's augmentation key: [8, 8192, 3] on the card."""
    batch = next(ds.batches(cfg.data.batch_size, seed=0))
    k_aug = jaxrng.split(jaxrng.fold_in(jaxrng.PRNGKey(0), 0), 3)[0]
    xyz, mask, _ = augment_batch(
        torch.as_tensor(batch["xyz"], device="cuda"),
        torch.as_tensor(batch["mask"], device="cuda"), k_aug, cfg.data)
    assert bool(mask.all())
    return xyz


def train_phase(torch, np, knn, cfg, ds, heldout, init_model, build_model,
                steps, jaxrng, profile):
    """scannet_seg training at full width on the card: 3 warm-up steps,
    30 timed steps (CUDA events and host wall), knn3_mxu exactly 32 launches
    per step, finite losses and gradient norms, the loss falling (mean of
    the last 5 below the first 5), every BatchNorm statistic moved; then
    one eval pass over 2 held-out batches whose confusion matrix counts
    every valid point. Returns the timed steps' median ms."""
    m = cfg.model
    assert [l.cas_iters for l in m.layers if l.sampler == "cas"] == [3, 3]
    assert m.dtype == "bfloat16" and m.bn_dtype == "float32"
    assert m.dropout == 0.5 and all(u.method == "pallas"
                                    for u in m.up_layers)
    d = cfg.data
    assert d.augment and d.rotate and d.jitter_sigma > 0 and d.shift_range
    assert cfg.train.lr_schedule == "cosine" and cfg.train.weight_decay == 0
    B = d.batch_size
    spe = ds.steps_per_epoch(B)
    assert (ds.size, B, spe) == (32, 8, 4)
    model, sd = init_model(m, torch.Generator().manual_seed(0))
    state = steps.create_train_state(cfg, model, sd, spe)
    stats0 = {k: v.clone() for k, v in state.model.state_dict().items()
              if "running" in k}
    step = steps.make_train_step(cfg)
    rng = jaxrng.PRNGKey(0)

    def batches():
        epoch = 0
        while True:
            yield from ds.batches(B, seed=epoch)
            epoch += 1

    feed = batches()
    for _ in range(3):                                   # warm-up
        state, met = step(state, next(feed), rng)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    knn.knn3_mxu.launches = 0
    knn.knn3_exact.launches = 0
    knn.mxu_pack_support.launches = 0
    losses, norms, lat, wall, per_step = [], [], [], [], []
    n_steps = 30
    for _ in range(n_steps):
        batch = next(feed)
        n0 = knn.knn3_mxu.launches
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        state, met = step(state, batch, rng)
        end.record()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        lat.append(start.elapsed_time(end))
        per_step.append(knn.knn3_mxu.launches - n0)
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    launches = {"knn3_mxu": knn.knn3_mxu.launches,
                "knn3_exact": knn.knn3_exact.launches,
                "mxu_pack_support": knn.mxu_pack_support.launches}
    print(f"train scannet_seg (CAS x3, bf16 + f32 BN, augment, dropout 0.5, "
          f"8 x 8192 pts, {n_steps} steps after 3 warm-up): ms per step "
          f"median {statistics.median(lat):.3f} (CUDA events; min "
          f"{min(lat):.3f}, max {max(lat):.3f}), host wall median "
          f"{statistics.median(wall):.3f} ms; peak memory {peak:.1f} MiB; "
          f"launches in the timed steps {launches}, knn3_mxu per step "
          f"{sorted(set(per_step))}; lr now {float(met['lr']):.6g}")
    print(f"  loss curve: {[round(x, 4) for x in losses]}")
    print(f"  grad_norm: {[round(x, 3) for x in norms]}")
    assert all(n == 4 * B for n in per_step), per_step
    assert launches["knn3_exact"] == 0
    assert launches["mxu_pack_support"] == launches["knn3_mxu"]
    assert all(np.isfinite(losses)) and all(np.isfinite(norms))
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    print(f"  mean loss of the first 5 timed steps {first:.4f}, of the "
          f"last 5 {last:.4f}")
    assert last < first, (first, last)
    now = state.model.state_dict()
    unmoved = [k for k, v in stats0.items() if torch.equal(v, now[k])]
    assert not unmoved, unmoved
    print(f"  all {len(stats0)} BatchNorm running statistics moved")

    evaluate = steps.make_eval_step(cfg)
    cm = None
    for batch in heldout.batches(B, seed=0, shuffle=False):
        out = evaluate(state, batch, rng)
        cm = out if cm is None else cm + out
    total = int(cm.sum())
    acc = float(cm.diagonal().sum()) / total
    print(f"  eval over {heldout.size // B} held-out batches: confusion "
          f"matrix counts {total} points (expected "
          f"{heldout.size * d.num_points}), overall accuracy {acc:.4f}")
    assert total == heldout.size * d.num_points
    if profile:
        profile_train_step(torch, step, state, next(feed), rng,
                           statistics.median(lat))
    return statistics.median(lat)


def profile_train_step(torch, step, state, batch, rng, latency_ms):
    _, wall, busy, kernels = profiled(torch, "train_step",
                                      lambda: step(state, batch, rng))
    print(f"profile: one training step {wall:.3f} ms wall under the "
          f"profiler, device busy {busy:.3f} ms; idle share "
          f"{1 - busy / latency_ms:.3f} of the unprofiled {latency_ms:.3f} "
          f"ms step; {kernels} device launches per step")


def counting(module, name, knn, calls, extract):
    """Wrap module.<name> (a step factory) so that each step it makes
    records (knn3_mxu launches during the call, extract(output)) in
    calls."""
    make = getattr(module, name)

    def factory(*a, **k):
        step = make(*a, **k)

        def run(*b):
            n0 = knn.knn3_mxu.launches
            out = step(*b)
            calls.append((knn.knn3_mxu.launches - n0, extract(out)))
            return out
        return run

    setattr(module, name, factory)
    return make


def jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def cli_phase(torch, np, knn, presets, card, bare_ms):
    """The trainer and evaluator CLIs on scannet_seg at full width (8 crops
    of 8192 points, CAS x3, bf16 with f32 BatchNorm, augmentation,
    dropout 0.5), on the hermetic fallback split (64 train and 32 test
    crops, 8 steps an epoch). Gates: the JSONL records in order, finite
    losses, knn3_mxu exactly 32 launches per train step and 4 per cloud of
    each eval batch, each eval's confusion matrix counting every point
    whose label is not the ignore label; the step-16 checkpoint restored
    into a fresh state bit for bit; a resumed run (step-16 file deleted)
    restoring step 8 and ending at step 16 within Adam's bound of the
    uninterrupted run; evaluate with --latency, the whole-scene eval with
    2 votes, the evaluator CLI and `train --mesh 1` (one NCCL rank, one
    epoch) in subprocesses; load_predictor's logits bit for bit those of
    a Predictor on the live state_dict."""
    import os
    import shutil

    from gridgcn_torch.api import Predictor, load_predictor
    from gridgcn_torch.configs.base import apply_overrides
    from gridgcn_torch.data.pipeline import make_dataset
    from gridgcn_torch.models.build import init_model
    from gridgcn_torch.train import evaluate as ev_mod
    from gridgcn_torch.train import steps
    from gridgcn_torch.train import train as train_mod
    from gridgcn_torch.utils import jaxrng
    from gridgcn_torch.utils.checkpoint import CheckpointManager

    work = os.path.abspath(os.path.join("build", "chip_smoke_cli"))
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    ck = os.path.join(work, "ck")
    # the JSONL records go to files; their stdout copies to this sink
    sink = open(os.path.join(work, "stdout"), "w")

    def quiet():
        return contextlib.redirect_stdout(sink)

    cfg = apply_overrides(presets.get("scannet_seg"), {
        "train.epochs": 2, "train.eval_every": 1, "train.ckpt_every": 1,
        "train.log_every": 1, "train.ckpt_dir": ck})
    m, d = cfg.model, cfg.data
    assert [l.cas_iters for l in m.layers if l.sampler == "cas"] == [3, 3]
    assert (d.num_points, d.batch_size, d.eval_batch_size) == (8192, 8, 16)
    B, EB, N = d.batch_size, d.eval_batch_size, d.num_points
    val = make_dataset(d, "test", m.num_classes, m.task)
    assert (val.size, make_dataset(d, "train", m.num_classes,
                                   m.task).size) == (32, 64)
    scored = int((val.labels != m.ignore_label).sum())

    train_calls, eval_calls = [], []
    orig = (counting(train_mod, "make_train_step", knn, train_calls,
                     lambda out: float(out[1]["loss"])),
            counting(train_mod, "make_eval_step", knn, eval_calls,
                     lambda cm: int(cm.sum())))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    log1 = os.path.join(work, "train.jsonl")
    with quiet():
        live = train_mod.train(cfg, log_path=log1)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    recs = jsonl(log1)
    kinds = [r["kind"] for r in recs]
    epoch_kinds = ["train_step"] * 8 + ["epoch", "eval"]
    assert kinds == ["config", "capacity"] + 2 * epoch_kinds, kinds
    losses = [r["loss"] for r in recs if r["kind"] == "train_step"]
    assert len(losses) == 16 and all(np.isfinite(losses)), losses
    assert [n for n, _ in train_calls] == [4 * B] * 16, train_calls
    assert [n for n, _ in eval_calls] == [4 * EB] * 4, eval_calls
    totals = [sum(t for _, t in eval_calls[i:i + 2]) for i in (0, 2)]
    assert totals == [scored, scored], (totals, scored)
    epochs = [r for r in recs if r["kind"] == "epoch"]
    ms = [B * N / r["points_per_sec"] * 1e3 for r in epochs]
    evals = [r for r in recs if r["kind"] == "eval"]
    print(f"cli train scannet_seg (2 epochs x 8 steps, eval each epoch on "
          f"32 crops): records {len(recs)} in order; knn3_mxu launches "
          f"per train step {sorted({n for n, _ in train_calls})}, per eval "
          f"batch of {EB} {sorted({n for n, _ in eval_calls})}; eval "
          f"confusion totals {totals} (labels != ignore_label: {scored}); "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}; eval overall_acc "
          f"{[round(r['overall_acc'], 4) for r in evals]}")

    # restore: the step-16 checkpoint into a fresh state, bit for bit
    mgr = CheckpointManager(ck, cfg)
    assert mgr.steps() == [8, 16], mgr.steps()
    model, sd = init_model(m, torch.Generator().manual_seed(1))
    fresh = steps.create_train_state(cfg, model, sd, 8)
    out = mgr.restore(fresh)
    live_sd, fresh_sd = live.model.state_dict(), fresh.model.state_dict()
    assert all(torch.equal(live_sd[k], fresh_sd[k]) for k in live_sd)
    assert all(torch.equal(a, b) for a, b in zip(
        live.tx.mu + live.tx.nu, fresh.tx.mu + fresh.tx.nu))
    assert fresh.step == live.step == 16
    assert np.array_equal(out["rng"], jaxrng.PRNGKey(cfg.train.seed))
    print(f"cli restore: step 16 into a fresh state: {len(live_sd)} "
          f"state_dict tensors, {2 * len(live.tx.mu)} Adam moments, count "
          f"and key equal bit for bit")

    # resume: delete the newest file, train again with the same config
    os.remove(os.path.join(ck, "ckpt-16.pt"))
    log2 = os.path.join(work, "resume.jsonl")
    with quiet():
        resumed = train_mod.train(cfg, log_path=log2)
    for name, f in zip(("make_train_step", "make_eval_step"), orig):
        setattr(train_mod, name, f)
    rec2 = jsonl(log2)
    assert [r["kind"] for r in rec2] == ["config", "capacity", "restore"] \
        + epoch_kinds, [r["kind"] for r in rec2]
    assert rec2[2]["step"] == 8 and rec2[2]["epoch"] == 1
    assert resumed.step == 16
    again = [r["loss"] for r in rec2 if r["kind"] == "train_step"]
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(again, losses[8:]))
    res_sd = resumed.model.state_dict()
    param_gap = max(float((res_sd[k] - live_sd[k]).abs().max())
                    for k, _ in resumed.model.named_parameters())
    stat_gap = max(float(((res_sd[k] - live_sd[k]).abs()
                          / live_sd[k].abs().clamp_min(1e-3)).max())
                   for k in res_sd if "running" in k)
    adam_bound = 8 * 3.2 * cfg.train.lr
    print(f"cli resume: restored step 8, ended at step 16; against the "
          f"uninterrupted run (0 would be bit for bit): epoch-2 losses "
          f"within {loss_gap:.3e} relative "
          f"(gate 5e-2), parameters within {param_gap:.3e} (gate: Adam's "
          f"bound over 8 steps, {adam_bound:.4g}), BatchNorm statistics "
          f"within {stat_gap:.3e} relative")
    assert loss_gap <= 5e-2 and param_gap <= adam_bound

    # evaluate: the crop eval with --latency, the whole-scene eval
    lg = os.path.join(work, "eval.jsonl")
    with quiet():
        ev_mod.evaluate(ck, latency=True, log_path=lg)
    lat = [r for r in jsonl(lg) if r["kind"] == "latency"]
    assert len(lat) == 1 and lat[0]["batch_ms"] > 0
    ws_totals = []
    cm_fn = ev_mod.confusion_matrix

    def counted(*a, **k):
        cm = cm_fn(*a, **k)
        ws_totals.append(int(cm.sum()))
        return cm

    ev_mod.confusion_matrix = counted
    lw = os.path.join(work, "whole.jsonl")
    n0 = knn.knn3_mxu.launches
    with quiet():
        s = ev_mod.evaluate_whole_scenes(ck, votes=2, log_path=lw)
    ev_mod.confusion_matrix = cm_fn
    ws_launches = knn.knn3_mxu.launches - n0
    assert "voxel_acc" in s and 0 <= float(s["voxel_acc"]) <= 1
    assert sum(ws_totals) == scored, (sum(ws_totals), scored)
    assert ws_launches == 4 * 2 * val.size, ws_launches
    whole = jsonl(lw)[-1]
    print(f"cli evaluate: batch_ms {lat[0]['batch_ms']} (CUDA events, "
          f"{EB} x {N} points, 20 iterations after 2 warm-up), "
          f"points_per_sec {lat[0]['points_per_sec']:.1f}; whole-scene "
          f"votes=2 over {val.size} scenes: voxel_acc "
          f"{whole['voxel_acc']:.4f}, overall_acc {whole['overall_acc']:.4f},"
          f" confusion total {sum(ws_totals)}, knn3_mxu launches "
          f"{ws_launches}")

    # the CLIs as a user runs them, in their own processes
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "gridgcn_torch.train.evaluate", "--ckpt-dir",
         ck, "--whole-scene", "--votes", "1"], capture_output=True,
        text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    last = json.loads(proc.stdout.strip().splitlines()[-1])
    assert last["kind"] == "whole_scene_eval" and last["votes"] == 1, last
    cli_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    lm = os.path.join(work, "mesh1.jsonl")
    proc = subprocess.run(
        [sys.executable, "-m", "gridgcn_torch.train.train", "--preset",
         "scannet_seg", "--mesh", "1", "--log", lm, "train.epochs=1",
         "train.eval_every=0", "train.log_every=1",
         f"train.ckpt_dir={os.path.join(work, 'mesh1')}"],
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    mrec = jsonl(lm)
    assert [r["kind"] for r in mrec] == ["config", "capacity"] + [
        "train_step"] * 8 + ["epoch"], [r["kind"] for r in mrec]
    assert all(np.isfinite(r["loss"]) for r in mrec[2:])
    mesh_s = time.perf_counter() - t0
    print(f"cli subprocess: evaluate --whole-scene --votes 1 exit 0 in "
          f"{cli_s:.1f} s, last line a whole_scene_eval record "
          f"(voxel_acc {last['voxel_acc']:.4f}); train --mesh 1 (NCCL, one "
          f"epoch of 8 steps) exit 0 in {mesh_s:.1f} s, losses "
          f"{mrec[2]['loss']:.4f} -> {mrec[-2]['loss']:.4f}")

    # serve the checkpoint
    pred = load_predictor(ck)
    want = Predictor(cfg, res_sd)
    xyz = val.points[0]
    key = jaxrng.PRNGKey(5)
    assert pred.step == 16
    assert np.array_equal(pred(xyz, rng=key), want(xyz, rng=key))
    print("cli serve: load_predictor(step 16) logits on one crop bit for "
          "bit those of Predictor(cfg, live state_dict)")
    print(f"cli numbers [{card}]: ms per step (epoch wall / 8 steps) "
          f"{[round(x, 3) for x in ms]}, points_per_sec "
          f"{[round(r['points_per_sec'], 1) for r in epochs]}; bare step "
          f"loop median {bare_ms:.3f} ms (training phase, CUDA events); "
          f"peak memory {peak:.1f} MiB")
    sink.close()
    return ms


@contextlib.contextmanager
def phase(name):
    """Print the phase's seconds when it ends."""
    t0 = time.perf_counter()
    yield
    print(f"phase {name}: {time.perf_counter() - t0:.1f} s")


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def fullsize_ref_phase(torch, np, knn, presets, Predictor, scene_fn, jaxrng):
    """The full-size JAX reference (gridgcn_torch/testdata/fullsize_ref.npz,
    scripts/dump_torch_fullsize_ref.py): scannet_whole_scene on the
    81920-point scene of seed 7, the numpy-seeded weights (their SHA-256
    checked first). Gates: each encoder layer's CAGQ on the card, on the
    reference's own level, bit for bit; the served forward's logits on the
    file's 4096-point subset within 10% of the range, argmax >= 0.98.
    Printed: the decoder's knn3_mxu on the reference's levels against the
    exact dense 3-NN (top-1 agreement), and the served forward's own chain
    of CAGQ layers against the reference's."""
    from gridgcn_torch.models.build import numpy_state_dict, \
        state_dict_digests
    from gridgcn_torch.ops.cagq import cagq

    ref = dict(np.load("gridgcn_torch/testdata/fullsize_ref.npz"))
    cfg = presets.get("scannet_whole_scene")
    sd = numpy_state_dict(cfg.model, 0)
    want = {k[len("digest/"):]: str(v) for k, v in ref.items()
            if k.startswith("digest/")}
    if state_dict_digests(sd) != want:
        raise RuntimeError("the numpy-seeded weights differ from the "
                           "reference's (SHA-256)")
    xyz = scene_fn(81920, seed=7)
    key = jaxrng.PRNGKey(0)
    pred = Predictor(cfg, sd, device="cuda")
    served = []
    with cagq_record(torch, served):
        logits = pred(xyz, rng=key)
    levels = [(xyz, np.ones(81920, bool))] + [
        (ref[f"enc{i}_center_xyz"], ref[f"enc{i}_center_valid"])
        for i in range(4)]
    chain = []
    for i, spec in enumerate(cfg.model.layers):
        x, m = (torch.as_tensor(a[None], device="cuda") for a in levels[i])
        g = cagq(x, m, spec, jaxrng.flax_make_rng(
            key, (f"gridconv{i}",), 1)).groups
        for f in ("center_vids", "center_valid", "neighbor_idx",
                  "neighbor_mask"):
            got = getattr(g, f)[0].cpu().numpy()
            assert np.array_equal(got.astype(ref[f"enc{i}_{f}"].dtype),
                                  ref[f"enc{i}_{f}"]), (i, f)
        chain.append(float((served[i].center_vids[0].numpy()
                            == ref[f"enc{i}_center_vids"]).mean()))
    top1 = []
    for s in range(4):
        (dx, dm), (cx, cm) = levels[3 - s], levels[4 - s]
        q = torch.as_tensor(dx, device="cuda")
        _, idx, _ = knn.knn3_mxu(
            q, torch.as_tensor(dm, device="cuda"),
            torch.as_tensor(cx, device="cuda"),
            torch.as_tensor(cm, device="cuda"))
        idx = idx.cpu().numpy()
        top1.append(round(float((idx[dm, 0] == ref[f"dec{s}_idx"][dm, 0])
                                .mean()), 5))
    sub, want_l = ref["subset"], ref["logits"].astype(np.float32)
    got_l = logits[sub]
    span = float(np.ptp(want_l))
    dmax = float(np.abs(got_l - want_l).max())
    arg = float((got_l.argmax(-1) == want_l.argmax(-1)).mean())
    print(f"fullsize ref scannet_whole_scene (81920 points, seed 7, numpy "
          f"weights, digests equal): each layer's CAGQ on the reference's "
          f"level bit for bit (4 layers); served chain's center voxels "
          f"alike {[round(c, 5) for c in chain]}; decoder knn3_mxu top-1 "
          f"vs the exact dense 3-NN on the reference's levels {top1}; "
          f"bf16 logits on 4096 points max |diff| {dmax:.4g} = "
          f"{dmax / span:.4f} of the range {span:.4g}, argmax alike {arg:.5f}")
    assert chain[0] == 1.0, chain
    assert dmax <= 0.1 * span and arg >= 0.98, (dmax, span, arg)
    return pred, xyz


def tf32_phase(torch, np, pred, xyz, jaxrng):
    """A caller's TF32 flags set to True survive a Predictor call, and the
    call's logits are those of a call with the flags False."""
    mm, cd = torch.backends.cuda.matmul, torch.backends.cudnn
    key = jaxrng.PRNGKey(3)
    base = pred(xyz, rng=key)
    mm.allow_tf32 = cd.allow_tf32 = True
    try:
        out = pred(xyz, rng=key)
        kept = (mm.allow_tf32, cd.allow_tf32)
    finally:
        mm.allow_tf32 = cd.allow_tf32 = False
    print(f"tf32: the caller's flags (True, True) after a Predictor call: "
          f"{kept}; logits equal to a call with TF32 off: "
          f"{np.array_equal(out, base)}")
    assert kept == (True, True) and np.array_equal(out, base)


def fps_phase(torch, np, presets, jaxrng, card):
    """FPS + ball query (ops/fps.py, plain torch) against layer 0's CAGQ at
    bench.py's cagq_vs_fps row: [1, 81920] points uniform in [0, 6)^3
    (jaxrng PRNGKey(0)) -> 8192 centers, K = 32, radius 0.1."""
    from gridgcn_torch.ops.cagq import cagq
    from gridgcn_torch.ops.fps import ball_query, farthest_point_sampling

    spec = presets.get("scannet_whole_scene").model.layers[0]
    N, M, K = 81920, spec.n_centers, spec.k_neighbors
    key = jaxrng.PRNGKey(0)
    xyz = jaxrng.uniform(key, (1, N, 3), "cuda", minval=0.0, maxval=6.0)
    mask = torch.ones((1, N), dtype=torch.bool, device="cuda")

    def run_cagq():
        return cagq(xyz, mask, spec, key).groups.neighbor_idx.sum()

    def run_fps():
        idx = farthest_point_sampling(xyz, mask, M, key).long()
        centers = torch.take_along_dim(xyz, idx[..., None], dim=1)
        return ball_query(xyz, mask, centers, 0.1, K)[0].sum()

    cagq_ms = cuda_ms(torch, run_cagq, 10)
    fps_ms = cuda_ms(torch, run_fps, 2, warmup=1)
    idx = farthest_point_sampling(xyz, mask, M, key)
    assert idx.shape == (1, M) and len(torch.unique(idx)) == M
    print(f"fps [{card}]: layer-0 CAGQ {cagq_ms:.3f} ms, FPS + ball query "
          f"{fps_ms:.3f} ms ({fps_ms / cagq_ms:.1f}x) at [1, {N}] -> {M} "
          f"centers, K {K} (CUDA events; FPS is {M} dependent steps of "
          f"plain torch)")


_EXPORT_CHILD = """
import sys, numpy as np
from gridgcn_torch.export import load_exported
from gridgcn_torch.kernels import knn
path, inp, out = sys.argv[1:4]
frozen = load_exported(path)
xyz = np.load(inp)
res, launches = [], []
for seed in (0, 1):
    n0 = knn.knn3_mxu.launches
    res.append(frozen(xyz, rng=np.array([0, seed], np.uint32)))
    launches.append(knn.knn3_mxu.launches - n0)
np.savez(out, logits=np.stack(res), launches=np.array(launches))
"""


def export_phase(torch, np, knn, presets, Predictor, pred, xyz, jaxrng):
    """export_predictor of scannet_whole_scene's folded forward at
    [1, 81920] on the card (the numpy-seeded weights, written as a step-0
    checkpoint), loaded in a fresh process and run under two keys there:
    each call's logits against the live Predictor under the same key
    (|diff| within 1e-5 of the range), knn3_mxu 4 launches per call inside
    the program, the two keys' logits differing."""
    import os
    import shutil

    from gridgcn_torch.export import export_predictor
    from gridgcn_torch.models.build import build_model, numpy_state_dict
    from gridgcn_torch.train import steps
    from gridgcn_torch.utils.checkpoint import CheckpointManager

    work = os.path.abspath(os.path.join("build", "chip_smoke_export"))
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    cfg = presets.get("scannet_whole_scene")
    sd = numpy_state_dict(cfg.model, 0)
    state = steps.create_train_state(cfg, build_model(cfg.model), sd, 1,
                                     device="cuda")
    CheckpointManager(os.path.join(work, "ck"), cfg).save(
        0, state, jaxrng.PRNGKey(0))
    path = os.path.join(work, "whole_scene.pt2")
    t0 = time.perf_counter()
    meta = export_predictor(os.path.join(work, "ck"), path, batch_size=1,
                            num_points=81920, device="cuda")
    export_s = time.perf_counter() - t0
    np.save(os.path.join(work, "xyz.npy"), xyz)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", _EXPORT_CHILD, path,
         os.path.join(work, "xyz.npy"), os.path.join(work, "out.npz")],
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    child_s = time.perf_counter() - t0
    got = np.load(os.path.join(work, "out.npz"))
    live = [pred(xyz, rng=np.array([0, s], np.uint32)) for s in (0, 1)]
    rows = []
    for g, w in zip(got["logits"], live):             # [81920, 21] each
        span = float(np.ptp(w))
        rows.append((float(np.abs(g - w).max()) / span,
                     float((g.argmax(-1) == w.argmax(-1)).mean())))
    keys_differ = float(np.abs(live[0] - live[1]).max())
    print(f"export scannet_whole_scene [1, 81920] on the card: traced and "
          f"saved in {export_s:.1f} s ({meta['bytes']} bytes, platforms "
          f"{meta['platforms']}); a fresh process loaded and ran it under "
          f"2 keys in {child_s:.1f} s; knn3_mxu launches per call "
          f"{got['launches'].tolist()}; against the live Predictor "
          f"(|diff| / range, argmax alike) {rows}; the two keys' logits "
          f"differ by up to {keys_differ:.4g}")
    assert got["launches"].tolist() == [4, 4]
    assert all(d <= 1e-5 for d, _ in rows), rows
    assert keys_differ > 0


def trace_cost_phase(torch, knn, pred, xyz):
    """The whole-scene request traced and priced with the port's tools:
    10 pred(xyz) requests (the export phase's live Predictor and
    scene) under utils.profiling.trace into build/chip_smoke_trace/, read
    by utils.traceview (per-kernel exclusive time, busy ms) beside a
    CUDA-events latency of the same requests; the export phase's artifact
    (the same folded forward at [1, 81920], the same weights) loaded and
    priced by utils.hlocost (touched bytes, gather rows, flops, the bytes
    floor). Gates: device events in the trace; no outer-dim scan kernel
    (`scan_outer_dim`) in it; knn3_mxu's kernel 4 times a request in it
    (the requests replay one capture), and among the report's rows; the
    trace's busy time within 2% of the profiler's summed device self time
    (one stream); exactly 4 gridgcn.knn3_mxu custom-call rows in the
    graph; 0 < floor / busy <= 1."""
    import collections
    import os
    import shutil

    from torch.autograd import DeviceType

    from gridgcn_torch.utils import hlocost, profiling, traceview

    path = os.path.join("build", "chip_smoke_export", "whole_scene.pt2")
    assert os.path.exists(path), f"no export artifact at {path}"
    logdir = os.path.join("build", "chip_smoke_trace")
    shutil.rmtree(logdir, ignore_errors=True)
    iters = 10
    pred(xyz)
    with profiling.trace(logdir) as prof:
        for _ in range(iters):
            pred(xyz)
        torch.cuda.synchronize()
    with open(os.path.join(logdir, "trace.json")) as f:
        cats = collections.Counter(e.get("cat") for e in
                                   json.load(f)["traceEvents"]
                                   if e.get("ph") == "X")
    print(f"trace: {iters} whole-scene requests, complete events by "
          f"category {dict(cats)}; counted as device work "
          f"{list(traceview.DEVICE_CATEGORIES)}")
    devices = traceview.load_events(logdir)
    assert devices, "the trace holds no device events"
    # the requests replay one capture: the kernels that ran, from the trace
    launched = sum("knn3_mxu_kernel" in n for ev in devices.values()
                   for _, _, n in ev)
    rep = traceview.report(logdir, iters=iters, topn=40)
    print(rep)
    busy = profiling.busy_ms_per_iter(logdir, iters)
    # the spans' device-side copies run from their first kernel to their
    # last, idle gaps included: not work (as traceview.DEVICE_CATEGORIES)
    prof_busy = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA
                    and not getattr(e, "is_user_annotation", False)
                    ) / 1e3 / iters
    latency = profiling.steady_state_time(pred, xyz, warmup=1,
                                          iters=iters) * 1e3
    print(f"trace: busy {busy:.4f} ms per request (traceview, "
          f"{sorted(devices)}), profiler device self time {prof_busy:.4f} "
          f"ms; CUDA-events latency {latency:.4f} ms per request; idle share "
          f"{1 - busy / latency:.4f}; knn3_mxu kernels in the trace "
          f"{launched}")
    # the voxel tables' prefix sums: a last-dim scan, never the outer-dim
    # scan that gives each column one thread
    scans = {n: round(ms, 4) for n, ms in
             traceview.exclusive_ms(logdir, iters).items() if "scan" in n}
    print(f"trace: scan kernels, exclusive ms per request {scans}")

    program = torch.export.load(path)
    rows = hlocost.attribute(program)
    cls = hlocost.class_totals(rows)
    fl = hlocost.floor_ms(rows)
    mxu = [r for r in rows if r["class"] == "custom-call"
           and r["opcode"] == "gridgcn.knn3_mxu"]
    floor_frac = fl["floor_ms"] / busy
    tiny = [r for r in rows if r["out_bytes"] <= 64]
    print(f"hlocost whole_scene.pt2: {len(rows)} launching nodes; by class "
          f"{cls}")
    print(f"hlocost: touched {fl['touched_bytes']} B (dense "
          f"{sum(r['bytes'] for r in rows)} B), gather Mrows "
          f"{cls.get('gather', {}).get('rows', 0) / 1e6:.6f}, flops "
          f"{fl['flops']} (flops_ms {fl['flops_ms']:.6f}); floor_ms "
          f"{fl['floor_ms']:.6f} (bw_ms {fl['bw_ms']:.6f}, row_ms "
          f"{fl['row_ms']}); floor_frac {floor_frac:.6f} of the traced busy "
          f"ms; achieved {fl['flops'] / busy / 1e9:.4f} TFLOP/s; nodes of "
          f"<= 64 output bytes (the key's words, derived on the device in "
          f"the program and in the live Predictor's replay) {len(tiny)}, "
          f"{sum(r['touched'] for r in tiny)} B; top rows "
          f"by touched bytes "
          f"{[(r['name'], r['opcode'], r['touched']) for r in rows[:5]]}; "
          f"knn3_mxu rows {[(r['name'], r['flops']) for r in mxu]}")
    assert launched == 4 * iters, launched
    assert scans and not any("scan_outer_dim" in n for n in scans), scans
    assert any("knn3_mxu_kernel" in line
               for line in rep.splitlines()[1:]), rep
    assert abs(busy - prof_busy) <= 0.02 * prof_busy, (busy, prof_busy)
    assert len(mxu) == 4, mxu
    assert 0 < floor_frac <= 1, floor_frac


def _trace_repeat_worker(root: str) -> None:
    """trace_repeat_phase's one process: 3 traces of 10 whole-scene
    requests (scannet_whole_scene, seeded weights, the 81920-point scene
    of seed 7), then 6 of the two-kernel call, each through
    utils.profiling.trace; one JSON line per trace on stdout (its device
    events, the kernel launches without their kernel record, and what
    busy_ms_per_iter read: a busy time, or its refusal), and a `MARK
    <name>` line on stderr after each, which lines up torch's profiler
    log with the trace."""
    import os

    import torch

    from gridgcn_torch.api import Predictor
    from gridgcn_torch.configs import presets
    from gridgcn_torch.data.synthetic import synthetic_scene_surface
    from gridgcn_torch.kernels import knn
    from gridgcn_torch.models.build import init_model
    from gridgcn_torch.utils import profiling, traceview

    cfg = presets.scannet_whole_scene()
    _, sd = init_model(cfg.model, torch.Generator().manual_seed(0))
    # eager: these traces study the profiler's records of kernels that the
    # host launched one by one (a replay launches a few graphs)
    pred = Predictor(cfg, sd, device="cuda", graphs=False)
    xyz = synthetic_scene_surface(81920, seed=7)
    call = two_kernel_call(torch, knn)
    pred(xyz)
    call()
    torch.cuda.synchronize()
    runs = [(f"whole_scene{i}", 10, lambda: pred(xyz)) for i in range(3)]
    runs += [(f"two_kernel{i}", 1, call) for i in range(6)]
    for name, iters, fn in runs:
        d = os.path.join(root, name)
        with profiling.trace(d):
            for _ in range(iters):
                fn()
        lost, launches = traceview.lost_records(d)
        events = sum(len(e) for e in traceview.load_events(d).values())
        try:
            read = profiling.busy_ms_per_iter(d, iters)
        except RuntimeError as e:
            read = f"refused: {e}"
        print(json.dumps({"trace": name, "iters": iters, "events": events,
                          "lost": lost, "launches": launches,
                          "read": read}), flush=True)
        print(f"MARK {name}", file=sys.stderr, flush=True)


def two_kernel_call(torch, knn):
    """A call of two small kernels: knn3_mxu at 512x128 (its support pack
    and its kernel) and one torch.add."""
    g = torch.Generator().manual_seed(0)
    q = torch.rand((512, 3), generator=g).cuda()
    s = torch.rand((128, 3), generator=g).cuda()
    qm = torch.ones(512, dtype=torch.bool, device="cuda")
    sm = torch.ones(128, dtype=torch.bool, device="cuda")
    a = torch.ones(1000, device="cuda")

    def call():
        knn.knn3_mxu(q, qm, s, sm)
        torch.add(a, a)
    return call


def trace_repeat_phase():
    """Many traces in one process, as a benchmark would take them
    (`_trace_repeat_worker`, in a process of its own with torch's
    profiler logging at KINETO_LOG_LEVEL=0): each trace's device events,
    the launches whose device record it lost (`traceview.lost_records`)
    and the profiler's own count of device records it dropped as out of
    the trace's window (its `Record counts: Out-of-range = N` line) are
    printed. Then the two-kernel call traced in 3 fresh processes, side
    by side.
    Gates: busy_ms_per_iter reads a trace only when it is complete, and
    refuses it otherwise; in a fresh process each trace holds its 3
    kernels (the support pack, knn3_mxu, the add), loses none, and reads
    a busy time."""
    import os
    import shutil

    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.join("build", "chip_smoke_trace_repeat")
    shutil.rmtree(root, ignore_errors=True)
    res = subprocess.run(
        [sys.executable, "-c", "import chip_smoke\n"
         f"chip_smoke._trace_repeat_worker({root!r})"],
        cwd=here, capture_output=True, text=True, timeout=600,
        env={**os.environ, "KINETO_LOG_LEVEL": "0"})
    assert res.returncode == 0, res.stderr[-4000:]
    out_of_range, pending = {}, None
    for line in res.stderr.splitlines():
        m = re.search(r"Out-of-range = (\d+)", line)
        if m:
            pending = int(m[1])
        elif line.startswith("MARK "):
            out_of_range[line[5:]] = pending
            pending = None
    rows = [json.loads(line) for line in res.stdout.splitlines()
            if line.startswith("{")]
    assert len(rows) == 9, res.stdout[-2000:]
    for r in rows:
        read = r["read"]
        print(f"trace repeat: one process, {r['trace']} ({r['iters']} "
              f"calls): {r['events']} device events, {r['lost']} of "
              f"{r['launches']} kernel launches without their record, the "
              f"profiler's out-of-range records "
              f"{out_of_range.get(r['trace'])}; read "
              + (f"busy {read:.4f} ms per call" if isinstance(read, float)
                 else read))
        complete = r["events"] > 0 and r["lost"] == 0
        assert isinstance(read, float) == complete, r
    procs = []
    for i in range(3):
        d = os.path.join(root, f"fresh{i}")
        code = (
            "import json, torch\n"
            "import chip_smoke\n"
            "from gridgcn_torch.kernels import knn\n"
            "from gridgcn_torch.utils import profiling, traceview\n"
            "call = chip_smoke.two_kernel_call(torch, knn)\n"
            "call()\n"
            "torch.cuda.synchronize()\n"
            f"with profiling.trace({d!r}):\n"
            "    call()\n"
            f"busy = profiling.busy_ms_per_iter({d!r}, 1)\n"
            "print(json.dumps({'busy': busy, 'lost': traceview.lost_records("
            f"{d!r}), 'names': [e[2] for evs in traceview.load_events("
            f"{d!r}).values() for e in evs]}}))\n")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code], cwd=here, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    for i, proc in enumerate(procs):
        stdout, stderr = proc.communicate(timeout=300)
        assert proc.returncode == 0, stderr[-4000:]
        out = json.loads(stdout.strip().splitlines()[-1])
        print(f"trace repeat: fresh process {i}: two-kernel call "
              f"{[n[:40] for n in out['names']]}, kernel launches without "
              f"their record {out['lost'][0]} of {out['lost'][1]}, busy "
              f"{out['busy']:.4f} ms")
        got = out["names"]
        assert len(got) == 3 and out["lost"][0] == 0, out
        assert sum("mxu_pack_kernel" in n for n in got) == 1, got
        assert sum("knn3_mxu_kernel" in n for n in got) == 1, got
        assert out["busy"] > 0, out


def tier_studies_phase(card):
    """The tier studies on the card, each in its own process at 5 calls a
    timing: scripts/study_tier2_compute_torch.py (tier 2's replicated
    share R/C of the whole-scene forward, busy ms from traces) and
    scripts/study_tier3_fixed_overhead_torch.py (tier 3 at world 1 against
    the unsharded forward, per-kernel Δ); a study whose trace was refused
    runs again, twice at most. Gates: each script exits 0
    (every trace holds device events: busy_ms_per_iter raises otherwise);
    0 < R/C < 1; C >= E0 + R - 5% of C; knn3_mxu launched 4 times per
    full forward under the trace; both tier-3 runs busy. Returns the
    measured R/C, the comm audit's tier-2 anchor."""
    import os

    here = os.path.dirname(os.path.abspath(__file__))
    lines = {}
    for script, tag, extra in (
            ("study_tier2_compute_torch.py", "TIER2_COMPUTE", []),
            ("study_tier3_fixed_overhead_torch.py", "TIER3_OVERHEAD",
             ["--topn", "15"])):
        t0 = time.perf_counter()
        # a trace that lost device records is refused (busy_ms_per_iter
        # raises) and the study taken again in a fresh process, twice at
        # most: each study traces 2-3 times in one process, and a later
        # trace can lose records there (PERF.md §7)
        for attempt in range(3):
            res = subprocess.run(
                [sys.executable, os.path.join(here, "scripts", script),
                 "--iters", "5", "--trace-dir",
                 os.path.join("build", f"chip_smoke_{tag.lower()}"),
                 *extra],
                cwd=here, capture_output=True, text=True, timeout=600)
            refused = re.search(r"RuntimeError: (the trace under .*)",
                                res.stderr)
            if res.returncode == 0 or not refused or attempt == 2:
                break
            print(f"  {script}: {refused[1]}; taken again")
        assert res.returncode == 0, (script, res.stdout[-2000:],
                                     res.stderr[-4000:])
        out = res.stdout.splitlines()
        for line in out:
            if line.strip() and not line.startswith(tag + " "):
                print(f"  {script}: {line}")
        lines[tag] = json.loads([line for line in out
                                 if line.startswith(tag + " ")][-1]
                                .split(" ", 1)[1])
        print(f"{tag} {json.dumps(lines[tag])}")
        print(f"tier studies: {script} {time.perf_counter() - t0:.1f} s")
    t2, t3 = lines["TIER2_COMPUTE"], lines["TIER3_OVERHEAD"]
    C, R, E0 = (t2[k] for k in ("full_busy_ms", "replicated_busy_ms",
                                "enc0_busy_ms"))
    assert all(v is not None and v > 0 for v in (C, R, E0)), t2
    frac = R / C
    print(f"tier studies ({card}): tier 2 busy ms per call C {C}, R {R}, "
          f"E0 {E0}; R/C {frac:.6f} measured, the byte model's "
          f"{t2['model_replicated_frac']} (kNN ms per stage "
          f"{t2['model_knn_ms']}); C - E0 - R {C - E0 - R:.4f} ms; wall "
          f"{t2['wall_ms']}; knn3_mxu launches per full forward "
          f"{t2['knn3_mxu_launches_per_full']}")
    print(f"tier studies ({card}): tier 3 at world 1, caps {t3['caps']}: "
          f"busy {t3['tier3_busy_ms']} ms against {t3['plain_busy_ms']} "
          f"unsharded (diff {t3['diff_ms']}), wall {t3['tier3_wall_ms']} "
          f"against {t3['plain_wall_ms']}; ghost overflow "
          f"{t3['ghost_overflow']}")
    assert 0 < frac < 1, frac
    assert C - E0 - R >= -0.05 * C, (C, E0, R)
    assert t2["knn3_mxu_launches_per_full"] == 4, t2
    assert t3["plain_busy_ms"] > 0 and t3["tier3_busy_ms"] > 0, t3
    return frac


# scripts/study_tier3_fixed_overhead_torch.py on the same scene (caps
# share/8) measured busy +9.2% over the unsharded forward on the H100
# (8.0145 / 7.3392 ms, 8.0170 / 7.3330); the mesh-1 study's share/8
# point must land within this many points of it
TIER3_SHARE8_OVERHEAD = 0.092
TIER3_SHARE8_BAND = 0.05


def mesh1_study_phase(card):
    """scripts/study_mesh1_overhead_torch.py on the card at 5 calls a
    timing on scannet_whole_scene: eval --ghost-sweep, then --train
    --ghost-sweep (the variants traced in fresh processes, a few a
    process). Gates: both runs exit 0 with busy values (a trace that lost
    device records is refused and retaken; the retakes printed); 4 sweep
    points per fit; no ghost overflow; knn3_mxu launched 4 times per
    forward or train step under every trace; the eval share/8 point (the
    tier-3 fixed-overhead study's caps) within TIER3_SHARE8_BAND of its
    +9.2%, and the full-share point, whose ghost rows are 8x as many, no
    lower than it. Returns the audit's anchors: the plain forward's and
    the plain train step's busy ms and the eval and train fits."""
    import os

    here = os.path.dirname(os.path.abspath(__file__))
    runs = {}
    for mode, extra in (("eval", []), ("train", ["--train"])):
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, os.path.join(here, "scripts",
                                          "study_mesh1_overhead_torch.py"),
             "--iters", "5", "--ghost-sweep", "--preset",
             "scannet_whole_scene", "--trace-dir",
             os.path.join("build", f"chip_smoke_mesh1_{mode}"), *extra],
            cwd=here, capture_output=True, text=True, timeout=900)
        assert res.returncode == 0, (mode, res.stdout[-3000:],
                                     res.stderr[-4000:])
        out = res.stdout.splitlines()
        for line in out:
            if line.strip() and not line.startswith("MESH1_OVERHEAD "):
                print(f"  mesh-1 {mode}: {line}")
        runs[mode] = json.loads([line for line in out if line.startswith(
            "MESH1_OVERHEAD ")][-1].split(" ", 1)[1])
        print(f"MESH1_OVERHEAD {json.dumps(runs[mode])}")
        print(f"mesh-1 study: {mode} {time.perf_counter() - t0:.1f} s")
    for mode, r in runs.items():
        pts = r["tier3"]
        assert r["plain"]["busy_ms"] and len(pts) == 4, r
        assert all(p["busy_ms"] and p["ghost_overflow"] == 0 for p in pts), r
        assert r["fit"] is not None, r
        launches = [r["plain"]["knn3_mxu_launches_per_call"]] + [
            p["knn3_mxu_launches_per_call"] for p in pts] + (
            [r["tier2"]["knn3_mxu_launches_per_call"]] if r["tier2"] else [])
        assert launches == [4.0] * len(launches), (mode, launches)
        print(f"mesh-1 study ({card}), {mode}: plain {r['plain']['busy_ms']}"
              f" ms busy; tier 3 overhead by ratio "
              f"{[(round(p['ratio'], 3), p['overhead']) for p in pts]}; fit "
              f"fixed {r['fit']['fixed']:.4f} coeff {r['fit']['coeff']:.4f} "
              f"(rms residual {r['fit']['rms_residual']:.4f}); traces "
              f"retaken {r['retaken']}")
    ev = runs["eval"]
    by = {p["div"]: p["overhead"] for p in ev["tier3"]}
    print(f"mesh-1 study ({card}): tier 2 at one rank {ev['tier2']['busy_ms']}"
          f" ms busy, overhead {ev['tier2']['overhead']}; tier 3 share/8 "
          f"overhead {by[8]} against the tier-3 study's "
          f"{TIER3_SHARE8_OVERHEAD} (band {TIER3_SHARE8_BAND}); full share "
          f"{by[0]}")
    assert abs(by[8] - TIER3_SHARE8_OVERHEAD) <= TIER3_SHARE8_BAND, by
    assert by[0] >= by[8] - 0.02, by
    fit = {m: (r["fit"]["fixed"], r["fit"]["coeff"]) for m, r in runs.items()}
    return {"compute_ms": ev["plain"]["busy_ms"],
            "train_ms": runs["train"]["plain"]["busy_ms"], "tax_fit": fit}


def _dp_worker(inputs, out_dir):
    """One rank of the world-2 gloo mesh on cuda:0 (dp_phase)."""
    import numpy as np
    import torch

    from gridgcn_torch.api import Predictor
    from gridgcn_torch.kernels import knn
    from gridgcn_torch.models.build import build_model
    from gridgcn_torch.parallel.mesh import make_mesh
    from gridgcn_torch.parallel.spatial import (
        required_halo, sharded_scene_apply, suggest_capacity)
    from gridgcn_torch.train import steps
    from gridgcn_torch.utils.precision import full_fp32

    inp = torch.load(inputs, weights_only=False)
    mesh = make_mesh(2, ["cuda:0", "cuda:0"])
    out = {}
    out["train"], out["train_launches"] = {}, {}
    for name, cfg in inp["train_cfgs"].items():
        n0 = knn.knn3_mxu.launches
        out["train"][name] = one_train_step(
            torch, steps, cfg, build_model(cfg.model), inp["train_sd"],
            inp["batch"], inp["key"], "cuda:0", mesh=mesh)
        out["train_launches"][name] = knn.knn3_mxu.launches - n0
    pred = Predictor(inp["serve_cfg"], inp["serve_sd"], device="cuda",
                     mesh=mesh)
    n0 = knn.knn3_mxu.launches
    out["serve"] = pred(inp["scenes"], rng=inp["key"])
    out["serve_launches"] = knn.knn3_mxu.launches - n0
    xyz = inp["scenes"][0]
    mask = np.ones(len(xyz), bool)
    halo = required_halo(inp["serve_cfg"], float(np.ptp(xyz, axis=0).max()))
    cap = suggest_capacity(xyz, mask, 2, halo)

    def apply_fn(x, m, row0):
        with torch.no_grad(), full_fp32():
            return pred._model(x, None, m, inp["key"], row0=row0)
    n0 = knn.knn3_mxu.launches
    out["tier1"] = sharded_scene_apply(apply_fn, xyz, mask, mesh, halo, cap,
                                       inp["serve_cfg"].model.num_classes)
    out["tier1_launches"] = knn.knn3_mxu.launches - n0
    out["tier1_cap"] = cap
    torch.cuda.synchronize()
    torch.save(out, f"{out_dir}/rank{mesh.rank}.pt")


def dp_phase(torch, np, knn, presets, init_model, build_model, steps,
             jaxrng, train_cfg, train_ds, scene_fn, Predictor):
    """Data parallelism on the card. (1) A world-1 NCCL mesh's scannet_seg
    train step (8 crops of 8192, augmentation, dropout) bit for bit the
    single-device step. (2) A world-2 gloo mesh with both ranks on cuda:0
    (NCCL refuses a shared card): the same step in float32 against the
    single-device step on the same global batch at the training-
    correctness gates (as trained: loss 1e-5, gradient norm 1e-4,
    gradients 1e-2, BatchNorm statistics 3e-5, determined parameters
    1e-5, at most 70% of the elements undetermined, none more than 2 lr
    off); in the preset's bf16 the two runs' products have other shapes
    (4 clouds a rank against 8), so cuBLAS sums them in another order and
    bf16 rounds some outputs an ulp apart: that step is held at loss 1e-3
    and BatchNorm statistics 1e-2 of scale (a few bf16 ulps); a
    mesh-served batch
    of 2 whole scenes (no padding, f32) against single-device serving
    (within 1e-5 of the range, argmax >= 0.999); tier 1 of one whole
    scene, one slab per rank."""
    import os
    import shutil

    import torch.distributed as dist

    from gridgcn_torch.parallel.launch import launch
    from gridgcn_torch.parallel.mesh import init_distributed, make_mesh

    work = os.path.abspath(os.path.join("build", "chip_smoke_dp"))
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    batch = next(train_ds.batches(train_cfg.data.batch_size, seed=0))
    key = jaxrng.PRNGKey(6)
    _, sd = init_model(train_cfg.model, torch.Generator().manual_seed(2))

    def single():
        return one_train_step(torch, steps, train_cfg,
                              build_model(train_cfg.model), sd, batch, key,
                              "cuda")

    ref, again = single(), single()
    f32_cfg = dataclasses.replace(train_cfg, model=dataclasses.replace(
        train_cfg.model, dtype="float32"))
    ref32 = one_train_step(torch, steps, f32_cfg, build_model(f32_cfg.model),
                           sd, batch, key, "cuda")
    env = dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               RANK="0", WORLD_SIZE="1")
    os.environ.update(env)
    try:
        init_distributed(["cuda:0"])
        assert dist.get_backend() == "nccl"
        mesh = make_mesh(1, ["cuda:0"])
        one = one_train_step(torch, steps, train_cfg,
                             build_model(train_cfg.model), sd, batch, key,
                             "cuda", mesh=mesh)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k in env:
            os.environ.pop(k)

    def equal(a, b):
        return (a["metrics"] == b["metrics"]
                and all(torch.equal(a["grads"][k], b["grads"][k])
                        for k in a["grads"])
                and all(torch.equal(a["state"][k], b["state"][k])
                        for k in a["state"]))
    print(f"dp world-1 NCCL mesh: scannet_seg train step (8 x 8192, "
          f"augmentation, dropout) equal to the single-device step bit for "
          f"bit: {equal(one, ref)} (single-device step run twice equal: "
          f"{equal(again, ref)}); loss {one['metrics']['loss']:.6f}")
    assert equal(one, ref)

    # f32 (the preset serves bf16): the single-device batch of 2 and each
    # rank's batch of 1 run products of other shapes, so the comparison
    # is at the f32 gate, not the bf16 one
    serve_cfg = presets.get("scannet_whole_scene")
    serve_cfg = dataclasses.replace(serve_cfg, model=dataclasses.replace(
        serve_cfg.model, dtype="float32"))
    _, serve_sd = init_model(serve_cfg.model,
                             torch.Generator().manual_seed(0))
    scenes = np.stack([scene_fn(81920, seed=7 + i) for i in range(2)])
    torch.save(dict(train_cfgs={"f32": f32_cfg, "bf16": train_cfg},
                    train_sd=sd, batch=batch, key=key,
                    serve_cfg=serve_cfg, serve_sd=serve_sd, scenes=scenes),
               os.path.join(work, "inputs.pt"))
    t0 = time.perf_counter()
    launch(_dp_worker, ["cuda:0", "cuda:0"], os.path.join(work, "inputs.pt"),
           work, timeout_s=600)
    w_s = time.perf_counter() - t0
    r0, r1 = (torch.load(os.path.join(work, f"rank{r}.pt"),
                         weights_only=False) for r in range(2))
    gaps = {}
    for name, cfg, want in (("f32", f32_cfg, ref32),
                            ("bf16", train_cfg, ref)):
        a, b = r0["train"][name], r1["train"][name]
        assert all(torch.equal(a["state"][k], b["state"][k])
                   for k in a["state"])
        g = gaps[name] = train_gaps(torch, steps, cfg, a, want)
        alike = [round(float((torch.cat([x.center_vids, y.center_vids])
                              == z.center_vids).float().mean()), 6)
                 for x, y, z in zip(a["cagq"], b["cagq"], want["cagq"])]
        print(f"dp world-2 gloo mesh on cuda:0 (workers {w_s:.1f} s): "
              f"scannet_seg train step ({name}) vs the single-device step: "
              f"{train_gap_line(g)}; CAGQ center voxels alike per layer "
              f"{alike}; both ranks' state bit for bit; knn3_mxu launches "
              f"per rank {[r['train_launches'][name] for r in (r0, r1)]}")
        assert r0["train_launches"][name] == r1["train_launches"][name] \
            == 16
        # Adam's first step moves a parameter by up to lr either way; the
        # float32 difference of two such moves rounds up to ~2 lr (1 + 2e-5)
        assert min(alike) == 1.0 and g["lr_moves"] <= 2.001, (alike, g)
    g = gaps["f32"]
    assert g["loss"] <= 1e-5 and g["grad_norm"] <= 1e-4, g
    assert g["grad"] <= 1e-2 and g["noise"] <= 2e-4, g
    assert g["param"] <= 1e-5 and g["stat"] <= 3e-5, g
    assert g["undetermined"] <= 0.7, g
    g = gaps["bf16"]
    assert g["loss"] <= 1e-3 and g["stat"] <= 1e-2, g
    want = Predictor(serve_cfg, serve_sd, device="cuda")(scenes, rng=key)
    span = float(np.ptp(want))
    rows = [(float(np.abs(r["serve"] - want).max()) / span,
             bool(np.array_equal(r["serve"], want))) for r in (r0, r1)]
    t1 = r0["tier1"]
    t1_arg = float((t1.argmax(-1) == want[0].argmax(-1)).mean())
    arg = [float((r["serve"].argmax(-1) == want.argmax(-1)).mean())
           for r in (r0, r1)]
    print(f"dp mesh serving scannet_whole_scene (f32), 2 scenes over 2 "
          f"ranks: argmax alike {arg}; "
          f"against single-device serving (|diff| / range, bit for bit) "
          f"{rows}; knn3_mxu launches per rank "
          f"{[r['serve_launches'] for r in (r0, r1)]}; tier 1 of scene 0, "
          f"one slab of capacity {r0['tier1_cap']} per rank: knn3_mxu "
          f"launches per rank {[r['tier1_launches'] for r in (r0, r1)]}, "
          f"argmax alike the unsharded forward {t1_arg:.5f}")
    assert all(d <= 1e-5 for d, _ in rows) and min(arg) >= 0.999, rows
    assert np.array_equal(r0["serve"], r1["serve"])
    assert r0["serve_launches"] == r1["serve_launches"] == 4
    assert r0["tier1_launches"] == r1["tier1_launches"] == 4
    assert t1.shape == (81920, 21) and np.isfinite(t1).all()


def list_length_record(torch, knn, k, cases, main, grid=()):
    """Both kernels at list length k on each case (args): knn3_exact bit
    for bit its plain version, knn3_mxu at the kernel phase's any-k gates
    against its plain version (agree 0.999, |d| 1e-3; bit for bit on the
    cases in `grid`) and against knn3_exact (recall 0.97, top-1 0.99).
    The cases for which main(args) is true are timed with CUDA events;
    returns {name: record} summed over them, with the kernels-line keys
    (times, bounds, library call)."""
    rec = {n: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                   bytes_ms=0.0, ops_ms=0.0, max_abs_err=0.0)
           for n in ("knn3_mxu", "knn3_exact")}
    for args in cases:
        q, qm, s, sm = args
        nq, ns = q.shape[0], s.shape[0]
        de, ie, ve = knn.knn3_exact(*args, k=k)
        dx, ix, vx = knn.knn3_exact_ref(*args, k=k)
        dm, im, vm = knn.knn3_mxu(*args, k=k)
        dr, ir, vr = knn.knn3_mxu_ref(*args, k=k)
        torch.cuda.synchronize()
        assert de.shape == (nq, k)
        assert torch.equal(de.view(torch.int32), dx.view(torch.int32)) \
            and torch.equal(ie, ix) and torch.equal(ve, vx), \
            f"knn3_exact k={k} differs from its plain version at {nq}x{ns}"
        on_grid = any(args is g for g in grid)
        if on_grid:
            assert torch.equal(dm.view(torch.int32), dr.view(torch.int32)) \
                and torch.equal(im, ir) and torch.equal(vm, vr), \
                f"knn3_mxu k={k} not bit exact on the grid at {nq}x{ns}"
        assert torch.equal(vm, vr) and torch.equal(vm, ve), (k, nq, ns)
        same = (im == ir) & vm
        agree = same.sum().item() / max(vm.sum().item(), 1)
        err = (dm - dr).abs()[same].max().item() if same.any() else 0.0
        rows = qm.nonzero()[:, 0]
        hit = (im[rows][:, :, None] == ie[rows][:, None, :]).any(-1)
        recall = hit[ve[rows]].float().mean().item()
        top1 = (im[rows, 0] == ie[rows, 0]).float().mean().item()
        assert agree >= 0.999 and err <= 1e-3, (k, nq, ns, agree, err)
        assert recall >= 0.97 and top1 >= 0.99, (k, nq, ns, recall, top1)
        errs = {"knn3_mxu": err, "knn3_exact": (de - dx).abs().max().item()}
        for n, r in rec.items():
            r["max_abs_err"] = max(r["max_abs_err"], errs[n])
        line = (f"kernel k={k} {nq}x{ns}{' grid' if on_grid else ''}: "
                f"knn3_exact bit for bit its plain version; knn3_mxu "
                f"{'bit for bit, ' if on_grid else ''}vs plain agree "
                f"{agree:.6f} err {err:.3g}, vs exact recall {recall:.5f} "
                f"top1 {top1:.5f}")
        if not main(args):
            print(line)
            continue
        pairs = nq * ns
        iters = 3 if pairs > 1e8 else 10
        ms = {n: cuda_ms(torch, lambda f=getattr(knn, n): f(*args, k=k),
                         iters) for n in rec}
        plain = {n: cuda_ms(torch, lambda f=getattr(knn, n + "_ref"):
                            f(*args, k=k), 2, 1) for n in rec}
        library = cuda_ms(torch, lambda: torch.topk(
            torch.cdist(q, s), k, dim=-1, largest=False), 2, 1)
        bytes_ms = (nq * 13 + ns * 13 + nq * k * 9) / HBM_BYTES_PER_S * 1e3
        ops_ms = {name: pairs * per_pair / PEAK_OPS_PER_S[peak] * 1e3
                  for name, (per_pair, peak) in KNN_OPS.items()}
        print(f"{line}; ms exact {ms['knn3_exact']:.4f} (plain "
              f"{plain['knn3_exact']:.4f}), mxu {ms['knn3_mxu']:.4f} (plain "
              f"{plain['knn3_mxu']:.4f}); library {library:.4f}")
        for n, r in rec.items():
            r["ms"] += ms[n]
            r["plain_ms"] += plain[n]
            r["library_ms"] += library
            r["bytes_ms"] += bytes_ms
            r["ops_ms"] += ops_ms[n]
            r["bound_ms"] += max(bytes_ms, ops_ms[n])
    return rec


def any_k_phase(torch, knn, ragged, main_calls):
    """Both kernels at list lengths other than the decoder's 3: ANY_K
    (the register kernels) on one ragged, masked shape; the list kernels
    at LIST_K on the ragged shape, on 2 valid supports of 200 (k - 2
    entries that only the column orders) and on the grid (exact sums, ties
    everywhere: knn3_mxu bit for bit) at 300 and 70000 queries, and at
    LONG_K on the main path's four decoder calls too, timed; each held as
    `list_length_record` holds them; k = 129 refused. Returns {(name, k):
    record}, the LONG_K records summed over the four main calls."""
    out = {}
    for k in ANY_K:
        rec = list_length_record(torch, knn, k, [ragged], lambda a: True)
        out.update({(n, k): r for n, r in rec.items()})
    grid = [grid_inputs(torch, nq, 2048, 5) for nq in (300, 70000)]
    checks = [ragged, ragged_inputs(torch, 300, 200, 2, 2)] + grid
    for k in LIST_K:
        timed = main_calls if k in LONG_K else []
        rec = list_length_record(torch, knn, k, checks + timed,
                                 lambda a: any(a is m for m in timed), grid)
        if k not in LONG_K:
            continue
        out.update({(n, k): r for n, r in rec.items()})
        print(f"kernel k={k}, sum of the main path's 4 decoder calls: "
              + "; ".join(f"{n} ms {r['ms']:.4f} plain {r['plain_ms']:.4f} "
                          f"library {r['library_ms']:.4f} bound "
                          f"{r['bound_ms']:.5f} ("
                          f"{'beats' if r['ms'] < r['library_ms'] else 'loses to'}"
                          f" the library)" for n, r in rec.items()))
    for fn in (knn.knn3_mxu, knn.knn3_exact):
        try:
            fn(*ragged, k=knn.MAX_K + 1)
        except ValueError:
            continue
        raise AssertionError(f"k = {knn.MAX_K + 1} was not refused")
    return out


def tier_cagq(torch, cfg, tier, d, i, origin, vsize, key, D=2):
    """Shard d's layer-i CAGQ arguments in a resident tier: (spec with the
    shard's n_centers, key, bounds or None), as `parallel.resident` and
    `parallel.resident_ml` derive them."""
    from gridgcn_torch.parallel.resident import stage_key
    from gridgcn_torch.utils import jaxrng

    spec = cfg.model.layers[i]
    dev = "cuda"
    o = torch.as_tensor(origin, device=dev)[None]
    if tier == 2:
        n = spec.n_centers // D if i == 0 else spec.n_centers
        k = stage_key(jaxrng.fold_in(key, d) if i == 0
                      else jaxrng.fold_in(key, 10_000 + i), i)
        bounds = (o, torch.as_tensor(vsize, device=dev)[None]) if i == 0 \
            else None
    else:
        n = spec.n_centers // D
        k = stage_key(jaxrng.fold_in(jaxrng.fold_in(key, i), d), i)
        extent = vsize * cfg.model.layers[0].resolution / (1.0 + 1e-5)
        v = torch.as_tensor(extent, device=dev) * (1.0 + 1e-5) \
            / spec.resolution
        bounds = (o, v[None])
    return dataclasses.replace(spec, n_centers=n), k, bounds


@contextlib.contextmanager
def overflow_record(out):
    """Within the block, every tier-3 boundary exchange adds the rows it
    could not send to out[0]."""
    from gridgcn_torch.parallel import resident_ml

    real = resident_ml.exchange_boundary

    def recording(*a, **k):
        o = real(*a, **k)
        out[0] += int(o[4])
        return o

    resident_ml.exchange_boundary = recording
    try:
        yield
    finally:
        resident_ml.exchange_boundary = real


def timed_scene_ms(torch, fn, warmup=1, iters=3):
    """Median milliseconds of fn() between CUDA events after warm-up (a
    predict call ends on the host with the logits, so the events bracket
    the whole request)."""
    for _ in range(warmup):
        fn()
    out = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def _spatial_steps(torch, inp, mesh, dev, pinned=None, pin_three_nn=True):
    """Both tiers' spatial train steps of inp["cfg"] on this rank of a
    world-2 mesh, from inp["sd"] on one whole scene; the CAGQ groups (and
    with pin_three_nn the decoder's 3-NN outputs) of another run pinned
    where given. {tier: one_train_step-like dict}, with the decoder's
    kNN kernel calls' arguments where the kernel ran
    (`three_nn_inputs`)."""
    import numpy as np

    from gridgcn_torch.models.build import build_model
    from gridgcn_torch.parallel.spatial_train import (
        make_spatial_train_step, shard_scene_batch)
    from gridgcn_torch.train import steps

    cfg = inp["cfg"]
    out = {}
    for tier in ("resident", "resident_ml"):
        state = steps.create_train_state(cfg, build_model(cfg.model),
                                         inp["sd"], 4, device=dev)
        grads, update = [], state.tx.update
        state.tx.update = lambda g, norm: (grads.extend(x.cpu() for x in g),
                                           update(g, norm))[1]
        batch = shard_scene_batch(cfg, inp["xyz"], inp["label"],
                                  np.ones(len(inp["xyz"]), bool), mesh,
                                  inp["cap"])
        step = make_spatial_train_step(cfg, mesh, tier=tier)
        groups, nns, calls = [], [], []
        with cagq_record(torch, groups, None if pinned is None
                         else pinned[tier]["cagq"]), \
                three_nn_record(nns, None if pinned is None or not
                                pin_three_nn else pinned[tier]["three_nn"],
                                inputs=calls):
            _, m = step(state, batch, inp["key"])
        names = [n for n, _ in state.model.named_parameters()]
        out[tier] = dict(
            metrics={k: float(v) for k, v in m.items()},
            grads=dict(zip(names, grads)),
            state={k: v.cpu() for k, v in state.model.state_dict().items()},
            cagq=groups, three_nn=nns, three_nn_inputs=calls)
    return out


def _spatial_float64(torch, inp, mesh, pinned):
    """Both tiers' spatial-step loss and gradients on this rank, computed
    on the CPU in float64 (BatchNorm included) with the CAGQ groups and
    decoder 3-NN outputs `pinned` (this rank's records of the f32 CPU
    step): the exact answer for those discrete choices, as
    `float64_gradients` gives it for the single-device step. The loss is
    the spatial step's: the owned points' cross-entropy over the global
    weight; the gradients are summed over the ranks."""
    import numpy as np
    import torch.nn.functional as F

    from gridgcn_torch.models.build import build_model
    from gridgcn_torch.parallel.resident import make_resident_forward
    from gridgcn_torch.parallel.resident_ml import make_resident_ml_forward
    from gridgcn_torch.parallel.spatial_train import shard_scene_batch
    from gridgcn_torch.utils import jaxrng

    cfg = inp["cfg"]
    b = {k: torch.as_tensor(v) for k, v in shard_scene_batch(
        cfg, inp["xyz"], inp["label"], np.ones(len(inp["xyz"]), bool), mesh,
        inp["cap"]).items()}
    out = {}
    for tier, make, geo in (("resident", make_resident_forward, "vsize"),
                            ("resident_ml", make_resident_ml_forward,
                             "extent")):
        model = build_model(cfg.model)
        model.load_state_dict(inp["sd"])
        model.double()
        for mod in model.modules():
            for a in ("dtype", "att_dtype", "interp_dtype"):
                if isinstance(getattr(mod, a, None), torch.dtype):
                    setattr(mod, a, torch.float64)
        fwd = make(cfg, mesh, train=True)
        with cagq_record(torch, [], pinned[tier]["cagq"]), \
                three_nn_record([], pinned[tier]["three_nn"]), \
                float64_batchnorm(torch):
            logits = fwd(model, b["sx"].double(), b["sm"], b["edges"],
                         b["origin"], b[geo], jaxrng.fold_in(inp["key"], 0))[0]
        labels = b["label"].long()
        ce = -(F.one_hot(labels, cfg.model.num_classes).double()
               * F.log_softmax(logits, -1)).sum(-1)
        owned = b["owned"]
        if cfg.model.ignore_label is not None:
            owned = owned & (labels != cfg.model.ignore_label)
        w = owned.double()
        denom = torch.clamp_min(mesh.sum(w.sum()), 1e-6)
        num = (ce * w).sum()
        params = list(model.parameters())
        grads = mesh.sum_all([torch.zeros_like(p) if g is None else g
                              for g, p in zip(torch.autograd.grad(
                                  num / denom, params, allow_unused=True),
                                  params)])
        out[tier] = dict(
            metrics={"loss": float(mesh.sum(num.detach()) / denom),
                     "grad_norm": float(torch.linalg.vector_norm(
                         torch.stack([g.norm() for g in grads])))},
            grads={n: g for (n, _), g in zip(model.named_parameters(),
                                             grads)})
    return out


def _resident_worker(inputs, out_dir, job):
    """One rank of a resident-tier mesh (resident_phase): "train_cpu" and
    "card" on world 2 (gloo: CPU, or both ranks on cuda:0), "scenes" on a
    world-4 gloo mesh on cuda:0 laid out 2 x 2."""
    import os
    import warnings

    import numpy as np
    import torch

    from gridgcn_torch.api import Predictor
    from gridgcn_torch.kernels import knn
    from gridgcn_torch.ops.cagq import cagq
    from gridgcn_torch.parallel.mesh import SPACE_AXIS, make_mesh
    from gridgcn_torch.parallel.resident import scene_bounds
    from gridgcn_torch.parallel.resident_ml import resident_ml_seg_predict
    from gridgcn_torch.parallel.spatial import partition_scene
    from gridgcn_torch.utils import jaxrng

    # the comm-audit test's wrapper of torch.distributed, from its file (a
    # `tests` package installed elsewhere would shadow the directory)
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests"))
    from torch_comm_worker import recording

    inp = torch.load(inputs, weights_only=False)
    out = {}
    if job == "train_cpu":
        mesh = make_mesh(2, ["cpu", "cpu"])
        out["train"] = _spatial_steps(torch, inp["train"], mesh, "cpu")
        out["exact"] = _spatial_float64(torch, inp["train"], mesh, {
            t: {f: r[f] for f in ("cagq", "three_nn")}
            for t, r in out["train"].items()})
    elif job == "card":
        mesh = make_mesh(2, ["cuda:0", "cuda:0"])
        d = mesh.rank
        sv = inp["serve"]
        cfg, xyz, key = sv["cfg"], sv["xyz"], sv["key"]
        ref = dict(np.load(sv["ref"]))
        pred = Predictor(cfg, sv["sd"], device="cuda", mesh=mesh)
        mask = np.ones(len(xyz), bool)
        origin, vsize = scene_bounds(xyz, mask, cfg.model.layers[0].resolution)
        sx, sm, _, _, _ = partition_scene(xyz, mask, 2, float(ref["halo"]),
                                          int(ref["capacity"]))
        for tier, name in ((2, "resident"), (3, "resident_ml")):
            res = out[name] = {}
            with warnings.catch_warnings(record=True) as w:
                warnings.simplefilter("always")
                pred.predict_scene(xyz, spatial=name, rng=key)   # warm-up
                over, calls = [0], []
                knn.knn3_mxu.launches = 0
                with overflow_record(over), three_nn_record([],
                                                            inputs=calls):
                    res["logits"] = pred.predict_scene(xyz, spatial=name,
                                                       rng=key)
                res["launches"] = knn.knn3_mxu.launches
                res["overflow"] = over[0]
                res["three_nn_inputs"] = calls
                res["ms"] = timed_scene_ms(torch, lambda: pred.predict_scene(
                    xyz, spatial=name, rng=key), warmup=0)
                # the bytes one request hands the collectives (comm phase;
                # the comm-audit test's wrapper of torch.distributed)
                res["collectives"] = []
                with recording(res["collectives"]):
                    pred.predict_scene(xyz, spatial=name, rng=key)
            res["warnings"] = [str(x.message) for x in w]
            # each layer's CAGQ on this shard, on the reference's level
            alike = []
            for i in range(len(cfg.model.layers)):
                if i == 0:
                    x = torch.as_tensor(sx[d:d + 1], device="cuda")
                    m = torch.as_tensor(sm[d:d + 1], device="cuda")
                else:
                    x = torch.as_tensor(ref[f"t{tier}_d{d}_in{i}_xyz"][None],
                                        device="cuda")
                    m = torch.as_tensor(ref[f"t{tier}_d{d}_in{i}_mask"][None],
                                        device="cuda")
                spec, k, bounds = tier_cagq(torch, cfg, tier, d, i, origin,
                                            vsize, key)
                g = cagq(x, m, spec, k, bounds=bounds).groups
                alike.append(bool(
                    np.array_equal(g.center_vids[0].cpu().numpy(),
                                   ref[f"t{tier}_d{d}_vids{i}"])
                    and np.array_equal(g.center_valid[0].cpu().numpy(),
                                       ref[f"t{tier}_d{d}_valid{i}"])))
            res["cagq_alike"] = alike
        out["train"] = _spatial_steps(torch, inp["train"], mesh, "cuda:0",
                                      pinned=inp["pinned"][d])
        out["train_again"] = _spatial_steps(torch, inp["train"], mesh,
                                            "cuda:0",
                                            pinned=inp["pinned"][d])
        live = out["train_live"] = _spatial_steps(
            torch, inp["train"], mesh, "cuda:0", pinned=inp["pinned"][d],
            pin_three_nn=False)
        # the same step on the CPU, on the CPU's CAGQ groups and the 3-NN
        # outputs knn3_mxu gave the card's step
        out["train_cpu_on_live"] = _spatial_steps(
            torch, inp["train"], make_mesh(2, ["cpu", "cpu"]), "cpu",
            pinned={t: {"cagq": inp["pinned"][d][t]["cagq"],
                        "three_nn": live[t]["three_nn"]} for t in live})
    else:
        mesh = make_mesh(4, ["cuda:0"] * 4)
        sc = inp["scenes"]
        cfg, xyz, key = sc["cfg"], sc["xyz"], sc["key"]
        pred = Predictor(cfg, sc["sd"], device="cuda", mesh=mesh)
        n0 = knn.knn3_mxu.launches
        out["batched"] = pred.predict_scenes(xyz, rng=key)
        out["launches"] = knn.knn3_mxu.launches - n0
        mesh2d = pred._scene_fwds[("scenes", 2)][0]
        b = mesh2d.axis("data").rank
        out["single"] = resident_ml_seg_predict(
            pred.cfg, pred._model, xyz[b], np.ones(xyz.shape[1], bool),
            mesh2d.axis(SPACE_AXIS), capacity=sc["cap"],
            rng=jaxrng.split(key, 2)[b])
        out["scene"] = b
    if job != "train_cpu":
        torch.cuda.synchronize()
    torch.save(out, f"{out_dir}/{job}{torch.distributed.get_rank()}.pt")


def resident_phase(torch, np, knn, presets, jaxrng, scene_fn, Predictor,
                   card):
    """The resident spatial tiers (tier 2 `parallel.resident`, tier 3
    `parallel.resident_ml`) on the card, at full width.
    (1) Serving scannet_whole_scene (81920 points, BatchNorm folded, bf16)
    through predict_scene(spatial="resident" and "resident_ml") on a
    world-2 gloo mesh with both ranks on cuda:0 (NCCL refuses two ranks on
    one card): knn3_mxu 4 launches per rank per vote, no ghost overflow,
    each encoder layer's per-shard CAGQ on the reference's level
    (gridgcn_torch/testdata/resident_ref.npz, scripts/
    dump_torch_resident_ref.py) bit for bit, the stitched bf16 logits
    within 10% of the reference's range with argmax >= 0.98; then tier 3
    on a world-1 NCCL mesh, timed beside single-device predict_scene.
    (2) predict_scenes of 2 scenes on a 2 x 2 mesh (4 gloo ranks on
    cuda:0): each scene's logits within 1e-5 of the range of its 1-D
    tier-3 forward on its row's ring. (3) One spatial train step of
    scannet_seg in f32 on a whole 8192-point scene, tiers 2 and 3, world-2
    gloo on cuda:0, held as trained against the same step on the CPU
    (world-2 gloo CPU workers) at the data-parallel phase's gates (loss
    1e-5, gradients 1e-2, determined parameters 1e-5 and BatchNorm
    statistics 3e-5 of scale), the gradient norm at 5e-4 (measured up to
    2.42e-4 between the two f32 steps; PERF.md): with the CPU's CAGQ
    groups (CAS picks other centers from barycenters a few ulps apart)
    and decoder 3-NN outputs pinned; and with the CAGQ groups pinned and
    knn3_mxu live on the card, against the CPU's step on the 3-NN outputs
    the card's kernel gave (the weights 1/(d² + 1e-8) amplify knn3_mxu's
    d² rounding where a query lies on a support, PR 4). Printed beside
    them: both f32 steps against the step in float64 on the same choices
    (`_spatial_float64`), the card with knn3_mxu live against the CPU on
    its own 3-NN outputs, and the card's step run twice. Both kernels are
    then held against their plain versions (kernel_phase's gates) on
    every decoder call of the served tiers and of the live train steps,
    on each rank. (4) Tier 3 at world 1 (NCCL): ms per spatial step
    and train_spatial for an epoch of 4 scenes, the convergence arm's
    path. Returns {"collectives": each rank's sends and receives of the
    world-2 tier-3 request} for the comm audit."""
    import os
    import shutil

    import torch.distributed as dist

    from gridgcn_torch.models.build import (
        build_model, numpy_state_dict, state_dict_digests)
    from gridgcn_torch.parallel.launch import launch
    from gridgcn_torch.parallel.mesh import init_distributed, make_mesh
    from gridgcn_torch.parallel.resident import resident_halo, scene_bounds
    from gridgcn_torch.parallel.spatial import suggest_capacity
    from gridgcn_torch.parallel.spatial_train import (
        make_spatial_train_step, shard_scene_batch)
    from gridgcn_torch.train import steps, train as ttrain

    work = os.path.abspath(os.path.join("build", "chip_smoke_resident"))
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    ref_path = "gridgcn_torch/testdata/resident_ref.npz"
    ref = dict(np.load(ref_path))
    cfg = presets.get("scannet_whole_scene")
    sd = numpy_state_dict(cfg.model, 0)
    want = {k[len("digest/"):]: str(v) for k, v in ref.items()
            if k.startswith("digest/")}
    if state_dict_digests(sd) != want:
        raise RuntimeError("the numpy-seeded weights differ from the "
                           "reference's (SHA-256)")
    xyz = scene_fn(81920, seed=7)
    key = jaxrng.PRNGKey(0)

    tcfg = scannet_train_config(presets)
    tcfg = dataclasses.replace(tcfg, model=dataclasses.replace(
        tcfg.model, dtype="float32"))
    # numpy-seeded weights: no zero-initialised bias, whose "scale" after
    # one Adam step is lr itself, so that the gate on determined
    # parameters does not measure Adam's eps term times the devices'
    # gradient rounding (init_model's zero biases: 9.45e-7, 1.51e-5 and
    # 3.43e-6 of scale in three calls)
    tsd = numpy_state_dict(tcfg.model, 3)
    txyz, tlabel = scene_fn(8192, seed=300, return_labels=True)
    _, tv = scene_bounds(txyz, np.ones(8192, bool),
                         tcfg.model.layers[0].resolution)
    tcap = suggest_capacity(txyz, np.ones(8192, bool), 2,
                            resident_halo(tcfg, tv))
    train_inp = dict(cfg=tcfg, sd=tsd, xyz=txyz, label=tlabel.astype(np.int32),
                     key=jaxrng.PRNGKey(8), cap=tcap)
    scenes = np.stack([scene_fn(81920, seed=20 + i) for i in range(2)])
    caps = []
    for b in range(2):
        _, v = scene_bounds(scenes[b], np.ones(81920, bool),
                            cfg.model.layers[0].resolution)
        caps.append(suggest_capacity(scenes[b], np.ones(81920, bool), 2,
                                     resident_halo(cfg, v)))
    inputs = os.path.join(work, "inputs.pt")
    torch.save(dict(train=train_inp), inputs)
    t0 = time.perf_counter()
    launch(_resident_worker, ["cpu", "cpu"], inputs, work, "train_cpu",
           timeout_s=600)
    t_cpu = time.perf_counter() - t0
    cpu_out = [torch.load(os.path.join(work, f"train_cpu{r}.pt"),
                          weights_only=False) for r in range(2)]
    cpu = [c["train"] for c in cpu_out]
    exact64 = cpu_out[0]["exact"]
    torch.save(dict(train=train_inp,
                    pinned=[{t: {f: c[t][f] for f in ("cagq", "three_nn")}
                             for t in c} for c in cpu],
                    serve=dict(cfg=cfg, sd=sd, xyz=xyz, key=key,
                               ref=os.path.abspath(ref_path))), inputs)
    t0 = time.perf_counter()
    launch(_resident_worker, ["cuda:0", "cuda:0"], inputs, work, "card",
           timeout_s=600)
    t_card = time.perf_counter() - t0
    r0, r1 = (torch.load(os.path.join(work, f"card{r}.pt"),
                         weights_only=False) for r in range(2))
    sub = ref["subset"]
    for tier, name in ((2, "resident"), (3, "resident_ml")):
        a, b = r0[name], r1[name]
        want_l = ref[f"t{tier}_logits"].astype(np.float32)
        got = a["logits"][sub]
        span = float(np.ptp(want_l))
        dmax = float(np.abs(got - want_l).max())
        arg = float((got.argmax(-1) == want_l.argmax(-1)).mean())
        print(f"resident {name} scannet_whole_scene (81920 points, bf16, "
              f"world-2 gloo on cuda:0): per-shard CAGQ on the reference's "
              f"levels bit for bit {[a['cagq_alike'], b['cagq_alike']]}; "
              f"knn3_mxu launches per rank per vote "
              f"{[a['launches'], b['launches']]}; ghost_overflow "
              f"{[a['overflow'], b['overflow']]}; bf16 logits on 4096 "
              f"points max |diff| {dmax:.4g} = {dmax / span:.4f} of the "
              f"reference's range {span:.4g}, argmax alike {arg:.5f}; ms "
              f"per scene (gloo, both ranks on one card) "
              f"{[round(a['ms'], 3), round(b['ms'], 3)]}")
        assert all(a["cagq_alike"]) and all(b["cagq_alike"])
        assert a["launches"] == b["launches"] == 4
        assert a["overflow"] == b["overflow"] == 0
        assert not a["warnings"] and not b["warnings"], a["warnings"]
        assert np.array_equal(a["logits"], b["logits"])
        assert dmax <= 0.1 * span and arg >= 0.98, (dmax, span, arg)
    for tier in ("resident", "resident_ml"):
        got, want, exact = r0["train"][tier], cpu[0][tier], exact64[tier]
        live, on_live = r0["train_live"][tier], r0["train_cpu_on_live"][tier]
        for name in ("train", "train_live"):
            a, b = r0[name][tier]["state"], r1[name][tier]["state"]
            assert all(torch.equal(a[k], b[k]) for k in a), name
        pinned = train_gaps(torch, steps, tcfg, got, want)
        live_gap = train_gaps(torch, steps, tcfg, live, on_live)
        shown = {
            "the card's pinned step vs float64 on the same choices":
                train_gaps(torch, steps, tcfg, got, want, exact),
            "the CPU's f32 step vs float64": train_gaps(
                torch, steps, tcfg, want, want, exact),
            "the card with knn3_mxu live vs the CPU's step on the CPU's "
            "own 3-NN outputs": train_gaps(torch, steps, tcfg, live, want),
            "the pinned step on the card again vs the first":
                train_gaps(torch, steps, tcfg, r0["train_again"][tier], got)}
        print(f"resident train step {tier} scannet_seg (f32, one 8192-point "
              f"scene, capacity {tcap}, world-2 gloo on cuda:0 and on the "
              f"CPU; workers {t_card:.1f} s card, {t_cpu:.1f} s CPU; loss "
              f"{got['metrics']['loss']:.7g} vs {want['metrics']['loss']:.7g}"
              + (f", ghost_overflow {got['metrics']['ghost_overflow']:.0f}"
                 if tier == "resident_ml" else "") + ")")
        print(f"  as trained, the CPU's CAGQ groups and 3-NN outputs pinned, "
              f"vs the CPU's step: {train_gap_line(pinned)}")
        print(f"  as trained, the CPU's CAGQ groups pinned and knn3_mxu "
              f"live, vs the CPU's step on the card's 3-NN outputs: "
              f"{train_gap_line(live_gap)}")
        for name, g in shown.items():
            print(f"  {name}: {train_gap_line(g)}")
        # the data-parallel phase's as-trained gates; the gradient norm's
        # a few times above the pinned steps' measured 2.42e-4 (PERF.md)
        for g in (pinned, live_gap):
            assert g["loss"] <= 1e-5 and g["grad_norm"] <= 5e-4, g
            assert g["grad"] <= 1e-2 and g["noise"] <= 2e-4, g
            assert g["param"] <= 1e-5 and g["stat"] <= 3e-5, g
            assert g["undetermined"] <= 0.7 and g["lr_moves"] <= 2.001, g
        assert got["metrics"].get("ghost_overflow", 0) == 0
        assert live["metrics"].get("ghost_overflow", 0) == 0
    # the kernels on every decoder call the tiers made on the card above
    # (the served whole scene's slab and ghost shapes, the train step's
    # with knn3_mxu live), against their plain versions and knn3_exact at
    # the kernel phase's gates
    cases = [(tuple(t.cuda() for t in a), f"{name} {what} rank {d}")
             for d, r in enumerate((r0, r1))
             for name in ("resident", "resident_ml")
             for what, calls in (
                 ("serve", r[name]["three_nn_inputs"]),
                 ("train", r["train_live"][name]["three_nn_inputs"]))
             for a in calls]
    assert len(cases) == 32, len(cases)
    kernel_phase(torch, knn, cases)

    # scene batching on a 2 x 2 mesh
    torch.save(dict(scenes=dict(cfg=cfg, sd=sd, xyz=scenes, key=key,
                                cap=max(caps))), inputs)
    t0 = time.perf_counter()
    launch(_resident_worker, ["cuda:0"] * 4, inputs, work, "scenes",
           timeout_s=600)
    t_sc = time.perf_counter() - t0
    rs = [torch.load(os.path.join(work, f"scenes{r}.pt"), weights_only=False)
          for r in range(4)]
    rows = []
    for r in rs:
        b, want_s = r["scene"], r["single"]
        rows.append(float(np.abs(r["batched"][b] - want_s).max())
                    / float(np.ptp(want_s)))
    print(f"resident predict_scenes 2 scenes on a 2 x 2 mesh (4 gloo ranks "
          f"on cuda:0, {t_sc:.1f} s): each scene against its 1-D tier 3 on "
          f"its row's ring, max |diff| / range per rank {rows}; knn3_mxu "
          f"launches per rank {[r['launches'] for r in rs]}")
    assert max(rows) <= 1e-5, rows
    assert all(r["launches"] == 4 for r in rs)
    assert all(np.array_equal(r["batched"], rs[0]["batched"]) for r in rs)

    # world 1, NCCL: tier 3 serving and training, the convergence arm's path
    env = dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               RANK="0", WORLD_SIZE="1")
    os.environ.update(env)
    try:
        init_distributed(["cuda:0"])
        assert dist.get_backend() == "nccl"
        mesh = make_mesh(1, ["cuda:0"])
        single = Predictor(cfg, sd, device="cuda")
        meshed = Predictor(cfg, sd, device="cuda", mesh=mesh)
        meshed.predict_scene(xyz, spatial="resident_ml", rng=key)
        knn.knn3_mxu.launches = 0
        one = meshed.predict_scene(xyz, spatial="resident_ml", rng=key)
        n1 = knn.knn3_mxu.launches
        ms1 = timed_scene_ms(torch, lambda: meshed.predict_scene(
            xyz, spatial="resident_ml", rng=key), warmup=0)
        ms0 = timed_scene_ms(torch, lambda: single.predict_scene(
            xyz, rng=key))
        state = steps.create_train_state(tcfg, build_model(tcfg.model), tsd,
                                         4, device="cuda")
        step = make_spatial_train_step(tcfg, mesh, tier="resident_ml")
        batch = shard_scene_batch(tcfg, txyz, train_inp["label"],
                                  np.ones(8192, bool), mesh, 8192)
        step_ms = timed_scene_ms(torch, lambda: step(
            state, batch, jaxrng.PRNGKey(8)), warmup=2, iters=5)
        spat = dataclasses.replace(
            tcfg, data=dataclasses.replace(
                tcfg.data, dataset="synthetic_scene", synthetic_size=4,
                augment=True),
            train=dataclasses.replace(tcfg.train, epochs=2, log_every=0,
                                      ckpt_dir=os.path.join(work, "ck")))
        log = os.path.join(work, "train_spatial.jsonl")
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):  # the JSONL echo
            ttrain.train_spatial(spat, 1, log_path=log, tier="resident_ml",
                                 device="cuda")
        t_ts = time.perf_counter() - t0
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k in env:
            os.environ.pop(k)
    epochs = [r for r in map(json.loads, open(log)) if r["kind"] == "epoch"]
    print(f"resident world-1 NCCL tier 3 scannet_whole_scene: knn3_mxu "
          f"launches per vote {n1}; ms per scene {ms1:.3f} beside the "
          f"single-device predict_scene {ms0:.3f} ({ms1 / ms0:.3f}x in "
          f"latency; CUDA events, after warm-up; {card}; the ghost tax is "
          f"the mesh-1 study's, in busy time); "
          f"argmax alike the single device "
          f"{float((one.argmax(-1) == single.predict_scene(xyz, rng=key).argmax(-1)).mean()):.5f}")
    print(f"resident world-1 NCCL tier 3 scannet_seg (f32) spatial train "
          f"step on a whole 8192-point scene: {step_ms:.3f} ms (median of "
          f"5 after 2 warm-up, CUDA events); train_spatial (4 scenes a "
          f"epoch, augmentation, 2 epochs) {t_ts:.1f} s, epochs' "
          f"points_per_sec {[round(e['points_per_sec'], 1) for e in epochs]}"
          f", ghost_overflow {[e['ghost_overflow'] for e in epochs]}")
    assert n1 == 4
    assert all(e["ghost_overflow"] == 0 for e in epochs) and len(epochs) == 2
    assert all(np.isfinite(e["loss"]) for e in epochs)
    return {"collectives": [r["resident_ml"]["collectives"]
                            for r in (r0, r1)]}



def coord_phase(torch, np, Predictor, cfg, sd, xyz):
    """The combined selection table's two gathers on the card: each of
    scannet_whole_scene's four CAGQ layers, called as the served forward
    calls it (its level, key and spec; 81920 points), again with
    coord_match and with coord_payload: every GroupedNodes field bit for
    bit the default packed path's; layer 0's on the CPU with each flag:
    every index field and node_xyz bit for bit, center_xyz within 1e-5
    (the devices' f32 prefix sums differ by ulps); ms per layer printed
    (CUDA events; flag-off study paths)."""
    import gridgcn_torch.models.gridconv as gridconv
    from gridgcn_torch.ops.cagq import cagq

    calls = []
    real = gridconv.cagq

    def recording(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)

    pred = Predictor(cfg, sd, device="cuda")       # its first call: eager
    gridconv.cagq = recording
    try:
        pred(xyz)
    finally:
        gridconv.cagq = real
    assert len(calls) == 4, len(calls)

    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t

    def cpu(a):
        return a.cpu() if torch.is_tensor(a) else a

    for i, (args, kw) in enumerate(calls):
        x, m, spec = args[:3]
        base = cagq(*args, **kw).groups
        names = [f.name for f in dataclasses.fields(base)
                 if torch.is_tensor(getattr(base, f.name))]
        ms = {"packed": cuda_ms(torch, lambda: cagq(*args, **kw), 5)}
        for flag in ("coord_match", "coord_payload"):
            fargs = (x, m, dataclasses.replace(spec, **{flag: True})) \
                + args[3:]
            g = cagq(*fargs, **kw).groups
            torch.cuda.synchronize()
            differ = [n for n in names if not torch.equal(
                bits(getattr(g, n)), bits(getattr(base, n)))]
            assert not differ, (i, flag, differ)
            ms[flag] = cuda_ms(torch, lambda: cagq(*fargs, **kw), 5)
            if i == 0:
                gc = cagq(*map(cpu, fargs), **{k: cpu(v) for k, v in
                                               kw.items()}).groups
                cx = (getattr(g, "center_xyz").cpu()
                      - gc.center_xyz).abs().max().item()
                same = [n for n in names if n != "center_xyz" and
                        torch.equal(bits(getattr(g, n).cpu()),
                                    bits(getattr(gc, n)))]
                print(f"coord layer 0 {flag}: the card against the CPU, "
                      f"{len(same)} of {len(names) - 1} fields bit for bit, "
                      f"center_xyz max |d| {cx:.3g}")
                assert len(same) == len(names) - 1 and cx <= 1e-5, \
                    (flag, same, cx)
        print(f"coord layer {i} ({x.shape[1]} points -> {spec.n_centers} "
              f"centers, nv {spec.nv}): coord_match and coord_payload equal "
              f"the packed path in all {len(names)} fields; ms "
              + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()))


def dryrun_phase(anchors):
    """gridgcn_torch.dryrun.dryrun_multichip(4): every parallel program,
    four gloo ranks sharing cuda:0; part 7's projection from the card's
    own anchors. Rank 0 prints the reference's lines."""
    from gridgcn_torch.dryrun import dryrun_multichip

    t0 = time.perf_counter()
    out = dryrun_multichip(4, anchors=anchors, timeout_s=600)
    kinds = [line.split(" ", 1)[0] for line in out["lines"]]
    print(f"dryrun: 4 gloo ranks on cuda:0 in {time.perf_counter() - t0:.1f}"
          f" s; lines {kinds}")
    assert kinds == ["FEATURED_SPATIAL_TRAIN", "SCENE_BATCHED_TIER3",
                     "SCENE_BATCHED_TIER3_TRAIN"] + ["COMM_REPORT"] * 6, kinds
    for line in out["lines"]:
        rec = json.loads(line.split(" ", 1)[1])
        assert rec.get("ghost_overflow", 0) == 0, line


def comm_phase(cfg, counted, anchors):
    """The audit's bytes against the bytes the card's world-2 tier-3
    forward handed its collectives (counted in the resident phase's
    workers by `tests/torch_comm_worker.recording`): each rank's ring-shift
    sends equal the audit's per-direction bytes; then the projections at
    2, 4 and 8 ranks with the card's anchors, the ghost tax taken at each
    rank count from the fits."""
    from gridgcn_torch.parallel.comm_audit import (
        comm_report, print_comm_report)

    want = comm_report(cfg, 2)["tier3"]["bytes_per_dir_per_chip"]
    sent = [sum(b for k, b in log if k == "isend") for log in counted]
    got = [sum(b for k, b in log if k == "irecv") for log in counted]
    print(f"comm tier-3 forward of scannet_whole_scene at world 2 (gloo on "
          f"cuda:0): ring-shift bytes sent per rank {sent}, received {got}; "
          f"the audit's bytes per direction per chip {want}")
    assert sent == got == [want, want], (sent, got, want)
    a = anchors["scannet_whole_scene"]
    for D in (2, 4, 8):
        rep = print_comm_report(
            cfg, D, compute_ms_per_step=a["compute_ms"] / D,
            train_ms_per_step=a["train_ms"] / D, tax_fit=a["tax_fit"],
            knn_ms=a["knn_ms"], tier2_frac=a["tier2_frac"],
            label=f"scannet_whole_scene:default (anchors, measured on this "
                  f"card: plain forward {a['compute_ms']:.4f} ms busy, plain "
                  f"train step {a['train_ms']:.4f} ms busy, ghost tax fits "
                  f"{ {m: [round(x, 4) for x in f] for m, f in a['tax_fit'].items()} }"
                  f", decoder kNN ms {[round(t, 4) for t in a['knn_ms']]}, "
                  f"tier-2 R/C {a['tier2_frac']:.6f})")
        t2, t3, pr = rep["tier2"], rep["tier3"], rep["projection"]
        print(f"comm at {D} ranks: ghost tax eval "
              f"{t3['ghost_compute_tax']:.4f}, train "
              f"{t3['ghost_compute_tax_train']:.4f}; tier 3 efficiency "
              f"eval {pr['tier3_inference_efficiency']:.4f}, train "
              f"{pr['tier3_train_efficiency']:.4f}; tier 2 "
              f"{pr['tier2_inference_efficiency']:.4f}; replicated share "
              f"measured {t2['replicated_frac_measured']:.6f} (used) "
              f"against the byte model's {t2['replicated_frac_model']:.6f}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also print torch.profiler tables of one "
                    "whole-scene request, one classifier request and one "
                    "training step")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from gridgcn_torch.api import Predictor
    from gridgcn_torch.configs import presets
    from gridgcn_torch.data.augment import augment_batch
    from gridgcn_torch.data.pipeline import Dataset
    from gridgcn_torch.data.synthetic import synthetic_scene_surface
    from gridgcn_torch.kernels import knn
    from gridgcn_torch.models.build import build_model, init_model
    from gridgcn_torch.models.fold import fold_inference
    from gridgcn_torch.train import steps
    from gridgcn_torch.utils import jaxrng, xla_math

    t_start = time.perf_counter()
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    # the main path's list length and the kernel phase's others (any_k)
    logs = knn.build_kernels(ANY_K + (3,) + LONG_K)
    print(f"build: {time.perf_counter() - t0:.2f} s for {len(logs)} "
          f"builds ({sorted(logs)}, side by side)")
    print(f"phase build: {time.perf_counter() - t0:.1f} s")
    for src, log in logs.items():
        # the main path's build and the list kernels'; others below
        if src not in ("knn.cu k=3", f"knn.cu k=17..{knn.MAX_K}"):
            continue
        for line in log.splitlines():
            if ("registers" in line or "Compiling" in line or "smem" in line
                    or "spill" in line or line.startswith("nvcc:")):
                print(f"  {src}: {line.strip()}")
    # the list kernels' occupancy (both run LIST_THREADS a block, with
    # static shared memory only)
    for name, (regs, smem) in kernel_resources(
            logs[f"knn.cu k=17..{knn.MAX_K}"]).items():
        m = re.search(r"(knn_list_\w+_kernel)ILi(\d)E", name)
        if m:
            print(f"{m[1]}<{m[2]}>: {regs} registers, {smem} B shared a "
                  f"block of {LIST_THREADS}, "
                  f"{resident_warps(regs, smem, LIST_THREADS)} resident "
                  f"warps an SM")
    # the main path's instantiations (the k = 3 build) must not spill; the
    # other list lengths' spills are printed
    report = {k: v for log in logs.values() for k, v in spills(log).items()}
    spilled = {k: v for k, v in spills(logs["knn.cu k=3"]).items()
               if "knn3_mxu_kernel" in k or "knn3_exact_kernel" in k}
    assert len(spilled) >= 4 and not any(any(v) for v in spilled.values()), \
        f"main kernels spill or are missing from the report: {spilled}"
    print(f"build: {len(report)} kernels; spilling (bytes stored, loaded): "
          f"{ {k: v for k, v in report.items() if any(v)} }")
    from gridgcn_torch.kernels import rng

    t0 = time.perf_counter()
    rng_log = rng.build_kernel()
    print(f"build: rng.cu in {time.perf_counter() - t0:.2f} s")
    for line in rng_log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("nvcc:"):
            print(f"  rng.cu: {line.strip()}")
    assert not any(any(v) for v in spills(rng_log).values()), \
        f"the draw kernel spills: {spills(rng_log)}"

    cfg = presets.scannet_whole_scene()
    _, sd = init_model(cfg.model, torch.Generator().manual_seed(0))
    main_calls = decoder_inputs(torch, cfg, sd,
                                synthetic_scene_surface(81920, seed=7),
                                jaxrng, fold_inference, build_model)
    assert [(a[0].shape[0], a[2].shape[0]) for a in main_calls] == \
        [(512, 128), (2048, 512), (8192, 2048), (81920, 8192)]
    # the scannet_seg serving phase's requests, and its first crop's
    # decoder calls (CAS encoder) for the kernel phase
    seg_cfg = presets.get("scannet_seg")
    _, seg_sd = init_model(seg_cfg.model, torch.Generator().manual_seed(0))
    crops = [crop_batch(np, synthetic_scene_surface, 8, seed=40 + 8 * r)
             for r in range(5)]
    crop_calls = decoder_inputs(torch, seg_cfg, seg_sd, crops[0], jaxrng,
                                fold_inference, build_model)
    assert [(a[0].shape[0], a[2].shape[0]) for a in crop_calls] == \
        [(128, 32), (512, 128), (2048, 512), (8192, 2048)]
    # the training phase's data, and the decoder calls of its first
    # augmented batch (first crop) for the kernel phase
    train_cfg = scannet_train_config(presets)
    train_ds = train_crops(np, Dataset, synthetic_scene_surface, 32, 200)
    heldout = train_crops(np, Dataset, synthetic_scene_surface, 16, 400)
    train_calls = decoder_inputs(
        torch, train_cfg, seg_sd,
        first_train_batch(torch, train_cfg, train_ds, jaxrng, augment_batch),
        jaxrng, fold_inference, build_model)
    assert [(a[0].shape[0], a[2].shape[0]) for a in train_calls] == \
        [(128, 32), (512, 128), (2048, 512), (8192, 2048)]
    cases = [(a, "main") for a in main_calls] + [
        (a, "crop") for a in crop_calls] + [
        (a, "train") for a in train_calls] + [
        (ragged_inputs(torch, 1000, 700, 693, 1), "ragged"),
        (ragged_inputs(torch, 300, 200, 2, 2), "ragged"),
        (grid_inputs(torch, 4096, 2048, 3), "grid")]
    with phase("kernels"):
        totals = kernel_phase(torch, knn, cases)
        any_k = any_k_phase(torch, knn,
                            ragged_inputs(torch, 1000, 700, 693, 1),
                            main_calls)

    with phase("correctness"):
        correctness_phase(torch, np, Predictor, cfg, sd,
                          synthetic_scene_surface, jaxrng)

    with phase("serving"):
        pred = Predictor(cfg, sd, device="cuda")
        scenes = [synthetic_scene_surface(81920, seed=7 + i)
                  for i in range(3)]
        launches, latency_ms = serving_phase(torch, np, knn, pred, scenes,
                                             jaxrng)
        if args.profile:
            profile_phase(torch, pred, scenes[0], latency_ms,
                          "whole_scene")

    with phase("paths correctness"):
        paths_correctness_phase(torch, np, Predictor, presets, init_model,
                                synthetic_scene_surface, jaxrng)
        cas_seg_correctness_phase(
            torch, np, Predictor, seg_cfg, seg_sd,
            crop_batch(np, synthetic_scene_surface, 2, seed=30), jaxrng,
            build_model, fold_inference)
    with phase("classifier and CAS serving"):
        cls_pred, cls_ms = classifier_serving_phase(torch, np, Predictor,
                                                    presets, init_model)
        if args.profile:
            profile_phase(torch, cls_pred,
                          classifier_clouds(np, 16, 1024, 0), cls_ms,
                          "classifier")
        cas_seg_serving_phase(torch, np, knn, Predictor, seg_cfg, seg_sd,
                              crops, jaxrng)
    with phase("cuda graphs"):
        graphs_phase(torch, np, Predictor, presets, init_model, knn, jaxrng,
                     synthetic_scene_surface)

    with phase("training correctness"):
        rng_phase(torch, jaxrng, xla_math)
        train_correctness_phase(torch, np, presets, init_model, build_model,
                                steps, synthetic_scene_surface, jaxrng)
    with phase("training"):
        bare_ms = train_phase(torch, np, knn, train_cfg, train_ds, heldout,
                              init_model, build_model, steps, jaxrng,
                              args.profile)
    with phase("clis"):
        cli_phase(torch, np, knn, presets, card, bare_ms)
    with phase("fullsize reference"):
        ref_pred, ref_xyz = fullsize_ref_phase(
            torch, np, knn, presets, Predictor, synthetic_scene_surface,
            jaxrng)
    with phase("tf32 scope"):
        tf32_phase(torch, np, ref_pred, ref_xyz, jaxrng)
    with phase("fps vs cagq"):
        fps_phase(torch, np, presets, jaxrng, card)
    with phase("export"):
        export_phase(torch, np, knn, presets, Predictor, ref_pred, ref_xyz,
                     jaxrng)
    with phase("trace and cost"):
        trace_cost_phase(torch, knn, ref_pred, ref_xyz)
    with phase("trace repeat"):
        trace_repeat_phase()
    with phase("data parallel"):
        dp_phase(torch, np, knn, presets, init_model, build_model, steps,
                 jaxrng, train_cfg, train_ds, synthetic_scene_surface,
                 Predictor)
    with phase("resident tiers"):
        tiers = resident_phase(torch, np, knn, presets, jaxrng,
                               synthetic_scene_surface, Predictor, card)
    with phase("tier studies"):
        tier2_frac = tier_studies_phase(card)
    with phase("mesh-1 study"):
        mesh1 = mesh1_study_phase(card)
    # the card's own anchors for the audit's projections, all device-busy
    # time but the kNN: the plain forward and train step and the ghost
    # tax's eval and train fits (the mesh-1 study), the decoder's
    # knn3_mxu calls (the kernel phase's main cases, for the byte model)
    # and tier 2's measured replicated share (the tier-2 study)
    anchors = {"scannet_whole_scene": {
        **mesh1, "knn_ms": totals["knn3_mxu"]["stage_ms"],
        "tier2_frac": tier2_frac}}
    with phase("comm audit"):
        comm_phase(cfg, tiers["collectives"], anchors)
    with phase("dry run"):
        dryrun_phase(anchors)
    with phase("cagq coord"):
        coord_phase(torch, np, Predictor, cfg, sd,
                    synthetic_scene_surface(81920, seed=7))

    replaces = {"knn3_mxu": "gridgcn_tpu/ops/pallas/knn.py:97",
                "knn3_exact": "gridgcn_tpu/ops/pallas/knn.py:55"}
    # every instantiation the script launched: k = 3 (the main path's, on
    # its four calls), then the other list lengths (any_k_phase); launches
    # are the main path's (serving_phase) for each list length
    records = [(k, 3, totals[k]) for k in ("knn3_mxu", "knn3_exact")] + [
        (n, k, r) for (n, k), r in sorted(any_k.items())]
    kernels = [dict(name=n if k == 3 else f"{n} k={k}", route="cuda",
                    source="gridgcn_torch/csrc/knn.cu", replaces=replaces[n],
                    launches=launches[n].get(k, 0),
                    bound_by=("operations" if r["ops_ms"] >= r["bytes_ms"]
                              else "bytes"),
                    **{f: r[f] for f in ("max_abs_err", "ms", "plain_ms",
                                         "bound_ms", "library_ms")})
               for n, k, r in records]
    print(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
