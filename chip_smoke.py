#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (gridgcn_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Phases, in order; any failure raises and the script exits non-zero:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build the CUDA kernels from the checkout's sources (nvcc), print the
     registers and spills of each, and require no spills in the two main
     kernels;
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
     3 requests and one predict_scene(votes=2) on 81920-point scenes; the
     kernel launch counters are read around exactly this run;
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
     points per request, CAS with 3 rounds; knn3_mxu launches 4 times per
     scene (once per decoder stage and cloud);
  9. one JSON line of kernels, the card line, and the final JSON line.
--profile adds torch.profiler tables of one whole-scene request and of one
classifier request, with the classifier request's CUDA launch count.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time

# published H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s,
# bf16 tensor-core and fp32 CUDA-core operations/s
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12
FP32_OPS_PER_S = 67e12


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
    "crop" (one of a scannet_seg crop's decoder calls), "ragged" or "grid"
    (knn3_mxu bit exact); returns per-kernel totals over the main cases
    (one whole-scene forward's four decoder calls)."""
    tot = {k: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                   max_abs_err=0.0, bytes_ms=0.0, ops_ms=0.0)
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
        # bytes: inputs read once, outputs written once; operations: 16
        # bf16 MACs per pair (mxu), 3 sub + 3 mul + 2 add fp32 (exact)
        bytes_ms = io_bytes / HBM_BYTES_PER_S * 1e3
        ops_ms = {"knn3_mxu": pairs * 32 / BF16_OPS_PER_S * 1e3,
                  "knn3_exact": pairs * 8 / FP32_OPS_PER_S * 1e3}
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
    args = next(a for a, kind in cases if kind == "main")
    for k in tot:
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


def serving_phase(torch, np, knn, pred, scenes, jaxrng):
    """3 requests and one predict_scene(votes=2): the counted main path."""
    for _ in range(2):                                   # warm-up
        pred(scenes[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    knn.knn3_mxu.launches = 0
    knn.knn3_exact.launches = 0
    knn.mxu_pack_support.launches = 0
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
    launches = {"knn3_mxu": knn.knn3_mxu.launches,
                "knn3_exact": knn.knn3_exact.launches}
    forwards = len(scenes) + 2
    assert launches["knn3_mxu"] == 4 * forwards, launches
    assert knn.mxu_pack_support.launches == 4 * forwards
    peak = torch.cuda.max_memory_allocated()
    print(f"serving: {forwards} forwards, launches {launches}; per-scene "
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


def cas_seg_serving_phase(torch, np, knn, Predictor, cfg, sd, batches):
    """scannet_seg (CAS, 3 rounds, bf16 with f32 BatchNorm) at full width,
    8 scenes of 8192 points per request, 5 requests after warm-up; every
    forward launches knn3_mxu once per decoder stage and cloud."""
    assert all(l.cas_iters == 3 for l in cfg.model.layers
               if l.sampler == "cas")
    pred = Predictor(cfg, sd, device="cuda")

    def check(out):
        assert out.shape == (8, 8192, 21) and out.dtype == np.float32
        assert np.isfinite(out).all()

    pred(batches[0])
    knn.knn3_mxu.launches = 0
    check(pred(batches[0]))
    assert knn.knn3_mxu.launches == 4 * 8, knn.knn3_mxu.launches
    lat, wall, peak = timed_requests(torch, pred, batches, check)
    print(f"scannet_seg (CAS x3, bf16, 8 x 8192 pts): per-batch latency "
          f"median {statistics.median(lat):.3f} ms (CUDA events; "
          f"{[round(x, 3) for x in lat]}), host wall median "
          f"{statistics.median(wall):.3f} ms; peak memory {peak:.1f} MiB; "
          f"knn3_mxu launches per forward {4 * 8}")


def profile_phase(torch, pred, xyz, latency_ms):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pred(xyz)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    # device-side events only (kernels, copies): the aten rows repeat them
    busy = sum(e.self_device_time_total for e in events
               if e.device_type == DeviceType.CUDA) / 1e3
    kernels = sum(e.count for e in events
                  if e.device_type == DeviceType.CUDA)
    aten = sorted(((e.count, e.key) for e in events
                   if e.key.startswith("aten::")), reverse=True)
    print(events.table(sort_by="self_cuda_time_total", row_limit=25))
    print(f"profile: one request {wall:.3f} ms wall under the profiler, "
          f"device busy {busy:.3f} ms; idle share {1 - busy / latency_ms:.3f}"
          f" of the unprofiled {latency_ms:.3f} ms request; "
          f"{kernels} device launches; most frequent host ops: "
          f"{[(k, c) for c, k in aten[:10]]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also print torch.profiler tables of one "
                    "whole-scene and one classifier request")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from gridgcn_torch.api import Predictor
    from gridgcn_torch.configs import presets
    from gridgcn_torch.data.synthetic import synthetic_scene_surface
    from gridgcn_torch.kernels import knn
    from gridgcn_torch.models.build import build_model, init_model
    from gridgcn_torch.models.fold import fold_inference
    from gridgcn_torch.utils import jaxrng

    t_start = time.perf_counter()
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    logs = knn.build_kernels()
    print(f"build: {time.perf_counter() - t0:.2f} s for {sorted(logs)}")
    for src, log in logs.items():
        for line in log.splitlines():
            if ("registers" in line or "Compiling" in line or "smem" in line
                    or "spill" in line):
                print(f"  {src}: {line.strip()}")
    spilled = {k: v for k, v in spills(logs["knn.cu"]).items()
               if ("knn3_mxu_kernel" in k or "knn3_exact_kernel" in k)}
    assert len(spilled) >= 4 and not any(any(v) for v in spilled.values()), \
        f"main kernels spill or are missing from the report: {spilled}"

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
    cases = [(a, "main") for a in main_calls] + [
        (a, "crop") for a in crop_calls] + [
        (ragged_inputs(torch, 1000, 700, 693, 1), "ragged"),
        (ragged_inputs(torch, 300, 200, 2, 2), "ragged"),
        (grid_inputs(torch, 4096, 2048, 3), "grid")]
    totals = kernel_phase(torch, knn, cases)

    correctness_phase(torch, np, Predictor, cfg, sd, synthetic_scene_surface,
                      jaxrng)

    pred = Predictor(cfg, sd, device="cuda")
    scenes = [synthetic_scene_surface(81920, seed=7 + i) for i in range(3)]
    launches, latency_ms = serving_phase(torch, np, knn, pred, scenes,
                                         jaxrng)
    if args.profile:
        profile_phase(torch, pred, scenes[0], latency_ms)

    paths_correctness_phase(torch, np, Predictor, presets, init_model,
                            synthetic_scene_surface, jaxrng)
    cas_seg_correctness_phase(
        torch, np, Predictor, seg_cfg, seg_sd,
        crop_batch(np, synthetic_scene_surface, 2, seed=30), jaxrng,
        build_model, fold_inference)
    cls_pred, cls_ms = classifier_serving_phase(torch, np, Predictor,
                                                presets, init_model)
    if args.profile:
        profile_phase(torch, cls_pred, classifier_clouds(np, 16, 1024, 0),
                      cls_ms)
    cas_seg_serving_phase(torch, np, knn, Predictor, seg_cfg, seg_sd, crops)

    replaces = {"knn3_mxu": "gridgcn_tpu/ops/pallas/knn.py:97",
                "knn3_exact": "gridgcn_tpu/ops/pallas/knn.py:55"}
    kernels = [dict(name=k, route="cuda",
                    source="gridgcn_torch/csrc/knn.cu", replaces=replaces[k],
                    launches=launches[k],
                    bound_by=("operations" if totals[k]["ops_ms"]
                              >= totals[k]["bytes_ms"] else "bytes"),
                    **{f: totals[k][f] for f in (
                        "max_abs_err", "ms", "plain_ms", "bound_ms",
                        "library_ms")})
               for k in ("knn3_mxu", "knn3_exact")]
    print(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
