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
     served model's encoder output on an 81920-point scene), two ragged,
     masked shapes and one on a 2^-6 grid where knn3_mxu must be bit
     exact, with CUDA-event times of kernel, plain version and a library
     yardstick, and the host cost of one small call;
  4. correctness: the served forward on the card against the same forward
     on the CPU (plain versions), at full width on a small scene (f32) and
     on the full 81920-point scene (bf16, the preset's dtype);
  5. serving: scannet_whole_scene at full width with seeded random weights,
     3 requests and one predict_scene(votes=2) on 81920-point scenes; the
     kernel launch counters are read around exactly this run;
  6. one JSON line of kernels, the card line, and the final JSON line.
--profile adds a torch.profiler table of one request.
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
    """The main path's four decoder kNN calls on one scene, as the served
    model's encoder produces them: (queries, query mask, supports, support
    mask) per stage, (512x128, 2048x512, 8192x2048, 81920x8192)."""
    fcfg, folded = fold_inference(cfg, sd)
    model = build_model(fcfg.model)
    model.load_state_dict(folded)
    model = model.to("cuda").eval()
    x = torch.as_tensor(xyz, device="cuda")[None]
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
    "ragged" or "grid" (knn3_mxu bit exact); returns per-kernel totals over
    the main cases (one forward's four decoder calls)."""
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
    print(events.table(sort_by="self_cuda_time_total", row_limit=25))
    print(f"profile: one request {wall:.3f} ms wall under the profiler, "
          f"device busy {busy:.3f} ms; idle share {1 - busy / latency_ms:.3f}"
          f" of the unprofiled {latency_ms:.3f} ms request")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also print a torch.profiler table of one request")
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
    cases = [(a, "main") for a in main_calls] + [
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
