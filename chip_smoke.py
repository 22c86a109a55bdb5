"""Chip smoke test of the PyTorch port (``primia_tpu_torch``) on one CUDA card.

Run from the root of a checkout, on a machine with an NVIDIA H100:

    python3 chip_smoke.py [--seed N] [--profile_out PATH]

Phases, each reported on its own line; any failure exits nonzero:

1. build          compile every ``primia_tpu_torch/csrc/*.cu`` with nvcc
                  (all at once) and report the seconds.
2. clahe_lut      the LUT kernel against its plain PyTorch version on the
                  card, at the serving path's shape (16, 224, 224), at
                  (64, 224, 224), at the train path's (200, 224, 224) and at
                  a ragged (3, 60, 60): LUTs equal.
3. clahe_apply    the apply kernel likewise: at most 1 uint8 level apart,
                  on at most 1e-4 of the pixels. For each kernel and shape:
                  kernel_ms (device time per launch, torch.profiler),
                  call_ms (the wrapper's time per call in a loop, CUDA
                  events), plain_ms, and bound_ms (each input byte read and
                  each output byte written once at 3.35 TB/s, or the f32
                  operations at 67 TFLOP/s, whichever is larger).
4. tent_rows      K1 against its plain version, max |d| <= 1e-6, at the
                  canonical train shape (200 images x 3 channels of 224x224)
                  for each of the train step's four passes (the affine warp's
                  row and column pass from real ``_affine_mats`` draws, the
                  dense warp's column and row pass from real elastic + grid
                  displacement fields) and at a ragged (3 x 2 planes of
                  60x72); the same times as above, and library_ms, the time
                  of ``F.grid_sample(bilinear, zeros, align_corners=True)``
                  computing the same function (a yardstick the port never
                  calls).
5. tent_bilinear  K2 likewise, at the canonical shape (the dense warp's and
                  the affine warp's gather coordinates) and the ragged one.
6. serve          slice 1's main path: the canonical recipe
                  (configs/torch/pneumonia-resnet-pretrained.ini: ResNet-18,
                  3 channels, 224 px, CLAHE on) with seeded random weights,
                  saved as a checkpoint; 64 synthetic 224x224 DICOMs; the
                  inference CLI on cuda at batch 16, with the launch counters
                  set to 0 just before and read just after (each CLAHE kernel
                  once per batch); the card's logits for 4 images against the
                  same predict step on the CPU; images per second; a profile.
7. train          slice 2's main path: the canonical INI with epochs = 1 on a
                  synthetic 3-class set of 600 train and 60 test DICOMs;
                  ``python -m primia_tpu_torch.cli.train`` in-process on cuda,
                  counters set to 0 just before and read just after (K1 four
                  times per train step, K2 never, each CLAHE kernel once);
                  then 24 timed train steps at batch 200 (p50/p75, img/s,
                  device ms by category, idle share, a profile); 2 steps under
                  PRIMIA_WARP_TWOPASS=0 (K2 once per step); and one float32
                  step with augmentation and mixup off on the card against
                  the CPU from the same params and batch (loss within 1e-4
                  relative, BN running statistics within 1e-4).
8. kernels        one JSON line with each kernel's error, times, bound and
                  launches, counted on the path that runs it (the train CLI
                  for K1 and CLAHE, the PRIMIA_WARP_TWOPASS=0 steps for K2;
                  every path's counts beside them, and a kernel launched no
                  time on its path fails the run), the card's name and power
                  limit, and as the last line {"ok": true, "device": {...}}.

Nothing here imports JAX or the JAX package. Work files go to
``build/chip_smoke/``, and the profile tables to ``--profile_out`` (default
``build/chip_smoke/profile.txt``; the train step's beside it, with
``.train`` before the suffix).
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "configs" / "torch" / "pneumonia-resnet-pretrained.ini"
N_IMAGES = 64
BATCH = 16
RES = 224
TRAIN_PER_CLASS, TEST_PER_CLASS = 200, 20
TRAIN_BATCH = 200
TIMED_STEPS = 24
CLASSES = ("bacterial pneumonia", "normal", "viral pneumonia")
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
KERNELS = {
    "clahe_lut": {"replaces": "primia_tpu/ops/pallas_clahe.py:83", "path": "train",
                  "kernel": "clahe_lut_kernel", "source": "primia_tpu_torch/csrc/clahe.cu"},
    "clahe_apply": {"replaces": "primia_tpu/ops/pallas_clahe.py:148", "path": "train",
                    "kernel": "clahe_apply_kernel", "source": "primia_tpu_torch/csrc/clahe.cu"},
    "tent_rows": {"replaces": "primia_tpu/ops/pallas_tent.py:191", "path": "train",
                  "kernel": "tent_rows_kernel", "source": "primia_tpu_torch/csrc/tent.cu"},
    # K2 is on the train path when the dense warp is the joint gather
    # (PRIMIA_WARP_TWOPASS=0) or the affine ranges are not two-pass safe
    "tent_bilinear": {"replaces": "primia_tpu/ops/pallas_tent.py:54",
                      "path": "train_twopass0", "kernel": "tent_bilinear_kernel",
                      "source": "primia_tpu_torch/csrc/tent.cu"},
}


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def say(phase, **kw):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()), flush=True)


def cuda_ms(torch, fn, iters, warmup=3):
    """Milliseconds per call of ``fn``: CUDA events around ``iters``
    back-to-back calls, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def profile(torch, fn, iters):
    """Run ``fn`` ``iters`` times under torch.profiler; returns the
    key_averages of the window."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return prof.key_averages()


def device_ms_by_category(avgs, iters):
    """Device milliseconds per call of the profiled function, summed over
    the device-side rows (kernels and copies) by category."""
    from torch.autograd import DeviceType

    cats = {"warp_kernels": 0.0, "clahe_kernels": 0.0, "convolution": 0.0, "memcpy": 0.0,
            "other": 0.0}
    for e in avgs:
        if e.device_type != DeviceType.CUDA:
            continue
        k = e.key
        if "tent_" in k:
            cat = "warp_kernels"
        elif "clahe" in k:
            cat = "clahe_kernels"
        elif any(w in k for w in ("xmma", "cudnn", "conv", "gemm", "Nhwc", "Nchw", "cutlass",
                                  "wgrad", "dgrad", "fprop", "implicit")):
            cat = "convolution"
        elif "Memcpy" in k or "Memset" in k:
            cat = "memcpy"
        else:
            cat = "other"
        cats[cat] += e.self_device_time_total * 1e-3 / iters
    return cats


def kernel_device_ms(avgs, kernel_name):
    """Device milliseconds per launch of a kernel from profiler averages,
    or None where the trace has no device time for it."""
    for e in avgs:
        if kernel_name in e.key and e.count and e.device_time_total > 0:
            return e.device_time_total / e.count * 1e-3
    return None


def bound(nbytes, nops):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = nops / PEAK_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def reset_launches():
    from primia_tpu_torch.ops import cuda_clahe, cuda_tent

    for counts in (cuda_clahe.launches, cuda_tent.launches):
        for name in counts:
            counts[name] = 0


def read_launches():
    from primia_tpu_torch.ops import cuda_clahe, cuda_tent

    return {**cuda_clahe.launches, **cuda_tent.launches}


def phase_build():
    from primia_tpu_torch.ops import _build

    t0 = time.perf_counter()
    libs = _build.build()
    secs = time.perf_counter() - t0
    for name in ("clahe", "tent"):
        check(name in libs and libs[name].is_file(), f"{name}.cu did not build")
    say("build", seconds=f"{secs:.3f}", libraries=",".join(sorted(libs)))


def phase_kernels(torch, seed):
    """Phases 2 and 3: each kernel against its plain version on the card.
    Returns the per-kernel records (times at the main path's shape)."""
    from primia_tpu_torch.ops import cuda_clahe as cc

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    rec = {name: {"max_abs_err": 0.0} for name in KERNELS}
    for shape in [(BATCH, RES, RES), (64, RES, RES), (TRAIN_BATCH, RES, RES), (3, 60, 60)]:
        planes = torch.randint(0, 256, shape, dtype=torch.uint8, device=dev, generator=g)
        N, H, W = shape
        T = 8
        luts = cc.clahe_luts(planes)
        torch.cuda.synchronize()
        luts_plain = cc.clahe_luts_plain(planes)
        lut_err = float((luts - luts_plain).abs().max())
        check(torch.equal(luts, luts_plain), f"clahe_lut differs from plain at {shape}: {lut_err}")
        rec["clahe_lut"]["max_abs_err"] = max(rec["clahe_lut"]["max_abs_err"], lut_err)

        out = cc.clahe_apply(planes, luts_plain)
        torch.cuda.synchronize()
        out_plain = cc.clahe_apply_plain(planes, luts_plain)
        d = (out - out_plain).abs()
        err, frac = float(d.max()), float((d > 1e-3).float().mean())
        check(err <= 1.0 and frac <= 1e-4,
              f"clahe_apply differs from plain at {shape}: max {err}, share {frac}")
        rec["clahe_apply"]["max_abs_err"] = max(rec["clahe_apply"]["max_abs_err"], err)

        px = N * H * W
        lut_bytes = N * T * T * 256 * 4
        timings = {
            "clahe_lut": (lambda: cc.clahe_luts(planes), lambda: cc.clahe_luts_plain(planes),
                          bound(px + lut_bytes, px + N * T * T * 256 * 8)),
            "clahe_apply": (lambda: cc.clahe_apply(planes, luts),
                            lambda: cc.clahe_apply_plain(planes, luts),
                            bound(px + lut_bytes + 4 * px, 24 * px)),
        }
        for name, (kern, plain, (bound_ms, bound_by)) in timings.items():
            call_ms = cuda_ms(torch, kern, 100)
            plain_ms = cuda_ms(torch, plain, 20)
            dev_ms = kernel_device_ms(profile(torch, kern, 20), KERNELS[name]["kernel"])
            say(name, shape="x".join(map(str, shape)),
                kernel_ms="not measured" if dev_ms is None else f"{dev_ms:.6f}",
                call_ms=f"{call_ms:.6f}",
                plain_ms=f"{plain_ms:.6f}", bound_ms=f"{bound_ms:.6f}", bound_by=bound_by,
                max_abs_err=rec[name]["max_abs_err"])
            if shape == (BATCH, RES, RES):
                rec[name].update(ms=call_ms if dev_ms is None else dev_ms, call_ms=call_ms,
                                 plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
    return rec


def grid_for(torch, ys, xs, H, W):
    """``grid_sample``'s normalised (x, y) grid for absolute positions,
    ``align_corners=True``: -1 and 1 are the first and last pixel centres."""
    return torch.stack([xs * (2.0 / (W - 1)) - 1.0, ys * (2.0 / (H - 1)) - 1.0], dim=-1)


def tent_cases(torch, seed):
    """(shape name, canonical?, planes, [(case, tent_rows coords, axis)],
    [(case, tent_bilinear ys, xs)]) at the canonical train shape, with
    coordinates from real augmentation draws, and at a ragged shape."""
    from primia_tpu_torch.config import Arguments
    from primia_tpu_torch.ops import augment as A
    from primia_tpu_torch.ops import image as I

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    cfg = A.AugmentConfig.from_args(Arguments.from_ini(CONFIG))
    B, C, H, W = TRAIN_BATCH, 3, RES, RES
    planes = torch.rand((B * C, H, W), generator=g, device=dev)
    mats = A._affine_mats(g, cfg, B)
    q, p = I.twopass_coords(mats, H, W)
    fy, fx = A._coarse_field(g, B, H, W, H // 8, A._uniform(g, (B,), 0.0, 2.0))
    gy, gx = A._coarse_field(g, B, H, W, 6, A._uniform(g, (B,), 0.0, 0.06 * H))
    rr, cc = I.pixel_grid(H, W, dev)
    sy, sx = I.affine_coords(mats, H, W)
    yield (f"{B}x{C}x{H}x{W}", True, planes,
           [("affine_rows", q, 2), ("affine_cols", p, 1),
            ("dense_cols", rr + fy + gy, 1), ("dense_rows", cc + fx + gx, 2)],
           [("dense_gather", rr + fy + gy, cc + fx + gx), ("affine_gather", sy, sx)])
    B, C, H, W = 3, 2, 60, 72
    planes = torch.rand((B * C, H, W), generator=g, device=dev)
    ys = torch.rand((B, H, W), generator=g, device=dev) * (H + 5.0) - 3.0
    xs = torch.rand((B, H, W), generator=g, device=dev) * (W + 5.0) - 3.0
    yield (f"{B}x{C}x{H}x{W}", False, planes, [("rows", xs, 2), ("cols", ys, 1)], [("gather", ys, xs)])


def phase_tent(torch, seed):
    """Phases 4 and 5: K1 and K2 against their plain versions on the card.
    Returns their records: at the canonical shape, the mean over the train
    step's four K1 passes, and K2 at the dense warp's coordinates."""
    import torch.nn.functional as F

    from primia_tpu_torch.ops import cuda_tent as ct

    rec = {"tent_rows": {"max_abs_err": 0.0, "times": []},
           "tent_bilinear": {"max_abs_err": 0.0, "times": []}}
    for shape, canonical, planes, row_cases, gather_cases in tent_cases(torch, seed):
        N, H, W = planes.shape
        B = row_cases[0][1].shape[0]
        px = N * H * W
        runs = []
        for case, coords, axis in row_cases:
            rr = torch.arange(H, dtype=torch.float32, device=planes.device)[:, None]
            cc = torch.arange(W, dtype=torch.float32, device=planes.device)[None, :]
            ys, xs = (rr.expand(B, H, W), coords) if axis == 2 else (coords, cc.expand(B, H, W))
            runs.append(("tent_rows", case,
                         lambda c=coords, a=axis: ct.tent_rows(planes, c, axis=a),
                         lambda c=coords, a=axis: ct.tent_rows_plain(planes, c, axis=a),
                         grid_for(torch, ys, xs, H, W),
                         bound(4 * (2 * px + B * H * W), 6 * px)))
        for case, ys, xs in gather_cases:
            runs.append(("tent_bilinear", case,
                         lambda y=ys, x=xs: ct.tent_bilinear(planes, y, x),
                         lambda y=ys, x=xs: ct.tent_bilinear_plain(planes, y, x),
                         grid_for(torch, ys, xs, H, W),
                         bound(4 * (2 * px + 2 * B * H * W), 14 * px)))
        for name, case, kern, plain, grid, (bound_ms, bound_by) in runs:
            got = kern()
            torch.cuda.synchronize()
            err = float((got - plain()).abs().max())
            check(err <= 1e-6, f"{name} differs from plain at {shape} {case}: {err}")
            rec[name]["max_abs_err"] = max(rec[name]["max_abs_err"], err)
            img = planes.reshape(B, N // B, H, W)
            lib = lambda: F.grid_sample(img, grid, mode="bilinear", padding_mode="zeros",
                                        align_corners=True)
            lib_diff = float((lib().reshape(N, H, W) - got).abs().max())
            call_ms = cuda_ms(torch, kern, 50)
            plain_ms = cuda_ms(torch, plain, 5)
            library_ms = cuda_ms(torch, lib, 50)
            dev_ms = kernel_device_ms(profile(torch, kern, 20), KERNELS[name]["kernel"])
            say(name, shape=shape, case=case, max_abs_err=err,
                kernel_ms="not measured" if dev_ms is None else f"{dev_ms:.6f}",
                call_ms=f"{call_ms:.6f}", plain_ms=f"{plain_ms:.6f}",
                library_ms=f"{library_ms:.6f}", bound_ms=f"{bound_ms:.6f}", bound_by=bound_by,
                library_max_abs_diff=lib_diff)
            if canonical and case != "affine_gather":
                rec[name]["times"].append(dict(
                    ms=call_ms if dev_ms is None else dev_ms, call_ms=call_ms,
                    plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                    bound_by=bound_by))
    for r in rec.values():
        times = r.pop("times")
        for k in ("ms", "call_ms", "plain_ms", "library_ms", "bound_ms"):
            r[k] = sum(t[k] for t in times) / len(times)
        r["bound_by"] = times[0]["bound_by"]
    return rec


def synthetic_xrays(np, rng, n):
    """uint8 224x224 images: a bright blob on a dark field, with noise."""
    yy, xx = np.mgrid[0:RES, 0:RES].astype(np.float32)
    out = np.empty((n, RES, RES), np.uint8)
    for i in range(n):
        cy, cx = rng.uniform(60, 164, 2)
        r = rng.uniform(30, 80)
        img = 40 + 150 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * r * r))
        img += rng.normal(0, 12, img.shape)
        out[i] = np.clip(img, 0, 255).astype(np.uint8)
    return out


def phase_serve(torch, seed, work, profile_out):
    import numpy as np

    from primia_tpu_torch.cli import inference
    from primia_tpu_torch.config import Arguments
    from primia_tpu_torch.data import PathDataset, write_dicom
    from primia_tpu_torch.nn import create_model
    from primia_tpu_torch.nn.jax_params import from_jax_tree
    from primia_tpu_torch.ops import cuda_clahe as cc
    from primia_tpu_torch.train import checkpoint as ckpt
    from primia_tpu_torch.train.steps import build_predict_step

    args = Arguments.from_ini(CONFIG)
    data = work / "images"
    check(args.model == "resnet-18" and args.pretrained and args.clahe
          and args.inference_resolution == RES, f"unexpected canonical config: {CONFIG}")
    rng = np.random.default_rng(seed)
    imgs = synthetic_xrays(np, rng, N_IMAGES)
    data.mkdir(parents=True)
    for i, a in enumerate(imgs):
        write_dicom(data / f"xray_{i:03d}.dcm", a)
    f = imgs.astype(np.float64) / 255.0
    mean_std = (np.full(3, f.mean()), np.full(3, f.std(ddof=1)))

    torch.manual_seed(seed)
    model = create_model(args, num_classes=3, device="cpu")
    weights = work / "resnet18-canonical.pt"
    ckpt.save_model(weights, epoch=0, model=model, args=args, val_mean_std=mean_std)
    say("serve", config=CONFIG.relative_to(ROOT), weights=weights.relative_to(ROOT),
        images=N_IMAGES, batch=BATCH)

    argv = ["--data_dir", str(data), "--model_weights", str(weights),
            "--batch_size", str(BATCH), "--device", "cuda"]
    out, err = io.StringIO(), io.StringIO()
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        result = inference.main(argv)
    cli_s = time.perf_counter() - t0
    launches = read_launches()
    n_batches = -(-N_IMAGES // BATCH)
    preds = result["Inference Results"]
    check(len(preds) == N_IMAGES and set(preds.values()) <= {0, 1, 2},
          f"bad inference results: {str(preds)[:200]}")
    lines = out.getvalue().splitlines()
    check(json.loads(lines[0]) == json.loads(json.dumps(result))
          and lines[-1].startswith("Took "), "inference CLI output contract broken")
    for name in cc.launches:
        check(launches[name] == n_batches,
              f"{name} launched {launches[name]} times for {n_batches} batches")
    check(launches["tent_rows"] == launches["tent_bilinear"] == 0,
          f"the serving path launched a warp kernel: {launches}")
    say("serve", cli_seconds=f"{cli_s:.4f}", cli_img_per_s=f"{N_IMAGES / cli_s:.2f}",
        launches=json.dumps(launches), predictions=lines[1])

    # the CLI's predict step, rebuilt for timing and for the CPU comparison
    state = ckpt.load_model(weights)
    msd = state["model_state_dict"]
    sd = from_jax_tree(msd["params"], msd["state"])
    batches, _ = PathDataset(data, channels=3).materialize(RES)
    gpu_model = create_model(args, num_classes=3, device="cuda")
    gpu_model.load_state_dict(sd)
    predict = build_predict_step(gpu_model, args, *mean_std, "cuda")
    chunks = [batches[i:i + BATCH] for i in range(0, N_IMAGES, BATCH)]
    logits = predict(chunks[0]).float().cpu()
    check(logits.shape == (BATCH, 3) and bool(torch.isfinite(logits).all()),
          f"bad logits {tuple(logits.shape)}")
    cpu_model = create_model(args, num_classes=3, device="cpu")
    cpu_model.load_state_dict(sd)
    ref = build_predict_step(cpu_model, args, *mean_std, "cpu")(chunks[0][:4])
    dl = float((logits[:4] - ref).abs().max())
    scale = float(ref.abs().max())
    check(torch.equal(logits[:4].argmax(1), ref.argmax(1)) and dl <= 1e-3 * scale,
          f"card vs CPU logits: max |d| {dl} against max |logit| {scale}")
    say("serve", cpu_check="ok", max_abs_dlogit=dl, max_abs_logit=scale)

    def one_pass():
        for c in chunks:
            predict(c)

    one_pass()  # warm-up: cuDNN's first-call set-up
    batch_ms = []
    for _ in range(10):
        for c in chunks:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            predict(c)
            torch.cuda.synchronize()
            batch_ms.append((time.perf_counter() - t0) * 1e3)
    q = np.percentile(batch_ms, [50, 75])
    nb = len(chunks)
    avgs = profile(torch, one_pass, 3)
    profile_out.parent.mkdir(parents=True, exist_ok=True)
    profile_out.write_text(avgs.table(sort_by="self_cuda_time_total", row_limit=40))
    cats = {k: v / nb for k, v in device_ms_by_category(avgs, 3).items()}
    busy = sum(cats.values())
    idle = f"{1.0 - busy / q[0]:.4f}" if busy > 0 else "not measured"
    say("serve", batch=BATCH, batches_timed=len(batch_ms), batch_ms_p50=f"{q[0]:.4f}",
        batch_ms_p75=f"{q[1]:.4f}", img_per_s_p50=f"{BATCH / (q[0] * 1e-3):.2f}",
        device_busy_ms_per_batch=f"{busy:.4f}", idle_share=idle)
    say("serve", device_ms_per_batch=json.dumps({k: round(v, 6) for k, v in cats.items()}))
    return launches


def write_dataset(np, rng, root):
    """The synthetic 3-class set: ``root/train/<class>/`` and
    ``root/test/<class>/`` DICOMs, each class a little brighter."""
    from primia_tpu_torch.data import write_dicom

    for split, n in (("train", TRAIN_PER_CLASS), ("test", TEST_PER_CLASS)):
        for ci, cls in enumerate(CLASSES):
            d = root / split / cls
            d.mkdir(parents=True)
            imgs = np.clip(synthetic_xrays(np, rng, n).astype(np.int16) + 12 * ci, 0, 255)
            for i, a in enumerate(imgs.astype(np.uint8)):
                write_dicom(d / f"xray_{i:03d}.dcm", a)


def phase_train(torch, seed, work, profile_out):
    """Phase 7: the train CLI on the card, timed train steps, K2 on the
    train path, and one float32 step on the card against the CPU.
    Returns the launch counts of the CLI's run and of the
    PRIMIA_WARP_TWOPASS=0 steps."""
    import numpy as np

    from primia_tpu_torch.cli import train as train_cli
    from primia_tpu_torch.config import Arguments
    from primia_tpu_torch.data import (BatchLoader, ImageFolderDataset, calc_mean_std,
                                       to_device_resident)
    from primia_tpu_torch.nn import create_model
    from primia_tpu_torch.train import checkpoint as ckpt
    from primia_tpu_torch.train.optim import make_optimizer
    from primia_tpu_torch.train.steps import build_train_step

    root = work / "xray"
    write_dataset(np, np.random.default_rng(seed + 1), root)
    text = CONFIG.read_text()
    check("epochs = 40" in text, f"unexpected canonical config: {CONFIG}")
    ini = work / "train.ini"
    ini.write_text(text.replace("epochs = 40", "epochs = 1"))
    args = Arguments.from_ini(ini)
    check(args.batch_size == TRAIN_BATCH and args.mixup and args.clahe and args.elastic,
          f"unexpected canonical config: {CONFIG}")
    n_train = TRAIN_PER_CLASS * len(CLASSES)
    steps = -(-n_train // TRAIN_BATCH)
    say("train", config=CONFIG.relative_to(ROOT), epochs=1, train_images=n_train,
        test_images=TEST_PER_CLASS * len(CLASSES), batch=TRAIN_BATCH, steps=steps)

    # the main path: the train CLI, in-process, on cuda
    argv = ["--config", str(ini), "--data_dir", str(root / "train"), "--device", "cuda"]
    out = io.StringIO()
    cwd = os.getcwd()
    os.chdir(work)
    try:
        reset_launches()
        torch.manual_seed(seed)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(out):
            best = train_cli.main(argv)
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        launches = read_launches()
    finally:
        os.chdir(cwd)
    (work / "train_cli.log").write_text(out.getvalue())
    want = {"tent_rows": 4 * steps, "tent_bilinear": 0, "clahe_lut": steps,
            "clahe_apply": steps}
    check(launches == want, f"train CLI launches {launches}, expected {want}")
    finals = sorted((work / "model_weights").glob("final_*.pt"))
    check(len(finals) == 1, f"train CLI wrote {len(finals)} final checkpoints")
    state = ckpt.load_model(finals[0])
    check(state["epoch"] == 1 and int(state["optim_state_dict"].step) == steps,
          "final checkpoint has the wrong epoch or optimizer step")
    losses = [float(line.split()[-1]) for line in out.getvalue().splitlines()
              if line.startswith("Train Epoch:")]
    check(len(losses) == 1 and np.isfinite(losses[0]), f"train losses {losses}")
    check(np.isfinite(best), f"best objective {best}")
    say("train", cli_seconds=f"{cli_s:.4f}", launches=json.dumps(launches),
        epoch_loss=losses[0], best_mcc_percent=best)

    # timed steps at batch 200, on a model and data set up as the loop does
    ds = ImageFolderDataset(root / "train", channels=3)
    imgs, labels = ds.materialize(RES)
    mean, std = calc_mean_std(imgs)
    dev = torch.device("cuda")
    torch.manual_seed(seed)
    model = create_model(args, num_classes=3, device="cpu").to(dev)
    opt = make_optimizer(args, model)
    step = build_train_step(model, opt, args, mean, std, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    loader = BatchLoader(to_device_resident(imgs, dev), labels, TRAIN_BATCH, seed=seed,
                         pad_final=False)
    batches = [b for b in loader]

    def run(i):
        b = batches[i % len(batches)]
        return step(gen, b.images, b.labels, b.mask, 1e-4)

    for i in range(3):
        run(i)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms, step_losses = [], []
    for i in range(TIMED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step_losses.append(run(i))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    check(all(bool(torch.isfinite(l)) for l in step_losses), "non-finite train loss")
    q = np.percentile(step_ms, [50, 75])
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_prof = 3
    avgs = profile(torch, lambda: [run(i) for i in range(n_prof)], 1)
    train_profile = profile_out.with_name(profile_out.stem + ".train" + profile_out.suffix)
    train_profile.parent.mkdir(parents=True, exist_ok=True)
    train_profile.write_text(avgs.table(sort_by="self_cuda_time_total", row_limit=60))
    cats = {k: v / n_prof for k, v in device_ms_by_category(avgs, 1).items()}
    busy = sum(cats.values())
    idle = f"{1.0 - busy / q[0]:.4f}" if busy > 0 else "not measured"
    say("train", batch=TRAIN_BATCH, steps_timed=len(step_ms), step_ms_p50=f"{q[0]:.4f}",
        step_ms_p75=f"{q[1]:.4f}", img_per_s_p50=f"{TRAIN_BATCH / (q[0] * 1e-3):.2f}",
        device_busy_ms_per_step=f"{busy:.4f}", idle_share=idle,
        peak_memory_gb=f"{peak_gb:.3f}", compute_dtype="bfloat16")
    say("train", device_ms_per_step=json.dumps({k: round(v, 6) for k, v in cats.items()}))

    # K2 on the train path: the dense warp as the joint bilinear gather
    os.environ["PRIMIA_WARP_TWOPASS"] = "0"
    try:
        reset_launches()
        k2_losses = [float(run(i)) for i in range(2)]
        torch.cuda.synchronize()
        k2 = read_launches()
    finally:
        os.environ.pop("PRIMIA_WARP_TWOPASS")
    check(k2["tent_bilinear"] == 2 and k2["tent_rows"] == 2 * 2
          and all(np.isfinite(k2_losses)),
          f"PRIMIA_WARP_TWOPASS=0 steps: launches {k2}, losses {k2_losses}")
    say("train", warp_twopass=0, steps=2, launches=json.dumps(k2), losses=k2_losses)

    # one float32 step, augmentation and mixup off: the card against the CPU
    f32 = Arguments.from_ini(ini)
    f32.compute_dtype = "float32"
    f32.rotation = f32.translate = f32.scale = f32.shear = 0.0
    f32.albu_prob = f32.noise_prob = 0.0
    f32.clahe = f32.mixup = False
    torch.manual_seed(seed)
    sd = create_model(f32, num_classes=3, device="cpu").state_dict()
    x4, y4, m4 = imgs[:4], labels[:4], np.ones(4, np.float32)
    results = {}
    for where in ("cuda", "cpu"):
        m = create_model(f32, num_classes=3, device=where)
        m.load_state_dict(sd)
        st = build_train_step(m, make_optimizer(f32, m), f32, mean, std, device=where)
        loss = float(st(torch.Generator(device=where).manual_seed(0), x4, y4, m4, 1e-4))
        stats = torch.cat([t.detach().float().cpu().reshape(-1) for n, t in m.state_dict().items()
                           if n.endswith(("running_mean", "running_var"))])
        results[where] = (loss, stats)
    (lg, sg), (lc, sc) = results["cuda"], results["cpu"]
    rel = abs(lg - lc) / abs(lc)
    dstat = float((sg - sc).abs().max())
    check(rel <= 1e-4 and dstat <= 1e-4,
          f"card vs CPU f32 step: loss {lg} vs {lc} (rel {rel}), BN stats max |d| {dstat}")
    say("train", cpu_check="ok", loss_cuda=lg, loss_cpu=lc, loss_rel_diff=rel,
        bn_stats_max_abs_diff=dstat)
    return launches, k2


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--profile_out", type=Path,
                        default=ROOT / "build" / "chip_smoke" / "profile.txt",
                        help="where to write the profiler table of the predict step "
                        "(the train step's goes beside it)")
    opts = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this test runs only on the card", file=sys.stderr)
        return 2
    if not (ROOT / "primia_tpu_torch" / "csrc").is_dir() or not CONFIG.is_file():
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    os.environ["PRIMIA_MATERIALIZE_CACHE"] = "0"
    work = ROOT / "build" / "chip_smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout else ""
    try:
        check(card, f"nvidia-smi failed: {smi.stderr.strip()}")
        say("device", name=torch.cuda.get_device_name(0),
            capability=torch.cuda.get_device_capability(0), torch=torch.__version__,
            cuda=torch.version.cuda)
        phase_build()
        rec = phase_kernels(torch, opts.seed)
        rec.update(phase_tent(torch, opts.seed))
        profile_out = opts.profile_out.resolve()
        by_path = {"serve": phase_serve(torch, opts.seed, work, profile_out)}
        by_path["train"], by_path["train_twopass0"] = phase_train(torch, opts.seed, work,
                                                                  profile_out)
        for name, meta in KERNELS.items():
            check(by_path[meta["path"]][name] > 0,
                  f"{name} was not launched on its path {meta['path']}: {by_path}")
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    say("kernels", checked=json.dumps(list(KERNELS)), launches=json.dumps(by_path))
    line = []
    for name, meta in KERNELS.items():
        r = rec[name]
        line.append({"name": name, "route": "cuda", "source": meta["source"],
                     "replaces": meta["replaces"], "launches": by_path[meta["path"]][name],
                     "launches_by_path": {p: n[name] for p, n in by_path.items()},
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"], "library_ms": r.get("library_ms"),
                     "call_ms": r["call_ms"]})
    print(json.dumps({"kernels": line}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
