"""Chip smoke test of the PyTorch port (``primia_tpu_torch``) on one CUDA card.

Run from the root of a checkout, on a machine with an NVIDIA H100:

    python3 chip_smoke.py [--seed N] [--profile_out PATH]

Phases, each reported on its own line; any failure exits nonzero:

1. build        compile every ``primia_tpu_torch/csrc/*.cu`` with nvcc
                (all at once) and report the seconds.
2. clahe_lut    the LUT kernel against its plain PyTorch version on the
                card, at the main path's shape (16, 224, 224), at
                (64, 224, 224) and at a ragged (3, 60, 60): LUTs equal.
3. clahe_apply  the apply kernel likewise: at most 1 uint8 level apart,
                on at most 1e-4 of the pixels. For each kernel and shape:
                kernel_ms (device time per launch, torch.profiler),
                call_ms (the wrapper's time per call in a loop of 200,
                CUDA events), plain_ms, and bound_ms (each input byte
                read and each output byte written once at 3.35 TB/s, or
                the f32 operations at 67 TFLOP/s, whichever is larger).
4. main path    the canonical recipe (configs/torch/pneumonia-resnet-
                pretrained.ini: ResNet-18, 3 channels, 224 px, CLAHE on)
                with seeded random weights, saved as a checkpoint; 64
                synthetic 224x224 DICOMs; the inference CLI on cuda at
                batch 16, with the launch counters set to 0 just before
                and read just after (each kernel once per batch); the
                card's logits for 4 images against the same predict step
                on the CPU (argmax equal, max |dlogit| <= 1e-3 max|logit|);
                images per second; a profile of the predict step.
5. kernels      the kernels launched and checked, then one JSON line with
                each kernel's launches, error, times and bound, the card's
                name and power limit, and as the last line
                {"ok": true, "device": {...}}.

Nothing here imports JAX or the JAX package. Work files go to
``build/chip_smoke/``, and the profile table of the predict step to
``--profile_out`` (default ``build/chip_smoke/profile.txt``).
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
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
KERNELS = {
    "clahe_lut": {"replaces": "primia_tpu/ops/pallas_clahe.py:83",
                  "kernel": "clahe_lut_kernel"},
    "clahe_apply": {"replaces": "primia_tpu/ops/pallas_clahe.py:148",
                    "kernel": "clahe_apply_kernel"},
}
SOURCE = "primia_tpu_torch/csrc/clahe.cu"


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

    cats = {"clahe_kernels": 0.0, "convolution": 0.0, "memcpy": 0.0, "other": 0.0}
    for e in avgs:
        if e.device_type != DeviceType.CUDA:
            continue
        k = e.key
        if "clahe" in k:
            cat = "clahe_kernels"
        elif any(w in k for w in ("xmma", "cudnn", "conv", "gemm", "Nhwc", "Nchw")):
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


def phase_build():
    from primia_tpu_torch.ops import _build

    t0 = time.perf_counter()
    libs = _build.build()
    secs = time.perf_counter() - t0
    check("clahe" in libs and libs["clahe"].is_file(), "clahe.cu did not build")
    say("build", seconds=f"{secs:.3f}", libraries=",".join(sorted(libs)))


def phase_kernels(torch, seed):
    """Phases 2 and 3: each kernel against its plain version on the card.
    Returns the per-kernel records (times at the main path's shape)."""
    from primia_tpu_torch.ops import cuda_clahe as cc

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    rec = {name: {"max_abs_err": 0.0} for name in KERNELS}
    for shape in [(BATCH, RES, RES), (64, RES, RES), (3, 60, 60)]:
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
            call_ms = cuda_ms(torch, kern, 200)
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


def phase_main_path(torch, seed, work, profile_out):
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
    check(args.model == "resnet-18" and args.pretrained and args.clahe
          and args.inference_resolution == RES, f"unexpected canonical config: {CONFIG}")
    rng = np.random.default_rng(seed)
    imgs = synthetic_xrays(np, rng, N_IMAGES)
    data = work / "images"
    data.mkdir(parents=True)
    for i, a in enumerate(imgs):
        write_dicom(data / f"xray_{i:03d}.dcm", a)
    f = imgs.astype(np.float64) / 255.0
    mean_std = (np.full(3, f.mean()), np.full(3, f.std(ddof=1)))

    torch.manual_seed(seed)
    model = create_model(args, num_classes=3, device="cpu")
    weights = work / "resnet18-canonical.pt"
    ckpt.save_model(weights, epoch=0, model=model, args=args, val_mean_std=mean_std)
    say("main", config=CONFIG.relative_to(ROOT), weights=weights.relative_to(ROOT),
        images=N_IMAGES, batch=BATCH)

    argv = ["--data_dir", str(data), "--model_weights", str(weights),
            "--batch_size", str(BATCH), "--device", "cuda"]
    out, err = io.StringIO(), io.StringIO()
    for name in cc.launches:
        cc.launches[name] = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        result = inference.main(argv)
    cli_s = time.perf_counter() - t0
    launches = dict(cc.launches)
    n_batches = -(-N_IMAGES // BATCH)
    preds = result["Inference Results"]
    check(len(preds) == N_IMAGES and set(preds.values()) <= {0, 1, 2},
          f"bad inference results: {str(preds)[:200]}")
    lines = out.getvalue().splitlines()
    check(json.loads(lines[0]) == json.loads(json.dumps(result))
          and lines[-1].startswith("Took "), "inference CLI output contract broken")
    for name, n in launches.items():
        check(n == n_batches, f"{name} launched {n} times for {n_batches} batches")
    say("main", cli_seconds=f"{cli_s:.4f}", cli_img_per_s=f"{N_IMAGES / cli_s:.2f}",
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
    say("main", cpu_check="ok", max_abs_dlogit=dl, max_abs_logit=scale)

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
    say("main", batch=BATCH, batches_timed=len(batch_ms), batch_ms_p50=f"{q[0]:.4f}",
        batch_ms_p75=f"{q[1]:.4f}", img_per_s_p50=f"{BATCH / (q[0] * 1e-3):.2f}",
        device_busy_ms_per_batch=f"{busy:.4f}", idle_share=idle)
    say("main", device_ms_per_batch=json.dumps({k: round(v, 6) for k, v in cats.items()}))
    return launches


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--profile_out", type=Path,
                        default=ROOT / "build" / "chip_smoke" / "profile.txt",
                        help="where to write the profiler table of the predict step")
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
        launches = phase_main_path(torch, opts.seed, work, opts.profile_out.resolve())
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    say("kernels", checked=json.dumps(list(KERNELS)), launches=json.dumps(launches))
    line = []
    for name, meta in KERNELS.items():
        r = rec[name]
        line.append({"name": name, "route": "cuda", "source": SOURCE,
                     "replaces": meta["replaces"], "launches": launches[name],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"], "library_ms": None,
                     "call_ms": r["call_ms"]})
    print(json.dumps({"kernels": line}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
