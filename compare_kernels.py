"""Hold this checkout's SIFT and LCS kernels against another checkout's on
one CUDA card: the same full-width inputs through both, the outputs
compared bit for bit (but for the sign of a zero), each side timed; and
time both checkouts' Fisher-vector statistics kernel at the main paths'
shapes, its outputs held together within the JAX package's bar (rtol
1e-3, atol 1e-4), since a redesign may sum in another order.

    python3 compare_kernels.py OTHER_CHECKOUT

Each side runs in a process of its own with its own checkout first on
``sys.path``, so it builds its own CUDA sources and calls them through
its own wrappers (``kernels.sift_bin_sample(mag, orient, ayt, ax)`` and
``kernels.plane_sandwich(planes, at, b)``, which both sides take, with the
operators' bands made beforehand by the side's own band function where
its wrapper takes them, as the extractors cache them). The sides run in
turns, other, this, this, other, and each times its kernels with CUDA
events (runs of 10 calls in a row, median of 5 runs). Inputs are those of
the flagship's serving path at B = 64 images of 256²: the four SIFT
scales' magnitude, orientation and sampling matrices, and the LCS planes
and operators. They and the outputs pass through ``tmp/compare_kernels/``
in this checkout, removed at the end. Each side makes the B3 inputs
itself on the card from one seed (``FV_SHAPES``: VOC's chunk of 64
images and one image at (d, k) = (80, 256), the flagship's streaming pair
at vocabulary 256, a shape past every tile, and the serving shapes) and
calls ``fv_kernel.fisher_vector_stats(x, means, variances, weights)``.

Prints the card's name and power limit, then one JSON line; exits
non-zero when an output differs beyond the sign of a zero.
"""

from __future__ import annotations

import inspect
import json
import os
import shutil
import statistics
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "tmp", "compare_kernels")
IMG, B = 256, 64
SIFT = dict(step=3, bin=4, num_scales=4, scale_step=1)
LCS = dict(stride=4, stride_start=16, sub_patch_size=6)
# B3: name -> (B, d, k, descriptor counts), and its bar
FV_SHAPES = {
    "voc_chunk": (64, 80, 256, (73866,)),
    "voc_image": (1, 80, 256, (73866,)),
    "flagship_vocab256": (64, 64, 256, (13165, 3136)),
    "past_every_tile": (2, 129, 257, (13165,)),
    "serving": (64, 64, 32, (13165, 3136)),
}
FV_RTOL, FV_ATOL = 1e-3, 1e-4


def time_ms(fn, calls=10, rounds=5, warmup=2):
    """Device time of one ``fn()`` in ms: CUDA events around ``calls``
    calls in a row, so that each call's launch from the host overlaps the
    device work before it, divided by ``calls``; the median of ``rounds``
    such runs, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def make_inputs(path):
    """Seeded full-width inputs of both kernels, saved on the CPU."""
    sys.path.insert(0, ROOT)
    from keystone_tpu_torch.ops.images import lcs, sift

    gen = torch.Generator().manual_seed(0)
    scales = []
    for _, ayt, ax, _ in sift.scale_operators(IMG, IMG, *SIFT.values(), "cpu"):
        mag = torch.rand((B, IMG, IMG), generator=gen)
        orient = torch.rand((B, IMG, IMG), generator=gen) * 8
        scales.append((mag, orient, ayt, ax))
    at, bm, *_ = lcs.LCSExtractor(**LCS).operators(IMG, IMG, "cpu")
    imgs = torch.randint(0, 256, (B, IMG, IMG, 3), generator=gen).to(torch.float32)
    planes = torch.cat([imgs, imgs * imgs], dim=-1).permute(0, 3, 1, 2).contiguous()
    torch.save({"sift": scales, "sandwich": (planes, at, bm)}, path)


def worker(checkout, tag, save):
    """One side: run and time the kernels of ``checkout``; save the
    outputs when asked. Prints its times as the last line."""
    sys.path.insert(0, checkout)
    from keystone_tpu_torch.ops.images import kernels

    assert os.path.dirname(os.path.abspath(kernels.__file__)).startswith(
        os.path.abspath(checkout)), kernels.__file__
    dev = torch.device("cuda")
    data = torch.load(os.path.join(WORK, "inputs.pt"))
    scales = [tuple(t.to(dev) for t in s) for s in data["sift"]]
    sandwich = tuple(t.to(dev) for t in data["sandwich"])
    # the band function: operator_bands, or sift_bands before it
    bands = getattr(kernels, "operator_bands", None) or getattr(kernels, "sift_bands", None)
    if bands is not None:
        scales = [(*s, bands(s[2], s[3])) for s in scales]
        if "bands" in inspect.signature(kernels.plane_sandwich).parameters:
            sandwich = (*sandwich, bands(sandwich[1], sandwich[2]))
    if save:
        out = {
            "sift": [kernels.sift_bin_sample(*s).cpu() for s in scales],
            "sandwich": kernels.plane_sandwich(*sandwich).cpu(),
        }
        torch.save(out, os.path.join(WORK, f"out_{tag}.pt"))
    times = {
        "sift_bin_sample_ms": time_ms(lambda: [kernels.sift_bin_sample(*s) for s in scales]),
        "plane_sandwich_ms": time_ms(lambda: kernels.plane_sandwich(*sandwich)),
    }
    del scales, sandwich
    from keystone_tpu_torch.ops.images import fv_kernel

    gen = torch.Generator(device=dev).manual_seed(0)
    fv_out = {}
    for name, (b, d, k, ms) in FV_SHAPES.items():
        gmm = (torch.randn(d, k, device=dev, generator=gen),
               0.5 + torch.randn(d, k, device=dev, generator=gen).abs(),
               torch.full((k,), 1.0 / k, device=dev))
        xs = [torch.randn(b, d, m, device=dev, generator=gen) for m in ms]
        if save:
            fv_out[name] = [t.cpu() for x in xs for t in fv_kernel.fisher_vector_stats(x, *gmm)]
        calls = 3 if b * sum(ms) > 10**6 else 10
        times[f"fisher_vector_stats_{name}_ms"] = time_ms(
            lambda: [fv_kernel.fisher_vector_stats(x, *gmm) for x in xs], calls=calls)
        del xs
        torch.cuda.empty_cache()
    if save:
        torch.save(fv_out, os.path.join(WORK, f"fv_{tag}.pt"))
    print(json.dumps(times))


def fv_compare(a, b):
    """The largest absolute difference, and the entries outside the B3 bar."""
    err = (a - b).abs()
    return {"entries": a.numel(), "max_abs_diff": float(err.max()),
            "outside_bar": int((err > FV_ATOL + FV_RTOL * a.abs()).sum())}


def compare(a, b):
    """Entries that differ in their bits once -0.0 is taken as +0.0, and
    the largest absolute difference."""
    a, b = a + 0.0, b + 0.0
    differ = int((a.view(torch.int32) != b.view(torch.int32)).sum())
    return {"entries": a.numel(), "differing": differ,
            "max_abs_diff": float((a - b).abs().max())}


def main():
    if len(sys.argv) == 5 and sys.argv[1] == "--worker":
        worker(sys.argv[2], sys.argv[3], sys.argv[4] == "save")
        return
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    if not torch.cuda.is_available():
        print("compare_kernels: CUDA is not available", file=sys.stderr)
        sys.exit(1)
    other = os.path.abspath(sys.argv[1])
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    os.makedirs(WORK, exist_ok=True)
    try:
        make_inputs(os.path.join(WORK, "inputs.pt"))
        rounds = []
        for checkout, tag, save in ((other, "other", True), (ROOT, "this", True),
                                    (ROOT, "this", False), (other, "other", False)):
            done = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--worker", checkout, tag,
                 "save" if save else "time"],
                capture_output=True, text=True, cwd=checkout,
            )
            if done.returncode != 0:
                sys.exit(f"{tag} side failed:\n{done.stdout}\n{done.stderr}")
            rounds.append({"side": tag, **json.loads(done.stdout.strip().splitlines()[-1])})
        outs = {t: torch.load(os.path.join(WORK, f"out_{t}.pt")) for t in ("other", "this")}
        diff = {
            "sift_bin_sample": [compare(a, b) for a, b in
                                zip(outs["other"]["sift"], outs["this"]["sift"])],
            "plane_sandwich": [compare(outs["other"]["sandwich"], outs["this"]["sandwich"])],
        }
        fv = {t: torch.load(os.path.join(WORK, f"fv_{t}.pt")) for t in ("other", "this")}
        fv_diff = {name: [fv_compare(a, b) for a, b in zip(fv["other"][name], fv["this"][name])]
                   for name in FV_SHAPES}
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    print(smi)
    print(json.dumps({"card": smi, "other": other, "rounds": rounds, "diff": diff,
                      "fisher_vector_stats": fv_diff}))
    if any(d["differing"] for ds in diff.values() for d in ds) or any(
            d["outside_bar"] for ds in fv_diff.values() for d in ds):
        sys.exit(1)


if __name__ == "__main__":
    main()
